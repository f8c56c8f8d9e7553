"""The CUDA kernels on the card (K1, K2 and their int8 variants K3, K4,
the flash forward K5 and backward K6, the IVF scan modes K1-opt, K9, K10,
K11, the packed attention K7 and the two-pass top-k K8), each held against
its plain version, and the port's pipelines (bf16 and int8 serving,
long-document encode, packed encode) on the card against the same
pipelines on the CPU.

Imports neither jax nor the JAX package, so it runs on a machine with a
card and no JAX; without a card every test skips. On the card:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, IndexConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.index import ivf as ivf_mod
from text_similarity_tpu_torch.index import ivf_modes
from text_similarity_tpu_torch.index.ivf import (
    IVFIndex,
    _plan_probes,
    ivf_scan,
    ivf_scan_cuda,
    ivf_scan_reference,
)
from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward, init_params
from text_similarity_tpu_torch.models.hf_convert import extend_positions
from text_similarity_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_cuda,
    flash_attention_plain,
    multi_head_attention,
    packed_attention,
    packed_attention_cuda,
    packed_attention_plain,
)
from text_similarity_tpu_torch.ops import topk as topk_mod
from text_similarity_tpu_torch.ops.topk import (
    cosine_topk_2pass,
    cosine_topk_2pass_reference,
    cosine_topk_cuda,
    cosine_topk_int8,
    cosine_topk_int8_cuda,
    cosine_topk_int8_reference,
    cosine_topk_reference,
    topk_2pass_count_cuda,
    topk_2pass_count_plain,
    topk_2pass_fold_cuda,
    topk_2pass_fold_plain,
)
from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # exact f32 plain versions
    return torch.device("cuda")


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _overlap(a, b):
    return np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)])


def _assert_agree(ks, ki, rs, ri, exact_ids):
    """Scores allclose 1e-5; f32: ids equal wherever neighbouring scores
    differ by > 1e-5 (near-ties may swap under another summation order);
    bf16: id overlap ≥ 0.99."""
    ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
    np.testing.assert_allclose(ks, rs, atol=1e-5)
    if exact_ids:
        gap = np.minimum(
            np.abs(np.diff(rs, axis=1, prepend=np.inf)),
            np.abs(np.diff(rs, axis=1, append=-np.inf)),
        )
        sep = gap > 1e-5
        np.testing.assert_array_equal(ki[sep], ri[sep])
    else:
        assert _overlap(ki, ri) >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 20, 256])
@pytest.mark.parametrize("q_n", [1, 7, 33])
def test_topk_kernel_matches_plain(cuda, dtype, k, q_n):
    rng = np.random.default_rng(5)
    x = _unit(rng.standard_normal((10_007, 64)))
    src = rng.choice(5000, q_n, replace=False)
    x[5000 + np.arange(q_n)] = x[src]                 # exact ties
    q = _unit(x[src] + 0.05 * rng.standard_normal((q_n, 64)))
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, dtype)
    before = cosine_topk_cuda.launches
    ks, ki = cosine_topk_cuda(tq, tx, k=k)
    rs, ri = cosine_topk_reference(tq, tx, k=k)
    torch.cuda.synchronize()
    assert cosine_topk_cuda.launches == before + 1
    _assert_agree(ks, ki, rs, ri, dtype == torch.float32)


def test_topk_kernel_rejects_bad_inputs(cuda):
    x = torch.nn.functional.normalize(torch.randn(1000, 64, device=cuda), dim=1)
    q = x[:4].contiguous()
    with pytest.raises(ValueError):
        cosine_topk_cuda(q, x, k=257)
    with pytest.raises(ValueError):
        cosine_topk_cuda(q, x.T.contiguous().T, k=5)      # not contiguous
    with pytest.raises(TypeError):
        cosine_topk_cuda(q.double(), x, k=5)
    with pytest.raises(ValueError):
        cosine_topk_cuda(q.cpu(), x, k=5)


def _clustered(n=4096, d=64, centers=64, q=64, seed=11):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d))
    x = _unit(c[rng.integers(0, centers, n)] * 3.0 + rng.standard_normal((n, d)))
    return _unit(x[:q] + 0.1 * rng.standard_normal((q, d))), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "approx_width,acc_slots,k",
    [(0, 1, 10), (128, 1, 10), (128, 2, 20), (128, 4, 100), (256, 3, 10), (0, 1, 256)],
)
@pytest.mark.parametrize("block_q", [1, 8, 64])
def test_ivf_kernel_matches_plain(cuda, dtype, approx_width, acc_slots, k, block_q):
    q, x = _clustered()
    ivf = IVFIndex.build(
        torch.from_numpy(x).to(cuda),
        IndexConfig(num_clusters=16, num_probes=4, kmeans_iters=4, max_cluster_size=256),
        data_dtype=dtype, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda,
    )
    assert ivf.data_padded.shape[1] == 256
    qs, probes, _ = _plan_probes(
        torch.from_numpy(q).to(cuda), ivf.centroids, ivf.num_base_clusters,
        ivf.data_padded.shape[0], block_q, 8,
    )
    args = (qs, probes, ivf.data_padded, ivf.ids_padded, k, block_q, approx_width, acc_slots)
    before = ivf_scan_cuda.launches
    ks, ki = ivf_scan_cuda(*args)
    rs, ri = ivf_scan_reference(*args)
    torch.cuda.synchronize()
    assert ivf_scan_cuda.launches == before + 1
    _assert_agree(ks, ki, rs, ri, dtype == torch.float32)


@pytest.mark.parametrize("k", [1, 10, 20, 256])
@pytest.mark.parametrize("q_n", [1, 7, 33])
def test_topk_int8_kernel_matches_plain(cuda, k, q_n):
    """K3: f32 queries against int8 rows × scales; ties from duplicated
    rows. Scores allclose 1e-5, ids equal at separated ranks."""
    rng = np.random.default_rng(6)
    x = _unit(rng.standard_normal((10_007, 64)))
    src = rng.choice(5000, q_n, replace=False)
    x[5000 + np.arange(q_n)] = x[src]
    q = torch.from_numpy(_unit(x[src] + 0.05 * rng.standard_normal((q_n, 64)))).to(cuda)
    codes, scales = quantize_embeddings_int8(torch.from_numpy(x).to(cuda))
    before = cosine_topk_int8_cuda.launches
    ks, ki = cosine_topk_int8_cuda(q, codes, scales, k=k)
    rs, ri = cosine_topk_int8_reference(q, codes, scales, k=k)
    torch.cuda.synchronize()
    assert cosine_topk_int8_cuda.launches == before + 1
    _assert_agree(ks, ki, rs, ri, True)


@pytest.mark.parametrize(
    "approx_width,acc_slots,k",
    [(0, 1, 10), (0, 1, 20), (128, 1, 10), (128, 2, 20), (256, 2, 20), (128, 4, 100)],
)
@pytest.mark.parametrize("block_q", [1, 8, 64])
def test_ivf_int8_kernel_matches_plain(cuda, approx_width, acc_slots, k, block_q):
    """K4: int8 slabs × per-slot scales, queries rounded to bf16, exact and
    deferred modes. Scores allclose 1e-5, ids equal at separated ranks."""
    q, x = _clustered()
    ivf = IVFIndex.build(
        torch.from_numpy(x).to(cuda),
        IndexConfig(num_clusters=16, num_probes=4, kmeans_iters=4, max_cluster_size=256,
                    quantize_int8=True),
        generator=torch.Generator(device=cuda).manual_seed(0), device=cuda,
    )
    assert ivf.data_padded.dtype == torch.int8
    qs, probes, _ = _plan_probes(
        torch.from_numpy(q).to(cuda), ivf.centroids, ivf.num_base_clusters,
        ivf.data_padded.shape[0], block_q, 8,
    )
    args = (qs, probes, ivf.data_padded, ivf.ids_padded, k, block_q, approx_width, acc_slots)
    before = ivf_scan_cuda.launches_int8
    ks, ki = ivf_scan_cuda(*args, scales=ivf.scales_padded)
    rs, ri = ivf_scan_reference(*args, scales=ivf.scales_padded)
    torch.cuda.synchronize()
    assert ivf_scan_cuda.launches_int8 == before + 1
    _assert_agree(ks, ki, rs, ri, True)


def test_int8_wrappers_never_reach_the_plain_version(cuda, monkeypatch):
    """On CUDA tensors the dispatching wrappers launch K3 / K4; their plain
    versions are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(topk_mod, "cosine_topk_int8_reference", refuse)
    monkeypatch.setattr(ivf_mod, "ivf_scan_reference", refuse)
    q, x = _clustered()
    codes, scales = quantize_embeddings_int8(torch.from_numpy(x).to(cuda))
    before = cosine_topk_int8_cuda.launches
    cosine_topk_int8(torch.from_numpy(q).to(cuda), codes, scales, k=10)
    assert cosine_topk_int8_cuda.launches == before + 1
    ivf = IVFIndex.build(
        torch.from_numpy(x).to(cuda),
        IndexConfig(num_clusters=16, num_probes=4, kmeans_iters=2, quantize_int8=True),
        device=cuda,
    )
    before = ivf_scan_cuda.launches_int8
    ivf.query(torch.from_numpy(q).to(cuda), k=10, block_q=8)
    assert ivf_scan_cuda.launches_int8 == before + 1
    with pytest.raises(ValueError):   # int8 slabs without their scales
        ivf_scan(ivf.centroids[:8].contiguous(), torch.zeros((1, 1), dtype=torch.int32,
                 device=cuda), ivf.data_padded, ivf.ids_padded, 10, 8)


def test_int8_encoder_on_card_matches_cpu(cuda):
    """to_int8 on the card (torch._int_mm, one-row batches padded to its
    minimum) against the CPU (f32 compute): embeddings allclose 1e-4."""
    corpus = _corpus(200)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=1000, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    params = init_params(arch, torch.Generator().manual_seed(1))
    cpu = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION,
                          device="cpu").to_int8()
    card = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION,
                           device=cuda).to_int8()
    for texts in (corpus[:1], corpus[:3], corpus[:64]):
        np.testing.assert_allclose(card.encode(texts), cpu.encode(texts), atol=1e-4)


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}{i}" for i in range(3000)]
    return list(dict.fromkeys(" ".join(rng.choice(words, rng.integers(8, 25))) for _ in range(n)))


@pytest.mark.parametrize("use_ivf", [False, True])
def test_pipeline_on_card_matches_cpu(cuda, tmp_path, use_ivf):
    """The same saved encoder, store and index on the CPU and on the card
    (f32 encoder): the card's run launches its kernel and returns the CPU's
    documents (id overlap ≥ 0.99) with scores allclose 1e-4."""
    corpus = _corpus(3000)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=4000, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    params = init_params(arch, torch.Generator().manual_seed(0))
    cpu_enc = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    cpu = SemanticSearchPipeline(
        cpu_enc, corpus=corpus, use_ivf=use_ivf, device="cpu",
        index_config=IndexConfig(num_clusters=16, num_probes=4, kmeans_iters=4),
    )
    queries = corpus[:64]
    want = cpu(queries, 10)
    cpu.save(str(tmp_path / "pipe"))
    cpu_enc.save(str(tmp_path / "enc"))
    enc = SentenceEncoder.load(str(tmp_path / "enc"), bf16=False, device=cuda)
    pipe = SemanticSearchPipeline(enc, use_ivf=use_ivf, device=cuda)
    pipe.load_corpus(str(tmp_path / "pipe"))
    counter = ivf_scan_cuda if use_ivf else cosine_topk_cuda
    before = counter.launches
    got = pipe(queries, 10)
    assert counter.launches > before
    assert _overlap([[x[2] for x in r] for r in got], [[x[2] for x in r] for r in want]) >= 0.99
    np.testing.assert_allclose(
        [[x[1] for x in r] for r in got], [[x[1] for x in r] for r in want], atol=1e-4
    )
    if not use_ivf:
        # exact search finds each verbatim query first; a 64-query IVF
        # request shares one probe union, which need not hold every
        # query's own cluster
        for q, row in zip(queries, got):
            assert row[0][0] == q


def test_int8_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """The int8 serving path (to_int8 encoder, int8 IVF with the bf16
    rescore) on the CPU and on the card from one saved state: the card
    launches K4 and returns the CPU's documents (overlap ≥ 0.99), scores
    allclose 1e-4; add and remove work on the card's built index."""
    corpus = _corpus(3000)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=4000, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    params = init_params(arch, torch.Generator().manual_seed(0))
    cpu_enc = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION,
                              device="cpu").to_int8()
    cfg = dataclasses.replace(IndexConfig(num_clusters=16, num_probes=4, kmeans_iters=4),
                              quantize_int8=True)
    cpu = SemanticSearchPipeline(cpu_enc, corpus=corpus, use_ivf=True, index_config=cfg,
                                 device="cpu")
    queries = corpus[:64]
    want = cpu(queries, 10)
    cpu.save(str(tmp_path / "pipe"))
    cpu_enc.save(str(tmp_path / "enc"))
    enc = SentenceEncoder.load(str(tmp_path / "enc"), bf16=False, device=cuda)
    pipe = SemanticSearchPipeline(enc, use_ivf=True, device=cuda)
    pipe.load_corpus(str(tmp_path / "pipe"))
    assert pipe.ivf.data_padded.dtype == torch.int8
    before = ivf_scan_cuda.launches_int8
    got = pipe(queries, 10)
    assert ivf_scan_cuda.launches_int8 > before
    assert _overlap([[x[2] for x in r] for r in got], [[x[2] for x in r] for r in want]) >= 0.99
    np.testing.assert_allclose(
        [[x[1] for x in r] for r in got], [[x[1] for x in r] for r in want], atol=1e-4
    )
    new_id = int(pipe.add_documents(["a brand new document"])[0])
    assert pipe(["a brand new document"], 1)[0][0][2] == new_id
    pipe.remove_documents([new_id])
    assert all(x[2] != new_id for x in pipe(["a brand new document"], 10)[0])


# ---------------------------------------------------------------------------
# K5: flash attention forward
# ---------------------------------------------------------------------------

def _qkv_views(cuda, b, s, h, d, dtype, seed=0, tail=0):
    """q, k, v as the encoder hands them over: views of one fused
    (B, S, H, 3, D) tensor; with ``tail`` > 0, of the first S tokens of a
    (B, S + tail, H, 3, D) one, so the batch stride is not S × the token
    stride."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s + tail, h, 3, d, generator=g, device=cuda).to(dtype)[:, :s]
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,global_cls", [(0, False), (256, False), (256, True), (24, True)])
@pytest.mark.parametrize(
    "d,s,lens,tail",
    [(64, 1024, (1024, 701), 0), (32, 512, (512, 300, 0), 0), (128, 600, (600, 599, 64), 0),
     (64, 4096, (4096, 3968, 3969, 1), 0), (32, 4096, (4096, 3969), 0), (128, 4096, (4096, 1), 0),
     (64, 1000, (1000, 640), 24)],
)
def test_flash_kernel_matches_plain(cuda, dtype, window, global_cls, d, s, lens, tail):
    """K5 against its plain version on valid rows: f32 max |Δ| ≤ 1e-4; bf16
    max ≤ 1e-2 and mean ≤ 5e-4 (p rounds to bf16 against a running max in
    the kernel, a row max in the plain version); lse ≤ 1e-4; zero-length
    rows exactly 0. S 600 and 1000 are not multiples of the 64- or 128-row
    tiles; lengths 3968 and 3969 end on a 128-row tile edge and one past
    it; ``tail`` slices a longer fused QKV (batch stride ≠ S × token
    stride, for the TMA tensor maps)."""
    q, k, v = _qkv_views(cuda, len(lens), s, 4, d, dtype, tail=tail)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    out, lse = flash_attention_cuda(q, k, v, lengths, window, global_cls, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, lengths, window, global_cls, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    valid = torch.arange(s, device=cuda)[None, :] < lengths[:, None]
    diff = (out.float() - ref.float()).abs()[valid]
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert float(diff.max()) <= 1e-2 and float(diff.mean()) <= 5e-4
    assert float((lse - ref_lse).abs().transpose(1, 2)[valid].max()) <= 1e-4
    zero = lengths == 0
    assert bool((out[zero] == 0).all()) and bool((lse[zero] == 0).all())


def test_flash_strided_views_match_contiguous(cuda):
    """Views of the fused QKV and contiguous copies give the same bits."""
    q, k, v = _qkv_views(cuda, 2, 512, 12, 64, torch.bfloat16, seed=1)
    lengths = torch.tensor([512, 333], dtype=torch.int32, device=cuda)
    a = flash_attention_cuda(q, k, v, lengths, 256, True)
    b = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), lengths, 256, True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_kernel_refuses_what_it_cannot_run(cuda):
    """Inputs that need a gradient under grad mode (the kernel's output
    carries none: ``flash_attention`` runs K5 and K6 for them), other head
    dims, mixed dtypes, a non-contiguous last dim; no launch for any of
    them."""
    q, k, v = _qkv_views(cuda, 1, 256, 2, 64, torch.float32, seed=2)
    lengths = torch.tensor([256], dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError):
        flash_attention_cuda(q.clone().requires_grad_(), k, v, lengths)
    x = torch.randn(1, 256, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(x, x, x, lengths)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k.to(torch.bfloat16), v, lengths)
    with pytest.raises(ValueError):
        t = q.transpose(2, 3)
        flash_attention_cuda(t, t, t, lengths)
    assert flash_attention_cuda.launches == before


# ---------------------------------------------------------------------------
# K6: flash attention backward
# ---------------------------------------------------------------------------

# Limits on dq, dk, dv against the plain version, every row: |Δ| ≤ REL ·
# max(1, |ref|), since dv of the CLS key sums p · do over all 4096 rows and
# reaches |ref| ≈ 110. f32: 1e-4 (the two summation orders differ by 1.3e-4
# there). bf16: two bf16 ulps (2 · 2^-7), where the largest reading on an
# H100 is 6.7e-3, 0.86 ulp (one rounding of ds, p or the output turned the
# other way); mean |Δ| at 2.5x the largest reading, 2.4e-7.
K6_F32_REL, K6_BF16_REL, K6_BF16_MEAN = 1e-4, 2 * 2.0 ** -7, 6e-7


def _k6_inputs(cuda, b, s, h, d, dtype, lens, window, global_cls, seed=0, tail=0):
    """q, k, v as views of a fused QKV, K5's o and lse, and a random do that
    is nonzero on padded rows too."""
    q, k, v = _qkv_views(cuda, b, s, h, d, dtype, seed=seed, tail=tail)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out, lse = flash_attention_cuda(q, k, v, lengths, window, global_cls, return_lse=True)
    g = torch.Generator(device=cuda).manual_seed(seed + 100)
    do = torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
    return q, k, v, lengths, out, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,global_cls", [(0, False), (256, False), (256, True), (24, True)])
@pytest.mark.parametrize(
    "b,s,h,d,lens,tail",
    [(4, 4096, 12, 64, (4096, 3001, 3500, 4000), 0), (3, 512, 12, 32, (512, 300, 0), 0),
     (2, 600, 4, 128, (600, 64), 0), (4, 4096, 4, 64, (4096, 3968, 3969, 1), 0),
     (2, 4096, 4, 32, (4096, 3969), 0), (2, 4096, 4, 128, (4096, 1), 0),
     (2, 1000, 4, 64, (1000, 640), 24)],
)
def test_flash_backward_kernel_matches_plain(cuda, dtype, window, global_cls, b, s, h, d, lens,
                                             tail):
    """K6 against its plain version on the same o and lse, every row: |Δ| ≤
    ``K6_F32_REL`` (f32) or ``K6_BF16_REL`` (bf16) · max(1, |ref|), and for
    bf16 the mean ≤ ``K6_BF16_MEAN``;
    a zero-length row's gradients exactly 0; two launches a call. The
    first shape is phase 7's training shape; S 600 and 1000 are not
    multiples of the 64- or 128-row tiles; lengths 3968 and 3969 end on a
    128-row tile edge and one past it; ``tail`` slices a longer fused QKV
    (batch stride ≠ S × token stride, for the TMA tensor maps)."""
    args = _k6_inputs(cuda, b, s, h, d, dtype, lens, window, global_cls, tail=tail)
    before = flash_attention_backward_cuda.launches
    got = flash_attention_backward_cuda(*args, window, global_cls)
    want = flash_attention_backward_plain(*args, window, global_cls)
    torch.cuda.synchronize()
    assert flash_attention_backward_cuda.launches == before + 2
    zero = args[3] == 0
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == args[0].shape and x.dtype == dtype and x.is_contiguous()
        diff = (x.float() - y.float()).abs()
        rel = diff / y.float().abs().clamp_min(1.0)
        print(f"K6 {name} {str(dtype)[6:]} S={s} D={d} window={window} cls={global_cls}: "
              f"max|Δ| {float(diff.max()):.3e} mean|Δ| {float(diff.mean()):.3e} "
              f"max|Δ|/max(1,|ref|) {float(rel.max()):.3e} "
              f"(max|ref| {float(y.float().abs().max()):.3e})")
        if dtype == torch.float32:
            assert float(rel.max()) <= K6_F32_REL, name
        else:
            assert float(rel.max()) <= K6_BF16_REL and float(diff.mean()) <= K6_BF16_MEAN, name
        assert bool((x[zero] == 0).all()), name


def test_flash_backward_is_deterministic_and_reads_views(cuda):
    """Two runs give the same bits (no atomics), and views of the fused QKV
    give the bits of contiguous copies."""
    args = _k6_inputs(cuda, 2, 1024, 12, 64, torch.bfloat16, (1024, 700), 256, True, seed=3)
    a = flash_attention_backward_cuda(*args, 256, True)
    b = flash_attention_backward_cuda(*args, 256, True)
    q, k, v = (t.contiguous() for t in args[:3])
    c = flash_attention_backward_cuda(q, k, v, *args[3:], 256, True)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_flash_autograd_runs_k5_then_k6(cuda):
    """``flash_attention`` with grad: one K5 launch forward, two K6
    launches backward, and the gradients of the same loss through the
    autograd Function on the CPU (the plain versions), f32, allclose
    1e-4."""
    q, k, v = (t.detach() for t in _qkv_views(cuda, 2, 256, 4, 32, torch.float32, seed=4))
    mask = torch.ones((2, 256), dtype=torch.int32, device=cuda)
    mask[1, 200:] = 0
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        f0, b0 = flash_attention_cuda.launches, flash_attention_backward_cuda.launches
        out = flash_attention(*leaves, mask.to(dev), window=24, global_cls=True)
        (out.sin() * mask.to(dev)[:, :, None, None]).sum().backward()
        if dev == "cuda":
            assert flash_attention_cuda.launches == f0 + 1
            assert flash_attention_backward_cuda.launches == b0 + 2
        grads[dev] = [t.grad.cpu() for t in leaves]
    for x, y in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=0)


def test_train_step_on_card_matches_cpu(cuda):
    """The bi-encoder loss and its gradients at S 4096 (tiny long arch,
    f32, no dropout): on the card every layer runs K5 forward and K6
    backward (launches = layers × 2 towers, and twice that for K6), on the
    CPU the banded reference. The losses agree to 1e-5 and every gradient
    leaf to ‖Δg‖ ≤ 1e-3 · max(‖g‖, 1e-3 · ‖g of all leaves‖): the key bias's
    gradient is zero in exact arithmetic, and the token-type row sums
    gradients that cancel over 16k tokens."""
    from text_similarity_tpu_torch.train.optim import _leaves
    from text_similarity_tpu_torch.train.steps import bi_encoder_loss, trainable, value_and_grad

    params, arch = _long_tiny(seed=2)
    arch = arch.replace(hidden_dropout=0.0)
    rng = np.random.default_rng(5)
    s = 4096
    batch = {}
    for side, n in (("a", (4096, 3000)), ("b", (3500, 4096))):
        mask = (np.arange(s)[None] < np.asarray(n)[:, None]).astype(np.int32)
        batch[f"ids_{side}"] = (rng.integers(5, arch.vocab_size, (2, s)) * mask).astype(np.int32)
        batch[f"mask_{side}"] = mask
    batch["target"] = np.array([0.2, 0.9], np.float32)
    batch["valid"] = np.ones(2, np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        leaves = trainable({"encoder": params}, torch.device(dev))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        f0, b0 = flash_attention_cuda.launches, flash_attention_backward_cuda.launches
        loss, _, grads = value_and_grad(bi_encoder_loss, leaves, tb, arch=arch,
                                        precision=FP32_PRECISION, deterministic=True)
        if dev == "cuda":
            assert flash_attention_cuda.launches == f0 + 2 * arch.num_layers
            assert flash_attention_backward_cuda.launches == b0 + 4 * arch.num_layers
        out[dev] = (float(loss.detach()), [g.cpu() for g in _leaves(grads)])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    whole = float(torch.sqrt(sum((y * y).sum() for y in out["cpu"][1])))
    for name, x, y in zip(_flat_names({"encoder": params}), out["cuda"][1], out["cpu"][1]):
        floor = max(float(y.norm()), 1e-3 * whole)
        assert float((x - y).norm()) <= 1e-3 * floor, name


def _flat_names(tree, prefix=""):
    """Leaf paths of a nested dict, in its order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_names(v, path)
        else:
            yield path


def _long_tiny(seed=0, vocab_size=1024):
    """tiny-test made RoBERTa-like (position offset 2, pad id 1) with two
    heads of 32 (K5 takes D 32, 64, 128), positions tiled to 4098, band 256
    with a global CLS."""
    arch = ARCH_PRESETS["tiny-test"].replace(
        num_heads=2, position_offset=2, pad_token_id=1, type_vocab_size=1, vocab_size=vocab_size
    )
    params = init_params(arch, torch.Generator().manual_seed(seed))
    params, arch = extend_positions(params, arch, 4098)
    return params, arch.replace(attention_window=256, window_global_cls=True)


def test_encoder_auto_runs_k5_at_4096_only(cuda):
    """impl="auto" on the card: one K5 launch per layer at S 4096, none at
    S 1024; at S 4096 the f32 embeddings match the banded reference's
    (allclose 1e-4)."""
    params, arch = _long_tiny()
    tp = SentenceEncoder(params, arch, precision=FP32_PRECISION, device=cuda).params
    rng = np.random.default_rng(3)
    for s, want in ((4096, arch.num_layers), (1024, 0)):
        ids = torch.from_numpy(rng.integers(5, arch.vocab_size, (2, s)).astype(np.int32)).to(cuda)
        mask = torch.ones((2, s), dtype=torch.int32, device=cuda)
        mask[1, s * 3 // 4:] = 0
        before = flash_attention_cuda.launches
        auto = encoder_forward(tp, ids, mask, arch=arch, precision=FP32_PRECISION)
        assert flash_attention_cuda.launches == before + want
        ref = encoder_forward(tp, ids, mask, arch=arch, precision=FP32_PRECISION,
                              attention_impl="reference")
        for b, n in enumerate((s, s * 3 // 4)):
            torch.testing.assert_close(auto.last_hidden_state[b, :n], ref.last_hidden_state[b, :n],
                                       atol=1e-4, rtol=0)


def test_long_encode_on_card_matches_cpu(cuda):
    """Documents of 600-4000 tokens through SentenceEncoder.encode with the
    long-encode arguments: the card (K5 at bucket 4096) against the CPU
    (the banded reference), f32, allclose 1e-4."""
    rng = np.random.default_rng(4)
    # letter-only words: one token each, so the documents hold these counts
    words = [chr(97 + i % 26) + chr(97 + i // 26 % 26) + chr(97 + i // 676) for i in range(900)]
    corpus = [" ".join(rng.choice(words, n)) for n in (4000, 3100, 650, 900)]
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=2000, min_freq=1))
    params, arch = _long_tiny(seed=1, vocab_size=tok.vocab_size)
    kw = dict(max_len=4096, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096), batch_size=2)
    cpu = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    card = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION, device=cuda)
    before = flash_attention_cuda.launches
    got = card.encode(corpus, **kw)
    # batches of two by length: (650, 900) at bucket 1024, (3100, 4000) at 4096
    assert flash_attention_cuda.launches == before + arch.num_layers
    np.testing.assert_allclose(got, cpu.encode(corpus, **kw), atol=1e-4)


# ---------------------------------------------------------------------------
# The IVF scan modes: K1-opt (per_probe, emit_acc), K9 (packed), K10 (copy
# ring), K11a (several probes a step), K11b (idless)
# ---------------------------------------------------------------------------

def _scan_inputs(cuda, dtype, d, mc=200, c_tot=12, u=6, block_q=8, b=24, seed=0,
                 sentinel=False):
    """Random unit slabs (C_tot, Mc, d) with ~10% empty slots, queries in
    blocks of block_q and a probe list per block holding a −1 probe (block
    0) and the last slab (an overflow slab). ``sentinel``: d counts the
    trailing column (+2 live, 0 empty; the queries end in 1).
    → (q, probes, data, ids, scales or None)."""
    rng = np.random.default_rng(seed)
    base = d - 1 if sentinel else d
    x = _unit(rng.standard_normal((c_tot * mc, base)))
    ids = np.arange(c_tot * mc, dtype=np.int32)
    ids[rng.random(c_tot * mc) < 0.1] = -1
    q = _unit(x[rng.integers(0, c_tot * mc, b)] + 0.2 * rng.standard_normal((b, base)))
    if sentinel:
        x = np.concatenate([x, np.where(ids >= 0, 2.0, 0.0)[:, None]], axis=1).astype(np.float32)
        q = np.concatenate([q, np.ones((b, 1), np.float32)], axis=1)
    probes = np.stack([rng.choice(c_tot - 1, u - 1, replace=False) for _ in range(b // block_q)])
    probes = np.concatenate([probes, np.full((b // block_q, 1), c_tot - 1)], axis=1).astype(np.int32)
    probes[0, 1] = -1
    tx = torch.from_numpy(x).to(cuda)
    scales = None
    if dtype == torch.int8:
        tx, scales = quantize_embeddings_int8(tx)
        scales = scales.view(c_tot, mc).contiguous()
    else:
        tx = tx.to(dtype)
    return (torch.from_numpy(q).to(cuda), torch.from_numpy(probes).to(cuda),
            tx.view(c_tot, mc, d).contiguous(), torch.from_numpy(ids).view(c_tot, mc).to(cuda),
            scales)


def _agree_flat(ks, ki, rs, ri, dtype):
    """A kernel's (…, k) result against its plain version's at k + 1:
    scores allclose 1e-5; f32 and int8: ids equal at every rank whose plain
    score differs by > 1e-5 from both neighbours, the (k+1)-th included (a
    near-tie at the cut may go either way); bf16: overlap ≥ 0.99."""
    k = ks.shape[-1]
    ks, ki = (t.reshape(-1, k).cpu().numpy() for t in (ks, ki))
    rs, ri = (t.reshape(-1, k + 1).cpu().numpy() for t in (rs, ri))
    np.testing.assert_allclose(ks, rs[:, :k], atol=1e-5)
    if dtype == torch.bfloat16:
        # an empty result (−1) at rank j counts as its own id
        col = np.arange(k)
        assert _overlap(np.where(ki < 0, -1 - col, ki), np.where(ri[:, :k] < 0, -1 - col, ri[:, :k])) >= 0.99
        return
    with np.errstate(invalid="ignore"):
        gap = np.minimum(np.abs(np.diff(rs, axis=1, prepend=np.inf))[:, :k],
                         np.abs(np.diff(rs, axis=1)))
    sep = gap > 1e-5
    np.testing.assert_array_equal(ki[sep], ri[:, :k][sep])


@pytest.mark.parametrize("dtype,d,sentinel", [
    (dt, d, s) for dt in (torch.float32, torch.bfloat16, torch.int8)
    for d, s in ((64, False), (65, False), (33, True), (385, True))
    if not (dt == torch.int8 and s)           # the sentinel layout has no int8 form
])
def test_k1_opt_per_probe_matches_plain(cuda, dtype, d, sentinel):
    """K1-opt per_probe: (U, B, k), each probe's exact top-k, −1 probes
    empty; D+1 rows of no alignment."""
    q, probes, data, ids, scales = _scan_inputs(cuda, dtype, d, sentinel=sentinel)
    counter = "launches_per_probe_int8" if dtype == torch.int8 else "launches_per_probe"
    before = getattr(ivf_scan_cuda, counter)
    ks, ki = ivf_scan_cuda(q, probes, data, ids, 10, 8, scales=scales, per_probe=True)
    rs, ri = ivf_scan_reference(q, probes, data, ids, 11, 8, scales=scales, per_probe=True)
    torch.cuda.synchronize()
    assert getattr(ivf_scan_cuda, counter) == before + 1
    assert ks.shape == (6, 24, 10)
    assert (ki[1, :8] == -1).all() and torch.isinf(ks[1, :8]).all()   # the −1 probe
    _agree_flat(ks, ki, rs, ri, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d,mc,width,slots", [(64, 256, 128, 3), (385, 256, 256, 2),
                                              (65, 200, 200, 1)])
def test_k1_opt_emit_acc_matches_plain(cuda, dtype, d, mc, width, slots):
    """K1-opt emit_acc: the raw (B, S·w) accumulator, slot-major; entries
    equal (≥ 99% of ids, scores 1e-5 where the ids agree)."""
    q, probes, data, ids, scales = _scan_inputs(cuda, dtype, d, mc=mc, seed=1)
    counter = "launches_emit_acc_int8" if dtype == torch.int8 else "launches_emit_acc"
    before = getattr(ivf_scan_cuda, counter)
    ks, ki = ivf_scan_cuda(q, probes, data, ids, 10, 8, width, slots, scales, emit_acc=True)
    rs, ri = ivf_scan_reference(q, probes, data, ids, 10, 8, width, slots, scales, emit_acc=True)
    torch.cuda.synchronize()
    assert getattr(ivf_scan_cuda, counter) == before + 1
    assert ks.shape == (24, slots * width)
    same = (ki == ri).cpu().numpy()
    assert same.mean() >= 0.99
    np.testing.assert_allclose(ks.cpu().numpy()[same], rs.cpu().numpy()[same], atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [33, 65, 385])
@pytest.mark.parametrize("width,k", [(128, 10), (200, 20)])
def test_k11b_idless_matches_plain(cuda, dtype, d, width, k):
    """K11b: no ids read, flat slot ids, empty slots score 0 and compete."""
    mc = 256 if width == 128 else 200
    q, probes, data, ids, _ = _scan_inputs(cuda, dtype, d, mc=mc, sentinel=True, seed=2)
    before = ivf_modes.ivf_scan_idless_cuda.launches
    ks, ki = ivf_modes.ivf_scan_idless_cuda(q, probes, data, k, 8, width)
    rs, ri = ivf_modes.ivf_scan_idless_reference(q, probes, data, k + 1, 8, width)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_idless_cuda.launches == before + 1
    _agree_flat(ks, ki, rs, ri, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [64, 33, 385])
@pytest.mark.parametrize("per_step", [2, 3, 4, 6])
def test_k11a_multiprobe_matches_plain_and_k1(cuda, dtype, d, per_step):
    """K11a against its plain version, and bit for bit against K1's
    deferred fold at width Mc, S = 1 (U = 6: P = 4 pads the list; P = 6 is
    staged four slabs at a time)."""
    q, probes, data, ids, scales = _scan_inputs(cuda, dtype, d, seed=3)
    before = ivf_modes.ivf_scan_multiprobe_cuda.launches
    ks, ki = ivf_modes.ivf_scan_multiprobe_cuda(q, probes, data, ids, 10, 8, per_step, scales)
    rs, ri = ivf_modes.ivf_scan_multiprobe_reference(q, probes, data, ids, 11, 8, per_step, scales)
    ws, wi = ivf_scan_cuda(q, probes, data, ids, 10, 8, data.shape[1], 1, scales)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_multiprobe_cuda.launches == before + 1
    _agree_flat(ks, ki, rs, ri, dtype)
    assert torch.equal(ki, wi) and torch.equal(ks, ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 33, 65, 385])
@pytest.mark.parametrize("mc,slots,k", [(200, 1, 10), (256, 2, 50), (136, 1, 20)])
def test_k10_dma_matches_plain_and_k1(cuda, dtype, d, mc, slots, k):
    """K10 at an Mc that is not a multiple of 128 (200, 136) and at 256
    with two slots: against its plain version, bit for bit against K1 at
    (approx_width = Mc, acc_slots = S), and the same for 2, 3, 4 buffers."""
    q, probes, data, ids, _ = _scan_inputs(cuda, dtype, d, mc=mc, seed=4)
    before = ivf_modes.ivf_scan_dma_cuda.launches
    got = [ivf_modes.ivf_scan_dma_cuda(q, probes, data, ids, k, 8, slots, n) for n in (2, 3, 4)]
    rs, ri = ivf_modes.ivf_scan_dma_reference(q, probes, data, ids, k + 1, 8, slots)
    ws, wi = ivf_scan_cuda(q, probes, data, ids, k, 8, mc, slots)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_dma_cuda.launches == before + 3
    _agree_flat(*got[0], rs, ri, dtype)
    for ks, ki in got:
        assert torch.equal(ki, wi) and torch.equal(ks, ws)


def test_k10_reads_nothing_past_the_slabs(cuda):
    """bf16 rows of odd width end 2 bytes short of a 4-byte boundary: the
    last slab's last row is copied without reading past the tensor."""
    q, probes, data, ids, _ = _scan_inputs(cuda, torch.bfloat16, 33, mc=199, c_tot=3, u=3,
                                           seed=5, sentinel=True)
    assert data.numel() % 2 == 1      # the tensor ends 2 bytes past a 4-byte boundary
    ks, ki = ivf_modes.ivf_scan_dma_cuda(q, probes, data, ids, 10, 8, 1, 2)
    rs, ri = ivf_modes.ivf_scan_dma_reference(q, probes, data, ids, 11, 8, 1, 2)
    torch.cuda.synchronize()
    _agree_flat(ks, ki, rs, ri, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,mc,width,slots,k", [(64, 256, 128, 2, 50), (65, 200, 200, 1, 10),
                                                (385, 256, 256, 3, 100)])
def test_k9_packed_matches_plain(cuda, dtype, d, mc, width, slots, k):
    """K9: packets from the f32 score; a score within ~1e-6 of a bin edge
    may land in the neighbouring bin, so: unpacked scores within one bin,
    ids overlap ≥ 0.99."""
    from text_similarity_tpu_torch.index.ivf_modes import PACK_SCALE, _unpack_candidates

    q, probes, data, ids, _ = _scan_inputs(cuda, dtype, d, mc=mc, seed=6)
    before = ivf_modes.ivf_scan_packed_cuda.launches
    kp = ivf_modes.ivf_scan_packed_cuda(q, probes, data, ids, k, 8, width, slots)
    rp = ivf_modes.ivf_scan_packed_reference(q, probes, data, ids, k, 8, width, slots)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_packed_cuda.launches == before + 1
    ks, ki = (t.cpu().numpy() for t in _unpack_candidates(kp, probes, ids, 8))
    rs, ri = (t.cpu().numpy() for t in _unpack_candidates(rp, probes, ids, 8))
    assert _overlap(ki, ri) >= 0.99
    np.testing.assert_allclose(np.sort(ks, 1), np.sort(rs, 1), atol=1.0 / PACK_SCALE + 1e-6)
    assert (kp.cpu().numpy() == rp.cpu().numpy()).mean() >= 0.95


def test_k9_rejects_wide_unions_and_slabs(cuda):
    q, probes, data, ids, _ = _scan_inputs(cuda, torch.float32, 64, u=6)
    wide = probes.repeat(1, 11)                       # U = 66 > 64
    with pytest.raises(ValueError):
        ivf_modes.ivf_scan_packed_cuda(q, wide.contiguous(), data, ids, 10, 8)
    big = torch.zeros((2, 2056, 64), device=cuda)     # Mc > 2048
    with pytest.raises(ValueError):
        ivf_modes.ivf_scan_packed_cuda(q, probes.clamp(max=1).contiguous(), big,
                                     torch.zeros((2, 2056), dtype=torch.int32, device=cuda),
                                     10, 8)


@pytest.mark.parametrize("layout", ["sentinel", "group2", "int8"])
def test_query_options_on_card_match_cpu(cuda, monkeypatch, layout):
    """IVFIndex.query with every option on one index, on the card and on
    the CPU: each option launches a kernel (the plain versions refuse CUDA
    tensors here) and returns the CPU's ids (overlap ≥ 0.99), scores 1e-4
    (the packed fold: one bin)."""
    q, x = _clustered()
    opts = dict(sentinel=True) if layout == "sentinel" else (
        dict(group=2) if layout == "group2" else {})
    cfg = IndexConfig(num_clusters=16, num_probes=4, kmeans_iters=4, max_cluster_size=256,
                      quantize_int8=layout == "int8")
    cpu = IVFIndex.build(torch.from_numpy(x), cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", **opts)
    card = IVFIndex(
        cpu.centroids.to(cuda), cpu.data_padded.to(cuda), cpu.ids_padded.to(cuda),
        cpu.num_base_clusters, cfg,
        scales_padded=None if cpu.scales_padded is None else cpu.scales_padded.to(cuda),
        rescore_data=None if cpu.rescore_data is None else cpu.rescore_data.to(cuda),
        group=cpu.group,
    )
    cases = [dict(per_probe=True), dict(approx_width=128, final_merge="xla", k=20),
             dict(approx_width=256, probes_per_step=3)]
    if layout != "int8":
        cases += [dict(dma_pipeline=True, dma_buffers=3)]
    if layout == "group2":
        cases += [dict(approx_width=256, final_merge="packed")]
    if layout == "sentinel":   # the idless scan (one slot), K1 over D+1 slabs
        cases += [dict(approx_width=128, acc_slots=1), dict(approx_width=256),
                  dict(approx_width=0)]
    cases = [dict(dict(k=10, block_q=8, union_factor=1), **c) for c in cases]
    tq = torch.from_numpy(q)
    want = [cpu.query(tq, **args) for args in cases]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("scan_plain", "ivf_scan_packed_reference", "ivf_scan_dma_reference",
                 "ivf_scan_multiprobe_reference", "ivf_scan_idless_reference"):
        monkeypatch.setattr(ivf_modes, name, refuse)
    monkeypatch.setattr(ivf_mod, "ivf_scan_reference", refuse)
    for args, (rs, ri) in zip(cases, want):
        counts = _mode_counts()
        ks, ki = card.query(tq.to(cuda), **args)
        torch.cuda.synchronize()
        assert _mode_counts() != counts, args
        assert _overlap(ki.cpu().numpy(), ri.numpy()) >= 0.99, args
        tol = 1.0 / 8191.75 + 1e-6 if args.get("final_merge") == "packed" else 1e-4
        np.testing.assert_allclose(ks.cpu().numpy(), rs.numpy(), atol=tol)


def _mode_counts():
    return (ivf_scan_cuda.launches, ivf_scan_cuda.launches_int8,
            ivf_scan_cuda.launches_per_probe, ivf_scan_cuda.launches_per_probe_int8,
            ivf_scan_cuda.launches_emit_acc, ivf_scan_cuda.launches_emit_acc_int8,
            ivf_modes.ivf_scan_packed_cuda.launches, ivf_modes.ivf_scan_dma_cuda.launches,
            ivf_modes.ivf_scan_multiprobe_cuda.launches, ivf_modes.ivf_scan_idless_cuda.launches)


def test_sentinel_add_remove_on_card(cuda):
    """remove on a sentinel index on the card zeroes the column (the idless
    scan never returns the row), add writes +2 (the row finds itself)."""
    q, x = _clustered()
    ivf = IVFIndex.build(torch.from_numpy(x).to(cuda),
                         IndexConfig(num_clusters=16, num_probes=4, kmeans_iters=4),
                         sentinel=True, generator=torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    tq = torch.from_numpy(x[:8]).to(cuda)
    before = ivf_modes.ivf_scan_idless_cuda.launches
    args = dict(block_q=8, approx_width=128, acc_slots=1)
    _, i = ivf.query(tq, k=5, **args)
    assert (i[:, 0].cpu().numpy() == np.arange(8)).all()
    assert ivf.remove(np.arange(8)) == 8
    _, i = ivf.query(tq, k=5, **args)
    assert not np.isin(i.cpu().numpy(), np.arange(8)).any()
    new = ivf.add(tq[:4], start_id=4096)
    _, i = ivf.query(tq[:4], k=1, **args)
    assert (i[:, 0].cpu().numpy() == new).all()
    assert ivf_modes.ivf_scan_idless_cuda.launches == before + 3


# ---------------------------------------------------------------------------
# K7: packed attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(12, 32), (12, 64), (2, 128)])
@pytest.mark.parametrize("s,lens", [(128, (128, 77, 0, 1)), (200, (200, 64, 65, 0))])
def test_k7_matches_plain(cuda, dtype, h, d, s, lens):
    """K7 against its plain version on every row, padded query rows
    included: f32 max |Δ| ≤ 1e-4; bf16 max ≤ 1e-2 and mean ≤ 5e-4 (p / l
    rounds to bf16 from scores summed in another order); zero-length rows
    exactly 0; one launch. S 200 is not a multiple of the 64-row blocks."""
    q, k, v = _qkv_views(cuda, len(lens), s, h, d, dtype, seed=d + s)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = packed_attention_cuda.launches
    out = packed_attention_cuda(q, k, v, lengths)
    ref = packed_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert float(diff.max()) <= 1e-2 and float(diff.mean()) <= 5e-4
    assert bool((out[lengths == 0] == 0).all())


def test_k7_autograd_and_dispatch(cuda):
    """``multi_head_attention(impl="packed")`` on the card launches K7 once;
    with inputs that need a gradient the Function's forward is K7 and its
    gradients are autograd's of ``attention_reference`` with the mask (f32,
    1e-5); views of the fused QKV and contiguous copies give the same bits."""
    q, k, v = _qkv_views(cuda, 3, 96, 4, 32, torch.float32, seed=3)
    mask = (torch.arange(96, device=cuda)[None] < torch.tensor([[96], [40], [7]], device=cuda))
    mask = mask.to(torch.int32)
    before = packed_attention_cuda.launches
    out = multi_head_attention(q, k, v, mask, impl="packed")
    same = packed_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                 mask.sum(dim=1, dtype=torch.int32))
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches == before + 2 and torch.equal(out, same)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    do = torch.randn_like(out)
    got = torch.autograd.grad(packed_attention(*leaves, mask), leaves, do)
    assert packed_attention_cuda.launches == before + 3
    ref_leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*ref_leaves, mask), ref_leaves, do)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=1e-5)


def test_k7_refuses_what_it_cannot_run(cuda):
    """CPU tensors, a head count that does not fill 128 / D groups, other
    head dims, and inputs that need a gradient under grad mode: no launch."""
    q, k, v = _qkv_views(cuda, 1, 64, 4, 32, torch.float32, seed=4)
    lengths = torch.tensor([64], dtype=torch.int32, device=cuda)
    before = packed_attention_cuda.launches
    with pytest.raises(ValueError):
        packed_attention_cuda(q.cpu(), k.cpu(), v.cpu(), lengths.cpu())
    x = torch.randn(1, 64, 3, 32, device=cuda)
    with pytest.raises(ValueError):
        packed_attention_cuda(x, x, x, lengths)
    x = torch.randn(1, 64, 4, 48, device=cuda)
    with pytest.raises(ValueError):
        packed_attention_cuda(x, x, x, lengths)
    with pytest.raises(ValueError):
        packed_attention_cuda(q.clone().requires_grad_(), k, v, lengths)
    assert packed_attention_cuda.launches == before


def test_encoder_packed_impl_on_card(cuda):
    """``encoder_forward(attention_impl="packed")`` launches K7 once a layer
    and agrees with the reference impl on valid rows (f32, 1e-4)."""
    arch = ARCH_PRESETS["tiny-test"].replace(num_heads=4, hidden_size=128, intermediate_size=256)
    params = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                             precision=FP32_PRECISION, device=cuda).params
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(5, arch.vocab_size, (4, 64)).astype(np.int32)).to(cuda)
    lens = torch.tensor([64, 30, 5, 1], device=cuda)
    mask = (torch.arange(64, device=cuda)[None] < lens[:, None]).to(torch.int32)
    before = packed_attention_cuda.launches
    got = encoder_forward(params, ids, mask, arch=arch, precision=FP32_PRECISION,
                          attention_impl="packed").last_hidden_state
    want = encoder_forward(params, ids, mask, arch=arch, precision=FP32_PRECISION,
                           attention_impl="reference").last_hidden_state
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches == before + arch.num_layers
    valid = mask.bool()
    assert float((got - want).abs()[valid].max()) <= 1e-4


def test_packed_encode_on_card_matches_cpu(cuda):
    """``encode`` under ``packed="auto"`` packs short texts on the card as on
    the CPU; f32 embeddings allclose 1e-4, ``device_output`` on the card."""
    texts = _corpus(40, seed=3)
    vocab = train_wordpiece_vocab(texts, vocab_size=400, min_freq=1)
    tok = WordPieceTokenizer(vocab)
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    params = init_params(arch, torch.Generator().manual_seed(1))
    cpu = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    card = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION, device=cuda)
    rows = cpu._tokenize_rows(texts, 64)
    assert cpu.use_packed(rows, 128, (16, 32, 64))
    want = cpu.encode(texts, max_len=64, buckets=(16, 32, 64))
    got = card.encode(texts, max_len=64, buckets=(16, 32, 64), device_output=True)
    assert got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-4)


# ---------------------------------------------------------------------------
# K8: the certified two-pass top-k
# ---------------------------------------------------------------------------

def _k8_counts():
    return (topk_2pass_fold_cuda.launches, topk_2pass_count_cuda.launches,
            cosine_topk_2pass.fallbacks, cosine_topk_cuda.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 20])
@pytest.mark.parametrize("q_n", [1, 7, 33])
@pytest.mark.parametrize("block_c", [2048, 1000])
def test_k8_matches_plain(cuda, dtype, k, q_n, block_c):
    """K8 against its plain version on N = 10,007 (not a multiple of
    block_c) with tied rows: the fast path (one launch of each pass, no
    fallback), scores 1e-5, f32 ids equal where scores are separated, bf16
    overlap ≥ 0.99; each pass against its plain version too (the fold's
    winners as K2's test; the count exact at thresholds between scores)."""
    rng = np.random.default_rng(7)
    x = _unit(rng.standard_normal((10_007, 64)))
    src = rng.choice(5000, q_n, replace=False)
    x[5000 + np.arange(q_n)] = x[src]
    q = _unit(x[src] + 0.05 * rng.standard_normal((q_n, 64)))
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, dtype)
    before = _k8_counts()
    ks, ki = cosine_topk_2pass(tq, tx, k=k, block_c=block_c)
    torch.cuda.synchronize()
    fold, count, falls, k2 = (a - b for a, b in zip(_k8_counts(), before))
    assert (fold, count) == (1, 1) and falls == k2
    rs, ri = cosine_topk_2pass_reference(tq, tx, k=k, block_c=block_c)
    _assert_agree(ks, ki, rs, ri, dtype == torch.float32)
    fs, fi = topk_2pass_fold_cuda(tq, tx, k, block_c)
    ps, pi = topk_2pass_fold_plain(tq, tx, k, block_c)
    _assert_agree(fs, fi, ps, pi, dtype == torch.float32)
    thr = torch.from_numpy(rng.uniform(0.1, 0.5, q_n).astype(np.float32)).to(cuda)
    assert torch.equal(topk_2pass_count_cuda(tq, tx, thr, block_c),
                       topk_2pass_count_plain(tq, tx, thr, block_c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_collision_falls_back_to_k2(cuda, dtype):
    """Two near-copies of the query block_c rows apart share a lane class:
    the certification fails, the call falls back to K2 (one launch), and
    both copies are in the answer, which equals K2's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4096, 64)).astype(np.float32) * 0.01
    target = rng.standard_normal(64).astype(np.float32)
    x[5] = target + 0.001 * rng.standard_normal(64)
    x[5 + 2048] = target + 0.001 * rng.standard_normal(64)
    x = _unit(x)
    q = _unit(np.repeat(target[None], 8, axis=0))
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, dtype)
    before = _k8_counts()
    ks, ki = cosine_topk_2pass(tq, tx, k=10)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k8_counts(), before)) == (1, 1, 1, 1)
    es, ei = cosine_topk_cuda(tq, tx, 10)
    assert torch.equal(ki, ei) and torch.equal(ks, es)
    for row in ki.cpu().numpy():
        assert {5, 5 + 2048} <= set(row)


def test_k8_refuses_what_it_cannot_run(cuda):
    """CPU tensors, D not a multiple of 32, k above 256, a block_c out of
    range: no launch."""
    x = torch.nn.functional.normalize(torch.randn(1000, 64, device=cuda), dim=1)
    q = x[:4].contiguous()
    before = _k8_counts()
    with pytest.raises(ValueError):
        topk_2pass_fold_cuda(q.cpu(), x.cpu(), 5)
    with pytest.raises(ValueError):
        topk_2pass_count_cuda(q.cpu(), x.cpu(), torch.zeros(4), 2048)
    with pytest.raises(ValueError):
        topk_2pass_fold_cuda(q[:, :40].contiguous(), x[:, :40].contiguous(), 5)
    with pytest.raises(ValueError):
        topk_2pass_fold_cuda(q, x, 257)
    with pytest.raises(ValueError):
        topk_2pass_fold_cuda(q, x, 5, block_c=0)
    assert _k8_counts() == before
