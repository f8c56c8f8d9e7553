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
from text_similarity_tpu_torch.ops import _cuda
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
    cosine_topk_large_cuda,
    cosine_topk_int8,
    cosine_topk_int8_cuda,
    cosine_topk_int8_reference,
    cosine_topk_reference,
    topk_2pass_count_cuda,
    topk_2pass_count_plain,
    topk_2pass_fold_cuda,
    topk_2pass_fold_plain,
    topk_select_cuda,
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
        cosine_topk_cuda(q, x, k=1001)                    # k > N
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
# K1 (bf16 slabs) and K4 on the wgmma tile (csrc/ivf_tile.cu)
# ---------------------------------------------------------------------------

def _tile_inputs(cuda, dtype, d=384, mc=1024, c_tot=20, u=6, block_q=8, b=16, seed=0,
                 fill=None):
    """Random unit slabs (C_tot, Mc, d), each filled from the front to its
    own count (by default 0 for slab 1, 1..5% for slabs 2-4, else
    10-90%), then interior holes; queries near live rows in blocks of
    block_q; each block probes u − 2 slabs, slab 1 (wholly empty), a −1
    probe and C_tot + 3 (both outside [0, C_tot): skipped).
    → (q, probes, data, ids, scales or None)."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((c_tot * mc, d)))
    if fill is None:
        fill = rng.uniform(0.1, 0.9, c_tot)
        fill[1] = 0.0
        fill[2:5] = rng.uniform(0.01, 0.05, 3)
    ids = np.full((c_tot, mc), -1, np.int32)
    for c in range(c_tot):
        n = int(round(fill[c] * mc))
        ids[c, :n] = c * mc + np.arange(n)
    ids[(rng.random((c_tot, mc)) < 0.05) & (ids >= 0)] = -1     # interior holes
    live = np.flatnonzero(ids.reshape(-1) >= 0)
    q = _unit(x[rng.choice(live, b)] + 0.2 * rng.standard_normal((b, d)))
    n_blocks = b // block_q
    others = [c for c in range(c_tot) if c != 1]
    probes = np.stack([rng.choice(others, u - 2, replace=False) for _ in range(n_blocks)])
    outside = np.where(np.arange(n_blocks) % 2, c_tot + 3, -1)
    extra = np.stack([np.ones(n_blocks, np.int64), outside], axis=1)
    probes = np.concatenate([probes, extra], axis=1).astype(np.int32)
    tx = torch.from_numpy(x).to(cuda)
    scales = None
    if dtype == torch.int8:
        tx, scales = quantize_embeddings_int8(tx)
        scales = scales.view(c_tot, mc).contiguous()
    else:
        tx = tx.to(dtype)
    return (torch.from_numpy(q).to(cuda), torch.from_numpy(probes).to(cuda),
            tx.view(c_tot, mc, d).contiguous(), torch.from_numpy(ids).to(cuda), scales)


def _tile_launches(dtype):
    return ivf_scan_cuda.launches_tile_int8 if dtype == torch.int8 else ivf_scan_cuda.launches_tile


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("block_q", [1, 8, 64])
@pytest.mark.parametrize("width,slots,k", [
    (0, 0, 10), (0, 0, 20), (0, 0, 100), (0, 0, 256),
    (1024, 1, 10), (1024, 2, 20), (1024, 2, 100), (256, 1, 10), (256, 3, 100), (128, 4, 256),
])
def test_ivf_tile_matches_plain(cuda, dtype, block_q, width, slots, k):
    """K1 (bf16) and K4 on the wgmma tile at D 384, Mc 1024, in the exact
    mode and the deferred mode at w = Mc and w < Mc, S 1-4, k 10-256,
    over mostly empty and wholly empty slabs and probes outside [0,
    C_tot): against their plain versions (scores 1e-5; int8 ids equal at
    separated ranks, bf16 overlap ≥ 0.99)."""
    q, probes, data, ids, scales = _tile_inputs(cuda, dtype, block_q=block_q, b=2 * block_q,
                                                seed=block_q + slots)
    kind = 2 if dtype == torch.int8 else 1
    w = width or 1024
    assert ivf_mod.tile_plan_cuda(kind, 384, 1024, block_q, k, w, slots) is not None
    args = (q, probes, data, ids, k, block_q, width, slots or 1)
    before, tiles = ivf_scan_cuda.launches + ivf_scan_cuda.launches_int8, _tile_launches(dtype)
    ks, ki = ivf_scan_cuda(*args, scales=scales)
    rs, ri = ivf_scan_reference(*args, scales=scales)
    torch.cuda.synchronize()
    assert ivf_scan_cuda.launches + ivf_scan_cuda.launches_int8 == before + 1
    assert _tile_launches(dtype) == tiles + 1
    _assert_agree(ks, ki, rs, ri, dtype == torch.int8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("width,slots", [(0, 0), (1024, 1), (1024, 2)])
def test_ivf_tile_mostly_empty_slabs(cuda, dtype, width, slots):
    """Slabs 0-3% full (and one empty) at block_q 64: most tiles are
    skipped; the answer equals the plain version's, tails (−inf, −1)
    included."""
    fill = np.random.default_rng(9).uniform(0.0, 0.03, 20)
    fill[1] = 0.0
    q, probes, data, ids, scales = _tile_inputs(cuda, dtype, block_q=64, b=128, seed=9, fill=fill)
    args = (q, probes, data, ids, 20, 64, width, slots or 1)
    tiles = _tile_launches(dtype)
    ks, ki = ivf_scan_cuda(*args, scales=scales)
    rs, ri = ivf_scan_reference(*args, scales=scales)
    torch.cuda.synchronize()
    assert _tile_launches(dtype) == tiles + 1
    _assert_agree(ks, ki, rs, ri, dtype == torch.int8)
    assert torch.equal(ki < 0, ri < 0)
    _, skipped = ivf_mod.tile_occupancy(probes, ids, width or 1024)
    assert skipped > 0.8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_ivf_tile_probes_outside_the_slabs(cuda, dtype):
    """Probe ids outside [0, C_tot) scan nothing: a list of only such
    probes returns (−inf, −1) everywhere."""
    q, _, data, ids, scales = _tile_inputs(cuda, dtype, block_q=8, b=16)
    probes = torch.tensor([[-1, 20, 1 << 20], [-5, 21, 20]], dtype=torch.int32, device=cuda)
    for width, slots in ((0, 1), (1024, 2)):
        ks, ki = ivf_scan_cuda(q, probes, data, ids, 10, 8, width, slots, scales)
        torch.cuda.synchronize()
        assert torch.isneginf(ks).all() and (ki == -1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_ivf_tile_after_remove_and_add(cuda, dtype):
    """An index (D 384, Mc ≥ 1024) after remove() of rows at the front of
    its slabs, and after add() of rows that fill those holes and slots
    past the old fronts: the tile sees the ids, not the build's fill
    counts, and agrees with the plain version each time."""
    q, x = _clustered(n=4096, d=384, centers=8, q=64)
    ivf = IVFIndex.build(
        torch.from_numpy(x).to(cuda),
        IndexConfig(num_clusters=4, num_probes=2, kmeans_iters=4,
                    quantize_int8=dtype == torch.int8),
        data_dtype=torch.bfloat16, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda,
    )
    mc = ivf.data_padded.shape[1]
    assert mc >= 1024 and ivf.data_padded.dtype == dtype
    qs, probes, _ = _plan_probes(torch.from_numpy(q).to(cuda), ivf.centroids,
                                 ivf.num_base_clusters, ivf.data_padded.shape[0], 64, 4)
    front = ivf.ids_padded[:, :200]
    gone = front[front >= 0].cpu().numpy()
    assert ivf.remove(gone) == gone.size

    def check():
        for width, slots, k in ((0, 1, 10), (mc, 1, 10), (mc, 2, 20)):
            args = (qs, probes, ivf.data_padded, ivf.ids_padded, k, 64, width, slots)
            tiles = _tile_launches(dtype)
            ks, ki = ivf_scan_cuda(*args, scales=ivf.scales_padded)
            rs, ri = ivf_scan_reference(*args, scales=ivf.scales_padded)
            torch.cuda.synchronize()
            assert _tile_launches(dtype) == tiles + 1
            _assert_agree(ks, ki, rs, ri, dtype == torch.int8)
            assert not np.isin(ki.cpu().numpy(), gone).any()

    check()
    rng = np.random.default_rng(3)
    new = _unit(x[rng.choice(4096, gone.size + 300)] + 0.05 * rng.standard_normal((gone.size + 300, 384)))
    ivf.add(torch.from_numpy(new).to(cuda), start_id=10_000)
    check()


def test_ivf_tile_kernel_choice(cuda):
    """The kernel library's plan (the launcher's and the counters' rule):
    the main path's bf16 and int8 scans (D 384, block_q 64, deferred and
    exact) take the tile with 64 queries a CTA in two warpgroups of N 32;
    the pipeline's 1- and 5-text requests (block_q 1 and 8) one warpgroup
    of N 8; block_q 9-16 two of N 8, 17 the 64-query tile; the exact
    mode's k 256 fewer queries beside its selectors. f32 slabs, D not a
    multiple of 64 (the sentinel's 385), D 1024 and Mc % 4 ≠ 0 take the
    CUDA-core kernel. An f32 scan and a D-385 bf16 scan run there and count
    no tile launch."""
    plan = ivf_mod.tile_plan_cuda
    for kind, k, width, slots in ((1, 10, 1536, 1), (1, 100, 512, 2), (1, 10, 1536, 0),
                                  (2, 20, 1536, 2), (2, 20, 1536, 0)):
        p = plan(kind, 384, 1536, 64, k, width, slots)
        assert p[:3] == (64, 2, 32) and 2 <= p.stages <= 4 and p.smem <= 232448
    for kind, mc, k in ((1, 544, 10), (2, 552, 20)):
        for block_q in (1, 8):
            assert plan(kind, 384, mc, block_q, k, mc, 0)[:3] == (8, 1, 8)
    assert plan(1, 384, 1024, 16, 10, 1024, 1)[:3] == (16, 2, 8)
    assert plan(2, 384, 1024, 17, 10, 1024, 1)[:3] == (64, 2, 32)
    assert plan(1, 384, 1536, 64, 256, 1536, 0).nq < 64
    for args in ((0, 384, 1536, 64, 10, 1536, 1), (0, 384, 1536, 64, 10, 1536, 0),
                 (1, 385, 1536, 64, 10, 1536, 1), (2, 385, 1536, 64, 10, 1536, 0),
                 (1, 1024, 1536, 64, 10, 1536, 1), (2, 384, 202, 8, 10, 202, 0)):
        assert plan(*args) is None, args
    for dtype, d in ((torch.float32, 384), (torch.bfloat16, 385)):
        q, probes, data, ids, _ = _scan_inputs(cuda, dtype, d, mc=256)
        before, tiles = ivf_scan_cuda.launches, ivf_scan_cuda.launches_tile
        ivf_scan_cuda(q, probes, data, ids, 10, 8, 256, 1)
        assert ivf_scan_cuda.launches == before + 1 and ivf_scan_cuda.launches_tile == tiles


@pytest.mark.parametrize("width,slots", [(0, 0), (256, 1)])
def test_k4_equals_k1_over_widened_codes(cuda, width, slots):
    """K4's scores are K1's over ``codes.to(bf16)`` slabs × the slot's
    scale, bit for bit: both run the same bf16 product (K1's A from
    shared memory, K4's widened in registers). Exact mode with k 256 over
    two probed slabs of at most 128 live rows returns every live slot;
    the deferred fold at one slot keeps one a lane class."""
    q, _, codes, ids, scales = _tile_inputs(cuda, torch.int8, mc=256, c_tot=6, block_q=8, b=16,
                                            fill=np.array([0.4, 0.0, 0.45, 0.3, 0.5, 0.2]))
    probes = torch.tensor([[0, 2], [3, 5]], dtype=torch.int32, device=cuda)
    args = (q, probes, codes, ids, 256, 8, width, slots or 1)
    s4, i4 = ivf_scan_cuda(*args, scales=scales)
    s1, i1 = ivf_scan_cuda(q, probes, codes.to(torch.bfloat16), ids, 256, 8, width, slots or 1)
    torch.cuda.synchronize()
    s4, i4, s1, i1 = (t.cpu().numpy() for t in (s4, i4, s1, i1))
    ids_h, sc_h = ids.cpu().numpy().reshape(-1), scales.cpu().numpy().reshape(-1)
    scale_of = dict(zip(ids_h[ids_h >= 0].tolist(), sc_h[ids_h >= 0].tolist()))
    for r in range(q.shape[0]):
        got = {int(i): s for s, i in zip(s4[r], i4[r]) if i >= 0}
        raw = {int(i): s for s, i in zip(s1[r], i1[r]) if i >= 0}
        if width == 0:   # every live slot of the block's two slabs
            n_live = int((ids[probes[r // 8].long()] >= 0).sum())
            assert set(got) == set(raw) and len(got) == n_live
        both = set(got) & set(raw)
        assert both
        for i in both:
            assert got[i] == np.float32(raw[i]) * np.float32(scale_of[i]), (r, i)


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


def _emit_acc_select(q, probes, data, ids, k, block_q, width, slots, scales=None):
    """K1-opt emit_acc's raw accumulator at (width, S), then its exact
    top-k by (score desc, id asc), missing results (−inf, −1). Where the
    kernel library's plan takes the shape (bf16 or int8 slabs, D a multiple
    of 64, Mc a multiple of 4) emit_acc runs K1's deferred mode on the
    wgmma tile, so this equals K1 on the tile at (width, S) bit for bit;
    elsewhere it is K1's CUDA-core fold (the same pass, the same fmaf
    chain)."""
    acc_s, acc_i = ivf_scan_cuda(q, probes, data, ids, k, block_q, width, slots, scales,
                                 emit_acc=True)
    return ivf_modes._select(acc_s, acc_i, k)


def _agree_k1(ks, ki, q, probes, data, ids, k, block_q, width, slots, scales=None):
    """A scan's (B, k) against K1's merge at the same plan, bit for bit:
    where the kernel library's plan takes the shape both run K1's wgmma
    tile (the same product, the same fold), elsewhere both run the
    CUDA-core fold (the same pass and fmaf chain)."""
    ws, wi = ivf_scan_cuda(q, probes, data, ids, k, block_q, width, slots, scales)
    assert torch.equal(ki, wi) and torch.equal(ks, ws)


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
    tile_counter = counter.replace("probe", "probe_tile")
    on_tile = dtype != torch.float32 and d % 64 == 0   # f32, D 65 and 385: the CUDA cores
    before, tiles = getattr(ivf_scan_cuda, counter), getattr(ivf_scan_cuda, tile_counter)
    ks, ki = ivf_scan_cuda(q, probes, data, ids, 10, 8, scales=scales, per_probe=True)
    rs, ri = ivf_scan_reference(q, probes, data, ids, 11, 8, scales=scales, per_probe=True)
    torch.cuda.synchronize()
    assert getattr(ivf_scan_cuda, counter) == before + 1
    assert getattr(ivf_scan_cuda, tile_counter) == tiles + int(on_tile)
    assert ks.shape == (6, 24, 10)
    assert (ki[1, :8] == -1).all() and torch.isinf(ks[1, :8]).all()   # the −1 probe
    _agree_flat(ks, ki, rs, ri, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d,mc,width,slots", [(64, 256, 128, 3), (385, 256, 256, 2),
                                              (65, 200, 200, 1), (64, 200, 200, 2),
                                              (384, 1536, 512, 3)])
def test_k1_opt_emit_acc_matches_plain(cuda, dtype, d, mc, width, slots):
    """K1-opt emit_acc: the raw (B, S·w) accumulator, slot-major; entries
    equal (≥ 99% of ids, scores 1e-5 where the ids agree). bf16 and int8
    at D 64 and 384 run the wgmma tile's deferred mode (counted in
    ``launches_emit_acc_tile[_int8]``; w 200 ends in a range of 8 lanes,
    (384, 1536, 512, 3) is phase 5b's shape): there emit_acc plus the
    exact select equals K1 on the tile at (w, S) bit for bit, and an
    output one query longer keeps its last row (no lane class at or past
    w is written). f32 and D 65, 385 run the CUDA-core kernel."""
    q, probes, data, ids, scales = _scan_inputs(cuda, dtype, d, mc=mc, seed=1)
    kind = ivf_modes.data_kind(data)
    on_tile = ivf_mod.tile_plan_cuda(kind, d, mc, 8, 1, width, slots) is not None
    assert on_tile == (dtype != torch.float32 and d % 64 == 0)
    suffix = "_int8" if dtype == torch.int8 else ""
    before = getattr(ivf_scan_cuda, f"launches_emit_acc{suffix}")
    tiles = getattr(ivf_scan_cuda, f"launches_emit_acc_tile{suffix}")
    ks, ki = ivf_scan_cuda(q, probes, data, ids, 10, 8, width, slots, scales, emit_acc=True)
    rs, ri = ivf_scan_reference(q, probes, data, ids, 10, 8, width, slots, scales, emit_acc=True)
    torch.cuda.synchronize()
    assert getattr(ivf_scan_cuda, f"launches_emit_acc{suffix}") == before + 1
    assert getattr(ivf_scan_cuda, f"launches_emit_acc_tile{suffix}") == tiles + int(on_tile)
    assert ks.shape == (24, slots * width)
    same = (ki == ri).cpu().numpy()
    assert same.mean() >= 0.99
    np.testing.assert_allclose(ks.cpu().numpy()[same], rs.cpu().numpy()[same], atol=1e-5)
    if not on_tile:
        return
    for k in (10, 100):
        ws, wi = ivf_scan_cuda(q, probes, data, ids, k, 8, width, slots, scales)
        es, ei = ivf_modes._select(ks, ki, k)
        assert torch.equal(ei, wi) and torch.equal(es, ws), k
    b, n = ks.shape
    buf_s = torch.full((b + 1, n), float("nan"), device=cuda)
    buf_i = torch.full((b + 1, n), -7, dtype=torch.int32, device=cuda)
    err = _cuda.lib().ts_ivf_scan_emit_acc(
        q.data_ptr(), probes.data_ptr(), data.data_ptr(), kind,
        scales.data_ptr() if scales is not None else None, ids.data_ptr(), b, d,
        probes.shape[1], data.shape[0], mc, 8, width, slots, buf_s.data_ptr(), buf_i.data_ptr(),
        _cuda.stream_handle(q.device))
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(buf_s[:b], ks) and torch.equal(buf_i[:b], ki)
    assert torch.isnan(buf_s[b]).all() and (buf_i[b] == -7).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [33, 65, 385])
@pytest.mark.parametrize("width,k", [(128, 10), (200, 20)])
def test_k11b_idless_matches_plain(cuda, dtype, d, width, k):
    """K11b: no ids read, flat slot ids, empty slots score 0 and compete.
    bf16 at D + 1 = 65 and 385 runs the wgmma tile (Mc 256 at w 128; Mc
    200 at w 200: a last tile of 8 rows); f32 and D + 1 = 33 the CUDA-core
    kernel."""
    mc = 256 if width == 128 else 200
    q, probes, data, ids, _ = _scan_inputs(cuda, dtype, d, mc=mc, sentinel=True, seed=2)
    on_tile = dtype == torch.bfloat16 and d != 33
    before, tiles = ivf_modes.ivf_scan_idless_cuda.launches, ivf_modes.ivf_scan_idless_cuda.launches_tile
    ks, ki = ivf_modes.ivf_scan_idless_cuda(q, probes, data, k, 8, width)
    rs, ri = ivf_modes.ivf_scan_idless_reference(q, probes, data, k + 1, 8, width)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_idless_cuda.launches == before + 1
    assert ivf_modes.ivf_scan_idless_cuda.launches_tile == tiles + int(on_tile)
    assert (ivf_modes.tile_plan_cuda(ivf_modes.SENTINEL_KIND, d, mc, 8, k, width, 1) is not None
            ) == (d != 33)
    _agree_flat(ks, ki, rs, ri, dtype)


def _sentinel_slabs(cuda, d, mc, c_tot=10, b=32, seed=12):
    """bf16 sentinel slabs (C_tot, Mc, d = D + 1) built to exercise K11b's
    skip: slab 0 full; slab 1 never written (all zero); slab 2 live in its
    first 40 rows, the rest zero (whole zero tiles); slab 3 rows 0-63
    removed (vectors kept, +2 gone: a tile with no live row that is not
    zero) and 4 live rows after them; slab 4 live only in its last 8 rows;
    the last slab live to its end (its last tile is the tensor's last
    bytes); the others half full. Queries near slabs 0, 2 and 3's rows (the
    last column 1), in blocks of 8: block 0 probes the full and the mixed
    slabs, block 1 slabs 1, 3 (removed rows), 4 and a −1 (fewer live rows
    than k: zeros and removed rows fill the tails), block 2 every slab,
    block 3 slabs 2 and 4 twice. → (q, probes, data, the flat slot ids of
    the live and of the removed rows)."""
    rng = np.random.default_rng(seed)
    base = d - 1
    x = _unit(rng.standard_normal((c_tot * mc, base))).reshape(c_tot, mc, base)
    live = np.zeros((c_tot, mc), bool)
    written = np.zeros((c_tot, mc), bool)
    live[0] = True
    live[2, :40] = True
    written[3, :64] = True
    live[3, 64:68] = True
    live[4, mc - 8:] = True
    live[c_tot - 1, mc // 2:] = True
    for c in range(5, c_tot - 1):
        live[c, : mc // 2] = True
    written |= live
    data = np.where(written[..., None], x, 0.0)
    data = np.concatenate([data, np.where(live, 2.0, 0.0)[..., None]], axis=2)
    src = np.concatenate([x[0, :8], x[2, :8], x[3, :8], x[3, 64:72]])
    q = _unit(src + 0.1 * rng.standard_normal(src.shape))
    q = np.concatenate([q, np.ones((b, 1))], axis=1).astype(np.float32)
    probes = np.array([[0, 2, 5, 6], [1, 3, 4, -1], [c_tot - 1, 1, 3, 0], [2, 4, 2, 4]], np.int32)
    flat = np.arange(c_tot * mc).reshape(c_tot, mc)
    return (torch.from_numpy(q).to(cuda), torch.from_numpy(probes).to(cuda),
            torch.from_numpy(data.astype(np.float32)).to(cuda).to(torch.bfloat16).contiguous(),
            flat[live], flat[written & ~live])


def _expected_tile_counts(probes, zmap, mc, w):
    """(tiles of valid probes, tiles whose rows all lie in zero 64-row
    tiles) that the tile walks: each block's probes × chunks × 64-lane
    ranges."""
    listed = skipped = 0
    for row in probes.cpu().numpy():
        for c in row:
            if not 0 <= c < zmap.shape[0]:
                continue
            for ch in range(mc // w):
                for r0 in range(0, w, 64):
                    lo = ch * w + r0
                    hi = lo + min(64, w - r0) - 1
                    listed += 1
                    skipped += int(zmap[c, lo // 64] and zmap[c, hi // 64])
    return listed, skipped


@pytest.mark.parametrize("d", [65, 385])
@pytest.mark.parametrize("mc,width,k", [(256, 256, 100), (256, 128, 100), (200, 200, 100),
                                        (456, 152, 100), (1536, 1536, 20)])
def test_k11b_tile_skips_zero_tiles_exactly(cuda, d, mc, width, k):
    """K11b on the wgmma tile over whole zero tiles, a wholly zero probed
    slab, removed rows in tiles with no live row, a block whose probes hold
    fewer live rows than k (zeros and removed rows fill its tails), w < Mc
    and Mc % 64 ≠ 0 (the last slab's last tile copied short): against the
    plain version (scores 1e-5; ids equal where the plain scores are
    separated, and at every exact 0, where both break ties by the lowest
    flat id); the kernel's counter equals the tiles of valid probes and
    the zero tiles among them, and the map the wrapper builds equals the
    index's."""
    q, probes, data, live, removed = _sentinel_slabs(cuda, d, mc)
    zmap = ivf_modes.zero_tile_map(data)
    counts = torch.zeros(2, dtype=torch.int32, device=cuda)
    tiles = ivf_modes.ivf_scan_idless_cuda.launches_tile
    ks, ki = ivf_modes.ivf_scan_idless_cuda(q, probes, data, k, 8, width, zmap, counts)
    ks2, ki2 = ivf_modes.ivf_scan_idless_cuda(q, probes, data, k, 8, width)   # builds the map
    rs, ri = ivf_modes.ivf_scan_idless_reference(q, probes, data, k + 1, 8, width)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_idless_cuda.launches_tile == tiles + 2
    assert torch.equal(ks, ks2) and torch.equal(ki, ki2)
    listed, skipped = _expected_tile_counts(probes, zmap.cpu().numpy(), mc, width)
    assert tuple(counts.cpu().tolist()) == (listed, skipped) and skipped > 0
    ks_h, ki_h, rs_h, ri_h = (t.cpu().numpy() for t in (ks, ki, rs, ri))
    np.testing.assert_allclose(ks_h, rs_h[:, :k], atol=1e-5)
    with np.errstate(invalid="ignore"):
        gap = np.minimum(np.abs(np.diff(rs_h, axis=1, prepend=np.inf))[:, :k],
                         np.abs(np.diff(rs_h, axis=1)))
    check = (gap > 1e-5) | ((rs_h[:, :k] == 0) & (ks_h == 0))
    np.testing.assert_array_equal(ki_h[check], ri_h[:, :k][check])
    # block 1 holds 12 live rows: removed rows (q·x) and, past them at k
    # 100, never-written slots (0) fill its tails
    tail_i, tail_s = ki_h[8:16, 12:], ks_h[8:16, 12:]
    assert not np.isin(tail_i, live).any() and np.isin(tail_i, removed).any()
    assert k < 100 or (tail_s == 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [64, 33, 385])
@pytest.mark.parametrize("per_step", [2, 3, 4, 6])
def test_k11a_multiprobe_matches_plain_and_k1(cuda, dtype, d, per_step):
    """K11a against its plain version, and bit for bit against K1 at width
    Mc, S = 1 over the unpadded list, and against emit_acc + the exact
    select at (Mc, 1) (U = 6: P = 4 pads the list to 8). K11a runs K1 at
    (Mc, 1): bf16 and int8 at D 64 on the wgmma tile (counted in
    ``launches_tile``), where emit_acc runs too; f32 and D 33, 385 on K1's
    CUDA-core kernel, held to the CUDA-core emit_acc + select."""
    q, probes, data, ids, scales = _scan_inputs(cuda, dtype, d, seed=3)
    mc = data.shape[1]
    on_tile = ivf_mod.tile_plan_cuda(ivf_modes.data_kind(data), d, mc, 8, 10, mc, 1) is not None
    assert on_tile == (dtype != torch.float32 and d == 64)
    before = ivf_modes.ivf_scan_multiprobe_cuda.launches
    tiles = ivf_modes.ivf_scan_multiprobe_cuda.launches_tile
    ks, ki = ivf_modes.ivf_scan_multiprobe_cuda(q, probes, data, ids, 10, 8, per_step, scales)
    rs, ri = ivf_modes.ivf_scan_multiprobe_reference(q, probes, data, ids, 11, 8, per_step, scales)
    ws, wi = _emit_acc_select(q, probes, data, ids, 10, 8, mc, 1, scales)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_multiprobe_cuda.launches == before + 1
    assert ivf_modes.ivf_scan_multiprobe_cuda.launches_tile == tiles + int(on_tile)
    _agree_flat(ks, ki, rs, ri, dtype)
    assert torch.equal(ki, wi) and torch.equal(ks, ws)
    _agree_k1(ks, ki, q, probes, data, ids, 10, 8, mc, 1, scales)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 33, 65, 385, 384])
@pytest.mark.parametrize("mc,slots,k", [(200, 1, 10), (256, 2, 50), (136, 1, 20),
                                        (1536, 3, 100), (256, 4, 50), (1536, 1, 10)])
def test_k10_dma_matches_plain_and_k1(cuda, dtype, d, mc, slots, k):
    """K10 at an Mc that is not a multiple of 128 (200, 136), at 256 and
    1536 with 1-4 slots, for 2, 3, 4 buffers: against its plain version,
    and bit for bit against K1 at (approx_width = Mc, acc_slots = S) and
    against emit_acc + the exact select there. K10 runs K1 at (Mc, S):
    bf16 at D 64 and 384 on the wgmma tile (counted in ``launches_tile``),
    where emit_acc runs too; f32 and D 33, 65, 385 on K1's CUDA-core
    kernel, held to the CUDA-core emit_acc + select."""
    q, probes, data, ids, _ = _scan_inputs(cuda, dtype, d, mc=mc, seed=4)
    on_tile = ivf_mod.tile_plan_cuda(ivf_modes.data_kind(data), d, mc, 8, k, mc, slots) is not None
    assert on_tile == (dtype == torch.bfloat16 and d % 64 == 0)
    before = ivf_modes.ivf_scan_dma_cuda.launches
    tiles = ivf_modes.ivf_scan_dma_cuda.launches_tile
    got = [ivf_modes.ivf_scan_dma_cuda(q, probes, data, ids, k, 8, slots, n) for n in (2, 3, 4)]
    rs, ri = ivf_modes.ivf_scan_dma_reference(q, probes, data, ids, k + 1, 8, slots)
    ws, wi = _emit_acc_select(q, probes, data, ids, k, 8, mc, slots)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_dma_cuda.launches == before + 3
    assert ivf_modes.ivf_scan_dma_cuda.launches_tile == tiles + (3 if on_tile else 0)
    _agree_flat(*got[0], rs, ri, dtype)
    for ks, ki in got:
        assert torch.equal(ki, wi) and torch.equal(ks, ws)
        _agree_k1(ks, ki, q, probes, data, ids, k, 8, mc, slots)


def test_k10_ring_depth_follows_buffers(cuda):
    """K10's ring is ``n_buffers`` stages deep, capped by what shared
    memory holds beside the queries: at the main path's shape (bf16, D
    384, Mc 1536, block_q 64) 2, 3 and 3 stages for 2, 3 and 4 buffers —
    the tile's own depth for K1 there."""
    own = ivf_mod.tile_plan_cuda(1, 384, 1536, 64, 10, 1536, 1).stages
    assert own == 3
    for nb in (2, 3, 4):
        for k, s in ((10, 1), (100, 2)):
            plan = ivf_mod.tile_plan_cuda(1, 384, 1536, 64, k, 1536, s, nb)
            assert plan.stages == min(nb, own) and plan[:3] == (64, 2, 32)


def test_k10_reads_nothing_past_the_slabs(cuda):
    """bf16 rows of odd width end 2 bytes short of a 4-byte boundary: the
    last slab's last row is read without reading past the tensor."""
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
    on_tile = dtype == torch.bfloat16 and d % 64 == 0   # f32, D 65 and 385: the CUDA cores
    before = ivf_modes.ivf_scan_packed_cuda.launches
    tiles = ivf_modes.ivf_scan_packed_cuda.launches_tile
    kp = ivf_modes.ivf_scan_packed_cuda(q, probes, data, ids, k, 8, width, slots)
    rp = ivf_modes.ivf_scan_packed_reference(q, probes, data, ids, k, 8, width, slots)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_packed_cuda.launches == before + 1
    assert ivf_modes.ivf_scan_packed_cuda.launches_tile == tiles + int(on_tile)
    ks, ki = (t.cpu().numpy() for t in _unpack_candidates(kp, probes, ids, 8))
    rs, ri = (t.cpu().numpy() for t in _unpack_candidates(rp, probes, ids, 8))
    assert _overlap(ki, ri) >= 0.99
    np.testing.assert_allclose(np.sort(ks, 1), np.sort(rs, 1), atol=1.0 / PACK_SCALE + 1e-6)
    assert (kp.cpu().numpy() == rp.cpu().numpy()).mean() >= 0.95


def _exact_inputs(cuda, dtype, d, mc=200, c_tot=10, u=5, block_q=8, b=16, seed=20):
    """Slabs whose every score is exact in f32 whatever the order of its
    sum: entries and queries in {−1, 0, 1} / 16 (int8: codes in {−1, 0,
    1} with per-slot scales 2^−3 … 2^−6), D ≤ 384, so each partial sum is
    a multiple of 2^−8 (int8: 2^−4 before its scale) below 2; scores tie
    often, so the lowest-id rule decides. About 10% of the slots are
    empty, slab 0's rows 64-127 are all empty (a wholly empty 64-row
    tile), Mc 200 ends in a tile of 8 rows, and block 0 probes −1.
    → (q, probes, data, ids, scales or None)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, 2, (b, d)).astype(np.float32) / 16
    codes = rng.integers(-1, 2, (c_tot * mc, d))
    ids = np.arange(c_tot * mc, dtype=np.int32)
    ids[rng.random(c_tot * mc) < 0.1] = -1
    ids[64:128] = -1
    probes = np.stack([rng.choice(c_tot, u, replace=False) for _ in range(b // block_q)])
    probes[0, 1] = -1
    scales = None
    if dtype == torch.int8:
        x = torch.from_numpy(codes.astype(np.int8)).to(cuda)
        sc = 2.0 ** -rng.integers(3, 7, c_tot * mc)
        scales = torch.from_numpy(sc.astype(np.float32)).view(c_tot, mc).to(cuda)
    else:
        x = torch.from_numpy(codes.astype(np.float32) / 16).to(cuda).to(dtype)
    return (torch.from_numpy(q).to(cuda), torch.from_numpy(probes.astype(np.int32)).to(cuda),
            x.view(c_tot, mc, d).contiguous(), torch.from_numpy(ids).view(c_tot, mc).to(cuda),
            scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("block_q", [8, 16, 64])
@pytest.mark.parametrize("d,k", [(64, 10), (384, 10), (128, 100)])
def test_k1_opt_per_probe_on_tile_exact(cuda, dtype, block_q, d, k):
    """K1-opt per_probe on the wgmma tile (the plans of 8, 16 and 64
    queries a CTA; k 10 in a list of 32, k 100 through the selector) over
    exactly representable scores: (U, B, k) equal to the plain version's
    bit for bit, scores and ids with the lowest-id rule, the −1 probe's
    rows (−inf, −1); and its per-probe top-k's pooled to (B, U·k) and
    selected equal to K1's exact mode on the tile bit for bit. Counted in
    ``launches_per_probe_tile[_int8]``."""
    q, probes, data, ids, scales = _exact_inputs(cuda, dtype, d, block_q=block_q, b=2 * block_q)
    kind = ivf_modes.data_kind(data)
    plan = ivf_mod.tile_plan_cuda(kind, d, 200, block_q, k, 200, 0)
    assert plan is not None and plan.nq == block_q
    suffix = "_int8" if dtype == torch.int8 else ""
    tiles = getattr(ivf_scan_cuda, f"launches_per_probe_tile{suffix}")
    ks, ki = ivf_scan_cuda(q, probes, data, ids, k, block_q, scales=scales, per_probe=True)
    rs, ri = ivf_scan_reference(q, probes, data, ids, k, block_q, scales=scales, per_probe=True)
    torch.cuda.synchronize()
    assert getattr(ivf_scan_cuda, f"launches_per_probe_tile{suffix}") == tiles + 1
    assert torch.equal(ks, rs) and torch.equal(ki, ri)
    assert (ki[1, :block_q] == -1).all() and torch.isneginf(ks[1, :block_q]).all()
    u, b = probes.shape[1], q.shape[0]
    pooled = ivf_modes._select(ks.permute(1, 0, 2).reshape(b, u * k),
                               ki.permute(1, 0, 2).reshape(b, u * k), k)
    k1_tiles = _tile_launches(dtype)
    ws, wi = ivf_scan_cuda(q, probes, data, ids, k, block_q, scales=scales)
    torch.cuda.synchronize()
    assert _tile_launches(dtype) == k1_tiles + 1
    assert torch.equal(pooled[0], ws) and torch.equal(pooled[1], wi)


@pytest.mark.parametrize("block_q", [8, 16, 64])
@pytest.mark.parametrize("d,mc,width,slots,k", [(64, 200, 200, 1, 10), (384, 256, 128, 2, 50),
                                                (128, 256, 256, 3, 100), (64, 512, 128, 4, 200)])
def test_k9_on_tile_packets_exact(cuda, block_q, d, mc, width, slots, k):
    """K9 on the wgmma tile (bf16; 8, 16 and 64 queries a CTA; S 1-4, a
    last range of 8 lanes at w 200) over exactly representable scores: its
    (B, k) packets equal ``ivf_scan_packed_reference``'s bit for bit, an
    empty tile and the −1 probe skipped. Counted in
    ``ivf_scan_packed_cuda.launches_tile``."""
    q, probes, data, ids, _ = _exact_inputs(cuda, torch.bfloat16, d, mc=mc, block_q=block_q,
                                            b=2 * block_q)
    assert ivf_mod.tile_plan_cuda(1, d, mc, block_q, k, width, slots) is not None
    tiles = ivf_modes.ivf_scan_packed_cuda.launches_tile
    kp = ivf_modes.ivf_scan_packed_cuda(q, probes, data, ids, k, block_q, width, slots)
    rp = ivf_modes.ivf_scan_packed_reference(q, probes, data, ids, k, block_q, width, slots)
    torch.cuda.synchronize()
    assert ivf_modes.ivf_scan_packed_cuda.launches_tile == tiles + 1
    assert torch.equal(kp, rp)


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
@pytest.mark.parametrize("s,lens", [(128, (128, 77, 0, 1)), (200, (200, 64, 65, 0)),
                                    (1, (1, 0)), (16, (16, 0, 1, 9)), (127, (127, 0, 1, 100)),
                                    (129, (129, 0, 1, 128))])
def test_k7_matches_plain(cuda, dtype, h, d, s, lens):
    """K7 against its plain version on every row, padded query rows
    included: f32 max |Δ| ≤ 1e-4; bf16 max ≤ 1e-2 and mean ≤ 5e-4 (p / l
    rounds to bf16 from scores summed in another order); zero-length rows
    exactly 0; one launch, on the one-sweep kernel (as the kernel library
    reports its choice) exactly for bf16 at S ≤ 128 (S 128 and 129 sit on
    either side of that boundary). S 1, 16, 127 and 200 are not multiples
    of the 64-row blocks; q, k and v are views of a fused QKV."""
    q, k, v = _qkv_views(cuda, len(lens), s, h, d, dtype, seed=d + s)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = packed_attention_cuda.launches
    one = packed_attention_cuda.launches_one_sweep
    out = packed_attention_cuda(q, k, v, lengths)
    ref = packed_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches == before + 1
    assert packed_attention_cuda.launches_one_sweep - one == (dtype == torch.bfloat16 and s <= 128)
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert float(diff.max()) <= 1e-2 and float(diff.mean()) <= 5e-4
    assert bool((out[lengths == 0] == 0).all())


@pytest.mark.parametrize("b,s,h,d", [(64, 128, 12, 32), (48, 100, 4, 128), (512, 16, 12, 32)])
def test_k7_one_sweep_walks_many_heads(cuda, b, s, h, d):
    """A grid of more (b, h) CTAs of the one-sweep kernel than fit on the
    card at once, lengths from 0 to S: every row against the plain version
    (bf16 max ≤ 1e-2, mean ≤ 5e-4), zero-length rows exactly 0, and the
    one-sweep kernel the one that ran."""
    q, k, v = _qkv_views(cuda, b, s, h, d, torch.bfloat16, seed=b + s)
    g = torch.Generator(device=cuda).manual_seed(s)
    lengths = torch.randint(0, s + 1, (b,), generator=g, device=cuda, dtype=torch.int32)
    lengths[0], lengths[-1] = 0, s
    one = packed_attention_cuda.launches_one_sweep
    out = packed_attention_cuda(q, k, v, lengths)
    ref = packed_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches_one_sweep == one + 1
    diff = (out.float() - ref.float()).abs()
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
    """CPU tensors, D not a multiple of 32, k above N, a block_c out of
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
        topk_2pass_fold_cuda(q, x, 1001)
    with pytest.raises(ValueError):
        topk_2pass_fold_cuda(q, x, 5, block_c=0)
    assert _k8_counts() == before


# ---------------------------------------------------------------------------
# The score tile of K2, K3 and K8 (csrc/score_tile.cuh): QT 16, 64 and 128
# ---------------------------------------------------------------------------

def _tile_data(q_n, d, seed=8):
    """N = 10,007 unit rows (not a multiple of 128) with a copy of each
    query's source row (exact ties, one reference chunk); queries near
    those rows."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((10_007, d)))
    src = rng.choice(5000, q_n, replace=False)
    x[5000 + np.arange(q_n)] = x[src]
    return _unit(x[src] + 0.05 * rng.standard_normal((q_n, d))), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("d", [32, 384, 1024])
@pytest.mark.parametrize("q_n", [1, 63, 64, 65, 129, 256])
def test_score_tile_k2_matches_plain(cuda, dtype, k, d, q_n):
    """K2 on every query tile (QT 16, 64, 128 by Q, capped by k) and D,
    against its plain version: scores 1e-5, f32 ids equal where separated,
    bf16 overlap ≥ 0.99."""
    q, x = _tile_data(q_n, d)
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, dtype)
    ks, ki = cosine_topk_cuda(tq, tx, k=k)
    rs, ri = cosine_topk_reference(tq, tx, k=k)
    _assert_agree(ks, ki, rs, ri, dtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("d", [32, 384, 1024])
@pytest.mark.parametrize("q_n", [1, 63, 64, 65, 129, 256])
def test_score_tile_k8_matches_plain(cuda, dtype, k, d, q_n):
    """K8 on every query tile and D against its plain version: the call
    (falling back exactly where the plain version does), pass A alone, and
    pass B on the tile and over pass A's kept scores (exact counts at
    thresholds between scores)."""
    q, x = _tile_data(q_n, d)
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, dtype)
    falls = cosine_topk_2pass.fallbacks
    ks, ki = cosine_topk_2pass(tq, tx, k=k)
    fell = cosine_topk_2pass.fallbacks - falls
    rs, ri = cosine_topk_2pass_reference(tq, tx, k=k)
    assert cosine_topk_2pass.fallbacks - falls - fell == fell
    _assert_agree(ks, ki, rs, ri, dtype == torch.float32)
    fs, fi = topk_2pass_fold_cuda(tq, tx, k)
    ps, pi = topk_2pass_fold_plain(tq, tx, k, 2048)
    _assert_agree(fs, fi, ps, pi, dtype == torch.float32)
    # thresholds halfway between the plain scores at the k-th rank and the
    # next, where that gap is wide: no score lies near them
    es, _ = cosine_topk_reference(tq, tx, k=k + 1)
    wide = (es[:, k - 1] - es[:, k]) > 1e-4
    thr = torch.where(wide, 0.5 * (es[:, k - 1] + es[:, k]), torch.full_like(es[:, 0], 2.0))
    want = topk_2pass_count_plain(tq, tx, thr, 2048)
    assert torch.equal(topk_2pass_count_cuda(tq, tx, thr), want)
    _, _, kept = topk_mod._fold_cuda(tq, tx, k, 2048, True)
    assert torch.equal(topk_2pass_count_cuda(tq, tx, thr, scores=kept), want)


@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("d", [32, 384, 1024])
@pytest.mark.parametrize("q_n", [1, 63, 64, 65, 129, 256])
def test_score_tile_k3_matches_plain(cuda, k, d, q_n):
    """K3 on every query tile (QT 16, 64, 128 by Q, capped by k) and D, N
    10,007 (not a multiple of 128) with exact ties, against its plain
    version: scores 1e-5, ids equal where separated; one launch."""
    q, x = _tile_data(q_n, d)
    tq = torch.from_numpy(q).to(cuda)
    codes, scales = quantize_embeddings_int8(torch.from_numpy(x).to(cuda))
    before = cosine_topk_int8_cuda.launches
    ks, ki = cosine_topk_int8_cuda(tq, codes, scales, k=k)
    rs, ri = cosine_topk_int8_reference(tq, codes, scales, k=k)
    torch.cuda.synchronize()
    assert cosine_topk_int8_cuda.launches == before + 1
    _assert_agree(ks, ki, rs, ri, True)


def test_k3_answer_independent_of_q(cuda):
    """A query's K3 scores and ids are equal bit for bit in calls of 1, 64
    and 256 queries (query tiles 16, 64 and 128)."""
    q, x = _tile_data(256, 384, seed=9)
    tq = torch.from_numpy(q).to(cuda)
    codes, scales = quantize_embeddings_int8(torch.from_numpy(x).to(cuda))
    s256, i256 = cosine_topk_int8_cuda(tq, codes, scales, 10)
    for q_n in (1, 64):
        s, i = cosine_topk_int8_cuda(tq[:q_n].contiguous(), codes, scales, 10)
        assert torch.equal(s, s256[:q_n]) and torch.equal(i, i256[:q_n])


@pytest.mark.parametrize("q_n", [1, 64, 256])
def test_k3_scores_equal_k2_bit_for_bit(cuda, q_n):
    """K3's scores equal K2's scores over the widened codes
    (``codes.float()``) times the row scales in f32, bit for bit: on 250
    rows K2 at k = N gives every such score; on N 10,007 pass A's kept
    scores (K2's bits) do, and K3's answer is the exact top-10 of their
    products by (score desc, id asc)."""
    q, x = _tile_data(q_n, 384, seed=12)
    tq = torch.from_numpy(q).to(cuda)
    codes, scales = quantize_embeddings_int8(torch.from_numpy(x).to(cuda))
    n = 250
    s2, i2 = cosine_topk_cuda(tq, codes[:n].float(), n)
    raw = torch.empty((q_n, n), device=cuda).scatter_(1, i2.long(), s2)
    s3, i3 = cosine_topk_int8_cuda(tq, codes[:n].contiguous(), scales[:n].contiguous(), n)
    assert torch.equal(torch.gather(raw * scales[None, :n], 1, i3.long()), s3)
    _, _, kept = topk_mod._fold_cuda(tq, codes.float(), 10, 2048, True)
    want = kept[:, :x.shape[0]] * scales[None, :]
    ids = torch.arange(x.shape[0], dtype=torch.int32, device=cuda).expand(q_n, -1)
    ws, wi = topk_mod.select_topk(want, ids, 10)
    ks, ki = cosine_topk_int8_cuda(tq, codes, scales, 10)
    assert torch.equal(ks, ws) and torch.equal(ki, wi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_answer_independent_of_q(cuda, dtype):
    """A query's K2 scores and ids are equal bit for bit in calls of 1, 64
    and 256 queries (query tiles 16, 64 and 128)."""
    q, x = _tile_data(256, 384, seed=9)
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, dtype)
    s256, i256 = cosine_topk_cuda(tq, tx, 10)
    for q_n in (1, 64):
        s, i = cosine_topk_cuda(tq[:q_n].contiguous(), tx, 10)
        assert torch.equal(s, s256[:q_n]) and torch.equal(i, i256[:q_n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_n", [1, 64, 256])
def test_k8_scores_equal_k2_bit_for_bit(cuda, dtype, q_n):
    """Pass A's scores (its reported winners and every score it keeps for
    pass B) equal K2's for the same (query, row) bit for bit, and pass B
    over them counts exactly what pass B on the tile counts."""
    q, x = _tile_data(q_n, 384, seed=10)
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, dtype)
    es, ei = cosine_topk_cuda(tq, tx, 10)
    fs, fi, kept = topk_mod._fold_cuda(tq, tx, 10, 2048, True)
    assert torch.equal(torch.gather(kept, 1, ei.long()), es)
    assert torch.equal(torch.gather(kept, 1, fi.long()), fs)
    thr = fs[:, 9].clone()
    assert torch.equal(topk_2pass_count_cuda(tq, tx, thr, scores=kept),
                       topk_2pass_count_cuda(tq, tx, thr))


def test_k8_pass_b_routes(cuda, monkeypatch):
    """cosine_topk_2pass counts over pass A's kept scores where they fit
    _SCORES_MAX and on the score tile where they do not; both give the
    same answer."""
    q, x = _tile_data(64, 384, seed=11)
    tq, tx = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    count, kept = topk_2pass_count_cuda.launches, topk_2pass_count_cuda.launches_scores
    a = cosine_topk_2pass(tq, tx, 10)
    assert (topk_2pass_count_cuda.launches - count,
            topk_2pass_count_cuda.launches_scores - kept) == (1, 1)
    monkeypatch.setattr(topk_mod, "_SCORES_MAX", 64 * x.shape[0] - 1)
    b = cosine_topk_2pass(tq, tx, 10)
    assert (topk_2pass_count_cuda.launches - count,
            topk_2pass_count_cuda.launches_scores - kept) == (2, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k8_count_over_scores_refuses_bad_inputs(cuda):
    """Kept scores of the wrong shape, a row stride not a multiple of 4 or
    shorter than N, or on the CPU: no launch."""
    x = torch.nn.functional.normalize(torch.randn(100, 64, device=cuda), dim=1)
    q, thr = x[:4].contiguous(), torch.zeros(4, device=cuda)
    before = topk_2pass_count_cuda.launches
    for bad in (torch.zeros(4, 98, device=cuda), torch.zeros(4, 102, device=cuda),
                torch.zeros(3, 100, device=cuda)):
        with pytest.raises(ValueError):
            topk_2pass_count_cuda(q, x, thr, scores=bad)
    with pytest.raises(ValueError):
        topk_2pass_count_cuda(q, x, thr, scores=torch.zeros(4, 100))
    assert topk_2pass_count_cuda.launches == before


# ---------------------------------------------------------------------------
# Serving: the cross-encoder and the HTTP daemon on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cross_encoder_packed_equals_bucketed_on_card(cuda, precision):
    """On the card the packed route's scores (each pair's CLS through the
    pooler's tanh) equal the bucketed route's: f32 within 1e-4; bf16
    within 1.5e-2, 2.8x the first reading (5.37e-3 on an H100, where the
    bucketed route rounds the pooler's output to bf16). Each limit is under
    a tenth (f32) or all (bf16: random weights give pairs near-equal CLS
    states, scores within about 3e-2) of the largest gap between
    neighbouring pairs' scores. Queueing a packed layout waits for the device nowhere
    (sync debug mode "error")."""
    from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION
    from text_similarity_tpu_torch.data import pack_pair_arrays
    from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder

    atol, prec = {"f32": (1e-4, FP32_PRECISION), "bf16": (1.5e-2, DEFAULT_PRECISION)}[precision]
    corpus = _corpus(200)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=2000, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    ce = CrossEncoder.init(torch.Generator().manual_seed(3), arch, tokenizer=tok, device=cuda,
                           precision=prec)
    ce.params["head"]["w"].mul_(50.0)    # std 1: scores spread across pairs
    assert ce.params["head"]["w"].is_cuda
    pairs = list(zip(corpus[:100], corpus[100:]))
    dense = ce.predict(pairs, packed=False, max_len=128)   # the arch's 128 positions
    packed = ce.predict(pairs, packed=True, max_len=128)
    print(f"{precision} packed vs bucketed: max|Δ| {np.abs(packed - dense).max():.3e}, "
          f"spread {np.ptp(dense):.3e}")
    assert np.isfinite(dense).all()
    np.testing.assert_allclose(packed, dense, atol=atol)
    gap = np.abs(dense - np.roll(dense, 1)).max()
    assert gap > (10 if precision == "f32" else 1) * atol
    ba, la = tok.encode_bodies([p[0] for p in pairs], 125)
    bb, lb = tok.encode_bodies([p[1] for p in pairs], 125)
    layout = pack_pair_arrays(ba, la, bb, lb, 128, cls_id=tok.cls_id, sep_id=tok.sep_id,
                              pad_id=tok.pad_id)
    ce._dispatch_packed_layout(layout)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = ce._dispatch_packed_layout(layout)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = np.zeros(len(pairs), np.float32)
    ce._collect_packed(pending, out)
    np.testing.assert_allclose(out, ce.predict_packed(pairs, width=128, max_len=128), atol=1e-6)


def test_search_server_on_card_launches_k1(cuda):
    """A SearchServer over a CUDA IVF pipeline: /search raises K1's launch
    counter and finds the verbatim query; /rerank scores on the card."""
    import json
    import urllib.request

    from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
    from text_similarity_tpu_torch.pipelines import RankingPipeline, SearchServer

    corpus = _corpus(3000)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=4000, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    enc = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                          tokenizer=tok, device=cuda)
    pipe = SemanticSearchPipeline(enc, corpus=corpus, use_ivf=True, device=cuda,
                                  index_config=IndexConfig(num_clusters=16, num_probes=4,
                                                           kmeans_iters=4))
    ce = CrossEncoder.init(torch.Generator().manual_seed(1), arch, tokenizer=tok, device=cuda)
    server = SearchServer(pipe, port=0, batch_window=0.002,
                          reranker=RankingPipeline(pipe, ce, retrieve_k=20))
    server.start_background()

    def call(path, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["results"]

    try:
        before = ivf_scan_cuda.launches
        row = call("/search", {"queries": [corpus[5]], "k": 5})[0]
        assert ivf_scan_cuda.launches > before
        assert row[0]["id"] == 5 and row[0]["score"] > 0.99
        row = call("/rerank", {"queries": [corpus[5]], "k": 5})[0]
        scores = [x["score"] for x in row]
        assert len(row) == 5 and scores == sorted(scores, reverse=True)
    finally:
        server.shutdown()


def test_albert_through_k7_and_k5_on_card(cuda):
    """ALBERT (one shared layer run 3 times, 32-wide tables) through K7
    (``attention_impl="packed"``, S 64) and K5 (S 4096 under ``"auto"``):
    each kernel launches once an iteration, and the states agree with the
    reference path on valid rows (f32, 2e-4)."""
    arch = ARCH_PRESETS["tiny-test"].replace(
        num_heads=4, hidden_size=128, intermediate_size=256, share_layers=True,
        embed_factor_size=32, num_layers=3, max_position=4096)
    params = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                             precision=FP32_PRECISION, device=cuda).params
    rng = np.random.default_rng(1)
    for s, impl, counter in ((64, "packed", packed_attention_cuda),
                             (4096, "auto", flash_attention_cuda)):
        ids = torch.from_numpy(rng.integers(5, arch.vocab_size, (2, s)).astype(np.int32)).to(cuda)
        lens = torch.tensor([s, s // 2 + 3], device=cuda)
        mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
        before = counter.launches
        got = encoder_forward(params, ids, mask, arch=arch, precision=FP32_PRECISION,
                              attention_impl=impl).last_hidden_state
        torch.cuda.synchronize()
        assert counter.launches == before + arch.num_layers, impl
        want = encoder_forward(params, ids, mask, arch=arch, precision=FP32_PRECISION,
                               attention_impl="reference").last_hidden_state
        assert float((got - want).abs()[mask.bool()].max()) <= 2e-4, impl


def test_pruned_model_through_k7_and_k5_on_card(cuda):
    """A model pruned to 8 of 12 heads (``head_dim_override`` 32, minilm-l6's
    width, 2 layers, FFN 1536 → 1024) through K7 (``"packed"``, S 64) and K5
    (S 4096 under ``"auto"``): each kernel takes the pruned head width,
    launches once a layer, and the states agree with the reference path on
    valid rows (f32, 2e-4)."""
    from text_similarity_tpu_torch.compress.prune import prune_rewire

    arch = ARCH_PRESETS["minilm-l6"].replace(num_layers=2, max_position=4096)
    rng = np.random.default_rng(2)
    pruned, parch = prune_rewire(init_params(arch, torch.Generator().manual_seed(0)), arch,
                                 rng.random((2, 12)), rng.random((2, 1536)), target_heads=8,
                                 target_ffn=1024)
    assert (parch.num_heads, parch.head_dim, parch.intermediate_size) == (8, 32, 1024)
    params = SentenceEncoder(pruned, parch, precision=FP32_PRECISION, device=cuda).params
    for s, impl, counter in ((64, "packed", packed_attention_cuda),
                             (4096, "auto", flash_attention_cuda)):
        ids = torch.from_numpy(rng.integers(5, parch.vocab_size, (2, s)).astype(np.int32)).to(cuda)
        lens = torch.tensor([s, s // 2 + 3], device=cuda)
        mask = (torch.arange(s, device=cuda)[None] < lens[:, None]).to(torch.int32)
        before = counter.launches
        got = encoder_forward(params, ids, mask, arch=parch, precision=FP32_PRECISION,
                              attention_impl=impl).last_hidden_state
        torch.cuda.synchronize()
        assert counter.launches == before + parch.num_layers, impl
        want = encoder_forward(params, ids, mask, arch=parch, precision=FP32_PRECISION,
                               attention_impl="reference").last_hidden_state
        assert float((got - want).abs()[mask.bool()].max()) <= 2e-4, impl


def test_pretrain_long_step_gradient_k5_k6_on_card(cuda):
    """One ``pretrain-long`` MLM loss at 4096 (a 2-layer cut of roberta-base
    with positions tiled to 4098, window 256, bf16 compute, a fixed
    corruption): its gradient through K5 / K6 against the reference path,
    per leaf ‖Δg‖ / ‖g‖ ≤ 3e-2 (``chip_smoke.GRAD_BF16``; a leaf whose
    exact gradient is zero is measured against 1e-3 of the whole norm)."""
    from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION
    from text_similarity_tpu_torch.models.losses import mlm_loss
    from text_similarity_tpu_torch.train.steps import trainable, value_and_grad

    arch = ARCH_PRESETS["roberta-base"].replace(num_layers=2)
    params, arch = extend_positions(init_params(arch, torch.Generator().manual_seed(0)), arch,
                                    4096 + arch.position_offset)
    arch = arch.replace(attention_window=256)
    tree = trainable({"encoder": params, "mlm_bias": torch.zeros(arch.vocab_size)}, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    ids = torch.randint(5, arch.vocab_size, (1, 4096), generator=g, device=cuda, dtype=torch.int32)
    mask = torch.ones_like(ids)
    labels = torch.where(torch.rand(ids.shape, generator=g, device=cuda) < 0.15, ids, -100)
    corrupted = torch.where(labels >= 0, torch.full_like(ids, 4), ids)

    def loss_fn(p, impl):
        h = encoder_forward(p["encoder"], corrupted, mask, arch=arch,
                            precision=DEFAULT_PRECISION, attention_impl=impl).last_hidden_state
        logits = h.float() @ p["encoder"]["embeddings"]["word"].T + p["mlm_bias"]
        return mlm_loss(logits, labels), {}

    before = (flash_attention_cuda.launches, flash_attention_backward_cuda.launches)
    loss_k, _, g_k = value_and_grad(loss_fn, tree, "auto")
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches - before[0],
            flash_attention_backward_cuda.launches - before[1]) == (2, 4)
    loss_r, _, g_r = value_and_grad(loss_fn, tree, "reference")

    def flat(t, prefix=""):
        out = {}
        for key, val in t.items():
            out.update(flat(val, prefix + key + "/") if isinstance(val, dict)
                       else {prefix + key: val.float()})
        return out

    g_k, g_r = flat(g_k), flat(g_r)
    whole = sum(float(v.norm()) ** 2 for v in g_r.values()) ** 0.5
    rel = {k: float((g_k[k] - v).norm()) / max(float(v.norm()), 1e-3 * whole)
           for k, v in g_r.items()}
    loss_k, loss_r = float(loss_k.detach()), float(loss_r.detach())
    assert abs(loss_k - loss_r) <= 1e-2 * abs(loss_r)
    assert max(rel.values()) <= 3e-2, sorted(rel.items(), key=lambda kv: -kv[1])[:3]


def test_spectral_knn_runs_k2_and_matches_plain(cuda):
    """``spectral_reduce`` on the card takes its k-NN graph from K2 (one
    launch) and gives the eigenvector projector of the same reduction on
    the CPU (plain top-k): three separated blobs, eigenvalue 1 of
    multiplicity 3, V·Vᵀ within 1e-3."""
    from text_similarity_tpu_torch.pipelines.topic import spectral_reduce

    g = torch.Generator().manual_seed(5)
    centres = torch.nn.functional.normalize(torch.randn(3, 64, generator=g), dim=1)
    x = torch.cat([c + 0.05 * torch.randn(n, 64, generator=g)
                   for c, n in zip(centres, (40, 30, 20))])
    x = torch.nn.functional.normalize(x, dim=1)
    before = cosine_topk_cuda.launches
    got = spectral_reduce(x.to(cuda), 3, n_neighbors=8)
    torch.cuda.synchronize()
    assert cosine_topk_cuda.launches == before + 1
    _, ki = cosine_topk_cuda(x.to(cuda), x.to(cuda), 9)
    _, ri = cosine_topk_reference(x, x, 9)
    assert torch.equal(ki.cpu().long(), ri.long())
    want = spectral_reduce(x, 3, n_neighbors=8)
    got = got.cpu()
    assert float((got @ got.T - want @ want.T).abs().max()) <= 1e-3


def test_export_bundle_on_card(cuda, tmp_path):
    """``export_encoder`` on the card (b 2, s 16, int8): the program records
    the card as its platform, and reloaded with its params on the card it
    equals the eager int8 encoder there (max |Δ| ≤ 1e-5); at 4096 tokens,
    where the eager encoder runs K5, the program carries K5's op: reloaded
    it equals the eager int8 encoder (max |Δ| ≤ 1e-5) and launches K5 once
    a layer a call."""
    from text_similarity_tpu_torch.compress.export import (
        export_encoder, load_exported_fn, load_exported_params,
    )

    arch = ARCH_PRESETS["tiny-test"]
    params = init_params(arch, torch.Generator().manual_seed(0))
    enc = SentenceEncoder(params, arch, precision=FP32_PRECISION, device="cuda")
    manifest = export_encoder(enc, str(tmp_path), batch_sizes=(2,), seq_lens=(16,))
    (f,) = manifest["functions"]
    assert f["platforms"] == ["cuda"]
    fn = load_exported_fn(str(tmp_path), f["name"])
    shipped = load_exported_params(str(tmp_path), device="cuda")
    ids = torch.randint(5, arch.vocab_size, (2, 16), device=cuda, dtype=torch.int32)
    mask = torch.ones_like(ids)
    mask[1, 9:] = 0
    got = fn(shipped, ids, mask)
    want = SentenceEncoder(params, arch, precision=FP32_PRECISION, device="cuda").to_int8() \
        .embed_tokens(ids.cpu().numpy(), mask.cpu().numpy())
    assert float((got - want).abs().max()) <= 1e-5
    long_arch = arch.replace(max_position=4096, num_heads=2)      # head dim 32
    long_params = init_params(long_arch, torch.Generator().manual_seed(1))
    long_enc = SentenceEncoder(long_params, long_arch, precision=FP32_PRECISION, device="cuda")
    (f,) = export_encoder(long_enc, str(tmp_path / "long"), batch_sizes=(1,),
                          seq_lens=(4096,))["functions"]
    fn = load_exported_fn(str(tmp_path / "long"), f["name"])
    shipped = load_exported_params(str(tmp_path / "long"), device="cuda")
    ids = torch.randint(5, arch.vocab_size, (1, 4096), device=cuda, dtype=torch.int32)
    mask = torch.ones_like(ids)
    mask[0, 3000:] = 0
    before = flash_attention_cuda.launches
    got = fn(shipped, ids, mask)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + long_arch.num_layers
    want = SentenceEncoder(long_params, long_arch, precision=FP32_PRECISION,
                           device="cuda").to_int8().embed_tokens(ids.cpu().numpy(),
                                                                 mask.cpu().numpy())
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("k", [64, 384])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 24, 33, 48])
def test_int8_mm_few_rows_on_card(cuda, m, k):
    """``int8_mm`` on the card at row counts cuBLASLt refuses unpadded at K
    64 (an MoE expert's capacity can be 8): exact against the CPU."""
    from text_similarity_tpu_torch.compress.quantize import int8_mm

    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, 128), generator=g, dtype=torch.int8)
    want = a.int() @ b.int()
    assert torch.equal(int8_mm(a.to(cuda), b.to(cuda)).cpu(), want)


@pytest.mark.parametrize("quantized", [False, True])
def test_moe_ffn_on_card_matches_cpu(cuda, quantized):
    """``moe_ffn`` on the card against the CPU (f32, E 4, top-2, T 16 so
    the capacity is 8; int8 experts through ``int8_mm``'s padded rows):
    the same routing and outputs within 1e-5, with TF32 allowed for the
    card's f32 products too (the router's logits take f64 then)."""
    from text_similarity_tpu_torch.compress.quantize import _quant_leaf
    from text_similarity_tpu_torch.ops.moe import moe_ffn

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 64), generator=g)
    mask = torch.ones((2, 8), dtype=torch.int32)
    mask[1, 6:] = 0
    rw = torch.randn((64, 4), generator=g)
    wi, wo = (0.1 * torch.randn(s, generator=g) for s in ((4, 64, 128), (4, 128, 64)))
    bi, bo = 0.1 * torch.randn((4, 128), generator=g), 0.1 * torch.randn((4, 64), generator=g)
    if quantized:
        wi, wo = _quant_leaf(wi), _quant_leaf(wo)

    def on(t, dev):
        return {k: v.to(dev) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)

    want = moe_ffn(x, mask, rw, wi, bi, wo, bo, capacity_factor=1.0)
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got = moe_ffn(*(on(t, cuda) for t in (x, mask, rw, wi, bi, wo, bo)),
                          capacity_factor=1.0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert float(got[2]) == float(want[2]) and abs(float(got[1]) - float(want[1])) <= 1e-6
        assert float((got[0].cpu() - want[0]).abs().max()) <= (1e-5 if not tf32 else 5e-3)


def test_moe_ffn_bf16_on_card_matches_cpu(cuda):
    """bf16 ``moe_ffn`` on the card (``bmm`` with an f32 output) against the
    CPU (the product of the operands raised to f32): both sum exact
    products in f32, so the routing is equal, each output within one bf16
    ulp (|Δ| ≤ 2^-7·|want|) and at most 1% of them differ at all; the
    gradients of x and the expert weights (bf16 products of the rounded
    cotangent on both) within 1e-2 of their largest."""
    from text_similarity_tpu_torch.ops.moe import moe_ffn

    g = torch.Generator().manual_seed(2)
    x = torch.randn((4, 64, 64), generator=g).bfloat16()
    mask = torch.ones((4, 64), dtype=torch.int32)
    mask[3, 40:] = 0
    rw = torch.randn((64, 4), generator=g)
    wi, wo = (0.3 * torch.randn(s, generator=g) for s in ((4, 64, 128), (4, 128, 64)))
    bi, bo = 0.1 * torch.randn((4, 128), generator=g), 0.1 * torch.randn((4, 64), generator=g)
    cot = torch.randn(x.shape, generator=g)
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, wi, wo)]
        y = moe_ffn(leaves[0], mask.to(dev), rw.to(dev), leaves[1], bi.to(dev), leaves[2],
                    bo.to(dev))
        (y[0].float() * cot.to(dev)).sum().backward()
        outs.append(y)
        grads.append([t.grad.float().cpu() for t in leaves])
    want, got = outs
    assert got[0].dtype == torch.bfloat16 and float(got[2]) == float(want[2])
    g0, w0 = got[0].detach().cpu().float(), want[0].detach().float()
    assert bool(((g0 - w0).abs() <= 2 ** -7 * w0.abs() + 1e-5).all())
    assert float((g0 != w0).float().mean()) <= 0.01
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-2 * float(a.abs().max())


def test_performer_attention_on_card_matches_cpu(cuda):
    """FAVOR+ (softmax and ReLU kernels, non-causal and causal at S 300)
    on the card against the CPU, f32, one projection: within 1e-5."""
    from text_similarity_tpu_torch.ops import performer

    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, 300, 4, 32), generator=g) for _ in range(3))
    mask = torch.ones((2, 300), dtype=torch.int32)
    mask[1, 200:] = 0
    proj = performer.draw_projection(32, 32)
    for fn in (performer.performer_attention, performer.performer_attention_causal):
        for kernel in ("softmax", "relu"):
            want = fn(q, k, v, proj, mask, kernel=kernel)
            got = fn(q.to(cuda), k.to(cuda), v.to(cuda), proj.to(cuda), mask.to(cuda),
                     kernel=kernel)
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _clustered_rows(n, d, n_centers, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, d).astype(np.float32)
    return _unit(centers[rng.randint(0, n_centers, n)] * 3.0 + rng.randn(n, d).astype(np.float32))


def _four_shards(cuda):
    from text_similarity_tpu_torch.core.mesh import make_mesh

    return (make_mesh(data=1, index=4, devices=[cuda] * 4),
            make_mesh(data=1, index=4, devices=["cpu"] * 4))


def test_sharded_brute_force_on_card_matches_plain(cuda):
    """Four shards on one card: K2 once a shard, the merge, against the
    same index on the CPU (the plain top-k)."""
    from text_similarity_tpu_torch.index.sharded import ShardedBruteForceIndex

    card, cpu = _four_shards(cuda)
    x = _unit(np.random.RandomState(0).randn(10_001, 384))
    q = _unit(np.random.RandomState(1).randn(64, 384))
    before = cosine_topk_cuda.launches
    s, i = ShardedBruteForceIndex.build(card, x).query(q, k=10)
    assert cosine_topk_cuda.launches == before + 4
    rs, ri = ShardedBruteForceIndex.build(cpu, x).query(q, k=10)
    assert np.abs(s - rs).max() <= 1e-5
    assert _overlap(i, ri) >= 0.999


@pytest.mark.parametrize("probes", [40, 8])
def test_sharded_ivf_on_card_matches_plain(cuda, probes):
    """Four shards on one card, bf16 slabs, built on the card (its
    distributed k-means): K1 once a shard on ``impl="auto"``, the answer
    against the plain scan's (``impl="kernel"``) over the same layout on
    the CPU; 40 probes take 64-query blocks with union factor 1, 8 probes
    16-query blocks with factor 3."""
    from text_similarity_tpu_torch.index.sharded import ShardedIVFIndex

    card, cpu = _four_shards(cuda)
    x = _clustered_rows(40_000, 384, 200)
    q = _unit(x[:100] + 0.05 * np.random.RandomState(2).randn(100, 384).astype(np.float32))
    cfg = IndexConfig(num_clusters=128, num_probes=probes, kmeans_iters=4)
    idx = ShardedIVFIndex.build(card, x, cfg, data_dtype=torch.bfloat16)
    ref = ShardedIVFIndex(cpu, idx.centroids.cpu(), [d.cpu() for d in idx.data_padded],
                          [i.cpu() for i in idx.ids_padded], cfg.num_probes)
    before = ivf_scan_cuda.launches
    s, i = idx.query(q, k=10)
    assert ivf_scan_cuda.launches == before + 4
    rs, ri = ref.query(q, k=10, impl="kernel")
    assert np.abs(s - rs).max() <= 1e-4
    assert _overlap(i, ri) >= 0.99


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_cp_attention_on_card_matches_cpu(cuda, strategy):
    """Ring and Ulysses at seq 4 on one card against the CPU, f32."""
    from text_similarity_tpu_torch.core.mesh import make_mesh

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 512, 8, 64), generator=g) for _ in range(3))
    mask = torch.ones((2, 512), dtype=torch.int32)
    mask[1, 300:] = 0
    out = {}
    for dev in ("cpu", cuda):
        devs = make_mesh(data=1, seq=4, devices=[dev] * 4).axis_devices("seq")
        pieces = [list(t.to(dev).chunk(4, dim=1)) for t in (q, k, v, mask)]
        out[str(dev)] = torch.cat(
            multi_head_attention(*pieces[:3], mask=pieces[3], impl=strategy, cp_group=devs),
            dim=1).cpu()
    assert float((out[str(cuda)] - out["cpu"]).abs().max()) <= 1e-5


def test_encode_long_on_card_matches_cpu(cuda):
    """``encode_long`` at seq 4 on one card (both strategies) against the
    CPU, f32 weights."""
    from text_similarity_tpu_torch.core.mesh import make_mesh

    texts = [" ".join(f"w{i % 50} x{i % 7}" for i in range(j, j + 150)) for j in range(5)]
    tok = WordPieceTokenizer(train_wordpiece_vocab(texts, 256, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size, max_position=512)
    params = init_params(arch, torch.Generator().manual_seed(0))
    for strategy in ("ring", "ulysses"):
        vecs = []
        for dev in ("cpu", cuda):
            enc = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION,
                                  device=dev)
            vecs.append(enc.encode_long(texts, make_mesh(data=1, seq=4, devices=[dev] * 4),
                                        max_len=512, strategy=strategy, batch_size=4))
        assert np.abs(vecs[0] - vecs[1]).max() <= 1e-5


def test_tp_step_runs_k5_k6_on_head_slices(cuda):
    """data 2 × model 2 on one card, a tiny long arch with 4 heads of 32 (2
    a model position), f32, S 512, ``attention_impl="flash"``: K5 once a
    layer, tower and position forward, K6 twice that backward, each on a
    (1, 512, 2, 32) head slice; the loss and the gradients against the same
    sharded step on the CPU (the plain versions), as
    ``test_train_step_on_card_matches_cpu`` holds them."""
    from text_similarity_tpu_torch.core.mesh import make_mesh
    from text_similarity_tpu_torch.models import param_pspecs
    from text_similarity_tpu_torch.train import init_sharded_train_state, make_optimizer
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.core.mesh import unshard
    from text_similarity_tpu_torch.train.steps import bi_encoder_loss, value_and_grad

    arch = ARCH_PRESETS["tiny-test"].replace(hidden_size=128, num_heads=4, hidden_dropout=0.0,
                                             max_position=512, attention_window=256,
                                             window_global_cls=True)
    params = {"encoder": init_params(arch, torch.Generator().manual_seed(3))}
    rng = np.random.default_rng(6)
    s = 512
    batch = {}
    for side, n in (("a", (512, 300)), ("b", (400, 512))):
        mask = (np.arange(s)[None] < np.asarray(n)[:, None]).astype(np.int32)
        batch[f"ids_{side}"] = (rng.integers(5, arch.vocab_size, (2, s)) * mask).astype(np.int32)
        batch[f"mask_{side}"] = mask
    batch["target"] = np.array([0.2, 0.9], np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = make_mesh(data=2, model=2, devices=[dev] * 4)
        tx = make_optimizer(TrainConfig(), 4, params)
        state = init_sharded_train_state(params, tx, mesh, {"encoder": param_pspecs(arch)})
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        f0, b0 = flash_attention_cuda.launches, flash_attention_backward_cuda.launches
        loss, _, grads = value_and_grad(bi_encoder_loss, state.params, tb, arch=arch,
                                        precision=FP32_PRECISION, deterministic=True,
                                        attention_impl="flash")
        if dev.type == "cuda":
            assert flash_attention_cuda.launches == f0 + 2 * arch.num_layers * 4
            assert flash_attention_backward_cuda.launches == b0 + 4 * arch.num_layers * 4
        flat = unshard(grads, "cpu")
        out[dev.type] = (float(loss.detach()), dict(zip(_flat_names(flat), _grad_leaves(flat))))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    whole = float(torch.sqrt(sum((y * y).sum() for y in out["cpu"][1].values())))
    for name, y in out["cpu"][1].items():
        floor = max(float(y.norm()), 1e-3 * whole)
        assert float((out["cuda"][1][name] - y).norm()) <= 1e-3 * floor, name


def _grad_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _grad_leaves(v)
        else:
            yield v


def test_adamw_over_pieces_on_one_card(cuda):
    """Pieces of four positions on cuda:0 (replicated, data-split and
    model-split leaves): the clipped update equals the whole tree's on the
    card."""
    from text_similarity_tpu_torch.core.mesh import PartitionSpec as P
    from text_similarity_tpu_torch.core.mesh import make_mesh, place, shard_leaf, unshard
    from text_similarity_tpu_torch.train import AdamW, linear_warmup_schedule

    g = torch.Generator().manual_seed(0)
    whole = {"a": torch.randn(8, 6, generator=g), "b": {"w": torch.randn(4, 8, generator=g),
                                                        "bias": torch.randn(8, generator=g)}}
    grads = [{"a": torch.randn(8, 6, generator=g) * 3,
              "b": {"w": torch.randn(4, 8, generator=g) * 3, "bias": torch.randn(8, generator=g)}}
             for _ in range(3)]
    mesh = make_mesh(data=2, model=2, devices=[cuda] * 4)
    specs = {"a": P("data", None), "b": {"w": P(None, "model"), "bias": P()}}
    ps = place(whole, mesh, specs)
    pw = {"a": whole["a"].to(cuda), "b": {k: v.to(cuda) for k, v in whole["b"].items()}}
    tx_w, tx_s = (AdamW(linear_warmup_schedule(1e-2, 10, 1), weight_decay=0.1) for _ in range(2))
    sw, ss = tx_w.init(pw), tx_s.init(ps)
    assert all(p.device == cuda or p.is_cuda for p in ss["mu"]["a"].pieces)
    for gr in grads:
        tx_w.step(pw, {"a": gr["a"].to(cuda), "b": {k: v.to(cuda) for k, v in gr["b"].items()}},
                  sw)
        tx_s.step(ps, {"a": shard_leaf(gr["a"].to(cuda), mesh, specs["a"]),
                       "b": {k: shard_leaf(v.to(cuda), mesh, specs["b"][k])
                             for k, v in gr["b"].items()}}, ss)
    got = unshard(ps)
    torch.testing.assert_close(got["a"], pw["a"], rtol=1e-6, atol=1e-7)
    for k in ("w", "bias"):
        torch.testing.assert_close(got["b"][k], pw["b"][k], rtol=1e-6, atol=1e-7)


def test_dryrun_multichip_on_the_card(cuda):
    """Every mesh axis over four positions on the visible cards (cycled):
    the DP × TP step, ring and Ulysses, K2 and K1 shards, the pipe-2 and
    expert-2 steps."""
    from text_similarity_tpu_torch.dryrun import dryrun_multichip

    before = (cosine_topk_cuda.launches, ivf_scan_cuda.launches)
    out = dryrun_multichip(4)
    assert out["recall_at_10"] >= 0.9 and np.isfinite(out["loss"])
    assert cosine_topk_cuda.launches > before[0] and ivf_scan_cuda.launches > before[1]


# ---------------------------------------------------------------------------
# The large-k route (csrc/topk_select.cu): k above the selectors' 256
# ---------------------------------------------------------------------------

def _large_k_data(cuda, q_n, n=30_011, d=64, seed=21):
    """Unit rows with three copies of each query's source row and 500 more
    duplicated rows (exact ties at the top and inside a large k)."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((n, d)))
    src = rng.choice(n // 3, q_n, replace=False)
    dst = rng.choice(np.arange(n // 3, n), 2 * q_n + 500, replace=False)
    x[dst[:q_n]] = x[src]
    x[dst[q_n:2 * q_n]] = x[src]
    x[dst[2 * q_n:]] = x[rng.choice(n // 3, 500)]
    q = _unit(x[src] + 0.05 * rng.standard_normal((q_n, d)))
    return torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)


def _plain_order(s, i, k):
    """The first k of each row by (value desc, id asc), numpy arrays (int
    values compare as ints)."""
    order = np.lexsort((i, -s.astype(np.float64)), axis=1)[:, :k]
    return np.take_along_axis(s, order, 1), np.take_along_axis(i, order, 1)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("q_n,k", [(1, 257), (7, 300), (64, 1000), (5, 8193), (2, 20011),
                                   (1, 1000), (1, 4096), (8, 257), (8, 1000), (8, 4096),
                                   (64, 257), (64, 4096)])
def test_large_k_route_matches_plain(cuda, kind, q_n, k):
    """K2 (f32, bf16) and K3 (int8) above 256 take the large-k route (no
    launch of the selector kernels, one select launch): scores allclose
    1e-5, sorted; f32 and int8 ids equal where separated, bf16 overlap ≥
    0.99; past 4,096 winners the merge passes run. Bit for bit: f32 and
    bf16 equal the plain (score desc, id asc) order of the tile's own
    scores (K8's kept scores, K2's bits), int8's first 256 equal K3's
    selector at k 256."""
    q, x = _large_k_data(cuda, q_n)
    before = (cosine_topk_cuda.launches, cosine_topk_int8_cuda.launches,
              cosine_topk_large_cuda.launches + cosine_topk_large_cuda.launches_int8,
              topk_select_cuda.launches)
    if kind == "int8":
        codes, scales = quantize_embeddings_int8(x)
        ks, ki = cosine_topk_int8_cuda(q, codes, scales, k)
        rs, ri = cosine_topk_int8_reference(q, codes, scales, k)
    else:
        c = x.to(torch.bfloat16) if kind == "bf16" else x
        ks, ki = cosine_topk_cuda(q, c, k)
        rs, ri = cosine_topk_reference(q, c, k)
    torch.cuda.synchronize()
    after = (cosine_topk_cuda.launches, cosine_topk_int8_cuda.launches,
             cosine_topk_large_cuda.launches + cosine_topk_large_cuda.launches_int8,
             topk_select_cuda.launches)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)
    assert bool((ks[:, 1:] <= ks[:, :-1]).all())
    _assert_agree(ks, ki, rs, ri, kind != "bf16")
    if kind == "int8":
        ss, si = cosine_topk_int8_cuda(q, codes, scales, 256)
        assert torch.equal(ks[:, :256], ss) and torch.equal(ki[:, :256], si)
    else:
        n = x.shape[0]
        kept = topk_mod._fold_cuda(q, c, 10, 2048, True)[2][:, :n].cpu().numpy()
        ps, pi = _plain_order(kept, np.arange(n)[None].repeat(q_n, 0), k)
        assert np.array_equal(ks.cpu().numpy(), ps) and np.array_equal(ki.cpu().numpy(), pi)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_large_k_route_on_one_repeated_row(cuda, kind):
    """A corpus of 50,000 copies of one row: every score equal, so the cut's
    bin holds the whole row, more than the select keeps as candidates (its
    second digit cannot split it either): the lowest k ids, in order, one
    select launch."""
    rng = np.random.default_rng(22)
    row = _unit(rng.standard_normal((1, 64)))
    x = torch.from_numpy(np.repeat(row, 50_000, 0)).to(cuda)
    q = torch.from_numpy(_unit(row + 0.1 * rng.standard_normal((3, 64)))).to(cuda)
    before = topk_select_cuda.launches
    if kind == "int8":
        codes, scales = quantize_embeddings_int8(x)
        ks, ki = cosine_topk_int8_cuda(q, codes, scales, 1000)
        ss, _ = cosine_topk_int8_cuda(q, codes, scales, 1)
    else:
        c = x.to(torch.bfloat16) if kind == "bf16" else x
        ks, ki = cosine_topk_cuda(q, c, 1000)
        ss, _ = cosine_topk_cuda(q, c, 1)
    torch.cuda.synchronize()
    assert topk_select_cuda.launches == before + 1
    assert torch.equal(ki.cpu(), torch.arange(1000, dtype=torch.int32)[None].repeat(3, 1))
    assert torch.equal(ks, ss.expand(3, 1000))


@pytest.mark.parametrize("rows,n,k", [(3, 5000, 700), (2, 300, 500), (4, 40_000, 9000),
                                      (1, 70_000, 70_000), (1, 30_011, 257), (1, 30_011, 1000),
                                      (1, 30_011, 4096), (8, 30_011, 257), (8, 30_011, 1000),
                                      (8, 30_011, 4096), (64, 30_011, 257), (64, 30_011, 1000),
                                      (64, 30_011, 4096)])
def test_select_kernel_is_exact_on_ties(cuda, rows, n, k):
    """The select kernel against the plain (score desc, id asc) order, bit
    for bit: scores on a 1/8 grid (ties everywhere, −0 beside +0), ids a
    permutation; k past n pads (−inf, −1); past 4,096 the merge passes."""
    g = torch.Generator().manual_seed(n)
    s = torch.round(torch.randn((rows, n), generator=g) * 8) / 8
    s[:, ::7] = -0.0
    i = torch.stack([torch.randperm(n, generator=g) for _ in range(rows)]).to(torch.int32)
    before = topk_select_cuda.launches
    ks, ki = topk_select_cuda(s.to(cuda), k, i.to(cuda))
    ps, pi = topk_select_cuda(s.to(cuda), k)                 # ids: positions
    torch.cuda.synchronize()
    assert topk_select_cuda.launches == before + 2
    kk = min(k, n)
    order = np.lexsort((i.numpy(), -s.numpy()), axis=1)[:, :kk]
    assert np.array_equal(ki.cpu().numpy()[:, :kk], np.take_along_axis(i.numpy(), order, 1))
    assert np.array_equal(ks.cpu().numpy()[:, :kk], np.take_along_axis(s.numpy(), order, 1))
    by_pos = np.lexsort((np.arange(n)[None].repeat(rows, 0), -s.numpy()), axis=1)[:, :kk]
    assert np.array_equal(pi.cpu().numpy()[:, :kk], by_pos)
    if k > n:
        assert bool((ks[:, n:] == -float("inf")).all()) and bool((ki[:, n:] == -1).all())


@pytest.mark.parametrize("case", ["all equal", "n below a slice", "n below k",
                                  "600,000 long", "segments with ids", "int keys"])
@pytest.mark.parametrize("k", [300, 4096])
def test_select_kernel_edges(cuda, case, k):
    """The select kernel at its design's edges, bit for bit against the
    plain (value desc, id asc) order, one launch a call: a row of one value
    (its cut's bin past the candidates the kernel keeps: the select over
    the row in place), rows shorter than one pass slice (4,096) and than k
    (padding (−inf, −1)), a row of 600,000 continuous scores, (U, R, M)
    IVF-style segments with ids (dead slots (−inf, −1)), int keys (padding
    0)."""
    g = torch.Generator().manual_seed(k)
    rows, n = {"all equal": (2, 20_000), "n below a slice": (5, 3000), "n below k": (3, 250),
               "600,000 long": (1, 600_000)}.get(case, (3, 0))
    segments = case == "segments with ids"
    if segments:
        u, m = 56, 384
        s = torch.randn((u, rows, m), generator=g)
        i = torch.randint(0, 1 << 20, (u, rows, m), generator=g, dtype=torch.int32)
        i[:, :, ::9] = -1
        s[:, :, ::9] = -float("inf")
        flat_s, flat_i = (t.permute(1, 0, 2).reshape(rows, u * m) for t in (s, i))
    elif case == "int keys":
        n = 50_000
        s = torch.randint(-(1 << 30), 1 << 30, (rows, n), generator=g, dtype=torch.int32)
        s[:, ::5] = s[:, 1::5]   # ties
        i = torch.stack([torch.randperm(n, generator=g) for _ in range(rows)]).to(torch.int32)
        flat_s, flat_i = s, i
    else:
        s = torch.full((rows, n), 0.5) if case == "all equal" else torch.randn((rows, n),
                                                                               generator=g)
        i = torch.stack([torch.randperm(n, generator=g) for _ in range(rows)]).to(torch.int32)
        flat_s, flat_i = s, i
    before = topk_select_cuda.launches
    ks, ki = topk_select_cuda(s.to(cuda), k, i.to(cuda), segments=segments)
    torch.cuda.synchronize()
    assert topk_select_cuda.launches == before + 1
    n_all = flat_s.shape[1]
    kk = min(k, n_all)
    ps, pi = _plain_order(flat_s.numpy(), flat_i.numpy(), kk)
    assert np.array_equal(ks.cpu().numpy()[:, :kk], ps)
    assert np.array_equal(ki.cpu().numpy()[:, :kk], pi)
    if k > n_all:
        pad = 0 if case == "int keys" else -float("inf")
        assert bool((ks[:, n_all:] == pad).all()) and bool((ki[:, n_all:] == -1).all())


def test_select_kernel_reads_segments_in_place(cuda):
    """(U, R, M) per-probe scores read as R rows of U·M candidates equal the
    select over the rows laid out flat."""
    g = torch.Generator().manual_seed(3)
    s = torch.randn((6, 5, 200), generator=g)
    i = torch.randint(0, 1 << 20, (6, 5, 200), generator=g, dtype=torch.int32)
    i[:, :, ::9] = -1
    s[:, :, ::9] = -float("inf")
    ks, ki = topk_select_cuda(s.to(cuda), 900, i.to(cuda), segments=True)
    flat_s = s.permute(1, 0, 2).reshape(5, 1200)
    flat_i = i.permute(1, 0, 2).reshape(5, 1200)
    ws, wi = topk_select_cuda(flat_s.to(cuda), 900, flat_i.to(cuda))
    assert torch.equal(ks, ws) and torch.equal(ki, wi)


def _large_k_counts():
    """(emit_acc, packet, select) launches of the IVF's large-k route."""
    fn = ivf_modes.ivf_scan_large_k_cuda
    return fn.launches_emit, fn.launches_pack, fn.launches_select


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_large_k_ivf_scans_match_plain(cuda, dtype):
    """K1 / K4 at k 300 on the card: exact (U·Mc = 1200 candidates, one
    block's probe −1), per_probe (k past Mc: padded), the deferred fold at
    (200, 2) — each from emit_acc's scores through the select kernel —
    against the plain scan at k + 1; none runs the tile's selection."""
    q, probes, data, ids, scales = _scan_inputs(cuda, dtype, 64)
    cases = [dict(), dict(per_probe=True), dict(approx_width=200, acc_slots=2)]
    for opts in cases:
        before = _large_k_counts()
        counts = _mode_counts()
        empty_s, _ = ivf_scan_cuda(q[:0], probes[:0], data, ids, 300, 8, scales=scales, **opts)
        assert _large_k_counts() == before and empty_s.numel() == 0
        ks, ki = ivf_scan_cuda(q, probes, data, ids, 300, 8, scales=scales, **opts)
        torch.cuda.synchronize()
        # one emit_acc and one select launch (one chunk of query blocks)
        assert _large_k_counts() == (before[0] + 1, before[1], before[2] + 1)
        assert _mode_counts() == counts
        w = opts.get("approx_width", 0)
        rs, ri = ivf_scan_reference(q.cpu(), probes.cpu(), data.cpu(), ids.cpu(), 301, 8, w,
                                    opts.get("acc_slots", 1),
                                    None if scales is None else scales.cpu(),
                                    per_probe=opts.get("per_probe", False))
        _agree_flat(ks, ki, rs, ri, dtype)


def test_large_k_ivf_modes_match_plain(cuda):
    """K10, K11a, K11b and K9 past 256 on the card (their fold from
    emit_acc's scores, then the select kernel; K9's packets on int keys)
    against their plain versions."""
    from text_similarity_tpu_torch.index.ivf_modes import PACK_SCALE, _unpack_candidates

    q, probes, data, ids, _ = _scan_inputs(cuda, torch.bfloat16, 64, mc=512)
    for fn, plain, extra in (
        (ivf_modes.ivf_scan_dma_cuda, ivf_modes.ivf_scan_dma_reference, (2, 2)),
        (ivf_modes.ivf_scan_multiprobe_cuda, ivf_modes.ivf_scan_multiprobe_reference, (3,)),
    ):
        ks, ki = fn(q, probes, data, ids, 300, 8, *extra)
        rs, ri = plain(q.cpu(), probes.cpu(), data.cpu(), ids.cpu(), 300, 8, *extra)
        _agree_flat(ks, ki, *(torch.cat([t, t[:, -1:]], 1) for t in (rs, ri)), torch.bfloat16)
    qs, ps, ds, _, _ = _scan_inputs(cuda, torch.bfloat16, 65, mc=512, sentinel=True)
    ks, ki = ivf_modes.ivf_scan_idless_cuda(qs, ps, ds, 300, 8, 512)
    rs, ri = ivf_modes.ivf_scan_idless_reference(qs.cpu(), ps.cpu(), ds.cpu(), 300, 8, 512)
    _agree_flat(ks, ki, *(torch.cat([t, t[:, -1:]], 1) for t in (rs, ri)), torch.bfloat16)
    for width, slots in ((512, 1), (256, 2)):
        before = _large_k_counts()
        kp = ivf_modes.ivf_scan_packed_cuda(q, probes, data, ids, 300, 8, width, slots)
        rp = ivf_modes.ivf_scan_packed_reference(q, probes, data, ids, 300, 8, width, slots)
        torch.cuda.synchronize()
        # emit_acc, the packet kernel, then the class select and the final one
        assert _large_k_counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
        assert bool((kp[:, 1:] <= kp[:, :-1]).all())
        ks, ki = (t.cpu().numpy() for t in _unpack_candidates(kp, probes, ids, 8))
        rs, ri = (t.cpu().numpy() for t in _unpack_candidates(rp, probes, ids, 8))
        col = np.arange(300)
        assert _overlap(np.where(ki < 0, -1 - col, ki), np.where(ri < 0, -1 - col, ri)) >= 0.99
        np.testing.assert_allclose(np.sort(ks, 1), np.sort(rs, 1), atol=1.0 / PACK_SCALE + 1e-6)
        assert (kp.cpu().numpy() == rp.cpu().numpy()).mean() >= 0.95


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [300, 2100])
def test_k8_large_k_matches_plain(cuda, dtype, k):
    """K8 past 256: pass A selects its classes' winners with the select
    kernel (past block_c 2048 the rounds' (−inf, lowest id) tail) against
    the plain k rounds; the call against its plain version."""
    q, x = _large_k_data(cuda, 4)
    c = x.to(dtype)
    before = topk_2pass_fold_cuda.launches_large
    ks, ki = topk_2pass_fold_cuda(q, c, k)
    rs, ri = topk_2pass_fold_plain(q.cpu(), c.cpu(), k, 2048)
    torch.cuda.synchronize()
    assert topk_2pass_fold_cuda.launches_large == before + 1
    n_cls = min(k, 2048)
    _assert_agree(ks[:, :n_cls], ki[:, :n_cls], rs[:, :n_cls], ri[:, :n_cls],
                  dtype == torch.float32)
    if k > 2048:
        assert bool((ks[:, n_cls:] == -float("inf")).all())
        assert torch.equal(ki[:, n_cls:].cpu(), ri[:, n_cls:])
    ks, ki = cosine_topk_2pass(q, c, k)
    rs, ri = cosine_topk_2pass_reference(q.cpu(), c.cpu(), k)
    _assert_agree(ks, ki, rs, ri, dtype == torch.float32)


def test_large_k_never_sorts_or_falls_back(cuda, monkeypatch):
    """Past 256 no selection on a CUDA tensor reaches torch.topk,
    torch.sort, torch.argsort or a plain version: K2, K3, K8, the IVF exact
    scan, the sharded merge."""
    from text_similarity_tpu_torch.ops.topk import select_topk

    q, x = _large_k_data(cuda, 8)
    codes, scales = quantize_embeddings_int8(x)
    sq, sp, sd, si, _ = _scan_inputs(cuda, torch.bfloat16, 64)

    def refuse(*a, **kw):
        raise AssertionError("a sort or a plain version ran on CUDA tensors")

    for name in ("topk", "sort", "argsort"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("cosine_topk_reference", "exact_merge_rounds", "topk_2pass_fold_plain"):
        monkeypatch.setattr(topk_mod, name, refuse)
    monkeypatch.setattr(ivf_modes, "scan_plain", refuse)
    cosine_topk_cuda(q, x, 1000)
    cosine_topk_int8_cuda(q, codes, scales, 1000)
    cosine_topk_2pass(q, x, 300)
    ivf_scan_cuda(sq, sp, sd, si, 300, 8)
    select_topk(torch.randn((3, 4, 500), device=cuda),
                torch.randint(0, 9999, (3, 4, 500), device=cuda, dtype=torch.int32), 1000)
    torch.cuda.synchronize()
