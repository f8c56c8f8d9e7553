"""The CUDA kernels on the card (K1, K2 and their int8 variants K3, K4,
and the flash forward K5), each held against its plain version, and the
port's pipelines (bf16 and int8 serving, long-document encode) on the card
against the same pipelines on the CPU.

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
from text_similarity_tpu_torch.index.ivf import (
    IVFIndex,
    _plan_probes,
    ivf_scan,
    ivf_scan_cuda,
    ivf_scan_reference,
)
from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward, init_params
from text_similarity_tpu_torch.models.hf_convert import extend_positions
from text_similarity_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_plain
from text_similarity_tpu_torch.ops import topk as topk_mod
from text_similarity_tpu_torch.ops.topk import (
    cosine_topk_cuda,
    cosine_topk_int8,
    cosine_topk_int8_cuda,
    cosine_topk_int8_reference,
    cosine_topk_reference,
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

def _qkv_views(cuda, b, s, h, d, dtype, seed=0):
    """q, k, v as the encoder hands them over: views of one fused
    (B, S, H, 3, D) tensor."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s, h, 3, d, generator=g, device=cuda).to(dtype)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,global_cls", [(0, False), (256, False), (256, True), (24, True)])
@pytest.mark.parametrize(
    "d,s,lens", [(64, 1024, (1024, 701)), (32, 512, (512, 300, 0)), (128, 600, (600, 599, 64))]
)
def test_flash_kernel_matches_plain(cuda, dtype, window, global_cls, d, s, lens):
    """K5 against its plain version on valid rows: f32 max |Δ| ≤ 1e-4; bf16
    max ≤ 1e-2 and mean ≤ 5e-4 (p rounds to bf16 against a running max in
    the kernel, a row max in the plain version); lse ≤ 1e-4; zero-length
    rows exactly 0. S 600 is not a multiple of the 64-row blocks."""
    q, k, v = _qkv_views(cuda, len(lens), s, 4, d, dtype)
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
    """requires_grad (the backward, K6, is not ported), other head dims,
    mixed dtypes, a non-contiguous last dim; no launch for any of them."""
    q, k, v = _qkv_views(cuda, 1, 256, 2, 64, torch.float32, seed=2)
    lengths = torch.tensor([256], dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    with pytest.raises(NotImplementedError):
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
