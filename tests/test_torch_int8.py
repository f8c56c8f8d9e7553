"""int8 serving against the JAX package: the int8 store and its brute-force
search (kernel K3's plain version against the Pallas kernel in interpret
mode), BruteForceIndex.mine, the int8 IVF (kernel K4's plain version
against ``_ivf_query_pallas`` with scales, the bf16 rescore, add, remove,
save/load both ways), and an int8 pipeline loaded from a JAX save. The
CUDA kernels are held against these plain versions in test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import IndexConfig as JaxIndexConfig
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu.index.brute import BruteForceIndex as JaxBrute
from text_similarity_tpu.index.ivf import IVFIndex as JaxIVFIndex
from text_similarity_tpu.index.ivf import _ivf_query_pallas
from text_similarity_tpu.index.store import EmbeddingStore as JaxStore
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.ops.topk import cosine_topk_pallas_int8, cosine_topk_xla
from text_similarity_tpu.pipelines import SemanticSearchPipeline as JaxPipeline
from text_similarity_tpu.pipelines.search import _pad_pow2 as jax_pad_pow2
from text_similarity_tpu_torch.compress.quantize import int8_matmul_scores
from text_similarity_tpu_torch.core.config import IndexConfig
from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore, IVFIndex
from text_similarity_tpu_torch.index.ivf import _plan_probes, ivf_scan, ivf_scan_cuda
from text_similarity_tpu_torch.models import SentenceEncoder
from text_similarity_tpu_torch.ops.topk import (
    cosine_topk_int8,
    cosine_topk_int8_cuda,
    cosine_topk_int8_reference,
    select_topk,
)
from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _overlap(a, b):
    return np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)])


def _store_pair(x, capacity=None):
    js = JaxStore(capacity or len(x), x.shape[1], quantized=True)
    js.add(jnp.asarray(x))
    ts = EmbeddingStore(capacity or len(x), x.shape[1], quantized=True, device="cpu")
    ts.add(torch.from_numpy(x))
    return js, ts


def _dup_data(n, d=64, q=16, seed=0):
    """Unit rows with three copies of each query's source row (exact ties
    after quantization too); queries are noisy copies of the sources."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((n, d)))
    src = rng.choice(n // 2, size=q, replace=False)
    dst = rng.choice(np.arange(n // 2, n), size=2 * q, replace=False)
    x[dst[:q]] = x[src]
    x[dst[q:]] = x[src]
    return _unit(x[src] + 0.05 * rng.standard_normal((q, d))), x


# ---------------------------------------------------------------------------
# K3 and the int8 store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("k", [1, 10, 20])
def test_k3_plain_matches_pallas_int8(n, k):
    """cosine_topk_int8_reference against cosine_topk_pallas_int8 in
    interpret mode (block_q 8, block_c 128; ragged N): ids equal (ties →
    lowest id), scores allclose 1e-5 (f32 dots summed in another order)."""
    q, x = _dup_data(n, seed=n + k)
    js, ts = _store_pair(x)
    ps, pi = cosine_topk_pallas_int8(jnp.asarray(q), js.view, js.scales_view, k=k,
                                     block_q=8, block_c=128, interpret=True)
    rs, ri = cosine_topk_int8_reference(torch.from_numpy(q), ts.view, ts.scales_view, k=k)
    np.testing.assert_array_equal(ri.numpy(), np.asarray(pi))
    np.testing.assert_allclose(rs.numpy(), np.asarray(ps), atol=1e-5)


def test_k3_dispatch_on_cpu_uses_plain_version():
    q, x = _dup_data(500, seed=4)
    _, ts = _store_pair(x)
    before = cosine_topk_int8_cuda.launches
    s, i = cosine_topk_int8(torch.from_numpy(q), ts.view, ts.scales_view, k=5)
    rs, ri = cosine_topk_int8_reference(torch.from_numpy(q), ts.view, ts.scales_view, k=5)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert cosine_topk_int8_cuda.launches == before
    with pytest.raises(ValueError):
        cosine_topk_int8_cuda(torch.from_numpy(q), ts.view, ts.scales_view, k=5)
    with pytest.raises(ValueError):
        cosine_topk_int8(torch.from_numpy(q), ts.view, ts.scales_view, k=501)   # k > N


def test_int8_store_matches_jax_and_grows():
    """Codes and scales equal JAX's store after two adds and a grow (new
    capacity scales 1.0, as there)."""
    x = _unit(np.random.default_rng(1).standard_normal((300, 64)))
    js, ts = _store_pair(x[:200], capacity=256)
    js.add(jnp.asarray(x[200:250]))
    ts.add(torch.from_numpy(x[200:250]))
    js.grow(512)
    ts.grow(512)
    assert ts.data.dtype == torch.int8 and ts.size == 250 and ts.capacity == 512
    np.testing.assert_array_equal(ts.data.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(ts.scales.numpy(), np.asarray(js.scales))
    np.testing.assert_array_equal(ts.scales_view.numpy(), np.asarray(js.scales_view))


def test_int8_store_save_load_both_ways(tmp_path):
    x = _unit(np.random.default_rng(2).standard_normal((120, 32)))
    js, ts = _store_pair(x, capacity=200)
    js.mark_deleted([3, 7])
    ts.mark_deleted([3, 7])
    js.save(str(tmp_path / "jax_store"))
    ts.save(str(tmp_path / "port_store"))
    from_jax = EmbeddingStore.load(str(tmp_path / "jax_store"), device="cpu")
    from_port = JaxStore.load(str(tmp_path / "port_store"))
    assert from_jax.quantized and from_port.quantized and from_jax.capacity == 200
    np.testing.assert_array_equal(from_jax.view.numpy(), np.asarray(js.view))
    np.testing.assert_array_equal(from_jax.scales_view.numpy(), np.asarray(js.scales_view))
    np.testing.assert_array_equal(from_jax.alive_view.numpy(), np.asarray(js.alive_view))
    np.testing.assert_array_equal(np.asarray(from_port.view), ts.view.numpy())
    np.testing.assert_array_equal(np.asarray(from_port.scales_view), ts.scales_view.numpy())


def test_brute_force_over_int8_store_is_k3_with_tombstones():
    """BruteForceIndex over an int8 store = K3's semantics (f32 queries,
    Pallas interpret mode) with the 2k over-fetch and tombstone filter."""
    q, x = _dup_data(1500, seed=5)
    js, ts = _store_pair(x)
    dead = [int(i) for i in np.random.default_rng(5).choice(1500, 40, replace=False)]
    ts.mark_deleted(dead)
    s, i = BruteForceIndex(ts).query(torch.from_numpy(q), k=10)
    ps, pi = cosine_topk_pallas_int8(jnp.asarray(q), js.view, js.scales_view, k=20,
                                     block_q=8, block_c=128, interpret=True)
    ps, pi = np.asarray(ps), np.asarray(pi)
    alive = np.ones(1500, bool)
    alive[dead] = False
    for r in range(len(q)):
        keep = alive[pi[r]]
        want = pi[r][keep][:10]
        assert i[r][: len(want)].tolist() == want.tolist()
        np.testing.assert_allclose(s[r][: len(want)], ps[r][keep][:10], atol=1e-5)
    assert not np.isin(i, dead).any()


def test_int8_matmul_scores_ranks_as_jax_xla_query():
    """The reference's CPU query of an int8 store (XLA branch: queries
    quantized too): int8_matmul_scores + top-k gives its ids and scores."""
    q, x = _dup_data(800, seed=6)
    js, ts = _store_pair(x)
    want_s, want_i = JaxBrute(js).query(jnp.asarray(q), k=10, impl="xla")
    scores = int8_matmul_scores(torch.from_numpy(q), ts.view, ts.scales_view)
    ids = torch.arange(800, dtype=torch.int32).expand(len(q), -1)
    got_s, got_i = select_topk(scores, ids, 20)
    np.testing.assert_array_equal(got_i[:, :10].numpy(), want_i)
    np.testing.assert_allclose(got_s[:, :10].numpy(), want_s, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("quantized", [False, True])
def test_mine_matches_jax(quantized):
    """All-pairs mining (self-match and tombstones dropped; an int8 store
    dequantized): ids equal, scores allclose 1e-5."""
    rng = np.random.default_rng(7)
    x = _unit(rng.standard_normal((700, 32)))
    x[600:650] = x[:50]                        # duplicates: exact ties
    if quantized:
        js, ts = _store_pair(x)
    else:
        js, ts = JaxStore(700, 32), EmbeddingStore(700, 32, device="cpu")
        js.add(jnp.asarray(x))
        ts.add(torch.from_numpy(x))
    dead = [5, 17, 620]
    js.mark_deleted(dead)
    ts.mark_deleted(dead)
    want_s, want_i = JaxBrute(js).mine(k=5, batch=256)
    got_s, got_i = BruteForceIndex(ts).mine(k=5, batch=256)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)
    assert (got_i[dead] == -1).all() and not np.isin(got_i, dead).any()


# ---------------------------------------------------------------------------
# K4 and the int8 IVF index
# ---------------------------------------------------------------------------

def _clustered(n=4096, d=64, centers=64, q=40, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d))
    x = _unit(c[rng.integers(0, centers, n)] * 3.0 + rng.standard_normal((n, d)))
    return _unit(x[:q] + 0.1 * rng.standard_normal((q, d))), x


CFG = dict(num_clusters=16, num_probes=4, kmeans_iters=4, max_cluster_size=256,
           quantize_int8=True)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A JAX-built int8 index (Mc 256, overflow slabs, bf16 rescore copy),
    saved and loaded into the port."""
    q, x = _clustered()
    jivf = JaxIVFIndex.build(jnp.asarray(x), JaxIndexConfig(**CFG), key=jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("ivf8") / "ivf.npz")
    jivf.save(path)
    tivf = IVFIndex.load(path, device="cpu")
    assert tivf.data_padded.dtype == torch.int8 and tivf.num_overflow > 0
    assert tivf.rescore_data.dtype == torch.bfloat16
    return q, x, jivf, tivf, path


@pytest.mark.parametrize("approx_width,acc_slots", [(0, 1), (128, 1), (128, 2), (256, 2)])
@pytest.mark.parametrize("k", [10, 20])
def test_k4_plain_matches_pallas(built, approx_width, acc_slots, k):
    """ivf_scan_reference on int8 slabs against _ivf_query_pallas with
    scales in interpret mode, on one probe plan: exact mode and the
    deferred fold with S 1 and S 2. ids equal, scores allclose 1e-5."""
    q, _, jivf, tivf, _ = built
    qs, probes, _ = _plan_probes(
        torch.from_numpy(q), tivf.centroids, tivf.num_base_clusters,
        tivf.data_padded.shape[0], 8, 8,
    )
    js, ji = _ivf_query_pallas(
        jnp.asarray(qs.numpy()), jnp.asarray(probes.numpy()), jivf.data_padded,
        jivf.ids_padded, jivf.scales_padded, k, 8, interpret=True,
        approx_width=approx_width, acc_slots=acc_slots,
    )
    ts, ti = ivf_scan(qs, probes, tivf.data_padded, tivf.ids_padded, k, 8,
                      approx_width, acc_slots, scales=tivf.scales_padded)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("k_coarse", [0, -1, 30])
@pytest.mark.parametrize("approx_width,acc_slots", [(0, 0), (128, 0), (128, 2)])
@pytest.mark.parametrize("n_q", [1, 5, 40])
def test_query_with_rescore_matches_pallas(built, k_coarse, approx_width, acc_slots, n_q):
    """IVFIndex.query on the JAX-saved int8 npz against JAX query(impl=
    "pallas"): default rescore (k_coarse 2k), raw int8 (k_coarse -1) and a
    wider pool. ids equal, scores allclose 1e-5."""
    q, _, jivf, tivf, _ = built
    args = dict(k=10, block_q=4 if n_q == 5 else 8, union_factor=1,
                approx_width=approx_width, acc_slots=acc_slots, k_coarse=k_coarse)
    js, ji = jivf.query(jnp.asarray(q[:n_q]), impl="pallas", **args)
    ts, ti = tivf.query(torch.from_numpy(q[:n_q]), **args)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_int8_query_xla_matches_jax(built):
    """Per-query probes with per-slot scales (the XLA path, no rescore)."""
    q, _, jivf, tivf, _ = built
    js, ji = jivf.query_xla(jnp.asarray(q), k=10)
    ts, ti = tivf.query_xla(torch.from_numpy(q), k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_int8_ivf_save_load_both_ways(built, tmp_path):
    q, _, jivf, tivf, _ = built
    path = str(tmp_path / "port_ivf")
    tivf.save(path)
    back = JaxIVFIndex.load(path)
    for name in ("data_padded", "ids_padded", "scales_padded"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), getattr(tivf, name).numpy())
    np.testing.assert_array_equal(
        np.asarray(back.rescore_data).astype(np.float32), tivf.rescore_data.float().numpy()
    )
    again = IVFIndex.load(path, device="cpu")
    a = tivf.query(torch.from_numpy(q), k=5, block_q=8)
    b = again.query(torch.from_numpy(q), k=5, block_q=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _assert_layout_equal(jivf, tivf):
    for name in ("data_padded", "ids_padded", "scales_padded"):
        np.testing.assert_array_equal(getattr(tivf, name).numpy(),
                                      np.asarray(getattr(jivf, name)), err_msg=name)
    np.testing.assert_array_equal(tivf.rescore_data.float().numpy(),
                                  np.asarray(jivf.rescore_data).astype(np.float32))
    assert tivf.num_overflow == jivf.num_overflow


def test_add_remove_match_jax(built):
    """add (free slots of the nearest clusters, then new overflow slabs
    with scale 0) and remove (slots cleared, rescore copy kept) leave the
    same layout as JAX's, and queries then agree (ids equal)."""
    q, x, _, _, path = built
    jivf, tivf = JaxIVFIndex.load(path), IVFIndex.load(path, device="cpu")
    rng = np.random.default_rng(9)
    new = _unit(x[rng.integers(0, 4096, 600)] + 0.05 * rng.standard_normal((600, 64)))
    for chunk in (new[:8], new[8:]):      # the second add overflows its clusters
        start = int(tivf.rescore_data.shape[0])
        want = jivf.add(jnp.asarray(chunk), start_id=start)
        got = tivf.add(torch.from_numpy(chunk), start_id=start)
        np.testing.assert_array_equal(got, want)
    assert tivf.num_overflow > 1
    _assert_layout_equal(jivf, tivf)
    assert (tivf.scales_padded[tivf.ids_padded < 0] >= 0).all()
    gone = np.arange(0, 4096, 7)
    assert tivf.remove(gone) == jivf.remove(gone) == gone.size
    assert tivf.remove(gone) == 0
    _assert_layout_equal(jivf, tivf)
    qs = np.concatenate([q, new[:8]])
    js, ji = jivf.query(jnp.asarray(qs), k=10, block_q=8, impl="pallas")
    ts, ti = tivf.query(torch.from_numpy(qs), k=10, block_q=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert not np.isin(ti.numpy(), gone).any()
    # each added row finds itself first
    assert (ti.numpy()[len(q):, 0] == np.arange(4096, 4104)).all()


def test_port_int8_build_matches_jax_quality():
    """k-means RNG differs: the port's int8 build (bf16 rescore copy) has
    recall@10 within 0.02 of the JAX build's and ≥ 0.9."""
    q, x = _clustered(n=6000, seed=7, q=64)
    cfg = dict(num_clusters=32, num_probes=6, kmeans_iters=6)
    _, exact = cosine_topk_xla(jnp.asarray(q), jnp.asarray(x), k=10)
    exact = np.asarray(exact)
    jivf = JaxIVFIndex.build(jnp.asarray(x), JaxIndexConfig(**cfg, quantize_int8=True),
                             key=jax.random.PRNGKey(1))
    tivf = IVFIndex.build(torch.from_numpy(x), IndexConfig(**cfg, quantize_int8=True),
                          generator=torch.Generator().manual_seed(1), device="cpu")
    assert tivf.data_padded.dtype == torch.int8 and tivf.rescore_data.dtype == torch.bfloat16
    assert tivf.scales_padded.shape == tivf.ids_padded.shape
    args = dict(k=10, block_q=8, union_factor=1)
    _, ji = jivf.query(jnp.asarray(q), impl="pallas", **args)
    _, ti = tivf.query(torch.from_numpy(q), **args)
    r_jax, r_port = _overlap(exact, np.asarray(ji)), _overlap(exact, ti.numpy())
    assert abs(r_port - r_jax) <= 0.02 and r_port >= 0.9, (r_port, r_jax)
    plain = IVFIndex.build(torch.from_numpy(x), IndexConfig(**cfg), device="cpu",
                           generator=torch.Generator().manual_seed(1), keep_rescore=False,
                           data_dtype=torch.int8)
    assert plain.rescore_data is None and plain.scales_padded is not None


def test_ivf_scan_checks_int8_arguments(built):
    _, _, _, tivf, _ = built
    q = torch.zeros((8, 64))
    probes = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):     # CPU tensors never reach the kernel
        ivf_scan_cuda(q, probes, tivf.data_padded, tivf.ids_padded, 10, 8,
                      scales=tivf.scales_padded)
    with pytest.raises(ValueError):
        IVFIndex(tivf.centroids, tivf.data_padded, tivf.ids_padded,
                 tivf.num_base_clusters, tivf.config)


# ---------------------------------------------------------------------------
# The int8 pipeline
# ---------------------------------------------------------------------------

def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}{chr(97 + i * 11 % 26)}{i}"
             for i in range(2000)]
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(rng.choice(words, rng.integers(8, 25)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


@pytest.fixture(scope="module")
def saved_pipeline(tmp_path_factory):
    """A JAX int8 encoder (to_int8, saved with its {q, s} leaves) and an
    int8 IVF pipeline over it, both saved."""
    corpus = _corpus(1500)
    jtok = JaxTokenizer(train_wordpiece_vocab(corpus, vocab_size=2000, min_freq=1))
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=jtok.vocab_size)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), jarch), jarch,
                              tokenizer=jtok, precision=JAX_FP32).to_int8()
    root = tmp_path_factory.mktemp("int8_pipe")
    jenc.save(str(root / "enc"))
    jpipe = JaxPipeline(
        jenc, corpus=corpus, use_ivf=True,
        index_config=JaxIndexConfig(num_clusters=16, num_probes=3, kmeans_iters=4,
                                    quantize_int8=True),
    )
    jpipe._build_ivf()
    jpipe.save(str(root / "ivf"))
    return root, jenc, jpipe, corpus


def _port_pipeline(root):
    enc = SentenceEncoder.load(str(root / "enc"), bf16=False, device="cpu")
    assert enc.params["layers"]["mlp"]["in"]["w"]["q"].dtype == torch.int8
    pipe = SemanticSearchPipeline(enc, use_ivf=True, device="cpu")
    pipe.load_corpus(str(root / "ivf"))
    assert pipe.ivf.data_padded.dtype == torch.int8
    return pipe


def _jax_answer(jpipe, jenc, queries, k):
    q_emb = jax_pad_pow2(jenc.encode(queries, device_output=True, packed=False))
    mc = jpipe.ivf.data_padded.shape[1]
    s, i = jpipe.ivf.query(q_emb, k=k, block_q=64, union_factor=1,
                           approx_width=2048 if mc >= 1024 else 0, impl="pallas")
    return np.asarray(s), np.asarray(i)


def _assert_answers(got, s, i, corpus):
    for r, row in enumerate(got):
        keep = (i[r] >= 0) & np.isfinite(s[r])
        assert [x[2] for x in row] == i[r][keep].tolist()
        assert [x[0] for x in row] == [corpus[j] for j in i[r][keep]]
        np.testing.assert_allclose([x[1] for x in row], s[r][keep], atol=1e-5)


@pytest.mark.parametrize("req", [(0, 1), (5, 8), (100, 140)])
def test_int8_pipeline_loaded_from_jax_answers_as_jax(saved_pipeline, req):
    """The port's int8 pipeline (int8 encoder, int8 IVF + bf16 rescore)
    returns the JAX index's pallas answers with the serving args: ids and
    documents equal, scores allclose 1e-5."""
    root, jenc, jpipe, corpus = saved_pipeline
    pipe = _port_pipeline(root)
    queries = corpus[req[0]:req[1]] + ["an unseen query of new words"]
    _assert_answers(pipe(queries, max_num_results=5),
                    *_jax_answer(jpipe, jenc, queries, 5), jpipe.corpus)


def test_int8_pipeline_add_and_remove_match_jax(saved_pipeline):
    """add_documents goes into the built int8 index and remove_documents
    clears slots, on both sides: the same answers, the added document
    finds itself, a removed one never comes back."""
    root, jenc, _, corpus = saved_pipeline
    pipe = _port_pipeline(root)
    jpipe = JaxPipeline(jenc, use_ivf=True)
    jpipe.load_corpus(str(root / "ivf"))
    new = ["a freshly added document about nothing at all",
           "another new line of text that was not indexed"]
    assert pipe.add_documents(new).tolist() == jpipe.add_documents(new).tolist() == [1500, 1501]
    assert pipe.ivf is not None and pipe.ivf.rescore_data.shape[0] == 1502
    gone = [3, 10, 1501]
    assert pipe.remove_documents(gone) == jpipe.remove_documents(gone) == 3
    queries = [corpus[3], corpus[10], new[0], new[1], corpus[20]]
    got = pipe(queries, max_num_results=5)
    _assert_answers(got, *_jax_answer(jpipe, jenc, queries, 5), jpipe.corpus)
    assert not {x[2] for row in got for x in row} & set(gone)
    # alone, a query's probe union holds its own cluster
    assert pipe(new[:1], 1)[0][0][2] == 1500


def test_int8_pipeline_built_by_the_port(saved_pipeline, tmp_path):
    """The port builds its own int8 index through IndexConfig(quantize_int8
    =True), saves and reloads it; verbatim documents find themselves."""
    root, _, _, corpus = saved_pipeline
    enc = SentenceEncoder.load(str(root / "enc"), bf16=False, device="cpu")
    cfg = dataclasses.replace(IndexConfig.auto(1500), quantize_int8=True)
    pipe = SemanticSearchPipeline(enc, corpus=corpus, index_config=cfg, use_ivf=True,
                                  device="cpu")
    got = pipe(corpus[:1], 3)
    assert pipe.ivf.data_padded.dtype == torch.int8
    assert got[0][0][2] == 0
    pipe.save(str(tmp_path / "p"))
    again = SemanticSearchPipeline(enc, use_ivf=True, device="cpu")
    again.load_corpus(str(tmp_path / "p"))
    assert again(corpus[:4], 3) == pipe(corpus[:4], 3)
