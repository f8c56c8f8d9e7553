"""The distributed serving path against the JAX package on its 8 virtual CPU
devices: the mesh and its collectives, the sharded brute-force and IVF
indexes (the IVF layout from the JAX package's centroids, bit for bit),
``ShardedSearchPipeline``, ``SearchServer`` over it and ``serve --shards``.
The port places its 8 shards on the one CPU (a device list may repeat a
device), the JAX package on its 8 virtual devices; inputs from numpy seeds,
tiny-test arch, f32."""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import IndexConfig as JaxIndexConfig
from text_similarity_tpu.core.mesh import make_mesh as jax_make_mesh
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu.index.sharded import ShardedBruteForceIndex as JaxShardedBrute
from text_similarity_tpu.index.sharded import ShardedIVFIndex as JaxShardedIVF
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.pipelines import ShardedSearchPipeline as JaxShardedPipeline
from text_similarity_tpu_torch.cli.main import build_parser, build_server
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, IndexConfig
from text_similarity_tpu_torch.core.mesh import (
    AXES, all_gather, all_to_all, is_multichip, local_mesh, make_mesh, on_devices, ppermute,
    replicate, shard_batch,
)
from text_similarity_tpu_torch.index import ShardedBruteForceIndex, ShardedIVFIndex
from text_similarity_tpu_torch.index.sharded import _pack_results, _unpack_results
from text_similarity_tpu_torch.models import SentenceEncoder, init_params
from text_similarity_tpu_torch.pipelines import SearchServer, ShardedSearchPipeline
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU8 = ["cpu"] * 8


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _corpus_vectors(n, d, seed=0):
    return _unit(np.random.RandomState(seed).randn(n, d))


def _clustered(n, d, n_centers, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, d).astype(np.float32)
    assign = rng.randint(0, n_centers, n)
    return _unit(centers[assign] * 3.0 + rng.randn(n, d).astype(np.float32))


def _ids_equal_where_separated(got_s, got_i, want_s, want_i, gap=1e-5):
    """Ids equal at every rank whose score stands apart from its neighbours
    in the reference's list (ties may order either way)."""
    for gs, gi, ws, wi in zip(got_s, got_i, want_s, want_i):
        for r in range(len(wi)):
            lo = r == 0 or ws[r - 1] - ws[r] > gap
            hi = r == len(wi) - 1 or ws[r] - ws[r + 1] > gap
            if lo and hi:
                assert gi[r] == wi[r], (r, gi, wi)
        np.testing.assert_allclose(gs, ws, atol=1e-6)


@pytest.fixture(scope="module")
def meshes(eight_devices):
    return jax_make_mesh(data=1, index=8), make_mesh(data=1, index=8, devices=CPU8)


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [
    dict(), dict(data=1, index=8), dict(data=2, seq=4), dict(data=-1, model=2, index=2),
    dict(data=1, pipe=2, expert=2, seq=2),
])
def test_make_mesh_shapes_match_jax(eight_devices, axes):
    jm = jax_make_mesh(**axes)
    m = make_mesh(**axes, devices=CPU8)
    assert tuple(jm.axis_names) == AXES == m.axis_names
    assert dict(jm.shape) == m.shape
    assert m.devices.shape == jm.devices.shape and m.devices.size == 8


@pytest.mark.parametrize("axes,message", [
    (dict(index=3), "not divisible"), (dict(data=3, index=2), "!= 8 devices"),
])
def test_make_mesh_errors_match_jax(eight_devices, axes, message):
    with pytest.raises(ValueError, match=message):
        jax_make_mesh(**axes)
    with pytest.raises(ValueError, match=message):
        make_mesh(**axes, devices=CPU8)


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert make_mesh().first_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()
    assert make_mesh(device="cpu").shape["data"] == 1
    assert local_mesh(device="cpu").shape == make_mesh(device="cpu").shape
    assert is_multichip() == (torch.cuda.is_available() and torch.cuda.device_count() > 1)


def test_axis_devices_and_placement():
    devs = [torch.device("cpu")] * 8
    m = make_mesh(data=2, index=4, devices=devs)
    assert len(m.axis_devices("index")) == 4 and len(m.axis_devices("data")) == 2
    x = torch.arange(10.0)[:, None]
    parts = shard_batch(m, {"x": x})
    assert [p["x"].shape[0] for p in parts] == [5, 5]
    assert torch.equal(torch.cat([p["x"] for p in parts]), x)
    reps = replicate(m, {"w": x}, "index")
    assert len(reps) == 4 and all(r is reps[0] for r in reps)   # one copy a device


def test_on_devices_copies_once_for_each_distinct_device():
    """One copy a distinct device, none on the device a leaf lies on; the
    data-parallel encoder's weights on its own device are its own."""
    x = torch.arange(6.0).reshape(2, 3)
    copies = on_devices({"a": {"w": x}}, ["cpu", "meta", torch.device("cpu"), "meta"])
    assert list(copies) == [torch.device("cpu"), torch.device("meta")]
    assert copies[torch.device("cpu")]["a"]["w"] is x
    assert copies[torch.device("meta")]["a"]["w"].shape == x.shape
    arch = ARCH_PRESETS["tiny-test"]
    enc = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                          device="cpu", mesh=make_mesh(data=4, devices=["cpu"] * 4))
    own = enc._params_on(torch.device("cpu"))
    assert own["embeddings"]["word"].data_ptr() == enc.params["embeddings"]["word"].data_ptr()


def _jax_collective(fn, x, n=8):
    mesh = jax_make_mesh(data=1, seq=n)
    spec = P("seq")
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec))(x))


@pytest.mark.parametrize("split,concat", [(1, 2), (2, 1), (1, 1), (2, 2)])
def test_all_to_all_matches_jax(eight_devices, split, concat):
    x = np.random.RandomState(split * 3 + concat).randn(8 * 2, 8, 16).astype(np.float32)
    want = _jax_collective(
        lambda t: jax.lax.all_to_all(t, "seq", split_axis=split, concat_axis=concat,
                                     tiled=True), x)
    got = torch.cat(all_to_all(list(torch.as_tensor(x).chunk(8)), split, concat)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ppermute_and_all_gather_match_jax(eight_devices):
    x = np.random.RandomState(5).randn(8 * 3, 4).astype(np.float32)
    perm = [(i, (i + 1) % 8) for i in range(8)]
    want = _jax_collective(lambda t: jax.lax.ppermute(t, "seq", perm), x)
    pieces = list(torch.as_tensor(x).chunk(8))
    np.testing.assert_array_equal(torch.cat(ppermute(pieces, perm)).numpy(), want)
    # a position nobody sends to gets zeros, as in JAX
    want = _jax_collective(lambda t: jax.lax.ppermute(t, "seq", [(0, 1)]), x)
    np.testing.assert_array_equal(torch.cat(ppermute(pieces, [(0, 1)])).numpy(), want)
    want = _jax_collective(lambda t: jax.lax.all_gather(t, "seq", axis=1, tiled=True), x)
    np.testing.assert_array_equal(
        torch.cat(all_gather(pieces, dim=1, tiled=True)).numpy(), want)


# ---------------------------------------------------------------------------
# Sharded brute force
# ---------------------------------------------------------------------------

def test_pack_results_round_trip():
    s = torch.tensor([[0.5, -1.25], [float("-inf"), 3e-39]])
    i = torch.tensor([[3, 7], [-1, 2**23 - 1]], dtype=torch.int32)
    ss, ii = _unpack_results(_pack_results(s, i), 2)
    np.testing.assert_array_equal(ss, s.numpy())
    np.testing.assert_array_equal(ii, i.numpy())


@pytest.mark.parametrize("n,k", [(2000, 10), (1001, 25), (37, 37)])
def test_sharded_brute_force_matches_jax(meshes, n, k):
    jm, m = meshes
    x = _corpus_vectors(n, 64)
    q = _corpus_vectors(32, 64, seed=1)
    js, ji = JaxShardedBrute.build(jm, jnp.asarray(x)).query(jnp.asarray(q), k=k)
    ps, pi = ShardedBruteForceIndex.build(m, x).query(q, k=k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, atol=1e-6)


def test_sharded_brute_force_negative_scores_with_padding(meshes):
    """100 rows pad to 128 over 8 shards: the zero rows must not push out
    real negative-score neighbours (the reference's regression case)."""
    jm, m = meshes
    emb = np.random.RandomState(0).randn(100, 16).astype(np.float32)
    emb[:, 0] += 6.0             # one half-space: every true score below is negative
    emb = _unit(emb)
    q = -emb[-4:]
    js, ji = JaxShardedBrute.build(jm, jnp.asarray(emb)).query(jnp.asarray(q), k=5)
    idx = ShardedBruteForceIndex.build(m, emb)
    assert idx.n_pad == 28
    ps, pi = idx.query(q, k=5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, atol=1e-6)
    assert np.isfinite(ps).all() and (pi < 100).all() and (ps < 0).all()


# ---------------------------------------------------------------------------
# Sharded IVF: the layout from the JAX package's centroids, then queries
# ---------------------------------------------------------------------------

IVF_CASES = {
    "f32": dict(n=4000, d=64, centers=48, cfg=dict(num_clusters=64, num_probes=6, kmeans_iters=4),
                dtype="f32", sentinel=False),
    "bf16": dict(n=4000, d=64, centers=48, cfg=dict(num_clusters=64, num_probes=6, kmeans_iters=4),
                 dtype="bf16", sentinel=False),
    "bf16_sentinel": dict(n=4001, d=64, centers=48,
                          cfg=dict(num_clusters=64, num_probes=6, kmeans_iters=4),
                          dtype="bf16", sentinel=True),
    "capped": dict(n=8192, d=32, centers=24,
                   cfg=dict(num_clusters=4, num_probes=3, kmeans_iters=3, max_cluster_size=256),
                   dtype="f32", sentinel=False),
}


@pytest.fixture(scope="module")
def ivf_pairs(meshes):
    """Each case: the JAX index, the port's built from its centroids, the
    corpus and 37 queries near corpus rows."""
    jm, m = meshes
    out = {}
    for name, case in IVF_CASES.items():
        x = _clustered(case["n"], case["d"], case["centers"])
        jdt, pdt = ((jnp.float32, torch.float32) if case["dtype"] == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        jidx = JaxShardedIVF.build(jm, jnp.asarray(x), JaxIndexConfig(**case["cfg"]),
                                   data_dtype=jdt, sentinel=case["sentinel"])
        pidx = ShardedIVFIndex.build(m, x, IndexConfig(**case["cfg"]), data_dtype=pdt,
                                     sentinel=case["sentinel"],
                                     centroids=np.array(jidx.centroids))
        out[name] = (jidx, pidx, x, _unit(x[:37] + 0.01))
    return out


@pytest.mark.parametrize("case", sorted(IVF_CASES))
def test_sharded_ivf_layout_equals_jax_bit_for_bit(ivf_pairs, case):
    jidx, pidx, _, _ = ivf_pairs[case]
    jd = np.asarray(jidx.data_padded.astype(jnp.float32))
    pd = torch.cat(pidx.data_padded).float().numpy()
    c_tot, mc = pidx.data_padded[0].shape[:2]
    assert jd.shape == pd.shape and jd.shape[0] == 8 * c_tot and jidx.data_padded.shape[1] == mc
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(torch.cat(pidx.ids_padded).numpy(), np.asarray(jidx.ids_padded))
    assert pidx.data_padded[0].dtype == (torch.float32 if IVF_CASES[case]["dtype"] == "f32"
                                         else torch.bfloat16)
    if case == "capped":
        assert mc == 256 and c_tot > pidx.num_base_clusters + 1   # overflow slabs in use


@pytest.mark.parametrize("case", sorted(IVF_CASES))
@pytest.mark.parametrize("impl,jax_impl", [("xla", "xla"), ("kernel", "pallas")])
def test_sharded_ivf_query_matches_jax(ivf_pairs, case, impl, jax_impl):
    """The XLA path against the JAX package's; the kernel-semantics path
    (K1's plain version on the CPU) against the JAX package's Pallas path in
    interpret mode: ids equal where the scores are separated."""
    jidx, pidx, _, q = ivf_pairs[case]
    k = 50 if case == "capped" else 10
    js, ji = jidx.query(jnp.asarray(q), k=k, impl=jax_impl)
    ps, pi = pidx.query(q, k=k, impl=impl)
    assert ps.shape == (37, k) and pi.shape == (37, k)   # the padded batch sliced
    _ids_equal_where_separated(ps, pi, np.asarray(js), np.asarray(ji))


def test_sharded_ivf_auto_is_the_xla_path_on_the_cpu(ivf_pairs):
    _, pidx, _, q = ivf_pairs["bf16"]
    for a, b in zip(pidx.query(q, k=10), pidx.query(q, k=10, impl="xla")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="impl"):
        pidx.query(q, k=10, impl="pallas")


def test_sharded_ivf_clamps_k_to_the_probed_pool(ivf_pairs):
    jidx, pidx, _, q = ivf_pairs["f32"]
    _, k_eff = pidx.query_packed(q, k=100_000, probes=1)
    c_tot, mc = pidx.data_padded[0].shape[:2]
    assert k_eff == (1 + c_tot - pidx.num_base_clusters) * mc
    assert k_eff == jidx.query_packed(jnp.asarray(q), k=100_000, probes=1)[1]


def test_sharded_ivf_own_kmeans_recall():
    """The port's own distributed Lloyd (no JAX centroids): global
    clusters, recall@10 ≥ 0.9 against exact search, as the reference's
    test asks of its build."""
    m = make_mesh(data=1, index=8, devices=CPU8)
    x = _clustered(4000, 64, 48)
    q = _unit(x[:32] + 0.01)
    idx = ShardedIVFIndex.build(m, x, IndexConfig(num_clusters=64, num_probes=6, kmeans_iters=6))
    assert idx.num_base_clusters == 64
    _, got = idx.query(q, k=10)
    exact = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, exact)])
    assert recall >= 0.9, recall
    assert (got >= 0).all() and (got < 4000).all()


@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_single_shard_path_matches_jax(eight_devices, kind):
    """index=1: the shard's own top-k is the answer (no merge), in both
    packages."""
    jm = jax_make_mesh(data=8, index=1)
    m = make_mesh(data=8, index=1, devices=CPU8)
    if kind == "brute":
        x, q = _corpus_vectors(1200, 64), _corpus_vectors(24, 64, seed=3)
        js, ji = JaxShardedBrute.build(jm, jnp.asarray(x)).query(jnp.asarray(q), k=10)
        ps, pi = ShardedBruteForceIndex.build(m, x).query(q, k=10)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(ps, js, atol=1e-6)
        return
    x = _clustered(3000, 64, 32)
    q = _unit(x[:24] + 0.01)
    cfg = dict(num_clusters=32, num_probes=6, kmeans_iters=3)
    jidx = JaxShardedIVF.build(jm, jnp.asarray(x), JaxIndexConfig(**cfg))
    pidx = ShardedIVFIndex.build(m, x, IndexConfig(**cfg), centroids=np.array(jidx.centroids))
    assert len(pidx.data_padded) == 1
    js, ji = jidx.query(jnp.asarray(q), k=10)
    ps, pi = pidx.query(q, k=10)
    _ids_equal_where_separated(ps, pi, js, ji)


# ---------------------------------------------------------------------------
# ShardedSearchPipeline, SearchServer, serve --shards
# ---------------------------------------------------------------------------

def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}{i}" for i in range(600)]
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(rng.choice(words, rng.integers(5, 14)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


CORPUS = _texts(300)


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """A JAX tiny-test encoder and its save loaded into the port (f32, CPU)."""
    tok = JaxTokenizer(train_wordpiece_vocab(CORPUS, vocab_size=800, min_freq=1))
    arch = JAX_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), arch), arch, tokenizer=tok,
                              precision=JAX_FP32)
    root = tmp_path_factory.mktemp("sharded")
    jenc.save(str(root / "enc"))
    (root / "corpus.txt").write_text("\n".join(CORPUS) + "\n")
    enc = SentenceEncoder.load(str(root / "enc"), bf16=False, device="cpu")
    return jenc, enc, root


def _answers(rows):
    return [[(d, i) for d, _, i in r] for r in rows]


def test_sharded_pipeline_brute_force_equals_jax(encoders, meshes):
    jenc, enc, _ = encoders
    jm, m = meshes
    jpipe = JaxShardedPipeline(jenc, jm, corpus=CORPUS, use_ivf=False)
    pipe = ShardedSearchPipeline(enc, m, corpus=CORPUS, use_ivf=False)
    queries = [CORPUS[0], CORPUS[5], "zz an unseen query", CORPUS[77]]
    got, want = pipe(queries, max_num_results=5), jpipe(queries, max_num_results=5)
    assert _answers(got) == _answers(want)
    np.testing.assert_allclose([[s for _, s, _ in r] for r in got],
                               [[s for _, s, _ in r] for r in want], atol=1e-5)
    for q, row in zip(queries, got):
        if q in CORPUS:
            assert row[0][0] == q and row[0][1] > 0.999
    assert pipe([]) == [] and pipe.size == len(CORPUS)
    # tombstones: brute force over-fetches (a power of 2) and filters
    assert pipe.remove_documents([0, 5]) == 2 and jpipe.remove_documents([0, 5]) == 2
    assert pipe.remove_documents([0]) == 0
    got, want = pipe(queries, max_num_results=5), jpipe(queries, max_num_results=5)
    assert _answers(got) == _answers(want)
    assert all(len(r) == 5 and all(i not in (0, 5) for _, _, i in r) for r in got)


def test_sharded_pipeline_ivf_tombstones_and_reload(encoders, meshes, tmp_path):
    _, enc, _ = encoders
    _, m = meshes
    cfg = IndexConfig(num_clusters=8, num_probes=3, kmeans_iters=3)
    pipe = ShardedSearchPipeline(enc, m, corpus=CORPUS, use_ivf=True, index_config=cfg)
    assert pipe.ivf is pipe.index and isinstance(pipe.index, ShardedIVFIndex)
    res = pipe([CORPUS[2], CORPUS[9]], max_num_results=3)
    assert [r[0][2] for r in res] == [2, 9] and res[0][0][1] > 0.999
    assert pipe.remove_documents([2]) == 1
    ids = torch.cat(pipe.index.ids_padded)
    assert not (ids == 2).any()
    res = pipe([CORPUS[2]], max_num_results=3)
    assert all(row[2] != 2 for row in res[0]) and len(res[0]) == 3
    pipe.save(str(tmp_path / "sp"))
    loaded = ShardedSearchPipeline.load(str(tmp_path / "sp"), enc, m)
    assert loaded.ivf is not None and loaded._removed == {2}
    assert loaded.index_config.num_clusters == 8
    assert _answers(loaded([CORPUS[2], CORPUS[40]], 3)) == _answers(pipe([CORPUS[2], CORPUS[40]], 3))


def test_sharded_pipeline_sentinel_tombstone_zeroes_the_column(encoders, meshes):
    _, enc, _ = encoders
    _, m = meshes
    pipe = ShardedSearchPipeline(enc, m, corpus=CORPUS[:64], use_ivf=False)
    pipe.index = ShardedIVFIndex.build(m, pipe._emb, IndexConfig(num_clusters=4, num_probes=2,
                                                                 kmeans_iters=2),
                                       data_dtype=torch.bfloat16, sentinel=True)
    pipe.ivf = pipe.index
    pipe.remove_documents([3])
    for data, ids in zip(pipe.index.data_padded, pipe.index.ids_padded):
        live = ids >= 0
        assert (data[..., -1][live] == 2).all()
    col = torch.cat([d[..., -1] for d in pipe.index.data_padded])
    assert int((col == 2).sum()) == 63
    assert all(r[2] != 3 for r in pipe([CORPUS[3]], 4)[0])


def test_sharded_pipeline_loads_a_jax_saved_directory(encoders, meshes, tmp_path):
    jenc, enc, _ = encoders
    jm, m = meshes
    jpipe = JaxShardedPipeline(jenc, jm, corpus=CORPUS, use_ivf=False)
    jpipe.remove_documents([7])
    jpipe.save(str(tmp_path / "jax"))
    pipe = ShardedSearchPipeline.load(str(tmp_path / "jax"), enc, m)
    assert pipe.corpus == CORPUS and pipe._removed == {7} and pipe.ivf is None
    queries = [CORPUS[7], CORPUS[8]]
    assert _answers(pipe(queries, 4)) == _answers(jpipe(queries, 4))
    # and the port's save loads in the JAX package
    pipe.save(str(tmp_path / "port"))
    back = JaxShardedPipeline.load(str(tmp_path / "port"), jenc, jm)
    assert back.corpus == CORPUS and back._removed == {7}
    assert _answers(back(queries, 4)) == _answers(jpipe(queries, 4))


def test_sharded_pipeline_warmup_add_and_edges(encoders, meshes, tmp_path):
    _, enc, _ = encoders
    _, m = meshes
    pipe = ShardedSearchPipeline(enc, m, corpus=CORPUS[:8], use_ivf=False)
    assert pipe.warmup(ks=(3,), max_queries=2) == 2
    assert pipe.warmup(ks=(3, 5), max_queries=4) == 6
    new = pipe.add_documents(["a brand new document about volcanoes"])
    assert list(new) == [8]
    assert pipe(["a brand new document about volcanoes"], 1)[0][0][2] == 8
    res = pipe([CORPUS[0], CORPUS[3], CORPUS[5]], max_num_results=2)
    assert [r[0][0] for r in res] == [CORPUS[0], CORPUS[3], CORPUS[5]]
    assert 1 <= len(pipe([CORPUS[0]], max_num_results=50)[0]) <= 9   # k past the corpus
    empty = ShardedSearchPipeline(enc, m)
    assert empty.warmup() == 0
    empty.save(str(tmp_path / "empty"))
    assert ShardedSearchPipeline.load(str(tmp_path / "empty"), enc, m)([CORPUS[0]], 3) == [[]]


def _http(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_search_server_serves_a_sharded_pipeline(encoders, meshes, tmp_path):
    _, enc, _ = encoders
    _, m = meshes
    pipe = ShardedSearchPipeline(enc, m, corpus=CORPUS, use_ivf=False)
    server = SearchServer(pipe, port=0)
    server.start_background()
    try:
        h = _http(server.port, "/health")
        assert h == {"status": "ok", "size": len(CORPUS), "ivf": False, "sharded": True}
        res = _http(server.port, "/search", {"queries": [CORPUS[1], CORPUS[4]], "k": 2})
        assert [r[0]["document"] for r in res["results"]] == [CORPUS[1], CORPUS[4]]
        assert _http(server.port, "/remove", {"ids": [1]})["removed"] == 1
        res = _http(server.port, "/search", {"queries": [CORPUS[1]], "k": 3})
        assert all(r["id"] != 1 for r in res["results"][0])
        assert _http(server.port, "/health")["size"] == len(CORPUS) - 1
        assert _http(server.port, "/add", {"texts": ["volcanoes erupt"]})["ids"] == [len(CORPUS)]
        _http(server.port, "/save", {"path": str(tmp_path / "saved")})
        assert (tmp_path / "saved" / "sharded_store.npz").exists()
    finally:
        server.shutdown()


def test_serve_shards_8_on_the_cpu(encoders):
    _, _, root = encoders
    args = build_parser().parse_args([
        "serve", "--model", str(root / "enc"), "--corpus", str(root / "corpus.txt"),
        "--shards", "8", "--device", "cpu", "--fp32", "--port", "0", "--warmup", "2",
    ])
    server = build_server(args)
    try:
        pipe = server.pipeline
        assert isinstance(pipe, ShardedSearchPipeline)
        assert pipe.mesh.shape["index"] == 8 and pipe.mesh.shape["data"] == 1
        assert pipe.encoder.mesh.shape["data"] == 8 and len(pipe.index.shards) == 8
        server.start_background()
        assert _http(server.port, "/health")["sharded"] is True
        res = _http(server.port, "/search", {"queries": [CORPUS[11]], "k": 1})
        assert res["results"][0][0]["id"] == 11
    finally:
        server.shutdown()
    # a shard count that does not divide the 128-row batch encodes without a mesh
    args.shards, args.warmup = 3, 0
    server = build_server(args)
    server.shutdown()
    assert server.pipeline.encoder.mesh is None and len(server.pipeline.index.shards) == 3
