"""Kernel K1 (IVF block-union scan) and the IVF index: a JAX-built index
loads into the port, and the port's plain scan is held against the JAX
Pallas kernel (interpret mode) in the exact and deferred merge modes; the
property the wgmma tile's skip of empty tiles relies on (empty slots'
rows change nothing), and how the merge wrapper and the K10 / K11b
wrappers follow the kernel library's plan. The CUDA kernel is held
against the plain scan in test_torch_cuda.py."""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import IndexConfig as JaxIndexConfig
from text_similarity_tpu.index.ivf import IVFIndex as JaxIVFIndex
from text_similarity_tpu.index.ivf import _approx_merge_plan as jax_plan
from text_similarity_tpu.index.ivf import _ivf_query_pallas
from text_similarity_tpu.ops.topk import cosine_topk_xla
from text_similarity_tpu_torch.core.config import IndexConfig
from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
from text_similarity_tpu_torch.index.ivf import (
    TILE_ROWS,
    IVFIndex,
    _approx_merge_plan,
    ivf_scan_reference,
    tile_occupancy,
    tile_part_width,
)
from text_similarity_tpu_torch.index.ivf_modes import TilePlan
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _clustered(n=4096, d=64, centers=64, q=40, seed=0):
    """Gaussian clusters (the bench's recipe at small scale); queries are
    noisy corpus rows."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d))
    x = _unit(c[rng.integers(0, centers, n)] * 3.0 + rng.standard_normal((n, d)))
    qs = _unit(x[:q] + 0.1 * rng.standard_normal((q, d)))
    return qs, x


CFG = dict(num_clusters=16, num_probes=4, kmeans_iters=4, max_cluster_size=256)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def built(request, tmp_path_factory):
    """A JAX-built index (Mc = 256, with overflow slabs), saved and loaded
    into the port."""
    q, x = _clustered()
    dtype = jnp.float32 if request.param == "float32" else jnp.bfloat16
    jivf = JaxIVFIndex.build(
        jnp.asarray(x), JaxIndexConfig(**CFG), key=jax.random.PRNGKey(0),
        data_dtype=dtype,
    )
    path = str(tmp_path_factory.mktemp("ivf") / "ivf.npz")
    jivf.save(path)
    tivf = IVFIndex.load(path, device="cpu")
    assert tivf.data_padded.shape[1] == 256 and tivf.num_overflow > 0
    return request.param, q, x, jivf, tivf


def _overlap(a, b):
    return np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)])


@pytest.mark.parametrize(
    "approx_width,acc_slots", [(0, 0), (128, 1), (128, 2), (256, 1)]
)
@pytest.mark.parametrize("n_q", [1, 5, 40])
def test_scan_matches_pallas(built, approx_width, acc_slots, n_q):
    """f32 slabs: ids equal, scores allclose 1e-5. bf16 slabs: id overlap
    ≥ 0.99, scores allclose 1e-5 (both sides take exact bf16 products in
    f32). n_q=5 with block_q=4 pads a block: the −1e9 pad-row mask."""
    dtype, q, _, jivf, tivf = built
    block_q = 4 if n_q == 5 else 8
    args = dict(k=10, block_q=block_q, union_factor=1,
                approx_width=approx_width, acc_slots=acc_slots)
    js, ji = jivf.query(jnp.asarray(q[:n_q]), impl="pallas", **args)
    ts, ti = tivf.query(torch.from_numpy(q[:n_q]), **args)
    ji, ti = np.asarray(ji), ti.numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(ti, ji)
    else:
        assert _overlap(ti, ji) >= 0.99
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_loaded_layout_equals_jax(built):
    dtype, _, _, jivf, tivf = built
    np.testing.assert_array_equal(tivf.ids_padded.numpy(), np.asarray(jivf.ids_padded))
    np.testing.assert_array_equal(
        tivf.data_padded.float().numpy(), np.asarray(jivf.data_padded).astype(np.float32)
    )
    assert tivf.num_base_clusters == jivf.num_base_clusters
    assert str(tivf.data_padded.dtype).endswith(dtype)


def test_per_query_path_matches_jax_xla(built):
    """query_xla keeps the reference's per-query probe semantics (f32:
    ids equal; bf16: overlap ≥ 0.99)."""
    dtype, q, _, jivf, tivf = built
    js, ji = jivf.query_xla(jnp.asarray(q), k=10)
    ts, ti = tivf.query_xla(torch.from_numpy(q), k=10)
    if dtype == "float32":
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    else:
        assert _overlap(ti.numpy(), np.asarray(ji)) >= 0.99
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_save_load_roundtrip(built, tmp_path):
    _, q, _, _, tivf = built
    path = str(tmp_path / "port_ivf")
    tivf.save(path)
    again = IVFIndex.load(path, device="cpu")
    a = tivf.query(torch.from_numpy(q), k=5, block_q=8)
    b = again.query(torch.from_numpy(q), k=5, block_q=8)
    assert torch.equal(a[1], b[1])
    # the JAX package reads the port's file back
    jivf = JaxIVFIndex.load(path)
    np.testing.assert_array_equal(np.asarray(jivf.ids_padded), tivf.ids_padded.numpy())


@pytest.mark.parametrize("k", [1, 10, 50, 100, 300])
@pytest.mark.parametrize("mc", [64, 200, 256, 1024, 2048])
@pytest.mark.parametrize("w", [0, 128, 512, 2048])
def test_approx_merge_plan_matches_jax(k, mc, w):
    assert _approx_merge_plan(k, mc, w) == jax_plan(k, mc, w)
    assert _approx_merge_plan(k, mc, w, tol=None) == jax_plan(k, mc, w, tol=None)


def test_k_guard_raises(built):
    _, q, _, _, tivf = built
    with pytest.raises(ValueError):
        tivf.query(torch.from_numpy(q), k=300, block_q=8, approx_width=128, acc_slots=2)


def test_port_build_recall_close_to_jax():
    """k-means RNG differs between frameworks: compare quality, not
    centroids — recall@10 against exact within 0.02 of the JAX build's."""
    q, x = _clustered(n=6000, seed=7, q=64)
    cfg = dict(num_clusters=32, num_probes=6, kmeans_iters=6)
    _, exact = cosine_topk_xla(jnp.asarray(q), jnp.asarray(x), k=10)
    exact = np.asarray(exact)
    jivf = JaxIVFIndex.build(jnp.asarray(x), JaxIndexConfig(**cfg), key=jax.random.PRNGKey(1))
    tivf = IVFIndex.build(
        torch.from_numpy(x), IndexConfig(**cfg),
        generator=torch.Generator().manual_seed(1), device="cpu",
    )
    args = dict(k=10, block_q=8, union_factor=1)
    _, ji = jivf.query(jnp.asarray(q), impl="pallas", **args)
    _, ti = tivf.query(torch.from_numpy(q), **args)
    r_jax = _overlap(exact, np.asarray(ji))
    r_port = _overlap(exact, ti.numpy())
    assert abs(r_port - r_jax) <= 0.02, (r_port, r_jax)
    assert r_port >= 0.9


# ---------------------------------------------------------------------------
# The wgmma tile (K1 bf16, K4): what its skip of empty tiles relies on, and
# how the wrapper sizes its partial results by the library's plan
# ---------------------------------------------------------------------------

def _holey_slabs(dtype, c_tot=6, mc=256, d=64, seed=0):
    """Slabs filled from the front to a count of their own (one empty, one
    full), with interior holes; queries near live rows, 2 blocks of 4; a
    probe list per block that holds the empty slab. → numpy (q, probes,
    data (f32 values of the stored type), ids, scales or None), and the
    empty slots' mask."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((c_tot * mc, d)))
    fill = np.array([0.9, 0.0, 0.3, 1.0, 0.55, 0.12])[:c_tot]
    ids = np.full((c_tot, mc), -1, np.int32)
    for c in range(c_tot):
        n = int(fill[c] * mc)
        ids[c, :n] = c * mc + np.arange(n)
    ids[(rng.random((c_tot, mc)) < 0.1) & (ids >= 0)] = -1            # interior holes
    live = np.flatnonzero(ids.reshape(-1) >= 0)
    q = _unit(x[rng.choice(live, 8)] + 0.1 * rng.standard_normal((8, d)))
    probes = np.array([[0, 1, 2, 3], [4, 5, 1, 0]], np.int32)
    scales = None
    if dtype == "int8":
        codes, sc = quantize_embeddings_int8(torch.from_numpy(x))
        data, scales = codes.numpy().reshape(c_tot, mc, d), sc.numpy().reshape(c_tot, mc)
    else:
        data = x.reshape(c_tot, mc, d)
    return q, probes, data, ids, scales, ids < 0


def _pallas_scan(q, probes, data, ids, scales, dtype, width, slots, k=10):
    jd = jnp.asarray(data, jnp.int8 if dtype == "int8" else jnp.bfloat16)
    js = None if scales is None else jnp.asarray(scales)
    s, i = _ivf_query_pallas(jnp.asarray(q), jnp.asarray(probes), jd, jnp.asarray(ids), js, k, 4,
                             interpret=True, approx_width=width, acc_slots=slots)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("width,slots", [(0, 1), (128, 1), (128, 2)])
def test_empty_slots_rows_change_nothing(dtype, width, slots):
    """The property the tile's skip rests on: with trailing and interior
    empty slots (and a wholly empty probed slab), the Pallas scan in
    interpret mode gives the same (scores, ids) when the rows of those
    slots are changed, in the exact mode and the deferred fold at S 1 and
    2 — so a tile of empty slots can go unread. The port's plain scan
    agrees with it on both (scores 1e-5; int8 ids equal, bf16 overlap ≥
    0.99)."""
    q, probes, data, ids, scales, empty = _holey_slabs(dtype)
    rng = np.random.default_rng(1)
    changed = data.copy()
    if dtype == "int8":
        changed[empty] = rng.integers(-127, 128, changed[empty].shape)
        sc2 = scales.copy()
        sc2[empty] = rng.uniform(0.0, 10.0, sc2[empty].shape).astype(np.float32)
    else:
        changed[empty] = 4.0 * rng.standard_normal(changed[empty].shape)
        sc2 = None
    a = _pallas_scan(q, probes, data, ids, scales, dtype, width, slots)
    b = _pallas_scan(q, probes, changed, ids, sc2, dtype, width, slots)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    td = torch.from_numpy(changed).to(torch.int8 if dtype == "int8" else torch.bfloat16)
    ts, ti = ivf_scan_reference(
        torch.from_numpy(q), torch.from_numpy(probes), td, torch.from_numpy(ids), 10, 4, width,
        slots, None if sc2 is None else torch.from_numpy(sc2))
    np.testing.assert_allclose(ts.numpy(), a[0], atol=1e-5)
    if dtype == "int8":
        np.testing.assert_array_equal(ti.numpy(), a[1])
    else:
        assert _overlap(ti.numpy(), a[1]) >= 0.99


class _ScanRecorder:
    """Stands in for the kernel library: answers ``ts_ivf_scan_tile_plan``
    with a plan (or none, the CUDA-core kernel) and records what the
    merge wrapper asks it and hands each entry point."""

    def __init__(self, plan):
        self.plan, self.asked, self.calls = plan, [], []

    def ts_ivf_scan_tile_plan(self, *args):
        self.asked.append(args[:7])
        if self.plan is None:
            return 0
        (ctypes.c_int * 5).from_address(args[7])[:] = list(self.plan)
        return 1

    def __getattr__(self, name):
        if not name.startswith("ts_ivf_scan"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


class _EmptyRecorder:
    """Stands in for ``torch`` in ``index.ivf``: records the shape of every
    buffer the wrapper allocates."""

    def __init__(self):
        self.shapes = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, shape, **kw):
        self.shapes.append(tuple(shape))
        return torch.empty(shape, **kw)


_PLAN = TilePlan(64, 2, 32, 3, 205392)
_DTYPES = {0: torch.float32, 1: torch.bfloat16, 2: torch.int8}


@pytest.mark.parametrize("kind,d,mc,block_q,k,aw,acc,taken,width,slots,n_part", [
    # the main path (bf16, int8; D 384, block_q 64): the tile's 64-lane
    # ranges, each handing the merge its raw 64·S fold entries or its top-k
    (1, 384, 1536, 64, 10, 2048, 1, True, 1536, 1, 24 * 64),
    (1, 384, 1536, 64, 100, 512, 2, True, 512, 2, 8 * 128),
    (1, 384, 1536, 64, 10, 0, 1, True, 1536, 0, 24 * 10),
    (2, 384, 1536, 64, 20, 2048, 2, True, 1536, 2, 24 * 128),
    (2, 384, 1536, 64, 20, 0, 1, True, 1536, 0, 24 * 20),
    # the pipeline's requests: 1, 5 (padded to 8) texts, exact below Mc 1024;
    # a width that is not a multiple of 64 ends in a partial range
    (1, 384, 544, 1, 10, 0, 1, True, 544, 0, 9 * 10),
    (1, 384, 544, 8, 10, 0, 1, True, 544, 0, 9 * 10),
    (2, 384, 552, 1, 20, 0, 1, True, 552, 0, 9 * 20),
    (2, 384, 552, 8, 20, 0, 1, True, 552, 0, 9 * 20),
    # S 3-4, a width that does not divide Mc (folds at Mc), k 256
    (1, 384, 1024, 16, 100, 256, 3, True, 256, 3, 4 * 192),
    (2, 384, 1024, 17, 10, 128, 4, True, 128, 4, 2 * 256),
    (1, 384, 1536, 64, 10, 1000, 1, True, 1536, 1, 24 * 64),
    (1, 384, 1536, 64, 256, 0, 1, True, 1536, 0, 24 * 256),
    # the CUDA-core kernel: its 128-lane blocks' top-k each
    (0, 384, 1536, 64, 10, 2048, 1, False, 1536, 1, 12 * 10),
    (0, 384, 1536, 64, 10, 0, 1, False, 1536, 0, 12 * 10),
    (1, 385, 1536, 64, 100, 512, 2, False, 512, 2, 4 * 100),
    (1, 385, 200, 8, 10, 200, 1, False, 200, 1, 2 * 10),
    (2, 384, 202, 8, 10, 0, 1, False, 202, 0, 2 * 10),
])
def test_merge_wrapper_follows_the_library_plan(kind, d, mc, block_q, k, aw, acc, taken, width,
                                                slots, n_part, monkeypatch):
    """``ivf_scan_cuda`` in a merge mode, the library replaced by a
    recorder (no card needed): it asks the library's plan with the fold
    (width, S; Mc and 0 in the exact mode), sizes the partial results by
    the kernel that plan names (the tile's 64-lane ranges, else the
    CUDA-core kernel's 128-lane blocks), hands the entry point of the slab
    type the same shape, and counts a tile launch only where the plan took
    the shape."""
    from text_similarity_tpu_torch.index import ivf as ivf_mod

    rec, alloc = _ScanRecorder(_PLAN if taken else None), _EmptyRecorder()
    monkeypatch.setattr(ivf_mod._cuda, "lib", lambda: rec)
    monkeypatch.setattr(ivf_mod._cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(ivf_mod._cuda, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(ivf_mod, "torch", alloc)
    for counter in ("launches", "launches_int8", "launches_tile", "launches_tile_int8"):
        monkeypatch.setattr(ivf_mod.ivf_scan_cuda, counter, 0)
    b, u, c_tot = 2 * block_q, 3, 2
    data = torch.zeros((c_tot, mc, d), dtype=_DTYPES[kind])
    ids = torch.zeros((c_tot, mc), dtype=torch.int32)
    scales = torch.ones((c_tot, mc)) if kind == 2 else None
    probes = torch.zeros((2, u), dtype=torch.int32)
    ivf_mod.ivf_scan_cuda(torch.zeros((b, d)), probes, data, ids, k, block_q, aw, acc, scales)
    assert rec.asked == [(kind, d, mc, block_q, k, width, slots)]
    (name, args), = rec.calls
    assert name == ("ts_ivf_scan_int8" if kind == 2 else "ts_ivf_scan")
    assert args[3] == (scales.data_ptr() if kind == 2 else int(kind == 1))
    assert args[5:14] == (b, d, u, c_tot, mc, block_q, k, width, slots)
    assert alloc.shapes == [(b, k), (b, k), (b, n_part), (b, n_part)]
    assert tile_part_width(width, k, slots) == n_part or not taken
    suffix = "_int8" if kind == 2 else ""
    fn = ivf_mod.ivf_scan_cuda
    assert (getattr(fn, f"launches{suffix}"), getattr(fn, f"launches_tile{suffix}")) == (1, int(taken))


class _ModeRecorder(_ScanRecorder):
    """The same stand-in, also recording the ring depth asked for."""

    def __init__(self, plan):
        super().__init__(plan)
        self.depths = []

    def ts_ivf_scan_tile_plan(self, *args):
        self.depths.append(args[8])
        return super().ts_ivf_scan_tile_plan(*args)


@pytest.mark.parametrize("mode,kind,d,mc,aw,slots,k,n_buf,taken,width,n_part", [
    # K10 at the main path (bf16, D 384, Mc 1536): the tile at width Mc,
    # its ring at most n_buffers deep
    ("dma", 1, 384, 1536, 0, 1, 10, 2, True, 1536, 24 * 64),
    ("dma", 1, 384, 1536, 0, 1, 10, 4, True, 1536, 24 * 64),
    ("dma", 1, 384, 1536, 0, 2, 100, 3, True, 1536, 24 * 128),
    ("dma", 1, 64, 200, 0, 1, 20, 2, True, 200, 4 * 64),
    # K1's CUDA-core kernel: its 128-lane blocks' top-k each
    ("dma", 0, 384, 1536, 0, 1, 10, 2, False, 1536, 12 * 10),
    ("dma", 1, 385, 1536, 0, 2, 100, 4, False, 1536, 12 * 100),
    # K11b on the sentinel rows (D + 1 = 385; w = Mc or w < Mc): the tile
    # reads the zero-tile map, built here when the caller passes none
    ("idless", 3, 385, 1536, 2048, 1, 10, 0, True, 1536, 24 * 64),
    ("idless", 3, 385, 1536, 512, 1, 10, 0, True, 512, 8 * 64),
    ("idless", 3, 65, 200, 200, 1, 20, 0, True, 200, 4 * 64),
    ("idless", 3, 33, 200, 200, 1, 20, 0, False, 200, 2 * 20),
    # f32 slabs never ask: the CUDA-core kernel
    ("idless", 0, 385, 1536, 2048, 1, 10, 0, False, 1536, 12 * 10),
    # K11a (n_buf here is P): K1's fold at width Mc with one slot, the
    # tile's own ring (else K1's CUDA-core kernel), over the probe list
    # padded to a multiple of P
    ("multiprobe", 1, 384, 1536, 0, 1, 10, 2, True, 1536, 24 * 64),
    ("multiprobe", 2, 384, 1536, 0, 1, 20, 3, True, 1536, 24 * 64),
    ("multiprobe", 1, 64, 200, 0, 1, 10, 4, True, 200, 4 * 64),
    ("multiprobe", 0, 384, 1536, 0, 1, 10, 2, False, 1536, 12 * 10),
    ("multiprobe", 1, 385, 1536, 0, 1, 10, 6, False, 1536, 12 * 10),
])
def test_mode_wrappers_follow_the_library_plan(mode, kind, d, mc, aw, slots, k, n_buf, taken,
                                               width, n_part, monkeypatch):
    """``ivf_scan_dma_cuda`` (K10), ``ivf_scan_idless_cuda`` (K11b) and
    ``ivf_scan_multiprobe_cuda`` (K11a), the library replaced by a
    recorder: each asks the plan of its mode (K10: K1's deferred fold at
    width Mc with S slots, its ring at most ``n_buffers`` deep; K11b: the
    sentinel kind 3 at its fold width, one slot, f32 slabs do not ask;
    K11a: width Mc, one slot, the tile's own ring), sizes the partial
    results by the kernel that plan names (the tile's 64·S entries a
    64-lane range, else the CUDA-core kernel's top-k a 128-lane block),
    hands K11b's tile the zero-tile map (none to the CUDA-core kernel),
    hands K11a the list padded to a multiple of P and counts a tile launch only where the plan took the shape."""
    from text_similarity_tpu_torch.index import ivf_modes

    rec, alloc = _ModeRecorder(_PLAN if taken else None), _EmptyRecorder()
    monkeypatch.setattr(ivf_modes._cuda, "lib", lambda: rec)
    monkeypatch.setattr(ivf_modes._cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(ivf_modes._cuda, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(ivf_modes, "torch", alloc)
    fn = getattr(ivf_modes, f"ivf_scan_{mode}_cuda")
    for counter in ("launches", "launches_tile"):
        monkeypatch.setattr(fn, counter, 0)
    b, block_q, c_tot = 128, 64, 3
    data = torch.zeros((c_tot, mc, d), dtype=_DTYPES.get(kind, torch.bfloat16))   # 3: bf16 rows
    ids = torch.zeros((c_tot, mc), dtype=torch.int32)
    scales = torch.ones((c_tot, mc)) if kind == 2 else None
    probes = torch.zeros((2, 4), dtype=torch.int32)
    q = torch.zeros((b, d))
    if mode == "dma":
        fn(q, probes, data, ids, k, block_q, slots, n_buf)
        name, want_args = "ts_ivf_scan_dma", (b, d, 4, c_tot, mc, block_q, k, slots, n_buf)
    elif mode == "multiprobe":
        fn(q, probes, data, ids, k, block_q, n_buf, scales)
        u = {2: 4, 3: 6, 4: 4, 6: 6}[n_buf]
        name, want_args = "ts_ivf_scan_multiprobe", (b, d, u, n_buf, c_tot, mc, block_q, k)
    else:
        fn(q, probes, data, k, block_q, aw)
        name, want_args = "ts_ivf_scan_idless", (b, d, 4, c_tot, mc, block_q, k, width)
    if kind == 0 and mode == "idless":
        assert rec.asked == []
    else:
        assert rec.asked == [(kind, d, mc, block_q, k, width, slots)]
        assert rec.depths == [0 if mode == "multiprobe" else n_buf]
    (called, args), = rec.calls
    assert called == name
    if mode == "dma":
        assert args[5:14] == want_args
    elif mode == "multiprobe":
        assert args[6:14] == want_args
        assert args[3] == kind and (args[4] is not None) == (kind == 2)   # kind, scales
    else:
        assert args[6:14] == want_args
        assert (args[4] is not None) == taken and args[5] is None   # the map; no counts
    assert alloc.shapes[-2:] == [(b, n_part), (b, n_part)]
    assert tile_part_width(width, k, slots) == n_part or not taken
    assert (fn.launches, fn.launches_tile) == (1, int(taken))


@pytest.mark.parametrize("kind,d,mc,block_q,aw,acc,taken,width", [
    # phase 5b's emit_acc (bench's k 100 args: w 512, S 3; int8 too)
    (1, 384, 1536, 64, 512, 3, True, 512),
    (2, 384, 1536, 64, 512, 3, True, 512),
    # a width that is not a multiple of 64; one that does not divide Mc
    (1, 64, 200, 8, 200, 2, True, 200),
    (2, 384, 1024, 16, 1000, 1, True, 1024),
    # the CUDA-core kernel: f32 slabs, the sentinel's D + 1
    (0, 384, 1536, 64, 512, 3, False, 512),
    (1, 385, 1536, 64, 512, 2, False, 512),
])
def test_emit_acc_wrapper_follows_the_library_plan(kind, d, mc, block_q, aw, acc, taken, width,
                                                   monkeypatch):
    """``ivf_scan_cuda(..., emit_acc=True)``, the library replaced by a
    recorder: it asks the plan of the deferred fold at (w, S) with k 1 (no
    selection runs), allocates only the (B, S·w) outputs (no partial
    results: neither kernel runs a merge pass), hands
    ``ts_ivf_scan_emit_acc`` the shape and counts a tile launch only where
    the plan took it."""
    from text_similarity_tpu_torch.index import ivf as ivf_mod

    rec, alloc = _ScanRecorder(_PLAN if taken else None), _EmptyRecorder()
    monkeypatch.setattr(ivf_mod._cuda, "lib", lambda: rec)
    monkeypatch.setattr(ivf_mod._cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(ivf_mod._cuda, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(ivf_mod, "torch", alloc)
    suffix = "_int8" if kind == 2 else ""
    fn = ivf_mod.ivf_scan_cuda
    for counter in (f"launches_emit_acc{suffix}", f"launches_emit_acc_tile{suffix}"):
        monkeypatch.setattr(fn, counter, 0)
    b, u, c_tot = 2 * block_q, 3, 2
    data = torch.zeros((c_tot, mc, d), dtype=_DTYPES[kind])
    ids = torch.zeros((c_tot, mc), dtype=torch.int32)
    scales = torch.ones((c_tot, mc)) if kind == 2 else None
    probes = torch.zeros((2, u), dtype=torch.int32)
    out = fn(torch.zeros((b, d)), probes, data, ids, 10, block_q, aw, acc, scales, emit_acc=True)
    assert rec.asked == [(kind, d, mc, block_q, 1, width, acc)]
    (name, args), = rec.calls
    assert name == "ts_ivf_scan_emit_acc"
    assert args[3] == kind and (args[4] is not None) == (kind == 2)
    assert args[6:14] == (b, d, u, c_tot, mc, block_q, width, acc)
    assert alloc.shapes == [(b, acc * width), (b, acc * width)]
    assert out[0].shape == (b, acc * width)
    assert (getattr(fn, f"launches_emit_acc{suffix}"),
            getattr(fn, f"launches_emit_acc_tile{suffix}")) == (1, int(taken))


def test_tile_occupancy_counts_live_slots_and_empty_tiles():
    """tile_occupancy over a hand-made layout: slab 0 holds 70 live slots
    (tiles 0, 1 of 4 at width 256), slab 1 none, slab 2 one live slot in
    its last tile; probes outside [0, C_tot) count in neither share. At
    width 128 (2 chunks, 2 ranges) the same slots fall in other tiles."""
    ids = np.full((3, 256), -1, np.int32)
    ids[0, :70] = np.arange(70)
    ids[2, 255] = 999
    probes = torch.tensor([[0, 1], [2, -1], [7, 0]], dtype=torch.int32)
    live, skipped = tile_occupancy(probes, torch.from_numpy(ids), 256)
    assert live == pytest.approx((70 + 0 + 1 + 70) / (4 * 256))
    assert skipped == pytest.approx(1 - (2 + 0 + 1 + 2) / (4 * 4))
    live, skipped = tile_occupancy(probes, torch.from_numpy(ids), 128)
    assert skipped == pytest.approx(1 - (2 + 0 + 1 + 2) / (4 * 4))
    # a width that is not a multiple of 64: its last range is 8 lanes wide
    ids = np.full((1, 200), -1, np.int32)
    ids[0, 195] = 5
    _, skipped = tile_occupancy(torch.zeros((1, 1), dtype=torch.int32), torch.from_numpy(ids), 200)
    assert TILE_ROWS == 64 and skipped == pytest.approx(1 - 1 / 4)
