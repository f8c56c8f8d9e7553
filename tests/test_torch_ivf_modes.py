"""The IVF index's other layouts and scan modes against the JAX package:
grouped slabs and the sentinel layout (JAX-saved npz files load into the
port), and every scan option of ``IVFIndex.query`` — per_probe and the raw
accumulator (K1-opt), the packed fold (K9), the copy-ring scan (K10),
several probes a step (K11a) and the idless scan (K11b) — each through the
port's plain versions against ``query(..., impl="pallas")`` in interpret
mode. The CUDA kernels are held against these plain versions in
test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import IndexConfig as JaxIndexConfig
from text_similarity_tpu.index.ivf import IVFIndex as JaxIVFIndex
from text_similarity_tpu.index.ivf import _affinity_group_perm as jax_group_perm
from text_similarity_tpu.index.ivf import _ivf_query_pallas, _ivf_query_pallas_packed
from text_similarity_tpu.index.ivf import _pack_candidates as jax_pack
from text_similarity_tpu.index.ivf import _unpack_candidates as jax_unpack
from text_similarity_tpu.ops.topk import cosine_topk_xla
from text_similarity_tpu_torch.core.config import IndexConfig
from text_similarity_tpu_torch.index import ivf as ivf_mod
from text_similarity_tpu_torch.index import ivf_modes
from text_similarity_tpu_torch.index.ivf import (
    IVFIndex,
    _affinity_group_perm,
    _plan_probes,
    ivf_scan,
)
from text_similarity_tpu_torch.index.ivf_modes import (
    PACK_SCALE,
    TILE_ROWS,
    _pack_candidates,
    _unpack_candidates,
    ivf_scan_dma,
    ivf_scan_idless,
    ivf_scan_multiprobe,
    ivf_scan_packed,
    zero_tile_map,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BIN = 1.0 / PACK_SCALE + 1e-6     # one 14-bit score bin of the packed fold


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _clustered(n=4096, d=64, centers=64, q=16, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d))
    x = _unit(c[rng.integers(0, centers, n)] * 3.0 + rng.standard_normal((n, d)))
    return _unit(x[:q] + 0.1 * rng.standard_normal((q, d))), x


def _overlap(a, b):
    return np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)])


CFG = dict(num_clusters=16, num_probes=4, kmeans_iters=4, max_cluster_size=256)
BUILDS = {
    "f32": dict(data_dtype=jnp.float32),
    "bf16": dict(data_dtype=jnp.bfloat16),
    "int8": dict(quantize_int8=True),
    "sentinel": dict(data_dtype=jnp.float32, sentinel=True),
    "group2": dict(data_dtype=jnp.float32, group=2),
}


@pytest.fixture(scope="module")
def corpus():
    return _clustered()


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """JAX-built indexes (Mc 256, overflow slabs), saved once → name → path."""
    _, x = corpus
    root = tmp_path_factory.mktemp("ivf_modes")
    paths = {}
    for name, opts in BUILDS.items():
        opts = dict(opts)
        cfg = JaxIndexConfig(**CFG, quantize_int8=opts.pop("quantize_int8", False))
        jivf = JaxIVFIndex.build(jnp.asarray(x), cfg, key=jax.random.PRNGKey(0), **opts)
        paths[name] = str(root / f"{name}.npz")
        jivf.save(paths[name])
    return paths


def _pair(saved, name):
    return JaxIVFIndex.load(saved[name]), IVFIndex.load(saved[name], device="cpu")


def _agree(name, ts, ti, js, ji, packed=False):
    """f32 (and int8 + rescore): ids equal; bf16: overlap ≥ 0.99; scores
    1e-5 (the packed fold: within one bin, overlap ≥ 0.99)."""
    ts, ti, js, ji = ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)
    if packed:
        assert _overlap(ti, ji) >= 0.99
        np.testing.assert_allclose(np.sort(ts, 1), np.sort(js, 1), atol=BIN)
        return
    if name == "bf16":
        assert _overlap(ti, ji) >= 0.99
    else:
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-5)


def _both(saved, name, q, **opts):
    jivf, tivf = _pair(saved, name)
    args = dict(dict(k=10, block_q=8, union_factor=1), **opts)
    js, ji = jivf.query(jnp.asarray(q), impl="pallas", **args)
    ts, ti = tivf.query(torch.from_numpy(q), **args)
    return ts, ti, js, ji


# ---------------------------------------------------------------------------
# Layouts: load, persistence, build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sentinel", "group2"])
def test_jax_saved_layout_loads(saved, name, tmp_path):
    jivf, tivf = _pair(saved, name)
    np.testing.assert_array_equal(tivf.ids_padded.numpy(), np.asarray(jivf.ids_padded))
    np.testing.assert_array_equal(tivf.data_padded.numpy(), np.asarray(jivf.data_padded))
    for attr in ("group", "cluster_cap", "num_overflow", "sentinel", "num_base_clusters"):
        assert getattr(tivf, attr) == getattr(jivf, attr), attr
    assert tivf.sentinel == (name == "sentinel")
    assert tivf.data_padded.shape[-1] == (65 if name == "sentinel" else 64)
    path = str(tmp_path / "port")
    tivf.save(path)
    back = JaxIVFIndex.load(path + ".npz")
    assert back.group == jivf.group and back.sentinel == jivf.sentinel
    np.testing.assert_array_equal(np.asarray(back.data_padded), tivf.data_padded.numpy())


@pytest.mark.parametrize("name", ["sentinel", "group2"])
def test_query_xla_matches_jax(saved, corpus, name):
    q, _ = corpus
    jivf, tivf = _pair(saved, name)
    js, ji = jivf.query_xla(jnp.asarray(q), k=10)
    ts, ti = tivf.query_xla(torch.from_numpy(q), k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("group", [2, 4, 8])
def test_affinity_group_perm_matches_jax(group):
    rng = np.random.default_rng(group)
    cent = _unit(rng.standard_normal((32, 16)))
    np.testing.assert_array_equal(_affinity_group_perm(cent, group), jax_group_perm(cent, group))
    with pytest.raises(ValueError):
        _affinity_group_perm(cent, 3)


@pytest.mark.parametrize("opts", [dict(group=2), dict(sentinel=True)])
def test_port_build_recall_close_to_jax(opts):
    """k-means RNG differs: the port's grouped and sentinel builds reach
    recall@10 within 0.02 of the JAX builds'."""
    q, x = _clustered(n=6000, seed=7, q=64)
    cfg = dict(num_clusters=32, num_probes=6, kmeans_iters=6)
    _, exact = cosine_topk_xla(jnp.asarray(q), jnp.asarray(x), k=10)
    jivf = JaxIVFIndex.build(jnp.asarray(x), JaxIndexConfig(**cfg), key=jax.random.PRNGKey(1),
                             **opts)
    tivf = IVFIndex.build(torch.from_numpy(x), IndexConfig(**cfg),
                          generator=torch.Generator().manual_seed(1), device="cpu", **opts)
    assert tivf.data_padded.shape[-1] == jivf.data_padded.shape[-1]
    assert tivf.sentinel == jivf.sentinel and tivf.group == jivf.group
    args = dict(k=10, block_q=8, union_factor=1, approx_width=256)
    _, ji = jivf.query(jnp.asarray(q), impl="pallas", **args)
    _, ti = tivf.query(torch.from_numpy(q), **args)
    r_jax, r_port = _overlap(np.asarray(exact), np.asarray(ji)), _overlap(np.asarray(exact), ti.numpy())
    assert abs(r_port - r_jax) <= 0.02, (r_port, r_jax)


def test_sentinel_rejects_int8():
    _, x = _clustered(n=512)
    cfg = IndexConfig(num_clusters=8, num_probes=2, quantize_int8=True)
    with pytest.raises(ValueError):
        IVFIndex.build(torch.from_numpy(x), cfg, sentinel=True, device="cpu")
    with pytest.raises(ValueError):
        IVFIndex.build(torch.from_numpy(x), dataclasses.replace(cfg, quantize_int8=False),
                       group=3, device="cpu")


# ---------------------------------------------------------------------------
# The scan options through IVFIndex.query, against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BUILDS))
def test_per_probe_matches_pallas(saved, corpus, name):
    """K1-opt per_probe: each probe's exact top-k pooled, then the top k
    (or, with the int8 rescore copy, the top k_coarse rescored)."""
    q, _ = corpus
    _agree(name, *_both(saved, name, q, per_probe=True))


@pytest.mark.parametrize("final_merge", ["xla", "xla_approx"])
@pytest.mark.parametrize("name,k,acc_slots", [
    ("f32", 20, 2), ("bf16", 20, 0), ("int8", 10, 2), ("group2", 10, 0), ("sentinel", 20, 2),
])
def test_emit_acc_matches_pallas(saved, corpus, final_merge, name, k, acc_slots):
    """K1-opt emit_acc: the raw slot-major accumulator, selected outside
    (lax.top_k order; approx_max_k is exact on the CPU)."""
    q, _ = corpus
    _agree(name, *_both(saved, name, q, k=k, approx_width=128, acc_slots=acc_slots,
                        final_merge=final_merge))


@pytest.mark.parametrize("final_merge", ["xla", "xla_approx"])
@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_emit_acc_partial_range_matches_pallas(saved, corpus, final_merge, name):
    """K1-opt emit_acc at a fold width that is not a multiple of 64 (32 of
    Mc 256: the wgmma tile's one range holds 32 lane classes of its 64
    rows), one slot: the same answer as the Pallas kernel's."""
    q, _ = corpus
    _agree(name, *_both(saved, name, q, approx_width=32, acc_slots=1, final_merge=final_merge))


@pytest.mark.parametrize("name,k,width", [
    ("f32", 10, 256), ("f32", 50, 128), ("bf16", 10, 256), ("group2", 20, 128),
])
def test_packed_matches_pallas(saved, corpus, name, k, width):
    """K9 through query(final_merge="packed"): unpacked scores within one
    14-bit bin, overlap ≥ 0.99."""
    q, _ = corpus
    _agree(name, *_both(saved, name, q, k=k, approx_width=width, final_merge="packed"),
           packed=True)


@pytest.mark.parametrize("name,k,buffers", [
    ("f32", 10, 2), ("f32", 50, 3), ("bf16", 10, 4), ("sentinel", 10, 3), ("group2", 20, 2),
])
def test_dma_matches_pallas(saved, corpus, name, k, buffers):
    """K10 through query(dma_pipeline=True): the full-width fold with the
    planned slots."""
    q, _ = corpus
    _agree(name, *_both(saved, name, q, k=k, dma_pipeline=True, dma_buffers=buffers))


@pytest.mark.parametrize("name,per_step", [
    ("f32", 2), ("f32", 3), ("bf16", 4), ("int8", 3), ("sentinel", 2), ("group2", 3),
])
def test_multiprobe_matches_pallas(saved, corpus, name, per_step):
    """K11a through query(probes_per_step=P); P = 3 pads the probe list."""
    q, _ = corpus
    _agree(name, *_both(saved, name, q, approx_width=256, probes_per_step=per_step))


@pytest.mark.parametrize("width,k,slots", [(128, 10, 1), (256, 5, 1), (256, 10, 0), (0, 10, 0)])
def test_sentinel_scans_match_pallas(saved, corpus, width, k, slots):
    """The sentinel index: the idless scan (K11b) at a single-slot fold,
    K1 over D+1 slabs with the planned two slots, and the exact merge."""
    q, _ = corpus
    _agree("sentinel", *_both(saved, "sentinel", q, k=k, approx_width=width, acc_slots=slots))


def test_sentinel_tails_and_removed_rows_match_jax():
    """A sentinel index with fewer live slots than k: the idless scan
    returns removed rows as (q·x − 2, −1) and empty slots as (−2, −1), as
    the reference does; the exact merge returns (−inf, −1) tails; a removed
    row never comes back with its id."""
    rng = np.random.default_rng(4)
    e = _unit(rng.standard_normal((1, 32)))
    # rows 0-7 near e (the queries), the rest near −e: once removed, those
    # score about −3 and rank below the empty slots' −2
    x = _unit(np.where(np.arange(512)[:, None] < 8, e, -e) + 0.05 * rng.standard_normal((512, 32)))
    jivf = JaxIVFIndex.build(jnp.asarray(x), JaxIndexConfig(num_clusters=8, num_probes=8),
                             key=jax.random.PRNGKey(0), sentinel=True)
    tivf = IVFIndex(torch.from_numpy(np.array(jivf.centroids)),       # copies: the port
                    torch.from_numpy(np.array(jivf.data_padded)),     # updates in place
                    torch.from_numpy(np.array(jivf.ids_padded)),
                    jivf.num_base_clusters, IndexConfig(num_clusters=8, num_probes=8))
    gone = np.arange(5, 512)
    assert tivf.remove(gone) == jivf.remove(gone) == gone.size
    np.testing.assert_array_equal(tivf.data_padded.numpy(), np.asarray(jivf.data_padded))
    q = x[:8]
    for width, slots in ((256, 1), (0, 0)):       # the idless scan, the exact merge
        args = dict(k=10, block_q=8, approx_width=width, acc_slots=slots)
        js, ji = jivf.query(jnp.asarray(q), impl="pallas", **args)
        ts, ti = tivf.query(torch.from_numpy(q), **args)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
        assert (ti.numpy()[:, 5:] == -1).all() and not np.isin(ti.numpy(), gone).any()
        tails = ts.numpy()[:, 5:]
        if width:    # removed rows (q·x − 2) and empty slots (−2)
            assert ((tails >= -3 - 1e-5) & (tails <= -1 + 1e-5)).all() and (tails == -2).any()
        else:
            assert np.isneginf(tails).all()


@pytest.mark.parametrize("name", ["sentinel", "group2"])
def test_add_remove_match_jax(saved, corpus, name):
    """add (free slots, then new overflow slabs rounded to the group; the
    sentinel's +2) and remove (ids cleared, the sentinel column zeroed)
    leave the JAX layout, and queries then agree."""
    q, x = corpus
    jivf, tivf = _pair(saved, name)
    rng = np.random.default_rng(9)
    new = _unit(x[rng.integers(0, 4096, 400)] + 0.05 * rng.standard_normal((400, 64)))
    start = 4096
    for chunk in (new[:8], new[8:]):      # the second add overflows its clusters
        want = jivf.add(jnp.asarray(chunk), start_id=start)
        got = tivf.add(torch.from_numpy(chunk), start_id=start)
        np.testing.assert_array_equal(got, want)
        start += len(chunk)
    gone = np.arange(0, 4096, 7)
    assert tivf.remove(gone) == jivf.remove(gone) == gone.size
    np.testing.assert_array_equal(tivf.ids_padded.numpy(), np.asarray(jivf.ids_padded))
    np.testing.assert_array_equal(tivf.data_padded.numpy(), np.asarray(jivf.data_padded))
    assert tivf.num_overflow == jivf.num_overflow
    qs = np.concatenate([q, new[:8]])
    for opts in (dict(approx_width=256), dict(dma_pipeline=True)):
        args = dict(k=10, block_q=8, **opts)
        js, ji = jivf.query(jnp.asarray(qs), impl="pallas", **args)
        ts, ti = tivf.query(torch.from_numpy(qs), **args)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert not np.isin(ti.numpy(), gone).any()
        assert (ti.numpy()[len(q):, 0] == np.arange(4096, 4104)).all()


# ---------------------------------------------------------------------------
# The idless scan's skip rule (K11b on the wgmma tile): the zero-tile map
# and why it, and not the ids, decides which tiles go unread
# ---------------------------------------------------------------------------

def _zero_tiles_by_rows(data):
    """The map by its definition: (data == 0).all over each 64-row tile of
    each slab (the last one shorter where Mc % 64 ≠ 0)."""
    d = data.float().numpy()
    c_tot, mc, _ = d.shape
    zero_row = (d == 0).all(axis=2)
    return np.array([[zero_row[c, t:t + TILE_ROWS].all() for t in range(0, mc, TILE_ROWS)]
                     for c in range(c_tot)], np.uint8)


def _hand_sentinel_index(dtype=torch.float32):
    """Two clusters (slabs 0, 1) and an overflow slab of Mc 120 (tiles of
    64 and 56 rows), D 8 + 1: slab 0 holds 64 live rows near e0 (tile 1
    all zero), slab 1 holds 64 live rows that are zero vectors (+2 only)
    near nothing, slab 2 nothing."""
    rng = np.random.default_rng(0)
    d, mc = 8, 120
    cent = np.eye(2, d, dtype=np.float32)
    data = np.zeros((3, mc, d + 1), np.float32)
    ids = np.full((3, mc), -1, np.int32)
    data[0, :64, :d] = _unit(cent[0] + 0.1 * rng.standard_normal((64, d)))
    data[0, :64, d] = 2.0
    data[1, :64, d] = 2.0
    ids[0, :64] = np.arange(64)
    ids[1, :64] = np.arange(64, 128)
    return IVFIndex(torch.from_numpy(cent), torch.from_numpy(data).to(dtype),
                    torch.from_numpy(ids), 2, IndexConfig(num_clusters=2, num_probes=2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_tile_map_tracks_the_slabs(dtype, tmp_path):
    """A sentinel index keeps the map of its all-zero 64-row tiles, equal
    to (data == 0).all over each tile: after the build (and the
    constructor: a JAX-built index), after remove() (a removed zero vector
    loses its +2: its tile becomes all zero), after add() (a row lands in
    an all-zero tile) and after save / load. Other layouts keep none."""
    tivf = _hand_sentinel_index(dtype)
    np.testing.assert_array_equal(tivf.zero_tiles.numpy(), _zero_tiles_by_rows(tivf.data_padded))
    np.testing.assert_array_equal(tivf.zero_tiles.numpy(), [[0, 1], [0, 1], [1, 1]])
    assert tivf.remove(np.arange(64, 128)) == 64
    np.testing.assert_array_equal(tivf.zero_tiles.numpy(), [[0, 1], [1, 1], [1, 1]])
    row = _unit(np.eye(1, 8, dtype=np.float32) + 0.01)
    assert tivf.add(torch.from_numpy(row), start_id=500)[0] == 500
    assert int(tivf.ids_padded[0, 64]) == 500          # slab 0's first free slot: tile 1
    np.testing.assert_array_equal(tivf.zero_tiles.numpy(), [[0, 0], [1, 1], [1, 1]])
    np.testing.assert_array_equal(tivf.zero_tiles.numpy(), _zero_tiles_by_rows(tivf.data_padded))
    tivf.save(str(tmp_path / "s.npz"))
    back = IVFIndex.load(str(tmp_path / "s.npz"), device="cpu")
    np.testing.assert_array_equal(back.zero_tiles.numpy(), tivf.zero_tiles.numpy())
    _, x = _clustered(n=1024, d=16, centers=8)
    built = IVFIndex.build(torch.from_numpy(x), IndexConfig(num_clusters=8, num_probes=2,
                                                            kmeans_iters=2),
                           generator=torch.Generator().manual_seed(0), sentinel=True,
                           device="cpu")
    np.testing.assert_array_equal(built.zero_tiles.numpy(), _zero_tiles_by_rows(built.data_padded))
    assert built.zero_tiles.shape == (built.data_padded.shape[0], -(-built.cluster_cap // 64))
    plain = IVFIndex.build(torch.from_numpy(x), IndexConfig(num_clusters=8, num_probes=2,
                                                            kmeans_iters=2), device="cpu")
    assert plain.zero_tiles is None


def _idless_with_skips(skip, value):
    """The idless scan's plain version with the scores of every 64-row tile
    marked in ``skip`` (C_tot, ceil(Mc / 64)) replaced by ``value`` before
    the fold: 0.0 is the tile kernel's rule for all-zero tiles (a constant
    0 folded in the tile's place), −inf a rule that leaves the tile out."""

    def scan(q, probe_list, data, k, block_q, approx_width, zero_tiles=None):
        mc = data.shape[1]
        w = ivf_modes.scan_width(mc, approx_width)
        qd = ivf_modes._dot_queries(q, data)
        tile_of = torch.arange(mc) // TILE_ROWS
        out_s = torch.empty((q.shape[0], k))
        out_i = torch.empty((q.shape[0], k), dtype=torch.int32)
        for blk in range(probe_list.shape[0]):
            rows = slice(blk * block_q, (blk + 1) * block_q)
            slabs = probe_list[blk].long()
            s, cid = ivf_modes._probe_scores(qd[rows], slabs, data, None, None)
            marked = skip[slabs.clamp(0, data.shape[0] - 1)][:, tile_of]      # (U, Mc)
            s = torch.where(marked[None], torch.tensor(value), s)
            acc_s, acc_i = ivf_modes._fold(s, cid, w, 1)
            out_s[rows], out_i[rows] = ivf_modes._select(
                acc_s.reshape(s.shape[0], -1), acc_i.reshape(s.shape[0], -1), k)
        return out_s, out_i

    return scan


def _tails_pair(keep):
    """A JAX-built sentinel index (8 clusters of a 512-row corpus, rows 0-7
    near the queries and the rest far from them; Mc 112: several slabs end
    in an all-zero tile) with every row but ``keep`` removed, and the
    port's copy of it: queries 0-7 find only 5 live rows in their top 10,
    so removed rows (q·x − 2) and never-written slots (−2) fill the
    tails."""
    rng = np.random.default_rng(4)
    e = _unit(rng.standard_normal((1, 32)))
    x = _unit(np.where(np.arange(512)[:, None] < 8, e, -e) + 0.05 * rng.standard_normal((512, 32)))
    jivf = JaxIVFIndex.build(jnp.asarray(x), JaxIndexConfig(num_clusters=8, num_probes=8),
                             key=jax.random.PRNGKey(0), sentinel=True)
    tivf = IVFIndex(torch.from_numpy(np.array(jivf.centroids)),
                    torch.from_numpy(np.array(jivf.data_padded)),
                    torch.from_numpy(np.array(jivf.ids_padded)),
                    jivf.num_base_clusters, IndexConfig(num_clusters=8, num_probes=8))
    gone = np.setdiff1d(np.arange(512), keep)
    assert tivf.remove(gone) == jivf.remove(gone) == gone.size
    return jivf, tivf, x[:8]


@pytest.mark.parametrize("case", ["tails", "far_tails", "saved"])
def test_idless_constant_zero_for_zero_tiles_matches_pallas(saved, corpus, monkeypatch, case):
    """The rule K11b's tile follows: every 64-row tile whose rows are all
    zero scores a constant 0 in its place in the fold, unread. Through
    ``IVFIndex.query`` the answer equals the Pallas idless kernel's in
    interpret mode (ids equal, scores 1e-5), on the tail cases (fewer live
    rows than k, near the queries or far from them) and on the saved
    sentinel index (overflow slabs end in zero tiles)."""
    if case != "saved":
        jivf, tivf, q = _tails_pair(np.arange(5) + (100 if case == "far_tails" else 0))
        args = dict(k=10, block_q=8, approx_width=256, acc_slots=1)
    else:
        jivf, tivf = _pair(saved, "sentinel")
        q = corpus[0]
        args = dict(k=10, block_q=8, union_factor=1, approx_width=128, acc_slots=1)
    zmap = tivf.zero_tiles.bool()
    assert zmap.any()
    monkeypatch.setattr(ivf_mod, "ivf_scan_idless", _idless_with_skips(zmap, 0.0))
    js, ji = jivf.query(jnp.asarray(q), impl="pallas", **args)
    ts, ti = tivf.query(torch.from_numpy(q), **args)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_idless_skip_by_ids_would_change_the_tails(monkeypatch):
    """Why the tile does not skip by ids (K1's rule, which reads a tile of
    only empty slots as −inf): in the idless scan dead slots compete. On
    the tail case the Pallas kernel returns removed rows (q·x − 2) and
    never-written slots (−2) after the 5 live rows; leaving out every tile
    whose ids are all < 0 drops them, and the answer is no longer the
    reference's: here the 5 live rows lie far from the queries and the
    removed rows near them fill tiles with no live id. The zero-tile rule
    gives the reference's answer."""
    jivf, tivf, q = _tails_pair(np.arange(100, 105))
    args = dict(k=10, block_q=8, approx_width=256, acc_slots=1)
    js, ji = (np.asarray(t) for t in jivf.query(jnp.asarray(q), impl="pallas", **args))
    c_tot, mc = tivf.ids_padded.shape
    n_t = -(-mc // TILE_ROWS)
    dead = torch.nn.functional.pad(tivf.ids_padded < 0, (0, n_t * TILE_ROWS - mc), value=True)
    by_ids = dead.view(c_tot, n_t, TILE_ROWS).all(dim=2)
    assert by_ids.any() and not torch.equal(by_ids, tivf.zero_tiles.bool())
    monkeypatch.setattr(ivf_mod, "ivf_scan_idless", _idless_with_skips(by_ids, float("-inf")))
    ts, ti = (t.numpy() for t in tivf.query(torch.from_numpy(q), **args))
    assert not (np.array_equal(ti, ji) and np.allclose(ts, js, atol=1e-5))
    monkeypatch.setattr(ivf_mod, "ivf_scan_idless",
                        _idless_with_skips(tivf.zero_tiles.bool(), 0.0))
    ts, ti = (t.numpy() for t in tivf.query(torch.from_numpy(q), **args))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-5)


def test_zero_tile_map_of_the_saved_layout(saved):
    """The map of a JAX-saved sentinel index, as the port loads it, equals
    its definition, and ``zero_tile_map`` itself takes any slab type and
    an Mc that is not a multiple of 64."""
    _, tivf = _pair(saved, "sentinel")
    np.testing.assert_array_equal(tivf.zero_tiles.numpy(), _zero_tiles_by_rows(tivf.data_padded))
    rng = np.random.default_rng(2)
    data = np.zeros((3, 200, 5), np.float32)
    data[0, 3, 1] = 1.0
    data[1, 199, 4] = -0.5          # the short last tile (rows 192-199)
    data[2, 64:128] = rng.standard_normal((64, 5))
    for dt in (torch.float32, torch.bfloat16):
        got = zero_tile_map(torch.from_numpy(data).to(dt))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), [[0, 1, 1, 1], [1, 1, 1, 0], [1, 0, 1, 1]])


# ---------------------------------------------------------------------------
# The option rules: the port raises where the reference raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,opts", [
    ("f32", dict(approx_width=128, per_probe=True)),
    ("f32", dict(final_merge="xla")),
    ("f32", dict(final_merge="packed", approx_width=128, per_probe=True)),
    ("f32", dict(final_merge="xla", approx_width=128, probes_per_step=2)),
    ("f32", dict(dma_pipeline=True, approx_width=256, final_merge="xla")),
    ("f32", dict(dma_pipeline=True, approx_width=256, final_merge="xla_approx")),
    ("f32", dict(dma_pipeline=True, approx_width=256, final_merge="packed")),
    ("f32", dict(probes_per_step=2)),
    ("f32", dict(k=300, approx_width=128, acc_slots=2)),
    ("int8", dict(approx_width=128, final_merge="packed")),
    ("int8", dict(dma_pipeline=True)),
    ("sentinel", dict(approx_width=128, final_merge="packed")),
])
def test_option_errors_match_jax(saved, corpus, name, opts):
    q, _ = corpus
    jivf, tivf = _pair(saved, name)
    args = dict(dict(k=10, block_q=8), **opts)
    with pytest.raises(ValueError):
        jivf.query(jnp.asarray(q[:8]), impl="pallas", **args)
    with pytest.raises(ValueError):
        tivf.query(torch.from_numpy(q[:8]), **args)


# ---------------------------------------------------------------------------
# The plain versions themselves
# ---------------------------------------------------------------------------

def test_pack_unpack_match_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    s = np.concatenate([rng.uniform(-1.2, 1.2, (8, 120)),
                        np.array([[-1.0, 1.0, 0.0, -0.99995, 0.99999, 2.0, -3.0, 0.5]] * 8)],
                       axis=1).astype(np.float32)
    for u, off in ((0, 0), (5, 256), (63, 1920)):
        got = _pack_candidates(torch.from_numpy(s), u, off, 8, 128).numpy()
        want = np.asarray(jax_pack(jnp.asarray(s), u, off, 8, 128))
        np.testing.assert_array_equal(got, want)
    probe_list = rng.integers(0, 12, (2, 64)).astype(np.int32)
    ids = rng.integers(-1, 5000, (12, 2048)).astype(np.int32)
    out_p = np.asarray(jax_pack(jnp.asarray(s[:, :10]), 7, 1000, 8, 10))
    out_p = np.concatenate([out_p, np.zeros((8, 2), np.int32)], axis=1)   # empty packets
    ws, wi = jax_unpack(jnp.asarray(out_p), jnp.asarray(probe_list), jnp.asarray(ids), 4)
    ts, ti = _unpack_candidates(torch.from_numpy(out_p), torch.from_numpy(probe_list),
                                torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))


def _plan(tivf, q, block_q=8):
    return _plan_probes(torch.from_numpy(q), tivf.centroids, tivf.num_base_clusters,
                        tivf.data_padded.shape[0], block_q, 8, tivf.group)


@pytest.mark.parametrize("name,width,slots,k", [("f32", 256, 1, 10), ("bf16", 128, 3, 50)])
def test_packed_plain_matches_pallas_packets(saved, corpus, name, width, slots, k):
    """K9's plain version against ``_ivf_query_pallas_packed``: unpacked
    scores within one bin, ids overlap ≥ 0.99, most packets bit-equal."""
    q, _ = corpus
    jivf, tivf = _pair(saved, name)
    qs, probes, _ = _plan(tivf, q)
    want = np.asarray(_ivf_query_pallas_packed(
        jnp.asarray(qs.numpy()), jnp.asarray(probes.numpy()), jivf.data_padded,
        jivf.ids_padded, k, 8, interpret=True, approx_width=width, acc_slots=slots))
    got = ivf_scan_packed(qs, probes, tivf.data_padded, tivf.ids_padded, k, 8, width, slots)
    assert np.mean(got.numpy() == want) >= 0.99
    ts, ti = _unpack_candidates(got, probes, tivf.ids_padded, 8)
    js, ji = jax_unpack(jnp.asarray(want), jnp.asarray(probes.numpy()), jivf.ids_padded, 8)
    _agree(name, ts, ti, js, ji, packed=True)


@pytest.mark.parametrize("name", ["f32", "sentinel"])
def test_full_width_modes_equal_k1_plain(saved, corpus, name):
    """K10's and K11a's plain versions are K1's deferred fold at width Mc:
    the same bits (K11a on a probe list padded to a multiple of P)."""
    q, _ = corpus
    _, tivf = _pair(saved, name)
    qs, probes, _ = _plan(tivf, q)
    if tivf.sentinel:
        qs = torch.cat([qs, torch.ones((qs.shape[0], 1))], dim=1)
    data, ids, mc = tivf.data_padded, tivf.ids_padded, tivf.data_padded.shape[1]
    for slots, k in ((1, 10), (2, 50)):
        want = ivf_scan(qs, probes, data, ids, k, 8, mc, slots)
        for n_buf in (2, 3, 4):
            got = ivf_scan_dma(qs, probes, data, ids, k, 8, slots, n_buf)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want = ivf_scan(qs, probes, data, ids, 10, 8, mc, 1)
    for per_step in (2, 3, 4):
        got = ivf_scan_multiprobe(qs, probes, data, ids, 10, 8, per_step)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("width,slots", [(128, 1), (128, 3), (0, 1), (0, 3)])
def test_emit_acc_select_equals_k1_plain(saved, corpus, name, width, slots):
    """emit_acc's plain version followed by the exact select is K1's plain
    version at the same (w, S), bit for bit (width 0: w = Mc), the
    identity by which the card tests hold emit_acc on the wgmma tile to K1
    on the tile."""
    q, _ = corpus
    _, tivf = _pair(saved, name)
    qs, probes, _ = _plan(tivf, q)
    data, ids, scales = tivf.data_padded, tivf.ids_padded, tivf.scales_padded
    w = width or data.shape[1]
    acc_s, acc_i = ivf_scan(qs, probes, data, ids, 10, 8, w, slots, scales, emit_acc=True)
    assert acc_s.shape == (qs.shape[0], slots * w)
    for k in (10, 50):
        want = ivf_scan(qs, probes, data, ids, k, 8, w, slots, scales)
        got = ivf_modes._select(acc_s, acc_i, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
def test_per_probe_plain_pools_to_k1_exact(saved, corpus, name):
    """K1-opt per_probe's plain version against the Pallas kernel
    (``_ivf_query_pallas(..., per_probe=True, interpret=True)``) probe by
    probe, and its (U, B, k) pooled to (B, U·k) and selected by (score
    desc, id asc) equal to K1's exact plain version bit for bit: the top-k
    of a union is the top-k of its per-probe top-k's. The card tests hold
    per_probe on the wgmma tile to K1's exact mode on the tile by this
    identity."""
    q, _ = corpus
    jivf, tivf = _pair(saved, name)
    qs, probes, _ = _plan(tivf, q)
    data, ids, scales = tivf.data_padded, tivf.ids_padded, tivf.scales_padded
    b, u = qs.shape[0], probes.shape[1]
    for k in (10, 50):
        ps, pi = ivf_scan(qs, probes, data, ids, k, 8, scales=scales, per_probe=True)
        assert ps.shape == (u, b, k)
        pooled = ivf_modes._select(ps.permute(1, 0, 2).reshape(b, u * k),
                                   pi.permute(1, 0, 2).reshape(b, u * k), k)
        want = ivf_scan(qs, probes, data, ids, k, 8, scales=scales)
        assert torch.equal(pooled[0], want[0]) and torch.equal(pooled[1], want[1]), k
    js, ji = _ivf_query_pallas(
        jnp.asarray(qs.numpy()), jnp.asarray(probes.numpy()), jivf.data_padded,
        jivf.ids_padded, jivf.scales_padded, 10, 8, interpret=True, per_probe=True)
    ps, pi = ivf_scan(qs, probes, data, ids, 10, 8, scales=scales, per_probe=True)
    _agree(name, ps.reshape(-1, 10), pi.reshape(-1, 10), np.asarray(js).reshape(-1, 10),
           np.asarray(ji).reshape(-1, 10))


def test_idless_plain_ids_are_flat_slots(saved, corpus):
    """K11b's plain version returns flat slot ids (probe · Mc + position);
    translated, they equal K1's ids wherever the scores are live."""
    q, _ = corpus
    _, tivf = _pair(saved, "sentinel")
    qs, probes, _ = _plan(tivf, q)
    qs = torch.cat([qs, torch.ones((qs.shape[0], 1))], dim=1)
    s, slot = ivf_scan_idless(qs, probes, tivf.data_padded, 10, 8, 256)
    flat = tivf.ids_padded.reshape(-1)[slot.long()]
    ws, wi = ivf_scan(qs, probes, tivf.data_padded, tivf.ids_padded, 10, 8, 256, 1)
    assert (s >= 1).all()                 # every result a live row (+2)
    assert torch.equal(flat, wi) and torch.allclose(s, ws)


# ---------------------------------------------------------------------------
# k = 300: past the tile's 256 winners, each option raises where the
# reference raises and answers as it answers elsewhere
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,opts", [
    ("f32", dict()),
    ("bf16", dict()),
    ("int8", dict()),
    ("group2", dict()),
    ("sentinel", dict()),
    ("f32", dict(per_probe=True)),
    ("f32", dict(approx_width=128)),
    ("bf16", dict(approx_width=256, acc_slots=2)),
    ("f32", dict(approx_width=128, final_merge="xla")),
    ("f32", dict(approx_width=128, final_merge="xla_approx")),
    ("f32", dict(approx_width=128, final_merge="packed")),
    ("f32", dict(dma_pipeline=True)),
    ("f32", dict(approx_width=256, probes_per_step=2)),
    ("f32", dict(approx_width=128, acc_slots=2)),
    ("sentinel", dict(approx_width=256, acc_slots=1)),
])
def test_options_at_k300_match_jax(saved, corpus, name, opts):
    """Each option at k = 300 raises exactly where ``query(...,
    impl="pallas")`` raises; where both answer, the answers agree as at k
    10 (missing results (−inf, −1) included)."""
    q, _ = corpus
    jivf, tivf = _pair(saved, name)
    args = dict(dict(k=300, block_q=8, union_factor=1), **opts)
    try:
        js, ji = jivf.query(jnp.asarray(q[:8]), impl="pallas", **args)
    except ValueError:
        with pytest.raises(ValueError):
            tivf.query(torch.from_numpy(q[:8]), **args)
        return
    ts, ti = tivf.query(torch.from_numpy(q[:8]), **args)
    assert ti.shape == (8, 300)
    _agree(name, ts, ti, js, ji, packed=opts.get("final_merge") == "packed")
