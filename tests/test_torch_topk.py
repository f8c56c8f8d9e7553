"""Kernel K2 (exact cosine top-k): the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its XLA oracle. The CUDA
kernel is held against the plain version in test_torch_cuda.py."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_similarity_tpu.ops.topk import cosine_topk_pallas, cosine_topk_xla
from text_similarity_tpu_torch.ops import topk as topk_mod
from text_similarity_tpu_torch.ops.topk import (
    cosine_topk,
    cosine_topk_cuda,
    cosine_topk_reference,
    l2_normalize,
    select_topk,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _data(n, d=64, q=16, seed=0, dups=True):
    """Random unit corpus with duplicated rows; queries are noisy copies of
    duplicated rows, so exact ties sit inside their top-k."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((n, d)))
    src = rng.choice(n // 2, size=q, replace=False)
    if dups:
        dst = rng.choice(np.arange(n // 2, n), size=2 * q, replace=False)
        x[dst[:q]] = x[src]
        x[dst[q:]] = x[src]       # three copies of each source row
    qs = _unit(x[src] + 0.05 * rng.standard_normal((q, d)))
    return qs, x


def _overlap(a, b):
    return np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)])


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("k", [1, 10, 20])
def test_reference_matches_pallas_f32(n, k):
    """f32: ids equal (ties → lowest id), scores allclose 1e-5."""
    q, x = _data(n)
    ps, pi = cosine_topk_pallas(jnp.asarray(q), jnp.asarray(x), k=k, interpret=True)
    ts, ti = cosine_topk_reference(torch.from_numpy(q), torch.from_numpy(x), k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-5)


@pytest.mark.parametrize("k", [1, 10, 20])
def test_reference_matches_xla_chunked(k):
    """Against the chunked XLA oracle with a chunk boundary inside the
    corpus (ids equal, scores allclose 1e-5)."""
    q, x = _data(3001, seed=1)
    xs, xi = cosine_topk_xla(jnp.asarray(q), jnp.asarray(x), k=k, chunk=1024)
    ts, ti = cosine_topk_reference(torch.from_numpy(q), torch.from_numpy(x), k=k, chunk=1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(xs), atol=1e-5)


def test_ties_pick_lowest_id():
    q, x = _data(1000, seed=2)
    _, ti = cosine_topk_reference(torch.from_numpy(q), torch.from_numpy(x), k=3)
    # each query's source row has two later copies: all three tie at the top
    assert (np.diff(ti.numpy(), axis=1) > 0).all()


@pytest.mark.parametrize("k", [10, 20])
def test_reference_matches_pallas_bf16(k):
    """bf16 corpus: id overlap ≥ 0.99, scores within bf16 input rounding
    (atol 1e-2)."""
    q, x = _data(4099, seed=3)
    xb = x.astype(ml_dtypes.bfloat16)
    ps, pi = cosine_topk_pallas(jnp.asarray(q), jnp.asarray(xb), k=k, interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ts, ti = cosine_topk_reference(torch.from_numpy(q), tx, k=k)
    assert _overlap(ti.numpy(), np.asarray(pi)) >= 0.99
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-2)


def test_dispatch_uses_plain_version_on_cpu():
    q, x = _data(500, seed=4)
    before = cosine_topk_cuda.launches
    s, i = cosine_topk(torch.from_numpy(q), torch.from_numpy(x), k=5)
    rs, ri = cosine_topk_reference(torch.from_numpy(q), torch.from_numpy(x), k=5)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert cosine_topk_cuda.launches == before
    with pytest.raises(ValueError):
        cosine_topk_cuda(torch.from_numpy(q), torch.from_numpy(x), k=5)
    with pytest.raises(ValueError):
        cosine_topk(torch.from_numpy(q), torch.from_numpy(x), k=501)   # k > N
    with pytest.raises(ValueError):
        cosine_topk(torch.from_numpy(q), torch.from_numpy(x), k=0)


def test_select_topk_order():
    s = torch.tensor([[0.5, 0.75, 0.5, 0.75, -float("inf")]])
    i = torch.tensor([[7, 3, 2, 1, -1]], dtype=torch.int32)
    ts, ti = select_topk(s, i, 4)
    assert ti.tolist() == [[1, 3, 2, 7]]
    assert ts.tolist() == [[0.75, 0.75, 0.5, 0.5]]


def test_l2_normalize():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(l2_normalize(x).numpy(), [[0.6, 0.8], [0.0, 0.0]])


_PLAN_Q = [1, 2, 7, 8, 15, 16, 17, 33, 63, 64, 65, 100, 128, 129, 255, 256, 257, 500, 1000,
           1024, 2047, 4096]
_PLAN_N = [1, 127, 128, 129, 1000, 10_007, 16_897, 100_003, 1_000_001]


class _GridRecorder:
    """Stands in for the kernel library: records the (splits, rows a
    split) that K3's wrapper hands to ``ts_cosine_topk_int8``."""

    def __init__(self):
        self.grids = []

    def ts_cosine_topk_int8(self, *args):
        self.grids.append((args[7], args[8]))
        return 0


def _k3_wrapper_grid(monkeypatch):
    """→ a function (q_n, n, k) → (QT, splits, rows) as K3's wrapper plans
    them, the library replaced by a recorder (no card needed)."""
    rec = _GridRecorder()
    monkeypatch.setattr(topk_mod._cuda, "lib", lambda: rec)
    monkeypatch.setattr(topk_mod._cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(topk_mod._cuda, "stream_handle", lambda dev: 0)
    corpora = {}

    def grid(q_n, n, k):
        if n not in corpora:
            corpora[n] = (torch.empty((n, 32), dtype=torch.int8), torch.empty(n))
        codes, scales = corpora[n]
        topk_mod.cosine_topk_int8_cuda(torch.empty((q_n, 32)), codes, scales, k)
        return (topk_mod._qtile(q_n, k), *rec.grids.pop())

    return grid


_PLAN_K = (1, 10, 33, 100, 256)


@pytest.mark.parametrize("kernel,k", [pytest.param("K2", k, id=str(k)) for k in _PLAN_K]
                         + [pytest.param("K3", k, id=f"K3-{k}") for k in _PLAN_K])
def test_score_tile_planner_covers_rows_and_fills_the_card(kernel, k, monkeypatch):
    """K2's grid (and K8's count, k 1), and K3's as its wrapper hands it to
    the kernel: for every Q in 1 … 4096 and ragged N, the query tile
    follows Q (16 / 64 / 128, capped by k's selectors), the splits are
    whole 128-row tiles that cover rows [0, N) exactly once, and the grid
    has at least 132 CTAs wherever the (query tile, 128-row tile) pairs
    allow."""
    plan = topk_mod._plan_topk if kernel == "K2" else _k3_wrapper_grid(monkeypatch)
    for q_n in _PLAN_Q:
        for n in _PLAN_N:
            if kernel == "K3" and k > n:
                continue   # the wrapper refuses k > N
            qt, splits, rows = plan(q_n, n, k)
            assert qt == min(16 if q_n <= 16 else 64 if q_n <= 64 else 128,
                             128 if k <= 32 else 64 if k <= 64 else 16)
            assert rows % 128 == 0
            covered = np.zeros(n, dtype=np.int64)
            for s in range(splits):
                covered[s * rows:min(n, (s + 1) * rows)] += 1
            assert (covered == 1).all() and splits * rows - n < rows
            q_tiles = -(-q_n // qt)
            assert q_tiles * splits >= min(132, q_tiles * -(-n // 128)), (q_n, n, k)


@pytest.mark.parametrize("block_c", [1, 100, 1000, 2048, 16384])
def test_fold_planner_covers_blocks_and_fills_the_card(block_c):
    """K8's fold grid (query tile, 128-class tile, split): the splits are
    runs of whole corpus blocks that cover every block exactly once, and
    the grid has at least 132 CTAs wherever the blocks allow."""
    for q_n in _PLAN_Q:
        for n in _PLAN_N:
            qt, splits, per = topk_mod._plan_fold(q_n, n, block_c)
            blocks = -(-n // block_c)
            assert qt == (16 if q_n <= 16 else 64 if q_n <= 64 else 128)
            assert (splits - 1) * per < blocks <= splits * per
            base = -(-q_n // qt) * -(-block_c // 128)
            assert base * splits >= min(132, base * blocks), (q_n, n, block_c)
