"""Kernel K1 (IVF block-union scan) and the IVF index: a JAX-built index
loads into the port, and the port's plain scan is held against the JAX
Pallas kernel (interpret mode) in the exact and deferred merge modes. The
CUDA kernel is held against the plain scan in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import IndexConfig as JaxIndexConfig
from text_similarity_tpu.index.ivf import IVFIndex as JaxIVFIndex
from text_similarity_tpu.index.ivf import _approx_merge_plan as jax_plan
from text_similarity_tpu.ops.topk import cosine_topk_xla
from text_similarity_tpu_torch.core.config import IndexConfig
from text_similarity_tpu_torch.index.ivf import (
    IVFIndex,
    _approx_merge_plan,
)


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
