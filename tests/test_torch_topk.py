"""Kernel K2 (exact cosine top-k): the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its XLA oracle. The CUDA
kernel is held against the plain version in test_torch_cuda.py."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_similarity_tpu.ops.topk import cosine_topk_pallas, cosine_topk_xla
from text_similarity_tpu_torch.ops.topk import (
    cosine_topk,
    cosine_topk_cuda,
    cosine_topk_reference,
    l2_normalize,
    select_topk,
)


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
        cosine_topk(torch.from_numpy(q), torch.from_numpy(x), k=257)


def test_select_topk_order():
    s = torch.tensor([[0.5, 0.75, 0.5, 0.75, -float("inf")]])
    i = torch.tensor([[7, 3, 2, 1, -1]], dtype=torch.int32)
    ts, ti = select_topk(s, i, 4)
    assert ti.tolist() == [[1, 3, 2, 7]]
    assert ts.tolist() == [[0.75, 0.75, 0.5, 0.5]]


def test_l2_normalize():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(l2_normalize(x).numpy(), [[0.6, 0.8], [0.0, 0.0]])
