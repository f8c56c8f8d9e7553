"""Kernel K8 (the certified two-pass top-k): the port's plain version
against the JAX package's ``cosine_topk_pallas_2pass`` in interpret mode,
with the reference's fallback observed. Under ``jax.disable_jit`` its
``lax.cond`` runs only the branch it takes, so a counting wrapper around
``cosine_topk_pallas`` (the reference's fallback) sees whether it ran. The
CUDA kernels are held against the plain version in test_torch_cuda.py."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import text_similarity_tpu.ops.topk as jax_topk
from text_similarity_tpu_torch.ops.topk import (
    cosine_topk_2pass,
    cosine_topk_2pass_reference,
    cosine_topk_reference,
    exact_merge_rounds,
    topk_2pass_count_cuda,
    topk_2pass_count_plain,
    topk_2pass_fold_cuda,
    topk_2pass_fold_plain,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _random(q_n=40, n=4096 + 77, d=64, seed=3):
    """tests/test_topk.py's random recipe. About two rows share each lane
    class, so some queries' top k hold two rows of one class: at k 10,
    queries 5, 29 and 30 do, and the 40-query call falls back; the first
    five queries certify."""
    rng = np.random.RandomState(seed)
    return _unit(rng.randn(q_n, d)), _unit(rng.randn(n, d))


def _collision(q_n=8, d=64, seed=4):
    """tests/test_topk.py's collision recipe: two near-copies of the query
    2048 rows apart share a lane class, so pass A hides one of them."""
    rng = np.random.RandomState(seed)
    corpus = rng.randn(4096, d).astype(np.float32) * 0.01
    target = rng.randn(d).astype(np.float32)
    corpus[5] = target + 0.001 * rng.randn(d)
    corpus[5 + 2048] = target + 0.001 * rng.randn(d)
    return _unit(np.repeat(target[None], q_n, axis=0)), _unit(corpus)


def _tied(q_n=13, n=5000, d=64, seed=5, gaps=(1500, 3000)):
    """Each query's source row has two later copies, ``gaps`` rows on:
    three equal scores at the top of its list. With the default gaps the
    copies lie in three lane classes (the merge rounds' lowest-id rule
    orders them); a gap of 2048 puts a copy in its source's class."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((n, d)))
    src = rng.choice(1000, q_n, replace=False)
    for gap in gaps:
        x[src + gap] = x[src]
    return _unit(x[src] + 0.05 * rng.standard_normal((q_n, d))), x


def _jax_2pass(q, x, k, block_c=2048):
    """The reference on (q, x) → (scores, ids, whether it fell back)."""
    calls = []
    orig = jax_topk.cosine_topk_pallas

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    jax_topk.cosine_topk_pallas = counted
    try:
        with jax.disable_jit():
            s, i = jax_topk.cosine_topk_pallas_2pass(
                jnp.asarray(q), jnp.asarray(x), k=k, block_c=block_c, interpret=True
            )
    finally:
        jax_topk.cosine_topk_pallas = orig
    return np.asarray(s), np.asarray(i), bool(calls)


def _port_2pass(q, x, k, block_c=2048, dtype=torch.float32):
    before = cosine_topk_2pass.fallbacks
    s, i = cosine_topk_2pass(torch.from_numpy(q), torch.from_numpy(x).to(dtype), k=k,
                             block_c=block_c)
    return s.numpy(), i.numpy(), cosine_topk_2pass.fallbacks > before


@pytest.mark.parametrize(
    "recipe,q_n,k,fell_back",
    [("random", 40, 1, False), ("random", 5, 10, False), ("random", 40, 10, True),
     ("random", 13, 20, True), ("collision", 8, 10, True), ("collision", 5, 20, True),
     ("tied", 13, 10, False)],
)
def test_plain_matches_pallas_2pass_f32(recipe, q_n, k, fell_back):
    """f32: ids exact, scores allclose 1e-6, and the fallback taken exactly
    where the reference takes it (Q 13 and 5 are not multiples of 8)."""
    q, x = {"random": _random, "collision": _collision, "tied": _tied}[recipe](q_n=q_n)
    js, ji, j_fell = _jax_2pass(q, x, k)
    ts, ti, t_fell = _port_2pass(q, x, k)
    assert j_fell == t_fell == fell_back
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6)


def test_tied_collision_falls_back_like_the_reference():
    """A copy 2048 rows after its source ties with it inside one lane
    class, and pass A keeps only the source. At k 1 and 2 (the source and
    the copy 3000 on) nothing scores above the k-th, so the call
    certifies; at k 3 the hidden copy scores above the k-th and both
    packages fall back."""
    q, x = _tied(q_n=13, gaps=(2048, 3000))
    for k, fell_back in ((1, False), (2, False), (3, True)):
        js, ji, j_fell = _jax_2pass(q, x, k)
        ts, ti, t_fell = _port_2pass(q, x, k)
        assert j_fell == t_fell == fell_back
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, atol=1e-6)


@pytest.mark.parametrize("k", [10, 20])
def test_plain_matches_pallas_2pass_bf16(k):
    """bf16 corpus (queries rounded to bf16, f32 sums): id overlap ≥ 0.99,
    scores within 1e-2, the same fallback decision."""
    q, x = _random(q_n=24)
    js, ji, j_fell = _jax_2pass(q, x.astype(ml_dtypes.bfloat16), k)
    ts, ti, t_fell = _port_2pass(q, x, k, dtype=torch.bfloat16)
    assert j_fell == t_fell
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(ti, ji)])
    assert overlap >= 0.99
    np.testing.assert_allclose(ts, js, atol=1e-2)


def test_block_c_is_a_real_parameter():
    """block_c sets the lane classes: the collision corpus certifies at
    block_c 1000 (the copies 2048 apart fall in different classes) and
    falls back at 2048 and 1024, in both packages."""
    q, x = _collision()
    for block_c, fell_back in ((2048, True), (1024, True), (1000, False)):
        js, ji, j_fell = _jax_2pass(q, x, 10, block_c)
        ts, ti, t_fell = _port_2pass(q, x, 10, block_c)
        assert j_fell == t_fell == fell_back
        np.testing.assert_array_equal(ti, ji)


def test_fallback_is_k2s_answer():
    """Where it falls back, the answer is K2's plain version's, bit for
    bit; where it certifies, the same ids as K2's."""
    for recipe in (_collision, _random):
        q, x = recipe()
        tq, tx = torch.from_numpy(q), torch.from_numpy(x)
        s, i = cosine_topk_2pass_reference(tq, tx, k=10)
        es, ei = cosine_topk_reference(tq, tx, k=10)
        assert torch.equal(i, ei)
        np.testing.assert_allclose(s.numpy(), es.numpy(), atol=1e-6)


def test_exact_merge_rounds_matches_reference():
    """The k rounds on candidates with ties, empty classes (−inf, −1) and
    fewer finite candidates than k."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 4, (6, 40)).astype(np.float32) / 4
    s[:, 30:] = -np.inf
    s[5, 3:] = -np.inf
    ids = rng.permutation(400)[:240].reshape(6, 40).astype(np.int32)
    ids[:, 35:] = -1
    js, ji = jax_topk._exact_merge_rounds(jnp.asarray(s), jnp.asarray(ids), 12)
    ts, ti = exact_merge_rounds(torch.from_numpy(s), torch.from_numpy(ids), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_passes_and_cuda_wrappers_on_cpu():
    """On queries that certify, pass B counts k − 1 scores above the k-th
    (pass A's view of the scores); the kernels' wrappers refuse CPU
    tensors and launch nothing; k is checked."""
    q, x = _random(q_n=5)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    s, _ = topk_2pass_fold_plain(tq, tx, 10, 2048)
    cnt = topk_2pass_count_plain(tq, tx, s[:, 9].contiguous(), 2048)
    assert torch.equal(cnt, torch.full((5,), 9, dtype=torch.int32))
    launches = (topk_2pass_fold_cuda.launches, topk_2pass_count_cuda.launches)
    with pytest.raises(ValueError):
        topk_2pass_fold_cuda(tq, tx, 10)
    with pytest.raises(ValueError):
        topk_2pass_count_cuda(tq, tx, s[:, 9].contiguous())
    assert (topk_2pass_fold_cuda.launches, topk_2pass_count_cuda.launches) == launches
    with pytest.raises(ValueError):
        cosine_topk_2pass(tq, tx, k=tx.shape[0] + 1)
