"""The flash backward in the port (kernel K6's plain version and the
autograd Function around K5 and K6) against the JAX package's Pallas
backward kernels, run in interpret mode through ``jax.vjp``.

Cases: full, padded and zero-length rows with a random do on the padded
rows too; window 0, 8, and 8 with the global CLS (row 0 and column 0
checked on their own); f32 and bf16; D 32 and 64. The padded rows are
within the band of a valid key, where the Pallas kernels and the port keep
the same pairs; rows beyond every band get a zero do, as in training.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.ops.attention import flash_attention as jax_flash
from text_similarity_tpu_torch.ops.attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_plain,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S, H = 3, 64, 2
LENS = (64, 59, 0)            # full, padded within the band, zero-length
MODES = [(0, False), (8, False), (8, True)]   # (window, global CLS)
# (atol, rtol). f32: the JAX tests' own tolerance; bf16: one bf16 ulp
# (relative 2^-7, and 2e-2 absolute for gradients below 2), where ds or p
# rounds the other way after f32 sums in another order
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2.0 ** -7)}


def _inputs(d, seed=0, lens=LENS):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, d)).astype(np.float32) for _ in range(4))
    mask = (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, dtype, window, global_cls):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, jnp.asarray(mask), block_q=32, block_k=32, interpret=True,
                         window=window, global_cls=global_cls)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,global_cls", MODES)
@pytest.mark.parametrize("d", [32, 64])
def test_backward_plain_matches_pallas_interpret(dtype, window, global_cls, d):
    """dq, dk, dv of ``flash_attention_backward_plain`` (on the plain
    forward's o and lse) against ``jax.vjp`` of the Pallas flash attention,
    every row (``TOL``); the zero-length row exactly 0; with
    the global CLS row 0 and column 0 on their own as well."""
    q, k, v, do, mask = _inputs(d)
    want = _jax_grads(q, k, v, do, mask, dtype, window, global_cls)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    lengths = torch.tensor(LENS, dtype=torch.int32)
    out, lse = flash_attention_plain(tq, tk, tv, lengths, window, global_cls, return_lse=True)
    got = flash_attention_backward_plain(tq, tk, tv, lengths, out, lse, tdo, window, global_cls)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (B, S, H, d)
        g = g.float().numpy()
        atol, rtol = TOL[dtype]
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)
        np.testing.assert_allclose(g[:, 0], w[:, 0], atol=atol, rtol=rtol)
        assert not g[2].any()


@pytest.mark.parametrize("window,global_cls", [(8, False), (8, True)])
def test_backward_plain_rows_beyond_the_band(window, global_cls):
    """Padded rows beyond every band (length 40 of 64) with a zero do there,
    as the encoder's pooling gives: every row agrees with the Pallas
    backward, f32 1e-5."""
    lens = (64, 40, 0)
    q, k, v, do, mask = _inputs(32, seed=1, lens=lens)
    do = do * mask[:, :, None, None]
    want = _jax_grads(q, k, v, do, mask, torch.float32, window, global_cls)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lengths = torch.tensor(lens, dtype=torch.int32)
    out, lse = flash_attention_plain(tq, tk, tv, lengths, window, global_cls, return_lse=True)
    got = flash_attention_backward_plain(tq, tk, tv, lengths, out, lse, tdo, window, global_cls)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_jax_grad(dtype):
    """``flash_attention`` on CPU tensors that need a gradient runs the
    autograd Function (plain K5, then plain K6): the gradients of
    sum(sin(o) · cos(o / 2)) against ``jax.grad`` of the same loss through
    the Pallas kernels (``TOL``)."""
    q, k, v, _, mask = _inputs(32, seed=2)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, jnp.asarray(mask), block_q=32, block_k=32, interpret=True,
                      window=8, global_cls=True).astype(jnp.float32)
        return jnp.sum(jnp.sin(o) * jnp.cos(o * 0.5))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jd) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = flash_attention(*leaves, torch.from_numpy(mask), window=8, global_cls=True)
    assert isinstance(o.grad_fn, FlashAttentionFunction._backward_cls)
    of = o.float()
    (of.sin() * (of * 0.5).cos()).sum().backward()
    for t, w in zip(leaves, want):
        atol, rtol = TOL[dtype]
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   atol=atol, rtol=rtol)


def test_no_grad_and_lse_paths_skip_the_function():
    """Without grad (or with inputs that need none) ``flash_attention`` runs
    the plain forward alone; the lse has no gradient path, so asking for it
    with inputs that need a gradient is refused."""
    q, k, v, _, mask = _inputs(32, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert flash_attention(tq, tk, tv, torch.from_numpy(mask)).grad_fn is None
    tq.requires_grad_()
    with torch.no_grad():
        assert flash_attention(tq, tk, tv, torch.from_numpy(mask)).grad_fn is None
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, torch.from_numpy(mask), return_lse=True)
