"""Kernel K7 (head-packed attention): the port's plain version
``packed_attention_plain`` against the JAX package's Pallas
``packed_attention`` in interpret mode on every row (padded query rows
included), the gradients of ``PackedAttentionFunction`` against ``jax.grad``
of the reference, and ``encoder_forward(attention_impl="packed")`` against
the JAX encoder's. The CUDA kernel is held against the plain version in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.ops.attention import packed_attention as jax_packed
from text_similarity_tpu_torch.core.config import EncoderArch
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.models import encoder_forward, params_from_jax
from text_similarity_tpu_torch.ops import attention as attn
from text_similarity_tpu_torch.ops.attention import (
    attention_reference,
    multi_head_attention,
    packed_attention,
    packed_attention_cuda,
    packed_attention_plain,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S = 64
LENS = (64, 37, 0, 1)     # full, padded, zero-length and one-key rows


def _qkv(h, d, seed=0, b=len(LENS), s=S):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _mask(lens=LENS, s=S):
    return (np.arange(s)[None] < np.asarray(lens)[:, None]).astype(np.int32)


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits), 2^-133 at 0."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("h,d", [(4, 32), (2, 64), (1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_interpret(h, d, dtype):
    """Every row, padded query rows included (they attend to the valid
    keys, unlike K5): f32 atol 1e-5; bf16 within one bf16 ulp of the output
    (both round p / l to bf16 and the output once, from f32 sums taken in
    another order). The zero-length row is exactly 0 on both sides."""
    q, k, v = _qkv(h, d, seed=d)
    mask = _mask()
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_packed(*(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(mask),
                      head_dim=d, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = packed_attention_plain(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                 torch.from_numpy(mask).sum(dim=1, dtype=torch.int32))
    assert got.dtype == dtype and got.shape == q.shape
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert (got[2] == 0).all() and (want[2] == 0).all()


def test_lengths_not_the_mask():
    """Only Σ mask is read: a mask with a hole gives the answer of its
    prefix of the same length, as the reference's kernel does."""
    q, k, v = _qkv(4, 32, seed=1, b=2)
    mask = np.ones((2, S), np.int32)
    mask[0, 10:20] = 0                               # a hole: length 54
    prefix = _mask((54, 64))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = packed_attention(*t, torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_packed(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask),
                                 head_dim=32, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got, packed_attention(*t, torch.from_numpy(prefix)).numpy())
    assert np.abs(got[0] - attention_reference(*t, torch.from_numpy(mask)).numpy()[0]).max() > 1e-3


def test_gradients_match_jax_grad():
    """Gradients through ``PackedAttentionFunction`` (forward: the plain
    K7; backward: autograd of ``attention_reference`` with the mask)
    against ``jax.grad`` of the reference's ``packed_attention`` (its
    ``custom_vjp``), the reference's loss and tolerance (atol 2e-4, rtol
    1e-3)."""
    q, k, v = _qkv(4, 32, seed=10, b=2, s=128)
    mask = _mask((100, 128), s=128)

    def jax_loss(q_, k_, v_):
        o = jax_packed(q_, k_, v_, jnp.asarray(mask), head_dim=32, interpret=True)
        return jnp.sum(jnp.sin(o) * jnp.cos(o * 0.5))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = packed_attention(*leaves, torch.from_numpy(mask))
    got = torch.autograd.grad((torch.sin(o) * torch.cos(o * 0.5)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=1e-3)


def test_dispatch_on_cpu(monkeypatch):
    """``multi_head_attention(impl="packed")`` on CPU tensors runs the plain
    version (never the reference); the kernel's wrapper refuses CPU
    tensors, launching nothing; the reference's shape rule (D | 128, H %
    (128 / D) == 0) holds on both routes."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 32, seed=2))
    mask = torch.from_numpy(_mask())
    calls = []
    plain = attn.packed_attention_plain
    monkeypatch.setattr(attn, "packed_attention_plain",
                        lambda *a: calls.append(1) or plain(*a))
    out = multi_head_attention(q, k, v, mask, impl="packed")
    assert calls == [1]
    np.testing.assert_array_equal(out.numpy(), plain(q, k, v, mask.sum(1, dtype=torch.int32)).numpy())
    before = packed_attention_cuda.launches
    with pytest.raises(ValueError):
        packed_attention_cuda(q, k, v, mask.sum(1, dtype=torch.int32))
    assert packed_attention_cuda.launches == before
    x = torch.zeros(1, 8, 3, 32)
    with pytest.raises(ValueError, match="128"):
        packed_attention(x, x, x)
    x = torch.zeros(1, 8, 4, 48)
    with pytest.raises(ValueError, match="128"):
        multi_head_attention(x, x, x, impl="packed")


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_encoder_packed_impl_matches_jax(act):
    """A tiny f32 encoder (4 heads of 32) with ``attention_impl="packed"``
    in both packages (the JAX one runs the Pallas kernel in interpret mode)
    on ragged rows: last_hidden_state on every row allclose 1e-4, and the
    port's packed route equal to its reference route on valid rows."""
    jarch = JAX_PRESETS["tiny-test"].replace(hidden_act=act, hidden_size=128, num_heads=4,
                                              intermediate_size=256)
    arch = EncoderArch.from_json(jarch.to_json())
    jp = jax.device_get(jax_init(jax.random.PRNGKey(1), jarch))
    tp = params_from_jax(jp, arch)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, arch.vocab_size, (3, 32)).astype(np.int32)
    mask = _mask((32, 20, 3), s=32)
    want = jax_forward(jp, jnp.asarray(ids), jnp.asarray(mask), arch=jarch, precision=JAX_FP32,
                       attention_impl="packed").last_hidden_state
    got = encoder_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask), arch=arch,
                          precision=FP32_PRECISION, attention_impl="packed").last_hidden_state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    ref = encoder_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask), arch=arch,
                          precision=FP32_PRECISION, attention_impl="reference").last_hidden_state
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], ref.numpy()[valid], atol=1e-4)
