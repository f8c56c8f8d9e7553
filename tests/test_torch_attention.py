"""Attention in the port against the JAX package: the plain version of the
flash kernel K5 against the Pallas kernel in interpret mode (outputs and
the lse residual), the banded reference, the ``impl="auto"`` rule, and the
CPU side of the CUDA wrapper."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_similarity_tpu.ops.attention import _flash_forward as jax_flash_forward
from text_similarity_tpu.ops.attention import attention_reference as jax_reference
from text_similarity_tpu.ops.attention import flash_attention as jax_flash
from text_similarity_tpu_torch.ops.attention import (
    attention_reference,
    auto_impl,
    flash_attention,
    flash_attention_cuda,
    flash_attention_plain,
    multi_head_attention,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S, H, D = 3, 128, 2, 32
LENS = (128, 77, 0)           # a full row, a padded row and a zero-length row
MODES = [(0, False), (24, False), (24, True)]   # (window, global CLS)


def _qkv(seed=0, b=B, s=S, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _mask(lens=LENS, s=S):
    return (np.arange(s)[None] < np.asarray(lens)[:, None]).astype(np.int32)


def _valid_rows(out, lens=LENS):
    """Rows i < len of each sequence (B, S, ...) → one flat array."""
    return np.concatenate([out[b, :n] for b, n in enumerate(lens)])


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window,global_cls", MODES)
def test_flash_plain_matches_pallas_interpret(dtype, atol, window, global_cls):
    """Valid rows allclose (f32 1e-5, the JAX tests' own tolerance; bf16
    2e-2: p rounds against a running max in the kernel, a row max here);
    the zero-length row is exactly 0."""
    q, k, v = _qkv()
    mask = _mask()
    jd = _jax_dtype(dtype)
    want = jax_flash(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(mask),
        block_q=32, block_k=32, interpret=True, window=window, global_cls=global_cls,
    )
    want = np.asarray(want.astype(jnp.float32))
    got = flash_attention(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), torch.from_numpy(mask),
        window=window, global_cls=global_cls,
    )
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    got = got.float().numpy()
    np.testing.assert_allclose(_valid_rows(got), _valid_rows(want), atol=atol)
    assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("window,global_cls", MODES)
def test_flash_plain_lse_matches_pallas_residual(window, global_cls):
    """The lse residual (m + log l, 0 for a zero-length row) against
    ``_flash_forward(save_residuals=True)`` in interpret mode, f32."""
    q, k, v = _qkv(seed=1)
    lens = np.repeat(np.asarray(LENS, np.int32), H)

    def fold(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    _, want = jax_flash_forward(
        fold(q), fold(k), fold(v), jnp.asarray(lens), 32, 32, True, window,
        save_residuals=True, global_cls=global_cls,
    )
    want = np.asarray(want).reshape(B, H, S)
    out, lse = flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.tensor(LENS, dtype=torch.int32),
        window=window, global_cls=global_cls, return_lse=True,
    )
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    lse = lse.numpy()
    for b, n in enumerate(LENS):
        np.testing.assert_allclose(lse[b, :, :n], want[b, :, :n], atol=1e-5)
    assert not lse[2].any()
    np.testing.assert_array_equal(
        out.numpy(), flash_attention_plain(
            *(torch.from_numpy(x) for x in (q, k, v)), torch.tensor(LENS, dtype=torch.int32),
            window=window, global_cls=global_cls,
        ).numpy()
    )


@pytest.mark.parametrize(
    "window,global_cls,masked",
    [(0, False, True), (24, False, True), (24, True, True), (8, True, False)],
)
def test_reference_matches_jax(window, global_cls, masked):
    """The banded reference with the global CLS, f32: allclose 1e-5 on
    every row (padding rows included: both compute the same softmax)."""
    q, k, v = _qkv(seed=2)
    mask = _mask((128, 77, 5)) if masked else None
    want = jax_reference(
        *(jnp.asarray(x) for x in (q, k, v)), None if mask is None else jnp.asarray(mask),
        window=window, global_cls=global_cls,
    )
    got = attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), window=window, global_cls=global_cls,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_reference_bf16_band_matches_jax():
    """bf16: the reference materialises the banded scores in bf16 on both
    sides; outputs allclose 2e-2."""
    q, k, v = _qkv(seed=3)
    mask = _mask()
    want = jax_reference(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask),
        window=24, global_cls=True,
    )
    got = attention_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), torch.from_numpy(mask),
        window=24, global_cls=True,
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2e-2
    )


@pytest.mark.parametrize("seq_len", [3968, 4096, 4224])
@pytest.mark.parametrize("on_cuda", [True, False])
@pytest.mark.parametrize("with_head_mask", [False, True])
def test_auto_rule(seq_len, on_cuda, with_head_mask):
    """Flash only on the card, without a head mask, at S % 128 == 0 and
    S ≥ 4096 (3968 is 31·128, below the threshold; 4224 is 33·128)."""
    head_mask = torch.ones(4) if with_head_mask else None
    want = "flash" if on_cuda and not with_head_mask and seq_len >= 4096 else "reference"
    assert auto_impl(seq_len, on_cuda, head_mask) == want


def test_auto_runs_the_reference_on_cpu(monkeypatch):
    """On the CPU ``auto`` takes the reference (as the JAX package does),
    ``impl="flash"`` the plain K5; flash refuses a head mask, packed a head
    mask, a window (with or without the global CLS) and segment ids."""
    import text_similarity_tpu_torch.ops.attention as attn

    q, k, v = (torch.from_numpy(x) for x in _qkv(seed=4, s=256))
    calls = []
    plain = attn.flash_attention_plain   # its answer goes on through K5's registered op
    monkeypatch.setattr(attn, "flash_attention_plain",
                        lambda *a, **kw: calls.append("plain") or plain(*a, **kw))
    multi_head_attention(q, k, v, impl="auto", window=16, window_global_cls=True)
    assert calls == []
    multi_head_attention(q, k, v, impl="flash", window=16, window_global_cls=True)
    assert calls == ["plain"]
    with pytest.raises(ValueError):
        multi_head_attention(q, k, v, head_mask=torch.ones(H), impl="flash")
    # the packed guards (the reference's): no head mask, no window, no
    # global CLS, no segment ids
    q4, k4, v4 = (torch.from_numpy(x) for x in _qkv(seed=4, s=64, h=4))
    with pytest.raises(ValueError, match="head_mask"):
        multi_head_attention(q4, k4, v4, head_mask=torch.ones(4), impl="packed")
    with pytest.raises(ValueError, match="window"):
        multi_head_attention(q4, k4, v4, impl="packed", window=16)
    with pytest.raises(ValueError, match="window"):
        multi_head_attention(q4, k4, v4, impl="packed", window=16, window_global_cls=True)
    with pytest.raises(ValueError, match="segment_ids"):
        multi_head_attention(q4, k4, v4, impl="packed", segment_ids=torch.ones(B, 64, dtype=torch.int32))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CPU takes the plain path only through ``flash_attention``; the
    kernel's wrapper itself refuses a CPU tensor and, under grad mode, any
    input that needs a gradient (``flash_attention`` takes those through
    its autograd Function, K5 then K6)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(seed=5))
    lens = torch.tensor(LENS, dtype=torch.int32)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v, lens)
    with pytest.raises(ValueError, match="does not track gradients"):
        flash_attention_cuda(q.requires_grad_(), k, v, lens)
    assert flash_attention_cuda.launches == before
