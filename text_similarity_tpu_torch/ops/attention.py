"""Exact softmax attention: the plain reference path and the flash forward
(kernel K5), port of ``text_similarity_tpu.ops.attention``.

* ``attention_reference``: plain tensor code, the path the JAX encoder
  takes below S = 4096. Scores are computed with f32 accumulation, masked
  with −1e9 (padding keys, and with ``window`` the band |i − j| ≤ window
  plus the global CLS row and column), materialised in bf16 when the
  inputs are bf16, and normalised by an f32 softmax.
* ``flash_attention``: blockwise online-softmax attention with per-row key
  lengths, the same band and global CLS, and the optional log-sum-exp
  residual. On a CUDA tensor it launches the hand-written kernel K5
  (``csrc/flash_fwd.cu``, via ``flash_attention_cuda``); on a CPU tensor it
  runs ``flash_attention_plain``. Its numerics are the Pallas kernel's:
  scores stay in f32 and p is rounded to the input dtype before P·V.
* ``multi_head_attention``: the dispatch the encoder calls, with the JAX
  package's ``impl="auto"`` rule (``auto_impl``).

Not ported yet: the flash backward (K6, with the training slice), the
head-packed kernel (K7, ``impl="packed"``), causal and segment-masked
attention, performer and the context-parallel strategies.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _cuda

NEG_INF = -1e9  # large finite negative: bf16-safe masking
FLASH_HEAD_DIMS = (32, 64, 128)


def _band(rows: torch.Tensor, keys: torch.Tensor, window: int, global_cls: bool) -> torch.Tensor:
    """(len(rows), len(keys)) bool: |i − j| ≤ window, or i == 0 / j == 0
    with the global CLS."""
    keep = (rows[:, None] - keys[None, :]).abs() <= window
    if global_cls:
        keep = keep | (rows[:, None] == 0) | (keys[None, :] == 0)
    return keep


def attention_reference(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,  # (B, S, H, D)
    mask: Optional[torch.Tensor] = None,       # (B, S) 1 = keep
    head_mask: Optional[torch.Tensor] = None,  # (H,) multiplier per head
    window: int = 0,           # > 0: banded attention, |i − j| ≤ window
    global_cls: bool = True,   # with window: position 0 global both ways
) -> torch.Tensor:
    d = q.shape[-1]
    s = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    # (B, H, S, D); products of bf16 values are exact in f32, so upcasting
    # the operands gives the reference's bf16-in / f32-accumulate dot
    qt = q.transpose(1, 2).float()
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if mask is not None:
        bias = torch.where(
            mask[:, None, None, :].bool(),
            torch.zeros((), dtype=torch.float32, device=logits.device),
            torch.full((), NEG_INF, dtype=torch.float32, device=logits.device),
        )
        logits = logits + bias
    if window > 0:
        pos = torch.arange(s, device=logits.device)
        logits = torch.where(_band(pos, pos, window, global_cls), logits, NEG_INF)
    if q.dtype == torch.bfloat16:
        # scores materialised in bf16 (the reference's AMP analogue); the
        # max, exp and sum still run in f32
        l16 = logits.to(torch.bfloat16).float()
        m = l16.amax(dim=-1, keepdim=True)
        p = torch.exp(l16 - m)
        probs = p / p.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
    if head_mask is not None:
        probs = probs * head_mask[None, :, None, None].to(probs.dtype)
    out = torch.matmul(probs.to(v.dtype).float(), vt.float())
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash forward (kernel K5)
# ---------------------------------------------------------------------------

def flash_attention_plain(
    q: torch.Tensor,        # (B, S, H, D) f32 or bf16
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) valid keys per sequence (padding at the end)
    window: int = 0,
    global_cls: bool = False,
    return_lse: bool = False,
):
    """Plain version of K5: a masked softmax in f32 over the keys j <
    len[b] (and, with ``window``, the band plus the global CLS row and
    column), p rounded to the input dtype before P·V with f32 sums, zero
    output and lse 0 for a row with no kept key (zero-length sequences).
    Query rows are taken in chunks so the (B, H, chunk, S) f32 scores stay
    near 512 MB. → out (B, S, H, D), and lse (B, H, S) f32 when asked."""
    b, s, h, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qt = q.transpose(1, 2).float()
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    pos = torch.arange(s, device=dev)
    key_ok = (pos[None, :] < lengths.to(dev)[:, None])[:, None, None, :]  # (B,1,1,S)
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    chunk = max(1, (1 << 27) // max(1, b * h * s))
    for r0 in range(0, s, chunk):
        rows = pos[r0:r0 + chunk]
        scores = torch.matmul(qt[:, :, r0:r0 + chunk], kt.transpose(-1, -2)) * scale
        keep = key_ok
        if window > 0:
            keep = keep & _band(rows, pos, window, global_cls)[None, None]
        scores = torch.where(keep, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m) * keep   # a row with no kept key sums to 0
        l = p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(q.dtype).float(), vt)
        out[:, :, r0:r0 + chunk] = pv / torch.where(l == 0, torch.ones_like(l), l)
        lse[:, :, r0:r0 + chunk] = torch.where(
            l > 0, m + torch.log(l), torch.zeros_like(l)
        ).squeeze(-1)
    out = out.transpose(1, 2).to(q.dtype)
    return (out, lse) if return_lse else out


def _check_flash_operand(t: torch.Tensor, name: str, like: torch.Tensor) -> None:
    """A q/k/v view K5 can read: CUDA, f32/bf16 as q, q's shape, the last
    dim contiguous, 16-byte aligned base and batch/token/head strides."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != like.dtype:
        raise TypeError(f"{name}: dtype {t.dtype} (need f32 or bf16, as q)")
    if t.dim() != 4 or t.shape != like.shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} (need (B, S, H, D) as q)")
    if t.device != like.device:
        raise ValueError("q, k and v must be on one device")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")
    if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:3]):
        raise ValueError(f"{name}: base and strides must be 16-byte aligned")


def flash_attention_cuda(
    q: torch.Tensor,        # (B, S, H, D) CUDA, f32 or bf16; last dim contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 CUDA
    window: int = 0,
    global_cls: bool = False,
    return_lse: bool = False,
):
    """Kernel K5 on the card. q, k, v may be strided views (the encoder's
    fused QKV); D ∈ {32, 64, 128}. Inference only: the backward is kernel
    K6, not ported. → out (B, S, H, D) contiguous in q's dtype, and lse
    (B, H, S) f32 when asked."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention backward (kernel K6) is not ported yet; run "
            "under torch.no_grad() or use impl='reference'"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_flash_operand(t, name, q)
    _cuda.require_cuda(lengths, "lengths", (torch.int32,), 1)
    b, s, h, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {FLASH_HEAD_DIMS}")
    if lengths.shape[0] != b or lengths.device != q.device:
        raise ValueError(f"lengths must be ({b},) on q's device")
    if window < 0:
        raise ValueError(f"window={window} must be ≥ 0")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    if b * s * h:
        err = _cuda.lib().ts_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, lengths.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(window), int(bool(global_cls)),
            ctypes.c_float(1.0 / math.sqrt(d)), _cuda.stream_handle(q.device),
        )
        _cuda.check(err, "flash attention kernel")
        flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (B, S), contiguous: 1s then 0s
    window: int = 0,           # > 0: sliding-window (banded) attention
    global_cls: bool = False,  # with window: position 0 global both ways
    return_lse: bool = False,
):
    """Blockwise exact attention (the JAX package's ``flash_attention``):
    the mask is reduced to per-sequence key lengths (padding sits at the
    end, as length-bucketed batching guarantees). K5 on a CUDA tensor, its
    plain version on a CPU tensor. → out (B, S, H, D), plus lse (B, H, S)
    with ``return_lse``."""
    b, s = q.shape[:2]
    if mask is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    else:
        lengths = mask.sum(dim=1, dtype=torch.int32)
    global_cls = bool(global_cls and window > 0)
    fn = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
    return fn(q, k, v, lengths, window=window, global_cls=global_cls, return_lse=return_lse)


def auto_impl(seq_len: int, on_cuda: bool, head_mask: Optional[torch.Tensor] = None) -> str:
    """The JAX package's ``impl="auto"`` rule (``ops/attention.py:863-870``):
    flash on the accelerator (here: a CUDA tensor) when there is no head
    mask, S % 128 == 0 and S ≥ 4096; otherwise the reference. (The rule
    also needs no segment ids; the port has no packed attention yet.)"""
    use_flash = on_cuda and head_mask is None and seq_len % 128 == 0 and seq_len >= 4096
    return "flash" if use_flash else "reference"


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",        # auto | flash | reference
    window: int = 0,
    window_global_cls: bool = False,
) -> torch.Tensor:
    """Dispatching MHA: ``auto`` resolves through :func:`auto_impl`, so on
    the CPU it runs the reference, as the JAX package does there; only an
    explicit ``impl="flash"`` runs K5's plain version on the CPU."""
    if impl == "auto":
        impl = auto_impl(q.shape[1], q.is_cuda, head_mask)
    if impl == "flash":
        if head_mask is not None:
            raise ValueError("flash attention does not support head_mask")
        return flash_attention(q, k, v, mask, window=window, global_cls=window_global_cls)
    if impl == "reference":
        return attention_reference(
            q, k, v, mask, head_mask, window=window, global_cls=window_global_cls
        )
    raise ValueError(f"attention impl {impl!r}: the port has auto, flash and reference")
