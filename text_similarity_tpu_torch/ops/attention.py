"""Exact softmax attention: the plain reference path, the flash forward
(kernel K5), the flash backward (kernel K6) and the head-packed attention
(kernel K7), port of ``text_similarity_tpu.ops.attention``.

* ``attention_reference``: plain tensor code, the path the JAX encoder
  takes below S = 4096 and for packed rows. Scores are computed with f32
  accumulation, masked with −1e9 (padding keys; with ``segment_ids`` every
  key of another segment, the block-diagonal mask of packed rows; with
  ``window`` the band |i − j| ≤ window plus the global CLS row and column),
  materialised in bf16 when the inputs are bf16, and normalised by an f32
  softmax. Autograd differentiates it.
* ``flash_attention``: blockwise online-softmax attention with per-row key
  lengths, the same band and global CLS, and the optional log-sum-exp
  residual. On a CUDA tensor it launches the hand-written kernel K5
  (``csrc/flash_fwd.cu``, via ``flash_attention_cuda``); on a CPU tensor it
  runs ``flash_attention_plain``. Its numerics are the Pallas kernel's:
  scores stay in f32 and p is rounded to the input dtype before P·V. With
  grad enabled it runs through ``FlashAttentionFunction``: the forward
  keeps o and lse, the backward is K6 (``csrc/flash_bwd.cu``, via
  ``flash_attention_backward_cuda``) on a CUDA tensor and
  ``flash_attention_backward_plain`` on a CPU tensor.
* ``packed_attention``: exact attention over per-row key lengths (Σ mask),
  the function of the reference's head-packed kernel: every query row,
  padded ones included, attends to the keys j < len; p is normalised, then
  rounded to the input dtype before P·V. On a CUDA tensor it launches K7
  (``csrc/packed_attention.cu``, via ``packed_attention_cuda``), on a CPU
  tensor ``packed_attention_plain``; with grad enabled it runs through
  ``PackedAttentionFunction``, whose backward is autograd of
  ``attention_reference`` with the mask, as the reference's ``custom_vjp``.
* ``multi_head_attention``: the dispatch the encoder calls, with the JAX
  package's ``impl="auto"`` rule (``auto_impl``) and its guards.

Not ported yet: causal attention, performer and the context-parallel
strategies.
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
    segment_ids: Optional[torch.Tensor] = None,  # (B, S): a token sees only
                                                 # keys of its own segment
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
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        logits = torch.where(same, logits, NEG_INF)
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
    fused QKV); D ∈ {32, 64, 128}. The kernel's output carries no
    gradient, so inputs that need one are refused under grad mode: take
    ``flash_attention``, whose autograd Function runs K5 and then K6. →
    out (B, S, H, D) contiguous in q's dtype, and lse (B, H, S) f32 when
    asked."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError(
            "flash_attention_cuda does not track gradients; call flash_attention, "
            "which runs K5 forward and K6 backward"
        )
    b, s, h, d = _check_flash_inputs(q, k, v, lengths, window)
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


def _check_flash_inputs(q, k, v, lengths, window) -> tuple:
    """The checks K5 and K6 make → (B, S, H, D)."""
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
    return b, s, h, d


# ---------------------------------------------------------------------------
# Flash backward (kernel K6)
# ---------------------------------------------------------------------------

def flash_attention_backward_plain(
    q: torch.Tensor,        # (B, S, H, D) f32 or bf16
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
    out: torch.Tensor,      # (B, S, H, D) the forward's output
    lse: torch.Tensor,      # (B, H, S) f32, the forward's log-sum-exp
    do: torch.Tensor,       # (B, S, H, D) the output's gradient
    window: int = 0,
    global_cls: bool = False,
):
    """Plain version of K6, the Pallas backward's arithmetic: di = Σ o·do
    in f32; p = exp(s − lse) on the kept pairs and 0 elsewhere; ds = p ·
    (do·vᵀ − di); ds rounded to the input dtype before ds·K and dsᵀ·Q, p
    before pᵀ·dO; f32 sums; dq and dk scaled by D^-1/2 once at the end.
    Every query row takes part, padded rows included: their lse is the
    forward's, so a nonzero do there reaches dk and dv of valid keys, as
    in the Pallas kernels. (Those kernels' own visit sets differ on two
    kinds of padded row the port does not copy: rows that meet no kept
    key in a visited block, and rows beyond every band under the global
    CLS; training never sends do there, ROADMAP queue 3.) Query rows are
    taken in chunks, as in ``flash_attention_plain``. → (dq, dk, dv),
    each (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt, dot = (x.transpose(1, 2).float() for x in (q, k, v, do))
    di = (out.float() * do.float()).sum(dim=-1).transpose(1, 2)   # (B, H, S)
    pos = torch.arange(s, device=dev)
    key_ok = (pos[None, :] < lengths.to(dev)[:, None])[:, None, None, :]  # (B,1,1,S)
    dq = torch.empty((b, h, s, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, h, s, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, h, s, d), dtype=torch.float32, device=dev)
    chunk = max(1, (1 << 27) // max(1, b * h * s))
    for r0 in range(0, s, chunk):
        rows = pos[r0:r0 + chunk]
        keep = key_ok
        if window > 0:
            keep = keep & _band(rows, pos, window, global_cls)[None, None]
        scores = torch.matmul(qt[:, :, r0:r0 + chunk], kt.transpose(-1, -2)) * scale
        p = torch.where(keep, torch.exp(scores - lse[:, :, r0:r0 + chunk, None]), 0.0)
        dp = torch.matmul(dot[:, :, r0:r0 + chunk], vt.transpose(-1, -2))
        ds = p * (dp - di[:, :, r0:r0 + chunk, None])
        dq[:, :, r0:r0 + chunk] = torch.matmul(ds.to(k.dtype).float(), kt)
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dot[:, :, r0:r0 + chunk])
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qt[:, :, r0:r0 + chunk])
    dq, dk = dq * scale, dk * scale
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


def flash_attention_backward_cuda(
    q: torch.Tensor,        # (B, S, H, D) CUDA, f32 or bf16; last dim contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 CUDA
    out: torch.Tensor,      # (B, S, H, D)
    lse: torch.Tensor,      # (B, H, S) f32
    do: torch.Tensor,       # (B, S, H, D)
    window: int = 0,
    global_cls: bool = False,
):
    """Kernel K6 on the card: its two kernels, dq (which also takes di =
    Σ o·do of its rows, the reduction the reference leaves to XLA, and
    writes it for the next) and dk/dv, each counted in ``launches``. q, k,
    v, out and do may be strided views with the last dim contiguous; D ∈
    {32, 64, 128}. → (dq, dk, dv), each (B, S, H, D) contiguous in q's
    dtype."""
    b, s, h, d = _check_flash_inputs(q, k, v, lengths, window)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"out and do must be {tuple(q.shape)}")
    if do.stride(-1) != 1 or do.data_ptr() % 16 or do.dtype != q.dtype:
        do = do.contiguous().to(q.dtype)
    if out.stride(-1) != 1 or out.data_ptr() % 16 or out.dtype != q.dtype:
        out = out.contiguous().to(q.dtype)
    _check_flash_operand(do, "do", q)
    _check_flash_operand(out, "out", q)
    _cuda.require_cuda(lse, "lse", (torch.float32,), 3)
    if tuple(lse.shape) != (b, h, s):
        raise ValueError(f"lse: shape {tuple(lse.shape)} (need {(b, h, s)})")
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    if b * s * h:
        lib = _cuda.lib()
        strides = (ctypes.c_longlong * 15)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            *out.stride()[:3],
        )
        common = (int(q.dtype == torch.bfloat16), b, s, h, d, strides, int(window),
                  int(bool(global_cls)), ctypes.c_float(1.0 / math.sqrt(d)),
                  _cuda.stream_handle(q.device))
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(),
               lse.data_ptr(), di.data_ptr())
        err = lib.ts_flash_bwd_dq(*ins, dq.data_ptr(), lengths.data_ptr(), *common)
        _cuda.check(err, "flash backward dq kernel")
        flash_attention_backward_cuda.launches += 1
        err = lib.ts_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), lengths.data_ptr(), *common)
        _cuda.check(err, "flash backward dk/dv kernel")
        flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


flash_attention_backward_cuda.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward (the JAX package's ``custom_vjp``
    ``_flash_folded``): the forward runs K5 with the lse residual (its
    plain version on a CPU tensor) and saves q, k, v, lengths, o and lse;
    the backward runs K6 (its plain version on a CPU tensor). On a CUDA
    tensor nothing falls back to the plain versions: a kernel launches or
    raises."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, window: int, global_cls: bool):
        fwd = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
        out, lse = fwd(q, k, v, lengths, window=window, global_cls=global_cls, return_lse=True)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.window, ctx.global_cls = window, global_cls
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        cpu = q.device.type == "cpu"
        bwd = flash_attention_backward_plain if cpu else flash_attention_backward_cuda
        dq, dk, dv = bwd(q, k, v, lengths, out, lse, do, ctx.window, ctx.global_cls)
        return dq, dk, dv, None, None, None


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
    plain version on a CPU tensor; with grad enabled and an input that
    needs a gradient, through ``FlashAttentionFunction`` (K6 backward).
    → out (B, S, H, D), plus lse (B, H, S) with ``return_lse`` (no
    gradient path)."""
    b, s = q.shape[:2]
    if mask is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    else:
        lengths = mask.sum(dim=1, dtype=torch.int32)
    global_cls = bool(global_cls and window > 0)
    wants_grad = q.requires_grad or k.requires_grad or v.requires_grad
    if torch.is_grad_enabled() and wants_grad:
        if return_lse:
            raise ValueError("return_lse is for inference; the lse has no gradient path")
        return FlashAttentionFunction.apply(q, k, v, lengths, window, global_cls)
    fn = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
    return fn(q, k, v, lengths, window=window, global_cls=global_cls, return_lse=return_lse)


# ---------------------------------------------------------------------------
# Head-packed attention (kernel K7)
# ---------------------------------------------------------------------------

def packed_attention_plain(
    q: torch.Tensor,        # (B, S, H, D) f32 or bf16
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) valid keys per sequence
) -> torch.Tensor:
    """Plain version of K7, the Pallas kernel's arithmetic: s = q·kᵀ (input
    dtype, f32 sums) × D^-1/2; keys j ≥ len[b] get −1e9 and weight exactly
    0 (``where(s > −1e9 / 2, exp(s − m), 0)``); p / l with l = 1 where it
    is 0 (a zero-length row gives 0); p rounded to v's dtype before P·V,
    f32 sums; the output in q's dtype. Every query row is computed, padded
    ones included. Query rows are taken in chunks, as in
    ``flash_attention_plain``. → (B, S, H, D)."""
    b, s, h, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))
    key_ok = (torch.arange(s, device=dev)[None, :] < lengths.to(dev)[:, None])[:, None, None, :]
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=dev)
    chunk = max(1, (1 << 27) // max(1, b * h * s))
    for r0 in range(0, s, chunk):
        scores = torch.matmul(qt[:, :, r0:r0 + chunk], kt.transpose(-1, -2)) * scale
        scores = torch.where(key_ok, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.where(scores > NEG_INF / 2, torch.exp(scores - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, r0:r0 + chunk] = torch.matmul(p.to(v.dtype).float(), vt)
    return out.transpose(1, 2).to(q.dtype)


def _check_packed_head_dim(q: torch.Tensor, head_dim: Optional[int] = None) -> int:
    """The reference's shape rule: D = head_dim divides 128 and the heads
    fill whole 128-lane groups (H % (128 / D) == 0) → D."""
    h, d = q.shape[2], q.shape[3]
    if head_dim is not None and d != head_dim:
        raise ValueError(f"head dim {d} != head_dim={head_dim}")
    if 128 % d or h % (128 // d):
        raise ValueError(f"packed attention needs D | 128 and H % (128 / D) == 0 (H {h}, D {d})")
    return d


def packed_attention_cuda(
    q: torch.Tensor,        # (B, S, H, D) CUDA, f32 or bf16; last dim contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 CUDA
) -> torch.Tensor:
    """Kernel K7 on the card. q, k, v may be strided views (the encoder's
    fused QKV); D ∈ {32, 64, 128} with H % (128 / D) == 0. The kernel's
    output carries no gradient, so inputs that need one are refused under
    grad mode: take ``packed_attention``. → (B, S, H, D) contiguous in q's
    dtype."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError(
            "packed_attention_cuda does not track gradients; call packed_attention, "
            "whose autograd Function runs K7 forward"
        )
    b, s, h, d = _check_flash_inputs(q, k, v, lengths, 0)
    _check_packed_head_dim(q)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b * s * h:
        err = _cuda.lib().ts_packed_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lengths.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            ctypes.c_float(1.0 / math.sqrt(d)), _cuda.stream_handle(q.device),
        )
        _cuda.check(err, "packed attention kernel")
        packed_attention_cuda.launches += 1
    return out


packed_attention_cuda.launches = 0


class PackedAttentionFunction(torch.autograd.Function):
    """Packed attention with its backward (the JAX package's ``custom_vjp``
    ``_packed_core``): the forward runs K7 (its plain version on a CPU
    tensor) and saves q, k, v and the mask; the backward is autograd of
    ``attention_reference`` with that mask, recomputed — the reference's
    backward is XLA's, not a kernel."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, mask):
        fwd = packed_attention_plain if q.device.type == "cpu" else packed_attention_cuda
        ctx.save_for_backward(q, k, v, mask)
        return fwd(q, k, v, lengths)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = attention_reference(*leaves, mask)
            dq, dk, dv = torch.autograd.grad(out, leaves, do)
        return dq, dk, dv, None, None


def packed_attention(
    q: torch.Tensor,  # (B, S, H, D), D | 128, H % (128 / D) == 0
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (B, S); only Σ mask per row is read
    head_dim: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention over per-row key lengths (the JAX package's
    ``packed_attention``): len[b] = Σ mask[b], and key j is valid iff j <
    len[b] — a mask that is not a prefix gives another answer than
    ``attention_reference``, as in the reference. K7 on a CUDA tensor, its
    plain version on a CPU tensor; with grad enabled and an input that
    needs a gradient, through ``PackedAttentionFunction``. → (B, S, H, D)."""
    _check_packed_head_dim(q, head_dim)
    b, s = q.shape[:2]
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.int32, device=q.device)
    lengths = mask.sum(dim=1, dtype=torch.int32)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return PackedAttentionFunction.apply(q, k, v, lengths, mask)
    fn = packed_attention_plain if q.device.type == "cpu" else packed_attention_cuda
    return fn(q, k, v, lengths)


def auto_impl(
    seq_len: int,
    on_cuda: bool,
    head_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> str:
    """The JAX package's ``impl="auto"`` rule (``ops/attention.py:863-870``):
    flash on the accelerator (here: a CUDA tensor) when there is no head
    mask and no segment ids, S % 128 == 0 and S ≥ 4096; otherwise the
    reference. It never picks the packed kernel."""
    use_flash = (on_cuda and head_mask is None and segment_ids is None
                 and seq_len % 128 == 0 and seq_len >= 4096)
    return "flash" if use_flash else "reference"


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",        # auto | flash | packed | reference
    window: int = 0,
    window_global_cls: bool = False,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S): packed rows
) -> torch.Tensor:
    """Dispatching MHA: ``auto`` resolves through :func:`auto_impl`, so on
    the CPU it runs the reference, as the JAX package does there; only an
    explicit ``impl="flash"`` / ``"packed"`` runs K5's / K7's plain version
    on the CPU. Segment ids go with auto or the reference only; flash and
    packed refuse a head mask, packed a window or the global CLS."""
    if segment_ids is not None and impl not in ("auto", "reference"):
        raise ValueError(
            "segment_ids (packed batches) is only supported by the reference/auto attention path"
        )
    if impl == "auto":
        impl = auto_impl(q.shape[1], q.is_cuda, head_mask, segment_ids)
    if impl == "packed":
        if head_mask is not None:
            raise ValueError("packed attention does not support head_mask")
        if window or window_global_cls:
            raise ValueError(
                "packed attention does not support sliding windows; use impl='flash' "
                "or 'reference' for windowed models"
            )
        return packed_attention(q, k, v, mask, head_dim=q.shape[3])
    if impl == "flash":
        if head_mask is not None:
            raise ValueError("flash attention does not support head_mask")
        return flash_attention(q, k, v, mask, window=window, global_cls=window_global_cls)
    if impl == "reference":
        return attention_reference(
            q, k, v, mask, head_mask, window=window, global_cls=window_global_cls,
            segment_ids=segment_ids,
        )
    raise ValueError(f"attention impl {impl!r}: the port has auto, flash, packed and reference")
