"""Mixture-of-Experts feed-forward with top-k routing (port of
``text_similarity_tpu.ops.moe``).

* ``expert_capacity``: the static slot count an expert, ceil(k·T/E · factor)
  rounded up to a multiple of 8 and clamped to T. T = B·S counts padding, so
  an MoE embedding depends on the batch it is encoded in.
* ``router_topk``: f32 softmax, k greedy rounds of argmax (the first maximum
  wins a tie, as ``jnp.argmax``), a token's slot = the valid tokens before it
  that picked the same expert this round + the slots earlier rounds took;
  the Switch load-balance loss over round 0 and the dropped fraction over
  the valid tokens' assignments.
* ``moe_ffn`` = ``moe_route`` (the router, then one scatter of token ids
  into E·C slots plus a trash slot (overflow and padding; its content is
  undefined on the card and cut) and one gather into (E, C, H)) →
  ``expert_partial`` (the expert GEMMs as batched products of the compute
  dtype accumulated and returned in f32, the activation in f32) + the
  output bias → ``moe_combine`` (the gate-weighted combine in f32). The
  expert-parallel forward (``models.sharded``) routes the whole batch once,
  splits the (E, C, H) buffer over the expert axis and runs
  ``expert_partial`` on each position's experts.
  Quantized experts (``{"q", "s"}`` leaves from ``compress.quantize``) run
  int8 × int8 → int32 expert by expert (``int8_mm``) with per-slot
  activation scales.

The router's logits go through ``f32_matmul``: they decide the argmax picks
and the capacity, so they never take TF32. The expert product's f32
accumulator takes the f32 bias, as the reference's does; the activation's
output and the expert output round to the compute dtype, as there.

While a ``torch.profiler`` session records, the four stages run inside
spans (``utils.profiling.span``) named ``ts.moe.router``, ``ts.moe.dispatch``,
``ts.moe.experts`` and ``ts.moe.combine``, so a profile splits an MoE
forward's device time by stage; without a session no range is opened.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..compress.quantize import _is_q, _jit_scale, _quantize, int8_mm
from ..core.precision import f32_matmul
from ..utils.profiling import span


def _dyn_quant_slots(x: torch.Tensor):
    """Per-slot (last-axis) symmetric int8: (E, C, H) → int8 codes + (E, C,
    1) f32 scales."""
    x32 = x.float()
    s = _jit_scale(torch.amax(torch.abs(x32), dim=-1, keepdim=True))
    return _quantize(x32, s), s


def expert_capacity(
    num_tokens: int, num_experts: int, top_k: int, capacity_factor: float, *, multiple: int = 8
) -> int:
    """ceil(k·T/E · factor), rounded up to ``multiple``, at least
    ``multiple``, at most T."""
    cap = int(math.ceil(num_tokens * top_k * capacity_factor / num_experts))
    cap = max(multiple, ((cap + multiple - 1) // multiple) * multiple)
    return min(cap, num_tokens)


def router_topk(
    logits: torch.Tensor,   # (T, E) router logits
    valid: torch.Tensor,    # (T,) 1 = real token, 0 = padding
    top_k: int,
    capacity: int,
    *,
    normalize_gates: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Greedy top-k expert assignment with a capacity an expert → (choice,
    slot, gate, keep), each (k, T) (int64, int64, f32, bool), the
    load-balance loss (E · Σ_e frac_e · mean_prob_e over round 0; 1 when
    balanced) and the dropped fraction (valid assignments past capacity /
    (k · valid tokens)). Slots go in token order."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    validf = valid.float()
    validi = (valid > 0).int()
    remaining = probs
    base = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    choices, slots, gates, keeps = [], [], [], []
    onehot0 = None
    for _ in range(top_k):
        choice = torch.argmax(remaining, dim=-1)                       # (T,)
        gate = remaining.gather(1, choice[:, None])[:, 0] * validf
        onehot = F.one_hot(choice, e).int()                            # (T, E)
        onehot_valid = onehot * validi[:, None]
        if onehot0 is None:
            onehot0 = onehot_valid
        # earlier valid tokens that picked the same expert this round, plus
        # the slots the earlier rounds took; the running count is a scan
        # along the last axis of the (E, T) transpose, as an outer-axis scan
        # over T is the card's slowest form of it
        before = torch.cumsum(onehot_valid.T.contiguous(), dim=1).T - onehot_valid
        slot = (before.gather(1, choice[:, None])[:, 0] + base[choice]).long()
        keeps.append((slot < capacity) & (validi > 0))
        choices.append(choice)
        slots.append(slot)
        gates.append(gate)
        base = base + onehot_valid.sum(dim=0)
        remaining = remaining * (1 - onehot).float()   # never the same expert twice
    choice, slot = torch.stack(choices), torch.stack(slots)
    gate, keep = torch.stack(gates), torch.stack(keeps)
    if normalize_gates and top_k > 1:
        gate = gate / gate.sum(dim=0, keepdim=True).clamp_min(1e-9)
    gate = gate * keep.float()

    n_valid = validf.sum().clamp_min(1.0)
    frac = onehot0.float().sum(dim=0) / n_valid                        # (E,)
    mean_prob = (probs * validf[:, None]).sum(dim=0) / n_valid         # (E,)
    aux = e * (frac * mean_prob).sum()
    dropped = ((validf[None, :] > 0) & ~keep).float().sum() / (top_k * n_valid)
    return choice, slot, gate, keep, aux, dropped


class _LowPrecisionProduct(torch.autograd.Function):
    """(E, C, K) @ (E, K, N) of one low-precision dtype, the exact products
    summed and returned in f32, as the reference's
    ``preferred_element_type``: ``bmm(out_dtype=f32)`` on the card; the
    CPU's ``bmm`` has no ``out_dtype``, and a bf16 product is exact in f32.
    ``bmm`` has no derivative for ``out_dtype``, so the gradients are
    written here: products in the inputs' dtype of the cotangent rounded to
    it, what autograd of a product in that dtype gives."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.bmm(x, w, out_dtype=torch.float32)
        return torch.bmm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return torch.bmm(g, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), g)


def _expert_gemm(x: torch.Tensor, w) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) → f32: int8 × int8 → int32 expert by expert
    with per-slot activation scales for a quantized ``w``, else one batched
    product of x's dtype accumulated and returned in f32 (a bf16 product is
    never rounded to bf16 before the bias)."""
    if _is_q(w):
        xq, xs = _dyn_quant_slots(x)
        y = torch.stack([int8_mm(xq[i], w["q"][i]) for i in range(xq.shape[0])]).float()
        return y * xs * w["s"].float()
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.bmm(x, w)
    return _LowPrecisionProduct.apply(x, w)


class MoeRoute(NamedTuple):
    """The routing of T tokens into E experts of C slots."""
    xe: torch.Tensor        # (E, C, H) the dispatched tokens (empty slots zero)
    flat: torch.Tensor      # (k, T) each assignment's flat slot, E·C (the trash) if dropped
    gate: torch.Tensor      # (k, T) f32 gates, zero where dropped
    aux: torch.Tensor       # the load-balance loss
    dropped: torch.Tensor   # the dropped fraction


def moe_route(
    x: torch.Tensor, mask: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
    capacity_factor: float,
) -> MoeRoute:
    """Router and dispatch over every token of ``x`` (B, S, H): the capacity
    counts T = B·S and slots go in token order, so a sharded batch is routed
    as a whole (the reference's GSPMD function is the unsharded one)."""
    b, s, h = x.shape
    e = router_w.shape[1]
    if not 1 <= top_k <= e:
        raise ValueError(f"expert_top_k={top_k} must be in [1, E={e}]")
    t = b * s
    cap = expert_capacity(t, e, top_k, capacity_factor)
    xt = x.reshape(t, h)
    with span("ts.moe.router"):
        logits = f32_matmul(xt, router_w)                              # (T, E)
        choice, slot, gate, keep, aux, dropped = router_topk(logits, mask.reshape(t), top_k, cap)

    with span("ts.moe.dispatch"):
        # token ids into E·C slots + the trash slot E·C, one gather
        trash = e * cap
        flat = torch.where(keep, choice * cap + slot, torch.full_like(slot, trash))   # (k, T)
        slot_token = torch.full((trash + 1,), t, dtype=torch.long, device=x.device)
        tok_ids = torch.arange(t, device=x.device)
        for r in range(top_k):
            slot_token.scatter_(0, flat[r], tok_ids)
        xt_pad = torch.cat([xt, xt.new_zeros((1, h))])
        xe = xt_pad[slot_token[:trash]].reshape(e, cap, h)             # (E, C, H)
    return MoeRoute(xe, flat, gate, aux, dropped)


def expert_partial(xe: torch.Tensor, wi, bi: torch.Tensor, wo,
                   activation: Optional[Callable] = None) -> torch.Tensor:
    """The experts of ``xe`` (E, C, H) without the output bias → f32 (E, C,
    H): act(xe·W_in + b_in) in xe's dtype, then ·W_out accumulated in f32.
    A tensor-parallel position passes its slice of the inner width and the
    partial products are summed before ``bo``."""
    if activation is None:
        activation = functools.partial(F.gelu, approximate="tanh")
    hidden = _expert_gemm(xe, wi) + bi[:, None].float()
    hidden = activation(hidden).to(xe.dtype)
    return _expert_gemm(hidden, wo)


def moe_combine(route: MoeRoute, ye: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Each token's k expert outputs (``ye`` (E, C, H)) weighted by its gates
    → (B, S, H) in the dtype of ``like`` (the layer's input)."""
    b, s, h = like.shape
    with span("ts.moe.combine"):
        ye_pad = torch.cat([ye.reshape(-1, h), ye.new_zeros((1, h))])
        y = torch.zeros((b * s, h), dtype=torch.float32, device=like.device)
        for r in range(route.flat.shape[0]):
            y = y + route.gate[r][:, None] * ye_pad[route.flat[r]].float()
    return y.reshape(b, s, h).to(like.dtype)


def moe_ffn(
    x: torch.Tensor,          # (B, S, H) hidden states
    mask: torch.Tensor,       # (B, S) 1 = real token
    router_w: torch.Tensor,   # (H, E)
    wi,                       # (E, H, I) or {"q", "s"}
    bi: torch.Tensor,         # (E, I)
    wo,                       # (E, I, H) or {"q", "s"}
    bo: torch.Tensor,         # (E, H)
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    activation: Optional[Callable] = None,   # default: tanh GELU, as ``jax.nn.gelu``
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse FFN in place of the dense MLP → (output (B, S, H) in x's
    dtype, load-balance loss, dropped fraction). A dropped or padding token
    gets a zero delta (the residual carries it)."""
    route = moe_route(x, mask, router_w, top_k=top_k, capacity_factor=capacity_factor)
    with span("ts.moe.experts"):
        ye = (expert_partial(route.xe, wi, bi, wo, activation)
              + bo[:, None].float()).to(route.xe.dtype)
    return moe_combine(route, ye, x), route.aux, route.dropped
