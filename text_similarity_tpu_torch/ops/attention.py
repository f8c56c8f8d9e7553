"""Exact softmax attention in plain tensor code.

Port of ``text_similarity_tpu.ops.attention.attention_reference``, the path
the JAX encoder takes at every serving length (its flash kernel engages only
on a TPU at S ≥ 4096; porting that kernel is later work). Scores are
computed with f32 accumulation, masked additively with −1e9, materialised
in bf16 when the inputs are bf16, and normalised by an f32 softmax.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9  # large finite negative: bf16-safe masking


def attention_reference(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,  # (B, S, H, D)
    mask: Optional[torch.Tensor] = None,  # (B, S) 1 = keep
) -> torch.Tensor:
    d = q.shape[-1]
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
    if q.dtype == torch.bfloat16:
        # scores materialised in bf16 (the reference's AMP analogue); the
        # max, exp and sum still run in f32
        l16 = logits.to(torch.bfloat16).float()
        m = l16.amax(dim=-1, keepdim=True)
        p = torch.exp(l16 - m)
        probs = p / p.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), vt.float())
    return out.transpose(1, 2).to(q.dtype)
