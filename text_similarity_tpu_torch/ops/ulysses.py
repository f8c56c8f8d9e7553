"""Ulysses context parallelism: exact attention over a sequence sharded
along the mesh ``seq`` axis by two all-to-all exchanges (port of
``text_similarity_tpu.ops.ulysses``).

Each position holds a (B, S/n, H, D) block of the sequence (lists, one
piece a position, as in ``ops.ring_attention``). One tiled all-to-all
(``core.mesh.all_to_all``) re-shards sequence → heads, (B, S/n, H, D) →
(B, S, H/n, D); the key mask is all-gathered whole; every position runs
plain full-sequence softmax attention (f32) over its head slice; a second
all-to-all restores the sequence sharding. Two exchanges where the ring
takes n − 1 rotations; the head count must divide over the axis.
Masked query rows get the ordinary average over the valid keys (the
poolers ignore them); a row with no valid key outputs 0, as in the ring.

Plain torch ops, as the reference's XLA einsums; autograd differentiates
it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.mesh import all_gather, all_to_all
from .ring_attention import NEG_INF, _scale


def ulysses_attention(
    q: Sequence[torch.Tensor],     # a position's (B, S_local, H, D)
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],  # a position's (B, S_local), 1 = valid
) -> List[torch.Tensor]:
    """→ each position's (B, S_local, H, D) output, in q's dtype."""
    n = len(q)
    h = q[0].shape[2]
    if h % n:
        raise ValueError(f"num_heads {h} must divide over axis ({n})")
    # split the heads over the positions, gather the whole sequence
    qh, kh, vh = (all_to_all(list(t), split_axis=2, concat_axis=1) for t in (q, k, v))
    m_all = all_gather(list(mask), dim=1, tiled=True)          # a position's (B, S)
    outs = []
    for qi, ki, vi, mi in zip(qh, kh, vh, m_all):
        s = torch.einsum("bqhd,bkhd->bhqk", qi.float() * _scale(qi.shape[-1], qi.device),
                         ki.float())
        s = torch.where(mi[:, None, None, :].bool(), s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = torch.where(s > 0.5 * NEG_INF, p, torch.zeros_like(p))   # no valid key → 0
        l = p.sum(dim=-1, keepdim=True)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p / l.clamp_min(1e-30), vi.float()))
    # restore the sequence sharding: (B, S, H/n, D) → (B, S/n, H, D)
    outs = all_to_all(outs, split_axis=1, concat_axis=2)
    return [o.to(x.dtype) for o, x in zip(outs, q)]
