"""Ring attention: exact attention over a sequence sharded along the mesh
``seq`` axis (port of ``text_similarity_tpu.ops.ring_attention``).

Each position of the axis holds one block of the sequence: its (B, S/n, H,
D) queries, keys and values and its (B, S/n) key mask, each a list with one
piece a position, on the position's device. The key / value / mask blocks
travel around the ring (``core.mesh.ppermute``: position i sends to i + 1),
and every position folds one block a step into an online-softmax
accumulator in f32, in the reference's order: at step s position i holds
block (i − s) mod n. Non-causal: every query attends to every valid key.
``NEG_INF`` is finite (bf16-safe), so a block whose keys are all masked
would give p = exp(0) = 1: p is zeroed where the score is masked, and a
row with no valid key at all outputs 0 (``l == 0``).

Plain torch ops (``torch.einsum``): the reference computes the ring with
XLA einsums too, outside any Pallas kernel. Autograd differentiates it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.mesh import ppermute

NEG_INF = -1e9


def _scale(d: int, device) -> torch.Tensor:
    # 1 / sqrt(d) in f32, as the reference computes it
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=device))


def ring_attention(
    q: Sequence[torch.Tensor],     # a position's (B, S_local, H, D) queries
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],  # a position's (B, S_local), 1 = valid key
) -> List[torch.Tensor]:
    """→ each position's (B, S_local, H, D) output, in q's dtype."""
    n = len(q)
    perm = [(i, (i + 1) % n) for i in range(n)]
    q32 = [x.float() * _scale(x.shape[-1], x.device) for x in q]
    state = []
    for x in q:
        b, s_loc, h, d = x.shape
        state.append((
            torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=x.device),
            torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=x.device),
            torch.zeros((b, h, s_loc), dtype=torch.float32, device=x.device),
        ))
    k_cur, v_cur, m_cur = list(k), list(v), list(mask)
    for step in range(n):
        state = [_fold(st, qi, kb, vb, mb)
                 for st, qi, kb, vb, mb in zip(state, q32, k_cur, v_cur, m_cur)]
        if step != n - 1:
            k_cur, v_cur, m_cur = (ppermute(t, perm) for t in (k_cur, v_cur, m_cur))
    out = []
    for (acc, _, l_run), x in zip(state, q):
        l_safe = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
        out.append((acc / l_safe.transpose(1, 2)[..., None]).to(x.dtype))
    return out


def _fold(state, q32, k_blk, v_blk, m_blk):
    """One key / value block into (acc, running max, running sum)."""
    acc, m_prev, l_prev = state
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float())
    s = torch.where(m_blk[:, None, None, :].bool(), s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    # a masked score gives p = 0 even where the whole block is masked
    p = torch.where(s > 0.5 * NEG_INF, p, torch.zeros_like(p))
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1)
    upd = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    return acc * alpha.transpose(1, 2)[..., None] + upd, m_new, l_new
