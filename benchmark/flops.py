"""The benchmark's yardstick of work: the table of peaks, and the
operations and bytes that the inputs need, whatever implements them.

A roofline's bound is max(bytes / peak bytes/s, operations / peak
operations/s): each input byte read once, each output byte written once.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_BF16 = 989e12        # FLOP/s, bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12      # HBM3 bytes/s


def bound_s(n_bytes: float, ops: float, peak_ops: float = PEAK_BF16) -> float:
    return max(n_bytes / PEAK_BYTES, ops / peak_ops)


# ---------------------------------------------------------------------------
# Attention pairs
# ---------------------------------------------------------------------------

def band_pairs(lens: Iterable[int], window: int, global_cls: bool) -> int:
    """(query, key) pairs one head's attention needs: valid rows i < n
    against valid keys j < n with |i − j| ≤ window (every valid key at
    window 0), plus the CLS row and column with a global CLS."""
    total = 0
    for n in lens:
        n = int(n)
        if n <= 0:
            continue
        if window <= 0:
            total += n * n
            continue
        i = np.arange(n)
        cnt = np.minimum(i + window, n - 1) - np.maximum(i - window, 0) + 1
        if global_cls:
            cnt[0] = n
            cnt[1:] += i[1:] > window
        total += int(cnt.sum())
    return total


def flash_fwd(batch: int, width: int, heads: int, hd: int, lens: Sequence[int], window: int,
              global_cls: bool):
    """K5's work: q, k, v read and o written once (bf16); 4·hd operations
    a kept pair and head (QKᵀ and PV). → (bytes, operations)."""
    n_bytes = 4 * batch * width * heads * hd * 2
    ops = 4.0 * hd * heads * band_pairs(lens, window, global_cls)
    return n_bytes, ops


def flash_bwd(batch: int, width: int, heads: int, hd: int, lens: Sequence[int], window: int,
              global_cls: bool):
    """K6's work: q, k, v, o, do read and dq, dk, dv written once (bf16);
    10·hd operations a kept pair and head (the recomputed QKᵀ, dP = dO·Vᵀ,
    dV, dQ, dK). A padded row's output gradient is zero, so it needs no
    work. → (bytes, operations)."""
    n_bytes = 8 * batch * width * heads * hd * 2
    ops = 10.0 * hd * heads * band_pairs(lens, window, global_cls)
    return n_bytes, ops


# ---------------------------------------------------------------------------
# Encoder FLOPs (useful work of a forward)
# ---------------------------------------------------------------------------

def encoder_flops(non_emb_params: int, lens: Sequence[int], layers: int, hidden: int,
                  window: int = 0, global_cls: bool = False) -> float:
    """2 · (non-embedding parameters) · (real tokens) + the attention over
    the real pairs (4·H operations a pair and layer): a forward's useful
    operations."""
    tokens = float(np.sum(lens))
    return 2.0 * non_emb_params * tokens + 4.0 * hidden * layers * band_pairs(
        lens, window, global_cls)


# ---------------------------------------------------------------------------
# IVF scan (K1): the probe plan and its bytes
# ---------------------------------------------------------------------------

def union_size(probes: int, union_factor: int, n_slabs: int) -> int:
    """Slabs a query block probes besides the overflow: ``probes`` ×
    ``union_factor`` rounded up to a multiple of 8, at most every slab."""
    return min(-(-probes * union_factor // 8) * 8, n_slabs)


def _plan(queries, centroids, num_base: int, c_tot: int, block_q: int, union: int):
    import torch

    q = queries.float()
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    b, d = q.shape
    pad_b = -(-b // block_q) * block_q
    if pad_b != b:
        q = torch.cat([q, q.new_zeros((pad_b - b, d))])
    scores = q @ centroids.float().T
    if pad_b != b:
        scores[b:] = -1e9
    order = torch.argsort(torch.argmax(scores, dim=1), stable=True)
    block = scores[order].reshape(pad_b // block_q, block_q, -1).amax(dim=1)
    probes = torch.argsort(block, dim=1, descending=True, stable=True)[:, :union]
    if c_tot > num_base:
        over = torch.arange(num_base, c_tot, device=q.device).expand(probes.shape[0], -1)
        probes = torch.cat([probes, over], dim=1)
    return probes, order


def plan_probes(queries, centroids, num_base: int, c_tot: int, block_q: int, union: int):
    """The probe plan of a query batch: queries normalised, padded to a
    multiple of ``block_q`` (padding scores −1e9), sorted by their nearest
    centroid; each block of ``block_q`` probes the ``union`` slabs of
    highest block-max score, plus every overflow slab → (n_blocks, U)
    int64 slab ids."""
    return _plan(queries, centroids, num_base, c_tot, block_q, union)[0]


def probes_per_query(queries, centroids, num_base: int, c_tot: int, block_q: int,
                     union: int):
    """The same plan, given per query: row j is the slab list of the block
    that query j is sorted into → (B, U) int64 slab ids."""
    import torch

    probes, order = _plan(queries, centroids, num_base, c_tot, block_q, union)
    b = queries.shape[0]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    return probes[pos[:b] // block_q]


def ivf_scan(probes, valid_per_slab, mc: int, d: int, row_bytes: int, n_q: int, k: int,
             block_q: int):
    """The scan's work: every valid row of each probed slab read once
    (``row_bytes`` each) with the slab's ids (4 bytes a slot), the queries
    (f32) and the top-k (f32 score + int32 id) once; 2·D operations a
    query and probed valid row. → (bytes, operations)."""
    import torch

    slabs = torch.unique(probes)
    n_bytes = (int(valid_per_slab[slabs].sum()) * row_bytes + int(slabs.numel()) * mc * 4
               + n_q * d * 4 + n_q * k * 8)
    ops = 2.0 * block_q * d * float(valid_per_slab[probes].sum())
    return n_bytes, ops
