"""Greedy sequence packing (the port's copy of
``text_similarity_tpu.data.packing``): many short sequences per fixed-width
row.

Instead of padding a 20-token sentence to a 64-wide bucket, first-fit-
decreasing packs several sentences into one row; the encoder separates them
with a block-diagonal attention mask (``ops.attention.attention_reference``
``segment_ids``), per-segment positions restarting at 0 and segment-wise
pooling (``models.pooling.segment_mean_pool``).

Everything here is host-side layout. The placement is a segment tree of
free space, in C (``native.ffd_place_native``) from ``NATIVE_MIN`` sequences
up and in Python below (the ctypes call costs more than a tiny placement);
both place every sequence alike.
"""

from __future__ import annotations

from itertools import chain
from typing import Dict, Optional, Sequence

import numpy as np

from ..native import ffd_place_native

# from this many sequences up the placement runs in C (the reference's cut)
NATIVE_MIN = 512


def _ffd_place(lens: np.ndarray, width: int):
    return ffd_place_native(lens, width) if len(lens) >= NATIVE_MIN else _ffd_place_py(lens, width)


def _ffd_place_py(lens: np.ndarray, width: int):
    """First-fit placement of lengths in the given order: each goes to the
    lowest-indexed row with free space ≥ its length, else to a new row, via
    a segment tree of free space, O(n log n). → (rows, row, slot, offset)
    with one (row, slot within the row, token offset) per length."""
    n = len(lens)
    if n == 0:
        return 0, np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.int32)
    P = 1
    while P < n:
        P <<= 1
    tree = [width] * (2 * P)      # rows not yet opened hold full free space
    nseg = [0] * n
    out_row = np.empty(n, np.int32)
    out_slot = np.empty(n, np.int32)
    out_off = np.empty(n, np.int32)
    max_row = -1
    for i in range(n):
        L = min(max(int(lens[i]), 0), width)
        node = 1
        while node < P:                 # leftmost leaf with space >= L
            node <<= 1
            if tree[node] < L:
                node |= 1
        row = node - P
        free = tree[node]
        out_row[i] = row
        out_slot[i] = nseg[row]
        out_off[i] = width - free
        nseg[row] += 1
        tree[node] = free - L
        node >>= 1
        while node >= 1:
            tree[node] = max(tree[2 * node], tree[2 * node + 1])
            node >>= 1
        if row > max_row:
            max_row = row
    return max_row + 1, out_row, out_slot, out_off


def _empty_layout(width: int, pad_id: int, with_types: bool) -> Dict[str, np.ndarray]:
    out = {
        "ids": np.full((0, width), pad_id, np.int32),
        "segments": np.zeros((0, width), np.int32),
        "positions": np.zeros((0, width), np.int32),
        "owners": np.full((0, 1), -1, np.int32),
        "n_segments": np.zeros((0,), np.int32),
    }
    if with_types:
        out["type_ids"] = np.zeros((0, width), np.int32)
    return out


def pack_sequences(
    row_ids: Sequence[Sequence[int]],
    width: int,
    pad_id: int = 0,
    row_types: Optional[Sequence[Sequence[int]]] = None,
) -> Dict[str, np.ndarray]:
    """First-fit-decreasing packing of token-id sequences into rows of
    ``width`` tokens (sequences longer than ``width`` are truncated).

    → a dict of arrays:
      ids        (R, width) int32 — packed token ids (pad_id elsewhere)
      segments   (R, width) int32 — 1-based segment tag per token, 0 = pad
      positions  (R, width) int32 — positions restarting at 0 per segment
      owners     (R, max_per_row) int32 — input index of each segment of
                 the row, −1 = empty slot
      n_segments (R,) int32
      type_ids   (R, width) int32 — only with ``row_types``: per-token
                 token-type ids packed alongside
    """
    n = len(row_ids)
    lens = np.fromiter((min(len(r), width) for r in row_ids), np.int64, count=n)
    order = np.argsort(-lens, kind="stable")   # longest first
    sl = lens[order].astype(np.int32)
    r, row, slot, off = _ffd_place(sl, width)
    if n == 0:
        return _empty_layout(width, pad_id, row_types is not None)

    # flat scatter positions for every token
    total = int(sl.sum())
    starts = np.zeros(n, np.int64)
    np.cumsum(sl[:-1], out=starts[1:])
    sl64 = sl.astype(np.int64)
    within = (np.arange(total, dtype=np.int64) - np.repeat(starts, sl64)).astype(np.int32)
    flat_pos = np.repeat(row.astype(np.int64) * width + off, sl64) + within

    def gather(rows):
        return np.fromiter(
            chain.from_iterable(rows[si][:width] if len(rows[si]) > width else rows[si]
                                for si in order),
            np.int32, count=total,
        )

    ids = np.full(r * width, pad_id, np.int32)
    ids[flat_pos] = gather(row_ids)
    segs = np.zeros(r * width, np.int32)
    segs[flat_pos] = np.repeat(slot + 1, sl64)
    pos = np.zeros(r * width, np.int32)
    pos[flat_pos] = within
    owners = np.full((r, int(slot.max()) + 1), -1, np.int32)
    owners[row, slot] = order
    out = {
        "ids": ids.reshape(r, width),
        "segments": segs.reshape(r, width),
        "positions": pos.reshape(r, width),
        "owners": owners,
        "n_segments": np.bincount(row, minlength=r).astype(np.int32),
    }
    if row_types is not None:
        types = np.zeros(r * width, np.int32)
        types[flat_pos] = gather(row_types)
        out["type_ids"] = types.reshape(r, width)
    return out


def pack_pair_arrays(
    ids_a: np.ndarray, lens_a: np.ndarray,
    ids_b: np.ndarray, lens_b: np.ndarray,
    width: int,
    cls_id: int, sep_id: int, pad_id: int = 0,
    max_len: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Pair packing straight from padded per-side body arrays: builds the
    [CLS] a [SEP] b [SEP] token and type streams with numpy gathers and
    scatters them into the packed layout — the same arrays as
    ``pack_sequences(rows, width, row_types=types)`` over the ragged pair
    rows of those bodies.

    ``ids_a`` / ``ids_b`` hold body tokens (no CLS/SEP) left-aligned, valid
    through ``lens_a`` / ``lens_b``. Longest-first truncation to the pair
    budget ``(max_len or width) − 3`` is applied here in closed form (pop
    from the longer side, ties from a) and reads only tokens below the final
    lengths."""
    budget = (max_len or width) - 3
    half = budget // 2
    la = np.minimum(np.asarray(lens_a, np.int64), budget)
    lb = np.minimum(np.asarray(lens_b, np.int64), budget)
    n = len(la)
    over = la + lb > budget
    keep_b = over & (lb <= half)
    keep_a = over & ~keep_b & (la <= half)
    both = over & ~keep_b & ~keep_a
    la = np.where(keep_b, budget - lb, np.where(both, half, la))
    lb = np.where(keep_a, budget - la, np.where(both, budget - half, lb))

    L = (la + lb + 3).astype(np.int64)
    order = np.argsort(-L, kind="stable")
    sl = L[order].astype(np.int32)
    r, row, slot, off = _ffd_place(sl, width)
    if n == 0:
        return _empty_layout(width, pad_id, True)

    total = int(sl.sum())
    starts = np.zeros(n, np.int64)
    np.cumsum(sl[:-1], out=starts[1:])
    within = np.arange(total, dtype=np.int32)
    within -= np.repeat(starts.astype(np.int32), sl)
    flat_pos = np.repeat(row * width + off, sl).astype(np.int64) + within

    seq = np.repeat(order.astype(np.int32), sl)   # original pair index
    laq = np.repeat(la[order].astype(np.int32), sl)
    is_first = np.zeros(total, bool)
    is_first[starts] = True
    is_last = np.zeros(total, bool)
    is_last[starts + sl - 1] = True
    is_sep1 = within == laq + 1
    in_a = (within >= 1) & (within <= laq)
    in_b = ~(is_first | is_last | is_sep1 | in_a)
    ia = np.ascontiguousarray(ids_a, np.int32)
    ib = np.ascontiguousarray(ids_b, np.int32)
    tok = np.empty(total, np.int32)
    tok[is_first] = cls_id
    tok[is_last] = sep_id
    tok[is_sep1] = sep_id
    sel = in_a.nonzero()[0]
    tok[sel] = ia[seq[sel], within[sel] - 1]
    sel = in_b.nonzero()[0]
    tok[sel] = ib[seq[sel], within[sel] - laq[sel] - 2]
    typ = (within >= laq + 2).astype(np.int32)

    ids = np.full(r * width, pad_id, np.int32)
    ids[flat_pos] = tok
    segs = np.zeros(r * width, np.int32)
    segs[flat_pos] = np.repeat(slot + 1, sl)
    pos = np.zeros(r * width, np.int32)
    pos[flat_pos] = within
    types = np.zeros(r * width, np.int32)
    types[flat_pos] = typ
    owners = np.full((r, int(slot.max()) + 1), -1, np.int32)
    owners[row, slot] = order
    return {
        "ids": ids.reshape(r, width),
        "segments": segs.reshape(r, width),
        "positions": pos.reshape(r, width),
        "type_ids": types.reshape(r, width),
        "owners": owners,
        "n_segments": np.bincount(row, minlength=r).astype(np.int32),
    }


def packing_efficiency(packed: Dict[str, np.ndarray]) -> float:
    """Fraction of row slots holding real tokens (1.0 = zero padding)."""
    segs = packed["segments"]
    return float((segs > 0).sum() / segs.size)
