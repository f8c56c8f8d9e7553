"""The IVF scan's semantics in plain tensor code, and its other kernels:
the packed fold (K9), the copy-ring scan (K10), several probes a step
(K11a) and the idless scan of the sentinel layout (K11b).

Port of the scan modes of ``text_similarity_tpu.index.ivf``. Every scan
takes queries sorted and padded to ``block_q`` blocks (B, D) f32, a probe
list (B/block_q, U) int32 shared by the queries of a block, slabs (C_tot,
Mc, D) of f32, bf16 or int8 (D+1 wide in the sentinel layout) and their
ids (C_tot, Mc) int32 (-1 = empty). Queries round to bf16 before the dot
when the slabs are bf16 or int8; int8 scores are × the slot's scale after
the dot; a probe id outside [0, C_tot) scans nothing.

- ``scan_plain``: the plain block-union scan behind every ``*_reference``:
  exact (top-k over every probed slot), the deferred lane-class fold
  (slot p of probe u enters class p mod w, which keeps its top-S; a later
  entry ranks below an earlier one of equal score), per probe, or the raw
  accumulator. Top-k order is (score desc, id asc), missing results
  (−inf, −1).
- K9 ``ivf_scan_packed``: the fold over one int32 packet a candidate
  (``_pack_candidates``) → (B, k) packets; ``_unpack_candidates`` turns
  them into (score, id). On the wgmma tile (bf16 slabs) the kernel builds
  each packet from its f32 accumulator and skips empty tiles, as K1 does.
- K10 ``ivf_scan_dma``: the deferred fold at full width Mc with S slots and
  the in-kernel merge; the card runs K1 at ``approx_width=Mc`` (its wgmma
  tile streams the slabs through a ring at most ``n_buffers`` deep), so
  the result equals K1's there.
- K11a ``ivf_scan_multiprobe``: P probes a step, full-width single-slot
  fold; the probe list is padded to a multiple of P by repeating its last
  probe (a repeated probe changes nothing). The card runs K1 at
  ``approx_width=Mc`` with one slot over the padded list, so the result
  equals K1's there.
- K11b ``ivf_scan_idless``: the single-slot deferred fold over D+1 slabs
  without ids: slot id = probe · Mc + position, no slot masked (the
  sentinel column scores dead slots 0) → flat slot ids. On the wgmma tile
  the kernel skips the 64-row tiles whose rows are all zero
  (``zero_tile_map``): they would score exactly 0, which it folds instead.

Each ``*_cuda`` wrapper launches its kernel (``csrc/ivf_modes.cu``,
``csrc/ivf_scan.cu``, ``csrc/ivf_tile.cu``) on CUDA tensors and counts its
launches; each dispatcher takes the plain version only for CPU slabs.
Above ``MAX_K`` the scans' selection stops; ``ivf_scan_large_k_cuda``
takes their scores from the tile's emit_acc and selects with
``csrc/topk_select.cu``; K9's packets are built from those scores by
``ts_ivf_pack_classes`` (``csrc/ivf_modes.cu``) and selected on int keys.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import _cuda
from ..ops.topk import _SCORES_BYTES, MAX_K, select_topk, topk_select_cuda

MAX_D = 1025                    # 1024 wide, +1 for the sentinel column
PACK_SCORE_BITS = 14            # fixed-point cosine resolution ~1.2e-4
PACK_U_BITS = 6                 # probe index within the block union (≤ 64)
PACK_POS_BITS = 11              # row position within the slab (Mc ≤ 2048)
PACK_SCALE = (1 << PACK_SCORE_BITS) / 2.0 - 0.25   # (s+1)·scale ≤ 2^14 − 1

_NEG = float("-inf")
_MAP_CHUNK = 1 << 26            # slab elements a step of zero_tile_map reduces


def scan_width(mc: int, approx_width: int) -> int:
    """The fold width a requested ``approx_width`` gives at slab width Mc
    (0 = the exact merge): clamped to Mc, and Mc when it does not divide."""
    if not approx_width:
        return 0
    w = min(approx_width, mc)
    return mc if mc % w else w


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _dot_queries(q: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return q.float() if data.dtype == torch.float32 else q.to(torch.bfloat16).float()


def _probe_scores(qb, slabs, data, ids, scales):
    """Scores of a block's queries against its probed slabs → (s (bq, U,
    Mc) f32, slot ids (U, Mc)). ``ids=None`` is the idless scan: flat slot
    ids, no slot masked; otherwise slots with id < 0 score −inf. Probes
    outside [0, C_tot) have no live slot."""
    c_tot, mc, _ = data.shape
    valid = (slabs >= 0) & (slabs < c_tot)
    safe = torch.where(valid, slabs, torch.zeros_like(slabs))
    s = torch.einsum("qd,umd->qum", qb, data[safe].float())
    if scales is not None:
        s = s * scales[safe][None]
    if ids is None:
        cid = safe[:, None] * mc + torch.arange(mc, device=qb.device)[None]
        cid = torch.where(valid[:, None], cid, -1).to(torch.int32)
        return torch.where(valid[None, :, None], s, _NEG), cid
    cid = torch.where(valid[:, None], ids[safe], -1)
    return torch.where(cid[None] >= 0, s, _NEG), cid


def _fold(s, cid, w: int, slots: int):
    """The lane-class fold of (bq, U, Mc) scores: insertion t of class c is
    slot (u, p) with p mod w = c, in (u, p) order; each class keeps its
    top-``slots`` (a stable sort: the earlier of equal scores first) →
    (acc_s, acc_i) (bq, slots, w); empty entries (−inf, −1)."""
    bq = s.shape[0]
    t = s.shape[1] * s.shape[2] // w
    s = s.reshape(bq, t, w)
    ci = cid.reshape(1, t, w).expand(bq, t, w)
    order = torch.argsort(s, dim=1, descending=True, stable=True)[:, :slots]
    acc_s, acc_i = torch.gather(s, 1, order), torch.gather(ci, 1, order)
    if t < slots:
        acc_s = torch.cat([acc_s, s.new_full((bq, slots - t, w), _NEG)], dim=1)
        acc_i = torch.cat([acc_i, acc_i.new_full((bq, slots - t, w), -1)], dim=1)
    return acc_s, torch.where(acc_s == _NEG, -1, acc_i).to(torch.int32)


def _select(cand_s, cand_i, k: int):
    """Top-k by (score desc, id asc) of (bq, n) candidates; −inf entries
    carry id −1; fewer than k candidates pad with (−inf, −1)."""
    cand_i = torch.where(cand_s == _NEG, -1, cand_i).to(torch.int32)
    if cand_s.shape[1] < k:
        pad = k - cand_s.shape[1]
        cand_s = torch.cat([cand_s, cand_s.new_full((cand_s.shape[0], pad), _NEG)], dim=1)
        cand_i = torch.cat([cand_i, cand_i.new_full((cand_i.shape[0], pad), -1)], dim=1)
    return select_topk(cand_s, cand_i, k)


def scan_plain(
    q: torch.Tensor, probe_list: torch.Tensor, data: torch.Tensor,
    ids: Optional[torch.Tensor], k: int, block_q: int, width: int = 0,
    slots: int = 1, scales: Optional[torch.Tensor] = None,
    per_probe: bool = False, emit_acc: bool = False,
):
    """The block-union scan in plain tensor code (``width`` = the fold
    width, 0 = exact). → (B, k) scores and ids; ``per_probe``: (U, B, k),
    each probe's exact top-k; ``emit_acc``: the (B, slots·width)
    accumulator, slot s at columns s·width … s·width + width − 1."""
    b = q.shape[0]
    n_blocks, u = probe_list.shape
    qd = _dot_queries(q, data)
    if per_probe:
        shape = (u, b, k)
    elif emit_acc:
        shape = (b, slots * width)
    else:
        shape = (b, k)
    out_s = torch.empty(shape, dtype=torch.float32, device=q.device)
    out_i = torch.empty(shape, dtype=torch.int32, device=q.device)
    for blk in range(n_blocks):
        rows = slice(blk * block_q, (blk + 1) * block_q)
        s, cid = _probe_scores(qd[rows], probe_list[blk].long(), data, ids, scales)
        if per_probe:
            for j in range(u):
                out_s[j, rows], out_i[j, rows] = _select(s[:, j], cid[j][None].expand_as(s[:, j]), k)
            continue
        if width:
            acc_s, acc_i = _fold(s, cid, width, slots)
            cand_s, cand_i = acc_s.reshape(s.shape[0], -1), acc_i.reshape(s.shape[0], -1)
            if emit_acc:
                out_s[rows], out_i[rows] = cand_s, cand_i
                continue
        else:
            cand_s = s.reshape(s.shape[0], -1)
            cand_i = cid.reshape(1, -1).expand_as(cand_s)
        out_s[rows], out_i[rows] = _select(cand_s, cand_i, k)
    return out_s, out_i


def _pack_candidates(s, u, off, block_q: int, width: int):
    """(score, probe u, position off + lane) → one int32 packet:
    [30:17] = score14, [16:11] = u, [10:0] = pos, as the reference packs
    them (score14 = clamp((s + 1) · PACK_SCALE, 0, 2^14 − 1), truncated)."""
    s14 = torch.clamp((s + 1.0) * PACK_SCALE, 0.0, float((1 << PACK_SCORE_BITS) - 1))
    s14 = s14.to(torch.int32)
    pos = off + torch.arange(width, dtype=torch.int32, device=s.device).expand(block_q, width)
    return (s14 << (PACK_U_BITS + PACK_POS_BITS)) | (u << PACK_POS_BITS) | pos


def _unpack_candidates(out_p, probe_list, ids_padded, block_q: int):
    """(B, k) packets → (scores f32, corpus ids int32); packet 0 is
    (−inf, −1)."""
    b = out_p.shape[0]
    pos = out_p & ((1 << PACK_POS_BITS) - 1)
    u = (out_p >> PACK_POS_BITS) & ((1 << PACK_U_BITS) - 1)
    s14 = out_p >> (PACK_U_BITS + PACK_POS_BITS)
    scores = s14.float() / PACK_SCALE - 1.0
    block = torch.arange(b, device=out_p.device)[:, None] // block_q
    slab = probe_list.long()[block, u.long()]
    ids = ids_padded[slab, pos.long()]
    empty = out_p == 0
    return torch.where(empty, _NEG, scores), torch.where(empty, -1, ids).to(torch.int32)


def _packed_width(u: int, mc: int, k: int, approx_width: int, acc_slots: int) -> int:
    if u > (1 << PACK_U_BITS):
        raise ValueError("packed fold needs a probe union <= 64")
    if mc > (1 << PACK_POS_BITS):
        raise ValueError("packed fold needs Mc <= 2048")
    w = scan_width(mc, approx_width) or mc
    if k > acc_slots * w:
        raise ValueError("k exceeds acc_slots * approx_width")
    if acc_slots > 1 and w % 128:
        raise ValueError("acc_slots > 1 needs a 128-aligned width")
    return w


def ivf_scan_packed_reference(
    q, probe_list, data, ids, k: int, block_q: int, approx_width: int = 0,
    acc_slots: int = 1,
) -> torch.Tensor:
    """Plain version of K9: every probed slot becomes a packet (dead slots
    0), lane class p mod w keeps its ``acc_slots`` largest packets, the
    result is the k largest packets of the accumulator (packets are unique,
    so no tie rule is needed; missing results are 0) → (B, k) int32."""
    n_blocks, u = probe_list.shape
    mc = data.shape[1]
    w = _packed_width(u, mc, k, approx_width, acc_slots)
    qd = _dot_queries(q, data)
    out = torch.empty((q.shape[0], k), dtype=torch.int32, device=q.device)
    probe_u = torch.arange(u, dtype=torch.int32, device=q.device)[None, :, None]
    for blk in range(n_blocks):
        rows = slice(blk * block_q, (blk + 1) * block_q)
        s, cid = _probe_scores(qd[rows], probe_list[blk].long(), data, ids, None)
        bq = s.shape[0]
        p = _pack_candidates(s.reshape(bq * u, mc), 0, 0, bq * u, mc).reshape(bq, u, mc)
        p = torch.where(cid[None] >= 0, p | (probe_u << PACK_POS_BITS), 0)
        p = p.reshape(bq, u * mc // w, w)
        acc = torch.sort(p, dim=1, descending=True).values[:, :acc_slots]
        if acc.shape[1] < acc_slots:
            acc = torch.cat([acc, acc.new_zeros((bq, acc_slots - acc.shape[1], w))], dim=1)
        out[rows] = torch.sort(acc.reshape(bq, -1), dim=1, descending=True).values[:, :k]
    return out


def _check_dma(k: int, mc: int, acc_slots: int, n_buffers: int) -> None:
    if not 2 <= n_buffers <= 4:
        raise ValueError(f"dma_buffers={n_buffers} must be in [2, 4]")
    if k > acc_slots * mc:
        raise ValueError("k exceeds acc_slots * Mc")
    if acc_slots > 1 and mc % 128:
        raise ValueError("acc_slots > 1 needs a 128-aligned Mc")


def ivf_scan_dma_reference(
    q, probe_list, data, ids, k: int, block_q: int, acc_slots: int = 1,
    n_buffers: int = 2,
):
    """Plain version of K10: the deferred fold at width Mc with
    ``acc_slots`` slots and the k-round merge (``n_buffers`` is the
    kernel's copy depth and changes nothing here)."""
    mc = data.shape[1]
    _check_dma(k, mc, acc_slots, n_buffers)
    return scan_plain(q, probe_list, data, ids, k, block_q, mc, acc_slots)


def pad_probes(probe_list: torch.Tensor, per_step: int) -> torch.Tensor:
    """Pad the probe list to a multiple of ``per_step`` by repeating its
    last probe (rescanning a slab is a no-op for the strict-> fold)."""
    u = probe_list.shape[1]
    if u % per_step == 0:
        return probe_list
    pad = per_step - u % per_step
    return torch.cat([probe_list, probe_list[:, -1:].expand(-1, pad)], dim=1).contiguous()


def _check_multiprobe(k: int, mc: int, per_step: int) -> None:
    if per_step < 1:
        raise ValueError(f"probes_per_step={per_step} must be ≥ 1")
    if k > mc:
        raise ValueError("k exceeds the full-width single-slot accumulator (Mc)")


def ivf_scan_multiprobe_reference(
    q, probe_list, data, ids, k: int, block_q: int, probes_per_step: int,
    scales=None,
):
    """Plain version of K11a: the probe list padded to a multiple of
    ``probes_per_step``, then the single-slot fold at width Mc and the
    k-round merge."""
    mc = data.shape[1]
    _check_multiprobe(k, mc, probes_per_step)
    return scan_plain(q, pad_probes(probe_list, probes_per_step), data, ids, k, block_q,
                      mc, 1, scales)


def ivf_scan_idless_reference(q, probe_list, data, k: int, block_q: int, approx_width: int):
    """Plain version of K11b: the single-slot fold of width
    ``approx_width`` over every slot (no ids read, none masked), ids =
    flat slot ids probe · Mc + position; the merge breaks ties on the
    lowest flat slot id."""
    w = scan_width(data.shape[1], approx_width)
    if not w:
        raise ValueError("the idless scan needs approx_width > 0")
    if k > w:
        raise ValueError("k exceeds the single-slot accumulator width")
    return scan_plain(q, probe_list, data, None, k, block_q, w, 1)


# ---------------------------------------------------------------------------
# The wgmma tile (csrc/ivf_tile.cu): its plan, and the zero-tile map that
# K11b reads in place of ids
# ---------------------------------------------------------------------------

TILE_ROWS = 64                 # slab rows a tile, lanes a CTA (wgmma's M)
SENTINEL_KIND = 3              # the tile's slab kind for K11b's raw sentinel rows


class TilePlan(NamedTuple):
    """The wgmma tile's launch plan for a scan, as ``ivf_tile_plan`` of
    ``csrc/ivf_tile.cu`` decides it."""

    nq: int       # queries a CTA: the block's 8, 16 or 64 (padded with zeros)
    nwg: int      # consumer warpgroups (they split the CTA's queries)
    n: int        # queries a warpgroup: wgmma's N
    stages: int   # copy-ring stages
    smem: int     # dynamic shared memory, bytes


def tile_part_width(width: int, k: int, slots: int) -> int:
    """Entries a query that the tile hands the merge pass: the deferred
    fold's raw 64·S accumulator entries of each 64-lane range, or the exact
    mode's top-k of each range."""
    return -(-width // TILE_ROWS) * (slots * TILE_ROWS if slots else k)


def tile_plan_cuda(kind: int, d: int, mc: int, block_q: int, k: int, width: int,
                   slots: int, max_stages: int = 0) -> Optional[TilePlan]:
    """The plan a scan's entry point takes (slab kind 0 f32, 1 bf16, 2 int8,
    ``SENTINEL_KIND`` the idless scan of bf16 sentinel rows, ``d`` their
    D + 1 columns; ``width`` the fold width, Mc in the exact mode; ``slots``
    0 exact, else S; ``max_stages`` the ring depth asked for, 0 for the
    tile's own), as the kernel library decides it; None where a CUDA-core
    kernel runs: f32 slabs, D (D + 1 for the sentinel rows) not a multiple
    of 64 or too wide for shared memory, Mc not a multiple of 4 (8 for the
    sentinel rows, and their width too). Its partial results take
    ``tile_part_width`` entries a query."""
    out = (ctypes.c_int * 5)()
    if not _cuda.lib().ts_ivf_scan_tile_plan(kind, d, mc, block_q, k, width, slots,
                                             ctypes.addressof(out), max_stages):
        return None
    return TilePlan(*out)


def zero_tile_map(data: torch.Tensor) -> torch.Tensor:
    """(C_tot, Mc, D') slabs → (C_tot, ceil(Mc / 64)) uint8: 1 where every
    row of a slab's 64-row tile (its last one may be shorter) is all zero.
    In the sentinel layout those are never-written slots, which the idless
    scan scores exactly 0, so K11b folds a constant 0 for such a tile
    without reading it. One pass over the slabs on their device, a few
    slabs at a time."""
    c_tot, mc, dw = data.shape
    n_t = -(-mc // TILE_ROWS)
    step = max(1, _MAP_CHUNK // (mc * dw))
    parts = []
    for c0 in range(0, c_tot, step):
        nz = (data[c0:c0 + step] != 0).any(dim=2)
        nz = torch.nn.functional.pad(nz, (0, n_t * TILE_ROWS - mc))
        parts.append((~nz.view(nz.shape[0], n_t, TILE_ROWS).any(dim=2)).to(torch.uint8))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def check_scan_inputs(q, probe_list, data, ids, k: int, block_q: int, scales=None,
                      dtypes=(torch.float32, torch.bfloat16, torch.int8)) -> None:
    """The checks every IVF scan wrapper makes on what it hands a kernel."""
    _cuda.require_cuda(q, "q", (torch.float32,), 2)
    _cuda.require_cuda(probe_list, "probe_list", (torch.int32,), 2)
    _cuda.require_cuda(data, "data", dtypes, 3)
    b, d = q.shape
    c_tot, mc, dd = data.shape
    if ids is not None:
        _cuda.require_cuda(ids, "ids", (torch.int32,), 2)
        if tuple(ids.shape) != (c_tot, mc):
            raise ValueError(f"ids shape {tuple(ids.shape)} != {(c_tot, mc)}")
    if (data.dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 slabs need scales, and only int8 slabs take them")
    if scales is not None:
        _cuda.require_cuda(scales, "scales", (torch.float32,), 2)
        if tuple(scales.shape) != (c_tot, mc):
            raise ValueError(f"scales shape {tuple(scales.shape)} != {(c_tot, mc)}")
    if dd != d or not 1 <= d <= MAX_D:
        raise ValueError(f"dims: q {d}, data {dd} (need equal, ≤ {MAX_D})")
    if block_q < 1 or b % block_q or probe_list.shape[0] != b // block_q:
        raise ValueError(f"B={b} must be n_blocks={probe_list.shape[0]} × block_q={block_q}")
    if k < 1:
        raise ValueError(f"k={k} must be ≥ 1")


def data_kind(data: torch.Tensor) -> int:
    """The kernels' slab type code: 0 f32, 1 bf16, 2 int8."""
    return {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[data.dtype]


def _outputs(shape, dev):
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def emit_acc_cuda(q, probe_list, data, ids, block_q: int, width: int, slots: int, scales,
                  out_s: torch.Tensor, out_i: torch.Tensor) -> None:
    """The scan's raw accumulator (K1-opt emit_acc) at (``width``,
    ``slots``) into out_s / out_i, contiguous (B, slots·width)."""
    b, d = q.shape
    c_tot, mc, _ = data.shape
    err = _cuda.lib().ts_ivf_scan_emit_acc(
        q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), data_kind(data),
        scales.data_ptr() if scales is not None else None, ids.data_ptr(), b, d,
        probe_list.shape[1], c_tot, mc, block_q, width, slots, out_s.data_ptr(),
        out_i.data_ptr(), _cuda.stream_handle(q.device),
    )
    _cuda.check(err, "ivf_scan emit_acc kernel")


def _per_probe_scores(q, probe_list, data, ids, block_q: int, scales):
    """Every probed slot's score, probe by probe, in one launch: emit_acc
    at width Mc with one slot over the queries repeated once a probe, the
    copy u of block i probing ``probe_list[i, u]`` alone, is each slab's
    scores as they are (a dead slot −inf with id −1) → (s, i) (U, B,
    Mc)."""
    b = q.shape[0]
    u, mc = probe_list.shape[1], data.shape[1]
    s = torch.empty((u, b, mc), dtype=torch.float32, device=q.device)
    i = torch.empty((u, b, mc), dtype=torch.int32, device=q.device)
    emit_acc_cuda(q.repeat(u, 1), probe_list.t().reshape(-1, 1).contiguous(), data, ids,
                  block_q, mc, 1, scales, s, i)
    ivf_scan_large_k_cuda.launches_emit += 1
    return s, i


def _select_counted(scores, k: int, ids=None, segments: bool = False):
    """``topk_select_cuda``, its launch also counted in
    ``ivf_scan_large_k_cuda.launches_select``."""
    out = topk_select_cuda(scores, k, ids, segments)
    ivf_scan_large_k_cuda.launches_select += 1
    return out


def _block_chunks(n_blocks: int, block_q: int, u: int, mc: int):
    """Query blocks a chunk, so that a chunk's (U, rows, Mc) scores and ids
    stay within ``_SCORES_BYTES`` → (blocks, rows) slices a chunk."""
    step = max(1, _SCORES_BYTES // (block_q * u * mc * 8))
    for blk0 in range(0, n_blocks, step):
        blk1 = min(n_blocks, blk0 + step)
        yield slice(blk0, blk1), slice(blk0 * block_q, blk1 * block_q)


def ivf_scan_large_k_cuda(q, probe_list, data, ids, k: int, block_q: int, width: int = 0,
                          slots: int = 1, scales=None, per_probe: bool = False):
    """The IVF scans above ``MAX_K`` on the card, where the tile's
    selection stops: the scores come from the scan's own tile (emit_acc)
    and ``topk_select_cuda`` selects, by (score desc, id asc), padding with
    (−inf, −1):
    - exact (``width`` 0): each block's union of probed slots, the scores
      written probe by probe in one launch (``_per_probe_scores``) for a
      chunk of query blocks at a time (≤ ``_SCORES_BYTES`` of scores and
      ids), then the top k of a query's U·Mc candidates in place → (B, k);
    - ``per_probe``: the same scores, each probe's row its own top k → (U,
      B, k);
    - deferred (width w, ``slots`` S): the fold's (B, S·w) accumulator, then
      its top k → (B, k), as the tile's own merge takes it.
    Each emit_acc launch adds one to ``ivf_scan_large_k_cuda.launches_emit``
    and each select launch one to ``.launches_select``."""
    b = q.shape[0]
    n_blocks, u = probe_list.shape
    mc = data.shape[1]
    dev = q.device
    shape = (u, b, k) if per_probe else (b, k)
    if b == 0:
        return _outputs(shape, dev)
    if width:
        acc_s, acc_i = _outputs((b, slots * width), dev)
        emit_acc_cuda(q, probe_list, data, ids, block_q, width, slots, scales, acc_s, acc_i)
        ivf_scan_large_k_cuda.launches_emit += 1
        return _select_counted(acc_s, k, acc_i)
    out_s, out_i = _outputs(shape, dev)
    for blocks, rows in _block_chunks(n_blocks, block_q, u, mc):
        s, i = _per_probe_scores(q[rows], probe_list[blocks], data, ids, block_q, scales)
        if per_probe:
            bc = s.shape[1]
            ts, ti = _select_counted(s.view(u * bc, mc), k, i.view(u * bc, mc))
            out_s[:, rows], out_i[:, rows] = ts.view(u, bc, k), ti.view(u, bc, k)
        else:
            out_s[rows], out_i[rows] = _select_counted(s, k, i, segments=True)
    return out_s, out_i


ivf_scan_large_k_cuda.launches_emit = 0
ivf_scan_large_k_cuda.launches_pack = 0
ivf_scan_large_k_cuda.launches_select = 0


def _packed_large_k_cuda(q, probe_list, data, ids, k: int, block_q: int, w: int, slots: int,
                         out: torch.Tensor) -> torch.Tensor:
    """K9 above ``MAX_K``, chunked over query blocks as the exact scan is:
    every probed slot's emit_acc score, then ``ts_ivf_pack_classes`` makes
    each its packet (``_pack_candidates``' rule; a dead slot 0) laid out a
    row per (query, lane class), then the select kernel on int keys takes
    each class's top-``slots`` packets and the top k of the (S·w)
    accumulator. The pack launches count in
    ``ivf_scan_large_k_cuda.launches_pack``."""
    n_blocks, u = probe_list.shape
    mc = data.shape[1]
    for blocks, rows in _block_chunks(n_blocks, block_q, u, mc):
        s, i = _per_probe_scores(q[rows], probe_list[blocks], data, ids, block_q, None)
        bc = s.shape[1]
        cls = torch.empty((bc * w, u * (mc // w)), dtype=torch.int32, device=q.device)
        err = _cuda.lib().ts_ivf_pack_classes(s.data_ptr(), i.data_ptr(), u, bc, mc, w,
                                              cls.data_ptr(), _cuda.stream_handle(q.device))
        _cuda.check(err, "ivf_scan packet kernel")
        ivf_scan_large_k_cuda.launches_pack += 1
        acc, _ = _select_counted(cls, slots)
        out[rows], _ = _select_counted(acc.view(bc, w * slots), k)
    return out


def ivf_scan_packed_cuda(
    q, probe_list, data, ids, k: int, block_q: int, approx_width: int = 0,
    acc_slots: int = 1,
) -> torch.Tensor:
    """Kernel K9 on the card; same contract as
    ``ivf_scan_packed_reference`` (f32 / bf16 slabs, U ≤ 64, Mc ≤ 2048,
    acc_slots ≤ 4). bf16 slabs run the wgmma tile where the kernel
    library's plan takes the shape (``tile_plan_cuda(1, D, Mc, block_q, k,
    w, acc_slots)``: D a multiple of 64, Mc a multiple of 4), else the
    CUDA-core kernel. Counts ``ivf_scan_packed_cuda.launches``, those on
    the tile also in ``.launches_tile``."""
    check_scan_inputs(q, probe_list, data, ids, k, block_q,
                      dtypes=(torch.float32, torch.bfloat16))
    b, d = q.shape
    c_tot, mc, _ = data.shape
    u = probe_list.shape[1]
    w = _packed_width(u, mc, k, approx_width, acc_slots)
    if not 1 <= acc_slots <= 4:
        raise ValueError(f"acc_slots={acc_slots} must be in [1, 4]")
    dev = q.device
    out = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    if k > MAX_K:
        return _packed_large_k_cuda(q, probe_list, data, ids, k, block_q, w, acc_slots, out)
    plan = None
    if data.dtype == torch.bfloat16:
        plan = tile_plan_cuda(1, d, mc, block_q, k, w, acc_slots)
    part_s, part_i = _outputs((b, tile_part_width(w, k, acc_slots) if plan else -(-w // 128) * k),
                              dev)
    sel_s, sel_i = _outputs((b, k), dev)
    err = _cuda.lib().ts_ivf_scan_packed(
        q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), int(data.dtype == torch.bfloat16),
        ids.data_ptr(), b, d, u, c_tot, mc, block_q, k, w, acc_slots,
        part_s.data_ptr(), part_i.data_ptr(), sel_s.data_ptr(), sel_i.data_ptr(),
        out.data_ptr(), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "ivf_scan_packed kernel")
    ivf_scan_packed_cuda.launches += 1
    if plan:
        ivf_scan_packed_cuda.launches_tile += 1
    return out


ivf_scan_packed_cuda.launches = 0
ivf_scan_packed_cuda.launches_tile = 0


def ivf_scan_dma_cuda(
    q, probe_list, data, ids, k: int, block_q: int, acc_slots: int = 1,
    n_buffers: int = 2,
):
    """Kernel K10 on the card; same contract as ``ivf_scan_dma_reference``
    (f32 / bf16 slabs, any Mc, D ≤ 1025, acc_slots ≤ 4, n_buffers 2-4).
    It runs K1 at width Mc with S slots, so its result is K1's at
    ``approx_width=Mc`` bit for bit: the wgmma tile where the kernel
    library's plan takes the shape (``tile_plan_cuda`` with its ring at
    most ``n_buffers`` deep: bf16 slabs, D a multiple of 64, Mc a multiple
    of 4), else K1's CUDA-core kernel. Counts
    ``ivf_scan_dma_cuda.launches``, those on the tile also in
    ``.launches_tile``."""
    check_scan_inputs(q, probe_list, data, ids, k, block_q,
                      dtypes=(torch.float32, torch.bfloat16))
    b, d = q.shape
    c_tot, mc, _ = data.shape
    _check_dma(k, mc, acc_slots, n_buffers)
    if not 1 <= acc_slots <= 4:
        raise ValueError(f"acc_slots={acc_slots} must be in [1, 4]")
    dev = q.device
    out_s, out_i = _outputs((b, k), dev)
    if b == 0:
        return out_s, out_i
    if k > MAX_K:   # K1's fold at width Mc, then the select kernel
        return ivf_scan_large_k_cuda(q, probe_list, data, ids, k, block_q, mc, acc_slots)
    plan = tile_plan_cuda(data_kind(data), d, mc, block_q, k, mc, acc_slots, n_buffers)
    n_part = tile_part_width(mc, k, acc_slots) if plan else -(-mc // 128) * k
    part_s, part_i = _outputs((b, n_part), dev)
    err = _cuda.lib().ts_ivf_scan_dma(
        q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), int(data.dtype == torch.bfloat16),
        ids.data_ptr(), b, d, probe_list.shape[1], c_tot, mc, block_q, k, acc_slots, n_buffers,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "ivf_scan_dma kernel")
    ivf_scan_dma_cuda.launches += 1
    if plan:
        ivf_scan_dma_cuda.launches_tile += 1
    return out_s, out_i


ivf_scan_dma_cuda.launches = 0
ivf_scan_dma_cuda.launches_tile = 0


def ivf_scan_multiprobe_cuda(
    q, probe_list, data, ids, k: int, block_q: int, probes_per_step: int,
    scales=None,
):
    """Kernel K11a on the card; same contract as
    ``ivf_scan_multiprobe_reference`` (f32, bf16 or int8 + scales). It
    runs K1 at width Mc with one slot over the probe list padded to a
    multiple of ``probes_per_step``, so its result is K1's at
    ``approx_width=Mc`` bit for bit: the wgmma tile where the kernel
    library's plan takes the shape (``tile_plan_cuda`` at width Mc with one
    slot: bf16 or int8 slabs, D a multiple of 64, Mc a multiple of 4), else
    K1's CUDA-core kernel. Counts ``ivf_scan_multiprobe_cuda.launches``,
    those on the tile also in ``.launches_tile``."""
    check_scan_inputs(q, probe_list, data, ids, k, block_q, scales)
    b, d = q.shape
    c_tot, mc, _ = data.shape
    _check_multiprobe(k, mc, probes_per_step)
    probe_list = pad_probes(probe_list, probes_per_step)
    dev = q.device
    out_s, out_i = _outputs((b, k), dev)
    if b == 0:
        return out_s, out_i
    if k > MAX_K:   # K1's single-slot fold at width Mc, then the select kernel
        return ivf_scan_large_k_cuda(q, probe_list, data, ids, k, block_q, mc, 1, scales)
    plan = tile_plan_cuda(data_kind(data), d, mc, block_q, k, mc, 1)
    part_s, part_i = _outputs((b, tile_part_width(mc, k, 1) if plan else -(-mc // 128) * k), dev)
    err = _cuda.lib().ts_ivf_scan_multiprobe(
        q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), data_kind(data),
        scales.data_ptr() if scales is not None else None, ids.data_ptr(), b, d,
        probe_list.shape[1], probes_per_step, c_tot, mc, block_q, k,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "ivf_scan_multiprobe kernel")
    ivf_scan_multiprobe_cuda.launches += 1
    if plan:
        ivf_scan_multiprobe_cuda.launches_tile += 1
    return out_s, out_i


ivf_scan_multiprobe_cuda.launches = 0
ivf_scan_multiprobe_cuda.launches_tile = 0


def ivf_scan_idless_cuda(q, probe_list, data, k: int, block_q: int, approx_width: int,
                         zero_tiles: Optional[torch.Tensor] = None,
                         counts: Optional[torch.Tensor] = None):
    """Kernel K11b on the card; same contract as
    ``ivf_scan_idless_reference`` (f32 / bf16 slabs). Where the kernel
    library's plan takes the shape (``tile_plan_cuda(SENTINEL_KIND, ...)``:
    bf16 rows of D + 1 columns with D a multiple of 64, Mc and the fold
    width multiples of 8, 16-byte aligned slabs) it runs the wgmma tile,
    which skips the 64-row tiles that ``zero_tiles`` (``zero_tile_map`` of
    the slabs; built here when None) marks all zero; else the CUDA-core
    kernel. ``counts``, an int32 (2,) CUDA tensor, gains (tiles of valid
    probes, tiles skipped) where the tile runs. Counts
    ``ivf_scan_idless_cuda.launches``, those on the tile also in
    ``.launches_tile``."""
    check_scan_inputs(q, probe_list, data, None, k, block_q,
                      dtypes=(torch.float32, torch.bfloat16))
    b, d = q.shape
    c_tot, mc, _ = data.shape
    w = scan_width(mc, approx_width)
    if not w:
        raise ValueError("the idless scan needs approx_width > 0")
    if k > w:
        raise ValueError("k exceeds the single-slot accumulator width")
    if c_tot * mc >= 2 ** 31:
        raise ValueError("flat slot ids need C_tot · Mc < 2^31")
    dev = q.device
    out_s, out_i = _outputs((b, k), dev)
    if b == 0:
        return out_s, out_i
    if k > MAX_K:
        # the same fold through emit_acc with the flat slot ids as ids (all
        # live, none masked), then the select kernel
        flat = torch.arange(c_tot * mc, dtype=torch.int32, device=dev).view(c_tot, mc)
        return ivf_scan_large_k_cuda(q, probe_list, data, flat, k, block_q, w, 1)
    plan = None
    if data.dtype == torch.bfloat16:
        plan = tile_plan_cuda(SENTINEL_KIND, d, mc, block_q, k, w, 1)
    zero_ptr = counts_ptr = None
    if plan:
        if zero_tiles is None:
            zero_tiles = zero_tile_map(data)
        _cuda.require_cuda(zero_tiles, "zero_tiles", (torch.uint8,), 2)
        if tuple(zero_tiles.shape) != (c_tot, -(-mc // TILE_ROWS)):
            raise ValueError(f"zero_tiles shape {tuple(zero_tiles.shape)} != "
                             f"{(c_tot, -(-mc // TILE_ROWS))}")
        zero_ptr = zero_tiles.data_ptr()
        if counts is not None:
            _cuda.require_cuda(counts, "counts", (torch.int32,), 1)
            if counts.numel() != 2:
                raise ValueError("counts holds (tiles of valid probes, tiles skipped)")
            counts_ptr = counts.data_ptr()
    n_part = tile_part_width(w, k, 1) if plan else -(-w // 128) * k
    part_s, part_i = _outputs((b, n_part), dev)
    err = _cuda.lib().ts_ivf_scan_idless(
        q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), int(data.dtype == torch.bfloat16),
        zero_ptr, counts_ptr, b, d, probe_list.shape[1], c_tot, mc, block_q, k, w,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "ivf_scan_idless kernel")
    ivf_scan_idless_cuda.launches += 1
    if plan:
        ivf_scan_idless_cuda.launches_tile += 1
    return out_s, out_i


ivf_scan_idless_cuda.launches = 0
ivf_scan_idless_cuda.launches_tile = 0


# ---------------------------------------------------------------------------
# Dispatch: the kernel for CUDA slabs, the plain version for CPU slabs
# ---------------------------------------------------------------------------

def ivf_scan_packed(q, probe_list, data, ids, k, block_q, approx_width=0, acc_slots=1):
    fn = ivf_scan_packed_cuda if data.is_cuda else ivf_scan_packed_reference
    return fn(q, probe_list, data, ids, k, block_q, approx_width, acc_slots)


def ivf_scan_dma(q, probe_list, data, ids, k, block_q, acc_slots=1, n_buffers=2):
    fn = ivf_scan_dma_cuda if data.is_cuda else ivf_scan_dma_reference
    return fn(q, probe_list, data, ids, k, block_q, acc_slots, n_buffers)


def ivf_scan_multiprobe(q, probe_list, data, ids, k, block_q, probes_per_step, scales=None):
    fn = ivf_scan_multiprobe_cuda if data.is_cuda else ivf_scan_multiprobe_reference
    return fn(q, probe_list, data, ids, k, block_q, probes_per_step, scales)


def ivf_scan_idless(q, probe_list, data, k, block_q, approx_width, zero_tiles=None):
    """K11b: the kernel for CUDA slabs (``zero_tiles`` the index's map, or
    None to build it), the plain version for CPU slabs (it reads no map)."""
    if data.is_cuda:
        return ivf_scan_idless_cuda(q, probe_list, data, k, block_q, approx_width, zero_tiles)
    return ivf_scan_idless_reference(q, probe_list, data, k, block_q, approx_width)
