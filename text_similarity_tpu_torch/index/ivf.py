"""IVF (inverted-file) ANN index with the block-union scan (kernels K1
and K4, and the scan modes of ``ivf_modes.py``: K1-opt, K9, K10, K11).

Port of ``text_similarity_tpu.index.ivf``:

- **Build**: spherical k-means (ops/kmeans.py), then the spill-balanced
  padded layout — a (C_tot, Mc, D) slab tensor plus a (C_tot, Mc) id map
  (-1 = empty slot); rows that fit no cluster go to overflow slabs that
  every query scans. An int8 build (``IndexConfig.quantize_int8``) stores
  per-row int8 codes with (C_tot, Mc) f32 scales, and by default keeps a
  bf16 copy of the corpus (``rescore_data``, indexed by id) for the rescore.
  ``group > 1`` stores ``group`` affinity-ordered clusters a slab ((C_tot /
  g, g·Mc, D)); ``sentinel=True`` appends a column (+2 live, 0 dead) so
  that a scan can run without ids (D+1 wide slabs).
- **Query** (``_ivf_query_fused``): normalise, score the centroids (a
  slab's score is its members' max), sort the queries by their top-1 slab
  (stable), give each ``block_q`` block of sorted queries one probe list —
  the top-``union`` of the block-max slab scores, padding rows masked to
  −1e9 — append the overflow slabs, scan, then, with a rescore copy,
  re-score the scan's ``k_coarse`` (default 2k) candidates against it and
  keep the top k; unsort. The scan options of the reference: the exact
  and deferred merges (K1 / K4), ``per_probe`` and ``final_merge`` "xla" /
  "xla_approx" (K1-opt), "packed" (K9), ``dma_pipeline`` (K10),
  ``probes_per_step`` (K11a) and, on a sentinel index, the idless scan
  (K11b).
- ``add`` inserts rows into free slots of their nearest clusters (new
  overflow slabs for the rest), ``remove`` clears slots by id (and the
  sentinel column).

Each scan runs its CUDA kernel on CUDA tensors and its plain version on
CPU tensors. ``query_xla`` keeps the reference's per-query probe semantics
(its XLA path) as a second plain function for tests.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..compress.quantize import quantize_embeddings_int8
from ..core.config import IndexConfig
from ..core.precision import resolve_device
from ..ops import _cuda
from ..ops.kmeans import assign_clusters_topk, kmeans
from ..ops.topk import MAX_K, l2_normalize, topk_select_cuda
from ..utils.profiling import span
from .ivf_modes import (
    TILE_ROWS,
    _unpack_candidates,
    check_scan_inputs,
    data_kind,
    emit_acc_cuda,
    ivf_scan_dma,
    ivf_scan_idless,
    ivf_scan_large_k_cuda,
    ivf_scan_multiprobe,
    ivf_scan_packed,
    scan_plain,
    scan_width as _scan_width,
    tile_part_width,
    tile_plan_cuda,
    zero_tile_map,
)
from .store import bf16_to_bits, bits_to_bf16

_BUILD_SCATTER_CHUNK = 1 << 20


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _approx_merge_plan(
    k_scan: int, mc: int, approx_width: int,
    max_slots: int = 4, tol: Optional[float] = 0.005,
) -> Tuple[int, int]:
    """Size the deferred lane-class fold → ``(approx_width, acc_slots)``,
    or ``(0, 1)`` for "use the exact merge". The fold keeps the top-S per
    lane class; a true top-k hit is lost iff ≥ S stronger hits share its
    class, expected relative loss ~ k^S / ((S+1)! · w^S). Take the
    smallest S that bounds the loss at ``tol``, holds k (k ≤ S·w) and keeps
    w % 128 == 0 for S > 1 (same rule as the reference)."""
    w = min(approx_width, mc) if approx_width else 0
    if w and mc % w:
        w = mc
    if not w:
        return 0, 1
    sizes = range(max_slots, 0, -1) if tol is None else range(1, max_slots + 1)
    for s in sizes:
        if k_scan > s * w:
            continue
        if s > 1 and w % 128:
            continue
        if tol is None or k_scan ** s / (math.factorial(s + 1) * w ** s) <= tol:
            return w, s
    return 0, 1


# ---------------------------------------------------------------------------
# The scan: plain version, kernel wrapper, dispatch
# ---------------------------------------------------------------------------

def ivf_scan_reference(
    q: torch.Tensor,           # (B, D) f32, B a multiple of block_q
    probe_list: torch.Tensor,  # (B/block_q, U) int32 slab ids
    data: torch.Tensor,        # (C_tot, Mc, D) f32, bf16 or int8
    ids: torch.Tensor,         # (C_tot, Mc) int32, -1 = empty
    k: int,
    block_q: int,
    approx_width: int = 0,
    acc_slots: int = 1,
    scales: Optional[torch.Tensor] = None,  # (C_tot, Mc) f32 for int8 slabs
    per_probe: bool = False,
    emit_acc: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1, and of K4 with int8 slabs and ``scales`` (the
    reference's ``_ivf_body`` semantics).

    Every query of block i is scored against all slots of the slabs in
    ``probe_list[i]`` (queries rounded to bf16 first when the slabs are
    bf16 or int8; f32 accumulation; int8 scores × the slot's scale after
    the dot); slots with id < 0 score −inf.
    - exact (``approx_width=0``): top-k over those slots;
    - deferred (width w): slot p of probe u is inserted, in (u, p) order,
      into lane class p mod w, which keeps its top-``acc_slots`` — a later
      entry ranks below an earlier one of equal score — and the top-k is
      taken over the S·w accumulator entries.
    Top-k order is (score desc, id asc); missing results are (−inf, −1).
    K1-opt: ``per_probe`` (exact only) → (U, B, k), each probe's own top-k;
    ``emit_acc`` (deferred only) → the (B, S·w) accumulator, slot-major."""
    w = _scan_width(data.shape[1], approx_width)
    _check_mode(w, per_probe, emit_acc)
    return scan_plain(q, probe_list, data, ids, k, block_q, w, acc_slots, scales,
                      per_probe=per_probe, emit_acc=emit_acc)


def _check_mode(w: int, per_probe: bool, emit_acc: bool) -> None:
    if per_probe and w:
        raise ValueError("approx_width and per_probe are exclusive")
    if emit_acc and not w:
        raise ValueError("emit_acc needs the deferred fold (approx_width > 0)")


# ---------------------------------------------------------------------------
# K1 / K4 on the wgmma tile (csrc/ivf_tile.cu; its plan: ivf_modes.py): what
# it reads
# ---------------------------------------------------------------------------

def tile_occupancy(probe_list: torch.Tensor, ids: torch.Tensor, width: int) -> Tuple[float, float]:
    """What a tile scan of ``probe_list`` (B/block_q, U) over slabs with
    ``ids`` (C_tot, Mc) meets: the share of its probed slots that are live
    (id ≥ 0), and the share of its 64-lane tiles that it skips because
    every slot in them is empty (probe ids outside [0, C_tot) scan
    nothing and count in neither)."""
    c_tot, mc = ids.shape
    n_ranges = -(-width // TILE_ROWS)
    live = (ids >= 0).view(c_tot, mc // width, width)
    pad = n_ranges * TILE_ROWS - width
    if pad:
        live = torch.cat([live, live.new_zeros((c_tot, mc // width, pad))], dim=2)
    tile_live = live.view(c_tot, mc // width, n_ranges, TILE_ROWS).any(dim=3)
    p = probe_list.long().reshape(-1)
    p = p[(p >= 0) & (p < c_tot)]
    if p.numel() == 0:
        return 0.0, 0.0
    live_slots = float((ids[p] >= 0).sum())
    return live_slots / (p.numel() * mc), 1.0 - float(tile_live[p].float().mean())


def ivf_scan_cuda(
    q: torch.Tensor,
    probe_list: torch.Tensor,
    data: torch.Tensor,
    ids: torch.Tensor,
    k: int,
    block_q: int,
    approx_width: int = 0,
    acc_slots: int = 1,
    scales: Optional[torch.Tensor] = None,
    per_probe: bool = False,
    emit_acc: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 (f32/bf16 slabs) or K4 (int8 slabs with ``scales``) on the
    card, in its merge, per-probe or raw-accumulator mode; same contract as
    ``ivf_scan_reference``. q (B, D) f32, probe_list (B/block_q, U) int32,
    data (C_tot, Mc, D), ids and scales (C_tot, Mc) int32 / f32 —
    contiguous CUDA tensors; D ≤ 1025 (any alignment), k ≥ 1 (above
    ``MAX_K`` through ``ivf_scan_large_k_cuda``), acc_slots ≤ 4. Every
    mode runs on the wgmma tile where the kernel library's plan takes the
    shape (``tile_plan_cuda``; per_probe asks it for the exact
    mode, emit_acc at k 1: no selection runs), else on the CUDA-core
    kernel. Each mode counts its launches apart: ``ivf_scan_cuda.launches``,
    ``.launches_int8`` (merge; those on the tile also in
    ``.launches_tile[_int8]``), ``.launches_per_probe[_int8]`` (those on
    the tile also in ``.launches_per_probe_tile[_int8]``),
    ``.launches_emit_acc[_int8]`` (those on the tile also in
    ``.launches_emit_acc_tile[_int8]``)."""
    check_scan_inputs(q, probe_list, data, ids, k, block_q, scales)
    int8 = data.dtype == torch.int8
    b, d = q.shape
    c_tot, mc, _ = data.shape
    n_blocks, u = probe_list.shape
    w = _scan_width(mc, approx_width)
    _check_mode(w, per_probe, emit_acc)
    slots = acc_slots if w else 0
    if w and not 1 <= slots <= 4:
        raise ValueError(f"acc_slots={acc_slots} must be in [1, 4]")
    width = w or mc
    dev = q.device
    sc_ptr = scales.data_ptr() if int8 else None
    suffix = "_int8" if int8 else ""
    if k > MAX_K and not emit_acc:
        return ivf_scan_large_k_cuda(q, probe_list, data, ids, k, block_q, w, slots, scales,
                                     per_probe)
    if emit_acc:
        out_s = torch.empty((b, slots * w), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, slots * w), dtype=torch.int32, device=dev)
        if b == 0:
            return out_s, out_i
        plan = tile_plan_cuda(data_kind(data), d, mc, block_q, 1, w, slots)
        emit_acc_cuda(q, probe_list, data, ids, block_q, w, slots, scales, out_s, out_i)
        _count(f"launches_emit_acc{suffix}")
        if plan:
            _count(f"launches_emit_acc_tile{suffix}")
        return out_s, out_i
    rows = u * b if per_probe else b
    out_s = torch.empty((rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=dev)
    if per_probe:
        out_s, out_i = out_s.view(u, b, k), out_i.view(u, b, k)
    if b == 0:
        return out_s, out_i
    plan = tile_plan_cuda(data_kind(data), d, mc, block_q, k, width, slots)
    if per_probe and plan:   # the tile writes (U, B, k) itself: no merge rows
        n_part = 0
    elif plan:
        n_part = tile_part_width(width, k, slots)
    else:
        n_part = -(-width // 128) * k
    part_s = torch.empty((rows, n_part), dtype=torch.float32, device=dev)
    part_i = torch.empty((rows, n_part), dtype=torch.int32, device=dev)
    outs = (part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            _cuda.stream_handle(dev))
    if per_probe:
        err = _cuda.lib().ts_ivf_scan_per_probe(
            q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), data_kind(data), sc_ptr,
            ids.data_ptr(), b, d, u, c_tot, mc, block_q, k, *outs,
        )
        _cuda.check(err, "ivf_scan per_probe kernel")
        _count(f"launches_per_probe{suffix}")
        if plan:
            _count(f"launches_per_probe_tile{suffix}")
        return out_s, out_i
    dims = (b, d, u, c_tot, mc, block_q, k, width, slots)
    if int8:
        err = _cuda.lib().ts_ivf_scan_int8(
            q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), scales.data_ptr(),
            ids.data_ptr(), *dims, *outs,
        )
        _cuda.check(err, "ivf_scan_int8 kernel")
    else:
        err = _cuda.lib().ts_ivf_scan(
            q.data_ptr(), probe_list.data_ptr(), data.data_ptr(),
            int(data.dtype == torch.bfloat16), ids.data_ptr(), *dims, *outs,
        )
        _cuda.check(err, "ivf_scan kernel")
    _count(f"launches{suffix}")
    if plan:
        _count(f"launches_tile{suffix}")
    return out_s, out_i


def _count(counter: str) -> None:
    setattr(ivf_scan_cuda, counter, getattr(ivf_scan_cuda, counter) + 1)


ivf_scan_cuda.launches = 0
ivf_scan_cuda.launches_int8 = 0
ivf_scan_cuda.launches_tile = 0
ivf_scan_cuda.launches_tile_int8 = 0
ivf_scan_cuda.launches_per_probe = 0
ivf_scan_cuda.launches_per_probe_int8 = 0
ivf_scan_cuda.launches_per_probe_tile = 0
ivf_scan_cuda.launches_per_probe_tile_int8 = 0
ivf_scan_cuda.launches_emit_acc = 0
ivf_scan_cuda.launches_emit_acc_int8 = 0
ivf_scan_cuda.launches_emit_acc_tile = 0
ivf_scan_cuda.launches_emit_acc_tile_int8 = 0


def ivf_scan(q, probe_list, data, ids, k, block_q, approx_width=0, acc_slots=1, scales=None,
             per_probe=False, emit_acc=False):
    """K1 / K4 / K1-opt: the CUDA kernel for CUDA slabs, the plain version
    for CPU slabs."""
    fn = ivf_scan_cuda if data.is_cuda else ivf_scan_reference
    return fn(q, probe_list, data, ids, k, block_q, approx_width, acc_slots, scales,
              per_probe=per_probe, emit_acc=emit_acc)


# ---------------------------------------------------------------------------
# Grouped slabs
# ---------------------------------------------------------------------------

def _affinity_group_perm(centroids: np.ndarray, group: int) -> np.ndarray:
    """Permutation putting mutually similar clusters into consecutive
    length-``group`` runs (hierarchical greedy max-similarity matching, as
    the reference builds it). ``group`` a power of two dividing the cluster
    count."""
    c = centroids.shape[0]
    if group & (group - 1):
        raise ValueError("group must be a power of two")
    if c % group:
        raise ValueError("cluster count must be a multiple of group")
    members = np.arange(c, dtype=np.int64)[:, None]      # (n_groups, size)
    reps = centroids.astype(np.float64)
    size = 1
    while size < group:
        n = reps.shape[0]
        sims = reps @ reps.T
        iu, ju = np.triu_indices(n, 1)
        order = np.argsort(-sims[iu, ju], kind="stable")
        used = np.zeros(n, bool)
        pair_a = np.empty(n // 2, np.int64)
        pair_b = np.empty(n // 2, np.int64)
        got = 0
        for a, b in zip(iu[order], ju[order]):
            if used[a] or used[b]:
                continue
            used[a] = used[b] = True
            pair_a[got], pair_b[got] = a, b
            got += 1
            if got == n // 2:
                break
        members = np.concatenate([members[pair_a], members[pair_b]], axis=1)
        merged = reps[pair_a] + reps[pair_b]
        reps = merged / np.maximum(np.linalg.norm(merged, axis=1, keepdims=True), 1e-9)
        size *= 2
    return members.reshape(-1)


def _group_max(scores: torch.Tensor, group: int) -> torch.Tensor:
    """(B, C) per-centroid sims → (B, C/group) per-slab probe scores."""
    if group == 1:
        return scores
    b, c = scores.shape
    return scores.reshape(b, c // group, group).amax(dim=2)


# ---------------------------------------------------------------------------
# Query orchestration
# ---------------------------------------------------------------------------

def _plan_probes(
    queries: torch.Tensor, centroids: torch.Tensor, num_base: int, c_tot: int,
    block_q: int, union: int, group: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """normalize → pad to block_q → sort by top-1 slab → block-max union
    (+ overflow slabs) → (sorted padded queries, probe list, order).
    ``c_tot`` counts slabs; a slab's score is its clusters' max."""
    q = l2_normalize(queries).float()
    b, d = q.shape
    pad_b = _round_up(b, block_q)
    if pad_b != b:
        q = torch.cat([q, q.new_zeros((pad_b - b, d))])
    scores_flat = _group_max(q @ centroids.float().T, group)
    if pad_b != b:
        # a zero padding row scores 0 against every centroid, which beats a
        # real query whose sims are all negative: keep it out of the union
        scores_flat[b:] = -1e9
    top1 = torch.argmax(scores_flat, dim=1)
    order = torch.argsort(top1, stable=True)
    q = q[order].contiguous()
    block_scores = scores_flat[order].reshape(pad_b // block_q, block_q, -1).amax(dim=1)
    probe_ids = torch.argsort(block_scores, dim=1, descending=True, stable=True)[:, :union]
    n_base = num_base // group
    if c_tot > n_base:
        over = torch.arange(n_base, c_tot, device=q.device).expand(probe_ids.shape[0], -1)
        probe_ids = torch.cat([probe_ids, over], dim=1)
    return q, probe_ids.to(torch.int32).contiguous(), order


def _rescore(q, i_c, rescore_data, k: int):
    """Re-score the scan's candidates ``i_c`` (B, k') against the rescore
    copy with the f32 queries and keep the top k. As ``lax.top_k`` over the
    candidate list: equal scores keep the earlier candidate (coarse rank),
    not the lower id; id -1 scores −inf."""
    cand = rescore_data[i_c.long().clamp(0, rescore_data.shape[0] - 1)]
    es = torch.einsum("bd,bkd->bk", q.float(), cand.float())
    es = torch.where(i_c >= 0, es, torch.tensor(float("-inf"), device=es.device))
    return _top_by_position(es, i_c, k)


def _top_by_position(s, i, k: int):
    """``lax.top_k`` order: score desc, the lower position first among
    equal scores (a stable sort, not ``torch.topk``; on CUDA tensors above
    ``MAX_K`` the select kernel, by position)."""
    if s.is_cuda and k > MAX_K:
        ts, pos = topk_select_cuda(s.float().contiguous(), min(k, s.shape[1]))
        return ts, torch.gather(i, 1, pos.long())
    top = torch.argsort(s, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(s, 1, top), torch.gather(i, 1, top)


def _ivf_query_fused(
    queries, centroids, data_padded, ids_padded, num_base: int, k: int,
    block_q: int, union: int, approx_width: int = 0, acc_slots: int = 1,
    scales_padded=None, rescore_data=None, k_scan: int = 0, group: int = 1,
    per_probe: bool = False, probes_per_step: int = 1, final_merge: str = "kernel",
    dma_pipeline: bool = False, dma_buffers: int = 2, zero_tiles=None,
):
    """plan → scan at ``k_scan`` (default k) → with ``rescore_data``, the
    rescore of the scan's candidates down to k → unsort. The scan is the
    reference's branch for the options: per_probe (K1-opt, each probe's
    top-k pooled and selected here), final_merge "packed" (K9), dma_pipeline
    (K10), probes_per_step > 1 (K11a), the idless scan on a sentinel index
    with a single-slot fold and the in-kernel merge (K11b), the raw
    accumulator for final_merge "xla" / "xla_approx" (K1-opt; both take the
    exact top-k here — the reference's ``approx_max_k`` is exact on its CPU
    too), else K1 / K4. Sentinel slabs (D+1) take the queries with a 1
    appended and their scores come back shifted by 2; ``zero_tiles`` is
    their ``zero_tile_map``, which K11b reads in place of ids."""
    with span("ts.ivf.plan"):
        q, probe_ids, order = _plan_probes(
            queries, centroids, num_base, data_padded.shape[0], block_q, union, group
        )
    k_scan = k_scan or k
    do_rescore = rescore_data is not None and k_scan > k
    d, dw = q.shape[1], data_padded.shape[-1]
    shift = 0.0
    q_kern = q
    if dw == d + 1:   # sentinel layout: live rows +2, dead slots 0
        q_kern = torch.cat([q, q.new_ones((q.shape[0], 1))], dim=1).contiguous()
        shift = 2.0
    idless = (
        dw == d + 1 and approx_width > 0 and not per_probe and probes_per_step == 1
        and scales_padded is None and final_merge == "kernel" and acc_slots == 1
    )
    emit_acc = (
        final_merge in ("xla", "xla_approx") and approx_width > 0
        and not per_probe and probes_per_step == 1
    )
    with span("ts.ivf.scan"):
        if per_probe:
            s_pp, i_pp = ivf_scan(q_kern, probe_ids, data_padded, ids_padded, k, block_q,
                                  scales=scales_padded, per_probe=True)
            pool_s = s_pp.permute(1, 0, 2).reshape(q.shape[0], -1)
            pool_i = i_pp.permute(1, 0, 2).reshape(q.shape[0], -1)
            s, i = _top_by_position(pool_s, pool_i,
                                    min(k_scan, pool_s.shape[1]) if do_rescore else k)
        elif final_merge == "packed":
            if scales_padded is not None:
                raise ValueError("packed fold does not support int8 scales")
            if dw != d:
                raise ValueError("packed fold is incompatible with sentinel")
            out_p = ivf_scan_packed(q, probe_ids, data_padded, ids_padded, k_scan, block_q,
                                    approx_width, max(acc_slots, 1))
            s, i = _unpack_candidates(out_p, probe_ids, ids_padded, block_q)
        elif dma_pipeline:
            if scales_padded is not None:
                raise ValueError("dma_pipeline does not support int8 scales")
            s, i = ivf_scan_dma(q_kern, probe_ids, data_padded, ids_padded, k_scan, block_q,
                                max(acc_slots, 1), dma_buffers)
        elif idless:
            s, i = ivf_scan_idless(q_kern, probe_ids, data_padded, k_scan, block_q,
                                   approx_width, zero_tiles)
            # flat slot ids → corpus ids with one (B, k) gather
            ids_flat = ids_padded.reshape(-1)
            i = torch.where(i >= 0, ids_flat[i.long().clamp(0, ids_flat.shape[0] - 1)], -1)
        elif probes_per_step > 1:
            if not approx_width:
                raise ValueError("probes_per_step>1 needs the approx path")
            s, i = ivf_scan_multiprobe(q_kern, probe_ids, data_padded, ids_padded, k_scan,
                                       block_q, probes_per_step, scales_padded)
        else:
            s, i = ivf_scan(q_kern, probe_ids, data_padded, ids_padded, k_scan, block_q,
                            approx_width=approx_width,
                            acc_slots=acc_slots if approx_width else 1,
                            scales=scales_padded, emit_acc=emit_acc)
            if emit_acc:
                s, i = _top_by_position(s, i, k_scan)
    with span("ts.ivf.merge"):
        if do_rescore:
            s, i = _rescore(q, i, rescore_data, k)
        elif final_merge != "packed":
            s = s - shift
        inv = torch.argsort(order)
        return s[inv], i[inv]


def _ivf_query_xla(
    q, centroids, data_padded, ids_padded, num_base, k, probes, chunk_q=16,
    scales_padded=None, group=1,
):
    """Per-query probes (the reference's XLA path): each query scans its own
    top-``probes`` slabs plus the overflow slabs (f32 queries; int8 scores ×
    the slot's scale; sentinel slabs take the query with a 1 appended and
    the scores shift back by 2); ties go to the earlier (probe, slot)
    position, as ``lax.top_k`` does."""
    b, d = q.shape
    c_tot, mc, dw = data_padded.shape
    n_base = num_base // group
    cscores = _group_max(q.float() @ centroids.float().T, group)
    shift = 0.0
    q = q.float()
    if dw == d + 1:
        q = torch.cat([q, q.new_ones((b, 1))], dim=1)
        shift = 2.0
    probe = torch.argsort(cscores, dim=1, descending=True, stable=True)[:, :probes]
    if c_tot > n_base:
        over = torch.arange(n_base, c_tot, device=q.device).expand(b, -1)
        probe = torch.cat([probe, over], dim=1)
    out_s, out_i = [], []
    for st in range(0, b, chunk_q):
        qc, pc = q[st:st + chunk_q], probe[st:st + chunk_q]
        s = torch.einsum("qd,qpmd->qpm", qc, data_padded[pc].float())
        if scales_padded is not None:
            s = s * scales_padded[pc]
        cid = ids_padded[pc]
        s = torch.where(cid >= 0, s, torch.tensor(float("-inf"), device=q.device))
        s, cid = s.reshape(qc.shape[0], -1), cid.reshape(qc.shape[0], -1)
        ts, ti = _top_by_position(s, cid, k)
        out_s.append(ts - shift)
        out_i.append(ti)
    return torch.cat(out_s), torch.cat(out_i)


class IVFIndex:
    def __init__(
        self,
        centroids: torch.Tensor,     # (C, D)
        data_padded: torch.Tensor,   # (C_tot/g, g·Mc, D or D+1), C_tot = C + overflow
        ids_padded: torch.Tensor,    # (C_tot/g, g·Mc) int32, -1 = empty
        num_base_clusters: int,
        config: IndexConfig,
        scales_padded: Optional[torch.Tensor] = None,  # same shape, f32, int8 slabs
        rescore_data: Optional[torch.Tensor] = None,   # (N, D) rows by id
        group: int = 1,              # clusters per stored slab
    ):
        if (data_padded.dtype == torch.int8) != (scales_padded is not None):
            raise ValueError("int8 slabs need scales_padded, and only they take it")
        if data_padded.shape[1] % group:
            raise ValueError("slab width must be a multiple of group")
        if group > 1 and num_base_clusters % group:
            raise ValueError("num_base_clusters must be a multiple of group")
        self.centroids = centroids
        self.data_padded = data_padded
        self.ids_padded = ids_padded
        self.scales_padded = scales_padded
        self.rescore_data = rescore_data
        self.group = group
        self.cluster_cap = data_padded.shape[1] // group   # slots a cluster
        self.num_base_clusters = num_base_clusters
        self.num_overflow = data_padded.shape[0] - num_base_clusters // group
        self.config = config
        self.device = data_padded.device
        # the sentinel layout, read from the shape: one trailing column, +2
        # on live rows and 0 on empty or removed slots
        self.sentinel = data_padded.shape[-1] == centroids.shape[-1] + 1
        # derived from the slabs, never saved: their 64-row tiles that are
        # all zero (never-written slots), which the idless scan (K11b) skips;
        # add() and remove() refresh it
        self.zero_tiles: Optional[torch.Tensor] = None
        self._refresh_zero_tiles()
        # host mirror of the flat id map, kept by add()/remove() so that
        # repeated small adds do not read the whole map back; None until
        # the first add()
        self._ids_host: Optional[np.ndarray] = None

    def _refresh_zero_tiles(self) -> None:
        if self.sentinel:
            self.zero_tiles = zero_tile_map(self.data_padded)

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    @classmethod
    def build(
        cls,
        corpus,                        # (N, D) L2-normalized
        config: IndexConfig = IndexConfig(),
        generator: Optional[torch.Generator] = None,
        data_dtype=torch.float32,
        spill_choices: int = 3,
        device="cuda",
        keep_rescore: Optional[bool] = None,   # default: on for int8 builds
        rescore_dtype=torch.bfloat16,
        sentinel: bool = False,
        group: int = 1,
    ) -> "IVFIndex":
        """Spill-balanced build: rows overflowing their cluster's Mc slots
        go to their 2nd/3rd nearest centroid's free slots; only the residue
        lands in always-scanned overflow slabs. Mc is the densest cluster,
        capped at 4× the mean (or ``config.max_cluster_size``), rounded up
        to 512 when ≥ 1024 and to 8 otherwise. ``config.quantize_int8`` (or
        ``data_dtype=torch.int8``) stores per-row int8 codes and scales and,
        unless ``keep_rescore=False``, a ``rescore_dtype`` copy of the
        corpus for the rescore. ``sentinel`` appends the +2 column (not with
        int8); ``group`` (a power of two) rounds the cluster count down to a
        multiple of it, orders the centroids by ``_affinity_group_perm`` and
        stores ``group`` clusters a slab, the overflow padded to a slab."""
        dev = resolve_device(device)
        corpus = torch.as_tensor(corpus).to(dev)
        n, d = corpus.shape
        c = min(config.num_clusters, max(n // 32, 1))
        if group > 1:
            if group & (group - 1):
                raise ValueError("group must be a power of two")
            c = max(group, c // group * group)
        centroids, _ = kmeans(corpus, c, iters=config.kmeans_iters, generator=generator)
        if group > 1:
            perm = _affinity_group_perm(centroids.cpu().numpy(), group)
            centroids = centroids[torch.as_tensor(perm, device=dev)]
        spill_choices = min(spill_choices, c)
        choices = assign_clusters_topk(corpus, centroids, topk=spill_choices).T.cpu().numpy()

        mean_sz = max(int(np.ceil(n / c)), 1)
        first_counts = np.bincount(choices[:, 0], minlength=c)
        if config.max_cluster_size:
            mc = min(config.max_cluster_size, int(first_counts.max()))
        else:
            mc = min(int(first_counts.max()), 4 * mean_sz)
        mc = _round_up(max(mc, 8), 512 if mc >= 1024 else 8)

        # greedy balanced placement on the host (ids only)
        slot_of_row = np.full(n, -1, np.int64)
        fill = np.zeros(c, np.int64)
        for col in range(spill_choices):
            todo = np.nonzero(slot_of_row < 0)[0]
            if todo.size == 0:
                break
            cand = choices[todo, col]
            order = np.argsort(cand, kind="stable")
            rows_sorted = todo[order]
            cand_sorted = cand[order]
            starts = np.searchsorted(cand_sorted, np.arange(c))
            rank = np.arange(cand_sorted.size) - starts[cand_sorted]
            take = rank < mc - fill[cand_sorted]
            taken_rows = rows_sorted[take]
            taken_cl = cand_sorted[take]
            slot_of_row[taken_rows] = taken_cl * mc + fill[taken_cl] + rank[take]
            fill += np.bincount(taken_cl, minlength=c)

        leftover = np.nonzero(slot_of_row < 0)[0]
        n_over = leftover.size
        e = (n_over + mc - 1) // mc if n_over else 0
        e = _round_up(e, group)    # the overflow region pads to a slab boundary
        if n_over:
            slot_of_row[leftover] = c * mc + np.arange(n_over)
        c_tot = c + e

        is_int8 = config.quantize_int8 or data_dtype == torch.int8
        if sentinel and is_int8:
            raise ValueError("sentinel layout is incompatible with int8")
        width = d + 1 if sentinel else d
        slot_dev = torch.as_tensor(slot_of_row, device=dev)
        flat = torch.zeros((c_tot * mc, width), dtype=torch.int8 if is_int8 else data_dtype,
                           device=dev)
        sflat = torch.zeros((c_tot * mc,), dtype=torch.float32, device=dev) if is_int8 else None
        for i in range(0, n, _BUILD_SCATTER_CHUNK):
            j = min(i + _BUILD_SCATTER_CHUNK, n)
            if is_int8:
                # quantize per chunk: bounds the f32 transient to one chunk
                flat[slot_dev[i:j]], sflat[slot_dev[i:j]] = quantize_embeddings_int8(corpus[i:j])
            else:
                flat[slot_dev[i:j]] = _stored_rows(corpus[i:j], data_dtype, sentinel)
        ids_flat = np.full((c_tot * mc,), -1, np.int32)
        ids_flat[slot_of_row] = np.arange(n, dtype=np.int32)
        if keep_rescore is None:
            keep_rescore = is_int8
        n_slabs = c_tot // group
        return cls(
            centroids=centroids,
            data_padded=flat.view(n_slabs, group * mc, width),
            ids_padded=torch.as_tensor(ids_flat.reshape(n_slabs, group * mc), device=dev),
            num_base_clusters=c,
            config=config,
            scales_padded=sflat.view(n_slabs, group * mc) if is_int8 else None,
            rescore_data=corpus.to(rescore_dtype, copy=True) if keep_rescore else None,
            group=group,
        )

    # ------------------------------------------------------------------
    # Query
    # ------------------------------------------------------------------

    def _probe_ids(self, queries: torch.Tensor, probes: int) -> torch.Tensor:
        """(B, P) probe-slab ids per query (base slabs only); a slab's score
        is the max of its member centroids' sims."""
        scores = _group_max(queries.float() @ self.centroids.float().T, self.group)
        return torch.argsort(scores, dim=1, descending=True, stable=True)[:, :probes].to(torch.int32)

    def query_xla(self, queries, k: int = 10, probes: Optional[int] = None, chunk_q: int = 16):
        """Per-query probe semantics of the reference's XLA path (plain
        tensor code; the tests' second reference). No rescore, as there."""
        probes = min(probes or self.config.num_probes, self.num_base_clusters // self.group)
        q = l2_normalize(torch.as_tensor(queries).to(self.device))
        return _ivf_query_xla(
            q, self.centroids, self.data_padded, self.ids_padded,
            self.num_base_clusters, k, probes, chunk_q, self.scales_padded, self.group,
        )

    def scan_k(self, k: int, k_coarse: int = 0) -> int:
        """Candidates the scan keeps for a top-k query: ``k_coarse`` when
        the index has a rescore copy and ``k_coarse > k`` (0 = 2k, the
        reference's default; -1 = no rescore), else k."""
        if self.rescore_data is None:
            return k
        if k_coarse == 0:
            k_coarse = 2 * k
        return k_coarse if k_coarse > k else k

    def scan_mode(
        self, k_scan: int, approx_width: int = 0, acc_slots: int = 0, per_probe: bool = False,
        probes_per_step: int = 1, final_merge: str = "auto", dma_pipeline: bool = False,
    ) -> Tuple[int, int]:
        """The fold a query's scan at ``k_scan`` candidates runs, by the
        reference's option rules (``IVFIndex.query``) → (approx_width,
        acc_slots); approx_width 0 is the exact merge. ``acc_slots=0`` sizes
        the fold with ``_approx_merge_plan`` (falling back to exact when no
        slot count bounds the collision loss; to the capacity-gated plan for
        an explicit final_merge; at full width for dma_pipeline). Unlike the
        reference on a TPU, a dma_pipeline query never degrades for an Mc
        that is not a multiple of 128: the CUDA K10 takes any Mc."""
        if approx_width and per_probe:
            raise ValueError("approx_width and per_probe are exclusive")
        if final_merge not in ("auto", "kernel", "xla", "xla_approx", "packed"):
            raise ValueError(f"final_merge={final_merge!r}")
        explicit = final_merge in ("xla", "xla_approx", "packed")
        if explicit and not (approx_width and not per_probe and probes_per_step == 1):
            raise ValueError(
                "final_merge='xla' needs the plain deferred-merge path "
                "(approx_width > 0, no per_probe/probes_per_step)"
            )
        mc = self.data_padded.shape[1]
        w = _scan_width(mc, approx_width)
        if dma_pipeline:
            # the DMA kernel always folds at full slab width with its own
            # in-kernel merge
            if final_merge not in ("auto", "kernel"):
                raise ValueError(
                    "dma_pipeline uses the in-kernel merge; "
                    f"final_merge={final_merge!r} would be ignored"
                )
            if acc_slots == 0:
                w_dma, acc_slots = _approx_merge_plan(k_scan, mc, mc)
                if w_dma == 0:
                    w_dma, acc_slots = _approx_merge_plan(k_scan, mc, mc, tol=None)
                if w_dma == 0:
                    raise ValueError(
                        f"k={k_scan} too large for the full-width DMA fold "
                        f"at Mc={mc}; use the default pipeline (exact merge)"
                    )
        elif w and acc_slots == 0 and not per_probe and probes_per_step == 1:
            w_req = w
            w, acc_slots = _approx_merge_plan(k_scan, mc, w_req)
            if w == 0 and explicit:
                w, acc_slots = _approx_merge_plan(k_scan, mc, w_req, tol=None)
            if w == 0:
                if explicit:
                    raise ValueError(
                        f"k={k_scan} is too large for the deferred accumulator at "
                        f"cluster width {mc}; use approx_width=0 (exact merge) or a "
                        "wider index"
                    )
                acc_slots = 1
        acc_slots = acc_slots or 1
        # the multiprobe and DMA kernels fold at full slab width Mc
        guard_w = mc if (dma_pipeline or probes_per_step > 1) else w
        if guard_w and w and k_scan > acc_slots * guard_w:
            raise ValueError(
                f"k={k_scan} exceeds the deferred accumulator "
                f"({acc_slots}×{guard_w}); pass approx_width=0 or more acc_slots"
            )
        if (w and acc_slots > 1 and w % 128 and not dma_pipeline
                and probes_per_step == 1 and final_merge != "packed"):
            raise ValueError(
                "acc_slots > 1 needs a 128-aligned approx_width"
            )
        return w, acc_slots

    def query(
        self, queries, k: int = 10, probes: Optional[int] = None,
        block_q: int = 32, union_factor: int = 3,
        approx_width: int = 0,     # >0: deferred lane-class fold of this width
        acc_slots: int = 0,        # 0 = sized by _approx_merge_plan
        k_coarse: int = 0,         # rescore pool (see scan_k)
        per_probe: bool = False,   # each probe's exact top-k, merged here
        probes_per_step: int = 1,  # >1 (deferred only): K11a, full width
        final_merge: str = "auto",  # "kernel" | "xla" | "xla_approx" | "packed"
        dma_pipeline: bool = False,  # K10: the cp.async copy-ring scan
        dma_buffers: int = 2,        # its ring depth, 2-4
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """normalize → probe union → scan (K1 / K4, or the kernel of the
        option: per_probe and final_merge "xla" / "xla_approx" K1-opt,
        "packed" K9, dma_pipeline K10, probes_per_step K11a, the idless K11b
        on a sentinel index with a single-slot fold) → rescore against
        ``rescore_data`` when there is one → unsort, with the reference's
        option rules. → (scores (B, k) f32, ids (B, k) int32) on the
        index's device."""
        with span("ts.ivf.query"):
            n_slabs = self.num_base_clusters // self.group
            probes = min(probes or self.config.num_probes, n_slabs)
            k_scan = self.scan_k(k, k_coarse)
            approx_width, acc_slots = self.scan_mode(
                k_scan, approx_width, acc_slots, per_probe, probes_per_step, final_merge,
                dma_pipeline,
            )
            q = torch.as_tensor(queries).to(self.device)
            b = q.shape[0]
            if b == 0:
                return (torch.empty((0, k), device=self.device),
                        torch.empty((0, k), dtype=torch.int32, device=self.device))
            block_q = min(block_q, b)
            union = min(_round_up(probes * union_factor, 8), n_slabs)
            s, i = _ivf_query_fused(
                q, self.centroids, self.data_padded, self.ids_padded,
                self.num_base_clusters, k, block_q, union,
                approx_width=approx_width, acc_slots=acc_slots,
                scales_padded=self.scales_padded, k_scan=k_scan,
                rescore_data=self.rescore_data if k_scan > k else None,
                group=self.group, per_probe=per_probe, probes_per_step=probes_per_step,
                final_merge="kernel" if final_merge == "auto" else final_merge,
                dma_pipeline=dma_pipeline, dma_buffers=dma_buffers, zero_tiles=self.zero_tiles,
            )
            return s[:b], i[:b]

    # ------------------------------------------------------------------
    # Insert and delete on a built index
    # ------------------------------------------------------------------

    def add(self, rows, start_id: int) -> np.ndarray:
        """Insert new (normalized) rows without a rebuild: each row takes
        the lowest free slot of its nearest cluster (2nd/3rd choice when
        full), the rest fill free overflow slots, then new overflow slabs
        (a multiple of ``group`` clusters; scale 0 in their empty slots). An
        int8 index quantizes the rows; a sentinel index writes their +2; a
        rescore copy grows to hold them. → the ids start_id … start_id+n-1."""
        rows = torch.as_tensor(rows).to(self.device)
        n, d = rows.shape
        g = self.group
        mc = self.cluster_cap                    # slots of one cluster
        dw = self.data_padded.shape[-1]          # d (+1 with the sentinel)
        c_tot = self.data_padded.shape[0] * g    # clusters with the padding
        c = self.num_base_clusters
        topk = min(3, c)
        choices = assign_clusters_topk(rows, self.centroids, topk=topk).T.cpu().numpy()
        if self._ids_host is None or self._ids_host.size != self.ids_padded.numel():
            self._ids_host = self.ids_padded.reshape(-1).cpu().numpy().astype(np.int32)
        # one row a cluster: grouped slabs keep the flat, cluster-major order
        ids_h = self._ids_host.reshape(-1, mc)
        # free slots per cluster: the actual holes (after remove() the live
        # count is no longer the next free offset); lowest first
        free_of = {}

        def free_list(cl):
            if cl not in free_of:
                free_of[cl] = list(np.nonzero(ids_h[cl] < 0)[0][::-1])
            return free_of[cl]

        slot = np.full(n, -1, np.int64)
        for col in range(topk):
            for i in np.nonzero(slot < 0)[0]:
                fl = free_list(int(choices[i, col]))
                if fl:
                    slot[i] = int(choices[i, col]) * mc + fl.pop()

        leftover = np.nonzero(slot < 0)[0]
        extra = 0
        if leftover.size:
            over_ids = ids_h[c:].reshape(-1)
            free = np.nonzero(over_ids < 0)[0]
            take_n = min(free.size, leftover.size)
            slot[leftover[:take_n]] = c * mc + free[:take_n]
            leftover = leftover[take_n:]
            if leftover.size:
                extra = _round_up((leftover.size + mc - 1) // mc, g)
                slot[leftover] = c_tot * mc + np.arange(leftover.size)

        if extra:
            pad = extra * mc
            n_slabs = (c_tot + extra) // g
            self.data_padded = torch.cat([
                self.data_padded.reshape(-1, dw),
                torch.zeros((pad, dw), dtype=self.data_padded.dtype, device=self.device),
            ]).view(n_slabs, g * mc, dw)
            self.ids_padded = torch.cat([
                self.ids_padded.reshape(-1),
                torch.full((pad,), -1, dtype=torch.int32, device=self.device),
            ]).view(n_slabs, g * mc)
            if self.scales_padded is not None:
                self.scales_padded = torch.cat([
                    self.scales_padded.reshape(-1),
                    torch.zeros((pad,), dtype=torch.float32, device=self.device),
                ]).view(n_slabs, g * mc)
            c_tot += extra
            self.num_overflow = n_slabs - c // g
            self._ids_host = np.concatenate([self._ids_host, np.full(pad, -1, np.int32)])

        slot_dev = torch.as_tensor(slot, device=self.device)
        flat = self.data_padded.view(-1, dw)
        if self.scales_padded is not None:
            q, sc = quantize_embeddings_int8(rows)
            flat[slot_dev] = q
            self.scales_padded.view(-1)[slot_dev] = sc
        else:
            flat[slot_dev] = _stored_rows(rows, flat.dtype, self.sentinel)
        new_ids = np.arange(start_id, start_id + n, dtype=np.int32)
        self.ids_padded.view(-1)[slot_dev] = torch.as_tensor(new_ids, device=self.device)
        self._ids_host[slot] = new_ids
        self._refresh_zero_tiles()
        if self.rescore_data is not None:
            need = start_id + n
            have = self.rescore_data.shape[0]
            if need > have:
                self.rescore_data = torch.cat([
                    self.rescore_data,
                    torch.zeros((need - have, d), dtype=self.rescore_data.dtype,
                                device=self.device),
                ])
            self.rescore_data[torch.as_tensor(new_ids, device=self.device).long()] = (
                rows.to(self.rescore_data.dtype)
            )
        return new_ids

    def remove(self, remove_ids) -> int:
        """Clear the slots of the given ids (they then score −inf; the
        rescore copy keeps its rows, the id mask covers them). A sentinel
        index also zeroes their column, so that the idless scan, which reads
        no ids, scores them below every live row (their vectors stay, so
        they can still fill a result's tail as (q·x − 2, −1), as in the
        reference). → how many slots were cleared."""
        rem = np.unique(np.asarray(remove_ids, np.int64))
        if rem.size == 0:
            return 0
        flat = self.ids_padded.view(-1)
        rem_dev = torch.as_tensor(rem, dtype=flat.dtype, device=self.device)
        hit = torch.isin(flat, rem_dev) & (flat >= 0)
        n_removed = int(hit.sum())
        flat[hit] = -1
        if self._ids_host is not None:
            self._ids_host[np.isin(self._ids_host, rem) & (self._ids_host >= 0)] = -1
        if self.sentinel:
            self.data_padded.view(-1, self.data_padded.shape[-1])[hit, -1] = 0
            self._refresh_zero_tiles()
        return n_removed

    # ------------------------------------------------------------------
    # Persistence (the JAX package's npz layout)
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        dp, tag = _to_npz(self.data_padded)
        extra = {}
        if self.scales_padded is not None:
            extra["scales_padded"] = self.scales_padded.cpu().numpy()
        if self.rescore_data is not None:
            extra["rescore_data"], extra["rescore_dtype"] = _to_npz(self.rescore_data)
        np.savez(
            path,
            centroids=self.centroids.cpu().numpy(),
            data_padded=dp,
            data_dtype=tag,
            ids_padded=self.ids_padded.cpu().numpy(),
            num_base_clusters=self.num_base_clusters,
            num_clusters=self.config.num_clusters,
            num_probes=self.config.num_probes,
            group=self.group,
            **extra,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "IVFIndex":
        dev = resolve_device(device)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            tag = str(z["data_dtype"]) if "data_dtype" in z.files else ""
            rd_tag = str(z["rescore_dtype"]) if "rescore_dtype" in z.files else ""
            cfg = IndexConfig(
                num_clusters=int(z["num_clusters"]), num_probes=int(z["num_probes"])
            )
            return cls(
                centroids=torch.from_numpy(np.asarray(z["centroids"])).to(dev),
                data_padded=_from_npz(z["data_padded"], tag).to(dev),
                ids_padded=torch.from_numpy(np.asarray(z["ids_padded"]).astype(np.int32)).to(dev),
                num_base_clusters=int(z["num_base_clusters"]),
                config=cfg,
                scales_padded=(
                    torch.from_numpy(np.asarray(z["scales_padded"])).to(dev)
                    if "scales_padded" in z.files else None
                ),
                rescore_data=(
                    _from_npz(z["rescore_data"], rd_tag).to(dev)
                    if "rescore_data" in z.files else None
                ),
                group=int(z["group"]) if "group" in z.files else 1,
            )


def _stored_rows(rows: torch.Tensor, dtype, sentinel: bool) -> torch.Tensor:
    """Rows as the slabs store them: cast, and with the sentinel layout a
    trailing +2."""
    rows = rows.to(dtype)
    if sentinel:
        rows = torch.cat([rows, rows.new_full((rows.shape[0], 1), 2.0)], dim=1)
    return rows


def _to_npz(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype tag); bf16 persists as its uint16 bit view."""
    if t.dtype == torch.bfloat16:
        return bf16_to_bits(t), "bfloat16"
    a = t.cpu().numpy()
    return a, str(a.dtype)


def _from_npz(a: np.ndarray, tag: str) -> torch.Tensor:
    return bits_to_bf16(a) if tag == "bfloat16" else torch.from_numpy(np.asarray(a))
