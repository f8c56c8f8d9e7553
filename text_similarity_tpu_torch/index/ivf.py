"""IVF (inverted-file) ANN index with the block-union scan (kernels K1
and K4).

Port of ``text_similarity_tpu.index.ivf``:

- **Build**: spherical k-means (ops/kmeans.py), then the spill-balanced
  padded layout — a (C_tot, Mc, D) slab tensor plus a (C_tot, Mc) id map
  (-1 = empty slot); rows that fit no cluster go to overflow slabs that
  every query scans. An int8 build (``IndexConfig.quantize_int8``) stores
  per-row int8 codes with (C_tot, Mc) f32 scales, and by default keeps a
  bf16 copy of the corpus (``rescore_data``, indexed by id) for the rescore.
- **Query** (``_ivf_query_fused``): normalise, score the centroids, sort the
  queries by their top-1 centroid (stable), give each ``block_q`` block of
  sorted queries one probe list — the top-``union`` of the block-max
  centroid scores, padding rows masked to −1e9 — append the overflow slabs,
  scan (K1; K4 over int8 slabs), then, with a rescore copy, re-score the
  scan's ``k_coarse`` (default 2k) candidates against it and keep the top
  k; unsort.
- The scan has two merge modes (see ``ivf_scan_reference``): exact, and the
  deferred lane-class fold sized by ``_approx_merge_plan``.
- ``add`` inserts rows into free slots of their nearest clusters (new
  overflow slabs for the rest), ``remove`` clears slots by id.

``ivf_scan`` runs the CUDA kernel (``csrc/ivf_scan.cu``) on CUDA tensors and
``ivf_scan_reference`` — the same block-union semantics in plain tensor
code — on CPU tensors. ``query_xla`` keeps the reference's per-query probe
semantics (its XLA path) as a second plain function for tests.

Not ported yet: grouped slabs, the sentinel layout, and the scan options
``per_probe``, ``probes_per_step``, ``final_merge``, ``dma_pipeline``.
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
from ..ops.topk import MAX_K, l2_normalize, select_topk
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

def _scan_width(mc: int, approx_width: int) -> int:
    if not approx_width:
        return 0
    w = min(approx_width, mc)
    return mc if mc % w else w


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
    Top-k order is (score desc, id asc); missing results are (−inf, −1)."""
    b, d = q.shape
    c_tot, mc, _ = data.shape
    w = _scan_width(mc, approx_width)
    qd = q.float() if data.dtype == torch.float32 else q.to(torch.bfloat16).float()
    out_s = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    neg = torch.tensor(float("-inf"), device=q.device)
    for blk in range(probe_list.shape[0]):
        rows = slice(blk * block_q, (blk + 1) * block_q)
        slabs = probe_list[blk].long()
        u = slabs.shape[0]
        s = torch.einsum("qd,umd->qum", qd[rows], data[slabs].float())
        if scales is not None:
            s = s * scales[slabs][None]
        cid = ids[slabs]
        s = torch.where(cid[None] >= 0, s, neg)
        bq = s.shape[0]
        if w:
            t = u * mc // w      # insertions per lane class, in (u, p) order
            s = s.reshape(bq, t, w)
            ci = cid.reshape(1, t, w).expand(bq, t, w)
            order = torch.argsort(s, dim=1, descending=True, stable=True)[:, :acc_slots]
            acc_s = torch.gather(s, 1, order)
            acc_i = torch.gather(ci, 1, order)
            if acc_s.shape[1] < acc_slots:
                pad = acc_slots - acc_s.shape[1]
                acc_s = torch.cat([acc_s, neg.expand(bq, pad, w)], dim=1)
                acc_i = torch.cat([acc_i, torch.full_like(acc_i[:, :1], -1).expand(bq, pad, w)], dim=1)
            acc_i = torch.where(acc_s == neg, torch.full_like(acc_i, -1), acc_i)
            cand_s, cand_i = acc_s.reshape(bq, -1), acc_i.reshape(bq, -1)
        else:
            cand_s = s.reshape(bq, -1)
            cand_i = torch.where(
                cand_s == neg, -1, cid.reshape(1, -1)
            ).to(torch.int32)
        if cand_s.shape[1] < k:
            pad = k - cand_s.shape[1]
            cand_s = torch.cat([cand_s, neg.expand(bq, pad)], dim=1)
            cand_i = torch.cat([cand_i, torch.full((bq, pad), -1, dtype=cand_i.dtype, device=q.device)], dim=1)
        out_s[rows], out_i[rows] = select_topk(cand_s, cand_i.to(torch.int32), k)
    return out_s, out_i


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 (f32/bf16 slabs) or K4 (int8 slabs with ``scales``) on the
    card; same contract as ``ivf_scan_reference``. q (B, D) f32,
    probe_list (B/block_q, U) int32, data (C_tot, Mc, D), ids and scales
    (C_tot, Mc) int32 / f32 — contiguous CUDA tensors; D a multiple of 32
    (≤ 1024), k ≤ 256, acc_slots ≤ 4. The two kernels count their launches
    apart (``ivf_scan_cuda.launches``, ``.launches_int8``)."""
    _cuda.require_cuda(q, "q", (torch.float32,), 2)
    _cuda.require_cuda(probe_list, "probe_list", (torch.int32,), 2)
    _cuda.require_cuda(data, "data", (torch.float32, torch.bfloat16, torch.int8), 3)
    _cuda.require_cuda(ids, "ids", (torch.int32,), 2)
    int8 = data.dtype == torch.int8
    if int8 != (scales is not None):
        raise ValueError("int8 slabs need scales, and only int8 slabs take them")
    b, d = q.shape
    c_tot, mc, dd = data.shape
    n_blocks, u = probe_list.shape
    if dd != d or d % 32 or d > 1024:
        raise ValueError(f"dims: q {d}, data {dd} (need equal, %32, ≤1024)")
    if tuple(ids.shape) != (c_tot, mc):
        raise ValueError(f"ids shape {tuple(ids.shape)} != {(c_tot, mc)}")
    if int8:
        _cuda.require_cuda(scales, "scales", (torch.float32,), 2)
        if tuple(scales.shape) != (c_tot, mc):
            raise ValueError(f"scales shape {tuple(scales.shape)} != {(c_tot, mc)}")
    if block_q < 1 or b % block_q or n_blocks != b // block_q:
        raise ValueError(f"B={b} must be n_blocks={n_blocks} × block_q={block_q}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    w = _scan_width(mc, approx_width)
    slots = acc_slots if w else 0
    if w and not 1 <= slots <= 4:
        raise ValueError(f"acc_slots={acc_slots} must be in [1, 4]")
    width = w or mc
    dev = q.device
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    n_ranges = -(-width // 128)
    part_s = torch.empty((b, n_ranges, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_ranges, k), dtype=torch.int32, device=dev)
    outs = (part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            _cuda.stream_handle(dev))
    dims = (b, d, u, c_tot, mc, block_q, k, width, slots)
    if int8:
        err = _cuda.lib().ts_ivf_scan_int8(
            q.data_ptr(), probe_list.data_ptr(), data.data_ptr(), scales.data_ptr(),
            ids.data_ptr(), *dims, *outs,
        )
        _cuda.check(err, "ivf_scan_int8 kernel")
        ivf_scan_cuda.launches_int8 += 1
    else:
        err = _cuda.lib().ts_ivf_scan(
            q.data_ptr(), probe_list.data_ptr(), data.data_ptr(),
            int(data.dtype == torch.bfloat16), ids.data_ptr(), *dims, *outs,
        )
        _cuda.check(err, "ivf_scan kernel")
        ivf_scan_cuda.launches += 1
    return out_s, out_i


ivf_scan_cuda.launches = 0
ivf_scan_cuda.launches_int8 = 0


def ivf_scan(q, probe_list, data, ids, k, block_q, approx_width=0, acc_slots=1, scales=None):
    """K1 / K4: the CUDA kernel for CUDA slabs, the plain version for CPU
    slabs."""
    if data.is_cuda:
        return ivf_scan_cuda(
            q, probe_list, data, ids, k, block_q, approx_width, acc_slots, scales
        )
    return ivf_scan_reference(
        q, probe_list, data, ids, k, block_q, approx_width, acc_slots, scales
    )


# ---------------------------------------------------------------------------
# Query orchestration
# ---------------------------------------------------------------------------

def _plan_probes(
    queries: torch.Tensor, centroids: torch.Tensor, num_base: int, c_tot: int,
    block_q: int, union: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """normalize → pad to block_q → sort by top-1 centroid → block-max
    union (+ overflow slabs) → (sorted padded queries, probe list, order)."""
    q = l2_normalize(queries).float()
    b, d = q.shape
    pad_b = _round_up(b, block_q)
    if pad_b != b:
        q = torch.cat([q, q.new_zeros((pad_b - b, d))])
    scores_flat = q @ centroids.float().T
    if pad_b != b:
        # a zero padding row scores 0 against every centroid, which beats a
        # real query whose sims are all negative: keep it out of the union
        scores_flat[b:] = -1e9
    top1 = torch.argmax(scores_flat, dim=1)
    order = torch.argsort(top1, stable=True)
    q = q[order].contiguous()
    block_scores = scores_flat[order].reshape(pad_b // block_q, block_q, -1).amax(dim=1)
    probe_ids = torch.argsort(block_scores, dim=1, descending=True, stable=True)[:, :union]
    if c_tot > num_base:
        over = torch.arange(num_base, c_tot, device=q.device).expand(probe_ids.shape[0], -1)
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
    top = torch.argsort(es, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(es, 1, top), torch.gather(i_c, 1, top)


def _ivf_query_fused(
    queries, centroids, data_padded, ids_padded, num_base: int, k: int,
    block_q: int, union: int, approx_width: int = 0, acc_slots: int = 1,
    scales_padded=None, rescore_data=None, k_scan: int = 0,
):
    """plan → scan at ``k_scan`` (default k) → with ``rescore_data``, the
    rescore of the scan's candidates down to k → unsort."""
    q, probe_ids, order = _plan_probes(
        queries, centroids, num_base, data_padded.shape[0], block_q, union
    )
    s, i = ivf_scan(
        q, probe_ids, data_padded, ids_padded, k_scan or k, block_q,
        approx_width=approx_width, acc_slots=acc_slots, scales=scales_padded,
    )
    if rescore_data is not None:
        s, i = _rescore(q, i, rescore_data, k)
    inv = torch.argsort(order)
    return s[inv], i[inv]


def _ivf_query_xla(
    q, centroids, data_padded, ids_padded, num_base, k, probes, chunk_q=16,
    scales_padded=None,
):
    """Per-query probes (the reference's XLA path): each query scans its own
    top-``probes`` clusters plus the overflow slabs (f32 queries; int8
    scores × the slot's scale); ties go to the earlier (probe, slot)
    position, as ``lax.top_k`` does."""
    b, d = q.shape
    c_tot, mc, _ = data_padded.shape
    cscores = q.float() @ centroids.float().T
    probe = torch.argsort(cscores, dim=1, descending=True, stable=True)[:, :probes]
    if c_tot > num_base:
        over = torch.arange(num_base, c_tot, device=q.device).expand(b, -1)
        probe = torch.cat([probe, over], dim=1)
    out_s, out_i = [], []
    for st in range(0, b, chunk_q):
        qc, pc = q[st:st + chunk_q].float(), probe[st:st + chunk_q]
        s = torch.einsum("qd,qpmd->qpm", qc, data_padded[pc].float())
        if scales_padded is not None:
            s = s * scales_padded[pc]
        cid = ids_padded[pc]
        s = torch.where(cid >= 0, s, torch.tensor(float("-inf"), device=q.device))
        s, cid = s.reshape(qc.shape[0], -1), cid.reshape(qc.shape[0], -1)
        top = torch.argsort(s, dim=1, descending=True, stable=True)[:, :k]
        out_s.append(torch.gather(s, 1, top))
        out_i.append(torch.gather(cid, 1, top))
    return torch.cat(out_s), torch.cat(out_i)


class IVFIndex:
    def __init__(
        self,
        centroids: torch.Tensor,     # (C, D)
        data_padded: torch.Tensor,   # (C_tot, Mc, D), C_tot = C + overflow
        ids_padded: torch.Tensor,    # (C_tot, Mc) int32, -1 = empty
        num_base_clusters: int,
        config: IndexConfig,
        scales_padded: Optional[torch.Tensor] = None,  # (C_tot, Mc) f32, int8 slabs
        rescore_data: Optional[torch.Tensor] = None,   # (N, D) rows by id
    ):
        if data_padded.shape[-1] != centroids.shape[-1]:
            raise NotImplementedError(
                "the sentinel (D+1) slab layout is not ported yet"
            )
        if (data_padded.dtype == torch.int8) != (scales_padded is not None):
            raise ValueError("int8 slabs need scales_padded, and only they take it")
        self.centroids = centroids
        self.data_padded = data_padded
        self.ids_padded = ids_padded
        self.scales_padded = scales_padded
        self.rescore_data = rescore_data
        self.num_base_clusters = num_base_clusters
        self.num_overflow = data_padded.shape[0] - num_base_clusters
        self.config = config
        self.device = data_padded.device
        # host mirror of the flat id map, kept by add()/remove() so that
        # repeated small adds do not read the whole map back; None until
        # the first add()
        self._ids_host: Optional[np.ndarray] = None

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
    ) -> "IVFIndex":
        """Spill-balanced build: rows overflowing their cluster's Mc slots
        go to their 2nd/3rd nearest centroid's free slots; only the residue
        lands in always-scanned overflow slabs. Mc is the densest cluster,
        capped at 4× the mean (or ``config.max_cluster_size``), rounded up
        to 512 when ≥ 1024 and to 8 otherwise. ``config.quantize_int8`` (or
        ``data_dtype=torch.int8``) stores per-row int8 codes and scales and,
        unless ``keep_rescore=False``, a ``rescore_dtype`` copy of the
        corpus for the rescore."""
        dev = resolve_device(device)
        corpus = torch.as_tensor(corpus).to(dev)
        n, d = corpus.shape
        c = min(config.num_clusters, max(n // 32, 1))
        centroids, _ = kmeans(corpus, c, iters=config.kmeans_iters, generator=generator)
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
        if n_over:
            slot_of_row[leftover] = c * mc + np.arange(n_over)
        c_tot = c + e

        is_int8 = config.quantize_int8 or data_dtype == torch.int8
        slot_dev = torch.as_tensor(slot_of_row, device=dev)
        flat = torch.zeros((c_tot * mc, d), dtype=torch.int8 if is_int8 else data_dtype, device=dev)
        sflat = torch.zeros((c_tot * mc,), dtype=torch.float32, device=dev) if is_int8 else None
        for i in range(0, n, _BUILD_SCATTER_CHUNK):
            j = min(i + _BUILD_SCATTER_CHUNK, n)
            if is_int8:
                # quantize per chunk: bounds the f32 transient to one chunk
                flat[slot_dev[i:j]], sflat[slot_dev[i:j]] = quantize_embeddings_int8(corpus[i:j])
            else:
                flat[slot_dev[i:j]] = corpus[i:j].to(data_dtype)
        ids_flat = np.full((c_tot * mc,), -1, np.int32)
        ids_flat[slot_of_row] = np.arange(n, dtype=np.int32)
        if keep_rescore is None:
            keep_rescore = is_int8
        return cls(
            centroids=centroids,
            data_padded=flat.view(c_tot, mc, d),
            ids_padded=torch.as_tensor(ids_flat.reshape(c_tot, mc), device=dev),
            num_base_clusters=c,
            config=config,
            scales_padded=sflat.view(c_tot, mc) if is_int8 else None,
            rescore_data=corpus.to(rescore_dtype, copy=True) if keep_rescore else None,
        )

    # ------------------------------------------------------------------
    # Query
    # ------------------------------------------------------------------

    def _probe_ids(self, queries: torch.Tensor, probes: int) -> torch.Tensor:
        """(B, P) probe ids per query (base clusters only)."""
        scores = queries.float() @ self.centroids.float().T
        return torch.argsort(scores, dim=1, descending=True, stable=True)[:, :probes].to(torch.int32)

    def query_xla(self, queries, k: int = 10, probes: Optional[int] = None, chunk_q: int = 16):
        """Per-query probe semantics of the reference's XLA path (plain
        tensor code; the tests' second reference). No rescore, as there."""
        probes = min(probes or self.config.num_probes, self.num_base_clusters)
        q = l2_normalize(torch.as_tensor(queries).to(self.device))
        return _ivf_query_xla(
            q, self.centroids, self.data_padded, self.ids_padded,
            self.num_base_clusters, k, probes, chunk_q, self.scales_padded,
        )

    def scan_mode(self, k: int, approx_width: int, acc_slots: int) -> Tuple[int, int]:
        """The merge mode a scan at ``k`` candidates runs → (approx_width,
        acc_slots); approx_width 0 is the exact merge. ``acc_slots=0``
        sizes the fold with ``_approx_merge_plan`` (falling back to exact
        when no slot count bounds the collision loss)."""
        w = _scan_width(self.data_padded.shape[1], approx_width)
        if w and acc_slots == 0:
            w, acc_slots = _approx_merge_plan(k, self.data_padded.shape[1], w)
        acc_slots = acc_slots or 1
        if w and k > acc_slots * w:
            raise ValueError(
                f"k={k} exceeds the deferred accumulator ({acc_slots}×{w}); "
                "pass approx_width=0 or more acc_slots"
            )
        return w, acc_slots

    def scan_k(self, k: int, k_coarse: int = 0) -> int:
        """Candidates the scan keeps for a top-k query: ``k_coarse`` when
        the index has a rescore copy and ``k_coarse > k`` (0 = 2k, the
        reference's default; -1 = no rescore), else k."""
        if self.rescore_data is None:
            return k
        if k_coarse == 0:
            k_coarse = 2 * k
        return k_coarse if k_coarse > k else k

    def query(
        self, queries, k: int = 10, probes: Optional[int] = None,
        block_q: int = 32, union_factor: int = 3,
        approx_width: int = 0,     # >0: deferred lane-class fold of this width
        acc_slots: int = 0,        # 0 = sized by _approx_merge_plan
        k_coarse: int = 0,         # rescore pool (see scan_k)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """normalize → probe union → scan (K1, or K4 over int8 slabs, on the
        card) → rescore against ``rescore_data`` when there is one → unsort.
        → (scores (B, k) f32, ids (B, k) int32) on the index's device."""
        n_slabs = self.num_base_clusters
        probes = min(probes or self.config.num_probes, n_slabs)
        q = torch.as_tensor(queries).to(self.device)
        b = q.shape[0]
        if b == 0:
            return (torch.empty((0, k), device=self.device),
                    torch.empty((0, k), dtype=torch.int32, device=self.device))
        block_q = min(block_q, b)
        union = min(_round_up(probes * union_factor, 8), n_slabs)
        k_scan = self.scan_k(k, k_coarse)
        approx_width, acc_slots = self.scan_mode(k_scan, approx_width, acc_slots)
        s, i = _ivf_query_fused(
            q, self.centroids, self.data_padded, self.ids_padded,
            self.num_base_clusters, k, block_q, union,
            approx_width=approx_width, acc_slots=acc_slots,
            scales_padded=self.scales_padded, k_scan=k_scan,
            rescore_data=self.rescore_data if k_scan > k else None,
        )
        return s[:b], i[:b]

    # ------------------------------------------------------------------
    # Insert and delete on a built index
    # ------------------------------------------------------------------

    def add(self, rows, start_id: int) -> np.ndarray:
        """Insert new (normalized) rows without a rebuild: each row takes
        the lowest free slot of its nearest cluster (2nd/3rd choice when
        full), the rest fill free overflow slots, then new overflow slabs
        (scale 0 in their empty slots). An int8 index quantizes the rows;
        a rescore copy grows to hold them. → the ids start_id … start_id+n-1."""
        rows = torch.as_tensor(rows).to(self.device)
        n, d = rows.shape
        mc = self.data_padded.shape[1]
        c_tot = self.data_padded.shape[0]
        c = self.num_base_clusters
        topk = min(3, c)
        choices = assign_clusters_topk(rows, self.centroids, topk=topk).T.cpu().numpy()
        if self._ids_host is None or self._ids_host.size != self.ids_padded.numel():
            self._ids_host = self.ids_padded.reshape(-1).cpu().numpy().astype(np.int32)
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
                extra = (leftover.size + mc - 1) // mc
                slot[leftover] = c_tot * mc + np.arange(leftover.size)

        if extra:
            pad = extra * mc
            self.data_padded = torch.cat([
                self.data_padded,
                torch.zeros((extra, mc, d), dtype=self.data_padded.dtype, device=self.device),
            ])
            self.ids_padded = torch.cat([
                self.ids_padded,
                torch.full((extra, mc), -1, dtype=torch.int32, device=self.device),
            ])
            if self.scales_padded is not None:
                self.scales_padded = torch.cat([
                    self.scales_padded,
                    torch.zeros((extra, mc), dtype=torch.float32, device=self.device),
                ])
            c_tot += extra
            self.num_overflow = c_tot - c
            self._ids_host = np.concatenate([self._ids_host, np.full(pad, -1, np.int32)])

        slot_dev = torch.as_tensor(slot, device=self.device)
        flat = self.data_padded.view(-1, d)
        if self.scales_padded is not None:
            q, sc = quantize_embeddings_int8(rows)
            flat[slot_dev] = q
            self.scales_padded.view(-1)[slot_dev] = sc
        else:
            flat[slot_dev] = rows.to(flat.dtype)
        new_ids = np.arange(start_id, start_id + n, dtype=np.int32)
        self.ids_padded.view(-1)[slot_dev] = torch.as_tensor(new_ids, device=self.device)
        self._ids_host[slot] = new_ids
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
        rescore copy keeps its rows, the id mask covers them). → how many
        slots were cleared."""
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
            group=1,
            **extra,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "IVFIndex":
        dev = resolve_device(device)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            if "group" in z.files and int(z["group"]) != 1:
                raise NotImplementedError(f"{path}: grouped slabs are not ported yet")
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
            )


def _to_npz(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype tag); bf16 persists as its uint16 bit view."""
    if t.dtype == torch.bfloat16:
        return bf16_to_bits(t), "bfloat16"
    a = t.cpu().numpy()
    return a, str(a.dtype)


def _from_npz(a: np.ndarray, tag: str) -> torch.Tensor:
    return bits_to_bf16(a) if tag == "bfloat16" else torch.from_numpy(np.asarray(a))
