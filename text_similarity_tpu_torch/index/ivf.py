"""IVF (inverted-file) ANN index with the block-union scan (kernel K1).

Port of ``text_similarity_tpu.index.ivf``:

- **Build**: spherical k-means (ops/kmeans.py), then the spill-balanced
  padded layout — a (C_tot, Mc, D) slab tensor plus a (C_tot, Mc) id map
  (-1 = empty slot); rows that fit no cluster go to overflow slabs that
  every query scans.
- **Query** (``_ivf_query_fused``): normalise, score the centroids, sort the
  queries by their top-1 centroid (stable), give each ``block_q`` block of
  sorted queries one probe list — the top-``union`` of the block-max
  centroid scores, padding rows masked to −1e9 — append the overflow slabs,
  scan (K1), unsort.
- The scan has two merge modes (see ``ivf_scan_reference``): exact, and the
  deferred lane-class fold sized by ``_approx_merge_plan``.

``ivf_scan`` runs the CUDA kernel (``csrc/ivf_scan.cu``) on CUDA tensors and
``ivf_scan_reference`` — the same block-union semantics in plain tensor
code — on CPU tensors. ``query_xla`` keeps the reference's per-query probe
semantics (its XLA path) as a second plain function for tests.

Not ported yet: ``add``/``remove`` on a built index, grouped slabs, the
sentinel layout, int8 slabs and the two-pass rescore, and the scan options
``per_probe``, ``probes_per_step``, ``final_merge``, ``dma_pipeline``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

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
    data: torch.Tensor,        # (C_tot, Mc, D) f32 or bf16
    ids: torch.Tensor,         # (C_tot, Mc) int32, -1 = empty
    k: int,
    block_q: int,
    approx_width: int = 0,
    acc_slots: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 (the reference's ``_ivf_body`` semantics).

    Every query of block i is scored against all slots of the slabs in
    ``probe_list[i]`` (queries rounded to bf16 first when the slabs are
    bf16; f32 accumulation); slots with id < 0 score −inf.
    - exact (``approx_width=0``): top-k over those slots;
    - deferred (width w): slot p of probe u is inserted, in (u, p) order,
      into lane class p mod w, which keeps its top-``acc_slots`` — a later
      entry ranks below an earlier one of equal score — and the top-k is
      taken over the S·w accumulator entries.
    Top-k order is (score desc, id asc); missing results are (−inf, −1)."""
    b, d = q.shape
    c_tot, mc, _ = data.shape
    w = _scan_width(mc, approx_width)
    qd = q.to(torch.bfloat16).float() if data.dtype == torch.bfloat16 else q.float()
    out_s = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    neg = torch.tensor(float("-inf"), device=q.device)
    for blk in range(probe_list.shape[0]):
        rows = slice(blk * block_q, (blk + 1) * block_q)
        slabs = probe_list[blk].long()
        u = slabs.shape[0]
        s = torch.einsum("qd,umd->qum", qd[rows], data[slabs].float())
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 on the card; same contract as ``ivf_scan_reference``.
    q (B, D) f32, probe_list (B/block_q, U) int32, data (C_tot, Mc, D) f32
    or bf16, ids (C_tot, Mc) int32 — contiguous CUDA tensors; D a multiple
    of 32 (≤ 1024), k ≤ 256, acc_slots ≤ 4."""
    _cuda.require_cuda(q, "q", (torch.float32,), 2)
    _cuda.require_cuda(probe_list, "probe_list", (torch.int32,), 2)
    _cuda.require_cuda(data, "data", (torch.float32, torch.bfloat16), 3)
    _cuda.require_cuda(ids, "ids", (torch.int32,), 2)
    b, d = q.shape
    c_tot, mc, dd = data.shape
    n_blocks, u = probe_list.shape
    if dd != d or d % 32 or d > 1024:
        raise ValueError(f"dims: q {d}, data {dd} (need equal, %32, ≤1024)")
    if tuple(ids.shape) != (c_tot, mc):
        raise ValueError(f"ids shape {tuple(ids.shape)} != {(c_tot, mc)}")
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
    err = _cuda.lib().ts_ivf_scan(
        q.data_ptr(), probe_list.data_ptr(), data.data_ptr(),
        int(data.dtype == torch.bfloat16), ids.data_ptr(),
        b, d, u, c_tot, mc, block_q, k, width, slots,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "ivf_scan kernel")
    ivf_scan_cuda.launches += 1
    return out_s, out_i


ivf_scan_cuda.launches = 0


def ivf_scan(q, probe_list, data, ids, k, block_q, approx_width=0, acc_slots=1):
    """K1: the CUDA kernel for CUDA slabs, the plain version for CPU slabs."""
    if data.is_cuda:
        return ivf_scan_cuda(q, probe_list, data, ids, k, block_q, approx_width, acc_slots)
    return ivf_scan_reference(q, probe_list, data, ids, k, block_q, approx_width, acc_slots)


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


def _ivf_query_fused(
    queries, centroids, data_padded, ids_padded, num_base: int, k: int,
    block_q: int, union: int, approx_width: int = 0, acc_slots: int = 1,
):
    q, probe_ids, order = _plan_probes(
        queries, centroids, num_base, data_padded.shape[0], block_q, union
    )
    s, i = ivf_scan(
        q, probe_ids, data_padded, ids_padded, k, block_q,
        approx_width=approx_width, acc_slots=acc_slots,
    )
    inv = torch.argsort(order)
    return s[inv], i[inv]


def _ivf_query_xla(q, centroids, data_padded, ids_padded, num_base, k, probes, chunk_q=16):
    """Per-query probes (the reference's XLA path): each query scans its own
    top-``probes`` clusters plus the overflow slabs; ties go to the earlier
    (probe, slot) position, as ``lax.top_k`` does."""
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
    ):
        if data_padded.shape[-1] != centroids.shape[-1]:
            raise NotImplementedError(
                "the sentinel (D+1) slab layout is not ported yet"
            )
        self.centroids = centroids
        self.data_padded = data_padded
        self.ids_padded = ids_padded
        self.num_base_clusters = num_base_clusters
        self.num_overflow = data_padded.shape[0] - num_base_clusters
        self.config = config
        self.device = data_padded.device

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
    ) -> "IVFIndex":
        """Spill-balanced build: rows overflowing their cluster's Mc slots
        go to their 2nd/3rd nearest centroid's free slots; only the residue
        lands in always-scanned overflow slabs. Mc is the densest cluster,
        capped at 4× the mean (or ``config.max_cluster_size``), rounded up
        to 512 when ≥ 1024 and to 8 otherwise."""
        if config.quantize_int8 or data_dtype == torch.int8:
            raise NotImplementedError(
                "int8 IVF slabs are not ported yet (ROADMAP queue 1: int8 serving)"
            )
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

        slot_dev = torch.as_tensor(slot_of_row, device=dev)
        flat = torch.zeros((c_tot * mc, d), dtype=data_dtype, device=dev)
        for i in range(0, n, _BUILD_SCATTER_CHUNK):
            j = min(i + _BUILD_SCATTER_CHUNK, n)
            flat[slot_dev[i:j]] = corpus[i:j].to(data_dtype)
        ids_flat = np.full((c_tot * mc,), -1, np.int32)
        ids_flat[slot_of_row] = np.arange(n, dtype=np.int32)
        return cls(
            centroids=centroids,
            data_padded=flat.view(c_tot, mc, d),
            ids_padded=torch.as_tensor(ids_flat.reshape(c_tot, mc), device=dev),
            num_base_clusters=c,
            config=config,
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
        tensor code; the tests' second reference)."""
        probes = min(probes or self.config.num_probes, self.num_base_clusters)
        q = l2_normalize(torch.as_tensor(queries).to(self.device))
        return _ivf_query_xla(
            q, self.centroids, self.data_padded, self.ids_padded,
            self.num_base_clusters, k, probes, chunk_q,
        )

    def scan_mode(self, k: int, approx_width: int, acc_slots: int) -> Tuple[int, int]:
        """The merge mode ``query`` runs → (approx_width, acc_slots);
        approx_width 0 is the exact merge. ``acc_slots=0`` sizes the fold
        with ``_approx_merge_plan`` (falling back to exact when no slot
        count bounds the collision loss)."""
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

    def query(
        self, queries, k: int = 10, probes: Optional[int] = None,
        block_q: int = 32, union_factor: int = 3,
        approx_width: int = 0,     # >0: deferred lane-class fold of this width
        acc_slots: int = 0,        # 0 = sized by _approx_merge_plan
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """normalize → probe union → scan (K1 on the card) → unsort.
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
        approx_width, acc_slots = self.scan_mode(k, approx_width, acc_slots)
        s, i = _ivf_query_fused(
            q, self.centroids, self.data_padded, self.ids_padded,
            self.num_base_clusters, k, block_q, union,
            approx_width=approx_width, acc_slots=acc_slots,
        )
        return s[:b], i[:b]

    # ------------------------------------------------------------------
    # Persistence (the JAX package's npz layout)
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self.data_padded.dtype == torch.bfloat16:
            dp, tag = bf16_to_bits(self.data_padded), "bfloat16"
        else:
            dp = self.data_padded.cpu().numpy()
            tag = str(dp.dtype)
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
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "IVFIndex":
        dev = resolve_device(device)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            missing = [
                name for name in ("scales_padded", "rescore_data") if name in z.files
            ]
            if missing or ("group" in z.files and int(z["group"]) != 1):
                raise NotImplementedError(
                    f"{path}: int8 slabs, rescore copies and grouped slabs are "
                    "not ported yet"
                )
            tag = str(z["data_dtype"]) if "data_dtype" in z.files else ""
            dp = (
                bits_to_bf16(z["data_padded"]) if tag == "bfloat16"
                else torch.from_numpy(np.asarray(z["data_padded"]))
            )
            cfg = IndexConfig(
                num_clusters=int(z["num_clusters"]), num_probes=int(z["num_probes"])
            )
            return cls(
                centroids=torch.from_numpy(np.asarray(z["centroids"])).to(dev),
                data_padded=dp.to(dev),
                ids_padded=torch.from_numpy(np.asarray(z["ids_padded"]).astype(np.int32)).to(dev),
                num_base_clusters=int(z["num_base_clusters"]),
                config=cfg,
            )
