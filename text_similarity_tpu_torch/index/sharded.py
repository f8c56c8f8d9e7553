"""Sharded indexes over the mesh ``index`` axis (port of
``text_similarity_tpu.index.sharded``): a corpus larger than one card's
memory is split by rows, one shard a position of the axis; each shard is
scanned on its device and the per-shard top-k lists are merged on the
first device (the reference's all-gather + ``topk_merge``).

- ``ShardedBruteForceIndex``: the rows zero-padded to a multiple of
  ``n_shards × 8``; each shard's exact top ``k + n_pad`` (kernel K2 through
  ``ops.topk.cosine_topk``; the zero rows score 0 and would otherwise push
  out real negative-score neighbours) with padding rows masked to −inf by
  their global id, then the merge.
- ``ShardedIVFIndex``: global clusters (spherical k-means over every shard
  by distributed Lloyd, ``ops.kmeans.kmeans_sharded``; or centroids the
  caller gives), then each shard's own capped layout under them: the rows
  wrap-padded to a multiple of the shard count, each row in the slot of its
  cluster by a stable sort, rows past a cluster's Mc slots in the shard's
  overflow slabs, every shard sized alike (C + E slabs of Mc) from the
  (shard, cluster) counts. A query probes the global centroids and scans
  each shard's slice of the probed clusters: ``impl="kernel"`` is the
  single-device index's block-union plan and scan (``_ivf_query_fused``:
  K1 on a CUDA tensor, its plain version on a CPU one) with the
  reference's serving rule, ``impl="xla"`` the per-query probes of the
  reference's XLA path; ``"auto"`` is the kernel on the card and the XLA
  path on the CPU, as the reference's auto is on its CPU.

A query returns one packed (Q, 2k) int32 tensor (``_pack_results``: the
f32 scores' bits, then the ids), so the answer reaches the host in one
copy. With one shard the shard's top-k is the answer and no merge runs.
Ties in the merge go to the lowest id.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.mesh import INDEX_AXIS, Mesh, on_devices
from ..ops.kmeans import assign_clusters, kmeans_sharded
from ..ops.topk import cosine_topk, l2_normalize, topk_merge
from .ivf import _approx_merge_plan, _ivf_query_fused, _ivf_query_xla, _round_up
from .ivf_modes import zero_tile_map


def _pack_results(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) f32 scores + (Q, k) ids → one (Q, 2k) int32 tensor, the
    scores' bits first (int32 carries them: ids below 2²³ would be f32
    denormals)."""
    return torch.cat([scores.float().contiguous().view(torch.int32), ids.to(torch.int32)], dim=1)


def _unpack_results(packed: torch.Tensor, k: int, n_q: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    arr = packed.cpu().numpy()
    if n_q is not None:
        arr = arr[:n_q]
    return arr[:, :k].copy().view(np.float32), arr[:, k:].copy()


def _merge(parts: List[Tuple[torch.Tensor, torch.Tensor]], k: int, device) -> torch.Tensor:
    """Per-shard (scores, ids) → the packed global top k on ``device``; one
    shard's list is the answer as it is."""
    if len(parts) == 1:
        return _pack_results(*parts[0])
    s_all = torch.stack([s.to(device) for s, _ in parts], dim=1)
    i_all = torch.stack([i.to(device) for _, i in parts], dim=1)
    return _pack_results(*topk_merge(s_all, i_all, k))


class ShardedBruteForceIndex:
    """Exact kNN over a row-sharded corpus."""

    def __init__(self, mesh: Mesh, shards: List[torch.Tensor], n_total: int):
        self.mesh = mesh
        self.shards = shards              # (shard_rows, D) a position of the index axis
        self.n_total = n_total
        self.shard_rows = shards[0].shape[0]
        self.n_pad = self.shard_rows * len(shards) - n_total

    @classmethod
    def build(cls, mesh: Mesh, embeddings) -> "ShardedBruteForceIndex":
        emb = torch.as_tensor(embeddings)
        n, d = emb.shape
        devs = mesh.axis_devices(INDEX_AXIS)
        rows = _round_up(n, len(devs) * 8) // len(devs)
        shards = []
        for i, dev in enumerate(devs):
            part = emb[i * rows:(i + 1) * rows].to(dev, copy=True)
            if part.shape[0] < rows:      # zero rows; masked by their global id
                part = torch.cat([part, part.new_zeros((rows - part.shape[0], d))])
            shards.append(part.contiguous())
        return cls(mesh, shards, n)

    def query_packed(self, queries, k: int = 10) -> torch.Tensor:
        """→ the packed (Q, 2k) int32 answer on the first shard's device
        (``_pack_results``), with no host copy. Each shard takes its top
        ``min(k + n_pad, shard_rows)``, as the reference's."""
        k = min(k, self.n_total)
        k_local = min(k + self.n_pad, self.shard_rows)
        q = torch.as_tensor(queries).float()
        qs = {d: l2_normalize(qd)
              for d, qd in on_devices(q, [s.device for s in self.shards]).items()}
        parts = []
        for si, shard in enumerate(self.shards):
            s, i = cosine_topk(qs[shard.device], shard, k=k_local)
            gid = i + si * self.shard_rows
            parts.append((torch.where(gid < self.n_total, s, float("-inf")), gid))
        if len(parts) == 1:    # the reference's single-shard path still selects k
            parts = [topk_merge(parts[0][0][:, None], parts[0][1][:, None], k)]
        return _merge(parts, k, self.shards[0].device)

    def query(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        k = min(k, self.n_total)
        return _unpack_results(self.query_packed(queries, k), k)


class ShardedIVFIndex:
    """IVF over a row-sharded corpus with global clusters: every shard lays
    out its own rows under the same centroids; its first C slabs are the C
    global clusters, the rest its overflow. ``data_padded`` and
    ``ids_padded`` are lists, one (C_tot, Mc, D) slab tensor and one
    (C_tot, Mc) int32 id map (global ids, -1 empty) a shard."""

    def __init__(
        self,
        mesh: Mesh,
        centroids: torch.Tensor,           # (C, D) f32
        data_padded: List[torch.Tensor],   # a shard's (C_tot, Mc, D or D + 1)
        ids_padded: List[torch.Tensor],    # a shard's (C_tot, Mc) int32
        num_probes: int,
    ):
        self.mesh = mesh
        self.centroids = centroids
        self.data_padded = data_padded
        self.ids_padded = ids_padded
        self.num_probes = num_probes
        self.sentinel = data_padded[0].shape[-1] == centroids.shape[-1] + 1
        # the idless scan's all-zero tiles, a shard (the sentinel layout only)
        self.zero_tiles = [zero_tile_map(d) if self.sentinel else None for d in data_padded]
        self._centroids = on_devices(centroids, [d.device for d in data_padded])

    @property
    def num_base_clusters(self) -> int:
        return self.centroids.shape[0]

    @classmethod
    def build(
        cls, mesh: Mesh, embeddings, config,
        generator: Optional[torch.Generator] = None,
        data_dtype=None,
        sentinel: Optional[bool] = None,   # default off, as the reference's
        centroids=None,                    # (C, D): skip the k-means
    ) -> "ShardedIVFIndex":
        """Wrap-pad and shard the rows, run the global k-means (unless
        ``centroids`` are given), count each shard's rows a cluster, size
        Mc and the overflow E on the host, then lay out each shard on its
        device. Raises where a shard's overflow would drop rows."""
        emb = torch.as_tensor(embeddings)
        n, d = emb.shape
        devs = mesh.axis_devices(INDEX_AXIS)
        s = len(devs)
        rows_per = _round_up(n, s) // s
        pad_n = rows_per * s
        # wrap-pad: the pads repeat the first rows (k-means stays sane; the
        # layout drops them)
        shards = [
            emb[torch.arange(i * rows_per, (i + 1) * rows_per, device=emb.device) % n].to(dev)
            for i, dev in enumerate(devs)
        ]
        c = max(1, min(config.num_clusters, pad_n // 32))
        if centroids is None:
            centroids = kmeans_sharded(shards, c, iters=config.kmeans_iters, generator=generator)
        centroids = torch.as_tensor(centroids).float().to(devs[0])
        c = centroids.shape[0]
        data_dtype = data_dtype or emb.dtype
        sentinel = bool(sentinel)

        # phase 1: each shard's assignment (kept for phase 2, so the counts
        # that size the layout are the layout's) and its counts a cluster
        on_dev = on_devices(centroids, devs)
        assigns, counts = [], np.zeros((s, c), np.int64)
        for si, rows in enumerate(shards):
            a = assign_clusters(rows, on_dev[rows.device]).long()
            n_valid = min(max(n - si * rows_per, 0), rows_per)
            counts[si] = np.bincount(a[:n_valid].cpu().numpy(), minlength=c)
            assigns.append(a)

        # the host sizes every shard's layout alike from the count matrix
        mean_sz = max(int(math.ceil(rows_per / c)), 1)
        if config.max_cluster_size:
            # the densest (shard, cluster): a cap sized from global rows
            # would pad each shard's slab about S times past its need
            mc = min(config.max_cluster_size, int(counts.max()))
        else:
            mc = min(int(counts.max()), 4 * mean_sz)
        mc = _round_up(max(mc, 8), 512 if mc >= 1024 else 8)
        over_per_shard = np.maximum(counts - mc, 0).sum(axis=1)
        # +1 slack slab, as the reference sizes it
        e = int(max(1, -(-int(over_per_shard.max()) // mc))) + 1
        c_tot = c + e

        data, ids, n_dropped = [], [], 0
        for si, (rows, a) in enumerate(zip(shards, assigns)):
            flat, idmap, dropped = _shard_layout(
                rows, a, si, n, rows_per, c, mc, c_tot, data_dtype, sentinel)
            data.append(flat)
            ids.append(idmap)
            n_dropped += dropped
        if n_dropped:
            raise RuntimeError(
                f"sharded IVF build dropped {n_dropped} rows: overflow capacity exceeded "
                "— raise max_cluster_size or num_clusters"
            )
        return cls(mesh, centroids, data, ids, num_probes=config.num_probes)

    # ------------------------------------------------------------------
    # Query
    # ------------------------------------------------------------------

    def _impl(self, impl: str) -> str:
        if impl == "auto":
            return "kernel" if self.data_padded[0].is_cuda else "xla"
        if impl not in ("kernel", "xla"):
            raise ValueError(f"impl={impl!r}: auto, kernel or xla")
        return impl

    def kernel_plan(self, b: int, k: int, probes: int) -> Tuple[int, int, int, int]:
        """The kernel path's (block_q, union, approx_width, acc_slots) for
        ``b`` queries: 64-query blocks whose own sorted probes are the union
        (factor 1) from 32 probes up, else 16-query blocks with factor 3;
        the deferred merge where ``_approx_merge_plan(k, Mc, 2048)`` bounds
        its loss."""
        n_base = self.num_base_clusters
        p = min(probes, n_base)
        block_q, uf = (min(64, b), 1) if p >= 32 else (min(16, b), 3)
        aw, slots = _approx_merge_plan(k, self.data_padded[0].shape[1], 2048)
        return block_q, min(_round_up(p * uf, 8), n_base), aw, slots

    def shard_query(self, si: int, q: torch.Tensor, k: int, probes: int, impl: str = "auto"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One shard's top k for L2-normalized queries ``q`` on its device
        → (scores, global ids), (B', k) with B' the batch padded to the
        query block on the kernel path (``kernel_plan``)."""
        data, ids = self.data_padded[si], self.ids_padded[si]
        cent = self._centroids[data.device]
        n_base = cent.shape[0]
        if self._impl(impl) == "xla":
            return _ivf_query_xla(q, cent, data, ids, n_base, k, min(probes, n_base))
        block_q, union, aw, slots = self.kernel_plan(q.shape[0], k, probes)
        return _ivf_query_fused(
            q, cent, data, ids, n_base, k, block_q, union,
            approx_width=aw, acc_slots=slots, zero_tiles=self.zero_tiles[si],
        )

    def query_packed(self, queries, k: int = 10, probes: Optional[int] = None,
                     impl: str = "auto") -> Tuple[torch.Tensor, int]:
        """→ (the packed (B', 2k') int32 answer on the first shard's device,
        the k' it holds): k is clamped to the probed candidate pool."""
        probes = probes or self.num_probes
        n_base = self.num_base_clusters
        c_tot, mc = self.data_padded[0].shape[:2]
        k = min(k, (min(probes, n_base) + (c_tot - n_base)) * mc)
        q = torch.as_tensor(queries).float()
        qs = {dev: l2_normalize(qd)
              for dev, qd in on_devices(q, [x.device for x in self.data_padded]).items()}
        parts = [self.shard_query(si, qs[data.device], k, probes, impl)
                 for si, data in enumerate(self.data_padded)]
        return _merge(parts, k, self.data_padded[0].device), k

    def query(self, queries, k: int = 10, probes: Optional[int] = None,
              impl: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        packed, k_eff = self.query_packed(queries, k, probes, impl)
        # the kernel path pads the batch to its query block: drop those rows
        return _unpack_results(packed, k_eff, len(queries))


def _shard_layout(rows, assign, si, n, rows_per, c, mc, c_tot, data_dtype, sentinel):
    """One shard's capped layout (the reference's phase 2): rows sorted
    stably by cluster (pads last), the first Mc of a cluster in its slab,
    the rest in the overflow slabs in sorted order, everything else into a
    trash slot that is cut off → ((C_tot, Mc, D'), (C_tot, Mc) int32, rows
    that did not fit)."""
    dev = rows.device
    local = torch.arange(rows_per, device=dev)
    valid = local < min(max(n - si * rows_per, 0), rows_per)
    a = torch.where(valid, assign, c)
    order = torch.argsort(a, stable=True)
    sa = a[order]
    starts = torch.searchsorted(sa, torch.arange(c, device=dev))
    rank = local - starts[sa.clamp(0, c - 1)]
    real = sa < c
    in_cap = real & (rank < mc)
    spill = real & ~in_cap
    over_rank = torch.cumsum(spill.long(), 0) - 1
    trash = c_tot * mc
    over_full = c * mc + over_rank >= trash
    slot = torch.where(in_cap, sa * mc + rank, c * mc + over_rank)
    slot = torch.where(real, slot, trash).clamp(0, trash)
    rows_sorted = rows[order].to(data_dtype)
    if sentinel:   # +2 marks a live row (the idless scan)
        rows_sorted = torch.cat([rows_sorted, rows_sorted.new_full((rows_per, 1), 2.0)], dim=1)
    gid = torch.where(real, si * rows_per + order, -1).to(torch.int32)
    flat = torch.zeros((trash + 1, rows_sorted.shape[1]), dtype=data_dtype, device=dev)
    flat[slot] = rows_sorted
    idmap = torch.full((trash + 1,), -1, dtype=torch.int32, device=dev)
    idmap[slot] = gid
    dropped = int((spill & over_full).sum())
    return (flat[:-1].reshape(c_tot, mc, -1).contiguous(),
            idmap[:-1].reshape(c_tot, mc).contiguous(), dropped)
