"""Spherical k-means — the IVF build step (port of
``text_similarity_tpu.ops.kmeans``) as plain tensor ops: chunked matmul +
argmax for assignment, ``index_add_`` for the centroid sums. The row chunking
keeps the (chunk, C) score block bounded instead of materialising (N, C).
``kmeans_sharded`` runs the same iterations over a corpus held as row
shards on several devices (the sharded IVF index's global clusters).
Random draws come from an explicit ``torch.Generator``; they cannot match
the JAX package's, so builds agree in quality, not in centroids.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core.mesh import on_devices


def _chunk_rows(n: int, chunk: int) -> int:
    # small corpora need no 65536-row chunk
    return min(chunk, max(8, 1 << (max(n - 1, 1)).bit_length()))


def _scores(rows: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return rows.float() @ centroids.float().T


def assign_clusters(
    data: torch.Tensor,       # (N, D) L2-normalized
    centroids: torch.Tensor,  # (C, D) L2-normalized
    chunk: int = 65536,
) -> torch.Tensor:
    """argmax_c <x, centroid_c> per row (first maximum on ties) → (N,) int32."""
    n = data.shape[0]
    chunk = _chunk_rows(n, chunk)
    out = [
        torch.argmax(_scores(data[i:i + chunk], centroids), dim=1)
        for i in range(0, n, chunk)
    ]
    return torch.cat(out).to(torch.int32)


def assign_clusters_topk(
    data: torch.Tensor,
    centroids: torch.Tensor,
    topk: int = 3,
    chunk: int = 65536,
) -> torch.Tensor:
    """Per row, the ids of its ``topk`` nearest centroids, returned
    topk-major as **(topk, N)** like the reference."""
    n = data.shape[0]
    chunk = _chunk_rows(n, chunk)
    out = [
        torch.topk(_scores(data[i:i + chunk], centroids), topk, dim=1).indices.T
        for i in range(0, n, chunk)
    ]
    return torch.cat(out, dim=1).to(torch.int32)


def _cluster_sums(
    data: torch.Tensor, centroids: torch.Tensor, chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign the rows, then per cluster the f32 sum of its rows and its
    row count → (sums (C, D), counts (C,)) on the rows' device."""
    c, n = centroids.shape[0], data.shape[0]
    assign = assign_clusters(data, centroids, chunk=chunk).long()
    sums = torch.zeros((c, data.shape[1]), dtype=torch.float32, device=data.device)
    counts = torch.zeros((c,), dtype=torch.float32, device=data.device)
    for i in range(0, n, chunk):
        a = assign[i:i + chunk]
        sums.index_add_(0, a, data[i:i + chunk].float())
        counts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
    return sums, counts


def _new_centroids(sums, counts, rand_rows) -> torch.Tensor:
    """The means, empty clusters re-seeded from ``rand_rows``, normalized."""
    new = sums / counts.clamp_min(1.0)[:, None]
    new = torch.where(counts[:, None] > 0, new, rand_rows.float())
    norm = torch.linalg.norm(new, dim=1, keepdim=True)
    return new / norm.clamp_min(1e-12)


def _kmeans_iter(
    data: torch.Tensor, centroids: torch.Tensor, generator: torch.Generator,
    chunk: int,
) -> torch.Tensor:
    c, n = centroids.shape[0], data.shape[0]
    sums, counts = _cluster_sums(data, centroids, chunk)
    # re-seed empty clusters from random data rows
    rand_rows = data[
        torch.randint(0, n, (c,), generator=generator, device=generator.device)
        .to(data.device)
    ]
    return _new_centroids(sums, counts, rand_rows)


def kmeans(
    data: torch.Tensor,       # (N, D) L2-normalized
    num_clusters: int,
    iters: int = 12,
    generator: Optional[torch.Generator] = None,
    chunk: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means → (centroids (C, D) normalized f32, assignments
    (N,) int32). Initial centroids are distinct random rows; empty
    clusters are re-seeded from random rows each iteration."""
    if generator is None:
        generator = torch.Generator(device=data.device).manual_seed(0)
    n = data.shape[0]
    init_idx = torch.randperm(n, generator=generator, device=generator.device)[:num_clusters]
    centroids = data[init_idx.to(data.device)].float()
    for _ in range(iters):
        centroids = _kmeans_iter(data, centroids, generator, _chunk_rows(n, chunk))
    return centroids, assign_clusters(data, centroids, chunk=chunk)


def _take_rows(shards: Sequence[torch.Tensor], idx: torch.Tensor, device) -> torch.Tensor:
    """Rows ``idx`` (global row ids over the shards in order) → (len(idx),
    D) f32 on ``device``; only those rows move."""
    out = torch.empty((idx.shape[0], shards[0].shape[1]), dtype=torch.float32, device=device)
    idx = idx.to(device)
    lo = 0
    for shard in shards:
        hi = lo + shard.shape[0]
        sel = torch.nonzero((idx >= lo) & (idx < hi)).squeeze(1)
        if sel.numel():
            rows = shard[(idx[sel] - lo).to(shard.device)].float()
            out[sel] = rows.to(device)
        lo = hi
    return out


def kmeans_sharded(
    shards: Sequence[torch.Tensor],   # row shards of one (N, D) L2-normalized corpus
    num_clusters: int,
    iters: int = 12,
    generator: Optional[torch.Generator] = None,
    chunk: int = 65536,
) -> torch.Tensor:
    """Spherical k-means over a corpus held as row shards, each on its own
    device: distributed Lloyd. Each iteration assigns every shard's rows
    on its device and sums them per cluster there; the sums and counts are
    reduced onto the first shard's device, which computes the centroids
    and sends them back. No step gathers the corpus: only the C initial
    and re-seed rows move. The draws are ``kmeans``'s over the shards'
    concatenation (``generator`` on the first shard's device), so the
    result equals it up to the order of the float sums. → centroids (C,
    D) normalized f32 on the first shard's device."""
    dev0 = shards[0].device
    if generator is None:
        generator = torch.Generator(device=dev0).manual_seed(0)
    n = sum(s.shape[0] for s in shards)
    c = num_clusters
    chunk = _chunk_rows(n, chunk)
    init_idx = torch.randperm(n, generator=generator, device=generator.device)[:c]
    centroids = _take_rows(shards, init_idx, dev0)
    for _ in range(iters):
        on_dev = on_devices(centroids, [s.device for s in shards])
        sums = torch.zeros((c, shards[0].shape[1]), dtype=torch.float32, device=dev0)
        counts = torch.zeros((c,), dtype=torch.float32, device=dev0)
        for shard in shards:
            s_sum, s_cnt = _cluster_sums(shard, on_dev[shard.device], chunk)
            sums += s_sum.to(dev0)
            counts += s_cnt.to(dev0)
        rand_idx = torch.randint(0, n, (c,), generator=generator, device=generator.device)
        centroids = _new_centroids(sums, counts, _take_rows(shards, rand_idx, dev0))
    return centroids
