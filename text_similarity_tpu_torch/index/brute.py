"""Brute-force exact-kNN index over an EmbeddingStore (port of
``text_similarity_tpu.index.brute``): kernel K2 over the store's rows (K3
over an int8 store) with a 2k over-fetch and a host-side tombstone filter.
Serves small corpora and is the recall oracle of the IVF index; ``mine``
is all-pairs paraphrase mining over the stored rows.

An int8 store is scored with the semantics of the reference's Pallas kernel
(f32 queries against dequantized rows) on both devices; the reference's
XLA branch, which quantizes the queries too, is
``compress.quantize.int8_matmul_scores``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.topk import cosine_topk, cosine_topk_int8, l2_normalize
from .store import EmbeddingStore


class BruteForceIndex:
    def __init__(self, store: EmbeddingStore):
        self.store = store

    @classmethod
    def from_embeddings(cls, embeddings: torch.Tensor, capacity: Optional[int] = None):
        cap = capacity or embeddings.shape[0]
        store = EmbeddingStore(
            cap, embeddings.shape[1], embeddings.dtype, device=embeddings.device
        )
        store.add(embeddings)
        return cls(store)

    def query(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores (Q, k), ids (Q, k)) as numpy. Tombstoned rows are never
        returned: 2k rows are fetched and dead ones filtered on the host;
        if more than k of them were dead the tail holds -1 ids at -inf."""
        q = l2_normalize(torch.as_tensor(queries).to(self.store.device))
        kk = min(k * 2, self.store.size)
        if self.store.quantized:
            s, i = cosine_topk_int8(q.float(), self.store.view, self.store.scales_view, k=kk)
        else:
            s, i = cosine_topk(q, self.store.view, k=kk)
        s_h, i_h = s.cpu().numpy(), i.cpu().numpy()
        alive_h = self.store.alive_view.cpu().numpy()
        if not alive_h.all():
            s_h = np.where(alive_h[i_h], s_h, -np.inf)
            order = np.argsort(-s_h, axis=1, kind="stable")
            s_h = np.take_along_axis(s_h, order, axis=1)
            i_h = np.take_along_axis(i_h, order, axis=1)
            i_h = np.where(np.isfinite(s_h), i_h, -1)
        return s_h[:, :k], i_h[:, :k]

    def mine(self, k: int = 10, batch: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
        """All-pairs mining: for every stored row, its top-k nearest other
        alive rows (self-match and tombstones dropped) → (scores (N, k) f32,
        ids (N, k) int64; -1 / 0.0 where fewer exist, and for dead rows).
        An int8 store is dequantized once to f32 (an offline sweep), then
        K2 runs over it."""
        n = self.store.size
        corpus = self.store.view
        if self.store.quantized:
            corpus = corpus.float() * self.store.scales_view[:, None]
        alive_h = self.store.alive_view.cpu().numpy()
        n_dead = int((~alive_h).sum())
        k_fetch = min(k + 1 + n_dead, n)
        all_s = np.zeros((n, k), np.float32)
        all_i = np.full((n, k), -1, np.int64)
        for start in range(0, n, batch):
            stop = min(start + batch, n)
            s, i = cosine_topk(corpus[start:stop], corpus, k=k_fetch)
            s_h, i_h = s.cpu().numpy(), i.cpu().numpy()
            rows = np.arange(start, stop)[:, None]
            keep = (i_h != rows) & alive_h[i_h]
            order = np.argsort(~keep, axis=1, kind="stable")[:, :k]
            valid = np.take_along_axis(keep, order, axis=1)
            all_s[start:stop] = np.where(valid, np.take_along_axis(s_h, order, axis=1), 0.0)
            all_i[start:stop] = np.where(valid, np.take_along_axis(i_h, order, axis=1), -1)
        if n_dead:
            all_i[~alive_h] = -1
            all_s[~alive_h] = 0.0
        return all_s, all_i
