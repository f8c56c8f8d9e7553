"""Brute-force exact-kNN index over an EmbeddingStore (port of
``text_similarity_tpu.index.brute``): kernel K2 over the store's rows with a
2k over-fetch and a host-side tombstone filter. Serves small corpora and is
the recall oracle of the IVF index. ``mine`` is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.topk import cosine_topk, l2_normalize
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
