"""Semantic search pipeline (port of
``text_similarity_tpu.pipelines.search.SemanticSearchPipeline``).

corpus texts → embeddings on the card → EmbeddingStore → brute-force
search (kernel K2) below 100k documents, an IVF index (kernel K1) from
100k up → per query ``[(document, score, corpus_id), ...]``. An
``index_config`` with ``quantize_int8=True`` builds int8 IVF slabs with a
bf16 rescore copy (kernel K4 + rescore); with an int8 encoder
(``SentenceEncoder.to_int8``) that is the int8 serving path.

Documents added after the IVF build go into the built index (no rebuild);
``remove_documents`` tombstones the store and clears the index's slots.

Not ported yet: the mining pipeline and the sharded pipeline.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.precision import resolve_device
from ..index import BruteForceIndex, EmbeddingStore, IVFIndex

logger = logging.getLogger(__name__)


def _pad_pow2(q_emb: torch.Tensor) -> torch.Tensor:
    """Pad an (N, D) query batch to the next power-of-2 row count by
    replicating the last row (zero rows would hijack the IVF block-max
    probe union; replicas are harmless)."""
    n_q = q_emb.shape[0]
    bucket = 1
    while bucket < n_q:
        bucket *= 2
    if bucket != n_q:
        q_emb = torch.cat([q_emb, q_emb[-1:].expand(bucket - n_q, q_emb.shape[1])])
    return q_emb


class SemanticSearchPipeline:
    """corpus texts → embeddings → index → query API."""

    IVF_MIN_DOCS = 100_000

    def __init__(
        self,
        encoder,                       # SentenceEncoder
        corpus: Optional[Sequence[str]] = None,
        index_config: Optional[IndexConfig] = None,  # None = size by corpus
        use_ivf: Optional[bool] = None,  # None = by corpus size
        capacity: Optional[int] = None,
        batch_size: int = 128,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if encoder.device.type != self.device.type:
            raise ValueError(
                f"encoder is on {encoder.device}, pipeline on {self.device}"
            )
        self.encoder = encoder
        self.index_config = index_config
        self.batch_size = batch_size
        self.corpus: List[str] = []
        self.store: Optional[EmbeddingStore] = None
        self.ivf: Optional[IVFIndex] = None
        self._id_remap: Optional[np.ndarray] = None
        self.use_ivf = use_ivf
        self._capacity = capacity
        if corpus:
            self.add_documents(corpus)

    def _ensure_store(self, first_batch_dim: int):
        if self.store is None:
            cap = self._capacity or max(first_batch_dim * 2, 1024)
            self.store = EmbeddingStore(cap, self.encoder.embedding_dim, device=self.device)

    def add_documents(self, texts: Sequence[str]) -> np.ndarray:
        """Encode and append to the store; a built IVF index takes the new
        rows in place, unless it was built over a tombstone remap (then it
        is dropped and rebuilt at the next query). → the new corpus ids."""
        emb = self.encoder.encode(texts, batch_size=self.batch_size, device_output=True)
        self._ensure_store(len(texts))
        while self.store.size + len(texts) > self.store.capacity:
            self.store.grow(self.store.capacity * 2)
        ids = self.store.add(emb)
        self.corpus.extend(texts)
        if self.ivf is not None and self._id_remap is None:
            self.ivf.add(emb, start_id=int(ids[0]))
        else:
            self.ivf = None
        return ids

    def remove_documents(self, ids: Sequence[int]) -> int:
        """Tombstone the store rows and clear their IVF slots (no rebuild).
        → how many of the rows were alive."""
        n_removed = self.store.mark_deleted(ids)
        if self.ivf is not None:
            if self._id_remap is None:
                self.ivf.remove(ids)
            else:
                # the index holds compacted ids: translate
                remap = self._id_remap
                want = np.asarray(ids)
                pos = np.clip(np.searchsorted(remap, want), 0, len(remap) - 1)
                self.ivf.remove(pos[remap[pos] == want])
        return n_removed

    def _want_ivf(self) -> bool:
        if self.use_ivf is not None:
            return self.use_ivf
        return self.store.size >= self.IVF_MIN_DOCS

    def _build_ivf(self):
        alive = self.store.alive_view.cpu().numpy()
        data = self.store.view
        if not alive.all():
            # tombstones: build over alive rows, keep global ids via a remap
            alive_idx = np.nonzero(alive)[0]
            data = data[torch.as_tensor(alive_idx, device=self.device)]
            self._id_remap = alive_idx
        else:
            self._id_remap = None
        cfg = self.index_config or IndexConfig.auto(int(data.shape[0]))
        # bf16 slabs, as the reference's serving build (int8 slabs and a
        # bf16 rescore copy when cfg.quantize_int8)
        self.ivf = IVFIndex.build(data, cfg, data_dtype=torch.bfloat16, device=self.device)
        logger.info(
            "built IVF index: %d rows, %d clusters (+%d overflow)",
            int(data.shape[0]), self.ivf.num_base_clusters, self.ivf.num_overflow,
        )

    def __call__(
        self, queries: Sequence[str], max_num_results: int = 10
    ) -> List[List[Tuple[str, float, int]]]:
        """→ per query: [(document, score, corpus_id), ...] best-first."""
        if len(queries) == 0:
            return []
        q_emb = self.encoder.encode(queries, batch_size=self.batch_size, device_output=True)
        q_emb = _pad_pow2(q_emb)
        if self._want_ivf():
            if self.ivf is None:
                self._build_ivf()
            # the reference's serving args: 64-query blocks sharing the
            # config's probe count as the union; the deferred merge for
            # big clusters, the exact merge for small ones
            mc = self.ivf.data_padded.shape[1]
            s, i = self.ivf.query(
                q_emb, k=max_num_results, block_q=64, union_factor=1,
                approx_width=2048 if mc >= 1024 else 0,
            )
            s, i = s.cpu().numpy(), i.cpu().numpy()
            if self._id_remap is not None:
                i = np.where(i >= 0, self._id_remap[np.maximum(i, 0)], -1)
        else:
            s, i = BruteForceIndex(self.store).query(q_emb, k=max_num_results)
        out = []
        for r in range(len(queries)):
            row = []
            for score, idx in zip(s[r], i[r]):
                if idx < 0 or not np.isfinite(score):
                    continue
                row.append((self.corpus[int(idx)], float(score), int(idx)))
            out.append(row)
        return out

    def warmup(self, ks: Sequence[int] = (10,), max_queries: int = 16) -> int:
        """Run every power-of-2 query bucket up to ``max_queries`` (and the
        bucket above it) × each k once — builds the kernels and the IVF
        index before the first user request. → the number of calls."""
        if not self.corpus:
            return 0
        n = 0
        bucket = 1
        while bucket // 2 < max(1, max_queries):
            probe = [self.corpus[0]] * bucket
            for k in ks:
                self(probe, max_num_results=k)
                n += 1
            bucket *= 2
        return n

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.store.save(os.path.join(path, "store.npz"))
        if self.ivf is not None:
            self.ivf.save(os.path.join(path, "ivf.npz"))
        if self._id_remap is not None:
            np.save(os.path.join(path, "id_remap.npy"), np.asarray(self._id_remap))
        with open(os.path.join(path, "corpus.txt"), "w", encoding="utf-8") as f:
            for t in self.corpus:
                f.write(t.replace("\n", " ") + "\n")

    def load_corpus(self, path: str) -> None:
        """Restore the store, corpus and (when saved) IVF index."""
        self.store = EmbeddingStore.load(os.path.join(path, "store.npz"), device=self.device)
        with open(os.path.join(path, "corpus.txt"), encoding="utf-8") as f:
            self.corpus = [line.rstrip("\n") for line in f]
        ivf_path = os.path.join(path, "ivf.npz")
        self.ivf = IVFIndex.load(ivf_path, device=self.device) if os.path.exists(ivf_path) else None
        remap_path = os.path.join(path, "id_remap.npy")
        self._id_remap = np.load(remap_path) if os.path.exists(remap_path) else None
