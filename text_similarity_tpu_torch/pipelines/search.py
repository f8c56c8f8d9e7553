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

``ShardedSearchPipeline`` serves a corpus sharded over a device mesh's
``index`` axis (``index.sharded``): each shard scanned on its device (IVF
with global clusters, K1 a shard; exact brute force, K2 a shard below
100k documents) and the per-shard top-k merged on the first device. Same
request surface as ``SemanticSearchPipeline``, so ``SearchServer`` serves
it; ``add_documents`` rebuilds the sharded layout (a bulk load),
``remove_documents`` tombstones in place (the IVF id maps and sentinel
column; brute force over-fetches and filters). ``save`` / ``load`` keep the
reference's ``sharded_store.npz`` + ``corpus.txt`` and rebuild on load, so
a directory either package saved loads in the other.

``SentenceMiningPipeline`` finds likely paraphrase pairs inside a corpus:
exact all-pairs mining through ``BruteForceIndex.mine`` (K2) below 100k
documents, the corpus queried against its own IVF index (K1) from 100k
up. ``compare_models`` is the teacher / student top-k overlap of two
brute-force pipelines over one corpus.
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
from ..ops.topk import l2_normalize
from ..utils.profiling import span

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


def _warmup_pipeline(pipe, ks: Sequence[int], max_queries: int) -> int:
    """Run every power-of-2 query bucket up to ``max_queries`` (and the
    bucket above it) × each k once — builds the kernels and the index
    before the first user request. → the number of calls."""
    if not pipe.corpus:
        return 0
    n = 0
    bucket = 1
    while bucket // 2 < max(1, max_queries):
        probe = [pipe.corpus[0]] * bucket
        for k in ks:
            pipe(probe, max_num_results=k)
            n += 1
        bucket *= 2
    return n


def _rows(corpus: Sequence[str], s: np.ndarray, i: np.ndarray, n_rows: int, k: int,
          removed=()) -> List[List[Tuple[str, float, int]]]:
    """Per query row: [(document, score, id)] best first, at most k,
    skipping ids < 0, non-finite scores and ``removed`` ids."""
    out = []
    for r in range(n_rows):
        row = []
        for score, idx in zip(s[r], i[r]):
            idx = int(idx)
            if idx < 0 or not np.isfinite(score) or idx in removed:
                continue
            row.append((corpus[idx], float(score), idx))
            if len(row) >= k:
                break
        out.append(row)
    return out


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
        _check_encoder_device(encoder, self.device)
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
        with span("ts.search"):
            q_emb = self.encoder.encode(queries, batch_size=self.batch_size, device_output=True)
            q_emb = _pad_pow2(q_emb)
            remap = None
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
                with span("ts.search.to_host"):
                    s, i = s.cpu().numpy(), i.cpu().numpy()
                remap = self._id_remap
            else:
                s, i = BruteForceIndex(self.store).query(q_emb, k=max_num_results)
            with span("ts.search.rows"):
                if remap is not None:
                    i = np.where(i >= 0, remap[np.maximum(i, 0)], -1)
                return _rows(self.corpus, s, i, len(queries), max_num_results)

    def warmup(self, ks: Sequence[int] = (10,), max_queries: int = 16) -> int:
        """Each power-of-2 query bucket up to ``max_queries`` × each k once
        (``_warmup_pipeline``). → the number of calls."""
        return _warmup_pipeline(self, ks, max_queries)

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


class ShardedSearchPipeline:
    """corpus texts → embeddings → an index sharded over ``mesh``'s index
    axis → query API (the reference's north-star multi-device shape)."""

    IVF_MIN_DOCS = 100_000

    def __init__(
        self,
        encoder,                       # SentenceEncoder
        mesh,                          # core.mesh.Mesh with the index axis
        corpus: Optional[Sequence[str]] = None,
        index_config: Optional[IndexConfig] = None,
        use_ivf: Optional[bool] = None,   # None: IVF from 100k documents
        batch_size: int = 128,
    ):
        _check_encoder_device(encoder, mesh.first_device)
        self.encoder = encoder
        self.mesh = mesh
        self.index_config = index_config
        self.use_ivf = use_ivf
        self.batch_size = batch_size
        self.corpus: List[str] = []
        self._emb: Optional[np.ndarray] = None   # host copy for rebuilds
        self._removed: set = set()
        self.index = None
        self.ivf = None       # the sharded IVF index when it serves (/health)
        self.store = None     # no single-device store
        if corpus:
            self.add_documents(corpus)

    @property
    def size(self) -> int:
        return len(self.corpus) - len(self._removed)

    def _want_ivf(self) -> bool:
        if self.use_ivf is not None:
            return self.use_ivf
        return len(self.corpus) >= self.IVF_MIN_DOCS

    def _rebuild(self) -> None:
        from ..index.sharded import ShardedBruteForceIndex, ShardedIVFIndex

        if self._want_ivf():
            cfg = self.index_config or IndexConfig.auto(len(self.corpus))
            # bf16 slabs, as the single-device pipeline's
            self.index = ShardedIVFIndex.build(self.mesh, self._emb, cfg,
                                               data_dtype=torch.bfloat16)
            self.ivf = self.index
            if self._removed:
                self._tombstone(sorted(self._removed))
        else:
            self.index = ShardedBruteForceIndex.build(self.mesh, self._emb)
            self.ivf = None
        logger.info("built sharded %s index: %d rows over %d shards",
                    "IVF" if self.ivf is not None else "brute-force", len(self.corpus),
                    self.mesh.shape["index"])

    def add_documents(self, texts: Sequence[str]) -> np.ndarray:
        """Bulk load: encode, extend the corpus, rebuild the sharded layout
        (a per-shard capped layout takes no cross-shard insert). → the new
        corpus ids."""
        emb = np.asarray(self.encoder.encode(list(texts), batch_size=self.batch_size),
                         np.float32)
        start = len(self.corpus)
        self.corpus.extend(texts)
        self._emb = emb if self._emb is None else np.concatenate([self._emb, emb])
        self._rebuild()
        return np.arange(start, len(self.corpus))

    def _tombstone(self, ids: Sequence[int]) -> None:
        """Clear global ids from every shard's IVF id map in place (and
        zero their sentinel column, which the idless scan masks by)."""
        rem = torch.as_tensor(sorted(ids), dtype=torch.int32)
        index = self.index
        for si, flat in enumerate(index.ids_padded):
            r = rem.to(flat.device)
            pos = torch.searchsorted(r, flat).clamp(0, r.shape[0] - 1)
            hit = (r[pos] == flat) & (flat >= 0)
            index.ids_padded[si] = torch.where(hit, -1, flat)
            if index.sentinel:
                col = index.data_padded[si][..., -1]
                col.copy_(torch.where(hit, torch.zeros_like(col), col))

    def remove_documents(self, ids: Sequence[int]) -> int:
        """Tombstone live corpus ids. → how many were alive."""
        fresh = [int(i) for i in ids
                 if 0 <= int(i) < len(self.corpus) and int(i) not in self._removed]
        if not fresh:
            return 0
        self._removed.update(fresh)
        if self.ivf is not None:
            self._tombstone(fresh)
        # brute-force shards have no id map: __call__ over-fetches instead
        return len(fresh)

    def __call__(
        self, queries: Sequence[str], max_num_results: int = 10
    ) -> List[List[Tuple[str, float, int]]]:
        """→ per query: [(document, score, corpus_id), ...] best-first."""
        if len(queries) == 0:
            return []
        if self.index is None:   # nothing loaded yet
            return [[] for _ in queries]
        q_emb = _pad_pow2(self.encoder.encode(list(queries), batch_size=self.batch_size,
                                              device_output=True))
        k = min(max_num_results, len(self.corpus))
        if self.ivf is None and self._removed:
            # over-fetch past the tombstones, snapped to a power of 2 (one
            # query shape a range of removals)
            b = 1
            while b < k + len(self._removed):
                b *= 2
            k = min(b, len(self.corpus))
        s, i = self.index.query(q_emb, k=k)
        return _rows(self.corpus, s, i, len(queries), max_num_results, self._removed)

    def warmup(self, ks: Sequence[int] = (10,), max_queries: int = 16) -> int:
        """``SemanticSearchPipeline.warmup``'s contract."""
        return _warmup_pipeline(self, ks, max_queries)

    # -- persistence: the layout depends on the mesh, so the corpus state
    # persists and a load rebuilds ----------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        emb = (self._emb if self._emb is not None
               else np.zeros((0, self.encoder.embedding_dim), np.float32))
        cfg = self.index_config
        np.savez(
            os.path.join(path, "sharded_store.npz"),
            emb=emb,
            removed=np.asarray(sorted(self._removed), np.int64),
            # the index choice, so a load does not re-run the size rule
            use_ivf=np.int8(-1 if self.use_ivf is None else int(self.use_ivf)),
            num_clusters=np.int32(cfg.num_clusters if cfg else -1),
            num_probes=np.int32(cfg.num_probes if cfg else -1),
        )
        with open(os.path.join(path, "corpus.txt"), "w", encoding="utf-8") as f:
            for t in self.corpus:
                f.write(t.replace("\n", " ") + "\n")

    @classmethod
    def load(cls, path: str, encoder, mesh, index_config: Optional[IndexConfig] = None,
             use_ivf: Optional[bool] = None) -> "ShardedSearchPipeline":
        with np.load(os.path.join(path, "sharded_store.npz")) as z:
            emb = z["emb"]
            removed = {int(i) for i in z["removed"]}
            if use_ivf is None and "use_ivf" in z.files:
                saved = int(z["use_ivf"])
                use_ivf = None if saved < 0 else bool(saved)
            if index_config is None and "num_clusters" in z.files and int(z["num_clusters"]) > 0:
                index_config = IndexConfig(num_clusters=int(z["num_clusters"]),
                                           num_probes=int(z["num_probes"]))
        pipe = cls(encoder, mesh, index_config=index_config, use_ivf=use_ivf)
        pipe._removed = removed
        with open(os.path.join(path, "corpus.txt"), encoding="utf-8") as f:
            pipe.corpus = [line.rstrip("\n") for line in f]
        if emb.shape[0]:
            pipe._emb = np.asarray(emb, np.float32)
            pipe._rebuild()
        return pipe


def _check_encoder_device(encoder, device: torch.device) -> None:
    if encoder.device.type != device.type:
        raise ValueError(f"encoder is on {encoder.device}, pipeline on {device}")


def _pairs_above(s: np.ndarray, i: np.ndarray, min_score: float) -> List[Tuple[int, int, float]]:
    """(r, j, score) for every neighbour j of row r with j ≥ 0, score ≥
    min_score and r < j (each pair once, from its lower row), best first;
    equal scores keep row-major order (a stable sort)."""
    rows = np.arange(s.shape[0])[:, None]
    keep = (i >= 0) & (s >= min_score) & (rows < i)
    r, c = np.nonzero(keep)
    j, sc = i[r, c], s[r, c]
    order = np.argsort(-sc, kind="stable")
    return [(int(a), int(b), float(x)) for a, b, x in zip(r[order], j[order], sc[order])]


class SentenceMiningPipeline:
    """Likely paraphrase pairs inside a corpus (the reference's intent:
    all-pairs top-k, each pair once, best first)."""

    IVF_MIN_DOCS = 100_000
    MINE_CHUNK = 16384   # corpus rows a query call of the IVF route

    def __init__(
        self,
        encoder,
        batch_size: int = 128,
        use_ivf: Optional[bool] = None,   # None: IVF from 100k docs (exact is O(N²))
        device="cuda",
    ):
        self.device = resolve_device(device)
        _check_encoder_device(encoder, self.device)
        self.encoder = encoder
        self.batch_size = batch_size
        self.use_ivf = use_ivf

    def _mine_ivf(self, emb: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate all-pairs mining: build a bf16 IVF index over the
        (normalized) rows, then ``_mine_with_index``."""
        ivf = IVFIndex.build(emb, IndexConfig.auto(int(emb.shape[0])), data_dtype=torch.bfloat16,
                             device=self.device)
        return self._mine_with_index(ivf, emb, k)

    def _mine_with_index(self, ivf: IVFIndex, emb: torch.Tensor, k: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Query the rows against ``ivf`` (which holds them under their row
        ids) in chunks of ``MINE_CHUNK`` at k + 1 with the serving args,
        then keep each row's first k hits that are not itself (a stable
        sort puts the self-match last) → (scores (N, k) f32, ids (N, k)
        int64; 0.0 / −1 where fewer remain)."""
        n = emb.shape[0]
        mc = ivf.data_padded.shape[1]
        all_s = np.zeros((n, k), np.float32)
        all_i = np.zeros((n, k), np.int64)
        for start in range(0, n, self.MINE_CHUNK):
            stop = min(start + self.MINE_CHUNK, n)
            s, i = ivf.query(emb[start:stop], k=k + 1, block_q=64, union_factor=1,
                             approx_width=2048 if mc >= 1024 else 0)
            s_h, i_h = s.cpu().numpy(), i.cpu().numpy()
            keep = i_h != np.arange(start, stop)[:, None]
            order = np.argsort(~keep, axis=1, kind="stable")[:, :k]
            valid = np.take_along_axis(keep, order, axis=1)
            all_s[start:stop] = np.where(valid, np.take_along_axis(s_h, order, axis=1), 0.0)
            all_i[start:stop] = np.where(valid, np.take_along_axis(i_h, order, axis=1), -1)
        return all_s, all_i

    def __call__(
        self,
        corpus: Sequence[str],
        k: int = 5,
        min_score: float = 0.0,
        queries: Optional[Sequence[str]] = None,
    ):
        """With ``queries=None``: all-pairs mining → [(i, j, score)], i < j,
        best first. With queries: each query's top k over the corpus →
        [[(document, score, corpus_id), ...]] (scores ≥ min_score)."""
        emb = l2_normalize(self.encoder.encode(corpus, batch_size=self.batch_size,
                                               device_output=True))
        want_ivf = (self.use_ivf if self.use_ivf is not None
                    else len(corpus) >= self.IVF_MIN_DOCS)
        if queries is None and want_ivf:
            return _pairs_above(*self._mine_ivf(emb, k), min_score)
        index = BruteForceIndex.from_embeddings(emb)
        if queries is None:
            return _pairs_above(*index.mine(k=k), min_score)
        q_emb = self.encoder.encode(list(queries), batch_size=self.batch_size, device_output=True)
        s, i = index.query(q_emb, k=k)
        return [
            [(corpus[int(j)], float(score), int(j)) for score, j in zip(s[r], i[r])
             if score >= min_score]
            for r in range(len(queries))
        ]


def compare_models(
    teacher_encoder,
    student_encoder,
    corpus: Sequence[str],
    queries: Sequence[str],
    k: int = 10,
    device="cuda",
) -> dict:
    """Teacher / student retrieval consistency: the mean and least top-k
    overlap of two brute-force pipelines' answers over the same corpus (the
    reference's compression acceptance metric)."""
    t_pipe = SemanticSearchPipeline(teacher_encoder, corpus=list(corpus), use_ivf=False,
                                    device=device)
    s_pipe = SemanticSearchPipeline(student_encoder, corpus=list(corpus), use_ivf=False,
                                    device=device)
    t_res = t_pipe(list(queries), max_num_results=k)
    s_res = s_pipe(list(queries), max_num_results=k)
    overlaps = []
    for tr, sr in zip(t_res, s_res):
        t_ids = {cid for _, _, cid in tr}
        s_ids = {cid for _, _, cid in sr}
        overlaps.append(len(t_ids & s_ids) / max(len(t_ids), 1))
    return {
        "mean_topk_overlap": float(np.mean(overlaps)),
        "min_topk_overlap": float(np.min(overlaps)),
        "k": k,
    }
