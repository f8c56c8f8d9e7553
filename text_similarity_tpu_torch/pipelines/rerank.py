"""Two-stage retrieval (port of ``text_similarity_tpu.pipelines.rerank``):
the bi-encoder pipeline retrieves ``retrieve_k`` candidates a query, a
cross-encoder re-scores every (query, candidate) pair in one batched call,
and each query's candidates are re-sorted best first.

Above 2048 pairs (with the array tokenizer path, cls pooling and at most
two classes) the pairs are scored in waves: the host tokenizes and packs
wave i + 1 while the card scores wave i (``CrossEncoder``'s dispatch does
not wait for the device), and the scores are drained once at the end.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..data.batching import BUCKETS, pick_bucket
from ..data.packing import pack_pair_arrays


class RankingPipeline:
    def __init__(
        self,
        search,                         # SemanticSearchPipeline
        cross_encoder,                  # models.cross_encoder.CrossEncoder
        retrieve_k: int = 100,
        batch_size: int = 64,
    ):
        self.search = search
        self.cross_encoder = cross_encoder
        self.retrieve_k = retrieve_k
        self.batch_size = batch_size

    def __call__(
        self, queries: Sequence[str], top_k: int = 10
    ) -> List[List[Tuple[str, float, int]]]:
        """→ per query: [(document, cross-encoder score, corpus id)], best
        first."""
        retrieved = self.search(queries, max_num_results=self.retrieve_k)
        flat_pairs, owners = [], []
        for qi, (q, cands) in enumerate(zip(queries, retrieved)):
            for doc, _, cid in cands:
                flat_pairs.append((q, doc))
                owners.append((qi, cid, doc))
        if not flat_pairs:
            return [[] for _ in queries]
        ce = self.cross_encoder
        if (
            hasattr(ce.tokenizer, "encode_bodies") and ce.pooling == "cls"
            and ce.num_classes <= 2 and len(flat_pairs) > 2048
        ):
            scores = self._predict_pipelined(flat_pairs)
        else:
            scores = ce.predict(flat_pairs, batch_size=self.batch_size)
        out: List[List[Tuple[str, float, int]]] = [[] for _ in queries]
        for (qi, cid, doc), sc in zip(owners, scores):
            out[qi].append((doc, float(sc), cid))
        for row in out:
            row.sort(key=lambda t: -t[1])
            del row[top_k:]
        return out

    def _predict_pipelined(self, flat_pairs, wave: int = 8192, max_len: int = 256) -> np.ndarray:
        """Packed pair scores in waves of ``wave`` pairs: each wave is
        tokenized (``encode_bodies``), packed into rows of its widest
        pair's bucket and queued on the device before the next wave's host
        work starts; one drain at the end. → (N,) f32, as ``predict``."""
        ce = self.cross_encoder
        tok = ce.tokenizer
        n = len(flat_pairs)
        out = np.zeros(n, np.float32)
        pending = []
        for st in range(0, n, wave):
            chunk = flat_pairs[st:st + wave]
            ba, la = tok.encode_bodies([p[0] for p in chunk], max_len - 3)
            bb, lb = tok.encode_bodies([p[1] for p in chunk], max_len - 3)
            lens = np.minimum(la + lb, max_len - 3) + 3
            width = pick_bucket(int(lens.max()), BUCKETS)
            layout = pack_pair_arrays(
                ba, la, bb, lb, width, cls_id=tok.cls_id, sep_id=tok.sep_id,
                pad_id=tok.pad_id, max_len=min(max_len, width),
            )
            pending.append((st, ce._dispatch_packed_layout(layout)))
        for st, p in pending:
            ce._collect_packed(p, out, base=st)
        return out
