"""Corpus clustering (port of ``text_similarity_tpu.pipelines.clustering``):
the encoder's embeddings, then spherical k-means (``ops.kmeans``) on the
encoder's device."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..ops.kmeans import kmeans
from ..ops.topk import l2_normalize


class ClusteringPipeline:
    def __init__(self, encoder, num_clusters: int = 10, iters: int = 20,
                 batch_size: int = 128):
        self.encoder = encoder
        self.num_clusters = num_clusters
        self.iters = iters
        self.batch_size = batch_size

    def _embed(self, corpus):
        return l2_normalize(self.encoder.encode(corpus, batch_size=self.batch_size,
                                                device_output=True))

    def __call__(self, corpus: Sequence[str]) -> Dict[int, List[str]]:
        """→ {cluster id: its texts, in corpus order}."""
        # the initial centroids are k distinct rows: k ≤ the corpus size
        k = min(self.num_clusters, len(corpus))
        _, assign = kmeans(self._embed(corpus), k, iters=self.iters)
        clusters: Dict[int, List[str]] = {}
        for i, c in enumerate(assign.cpu().numpy()):
            clusters.setdefault(int(c), []).append(corpus[i])
        return clusters

    def assignments(self, corpus: Sequence[str]) -> np.ndarray:
        """→ (N,) cluster ids."""
        _, assign = kmeans(self._embed(corpus), self.num_clusters, iters=self.iters)
        return assign.cpu().numpy()
