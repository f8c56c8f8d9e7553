"""Topic modelling: embed → reduce → cluster → class-based TF-IDF (port of
``text_similarity_tpu.pipelines.topic``).

- Reduction: PCA through the SVD (``ops.pca``), or Laplacian eigenmaps of
  the k-NN graph (``spectral_reduce``), whose neighbours come from
  ``ops.topk.cosine_topk`` (kernel K2 on the card, the lowest id first
  among equal scores) and whose eigenvectors from ``torch.linalg.eigh``.
- Clustering: spherical k-means (``ops.kmeans``) with an optional outlier
  rule (the least similar share of documents → topic −1), or the density
  methods of ``ops.density`` (DBSCAN, multi-radius HDBSCAN), whose noise is
  topic −1.
- c-TF-IDF words and the merge of the least frequent topics into their
  nearest one (the reference's host code); hypernym topic names through
  ``utils.lexicon`` with ``lexicon=``.

The embeddings stay on the encoder's device through the reduction and the
clustering; the words are counted on the host.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.kmeans import kmeans
from ..ops.topk import cosine_topk, l2_normalize

_WORD_RE = re.compile(r"[a-zA-Z][a-zA-Z\-']+")

# a minimal English stoplist for topic words
_STOP = set(
    """the a an and or of to in is are was were be been it its this that
    these those for with as on at by from not no but if then so such can
    could would should may might will shall do does did done have has had
    i you he she we they them his her their our your my me us""".split()
)


def _tokenize_doc(text: str) -> List[str]:
    return [w.lower() for w in _WORD_RE.findall(text) if w.lower() not in _STOP and len(w) > 2]


def pca_reduce(emb: torch.Tensor, dim: int) -> torch.Tensor:
    """The PCA projection (``ops.pca``) on ``emb``'s device."""
    from ..ops.pca import pca_fit_transform

    reduced, _, _ = pca_fit_transform(emb, dim)
    return reduced


def spectral_reduce(emb: torch.Tensor, dim: int, n_neighbors: int = 15) -> torch.Tensor:
    """Laplacian eigenmaps of the k-NN graph → (N, min(dim, N)): the
    neighbours by ``cosine_topk`` (the row itself included, hence k + 1),
    the undirected graph without self loops, its symmetric normalised
    adjacency D^-½ A D^-½, and its leading eigenvectors (largest first).
    The eigenvalue-1 ones are kept: on a disconnected graph they span the
    component indicators, the separating directions. Dense (N, N): sized
    for topic corpora (N up to about 20,000 on one card)."""
    x = l2_normalize(torch.as_tensor(emb).float())
    n = x.shape[0]
    k = min(n_neighbors + 1, n)
    _, idx = cosine_topk(x, x, k)
    a = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    a[rows, idx.reshape(-1).long().to(x.device)] = 1.0
    a = torch.maximum(a, a.T)
    a.fill_diagonal_(0.0)
    dinv = torch.rsqrt(a.sum(dim=1).clamp_min(1e-6))
    a_norm = a * dinv[:, None] * dinv[None, :]
    _, v = torch.linalg.eigh(a_norm)          # ascending eigenvalues
    take = min(dim, n)
    return v[:, n - take:].flip(1)


def class_tfidf(
    docs_per_topic: Dict[int, List[str]], top_n: int = 10
) -> Dict[int, List[Tuple[str, float]]]:
    """c-TF-IDF: a topic's term frequency × log(1 + the mean words a topic
    / the term's count over all topics)."""
    topic_tf: Dict[int, collections.Counter] = {}
    word_topic_freq: collections.Counter = collections.Counter()
    for t, docs in docs_per_topic.items():
        c = collections.Counter()
        for d in docs:
            c.update(_tokenize_doc(d))
        topic_tf[t] = c
        for w in c:
            word_topic_freq[w] += c[w]
    a = np.mean([sum(c.values()) or 1 for c in topic_tf.values()])
    out = {}
    for t, c in topic_tf.items():
        total = sum(c.values()) or 1
        scored = [(w, (cnt / total) * np.log(1 + a / word_topic_freq[w])) for w, cnt in c.items()]
        scored.sort(key=lambda x: -x[1])
        out[t] = scored[:top_n]
    return out


class TopicModelingPipeline:
    def __init__(
        self,
        encoder,
        num_topics: int = 20,
        reduce_dim: int = 32,
        top_n_words: int = 10,
        outlier_quantile: float = 0.0,  # 0: no outliers; e.g. 0.05
        batch_size: int = 128,
        method: str = "kmeans",         # kmeans | density (DBSCAN) | hdbscan
        density_eps: float = 0.3,
        density_min_samples: int = 3,
        reduce: str = "pca",            # pca | spectral
        spectral_neighbors: int = 15,
        lexicon=None,                   # utils.lexicon.Lexicon → topic names
    ):
        self.encoder = encoder
        self.num_topics = num_topics
        self.reduce_dim = reduce_dim
        self.top_n_words = top_n_words
        self.outlier_quantile = outlier_quantile
        self.batch_size = batch_size
        self.method = method
        self.density_eps = density_eps
        self.density_min_samples = density_min_samples
        self.reduce = reduce
        self.spectral_neighbors = spectral_neighbors
        self.lexicon = lexicon

    def __call__(self, corpus: Sequence[str]) -> dict:
        """→ {"assignments" (N,), "topics" {t: [(word, score)]}, "sizes",
        "centroids" (T, d)[, "names"]}."""
        x = self.encoder.encode(corpus, batch_size=self.batch_size, device_output=True)
        if self.reduce_dim and self.reduce_dim < x.shape[1]:
            if self.reduce == "spectral":
                x = spectral_reduce(x, self.reduce_dim, n_neighbors=self.spectral_neighbors)
            else:
                x = pca_reduce(x, self.reduce_dim)
        x = l2_normalize(x)

        if self.method in ("density", "hdbscan"):
            from ..ops.density import dbscan_cosine, hdbscan_cosine

            if self.method == "hdbscan":
                assign = hdbscan_cosine(x, min_samples=self.density_min_samples)
            else:
                assign = dbscan_cosine(x, eps=self.density_eps,
                                       min_samples=self.density_min_samples)
            ks = [t for t in np.unique(assign) if t >= 0]
            centroids = np.stack([
                x[torch.as_tensor(assign == t, device=x.device)].mean(dim=0).cpu().numpy()
                for t in ks
            ]) if ks else np.zeros((0, x.shape[1]), np.float32)
        else:
            k = min(self.num_topics, max(len(corpus) // 4, 1))
            cent, assign_t = kmeans(x, k, iters=20)
            assign = assign_t.cpu().numpy()
            # outlier rule: the documents least similar to their centroid
            if self.outlier_quantile > 0:
                sims = (x * cent[assign_t.long()]).sum(dim=1).cpu().numpy()
                thr = np.quantile(sims, self.outlier_quantile)
                assign = np.where(sims < thr, -1, assign)
            centroids = cent.cpu().numpy()
        return self._result(assign, centroids, corpus)

    def _result(self, assign, centroids, corpus) -> dict:
        docs_per_topic: Dict[int, List[str]] = {}
        for i, t in enumerate(assign):
            docs_per_topic.setdefault(int(t), []).append(corpus[i])
        words = class_tfidf(docs_per_topic, self.top_n_words)
        out = {
            "assignments": assign,
            "topics": words,
            "sizes": {t: len(d) for t, d in docs_per_topic.items()},
            "centroids": centroids,
        }
        if self.lexicon is not None:
            from ..utils.lexicon import name_topics

            out["names"] = name_topics(words, self.lexicon)
        return out

    def reduce_topics(self, result: dict, corpus: Sequence[str], target: int) -> dict:
        """Merge the least frequent topic into its nearest one by centroid
        cosine until ``target`` topics are left (sizes recounted after each
        merge; the merged centroid is the size-weighted mean)."""
        assign = np.array(result["assignments"])
        centroids = np.array(result["centroids"])
        alive = [int(t) for t in np.unique(assign) if t >= 0]
        sizes = {t: int((assign == t).sum()) for t in alive}
        while len(alive) > target:
            smallest = min(alive, key=lambda t: sizes[t])
            alive.remove(smallest)
            c = centroids[smallest]
            # cosine, not the raw dot: density means and merged means are
            # not unit vectors
            cand = centroids[alive]
            cand_n = cand / np.maximum(np.linalg.norm(cand, axis=1, keepdims=True), 1e-12)
            c_n = c / max(float(np.linalg.norm(c)), 1e-12)
            tgt = alive[int(np.argmax(cand_n @ c_n))]
            n_s, n_t = sizes[smallest], sizes[tgt]
            centroids[tgt] = (centroids[tgt] * n_t + c * n_s) / max(n_s + n_t, 1)
            assign[assign == smallest] = tgt
            sizes[tgt] = n_t + n_s
            del sizes[smallest]
        return self._result(assign, centroids, corpus)
