"""Evaluators (port of ``text_similarity_tpu.evaluation.evaluators``): run a
model over an evaluation set and return a metric dict.

- ``ParaphraseEvaluator``: encode both sides of sentence pairs; correlation
  metrics (STS, ``mode="regression"``) or best-threshold binary metrics
  (PAWS / Quora, ``mode="binary"``)
- ``RetrievalEvaluator``: encode source and target corpora, bitext
  retrieval accuracy (Tatoeba)
- ``ClassifierEvaluator``: batched logits → accuracy and macro F1

Embeddings and logits come back to the host once per batch; the metrics
are ``evaluation.meters``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import meters as M


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array → a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class ParaphraseEvaluator:
    """Evaluate a SentenceEncoder on sentence pairs.

    mode="regression": gold are similarity scores → Pearson / Spearman.
    mode="binary": gold are 0/1 labels → best-threshold acc / F1 / AP."""

    def __init__(self, encoder, mode: str = "regression", batch_size: int = 128):
        self.encoder = encoder
        self.mode = mode
        self.batch_size = batch_size

    def evaluate(
        self,
        sents_a: Sequence[str],
        sents_b: Sequence[str],
        gold: Sequence[float],
    ) -> Dict[str, float]:
        u = self.encoder.encode(sents_a, batch_size=self.batch_size)
        v = self.encoder.encode(sents_b, batch_size=self.batch_size)
        return self.evaluate_embeddings(u, v, gold)

    def evaluate_embeddings(self, u, v, gold) -> Dict[str, float]:
        u, v, gold = _host(u), _host(v), np.asarray(gold)
        if self.mode == "regression":
            return M.similarity_metrics(u, v, gold)
        return M.binary_similarity_report(u, v, gold)


class RetrievalEvaluator:
    """Bitext retrieval accuracy over aligned corpora."""

    def __init__(self, encoder, batch_size: int = 128):
        self.encoder = encoder
        self.batch_size = batch_size

    def evaluate(self, src_sents: Sequence[str], tgt_sents: Sequence[str]) -> Dict[str, float]:
        src = self.encoder.encode(src_sents, batch_size=self.batch_size)
        tgt = self.encoder.encode(tgt_sents, batch_size=self.batch_size)
        return M.retrieval_accuracy(_host(src), _host(tgt))


class ClassifierEvaluator:
    """Batched classifier evaluation: ``logits_fn(ids, mask, type_ids)`` →
    logits (a tensor or an array); only the logits of valid rows are kept
    on the host."""

    def __init__(self, logits_fn):
        self.logits_fn = logits_fn

    def evaluate(self, batches) -> Dict[str, float]:
        all_logits, all_labels = [], []
        for b in batches:
            logits = _host(self.logits_fn(b["ids"], b["mask"], b.get("type_ids")))
            labels = np.asarray(b["labels"])
            valid = b.get("valid")
            if valid is not None:
                valid = np.asarray(valid).astype(bool)   # batches carry 0/1 ints
                logits, labels = logits[valid], labels[valid]
            all_logits.append(logits)
            all_labels.append(labels)
        return M.classification_metrics(np.concatenate(all_logits), np.concatenate(all_labels))
