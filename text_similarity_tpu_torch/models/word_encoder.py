"""Word-level encoders for word-in-context (WiC) and graded word similarity
in context (GWSC) (port of ``text_similarity_tpu.models.word_encoder``).

A target word's vector is the sum of the encoder's last k hidden states
(``encoder_forward(output_hidden_states=True)``) pooled over the word's
sub-token span; ``WordEncoder`` compares the two words of a pair by
cosine, optionally with the best-matching row of a sense bank (1-NN by
cosine, ``match_sense``) concatenated to each vector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import EncoderArch
from ..core.precision import DEFAULT_PRECISION, Precision, resolve_device
from .encoder import encoder_forward
from .pooling import word_span_pool
from .sentence_encoder import _tree_to


def contextual_word_embedding(
    enc_params: dict,
    ids: torch.Tensor, mask: torch.Tensor, span: torch.Tensor,   # (B, S), (B, S), (B, W)
    *,
    arch: EncoderArch,
    precision: Precision = DEFAULT_PRECISION,
    last_k_layers: int = 4,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """The target word's vector: the f32 sum of the last ``last_k_layers``
    hidden states (of L + 1, the embeddings first) pooled over its span →
    (B, H)."""
    out = encoder_forward(enc_params, ids, mask, arch=arch, precision=precision,
                          output_hidden_states=True, deterministic=deterministic,
                          generator=generator)
    hs = out.hidden_states
    k = min(last_k_layers, hs.shape[0])
    return word_span_pool(hs[-k:].float().sum(dim=0), span)


def match_sense(word_vecs: torch.Tensor, sense_bank: torch.Tensor) -> torch.Tensor:
    """The sense bank's row of highest cosine a word vector (the first on
    ties)."""
    w = word_vecs / torch.linalg.vector_norm(word_vecs, dim=-1, keepdim=True).clamp_min(1e-12)
    s = sense_bank / torch.linalg.vector_norm(sense_bank, dim=-1, keepdim=True).clamp_min(1e-12)
    best = torch.argmax(w.float() @ s.float().T, dim=-1)
    return sense_bank[best]


class WordEncoder:
    """Twin-tower word-in-context model: the cosine of the two target
    words' vectors (sense-augmented with ``sense_bank``) scores same sense
    against different sense."""

    def __init__(
        self,
        enc_params: dict,
        arch: EncoderArch,
        tokenizer=None,
        sense_bank=None,                  # (S, Ds) or None
        last_k_layers: int = 4,
        precision: Precision = DEFAULT_PRECISION,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.enc_params = _tree_to(enc_params, self.device)
        self.arch = arch
        self.tokenizer = tokenizer
        self.sense_bank = (None if sense_bank is None
                           else torch.as_tensor(np.asarray(sense_bank)).to(self.device))
        self.last_k_layers = last_k_layers
        self.precision = precision

    def _word_vec(self, ids, mask, span) -> torch.Tensor:
        v = contextual_word_embedding(self.enc_params, ids, mask, span, arch=self.arch,
                                      precision=self.precision, last_k_layers=self.last_k_layers)
        if self.sense_bank is not None:
            v = torch.cat([v, match_sense(v, self.sense_bank).to(v.dtype)], dim=-1)
        return v.float()

    @torch.no_grad()
    def score_tokens(self, batch) -> np.ndarray:
        """The cosine of the two target-word vectors of each row → (B,)."""
        t = {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
             for k in ("ids_a", "mask_a", "span_a", "ids_b", "mask_b", "span_b")}
        u = self._word_vec(t["ids_a"], t["mask_a"], t["span_a"])
        v = self._word_vec(t["ids_b"], t["mask_b"], t["span_b"])
        un = torch.linalg.vector_norm(u, dim=-1).clamp_min(1e-12)
        vn = torch.linalg.vector_norm(v, dim=-1).clamp_min(1e-12)
        return ((u * v).sum(dim=-1) / (un * vn)).cpu().numpy()

    def evaluate_wic(self, batches) -> dict:
        """Best-threshold accuracy over the cosine scores (the WiC
        protocol)."""
        from ..evaluation.meters import best_threshold_accuracy

        scores, labels = [], []
        for b in batches:
            v = np.asarray(b["valid"]).astype(bool)
            scores.append(self.score_tokens(b)[v])
            labels.append(np.asarray(b["target"])[v])
        return best_threshold_accuracy(np.concatenate(scores), np.concatenate(labels))

    def _scores_in_order(self, batches):
        """Scores and example indices of the valid rows (batches arrive
        length-sorted, with padded tails)."""
        scores, idxs = [], []
        for b in batches:
            v = np.asarray(b["valid"]).astype(bool)
            scores.append(self.score_tokens(b)[v])
            idxs.append(np.asarray(b["index"])[v])
        return np.concatenate(scores), np.concatenate(idxs)

    def graded_similarity(self, batches) -> np.ndarray:
        """GWSC scores in the examples' original order (padding dropped)."""
        flat_s, flat_i = self._scores_in_order(batches)
        out = np.zeros(flat_i.max() + 1 if len(flat_i) else 0, np.float32)
        out[flat_i] = flat_s
        return out

    def evaluate_gwsc(self, batches, gold_scores) -> dict:
        """Pearson and Spearman of the cosine scores against the human
        graded similarity change, each score realigned to its example."""
        from scipy.stats import pearsonr, spearmanr

        scores, idxs = self._scores_in_order(batches)
        order = np.argsort(idxs)
        scores = scores[order]
        gold = np.asarray(gold_scores, np.float64)[idxs[order]]
        return {"pearson": float(pearsonr(gold, scores)[0]),
                "spearman": float(spearmanr(gold, scores)[0])}
