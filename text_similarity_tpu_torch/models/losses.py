"""Training losses (port of ``text_similarity_tpu.models.losses``).

- ``softmax_loss``: SBERT concat [u; v; |u − v|] → linear classifier → CE
- ``cosine_mse_loss``: MSE between cos(u, v) and the gold score (STS)
- ``contrastive_loss``: cosine-distance margin contrastive
- ``online_contrastive_loss``: hard-pair mining inside the batch, with
  masked reductions (static shapes)
- ``distill_mse_loss``: embedding-matching distillation
- ``multiple_negatives_loss``: in-batch negatives InfoNCE (MNRL)
- ``cross_entropy_loss``: a classification head's CE

Every loss takes an optional ``valid`` (B,) mask: padded rows of a tail
batch count nowhere. Reductions run in f32. ``mlm_loss``,
``hidden_state_mse`` and ``kl_distill_loss`` come with their train steps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _cos(u: torch.Tensor, v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    u, v = u.float(), v.float()
    un = torch.linalg.vector_norm(u, dim=-1).clamp_min(eps)
    vn = torch.linalg.vector_norm(v, dim=-1).clamp_min(eps)
    return (u * v).sum(dim=-1) / (un * vn)


def _masked_mean(per: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return per.mean()
    w = valid.float()
    return (per * w).sum() / w.sum().clamp_min(1.0)


def sbert_concat(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[u; v; |u − v|], the bi-encoder's pair features."""
    return torch.cat([u, v, (u - v).abs()], dim=-1)


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _masked_mean(nll, valid)


def softmax_loss(u, v, w, b, labels, valid: Optional[torch.Tensor] = None):
    """Classifier weight w (3H, C), bias b (C,) → (loss, logits)."""
    logits = sbert_concat(u, v).float() @ w + b
    return cross_entropy_loss(logits, labels, valid), logits


def cosine_mse_loss(u, v, scores, valid: Optional[torch.Tensor] = None):
    """STS regression → (loss, predicted cosine)."""
    c = _cos(u, v)
    return _masked_mean((c - scores.float()).square(), valid), c


def contrastive_loss(u, v, labels, margin: float = 0.5, valid: Optional[torch.Tensor] = None):
    """Cosine-distance margin contrastive (labels 1 = similar) → (loss,
    distance)."""
    d = 1.0 - _cos(u, v)
    lab = labels.float()
    per = 0.5 * (lab * d.square() + (1.0 - lab) * (margin - d).clamp_min(0.0).square())
    return _masked_mean(per, valid), d


def online_contrastive_loss(
    u, v, labels, margin: float = 0.5, valid: Optional[torch.Tensor] = None
):
    """Keep only positive pairs farther than the closest negative and
    negative pairs closer than the farthest positive → (loss, distance)."""
    d = 1.0 - _cos(u, v)
    lab = labels.float()
    w = valid.float() if valid is not None else torch.ones_like(lab)
    pos_mask = lab * w
    neg_mask = (1.0 - lab) * w
    inf = torch.tensor(float("inf"), device=d.device)
    neg_min = torch.where(neg_mask > 0, d, inf).min()
    pos_max = torch.where(pos_mask > 0, d, -inf).max()
    hard_pos = pos_mask * (d > neg_min).float()
    hard_neg = neg_mask * (d < pos_max).float()
    pos_loss = d.square() * hard_pos
    neg_loss = (margin - d).clamp_min(0.0).square() * hard_neg
    n = (hard_pos.sum() + hard_neg.sum()).clamp_min(1.0)
    return (pos_loss.sum() + neg_loss.sum()) / n, d


def distill_mse_loss(student_emb, teacher_emb, valid: Optional[torch.Tensor] = None):
    """Embedding-matching distillation: per-row mean squared error."""
    err = (student_emb.float() - teacher_emb.float()).square().mean(dim=-1)
    return _masked_mean(err, valid)


def multiple_negatives_loss(u, v, scale: float = 20.0, valid: Optional[torch.Tensor] = None):
    """In-batch negatives: cos(u_i, v_i) against every v_j → (loss, scaled
    similarities). Padded rows are neither anchors nor negatives."""
    un = u / torch.linalg.vector_norm(u.float(), dim=-1, keepdim=True).clamp_min(1e-8)
    vn = v / torch.linalg.vector_norm(v.float(), dim=-1, keepdim=True).clamp_min(1e-8)
    sim = (un.float() @ vn.float().T) * scale
    labels = torch.arange(sim.shape[0], device=sim.device)
    if valid is not None:
        sim = torch.where(valid.bool()[None, :], sim, torch.full_like(sim, -1e9))
    logp = F.log_softmax(sim, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    return _masked_mean(nll, valid), sim
