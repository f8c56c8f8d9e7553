"""Training losses (port of ``text_similarity_tpu.models.losses``).

- ``softmax_loss``: SBERT concat [u; v; |u − v|] → linear classifier → CE
- ``cosine_mse_loss``: MSE between cos(u, v) and the gold score (STS)
- ``contrastive_loss``: cosine-distance margin contrastive
- ``online_contrastive_loss``: hard-pair mining inside the batch, with
  masked reductions (static shapes)
- ``distill_mse_loss``: embedding-matching distillation
- ``multiple_negatives_loss``: in-batch negatives InfoNCE (MNRL)
- ``cross_entropy_loss``: a classification head's CE
- ``mlm_loss``: masked-LM CE over the predicted positions
- ``hidden_state_mse``: layer-mapped hidden-state matching (FastFormers)
- ``kl_distill_loss``: temperature-scaled logit distillation

Every pair loss takes an optional ``valid`` (B,) mask: padded rows of a
tail batch count nowhere. Reductions run in f32.
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


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked-LM cross entropy of (B, S, V) logits over the positions whose
    (B, S) label is not −100, averaged over those positions."""
    valid = labels >= 0
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    w = valid.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def hidden_state_mse(
    student_hidden: torch.Tensor,                 # (Ls + 1, B, S, H)
    teacher_hidden: torch.Tensor,                 # (Lt + 1, B, S, H)
    mask: Optional[torch.Tensor] = None,          # (B, S)
    layer_map=None,                               # (Ls + 1,) teacher index a student layer
) -> torch.Tensor:
    """Student layer i against teacher layer ``layer_map[i]`` (a student
    initialised from teacher layers keep_layers aligns with those), else the
    uniform round(i · Lt / Ls) map; both count the embeddings as layer 0.
    The squared error is averaged over H, then over the masked tokens and
    the Ls + 1 layers."""
    ls = student_hidden.shape[0] - 1
    lt = teacher_hidden.shape[0] - 1
    if layer_map is not None:
        idx = torch.as_tensor(layer_map, dtype=torch.long)
    else:
        # round half to even, as jnp.round
        idx = torch.round(torch.arange(ls + 1, dtype=torch.float32) * (lt / max(ls, 1))).long()
    mapped = teacher_hidden[idx.to(teacher_hidden.device)]
    err = (student_hidden.float() - mapped.float()).square().mean(dim=-1)   # (Ls + 1, B, S)
    if mask is None:
        return err.mean()
    w = mask.float()[None]
    return (err * w).sum() / (w.sum() * (ls + 1)).clamp_min(1.0)


def kl_distill_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    temperature: float = 2.0,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL(teacher ‖ student) of the temperature-softened distributions,
    times T², a row."""
    t = temperature
    sp = F.log_softmax(student_logits.float() / t, dim=-1)
    tp = F.softmax(teacher_logits.float() / t, dim=-1)
    kl = (tp * (torch.log(tp.clamp_min(1e-12)) - sp)).sum(dim=-1) * t * t
    return _masked_mean(kl, valid)
