"""Pooling strategies turning token states into sentence embeddings (port of
``text_similarity_tpu.models.pooling``: masked mean, CLS, masked max, and
the per-segment mean and first-token pools of packed rows, BERT's tanh
pooler, and the target word's span pool of the word models)."""

from __future__ import annotations

from typing import Optional

import torch


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence axis; hidden (B, S, H), mask (B, S)
    with 1 = real token; the token count is clamped at 1e-9."""
    m = mask.float()[..., None]
    summed = (hidden.float() * m).sum(dim=1)
    count = m.sum(dim=1).clamp_min(1e-9)
    return (summed / count).to(hidden.dtype)


def cls_pool(hidden: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return hidden[:, 0, :]


def max_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    neg = torch.finfo(torch.float32).min
    m = mask.bool()[..., None]
    filled = torch.where(m, hidden.float(), torch.full_like(hidden, neg, dtype=torch.float32))
    return filled.amax(dim=1).to(hidden.dtype)


def segment_mean_pool(
    hidden: torch.Tensor,    # (B, S, H)
    segments: torch.Tensor,  # (B, S) 1-based segment tag per token, 0 = pad
    max_segments: int,       # segment slots per row (the layout's owners width)
) -> torch.Tensor:
    """Per-segment masked mean of packed rows (``data.packing``) → (B,
    max_segments, H) in hidden's dtype; empty slots come out zero. One f32
    (B,S,M)×(B,S,H) product over a one-hot of the tags, divided by the
    token count clamped at 1e-9, as the reference's einsum."""
    tags = torch.arange(1, max_segments + 1, dtype=segments.dtype, device=segments.device)
    oh = (segments[:, :, None] == tags[None, None, :]).float()
    summed = torch.einsum("bsm,bsh->bmh", oh, hidden.float())
    count = oh.sum(dim=1).clamp_min(1e-9)    # (B, M)
    return (summed / count[..., None]).to(hidden.dtype)


def segment_first_pool(
    hidden: torch.Tensor,    # (B, S, H)
    segments: torch.Tensor,  # (B, S) 1-based segment tag per token, 0 = pad
    max_segments: int,
) -> torch.Tensor:
    """Per-segment first-token (CLS) pool of packed rows: slot m holds the
    hidden state at the first position tagged m + 1 → (B, max_segments, H);
    empty slots come out zero."""
    b, s, _ = hidden.shape
    pos = torch.arange(s, device=segments.device)
    tags = torch.arange(1, max_segments + 1, dtype=segments.dtype, device=segments.device)
    is_m = segments[:, :, None] == tags[None, None, :]                       # (B, S, M)
    first = torch.where(is_m, pos[None, :, None], s).amin(dim=1)              # (B, M)
    gathered = torch.gather(
        hidden, 1, first.clamp(max=s - 1)[:, :, None].expand(-1, -1, hidden.shape[2])
    )
    # the zero lives on hidden's device: a host scalar would cost a blocking copy
    return torch.where((first < s)[:, :, None], gathered, hidden.new_zeros(()))


def bert_pooler(hidden: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """BERT's pooler: tanh(W · h_CLS + b), taken in f32 and cast back to
    the hidden dtype."""
    cls = hidden[:, 0, :].float()
    return torch.tanh(cls @ w.float() + b.float()).to(hidden.dtype)


POOLERS = {
    "mean": mean_pool,
    "cls": cls_pool,
    "max": max_pool,
}


def word_span_pool(hidden: torch.Tensor, span_indices: torch.Tensor) -> torch.Tensor:
    """Mean of one target word's sub-token vectors an example: hidden (B,
    S, H), span_indices (B, W) positions padded with −1 → (B, H) in
    hidden's dtype (the sum in f32)."""
    valid = (span_indices >= 0).float()
    idx = span_indices.long().clamp_min(0)
    gathered = torch.gather(hidden, 1, idx[..., None].expand(-1, -1, hidden.shape[-1])).float()
    summed = (gathered * valid[..., None]).sum(dim=1)
    count = valid.sum(dim=1, keepdim=True).clamp_min(1.0)
    return (summed / count).to(hidden.dtype)


def pool(strategy: str, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if strategy not in POOLERS:
        raise ValueError(f"unknown pooling {strategy}")
    return POOLERS[strategy](hidden, mask)
