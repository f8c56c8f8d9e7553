"""Pooling strategies turning token states into sentence embeddings (port of
``text_similarity_tpu.models.pooling``: masked mean, CLS, masked max)."""

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


POOLERS = {
    "mean": mean_pool,
    "cls": cls_pool,
    "max": max_pool,
}


def pool(strategy: str, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if strategy not in POOLERS:
        raise ValueError(f"unknown pooling {strategy}")
    return POOLERS[strategy](hidden, mask)
