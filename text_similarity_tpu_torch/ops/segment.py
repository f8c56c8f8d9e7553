"""Label-graph ops (port of ``text_similarity_tpu.ops.segment``): the
sparse adjacency product over an edge list, and structured logits, which
mix each class logit with its graph neighbours' mean. The sums are
``index_add`` over the edges (the reference's ``segment_sum``)."""

from __future__ import annotations

import torch


def adjacency_matvec(
    values: torch.Tensor,       # (..., C) per-class values
    edge_src: torch.Tensor,     # (E,) the neighbour class
    edge_dst: torch.Tensor,     # (E,) the receiving class
    edge_weight: torch.Tensor,  # (E,)
    num_classes: int,
    normalize: bool = True,
) -> torch.Tensor:
    """y[..., dst] = Σ_edges w · x[..., src] (sparse A @ x), divided by the
    receiving class's weighted in-degree (at least 1e-9) with
    ``normalize``."""
    src, dst = edge_src.long(), edge_dst.long()
    gathered = values[..., src] * edge_weight
    out = values.new_zeros(values.shape[:-1] + (num_classes,)).index_add_(-1, dst, gathered)
    if normalize:
        deg = edge_weight.new_zeros((num_classes,)).index_add_(0, dst, edge_weight)
        out = out / deg.clamp_min(1e-9)
    return out


def structured_logits(
    logits: torch.Tensor,       # (B, C)
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_weight: torch.Tensor,
    alpha: float = 0.5,
) -> torch.Tensor:
    """(1 − alpha) · logits + alpha · the neighbourhood's mean logit."""
    neighbor = adjacency_matvec(logits, edge_src, edge_dst, edge_weight, logits.shape[-1],
                                normalize=True)
    return (1.0 - alpha) * logits + alpha * neighbor
