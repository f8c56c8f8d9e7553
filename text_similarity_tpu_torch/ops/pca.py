"""PCA through the SVD of the centred matrix (port of
``text_similarity_tpu.ops.pca``): the one implementation behind the topic
pipeline's linear reduction (``pipelines.topic.pca_reduce``) and the
dimension-reducing distiller's teacher targets
(``compress.distill.pca_reduce``). A component's sign is the SVD's own, so
it may differ from the JAX package's; the projections agree up to each
component's sign."""

from __future__ import annotations

from typing import Tuple

import torch


def pca_fit_transform(emb, dim: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (reduced (N, dim), mean (1, D), components (dim, D)), f32 on
    ``emb``'s device (a non-tensor input goes to the CPU)."""
    x = torch.as_tensor(emb).float()
    mu = x.mean(dim=0, keepdim=True)
    xc = x - mu
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    comp = vt[:dim]
    return xc @ comp.T, mu, comp
