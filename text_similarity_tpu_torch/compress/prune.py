"""Structured pruning (port of ``text_similarity_tpu.compress.prune``):
gradient-based head and FFN-neuron importance, then a rewire that slices
the stacked layer parameters down to the most important heads and neurons
of each layer.

Head importance is |∂loss/∂head_mask| of the classifier's f32 loss with
respect to an (L, nh) mask of ones (the encoder scales each head's
attention by it); FFN importance the first-order Taylor score
|W_out ⊙ ∂loss/∂W_out| summed over the output axis. Both accumulate over
the batches in f64 on the host, as the reference does, and are normalised
per layer. The rewire gathers along the head and neuron axes of the
(L, …) stack, so the pruned model is a smaller dense one whose arch sets
``head_dim_override``.

The training code is imported where it runs: ``models.encoder`` imports
``compress.quantize``, so this package may not import ``train`` or
``models`` when it loads.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.config import EncoderArch
from ..core.precision import FP32_PRECISION
from ..utils.logging import get_logger

logger = get_logger("prune")


def _device_of(params: dict) -> torch.device:
    return params["encoder"]["layers"]["mlp"]["out"]["w"].device


def _loss(params, arch, batch, pooling, head_mask=None):
    from ..models.losses import cross_entropy_loss
    from ..train.steps import batch_to, classifier_forward

    batch = batch_to(batch, _device_of(params))
    logits = classifier_forward(
        params, batch["ids"], batch["mask"], batch.get("type_ids"), arch=arch,
        precision=FP32_PRECISION, pooling=pooling, head_mask=head_mask,
    )
    return cross_entropy_loss(logits, batch["labels"], batch.get("valid"))


def _normalize(acc: np.ndarray, normalize_layers: bool) -> np.ndarray:
    if normalize_layers:
        acc = acc / np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-20)
    return acc


def head_importance(
    params: dict,                 # {"encoder": ..., "head": ...} tensors
    arch: EncoderArch,
    batches,                      # classifier batches (ids / mask / labels / valid)
    pooling: str = "cls",
    normalize_layers: bool = True,
) -> np.ndarray:
    """(L, nh) |∂loss/∂head_mask| summed over the batches, on the params'
    device."""
    dev = _device_of(params)
    acc = np.zeros((arch.num_layers, arch.num_heads), np.float64)
    for b in batches:
        hm = torch.ones((arch.num_layers, arch.num_heads), device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(_loss(params, arch, b, pooling, hm), hm)
        acc += np.abs(g.cpu().numpy().astype(np.float64))
    return _normalize(acc, normalize_layers)


def ffn_importance(
    params: dict,
    arch: EncoderArch,
    batches,
    pooling: str = "cls",
    normalize_layers: bool = True,
) -> np.ndarray:
    """(L, intermediate) Taylor importance |W_out ⊙ ∂loss/∂W_out| summed
    over the output axis and the batches."""
    w = params["encoder"]["layers"]["mlp"]["out"]["w"].detach()
    w64 = w.cpu().numpy().astype(np.float64)
    acc = np.zeros((arch.num_layers, arch.intermediate_size), np.float64)
    for b in batches:
        leaf = w.clone().requires_grad_(True)
        enc = dict(params["encoder"])
        layers = dict(enc["layers"])
        layers["mlp"] = dict(layers["mlp"], out=dict(layers["mlp"]["out"], w=leaf))
        enc["layers"] = layers
        tree = dict(params, encoder=enc)
        (g,) = torch.autograd.grad(_loss(tree, arch, b, pooling), leaf)
        acc += np.abs(g.cpu().numpy().astype(np.float64) * w64).sum(axis=2)
    return _normalize(acc, normalize_layers)


def head_mask_from_importance(importance: np.ndarray, keep_fraction: float) -> np.ndarray:
    """Binary (L, H) mask keeping the top fraction of heads a layer."""
    l, h = importance.shape
    keep = max(int(round(h * keep_fraction)), 1)
    mask = np.zeros((l, h), np.float32)
    for i in range(l):
        mask[i, np.argsort(-importance[i])[:keep]] = 1.0
    return mask


def prune_rewire(
    params: dict,                 # encoder params (stacked layers), tensors
    arch: EncoderArch,
    head_imp: np.ndarray,         # (L, nh)
    ffn_imp: np.ndarray,          # (L, intermediate)
    target_heads: int,
    target_ffn: int,
) -> Tuple[dict, EncoderArch]:
    """Each layer keeps its ``target_heads`` most important heads and
    ``target_ffn`` most important FFN neurons, in index order → (new
    params, new arch with ``head_dim_override`` = the old head width)."""
    l, nh = head_imp.shape
    hd, h = arch.head_dim, arch.hidden_size
    if target_heads > nh or target_ffn > arch.intermediate_size:
        raise ValueError(f"targets {target_heads} heads, {target_ffn} neurons exceed the model's "
                         f"{nh}, {arch.intermediate_size}")

    def top(imp, n):
        return np.stack([np.sort(np.argsort(-imp[i])[:n]) for i in range(l)])

    layers = params["layers"]
    dev = layers["mlp"]["out"]["w"].device
    hi = torch.as_tensor(top(head_imp, target_heads), device=dev)   # (L, heads)
    fi = torch.as_tensor(top(ffn_imp, target_ffn), device=dev)      # (L, neurons)
    a = target_heads * hd

    def qkv(wb):   # w (L, H, nh·hd) → (L, H, heads·hd); b (L, nh·hd) → (L, heads·hd)
        w = torch.take_along_dim(wb["w"].reshape(l, h, nh, hd), hi[:, None, :, None], dim=2)
        b = torch.take_along_dim(wb["b"].reshape(l, nh, hd), hi[:, :, None], dim=1)
        return {"w": w.reshape(l, h, a), "b": b.reshape(l, a)}

    def out(wb):   # w (L, nh·hd, H) → (L, heads·hd, H)
        w = torch.take_along_dim(wb["w"].reshape(l, nh, hd, h), hi[:, :, None, None], dim=1)
        return {"w": w.reshape(l, a, h), "b": wb["b"]}

    attn, mlp = layers["attn"], layers["mlp"]
    new_layers = {
        "attn": {"q": qkv(attn["q"]), "k": qkv(attn["k"]), "v": qkv(attn["v"]),
                 "o": out(attn["o"])},
        "attn_ln": layers["attn_ln"],
        "mlp": {
            "in": {"w": torch.take_along_dim(mlp["in"]["w"], fi[:, None, :], dim=2),
                   "b": torch.take_along_dim(mlp["in"]["b"], fi, dim=1)},
            "out": {"w": torch.take_along_dim(mlp["out"]["w"], fi[:, :, None], dim=1),
                    "b": mlp["out"]["b"]},
        },
        "mlp_ln": layers["mlp_ln"],
    }
    new_arch = arch.replace(num_heads=target_heads, intermediate_size=target_ffn,
                            head_dim_override=hd)
    logger.info("pruned %d→%d heads, %d→%d ffn dims per layer",
                nh, target_heads, arch.intermediate_size, target_ffn)
    return dict(params, layers=new_layers), new_arch
