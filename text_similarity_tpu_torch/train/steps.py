"""Train-step factories (port of ``text_similarity_tpu.train.steps``: the
bi-encoder step, and the classifier forward the cross-encoder scores with).

A step is eager PyTorch: two tower passes that share the encoder weights
(dropout from the state's ``torch.Generator``), the pair loss, the
gradients of every parameter leaf (``torch.autograd.grad``; on the card
every flash layer runs K5 forward and K6 backward), then the optimizer's
in-place update. Metrics come back as device scalars; nothing waits for
the device inside a step.

Parameters are a plain tree ``{"encoder": ..., "head": ...}`` of f32 leaf
tensors that require grad, in the JAX package's layout, so
``models.params_from_jax`` carries a JAX tree across and a trained encoder
saves in the shared checkpoint format.

Not ported yet: the cross-encoder / classifier step (its forward,
``classifier_forward``, is here), the token, word, MLM, packed, theseus and
distillation steps, ``remat``, pipeline parallelism and MoE
auxiliary losses.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import EncoderArch
from ..core.precision import DEFAULT_PRECISION, Precision, resolve_device
from ..models import losses as L
from ..models.encoder import dequant_weight, encoder_forward
from ..models.pooling import cls_pool, mean_pool, pool
from .optim import AdamW, _leaves


class TrainState(NamedTuple):
    params: dict              # {"encoder": ..., "head": ...}, f32 leaves that require grad
    opt_state: dict           # the optimizer's state tree
    step: int                 # steps taken
    rng: torch.Generator      # dropout masks, on the params' device


def trainable(tree: dict, device=None) -> dict:
    """A copy of ``tree`` as f32 leaf tensors that require grad (on
    ``device``, or where each leaf lies)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            if set(val) == {"q", "s"}:
                raise ValueError("int8 leaves cannot train; train the float weights")
            out[key] = trainable(val, device)
        else:
            t = torch.as_tensor(np.asarray(val)) if not isinstance(val, torch.Tensor) else val
            t = t.detach().to(device or t.device, torch.float32)
            out[key] = t.clone().requires_grad_(True)
    return out


def init_train_state(params: dict, tx: AdamW, seed: int = 0, device="cuda") -> TrainState:
    """Trainable f32 copies of ``params`` on ``device``, the optimizer's
    state, step 0 and a generator seeded with ``seed``."""
    dev = resolve_device(device)
    params = trainable(params, dev)
    return TrainState(params, tx.init(params), 0, torch.Generator(device=dev).manual_seed(seed))


def _embed(
    enc_params: dict, ids, mask, *, arch: EncoderArch, precision: Precision, pooling: str,
    generator: Optional[torch.Generator], deterministic: bool, attention_impl: str = "auto",
) -> torch.Tensor:
    """Encoder → pooling → the optional ``projection`` head → (B, D)."""
    out = encoder_forward(
        enc_params, ids, mask, arch=arch, precision=precision, attention_impl=attention_impl,
        deterministic=deterministic, generator=generator,
    )
    pooled = pool(pooling, out.last_hidden_state, mask)
    if "projection" in enc_params:
        pw = enc_params["projection"]
        pooled = pooled.float() @ pw["w"] + pw["b"]
    return pooled


def classifier_forward(
    params: dict, ids, mask, type_ids=None, *, arch: EncoderArch,
    precision: Precision = DEFAULT_PRECISION, pooling: str = "cls",
) -> torch.Tensor:
    """Encoder → pool → linear head → (B, C) f32 logits, without dropout.
    ``cls`` pooling takes the tanh pooler's output where the arch has one,
    else the CLS state; any other pooling the masked mean."""
    out = encoder_forward(params["encoder"], ids, mask, type_ids, arch=arch, precision=precision)
    if pooling == "cls":
        pooled = (out.pooler_output if out.pooler_output is not None
                  else cls_pool(out.last_hidden_state, mask))
    else:
        pooled = mean_pool(out.last_hidden_state, mask)
    head = params["head"]
    return pooled.float() @ dequant_weight(head["w"]).float() + head["b"].float()


def init_classifier_head(
    generator: torch.Generator, in_dim: int, num_classes: int, device="cuda"
) -> dict:
    """A linear head: w ~ N(0, 0.02²) drawn from ``generator``, b = 0."""
    dev = resolve_device(device)
    w = torch.randn((in_dim, num_classes), generator=generator, device=generator.device) * 0.02
    return {"w": w.to(dev), "b": torch.zeros((num_classes,), device=dev)}


def _masked_accuracy(logits, labels, valid) -> torch.Tensor:
    hit = (logits.argmax(dim=-1) == labels.long()).float()
    if valid is None:
        return hit.mean()
    w = valid.float()
    return (hit * w).sum() / w.sum().clamp_min(1.0)


def _pair_objective(loss_type: str, params: dict, u, v, target, valid, margin: float):
    """The SBERT pair-loss switch → (loss, aux metrics)."""
    aux = {}
    if loss_type == "softmax":
        head = params["head"]
        loss, logits = L.softmax_loss(u, v, head["w"], head["b"], target, valid)
        aux["accuracy"] = _masked_accuracy(logits, target, valid)
    elif loss_type == "cosine_mse":
        loss, _ = L.cosine_mse_loss(u, v, target, valid)
    elif loss_type == "contrastive":
        loss, _ = L.contrastive_loss(u, v, target, margin, valid)
    elif loss_type == "online_contrastive":
        loss, _ = L.online_contrastive_loss(u, v, target, margin, valid)
    elif loss_type == "mnrl":
        loss, _ = L.multiple_negatives_loss(u, v, valid=valid)
    elif loss_type == "distill_mse":
        loss = L.distill_mse_loss(u, target, valid)
    else:
        raise ValueError(f"unknown loss {loss_type}")
    return loss, aux


def bi_encoder_loss(
    params: dict, batch: dict, *, arch: EncoderArch, loss_type: str = "cosine_mse",
    pooling: str = "mean", precision: Precision = DEFAULT_PRECISION, margin: float = 0.5,
    generator: Optional[torch.Generator] = None, deterministic: bool = False,
    attention_impl: str = "auto",
):
    """The bi-encoder objective on one batch (device tensors ids_a, mask_a,
    ids_b, mask_b, target, valid): two tower passes over the shared
    encoder, then the pair loss → (loss, aux metrics)."""
    kw = dict(arch=arch, precision=precision, pooling=pooling, generator=generator,
              deterministic=deterministic, attention_impl=attention_impl)
    enc = params["encoder"]
    u = _embed(enc, batch["ids_a"], batch["mask_a"], **kw)
    v = _embed(enc, batch["ids_b"], batch["mask_b"], **kw)
    return _pair_objective(loss_type, params, u, v, batch.get("target"), batch.get("valid"),
                           margin)


def _like(tree: dict, flat: list) -> dict:
    """``flat`` (in ``_leaves`` order) in the structure of ``tree``."""
    it = iter(flat)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it) for k, v in t.items()}

    return build(tree)


def batch_to(batch: dict, device: torch.device) -> dict:
    """Host (numpy) or device arrays → tensors on ``device`` (a copy only
    where needed)."""
    return {
        k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(
            device, non_blocking=True)
        for k, v in batch.items()
    }


def value_and_grad(loss_fn: Callable, params: dict, *args, **kwargs):
    """(loss, aux, grads) of ``loss_fn(params, ...) → (loss, aux)``: the
    gradient of every leaf of ``params`` (zeros for a leaf the loss does
    not reach, such as the pooler under mean pooling), in its structure."""
    loss, aux = loss_fn(params, *args, **kwargs)
    leaves = _leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss, aux, _like(params, grads)


def make_bi_encoder_train_step(
    arch: EncoderArch,
    tx: AdamW,
    loss_type: str = "cosine_mse",   # softmax | cosine_mse | contrastive |
                                     # online_contrastive | mnrl | distill_mse
    pooling: str = "mean",
    precision: Precision = DEFAULT_PRECISION,
    margin: float = 0.5,
    device="cuda",
) -> Callable:
    """Returns step(state, batch) → (state, metrics): the loss and its
    gradients (dropout on), then ``tx``'s in-place update. batch: ids_a,
    mask_a, ids_b, mask_b, target (labels, scores or teacher embeddings),
    valid (B,); host arrays or tensors on ``device``. The state's
    parameters must lie on ``device``. metrics: {"loss", …} as device
    scalars."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict):
        leaf = _leaves(state.params)[0]
        if leaf.device.type != dev.type:
            raise ValueError(f"the state lies on {leaf.device}, the step runs on {dev}")
        batch = batch_to(batch, leaf.device)
        loss, aux, grads = value_and_grad(
            bi_encoder_loss, state.params, batch, arch=arch, loss_type=loss_type,
            pooling=pooling, precision=precision, margin=margin, generator=state.rng,
            deterministic=False,
        )
        tx.step(state.params, grads, state.opt_state)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        return state._replace(step=state.step + 1), metrics

    return step
