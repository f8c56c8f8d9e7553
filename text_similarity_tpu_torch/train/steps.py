"""Train-step factories (port of ``text_similarity_tpu.train.steps``): the
bi-encoder step, the classifier / cross-encoder step, the packed
bi-encoder and packed classifier steps, the token-classifier (NER) step,
the masked-LM step, the word-in-context (WiC) step and the FastFormers
distillation step, with their forwards.

A step is eager PyTorch: the tower passes (dropout from the state's
``torch.Generator``), the loss, the gradients of every parameter leaf
(``torch.autograd.grad``; on the card every flash layer runs K5 forward
and K6 backward), then the optimizer's in-place update. Metrics come back
as device scalars; nothing waits for the device inside a step. ``remat``
(bi-encoder and packed steps) recomputes each layer in the backward.

Parameters are a plain tree ``{"encoder": ..., "head": ...}`` of f32 leaf
tensors that require grad, in the JAX package's layout, so
``models.params_from_jax`` carries a JAX tree across and a trained encoder
saves in the shared checkpoint format. Packed steps scatter each segment's
output to its pair's slot through an explicit trash row for empty slots.

The FastFormers step runs the frozen teacher under ``torch.no_grad()``;
the theseus step lives with its forward in ``compress.theseus``; both
refuse MoE archs, as the reference does.

MoE archs: every other step adds ``moe_aux_weight`` × the encoder's
load-balance loss (the mean of the two towers' for twin-tower steps) and
reports ``moe_aux`` / ``moe_drop``. Performer archs with
``performer_redraw_every`` > 0: the bi-encoder and MLM steps pass the
state's step into the forward, so the projection's epoch advances (the
reference's ``_redraw_step``); the packed steps refuse Performer.

Distributed training on the one-controller mesh (``core.mesh``):
``init_sharded_train_state`` places the parameters by a spec tree
(``models.encoder.param_pspecs`` for tensor and expert parallelism,
``fsdp_param_pspecs``; replicated by default), then the optimizer's moments
on the pieces. Every step takes such a state as it is: ``encoder_forward``
runs ``models.sharded`` over the mesh (the batch rows over the data axis),
the last hidden states come back to the first device, and the objective
runs there once over the global batch (an MNRL step's in-batch negatives
span every data position, as the reference's jitted step computes them
over the global arrays). The batch may be host arrays, tensors, or the
per-position pieces of ``shard_batch_for``. With ``pp_mesh`` (the
bi-encoder, classifier, token-classifier, word-encoder and MLM steps) the
layer stack runs pipeline-parallel (``models.pipeline``) over a whole
state, with the reference's refusals (head masks, MoE) and its pooler tail.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import EncoderArch
from ..core.mesh import DATA_AXIS, Mesh, ShardedLeaf, gather_leaf, mesh_of, place, shard_batch
from ..core.precision import DEFAULT_PRECISION, Precision, resolve_device
from ..models import losses as L
from ..models.encoder import EncoderOutput, dequant_weight, encoder_forward
from ..models.pooling import (
    bert_pooler, cls_pool, mean_pool, pool, segment_first_pool, segment_mean_pool, word_span_pool,
)
from ..utils.profiling import span
from .optim import AdamW, _leaves


class TrainState(NamedTuple):
    params: dict              # {"encoder": ..., "head": ...}, f32 leaves that require grad
    opt_state: dict           # the optimizer's state tree
    step: int                 # steps taken
    rng: torch.Generator      # dropout masks, on the params' device


def trainable(tree: dict, device=None) -> dict:
    """A copy of ``tree`` as f32 leaf tensors that require grad (on
    ``device``, or where each leaf lies; a sharded leaf's pieces where they
    lie)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            if set(val) == {"q", "s"}:
                raise ValueError("int8 leaves cannot train; train the float weights")
            out[key] = trainable(val, device)
        elif isinstance(val, ShardedLeaf):
            out[key] = val.like([p.detach().float().clone().requires_grad_(True)
                                 for p in val.pieces])
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


def init_sharded_train_state(params: dict, tx: AdamW, mesh: Mesh, param_specs=None,
                             seed: int = 0) -> TrainState:
    """A train state placed on ``mesh``: the parameters first, by
    ``param_specs`` (a tree of ``core.mesh.PartitionSpec`` like ``params``,
    e.g. ``{"encoder": param_pspecs(arch), "head": ...}``; None replicates
    every leaf), as f32 pieces that require grad, then ``tx.init`` over the
    pieces, so each moment lies beside its piece. The generator lies on the
    mesh's first device."""
    placed = trainable(place(params, mesh, param_specs))
    gen = torch.Generator(device=mesh.first_device).manual_seed(seed)
    return TrainState(placed, tx.init(placed), 0, gen)


def shard_batch_for(mesh: Optional[Mesh], batch: dict):
    """``batch`` split over the mesh's data positions (one dict a position,
    on its device; ``core.mesh.shard_batch``), or as it is without a mesh.
    The rows must divide evenly, as the reference's placement requires."""
    if mesh is None:
        return batch
    n = mesh.shape[DATA_AXIS]
    for key, val in batch.items():
        if len(val) % n:
            raise ValueError(f"{key}: {len(val)} rows do not split over the data axis ({n})")
    return shard_batch(mesh, batch)


def _encoder_out(
    enc_params: dict, ids, mask, type_ids=None, *, arch: EncoderArch, precision: Precision,
    generator: Optional[torch.Generator] = None, deterministic: bool = True,
    attention_impl: str = "auto", head_mask=None, remat=False,
    performer_step: Optional[int] = None, pp_mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
) -> EncoderOutput:
    """``encoder_forward``, or with ``pp_mesh`` the layer stack pipeline-
    parallel over its pipe axis (``models.pipeline.encoder_forward_pp``,
    composed with its data axis) and the pooler after it, as the
    reference's ``_encoder_out``. Every step's encoder forward goes through
    here, so ``pp_mesh`` works alike across objectives."""
    if pp_mesh is None:
        return encoder_forward(
            enc_params, ids, mask, type_ids, arch=arch, precision=precision,
            attention_impl=attention_impl, deterministic=deterministic, generator=generator,
            head_mask=head_mask, remat=remat, performer_step=performer_step,
        )
    if head_mask is not None:
        raise ValueError("head_mask is not supported with pp_mesh")
    if arch.num_experts > 0:
        raise ValueError(
            "MoE archs are not supported with pp_mesh (the pipelined "
            "stack would drop the load-balance aux loss); use DP/TP/EP"
        )
    if mesh_of(enc_params) is not None:
        raise ValueError("pp_mesh runs a whole parameter tree, not a sharded one")
    from ..models.pipeline import encoder_forward_pp

    hidden = encoder_forward_pp(
        enc_params, ids, mask, arch=arch, mesh=pp_mesh, microbatches=pp_microbatches,
        precision=precision, token_type_ids=type_ids, attention_impl=attention_impl,
        remat=remat, deterministic=deterministic, generator=generator,
        performer_step=performer_step,
    )
    pooler_out = None
    if arch.has_pooler and "pooler" in enc_params:
        pw = enc_params["pooler"]   # the tail of encoder_forward
        pooler_out = bert_pooler(hidden, dequant_weight(pw["w"]), pw["b"])
    return EncoderOutput(hidden, pooler_out)


def _moe_stats_of(out) -> torch.Tensor:
    """(2,) [load-balance loss, dropped fraction] of an ``EncoderOutput``
    (zeros for a dense arch)."""
    if out.moe_aux is None:
        return torch.zeros((2,), dtype=torch.float32, device=out.last_hidden_state.device)
    return torch.stack([out.moe_aux, out.moe_drop])


def _with_moe(arch: EncoderArch, loss, aux: dict, moe: torch.Tensor):
    """For an MoE arch: loss + ``moe_aux_weight`` × the load-balance loss,
    and ``moe_aux`` / ``moe_drop`` in the metrics → (loss, aux)."""
    if arch.num_experts > 0:
        loss = loss + arch.moe_aux_weight * moe[0]
        aux = {**aux, "moe_aux": moe[0], "moe_drop": moe[1]}
    return loss, aux


def _redraw_step(arch: EncoderArch, state: "TrainState") -> Optional[int]:
    """The step a Performer arch that redraws its features passes into the
    forward (the projection is a function of ``step // every``), else
    None."""
    if arch.attention_type == "performer" and arch.performer_redraw_every > 0:
        return state.step
    return None


def _embed(
    enc_params: dict, ids, mask, *, arch: EncoderArch, precision: Precision, pooling: str,
    generator: Optional[torch.Generator], deterministic: bool, attention_impl: str = "auto",
    remat=False, performer_step: Optional[int] = None, pp_mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
):
    """Encoder → pooling → the optional ``projection`` head → ((B, D), (2,)
    MoE stats)."""
    out = _encoder_out(
        enc_params, ids, mask, arch=arch, precision=precision, attention_impl=attention_impl,
        deterministic=deterministic, generator=generator, remat=remat,
        performer_step=performer_step, pp_mesh=pp_mesh, pp_microbatches=pp_microbatches,
    )
    return _project(enc_params, pool(pooling, out.last_hidden_state, mask)), _moe_stats_of(out)


def _whole(leaf, device) -> torch.Tensor:
    """A head leaf on ``device``: a sharded one gathered by differentiable
    copies (the objective runs on the mesh's first device)."""
    if isinstance(leaf, ShardedLeaf):
        return gather_leaf(leaf, device)
    return leaf


def _project(enc_params: dict, pooled: torch.Tensor) -> torch.Tensor:
    """The optional ``projection`` head (dimension-reduced students)."""
    if "projection" in enc_params:
        pw = enc_params["projection"]
        pooled = pooled.float() @ _whole(pw["w"], pooled.device) + _whole(pw["b"], pooled.device)
    return pooled


def classifier_forward(
    params: dict, ids, mask, type_ids=None, *, arch: EncoderArch,
    precision: Precision = DEFAULT_PRECISION, pooling: str = "cls",
    generator: Optional[torch.Generator] = None, deterministic: bool = True,
    head_mask: Optional[torch.Tensor] = None, with_moe_aux: bool = False,
    pp_mesh: Optional[Mesh] = None, pp_microbatches: Optional[int] = None,
):
    """Encoder → pool → linear head → (B, C) f32 logits (dropout with
    ``deterministic=False``). ``cls`` pooling takes the tanh pooler's
    output where the arch has one, else the CLS state; any other pooling
    the masked mean. ``head_mask`` (L, nh) scales the heads' attention.
    ``with_moe_aux=True`` returns ``(logits, (2,) MoE stats)``."""
    out = _encoder_out(params["encoder"], ids, mask, type_ids, arch=arch, precision=precision,
                       deterministic=deterministic, generator=generator, head_mask=head_mask,
                       pp_mesh=pp_mesh, pp_microbatches=pp_microbatches)
    if pooling == "cls":
        pooled = (out.pooler_output if out.pooler_output is not None
                  else cls_pool(out.last_hidden_state, mask))
    else:
        pooled = mean_pool(out.last_hidden_state, mask)
    return (_head(params, pooled), _moe_stats_of(out)) if with_moe_aux else _head(params, pooled)


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x · head.w + head.b in f32 (an int8 w dequantized, a sharded one
    gathered to x's device)."""
    head = params["head"]
    w = dequant_weight(_whole(head["w"], x.device))
    return x.float() @ w.float() + _whole(head["b"], x.device).float()


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
        loss, logits = L.softmax_loss(u, v, _whole(head["w"], u.device),
                                      _whole(head["b"], u.device), target, valid)
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
    attention_impl: str = "auto", remat=False, performer_step: Optional[int] = None,
    pp_mesh: Optional[Mesh] = None, pp_microbatches: Optional[int] = None,
):
    """The bi-encoder objective on one batch (device tensors ids_a, mask_a,
    ids_b, mask_b, target, valid): two tower passes over the shared
    encoder, then the pair loss → (loss, aux metrics); an MoE arch adds the
    towers' mean load-balance loss. ``distill_mse`` reads the a side only,
    so the b tower does not run (its MoE term is the a tower's)."""
    kw = dict(arch=arch, precision=precision, pooling=pooling, generator=generator,
              deterministic=deterministic, attention_impl=attention_impl, remat=remat,
              performer_step=performer_step, pp_mesh=pp_mesh, pp_microbatches=pp_microbatches)
    enc = params["encoder"]
    u, moe = _embed(enc, batch["ids_a"], batch["mask_a"], **kw)
    v = None
    if loss_type != "distill_mse":
        v, moe_v = _embed(enc, batch["ids_b"], batch["mask_b"], **kw)
        moe = 0.5 * (moe + moe_v)
    loss, aux = _pair_objective(loss_type, params, u, v, batch.get("target"),
                                batch.get("valid"), margin)
    return _with_moe(arch, loss, aux, moe)


def _like(tree: dict, flat: list) -> dict:
    """``flat`` (in ``_leaves`` order: a sharded leaf's pieces in its place)
    in the structure of ``tree``."""
    it = iter(flat)

    def leaf(v):
        if isinstance(v, ShardedLeaf):
            return v.like([next(it) for _ in v.pieces])
        return next(it)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else leaf(v) for k, v in t.items()}

    return build(tree)


def batch_to(batch, device: torch.device) -> dict:
    """Host (numpy) or device arrays → tensors on ``device`` (a copy only
    where needed). A list of per-position batches (``shard_batch_for``) is
    joined back, rows in position order."""
    if isinstance(batch, (list, tuple)):
        return {k: torch.cat([part[k].to(device, non_blocking=True) for part in batch])
                for k in batch[0]}
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
    with span("ts.train.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss, aux, _like(params, grads)


def _make_step(loss_fn: Callable, tx: AdamW, device, redraw_arch: Optional[EncoderArch] = None
               ) -> Callable:
    """step(state, batch, *extra) → (state, metrics) of ``loss_fn(params,
    batch, generator, *extra) → (loss, aux)``: its gradients, then ``tx``'s
    in-place update. The state's parameters must lie on ``device`` (a
    sharded state: its mesh's first device, where the batch is joined); the
    batch may be host arrays, tensors or per-position pieces. metrics:
    {"loss", …} as device scalars. With ``redraw_arch``, ``loss_fn`` also takes
    ``performer_step`` (``_redraw_step`` of the state)."""
    dev = resolve_device(device)

    def step(state: TrainState, batch, *extra):
        with span("ts.train.step"):
            mesh = mesh_of(state.params)
            home = mesh.first_device if mesh is not None else _leaves(state.params)[0].device
            if home.type != dev.type:
                raise ValueError(f"the state lies on {home}, the step runs on {dev}")
            batch = batch_to(batch, home)
            kw = {} if redraw_arch is None else {"performer_step": _redraw_step(redraw_arch, state)}
            loss, aux, grads = value_and_grad(loss_fn, state.params, batch, state.rng, *extra,
                                              **kw)
            tx.step(state.params, grads, state.opt_state)
            metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
            return state._replace(step=state.step + 1), metrics

    return step


def make_bi_encoder_train_step(
    arch: EncoderArch,
    tx: AdamW,
    loss_type: str = "cosine_mse",   # softmax | cosine_mse | contrastive |
                                     # online_contrastive | mnrl | distill_mse
    pooling: str = "mean",
    precision: Precision = DEFAULT_PRECISION,
    margin: float = 0.5,
    remat=False,
    device="cuda",
    pp_mesh: Optional[Mesh] = None,         # pipeline parallelism: layer
    pp_microbatches: Optional[int] = None,  # stages over the pipe axis
) -> Callable:
    """Returns step(state, batch) → (state, metrics): the loss and its
    gradients (dropout on), then ``tx``'s in-place update. batch: ids_a,
    mask_a, ids_b, mask_b, target (labels, scores or teacher embeddings),
    valid (B,). With ``pp_mesh`` each tower runs pipeline-parallel over its
    pipe axis (composed with its data axis)."""

    def loss_fn(params, batch, generator, performer_step=None):
        return bi_encoder_loss(
            params, batch, arch=arch, loss_type=loss_type, pooling=pooling,
            precision=precision, margin=margin, generator=generator, deterministic=False,
            remat=remat, performer_step=performer_step, pp_mesh=pp_mesh,
            pp_microbatches=pp_microbatches,
        )

    return _make_step(loss_fn, tx, device, redraw_arch=arch)


def make_classifier_train_step(
    arch: EncoderArch,
    tx: AdamW,
    pooling: str = "cls",
    precision: Precision = DEFAULT_PRECISION,
    device="cuda",
    pp_mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
) -> Callable:
    """Cross-encoder / document-classifier step. batch: ids, mask,
    type_ids (optional), labels, valid. metrics: loss, accuracy.
    ``pp_mesh`` as for the bi-encoder step."""

    def loss_fn(params, batch, generator):
        logits, moe = classifier_forward(
            params, batch["ids"], batch["mask"], batch.get("type_ids"), arch=arch,
            precision=precision, pooling=pooling, generator=generator, deterministic=False,
            with_moe_aux=True, pp_mesh=pp_mesh, pp_microbatches=pp_microbatches,
        )
        valid = batch.get("valid")
        loss = L.cross_entropy_loss(logits, batch["labels"], valid)
        return _with_moe(arch, loss, {"accuracy": _masked_accuracy(logits, batch["labels"], valid)},
                         moe)

    return _make_step(loss_fn, tx, device)


# ---------------------------------------------------------------------------
# Packed steps: several short sequences a fixed-width row behind a
# block-diagonal mask (data.pairs.build_packed_pair_batches)
# ---------------------------------------------------------------------------

def _scatter_segments(emb: torch.Tensor, owners: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Per-segment outputs (R, M, D) → per-example slots (n_slots, D).
    ``owners`` (R, M) holds each segment's example index, −1 for an empty
    slot; empty slots add into an explicit trash row n_slots, which is cut
    off. Each example owns one segment, so the add is a set."""
    r, m, d = emb.shape
    own = owners.reshape(r * m).long()
    idx = torch.where(own >= 0, own, torch.full_like(own, n_slots))
    out = emb.new_zeros((n_slots + 1, d)).index_add(0, idx, emb.reshape(r * m, d))
    return out[:n_slots]


def _packed_embed(
    enc_params: dict, ids, segments, positions, owners, n_slots: int, *, arch: EncoderArch,
    precision: Precision, pooling: str, generator, deterministic: bool, remat=False,
):
    """The packed counterpart of ``_embed``: the encoder over packed rows
    (block-diagonal attention, per-segment positions), a per-segment pool
    (first token for ``cls``, else the mean), the projection head, then the
    owner scatter → ((n_slots, D), (2,) MoE stats)."""
    mask = (segments > 0).to(torch.int32)
    out = encoder_forward(
        enc_params, ids, mask, arch=arch, precision=precision, deterministic=deterministic,
        generator=generator, remat=remat, segment_ids=segments, position_ids=positions,
    )
    m = owners.shape[1]
    seg_pool = segment_first_pool if pooling == "cls" else segment_mean_pool
    pooled = _project(enc_params, seg_pool(out.last_hidden_state, segments, m))
    return _scatter_segments(pooled, owners, n_slots), _moe_stats_of(out)


def _check_packable(arch: EncoderArch) -> None:
    if arch.attention_type != "softmax":
        raise ValueError("packed training needs block-diagonal softmax attention")


def packed_bi_encoder_loss(
    params: dict, batch: dict, *, arch: EncoderArch, loss_type: str = "cosine_mse",
    pooling: str = "mean", precision: Precision = DEFAULT_PRECISION, margin: float = 0.5,
    generator: Optional[torch.Generator] = None, deterministic: bool = False, remat=False,
):
    """The bi-encoder objective on one packed batch (ids_a / segments_a /
    positions_a (R, W), owners_a (R, M), the same for b, target (P,), valid
    (P,)) → (loss, aux metrics). The owner scatter gives the pair loss the
    dense batch's (u, v, target, valid), so it equals ``bi_encoder_loss``
    on the same pairs."""
    n_slots = batch["target"].shape[0]
    kw = dict(arch=arch, precision=precision, pooling=pooling, generator=generator,
              deterministic=deterministic, remat=remat)
    enc = params["encoder"]
    u, moe_u = _packed_embed(enc, batch["ids_a"], batch["segments_a"], batch["positions_a"],
                             batch["owners_a"], n_slots, **kw)
    v, moe_v = _packed_embed(enc, batch["ids_b"], batch["segments_b"], batch["positions_b"],
                             batch["owners_b"], n_slots, **kw)
    loss, aux = _pair_objective(loss_type, params, u, v, batch.get("target"),
                                batch.get("valid"), margin)
    return _with_moe(arch, loss, aux, 0.5 * (moe_u + moe_v))


def make_packed_bi_encoder_train_step(
    arch: EncoderArch,
    tx: AdamW,
    loss_type: str = "cosine_mse",
    pooling: str = "mean",
    precision: Precision = DEFAULT_PRECISION,
    margin: float = 0.5,
    remat=False,
    device="cuda",
) -> Callable:
    """Packed twin-tower step over ``packed_bi_encoder_loss``; its
    gradients equal the dense step's on the same pairs."""
    _check_packable(arch)

    def loss_fn(params, batch, generator):
        return packed_bi_encoder_loss(
            params, batch, arch=arch, loss_type=loss_type, pooling=pooling,
            precision=precision, margin=margin, generator=generator, remat=remat,
        )

    return _make_step(loss_fn, tx, device)


def packed_classifier_forward(
    params: dict, ids, segments, positions, type_ids, owners, n_slots: int, *,
    arch: EncoderArch, precision: Precision = DEFAULT_PRECISION,
    generator: Optional[torch.Generator] = None, deterministic: bool = True, remat=False,
    with_moe_aux: bool = False,
):
    """Packed cross-encoder forward: several [CLS] a [SEP] b [SEP] pairs a
    row → (n_slots, C) f32 logits, each pair read at its own [CLS] through
    the tanh pooler where the arch has one (``classifier_forward`` with cls
    pooling); ``with_moe_aux=True`` → (logits, (2,) MoE stats)."""
    enc = params["encoder"]
    mask = (segments > 0).to(torch.int32)
    out = encoder_forward(
        enc, ids, mask, type_ids, arch=arch, precision=precision, deterministic=deterministic,
        generator=generator, remat=remat, segment_ids=segments, position_ids=positions,
    )
    pooled = segment_first_pool(out.last_hidden_state, segments, owners.shape[1])
    if arch.has_pooler and "pooler" in enc:
        pw = enc["pooler"]
        w = dequant_weight(_whole(pw["w"], pooled.device))
        pooled = torch.tanh(pooled.float() @ w.float() + _whole(pw["b"], pooled.device))
    logits = _scatter_segments(_head(params, pooled), owners, n_slots)
    return (logits, _moe_stats_of(out)) if with_moe_aux else logits


def make_packed_classifier_train_step(
    arch: EncoderArch,
    tx: AdamW,
    precision: Precision = DEFAULT_PRECISION,
    remat=False,
    device="cuda",
) -> Callable:
    """Packed cross-encoder / pair-classifier step. batch
    (``build_packed_pair_batches(mode="cross")``): ids / segments /
    positions / type_ids (R, W), owners (R, M), labels (P,), valid (P,)."""
    _check_packable(arch)

    def loss_fn(params, batch, generator):
        logits, moe = packed_classifier_forward(
            params, batch["ids"], batch["segments"], batch["positions"], batch.get("type_ids"),
            batch["owners"], batch["labels"].shape[0], arch=arch, precision=precision,
            generator=generator, deterministic=False, remat=remat, with_moe_aux=True,
        )
        valid = batch.get("valid")
        loss = L.cross_entropy_loss(logits, batch["labels"], valid)
        return _with_moe(arch, loss, {"accuracy": _masked_accuracy(logits, batch["labels"], valid)},
                         moe)

    return _make_step(loss_fn, tx, device)


# ---------------------------------------------------------------------------
# Token classification (NER)
# ---------------------------------------------------------------------------

def token_classifier_forward(
    params: dict, ids, mask, *, arch: EncoderArch, precision: Precision = DEFAULT_PRECISION,
    generator: Optional[torch.Generator] = None, deterministic: bool = True,
    with_moe_aux: bool = False, pp_mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
):
    """Encoder → per-token linear head → (B, S, T) f32 logits
    (``with_moe_aux=True``: with the (2,) MoE stats)."""
    out = _encoder_out(params["encoder"], ids, mask, arch=arch, precision=precision,
                       deterministic=deterministic, generator=generator, pp_mesh=pp_mesh,
                       pp_microbatches=pp_microbatches)
    head = params["head"]
    h = out.last_hidden_state
    logits = h.float() @ _whole(head["w"], h.device) + _whole(head["b"], h.device)
    return (logits, _moe_stats_of(out)) if with_moe_aux else logits


def make_token_classifier_train_step(
    arch: EncoderArch,
    tx: AdamW,
    precision: Precision = DEFAULT_PRECISION,
    device="cuda",
    pp_mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
) -> Callable:
    """batch: ids, mask, tags (B, S) with −100 where no tag is predicted
    (sub-word continuations, specials, padding); padding is ignored too.
    metrics: loss, accuracy over the tagged tokens."""

    def loss_fn(params, batch, generator):
        logits, moe = token_classifier_forward(params, batch["ids"], batch["mask"], arch=arch,
                                               precision=precision, generator=generator,
                                               deterministic=False, with_moe_aux=True,
                                               pp_mesh=pp_mesh, pp_microbatches=pp_microbatches)
        tags = batch["tags"].long()
        w = ((tags >= 0) & (batch["mask"] > 0)).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tags.clamp_min(0)[..., None])[..., 0]
        n = w.sum().clamp_min(1.0)
        acc = ((logits.argmax(dim=-1) == tags).float() * w).sum() / n
        return _with_moe(arch, (nll * w).sum() / n, {"accuracy": acc}, moe)

    return _make_step(loss_fn, tx, device)


# ---------------------------------------------------------------------------
# Masked-LM pretraining (the long-model re-pretraining objective)
# ---------------------------------------------------------------------------

def mlm_mask_batch(
    generator: torch.Generator,
    ids: torch.Tensor,            # (B, S) int
    mask: torch.Tensor,           # (B, S) 1 = real token
    vocab_size: int,
    mask_token_id: int,
    mask_prob: float = 0.15,
    special_ids=(0, 1, 2, 3, 4),  # token ids never masked
):
    """BERT-style dynamic masking, drawn from ``generator``: each real,
    non-special token is selected with probability ``mask_prob``; of the
    selected, 80% become ``mask_token_id``, 10% a token drawn uniformly
    from the vocabulary and 10% stay. → (corrupted ids, labels: the
    original id where selected, −100 elsewhere). ``special_ids`` must be
    the tokenizer's real special ids."""
    dev = ids.device
    specials = torch.tensor(sorted(special_ids), dtype=ids.dtype, device=dev)
    eligible = (mask > 0) & ~torch.isin(ids, specials)
    sel = (torch.rand(ids.shape, generator=generator, device=dev) < mask_prob) & eligible
    labels = torch.where(sel, ids, torch.full_like(ids, -100))
    op = torch.rand(ids.shape, generator=generator, device=dev)
    rand_tok = torch.randint(0, vocab_size, ids.shape, generator=generator, device=dev,
                             dtype=ids.dtype)
    corrupted = torch.where(sel & (op < 0.8), torch.full_like(ids, mask_token_id),
                            torch.where(sel & (op >= 0.9), rand_tok, ids))
    return corrupted, labels.to(torch.int32)


def _check_tied_head(arch: EncoderArch) -> None:
    if arch.embed_factor_size and arch.embed_factor_size != arch.hidden_size:
        raise ValueError(
            f"the MLM head is tied to the word table, which is {arch.embed_factor_size} wide "
            f"where the hidden states are {arch.hidden_size}: MLM needs embed_factor_size == "
            "hidden_size (the reference's einsum fails to trace here too)"
        )


def mlm_forward(
    params: dict, ids, mask, *, arch: EncoderArch, precision: Precision = DEFAULT_PRECISION,
    generator: Optional[torch.Generator] = None, deterministic: bool = True,
    performer_step: Optional[int] = None, with_moe_aux: bool = False,
    pp_mesh: Optional[Mesh] = None, pp_microbatches: Optional[int] = None,
):
    """Encoder → the output head tied to the word table (f32) → (B, S, V)
    logits, plus ``params["mlm_bias"]`` where present
    (``with_moe_aux=True``: with the (2,) MoE stats)."""
    _check_tied_head(arch)
    out = _encoder_out(params["encoder"], ids, mask, arch=arch, precision=precision,
                       deterministic=deterministic, generator=generator,
                       performer_step=performer_step, pp_mesh=pp_mesh,
                       pp_microbatches=pp_microbatches)
    h = out.last_hidden_state
    word = _whole(params["encoder"]["embeddings"]["word"], h.device)
    logits = h.float() @ word.float().T
    if "mlm_bias" in params:
        logits = logits + _whole(params["mlm_bias"], h.device)
    return (logits, _moe_stats_of(out)) if with_moe_aux else logits


def make_mlm_train_step(
    arch: EncoderArch,
    tx: AdamW,
    mask_token_id: int,
    precision: Precision = DEFAULT_PRECISION,
    mask_prob: float = 0.15,
    special_ids=(0, 1, 2, 3, 4),
    device="cuda",
    pp_mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
) -> Callable:
    """batch: ids, mask. The masking is drawn anew each step from the
    state's generator (then the dropout masks). metrics: loss,
    masked_tokens. ``pp_mesh`` as for the bi-encoder step."""
    _check_tied_head(arch)

    def loss_fn(params, batch, generator, performer_step=None):
        corrupted, labels = mlm_mask_batch(
            generator, batch["ids"], batch["mask"], arch.vocab_size, mask_token_id, mask_prob,
            special_ids=special_ids,
        )
        logits, moe = mlm_forward(params, corrupted, batch["mask"], arch=arch,
                                  precision=precision, generator=generator, deterministic=False,
                                  performer_step=performer_step, with_moe_aux=True,
                                  pp_mesh=pp_mesh, pp_microbatches=pp_microbatches)
        loss = L.mlm_loss(logits, labels)
        return _with_moe(arch, loss, {"masked_tokens": (labels >= 0).float().sum()}, moe)

    return _make_step(loss_fn, tx, device, redraw_arch=arch)


# ---------------------------------------------------------------------------
# Word-in-context (WiC): twin towers over the target words' spans
# ---------------------------------------------------------------------------

def make_word_encoder_train_step(
    arch: EncoderArch,
    tx: AdamW,
    precision: Precision = DEFAULT_PRECISION,
    margin: float = 0.5,
    loss_type: str = "contrastive",   # contrastive | online_contrastive
    device="cuda",
    pp_mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
) -> Callable:
    """batch: ids_a / mask_a / span_a, ids_b / mask_b / span_b, target
    (0/1), valid. Both sides run the shared encoder (dropout on) and pool
    the target word's sub-token span; the contrastive loss on the word
    vectors' cosine."""

    def word_vec(enc, ids, mask, span, generator):
        out = _encoder_out(enc, ids, mask, arch=arch, precision=precision, deterministic=False,
                           generator=generator, pp_mesh=pp_mesh, pp_microbatches=pp_microbatches)
        return word_span_pool(out.last_hidden_state, span), _moe_stats_of(out)

    def loss_fn(params, batch, generator):
        enc = params["encoder"]
        u, moe_u = word_vec(enc, batch["ids_a"], batch["mask_a"], batch["span_a"], generator)
        v, moe_v = word_vec(enc, batch["ids_b"], batch["mask_b"], batch["span_b"], generator)
        objective = (L.online_contrastive_loss if loss_type == "online_contrastive"
                     else L.contrastive_loss)
        loss, _ = objective(u, v, batch["target"], margin, batch.get("valid"))
        return _with_moe(arch, loss, {}, 0.5 * (moe_u + moe_v))

    return _make_step(loss_fn, tx, device)


# ---------------------------------------------------------------------------
# FastFormers distillation: teacher logits (KL) + layer-mapped hidden states
# (MSE) (+ hard-label CE) for classifiers
# ---------------------------------------------------------------------------

def make_fastformers_distill_step(
    student_arch: EncoderArch,
    teacher_arch: EncoderArch,
    tx: AdamW,
    pooling: str = "cls",
    precision: Precision = DEFAULT_PRECISION,
    temperature: float = 2.0,
    alpha_kl: float = 1.0,
    alpha_state: float = 1.0,
    alpha_ce: float = 0.0,
    layer_map=None,   # (Ls + 1,) teacher hidden index a student layer
    device="cuda",
) -> Callable:
    """Returns step(state, batch, teacher_params) → (state, metrics). The
    frozen teacher ({"encoder", "head"}) runs under ``torch.no_grad()``
    with no dropout, giving logits and hidden states; the student (dropout
    on) matches the logits through the temperature-scaled KL and the
    hidden states through the layer-mapped MSE. batch: ids, mask
    (type_ids, labels, valid). metrics: loss, kl, state_mse (ce, accuracy
    with ``alpha_ce > 0`` and labels)."""
    if student_arch.num_experts > 0 or teacher_arch.num_experts > 0:
        raise ValueError("MoE archs are not supported by the FastFormers distill step")

    def tower(params, arch_, batch, generator, deterministic):
        out = encoder_forward(
            params["encoder"], batch["ids"], batch["mask"], batch.get("type_ids"), arch=arch_,
            precision=precision, deterministic=deterministic, generator=generator,
            output_hidden_states=True,
        )
        if pooling == "cls":
            pooled = (out.pooler_output if out.pooler_output is not None
                      else cls_pool(out.last_hidden_state, batch["mask"]))
        else:
            pooled = mean_pool(out.last_hidden_state, batch["mask"])
        return _head(params, pooled), out.hidden_states

    def loss_fn(params, batch, generator, teacher_params):
        with torch.no_grad():
            t_logits, t_hidden = tower(teacher_params, teacher_arch, batch, None, True)
        s_logits, s_hidden = tower(params, student_arch, batch, generator, False)
        valid = batch.get("valid")
        kl = L.kl_distill_loss(s_logits, t_logits, temperature, valid)
        st = L.hidden_state_mse(s_hidden, t_hidden, batch["mask"], layer_map=layer_map)
        loss = alpha_kl * kl + alpha_state * st
        aux = {"kl": kl, "state_mse": st}
        if alpha_ce > 0 and "labels" in batch:
            ce = L.cross_entropy_loss(s_logits, batch["labels"], valid)
            loss = loss + alpha_ce * ce
            aux["ce"] = ce
            aux["accuracy"] = _masked_accuracy(s_logits, batch["labels"], valid)
        return loss, aux

    return _make_step(loss_fn, tx, device)
