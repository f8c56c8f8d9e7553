"""BERT-of-Theseus compression (port of
``text_similarity_tpu.compress.theseus``): each successor "slot" replaces a
block of ``ratio`` predecessor layers, chosen by a Bernoulli gate drawn a
slot and a forward at the scheduler's replacing rate; the successors (and
the head) train, the predecessors and embeddings stay frozen.

The reference computes both paths of every slot and blends them by the
gate (a traced program cannot branch on a drawn value); eager torch runs
only the chosen path, which gives the same output (gate · succ + (1 −
gate) · pred with a 0/1 gate). A successor that was not chosen still gets
a gradient, of zeros: AdamW's moments and weight decay move it, as optax
moves it in the reference. Gates come from the step's ``torch.Generator``,
so they cannot match the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import EncoderArch, TrainConfig
from ..core.precision import DEFAULT_PRECISION, Precision, precision_for
from ..utils.logging import get_logger

logger = get_logger("theseus")


class ReplacementScheduler:
    """The replacing rate: constant, or the linear ramp base + k · step
    clipped to 1."""

    def __init__(self, base_rate: float = 0.3, k: float = 0.0):
        self.base_rate = base_rate
        self.k = k

    def rate(self, step: int) -> float:
        return float(min(1.0, self.base_rate + self.k * step))


def _n_stacked(tree: dict) -> int:
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def theseus_encoder_forward(
    pred_layers: dict,        # stacked (L, ...)
    succ_layers: dict,        # stacked (S, ...), L = S · ratio
    embeddings: dict,         # the shared embedding params
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    *,
    arch: EncoderArch,
    replace_rate: float,
    generator: torch.Generator,
    precision: Precision = DEFAULT_PRECISION,
    deterministic_layers: bool = True,
) -> torch.Tensor:
    """The mixed predecessor / successor stack → (B, S, H): embeddings
    (frozen), then per slot either its successor layer (gate 1, drawn with
    probability ``replace_rate``) or its block of predecessor layers
    (frozen)."""
    from ..models.encoder import _cast_tree, _unstack_tree, embed_inputs, transformer_layer

    if arch.num_experts > 0:
        raise ValueError("MoE archs are not supported by theseus compression (the mixed "
                         "stack would drop the load-balance aux loss)")
    n_pred, n_succ = _n_stacked(pred_layers), _n_stacked(succ_layers)
    if n_pred % n_succ:
        raise ValueError(f"{n_pred} predecessor layers not divisible by {n_succ} slots")
    ratio = n_pred // n_succ
    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, dtype=torch.int32, device=input_ids.device)
    with torch.no_grad():
        x = embed_inputs(embeddings, input_ids, attention_mask, None, arch=arch,
                         precision=precision, deterministic=True)
    dtype = precision.compute_dtype
    pred = _unstack_tree(_cast_tree(pred_layers, dtype), n_pred)
    succ = _unstack_tree(_cast_tree(succ_layers, dtype), n_succ)
    draws = torch.rand((n_succ,), generator=generator, device=generator.device)
    gates = (draws < replace_rate).tolist()
    for slot, gate in enumerate(gates):
        if gate:
            x = transformer_layer(x, succ[slot], attention_mask, arch=arch,
                                  deterministic=deterministic_layers, generator=generator)
        else:
            with torch.no_grad():
                for lp in pred[slot * ratio:(slot + 1) * ratio]:
                    x = transformer_layer(x, lp, attention_mask, arch=arch, deterministic=True)
    return x


def init_successors_from_predecessors(pred_layers: dict, num_slots: int) -> dict:
    """Slot i starts as a copy of the first layer of its predecessor
    block."""
    from .distill import extract_student_layers

    ratio = _n_stacked(pred_layers) // num_slots
    return extract_student_layers({"layers": pred_layers},
                                  range(0, num_slots * ratio, ratio))["layers"]


class TheseusDistiller:
    """Compress an encoder to ``num_slots`` layers by theseus replacement
    training on a pair-classification objective, on the teacher params'
    device."""

    def __init__(
        self,
        teacher_params: dict,          # the encoder's params (tensors)
        arch: EncoderArch,
        num_slots: int,
        scheduler: Optional[ReplacementScheduler] = None,
        train_config: TrainConfig = TrainConfig(lr=2e-5, epochs=1),
    ):
        self.teacher_params = teacher_params
        self.arch = arch
        self.num_slots = num_slots
        self.scheduler = scheduler or ReplacementScheduler(0.3, 5e-4)
        self.cfg = train_config
        self.succ = init_successors_from_predecessors(teacher_params["layers"], num_slots)
        self.device = teacher_params["embeddings"]["word"].device

    def make_train_step(self, tx, num_classes: int, pooling: str = "mean"):
        """The softmax-loss theseus step: the trainable params are
        {"succ", "head"}; call step(state, batch, rate, pred_layers,
        embeddings) with the frozen predecessor layers and embeddings.
        metrics: loss."""
        from ..models.losses import softmax_loss
        from ..models.pooling import cls_pool, mean_pool
        from ..train.steps import _make_step

        arch = self.arch
        precision = precision_for(self.cfg.bf16)

        def embed(succ, pred_layers, embeddings, ids, mask, rate, generator):
            h = theseus_encoder_forward(pred_layers, succ, embeddings, ids, mask, arch=arch,
                                        replace_rate=rate, generator=generator,
                                        precision=precision)
            return mean_pool(h, mask) if pooling == "mean" else cls_pool(h, mask)

        def loss_fn(params, batch, generator, rate, pred_layers, embeddings):
            u = embed(params["succ"], pred_layers, embeddings, batch["ids_a"], batch["mask_a"],
                      rate, generator)
            v = embed(params["succ"], pred_layers, embeddings, batch["ids_b"], batch["mask_b"],
                      rate, generator)
            head = params["head"]
            loss, _ = softmax_loss(u, v, head["w"], head["b"], batch["target"],
                                   batch.get("valid"))
            return loss, {}

        return _make_step(loss_fn, tx, self.device)

    def compressed_params(self, succ: Optional[dict] = None) -> dict:
        """The student: the successors in place of the layers, the
        embeddings (and pooler, projection) carried over."""
        out = dict(self.teacher_params)
        out["layers"] = succ if succ is not None else self.succ
        return out

    @property
    def compressed_arch(self) -> EncoderArch:
        return self.arch.replace(num_layers=self.num_slots)
