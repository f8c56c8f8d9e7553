"""Pipeline-parallel encoder forward: layer stages over the mesh ``pipe``
axis, GPipe microbatching (port of ``text_similarity_tpu.models.pipeline``).

Stage s of a data shard's pipe group holds the L/P contiguous layers
``[s·L/P, (s+1)·L/P)``, copied from the parameters' device to the stage's
(one copy a distinct (stage, device)). Each data shard's rows split into M
microbatches, and the ticks run the GPipe order: at tick t stage s applies
its layers to microbatch t − s. A stage's output moves to the next stage's
device (the reference's ``ppermute``); the last stage's returns to its data
shard's first device. Every data shard advances in the same tick loop, so
on several cards the shards' and the stages' work overlaps as the host
queues it; the reference's warm-up and drain ticks, which compute garbage
under its one XLA program, are simply not run. The backward runs the
reverse pipeline through autograd of the copies.

Embeddings are computed outside the pipeline, whole, on the parameters'
device; the pooler is left to the caller. Dropout keeps the reference's
structure: every (data shard, microbatch, layer) draws its own mask from
the step's generator (on the generator's device), so no two microbatches
share a pattern. ``remat`` recomputes each stage's layers in the backward
with the generator put back to the stage's entry (``remat_call``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import EncoderArch
from ..core.mesh import AXES, DATA_AXIS, PIPE_AXIS, Mesh
from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops import performer as _performer
from .encoder import _cast_tree, _unstack_tree, embed_inputs, remat_call, transformer_layer


def encoder_forward_pp(
    params: dict,
    input_ids: torch.Tensor,                        # (B, S)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S)
    *,
    arch: EncoderArch,
    mesh: Mesh,
    microbatches: Optional[int] = None,   # default: min(P, rows a data shard)
    precision: Precision = DEFAULT_PRECISION,
    token_type_ids: Optional[torch.Tensor] = None,
    attention_impl: str = "auto",
    remat=False,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    performer_step: Optional[int] = None,
) -> torch.Tensor:
    """→ the (B, S, H) last hidden state, equal to ``encoder_forward``'s, on
    ``input_ids``' device. Refuses what the reference refuses: an MoE
    arch, ALBERT's shared layers, ``num_layers`` not divisible by the pipe
    axis, B not divisible by the data axis, and a data shard's rows not
    divisible by ``microbatches``."""
    if arch.num_experts > 0:
        raise ValueError(
            "MoE archs are not supported in the pipelined stack (it would "
            "silently drop the load-balance aux loss); use DP/TP/EP"
        )
    n_pipe, n_data = mesh.shape[PIPE_AXIS], mesh.shape[DATA_AXIS]
    if arch.share_layers:
        raise ValueError(
            "pipeline parallelism over shared (ALBERT) layers is "
            "meaningless — every stage would hold the same parameters"
        )
    n_layers = arch.num_layers
    if n_layers % n_pipe:
        raise ValueError(f"num_layers={n_layers} must divide over pipe axis ({n_pipe})")
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
    if b % n_data:
        raise ValueError(f"B={b} must divide over data axis ({n_data})")
    b_loc = b // n_data
    m = microbatches if microbatches is not None else min(n_pipe, b_loc)
    if m < 1 or b_loc % m:
        raise ValueError(f"per-shard batch {b_loc} must divide into microbatches={m}")
    mb = b_loc // m

    def dev(d: int, st: int) -> torch.device:
        pos = [0] * len(AXES)
        pos[AXES.index(DATA_AXIS)], pos[AXES.index(PIPE_AXIS)] = d, st
        return mesh.devices[tuple(pos)]

    x = embed_inputs(params["embeddings"], input_ids, attention_mask, token_type_ids, arch=arch,
                     precision=precision, deterministic=deterministic, generator=generator)
    layers = _unstack_tree(_cast_tree(params["layers"], precision.compute_dtype), n_layers)
    l_per = n_layers // n_pipe
    copies = {}

    def stage_layers(st: int, device: torch.device) -> list:
        if (st, device) not in copies:
            copies[st, device] = [{k: _to_tree(v, device) for k, v in lp.items()}
                                  for lp in layers[st * l_per:(st + 1) * l_per]]
        return copies[st, device]

    proj = {}
    if arch.attention_type == "performer":
        attention_impl = "performer"

    def performer_proj(device):
        if arch.attention_type != "performer":
            return None
        if device not in proj:
            proj[device] = _performer.projection(arch, performer_step, device)
        return proj[device]

    def run_stage(h, mask_mb, st, device):
        def body(h_):
            for lp in stage_layers(st, device):
                h_ = transformer_layer(
                    h_, lp, mask_mb, arch=arch, attention_impl=attention_impl,
                    deterministic=deterministic, generator=generator,
                    performer_proj=performer_proj(device),
                ).to(h_.dtype)
            return h_

        if remat and torch.is_grad_enabled():
            return remat_call(body, (h,), remat, generator=generator, deterministic=deterministic)
        return body(h)

    # microbatch i of data shard d: rows d·b_loc + i·mb …
    xs = [[x[d * b_loc + i * mb:d * b_loc + (i + 1) * mb] for i in range(m)] for d in range(n_data)]
    masks = [[attention_mask[d * b_loc + i * mb:d * b_loc + (i + 1) * mb] for i in range(m)]
             for d in range(n_data)]
    if remat and torch.is_grad_enabled():
        for d in range(n_data):           # the copies are made outside the recomputed region
            for st in range(n_pipe):
                stage_layers(st, dev(d, st))
    out = [[None] * m for _ in range(n_data)]
    handoff = {}                          # (d, stage) → the microbatch it passes on
    for t in range(m + n_pipe - 1):
        for d in range(n_data):
            for st in reversed(range(n_pipe)):   # stage s reads what s − 1 passed last tick
                i = t - st
                if not 0 <= i < m:
                    continue
                device = dev(d, st)
                h = xs[d][i].to(device) if st == 0 else handoff.pop((d, st - 1))
                h = run_stage(h, masks[d][i].to(device), st, device)
                if st == n_pipe - 1:
                    out[d][i] = h.to(dev(d, 0))
                else:
                    handoff[d, st] = h.to(dev(d, st + 1))
    return torch.cat([piece.to(input_ids.device) for row in out for piece in row])


def _to_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tree(v, device) for k, v in tree.items()}
    return tree.to(device)
