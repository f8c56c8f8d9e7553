"""Context-parallel encoder forward: exact attention over sequences sharded
along the mesh ``seq`` axis (port of
``text_similarity_tpu.models.long_context``).

The embeddings are computed whole on the parameters' device (positions need
global offsets), then split along S into one piece a position of the seq
axis, each moved to its device. Each layer runs ``layer_qkv`` on every
piece, one context-parallel attention across the pieces —

- ``strategy="ring"``: key / value blocks rotate around the axis
  (``ops.ring_attention``);
- ``strategy="ulysses"``: sequence → heads all-to-all, attention per head
  slice, heads → sequence (``ops.ulysses``; the heads must divide over the
  axis) —

then ``layer_after_attention`` on every piece: the layer's math is the
encoder's own, once. The layers are replicated once for each distinct
device of the axis (several positions on one card share one copy). ALBERT
runs its one shared layer ``num_layers`` times. An MoE FFN routes each
piece's tokens with the capacity of that piece, as the reference's
``shard_map`` body does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import EncoderArch
from ..core.mesh import SEQ_AXIS, Mesh, replicate
from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.attention import multi_head_attention
from .encoder import _cast_tree, _unstack_tree, embed_inputs, layer_after_attention, layer_qkv


def encoder_forward_cp(
    params: dict,
    input_ids: torch.Tensor,        # (B, S), S divisible by the seq axis
    attention_mask: torch.Tensor,   # (B, S)
    *,
    arch: EncoderArch,
    mesh: Mesh,
    strategy: str = "ring",         # ring | ulysses
    precision: Precision = DEFAULT_PRECISION,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """→ the (B, S, H) last hidden state, gathered on the first device of
    the seq axis (pool it as usual). Exact full attention: refuses a
    Performer or windowed arch (its weights were trained for another
    attention), an S that does not divide over the axis, and an S past the
    position table."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown CP strategy {strategy!r}")
    if arch.attention_type == "performer" or arch.attention_window:
        raise ValueError(
            "context-parallel forward is exact full attention; "
            f"arch has attention_type={arch.attention_type!r} / window={arch.attention_window}"
        )
    devs = mesh.axis_devices(SEQ_AXIS)
    n_seq = len(devs)
    b, s = input_ids.shape
    if s % n_seq:
        raise ValueError(f"S={s} must divide over seq axis ({n_seq})")
    limit = arch.max_position - (arch.pad_token_id + 1 if arch.position_offset else 0)
    if s > limit:
        raise ValueError(
            f"S={s} exceeds the position table ({limit} usable positions) — CP extends "
            "attention memory, not max_position; re-tile positions first "
            "(models.hf_convert.extend_positions)"
        )
    x = embed_inputs(
        params["embeddings"], input_ids, attention_mask, token_type_ids,
        arch=arch, precision=precision, deterministic=True,
    )
    stacked = _cast_tree(params["layers"], precision.compute_dtype)
    n_stored = 1 if arch.share_layers else arch.num_layers
    layers = [_unstack_tree(tree, n_stored) for tree in replicate(mesh, stacked, SEQ_AXIS)]
    xs = [piece.to(d) for piece, d in zip(x.chunk(n_seq, dim=1), devs)]
    masks = [piece.to(d) for piece, d in zip(attention_mask.chunk(n_seq, dim=1), devs)]
    for li in range(arch.num_layers):
        lps = [stack[0 if arch.share_layers else li] for stack in layers]
        qkv = [layer_qkv(xi, lp, arch=arch) for xi, lp in zip(xs, lps)]
        ctx = multi_head_attention(
            [t[0] for t in qkv], [t[1] for t in qkv], [t[2] for t in qkv], mask=masks,
            impl=strategy, cp_group=devs,
        )
        xs = [layer_after_attention(xi, ci, lp, mi, arch=arch).to(xi.dtype)
              for xi, ci, lp, mi in zip(xs, ctx, lps, masks)]
    return torch.cat([xi.to(devs[0]) for xi in xs], dim=1)
