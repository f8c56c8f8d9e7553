"""The encoder forward over a sharded parameter tree: data, tensor (Megatron),
fully sharded (FSDP) and expert parallelism on the one-controller mesh.

The JAX package gets all four from GSPMD: its train state is one pytree
placed by ``param_pspecs`` / ``fsdp_param_pspecs`` and the unsharded
``encoder_forward`` runs over it. Here ``encoder_forward`` hands a tree of
``core.mesh.ShardedLeaf`` to :func:`encoder_forward_sharded`, which runs the
same layers over the mesh's positions:

- **data**: the batch rows split over the data positions
  (``torch.tensor_split``); each position embeds and runs its rows.
- **model** (tensor parallelism): position m of a data position's model
  group takes its column slice of Q, K, V and MLP-in (``H / tp`` heads, the
  same ``multi_head_attention`` dispatch: on the card, K5 forward and K6
  backward at S ≥ 4096) and its row slice of O and MLP-out; the partial
  products are summed on the data position's first device and the
  replicated bias is added once after the sum.
- **FSDP** (a leaf split over ``data``): gathered whole on the device that
  uses it, by differentiable copies; the gradient returns split.
- **expert**: every MoE layer routes the whole batch on the first device
  (the capacity counts T = B·S of the global batch and slots go in the
  unsharded order), splits the (E, C, H) dispatch buffer over the expert
  positions, runs each position's experts (with the model split inside
  each expert) and combines there, then returns each data position's rows.

The residual tensors (embeddings, the post-O and post-MLP deltas) exist once
a data position, on its first device, so each dropout mask is drawn once
there from the step's generator (in the order embed, then each layer's
positions) and never per model position. Every copy between devices is a
``Tensor.to``, so autograd sums the gradients of a leaf's copies back into
its pieces: the psum of a replicated leaf, the reduce-scatter of an FSDP
piece. Leaves move in f32 (one copy a distinct (device, slice), shared by
the positions on that device) and are cast to the compute dtype once a data
position, so the gradients of positions that share a device sum in f32.

The last hidden state comes back whole on the mesh's first device, where
the caller's objective runs once over the global batch (an in-batch
negatives loss then spans every data position). Head masks and
``output_hidden_states`` need a whole tree (``core.mesh.unshard``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.config import EncoderArch
from ..core.mesh import (
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, AXES, ShardedLeaf, gather_leaf, mesh_of,
)
from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops import performer as _performer
from ..ops.moe import expert_partial, moe_combine, moe_route
from .encoder import (
    EncoderOutput, _act, _unstack_tree, embed_inputs, layer_attention, mlp_hidden, param_pspecs,
    remat_call, residual_norm,
)
from .pooling import bert_pooler

_SPLIT_AXES = (MODEL_AXIS, EXPERT_AXIS)


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _check_layout(layers: dict, arch: EncoderArch) -> None:
    """The model and expert axes must carry ``param_pspecs``' layout: the
    forward sums row-parallel partial products and splits the dispatch
    buffer by it."""
    want = param_pspecs(arch)["layers"]

    def walk(tree, specs, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, specs[key], path + key + "/")
                continue
            spec = tuple(specs[key]) + (None,) * (val.ndim - len(specs[key]))
            got = tuple(a if a in _SPLIT_AXES else None for a in val.spec)
            if got != tuple(a if a in _SPLIT_AXES else None for a in spec):
                raise ValueError(
                    f"layers/{path}{key} is placed {val.spec!r}: over the model and expert "
                    f"axes a layer leaf takes param_pspecs' layout {specs[key]!r}"
                )

    walk(layers, want, "")


class _Views:
    """Each leaf on a device with the slices a position keeps, gathered in
    f32 once a distinct (tree, device, kept slice), then cast to the compute
    dtype once a data position: the positions that share a device share
    the f32 copy, so their gradients sum in f32 there."""

    def __init__(self, n_stored: int, dtype: torch.dtype):
        self.n_stored, self.dtype = n_stored, dtype
        self._cache: Dict[tuple, object] = {}

    def tree(self, tree: dict, dev, keep: Optional[dict] = None) -> dict:
        keep = keep or {}
        key = (id(tree), dev, tuple(sorted(keep.items())))
        if key not in self._cache:
            self._cache[key] = _map(tree, lambda leaf: gather_leaf(leaf, dev, keep))
        return self._cache[key]

    def layer(self, layers: dict, dev, li: int, m: int = 0, e: int = 0, owner=0) -> dict:
        """Layer ``li`` (ALBERT: the one shared layer) as position (m, e) of
        data position ``owner`` holds it on ``dev``, in the compute dtype."""
        key = ("layer", id(layers), dev, m, e, owner)
        if key not in self._cache:
            whole = self.tree(layers, dev, {MODEL_AXIS: m, EXPERT_AXIS: e})
            cast = _map(whole, lambda t: t.to(self.dtype) if t.is_floating_point() else t)
            self._cache[key] = _unstack_tree(cast, self.n_stored)
        return self._cache[key][0 if self.n_stored == 1 else li]


def _row_sum(parts: List[torch.Tensor], bias: torch.Tensor) -> torch.Tensor:
    """Σ partial products, then the replicated bias once."""
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y + bias


def encoder_forward_sharded(
    params: dict,
    input_ids: torch.Tensor,                       # (B, S)
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    arch: EncoderArch,
    precision: Precision = DEFAULT_PRECISION,
    attention_impl: str = "auto",
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    remat=False,
    head_mask: Optional[torch.Tensor] = None,
    output_hidden_states: bool = False,
    performer_step: Optional[int] = None,
    performer_proj: Optional[torch.Tensor] = None,
) -> EncoderOutput:
    """``encoder_forward`` over a tree of ``ShardedLeaf`` (see the module
    note) → an ``EncoderOutput`` whose last hidden state, pooler output and
    MoE statistics lie on the mesh's first device."""
    if head_mask is not None or output_hidden_states:
        raise ValueError("head_mask and output_hidden_states need a whole parameter tree "
                         "(core.mesh.unshard)")
    mesh = mesh_of(params)
    for leaf in _leaves(params):
        if not isinstance(leaf, ShardedLeaf) or leaf.mesh is not mesh:
            raise ValueError("a sharded parameter tree places every leaf on one mesh")
    n_data, n_model, n_expert = (mesh.shape[a] for a in (DATA_AXIS, MODEL_AXIS, EXPERT_AXIS))
    moe = arch.num_experts > 0
    if n_model > 1 or n_expert > 1:
        _check_layout(params["layers"], arch)
    if arch.num_heads % n_model:
        raise ValueError(f"{arch.num_heads} heads do not split over the model axis ({n_model})")

    def dev(d=0, m=0, e=0) -> torch.device:
        pos = [0] * len(AXES)
        pos[AXES.index(DATA_AXIS)], pos[AXES.index(MODEL_AXIS)] = d, m
        pos[AXES.index(EXPERT_AXIS)] = e
        return mesh.devices[tuple(pos)]

    home = dev()
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
    # the rows of each data position that has any, on its first device
    inputs = {"ids": input_ids, "mask": attention_mask, "type": token_type_ids,
              "seg": segment_ids, "pos": position_ids}
    rows = []
    for d in range(n_data):
        part = {k: None if v is None else v.tensor_split(n_data)[d].to(dev(d))
                for k, v in inputs.items()}
        if part["ids"].shape[0]:
            rows.append((d, part))

    views = _Views(1 if arch.share_layers else arch.num_layers, precision.compute_dtype)
    layers = params["layers"]
    if arch.attention_type == "performer":
        attention_impl = "performer"
        if performer_proj is None:
            performer_proj = _performer.projection(arch, performer_step, home)
    nh_loc = arch.num_heads // n_model
    local_arch = [arch if n_model == 1 else arch.replace(
        num_heads=nh_loc, head_dim_override=arch.head_dim,
        performer_local_heads=min(max(arch.performer_local_heads - m * nh_loc, 0), nh_loc),
    ) for m in range(n_model)]
    act = _act(arch.hidden_act)
    drop_kw = dict(arch=arch, deterministic=deterministic, generator=generator)

    def attention_half(x, d, part, li):
        """O(attention(x)) summed over the model group, + residual, LN."""
        b_d = x.shape[0]
        partial = []
        for m in range(n_model):
            dm = dev(d, m)
            lp = views.layer(layers, dm, li, m=m, owner=d)
            ctx = layer_attention(
                x.to(dm), lp, part["mask"].to(dm), arch=local_arch[m],
                attention_impl=attention_impl,
                segment_ids=None if part["seg"] is None else part["seg"].to(dm),
                performer_proj=None if performer_proj is None else performer_proj.to(dm),
            )
            partial.append(torch.matmul(ctx.reshape(b_d, s, -1), lp["attn"]["o"]["w"]).to(dev(d)))
        lp0 = views.layer(layers, dev(d), li, owner=d)
        return residual_norm(x, _row_sum(partial, lp0["attn"]["o"]["b"]), lp0["attn_ln"],
                             **drop_kw)

    def dense_ffn(hx1, d, li):
        partial = []
        for m in range(n_model):
            dm = dev(d, m)
            mlp = views.layer(layers, dm, li, m=m, owner=d)["mlp"]
            partial.append(torch.matmul(mlp_hidden(hx1.to(dm), mlp, arch=arch),
                                        mlp["out"]["w"]).to(dev(d)))
        return _row_sum(partial, views.layer(layers, dev(d), li, owner=d)["mlp"]["out"]["b"])

    def moe_ffn_global(hx1s, li):
        """Route the whole batch once, the experts over the expert axis."""
        x = torch.cat([h.to(home) for h in hx1s])
        mask = torch.cat([part["mask"].to(home) for _, part in rows])
        route = moe_route(x, mask, views.layer(layers, home, li, owner="moe")["mlp"]["router"]["w"],
                          top_k=arch.expert_top_k, capacity_factor=arch.expert_capacity_factor)
        e_loc = arch.num_experts // n_expert
        ye = []
        for e in range(n_expert):
            xe = route.xe[e * e_loc:(e + 1) * e_loc]
            partial = []
            for m in range(n_model):
                dme = dev(0, m, e)
                mlp = views.layer(layers, dme, li, m=m, e=e, owner="moe")["mlp"]
                partial.append(expert_partial(xe.to(dme), mlp["in"]["w"], mlp["in"]["b"],
                                              mlp["out"]["w"], act).to(dev(0, 0, e)))
            bo = views.layer(layers, dev(0, 0, e), li, e=e, owner="moe")["mlp"]["out"]["b"]
            ye.append(_row_sum(partial, bo[:, None].float()).to(xe.dtype).to(home))
        y = moe_combine(route, torch.cat(ye), x)
        return y.split([h.shape[0] for h in hx1s]), route.aux, route.dropped

    def layer(li, *xs):
        hx1s = [attention_half(x, d, part, li) for x, (d, part) in zip(xs, rows)]
        if moe:
            ffs, aux, drop = moe_ffn_global(hx1s, li)
            ffs = [f.to(h.device) for f, h in zip(ffs, hx1s)]
        else:
            ffs = [dense_ffn(h, d, li) for h, (d, _) in zip(hx1s, rows)]
            aux = drop = torch.zeros((), dtype=torch.float32, device=home)
        outs = [residual_norm(h, f, views.layer(layers, dev(d), li, owner=d)["mlp_ln"], **drop_kw)
                for h, f, (d, _) in zip(hx1s, ffs, rows)]
        return (*outs, aux, drop)

    xs = [embed_inputs(views.tree(params["embeddings"], dev(d)), part["ids"], part["mask"],
                       part["type"], arch=arch, precision=precision, deterministic=deterministic,
                       generator=generator, position_ids=part["pos"])
          for d, part in rows]
    sums = torch.zeros((2,), dtype=torch.float32, device=home)
    if remat and torch.is_grad_enabled():
        # the copies are made once, outside the recomputed region
        for d, _ in rows:
            for m in range(n_model):
                views.layer(layers, dev(d, m), 0, m=m, owner=d)
        for e in range(n_expert if moe else 0):
            for m in range(n_model):
                views.layer(layers, dev(0, m, e), 0, m=m, e=e, owner="moe")
    for li in range(arch.num_layers):
        if remat and torch.is_grad_enabled():
            out = remat_call(lambda *a, li=li: layer(li, *a), tuple(xs), remat,
                             generator=generator, deterministic=deterministic)
        else:
            out = layer(li, *xs)
        xs = list(out[:-2])
        sums = sums + torch.stack(list(out[-2:]))
    hidden = torch.cat([x.to(home) for x in xs])
    pooler_out = None
    if arch.has_pooler and "pooler" in params:
        pw = views.tree(params["pooler"], home)
        pooler_out = bert_pooler(hidden, pw["w"], pw["b"])
    moe_aux = moe_drop = None
    if moe:
        moe_aux, moe_drop = sums[0] / arch.num_layers, sums[1] / arch.num_layers
    return EncoderOutput(hidden, pooler_out, None, moe_aux, moe_drop)


def _leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out
