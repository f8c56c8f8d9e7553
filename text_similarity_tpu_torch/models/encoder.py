"""BERT-class transformer encoder, port of
``text_similarity_tpu.models.encoder``.

Parameters keep the JAX package's tree layout — a nested dict with the L
layers stacked on a leading axis — so a JAX parameter tree (as numpy)
carries across with :func:`params_from_jax` and checkpoints are shared.
:class:`Encoder` holds the tree as an ``nn.Module``; the forward is plain
tensor code: embeddings + LN, then L post-LN blocks (fused head-interleaved
QKV, attention, FFN), then the optional tanh pooler.

Attention goes through ``ops.attention.multi_head_attention`` with the
arch's ``attention_window`` / ``window_global_cls`` (Longformer-style band
with a global CLS) and ``attention_impl="auto"``: on the card every layer
at S ≥ 4096 (S % 128 == 0) runs the flash kernel K5, every shorter bucket
the reference; on the CPU ``auto`` runs the reference, as the JAX package
does there. ``attention_impl="packed"`` runs the head-packed kernel K7 in
every layer (no window). RoBERTa-family archs (``position_offset``) number
real tokens from ``pad_token_id + 1`` and give padding the pad row.

Packed rows (``data.packing``): ``segment_ids`` give the block-diagonal
attention mask (the reference path) and ``position_ids`` the positions
restarting at 0 in each segment (shifted by ``pad_token_id + 1`` for
RoBERTa, padding on the pad row).

Precision follows the reference: embeddings and LayerNorms in f32, layer
matmuls in the compute dtype with f32 accumulation, softmax in f32. The
parameters stay f32 (master weights) and are cast to the compute dtype in
the forward, so gradients arrive in f32.

Training: ``encoder_forward(..., deterministic=False, generator=g)`` applies
the reference's inverted dropout (``arch.hidden_dropout``) at its three
places: after the embedding LayerNorm, on the attention output projection
and on the FFN output, each mask drawn from the ``torch.Generator`` ``g`` in
forward order (the JAX package folds its key per layer and site instead, so
the masks differ; dropout never touches the attention probabilities, so
flash stays exact). A tree of leaf tensors that require grad (the train
state's) differentiates through every op, K5 / K6 included.

int8 weights (``compress.quantize.quantize_params_int8``): a kernel or an
embedding table may be a ``{"q": int8, "s": f32 scale}`` leaf. Dense layers
with such kernels quantize their input per token and run an exact
int8×int8→int32 product (``_int8_dense``, the fused QKV), embedding tables
dequantize the gathered rows, the pooler dequantizes its kernel.

ALBERT (``share_layers``, ``embed_factor_size``): the stack holds one
layer's parameters on its leading axis and the forward runs that layer
``num_layers`` times, so its gradient is the sum over the iterations; the
embedding tables and their LayerNorm are E wide and ``embeddings.proj``
maps E → H after the embedding dropout (kept even where E == H, as HF
does). An int8 tree quantizes ``proj.w`` (a leaf named ``w``); the embed
path dequantizes it.

``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``); ``remat="dots"`` keeps the layer's matmul
outputs and recomputes the rest. The recompute restores the dropout
generator to its state at the layer's entry, so it draws the masks the
forward drew.

Head masks and hidden states (compression, word models): ``head_mask``
(L, nh) scales each layer's attention probabilities per head (the
reference's XLA path scales each head's output, the same product), so its
gradient is the heads' importance; a masked call takes the reference
attention. ``output_hidden_states`` returns the (L + 1, B, S, H) stack, the
embedding output first. A pruned arch (``head_dim_override``) keeps its
head width: q, k, v are (H, nh·hd) and o (nh·hd, H).

MoE (``arch.num_experts > 0``): the stack holds a router (L, H, E) and the
experts (L, E, H, I) / (L, E, I, H) with (L, E, ·) biases, and each layer's
FFN is ``ops.moe.moe_ffn``; ``encoder_forward`` returns the load-balance
loss and the dropped fraction, each the mean over the L layers, as
``moe_aux`` / ``moe_drop``. An int8 tree quantizes the experts and keeps
the router in f32.

Performer (``attention_type="performer"``): every layer runs
``impl="performer"`` (FAVOR+, ``ops.performer``; never K5 or K7) with the
projection ``ops.performer.projection`` draws (seeded 42, or the epoch of
``performer_step`` when the arch redraws), or an explicit
``performer_proj``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..compress.quantize import _is_q, _jit_scale, _quantize, int8_mm
from ..core.config import EncoderArch
from ..core.mesh import PartitionSpec as P
from ..core.mesh import mesh_of
from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops import performer as _performer
from ..ops.attention import multi_head_attention
from ..ops.moe import moe_ffn
from ..utils.profiling import span
from .pooling import bert_pooler


class EncoderOutput(NamedTuple):
    last_hidden_state: torch.Tensor         # (B, S, H)
    pooler_output: Optional[torch.Tensor]   # (B, H) tanh(W·cls) or None
    hidden_states: Optional[torch.Tensor] = None  # (L + 1, B, S, H), embeddings first
    moe_aux: Optional[torch.Tensor] = None        # MoE: load-balance loss, mean over layers
    moe_drop: Optional[torch.Tensor] = None       # MoE: dropped fraction, mean over layers


def _param_shapes(arch: EncoderArch) -> dict:
    h, i = arch.hidden_size, arch.intermediate_size
    a = arch.num_heads * arch.head_dim   # < h after head pruning
    # ALBERT: one layer on the stack axis, tables at E projected to H
    l = 1 if arch.share_layers else arch.num_layers
    e = arch.embed_factor_size or h
    dense = lambda fi, fo: {"w": (l, fi, fo), "b": (l, fo)}  # noqa: E731
    ln = lambda *s: {"scale": s, "bias": s}  # noqa: E731
    shapes = {
        "embeddings": {
            "word": (arch.vocab_size, e),
            "position": (arch.max_position, e),
            "ln": ln(e),
        },
        "layers": {
            "attn": {**{n: dense(h, a) for n in ("q", "k", "v")}, "o": dense(a, h)},
            "attn_ln": ln(l, h),
            "mlp": {"in": dense(h, i), "out": dense(i, h)},
            "mlp_ln": ln(l, h),
        },
    }
    if arch.num_experts > 0:
        ne = arch.num_experts
        shapes["layers"]["mlp"] = {
            "router": {"w": (l, h, ne)},
            "in": {"w": (l, ne, h, i), "b": (l, ne, i)},
            "out": {"w": (l, ne, i, h), "b": (l, ne, h)},
        }
    if arch.has_token_type:
        shapes["embeddings"]["token_type"] = (arch.type_vocab_size, e)
    if arch.embed_factor_size:
        shapes["embeddings"]["proj"] = {"w": (e, h), "b": (h,)}
    if arch.has_pooler:
        shapes["pooler"] = {"w": (h, h), "b": (h,)}
    if arch.projection_dim:
        shapes["projection"] = {
            "w": (h, arch.projection_dim), "b": (arch.projection_dim,),
        }
    return shapes


def init_params(
    arch: EncoderArch,
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> dict:
    """Random-init params (normal, std 0.02; LN scale 1, biases 0) drawn
    from ``generator`` in a fixed tree order. The numbers differ from the
    JAX package's ``init_params`` (another RNG); carry JAX weights across
    with :func:`params_from_jax` instead."""

    def make(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = make(val)
            elif key == "scale":
                out[key] = torch.ones(val, device=device)
            elif key in ("b", "bias"):
                out[key] = torch.zeros(val, device=device)
            else:
                out[key] = (
                    torch.randn(val, generator=generator, device=device) * 0.02
                )
        return out

    return make(_param_shapes(arch))


# ---------------------------------------------------------------------------
# Placement specs (core.mesh.PartitionSpec trees, the JAX package's layouts)
# ---------------------------------------------------------------------------

def param_pspecs(arch: EncoderArch, model_axis: str = "model", expert_axis: str = "expert") -> dict:
    """Megatron tensor parallelism: Q, K, V and MLP-in split their output
    columns over ``model_axis``, O and MLP-out their input rows (the partial
    products are summed, then the replicated bias is added once). An MoE
    arch splits its experts over ``expert_axis`` and keeps the column / row
    split inside each expert. Everything else is replicated."""
    m = model_axis
    col = {"w": P(None, None, m), "b": P(None, m)}
    row = {"w": P(None, m, None), "b": P(None, None)}
    ln2 = {"scale": P(None, None), "bias": P(None, None)}
    specs = {
        "embeddings": {
            "word": P(None, None),
            "position": P(None, None),
            "ln": {"scale": P(None), "bias": P(None)},
        },
        "layers": {
            "attn": {"q": dict(col), "k": dict(col), "v": dict(col), "o": dict(row)},
            "attn_ln": dict(ln2),
            "mlp": {"in": dict(col), "out": dict(row)},
            "mlp_ln": dict(ln2),
        },
    }
    if arch.num_experts > 0:
        ex = expert_axis
        specs["layers"]["mlp"] = {
            "router": {"w": P(None, None, None)},
            "in": {"w": P(None, ex, None, m), "b": P(None, ex, m)},
            "out": {"w": P(None, ex, m, None), "b": P(None, ex, None)},
        }
    if arch.has_token_type:
        specs["embeddings"]["token_type"] = P(None, None)
    if arch.embed_factor_size:
        specs["embeddings"]["proj"] = {"w": P(None, None), "b": P(None)}
    if arch.has_pooler:
        specs["pooler"] = {"w": P(None, None), "b": P(None)}
    if arch.projection_dim:
        specs["projection"] = {"w": P(None, None), "b": P(None)}
    return specs


def fsdp_param_pspecs(arch: EncoderArch, data_axis: str = "data") -> dict:
    """ZeRO-3 / FSDP: every stacked layer kernel splits its widest feature
    dim over the data axis (the word table its vocabulary rows, the pooler
    and projection their output columns); each is gathered where it is used
    and its gradient comes back split. Like the reference, the tree has no
    entry for ALBERT's ``embeddings.proj``, so placing an ALBERT tree by it
    raises."""
    d = data_axis
    col = {"w": P(None, None, d), "b": P(None, d)}
    row = {"w": P(None, d, None), "b": P(None, None)}
    ln2 = {"scale": P(None, None), "bias": P(None, None)}
    specs = {
        "embeddings": {
            "word": P(d, None),
            "position": P(None, None),
            "ln": {"scale": P(None), "bias": P(None)},
        },
        "layers": {
            "attn": {"q": dict(col), "k": dict(col), "v": dict(col), "o": dict(row)},
            "attn_ln": dict(ln2),
            "mlp": {"in": dict(col), "out": dict(row)},
            "mlp_ln": dict(ln2),
        },
    }
    if arch.num_experts > 0:
        specs["layers"]["mlp"] = {
            "router": {"w": P(None, None, None)},
            "in": {"w": P(None, None, None, d), "b": P(None, None, d)},
            "out": {"w": P(None, None, d, None), "b": P(None, None, None)},
        }
    if arch.has_token_type:
        specs["embeddings"]["token_type"] = P(None, None)
    if arch.has_pooler:
        specs["pooler"] = {"w": P(None, d), "b": P(d)}
    if arch.projection_dim:
        specs["projection"] = {"w": P(None, d), "b": P(d)}
    return specs


def _leaf_from_jax(arr, shp, name: str, kind: str, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind != kind:
        raise TypeError(f"{name}: expected a {kind!r} array, got {arr.dtype}")
    if tuple(arr.shape) != tuple(shp):
        raise ValueError(f"{name}: shape {arr.shape} != expected {shp}")
    if kind == "i":
        return torch.from_numpy(arr.astype(np.int8)).to(device)
    return torch.from_numpy(arr.astype(np.float32)).to(device)


def _tree_from_jax(shapes: dict, sub: dict, path: str, device) -> dict:
    """``sub`` (numpy leaves) → tensors, leaf by leaf against ``shapes``."""
    out = {}
    for key, shp in shapes.items():
        if key not in sub:
            raise KeyError(f"parameter tree is missing {path + key!r}")
        if isinstance(shp, dict):
            out[key] = _tree_from_jax(shp, sub[key], path + key + "/", device)
        elif isinstance(sub[key], dict):
            if set(sub[key]) != {"q", "s"}:
                raise KeyError(f"{path + key}: a quantized leaf holds q and s")
            s_shp = tuple(shp[:-2]) + (1, shp[-1])
            out[key] = {
                "q": _leaf_from_jax(sub[key]["q"], shp, path + key + "/q", "i", device),
                "s": _leaf_from_jax(sub[key]["s"], s_shp, path + key + "/s", "f", device),
            }
        else:
            out[key] = _leaf_from_jax(sub[key], shp, path + key, "f", device)
    return out


def params_from_jax(tree: dict, arch: EncoderArch, device="cpu") -> dict:
    """A JAX-layout parameter tree of numpy arrays (e.g. from
    ``restore_checkpoint_raw`` or ``jax.device_get(params)``) → the same
    tree of f32 tensors on ``device``, checked leaf by leaf against the
    shapes ``arch`` implies. A quantized leaf ``{"q": int8, "s": scale}``
    (``quantize_params_int8``) carries across as int8 codes and f32 scales
    whose contraction axis (-2) is 1."""
    return _tree_from_jax(_param_shapes(arch), tree, "", device)


def cross_params_from_jax(tree: dict, arch: EncoderArch, num_classes: int, device="cpu") -> dict:
    """A cross-encoder's JAX-layout tree ``{"encoder", "head"}`` → tensors,
    as :func:`params_from_jax`; the head is ``w`` (hidden, num_classes) and
    ``b`` (num_classes,), its ``w`` quantized or not."""
    head = {"w": (arch.hidden_size, num_classes), "b": (num_classes,)}
    return {
        "encoder": params_from_jax(tree["encoder"], arch, device),
        "head": _tree_from_jax(head, tree["head"], "head/", device),
    }


class _ParamTree(nn.Module):
    """A nested dict of tensors held as (frozen) module parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False)
                )

    def tree(self) -> dict:
        out = {}
        for key in self._keys:
            val = getattr(self, key)
            out[key] = val.tree() if isinstance(val, _ParamTree) else val
        return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name == "mish":
        return lambda x: x * torch.tanh(F.softplus(x))
    if name == "swish":
        return F.silu
    if name == "penalized_tanh":
        return lambda x: torch.where(x > 0, torch.tanh(x), 0.25 * torch.tanh(x))
    raise ValueError(f"unknown activation {name}")


def dequant_weight(w):
    """Weight-only dequant of one ``{"q", "s"}`` leaf (f32); a dense
    kernel passes through."""
    if _is_q(w):
        return w["q"].float() * w["s"]
    return w


def _dyn_quant_tokens(x: torch.Tensor):
    """Per-token (last-axis) symmetric int8 → (int8 codes, (…, 1) f32
    scale)."""
    x32 = x.float()
    s = _jit_scale(torch.amax(torch.abs(x32), dim=-1, keepdim=True))
    return _quantize(x32, s), s


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(…, K) int8 @ (K, N) int8 → (…, N) as f32 (exact int32 sums)."""
    out = int8_mm(xq.reshape(-1, xq.shape[-1]), wq)
    return out.reshape(*xq.shape[:-1], wq.shape[-1]).float()


def _int8_dense(x: torch.Tensor, wb: dict) -> torch.Tensor:
    """y = (int8(x) @ w_q) · x_scale · w_scale, cast to x's dtype, + b —
    the reference's order (the scales may be bf16-rounded by the compute
    dtype cast, as there)."""
    xq, xs = _dyn_quant_tokens(x)
    y = _int8_matmul(xq, wb["w"]["q"]) * xs * wb["w"]["s"].reshape(-1).float()
    return y.to(x.dtype) + wb["b"]


def _dense(x: torch.Tensor, wb: dict) -> torch.Tensor:
    # matmul accumulates in f32 and rounds to x's dtype; the bias adds after
    # the rounding, as the reference's einsum(...).astype(x.dtype) + b
    if _is_q(wb["w"]):
        return _int8_dense(x, wb)
    return torch.matmul(x, wb["w"]) + wb["b"]


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], deterministic: bool
) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 − rate (a
    uniform draw from ``generator`` below 1 − rate, drawn on the generator's
    device) and scale it by 1 / (1 − rate), in x's dtype; the identity when
    deterministic or rate is 0."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator (deterministic=False)")
    # drawn where the generator lives, then moved: a sharded forward runs
    # positions on other devices than the step's one generator
    keep = torch.rand(x.shape, generator=generator, device=generator.device) < 1.0 - rate
    keep = keep.to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def layer_qkv(hx: torch.Tensor, lp: dict, *, arch: EncoderArch):
    """A layer's attention inputs: the fused head-interleaved QKV product
    (the reference's (h, nh, 3, hd) stack; int8 kernels through the int8
    product) → q, k, v (B, S, nh, hd), strided views of it (K5 reads them
    in place)."""
    b, s, h = hx.shape
    nh, hd = arch.num_heads, arch.head_dim
    attn = lp["attn"]
    quant = _is_q(attn["q"]["w"])
    w_qkv = torch.stack(
        [(attn[n]["w"]["q"] if quant else attn[n]["w"]).reshape(h, nh, hd)
         for n in ("q", "k", "v")], dim=2
    ).reshape(h, nh * 3 * hd)
    b_qkv = torch.stack(
        [attn[n]["b"].reshape(nh, hd) for n in ("q", "k", "v")], dim=1
    )
    if quant:
        s_qkv = torch.stack(
            [attn[n]["w"]["s"].reshape(nh, hd) for n in ("q", "k", "v")], dim=1
        ).float()
        hq, hs = _dyn_quant_tokens(hx)
        qkv = _int8_matmul(hq, w_qkv).reshape(b, s, nh, 3, hd)
        qkv = (qkv * hs[..., None, None] * s_qkv).to(hx.dtype) + b_qkv
    else:
        qkv = torch.matmul(hx, w_qkv).reshape(b, s, nh, 3, hd) + b_qkv
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


def residual_norm(
    x: torch.Tensor, delta: torch.Tensor, ln: dict, *, arch: EncoderArch,
    deterministic: bool = True, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """LN(x + dropout(delta)): the close of a block's attention or FFN half."""
    delta = dropout(delta, arch.hidden_dropout, generator, deterministic)
    return _layer_norm(x + delta, ln["scale"], ln["bias"], arch.layer_norm_eps)


def mlp_hidden(hx: torch.Tensor, mlp: dict, *, arch: EncoderArch) -> torch.Tensor:
    """The dense FFN's activated hidden layer, act(x·W_in + b) in x's dtype
    (the activation in f32)."""
    return _act(arch.hidden_act)(_dense(hx, mlp["in"]).float()).to(hx.dtype)


def layer_after_attention(
    hx: torch.Tensor,              # (B, S, H): the layer's input
    ctx: torch.Tensor,             # (B, S, nh, hd): the attention output
    lp: dict,
    attention_mask: torch.Tensor,  # (B, S)
    *,
    arch: EncoderArch,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    with_aux: bool = False,
):
    """The rest of a post-LN block after attention: output projection (+
    dropout), residual + LN, FFN (the routed experts for an MoE arch; +
    dropout), residual + LN. Position-wise but for the MoE capacity, which
    counts the tokens of the rows given. ``with_aux`` as in
    ``transformer_layer``."""
    b, s, _ = hx.shape
    attn, mlp = lp["attn"], lp["mlp"]
    ctx = ctx.reshape(b, s, -1)    # nh·hd < h after head pruning
    with span("ts.encoder.ffn"):
        hx1 = residual_norm(hx, _dense(ctx, attn["o"]), lp["attn_ln"], arch=arch,
                            deterministic=deterministic, generator=generator)
        aux = drop = None
        if arch.num_experts > 0:
            ff, aux, drop = moe_ffn(
                hx1, attention_mask, mlp["router"]["w"], mlp["in"]["w"], mlp["in"]["b"],
                mlp["out"]["w"], mlp["out"]["b"], top_k=arch.expert_top_k,
                capacity_factor=arch.expert_capacity_factor, activation=_act(arch.hidden_act),
            )
        else:
            ff = _dense(mlp_hidden(hx1, mlp, arch=arch), mlp["out"])
        out = residual_norm(hx1, ff, lp["mlp_ln"], arch=arch, deterministic=deterministic,
                            generator=generator)
    if not with_aux:
        return out
    if aux is None:
        aux = drop = torch.zeros((), dtype=torch.float32, device=hx.device)
    return out, aux, drop


def layer_attention(
    hx: torch.Tensor,              # (B, S, H)
    lp: dict,
    attention_mask: torch.Tensor,  # (B, S)
    *,
    arch: EncoderArch,
    attention_impl: str = "auto",
    segment_ids: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
    performer_proj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A layer's attention: ``layer_qkv`` → ``multi_head_attention`` with
    the arch's window and Performer settings → (B, S, nh, hd). A tensor-
    parallel position passes an arch of its own head count."""
    with span("ts.encoder.attention"):
        q, k, v = layer_qkv(hx, lp, arch=arch)
        return multi_head_attention(
            q, k, v, mask=attention_mask, head_mask=head_mask, impl=attention_impl,
            window=arch.attention_window, window_global_cls=arch.window_global_cls,
            segment_ids=segment_ids, performer_proj=performer_proj,
            performer_kernel=arch.performer_kernel,
            performer_local_heads=arch.performer_local_heads,
            performer_local_window=arch.performer_local_window,
        )


def transformer_layer(
    hx: torch.Tensor,              # (B, S, H) in the compute dtype
    lp: dict,                      # one layer's params (unstacked, cast)
    attention_mask: torch.Tensor,  # (B, S)
    *,
    arch: EncoderArch,
    attention_impl: str = "auto",  # auto | flash | packed | reference
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S): packed rows
    head_mask: Optional[torch.Tensor] = None,    # (nh,) multiplier a head
    performer_proj: Optional[torch.Tensor] = None,  # (m, hd): impl="performer"
    with_aux: bool = False,
):
    """One post-LN block: MHA + residual + LN, FFN + residual + LN, with
    dropout on the attention output and the FFN output in training
    (``layer_attention`` → ``layer_after_attention``;
    ``models.long_context`` runs the two parts per sequence piece around a
    context-parallel attention). For an MoE arch the FFN is the routed
    expert block; ``with_aux=True`` returns ``(out, aux, drop)``: the
    layer's load-balance loss and dropped fraction (zeros for a dense
    arch)."""
    ctx = layer_attention(hx, lp, attention_mask, arch=arch, attention_impl=attention_impl,
                          segment_ids=segment_ids, head_mask=head_mask,
                          performer_proj=performer_proj)
    return layer_after_attention(hx, ctx, lp, attention_mask, arch=arch,
                                 deterministic=deterministic, generator=generator,
                                 with_aux=with_aux)


def embed_inputs(
    emb: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    arch: EncoderArch,
    precision: Precision = DEFAULT_PRECISION,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    position_ids: Optional[torch.Tensor] = None,  # (B, S) packed rows' positions
) -> torch.Tensor:
    """Word + position (+ token type) embeddings, LN and dropout, returned
    in the compute dtype. The sum runs in the tables' dtype (bf16 tables add in
    bf16, as the reference's code reads); an int8 table dequantizes its
    gathered rows to f32. With ``arch.position_offset`` (RoBERTa) real
    tokens take positions cumsum(mask) + pad_token_id and padding the pad
    row, as the reference (``create_position_ids_from_input_ids``). Given
    ``position_ids`` (0-based in each packed segment), real tokens take
    those, shifted to ``p + pad_token_id + 1`` with ``position_offset``,
    and padding the pad row."""
    s = input_ids.shape[1]
    x = _take(emb["word"], input_ids.long())
    if position_ids is not None:
        pos_ids = position_ids.long()
        if arch.position_offset:
            m = attention_mask.long()
            pos_ids = (pos_ids + arch.pad_token_id + 1) * m + arch.pad_token_id * (1 - m)
        x = x + _take(emb["position"], pos_ids)
    elif arch.position_offset:
        m = attention_mask.long()
        pos_ids = torch.cumsum(m, dim=1) * m + arch.pad_token_id
        x = x + _take(emb["position"], pos_ids)
    else:
        x = x + _take(emb["position"], slice(0, s))[None]
    if arch.has_token_type:
        if token_type_ids is None:
            x = x + _take(emb["token_type"], 0)
        else:
            x = x + _take(emb["token_type"], token_type_ids.long())
    x = _layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"], arch.layer_norm_eps)
    x = dropout(x, arch.hidden_dropout, generator, deterministic)
    if arch.embed_factor_size and "proj" in emb:
        # ALBERT: E → H in f32 (HF's embedding_hidden_mapping_in)
        pw = emb["proj"]
        x = x.float() @ dequant_weight(pw["w"]).float() + pw["b"].float()
    return x.to(precision.compute_dtype)


def _take(table, idx):
    """Rows of an embedding table; an int8 table gathers codes, then
    dequantizes them with its per-column scale."""
    if _is_q(table):
        return table["q"][idx].float() * table["s"][0]
    return table[idx]


def encoder_forward(
    params: dict,
    input_ids: torch.Tensor,                       # (B, S) int
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = keep
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    arch: EncoderArch,
    precision: Precision = DEFAULT_PRECISION,
    attention_impl: str = "auto",
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,   # (B, S): packed rows
    position_ids: Optional[torch.Tensor] = None,  # (B, S): packed rows
    remat=False,                                  # False | True | "dots"
    head_mask: Optional[torch.Tensor] = None,     # (L, nh)
    output_hidden_states: bool = False,
    performer_step: Optional[int] = None,         # train step, for feature redraw
    performer_proj: Optional[torch.Tensor] = None,  # (m, hd) in place of the draw
) -> EncoderOutput:
    """Run the encoder: embeddings, then a loop over the L stacked layers
    (the reference's ``lax.scan``; ALBERT runs its one layer L times), then
    the pooler when the arch has one. ``attention_impl``: auto | flash |
    packed | reference (see the module note). ``deterministic=False``
    applies dropout with masks from ``generator``. ``segment_ids`` /
    ``position_ids``: a packed layout (``data.packing.pack_sequences``).
    ``remat``: recompute each layer in the backward (True), or all but its
    matmul outputs ("dots"). ``head_mask`` (L, nh): layer l's attention
    probabilities scaled by row l (the reference attention).
    ``output_hidden_states``: also the (L + 1, B, S, H) stack of the
    embedding output and every layer's output. A Performer arch runs
    ``impl="performer"`` whatever ``attention_impl`` says, with
    ``performer_proj`` or the drawn projection (the epoch of
    ``performer_step`` when the arch redraws). An MoE arch returns
    ``moe_aux`` / ``moe_drop``, the means over the L layers. A tree of
    ``core.mesh.ShardedLeaf`` (a sharded train state) runs
    ``models.sharded.encoder_forward_sharded``, the same function over the
    mesh, as GSPMD runs the reference's unsharded one."""
    if mesh_of(params) is not None:
        from .sharded import encoder_forward_sharded

        return encoder_forward_sharded(
            params, input_ids, attention_mask, token_type_ids, arch=arch, precision=precision,
            attention_impl=attention_impl, deterministic=deterministic, generator=generator,
            segment_ids=segment_ids, position_ids=position_ids, remat=remat,
            head_mask=head_mask, output_hidden_states=output_hidden_states,
            performer_step=performer_step, performer_proj=performer_proj,
        )
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
    x = embed_inputs(
        params["embeddings"], input_ids, attention_mask, token_type_ids,
        arch=arch, precision=precision, deterministic=deterministic, generator=generator,
        position_ids=position_ids,
    )
    layers = _cast_tree(params["layers"], precision.compute_dtype)
    if arch.share_layers:
        layers = _unstack_tree(layers, 1) * arch.num_layers   # one set, L iterations
    else:
        layers = _unstack_tree(layers, arch.num_layers)
    if arch.attention_type == "performer":
        attention_impl = "performer"
        if performer_proj is None:
            performer_proj = _performer.projection(arch, performer_step, x.device)
    moe = arch.num_experts > 0
    kw = dict(arch=arch, attention_impl=attention_impl, deterministic=deterministic,
              generator=generator, segment_ids=segment_ids, performer_proj=performer_proj,
              with_aux=moe)
    states = [x]
    sums = torch.zeros((2,), dtype=torch.float32, device=x.device) if moe else None
    for i, lp in enumerate(layers):
        hm = None if head_mask is None else head_mask[i].float()
        if remat and torch.is_grad_enabled():
            x = _remat_layer(x, lp, attention_mask, remat, head_mask=hm, **kw)
        else:
            x = transformer_layer(x, lp, attention_mask, head_mask=hm, **kw)
        if moe:
            x, aux, drop = x
            sums = sums + torch.stack([aux, drop])
        states.append(x)
    pooler_out = None
    if arch.has_pooler and "pooler" in params:
        pw = params["pooler"]
        pooler_out = bert_pooler(x, dequant_weight(pw["w"]), pw["b"])
    moe_aux = moe_drop = None
    if moe:
        moe_aux, moe_drop = sums[0] / arch.num_layers, sums[1] / arch.num_layers
    return EncoderOutput(x, pooler_out, torch.stack(states) if output_hidden_states else None,
                         moe_aux, moe_drop)


def num_params(params: dict) -> int:
    """Elements over every leaf of a parameter tree (an int8 leaf counts
    its codes and its scales)."""
    return sum(num_params(v) if isinstance(v, dict) else v.numel() for v in params.values())


# ops whose outputs remat="dots" keeps (the reference's
# dots_with_no_batch_dims_saveable keeps the matmuls)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default]


def _remat_layer(x, lp, attention_mask, remat, *, generator, deterministic, **kw):
    """One layer under ``torch.utils.checkpoint`` (``remat_call``). An MoE
    layer's (out, aux, drop) goes through as a tuple."""
    def layer(h):
        return transformer_layer(h, lp, attention_mask, generator=generator,
                                 deterministic=deterministic, **kw)

    return remat_call(layer, (x,), remat, generator=generator, deterministic=deterministic)


def remat_call(fn, args: tuple, remat, *, generator, deterministic):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (``remat="dots"``: the
    matmul outputs kept). Checkpoint restores only the default generators,
    so ``generator`` is put back to its state at the call's entry for the
    recompute (and returned to where the backward found it after), so the
    recompute draws the forward's dropout masks."""
    draws = generator is not None and not deterministic
    entry = generator.get_state() if draws else None
    calls = []

    def run(*a):
        if not draws or not calls:       # the forward
            calls.append(1)
            return fn(*a)
        now = generator.get_state()      # the recompute
        generator.set_state(entry)
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    context = {}
    if remat == "dots":
        context["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _DOTS)
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **context)


def _cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Floating leaves → ``dtype`` (an int8 leaf's scale too, as the
    reference casts it); int8 codes stay."""
    return {
        k: _cast_tree(v, dtype) if isinstance(v, dict)
        else v.to(dtype) if v.is_floating_point() else v
        for k, v in tree.items()
    }


def _unstack_tree(tree: dict, n: int) -> list:
    """A tree of (n, …) stacked leaves → n trees of (…) leaves. One
    ``unbind`` a leaf, so the backward stacks the n gradients once (indexing
    each layer would add n full-size zero tensors a leaf). ALBERT's stack
    holds one layer (n = 1), which the forward then reuses."""
    parts = {
        k: _unstack_tree(v, n) if isinstance(v, dict) else v.unbind(0)
        for k, v in tree.items()
    }
    return [{k: parts[k][i] for k in tree} for i in range(n)]


class Encoder(nn.Module):
    """The encoder as an ``nn.Module`` over a JAX-layout parameter tree."""

    def __init__(
        self,
        arch: EncoderArch,
        params: dict,
        precision: Precision = DEFAULT_PRECISION,
    ):
        super().__init__()
        self.arch = arch
        self.precision = precision
        self.params = _ParamTree(params)

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None) -> EncoderOutput:
        return encoder_forward(
            self.tree(), input_ids, attention_mask, token_type_ids,
            arch=self.arch, precision=self.precision,
        )
