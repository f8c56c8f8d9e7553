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
does there. RoBERTa-family archs (``position_offset``) number real tokens
from ``pad_token_id + 1`` and give padding the pad row.

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

Not ported yet: ALBERT sharing and factorized embeddings, MoE, head-dim
overrides, performer attention, head pruning, ``remat``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..compress.quantize import _is_q, _jit_scale, _quantize, int8_mm
from ..core.config import EncoderArch
from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.attention import multi_head_attention


class EncoderOutput(NamedTuple):
    last_hidden_state: torch.Tensor         # (B, S, H)
    pooler_output: Optional[torch.Tensor]   # (B, H) tanh(W·cls) or None


def _check_supported(arch: EncoderArch) -> None:
    unsupported = {
        "share_layers": arch.share_layers,
        "embed_factor_size": arch.embed_factor_size,
        "num_experts": arch.num_experts,
        "head_dim_override": arch.head_dim_override,
    }
    bad = [k for k, v in unsupported.items() if v]
    if arch.attention_type != "softmax":
        bad.append(f"attention_type={arch.attention_type!r}")
    if bad:
        raise NotImplementedError(
            f"encoder options not ported yet: {', '.join(bad)} "
            "(ROADMAP queue 1: ALBERT, MoE, performer)"
        )


def _param_shapes(arch: EncoderArch) -> dict:
    h, i, l = arch.hidden_size, arch.intermediate_size, arch.num_layers
    dense = lambda fi, fo: {"w": (l, fi, fo), "b": (l, fo)}  # noqa: E731
    ln = lambda *s: {"scale": s, "bias": s}  # noqa: E731
    shapes = {
        "embeddings": {
            "word": (arch.vocab_size, h),
            "position": (arch.max_position, h),
            "ln": ln(h),
        },
        "layers": {
            "attn": {n: dense(h, h) for n in ("q", "k", "v", "o")},
            "attn_ln": ln(l, h),
            "mlp": {"in": dense(h, i), "out": dense(i, h)},
            "mlp_ln": ln(l, h),
        },
    }
    if arch.has_token_type:
        shapes["embeddings"]["token_type"] = (arch.type_vocab_size, h)
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
    _check_supported(arch)

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


def params_from_jax(tree: dict, arch: EncoderArch, device="cpu") -> dict:
    """A JAX-layout parameter tree of numpy arrays (e.g. from
    ``restore_checkpoint_raw`` or ``jax.device_get(params)``) → the same
    tree of f32 tensors on ``device``, checked leaf by leaf against the
    shapes ``arch`` implies. A quantized leaf ``{"q": int8, "s": scale}``
    (``quantize_params_int8``) carries across as int8 codes and f32 scales
    whose contraction axis (-2) is 1."""
    _check_supported(arch)

    def leaf(arr, shp, name, kind):
        arr = np.asarray(arr)
        if arr.dtype.kind != kind:
            raise TypeError(f"{name}: expected a {kind!r} array, got {arr.dtype}")
        if tuple(arr.shape) != tuple(shp):
            raise ValueError(f"{name}: shape {arr.shape} != expected {shp}")
        if kind == "i":
            return torch.from_numpy(arr.astype(np.int8)).to(device)
        return torch.from_numpy(arr.astype(np.float32)).to(device)

    def convert(shapes, sub, path):
        out = {}
        for key, shp in shapes.items():
            if key not in sub:
                raise KeyError(f"parameter tree is missing {path + key!r}")
            if isinstance(shp, dict):
                out[key] = convert(shp, sub[key], path + key + "/")
            elif isinstance(sub[key], dict):
                if set(sub[key]) != {"q", "s"}:
                    raise KeyError(f"{path + key}: a quantized leaf holds q and s")
                s_shp = tuple(shp[:-2]) + (1, shp[-1])
                out[key] = {
                    "q": leaf(sub[key]["q"], shp, path + key + "/q", "i"),
                    "s": leaf(sub[key]["s"], s_shp, path + key + "/s", "f"),
                }
            else:
                out[key] = leaf(sub[key], shp, path + key, "f")
        return out

    return convert(_param_shapes(arch), tree, "")


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
    uniform draw from ``generator`` below 1 − rate) and scale it by 1 / (1 −
    rate), in x's dtype; the identity when deterministic or rate is 0."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator (deterministic=False)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def transformer_layer(
    hx: torch.Tensor,              # (B, S, H) in the compute dtype
    lp: dict,                      # one layer's params (unstacked, cast)
    attention_mask: torch.Tensor,  # (B, S)
    *,
    arch: EncoderArch,
    attention_impl: str = "auto",  # auto | flash | reference
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One post-LN block: MHA + residual + LN, FFN + residual + LN, with
    dropout on the attention output and the FFN output in training."""
    b, s, h = hx.shape
    nh, hd = arch.num_heads, arch.head_dim
    attn, mlp = lp["attn"], lp["mlp"]
    # fused QKV with the reference's head-interleaved (h, nh, 3, hd) stack
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
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    # q, k, v stay strided views of the fused QKV: K5 reads them in place
    ctx = multi_head_attention(
        q, k, v, mask=attention_mask, impl=attention_impl,
        window=arch.attention_window, window_global_cls=arch.window_global_cls,
    ).reshape(b, s, nh * hd)
    ctx = dropout(_dense(ctx, attn["o"]), arch.hidden_dropout, generator, deterministic)
    hx1 = _layer_norm(
        hx + ctx, lp["attn_ln"]["scale"], lp["attn_ln"]["bias"],
        arch.layer_norm_eps,
    )
    ff = _dense(hx1, mlp["in"])
    ff = _act(arch.hidden_act)(ff.float()).to(hx1.dtype)
    ff = dropout(_dense(ff, mlp["out"]), arch.hidden_dropout, generator, deterministic)
    return _layer_norm(
        hx1 + ff, lp["mlp_ln"]["scale"], lp["mlp_ln"]["bias"],
        arch.layer_norm_eps,
    )


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
) -> torch.Tensor:
    """Word + position (+ token type) embeddings, LN and dropout, returned
    in the compute dtype. The sum runs in the tables' dtype (bf16 tables add in
    bf16, as the reference's code reads); an int8 table dequantizes its
    gathered rows to f32. With ``arch.position_offset`` (RoBERTa) real
    tokens take positions cumsum(mask) + pad_token_id and padding the pad
    row, as the reference (``create_position_ids_from_input_ids``)."""
    s = input_ids.shape[1]
    x = _take(emb["word"], input_ids.long())
    if arch.position_offset:
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
) -> EncoderOutput:
    """Run the encoder: embeddings, then a loop over the L stacked layers
    (the reference's ``lax.scan``), then the pooler when the arch has one.
    ``attention_impl``: auto | flash | reference (see the module note).
    ``deterministic=False`` applies dropout with masks from ``generator``."""
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
    x = embed_inputs(
        params["embeddings"], input_ids, attention_mask, token_type_ids,
        arch=arch, precision=precision, deterministic=deterministic, generator=generator,
    )
    layers = _unstack_tree(_cast_tree(params["layers"], precision.compute_dtype), arch.num_layers)
    for lp in layers:
        x = transformer_layer(
            x, lp, attention_mask, arch=arch, attention_impl=attention_impl,
            deterministic=deterministic, generator=generator,
        )
    pooler_out = None
    if arch.has_pooler and "pooler" in params:
        pw = params["pooler"]
        w = dequant_weight(pw["w"]).float()
        pooler_out = torch.tanh(x[:, 0, :].float() @ w + pw["b"]).to(x.dtype)
    return EncoderOutput(x, pooler_out)


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
    each layer would add n full-size zero tensors a leaf)."""
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
        _check_supported(arch)
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
