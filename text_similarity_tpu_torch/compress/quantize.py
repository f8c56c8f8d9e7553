"""Int8 quantization of weights and embeddings (port of
``text_similarity_tpu.compress.quantize``).

- ``quantize_params_int8`` / ``dequantize_params``: per-output-channel
  symmetric int8 for every kernel (``w``) and embedding table of 2-4 dims;
  a quantized leaf is ``{"q": int8, "s": f32 scale}``. Vectors stay f32.
- ``quantize_embeddings_int8``: per-row symmetric int8 for the embedding
  store and the int8 IVF slabs.
- ``int8_matmul_scores``: the reference's XLA scoring of an int8 corpus —
  the queries are quantized too (the kernels K3/K4 keep them in floats).
- ``int8_dynamic_matmul``: per-tensor activation quant + int8 dot.

Every quantizer divides the values by the scale (no reciprocal) and rounds
half to even, as the reference does. The scale itself is max|x| / 127 for
weights (the reference quantizes them eagerly) and max|x| × f32(1/127) for
embeddings and activations, which the reference quantizes under ``jit``,
where XLA turns the division by the constant into that product: the
scales then agree to the bit. ``int8_mm`` is the exact int8×int8→int32
product all of them use: ``torch._int_mm`` (on the card, the rows padded
to a multiple of 32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import checkpoint as ckpt

_EMBED_TABLES = ("word", "position", "token_type")
_INV_127 = float(np.float32(1.0 / 127.0))


def _jit_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 as the reference computes it under jit."""
    return torch.clamp_min(amax, 1e-12) * _INV_127


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def _quant_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel (last axis) symmetric int8, reducing only the
    contraction axis (-2); leading axes (stacked layers) keep their own
    scales."""
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=w.dim() - 2, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return {"q": _quantize(w32, scale), "s": scale}


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def quantize_params_int8(params: dict) -> dict:
    """The quantized tree: kernels (2-4 dims, named ``w``) and embedding
    tables become ``{"q", "s"}`` leaves; everything under a ``router`` key
    and every vector stays as it is."""

    def walk(tree, names):
        out = {}
        for key, val in tree.items():
            path = names + (str(key),)
            if isinstance(val, dict):
                out[key] = walk(val, path)
            elif (
                "router" not in path and 2 <= val.dim() <= 4
                and (key == "w" or key in _EMBED_TABLES)
            ):
                out[key] = _quant_leaf(val)
            else:
                out[key] = val
        return out

    return walk(params, ())


def dequantize_params(qparams: dict, dtype=torch.bfloat16) -> dict:
    """Inverse of ``quantize_params_int8``: each ``{"q", "s"}`` leaf →
    ``(q · s)`` in ``dtype``; other leaves unchanged."""
    out = {}
    for key, val in qparams.items():
        if _is_q(val):
            out[key] = (val["q"].float() * val["s"]).to(dtype)
        elif isinstance(val, dict):
            out[key] = dequantize_params(val, dtype)
        else:
            out[key] = val
    return out


def save_quantized(path: str, params: dict, meta: dict | None = None) -> None:
    """Quantize and write a checkpoint tagged ``format: int8`` (the int8
    deployment artifact; ``SentenceEncoder.load`` dequantizes it)."""
    ckpt.save_checkpoint(
        path, quantize_params_int8(params), step=0,
        meta={"format": "int8", **(meta or {})},
    )


def quantize_embeddings_int8(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 → (values (N, D) int8, scales (N,) f32)."""
    e32 = emb.float()
    scale = _jit_scale(torch.amax(torch.abs(e32), dim=1))
    return _quantize(e32, scale[:, None]), scale


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 @ (K, N) int8 → (M, N) int32. On the card
    ``torch._int_mm`` needs M > 16 and K, N multiples of 8, and cuBLASLt
    refuses some M at a small K (CUBLAS_STATUS_NOT_SUPPORTED: at K 64 only
    multiples of 32 ran on an H100 with CUDA 12.8, every M > 16 at K ≥
    128): M is padded with zero rows (exact) to a multiple of 32; K and N
    must already be multiples of 8."""
    m = a.shape[0]
    if a.is_cuda:
        rows = -(-m // 32) * 32
        if rows != m:
            a = torch.cat([a, a.new_zeros((rows - m, a.shape[1]))])
        return torch._int_mm(a.contiguous(), b.contiguous())[:m]
    return torch._int_mm(a.contiguous(), b.contiguous())


def int8_matmul_scores(
    queries: torch.Tensor,       # (Q, D) f32 normalized
    corpus_q: torch.Tensor,      # (N, D) int8
    corpus_scale: torch.Tensor,  # (N,)
) -> torch.Tensor:
    """Approximate cosine scores against an int8 corpus with the queries
    quantized per row: int8×int8→int32, then both scales."""
    qq, qs = quantize_embeddings_int8(queries)
    acc = int8_mm(qq, corpus_q.T)
    return acc.float() * qs[:, None] * corpus_scale[None, :]


def int8_dynamic_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """Dense layer with one dynamic activation scale for the whole tensor
    (torch ``quantize_dynamic`` semantics) and an int8 dot."""
    x32 = x.float()
    xs = _jit_scale(torch.amax(torch.abs(x32)))
    xq = _quantize(x32, xs)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), w_q).reshape(*x.shape[:-1], -1)
    return acc.float() * xs * w_s.reshape((1,) * (acc.dim() - 1) + (-1,))
