"""Precision and device policy.

Params stay in f32; matmuls run in the compute dtype (bf16 by default) and
accumulate in f32; softmax, layer norm and reductions stay in f32 — the
same policy as ``text_similarity_tpu.core.precision``.

Device policy: every entry point takes ``device`` defaulting to ``"cuda"``
and raises when no card is present. The CPU is used only when the caller
passes ``device="cpu"``; nothing falls back to it.

``f32_matmul`` is the product for the two places where a choice downstream
is discontinuous (the MoE router's argmax, the Performer features'
exponent): it never takes TF32 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32


DEFAULT_PRECISION = Precision()
FP32_PRECISION = Precision(compute_dtype=torch.float32)


def precision_for(bf16: bool) -> Precision:
    return DEFAULT_PRECISION if bf16 else FP32_PRECISION


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is visible (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 that no TF32 setting reaches: where the card's f32
    products may take TF32 (``allow_tf32`` or a float32 matmul precision
    below "highest"), the product runs in f64 and rounds to f32."""
    a, b = a.float(), b.float()
    if a.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        return (a.double() @ b.double()).float()
    return a @ b
