from .config import ARCH_PRESETS, EncoderArch, IndexConfig
from .precision import (
    DEFAULT_PRECISION,
    FP32_PRECISION,
    Precision,
    precision_for,
    resolve_device,
)

__all__ = [
    "ARCH_PRESETS",
    "EncoderArch",
    "IndexConfig",
    "DEFAULT_PRECISION",
    "FP32_PRECISION",
    "Precision",
    "precision_for",
    "resolve_device",
]
