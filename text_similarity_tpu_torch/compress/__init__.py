from .quantize import (
    dequantize_params,
    int8_dynamic_matmul,
    int8_matmul_scores,
    quantize_embeddings_int8,
    quantize_params_int8,
    save_quantized,
)
from .distill import extract_student_layers, SentenceEncoderDistiller
from .theseus import TheseusDistiller, ReplacementScheduler
from .prune import head_importance, ffn_importance, prune_rewire

__all__ = [
    "extract_student_layers",
    "SentenceEncoderDistiller",
    "TheseusDistiller",
    "ReplacementScheduler",
    "head_importance",
    "ffn_importance",
    "prune_rewire",
    "dequantize_params",
    "int8_dynamic_matmul",
    "int8_matmul_scores",
    "quantize_embeddings_int8",
    "quantize_params_int8",
    "save_quantized",
]
