from .quantize import (
    dequantize_params,
    int8_dynamic_matmul,
    int8_matmul_scores,
    quantize_embeddings_int8,
    quantize_params_int8,
    save_quantized,
)

__all__ = [
    "dequantize_params",
    "int8_dynamic_matmul",
    "int8_matmul_scores",
    "quantize_embeddings_int8",
    "quantize_params_int8",
    "save_quantized",
]
