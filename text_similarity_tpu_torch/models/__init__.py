from .encoder import (
    Encoder,
    EncoderOutput,
    cross_params_from_jax,
    embed_inputs,
    encoder_forward,
    fsdp_param_pspecs,
    init_params,
    layer_after_attention,
    layer_qkv,
    num_params,
    param_pspecs,
    params_from_jax,
    transformer_layer,
)
from .long_context import encoder_forward_cp
from .pipeline import encoder_forward_pp
from .sharded import encoder_forward_sharded
from .hf_convert import arch_from_hf_config, convert_hf_model, convert_state_dict
from .pooling import (
    cls_pool, max_pool, mean_pool, segment_first_pool, segment_mean_pool, word_span_pool,
)
from .sentence_encoder import SentenceEncoder

__all__ = [
    "Encoder",
    "EncoderOutput",
    "cross_params_from_jax",
    "embed_inputs",
    "encoder_forward",
    "init_params",
    "layer_after_attention",
    "layer_qkv",
    "encoder_forward_cp",
    "encoder_forward_pp",
    "encoder_forward_sharded",
    "fsdp_param_pspecs",
    "param_pspecs",
    "num_params",
    "params_from_jax",
    "transformer_layer",
    "cls_pool",
    "max_pool",
    "mean_pool",
    "segment_first_pool",
    "segment_mean_pool",
    "word_span_pool",
    "SentenceEncoder",
    "arch_from_hf_config",
    "convert_hf_model",
    "convert_state_dict",
]
