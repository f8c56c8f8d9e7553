"""HuggingFace → parameter-tree conversion and the long-context position
tiling (port of ``text_similarity_tpu.models.hf_convert``).

A BERT / MiniLM / DistilBERT / RoBERTa / XLM-R / CamemBERT or single-group
ALBERT checkpoint converts into the stacked-layer tree of
``models.encoder``: from a live ``transformers`` model (its ``.config`` and
``.state_dict()`` are read; this module does not import ``transformers``)
or from a state dict of numpy arrays, so a converted checkpoint can be
made offline and shipped as an npz. The tree is built in the JAX package's
layout and carried across by ``params_from_jax``, the one function that
brings weights into the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..compress.quantize import _is_q
from ..core.config import EncoderArch
from .encoder import params_from_jax


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return np.asarray(t)


def arch_from_hf_config(cfg) -> EncoderArch:
    """Map a transformers ``PretrainedConfig`` to ``EncoderArch``."""
    mt = cfg.model_type
    if mt == "distilbert":
        return EncoderArch(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.dim,
            num_layers=cfg.n_layers,
            num_heads=cfg.n_heads,
            intermediate_size=cfg.hidden_dim,
            max_position=cfg.max_position_embeddings,
            type_vocab_size=0,
            layer_norm_eps=1e-12,
            hidden_act=cfg.activation,
            pad_token_id=cfg.pad_token_id,
            has_token_type=False,
            has_pooler=False,
        )
    if mt == "albert":
        if getattr(cfg, "num_hidden_groups", 1) != 1 or getattr(cfg, "inner_group_num", 1) != 1:
            raise ValueError("only single-group ALBERT is supported")
        return EncoderArch(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size,
            max_position=cfg.max_position_embeddings,
            type_vocab_size=cfg.type_vocab_size,
            layer_norm_eps=cfg.layer_norm_eps,
            hidden_act=cfg.hidden_act,
            pad_token_id=cfg.pad_token_id or 0,
            has_token_type=cfg.type_vocab_size > 0,
            has_pooler=True,
            share_layers=True,
            # HF applies embedding_hidden_mapping_in even where E == H, so
            # the factor size stays set and the projection is kept
            embed_factor_size=cfg.embedding_size,
        )
    if mt in ("bert", "roberta", "xlm-roberta", "camembert"):
        return EncoderArch(
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size,
            max_position=cfg.max_position_embeddings,
            type_vocab_size=cfg.type_vocab_size,
            layer_norm_eps=cfg.layer_norm_eps,
            hidden_act=cfg.hidden_act,
            pad_token_id=cfg.pad_token_id or 0,
            position_offset=2 if mt != "bert" else 0,
            has_token_type=cfg.type_vocab_size > 0,
            has_pooler=mt == "bert",
        )
    raise ValueError(f"unsupported model_type {mt!r}")


# key templates per family: ours ← theirs
_BERT_LAYER = {
    ("attn", "q", "w"): "encoder.layer.{i}.attention.self.query.weight",
    ("attn", "q", "b"): "encoder.layer.{i}.attention.self.query.bias",
    ("attn", "k", "w"): "encoder.layer.{i}.attention.self.key.weight",
    ("attn", "k", "b"): "encoder.layer.{i}.attention.self.key.bias",
    ("attn", "v", "w"): "encoder.layer.{i}.attention.self.value.weight",
    ("attn", "v", "b"): "encoder.layer.{i}.attention.self.value.bias",
    ("attn", "o", "w"): "encoder.layer.{i}.attention.output.dense.weight",
    ("attn", "o", "b"): "encoder.layer.{i}.attention.output.dense.bias",
    ("attn_ln", "scale"): "encoder.layer.{i}.attention.output.LayerNorm.weight",
    ("attn_ln", "bias"): "encoder.layer.{i}.attention.output.LayerNorm.bias",
    ("mlp", "in", "w"): "encoder.layer.{i}.intermediate.dense.weight",
    ("mlp", "in", "b"): "encoder.layer.{i}.intermediate.dense.bias",
    ("mlp", "out", "w"): "encoder.layer.{i}.output.dense.weight",
    ("mlp", "out", "b"): "encoder.layer.{i}.output.dense.bias",
    ("mlp_ln", "scale"): "encoder.layer.{i}.output.LayerNorm.weight",
    ("mlp_ln", "bias"): "encoder.layer.{i}.output.LayerNorm.bias",
}

_DISTILBERT_LAYER = {
    ("attn", "q", "w"): "transformer.layer.{i}.attention.q_lin.weight",
    ("attn", "q", "b"): "transformer.layer.{i}.attention.q_lin.bias",
    ("attn", "k", "w"): "transformer.layer.{i}.attention.k_lin.weight",
    ("attn", "k", "b"): "transformer.layer.{i}.attention.k_lin.bias",
    ("attn", "v", "w"): "transformer.layer.{i}.attention.v_lin.weight",
    ("attn", "v", "b"): "transformer.layer.{i}.attention.v_lin.bias",
    ("attn", "o", "w"): "transformer.layer.{i}.attention.out_lin.weight",
    ("attn", "o", "b"): "transformer.layer.{i}.attention.out_lin.bias",
    ("attn_ln", "scale"): "transformer.layer.{i}.sa_layer_norm.weight",
    ("attn_ln", "bias"): "transformer.layer.{i}.sa_layer_norm.bias",
    ("mlp", "in", "w"): "transformer.layer.{i}.ffn.lin1.weight",
    ("mlp", "in", "b"): "transformer.layer.{i}.ffn.lin1.bias",
    ("mlp", "out", "w"): "transformer.layer.{i}.ffn.lin2.weight",
    ("mlp", "out", "b"): "transformer.layer.{i}.ffn.lin2.bias",
    ("mlp_ln", "scale"): "transformer.layer.{i}.output_layer_norm.weight",
    ("mlp_ln", "bias"): "transformer.layer.{i}.output_layer_norm.bias",
}

# ALBERT: one shared parameter set (layer group 0, inner layer 0); the {i}
# index is unused and the stack holds one layer, which the forward reuses
_ALBERT = "encoder.albert_layer_groups.0.albert_layers.0."
_ALBERT_LAYER = {
    ("attn", "q", "w"): _ALBERT + "attention.query.weight",
    ("attn", "q", "b"): _ALBERT + "attention.query.bias",
    ("attn", "k", "w"): _ALBERT + "attention.key.weight",
    ("attn", "k", "b"): _ALBERT + "attention.key.bias",
    ("attn", "v", "w"): _ALBERT + "attention.value.weight",
    ("attn", "v", "b"): _ALBERT + "attention.value.bias",
    ("attn", "o", "w"): _ALBERT + "attention.dense.weight",
    ("attn", "o", "b"): _ALBERT + "attention.dense.bias",
    ("attn_ln", "scale"): _ALBERT + "attention.LayerNorm.weight",
    ("attn_ln", "bias"): _ALBERT + "attention.LayerNorm.bias",
    ("mlp", "in", "w"): _ALBERT + "ffn.weight",
    ("mlp", "in", "b"): _ALBERT + "ffn.bias",
    ("mlp", "out", "w"): _ALBERT + "ffn_output.weight",
    ("mlp", "out", "b"): _ALBERT + "ffn_output.bias",
    ("mlp_ln", "scale"): _ALBERT + "full_layer_layer_norm.weight",
    ("mlp_ln", "bias"): _ALBERT + "full_layer_layer_norm.bias",
}

_EMB = {
    "bert": {
        "word": "embeddings.word_embeddings.weight",
        "position": "embeddings.position_embeddings.weight",
        "token_type": "embeddings.token_type_embeddings.weight",
        "ln_scale": "embeddings.LayerNorm.weight",
        "ln_bias": "embeddings.LayerNorm.bias",
    },
    "distilbert": {
        "word": "embeddings.word_embeddings.weight",
        "position": "embeddings.position_embeddings.weight",
        "ln_scale": "embeddings.LayerNorm.weight",
        "ln_bias": "embeddings.LayerNorm.bias",
    },
    "albert": {
        "word": "embeddings.word_embeddings.weight",
        "position": "embeddings.position_embeddings.weight",
        "token_type": "embeddings.token_type_embeddings.weight",
        "ln_scale": "embeddings.LayerNorm.weight",
        "ln_bias": "embeddings.LayerNorm.bias",
    },
}

_LAYERS = {"bert": _BERT_LAYER, "distilbert": _DISTILBERT_LAYER, "albert": _ALBERT_LAYER}


def _family(model_type: str) -> str:
    return model_type if model_type in ("distilbert", "albert") else "bert"


def convert_state_dict(
    state_dict: Dict[str, "np.ndarray"],
    arch: EncoderArch,
    family: str = "bert",
    device="cpu",
) -> dict:
    """An HF state dict (tensors or numpy arrays) → the encoder's tree of
    f32 tensors on ``device``. A top-level prefix (``bert.``, ``roberta.``,
    …) is stripped; linear weights transpose from HF's (out, in) to (in,
    out); layers stack on a leading axis (one layer for ALBERT)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    for p in ("bert.", "distilbert.", "roberta.", "albert.", "model."):
        if any(k.startswith(p) for k in sd):
            sd = {(k[len(p):] if k.startswith(p) else k): v for k, v in sd.items()}
            break
    fam = _family(family)
    emb_map = _EMB[fam]
    depth = 1 if arch.share_layers else arch.num_layers

    def f32(a: np.ndarray) -> np.ndarray:
        # C order: a transposed weight would otherwise stay a strided view
        return np.ascontiguousarray(a, np.float32)

    layers: dict = {}
    for path, template in _LAYERS[fam].items():
        mats = [sd[template.format(i=i)] for i in range(depth)]
        if path[-1] == "w":
            mats = [m.T for m in mats]
        node = layers
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = f32(np.stack(mats))

    emb = {
        "word": f32(sd[emb_map["word"]]),
        "position": f32(sd[emb_map["position"]]),
        "ln": {"scale": f32(sd[emb_map["ln_scale"]]), "bias": f32(sd[emb_map["ln_bias"]])},
    }
    if arch.has_token_type and "token_type" in emb_map:
        emb["token_type"] = f32(sd[emb_map["token_type"]])
    if arch.embed_factor_size and "encoder.embedding_hidden_mapping_in.weight" in sd:
        emb["proj"] = {
            "w": f32(sd["encoder.embedding_hidden_mapping_in.weight"].T),
            "b": f32(sd["encoder.embedding_hidden_mapping_in.bias"]),
        }
    tree = {"embeddings": emb, "layers": layers}
    if arch.has_pooler:
        # BERT's pooler is a dense block, ALBERT's a bare Linear
        for key in ("pooler.dense", "pooler"):
            if key + ".weight" in sd:
                tree["pooler"] = {"w": f32(sd[key + ".weight"].T), "b": f32(sd[key + ".bias"])}
                break
    return params_from_jax(tree, arch, device)


def convert_hf_model(hf_model, device="cpu") -> Tuple[dict, EncoderArch]:
    """A live transformers model (BertModel, DistilBertModel, RobertaModel,
    AlbertModel, …) → (params on ``device``, arch)."""
    arch = arch_from_hf_config(hf_model.config)
    params = convert_state_dict(hf_model.state_dict(), arch,
                                family=_family(hf_model.config.model_type), device=device)
    return params, arch


def extend_positions(params: dict, arch: EncoderArch, new_max: int) -> Tuple[dict, EncoderArch]:
    """Tile the learned position embeddings out to ``new_max`` positions
    (the reference's Longformer conversion: copy the position table k
    times). The first ``arch.position_offset`` rows (RoBERTa's padding
    offset) are kept once, the body rows repeat, and the table is cut to
    ``new_max``. → (params with the new table, arch with ``max_position =
    new_max``); unchanged when ``new_max`` is not larger. Extend before
    quantizing: an int8 table raises."""
    emb = params["embeddings"]["position"]
    if _is_q(emb):
        raise TypeError("extend_positions needs a float position table; extend before to_int8")
    old_max = emb.shape[0]
    if new_max <= old_max:
        return params, arch
    reps = -(-new_max // old_max)
    offset = arch.position_offset
    tiled = torch.cat([emb[:offset]] + [emb[offset:]] * reps, dim=0)[:new_max]
    new_params = dict(params)
    new_params["embeddings"] = dict(params["embeddings"])
    new_params["embeddings"]["position"] = tiled
    return new_params, arch.replace(max_position=new_max)
