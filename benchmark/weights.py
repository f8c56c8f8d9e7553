"""Random weights of a configuration, made on the device from the seed in
one draw: kernels normal(0, 1/√fan_in), so that every attention and FFN
branch adds as much to the residual stream as a trained model's does (at
the usual 0.02 the branches are a few percent of it and a model computes
little but its embeddings); embedding tables normal(0, 0.02); LayerNorm
scales 1, biases 0; f32 (the master type; the program casts to its compute
type). The tree is the port's parameter layout: layers stacked on a
leading axis."""

from __future__ import annotations

from typing import Dict

import torch


def arch_fields(cfg: dict) -> dict:
    """A configuration file → the encoder's fields: the published
    ``model`` block (Hugging Face key names) and the ``layout`` block (how
    the model numbers positions and bands its attention)."""
    m, lay = cfg["model"], cfg.get("layout", {})
    return dict(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_layers=m["num_hidden_layers"], num_heads=m["num_attention_heads"],
        intermediate_size=m["intermediate_size"], max_position=m["max_position_embeddings"],
        type_vocab_size=m["type_vocab_size"], layer_norm_eps=m["layer_norm_eps"],
        hidden_act=m["hidden_act"], pad_token_id=m["pad_token_id"],
        position_offset=lay.get("position_offset", 0), has_token_type=True, has_pooler=True,
        hidden_dropout=m["hidden_dropout_prob"],
        attention_dropout=m["attention_probs_dropout_prob"],
        attention_window=lay.get("attention_window_one_sided", 0),
        window_global_cls=lay.get("window_global_cls", False),
    )


def shapes(a: dict) -> Dict[str, tuple]:
    """Flat ``path → shape`` of every leaf, in draw order."""
    h, i, L = a["hidden_size"], a["intermediate_size"], a["num_layers"]
    out = {
        "embeddings/word": (a["vocab_size"], h),
        "embeddings/position": (a["max_position"], h),
        "embeddings/token_type": (a["type_vocab_size"], h),
        "embeddings/ln/scale": (h,), "embeddings/ln/bias": (h,),
    }
    for n in ("q", "k", "v", "o"):
        out[f"layers/attn/{n}/w"] = (L, h, h)
        out[f"layers/attn/{n}/b"] = (L, h)
    out.update({
        "layers/attn_ln/scale": (L, h), "layers/attn_ln/bias": (L, h),
        "layers/mlp/in/w": (L, h, i), "layers/mlp/in/b": (L, i),
        "layers/mlp/out/w": (L, i, h), "layers/mlp/out/b": (L, h),
        "layers/mlp_ln/scale": (L, h), "layers/mlp_ln/bias": (L, h),
        "pooler/w": (h, h), "pooler/b": (h,),
    })
    return out


def _kind(path: str) -> str:
    last = path.rsplit("/", 1)[-1]
    return "one" if last == "scale" else "zero" if last in ("b", "bias") else "normal"


def _std(path: str, shape: tuple) -> float:
    """0.02 for an embedding table; 1/√fan_in for a kernel (its rows)."""
    return 0.02 if path.startswith("embeddings/") else float(shape[-2]) ** -0.5


def make_flat(a: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every random leaf from one ``randn`` over their total size."""
    shp = shapes(a)
    normal = [p for p in shp if _kind(p) == "normal"]
    total = sum(int(torch.Size(shp[p]).numel()) for p in normal)
    g = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for p, s in shp.items():
        kind = _kind(p)
        if kind == "normal":
            n = int(torch.Size(s).numel())
            out[p] = buf[off:off + n].view(s).mul_(_std(p, s))
            off += n
        else:
            out[p] = (torch.ones if kind == "one" else torch.zeros)(s, device=device)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        parts = path.split("/")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


def make_params(a: dict, seed: int, device) -> dict:
    return nest(make_flat(a, seed, device))


def non_embedding_params(a: dict) -> int:
    """Parameters of the layers (the matmul weights a token passes)."""
    return sum(int(torch.Size(s).numel()) for p, s in shapes(a).items()
               if p.startswith("layers/"))

