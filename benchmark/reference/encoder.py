"""The plain reference encoder: a BERT / RoBERTa post-LN transformer in f32
torch operations, with no kernel, cache or batching trick of the program.

embeddings (word + position + token type; RoBERTa numbers real tokens from
``pad_token_id + 1``) → LayerNorm → L blocks of [multi-head attention →
dropout → residual → LayerNorm → GELU FFN → dropout → residual →
LayerNorm] → masked mean pool → L2 normalisation.

Attention is exact softmax attention over the valid keys; with a window w
a query i sees keys |i − j| ≤ w, and with a global CLS position 0 sees and
is seen by every position (Longformer's band with a global first token).
It is computed in blocks of query rows against the keys their band
reaches, so 4,096-token rows fit.

``lowp`` (the control) rounds both operands of every matmul to a lower
precision first; ``drop`` gives the dropout keep-masks in forward order
(the embedding's, then each layer's attention output and FFN output).
TF32 is switched off for the reference's products.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one f32 scale a row (its max to 448),
    as a straight-through value: the rounding has the identity gradient."""
    s = x.detach().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x.detach())


def _mm(a: torch.Tensor, b: torch.Tensor, lowp: Optional[Callable]) -> torch.Tensor:
    if lowp is not None:
        a, b = lowp(a), lowp(b.transpose(-1, -2)).transpose(-1, -2)
    return torch.matmul(a, b)


def _ln(x, scale, bias, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def _dropout(x, keep, rate):
    return x if keep is None else torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def attention(q, k, v, mask, window: int, global_cls: bool, lowp=None, block: int = 256):
    """q, k, v (B, nh, S, hd) f32, mask (B, S) → (B, nh, S, hd)."""
    b, nh, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    valid = mask.bool()[:, None, None, :]                  # (B, 1, 1, S)
    pos = torch.arange(s, device=q.device)
    outs = []
    for st in range(0, s, block):
        en = min(s, st + block)
        if window > 0:
            k0, k1 = max(0, st - window), min(s, en + window)
        else:
            k0, k1 = 0, s
        keys = torch.arange(k0, k1, device=q.device)
        if window > 0 and global_cls and k0 > 0:
            keys = torch.cat([keys.new_zeros(1), keys])
        kk, vv = k[:, :, keys], v[:, :, keys]
        logits = _mm(q[:, :, st:en], kk.transpose(-1, -2), lowp) * scale
        keep = valid[..., keys].expand(b, 1, en - st, keys.numel())
        if window > 0:
            rows = pos[st:en]
            band = (rows[:, None] - keys[None, :]).abs() <= window
            if global_cls:
                band = band | (keys[None, :] == 0)
            keep = keep & band
        logits = torch.where(keep, logits, torch.full_like(logits, NEG))
        outs.append(_mm(torch.softmax(logits, dim=-1), vv, lowp))
    out = torch.cat(outs, dim=2)
    if window > 0 and global_cls:
        # the CLS row sees every valid key
        logits = _mm(q[:, :, :1], k.transpose(-1, -2), lowp) * scale
        logits = torch.where(valid, logits, torch.full_like(logits, NEG))
        cls = _mm(torch.softmax(logits, dim=-1), v, lowp)
        out = torch.cat([cls, out[:, :, 1:]], dim=2)
    return out


def embed(p: dict, a: dict, ids, mask):
    m = mask.long()
    if a["position_offset"]:
        pos = torch.cumsum(m, dim=1) * m + a["pad_token_id"]
    else:
        pos = torch.arange(ids.shape[1], device=ids.device)[None].expand_as(ids)
    e = p["embeddings"]
    x = e["word"][ids.long()] + e["position"][pos] + e["token_type"][0]
    return _ln(x.float(), e["ln"]["scale"], e["ln"]["bias"], a["layer_norm_eps"])


def layer(x, lp: dict, mask, a: dict, keep_attn=None, keep_ffn=None, lowp=None):
    b, s, h = x.shape
    nh = a["num_heads"]
    hd = h // nh

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    att = lp["attn"]
    q = heads(_mm(x, att["q"]["w"], lowp) + att["q"]["b"])
    k = heads(_mm(x, att["k"]["w"], lowp) + att["k"]["b"])
    v = heads(_mm(x, att["v"]["w"], lowp) + att["v"]["b"])
    ctx = attention(q, k, v, mask, a["attention_window"], a["window_global_cls"], lowp)
    ctx = ctx.transpose(1, 2).reshape(b, s, h)
    o = _dropout(_mm(ctx, att["o"]["w"], lowp) + att["o"]["b"], keep_attn, a["hidden_dropout"])
    x = _ln(x + o, lp["attn_ln"]["scale"], lp["attn_ln"]["bias"], a["layer_norm_eps"])
    hid = _act(a["hidden_act"])(_mm(x, lp["mlp"]["in"]["w"], lowp) + lp["mlp"]["in"]["b"])
    f = _dropout(_mm(hid, lp["mlp"]["out"]["w"], lowp) + lp["mlp"]["out"]["b"], keep_ffn,
                 a["hidden_dropout"])
    return _ln(x + f, lp["mlp_ln"]["scale"], lp["mlp_ln"]["bias"], a["layer_norm_eps"])


def _layer_params(p: dict, i: int) -> dict:
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(p["layers"])


def forward(p: dict, a: dict, ids, mask, keeps: Optional[List] = None, lowp=None,
            remat: bool = False):
    """→ last hidden state (B, S, H) f32. ``keeps``: 1 + 2L keep-masks."""
    x = embed(p, a, ids, mask)
    if keeps is not None:
        x = _dropout(x, keeps[0], a["hidden_dropout"])
    for i in range(a["num_layers"]):
        lp = _layer_params(p, i)
        ka = keeps[1 + 2 * i] if keeps is not None else None
        kf = keeps[2 + 2 * i] if keeps is not None else None
        if remat:
            x = checkpoint(lambda x_, lp_, ka=ka, kf=kf: layer(x_, lp_, mask, a, ka, kf, lowp),
                           x, lp, use_reentrant=False)
        else:
            x = layer(x, lp, mask, a, ka, kf, lowp)
    return x


def mean_pool(h, mask):
    m = mask.float()[..., None]
    return (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)


def normalize(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def embed_rows(p: dict, a: dict, ids, mask, lowp=None, batch: int = 8):
    """Unit embeddings of tokenized rows, ``batch`` rows at a time."""
    out = []
    for st in range(0, ids.shape[0], batch):
        i, m = ids[st:st + batch], mask[st:st + batch]
        out.append(normalize(mean_pool(forward(p, a, i, m, lowp=lowp), m)))
    return torch.cat(out)
