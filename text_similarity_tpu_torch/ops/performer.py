"""Performer / FAVOR+ linear attention (port of
``text_similarity_tpu.ops.performer``).

* ``orthogonal_random_features``: the (m, d) projection, block QR of
  gaussian (d, d) blocks with rows rescaled by √χ²(d), drawn from an explicit
  ``torch.Generator`` on the CPU (χ² as a sum of d squared normals from the
  same generator), so the card and the CPU get the same matrix.
* ``draw_projection`` / ``projection``: the encoder's matrix, seeded 42, or
  from (42, epoch) for a redraw (the epoch of a train step is
  ``step // every``); one draw a (m, d, epoch, device), cached, so a
  forward does not redo the QR. The JAX package draws from ``PRNGKey(42)`` with threefry:
  the two packages' matrices differ, each deterministic in its package (the
  parity tests pass the JAX matrix in).
* ``softmax_kernel_features`` / ``relu_kernel_features``: φ(x), features
  and sums in f32; the feature projection goes through ``f32_matmul``, so
  the exponent never takes TF32.
* ``performer_attention``: non-causal FAVOR+, out = φq (φkᵀ v) / (φq φkᵀ 1).
* ``performer_attention_causal``: chunked prefix sums, chunk 128 (S padded
  up to a multiple): exact masked products within a chunk plus the running
  (m, d) state of the chunks before it, as one exclusive cumulative sum
  over the chunks in place of the reference's ``lax.scan``.

The output is cast back to q's dtype, as the reference does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import f32_matmul

BASE_SEED = 42
_NEG = -1e9   # finite sentinel: a fully masked row must stay finite


def orthogonal_random_features(
    generator: torch.Generator, num_features: int, dim: int, scaling: str = "sqrt_dim"
) -> torch.Tensor:
    """(m, d) block-orthogonal gaussian features on the CPU (f32): the
    transposed Q of a QR of each gaussian (d, d) block, rows rescaled to
    √χ²(d) norms (``scaling="sqrt_dim"``) or to √d."""
    n_blocks = -(-num_features // dim)
    blocks = []
    for _ in range(n_blocks):
        g = torch.randn((dim, dim), generator=generator, dtype=torch.float32)
        q, _ = torch.linalg.qr(g)
        blocks.append(q.T)
    w = torch.cat(blocks, dim=0)[:num_features]
    if scaling == "sqrt_dim":
        chi2 = torch.randn((num_features, dim), generator=generator,
                           dtype=torch.float32).square().sum(dim=1, keepdim=True)
        return w * torch.sqrt(chi2)
    return w * math.sqrt(dim)


def _generator(epoch: Optional[int]) -> torch.Generator:
    if epoch is None:
        return torch.Generator().manual_seed(BASE_SEED)
    seed = int(np.random.SeedSequence([BASE_SEED, int(epoch)]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


@functools.lru_cache(maxsize=16)
def draw_projection(num_features: int, dim: int, epoch: Optional[int] = None,
                    device: str = "cpu") -> torch.Tensor:
    """The encoder's (m, d) projection, drawn on the CPU and moved to
    ``device``: seeded 42 (``epoch`` None), or from (42, epoch) for a
    redraw. Cached: one QR a (m, d, epoch, device)."""
    return orthogonal_random_features(_generator(epoch), num_features, dim).to(device)


def projection(arch, step: Optional[int] = None, device="cpu") -> torch.Tensor:
    """The projection ``encoder_forward`` uses for a Performer arch, on
    ``device``: m = ``performer_features`` or the head width; with
    ``performer_redraw_every`` > 0 and a train ``step``, the matrix of the
    step's epoch ``step // every`` (the feature redraw: the steps of one
    epoch share a matrix, the next epoch draws a new one), else the base
    draw."""
    m = arch.performer_features or arch.head_dim
    epoch = None
    if arch.performer_redraw_every > 0 and step is not None:
        epoch = int(step) // arch.performer_redraw_every
    return draw_projection(m, arch.head_dim, epoch, str(torch.device(device)))


def _project(x32: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(..., S, H, D) f32 @ (m, D)ᵀ → (..., S, H, m), true f32."""
    return f32_matmul(x32, proj.T.to(x32.device))


def softmax_kernel_features(
    x: torch.Tensor,            # (..., S, H, D)
    proj: torch.Tensor,         # (m, D)
    is_query: bool,
    eps: float = 1e-4,
    mask: Optional[torch.Tensor] = None,   # (..., S) 1 = valid position
) -> torch.Tensor:
    """φ(x): positive softmax-kernel features. Queries stabilise per
    position; keys over (S, m) per (b, h), masked keys excluded through the
    finite −1e9 sentinel. A row with no valid key stabilises over all its
    keys, so its features stay finite (the reference's give inf there, and
    its attention NaN)."""
    d = x.shape[-1]
    xs = x.float() * d ** -0.25
    wx = _project(xs, proj)
    sq = 0.5 * (xs * xs).sum(dim=-1, keepdim=True)
    if is_query:
        stab = (wx - sq).amax(dim=-1, keepdim=True)
    else:
        stab = (wx - sq).amax(dim=(-3, -1), keepdim=True)
        if mask is not None:
            keep = mask[..., None, None].bool()
            masked = torch.where(keep, wx - sq, torch.full((), _NEG, device=x.device))
            masked = masked.amax(dim=(-3, -1), keepdim=True)
            # a row with no valid key keeps the unmasked maximum: its
            # features are masked out after, and exp(· + 1e9) would be inf
            stab = torch.where(masked > _NEG, masked, stab)
    return (torch.exp(wx - sq - stab) + eps) / math.sqrt(proj.shape[0])


def relu_kernel_features(x: torch.Tensor, proj: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Generalized (ReLU) kernel features: relu(x Wᵀ) / √m + ε."""
    return (F.relu(_project(x.float(), proj)) + eps) / math.sqrt(proj.shape[0])


def _features(x, proj, is_query, mask, kernel: str):
    if kernel == "relu":
        return relu_kernel_features(x, proj)
    return softmax_kernel_features(x, proj, is_query=is_query, mask=mask)


def performer_attention(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    proj: torch.Tensor,         # (m, D)
    mask: Optional[torch.Tensor] = None,   # (B, S) 1 = keep
    kernel: str = "softmax",
) -> torch.Tensor:
    """Non-causal FAVOR+: out = φq (φkᵀ v) / (φq (φkᵀ 1))."""
    qf = _features(q, proj, True, None, kernel)            # (B, S, H, m)
    kf = _features(k, proj, False, mask, kernel)
    if mask is not None:
        kf = kf * mask[:, :, None, None].float()
    kv = torch.einsum("bshm,bshd->bhmd", kf, v.float())
    z = torch.einsum("bshm,bhm->bsh", qf, kf.sum(dim=1))
    out = torch.einsum("bshm,bhmd->bshd", qf, kv) / z[..., None].clamp_min(1e-9)
    return out.to(q.dtype)


def performer_attention_causal(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    proj: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 128,
    kernel: str = "softmax",
) -> torch.Tensor:
    """Causal FAVOR+ through chunked prefix sums: within a chunk the exact
    lower-triangular product of the features, across chunks the (m, d)
    and (m,) sums of every earlier chunk."""
    b, s, h, d = q.shape
    pad = (-s) % chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.int32, device=q.device)
    if pad:
        padder = lambda x: F.pad(x, (0, 0, 0, 0, 0, pad))  # noqa: E731
        q, k, v = padder(q), padder(k), padder(v)
        mask = F.pad(mask, (0, pad))
    qf = _features(q, proj, True, None, kernel)
    kf = _features(k, proj, False, mask, kernel) * mask[:, :, None, None].float()
    n = q.shape[1] // chunk
    m = proj.shape[0]
    qc = qf.reshape(b, n, chunk, h, m)
    kc = kf.reshape(b, n, chunk, h, m)
    vc = v.float().reshape(b, n, chunk, h, d)
    # every chunk's own sums, then the exclusive prefix over the chunks
    kv = torch.einsum("bnkhm,bnkhd->bnhmd", kc, vc)
    zs = kc.sum(dim=2)                                          # (b, n, h, m)
    kv_prefix = torch.cumsum(F.pad(kv[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0)), dim=1)
    z_prefix = torch.cumsum(F.pad(zs[:, :-1], (0, 0, 0, 0, 1, 0)), dim=1)
    num = torch.einsum("bnchm,bnhmd->bnchd", qc, kv_prefix)
    den = torch.einsum("bnchm,bnhm->bnch", qc, z_prefix)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=q.device))
    scores = torch.einsum("bnchm,bnkhm->bnhck", qc, kc) * tri
    num = num + torch.einsum("bnhck,bnkhd->bnchd", scores, vc)
    den = den + scores.sum(dim=-1).transpose(2, 3)
    out = num / den[..., None].clamp_min(1e-9)
    return out.reshape(b, n * chunk, h, d)[:, :s].to(q.dtype)
