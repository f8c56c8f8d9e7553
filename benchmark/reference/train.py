"""The plain reference of a bi-encoder fine-tuning step, followed for the
first steps of a run: both towers through ``reference.encoder`` in f32
(layers recomputed in the backward to fit 4,096-token rows), mean pool,
the multiple-negatives ranking loss (cosine × 20 against every in-batch
candidate, cross entropy on the diagonal), gradients by autograd, global
norm clipping, then AdamW with decoupled weight decay (not on LayerNorm
leaves or biases) under a linear warm-up then linear decay.

Dropout: the keep-masks are drawn from a generator seeded as the trainer's
state is, one (B, S, H) uniform draw a site in forward order (tower a's
embedding, each layer's attention output and FFN output, then tower b's),
so both sides drop the same elements."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import encoder as E

NO_DECAY_SUBTREES = ("ln", "attn_ln", "mlp_ln")
NO_DECAY_LEAVES = ("b", "bias", "scale")


def decays(path: str, ndim: int) -> bool:
    parts = path.split("/")
    return (not any(p in NO_DECAY_SUBTREES for p in parts)
            and parts[-1] not in NO_DECAY_LEAVES and ndim >= 2)


def lr_at(count: int, lr: float, total: int, warmup: int) -> float:
    warmup = max(warmup, 1)
    warm = count / warmup
    dec = (total - count) / max(total - warmup, 1)
    return lr * min(max(min(warm, dec), 0.0), 1.0)


def keep_masks(gen: torch.Generator, shape, n_layers: int, rate: float) -> List[torch.Tensor]:
    return [torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate
            for _ in range(1 + 2 * n_layers)]


def mnrl(u, v, scale: float = 20.0):
    un = E.normalize(u)
    vn = E.normalize(v)
    sim = un @ vn.T * scale
    return F.cross_entropy(sim, torch.arange(sim.shape[0], device=sim.device))


def follow(flat0: Dict[str, torch.Tensor], a: dict, batches: List[dict], gen_seed: int,
           opt: dict, n_steps: int, lowp=None, fault: Optional[str] = None) -> dict:
    """The first ``n_steps`` steps from the weights ``flat0`` (path → f32
    tensor) over ``batches`` (device tensors) → {"losses": [..], "grad1":
    {path: the first clipped gradient}, "delta": {path: p_n − p_0}}.
    ``fault`` plants one fault in place of the program: "half" (half of
    each batch left out, the mean over the rest), "token" (one token of
    each batch altered)."""
    from ..weights import nest

    dev = next(iter(flat0.values())).device
    gen = torch.Generator(device=dev).manual_seed(int(gen_seed))
    paths = list(flat0)
    params = {p: flat0[p].detach().clone().requires_grad_(True) for p in paths}
    mu = {p: torch.zeros_like(params[p]) for p in paths}
    nu = {p: torch.zeros_like(params[p]) for p in paths}
    b1, b2, eps, wd = opt["adam_b1"], opt["adam_b2"], opt["adam_eps"], opt["weight_decay"]
    losses, grad1 = [], None
    for t in range(n_steps):
        bt = batches[t]
        ids_a, mask_a, ids_b, mask_b = bt["ids_a"], bt["mask_a"], bt["ids_b"], bt["mask_b"]
        tree = nest(params)
        shape = (ids_a.shape[0], ids_a.shape[1], a["hidden_size"])
        keep_a = keep_masks(gen, shape, a["num_layers"], a["hidden_dropout"])
        if fault == "token":
            ids_a = ids_a.clone()
            ids_a[0, 1] = (ids_a[0, 1] + 1) % a["vocab_size"]
        u = E.mean_pool(E.forward(tree, a, ids_a, mask_a, keep_a, lowp, remat=True), mask_a)
        keep_b = keep_masks(gen, shape, a["num_layers"], a["hidden_dropout"])
        v = E.mean_pool(E.forward(tree, a, ids_b, mask_b, keep_b, lowp, remat=True), mask_b)
        if fault == "half":
            h = u.shape[0] // 2
            u, v = u[:h], v[:h]
        loss = mnrl(u, v)
        grads = torch.autograd.grad(loss, [params[p] for p in paths], allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {p: torch.zeros_like(params[p]) if gr is None else gr
                 for p, gr in zip(paths, grads)}
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
            if norm >= opt["max_grad_norm"]:
                g = {p: x / norm * opt["max_grad_norm"] for p, x in g.items()}
            if t == 0:
                grad1 = {p: x.clone() for p, x in g.items()}
            lr = lr_at(t, opt["lr"], opt["total_steps"], opt["warmup_steps"])
            bc1, bc2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
            for p in paths:
                mu[p].mul_(b1).add_(g[p], alpha=1.0 - b1)
                nu[p].mul_(b2).add_(g[p] * g[p], alpha=1.0 - b2)
                upd = (mu[p] / bc1) / (torch.sqrt(nu[p] / bc2) + eps)
                if wd and decays(p, params[p].ndim):
                    upd = upd + wd * params[p]
                params[p].sub_(lr * upd)
        del grads, g
    delta = {p: (params[p].detach() - flat0[p]) for p in paths}
    return {"losses": losses, "grad1": grad1, "delta": delta}
