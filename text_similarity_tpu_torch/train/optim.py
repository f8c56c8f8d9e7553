"""Optimizer (port of ``text_similarity_tpu.train.optim``): AdamW with
decoupled weight decay and no-decay groups by leaf name, a linear warmup
then linear decay schedule, global-norm clipping and gradient accumulation,
with the arithmetic of the JAX package's optax chain
``clip_by_global_norm → adamw`` (wrapped in ``MultiSteps`` when
``grad_accum_steps > 1``).

The optimizer updates the parameter tensors in place; its state is a plain
tree (tensors and Python counters) that ``core.checkpoint`` saves as
``opt_state.npz``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.config import TrainConfig

_NO_DECAY_SUBTREES = ("ln", "attn_ln", "mlp_ln")
_NO_DECAY_LEAVES = ("b", "bias", "scale")


def _no_decay_mask(params: dict, _path: tuple = ()) -> dict:
    """True where weight decay applies: kernels and embedding tables.
    LayerNorm subtrees and leaves named b, bias or scale are excluded by
    NAME, since the layer-stacked biases are (L, H) and ndim alone would
    decay them; any other leaf decays when ndim ≥ 2."""
    out = {}
    for key, val in params.items():
        path = _path + (str(key),)
        if isinstance(val, dict):
            out[key] = _no_decay_mask(val, path)
        else:
            excluded = any(n in _NO_DECAY_SUBTREES for n in path) or path[-1] in _NO_DECAY_LEAVES
            out[key] = not excluded and val.ndim >= 2
    return out


def linear_warmup_schedule(lr: float, total_steps: int, warmup_steps: int) -> Callable:
    """Linear warmup then linear decay to 0: lr · clip(min(step / warmup,
    (total − step) / (total − warmup)), 0, 1), with warmup at least 1, so
    the first update (step 0) has lr 0."""
    warmup_steps = max(warmup_steps, 1)

    def schedule(step: int) -> float:
        warm = step / warmup_steps
        decay = (total_steps - step) / max(total_steps - warmup_steps, 1)
        return lr * min(max(min(warm, decay), 0.0), 1.0)

    return schedule


def _leaves(tree: dict) -> list:
    out = []
    for val in tree.values():
        out.extend(_leaves(val) if isinstance(val, dict) else [val])
    return out


def _zeros_like(tree: dict) -> dict:
    return {
        k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v, dtype=torch.float32)
        for k, v in tree.items()
    }


class AdamW:
    """``clip_by_global_norm(max_grad_norm) → adamw(schedule, b1, b2, eps,
    weight_decay, mask)``, applied in place by :meth:`step`.

    Per optimizer step, with count the number of earlier steps:
    g ← g · max_norm / ‖g‖ when ‖g‖ ≥ max_norm (‖·‖ over every leaf);
    mu ← (1 − b1) g + b1 mu; nu ← (1 − b2) g² + b2 nu;
    u ← (mu / (1 − b1^(count+1))) / (√(nu / (1 − b2^(count+1))) + eps),
    plus weight_decay · p where the mask decays; p ← p − schedule(count) · u.
    With ``grad_accum_steps = k > 1`` (optax ``MultiSteps``), each call
    folds g into a running mean and every k-th call applies the step to the
    mean of the k gradients; the schedule counts optimizer steps."""

    def __init__(
        self,
        schedule: Callable[[int], float],
        decay_mask: Optional[dict] = None,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.01,
        max_grad_norm: float = 1.0,
        grad_accum_steps: int = 1,
    ):
        self.schedule = schedule
        self.decay_mask = decay_mask
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.grad_accum_steps = grad_accum_steps

    def init(self, params: dict) -> dict:
        """The state: the step count, the f32 moments mu and nu (trees like
        params) and, with accumulation, the running mean and its counters.
        Without a mask given, the no-decay mask is taken from ``params``."""
        if self.decay_mask is None:
            self.decay_mask = _no_decay_mask(params)
        state = {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params)}
        if self.grad_accum_steps > 1:
            state.update(mini_step=0, gradient_step=0, acc=_zeros_like(params))
        return state

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> bool:
        """Fold ``grads`` (a tree like params) in and update params and state
        in place → whether the parameters moved (False on the first k − 1
        micro-steps of an accumulation). Each formula is one ``_foreach``
        pass over all the leaves."""
        g = [x.float() for x in _leaves(grads)]
        if self.grad_accum_steps > 1:
            acc = _leaves(state["acc"])
            n = state["mini_step"]
            delta = torch._foreach_sub(g, acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(acc, delta)
            state["mini_step"] = (n + 1) % self.grad_accum_steps
            if n != self.grad_accum_steps - 1:
                return False
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            state["gradient_step"] += 1
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        # optax: (g / ‖g‖) · max_norm when ‖g‖ ≥ max_norm, else g (g / 1 · 1)
        keep = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        g = torch._foreach_div(g, torch.where(keep, one, norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * self.max_grad_norm))

        count = state["count"]
        lr = self.schedule(count)
        bc1 = 1.0 - float(torch.tensor(self.b1) ** (count + 1))
        bc2 = 1.0 - float(torch.tensor(self.b2) ** (count + 1))
        p, mu, nu = _leaves(params), _leaves(state["mu"]), _leaves(state["nu"])
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1.0 - self.b2)
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            decays = [i for i, m in enumerate(_leaves(self.decay_mask)) if m]
            torch._foreach_add_([u[i] for i in decays], [p[i] for i in decays],
                                alpha=self.weight_decay)
        torch._foreach_add_(p, [x.to(t.dtype) for x, t in zip(u, p)], alpha=-lr)
        state["count"] = count + 1
        return True


def make_optimizer(
    cfg: TrainConfig,
    total_steps: int,
    params_example: Optional[dict] = None,
    warmup_steps: Optional[int] = None,
) -> AdamW:
    """AdamW of ``cfg`` over ``total_steps`` micro-steps: warmup defaults to
    ``total_steps · warmup_ratio``; with accumulation both count optimizer
    steps (divided by ``grad_accum_steps``), as the JAX package does for
    ``MultiSteps``. The no-decay mask is taken from ``params_example``, or
    from the params the optimizer's ``init`` is given."""
    if warmup_steps is None:
        warmup_steps = int(total_steps * cfg.warmup_ratio)
    if cfg.grad_accum_steps > 1:
        total_steps = max(total_steps // cfg.grad_accum_steps, 1)
        warmup_steps = warmup_steps // cfg.grad_accum_steps
    return AdamW(
        linear_warmup_schedule(cfg.lr, total_steps, warmup_steps),
        decay_mask=_no_decay_mask(params_example) if params_example is not None else None,
        b1=cfg.adam_b1,
        b2=cfg.adam_b2,
        eps=cfg.adam_eps,
        weight_decay=cfg.weight_decay,
        max_grad_norm=cfg.max_grad_norm,
        grad_accum_steps=cfg.grad_accum_steps,
    )

