"""Hyper-parameter search (copy of ``text_similarity_tpu.train.hpo``).

Random or grid search over a declarative space with best-trial tracking
(``ParamOptimizer``), and the adaptive search: a TPE sampler with median
pruning (``AdaptiveParamOptimizer``). Host Python only; an objective runs
whatever it likes, e.g. the port's train steps. The random streams are the
reference's (``random.Random(seed)`` drawn in the same order), so one seed
gives the same trials in both packages."""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Tuple

from ..utils.logging import get_logger

logger = get_logger("hpo")


class SearchSpace:
    """space = {"lr": ("loguniform", 1e-5, 1e-3), "layers": ("choice", [2,4]),
    "warmup": ("uniform", 0.0, 0.2), "bs": ("choice", [16, 32])}"""

    def __init__(self, space: Dict[str, Tuple]):
        self.space = space

    def sample(self, rng: random.Random) -> Dict[str, Any]:
        out = {}
        for name, spec in self.space.items():
            kind = spec[0]
            if kind == "choice":
                out[name] = rng.choice(list(spec[1]))
            elif kind == "uniform":
                out[name] = rng.uniform(spec[1], spec[2])
            elif kind == "loguniform":
                import math

                out[name] = math.exp(
                    rng.uniform(math.log(spec[1]), math.log(spec[2]))
                )
            elif kind == "int":
                out[name] = rng.randint(spec[1], spec[2])
            else:
                raise ValueError(f"unknown spec {kind}")
        return out

    def grid(self) -> List[Dict[str, Any]]:
        keys, vals = [], []
        for name, spec in self.space.items():
            if spec[0] != "choice":
                raise ValueError("grid search needs all-'choice' space")
            keys.append(name)
            vals.append(list(spec[1]))
        return [dict(zip(keys, combo)) for combo in itertools.product(*vals)]


class ParamOptimizer:
    """objective(trial_params) → float metric; direction max|min."""

    def __init__(
        self,
        objective: Callable[[Dict[str, Any]], float],
        space: SearchSpace,
        direction: str = "max",
        seed: int = 0,
    ):
        self.objective = objective
        self.space = space
        self.direction = direction
        self.rng = random.Random(seed)
        self.trials: List[Dict] = []

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.direction == "max" else a < b

    def optimize(
        self, n_trials: int = 10, method: str = "random"
    ) -> Dict[str, Any]:
        candidates = (
            self.space.grid()[:n_trials]
            if method == "grid"
            else [self.space.sample(self.rng) for _ in range(n_trials)]
        )
        best_value, best_params = None, None
        for i, params in enumerate(candidates):
            value = float(self.objective(params))
            self.trials.append({"params": params, "value": value})
            if best_value is None or self._better(value, best_value):
                best_value, best_params = value, params
            logger.info(
                "trial %d/%d: %s -> %.5f (best %.5f)",
                i + 1, len(candidates), params, value, best_value,
            )
        return {"best_value": best_value, "best_params": best_params,
                "trials": self.trials}


# ---------------------------------------------------------------------------
# Adaptive search: TPE sampler + median pruning — capability parity with
# the reference's Optuna usage (src/training/test.py:11-82 creates a TPE
# study; Optuna's default pruner is the median pruner). Self-contained
# (no Optuna dependency).
# ---------------------------------------------------------------------------


class Pruned(Exception):
    """Raised inside an objective (via ``report``) to stop a bad trial."""


class MedianPruner:
    """Prune a trial whose intermediate value is worse than the median of
    completed trials' values at the same step."""

    def __init__(self, direction: str = "max", n_warmup_trials: int = 2):
        self.direction = direction
        self.n_warmup = n_warmup_trials
        self.histories: List[Dict[int, float]] = []
        self._current: Dict[int, float] = {}

    def start_trial(self):
        self._current = {}

    def report(self, step: int, value: float):
        self._current[step] = float(value)
        done = [h for h in self.histories if step in h]
        if len(done) < self.n_warmup:
            return
        import statistics

        med = statistics.median(h[step] for h in done)
        worse = value < med if self.direction == "max" else value > med
        if worse:
            raise Pruned(f"step {step}: {value:.5f} vs median {med:.5f}")

    def finish_trial(self, pruned: bool = False):
        # pruned trials' partial histories stay OUT of the median: their
        # bad tails would drag it down until equally-bad trials pass
        # (Optuna's MedianPruner also uses completed trials only)
        if not pruned:
            self.histories.append(self._current)
        self._current = {}


class TPESampler:
    """Tree-structured Parzen estimator (per-dimension independent, the
    standard TPE simplification): split past trials at the gamma quantile
    into good/bad, model each set with a kernel density, and pick the
    candidate maximizing the good/bad density ratio."""

    def __init__(
        self,
        space: SearchSpace,
        direction: str = "max",
        gamma: float = 0.25,
        n_startup: int = 5,
        n_candidates: int = 24,
        seed: int = 0,
    ):
        self.space = space
        self.direction = direction
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)

    def _split(self, trials):
        s = sorted(
            trials, key=lambda t: t["value"],
            reverse=(self.direction == "max"),
        )
        n_good = max(1, int(len(s) * self.gamma))
        return s[:n_good], s[n_good:]

    @staticmethod
    def _to_unit(spec, v):
        import math

        kind = spec[0]
        if kind == "uniform":
            return (v - spec[1]) / max(spec[2] - spec[1], 1e-12)
        if kind == "loguniform":
            lo, hi = math.log(spec[1]), math.log(spec[2])
            return (math.log(v) - lo) / max(hi - lo, 1e-12)
        if kind == "int":
            return (v - spec[1]) / max(spec[2] - spec[1], 1)
        raise ValueError(kind)

    @staticmethod
    def _from_unit(spec, u):
        import math

        u = min(max(u, 0.0), 1.0)
        kind = spec[0]
        if kind == "uniform":
            return spec[1] + u * (spec[2] - spec[1])
        if kind == "loguniform":
            lo, hi = math.log(spec[1]), math.log(spec[2])
            return math.exp(lo + u * (hi - lo))
        if kind == "int":
            return int(round(spec[1] + u * (spec[2] - spec[1])))
        raise ValueError(kind)

    def _kde_logpdf(self, xs, x, bw):
        import math

        if not xs:
            return 0.0
        acc = 0.0
        for c in xs:
            acc += math.exp(-0.5 * ((x - c) / bw) ** 2)
        return math.log(max(acc / (len(xs) * bw), 1e-12))

    def sample(self, trials) -> Dict[str, Any]:
        if len(trials) < self.n_startup:
            return self.space.sample(self.rng)
        good, bad = self._split(trials)
        out = {}
        for name, spec in self.space.space.items():
            kind = spec[0]
            if kind == "choice":
                opts = list(spec[1])
                gcnt = {o: 1.0 for o in opts}       # +1 smoothing
                bcnt = {o: 1.0 for o in opts}
                for t in good:
                    gcnt[t["params"][name]] += 1.0
                for t in bad:
                    bcnt[t["params"][name]] += 1.0
                weights = [gcnt[o] / bcnt[o] for o in opts]
                tot = sum(weights)
                r = self.rng.uniform(0, tot)
                acc = 0.0
                pick = opts[-1]
                for o, w in zip(opts, weights):
                    acc += w
                    if r <= acc:
                        pick = o
                        break
                out[name] = pick
            else:
                g = [self._to_unit(spec, t["params"][name]) for t in good]
                b = [self._to_unit(spec, t["params"][name]) for t in bad]
                bw = max(1.0 / max(len(g), 1) ** 0.5 * 0.5, 0.1)
                best_u, best_score = None, None
                for _ in range(self.n_candidates):
                    center = self.rng.choice(g) if g else self.rng.random()
                    u = center + self.rng.gauss(0.0, bw)
                    score = (
                        self._kde_logpdf(g, u, bw)
                        - self._kde_logpdf(b, u, bw)
                    )
                    if best_score is None or score > best_score:
                        best_u, best_score = u, score
                out[name] = self._from_unit(spec, best_u)
        return out


class AdaptiveParamOptimizer(ParamOptimizer):
    """TPE-sampled, median-pruned search. The objective may accept a
    second ``report(step, value)`` argument for intermediate pruning
    (Optuna's trial.report/should_prune pattern)."""

    def __init__(self, objective, space, direction="max", seed=0,
                 gamma: float = 0.25, n_startup: int = 5):
        super().__init__(objective, space, direction, seed)
        self.sampler = TPESampler(
            space, direction, gamma=gamma, n_startup=n_startup, seed=seed
        )
        self.pruner = MedianPruner(direction)
        import inspect

        self._wants_report = (
            len(inspect.signature(objective).parameters) >= 2
        )

    def optimize(self, n_trials: int = 20, method: str = "tpe"):
        if method != "tpe":
            # the adaptive optimizer IS the TPE path; silently running
            # TPE for method='grid'/'random' would hand back a different
            # search than requested — delegate to the parent instead
            return super().optimize(n_trials=n_trials, method=method)
        best_value, best_params = None, None
        n_pruned = 0
        for i in range(n_trials):
            params = self.sampler.sample(
                [t for t in self.trials if not t.get("pruned")]
            )
            self.pruner.start_trial()
            try:
                if self._wants_report:
                    value = float(self.objective(params, self.pruner.report))
                else:
                    value = float(self.objective(params))
            except Pruned as e:
                n_pruned += 1
                self.pruner.finish_trial(pruned=True)
                self.trials.append(
                    {"params": params, "value": None, "pruned": True}
                )
                logger.info("trial %d/%d pruned: %s", i + 1, n_trials, e)
                continue
            self.pruner.finish_trial()
            self.trials.append({"params": params, "value": value})
            if best_value is None or self._better(value, best_value):
                best_value, best_params = value, params
            logger.info(
                "trial %d/%d: %s -> %.5f (best %.5f)",
                i + 1, n_trials, params, value, best_value,
            )
        return {"best_value": best_value, "best_params": best_params,
                "trials": self.trials, "n_pruned": n_pruned}
