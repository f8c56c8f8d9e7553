"""The port's hyper-parameter search (``train/hpo.py``): the reference's own
three tests (``tests/test_export_hpo.py``) run against the port's module,
and one seed gives the JAX package's trials, values and best params, for
random, grid and TPE search with pruning (the same ``random.Random``
streams, drawn in the same order)."""

import math

import pytest

from text_similarity_tpu.train import hpo as jax_hpo
from text_similarity_tpu_torch.train import hpo


def test_hpo_random_and_grid():
    def objective(p):
        return -((p["lr"] - 3e-4) ** 2) - (p["layers"] - 4) ** 2

    space = hpo.SearchSpace({
        "lr": ("loguniform", 1e-5, 1e-2),
        "layers": ("choice", [2, 4, 6]),
    })
    res = hpo.ParamOptimizer(objective, space, direction="max").optimize(25)
    assert res["best_params"]["layers"] == 4
    assert len(res["trials"]) == 25

    grid_space = hpo.SearchSpace({
        "lr": ("choice", [1e-4, 3e-4]),
        "layers": ("choice", [2, 4]),
    })
    res = hpo.ParamOptimizer(objective, grid_space, direction="max").optimize(10, method="grid")
    assert res["best_params"] == {"lr": 3e-4, "layers": 4}


def _bowl(p):
    bonus = 1.0 if p["kind"] == "a" else 0.0
    return -(p["x"] - 1.5) ** 2 - (math.log10(p["lr"]) + 3) ** 2 + bonus


BOWL = {
    "x": ("uniform", -5.0, 5.0),
    "lr": ("loguniform", 1e-5, 1e-1),
    "kind": ("choice", ["a", "b"]),
}


def test_tpe_adaptive_beats_random_on_quadratic():
    """TPE concentrates samples near the optimum of a smooth bowl and beats
    random search at an equal trial budget (seeded, deterministic)."""
    space = hpo.SearchSpace(BOWL)
    r_tpe = hpo.AdaptiveParamOptimizer(_bowl, space, direction="max", seed=0).optimize(40)
    r_rnd = hpo.ParamOptimizer(_bowl, space, direction="max", seed=0).optimize(40, "random")
    assert r_tpe["best_value"] >= r_rnd["best_value"] - 0.3
    assert r_tpe["best_value"] > 0.0, r_tpe["best_value"]


def _pruned_objective(calls):
    def objective(p, report):
        # trials with low q are uniformly worse at every step
        for step in range(5):
            calls["steps"] += 1
            report(step, p["q"] * (step + 1))
        return p["q"] * 5

    return objective


def test_median_pruner_stops_bad_trials():
    calls = {"steps": 0}
    space = hpo.SearchSpace({"q": ("uniform", 0.0, 1.0)})
    res = hpo.AdaptiveParamOptimizer(_pruned_objective(calls), space, direction="max",
                                     seed=1).optimize(n_trials=20)
    assert res["n_pruned"] > 0
    assert res["best_value"] is not None
    assert calls["steps"] < 100


@pytest.mark.parametrize("case", ["random", "grid", "tpe", "tpe_pruned", "tpe_min_int"])
def test_same_seed_gives_the_jax_trials(case):
    """Trials (params and values, pruned ones marked), best value and best
    params equal to the JAX package's, for one seed."""
    def run(mod):
        if case == "random":
            return mod.ParamOptimizer(_bowl, mod.SearchSpace(BOWL), seed=3).optimize(15)
        if case == "grid":
            space = mod.SearchSpace({"a": ("choice", [1, 2, 3]), "b": ("choice", ["x", "y"])})
            return mod.ParamOptimizer(lambda p: p["a"] * (p["b"] == "y"), space,
                                      direction="min").optimize(5, method="grid")
        if case == "tpe":
            return mod.AdaptiveParamOptimizer(_bowl, mod.SearchSpace(BOWL), seed=5).optimize(30)
        if case == "tpe_pruned":
            space = mod.SearchSpace({"q": ("uniform", 0.0, 1.0)})
            return mod.AdaptiveParamOptimizer(_pruned_objective({"steps": 0}), space,
                                              seed=1).optimize(20)
        space = mod.SearchSpace({"n": ("int", 1, 9), "w": ("uniform", 0.0, 2.0)})
        return mod.AdaptiveParamOptimizer(lambda p: (p["n"] - 4) ** 2 + p["w"], space,
                                          direction="min", seed=2, n_startup=3).optimize(12)

    got, want = run(hpo), run(jax_hpo)
    assert got == want
    assert len(got["trials"]) == {"grid": 5, "random": 15, "tpe": 30}.get(case, len(want["trials"]))
