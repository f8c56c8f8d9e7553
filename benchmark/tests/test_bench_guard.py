"""Nothing a run loads is JAX or the JAX package: a whole tiny run of every
cell in a fresh process, then its loaded modules' top-level names (before
the first dot, compared whole; the port's name begins with the JAX
package's). The guard itself is held to a planted module."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.harness import ROOT

CELLS = ["minilm-l6.search-text", "minilm-l6.search-vectors", "roberta-base-long.encode",
         "roberta-base-long.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-m", "benchmark.tests.tiny_run", cell], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"forbidden": []}
    assert json.loads(lines[-2])["attempted"] > 0


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert "text_similarity_tpu_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "text_similarity_tpu_torch_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "text_similarity_tpu.core", object())
    assert run.forbidden_modules() == ["text_similarity_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib", "text_similarity_tpu"]


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "minilm-l6.search-text", "--seed", "1", "--seconds", "1"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
