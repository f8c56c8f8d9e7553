"""The control at the tiny test size: the reference, or the program's own
path, one precision below what the configuration states (bf16 → int8 or
float8) fails at least one of the cell's numbers, where the program at the
same size and seed passes them all (``tiny_limits.json``). On the card
(``cuda``), a full-size run of each cell comes out correct."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness, run
from benchmark.reference import encoder as E
from benchmark.tests.conftest import tiny_config, tiny_traffic
from benchmark.tests.tiny_run import TINY_LIMITS

CONFIG = {"search-text": "minilm-l6", "search-vectors": "minilm-l6", "encode": "roberta-base-long",
          "train": "roberta-base-long"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fails(numbers: dict, limits: dict) -> list:
    """The numbers that fail, by the harness's own comparison (``run.judge``)."""
    correct, checks = run.judge(numbers, limits)
    failed = [n for n, c in checks.items() if not c["value"] <= c["limit"]]
    assert correct == (not failed)
    return failed


def _numbers(mix: str, seed: int, variant=None) -> dict:
    t = tiny_traffic(mix)
    cell = harness.cell_driver(t["kind"])(tiny_config(CONFIG[mix]), t, seed, "cpu", variant)
    cell.setup()
    cell.window(0.3)
    cell.free()
    return cell.check()


@pytest.mark.parametrize("mix", ["search-text", "search-vectors", "encode"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2])
def test_int8_control_fails(mix, seed):
    limits = TINY_LIMITS[f"{CONFIG[mix]}.{mix}"]
    assert _fails(_numbers(mix, seed), limits) == []
    assert _fails(_numbers(mix, seed, "int8"), limits)


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2])
def test_fp8_reference_in_the_programs_place_fails(seed):
    from benchmark.cells.train import gaps

    t = tiny_traffic("train")
    cell = harness.cell_driver("train")(tiny_config("roberta-base-long"), t, seed, "cpu")
    cell.setup()
    ref = cell.reference()
    limits = TINY_LIMITS["roberta-base-long.train"]
    assert _fails(gaps(cell.readings, ref), limits) == []
    assert _fails(gaps(cell.reference(lowp=E.fp8_round), ref), limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["minilm-l6.search-text", "roberta-base-long.train",
                                  "minilm-l6.search-vectors", "roberta-base-long.encode"])
def test_full_size_run_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                        "2147483999", "--seconds", "2"], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=1200, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True, p.stderr[-2000:]
