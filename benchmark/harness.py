"""What the benchmark finds by name: ``BENCHMARK.json``, a cell's
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``), its limits (``limits/<cell>.json``), and each
per-layer metric's reader (``metrics/<metric>.py``). Nothing here names a
cell: a cell added as new files and a new ``BENCHMARK.json`` entry loads
as it stands."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _read_json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_traffic(name: str, here: str = HERE) -> dict:
    return _read_json(os.path.join(here, "traffic", f"{name}.json"))


def load_limits(cell: str, here: str = HERE) -> Dict[str, float]:
    path = os.path.join(here, "limits", f"{cell}.json")
    return _read_json(path)["limits"] if os.path.exists(path) else {}


def metrics_for(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` (end_to_end | per_layer) that ``cell``
    reports: those that list it under ``workloads``, and those without the
    key whose end-to-end metric (``moves``, or the metric itself) the cell
    reports. The second route is for a per-layer metric that a later
    change adds without the key: it is then read in every cell that
    reports what it moves, cells added later too."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports_e2e(name: str) -> bool:
        m = e2e.get(name)
        return m is not None and ("workloads" not in m or cell in m["workloads"])

    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or reports_e2e(m["moves"]):
            out.append(m)
    return out


def load_reader(name: str, here: str = HERE):
    """``metrics/<name>.py``'s ``read(ctx)`` → a number or None."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_driver(kind: str):
    """The general driver of a traffic ``kind`` (``cells/<kind>.py``)."""
    mod = importlib.import_module(f"benchmark.cells.{kind}")
    return mod.Cell
