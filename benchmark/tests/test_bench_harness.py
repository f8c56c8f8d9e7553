"""The harness finds every cell, configuration, traffic mix, limit and
metric by name from its file; a cell added as new files alone loads; and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_texts(bench):
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names))
        for e in bench[section]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_enough(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    used = set()
    for w in bench["workloads"]:
        used.add(w["config"])
        mine = [m["name"] for m in harness.metrics_for(bench, "end_to_end", w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = harness.metrics_for(bench, "per_layer", w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        cfg = harness.load_config(bench, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        t = harness.load_traffic(w["traffic"])
        assert harness.cell_driver(t["kind"]) is not None
        assert harness.load_limits(w["name"]), w["name"]
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_a_metric_without_workloads_follows_what_it_moves(bench):
    """A per-layer metric with no ``workloads`` key is read in every cell
    that reports its end-to-end metric, also in cells added later."""
    extra = {"name": "qps_probe", "unit": "%", "better": "higher", "source": "device_trace",
             "layer": "kernels", "moves": "search_qps"}
    b = {**bench, "per_layer": bench["per_layer"] + [extra]}
    search = next(m for m in bench["end_to_end"] if m["name"] == "search_qps")["workloads"]
    for w in bench["workloads"]:
        names = [m["name"] for m in harness.metrics_for(b, "per_layer", w["name"])]
        assert ("qps_probe" in names) == (w["name"] in search), w["name"]


def test_check_budget_fits(bench):
    """A full check of 24 cells at this run length fits the driver's time."""
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_cell_added_as_files_loads(tmp_path, bench):
    """A later cell: a configuration file, a traffic file, a limits file, a
    reader and entries in BENCHMARK.json, no code."""
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    new = dict(bench)
    with open(here / "traffic" / "search-vectors.json") as f:
        t = json.load(f)
    t["k"] = 100
    t["approx_width"] = 512
    with open(here / "traffic" / "search-vectors-k100.json", "w") as f:
        json.dump(t, f)
    with open(here / "limits" / "minilm-l6.search-vectors-k100.json", "w") as f:
        json.dump({"limits": {"scan_gap": 1.0}}, f)
    with open(here / "metrics" / "k100_probe.py", "w") as f:
        f.write("def read(ctx):\n    return None\n")
    cell = {"name": "minilm-l6.search-vectors-k100", "config": "minilm-l6",
            "traffic": "search-vectors-k100", "chips": 1, "why": "k 100"}
    new = {**bench, "workloads": bench["workloads"] + [cell],
           "per_layer": bench["per_layer"] + [
               {"name": "k100_probe", "unit": "%", "better": "higher", "source": "device_trace",
                "layer": "kernels", "moves": "search_qps", "workloads": [cell["name"]]}],
           "end_to_end": [dict(m, workloads=m["workloads"] + [cell["name"]])
                          if m["name"] == "search_qps" else m for m in bench["end_to_end"]]}
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(new, f)
    b = harness.load_benchmark(str(tmp_path))
    w = harness.find_workload(b, cell["name"])
    assert harness.load_config(b, w["config"], str(tmp_path))["name"] == "minilm-l6"
    t2 = harness.load_traffic(w["traffic"], str(here))
    assert t2["k"] == 100 and harness.cell_driver(t2["kind"]).__module__.endswith("search_vectors")
    assert harness.load_limits(cell["name"], str(here)) == {"scan_gap": 1.0}
    names = [m["name"] for m in harness.metrics_for(b, "per_layer", cell["name"])]
    assert names == ["k100_probe"]
    assert harness.load_reader("k100_probe", str(here))({}) is None
    e2e = [m["name"] for m in harness.metrics_for(b, "end_to_end", cell["name"])]
    assert e2e == ["search_qps", "setup_s"]
