"""Run one cell of the benchmark on the card and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration file and a traffic file; the traffic file's ``kind``
names the general driver (``cells/<kind>.py``). Set-up makes the inputs
and weights from the seed and warms every shape; the window then runs the
closed loop for ``--seconds``. ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` runs the same window, then a short stretch under the
profiler, and reports its per-layer metrics (``metrics/<name>.py``). After
the device memory's peak is read and the program's state freed, the
answers are judged against the plain reference; each number compared is
printed beside its limit (``limits/<cell>.json``) on standard error and,
last, in the result line. The last line of standard output is the result.

Exit codes: 0 with a result; 2 no card, or fewer than the cell asks for;
3 a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
# keep libraries that the program may load from loading JAX or Flax
for _var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[_var] = "0"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "text_similarity_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(numbers: dict, limits: dict):
    """→ (correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number without a limit, or not finite, is not correct."""
    checks = {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}
    ok = bool(numbers) and all(
        limits.get(n) is not None and math.isfinite(v) and v <= limits[n]
        for n, v in numbers.items())
    return ok, checks


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    args = parse(argv)
    import torch

    from . import harness, trace

    bench = harness.load_benchmark()
    w = harness.find_workload(bench, args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < w["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {w['chips']} CUDA card(s); {n} visible", file=sys.stderr)
        return 2
    cfg = harness.load_config(bench, w["config"])
    traffic = harness.load_traffic(w["traffic"])
    cell = harness.cell_driver(traffic["kind"])(cfg, traffic, args.seed, device)
    card = device == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
    cell.setup()
    if card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    win = cell.window(args.seconds)

    out_metrics, extra = {}, {}
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(0) if card else "cpu", "count": w["chips"]}
    if args.trace:
        reading = trace.profile(cell.traced)
        ctx = cell.layer_ctx(win, reading)
        for m in harness.metrics_for(bench, "per_layer", w["name"]):
            value = harness.load_reader(m["name"])(ctx)
            if value is not None:
                out_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev["busy_s"] = reading.busy_s()
        dev["window_s"] = reading.wall_s
        extra["breakdown"] = {"device_ops": reading.top_ops(10),
                              "idle_gaps": reading.idle_gaps(10)}
    else:
        e2e = cell.e2e(win)
        for m in harness.metrics_for(bench, "end_to_end", w["name"]):
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            out_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if card else 0

    cell.free()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    correct, checks = judge(cell.check(), harness.load_limits(w["name"]))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": win.units, "failed": 0, "metrics": out_metrics,
              "device": dev, **extra, "checks": checks}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
