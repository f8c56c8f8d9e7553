"""The readings that a cell's limits are set from, in one process on the
card: for each seed the program's numbers (set-up, a short window at the
cell's own load, the check), and on the control seeds the control's (the
program's int8 variant, or for training the reference in float8 put in
the program's place) and the faults: for search planted in the program's
index query (``cells.FAULTS``), for training in the reference put in the
program's place. Each reading is also judged by the harness's own
comparison (``run.judge``) against the cell's committed limits, as
``correct``: the program's should read true, the control's and the
faults' false.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3] [--out chiprun_out/calib.jsonl]

Each reading is printed as one JSON line and appended to ``--out``."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def emit(out: str, rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a", encoding="utf-8") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)

    import torch

    from . import harness, run
    from .cells import FAULTS
    from .reference import encoder as E

    bench = harness.load_benchmark()
    w = harness.find_workload(bench, a.workload)
    cfg = harness.load_config(bench, w["config"])
    traffic = harness.load_traffic(w["traffic"])
    Cell = harness.cell_driver(traffic["kind"])
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctrl = {int(s) for s in a.control_seeds.split(",") if s}
    limits = harness.load_limits(a.workload)

    def record(seed, side, numbers, **more):
        emit(a.out, {"workload": a.workload, "seed": seed, "side": side, **numbers,
                     "correct": run.judge(numbers, limits)[0], **more})

    def clear():
        gc.collect()
        torch.cuda.empty_cache()

    for seed in seeds:
        t = time.perf_counter()
        cell = Cell(cfg, traffic, seed, "cuda")
        cell.setup()
        cell.window(a.seconds)
        cell.free()
        clear()
        if traffic["kind"] == "train":
            from .cells.train import gaps

            ref = cell.reference()
            record(seed, "program", gaps(cell.readings, ref), s=time.perf_counter() - t)
            if seed in ctrl:
                for side, kw in (("control_fp8", {"lowp": E.fp8_round}),
                                 ("fault_half", {"fault": "half"}),
                                 ("fault_token", {"fault": "token"})):
                    record(seed, side, gaps(cell.reference(**kw), ref))
            del cell
            clear()
            continue
        record(seed, "program", cell.check(), s=time.perf_counter() - t)
        del cell
        clear()
        if seed in ctrl:
            variants = ("int8",) + (FAULTS if traffic["kind"].startswith("search") else ())
            for v in variants:
                cell = Cell(cfg, traffic, seed, "cuda", variant=v)
                cell.setup()
                cell.window(a.seconds)
                cell.free()
                clear()
                record(seed, "control_int8" if v == "int8" else f"fault_{v}", cell.check())
                del cell
                clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
