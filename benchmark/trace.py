"""The traced stretch: ``torch.profiler`` over the CPU and the card, read
from its Chrome trace. Device busy time is the union of the intervals in
which a kernel, copy or fill ran (overlapping streams count once); a
kernel's device time is the sum of its launches; an idle gap is named by
the innermost host operation or range that was running at its middle.
Ranges the cells open around calls into the program (``span``) show up
by name among the host operations."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def span(name: str):
    """A named host range (``record_function``) around a call."""
    import torch

    with torch.profiler.record_function(name):
        yield


class Reading:
    """What one traced stretch recorded."""

    def __init__(self, events: List[dict], wall_s: float, units: int):
        self.wall_s = wall_s
        self.units = units
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]

    def busy_s(self) -> float:
        iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def kernel_s(self, names: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose symbol holds any
        of ``names``."""
        hits = [e for e in self.device if e.get("cat") == "kernel"
                and any(n in e.get("name", "") for n in names)]
        return sum(float(e["dur"]) for e in hits) * 1e-6, len(hits)

    def range_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside host range
        ``name`` (matched by the launch's correlation id)."""
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.host
                  if e.get("cat") == "user_annotation" and e.get("name") == name]
        if not ranges:
            return None
        launches = {}
        for e in self.host:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = float(e["ts"])
        total = 0.0
        for e in self.device:
            corr = (e.get("args") or {}).get("correlation")
            t = launches.get(corr)
            if t is not None and any(s <= t <= en for s, en in ranges):
                total += float(e["dur"])
        return total * 1e-6

    def top_ops(self, n: int = 10) -> List[list]:
        acc: Dict[str, float] = {}
        for e in self.device:
            acc[e["name"]] = acc.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        return [[k[:200], v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, named: int = 400) -> List[list]:
        """The idle time between device intervals, summed by the host
        operation running at each gap's middle (the ``named`` longest gaps;
        the rest as "shorter gaps"); the largest ``n`` sums."""
        import numpy as np

        iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)
        gaps, end = [], None
        for s, e in iv:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        hosts = [h for h in self.host if h.get("cat") != "cuda_runtime"]
        starts = np.asarray([float(h["ts"]) for h in hosts])
        ends = starts + np.asarray([float(h["dur"]) for h in hosts])
        acc: Dict[str, float] = {}
        for j, (s, e) in enumerate(gaps):
            name = "shorter gaps"
            if j < named and len(hosts):
                mid = 0.5 * (s + e)
                inside = np.flatnonzero((starts <= mid) & (ends >= mid))
                name = ("host (no operation)" if inside.size == 0 else
                        hosts[int(inside[np.argmin((ends - starts)[inside])])].get("name", ""))
            acc[name[:200]] = acc.get(name[:200], 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def profile(run_units, tmp_dir: Optional[str] = None) -> Reading:
    """Run ``run_units() → units done`` under the profiler (CPU and CUDA)
    → its Reading."""
    import torch
    from torch.profiler import ProfilerActivity

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = run_units()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmp_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return Reading(events, wall, units)
