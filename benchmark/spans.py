"""What the program's own spans read in a traced stretch. The program
opens a ``record_function`` range named ``ts.<layer>[.<stage>]`` at each
layer boundary while the profiler records (``utils.profiling.span`` in the
port); each lands in the Chrome trace as a ``user_annotation`` event on
the calling thread. Every function here returns None where the stretch
holds no event of the span (a program without it), and a number a unit
(request, batch or step) otherwise."""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def _ranges(reading, span: str) -> List[Tuple[float, float]]:
    """The span's intervals (µs), sorted and merged where they overlap."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in reading.host
                if e.get("cat") == "user_annotation" and e.get("name") == span)
    merged: List[Tuple[float, float]] = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _inside(ranges: List[Tuple[float, float]], t: float) -> bool:
    j = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return j >= 0 and ranges[j][0] <= t <= ranges[j][1]


def _usable(reading) -> bool:
    return reading is not None and reading.units > 0


def host_ms(reading, span: str) -> Optional[float]:
    """Host milliseconds a unit inside ``span``: the summed durations of
    its events."""
    if not _usable(reading):
        return None
    durs = [float(e["dur"]) for e in reading.host
            if e.get("cat") == "user_annotation" and e.get("name") == span]
    return 1e-3 * sum(durs) / reading.units if durs else None


def device_ms(reading, span: str) -> Optional[float]:
    """Device milliseconds a unit of the kernels, copies and fills launched
    inside ``span`` (``Reading.range_device_s``: matched by the launch's
    correlation id); None too where none of them recorded device time."""
    if not _usable(reading):
        return None
    t = reading.range_device_s(span)
    return 1e3 * t / reading.units if t else None


def calls_in(reading, span: str, names: Sequence[str]) -> Optional[float]:
    """CUDA runtime and driver calls a unit whose name is one of ``names``
    and which start inside ``span``."""
    if not _usable(reading):
        return None
    ranges = _ranges(reading, span)
    if not ranges:
        return None
    n = sum(1 for e in reading.host
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in names
            and _inside(ranges, float(e["ts"])))
    return n / reading.units
