"""Timing and tracing helpers (port of
``text_similarity_tpu.utils.profiling``).

- ``force_sync``: wait for the card (``torch.cuda.synchronize``) where a
  result lies on it, then copy the result to the host (tree-aware).
- ``Timer``: labelled wall-clock records.
- ``trace``: a ``torch.profiler`` run over the CPU and, where a card
  is present, CUDA, written as a Chrome trace under ``log_dir``.
- ``benchmark_fn``: warm-up, then timed calls, each waiting for its result
  → {mean_ms, p50_ms, p95_ms[, throughput_per_sec]}.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def force_sync(x):
    """The result on the host: numpy arrays for tensors, in the structure
    of ``x`` (dicts, lists and tuples)."""
    if isinstance(x, dict):
        return {k: force_sync(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(force_sync(v) for v in x)
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Timer:
    def __init__(self, name: str = "timer"):
        self.name = name
        self.records = []

    @contextlib.contextmanager
    def time(self, label: str = ""):
        t0 = time.perf_counter()
        yield
        self.records.append((label, time.perf_counter() - t0))

    def summary(self) -> Dict[str, float]:
        return {label: dt for label, dt in self.records}


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (view it in Perfetto or
    chrome://tracing), written to ``log_dir/trace.json``; yields the
    profiler, whose ``key_averages()`` sum the kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 10,
    items_per_call: Optional[int] = None,
) -> Dict[str, float]:
    """Time ``fn(*args)``, each call waiting for its result on the host."""
    for _ in range(warmup):
        force_sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force_sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    out = {
        "mean_ms": float(times.mean() * 1e3),
        "p50_ms": float(np.percentile(times, 50) * 1e3),
        "p95_ms": float(np.percentile(times, 95) * 1e3),
    }
    if items_per_call:
        out["throughput_per_sec"] = float(items_per_call / times.mean())
    return out
