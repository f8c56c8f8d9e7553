"""Spans and traces.

- ``span``: a named host range around a stage of the program while a
  ``torch.profiler`` session records, nothing otherwise. The program's
  spans are named ``ts.<layer>[.<stage>]`` and open on the calling thread
  only, never inside a backward pass, so each lands in the profiler's Chrome trace beside the kernels
  and copies it launched, on the same clock.
- ``trace``: a ``torch.profiler`` run over the CPU and, where a card is
  present, CUDA, written as a Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os

import torch


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else a ``nullcontext`` (no cost but the check). Inside a
    backward pass it is a ``nullcontext`` too: autograd's engine runs the
    backward on a worker thread of its own on the card, and a layer that
    ``torch.utils.checkpoint`` recomputes there is not forward work."""
    if (getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
            and torch._C._current_graph_task_id() == -1):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (view it in Perfetto or
    chrome://tracing), written to ``log_dir/trace.json``; yields the
    profiler, whose ``key_averages()`` sum the kernels by name. The
    program's spans appear in it as ``user_annotation`` events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
