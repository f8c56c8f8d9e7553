"""The general drivers, one a traffic ``kind``. A driver reads every size
from its configuration and traffic files; a cell is a (configuration,
traffic) pair of files, never code.

A driver's life in a run: ``setup()`` (inputs and weights from the seed,
the program built and every shape of the traffic warmed), ``window(s)``
(the measured closed loop), ``traced()`` (a short stretch under the
profiler, with named ranges around the calls into each layer),
``layer_ctx(...)`` (what the per-layer readers read), ``free()`` (the
program's state dropped), then ``check()`` (the answers judged against
the plain reference)."""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np


class Window:
    """A closed loop's record: per unit its latency and its work."""

    def __init__(self):
        self.latencies: List[float] = []
        self.work: List[float] = []
        self.tags: List[int] = []
        self.wall_s = 0.0

    @property
    def units(self) -> int:
        return len(self.latencies)

    def rate(self) -> float:
        return float(np.sum(self.work)) / self.wall_s

    def p95_ms(self) -> float:
        return float(np.percentile(np.asarray(self.latencies), 95)) * 1e3


def closed_loop(seconds: float, step: Callable[[int], float], sync: Callable[[], None]) -> Window:
    """Call ``step(i) → work`` back to back until ``seconds`` have passed
    (each call ends with its answers on the host, or ``sync``); the window
    runs from the first call's start to the last call's end."""
    win = Window()
    sync()
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        work = step(i)
        sync()
        t1 = time.perf_counter()
        win.latencies.append(t1 - t0)
        win.work.append(work)
        win.tags.append(i)
        i += 1
        if t1 - t_start >= seconds:
            break
    win.wall_s = t1 - t_start
    return win


def scan_work(ivf, calls, union_factor: int, block_q: int) -> list:
    """(bytes, operations) of each recorded IVF call ``(queries, k)``: its
    probe plan by the index's rule (``flops.plan_probes``), then
    ``flops.ivf_scan`` over the probed slabs' valid rows."""
    from .. import flops

    n_slabs = ivf.num_base_clusters // ivf.group
    union = flops.union_size(min(ivf.config.num_probes, n_slabs), union_factor, n_slabs)
    valid = (ivf.ids_padded >= 0).sum(dim=1)
    row = ivf.data_padded.shape[-1] * ivf.data_padded.element_size() + (
        4 if ivf.scales_padded is not None else 0)
    out = []
    for q, k in calls:
        bq = min(block_q, q.shape[0])
        pr = flops.plan_probes(q, ivf.centroids, ivf.num_base_clusters,
                               ivf.data_padded.shape[0] * ivf.group, bq, union)
        out.append(flops.ivf_scan(pr, valid, ivf.data_padded.shape[1], q.shape[1], row,
                                  q.shape[0], k, bq))
    return out


# K1's kernels: the wgmma tile and the merge of its partial top-k
SCAN_KERNELS = ("ivf_tile_kernel", "merge_partials")

# two reference scores closer than this are a tie: a sound scan's score
# lies within 1e-6 of the exact dot of its bf16 operands
TIE = 1e-5


def index_layout(ivf) -> dict:
    """What the selection check reads of a built index, copied before the
    program is dropped: its centroids and its slab id map (−1 an empty
    slot). The check follows the program's clustering; it does not redo
    k-means."""
    if ivf.group != 1:
        raise ValueError("the selection check reads one cluster a slab")
    return {"centroids": ivf.centroids.detach().clone(),
            "ids": ivf.ids_padded.detach().clone(), "num_base": int(ivf.num_base_clusters)}


def probed_slabs(layout: dict, queries, traffic: dict):
    """Each query's probed slabs by the traffic's stated plan (its
    ``probes``, ``union_factor`` and ``block_q``) and the benchmark's copy
    of the planning rule → (B, U) slab ids."""
    from .. import flops

    n_base = layout["num_base"]
    union = flops.union_size(min(traffic["probes"], n_base), traffic["union_factor"], n_base)
    return flops.probes_per_query(queries, layout["centroids"], n_base, layout["ids"].shape[0],
                                  min(traffic["block_q"], queries.shape[0]), union)


def selection_misses(got_ids, slabs, layout: dict, rows, q_unit, k: int) -> int:
    """Returned ids that are not among the exact top-k of the rows in the
    query's probed slabs: outside those slabs, or scored below the k-th
    best of them by more than a tie. The scores are the f64 dots of the
    query and the rows, both rounded to bf16, as the index states."""
    import torch

    cand = layout["ids"][slabs.to(layout["ids"].device)].reshape(-1)
    cand = cand[cand >= 0].long()
    if cand.numel() == 0:
        return len(got_ids)
    ref = (bf16_round(rows[cand.to(rows.device)]) @ bf16_round(q_unit.to(rows.device))).cpu()
    kth = float(torch.topk(ref, min(k, ref.numel())).values[-1])
    score = dict(zip(cand.cpu().tolist(), ref.tolist()))
    return sum(1 for i in np.asarray(got_ids).tolist()
               if i not in score or score[i] < kth - TIE)


FAULTS = ("half_probes", "wrong_merge")


def with_fault(variant, inner: Callable, probes: int) -> Callable:
    """``IVFIndex.query`` with a planted fault, for calibration and the
    tests: ``half_probes`` scans half the stated probes; ``wrong_merge``
    keeps the ranks 2 to k + 1 of the merge in place of 1 to k. Both give
    rows of the right form with scores true to their ids. Any other
    variant leaves the query as it is."""
    if variant == "half_probes":
        return lambda q, **kw: inner(q, **{**kw, "probes": max(probes // 2, 1)})
    if variant == "wrong_merge":
        def drop_best(q, **kw):
            s, i = inner(q, **{**kw, "k": kw.get("k", 10) + 1})
            return s[:, 1:].contiguous(), i[:, 1:].contiguous()
        return drop_best
    return inner


def cuda_sync(device) -> Callable[[], None]:
    import torch

    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def keep_sample(seed: int, i: int, every: int) -> bool:
    """Whether request ``i``'s answers are kept for the check: the first,
    and one in ``every`` after it, the offset drawn by the seed."""
    return i == 0 or (i + seed) % every == 0


def order_gaps(ids: np.ndarray, scores: np.ndarray, k: int, n_rows: int) -> int:
    """Rows that are no answer: fewer than k results, an id outside the
    corpus or twice, or scores that rise."""
    bad = 0
    for r_i, r_s in zip(ids, scores):
        if (len(r_i) < k or np.any(r_i < 0) or np.any(r_i >= n_rows)
                or len(set(r_i.tolist())) != len(r_i)
                or np.any(np.diff(np.asarray(r_s, np.float64)) > 0)
                or not np.all(np.isfinite(r_s))):
            bad += 1
    return bad


def bf16_round(x):
    """x rounded to bf16 (to nearest even), held in f64 for an exact sum."""
    import torch

    return x.to(torch.bfloat16).to(torch.float64)


def unit_rows(x):
    """Rows scaled to unit length in f32, the cosine index's query rule
    (x / max(√Σx², 1e-12)); taken over a whole request, as the index
    takes it, so that every row rounds as the index's does."""
    import torch

    x = x.float()
    return x / torch.sqrt(torch.sum(x.square(), dim=-1, keepdim=True)).clamp_min(1e-12)
