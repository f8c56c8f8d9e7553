"""Churn drive for the live IVF index: add and remove on a built index at
1M × 384 (bench.py's corpus recipe), against a fresh build and a rebuild.

Phases, one JSON line each:
  fresh       build s, query rate of every timed window and their median,
              recall@10 against the exact top-10 (K2)
  remove      10% of the rows by id (``IVFIndex.remove``): seconds, rows/s
  add         the same count of new rows at two batchings (1 × 100k and
              10 × 10k), each on a copy loaded from a saved snapshot and
              cleared of the removed ids: seconds, rows/s
  post_churn  the 1 × 100k copy: query rates and recall@10 against the
              exact top-10 over the live rows (K2)
  tombstone_leak_check  removed ids among the recall queries' answers
  readd_self_check      each added row queried alone with itself (block_q
              1): found in its top 10, and first
  rebuild     a fresh build over the live rows: build s, rates, recall

The queries run with the serving args (block_q 64, union_factor 1, the
deferred merge at 1M). Every timed window is printed; no window is
re-timed or dropped.

    python -m text_similarity_tpu_torch.drives.churn [--n 1000000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.precision import resolve_device
from ..index.ivf import IVFIndex
from ..ops.topk import cosine_topk, l2_normalize

N_CENTERS = 4096
K = 10
N_RECALL = 256        # queries held to the exact top-k
CHURN_FRAC = 0.10     # rows removed, then as many added


def _centers(d: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(N_CENTERS, d, generator=g, device=device)


def _rows(centers: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    """n rows of the recipe: a centre ×3 + unit noise, normalized."""
    d, dev = centers.shape[1], centers.device
    assign = torch.randint(0, N_CENTERS, (n,), generator=g, device=dev)
    out = torch.empty((n, d), device=dev)
    for i in range(0, n, 1 << 18):
        j = min(i + (1 << 18), n)
        out[i:j] = l2_normalize(centers[assign[i:j]] * 3.0
                                + torch.randn(j - i, d, generator=g, device=dev))
    return out


def bench_corpus(n: int, n_q: int, d: int = 384, seed: int = 0, device="cuda"):
    """bench.py's recipe: 4096 gaussian centres ×3 + unit noise, normalized;
    queries are the first rows + 0.1 noise → (corpus (n, d), queries (n_q,
    d)), f32 on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(N_CENTERS, d, generator=g, device=dev)
    corpus = _rows(centers, n, g)
    queries = l2_normalize(corpus[:n_q] + 0.1 * torch.randn(n_q, d, generator=g, device=dev))
    return corpus, queries


def new_rows(n: int, d: int = 384, seed: int = 0, device="cuda") -> torch.Tensor:
    """n further rows from the centres of ``bench_corpus(..., seed)``."""
    dev = resolve_device(device)
    return _rows(_centers(d, seed, dev), n, torch.Generator(device=dev).manual_seed(seed + 99))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Churn:
    """The drive over given data: ``run`` emits each phase's row through
    ``emit`` and returns the rows by phase."""

    def __init__(self, corpus, queries, added, *, windows: int = 5, iters: int = 5,
                 snapshot_dir: Optional[str] = None, seed: int = 0,
                 emit: Callable[[dict], None] = None):
        self.corpus, self.queries, self.added = corpus, queries, added
        self.dev = corpus.device
        self.n = corpus.shape[0]
        self.k, self.n_recall = K, min(N_RECALL, queries.shape[0])
        self.windows, self.iters = windows, iters
        self.snapshot_dir, self.seed = snapshot_dir, seed
        self.emit = emit or (lambda row: print(json.dumps(row), flush=True))
        big = self.n >= 500_000
        self.qargs = dict(block_q=64, union_factor=1, approx_width=2048 if big else 0)
        # bench.py's index at 1M; the config's own sizing below that
        self.cfg = (IndexConfig(num_clusters=2048, num_probes=56, kmeans_iters=8) if big
                    else IndexConfig.auto(self.n))
        self.rows: Dict[str, dict] = {}

    def _out(self, row: dict) -> None:
        self.rows[row["phase"] + (f"_{row['batching']}" if "batching" in row else "")] = row
        self.emit(row)

    def build(self, data) -> tuple:
        _sync(self.dev)
        t0 = time.time()
        ivf = IVFIndex.build(data, self.cfg, data_dtype=torch.bfloat16, device=self.dev,
                             generator=torch.Generator(device=self.dev).manual_seed(7))
        _sync(self.dev)
        return ivf, time.time() - t0

    def oracle(self, data, ids: np.ndarray) -> List[set]:
        """The exact top-k of the recall queries over ``data`` (K2 on the
        card), as sets of ``ids``."""
        _, oi = cosine_topk(self.queries[: self.n_recall], data, k=self.k)
        return [set(row.tolist()) for row in ids[oi.cpu().numpy()]]

    def rate_recall(self, ivf, oracle: List[set]) -> dict:
        """Recall@k of one untimed call (which also warms), then ``windows``
        timed windows of ``iters`` calls over every query."""
        _, i = ivf.query(self.queries, k=self.k, **self.qargs)
        i = i.cpu().numpy()
        recall = float(np.mean([len(set(i[r].tolist()) & oracle[r]) / self.k
                                for r in range(self.n_recall)]))
        rates = []
        for _ in range(self.windows):
            _sync(self.dev)
            t0 = time.time()
            for _ in range(self.iters):
                ivf.query(self.queries, k=self.k, **self.qargs)
            _sync(self.dev)
            rates.append(self.queries.shape[0] * self.iters / (time.time() - t0))
        return {"qps_windows": rates, "qps_median": statistics.median(rates),
                "recall_at_10": recall}

    def run(self) -> Dict[str, dict]:
        n, added = self.n, self.added
        n_churn = added.shape[0]
        remove_ids = np.sort(np.random.default_rng(self.seed + 3).choice(
            n, size=n_churn, replace=False))

        ivf, build_s = self.build(self.corpus)
        fresh = self.rate_recall(ivf, self.oracle(self.corpus, np.arange(n)))
        self._out({"phase": "fresh", "rows": n, "build_seconds": build_s,
                   "clusters": ivf.num_base_clusters, "overflow": ivf.num_overflow, **fresh})

        with tempfile.TemporaryDirectory(dir=self.snapshot_dir) as tmp:
            snap = os.path.join(tmp, "churn_snapshot.npz")
            t0 = time.time()
            ivf.save(snap)
            save_s = time.time() - t0

            _sync(self.dev)
            t0 = time.time()
            n_removed = ivf.remove(remove_ids)
            _sync(self.dev)
            dt = time.time() - t0
            if n_removed != n_churn:
                raise AssertionError(f"removed {n_removed} of {n_churn} ids")
            self._out({"phase": "remove", "rows": n_churn, "seconds": dt,
                       "rows_per_s": n_churn / dt, "snapshot_save_seconds": save_s})
            del ivf

            churned = None
            chunk10 = max(1, n_churn // 10)
            for tag, chunk in ((f"1x{n_churn}", n_churn), (f"10x{chunk10}", chunk10)):
                t0 = time.time()
                inst = IVFIndex.load(snap, device=self.dev)
                inst.remove(remove_ids)
                _sync(self.dev)
                load_s = time.time() - t0
                t0 = time.time()
                for st in range(0, n_churn, chunk):
                    inst.add(added[st:st + chunk], start_id=n + st)
                _sync(self.dev)
                dt = time.time() - t0
                self._out({"phase": "add", "batching": tag, "rows": n_churn, "seconds": dt,
                           "rows_per_s": n_churn / dt, "snapshot_load_seconds": load_s})
                if churned is None:
                    churned = inst       # the 1 × n_churn copy: the quality checks
                del inst

        keep = np.ones(n, bool)
        keep[remove_ids] = False
        keep_idx = np.nonzero(keep)[0]
        live = torch.cat([self.corpus[torch.as_tensor(keep_idx, device=self.dev)], added])
        live_ids = np.concatenate([keep_idx, n + np.arange(n_churn)])
        post = self.rate_recall(churned, self.oracle(live, live_ids))
        self._out({"phase": "post_churn", **post,
                   "recall_drop_vs_fresh": fresh["recall_at_10"] - post["recall_at_10"]})

        _, i = churned.query(self.queries[: self.n_recall], k=self.k, **self.qargs)
        leaked = int(np.isin(i.cpu().numpy(), remove_ids).sum())
        self._out({"phase": "tombstone_leak_check", "leaked": leaked})

        # each added row queried alone (block_q 1: its own probe list), so a
        # miss means add() put the row where its own probes do not reach
        _, i = churned.query(added, k=self.k, **dict(self.qargs, block_q=1))
        i = i.cpu().numpy()
        own = (n + np.arange(n_churn))[:, None]
        self._out({"phase": "readd_self_check", "rows": n_churn,
                   "found_top10": int((i == own).any(axis=1).sum()),
                   "found_first": int((i[:, 0] == own[:, 0]).sum())})
        del churned

        rebuilt, build_s = self.build(live)
        # the rebuilt index numbers the live rows 0 … N−1
        re = self.rate_recall(rebuilt, self.oracle(live, np.arange(live.shape[0])))
        self._out({"phase": "rebuild", "build_seconds": build_s, **re})
        return self.rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m text_similarity_tpu_torch.drives.churn",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="corpus rows")
    ap.add_argument("--d", type=int, default=384, help="row width")
    ap.add_argument("--queries", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot-dir", default=None,
                    help="where the index snapshot goes (default: the temp dir); deleted after")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> Dict[str, dict]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    corpus, queries = bench_corpus(args.n, args.queries, args.d, args.seed, dev)
    added = new_rows(int(args.n * CHURN_FRAC), args.d, args.seed, dev)
    return Churn(corpus, queries, added, snapshot_dir=args.snapshot_dir, seed=args.seed).run()


if __name__ == "__main__":
    main()
