"""Vector search through ``IVFIndex.query``: a corpus of ``bench.py``'s
recipe made on the device, an IVF index over it with bf16 slabs, then a
closed loop of one caller sending a batch of query vectors at a time with
the search pipeline's serving arguments; each answer's top-k ids and
scores are copied to the host.

The check: a sample of the answered queries drawn by the seed, judged
against the f32 corpus the benchmark made (made again from the seed):
``scan_gap``, the widest gap between a returned score and the dot
product, accumulated in f64, of the query and that row rounded to bf16
(the precision the index states for its slabs and queries; the query
first scaled to unit length over its whole request, as the index does);
``bad_rows``,
rows that are no answer; ``sel_miss``, the share of returned ids that are
not among the exact top-k of the rows in the query's probed slabs (by the
traffic's stated plan and the benchmark's copy of the planning rule, over
the program's centroids and slabs; the scores of the bf16-rounded query
and rows); and ``recall_miss``, 1 − recall@k against the exact f32 top-k
over the whole corpus, whose limit the traffic file states.

Variant ``int8`` (the control): int8 slabs without the bf16 rescore copy,
the program's int8 scan path. The variants ``half_probes`` and
``wrong_merge`` plant a fault in the index's query
(``cells.with_fault``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import gen, trace
from . import (SCAN_KERNELS, Window, bf16_round, closed_loop, cuda_sync, index_layout,
               keep_sample, order_gaps, probed_slabs, scan_work, selection_misses, unit_rows,
               with_fault)


class Cell:
    unit = "request"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda", variant=None):
        self.cfg, self.t, self.seed, self.device = cfg, traffic, int(seed), torch.device(device)
        self.variant = variant
        self.sync = cuda_sync(self.device)
        self.kept = {}
        self.ivf_calls = []
        self._record = False

    def _corpus(self):
        t = self.t
        centres = gen.vector_centres(t["centres"], t["dim"], self.seed, self.device)
        return gen.vector_rows(centres, t["corpus_rows"], t["centre_scale"], self.seed, 11)

    def setup(self) -> None:
        from text_similarity_tpu_torch.core.config import IndexConfig
        from text_similarity_tpu_torch.index import IVFIndex

        t = self.t
        corpus = self._corpus()
        self.pool = [gen.vector_queries(corpus, t["queries_per_request"], t["query_noise"],
                                        self.seed, 20 + r)[0] for r in range(t["request_pool"])]
        self.order = gen.rng_for(self.seed, 3).permutation(t["request_pool"])
        cfg = IndexConfig(num_clusters=t["clusters"], num_probes=t["probes"],
                          kmeans_iters=t["kmeans_iters"],
                          quantize_int8=self.variant == "int8")
        g = torch.Generator(device=self.device).manual_seed(gen.torch_seed(self.seed, 12))
        kw = {"keep_rescore": False} if self.variant == "int8" else {}
        self.ivf = IVFIndex.build(corpus, cfg, generator=g, data_dtype=torch.bfloat16,
                                  device=self.device, **kw)
        del corpus
        mc = self.ivf.data_padded.shape[1]
        self.qargs = dict(k=t["k"], block_q=t["block_q"], union_factor=t["union_factor"],
                          approx_width=t["approx_width"] if mc >= t["approx_min_mc"] else 0)
        inner = with_fault(self.variant, self.ivf.query, t["probes"])

        def query(q, **kw):
            if self._record:
                self.ivf_calls.append((q, kw["k"]))
            with trace.span("ivf.query"):
                return inner(q, **kw)

        self.ivf.query = query
        for q in self.pool:                      # warms every request
            self._ask(q)
        self.sync()

    def _ask(self, q):
        s, i = self.ivf.query(q, **self.qargs)
        return s.cpu().numpy(), i.cpu().numpy()

    def _request(self, i: int) -> float:
        b = int(self.order[i % len(self.order)])
        s, ids = self._ask(self.pool[b])
        if keep_sample(self.seed, i, self.t["keep_every"]):
            self.kept[i] = (b, s, ids)
        return float(s.shape[0])

    def window(self, seconds: float) -> Window:
        return closed_loop(seconds, self._request, self.sync)

    def traced(self) -> int:
        self._record = True
        n = self.t["trace_requests"]
        for i in range(n):
            self._ask(self.pool[int(self.order[i % len(self.order)])])
        self._record = False
        return n

    def e2e(self, win: Window) -> dict:
        return {"search_qps": win.rate()}

    def layer_ctx(self, win: Window, reading) -> dict:
        scans = scan_work(self.ivf, self.ivf_calls, self.t["union_factor"],
                          self.t["block_q"])
        scan_ops = np.mean([ops for _, ops in scans]) if scans else 0.0
        return {"window": win, "reading": reading, "useful_flops": scan_ops * win.units,
                "scan_work": scans, "scan_kernels": SCAN_KERNELS}

    def free(self) -> None:
        self.layout = index_layout(self.ivf)
        self.ivf = None

    def check(self) -> dict:
        from ..reference.encoder import no_tf32

        no_tf32()
        t = self.t
        rng = gen.rng_for(self.seed, 4)
        reqs = sorted(self.kept)
        bad = sum(s.shape[0] != self.pool[b].shape[0] for b, s, _ in self.kept.values())
        picks = []
        for _ in range(t["check_queries"]):
            b, s, ids = self.kept[reqs[int(rng.integers(len(reqs)))]]
            j = int(rng.integers(s.shape[0]))
            picks.append((b, j, ids[j].astype(np.int64), s[j].astype(np.float64)))
        bad += order_gaps([p[2] for p in picks], [p[3] for p in picks], t["k"], t["corpus_rows"])
        corpus = self._corpus()
        q = torch.stack([self.pool[b][j] for b, j, _, _ in picks])
        q_unit = torch.stack([unit_rows(self.pool[b])[j] for b, j, _, _ in picks])
        ids = torch.as_tensor(np.stack([np.clip(p[2], 0, t["corpus_rows"] - 1) for p in picks]),
                              device=self.device)
        ref = torch.einsum("qd,qkd->qk", bf16_round(q_unit), bf16_round(corpus[ids])).cpu().numpy()
        got = np.stack([p[3] for p in picks])
        gap = float(np.max(np.abs(got - ref)))
        slabs = {b: probed_slabs(self.layout, self.pool[b], t) for b in {p[0] for p in picks}}
        miss = sum(selection_misses(p[2], slabs[p[0]][p[1]], self.layout, corpus, q_unit[n], t["k"])
                   for n, p in enumerate(picks))
        hits = 0
        for st in range(0, q.shape[0], 64):
            exact = torch.topk(q[st:st + 64] @ corpus.T, t["k"], dim=1).indices.cpu().numpy()
            for e, p in zip(exact, picks[st:st + 64]):
                hits += len(set(e.tolist()) & set(p[2].tolist()))
        recall = hits / (t["k"] * len(picks))
        return {"scan_gap": gap, "bad_rows": float(bad), "sel_miss": miss / (t["k"] * len(picks)),
                "recall_miss": 1.0 - recall}
