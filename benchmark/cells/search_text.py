"""Text search through ``SemanticSearchPipeline``: a corpus of synthetic
documents encoded at set-up through ``add_documents`` into the store and an
IVF index, then a closed loop of one caller sending ``pipe(queries,
max_num_results=k)`` with a batch of query texts each time (tokenize →
encode → IVF plan, scan, merge → result rows on the host).

The check: a sample of the answered queries drawn by the seed, judged
stage by stage. The encoder: the reference encodes each sampled query and
each returned document from its text (its own WordPiece and f32 encoder,
weights made again from the seed); ``emb_gap`` is the widest 1 − cosine
between the program's vector (the query's as the pipeline handed it to the
index, the document's as the store holds it) and the reference's. The scan
and merge (following the program from its own vectors, as the stage after
the encoder): ``scan_gap`` is the widest gap between a returned score and
the dot product, accumulated in f64, of the two vectors rounded to bf16,
the precision the index states for its slabs and its queries (the query
first scaled to unit length over its whole request, as the index does);
``bad_rows`` counts rows that are no answer (fewer than k, an id twice or
outside the corpus, scores that rise, a query without a row);
``sel_miss`` is the share of returned ids that are not among the exact
top-k of the rows in the query's probed slabs, by the traffic's stated
plan (``clusters``, ``probes``, ``union_factor``, ``block_q``) and the
benchmark's copy of the planning rule, over the program's centroids and
slabs (the check follows the program's clustering; it does not redo
k-means).

Variant ``int8`` (the control): the program's int8 serving path, the int8
encoder (``to_int8``) and int8 IVF slabs with their bf16 rescore. The
variants ``half_probes`` and ``wrong_merge`` plant a fault in the index's
query (``cells.with_fault``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import flops, gen, trace, weights
from . import (SCAN_KERNELS, Window, bf16_round, closed_loop, cuda_sync, index_layout,
               keep_sample, order_gaps, probed_slabs, scan_work, selection_misses, unit_rows,
               with_fault)


class Cell:
    unit = "request"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda", variant=None):
        self.cfg, self.t, self.seed, self.device = cfg, traffic, int(seed), torch.device(device)
        self.variant = variant
        self.fields = weights.arch_fields(cfg)
        self.sync = cuda_sync(self.device)
        self.kept = {}
        self.ivf_calls = []
        self._record = False

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from text_similarity_tpu_torch.core.config import EncoderArch, IndexConfig
        from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer
        from text_similarity_tpu_torch.models import SentenceEncoder
        from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline

        t = self.t
        corpus = gen.sentence_texts(t["corpus_docs"], *t["doc_words"], gen.rng_for(self.seed, 1))
        self.corpus = corpus.all()
        qrng = gen.rng_for(self.seed, 2)
        pool = [gen.sentence_texts(t["queries_per_request"], *t["query_words"], qrng)
                for _ in range(t["request_pool"])]
        self.pool_texts = [p.all() for p in pool]
        self.pool_tokens = [p.tokens() for p in pool]
        self.order = gen.rng_for(self.seed, 3).permutation(t["request_pool"])

        tok = WordPieceTokenizer.from_vocab_file(gen.VOCAB)
        arch = EncoderArch(**self.fields)
        params = weights.make_params(self.fields, gen.torch_seed(self.seed, 0), self.device)
        enc = SentenceEncoder(params, arch, tokenizer=tok, device=self.device)
        index_cfg = IndexConfig(num_clusters=t["clusters"], num_probes=t["probes"],
                                kmeans_iters=t["kmeans_iters"])
        if self.variant == "int8":
            enc = enc.to_int8()
            index_cfg = dataclasses.replace(index_cfg, quantize_int8=True)
        self.pipe = SemanticSearchPipeline(enc, index_config=index_cfg, use_ivf=t["use_ivf"],
                                           batch_size=t["encode_batch"], device=self.device)
        self.pipe.add_documents(self.corpus)
        self._wrap_index_query()
        for texts in self.pool_texts:            # warms every request
            self.pipe(texts, max_num_results=t["k"])
        self.sync()

    def _wrap_index_query(self) -> None:
        self.pipe(self.pool_texts[0][:1], max_num_results=self.t["k"])   # builds the index
        ivf = self.pipe.ivf
        inner = with_fault(self.variant, ivf.query, self.t["probes"])

        def query(q, *a, **kw):
            self.last_q = q
            if self._record:
                self.ivf_calls.append((q.detach().clone(), kw.get("k", a[0] if a else 10)))
            with trace.span("ivf.query"):
                return inner(q, *a, **kw)

        ivf.query = query
        enc = self.pipe.encoder
        enc_inner = enc.encode

        def encode(*a, **kw):
            with trace.span("encoder.encode"):
                return enc_inner(*a, **kw)

        enc.encode = encode

    # -- the window -----------------------------------------------------
    def _request(self, i: int) -> float:
        b = int(self.order[i % len(self.order)])
        rows = self.pipe(self.pool_texts[b], max_num_results=self.t["k"])
        if keep_sample(self.seed, i, self.t["keep_every"]):
            self.kept[i] = (b, rows, self.last_q)
        return float(len(rows))

    def window(self, seconds: float) -> Window:
        win = closed_loop(seconds, self._request, self.sync)
        self.window_pool = [int(self.order[i % len(self.order)]) for i in win.tags]
        return win

    def traced(self) -> int:
        self._record = True
        n = self.t["trace_requests"]
        for i in range(n):
            with trace.span("pipeline.__call__"):
                self.pipe(self.pool_texts[int(self.order[i % len(self.order)])],
                          max_num_results=self.t["k"])
        self._record = False
        return n

    # -- what the readers read -----------------------------------------
    def e2e(self, win: Window) -> dict:
        return {"search_qps": win.rate()}

    def layer_ctx(self, win: Window, reading) -> dict:
        f = self.fields
        non_emb = weights.non_embedding_params(f)
        enc_flops = [flops.encoder_flops(non_emb, toks, f["num_layers"], f["hidden_size"])
                     for toks in self.pool_tokens]
        scans = scan_work(self.pipe.ivf, self.ivf_calls, self.t["union_factor"],
                          self.t["block_q"])
        scan_ops = np.mean([ops for _, ops in scans]) if scans else 0.0
        useful = sum(enc_flops[b] for b in self.window_pool) + scan_ops * win.units
        return {"window": win, "reading": reading, "useful_flops": useful,
                "scan_work": scans, "scan_kernels": SCAN_KERNELS}

    def free(self) -> None:
        """Draws the sample and copies out what the check reads of the
        program (the sampled queries' vectors and the returned documents'
        stored vectors), then drops the program."""
        rng = gen.rng_for(self.seed, 4)
        reqs = sorted(self.kept)
        store = self.pipe.store.view
        self.layout = index_layout(self.pipe.ivf)
        self.store = store.detach()
        slabs = {}
        self.bad = sum(len(rows) != len(self.pool_texts[b]) for b, rows, _ in self.kept.values())
        self.picks = []
        for _ in range(self.t["check_queries"]):
            req = reqs[int(rng.integers(len(reqs)))]
            b, rows, q = self.kept[req]
            j = int(rng.integers(len(rows)))
            if req not in slabs:
                slabs[req] = probed_slabs(self.layout, q, self.t)
            ids = np.asarray([r[2] for r in rows[j]], np.int64)
            live = torch.as_tensor(ids[(ids >= 0) & (ids < store.shape[0])], device=store.device)
            self.picks.append({"text": self.pool_texts[b][j], "ids": ids,
                               "scores": np.asarray([r[1] for r in rows[j]], np.float64),
                               "q": q[j].float().cpu(), "q_unit": unit_rows(q)[j].cpu(),
                               "docs": store[live].float().cpu(), "slabs": slabs[req][j]})
        self.pipe = self.kept = None

    # -- the check ------------------------------------------------------
    def check(self) -> dict:
        from ..reference import encoder as E

        E.no_tf32()
        picks, k, n = self.picks, self.t["k"], len(self.corpus)
        bad = self.bad + order_gaps([p["ids"] for p in picks], [p["scores"] for p in picks], k, n)
        scan_gap, miss = 0.0, 0
        for p in picks:
            miss += selection_misses(p["ids"], p["slabs"], self.layout, self.store, p["q_unit"], k)
            live = (p["ids"] >= 0) & (p["ids"] < n)
            ref = (bf16_round(p["docs"]) @ bf16_round(p["q_unit"])).numpy()
            if ref.size:
                scan_gap = max(scan_gap, float(np.max(np.abs(p["scores"][live] - ref))))
        tok = gen.tokenizer()
        p_ref = weights.make_params(self.fields, gen.torch_seed(self.seed, 0), self.device)
        doc_ids = [int(x) for p in picks for x in p["ids"] if 0 <= x < n]
        texts = [p["text"] for p in picks] + [self.corpus[x] for x in doc_ids]
        ids, mask = tok.batch(texts, self.t["max_len"])
        ref = E.embed_rows(p_ref, self.fields, torch.as_tensor(ids, device=self.device),
                           torch.as_tensor(mask, device=self.device), batch=256).cpu()
        got = torch.cat([torch.stack([p["q"] for p in picks])] + [p["docs"] for p in picks])
        cos = (got * ref).sum(1) / got.norm(dim=1).clamp_min(1e-12)
        emb_gap = float((1.0 - cos).max()) if bool(torch.isfinite(cos).all()) else 2.0
        return {"emb_gap": emb_gap, "scan_gap": scan_gap, "bad_rows": float(bad),
                "sel_miss": miss / (k * len(picks))}
