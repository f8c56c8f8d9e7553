"""Load drive of the HTTP search daemon: a synthetic corpus encoded into a
``SemanticSearchPipeline`` behind ``SearchServer`` with a cross-encoder
``RankingPipeline``, then concurrent clients over HTTP:

  A  /search, 1 query a request, 32 clients (through the micro-batcher)
  B  /search, 16 queries a request, 8 clients
  C  /search, 256 queries a request, 4 clients
  D  /rerank, 256 queries a request, retrieve_k 100, top 10, 2 clients
  E  /rerank as D with 1 client (only when asked)

Each phase prints one JSON line: queries/s, requests, errors, the clients'
p50 / p95 request latency, and the server's ``/metrics`` after it. An
untimed round of requests of 1, 2, 4, … queries opens each phase.

    python -m text_similarity_tpu_torch.drives.serve_load [--n-docs 1000000] \\
        [--duration 20] [--phases ABCD] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.client import HTTPConnection
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import ARCH_PRESETS
from ..core.precision import precision_for
from ..data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from ..models import SentenceEncoder, init_params
from ..models.cross_encoder import CrossEncoder
from ..pipelines import RankingPipeline, SearchServer, SemanticSearchPipeline

HOST = "127.0.0.1"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_texts(n: int, rng: np.random.Generator, n_words: int = 4000) -> List[str]:
    """Synthetic sentences of STS-like lengths (median about 10 words)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = np.array(["".join(rng.choice(letters, rng.integers(3, 9))) for _ in range(n_words)])
    lens = np.clip(np.round(np.exp(rng.normal(2.3, 0.4, n))), 4, 24).astype(int)
    flat = rng.integers(0, n_words, int(lens.sum()))
    texts, off = [], 0
    for length in lens:
        texts.append(" ".join(words[flat[off:off + length]]))
        off += length
    return texts


def http_json(port: int, method: str, path: str, payload=None, timeout: float = 600.0):
    """One request → (seconds, status, decoded JSON body)."""
    conn = HTTPConnection(HOST, port, timeout=timeout)
    try:
        t0 = time.monotonic()
        if payload is None:
            conn.request(method, path)
        else:
            conn.request(method, path, json.dumps(payload), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return time.monotonic() - t0, resp.status, json.loads(data)
    finally:
        conn.close()


def _percentile(sorted_ms: np.ndarray, q: float) -> float:
    """The nearest-rank percentile of sorted values."""
    rank = min(len(sorted_ms) - 1, max(0, int(np.ceil(len(sorted_ms) * q)) - 1))
    return float(sorted_ms[rank])


def load_phase(name: str, port: int, path: str, queries: Sequence[str], batch: int,
               n_threads: int, k: int, duration: float) -> dict:
    """``n_threads`` clients send ``batch``-query requests for ``duration``
    seconds → the phase's row. Every request that is not answered 200
    counts as an error."""
    for w, wb in enumerate(sorted({b for b in (1, 2, 4, 8, 16, 32, batch) if b <= batch})):
        warm = [queries[(w * wb + t) % len(queries)] for t in range(wb)]
        _, status, body = http_json(port, "POST", path, {"queries": warm, "k": k})
        if status != 200:
            raise RuntimeError(f"{path} warm request -> {status}: {body}")
    stop = time.monotonic() + duration
    lat: List[float] = []
    counts = {"queries": 0, "errors": 0}
    lock = threading.Lock()
    idx = np.random.default_rng(1234).integers(0, len(queries), 65536)

    def worker(wid: int) -> None:
        j = wid * 131
        while time.monotonic() < stop:
            qs = [queries[idx[(j + t) % len(idx)]] for t in range(batch)]
            j += batch
            try:
                dt, status, _ = http_json(port, "POST", path, {"queries": qs, "k": k})
                ok = status == 200
            except (OSError, ValueError):
                ok = False
            with lock:
                if ok:
                    lat.append(dt)
                    counts["queries"] += batch
                else:
                    counts["errors"] += 1

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    _, _, metrics = http_json(port, "GET", "/metrics")
    return {
        "phase": name, "path": path, "batch": batch, "clients": n_threads,
        "requests": len(lat), "errors": counts["errors"], "seconds": wall,
        "queries_per_s": counts["queries"] / wall,
        "p50_ms": _percentile(lat_ms, 0.50) if len(lat) else None,
        "p95_ms": _percentile(lat_ms, 0.95) if len(lat) else None,
        "metrics": metrics,
    }


def run_phases(pipe, reranker, queries: Sequence[str], duration: float, phases: str = "ABCD",
               rerank_factor: float = 3.0, emit: Optional[Callable[[dict], None]] = None) -> List[dict]:
    """The daemon over ``pipe`` (and ``reranker``, which serves /rerank) on
    127.0.0.1, a free port; the phases in ``phases``, the rerank ones
    ``rerank_factor`` × ``duration`` long → their rows, each also emitted."""
    emit = emit or (lambda row: print(json.dumps(row), flush=True))
    rk = getattr(reranker, "retrieve_k", 0)
    plan = {
        "A": ("A_search_b1_microbatch", "/search", 1, 32, duration),
        "B": ("B_search_b16", "/search", 16, 8, duration),
        "C": ("C_search_b256", "/search", 256, 4, duration),
        "D": (f"D_rerank_b256_k{rk}", "/rerank", 256, 2, duration * rerank_factor),
        "E": ("E_rerank_b256_1client", "/rerank", 256, 1, duration * rerank_factor),
    }
    server = SearchServer(pipe, host=HOST, port=0, batch_window=0.005, reranker=reranker)
    server.start_background()
    rows = []
    try:
        for key in phases:
            name, path, batch, clients, dur = plan[key]
            row = load_phase(name, server.port, path, queries, batch, clients, 10, dur)
            emit(row)
            rows.append(row)
    finally:
        server.shutdown()
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m text_similarity_tpu_torch.drives.serve_load",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=1_000_000)
    ap.add_argument("--duration", type=float, default=20.0, help="seconds a search phase")
    ap.add_argument("--rerank-factor", type=float, default=3.0,
                    help="a rerank phase lasts this many times --duration")
    ap.add_argument("--phases", default="ABCD")
    ap.add_argument("--arch", default="minilm-l6")
    ap.add_argument("--retrieve-k", type=int, default=100,
                    help="candidates retrieved per query before reranking")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> List[dict]:
    args = build_parser().parse_args(argv)
    rng = np.random.default_rng(0)
    t0 = time.time()
    texts = make_texts(args.n_docs, rng)
    log(f"synthetic corpus: {args.n_docs} docs in {time.time() - t0:.1f}s")
    tok = WordPieceTokenizer(train_wordpiece_vocab(texts[:20000], vocab_size=8000, min_freq=1))
    arch = ARCH_PRESETS[args.arch].replace(vocab_size=tok.vocab_size)
    precision = precision_for(not args.fp32)
    enc = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                          tokenizer=tok, precision=precision, device=args.device)
    pipe = SemanticSearchPipeline(enc, batch_size=1024, device=args.device)
    t0 = time.time()
    pipe.add_documents(texts)
    log(f"encode + store {args.n_docs} docs: {time.time() - t0:.1f}s")
    t0 = time.time()
    pipe(["warm trigger"], max_num_results=10)    # builds the IVF index from 100k docs
    pipe.warmup(ks=(10,), max_queries=256)
    log(f"first query and warm-up: {time.time() - t0:.1f}s")
    ce = CrossEncoder.init(torch.Generator().manual_seed(1), arch, tokenizer=tok,
                           num_classes=1, precision=precision, device=args.device)
    reranker = RankingPipeline(pipe, ce, retrieve_k=args.retrieve_k, batch_size=512)
    reranker(["warm trigger rerank"], top_k=10)
    rows = run_phases(pipe, reranker, texts[:65536], args.duration, args.phases,
                      rerank_factor=args.rerank_factor)
    if any(r["errors"] or not r["requests"] for r in rows):
        raise SystemExit("serve_load: a phase had failed or no requests")
    return rows


if __name__ == "__main__":
    main()
