"""HTTP serving daemon for the semantic-search pipeline (port of
``text_similarity_tpu.pipelines.serve``): JSON over the standard library's
``http.server``, one pipeline: a ``SemanticSearchPipeline`` on one device
or a ``ShardedSearchPipeline`` over a device mesh.

Endpoints (all JSON):

- ``GET  /health``   → ``{"status": "ok", "size": N, "ivf": bool, "sharded": bool}``
  (a sharded pipeline's size counts its live documents)
- ``POST /search``   ``{"queries": [...], "k": 10}`` →
  ``{"results": [[{"document", "score", "id"}, ...], ...]}``
- ``POST /rerank``   the same, re-scored by the cross-encoder (needs a
  ``reranker``)
- ``POST /encode``   ``{"texts": [...]}`` → ``{"embeddings": [[...]]}``
- ``POST /add``      ``{"texts": [...]}`` → ``{"ids": [...]}``
- ``POST /remove``   ``{"ids": [...]}`` → ``{"removed": n}``
- ``POST /save``     ``{"path": "..."}`` → ``{"saved": path}``
- ``GET  /metrics``  → per endpoint: requests, errors, p50 / p95 latency
  (ms) over the last 1024 requests

A malformed request (bad JSON, a missing key, an empty ``queries`` list)
is answered 400; any other failure 500, and the daemon keeps serving.
Handlers run one at a time under one lock. With ``batch_window > 0``
concurrent ``/search`` requests of one ``k`` are coalesced into one
pipeline call of at most ``max_batch`` queries.

Grad mode is per thread in PyTorch, so every handler and the batcher
thread run the pipeline under ``torch.no_grad()`` themselves.

Three faults of the reference are not copied: an empty ``queries`` list is
a 400 (it killed the reference's batcher thread), the batch's padding to a
power of two runs inside the batcher's error handling and never exceeds
the power of two at or above ``max_batch``, and (in ``cli.main``) the
rerank path is warmed whenever a reranker is configured.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger("serve")


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _queries(req: dict) -> List[str]:
    queries = req["queries"]
    if isinstance(queries, str):
        queries = [queries]
    if not isinstance(queries, list) or not queries:
        raise ValueError("queries must be a non-empty list of strings")
    return queries


class _MicroBatcher:
    """Coalesce concurrent /search requests into one pipeline call: take
    the first waiting request, linger ``window`` seconds for companions of
    the same ``k``, run one call over their queries (at most ``max_batch``
    unless one request alone is larger), padded to a power of two with
    repeats of the first query, and hand each request its rows."""

    def __init__(self, pipeline, lock, window: float, max_batch: int = 4096):
        self.pipeline = pipeline
        self.lock = lock           # the server's pipeline lock
        self.window = window
        self.max_batch = max_batch
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="micro-batcher")
        self._thread.start()

    def submit(self, queries: List[str], k: int):
        item = {"q": queries, "k": k, "ev": threading.Event(), "res": None, "err": None}
        with self._cv:
            if self._closed:
                raise RuntimeError("the micro-batcher is closed")
            self._queue.append(item)
            self._cv.notify()
        item["ev"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["res"]

    def close(self, timeout: float = 5.0) -> None:
        """Stop the batcher thread after the batch it is running."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout)

    def _take_batch(self) -> Optional[list]:
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return None
            first = self._queue.popleft()
        if self.window > 0:
            time.sleep(self.window)   # linger for companions
        batch, n = [first], len(first["q"])
        with self._cv:
            while (self._queue and self._queue[0]["k"] == first["k"]
                   and n + len(self._queue[0]["q"]) <= self.max_batch):
                n += len(self._queue[0]["q"])
                batch.append(self._queue.popleft())
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                all_q = [q for b in batch for q in b["q"]]
                n_real = len(all_q)
                # a power of two bounds the shapes a serving card sees; it
                # never exceeds next_pow2(max_batch) or cuts a request
                n_pad = max(n_real, min(_next_pow2(n_real), _next_pow2(self.max_batch)))
                all_q = all_q + [all_q[0]] * (n_pad - n_real)
                with self.lock, torch.no_grad():
                    results = self.pipeline(all_q, max_num_results=batch[0]["k"])
                off = 0
                for b in batch:
                    b["res"] = results[off:off + len(b["q"])]
                    off += len(b["q"])
            except Exception as e:  # every waiting request gets the error
                for b in batch:
                    b["err"] = e
            for b in batch:
                b["ev"].set()


class _EndpointStats:
    """Per-endpoint request and error counts and the latencies of the last
    1024 requests, for /metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: dict = {}
        self.errors: dict = {}
        self._lat: dict = {}

    def record(self, path: str, seconds: float, ok: bool) -> None:
        with self._lock:
            self.counts[path] = self.counts.get(path, 0) + 1
            if not ok:
                self.errors[path] = self.errors.get(path, 0) + 1
            self._lat.setdefault(path, deque(maxlen=1024)).append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for path, n in self.counts.items():
                lats = np.sort(np.asarray(self._lat[path])) * 1e3
                p50 = float(lats[len(lats) // 2])
                p95 = float(lats[max(0, int(np.ceil(len(lats) * 0.95)) - 1)])
                out[path] = {
                    "requests": int(n),
                    "errors": int(self.errors.get(path, 0)),
                    "latency_ms_p50": round(p50, 3),
                    "latency_ms_p95": round(p95, 3),
                }
            return out


class SearchServer:
    """Owns the pipeline, its lock, the optional micro-batcher and reranker,
    and the HTTP server."""

    def __init__(
        self,
        pipeline,
        host: str = "127.0.0.1",
        port: int = 8080,
        batch_window: float = 0.0,  # > 0: micro-batch concurrent /search
                                    # requests (seconds of linger)
        reranker=None,              # pipelines.rerank.RankingPipeline over
                                    # the same pipeline: serves /rerank
    ):
        self.pipeline = pipeline
        self.reranker = reranker
        self.stats = _EndpointStats()
        self.lock = threading.Lock()
        self.batcher = (
            _MicroBatcher(pipeline, self.lock, batch_window)
            if batch_window > 0 else None
        )
        handlers = {
            "/search": self._search, "/rerank": self._rerank, "/encode": self._encode,
            "/add": self._add, "/remove": self._remove, "/save": self._save,
        }
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self) -> Optional[dict]:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:   # a bad length or JSON
                    return None
                return req if isinstance(req, dict) else None

            def do_GET(self):  # noqa: N802
                if self.path == "/metrics":
                    return self._reply(200, server.stats.snapshot())
                if self.path != "/health":
                    return self._reply(404, {"error": "unknown endpoint"})
                with server.lock:
                    p = server.pipeline
                    if getattr(p, "store", None) is not None:
                        size = p.store.size
                    else:   # a sharded pipeline has no single-device store
                        size = getattr(p, "size", 0)
                    self._reply(200, {"status": "ok", "size": int(size),
                                      "ivf": p.ivf is not None, "sharded": hasattr(p, "mesh")})

            def do_POST(self):  # noqa: N802
                if self.path not in handlers:
                    # only known endpoints are recorded, so random paths
                    # cannot grow /metrics
                    return self._reply(404, {"error": "unknown endpoint"})
                # monotonic, so a clock step cannot poison the latencies
                t0 = time.monotonic()
                code, out = self._answer()
                # recorded before the reply is written: a client that holds
                # its answer and asks /metrics at once finds it counted
                server.stats.record(self.path, time.monotonic() - t0, code == 200)
                self._reply(code, out)

            def _answer(self):
                """(status, payload) of a known endpoint's request; every
                failure, reading the body included, becomes a status."""
                try:
                    req = self._read_json()
                    if req is None:
                        return 400, {"error": "invalid JSON body"}
                    if self.path == "/search" and server.batcher is not None:
                        # the batcher takes the pipeline lock itself
                        return 200, server._search_batched(req)
                    with server.lock, torch.no_grad():
                        return 200, handlers[self.path](req)
                except (KeyError, TypeError, ValueError) as e:
                    return 400, {"error": f"{type(e).__name__}: {e}"}
                except Exception as e:  # unexpected: 500, keep serving
                    logger.exception("request failed")
                    return 500, {"error": f"{type(e).__name__}: {e}"}

        class _Server(ThreadingHTTPServer):
            # the default listen backlog of 5 resets bursts of concurrent
            # connects before a handler runs; the device is the bottleneck,
            # not accept
            request_queue_size = 128
            daemon_threads = True

        self.httpd = _Server((host, port), Handler)
        self._serving = False

    # -- request handlers (under self.lock and no_grad) ---------------------

    @staticmethod
    def _format_results(results) -> dict:
        return {
            "results": [
                [{"document": doc, "score": score, "id": idx} for doc, score, idx in row]
                for row in results
            ]
        }

    def _search(self, req: dict) -> dict:
        return self._format_results(
            self.pipeline(_queries(req), max_num_results=int(req.get("k", 10)))
        )

    def _search_batched(self, req: dict) -> dict:
        return self._format_results(self.batcher.submit(_queries(req), int(req.get("k", 10))))

    def _rerank(self, req: dict) -> dict:
        if self.reranker is None:
            raise ValueError("server started without a reranker model")
        return self._format_results(self.reranker(_queries(req), top_k=int(req.get("k", 10))))

    def _encode(self, req: dict) -> dict:
        texts = req["texts"]
        if isinstance(texts, str):
            texts = [texts]
        emb = self.pipeline.encoder.encode(texts)
        return {"embeddings": np.asarray(emb, np.float32).tolist()}

    def _add(self, req: dict) -> dict:
        texts = req["texts"]
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            raise ValueError("texts must be a non-empty list of strings")
        return {"ids": np.asarray(self.pipeline.add_documents(texts)).tolist()}

    def _remove(self, req: dict) -> dict:
        return {"removed": int(self.pipeline.remove_documents([int(i) for i in req["ids"]]))}

    def _save(self, req: dict) -> dict:
        path = str(req["path"])
        self.pipeline.save(path)
        return {"saved": path}

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        logger.info("serving on %s:%d", *self.httpd.server_address[:2])
        self._serving = True
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        self._serving = True
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True, name="http")
        t.start()
        return t

    def shutdown(self) -> None:
        """Stop serving (``httpd.shutdown`` waits for a loop that was
        started), close the socket and stop the batcher."""
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self.batcher is not None:
            self.batcher.close()
