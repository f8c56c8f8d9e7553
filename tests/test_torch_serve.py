"""The port's HTTP daemon on the CPU: the JAX package's server tests
(health, search, encode, add, remove, save, metrics, errors, micro-batching,
rerank), /metrics counting every answered request, the three faults of the reference that the port does not copy, a
32-client stress run of the micro-batcher, the CLI's server builder and the
``serve`` entry point as a process, and one request answered alike by the
port's server and the JAX package's over the same saved pipeline.

Every server binds port 0 on 127.0.0.1, every HTTP call has a timeout and
every server shuts down in ``finally``."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.pipelines import SemanticSearchPipeline as JaxPipeline
from text_similarity_tpu.pipelines.serve import SearchServer as JaxSearchServer
from text_similarity_tpu_torch.cli.main import build_parser, build_server
from text_similarity_tpu_torch.core.config import ARCH_PRESETS
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, init_params
from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
from text_similarity_tpu_torch.pipelines import (
    RankingPipeline,
    SearchServer,
    SemanticSearchPipeline,
)
from text_similarity_tpu_torch.pipelines.serve import _MicroBatcher
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast dark fox leaped over a sleepy dog",
    "machine learning on tensor processing units",
    "neural networks accelerate matrix multiplication",
    "semantic similarity of short sentences",
    "the stock market fell sharply on tuesday",
    "investors worried about rising interest rates",
    "the cat sat on the mat",
    "a kitten rested on a rug",
    "tokyo is the capital of japan",
    "kyoto was the ancient capital of japan",
    "rain is expected across the region tomorrow",
] * 2  # duplicates make self-retrieval checks meaningful


@pytest.fixture(scope="module")
def encoder():
    tok = WordPieceTokenizer(train_wordpiece_vocab(CORPUS, vocab_size=512, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    params = init_params(arch, torch.Generator().manual_seed(0))
    return SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION, device="cpu")


@pytest.fixture(scope="module")
def cross_encoder(encoder):
    return CrossEncoder.init(torch.Generator().manual_seed(1), encoder.arch,
                             tokenizer=encoder.tokenizer, precision=FP32_PRECISION, device="cpu")


def _pipe(encoder, corpus=CORPUS):
    return SemanticSearchPipeline(encoder, corpus=corpus, use_ivf=False, device="cpu")


def _call(server, path, payload=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _http_error(server, path, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _call(server, path, payload, timeout=30)
    return ei.value.code, json.loads(ei.value.read())


def test_search_server_end_to_end(encoder, tmp_path):
    server = SearchServer(_pipe(encoder), port=0)
    server.start_background()
    try:
        h = _call(server, "/health")
        assert h == {"status": "ok", "size": len(CORPUS), "ivf": False, "sharded": False}
        top = _call(server, "/search", {"queries": [CORPUS[0]], "k": 3})["results"][0][0]
        assert top["document"] == CORPUS[0] and top["score"] == pytest.approx(1.0, abs=1e-3)
        emb = _call(server, "/encode", {"texts": [CORPUS[0], CORPUS[1]]})
        assert np.asarray(emb["embeddings"]).shape == (2, encoder.embedding_dim)
        added = _call(server, "/add", {"texts": ["a brand new document about boats"]})
        new_id = added["ids"][0]
        assert added["ids"] == [len(CORPUS)]
        res = _call(server, "/search", {"queries": "a brand new document about boats", "k": 1})
        assert res["results"][0][0]["id"] == new_id
        assert _call(server, "/remove", {"ids": [new_id]})["removed"] == 1
        res = _call(server, "/search", {"queries": "a brand new document about boats", "k": 1})
        assert not res["results"][0] or res["results"][0][0]["id"] != new_id
        _call(server, "/save", {"path": str(tmp_path / "served")})
        assert (tmp_path / "served" / "store.npz").exists()
        assert _http_error(server, "/search", {"nope": 1})[0] == 400
        assert _http_error(server, "/bogus", {})[0] == 404
        assert _http_error(server, "/add", {"texts": []})[0] == 400
    finally:
        server.shutdown()


def test_search_server_micro_batching(encoder):
    """Concurrent /search requests coalesce into one pipeline call; every
    client still gets its own rows; aggregates are powers of two."""
    pipe = _pipe(encoder)
    calls = []

    class Counting:
        server = None    # set after construction: the first call waits for
                         # the others to queue, so coalescing is certain

        def __call__(self, queries, max_num_results=10):
            if not calls and self.server is not None:
                deadline = time.time() + 10.0
                while len(self.server.batcher._queue) < 6 - len(queries) and time.time() < deadline:
                    time.sleep(0.005)
            calls.append(len(queries))
            return pipe(queries, max_num_results)

    counting = Counting()
    server = SearchServer(counting, port=0, batch_window=0.05)
    counting.server = server
    server.start_background()
    results = {}

    def one(i):
        results[i] = _call(server, "/search", {"queries": [CORPUS[i]], "k": 3})["results"][0]

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for i in range(6):
            assert results[i][0]["document"] == CORPUS[i], (i, results[i])
        assert len(calls) <= 2 and all(c & (c - 1) == 0 for c in calls) and sum(calls) >= 6
    finally:
        server.shutdown()


def test_search_server_internal_error_returns_500(encoder):
    class Flaky:
        def __init__(self):
            self.pipe = _pipe(encoder)
            self.store, self.ivf, self.encoder = self.pipe.store, None, encoder
            self.boom = True

        def __call__(self, queries, max_num_results=10):
            if self.boom:
                self.boom = False
                raise RuntimeError("synthetic device failure")
            return self.pipe(queries, max_num_results)

    server = SearchServer(Flaky(), port=0)
    server.start_background()
    try:
        code, body = _http_error(server, "/search", {"queries": [CORPUS[0]], "k": 3})
        assert code == 500 and "synthetic device failure" in body["error"]
        res = _call(server, "/search", {"queries": [CORPUS[0]], "k": 3})
        assert res["results"][0][0]["document"] == CORPUS[0]
        assert _call(server, "/metrics")["/search"]["errors"] == 1
    finally:
        server.shutdown()


def test_search_server_metrics_endpoint(encoder):
    server = SearchServer(_pipe(encoder), port=0)
    server.start_background()
    try:
        for _ in range(3):
            _call(server, "/search", {"queries": [CORPUS[0]], "k": 2})
        m = _call(server, "/metrics")
        assert m["/search"]["requests"] == 3 and m["/search"]["errors"] == 0
        assert m["/search"]["latency_ms_p95"] >= m["/search"]["latency_ms_p50"] > 0
        _http_error(server, "/nowhere", {})
        assert "/nowhere" not in _call(server, "/metrics")
    finally:
        server.shutdown()


def test_metrics_count_every_answered_request(encoder):
    """/metrics counts every request whose answer the client already holds:
    50 sequential /search calls, /metrics read after each. The server
    records a request before it writes the reply; recorded after, the
    /metrics request could run on another handler thread first. A record
    that takes 10 ms widens any such window to where every call shows it."""
    server = SearchServer(_pipe(encoder), port=0)
    record = server.stats.record

    def slow_record(*args):
        time.sleep(0.01)
        record(*args)

    server.stats.record = slow_record
    server.start_background()
    try:
        seen = []
        for n in range(1, 51):
            _call(server, "/search", {"queries": [CORPUS[n % len(CORPUS)]], "k": 2})
            seen.append(_call(server, "/metrics")["/search"]["requests"])
        assert seen == list(range(1, 51))
    finally:
        server.shutdown()


def test_failed_body_read_is_answered_500_and_counted(encoder):
    """An OSError while the body is read (a client reset mid-upload) is a
    failure of a known endpoint like any other: answered 500 and recorded."""
    server = SearchServer(_pipe(encoder), port=0)

    def reset(handler):
        raise ConnectionResetError("connection reset by peer")

    server.httpd.RequestHandlerClass._read_json = reset
    server.start_background()
    try:
        code, body = _http_error(server, "/search", {"queries": [CORPUS[0]], "k": 2})
        assert code == 500 and "ConnectionResetError" in body["error"]
        m = _call(server, "/metrics")["/search"]
        assert m["requests"] == 1 and m["errors"] == 1
    finally:
        server.shutdown()


def test_search_server_rerank_endpoint(encoder, cross_encoder):
    pipe = _pipe(encoder)
    rr = RankingPipeline(pipe, cross_encoder, retrieve_k=5)
    server = SearchServer(pipe, port=0, reranker=rr)
    server.start_background()
    try:
        row = _call(server, "/rerank", {"queries": [CORPUS[0]], "k": 3})["results"][0]
        assert len(row) == 3
        scores = [x["score"] for x in row]
        assert scores == sorted(scores, reverse=True)
        assert [x["id"] for x in row] == [cid for _, _, cid in rr([CORPUS[0]], top_k=3)[0]]
    finally:
        server.shutdown()


def test_search_server_rerank_without_model_errors(encoder):
    server = SearchServer(_pipe(encoder, CORPUS[:6]), port=0)
    server.start_background()
    try:
        assert _http_error(server, "/rerank", {"queries": ["x"]})[0] == 400
    finally:
        server.shutdown()


def test_health_of_an_empty_pipeline(encoder):
    server = SearchServer(SemanticSearchPipeline(encoder, device="cpu"), port=0)
    server.start_background()
    try:
        assert _call(server, "/health")["size"] == 0
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# The reference's faults, not copied
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0.0, 0.01])
def test_empty_queries_answered_400_and_server_keeps_serving(encoder, cross_encoder, window):
    """An empty ``queries`` list is a 400 on /search (batched or not) and
    /rerank; the batcher thread lives on and the next request is answered."""
    pipe = _pipe(encoder)
    server = SearchServer(pipe, port=0, batch_window=window,
                          reranker=RankingPipeline(pipe, cross_encoder, retrieve_k=3))
    server.start_background()
    try:
        for path in ("/search", "/rerank"):
            code, body = _http_error(server, path, {"queries": [], "k": 3})
            assert code == 400 and "non-empty" in body["error"]
        res = _call(server, "/search", {"queries": [CORPUS[2]], "k": 2})
        assert res["results"][0][0]["document"] == CORPUS[2]
        if server.batcher is not None:
            assert server.batcher._thread.is_alive()
    finally:
        server.shutdown()
    if server.batcher is not None:
        assert not server.batcher._thread.is_alive()   # closed with the server


def test_batcher_survives_a_failing_batch(encoder):
    """The batch's padding runs inside the batcher's error handling: an
    empty batch reaching the batcher fails that request only."""
    batcher = _MicroBatcher(_pipe(encoder), threading.Lock(), window=0.0)
    try:
        with pytest.raises(IndexError):
            batcher.submit([], 3)
        assert batcher._thread.is_alive()
        assert batcher.submit([CORPUS[4]], 2)[0][0][0] == CORPUS[4]
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()


def test_batch_padding_stays_within_max_batch(encoder):
    """Requests of 5, 5 and 3 queries with max_batch 8: no call carries
    more than next_pow2(8) = 8 queries (the reference coalesced 5 + 5 and
    padded to 16); a single request of 9 runs alone, unpadded past 9."""
    pipe = _pipe(encoder)
    calls = []
    gate = threading.Event()

    def counting(queries, max_num_results=10):
        gate.wait(30)
        calls.append(len(queries))
        return pipe(queries, max_num_results)

    batcher = _MicroBatcher(counting, threading.Lock(), window=0.05, max_batch=8)
    sizes = [5, 5, 3, 9]
    out = {}

    def one(i, n):
        out[i] = batcher.submit([CORPUS[(i + j) % 12] for j in range(n)], 2)

    try:
        threads = [threading.Thread(target=one, args=(i, n)) for i, n in enumerate(sizes)]
        for t in threads:
            t.start()
        deadline = time.time() + 3
        while len(batcher._queue) < len(sizes) - 1 and time.time() < deadline:
            time.sleep(0.005)
        gate.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert sum(calls) >= sum(sizes) and max(calls) <= 9
        assert all(c <= 8 for c in calls if c != 9), calls
        for i, n in enumerate(sizes):
            assert len(out[i]) == n
            assert [r[0][0] for r in out[i]] == [CORPUS[(i + j) % 12] for j in range(n)]
    finally:
        batcher.close()


def test_micro_batcher_stress_32_clients(encoder):
    """32 concurrent single-query clients (more than the cores, a short
    switch interval) through the micro-batcher: each answer equals the
    unbatched one."""
    pipe = _pipe(encoder)
    want = {i: pipe([CORPUS[i % 24]], 3)[0] for i in range(32)}
    server = SearchServer(pipe, port=0, batch_window=0.002)
    server.start_background()
    got, old = {}, sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def one(i):
        got[i] = _call(server, "/search", {"queries": [CORPUS[i % 24]], "k": 3})["results"][0]

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        server.shutdown()
    for i in range(32):
        assert [(x["document"], x["id"]) for x in got[i]] == [(d, c) for d, _, c in want[i]]
        np.testing.assert_allclose([x["score"] for x in got[i]], [s for _, s, _ in want[i]],
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved_dirs(encoder, cross_encoder, tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    encoder.save(str(root / "enc"))
    cross_encoder.save(str(root / "ce"))
    _pipe(encoder).save(str(root / "pipe"))
    (root / "corpus.txt").write_text("\n".join(CORPUS[:12]) + "\n\n", encoding="utf-8")
    return root


def _serve_args(*argv):
    return build_parser().parse_args(["serve", "--device", "cpu", "--port", "0", "--fp32", *argv])


def test_cli_build_server_on_cpu(saved_dirs, capsys):
    """``build_server`` loads the encoder, the saved pipeline and the
    cross-encoder, and warms the rerank path without --warmup."""
    args = _serve_args("--model", str(saved_dirs / "enc"), "--load", str(saved_dirs / "pipe"),
                       "--rerank-model", str(saved_dirs / "ce"), "--retrieve-k", "5")
    server = build_server(args)
    assert "warmed rerank path" in capsys.readouterr().out
    server.start_background()
    try:
        assert server.pipeline.device.type == "cpu"
        assert server.reranker.cross_encoder.device.type == "cpu"
        assert _call(server, "/health")["size"] == len(CORPUS)
        res = _call(server, "/search", {"queries": [CORPUS[3]], "k": 2})["results"][0]
        assert res[0]["document"] == CORPUS[3]
        row = _call(server, "/rerank", {"queries": [CORPUS[3]], "k": 4})["results"][0]
        assert len(row) == 4 and [x["score"] for x in row] == sorted(
            (x["score"] for x in row), reverse=True)
    finally:
        server.shutdown()


def test_cli_warms_rerank_without_warmup_flag(saved_dirs, capsys, monkeypatch):
    """The reference warmed the rerank path only under --warmup; the port
    warms it whenever a reranker is configured and the corpus is not
    empty (one retrieve + score before the first request)."""
    seen = []
    real = RankingPipeline.__call__
    def spy(self, queries, top_k=10):
        seen.append((list(queries), top_k))
        return real(self, queries, top_k)

    monkeypatch.setattr(RankingPipeline, "__call__", spy)
    args = _serve_args("--model", str(saved_dirs / "enc"), "--corpus",
                       str(saved_dirs / "corpus.txt"), "--rerank-model", str(saved_dirs / "ce"),
                       "--retrieve-k", "5", "--batch-window-ms", "0")
    server = build_server(args)
    server.shutdown()
    assert args.warmup == 0 and seen == [([CORPUS[0]], 5)]
    assert "warmed rerank path" in capsys.readouterr().out
    assert server.batcher is None and len(server.pipeline.corpus) == 12


def test_cli_rejects_what_is_not_ported(saved_dirs):
    # --shards N on the card takes the first N cards: fewer raise, naming the count
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="--shards 2 needs 2 cards"):
            build_server(_serve_args("--model", str(saved_dirs / "enc"), "--shards", "2",
                                     "--device", "cuda"))
    with pytest.raises(SystemExit, match="--model"):
        build_server(_serve_args("--model", str(saved_dirs / "missing")))
    # the reference's shared flags that serve never reads: refused, not ignored
    for flag, value in (("--tokenizer", "tok"), ("--pooling", "cls"), ("--seed", "1"),
                        ("--arch", "tiny-test")):
        with pytest.raises(SystemExit, match=f"reads no {flag}"):
            build_server(_serve_args("--model", str(saved_dirs / "enc"), flag, value))
    if not torch.cuda.is_available():
        args = build_parser().parse_args(["serve", "--model", str(saved_dirs / "enc")])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            build_server(args)


def test_serve_entry_point_as_a_process(saved_dirs):
    """``python -m text_similarity_tpu_torch serve --device cpu --port 0``
    warms the rerank path, serves /health, /search and /rerank, and exits
    0 on SIGINT with no traceback."""
    cmd = [sys.executable, "-m", "text_similarity_tpu_torch", "serve", "--device", "cpu",
           "--port", "0", "--fp32", "--model", str(saved_dirs / "enc"), "--load",
           str(saved_dirs / "pipe"), "--rerank-model", str(saved_dirs / "ce"), "--retrieve-k", "5"]
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        deadline = time.time() + 120
        port = None
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on http://"):
                port = int(line.rsplit(":", 1)[1])
        assert port is not None, (lines, proc.poll())
        assert any("warmed rerank path" in ln for ln in lines)
        server = SimpleNamespace(port=port)
        assert _call(server, "/health")["size"] == len(CORPUS)
        assert _call(server, "/search", {"queries": [CORPUS[1]], "k": 1})["results"][0][0][
            "document"] == CORPUS[1]
        assert len(_call(server, "/rerank", {"queries": [CORPUS[1]], "k": 2})["results"][0]) == 2
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "Traceback" not in err and "serving on 127.0.0.1" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


# ---------------------------------------------------------------------------
# Against the JAX package's server
# ---------------------------------------------------------------------------

def test_search_answers_equal_the_jax_server(tmp_path):
    """The JAX package's daemon and the port's, each over the same
    JAX-saved encoder and pipeline: the same /search request gets the same
    documents and ids, scores within 1e-5."""
    jtok = JaxTokenizer(train_wordpiece_vocab(CORPUS, vocab_size=512, min_freq=1))
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=jtok.vocab_size)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), jarch), jarch, tokenizer=jtok,
                              precision=JAX_FP32)
    jenc.save(str(tmp_path / "enc"))
    jpipe = JaxPipeline(jenc, corpus=CORPUS, use_ivf=False)
    jpipe.save(str(tmp_path / "pipe"))
    enc = SentenceEncoder.load(str(tmp_path / "enc"), bf16=False, device="cpu")
    pipe = SemanticSearchPipeline(enc, use_ivf=False, device="cpu")
    pipe.load_corpus(str(tmp_path / "pipe"))
    servers = [JaxSearchServer(jpipe, port=0), SearchServer(pipe, port=0)]
    for s in servers:
        s.start_background()
    try:
        req = {"queries": [CORPUS[0], CORPUS[7], "unseen words about a fox"], "k": 4}
        want, got = (_call(s, "/search", req)["results"] for s in servers)
        assert [[(x["document"], x["id"]) for x in r] for r in got] == [
            [(x["document"], x["id"]) for x in r] for r in want]
        np.testing.assert_allclose([[x["score"] for x in r] for r in got],
                                   [[x["score"] for x in r] for r in want], atol=1e-5)
        assert _call(servers[1], "/health") == {**_call(servers[0], "/health"), "sharded": False}
    finally:
        for s in servers:
            s.shutdown()
