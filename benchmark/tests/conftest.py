"""Tiny configurations and traffic for the benchmark's CPU tests: the
published files' keys at small sizes, so every driver runs its whole path
on the CPU in seconds."""

import copy
import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(BENCH, *parts), encoding="utf-8") as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(_load("configs", f"{name}.json"))
    cfg["model"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, vocab_size=30522)
    if cfg["layout"]["attention_window_one_sided"]:
        cfg["model"]["max_position_embeddings"] = 260
        cfg["layout"]["attention_window_one_sided"] = 16
    else:
        cfg["model"]["max_position_embeddings"] = 128
    return cfg


TINY_TRAFFIC = {
    "search-text": dict(corpus_docs=1500, request_pool=3, queries_per_request=16,
                        check_queries=12, keep_every=2, trace_requests=2, encode_batch=64,
                        clusters=32, probes=16, kmeans_iters=3),
    "search-vectors": dict(corpus_rows=4000, centres=512, queries_per_request=64, request_pool=3,
                           clusters=32, probes=24, kmeans_iters=3, block_q=8, keep_every=2,
                           trace_requests=2, check_queries=32),
    "train": dict(pairs_per_step=4, doc_tokens=[60, 100], bucket=128, batches=4,
                  total_steps=100, log_every=2, trace_steps=2),
    "encode": dict(docs_per_batch=4, doc_tokens=[60, 120], max_len=128,
                   buckets=[16, 32, 64, 128], batches=3, keep_every=2, trace_batches=2,
                   check_docs=4),
}


def tiny_traffic(name: str) -> dict:
    t = copy.deepcopy(_load("traffic", f"{name}.json"))
    t.update(TINY_TRAFFIC[name])
    return t


@pytest.fixture
def card():
    """The CUDA card, for the tests marked ``cuda``; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
