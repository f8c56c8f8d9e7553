"""The port's spans (``utils.profiling.span``) on the CPU: a ``nullcontext``
without a profiler and a ``user_annotation`` under one; the tree a search
request exports (``ts.search`` over the encode, the IVF query and the rows,
by interval containment) on the packed and the bucketed route; the train
step's spans through ``Trainer``; no span in a remat recompute; the MoE
stages; every span on the calling thread; results bit-equal with the
profiler on and off."""

import contextlib
import json

import numpy as np
import pytest
import torch

from text_similarity_tpu_torch.core.config import ARCH_PRESETS, IndexConfig, TrainConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, init_params
from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
from text_similarity_tpu_torch.train import (
    Trainer, init_train_state, make_bi_encoder_train_step, make_optimizer,
)
from text_similarity_tpu_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = ARCH_PRESETS["tiny-test"].replace(hidden_dropout=0.0, attention_dropout=0.0)


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    words = [f"w{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}{i}" for i in range(300)]
    return [" ".join(rng.choice(words, rng.integers(3, 20))) for _ in range(n)]


def _spans(log_dir):
    """The trace's ``ts.*`` spans → [(name, start, end, tid)]."""
    with open(log_dir / "trace.json", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("ts.")]


def _parent(spans, child):
    """The innermost span that holds ``child`` (None at the top)."""
    name, s, e, _ = child
    outer = [p for p in spans if p is not child and p[1] <= s and e <= p[2]
             and (p[1], p[2]) != (s, e)]
    return min(outer, key=lambda p: p[2] - p[1])[0] if outer else None


def _tree(spans):
    """{span name: the set of its parents' names}."""
    tree = {}
    for sp in spans:
        tree.setdefault(sp[0], set()).add(_parent(spans, sp))
    return tree


def _train_step(device, remat=False):
    """A bi-encoder step on ``ARCH``, its state and one batch of 4 pairs."""
    params = {"encoder": init_params(ARCH, torch.Generator().manual_seed(0))}
    tx = make_optimizer(TrainConfig(lr=1e-3, warmup_ratio=0.0), total_steps=10,
                        params_example=params)
    state = init_train_state(params, tx, device=device)
    step = make_bi_encoder_train_step(ARCH, tx, precision=FP32_PRECISION, remat=remat,
                                      device=device)
    rng = np.random.RandomState(0)
    batch = {"ids_a": rng.randint(5, ARCH.vocab_size, (4, 8)).astype(np.int32),
             "mask_a": np.ones((4, 8), np.int32),
             "ids_b": rng.randint(5, ARCH.vocab_size, (4, 8)).astype(np.int32),
             "mask_b": np.ones((4, 8), np.int32),
             "target": rng.rand(4).astype(np.float32), "valid": np.ones((4,), np.int32)}
    return step, state, batch


@pytest.fixture(scope="module")
def pipe():
    corpus = _texts(300, 0)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=600, min_freq=1))
    arch = ARCH.replace(vocab_size=tok.vocab_size)
    enc = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                          tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    p = SemanticSearchPipeline(enc, corpus=corpus, use_ivf=True, batch_size=16, device="cpu",
                               index_config=IndexConfig(num_clusters=8, num_probes=3,
                                                        kmeans_iters=2))
    p(corpus[:2], max_num_results=5)       # builds the index
    return p


def test_span_is_free_without_a_profiler_and_named_under_one():
    assert isinstance(profiling.span("ts.test"), contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("ts.test"):
            torch.ones(3).sum()
    assert "ts.test" in {e.key for e in prof.key_averages()}
    assert isinstance(profiling.span("ts.test"), contextlib.nullcontext)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bucketed"])
def test_search_request_exports_the_span_tree(pipe, packed, monkeypatch, tmp_path):
    monkeypatch.setattr(SentenceEncoder, "use_packed", lambda self, *a: packed)
    queries = _texts(40, 1)
    with profiling.trace(str(tmp_path)):
        pipe(queries, max_num_results=5)
    spans = _spans(tmp_path)
    tree = _tree(spans)
    want = {
        "ts.search": {None},
        "ts.encode": {"ts.search"},
        "ts.tokenize": {"ts.encode"},
        "ts.pack": {"ts.encode"},
        "ts.encoder.forward": {"ts.encode"},
        "ts.encoder.attention": {"ts.encoder.forward"},
        "ts.encoder.ffn": {"ts.encoder.forward"},
        "ts.ivf.query": {"ts.search"},
        "ts.ivf.plan": {"ts.ivf.query"},
        "ts.ivf.scan": {"ts.ivf.query"},
        "ts.ivf.merge": {"ts.ivf.query"},
        "ts.search.to_host": {"ts.search"},
        "ts.search.rows": {"ts.search"},
    }
    assert tree == want
    count = {n: sum(1 for s in spans if s[0] == n) for n in tree}
    forwards = count["ts.encoder.forward"]
    assert count["ts.search"] == 1 and forwards >= 1
    assert count["ts.encoder.attention"] == count["ts.encoder.ffn"] == ARCH.num_layers * forwards
    # the bucketed route draws each batch (and the end) in its own span
    assert count["ts.pack"] == (1 if packed else forwards + 1)
    start = {s[0]: s[1] for s in spans}
    assert start["ts.ivf.plan"] < start["ts.ivf.scan"] < start["ts.ivf.merge"]
    assert start["ts.search.to_host"] < start["ts.search.rows"]
    assert len({s[3] for s in spans}) == 1       # all on the calling thread


def test_search_results_equal_with_the_profiler_on_and_off(pipe, tmp_path):
    queries = _texts(24, 2)
    off = pipe(queries, max_num_results=5)
    with profiling.trace(str(tmp_path)):
        on = pipe(queries, max_num_results=5)
    assert on == off


def test_train_step_spans_through_trainer(tmp_path):
    step, state, batch = _train_step("cpu")
    trainer = Trainer(step, state, log_every=1, prefetch=2, device="cpu")
    with profiling.trace(str(tmp_path)):
        trainer.execute(lambda e: iter([batch]), epochs=1, write_results=False)
    spans = _spans(tmp_path)
    tree = _tree(spans)
    assert tree["ts.train.step"] == {None}
    assert tree["ts.train.backward"] == {"ts.train.step"}
    assert tree["ts.train.optimizer"] == {"ts.train.step"}
    assert tree["ts.train.drain"] == {None}
    assert tree["ts.encoder.attention"] == tree["ts.encoder.ffn"] == {"ts.train.step"}
    assert sum(1 for s in spans if s[0] == "ts.train.step") == 1
    # the prefetcher's thread opens none
    assert len({s[3] for s in spans}) == 1


@pytest.mark.parametrize("remat", [True, "dots"], ids=["full", "dots"])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_remat_recompute_opens_no_span(device, remat, tmp_path):
    """The backward's recompute of a checkpointed layer (on autograd's
    worker thread on the card) opens no span: each layer's attention and
    FFN spans count the forward once, all on the calling thread."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: autograd's worker thread runs only there")
    step, state, batch = _train_step(device, remat)
    with profiling.trace(str(tmp_path)):
        step(state, batch)
    spans = _spans(tmp_path)
    backward = [s for s in spans if s[0] == "ts.train.backward"]
    assert len(backward) == 1
    count = {n: sum(1 for s in spans if s[0] == n)
             for n in ("ts.encoder.attention", "ts.encoder.ffn")}
    # both towers' forwards, and nothing from the recompute
    assert count == {"ts.encoder.attention": 2 * ARCH.num_layers,
                     "ts.encoder.ffn": 2 * ARCH.num_layers}
    _, b0, b1, _ = backward[0]
    assert not [s for s in spans if s[0].startswith("ts.encoder") and b0 <= s[1] <= b1]
    assert len({s[3] for s in spans}) == 1


def test_moe_stages_are_spans(tmp_path):
    arch = ARCH.replace(num_experts=4, expert_top_k=2)
    enc = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                          precision=FP32_PRECISION, device="cpu")
    ids = np.random.RandomState(0).randint(5, arch.vocab_size, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    off = enc.embed_tokens(ids, mask)
    with profiling.trace(str(tmp_path)):
        on = enc.embed_tokens(ids, mask)
    assert torch.equal(on, off)
    tree = _tree(_spans(tmp_path))
    for stage in ("router", "dispatch", "experts", "combine"):
        assert tree[f"ts.moe.{stage}"] == {"ts.encoder.ffn"}, stage
