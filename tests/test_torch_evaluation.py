"""The port's meters and evaluators against the JAX package's: every meter
on the same scores, labels and embeddings (ties included), and the
paraphrase, retrieval and classifier evaluators over a JAX-saved encoder
loaded in both packages (f32)."""

import numpy as np
import pytest
import torch

import jax

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.evaluation import evaluators as JE
from text_similarity_tpu.evaluation import meters as JM
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu_torch.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu_torch.evaluation import evaluators as TE
from text_similarity_tpu_torch.evaluation import meters as TM
from text_similarity_tpu_torch.models import SentenceEncoder


def _scores_labels(n=200, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(n) > 0.5).astype(int)
    scores = labels * 0.3 + rng.randn(n) * 0.5
    if ties:
        scores = np.round(scores, 1)
    return scores, labels


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["best_threshold_accuracy", "best_threshold_f1",
                                  "average_precision", "roc_curve"])
@pytest.mark.parametrize("ties", [False, True])
def test_binary_meters_match_jax(name, ties):
    scores, labels = _scores_labels(seed=1, ties=ties)
    _same(getattr(TM, name)(scores, labels), getattr(JM, name)(scores, labels))


def test_embedding_meters_match_jax():
    rng = np.random.RandomState(3)
    u = rng.randn(50, 16)
    v = u * 0.7 + rng.randn(50, 16) * 0.4
    gold = rng.rand(50)
    labels = (gold > 0.5).astype(int)
    _same(TM.similarity_metrics(u, v, gold), JM.similarity_metrics(u, v, gold))
    _same(TM.binary_similarity_report(u, v, labels), JM.binary_similarity_report(u, v, labels))
    _same(TM.retrieval_accuracy(u, v), JM.retrieval_accuracy(u, v))
    logits, y = rng.randn(40, 3), rng.randint(0, 3, 40)
    _same(TM.classification_metrics(logits, y), JM.classification_metrics(logits, y))


def test_average_meters_match_jax():
    t, j = TM.Metrics("loss", "acc"), JM.Metrics("loss", "acc")
    for m in (t, j):
        m.update("loss", 2.0, n=3)
        m.update("loss", 1.0)
        m.update("acc", 0.5)
    assert t.averages() == j.averages() and t.display() == j.display()


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    rng = np.random.default_rng(0)
    words = [f"w{i}{chr(97 + i % 26)}" for i in range(100)]
    texts = [" ".join(rng.choice(words, rng.integers(3, 14))) for _ in range(40)]
    vocab = train_wordpiece_vocab(texts, vocab_size=300, min_freq=1)
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=len(vocab))
    path = str(tmp_path_factory.mktemp("enc"))
    JaxSentenceEncoder(jax_init(jax.random.PRNGKey(1), jarch), jarch,
                       tokenizer=JaxTokenizer(vocab), precision=JAX_FP32).save(path)
    return (SentenceEncoder.load(path, bf16=False, device="cpu"),
            JaxSentenceEncoder.load(path, bf16=False), texts)


@pytest.mark.parametrize("mode", ["regression", "binary"])
def test_paraphrase_evaluator_matches_jax(encoders, mode):
    enc, jenc, texts = encoders
    a, b = texts[:20], texts[20:]
    gold = np.linspace(0, 1, 20) if mode == "regression" else np.arange(20) % 2
    got = TE.ParaphraseEvaluator(enc, mode=mode).evaluate(a, b, gold)
    want = JE.ParaphraseEvaluator(jenc, mode=mode).evaluate(a, b, gold)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    # embeddings handed over as tensors give the same metrics
    u, v = (enc.encode(x, device_output=True) for x in (a, b))
    again = TE.ParaphraseEvaluator(enc, mode=mode).evaluate_embeddings(u, v, gold)
    assert again == pytest.approx(got)


def test_retrieval_evaluator_matches_jax(encoders):
    enc, jenc, texts = encoders
    src, tgt = texts[:20], [t + " " + t for t in texts[:20]]
    got = TE.RetrievalEvaluator(enc).evaluate(src, tgt)
    assert got == pytest.approx(JE.RetrievalEvaluator(jenc).evaluate(src, tgt), abs=1e-9)


def test_classifier_evaluator_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 3)).astype(np.float32)
    batches = [{"ids": rng.integers(0, 50, (4,)), "mask": np.ones(4), "labels":
                rng.integers(0, 3, 4), "valid": np.array([1, 1, 1, 0])} for _ in range(3)]
    got = TE.ClassifierEvaluator(lambda ids, m, t: torch.from_numpy(table[ids])).evaluate(batches)
    want = JE.ClassifierEvaluator(lambda ids, m, t: table[ids]).evaluate(batches)
    assert got == pytest.approx(want, abs=1e-12)
