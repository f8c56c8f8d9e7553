"""The port's CrossEncoder and RankingPipeline against the JAX package's: a
JAX-built tiny-test cross-encoder (token types, tanh pooler, FP32; 1, 2 and
3 classes) saved and loaded into the port scores the same pairs bucketed,
packed and under ``"auto"`` within |Δ| ≤ 1e-4, taking the same route;
int8 weights after ``to_int8`` within 1e-4 of the JAX package's int8; a
port-saved cross-encoder loads in the JAX package; the wave-pipelined scorer
equals ``predict``; the rerank pipeline returns the JAX package's ids in the
JAX package's order."""

import numpy as np
import pytest
import torch

import jax

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.pipelines import RankingPipeline as JaxRankingPipeline
from text_similarity_tpu.pipelines import SemanticSearchPipeline as JaxPipeline
from text_similarity_tpu.train.steps import classifier_forward as jax_classifier_forward
from text_similarity_tpu_torch.core.config import ARCH_PRESETS
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, cross_params_from_jax
from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
from text_similarity_tpu_torch.pipelines import RankingPipeline, SemanticSearchPipeline
from text_similarity_tpu_torch.train.steps import classifier_forward
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4

WORDS = [f"{a}{b}" for a in ("ka", "lo", "mi", "nu", "pe", "ro", "su", "ti") for b in
         ("ba", "de", "fo", "gu", "hi", "jo")]


def _sentences(n, seed, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(rng.choice(WORDS, rng.integers(lo, hi)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


CORPUS = _sentences(80, 0)


def _pairs(n=40, seed=1, lo=3, hi=20):
    a, b = _sentences(n, seed, lo, hi), _sentences(n, seed + 100, lo, hi)
    return list(zip(a, b))


@pytest.fixture(scope="module")
def vocab():
    return train_wordpiece_vocab(CORPUS, vocab_size=400, min_freq=1)


@pytest.fixture(scope="module")
def jax_arch(vocab):
    return JAX_PRESETS["tiny-test"].replace(vocab_size=len(vocab))


@pytest.fixture(scope="module")
def saved(vocab, jax_arch, tmp_path_factory):
    """{num_classes: (JAX cross-encoder, its saved dir)}. The random head
    is scaled ×100 so that scores spread across pairs far beyond ATOL
    (random encoders give pairs similar CLS states)."""
    out = {}
    for c in (1, 2, 3):
        jce = JaxCrossEncoder.init(jax.random.PRNGKey(c), jax_arch,
                                   tokenizer=JaxTokenizer(vocab), num_classes=c,
                                   precision=JAX_FP32)
        jce.params["head"]["w"] = jce.params["head"]["w"] * 100.0
        d = tmp_path_factory.mktemp(f"ce{c}")
        jce.save(str(d))
        out[c] = (jce, str(d))
    return out


def _port(saved, c) -> CrossEncoder:
    return CrossEncoder.load(saved[c][1], bf16=False, device="cpu")


def _routes(monkeypatch, cls=CrossEncoder):
    """Count a package's packed scoring calls (``cls`` the port's or the JAX
    package's CrossEncoder): the route a predict took, read without
    clearing the JAX package's compiled shapes, which the tests share."""
    calls = []
    real = cls._predict_packed_layout
    monkeypatch.setattr(cls, "_predict_packed_layout",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    return calls


def test_load_reads_the_jax_layout(saved):
    for c in (1, 2, 3):
        ce = _port(saved, c)
        assert ce.num_classes == c and ce.pooling == "cls"
        assert tuple(ce.params["head"]["w"].shape) == (64, c)
        assert "pooler" in ce.params["encoder"] and ce.device.type == "cpu"


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("mode", [False, True, "auto"])
def test_predict_matches_jax(saved, c, mode, monkeypatch):
    """Bucketed, packed and "auto" scores of 40 pairs within 1e-4 of the
    JAX package's, (N,) for 1 and 2 classes, (N, C) logits for 3."""
    jce = saved[c][0]
    ce = _port(saved, c)
    pairs = _pairs()
    calls, jax_calls = _routes(monkeypatch), _routes(monkeypatch, JaxCrossEncoder)
    got = ce.predict(pairs, packed=mode)
    want = np.asarray(jce.predict(pairs, packed=mode))
    assert got.shape == want.shape == ((40,) if c <= 2 else (40, c))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.ptp(want) > 10 * ATOL     # the tolerance tells pairs apart
    assert bool(calls) == bool(jax_calls) == (mode is not False)


@pytest.mark.parametrize("lens", [(3, 20), (30, 31)])
def test_auto_route_follows_jax(saved, lens, monkeypatch):
    """Short pairs pack under "auto", pairs that fill their bucket do not,
    in both packages; 8 pairs never pack."""
    jce = saved[1][0]
    ce = _port(saved, 1)
    routes = []
    for pairs in (_pairs(40, 7, *lens), _pairs(8, 9)):
        calls, jax_calls = _routes(monkeypatch), _routes(monkeypatch, JaxCrossEncoder)
        np.testing.assert_allclose(ce.predict(pairs, max_len=64),
                                   np.asarray(jce.predict(pairs, max_len=64)), atol=ATOL)
        assert bool(calls) == bool(jax_calls)
        routes.append(bool(calls))
    assert routes[-1] is False                 # the 8-pair call


def test_predict_packed_matches_jax(saved):
    jce = saved[2][0]
    ce = _port(saved, 2)
    pairs = _pairs(30, 3)
    np.testing.assert_allclose(
        ce.predict_packed(pairs, width=64, max_len=64, rows_per_batch=4),
        np.asarray(jce.predict_packed(pairs, width=64, max_len=64)), atol=ATOL,
    )


def test_packed_scores_equal_dense_with_pooler(saved):
    """The packed route reads each pair's CLS through the pooler's tanh, so
    its scores equal the dense route's (the JAX package's own test holds
    rtol 2e-3, atol 1e-4)."""
    ce = _port(saved, 2)
    pairs = _pairs(24, 5)
    np.testing.assert_allclose(ce.predict(pairs, packed=False), ce.predict(pairs, packed=True),
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("c", [1, 2])
def test_to_int8_matches_jax_int8(saved, c):
    jce, d = saved[c]
    jq = JaxCrossEncoder.load(d, bf16=False)
    jq.to_int8()
    ce = _port(saved, c).to_int8()
    assert set(ce.params["head"]["w"]) == {"q", "s"}
    pairs = _pairs()
    for mode in (False, True):
        np.testing.assert_allclose(ce.predict(pairs, packed=mode),
                                   np.asarray(jq.predict(pairs, packed=mode)), atol=ATOL)


@pytest.mark.parametrize("c", [1, 3])
def test_port_saved_cross_encoder_loads_in_jax(vocab, c, tmp_path):
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=len(vocab))
    ce = CrossEncoder.init(torch.Generator().manual_seed(c), arch,
                           tokenizer=WordPieceTokenizer(vocab), num_classes=c,
                           precision=FP32_PRECISION, device="cpu")
    ce.save(str(tmp_path / "ce"))
    jce = JaxCrossEncoder.load(str(tmp_path / "ce"), bf16=False)
    assert jce.num_classes == c
    pairs = _pairs()
    np.testing.assert_allclose(ce.predict(pairs), np.asarray(jce.predict(pairs)), atol=ATOL)


def test_int8_saved_cross_encoder_round_trips(saved, tmp_path):
    """A cross-encoder saved after ``to_int8`` keeps its int8 leaves and
    loads to the same scores."""
    ce = _port(saved, 1).to_int8()
    ce.save(str(tmp_path / "q"))
    back = CrossEncoder.load(str(tmp_path / "q"), bf16=False, device="cpu")
    assert set(back.params["encoder"]["layers"]["attn"]["q"]["w"]) == {"q", "s"}
    pairs = _pairs(12, 4)
    np.testing.assert_array_equal(back.predict(pairs), ce.predict(pairs))


def test_cross_params_from_jax_checks_the_head(saved, jax_arch):
    tree = jax.device_get(saved[2][0].params)
    params = cross_params_from_jax(tree, jax_arch, 2)
    assert params["head"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="head/w"):
        cross_params_from_jax(tree, jax_arch, 3)
    with pytest.raises(KeyError):
        cross_params_from_jax({"encoder": tree["encoder"], "head": {"w": tree["head"]["w"]}},
                              jax_arch, 2)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_classifier_forward_matches_jax(saved, jax_arch, pooling):
    jce = saved[3][0]
    ce = _port(saved, 3)
    tok = ce.tokenizer
    ids, mask, tts = tok.encode_pair_batch([p[0] for p in _pairs()], [p[1] for p in _pairs()],
                                           max_len=48)
    got = classifier_forward(ce.params, torch.as_tensor(ids), torch.as_tensor(mask),
                             torch.as_tensor(tts), arch=ce.arch, precision=FP32_PRECISION,
                             pooling=pooling)
    want = jax_classifier_forward(jce.params, ids, mask, tts, arch=jax_arch,
                                  precision=JAX_FP32, pooling=pooling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_score_tokens_matches_jax(saved):
    jce = saved[2][0]
    ce = _port(saved, 2)
    ids, mask, tts = ce.tokenizer.encode_pair_batch(["kaba lode"] * 3, ["mifo", "nugu pehi", ""],
                                                    max_len=16)
    np.testing.assert_allclose(ce.score_tokens(ids, mask, tts),
                               np.asarray(jce.score_tokens(ids, mask, tts)), atol=ATOL)
    np.testing.assert_allclose(ce.score_tokens(ids, mask),
                               np.asarray(jce.score_tokens(ids, mask)), atol=ATOL)


def test_cross_encoder_defaults_to_the_card(saved):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        CrossEncoder.load(saved[1][1], bf16=False)


# ---------------------------------------------------------------------------
# RankingPipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rank_setup(vocab, jax_arch, saved, tmp_path_factory):
    """The JAX package's and the port's brute-force pipelines over CORPUS
    (one JAX-saved bi-encoder), built once: reranking reads them only."""
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(5), jax_arch),
                              jax_arch, tokenizer=JaxTokenizer(vocab), precision=JAX_FP32)
    d = tmp_path_factory.mktemp("enc")
    jenc.save(str(d))
    enc = SentenceEncoder.load(str(d), bf16=False, device="cpu")
    return (JaxPipeline(jenc, corpus=CORPUS, use_ivf=False),
            SemanticSearchPipeline(enc, corpus=CORPUS, use_ivf=False, device="cpu"))


@pytest.mark.parametrize("c", [1, 2])
def test_ranking_pipeline_matches_jax(rank_setup, saved, c):
    """Same candidates, same re-sorted ids and order, scores within 1e-4."""
    jpipe, pipe = rank_setup
    jrr = JaxRankingPipeline(jpipe, saved[c][0], retrieve_k=10)
    rr = RankingPipeline(pipe, _port(saved, c), retrieve_k=10)
    queries = CORPUS[:3] + ["kaba lode mifo unseen"]
    got, want = rr(queries, top_k=5), jrr(queries, top_k=5)
    assert [[(d, i) for d, _, i in r] for r in got] == [[(d, i) for d, _, i in r] for r in want]
    np.testing.assert_allclose([[s for _, s, _ in r] for r in got],
                               [[s for _, s, _ in r] for r in want], atol=ATOL)
    for row in got:
        assert [s for _, s, _ in row] == sorted((s for _, s, _ in row), reverse=True)


def test_predict_pipelined_equals_predict(rank_setup, saved):
    """The wave-pipelined packed scorer over 3000 pairs in waves of 1024
    equals ``predict`` (packed; the JAX package's own test holds 1e-5) and
    the JAX package's wave scorer within 1e-4."""
    jpipe, pipe = rank_setup
    ce = _port(saved, 1)
    rr = RankingPipeline(pipe, ce, retrieve_k=5)
    rng = np.random.default_rng(0)
    flat = [(CORPUS[i], CORPUS[j]) for i, j in rng.integers(0, len(CORPUS), (3000, 2))]
    got = rr._predict_pipelined(flat, wave=1024)
    np.testing.assert_allclose(got, ce.predict(flat, packed=True), rtol=1e-5, atol=1e-5)
    jrr = JaxRankingPipeline(jpipe, saved[1][0], retrieve_k=5)
    np.testing.assert_allclose(got, np.asarray(jrr._predict_pipelined(flat, wave=1024)),
                               atol=ATOL)


def test_ranking_pipeline_takes_the_wave_path_above_2048_pairs(rank_setup, saved, monkeypatch):
    """33 queries × 64 candidates = 2112 pairs: scored in waves, with the
    same ranking as the direct ``predict`` route."""
    _, pipe = rank_setup
    ce = _port(saved, 1)
    rr = RankingPipeline(pipe, ce, retrieve_k=64)
    waves = []
    real = RankingPipeline._predict_pipelined
    monkeypatch.setattr(RankingPipeline, "_predict_pipelined",
                        lambda self, p, **k: waves.append(len(p)) or real(self, p, **k))
    queries = (CORPUS * 2)[:33]
    got = rr(queries, top_k=64)
    assert waves == [33 * 64]
    flat = [(q, d) for q, row in zip(queries, got) for d, _, _ in row]
    want = ce.predict(flat)
    np.testing.assert_allclose([s for row in got for _, s, _ in row], want, atol=1e-5)


def test_ranking_pipeline_empty_candidates(saved):
    """No candidate retrieved (every document removed): empty rows, no
    cross-encoder call."""
    def search(queries, max_num_results):
        return [[] for _ in queries]

    assert RankingPipeline(search, _port(saved, 1))(["a", "b"], top_k=3) == [[], []]
