"""Paraphrase mining and compare_models against the JAX package: a JAX-saved
tiny-test encoder (FP32) loads into the port; exact mining (K2's plain
version) and the queries= mode give the JAX package's pairs with scores
within 1e-5; on one JAX-built bf16 IVF index, saved and loaded into the
port, the port's ``_mine_with_index`` and the whole IVF route give the
answers of the JAX package's ``_mine_ivf`` run through its Pallas scan in
interpret mode (on one embedding array: ids equal where the scores are
separated by more than 1e-5, scores within 1e-5; through each package's
own encode: the same pairs, scores within one bf16 rounding of the query,
2^-8); the port's own build mines within 0.05 of the JAX package's recall;
compare_models gives the JAX package's JSON."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.compress.quantize import save_quantized as jax_save_quantized
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import IndexConfig as JaxIndexConfig
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu.index.ivf import IVFIndex as JaxIVFIndex
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
import text_similarity_tpu.pipelines.search as jax_search
from text_similarity_tpu_torch.index import IVFIndex
from text_similarity_tpu_torch.models import SentenceEncoder
import text_similarity_tpu_torch.pipelines.search as port_search
from text_similarity_tpu_torch.pipelines import SentenceMiningPipeline, compare_models
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCORE_TOL = 1e-5
# the IVF scan takes its dots against bf16 rows with the query rounded to
# bf16 too: queries that differ in the last f32 bits (each package's own
# encode) may round a component one bf16 step apart, which moves a score by
# at most 2^-8 · Σ|q_d x_d| ≤ 2^-8
BF16_TOL = 2.0 ** -8


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}{i}" for i in range(600)]
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(rng.choice(words, rng.integers(4, 16)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


CORPUS = _corpus(1200)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A JAX tiny-test encoder, saved, and the port's load of it."""
    jtok = JaxTokenizer(train_wordpiece_vocab(CORPUS, vocab_size=1000, min_freq=1))
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=jtok.vocab_size)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), jarch), jarch, tokenizer=jtok,
                              precision=JAX_FP32)
    root = tmp_path_factory.mktemp("mining")
    jenc.save(str(root / "enc"))
    enc = SentenceEncoder.load(str(root / "enc"), bf16=False, device="cpu")
    return root, jenc, enc


@pytest.fixture(scope="module")
def shared_ivf(setup, tmp_path_factory):
    """The JAX package's normalized embeddings of the corpus and its bf16
    IVF index over them (IndexConfig.auto), saved and loaded into the port."""
    _, jenc, _ = setup
    emb = np.asarray(jax_search.l2_normalize(jnp.asarray(jenc.encode(CORPUS))))
    jivf = JaxIVFIndex.build(jnp.asarray(emb), JaxIndexConfig.auto(len(CORPUS)),
                             key=jax.random.PRNGKey(0), data_dtype=jnp.bfloat16)
    path = str(tmp_path_factory.mktemp("mine_ivf") / "ivf.npz")
    jivf.save(path)
    tivf = IVFIndex.load(path, device="cpu")
    assert tivf.data_padded.dtype == torch.bfloat16
    return emb, jivf, tivf


def _jax_ivf_through(monkeypatch, jivf):
    """The JAX package's mining takes ``jivf`` for its build and queries it
    with the Pallas scan (interpret mode): the kernel's block-union
    semantics, which the port's scan follows."""
    monkeypatch.setattr(jax_search.IVFIndex, "build", classmethod(lambda cls, *a, **k: jivf))
    real = JaxIVFIndex.query
    monkeypatch.setattr(JaxIVFIndex, "query", lambda self, q, **k: real(self, q, impl="pallas", **k))


def _as_dict(pairs):
    out = {(i, j): s for i, j, s in pairs}
    assert len(out) == len(pairs)
    return out


def _assert_pairs_equal(got, want, tol=SCORE_TOL):
    """The same (i, j) pairs with scores within ``tol``, and both lists
    best first."""
    g, w = _as_dict(got), _as_dict(want)
    assert g.keys() == w.keys()
    np.testing.assert_allclose([g[p] for p in w], list(w.values()), atol=tol)
    for pairs in (got, want):
        scores = [s for _, _, s in pairs]
        assert scores == sorted(scores, reverse=True)
        assert all(i < j for i, j, _ in pairs)


def _separated(s, tol=SCORE_TOL):
    """Ranks whose score differs from both neighbours' by more than tol."""
    gap = np.minimum(np.abs(np.diff(s, axis=1, prepend=np.inf)),
                     np.abs(np.diff(s, axis=1, append=-np.inf)))
    return gap > tol


def _threshold(scores, quantile):
    """A min_score near the quantile of ``scores`` with no score within
    1.5 × SCORE_TOL of it, so that the filter cannot split on rounding."""
    s = np.sort(np.asarray(scores))
    i = int(quantile * len(s))
    while s[i + 1] - s[i] <= 3 * SCORE_TOL:
        i += 1
    return float(s[i] + s[i + 1]) / 2


@pytest.mark.parametrize("k,quantile", [(5, None), (3, 0.5)])
def test_exact_mining_matches_jax(setup, k, quantile):
    """All-pairs exact mining: the JAX package's pairs, deduplicated
    (i < j), at or above min_score, best first; scores within 1e-5."""
    _, jenc, enc = setup
    jmine = jax_search.SentenceMiningPipeline(jenc, use_ivf=False)
    min_score = 0.0
    if quantile is not None:
        min_score = _threshold([s for _, _, s in jmine(CORPUS, k=k)], quantile)
    want = jmine(CORPUS, k=k, min_score=min_score)
    got = SentenceMiningPipeline(enc, use_ivf=False, device="cpu")(CORPUS, k=k,
                                                                    min_score=min_score)
    assert len(want) > 100
    _assert_pairs_equal(got, want)


def test_query_mode_matches_jax(setup):
    """queries=: each query's top k over the corpus as (document, score,
    id), at or above min_score."""
    _, jenc, enc = setup
    queries = CORPUS[:4] + ["an unseen query of new words", "zz"]
    want = jax_search.SentenceMiningPipeline(jenc)(CORPUS, k=4, min_score=0.5, queries=queries)
    got = SentenceMiningPipeline(enc, device="cpu")(CORPUS, k=4, min_score=0.5, queries=queries)
    assert len(got) == len(want) == len(queries)
    for g, w in zip(got, want):
        assert [(d, i) for d, _, i in g] == [(d, i) for d, _, i in w]
        np.testing.assert_allclose([s for _, s, _ in g], [s for _, s, _ in w], atol=SCORE_TOL)
    assert [row[0][2] for row in got[:4]] == [0, 1, 2, 3]


def test_mine_with_index_matches_jax_mine_ivf(setup, shared_ivf, monkeypatch):
    """On one saved index and one embedding array: the port's post-query
    selection (k + 1 with the serving args, self-matches dropped by a
    stable sort, −1 / 0.0 where fewer remain) against the JAX package's
    ``_mine_ivf``."""
    _, jenc, enc = setup
    emb, jivf, tivf = shared_ivf
    _jax_ivf_through(monkeypatch, jivf)
    k = 5
    ws, wi = jax_search.SentenceMiningPipeline(jenc)._mine_ivf(jnp.asarray(emb), k)
    gs, gi = SentenceMiningPipeline(enc, device="cpu")._mine_with_index(
        tivf, torch.from_numpy(emb.copy()), k)
    assert gs.dtype == np.float32 and gi.dtype == np.int64 and gi.shape == (len(CORPUS), k)
    sep = _separated(ws)
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(gi[sep], wi[sep])
    np.testing.assert_allclose(gs, ws, atol=SCORE_TOL)
    assert not (gi == np.arange(len(CORPUS))[:, None]).any()


def test_ivf_route_matches_jax_on_a_shared_index(setup, shared_ivf, monkeypatch):
    """The whole IVF route (encode, the index, selection, dedupe, the
    min_score filter, the sort) with both packages' builds replaced by the
    shared index: the JAX package's pairs, scores within BF16_TOL (each
    package queries with its own encode)."""
    _, jenc, enc = setup
    _, jivf, tivf = shared_ivf
    _jax_ivf_through(monkeypatch, jivf)
    monkeypatch.setattr(port_search.IVFIndex, "build", classmethod(lambda cls, *a, **k: tivf))
    want = jax_search.SentenceMiningPipeline(jenc, use_ivf=True)(CORPUS, k=4)
    got = SentenceMiningPipeline(enc, use_ivf=True, device="cpu")(CORPUS, k=4)
    assert len(want) > 100
    _assert_pairs_equal(got, want, BF16_TOL)


def test_port_built_ivf_mining_recall_close_to_jax(setup, shared_ivf, monkeypatch):
    """k-means RNG differs: the port's own ``_mine_ivf`` (its build, bf16
    slabs) has recall@5 against the exact neighbours within 0.05 of the JAX
    package's ``_mine_ivf`` on its own build through the Pallas scan."""
    _, jenc, enc = setup
    emb = shared_ivf[0]
    cos = emb @ emb.T
    np.fill_diagonal(cos, -np.inf)
    exact = np.argsort(-cos, axis=1, kind="stable")[:, :5]
    real = JaxIVFIndex.query
    monkeypatch.setattr(JaxIVFIndex, "query", lambda self, q, **k: real(self, q, impl="pallas", **k))
    _, wi = jax_search.SentenceMiningPipeline(jenc)._mine_ivf(jnp.asarray(emb), 5)
    _, gi = SentenceMiningPipeline(enc, device="cpu")._mine_ivf(torch.from_numpy(emb.copy()), 5)
    r_jax, r_port = (np.mean([len(set(g) & set(e)) / 5 for g, e in zip(i, exact)])
                     for i in (wi, gi))
    assert abs(r_port - r_jax) <= 0.05, (r_port, r_jax)


def test_ivf_from_100k_documents(setup, monkeypatch):
    """use_ivf=None takes the IVF route from IVF_MIN_DOCS documents (100k,
    as the reference), the exact route below; queries= is always exact."""
    _, _, enc = setup
    routes = []
    real = SentenceMiningPipeline._mine_ivf
    monkeypatch.setattr(SentenceMiningPipeline, "_mine_ivf",
                        lambda self, e, k: routes.append(len(e)) or real(self, e, k))
    assert SentenceMiningPipeline.IVF_MIN_DOCS == 100_000
    miner = SentenceMiningPipeline(enc, device="cpu")
    miner(CORPUS[:120], k=2)
    assert routes == []
    monkeypatch.setattr(SentenceMiningPipeline, "IVF_MIN_DOCS", 120)
    miner(CORPUS[:120], k=2)
    miner(CORPUS[:120], k=2, queries=CORPUS[:2])
    assert routes == [120]


def test_compare_models_matches_jax(setup, tmp_path):
    """Teacher against an int8 student (the reference's quantize output,
    loaded dequantized) and against itself: the JAX package's JSON."""
    root, jenc, enc = setup
    jax_save_quantized(str(tmp_path / "q8"), jenc.params, meta={"pooling": "mean"})
    (tmp_path / "q8" / "arch.json").write_text((root / "enc" / "arch.json").read_text())
    jstudent = JaxSentenceEncoder.load(str(tmp_path / "q8"), bf16=False)
    jstudent.tokenizer = jenc.tokenizer
    student = SentenceEncoder.load(str(tmp_path / "q8"), bf16=False, device="cpu")
    student.tokenizer = enc.tokenizer
    docs, queries = CORPUS[:300], CORPUS[:40]
    want = jax_search.compare_models(jenc, jstudent, docs, queries, k=10)
    assert compare_models(enc, student, docs, queries, k=10, device="cpu") == want
    assert want["mean_topk_overlap"] < 1.0
    assert compare_models(enc, enc, docs, queries, k=5, device="cpu") == {
        "mean_topk_overlap": 1.0, "min_topk_overlap": 1.0, "k": 5}
