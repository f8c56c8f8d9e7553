"""Exact top-k above the selectors' 256 winners: the port's entry points
at k ∈ {257, 300, 1000, N} against the JAX package's Pallas kernels in
interpret mode (K2, K3, K8), and the callers that fetch past 256 —
``BruteForceIndex.query`` (2k over-fetch), ``.mine`` past 300 tombstones and
``ShardedSearchPipeline`` after a query's 300 nearest documents are removed
— against the JAX package's. On the CPU each entry point runs its plain
version; the large-k kernels (``csrc/topk_select.cu``) are held to those
plain versions in test_torch_cuda.py. The wrapper's query chunks are
checked here with the kernel library replaced by a recorder."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import text_similarity_tpu.ops.topk as jax_topk
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.mesh import make_mesh as jax_make_mesh
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu.index.brute import BruteForceIndex as JaxBrute
from text_similarity_tpu.index.store import EmbeddingStore as JaxStore
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.pipelines import ShardedSearchPipeline as JaxShardedPipeline
from text_similarity_tpu_torch.core.mesh import make_mesh
from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
from text_similarity_tpu_torch.models import SentenceEncoder
from text_similarity_tpu_torch.ops import topk as topk_mod
from text_similarity_tpu_torch.ops.topk import (
    MAX_K,
    cosine_topk,
    cosine_topk_2pass,
    cosine_topk_int8,
    cosine_topk_large_cuda,
    select_topk,
)
from text_similarity_tpu_torch.pipelines import ShardedSearchPipeline
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 3001          # ragged against every block size
LARGE_K = [257, 300, 1000, N]


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _tied(n=N, d=64, q=8, seed=0):
    """Unit rows, each query's source row with two exact copies later in
    the corpus: three equal scores at the top of its list, and more
    copies of other rows further down (ties inside a large k)."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((n, d)))
    src = rng.choice(n // 3, size=q, replace=False)
    dst = rng.choice(np.arange(n // 3, n), size=2 * q + 200, replace=False)
    x[dst[:q]] = x[src]
    x[dst[q:2 * q]] = x[src]
    x[dst[2 * q:]] = x[rng.choice(n // 3, 200)]
    return _unit(x[src] + 0.05 * rng.standard_normal((q, d))), x


def _overlap(a, b):
    return np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)])


def _ids_equal_where_separated(got_s, got_i, want_s, want_i, gap=1e-6):
    """Scores allclose 1e-5, and ids equal at every rank whose reference
    score stands more than ``gap`` apart from its neighbours: the two
    frameworks' sums differ in the last bits, and the reference's host
    filter sorts ties in no set order."""
    got_s, got_i, want_s, want_i = (np.asarray(a) for a in (got_s, got_i, want_s, want_i))
    np.testing.assert_allclose(got_s, want_s, atol=1e-5)
    with np.errstate(invalid="ignore"):
        sep = np.minimum(np.abs(np.diff(want_s, axis=-1, prepend=np.inf)),
                         np.abs(np.diff(want_s, axis=-1, append=-np.inf))) > gap
    np.testing.assert_array_equal(got_i[sep], want_i[sep])


def _int8_store_pair(x):
    js = JaxStore(len(x), x.shape[1], quantized=True)
    ts = EmbeddingStore(len(x), x.shape[1], quantized=True, device="cpu")
    js.add(jnp.asarray(x))
    ts.add(torch.from_numpy(x))
    return js, ts


# ---------------------------------------------------------------------------
# K2, K3, K8 at every k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", LARGE_K)
def test_cosine_topk_large_k_matches_pallas_f32(k):
    """f32: ids equal (ties → lowest id), scores allclose 1e-5, at k past
    the selectors' 256 up to N."""
    q, x = _tied()
    ps, pi = jax_topk.cosine_topk_pallas(jnp.asarray(q), jnp.asarray(x), k=k, interpret=True)
    ts, ti = cosine_topk(torch.from_numpy(q), torch.from_numpy(x), k=k)
    assert ti.shape == (len(q), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-5)
    # the three copies of each query's source lead its list, lowest id first
    assert (np.diff(ti.numpy()[:, :3], axis=1) > 0).all()


def test_cosine_topk_large_k_matches_pallas_bf16():
    q, x = _tied(seed=1)
    xb = x.astype(ml_dtypes.bfloat16)
    ps, pi = jax_topk.cosine_topk_pallas(jnp.asarray(q), jnp.asarray(xb), k=300, interpret=True)
    ts, ti = cosine_topk(torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16), k=300)
    assert _overlap(ti.numpy(), np.asarray(pi)) >= 0.99
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-2)


@pytest.mark.parametrize("k", LARGE_K)
def test_cosine_topk_int8_large_k_matches_pallas(k):
    """K3's semantics ((q · float(c)) × scale, f32 queries): ids equal,
    scores allclose 1e-5."""
    q, x = _tied(seed=2)
    js, ts = _int8_store_pair(x)
    ps, pi = jax_topk.cosine_topk_pallas_int8(jnp.asarray(q), js.view, js.scales_view, k=k,
                                              interpret=True)
    gs, gi = cosine_topk_int8(torch.from_numpy(q), ts.view, ts.scales_view, k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ps), atol=1e-5)


@pytest.mark.parametrize("k", LARGE_K)
def test_cosine_topk_2pass_large_k_matches_pallas(k):
    """K8 at large k (past block_c 2048 the merge rounds repeat the lowest
    id at −inf, the certification fails and the call falls back to K2):
    ids equal, scores allclose 1e-5."""
    q, x = _tied(q=3, seed=3)
    js, ji = jax_topk.cosine_topk_pallas_2pass(jnp.asarray(q), jnp.asarray(x), k=k,
                                               interpret=True)
    before = cosine_topk_2pass.fallbacks
    ts, ti = cosine_topk_2pass(torch.from_numpy(q), torch.from_numpy(x), k=k)
    if k > 2048:
        assert cosine_topk_2pass.fallbacks == before + 1
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_k_outside_one_to_n_raises():
    q, x = _tied(n=500, q=2)
    for k in (0, 501):
        with pytest.raises(ValueError):
            cosine_topk(torch.from_numpy(q), torch.from_numpy(x), k=k)
        with pytest.raises(ValueError):
            cosine_topk_2pass(torch.from_numpy(q), torch.from_numpy(x), k=k)


def test_select_topk_past_max_k_orders_by_score_then_id():
    """The merge the sharded indexes run: (score desc, id asc) at k past
    256, ties everywhere (scores on a 1/8 grid, ids shuffled)."""
    rng = np.random.default_rng(4)
    s = np.round(rng.standard_normal((3, 2000)) * 8) / 8
    i = np.stack([rng.permutation(2000) for _ in range(3)]).astype(np.int32)
    ts, ti = select_topk(torch.from_numpy(s), torch.from_numpy(i), 700)
    order = np.lexsort((i, -s), axis=1)[:, :700]
    np.testing.assert_array_equal(ti.numpy(), np.take_along_axis(i, order, 1))
    np.testing.assert_array_equal(ts.numpy(), np.take_along_axis(s, order, 1))


class _LargeKRecorder:
    """Stands in for the kernel library: records each ``ts_topk_large``
    chunk (first query's offset, queries, k, splits, rows a split, ld)."""

    def __init__(self, q0_ptr):
        self.q0_ptr, self.calls = q0_ptr, []

    def ts_topk_large(self, q, corpus, kind, scales, qn, n, d, k, splits, rows, scores, ld,
                      *rest):
        self.calls.append(((q - self.q0_ptr) // (4 * d), qn, k, splits, rows, ld, kind))
        return 0


@pytest.mark.parametrize("q_n,n,budget_rows", [(10, 1000, 3), (1, 1001, 1), (300, 5003, 256)])
def test_large_k_wrapper_chunks_the_queries(monkeypatch, q_n, n, budget_rows):
    """The wrapper's chunks of queries cover every query once, in order,
    each chunk's (Qc, ld) f32 scores and the select's workspace within the
    budget (ld = N rounded up to 4), each on K2's score grid at k 1."""
    queries = torch.empty((q_n, 32))
    rec = _LargeKRecorder(queries.data_ptr())
    ld = -(-n // 4) * 4
    monkeypatch.setattr(topk_mod._cuda, "lib", lambda: rec)
    monkeypatch.setattr(topk_mod._cuda, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(topk_mod, "_SCORES_BYTES",
                        budget_rows * (ld * 4 + topk_mod._select_row_bytes(n, 300)))
    cosine_topk_large_cuda(queries, torch.empty((n, 32)), 300)
    starts = [c[0] for c in rec.calls]
    sizes = [c[1] for c in rec.calls]
    assert starts == list(np.cumsum([0] + sizes[:-1])) and sum(sizes) == q_n
    assert max(sizes) <= budget_rows
    for start, qn, k, splits, rows, got_ld, kind in rec.calls:
        assert (k, got_ld, kind) == (300, ld, 0)
        assert (splits, rows) == topk_mod._plan_topk(qn, n)[1:]


def test_max_k_only_chooses_the_route():
    """Every entry point takes 1 ≤ k ≤ N: MAX_K is the switch between the
    selectors and the large-k route, and no caller clamps a k to it."""
    import inspect

    from text_similarity_tpu_torch.index import sharded
    from text_similarity_tpu_torch.pipelines import search

    assert MAX_K == 256
    for mod in (sharded, search):
        assert "MAX_K" not in inspect.getsource(mod)


# ---------------------------------------------------------------------------
# The callers: brute-force query and mine, the sharded pipeline
# ---------------------------------------------------------------------------

def test_brute_force_query_k200_matches_jax():
    """``query(k=200)`` fetches 400 (the 2k over-fetch) past tombstones:
    the reference's answer (ids equal where the scores are separated, the
    same sets)."""
    q, x = _tied(n=2000, seed=5)
    js, ts = JaxStore(2000, 64), EmbeddingStore(2000, 64, device="cpu")
    js.add(jnp.asarray(x))
    ts.add(torch.from_numpy(x))
    dead = [int(i) for i in np.random.default_rng(5).choice(2000, 60, replace=False)]
    js.mark_deleted(dead)
    ts.mark_deleted(dead)
    want_s, want_i = JaxBrute(js).query(jnp.asarray(q), k=200)
    got_s, got_i = BruteForceIndex(ts).query(torch.from_numpy(q), k=200)
    assert got_i.shape == (len(q), 200)
    _ids_equal_where_separated(got_s, got_i, want_s, want_i)
    assert (np.sort(got_i, axis=1) == np.sort(np.asarray(want_i), axis=1)).mean() >= 0.99
    assert not np.isin(got_i, dead).any()


def test_brute_force_mine_past_300_tombstones_matches_jax():
    """``mine`` fetches k + 1 + dead rows: with 300 tombstones that is past
    256; ids equal the reference's, scores 1e-5, no dead id returned."""
    rng = np.random.default_rng(6)
    x = _unit(rng.standard_normal((900, 32)))
    x[800:850] = x[:50]
    js, ts = JaxStore(900, 32), EmbeddingStore(900, 32, device="cpu")
    js.add(jnp.asarray(x))
    ts.add(torch.from_numpy(x))
    dead = [int(i) for i in rng.choice(900, 300, replace=False)]
    js.mark_deleted(dead)
    ts.mark_deleted(dead)
    want_s, want_i = JaxBrute(js).mine(k=5, batch=256)
    got_s, got_i = BruteForceIndex(ts).mine(k=5, batch=256)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=1e-5)
    assert not np.isin(got_i, dead).any()


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"{chr(97 + i % 26)}{chr(97 + i * 11 % 26)}{i}" for i in range(900)]
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(rng.choice(words, rng.integers(5, 14)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def test_sharded_pipeline_after_300_nearest_removed_matches_jax(eight_devices, tmp_path):
    """Brute-force shards on 8 positions: a query's 300 nearest documents
    (a k = 300 answer) are removed; its k = 10 answer then over-fetches 512
    past the tombstones and returns 10 live rows, none removed, as the
    reference does (ids equal where the scores are separated: the tiny
    random encoder puts many documents within 1e-5 of each other)."""
    corpus = _texts(700, seed=8)
    tok = JaxTokenizer(train_wordpiece_vocab(corpus, vocab_size=900, min_freq=1))
    arch = JAX_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), arch), arch, tokenizer=tok,
                              precision=JAX_FP32)
    jenc.save(str(tmp_path / "enc"))
    enc = SentenceEncoder.load(str(tmp_path / "enc"), bf16=False, device="cpu")
    jpipe = JaxShardedPipeline(jenc, jax_make_mesh(data=1, index=8), corpus=corpus,
                               use_ivf=False)
    pipe = ShardedSearchPipeline(enc, make_mesh(data=1, index=8, devices=["cpu"] * 8),
                                 corpus=corpus, use_ivf=False)
    query = [corpus[3]]

    def answer(p, k):
        row = p(query, max_num_results=k)[0]
        return np.array([[s for _, s, _ in row]]), np.array([[i for _, _, i in row]])

    near_s, near_i = answer(pipe, 300)
    _ids_equal_where_separated(near_s, near_i, *answer(jpipe, 300))
    removed = near_i[0].tolist()
    assert pipe.remove_documents(removed) == 300 == jpipe.remove_documents(removed)
    got_s, got_i = answer(pipe, 10)
    _ids_equal_where_separated(got_s, got_i, *answer(jpipe, 10))
    assert got_i.shape == (1, 10) and not set(got_i[0]) & set(removed)


# ---------------------------------------------------------------------------
# The serving route past 256: RankingPipeline and SemanticSearchPipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_pair(tmp_path_factory):
    """The JAX package's and the port's brute-force search pipelines over
    450 texts (one JAX-saved tiny-test bi-encoder, f32) and one JAX-saved
    tiny-test cross-encoder (its random head scaled ×100, so that the
    rerank scores spread far beyond the tolerance), built once."""
    from text_similarity_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
    from text_similarity_tpu.pipelines import SemanticSearchPipeline as JaxPipeline
    from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
    from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline

    corpus = _texts(450, seed=22)
    tok = JaxTokenizer(train_wordpiece_vocab(corpus, vocab_size=900, min_freq=1))
    arch = JAX_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(22), arch), arch, tokenizer=tok,
                              precision=JAX_FP32)
    jce = JaxCrossEncoder.init(jax.random.PRNGKey(23), arch, tokenizer=tok, num_classes=1,
                               precision=JAX_FP32)
    jce.params["head"]["w"] = jce.params["head"]["w"] * 100.0
    enc_dir, ce_dir = tmp_path_factory.mktemp("enc"), tmp_path_factory.mktemp("ce")
    jenc.save(str(enc_dir))
    jce.save(str(ce_dir))
    enc = SentenceEncoder.load(str(enc_dir), bf16=False, device="cpu")
    ce = CrossEncoder.load(str(ce_dir), bf16=False, device="cpu")
    return (corpus, JaxPipeline(jenc, corpus=corpus, use_ivf=False), jce,
            SemanticSearchPipeline(enc, corpus=corpus, use_ivf=False, device="cpu"), ce)


def _same_rows(got, want):
    """(document, score, id) rows: ids and order equal, scores allclose
    1e-5."""
    assert [[(d, i) for d, _, i in r] for r in got] == [[(d, i) for d, _, i in r] for r in want]
    np.testing.assert_allclose([[s for _, s, _ in r] for r in got],
                               [[s for _, s, _ in r] for r in want], atol=1e-5)


def test_ranking_pipeline_retrieve_k200_matches_jax(serving_pair):
    """``RankingPipeline(retrieve_k=200)``: its search fetches 400 rows a
    query (the brute-force 2k over-fetch, past 256), then reranks; the
    port returns the JAX package's ids in its order."""
    from text_similarity_tpu.pipelines import RankingPipeline as JaxRankingPipeline
    from text_similarity_tpu_torch.pipelines import RankingPipeline

    corpus, jpipe, jce, pipe, ce = serving_pair
    queries = [corpus[7], "unseen words of a query"]
    want = JaxRankingPipeline(jpipe, jce, retrieve_k=200)(queries, top_k=200)
    got = RankingPipeline(pipe, ce, retrieve_k=200)(queries, top_k=200)
    assert [len(r) for r in got] == [200, 200]
    _same_rows(got, want)


def test_search_pipeline_one_query_150_results_matches_jax(serving_pair):
    """One query at ``max_num_results=150`` (a 300-row fetch): the JAX
    package's 150 rows, ids and order equal."""
    corpus, jpipe, _, pipe, _ = serving_pair
    got, want = pipe([corpus[11]], max_num_results=150), jpipe([corpus[11]], max_num_results=150)
    assert len(got[0]) == 150
    _same_rows(got, want)
