"""The port's density clustering, label-graph ops, reductions, clustering
and topic pipelines against the JAX package on the same numpy inputs
(seeded blobs on the unit sphere): DBSCAN and HDBSCAN labels exactly,
``adjacency_matvec`` / ``structured_logits`` / ``class_tfidf``, the
spectral reduction through its projector V·Vᵀ (eigenvectors of a repeated
eigenvalue are defined up to rotation), the pipelines' partitions up to
label permutation; the lexicon and profiling helpers; ``cluster`` and
``topics`` through the CLI."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import text_similarity_tpu.ops.density as JDen
import text_similarity_tpu.ops.segment as JSeg
import text_similarity_tpu.pipelines.topic as JTopic
import text_similarity_tpu.utils.lexicon as JLex
from text_similarity_tpu.pipelines.clustering import ClusteringPipeline as JaxClustering
import text_similarity_tpu_torch.ops.density as TDen
import text_similarity_tpu_torch.ops.segment as TSeg
import text_similarity_tpu_torch.pipelines.topic as TTopic
import text_similarity_tpu_torch.utils.lexicon as TLex
from text_similarity_tpu_torch.cli.main import main
from text_similarity_tpu_torch.core.config import ARCH_PRESETS
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, init_params
from text_similarity_tpu_torch.pipelines import ClusteringPipeline
from text_similarity_tpu_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOPIC_WORDS = [["cat", "dog", "horse", "kitten", "puppy"],
               ["car", "truck", "bicycle", "bike", "road"],
               ["apple", "banana", "bread", "fruit", "bakery"],
               ["eagle", "sparrow", "nest", "wing", "feather"]]


def _blobs(sizes, spreads, d=32, seed=0, n_noise=0):
    """Unit vectors around one random centre a blob (gaussian spread), then
    ``n_noise`` uniform directions → (N, d) f32, the blob of each row (−1
    for noise)."""
    rng = np.random.default_rng(seed)
    rows, owner = [], []
    for b, (n, s) in enumerate(zip(sizes, spreads)):
        c = rng.standard_normal(d)
        rows.append(c / np.linalg.norm(c) + s * rng.standard_normal((n, d)) / np.sqrt(d))
        owner += [b] * n
    rows.append(rng.standard_normal((n_noise, d)))
    owner += [-1] * n_noise
    x = np.concatenate(rows)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32), np.asarray(owner)


def _same_partition(a, b):
    """Equal up to a one-to-one relabelling (noise −1 kept as it is)."""
    a, b = np.asarray(a), np.asarray(b)
    if not np.array_equal(a < 0, b < 0):
        return False
    pairs = set(zip(a[a >= 0].tolist(), b[b >= 0].tolist()))
    return len(pairs) == len({p for p, _ in pairs}) == len({q for _, q in pairs})


# ---------------------------------------------------------------------------
# density clustering and segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps,min_samples,chunk", [(0.3, 5, 1024), (0.15, 3, 16), (0.6, 8, 40)])
def test_dbscan_labels_equal_jax(eps, min_samples, chunk):
    x, _ = _blobs([30, 20, 25], [0.4, 0.2, 0.6], n_noise=15, seed=1)
    got = TDen.dbscan_cosine(torch.from_numpy(x), eps=eps, min_samples=min_samples, chunk=chunk)
    want = JDen.dbscan_cosine(jnp.asarray(x), eps=eps, min_samples=min_samples, chunk=chunk)
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 1 and (got == -1).any()


def test_dbscan_counts_its_sweeps():
    """``dbscan_cosine.sweeps``: a cap of one sweep stops after one, with
    the JAX package's labels under the same cap; uncapped, the last sweep
    is the one that changed nothing, so there are at least two."""
    x, _ = _blobs([30, 20, 25], [0.4, 0.2, 0.6], n_noise=15, seed=1)
    got = TDen.dbscan_cosine(torch.from_numpy(x), eps=0.3, min_samples=5, max_sweeps=1)
    assert TDen.dbscan_cosine.sweeps == 1
    np.testing.assert_array_equal(
        got, JDen.dbscan_cosine(jnp.asarray(x), eps=0.3, min_samples=5, max_sweeps=1))
    TDen.dbscan_cosine(torch.from_numpy(x), eps=0.3, min_samples=5)
    assert 2 <= TDen.dbscan_cosine.sweeps <= len(x)


def test_hdbscan_labels_equal_jax():
    """Blobs of three densities and uniform noise: the multi-ε selection
    gives the same labels, and each blob its own cluster."""
    x, owner = _blobs([40, 30, 30], [0.15, 0.35, 0.7], n_noise=20, seed=2)
    got = TDen.hdbscan_cosine(torch.from_numpy(x), min_samples=4)
    want = JDen.hdbscan_cosine(jnp.asarray(x), min_samples=4)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[owner >= 0].tolist()) - {-1}) == 3


def test_adjacency_matvec_and_structured_logits_equal_jax():
    rng = np.random.default_rng(3)
    c = 7
    src, dst = rng.integers(0, c, 20).astype(np.int32), rng.integers(0, c - 1, 20).astype(np.int32)
    w = rng.random(20).astype(np.float32)
    vals = rng.standard_normal((4, 3, c)).astype(np.float32)
    for normalize in (True, False):
        got = TSeg.adjacency_matvec(torch.from_numpy(vals), torch.from_numpy(src),
                                    torch.from_numpy(dst), torch.from_numpy(w), c, normalize)
        want = JSeg.adjacency_matvec(jnp.asarray(vals), jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(w), c, normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    logits = vals[:, 0]
    got = TSeg.structured_logits(torch.from_numpy(logits), torch.from_numpy(src),
                                 torch.from_numpy(dst), torch.from_numpy(w), alpha=0.3)
    want = JSeg.structured_logits(jnp.asarray(logits), jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(w), alpha=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _topic_docs(owner, seed=4):
    rng = np.random.default_rng(seed)
    common = ["the", "a", "and", "with", "near", "seen", "today"]
    return [" ".join(rng.choice(TOPIC_WORDS[o % 4] if o >= 0 else sum(TOPIC_WORDS, []), 4))
            + " " + " ".join(rng.choice(common, 3)) for o in owner]


def test_class_tfidf_equals_jax():
    owner = np.repeat([0, 1, 2, 3, -1], [6, 5, 4, 3, 2])
    docs = _topic_docs(owner)
    per = {}
    for d, o in zip(docs, owner):
        per.setdefault(int(o), []).append(d)
    got, want = TTopic.class_tfidf(per, top_n=5), JTopic.class_tfidf(per, top_n=5)
    assert got.keys() == want.keys()
    for t in want:
        assert [w for w, _ in got[t]] == [w for w, _ in want[t]]
        np.testing.assert_allclose([s for _, s in got[t]], [s for _, s in want[t]], rtol=1e-12)


# ---------------------------------------------------------------------------
# reductions and pipelines
# ---------------------------------------------------------------------------

def test_spectral_reduce_projector_equals_jax():
    """Three separated blobs: the k-NN graph has three components, so the
    eigenvalue 1 has multiplicity 3 and its eigenvectors are defined up to
    a rotation; their projector V·Vᵀ is not (atol 1e-4)."""
    x, _ = _blobs([25, 20, 15], [0.3, 0.3, 0.3], seed=5)
    got = TTopic.spectral_reduce(torch.from_numpy(x), 3, n_neighbors=6).numpy()
    want = np.asarray(JTopic.spectral_reduce(jnp.asarray(x), 3, n_neighbors=6))
    assert got.shape == want.shape == (60, 3)
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=1e-4)


class _Emb:
    """An encoder whose embeddings are fixed rows (the same numbers into
    both packages' pipelines)."""

    def __init__(self, emb, torch_out):
        self.emb, self.torch_out = emb, torch_out

    def encode(self, texts, batch_size=128, device_output=False):
        assert len(texts) == len(self.emb)
        return torch.from_numpy(self.emb) if self.torch_out else self.emb


@pytest.fixture(scope="module")
def corpus():
    """Four blobs in 64 dims, the documents of their topics, and the same
    blobs at zero spread (every row its blob's centre). k-means starts from
    random rows in both packages (different generators), and two centres
    drawn in one blob of spread rows split it for good; drawn on a
    duplicate row, one of them loses every tie (the first maximum wins),
    empties and is re-seeded, so k-means finds the four centres from any
    start."""
    x, owner = _blobs([30, 26, 22, 18], [0.25, 0.25, 0.25, 0.25], d=64, seed=6)
    xdup, _ = _blobs([30, 26, 22, 18], [0.0, 0.0, 0.0, 0.0], d=64, seed=6)
    return x, xdup, owner, _topic_docs(owner)


def test_clustering_pipeline_partition_equals_jax(corpus):
    _, x, owner, docs = corpus
    got = ClusteringPipeline(_Emb(x, True), num_clusters=4)(docs)
    want = JaxClustering(_Emb(x, False), num_clusters=4)(docs)
    by_text = {}
    for cid, texts in got.items():
        for t in texts:
            by_text.setdefault(t, cid)
    as_sets = lambda cl: sorted(sorted(v) for v in cl.values())  # noqa: E731
    assert as_sets(got) == as_sets(want)
    assert _same_partition([by_text[d] for d in docs], owner)
    assignments = ClusteringPipeline(_Emb(x, True), num_clusters=4).assignments(docs)
    assert _same_partition(assignments, owner)


@pytest.mark.parametrize("method,reduce", [("kmeans", "none"), ("hdbscan", "spectral"),
                                           ("density", "pca")])
def test_topic_pipeline_partition_equals_jax(corpus, method, reduce):
    """The same partition up to label permutation, each topic's c-TF-IDF
    words and sizes under that relabelling, and the lexicon's names;
    k-means on the zero-spread blobs, unreduced (a reduction would give
    the duplicates rounding noise, and near-ties split a blob)."""
    x, xdup, owner, docs = corpus
    if method == "kmeans":
        x = xdup
    kw = dict(num_topics=4, reduce_dim=0 if reduce == "none" else 8, method=method,
              reduce=reduce, density_eps=0.3, spectral_neighbors=8)
    got = TTopic.TopicModelingPipeline(_Emb(x, True), lexicon=TLex.demo_lexicon(), **kw)(docs)
    want = JTopic.TopicModelingPipeline(_Emb(x, False), lexicon=JLex.demo_lexicon(), **kw)(docs)
    assert _same_partition(got["assignments"], want["assignments"])
    if method != "hdbscan":       # the multi-ε selection may keep sub-clusters of a blob
        assert _same_partition(got["assignments"], owner)
    relabel = dict(zip(np.asarray(got["assignments"]).tolist(),
                       np.asarray(want["assignments"]).tolist()))
    assert {relabel[t]: n for t, n in got["sizes"].items()} == want["sizes"]
    for t, words in got["topics"].items():
        assert [w for w, _ in words] == [w for w, _ in want["topics"][relabel[t]]]
        assert got["names"][t] == want["names"][relabel[t]]
    assert got["centroids"].shape == np.asarray(want["centroids"]).shape
    merged = TTopic.TopicModelingPipeline(_Emb(x, True), **kw).reduce_topics(got, docs, 2)
    jmerged = JTopic.TopicModelingPipeline(_Emb(x, False), **kw).reduce_topics(want, docs, 2)
    assert _same_partition(merged["assignments"], jmerged["assignments"])


# ---------------------------------------------------------------------------
# lexicon, profiling
# ---------------------------------------------------------------------------

def test_lexicon_names_equal_jax(tmp_path):
    lex, jlex = TLex.demo_lexicon(), JLex.demo_lexicon()
    topics = {0: [("dog", 1.0), ("cat", 0.9), ("kitten", 0.5)],
              1: [("car", 1.0), ("bike", 0.8), ("apple", 0.1)],
              2: [("bread", 1.0), ("banana", 0.7), ("eagle", 0.2)], 3: [("zzz", 1.0)]}
    assert TLex.name_topics(topics, lex) == JLex.name_topics(topics, jlex)
    assert TLex.name_topics(topics, lex)[0][0] == "mammal"
    lex.to_json(str(tmp_path / "lex.json"))
    again = TLex.Lexicon.from_json(str(tmp_path / "lex.json"))
    assert TLex.common_hypernyms_for_words(["dog", "eagle", "car"], again) == \
        JLex.common_hypernyms_for_words(["dog", "eagle", "car"], jlex)
    errors = []
    for cls in (TLex.Lexicon, JLex.Lexicon):
        with pytest.raises((LookupError, ImportError)) as e:
            cls.from_wordnet()
        errors.append(type(e.value))
    assert errors[0] is errors[1]


def test_profiling_helpers(tmp_path):
    x = torch.arange(6.0)
    with profiling.span("ts.outside"):        # no profiler: nothing recorded
        x.sum()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("ts.inside"):
            (x * 2).sum()
    assert (tmp_path / "trace" / "trace.json").exists() and prof.key_averages()
    with open(tmp_path / "trace" / "trace.json", encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert "ts.inside" in names and "ts.outside" not in names


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cluster_and_topics_commands(corpus, tmp_path, capsys):
    docs = corpus[3]
    (tmp_path / "docs.txt").write_text("\n".join(docs) + "\n")
    main(["cluster", "--corpus", str(tmp_path / "docs.txt"), "--num-clusters", "4", "--arch",
          "tiny-test", "--vocab-size", "256", "--fp32", "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["cluster"] for r in rows] == sorted(r["cluster"] for r in rows)
    assert sum(r["size"] for r in rows) == len(docs) and len(rows) <= 4
    assert all(0 < len(r["examples"]) <= 5 for r in rows)

    tok = WordPieceTokenizer(train_wordpiece_vocab(docs, 256, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch, tokenizer=tok,
                    precision=FP32_PRECISION, device="cpu").save(str(tmp_path / "enc"))
    TLex.demo_lexicon().to_json(str(tmp_path / "lex.json"))
    for method, reduce in (("kmeans", "pca"), ("hdbscan", "spectral")):
        main(["topics", "--model", str(tmp_path / "enc"), "--corpus", str(tmp_path / "docs.txt"),
              "--num-topics", "4", "--method", method, "--reduce", reduce, "--lexicon",
              str(tmp_path / "lex.json"), "--fp32", "--device", "cpu"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines and sum(int(line.split()[1]) for line in lines) == len(docs)
        if method == "kmeans":
            assert len(lines) <= 4
