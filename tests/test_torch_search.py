"""The search path end to end: a JAX-saved encoder and pipeline load into the port,
whose answers equal the JAX package's on the brute-force path (its own
pipeline) and on the IVF path (its Pallas scan with the serving args)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import IndexConfig as JaxIndexConfig
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.pipelines import SemanticSearchPipeline as JaxPipeline
from text_similarity_tpu.pipelines.search import _pad_pow2 as jax_pad_pow2
from text_similarity_tpu_torch.models import SentenceEncoder
from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
from text_similarity_tpu_torch.pipelines.search import _pad_pow2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}{chr(97 + i * 11 % 26)}{i}"
             for i in range(2000)]
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(rng.choice(words, rng.integers(8, 25)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX encoder plus a brute-force and an IVF pipeline, all saved."""
    corpus = _corpus(1500)
    jtok = JaxTokenizer(train_wordpiece_vocab(corpus, vocab_size=2000, min_freq=1))
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=jtok.vocab_size)
    jenc = JaxSentenceEncoder(
        jax_init(jax.random.PRNGKey(0), jarch), jarch, tokenizer=jtok, precision=JAX_FP32
    )
    root = tmp_path_factory.mktemp("search")
    jenc.save(str(root / "enc"))
    brute = JaxPipeline(jenc, corpus=corpus, use_ivf=False)
    brute.save(str(root / "brute"))
    ivf = JaxPipeline(
        jenc, corpus=corpus, use_ivf=True,
        index_config=JaxIndexConfig(num_clusters=16, num_probes=3, kmeans_iters=4),
    )
    ivf._build_ivf()
    ivf.save(str(root / "ivf"))
    return root, jenc, brute, ivf, corpus


def _port(root, name):
    enc = SentenceEncoder.load(str(root / "enc"), bf16=False, device="cpu")
    pipe = SemanticSearchPipeline(enc, use_ivf=(name == "ivf"), device="cpu")
    pipe.load_corpus(str(root / name))
    return pipe


def _requests(corpus):
    fresh = ["zz unseen words here", "another query that is new"]
    return [corpus[:1], corpus[5:8] + fresh[:1], corpus[100:106] + fresh]


@pytest.mark.parametrize("req", [0, 1, 2])
def test_brute_force_path_equals_jax(saved, req):
    """(document, id) equal to the JAX pipeline's, scores allclose 1e-5."""
    root, _, jpipe, _, corpus = saved
    pipe = _port(root, "brute")
    queries = _requests(corpus)[req]
    got = pipe(queries, max_num_results=5)
    want = jpipe(queries, max_num_results=5)
    assert [[(d, i) for d, _, i in r] for r in got] == [[(d, i) for d, _, i in r] for r in want]
    np.testing.assert_allclose(
        [[s for _, s, _ in r] for r in got], [[s for _, s, _ in r] for r in want], atol=1e-5
    )
    # verbatim corpus sentences find themselves first
    for q, r in zip(queries, got):
        if q in corpus:
            assert r[0][0] == q and r[0][1] > 0.999


@pytest.mark.parametrize("req", [0, 1, 2])
def test_ivf_path_equals_jax_pallas(saved, req):
    """The port's pipeline answers equal JAX ivf.query(impl="pallas") with
    the serving args on the same loaded index (ids equal, scores allclose
    1e-5: bf16 slabs, exact bf16 products on both sides)."""
    root, jenc, _, jpipe, corpus = saved
    pipe = _port(root, "ivf")
    queries = _requests(corpus)[req]
    got = pipe(queries, max_num_results=5)
    q_emb = jax_pad_pow2(jenc.encode(queries, device_output=True, packed=False))
    mc = jpipe.ivf.data_padded.shape[1]
    s, i = jpipe.ivf.query(
        q_emb, k=5, block_q=64, union_factor=1,
        approx_width=2048 if mc >= 1024 else 0, impl="pallas",
    )
    s, i = np.asarray(s), np.asarray(i)
    for r, row in enumerate(got):
        keep = (i[r] >= 0) & np.isfinite(s[r])
        assert [x[2] for x in row] == i[r][keep].tolist()
        assert [x[0] for x in row] == [corpus[j] for j in i[r][keep]]
        np.testing.assert_allclose([x[1] for x in row], s[r][keep], atol=1e-5)


def test_empty_queries(saved):
    root = saved[0]
    assert _port(root, "brute")([], max_num_results=3) == []
    assert _port(root, "ivf")([], max_num_results=3) == []


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_pad_pow2_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((n, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        _pad_pow2(torch.from_numpy(x)).numpy(), np.asarray(jax_pad_pow2(jnp.asarray(x)))
    )


def test_pipeline_save_load_roundtrip(saved, tmp_path):
    root, _, _, _, corpus = saved
    pipe = _port(root, "ivf")
    pipe.save(str(tmp_path))
    again = SemanticSearchPipeline(pipe.encoder, use_ivf=True, device="cpu")
    again.load_corpus(str(tmp_path))
    assert again(corpus[:4], 3) == pipe(corpus[:4], 3)
    # a document added to the loaded index goes into it (no rebuild)
    ivf = again.ivf
    assert again.add_documents(["one more document"]).tolist() == [len(corpus)]
    assert again.ivf is ivf and again(["one more document"], 1)[0][0][2] == len(corpus)


def test_add_documents_and_warmup(saved):
    root, _, _, _, corpus = saved
    enc = SentenceEncoder.load(str(root / "enc"), bf16=False, device="cpu")
    pipe = SemanticSearchPipeline(enc, corpus=corpus[:300], device="cpu")
    ids = pipe.add_documents(corpus[300:310])
    assert ids.tolist() == list(range(300, 310))
    assert pipe(corpus[305:306], 1)[0][0][2] == 305
    assert pipe.warmup(ks=(1, 5), max_queries=4) == 6
