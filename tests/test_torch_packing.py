"""Packed variable-length encode in the port against the JAX package: the
packing layouts (``pack_sequences``, ``pack_pair_arrays``, the FFD
placement) array for array, the segment pools, segment-masked attention,
``embed_tokens_packed`` and ``encode(packed=True | "auto")``, and the
``"auto"`` route rule on the reference's own three cases."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import EncoderArch as JaxArch
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data import packing as jax_packing
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models import pooling as jax_pooling
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.ops.attention import attention_reference as jax_attention
from text_similarity_tpu_torch.core.config import EncoderArch
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data import pack_pair_arrays, pack_sequences, packing_efficiency
from text_similarity_tpu_torch.data.packing import _ffd_place_py
from text_similarity_tpu_torch.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu_torch.models import (
    SentenceEncoder,
    params_from_jax,
    segment_first_pool,
    segment_mean_pool,
)
from text_similarity_tpu_torch.ops.attention import attention_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rows(n, seed, max_len=90, vocab=1000):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(5, vocab, int(rng.integers(1, max_len)))) for _ in range(n)]


def _assert_layouts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        assert got[key].dtype == np.asarray(want[key]).dtype, key


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,width,seed,pad_id", [
    (1, 16, 0, 0), (37, 32, 1, 0), (200, 64, 2, 3), (600, 128, 3, 1), (0, 32, 4, 0),
])
@pytest.mark.parametrize("with_types", [False, True])
def test_pack_sequences_matches_reference(n, width, seed, pad_id, with_types):
    """Every array equal to the reference's, rows longer than the width
    truncated (lengths up to 90 against widths 16-128), ``pad_id`` ≠ 0 and
    ``row_types``; 600 rows take the reference's native placement there,
    the Python one here."""
    rows = _rows(n, seed)
    types = ([list(np.arange(len(r)) % 2) for r in rows] if with_types else None)
    got = pack_sequences(rows, width, pad_id=pad_id, row_types=types)
    want = jax_packing.pack_sequences(rows, width, pad_id=pad_id, row_types=types)
    _assert_layouts_equal(got, want)
    assert packing_efficiency(got) == jax_packing.packing_efficiency(want) if n else True


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ffd_place_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(0, 140, 300))[::-1].astype(np.int32)
    for width in (32, 128):
        got = _ffd_place_py(lens, width)
        want = jax_packing._ffd_place_py(lens, width)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,width,max_len,seed", [(50, 64, None, 0), (300, 128, 96, 1), (0, 64, None, 2)])
def test_pack_pair_arrays_matches_reference(n, width, max_len, seed):
    """Pairs with sides over the budget on either side and both, the pair
    budget from ``max_len``; every array equal."""
    rng = np.random.default_rng(seed)
    la, lb = rng.integers(1, 80, n), rng.integers(1, 80, n)
    ids_a = rng.integers(5, 900, (n, 80)).astype(np.int32)
    ids_b = rng.integers(5, 900, (n, 80)).astype(np.int32)
    args = (ids_a, la, ids_b, lb, width)
    kw = dict(cls_id=2, sep_id=3, pad_id=1, max_len=max_len)
    _assert_layouts_equal(pack_pair_arrays(*args, **kw),
                          jax_packing.pack_pair_arrays(*args, **kw))


# ---------------------------------------------------------------------------
# segment pools and segment-masked attention
# ---------------------------------------------------------------------------

def _packed_hidden(seed=0, rows=20, width=32, hidden=24):
    packed = pack_sequences(_rows(rows * 3, seed, max_len=20), width)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((packed["ids"].shape[0], width, hidden)).astype(np.float32)
    return h, packed["segments"], packed["owners"].shape[1]


@pytest.mark.parametrize("extra_slots", [0, 3])
def test_segment_pools_match_reference(extra_slots):
    """Mean and first-token pools per segment, empty slots zero; f32 atol
    1e-6 (one f32 einsum and a divide on both sides)."""
    h, segs, m = _packed_hidden()
    m += extra_slots
    for port, ref in ((segment_mean_pool, jax_pooling.segment_mean_pool),
                      (segment_first_pool, jax_pooling.segment_first_pool)):
        got = port(torch.from_numpy(h), torch.from_numpy(segs), m).numpy()
        want = np.asarray(ref(jnp.asarray(h), jnp.asarray(segs), m))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)
    if extra_slots:
        assert not segment_mean_pool(torch.from_numpy(h), torch.from_numpy(segs), m)[:, -1].any()


def test_segment_attention_matches_reference_and_isolates_segments():
    """``attention_reference`` with ``segment_ids`` (and a padding mask)
    against the reference's, f32 atol 1e-6; changing another segment's keys
    and values leaves a segment's outputs as they were."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32) for _ in range(3))
    segs = np.array([[1] * 5 + [2] * 7 + [3] * 2 + [0] * 2, [1] * 9 + [2] * 7], np.int32)
    mask = (segs > 0).astype(np.int32)
    got = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
                              segment_ids=torch.from_numpy(segs)).numpy()
    want = np.asarray(jax_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask),
                                    segment_ids=jnp.asarray(segs)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    k2, v2 = k.copy(), v.copy()
    k2[0, 5:12] = rng.standard_normal((7, 2, 8))
    v2[0, 5:12] = rng.standard_normal((7, 2, 8))
    again = attention_reference(*(torch.from_numpy(x) for x in (q, k2, v2)), torch.from_numpy(mask),
                                segment_ids=torch.from_numpy(segs)).numpy()
    np.testing.assert_allclose(again[0, :5], got[0, :5], atol=1e-6)
    np.testing.assert_allclose(again[0, 12:14], got[0, 12:14], atol=1e-6)
    assert np.abs(again[0, 5:12] - got[0, 5:12]).max() > 1e-3


# ---------------------------------------------------------------------------
# the encoder on packed rows
# ---------------------------------------------------------------------------

def _tiny_pair(**changes):
    """A tiny f32 encoder in both packages, the same weights."""
    jarch = JAX_PRESETS["tiny-test"].replace(**changes)
    arch = EncoderArch.from_json(jarch.to_json())
    jp = jax.device_get(jax_init(jax.random.PRNGKey(5), jarch))
    jenc = JaxSentenceEncoder(jp, jarch, precision=JAX_FP32)
    enc = SentenceEncoder(params_from_jax(jp, arch), arch, precision=FP32_PRECISION, device="cpu")
    return jenc, enc


@pytest.mark.parametrize("changes", [
    {},
    {"pad_token_id": 1, "position_offset": 2},   # RoBERTa positions
    {"projection_dim": 16},                      # a projection head
])
def test_embed_tokens_packed_matches_jax(changes):
    """(R, M, D) slot embeddings of one packed layout, f32 atol 2e-5, empty
    slots zero in both."""
    jenc, enc = _tiny_pair(**changes)
    rows = _rows(30, seed=7, max_len=24, vocab=jenc.arch.vocab_size)
    packed = pack_sequences(rows, 32, pad_id=jenc.arch.pad_token_id)
    args = (packed["ids"], packed["segments"], packed["positions"])
    got = enc.embed_tokens_packed(*args).numpy()
    want = np.asarray(jenc.embed_tokens_packed(*args))
    assert got.shape == want.shape == (*packed["owners"].shape, jenc.arch.embedding_size)
    np.testing.assert_allclose(got, want, atol=2e-5)
    empty = packed["owners"] < 0
    assert not got[empty].any() and not want[empty].any()


def _tok_encoders(tmp_path, pooling="mean"):
    """The reference's text-level test encoder (tests/test_packing.py
    ``_tok_encoder``), saved by the JAX package and loaded by the port."""
    corpus = [
        "the quick brown fox jumps over the lazy dog",
        "a fast dark fox leaped over a sleepy dog",
        "semantic similarity of sentences on tensor units",
        "the dog sleeps while the fox runs far away",
    ] * 3
    tok = JaxTokenizer(train_wordpiece_vocab(corpus, vocab_size=256, min_freq=1))
    arch = JaxArch(
        vocab_size=300, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position=64, has_pooler=False, hidden_dropout=0.0, attention_dropout=0.0,
    )
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), arch), arch, tokenizer=tok,
                              pooling=pooling, precision=JAX_FP32)
    jenc.save(str(tmp_path))
    return jenc, SentenceEncoder.load(str(tmp_path), bf16=False, device="cpu"), corpus


def _count_packed(monkeypatch, enc):
    """Count the port encoder's packed-route calls."""
    calls = []
    inner = enc._encode_packed_rows

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(enc, "_encode_packed_rows", counted)
    return calls


def _jax_packed_used(jenc):
    return any(isinstance(key, tuple) and key and key[0] == "packed" for key in jenc._jit_cache)


def test_encode_packed_and_auto_match_jax(tmp_path, monkeypatch):
    """The reference's first auto case: 24 short texts against max_len 64
    pack under "auto" in both packages; packed=True, "auto" and the
    bucketed route all agree with the JAX encode, f32 atol 2e-5."""
    jenc, enc, corpus = _tok_encoders(tmp_path)
    texts = corpus * 2
    calls = _count_packed(monkeypatch, enc)
    bucketed = enc.encode(texts, max_len=64, packed=False)
    assert not calls
    want = np.asarray(jenc.encode(texts, max_len=64, packed=False))
    np.testing.assert_allclose(bucketed, want, atol=2e-5)
    got_auto = enc.encode(texts, max_len=64)
    assert len(calls) == 1
    assert _jax_packed_used(jenc) is False
    want_auto = np.asarray(jenc.encode(texts, max_len=64))
    assert _jax_packed_used(jenc)
    np.testing.assert_allclose(got_auto, want_auto, atol=2e-5)
    np.testing.assert_allclose(enc.encode(texts, max_len=64, packed=True),
                               np.asarray(jenc.encode(texts, max_len=64, packed=True)), atol=2e-5)
    np.testing.assert_allclose(got_auto, bucketed, atol=2e-5)
    got = enc.encode_packed(texts, width=64, rows_per_batch=2, max_len=64, max_segments=8)
    np.testing.assert_allclose(
        got, np.asarray(jenc.encode_packed(texts, width=64, rows_per_batch=2, max_len=64,
                                           max_segments=8)), atol=2e-5)


@pytest.mark.parametrize("case", ["short", "cls_pooling", "near_full", "few_texts"])
def test_auto_route_matches_reference(tmp_path, monkeypatch, case):
    """The route ``packed="auto"`` takes, in the reference's three auto
    tests (short texts pack; cls pooling stays bucketed; texts that fill
    their bucket stay bucketed) and with 8 texts (never packed), is the
    reference's."""
    jenc, enc, corpus = _tok_encoders(tmp_path, pooling="cls" if case == "cls_pooling" else "mean")
    calls = _count_packed(monkeypatch, enc)
    if case == "near_full":
        texts = [" ".join(["the quick brown fox jumps over the lazy dog"] * 3)] * 12
        kw = dict(max_len=32, batch_size=12)
    else:
        texts = {"short": corpus * 2, "cls_pooling": corpus, "few_texts": corpus[:8]}[case]
        kw = dict(max_len=64)
    got = enc.encode(texts, **kw)
    want = np.asarray(jenc.encode(texts, **kw))
    assert bool(calls) == _jax_packed_used(jenc) == (case == "short")
    rows = enc._tokenize_rows(texts, kw["max_len"])
    assert enc.use_packed(rows, kw.get("batch_size", 128), (16, 32, 64, 128, 256, 512)) == bool(calls)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_route_counts_tail_batches_full():
    """The rule counts a tail batch at its full ``batch_size`` as the
    reference does, though the port drops its padding rows: 9 rows of 30
    tokens in 32-wide buckets pack with batch_size 128 (4096 bucketed
    tokens against 1.3 × 9 packed rows × 32) and stay bucketed with
    batch_size 9 (288 tokens); 8 rows never pack."""
    _, enc = _tiny_pair()
    rows = [[1] * 30] * 9
    assert enc.use_packed(rows, 128, (16, 32, 64))
    assert not enc.use_packed(rows, 9, (16, 32, 64))
    assert not enc.use_packed(rows[:8], 128, (16, 32, 64))


def test_device_output_empty_and_guards(tmp_path):
    """``device_output`` gives the host result as a tensor (the trash row
    dropped), empty input gives (0, D) on both routes, packed=True refuses
    cls pooling, and a ``max_segments`` below the layout's raises."""
    _, enc, corpus = _tok_encoders(tmp_path)
    texts = corpus * 2
    host = enc.encode(texts, max_len=64, packed=True)
    dev = enc.encode(texts, max_len=64, packed=True, device_output=True)
    assert isinstance(dev, torch.Tensor) and dev.shape == (24, enc.embedding_dim)
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_allclose(np.linalg.norm(host, axis=1), 1.0, atol=1e-5)
    assert enc.encode([], packed=True).shape == (0, enc.embedding_dim)
    assert enc.encode_packed([]).shape == (0, enc.embedding_dim)
    with pytest.raises(ValueError, match="max_segments"):
        enc.encode_packed(texts, width=64, max_segments=1)
    enc.pooling = "cls"
    with pytest.raises(ValueError, match="mean pooling"):
        enc.encode(texts, max_len=64, packed=True)


def test_int8_encoder_takes_the_packed_route(tmp_path):
    """``to_int8`` on both sides: the packed encode agrees with the JAX
    int8 packed encode (f32 compute, atol 1e-4: per-token activation
    quantization sees the same tokens in either layout)."""
    jenc, enc, corpus = _tok_encoders(tmp_path)
    texts = corpus * 2
    jenc.to_int8()
    enc.to_int8()
    np.testing.assert_allclose(enc.encode(texts, max_len=64, packed=True),
                               np.asarray(jenc.encode(texts, max_len=64, packed=True)), atol=1e-4)
