"""The port's native tokenizer and packer against its Python paths and the
JAX package: the C WordPiece matcher (many texts and the padded pthread
batch), the C first-fit placement, the packed layouts, the pair
methods and the HF ``tokenizer.json`` adapter. Every comparison of ids and
layouts is exact; embeddings of a JAX-saved encoder hold atol 1e-4, as in
``tests/test_torch_encoder.py``."""

import os
import threading

import numpy as np
import pytest
import torch

import jax

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data import packing as jax_packing
from text_similarity_tpu.data.tokenization import HFTokenizerAdapter as JaxHFAdapter
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.native import ffd_place_native as jax_ffd_native
from text_similarity_tpu_torch import native
from text_similarity_tpu_torch.data import packing
from text_similarity_tpu_torch.data.tokenization import (
    HFTokenizerAdapter,
    WordPieceTokenizer,
    load_tokenizer,
    train_wordpiece_vocab,
)
from text_similarity_tpu_torch.models import SentenceEncoder

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "internationalization and localization efforts",
    "tokenizers accelerate preprocessing pipelines",
    "unicode: naïve café résumé 東京 zürich",
    "byte pair encoding versus wordpiece segmentation",
] * 4

SURROGATES = ["alpha \ud800 beta", "al\udfffpha fox", "\ud83d"]


def _texts():
    """The cases of the JAX package's native tokenizer tests, plus lone
    surrogates (text that does not encode as UTF-8) and control bytes."""
    rng = np.random.RandomState(0)
    texts = CORPUS + [
        "completely unseen zzyzzyx words qqq",
        "MIXED Case And PUNCTUATION!!! with-hyphens and digits 12345",
        "",
        "a",
        "ё unicode ünïcödé ßtraße 日本語のテキスト",
        "x" * 150,                      # over max_word_chars → [UNK]
        "x" * 1100,                     # over the C word buffer → [UNK]
        "The quick brown fox JUMPS over, the lazy dog!",
        "punctuation,,,   here!  and-there...",
        "under_scores and 123 numbers",
        "café au lait — unicode résumé",
        "alpha\x1cbeta", "alpha\x1dbeta\x1egamma", "\x1falpha",   # str.split() spaces
        "nul\x00byte bell\x07 tab\tnew\nline\r\x0b\x0c",
        "word " * 200,                  # truncates
        "\u2026\u2026 \ufb01le 3\u338f",     # NFKC: more ids than characters
    ] + SURROGATES
    for _ in range(20):
        texts.append("".join(rng.choice(list("abcdefgh ij.km'no"), rng.randint(1, 80))))
    return texts


@pytest.fixture(scope="module")
def vocab():
    return train_wordpiece_vocab(CORPUS + ["alpha beta gamma word"], vocab_size=2048, min_freq=1)


@pytest.fixture(scope="module")
def toks(vocab):
    """(port native, port Python, JAX Python, JAX native)."""
    return (WordPieceTokenizer(vocab), WordPieceTokenizer(vocab, use_native=False),
            JaxTokenizer(vocab, use_native=False), JaxTokenizer(vocab, use_native=True))


def test_native_lib_builds_into_the_build_dir():
    lib = native.get_lib()
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libts_native_")
    assert path.exists() and lib is native.get_lib()


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises (no Python fallback), with
    cc's diagnostics in the message."""
    for name in native.SOURCES:
        (tmp_path / name).write_text("int broken( {\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="cc failed") as ei:
        native.build()
    assert "error" in str(ei.value)
    assert not list((tmp_path / "_build").iterdir())   # no temp file left


def test_concurrent_builds_agree(tmp_path, monkeypatch):
    """Builders racing on an empty build dir each compile into their own
    temp file and rename it into place: one library, loadable, no temp
    files left."""
    import ctypes

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    paths, errors = [], []

    def one():
        try:
            paths.append(native.build())
        except Exception as e:  # recorded, asserted below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and len(paths) == 3 and len(set(paths)) == 1
    assert not any(t.is_alive() for t in threads)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [paths[0].name]
    ctypes.CDLL(str(paths[0])).ffd_place   # loads and exports the packer


@pytest.mark.parametrize("method", ["tokenize_to_ids", "tokenize_many"])
def test_ids_equal_across_paths_and_packages(toks, method):
    nat, py, jpy, _ = toks
    assert nat._native is not None and py._native is None
    texts = _texts()
    if method == "tokenize_to_ids":
        for t in texts:
            want = jpy.tokenize_to_ids(t)
            assert nat.tokenize_to_ids(t) == want, repr(t)
            assert py.tokenize_to_ids(t) == want, repr(t)
    else:
        want = jpy.tokenize_many(texts)
        assert nat.tokenize_many(texts) == want
        assert py.tokenize_many(texts) == want


def test_tokenize_many_in_small_chunks(toks, monkeypatch):
    """The native tokenize_many cut into C calls of a few texts and cells
    (a text wider than the cell budget goes alone) equals the JAX
    package's Python ids, in the caller's order."""
    from text_similarity_tpu_torch.data import tokenization

    monkeypatch.setattr(tokenization, "_MANY_ROWS", 5)
    monkeypatch.setattr(tokenization, "_MANY_CELLS", 300)
    nat, _, jpy, _ = toks
    texts = _texts()[::-1]
    assert nat.tokenize_many(texts) == jpy.tokenize_many(texts)


@pytest.mark.parametrize("max_len", [2, 3, 16, 32, 300])
def test_encode_batch_equal_across_paths_and_packages(toks, max_len):
    """The pthread C batch (non-ASCII and surrogate rows through Python),
    the Python path and the JAX package's Python path: equal ids and
    masks, truncation included."""
    nat, py, jpy, _ = toks
    texts = _texts()
    want = jpy.encode_batch(texts, max_len=max_len)
    for tok in (nat, py):
        got = tok.encode_batch(texts, max_len=max_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_encode_batch_equals_jax_native_on_utf8_text(toks):
    """Where the JAX package's native path runs (text that encodes as
    UTF-8), the port's native batch equals it."""
    nat, _, _, jnat = toks
    texts = [t for t in _texts() if t not in SURROGATES]
    for g, w in zip(nat.encode_batch(texts, max_len=24), jnat.encode_batch(texts, max_len=24)):
        np.testing.assert_array_equal(g, w)


def test_encode_batch_pad_to(toks):
    nat, py, jpy, _ = toks
    texts = CORPUS[:5]
    for pad_to in (40, 70):
        want = jpy.encode_batch(texts, max_len=64, pad_to=pad_to)
        for tok in (nat, py):
            for g, w in zip(tok.encode_batch(texts, max_len=64, pad_to=pad_to), want):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="pad_to"):
        nat.encode_batch(texts, max_len=64, pad_to=3)


@pytest.mark.parametrize("n_threads", [1, 7, 64])
def test_encode_batch_padded_truncation_and_threads(n_threads):
    """Every row truncates at max_len; the thread count changes nothing;
    the arrays equal the JAX package's native call."""
    vocab = train_wordpiece_vocab(["word " * 50], 128, min_freq=1)
    tok = WordPieceTokenizer(vocab)
    jtok = JaxTokenizer(vocab, use_native=True)
    texts = ["word " * 200] * 64 + ["a word", ""]
    got = tok._native.encode_batch_padded(texts, 16, tok.cls_id, tok.sep_id, tok.pad_id,
                                          n_threads=n_threads)
    want = jtok._native.encode_batch_padded(texts, 16, tok.cls_id, tok.sep_id, tok.pad_id,
                                            n_threads=n_threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids, mask, lens, needs = got
    assert ids.shape == (66, 16) and (lens[:64] == 16).all() and not needs.any()
    assert (ids[:64, 0] == tok.cls_id).all() and (ids[:64, 15] == tok.sep_id).all()
    assert (ids[:64] == ids[0]).all()


def test_native_flags_non_ascii_and_surrogate_rows():
    """Rows the C batch does not take are flagged on the input's own test
    (a non-ASCII byte); a lone surrogate crosses as non-ASCII bytes."""
    tok = WordPieceTokenizer(train_wordpiece_vocab(["alpha beta"], 64, min_freq=1))
    texts = ["alpha beta", "café", "alpha \ud800", "beta"]
    *_, needs = tok._native.encode_batch_padded(texts, 8, tok.cls_id, tok.sep_id, tok.pad_id)
    assert needs.tolist() == [False, True, True, False]


def test_non_dense_vocab_ids(vocab):
    """Ids that are not 0..n-1 remap through the C side's positions."""
    sparse = {t: 3 * i + 1 for i, t in enumerate(vocab)}
    nat = WordPieceTokenizer(sparse)
    jpy = JaxTokenizer(sparse, use_native=False)
    texts = _texts()
    assert nat.tokenize_many(texts) == jpy.tokenize_many(texts)
    for g, w in zip(nat.encode_batch(texts, 20), jpy.encode_batch(texts, 20)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("max_len", [8, 16, 64])
def test_pair_methods_equal_jax(toks, max_len):
    """encode_pair_batch, encode_pair_rows (longest-first truncation) and
    encode_bodies equal the JAX package's, on both port paths."""
    nat, py, jpy, _ = toks
    texts = _texts()
    a, b = texts, texts[::-1]
    want_batch = jpy.encode_pair_batch(a, b, max_len=max_len)
    want_rows = jpy.encode_pair_rows(a, b, max_len=max_len)
    want_bodies = jpy.encode_bodies(a, max_len - 3)
    for tok in (nat, py):
        for g, w in zip(tok.encode_pair_batch(a, b, max_len=max_len), want_batch):
            np.testing.assert_array_equal(g, w)
        assert tok.encode_pair_rows(a, b, max_len=max_len) == want_rows
        for g, w in zip(tok.encode_bodies(a, max_len - 3), want_bodies):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,width", [(0, 32), (1, 128), (2, 256), (3, 7)])
def test_ffd_place_native_equals_python_and_jax(seed, width):
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(-2, width + 5, 3000))[::-1].astype(np.int32)
    want = packing._ffd_place_py(lens, width)
    for got in (native.ffd_place_native(lens, width), jax_ffd_native(lens, width),
                jax_packing._ffd_place_py(lens, width)):
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)


def test_ffd_place_native_empty():
    r, row, slot, off = native.ffd_place_native(np.zeros(0, np.int32), 16)
    assert r == 0 and row.shape == slot.shape == off.shape == (0,)


def _assert_layouts_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("n", [0, 5, 511, 512, 2000])
def test_pack_sequences_equals_jax(n, monkeypatch):
    """Below NATIVE_MIN the Python placement runs, from it up the C one:
    the layout equals the JAX package's either way, with and without token
    types."""
    calls = []
    real = packing.ffd_place_native
    monkeypatch.setattr(packing, "ffd_place_native",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(n)
    rows = [rng.integers(1, 500, rng.integers(1, 90)).tolist() for _ in range(n)]
    types = [[i % 2 for i in range(len(r))] for r in rows]
    for width in (64, 128):
        _assert_layouts_equal(packing.pack_sequences(rows, width, pad_id=0, row_types=types),
                              jax_packing.pack_sequences(rows, width, pad_id=0, row_types=types))
        _assert_layouts_equal(packing.pack_sequences(rows, width, pad_id=3),
                              jax_packing.pack_sequences(rows, width, pad_id=3))
    assert bool(calls) == (n >= packing.NATIVE_MIN)


@pytest.mark.parametrize("n", [40, 3000])
def test_pack_pair_arrays_equals_jax(toks, n):
    nat = toks[0]
    rng = np.random.default_rng(n)
    texts = _texts()
    a = [texts[i] for i in rng.integers(0, len(texts), n)]
    b = [texts[i] for i in rng.integers(0, len(texts), n)]
    ba, la = nat.encode_bodies(a, 61)
    bb, lb = nat.encode_bodies(b, 61)
    kw = dict(cls_id=nat.cls_id, sep_id=nat.sep_id, pad_id=nat.pad_id, max_len=64)
    _assert_layouts_equal(packing.pack_pair_arrays(ba, la, bb, lb, 64, **kw),
                          jax_packing.pack_pair_arrays(ba, la, bb, lb, 64, **kw))


# ---------------------------------------------------------------------------
# HF tokenizer.json
# ---------------------------------------------------------------------------

def _save_hf_tokenizer(vocab, path):
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])],
    )
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))


@pytest.fixture(scope="module")
def hf_dir(vocab, tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    _save_hf_tokenizer(vocab, str(d))
    return str(d)


@pytest.mark.parametrize("max_len", [6, 16, 128])
def test_hf_adapter_equals_jax(hf_dir, max_len):
    """load_tokenizer prefers tokenizer.json; the adapter's padded batches
    equal the JAX package's adapter, and a truncated row ends in [SEP]."""
    tok = load_tokenizer(hf_dir)
    jtok = JaxHFAdapter.from_file(os.path.join(hf_dir, "tokenizer.json"))
    assert isinstance(tok, HFTokenizerAdapter)
    assert (tok.pad_id, tok.cls_id, tok.sep_id, tok.unk_id, tok.mask_id, tok.vocab_size) == (
        jtok.pad_id, jtok.cls_id, jtok.sep_id, jtok.unk_id, jtok.mask_id, jtok.vocab_size)
    texts = [t for t in _texts() if t not in SURROGATES]
    for g, w in zip(tok.encode_batch(texts, max_len), jtok.encode_batch(texts, max_len)):
        np.testing.assert_array_equal(g, w)
    ids, mask, tts = tok.encode_pair_batch(texts, texts[::-1], max_len)
    for g, w in zip((ids, mask, tts), jtok.encode_pair_batch(texts, texts[::-1], max_len)):
        np.testing.assert_array_equal(g, w)
    lens = mask.sum(axis=1)
    assert (ids[np.arange(len(ids)), lens - 1] == tok.sep_id).all()
    assert lens.max() <= max_len


def test_load_tokenizer_without_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path))


def test_jax_saved_encoder_with_tokenizer_json_loads_and_encodes(vocab, tmp_path):
    """A JAX-saved SentenceEncoder directory whose tokenizer is a
    tokenizer.json loads in the port (the adapter) and encodes as the JAX
    package does, bucketed and packed (atol 1e-4)."""
    jtok = JaxTokenizer(vocab, use_native=False)
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=len(vocab))
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), jarch), jarch, tokenizer=jtok,
                              precision=JAX_FP32)
    d = str(tmp_path / "enc")
    jenc.save(d)
    os.remove(os.path.join(d, "vocab.txt"))
    _save_hf_tokenizer(vocab, d)
    jenc = JaxSentenceEncoder.load(d, bf16=False)
    enc = SentenceEncoder.load(d, bf16=False, device="cpu")
    assert isinstance(enc.tokenizer, HFTokenizerAdapter)
    texts = [t for t in _texts() if t not in SURROGATES]
    for packed in (False, True):   # max_len within the arch's 128 positions
        np.testing.assert_allclose(
            enc.encode(texts, max_len=64, packed=packed),
            np.asarray(jenc.encode(texts, max_len=64, packed=packed)), atol=1e-4,
        )
    assert torch.isfinite(torch.as_tensor(enc.encode(texts[:3]))).all()
