"""The long-document encode path against the JAX package: position
extension, RoBERTa positions, a tiny RoBERTa-like encoder converted for
long context (tiled positions, a band of 16 with a global CLS) through the
flash and the auto attention paths, and a JAX-saved long SentenceEncoder
loaded by the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models import mean_pool as jax_mean_pool
from text_similarity_tpu.models.encoder import embed_inputs as jax_embed_inputs
from text_similarity_tpu.models.hf_convert import extend_positions as jax_extend_positions
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu_torch.compress.quantize import quantize_params_int8
from text_similarity_tpu_torch.core.config import EncoderArch
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.batching import BUCKETS
from text_similarity_tpu_torch.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu_torch.models import (
    SentenceEncoder,
    embed_inputs,
    encoder_forward,
    mean_pool,
    params_from_jax,
)
from text_similarity_tpu_torch.models.hf_convert import extend_positions
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LONG_BUCKETS = BUCKETS + (1024, 2048, 4096)


def _roberta_tiny(vocab_size=1024):
    """tiny-test with RoBERTa's position offset, pad id and single token
    type (JAX arch)."""
    return JAX_PRESETS["tiny-test"].replace(
        position_offset=2, pad_token_id=1, type_vocab_size=1, vocab_size=vocab_size
    )


def _long_model(seed=0, vocab_size=1024):
    """JAX params of the tiny RoBERTa-like encoder, positions extended to
    514, band 16 with a global CLS → (numpy params, JAX arch, port arch)."""
    jarch = _roberta_tiny(vocab_size)
    params, jarch = jax_extend_positions(jax_init(jax.random.PRNGKey(seed), jarch), jarch, 514)
    jarch = jarch.replace(attention_window=16, window_global_cls=True)
    return jax.device_get(params), jarch, EncoderArch.from_json(jarch.to_json())


def _ragged(vocab, b, s, lens, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask + (1 - mask), mask   # padding carries the pad id 1


@pytest.mark.parametrize("offset", [0, 2])
def test_extend_positions_matches_jax(offset):
    """Offset rows kept once, the body tiled, cut to new_max: equal to the
    JAX package's table; the arch's max_position follows."""
    jarch = JAX_PRESETS["tiny-test"].replace(position_offset=offset)
    jp = jax.device_get(jax_init(jax.random.PRNGKey(1), jarch))
    want, want_arch = jax_extend_positions(jp, jarch, 514)
    tarch = EncoderArch.from_json(jarch.to_json())
    got, got_arch = extend_positions(params_from_jax(jp, tarch), tarch, 514)
    table = got["embeddings"]["position"]
    assert table.shape == (514, tarch.hidden_size) and got_arch.max_position == 514
    assert got_arch == EncoderArch.from_json(want_arch.to_json())
    np.testing.assert_array_equal(table.numpy(), np.asarray(want["embeddings"]["position"]))
    old = jp["embeddings"]["position"]
    np.testing.assert_array_equal(table[:offset].numpy(), old[:offset])
    np.testing.assert_array_equal(table[128:128 + 8].numpy(), old[offset:offset + 8])


def test_extend_positions_noop_and_int8():
    jarch = JAX_PRESETS["tiny-test"]
    tarch = EncoderArch.from_json(jarch.to_json())
    params = params_from_jax(jax.device_get(jax_init(jax.random.PRNGKey(2), jarch)), tarch)
    same, same_arch = extend_positions(params, tarch, 128)
    assert same is params and same_arch is tarch
    with pytest.raises(TypeError):
        extend_positions(quantize_params_int8(params), tarch, 512)


def test_roberta_embed_inputs_matches_jax():
    """RoBERTa positions cumsum(mask)·mask + pad_token_id on ragged masks
    (a zero-length row included): embeddings allclose 1e-5 in f32."""
    jp, jarch, tarch = _long_model()
    ids, mask = _ragged(tarch.vocab_size, 4, 40, (40, 23, 1, 0))
    want = jax_embed_inputs(
        jp["embeddings"], jnp.asarray(ids), jnp.asarray(mask), arch=jarch, precision=JAX_FP32
    )
    tp = params_from_jax(jp, tarch)
    got = embed_inputs(
        tp["embeddings"], torch.from_numpy(ids), torch.from_numpy(mask), arch=tarch,
        precision=FP32_PRECISION,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_long_encoder_matches_jax(impl):
    """The tiny long encoder at S 256 (band 16, global CLS), f32: pooled
    unit embeddings allclose 1e-4. ``flash``: the Pallas kernel in
    interpret mode against the port's plain K5; ``auto``: the banded
    reference on both sides (the CPU never takes flash by itself)."""
    jp, jarch, tarch = _long_model(seed=3)
    lens = (256, 181, 37)
    ids, mask = _ragged(tarch.vocab_size, 3, 256, lens, seed=1)
    jout = jax_forward(
        jp, jnp.asarray(ids), jnp.asarray(mask), arch=jarch, precision=JAX_FP32,
        attention_impl=impl,
    )
    je = np.asarray(jax_mean_pool(jout.last_hidden_state, jnp.asarray(mask)))
    tout = encoder_forward(
        params_from_jax(jp, tarch), torch.from_numpy(ids), torch.from_numpy(mask),
        arch=tarch, precision=FP32_PRECISION, attention_impl=impl,
    )
    te = mean_pool(tout.last_hidden_state, torch.from_numpy(mask)).numpy()
    je = je / np.linalg.norm(je, axis=1, keepdims=True)
    te = te / np.linalg.norm(te, axis=1, keepdims=True)
    np.testing.assert_allclose(te, je, atol=1e-4)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(
            tout.last_hidden_state[b, :n].numpy(), np.asarray(jout.last_hidden_state)[b, :n],
            atol=1e-4,
        )


def _documents(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"d{i}{chr(97 + i % 26)}{chr(97 + i * 5 % 26)}" for i in range(400)]
    return [" ".join(rng.choice(words, rng.integers(3, 300))) + "." for _ in range(n)]


def test_jax_saved_long_encoder_loads_and_encodes(tmp_path):
    """A long encoder (arch.json with max_position 514, attention_window 16,
    window_global_cls) saved by the JAX package, loaded by the port, encodes
    mixed-length texts with the long-encode arguments: allclose 1e-4 in f32
    against the JAX encode (bucketed: packed=False). The port's "auto" runs
    a windowed model bucketed where the reference's rule (which reads no
    window) packs these texts, and packed=True raises."""
    texts = _documents(40)
    jtok = JaxTokenizer(train_wordpiece_vocab(texts, vocab_size=800, min_freq=1))
    jp, jarch, _ = _long_model(seed=4, vocab_size=jtok.vocab_size)
    jenc = JaxSentenceEncoder(jax.tree.map(jnp.asarray, jp), jarch, tokenizer=jtok,
                              precision=JAX_FP32)
    jenc.save(str(tmp_path))
    enc = SentenceEncoder.load(str(tmp_path), bf16=False, device="cpu")
    assert enc.arch.max_position == 514 and enc.arch.attention_window == 16
    assert enc.arch.window_global_cls and enc.arch.position_offset == 2
    kw = dict(max_len=512, buckets=LONG_BUCKETS, batch_size=8)
    want = np.asarray(jenc.encode(texts, packed=False, **kw))
    got = enc.encode(texts, **kw)
    lens = [len(r) for r in enc._tokenize_rows(texts, 512)]
    assert min(lens) < 16 and max(lens) > 256     # several buckets
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    rows = enc._tokenize_rows(texts, 512)
    assert not enc.use_packed(rows, 8, LONG_BUCKETS)
    flat = SentenceEncoder(enc.params, enc.arch.replace(attention_window=0), tokenizer=enc.tokenizer,
                           device="cpu")
    assert flat.use_packed(rows, 8, LONG_BUCKETS)    # the reference's rule packs them
    with pytest.raises(ValueError, match="window"):
        enc.encode(texts, packed=True, **kw)
