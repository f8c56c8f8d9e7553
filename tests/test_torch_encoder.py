"""The sentence encoder: JAX parameters carried across with
params_from_jax, forward and pooled embeddings against the JAX package, and
SentenceEncoder save/load across the two packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import DEFAULT_PRECISION as JAX_BF16
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models import mean_pool as jax_mean_pool
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, EncoderArch
from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
    train_wordpiece_vocab,
)
from text_similarity_tpu_torch.models import (
    SentenceEncoder,
    encoder_forward,
    init_params,
    mean_pool,
    params_from_jax,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _sentences(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}" for i in range(300)]
    return [" ".join(rng.choice(words, rng.integers(3, 30))) + "." for _ in range(n)]


def _inputs(arch, b=4, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, arch.vocab_size, (b, s)).astype(np.int32)
    lens = rng.integers(3, s + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


def _jax_params(arch, seed=0):
    return jax.device_get(jax_init(jax.random.PRNGKey(seed), JAX_PRESETS["tiny-test"].replace(
        **{f: getattr(arch, f) for f in ("hidden_act", "vocab_size")}
    )))


def test_arch_json_roundtrip_from_jax():
    for name, jarch in JAX_PRESETS.items():
        tarch = EncoderArch.from_json(jarch.to_json())
        assert tarch == ARCH_PRESETS[name]
        assert tarch.head_dim == jarch.head_dim


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
def test_forward_matches_jax_fp32(act):
    """f32: last hidden state, pooler and mean-pooled embeddings allclose
    1e-4."""
    arch = ARCH_PRESETS["tiny-test"].replace(hidden_act=act)
    jarch = JAX_PRESETS["tiny-test"].replace(hidden_act=act)
    jp = _jax_params(arch)
    ids, mask = _inputs(arch)
    jout = jax_forward(jp, jnp.asarray(ids), jnp.asarray(mask), arch=jarch, precision=JAX_FP32)
    tp = params_from_jax(jp, arch)
    tout = encoder_forward(
        tp, torch.from_numpy(ids), torch.from_numpy(mask), arch=arch, precision=FP32_PRECISION
    )
    np.testing.assert_allclose(
        tout.last_hidden_state.numpy(), np.asarray(jout.last_hidden_state), atol=1e-4
    )
    np.testing.assert_allclose(tout.pooler_output.numpy(), np.asarray(jout.pooler_output), atol=1e-4)
    je = jax_mean_pool(jout.last_hidden_state, jnp.asarray(mask))
    te = mean_pool(tout.last_hidden_state, torch.from_numpy(mask))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)


def test_forward_matches_jax_bf16():
    """bf16 compute: pooled embeddings agree to cosine ≥ 0.999."""
    arch = ARCH_PRESETS["tiny-test"]
    jp = _jax_params(arch, seed=1)
    ids, mask = _inputs(arch, b=8, s=32, seed=1)
    jout = jax_forward(jp, jnp.asarray(ids), jnp.asarray(mask), arch=JAX_PRESETS["tiny-test"],
                       precision=JAX_BF16)
    je = np.asarray(jax_mean_pool(jout.last_hidden_state, jnp.asarray(mask))).astype(np.float32)
    tout = encoder_forward(
        params_from_jax(jp, arch), torch.from_numpy(ids), torch.from_numpy(mask),
        arch=arch, precision=DEFAULT_PRECISION,
    )
    assert tout.last_hidden_state.dtype == torch.bfloat16
    te = mean_pool(tout.last_hidden_state, torch.from_numpy(mask)).float().numpy()
    cos = (te * je).sum(1) / np.linalg.norm(te, axis=1) / np.linalg.norm(je, axis=1)
    assert cos.min() >= 0.999, cos


def test_params_from_jax_checks_shapes():
    arch = ARCH_PRESETS["tiny-test"]
    jp = _jax_params(arch)
    jp["layers"]["attn"]["q"]["w"] = jp["layers"]["attn"]["q"]["w"][:, :, :8]
    with pytest.raises(ValueError):
        params_from_jax(jp, arch)
    with pytest.raises(KeyError, match="router"):   # a dense tree for an MoE arch
        params_from_jax(_jax_params(arch), ARCH_PRESETS["tiny-test"].replace(num_experts=2))


def test_init_params_layout_matches_jax():
    arch = ARCH_PRESETS["tiny-test"]
    tp = init_params(arch, torch.Generator().manual_seed(0))
    jp = _jax_params(arch)
    flat_t = jax.tree_util.tree_leaves_with_path({k: v for k, v in tp.items()})
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert [(p, tuple(v.shape)) for p, v in flat_t] == [(p, v.shape) for p, v in flat_j]


@pytest.fixture(scope="module")
def saved_jax_encoder(tmp_path_factory):
    texts = _sentences(200)
    vocab = train_wordpiece_vocab(texts, vocab_size=600, min_freq=1)
    jtok = JaxTokenizer(vocab)
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=jtok.vocab_size)
    jenc = JaxSentenceEncoder(
        jax_init(jax.random.PRNGKey(3), jarch), jarch, tokenizer=jtok, precision=JAX_FP32
    )
    path = str(tmp_path_factory.mktemp("enc"))
    jenc.save(path)
    return path, jenc, texts


def test_tokenizer_matches_jax(saved_jax_encoder):
    _, jenc, texts = saved_jax_encoder
    tok = WordPieceTokenizer(jenc.tokenizer.vocab)
    ji, jm = jenc.tokenizer.encode_batch(texts[:50], max_len=20)
    ti, tm = tok.encode_batch(texts[:50], max_len=20)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    assert tok.tokenize_many(texts[:20]) == jenc.tokenizer.tokenize_many(texts[:20])


def test_load_jax_saved_encoder_and_encode(saved_jax_encoder):
    """JAX save → port load → encode (bucketed, and packed=True against the
    JAX packed encode): allclose 1e-4 in f32, rows L2-unit."""
    path, jenc, texts = saved_jax_encoder
    enc = SentenceEncoder.load(path, bf16=False, device="cpu")
    je = np.asarray(jenc.encode(texts, batch_size=32, packed=False))
    te = enc.encode(texts, batch_size=32)
    assert te.shape == je.shape
    np.testing.assert_allclose(te, je, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(te, axis=1), 1.0, atol=1e-5)
    dev = enc.encode(texts[:3], device_output=True)
    assert isinstance(dev, torch.Tensor) and dev.shape == (3, enc.embedding_dim)
    assert enc.encode([]).shape == (0, enc.embedding_dim)
    np.testing.assert_allclose(
        enc.encode(texts, packed=True), np.asarray(jenc.encode(texts, packed=True)), atol=1e-4
    )


def test_port_saved_encoder_loads_in_jax(saved_jax_encoder, tmp_path):
    path, _, texts = saved_jax_encoder
    enc = SentenceEncoder.load(path, bf16=False, device="cpu")
    enc.save(str(tmp_path))
    jenc = JaxSentenceEncoder.load(str(tmp_path), bf16=False)
    np.testing.assert_allclose(
        enc.encode(texts[:40]), np.asarray(jenc.encode(texts[:40], packed=False)), atol=1e-4
    )
