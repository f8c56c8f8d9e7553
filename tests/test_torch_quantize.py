"""int8 quantization and the int8 encoder: the port's compress.quantize
against the JAX package's, the int8 forward (per-token activation quant,
int8×int8→int32 dense layers and fused QKV, quantized embedding tables) on
a JAX-quantized tree carried across, and SentenceEncoder.to_int8 / to_bf16
/ int8-checkpoint load against the JAX SentenceEncoder."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.compress import quantize as jq
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import DEFAULT_PRECISION as JAX_BF16
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models import mean_pool as jax_mean_pool
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu_torch.compress import quantize as tq
from text_similarity_tpu_torch.core.config import ARCH_PRESETS
from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu_torch.models import (
    SentenceEncoder,
    encoder_forward,
    mean_pool,
    params_from_jax,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = ARCH_PRESETS["tiny-test"]
JARCH = JAX_PRESETS["tiny-test"]


def _jax_params(seed=0):
    return jax.device_get(jax_init(jax.random.PRNGKey(seed), JARCH))


def _inputs(b=4, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, ARCH.vocab_size, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < rng.integers(3, s + 1, b)[:, None]).astype(np.int32)
    return ids, mask


def _leaves(tree, path=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{path}/{key}")
        else:
            yield f"{path}/{key}", val


def _assert_quantized_equal(jtree, ttree):
    """Codes equal; scales within 1e-7 relative."""
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(jl) == sorted(tl)
    for path, jv in jl.items():
        jv, tv = np.asarray(jv), tl[path].numpy()
        assert jv.dtype == tv.dtype, path
        if jv.dtype == np.int8:
            np.testing.assert_array_equal(tv, jv, err_msg=path)
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-7, atol=0, err_msg=path)


@pytest.mark.parametrize("n,d,scale", [(4000, 64, 1.0), (257, 384, 1e-3), (33, 32, 50.0)])
def test_quantize_embeddings_matches_jax(n, d, scale):
    """Per-row codes equal JAX's in every entry (the port divides by the
    scale as the reference does); scales within 1e-7 relative."""
    x = (np.random.default_rng(n).standard_normal((n, d)) * scale).astype(np.float32)
    x[0] = 0.0                                           # the 1e-12 floor
    jcodes, jscales = jq.quantize_embeddings_int8(jnp.asarray(x))
    tcodes, tscales = tq.quantize_embeddings_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(tscales.numpy(), np.asarray(jscales), rtol=1e-7, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_params_matches_jax(seed):
    jp = _jax_params(seed)
    _assert_quantized_equal(
        jax.device_get(jq.quantize_params_int8(jp)),
        tq.quantize_params_int8(params_from_jax(jp, ARCH)),
    )


def test_quantize_params_keeps_router_and_vectors():
    w = torch.randn(2, 8, 4)
    tree = {"mlp": {"router": {"w": w}, "in": {"w": w, "b": torch.randn(2, 4)}},
            "emb": {"word": torch.randn(10, 4)}}
    q = tq.quantize_params_int8(tree)
    assert q["mlp"]["router"]["w"] is w
    assert q["mlp"]["in"]["b"] is tree["mlp"]["in"]["b"]
    assert q["mlp"]["in"]["w"]["q"].dtype == torch.int8
    assert q["mlp"]["in"]["w"]["s"].shape == (2, 1, 4)
    assert q["emb"]["word"]["s"].shape == (1, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_params_matches_jax(dtype):
    """Bit-equal dequantized leaves (q · s in f32, then the target dtype)."""
    jq_tree = jax.device_get(jq.quantize_params_int8(_jax_params()))
    jd = jax.device_get(jq.dequantize_params(jq_tree, getattr(jnp, dtype)))
    td = tq.dequantize_params(params_from_jax(jq_tree, ARCH), getattr(torch, dtype))
    jl, tl = dict(_leaves(jd)), dict(_leaves(td))
    for path, jv in jl.items():
        np.testing.assert_array_equal(
            tl[path].float().numpy(), np.asarray(jv).astype(np.float32), err_msg=path
        )


def test_int8_matmul_scores_matches_jax():
    """The reference's XLA int8 scoring (queries quantized too): equal int32
    sums, scores allclose 1e-6 (the two scale products round alike)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 64)).astype(np.float32)
    q = rng.standard_normal((7, 64)).astype(np.float32)
    codes, scales = jq.quantize_embeddings_int8(jnp.asarray(x))
    js = jq.int8_matmul_scores(jnp.asarray(q), codes, scales)
    ts = tq.int8_matmul_scores(
        torch.from_numpy(q), torch.from_numpy(np.array(codes)),
        torch.from_numpy(np.array(scales)),
    )
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)


def test_int8_dynamic_matmul_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    leaf = jq._quant_leaf(jnp.asarray(w))
    jy = jq.int8_dynamic_matmul(jnp.asarray(x), leaf["q"], leaf["s"])
    ty = tq.int8_dynamic_matmul(
        torch.from_numpy(x), torch.from_numpy(np.array(leaf["q"])),
        torch.from_numpy(np.array(leaf["s"])),
    )
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)


def test_int8_mm_is_exact():
    """Products summed over K = 1536 pass 2^24: exact int32, unlike f32."""
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (3, 1536)).astype(np.int8)
    b = rng.integers(-127, 128, (1536, 16)).astype(np.int8)
    a[0] = 127
    b[:, 0] = 127
    got = tq.int8_mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
    assert got[0, 0] == 127 * 127 * 1536 > 2 ** 24


def test_int8_forward_matches_jax_fp32():
    """A JAX-quantized tree carried across: f32 compute, last hidden state
    and pooler allclose 1e-4 (the int32 sums are exact on both sides)."""
    jqp = jax.device_get(jq.quantize_params_int8(_jax_params()))
    ids, mask = _inputs()
    jout = jax_forward(jax.tree.map(jnp.asarray, jqp), jnp.asarray(ids), jnp.asarray(mask),
                       arch=JARCH, precision=JAX_FP32)
    tp = params_from_jax(jqp, ARCH)
    assert tp["layers"]["attn"]["q"]["w"]["q"].dtype == torch.int8
    tout = encoder_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                           arch=ARCH, precision=FP32_PRECISION)
    np.testing.assert_allclose(
        tout.last_hidden_state.numpy(), np.asarray(jout.last_hidden_state), atol=1e-4
    )
    np.testing.assert_allclose(tout.pooler_output.numpy(), np.asarray(jout.pooler_output), atol=1e-4)


def test_int8_forward_matches_jax_bf16():
    """bf16 compute (the int8 scales are bf16-rounded by the compute-dtype
    cast on both sides): hidden states within 2 bf16 ulps at magnitude 4
    (atol 0.0625), mean-pooled embeddings at cosine ≥ 0.9999."""
    jqp = jax.device_get(jq.quantize_params_int8(_jax_params(seed=2)))
    ids, mask = _inputs(b=8, s=32, seed=2)
    jout = jax_forward(jax.tree.map(jnp.asarray, jqp), jnp.asarray(ids), jnp.asarray(mask),
                       arch=JARCH, precision=JAX_BF16)
    tout = encoder_forward(params_from_jax(jqp, ARCH), torch.from_numpy(ids),
                           torch.from_numpy(mask), arch=ARCH, precision=DEFAULT_PRECISION)
    assert tout.last_hidden_state.dtype == torch.bfloat16
    jh = np.asarray(jout.last_hidden_state).astype(np.float32)
    np.testing.assert_allclose(tout.last_hidden_state.float().numpy(), jh, atol=0.0625)
    je = np.asarray(jax_mean_pool(jout.last_hidden_state, jnp.asarray(mask))).astype(np.float32)
    te = mean_pool(tout.last_hidden_state, torch.from_numpy(mask)).float().numpy()
    cos = (te * je).sum(1) / np.linalg.norm(te, axis=1) / np.linalg.norm(je, axis=1)
    assert cos.min() >= 0.9999, cos


def test_params_from_jax_checks_quantized_leaves():
    jqp = jax.device_get(jq.quantize_params_int8(_jax_params()))
    bad = dict(jqp, pooler={"w": {"q": np.asarray(jqp["pooler"]["w"]["q"])}, "b": jqp["pooler"]["b"]})
    with pytest.raises(KeyError):
        params_from_jax(bad, ARCH)
    bad = dict(jqp, pooler={"w": {"q": np.asarray(jqp["pooler"]["w"]["q"]),
                                  "s": np.ones((64,), np.float32)}, "b": jqp["pooler"]["b"]})
    with pytest.raises(ValueError):
        params_from_jax(bad, ARCH)


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}{chr(97 + i % 26)}{chr(97 + i * 7 % 26)}" for i in range(300)]
    return [" ".join(rng.choice(words, rng.integers(3, 30))) + "." for _ in range(n)]


@pytest.fixture(scope="module")
def jax_encoder():
    texts = _texts(120)
    tok = JaxTokenizer(train_wordpiece_vocab(texts, vocab_size=600, min_freq=1))
    arch = JARCH.replace(vocab_size=tok.vocab_size)
    return JaxSentenceEncoder(jax_init(jax.random.PRNGKey(7), arch), arch,
                              tokenizer=tok, precision=JAX_FP32), texts


@pytest.fixture
def port_encoder(jax_encoder, tmp_path):
    jenc, texts = jax_encoder
    jenc.save(str(tmp_path / "enc"))
    return SentenceEncoder.load(str(tmp_path / "enc"), bf16=False, device="cpu"), texts


def test_sentence_encoder_to_int8_matches_jax(jax_encoder, port_encoder):
    """to_int8 on both sides (f32 compute): embeddings allclose 1e-4."""
    jenc, texts = jax_encoder
    enc, _ = port_encoder
    enc.to_int8()
    assert enc.params["embeddings"]["word"]["q"].dtype == torch.int8
    jq_enc = JaxSentenceEncoder(jenc.params, jenc.arch, tokenizer=jenc.tokenizer,
                                precision=JAX_FP32).to_int8()
    np.testing.assert_allclose(
        enc.encode(texts, batch_size=32),
        np.asarray(jq_enc.encode(texts, batch_size=32, packed=False)), atol=1e-4,
    )


def test_to_bf16_matches_jax(jax_encoder, port_encoder):
    """bf16-stored weights (f32 compute): embeddings allclose 2e-3. The port
    adds the bf16 embedding rows in bf16, as the reference's code reads
    (and its eager forward gives, bit for bit); under ``jit`` XLA fuses
    those adds and rounds once, which moves the embedding LayerNorm output
    by up to one bf16 ulp (0.0156 at magnitude 2-4)."""
    jenc, texts = jax_encoder
    enc, _ = port_encoder
    enc.to_bf16()
    assert enc.params["layers"]["attn"]["q"]["w"].dtype == torch.bfloat16
    jb = JaxSentenceEncoder(jenc.params, jenc.arch, tokenizer=jenc.tokenizer,
                            precision=JAX_FP32).to_bf16()
    np.testing.assert_allclose(
        enc.encode(texts[:40]), np.asarray(jb.encode(texts[:40], packed=False)), atol=2e-3
    )


@pytest.mark.parametrize("bf16", [False, True])
def test_int8_checkpoint_loads_dequantized(jax_encoder, tmp_path, bf16):
    """A JAX save_quantized checkpoint loads dequantized (bf16 or f32
    weights, bf16 embedding sums as in the reference). f32: allclose 1e-4;
    bf16 compute: allclose 2e-2 (bf16 activations, unit-norm outputs)."""
    jenc, texts = jax_encoder
    path = str(tmp_path / "int8")
    jenc.save(path)
    jq.save_quantized(path, jenc.params, meta={"pooling": "mean"})
    want = np.asarray(JaxSentenceEncoder.load(path, bf16=bf16).encode(texts[:40], packed=False))
    enc = SentenceEncoder.load(path, bf16=bf16, device="cpu")
    dtype = torch.bfloat16 if bf16 else torch.float32
    assert enc.params["embeddings"]["word"].dtype == dtype
    np.testing.assert_allclose(enc.encode(texts[:40]), want, atol=2e-2 if bf16 else 1e-4)


def test_port_int8_encoder_loads_in_jax(port_encoder, tmp_path):
    """The port's to_int8 tree saved → the JAX package loads the {q, s}
    leaves and runs its int8 forward: f32, allclose 1e-4."""
    enc, texts = port_encoder
    enc.to_int8()
    enc.save(str(tmp_path / "q"))
    jenc = JaxSentenceEncoder.load(str(tmp_path / "q"), bf16=False)
    np.testing.assert_allclose(
        enc.encode(texts[:40]), np.asarray(jenc.encode(texts[:40], packed=False)), atol=1e-4
    )
    again = SentenceEncoder.load(str(tmp_path / "q"), bf16=False, device="cpu")
    np.testing.assert_array_equal(again.encode(texts[:40]), enc.encode(texts[:40]))
