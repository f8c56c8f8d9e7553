"""ALBERT in the port's encoder: one shared layer on the stack axis run L
times and factorized embeddings (E-wide tables, the E → H projection).
Against HF's ``AlbertModel`` (random weights; E 32 and 64, the E == H case
keeping the projection) through the port's ``convert_hf_model`` (its tree
equal to the JAX package's conversion) and against the JAX package's
forward; the (1, …) stack of ``init_params``;
SentenceEncoder directories across the two packages; int8 weights; the
packed and head-packed routes; the shared leaf's gradient as the sum over
its iterations."""

import numpy as np
import pytest
import torch
import transformers

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.hf_convert import convert_hf_model as jax_convert_hf_model
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, EncoderArch
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import (
    SentenceEncoder, convert_hf_model, encoder_forward, init_params, params_from_jax,
)
from text_similarity_tpu_torch.models.encoder import _param_shapes
from text_similarity_tpu_torch.train.steps import trainable
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ALBERT = dict(share_layers=True, embed_factor_size=32, num_layers=3)


def _np(tree):
    return jax.tree.map(np.array, jax.device_get(tree))


def _batch(vocab, b=3, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < np.array([s, 16, 9])[:b, None]).astype(np.int32)
    return ids * mask, mask


def _sentences(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}{chr(97 + i % 26)}" for i in range(120)]
    return [" ".join(rng.choice(words, rng.integers(3, 20))) for _ in range(n)]


@pytest.mark.parametrize("embedding_size", [32, 64])
def test_albert_matches_hf_and_jax(embedding_size):
    cfg = transformers.AlbertConfig(
        vocab_size=512, embedding_size=embedding_size, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=128, max_position_embeddings=96,
        type_vocab_size=2,
    )
    torch.manual_seed(0)
    model = transformers.AlbertModel(cfg).eval()
    jparams, jarch = jax_convert_hf_model(model)
    params, arch = convert_hf_model(model)
    assert arch == EncoderArch.from_json(jarch.to_json())
    want = params_from_jax(_np(jparams), arch)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)))
    assert params["layers"]["attn"]["q"]["w"].shape[0] == 1
    assert params["embeddings"]["proj"]["w"].shape == (embedding_size, 64)
    ids, mask = _batch(cfg.vocab_size)
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long())
    out = encoder_forward(params, torch.from_numpy(ids), torch.from_numpy(mask), arch=arch,
                          precision=FP32_PRECISION)
    jout = jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), arch=jarch,
                       precision=JAX_FP32)
    m = mask.astype(bool)
    got = out.last_hidden_state.numpy()
    for want, pooled in ((ref.last_hidden_state.numpy(), ref.pooler_output.numpy()),
                         (np.asarray(jout.last_hidden_state), np.asarray(jout.pooler_output))):
        np.testing.assert_allclose(got[m], want[m], atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(out.pooler_output.numpy(), pooled, atol=2e-4, rtol=2e-3)


def test_init_params_holds_one_layer_and_e_wide_tables():
    """The JAX package's tree, leaf for leaf (tiny-test with ALBERT's
    options), and albert-base's shapes: one 768-wide layer, 128-wide
    tables."""
    arch = ARCH_PRESETS["tiny-test"].replace(**ALBERT)
    tp = init_params(arch, torch.Generator().manual_seed(0))
    jp = jax_init(jax.random.PRNGKey(0), JAX_PRESETS["tiny-test"].replace(**ALBERT))
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert [(p, tuple(v.shape)) for p, v in flat_t] == [(p, v.shape) for p, v in flat_j]
    shapes = _param_shapes(ARCH_PRESETS["albert-base"])
    assert shapes["layers"]["mlp"]["in"]["w"] == (1, 768, 3072)
    assert shapes["embeddings"]["word"] == (30000, 128)
    assert shapes["embeddings"]["ln"]["scale"] == (128,)
    assert shapes["embeddings"]["proj"]["w"] == (128, 768)


def test_albert_still_refuses_moe():
    """ALBERT with MoE FFNs (refused before MoE was ported): one shared
    layer's router and experts, leaf for leaf the JAX package's tree."""
    arch = ARCH_PRESETS["tiny-test"].replace(num_experts=2, **ALBERT)
    tp = init_params(arch, torch.Generator().manual_seed(0))
    jp = jax_init(jax.random.PRNGKey(0), JAX_PRESETS["tiny-test"].replace(num_experts=2, **ALBERT))
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert [(p, tuple(v.shape)) for p, v in flat_t] == [(p, v.shape) for p, v in flat_j]
    assert tp["layers"]["mlp"]["in"]["w"].shape == (1, 2, 64, 128)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    texts = _sentences(60)
    vocab = train_wordpiece_vocab(texts, vocab_size=300, min_freq=1)
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=len(vocab), **ALBERT)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(2), jarch), jarch,
                              tokenizer=JaxTokenizer(vocab), precision=JAX_FP32)
    path = str(tmp_path_factory.mktemp("albert"))
    jenc.save(path)
    return path, jenc, texts


def test_jax_saved_albert_loads_in_the_port_and_back(saved, tmp_path):
    path, jenc, texts = saved
    enc = SentenceEncoder.load(path, bf16=False, device="cpu")
    assert enc.arch.share_layers and enc.arch.embed_factor_size == 32
    want = np.asarray(jenc.encode(texts, packed=False))
    np.testing.assert_allclose(enc.encode(texts, packed=False), want, atol=1e-5)
    enc.save(str(tmp_path / "port"))
    back = JaxSentenceEncoder.load(str(tmp_path / "port"), bf16=False)
    np.testing.assert_allclose(np.asarray(back.encode(texts, packed=False)), want, atol=1e-5)


def test_albert_int8_matches_jax(saved):
    """to_int8 quantizes embeddings.proj.w too (a leaf named w); the
    embed path dequantizes it. f32 compute, embeddings allclose 1e-4."""
    path, _, texts = saved
    enc = SentenceEncoder.load(path, bf16=False, device="cpu").to_int8()
    assert set(enc.params["embeddings"]["proj"]["w"]) == {"q", "s"}
    jenc = JaxSentenceEncoder.load(path, bf16=False)
    jenc.to_int8()
    np.testing.assert_allclose(enc.encode(texts[:20], packed=False),
                               np.asarray(jenc.encode(texts[:20], packed=False)), atol=1e-4)


def test_albert_packed_encode_matches_bucketed(saved):
    path, _, texts = saved
    enc = SentenceEncoder.load(path, bf16=False, device="cpu")
    np.testing.assert_allclose(enc.encode(texts, packed=True), enc.encode(texts, packed=False),
                               atol=1e-5)


def test_albert_head_packed_attention_matches_the_reference():
    """``attention_impl="packed"`` (K7's plain version on the CPU) in every
    iteration of the shared layer (4 heads of 32: K7 fills 128 lanes)."""
    arch = ARCH_PRESETS["tiny-test"].replace(hidden_size=128, **ALBERT)
    params = init_params(arch, torch.Generator().manual_seed(1))
    ids, mask = (torch.from_numpy(x) for x in _batch(arch.vocab_size, s=32))
    out = {impl: encoder_forward(params, ids, mask, arch=arch, precision=FP32_PRECISION,
                                 attention_impl=impl).last_hidden_state
           for impl in ("packed", "reference")}
    m = mask.bool()
    np.testing.assert_allclose(out["packed"][m].numpy(), out["reference"][m].numpy(), atol=1e-5)


def test_shared_layer_gradient_is_the_sum_over_iterations():
    """The one shared layer's gradient equals the sum of the gradients of
    an unshared L-layer copy of the same weights (dropout 0, f32)."""
    arch = ARCH_PRESETS["tiny-test"].replace(hidden_dropout=0.0, **ALBERT)
    shared = trainable(init_params(arch, torch.Generator().manual_seed(3)))
    unshared_arch = arch.replace(share_layers=False)

    def repeat(tree):
        return {k: repeat(v) if isinstance(v, dict)
                else v.detach().repeat(3, *[1] * (v.dim() - 1)) for k, v in tree.items()}

    unshared = trainable({**shared, "layers": repeat(shared["layers"])})
    ids, mask = (torch.from_numpy(x) for x in _batch(arch.vocab_size))
    w = torch.randn(3, 24, arch.hidden_size, generator=torch.Generator().manual_seed(4))

    def grads(p, a):
        h = encoder_forward(p, ids, mask, arch=a, precision=FP32_PRECISION).last_hidden_state
        loss = (h * w * mask[..., None]).sum()
        leaves = [p["layers"]["attn"]["q"]["w"], p["layers"]["mlp"]["out"]["b"],
                  p["embeddings"]["proj"]["w"]]
        return torch.autograd.grad(loss, leaves)

    g_shared, g_unshared = grads(shared, arch), grads(unshared, unshared_arch)
    for gs, gu in zip(g_shared, g_unshared):
        if gs.shape[0] == 1 and gu.shape[0] == 3:
            gu = gu.sum(dim=0, keepdim=True)
        np.testing.assert_allclose(gs.numpy(), gu.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(gu.abs().max()))
