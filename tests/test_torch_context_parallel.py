"""Context-parallel attention and encode, and the data-parallel encode,
against the JAX package on its 8 virtual CPU devices: ring and Ulysses
attention (outputs and gradients) against the reference's ``shard_map``
bodies, ``encoder_forward_cp`` and ``encode_long`` for both strategies, and
``SentenceEncoder(mesh=...)``'s encode against the JAX package's mesh
encode. The port places its 8 positions on the one CPU; inputs from numpy
seeds, tiny-test widths, f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.mesh import make_mesh as jax_make_mesh
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.long_context import encoder_forward_cp as jax_forward_cp
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.ops.ring_attention import ring_attention as jax_ring
from text_similarity_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from text_similarity_tpu_torch.core.config import EncoderArch
from text_similarity_tpu_torch.core.mesh import make_mesh
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward, params_from_jax
from text_similarity_tpu_torch.models.long_context import encoder_forward_cp
from text_similarity_tpu_torch.ops.attention import attention_reference, multi_head_attention
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU8 = ["cpu"] * 8
JAX_CP = {"ring": jax_ring, "ulysses": jax_ulysses}


def _qkv(b, s, h, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


def _pieces(x, n=8):
    return list(torch.as_tensor(x).chunk(n, dim=1))


def _jax_cp(strategy, n=8):
    mesh = jax_make_mesh(data=1, seq=n)
    seq4, seq2 = P(None, "seq", None, None), P(None, "seq")
    fn = JAX_CP[strategy]
    return jax.jit(shard_map(lambda q, k, v, m: fn(q, k, v, m, "seq"), mesh=mesh,
                             in_specs=(seq4, seq4, seq4, seq2), out_specs=seq4))


def _port_cp(strategy, q, k, v, m, n=8):
    devs = make_mesh(data=1, seq=n, devices=["cpu"] * n).axis_devices("seq")
    out = multi_head_attention(q, k, v, mask=m, impl=strategy, cp_group=devs)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Ring and Ulysses attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("shape", [(2, 128, 8, 16), (1, 64, 16, 32)])
def test_cp_attention_matches_jax(eight_devices, strategy, shape):
    b, s, h, d = shape
    q, k, v = _qkv(b, s, h, d, seed=7)
    mask = np.ones((b, s), np.int32)
    mask[0, 100 % s:] = 0
    want = np.asarray(_jax_cp(strategy)(q, k, v, mask))
    got = _port_cp(strategy, _pieces(q), _pieces(k), _pieces(v), _pieces(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # and the single-device attention on valid rows
    ref = attention_reference(*(torch.as_tensor(t) for t in (q, k, v)), torch.as_tensor(mask))
    keep = mask.astype(bool)
    np.testing.assert_allclose(got[keep], ref.numpy()[keep], atol=1e-5)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_cp_attention_gradients_match_jax(eight_devices, strategy):
    b, s, h, d = 1, 64, 8, 16
    q, k, v = _qkv(b, s, h, d, seed=9)
    mask = np.ones((b, s), np.int32)
    mask[0, 50:] = 0
    fn = _jax_cp(strategy)
    want = jax.grad(lambda t: jnp.sum(fn(*t, mask) ** 2))((q, k, v))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = _port_cp(strategy, *(_pieces(t) for t in leaves), _pieces(mask))
    (out ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_cp_attention_fully_masked_row_outputs_zero(eight_devices, strategy):
    q, k, v = _qkv(2, 64, 8, 16, seed=9)
    mask = np.ones((2, 64), np.int32)
    mask[1] = 0
    want = np.asarray(_jax_cp(strategy)(q, k, v, mask))
    got = _port_cp(strategy, _pieces(q), _pieces(k), _pieces(v), _pieces(mask)).numpy()
    assert np.all(got[1] == 0.0) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], want[1])


def test_cp_attention_refusals():
    q = _pieces(_qkv(1, 16, 6, 8, seed=0)[0])
    with pytest.raises(ValueError, match="cp_group"):
        multi_head_attention(q, q, q, impl="ring")
    devs = make_mesh(data=1, seq=8, devices=CPU8).axis_devices("seq")
    with pytest.raises(ValueError, match="non-causal"):
        multi_head_attention(q, q, q, impl="ring", window=4, cp_group=devs)
    with pytest.raises(ValueError, match="must divide"):
        multi_head_attention(q, q, q, impl="ulysses", cp_group=devs)   # 6 heads over 8


# ---------------------------------------------------------------------------
# The context-parallel encoder forward
# ---------------------------------------------------------------------------

ARCHS = {
    "bert": dict(num_heads=8, max_position=256),
    "roberta": dict(num_heads=8, max_position=260, position_offset=2, pad_token_id=1),
    "albert": dict(num_heads=8, max_position=256, share_layers=True, embed_factor_size=32,
                   num_layers=3),
}


def _archs(name):
    jarch = JAX_PRESETS["tiny-test"].replace(**ARCHS[name])
    return jarch, EncoderArch.from_json(jarch.to_json())


@pytest.fixture(scope="module")
def models(eight_devices):
    out = {}
    for name in ARCHS:
        jarch, arch = _archs(name)
        jp = jax_init(jax.random.PRNGKey(0), jarch)
        out[name] = (jarch, arch, jp, params_from_jax(jax.device_get(jp), arch))
    return out


def _ids_mask(arch, b=2, s=128, seed=11):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, arch.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 96:] = 0
    ids[1, 96:] = arch.pad_token_id
    return ids, mask


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_encoder_forward_cp_matches_jax(models, arch_name, strategy):
    jarch, arch, jp, tp = models[arch_name]
    ids, mask = _ids_mask(arch)
    want = np.asarray(jax_forward_cp(jp, jnp.asarray(ids), jnp.asarray(mask), arch=jarch,
                                     mesh=jax_make_mesh(data=1, seq=8), strategy=strategy,
                                     precision=JAX_FP32))
    m = make_mesh(data=1, seq=8, devices=CPU8)
    got = encoder_forward_cp(tp, torch.as_tensor(ids), torch.as_tensor(mask), arch=arch, mesh=m,
                             strategy=strategy, precision=FP32_PRECISION).numpy()
    keep = mask.astype(bool)
    np.testing.assert_allclose(got[keep], want[keep], atol=2e-5, rtol=2e-5)
    # and the port's own single-device forward
    ref = encoder_forward(tp, torch.as_tensor(ids), torch.as_tensor(mask), arch=arch,
                          precision=FP32_PRECISION, attention_impl="reference")
    np.testing.assert_allclose(got[keep], ref.last_hidden_state.numpy()[keep], atol=2e-5,
                               rtol=2e-5)


def test_encoder_forward_cp_refusals(models):
    _, arch, _, tp = models["bert"]
    ids, mask = (torch.as_tensor(t) for t in _ids_mask(arch))
    m = make_mesh(data=1, seq=8, devices=CPU8)
    kw = dict(arch=arch, mesh=m, precision=FP32_PRECISION)
    with pytest.raises(ValueError, match="unknown CP strategy"):
        encoder_forward_cp(tp, ids, mask, strategy="tree", **kw)
    with pytest.raises(ValueError, match="must divide"):
        encoder_forward_cp(tp, ids[:, :100], mask[:, :100], **kw)
    with pytest.raises(ValueError, match="position table"):
        encoder_forward_cp(tp, ids.repeat(1, 3), mask.repeat(1, 3), **kw)
    for bad in (dict(attention_window=16), dict(attention_type="performer")):
        kw["arch"] = arch.replace(**bad)
        with pytest.raises(ValueError, match="exact full attention"):
            encoder_forward_cp(tp, ids, mask, **kw)


# ---------------------------------------------------------------------------
# encode_long and the data-parallel encode through SentenceEncoder
# ---------------------------------------------------------------------------

TEXTS = [
    "a very long document about foxes " * 8,
    "tensor processing units multiply matrices quickly " * 6,
    "short one",
    "the cat sat on the mat and then it slept for a while " * 3,
    "rain is expected across the region tomorrow",
]


@pytest.fixture(scope="module")
def sentence_encoders(eight_devices, tmp_path_factory):
    tok = JaxTokenizer(train_wordpiece_vocab(TEXTS * 4, 256, min_freq=1))
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size, num_heads=8,
                                             max_position=256)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), jarch), jarch, tokenizer=tok,
                              precision=JAX_FP32)
    path = str(tmp_path_factory.mktemp("cp") / "enc")
    jenc.save(path)
    return jenc, path


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_encode_long_matches_jax(sentence_encoders, strategy):
    jenc, path = sentence_encoders
    enc = SentenceEncoder.load(path, bf16=False, device="cpu")
    want = jenc.encode_long(TEXTS, jax_make_mesh(data=1, seq=8), max_len=128, strategy=strategy,
                            batch_size=4)
    got = enc.encode_long(TEXTS, make_mesh(data=1, seq=8, devices=CPU8), max_len=128,
                          strategy=strategy, batch_size=4)
    assert got.shape == (len(TEXTS), enc.embedding_dim)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
    # the same vectors as the port's single-device encode at that width
    plain = enc.encode(TEXTS, max_len=128, buckets=(128,), packed=False)
    np.testing.assert_allclose(got, plain, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_data_parallel_encode_matches_jax_mesh_encode(sentence_encoders, packed):
    """The port's encode with ``mesh=`` (rows split over 8 positions on the
    CPU) against the JAX package's mesh encode over its 8 devices, and
    against the port's own mesh-less encode."""
    jenc, path = sentence_encoders
    texts = [f"{t} {i}" for i in range(30) for t in TEXTS[2:]]
    jmesh_enc = JaxSentenceEncoder(jenc.params, jenc.arch, tokenizer=jenc.tokenizer,
                                   mesh=jax_make_mesh(data=8), precision=JAX_FP32)
    want = jmesh_enc.encode(texts, batch_size=16, packed=packed)
    enc = SentenceEncoder.load(path, bf16=False, device="cpu",
                               mesh=make_mesh(data=8, devices=CPU8))
    got = enc.encode(texts, batch_size=16, packed=packed)
    np.testing.assert_allclose(got, want, atol=1e-5)
    alone = SentenceEncoder.load(path, bf16=False, device="cpu")
    np.testing.assert_allclose(got, alone.encode(texts, batch_size=16, packed=packed), atol=1e-6)


def test_data_parallel_encode_keeps_moe_batches_whole(tmp_path):
    """An MoE model's capacity counts the batch: under a mesh each batch
    stays whole on the next data device, so the vectors equal the
    mesh-less encode's."""
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer
    from text_similarity_tpu_torch.models import init_params

    tok = WordPieceTokenizer(train_wordpiece_vocab(TEXTS * 4, 256, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size, num_experts=4,
                                             expert_top_k=1, expert_capacity_factor=0.5)
    params = init_params(arch, torch.Generator().manual_seed(0))
    texts = [f"{t} {i}" for i in range(12) for t in TEXTS]
    kw = dict(tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    alone = SentenceEncoder(params, arch, **kw).encode(texts, batch_size=16, packed=False)
    enc = SentenceEncoder(params, arch, mesh=make_mesh(data=4, devices=["cpu"] * 4), **kw)
    got = enc.encode(texts, batch_size=16, packed=False)
    np.testing.assert_array_equal(got, alone)
    assert enc._turn > 1
