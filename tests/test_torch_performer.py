"""Performer / FAVOR+ attention in the port against the JAX package, f32 on
the CPU, with the JAX package's projection passed to the port (the two
packages draw their matrices from different generators): the softmax and
ReLU features, non-causal attention with a fully masked row, causal
attention at a length that is not a multiple of the chunk, the causal
``attention_reference``, the local + global head mix, ``encoder_forward``
on tiny-test with both kernels, and the bi-encoder step with a feature
redraw every step. The port's own draws: orthogonal blocks, one QR a
(m, d, epoch), a new matrix only at an epoch boundary. A JAX-saved
Performer encoder: equal to the JAX encode with the JAX matrix, within the
feature approximation with the port's; never packed under ``"auto"``,
refused with ``packed=True``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import text_similarity_tpu.train.steps as JS
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.ops import attention as JA
from text_similarity_tpu.ops import performer as JP
import text_similarity_tpu_torch.ops.performer as TP
import text_similarity_tpu_torch.train.steps as TS
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, EncoderArch
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.pairs import build_pair_batches
from text_similarity_tpu_torch.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward, params_from_jax
from text_similarity_tpu_torch.ops.attention import attention_reference, multi_head_attention
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_steps import NO_DROP, WORDS, _pairs, _step_parity

RTOL = 1e-5   # relative to the largest |value| of the reference's output


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _jax_proj(m, d, epoch=None):
    key = jax.random.PRNGKey(42)
    if epoch is not None:
        key = jax.random.fold_in(key, epoch)
    return np.array(JP.orthogonal_random_features(key, m, d))


def _qkv(b=2, s=200, h=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[1, 150:] = 0
    return q, k, v, mask


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("kernel", ["softmax", "relu"])
def test_features_match_jax(kernel):
    """φ(q) and φ(k), keys with a padded row and a row of padding only: the
    port's features are finite everywhere; the reference's softmax-kernel
    keys of the all-padding row are inf (its −1e9 sentinel becomes the
    row's stabiliser), so rows 0-1 are compared."""
    q, k, _, mask = _qkv(b=3, s=40)
    mask[2] = 0
    proj = _jax_proj(24, 16)
    for x, is_query in ((q, True), (k, False)):
        if kernel == "relu":
            want = jax.jit(JP.relu_kernel_features)(*_j(x, proj))
            got = TP.relu_kernel_features(*_t(x, proj))
        else:
            want = jax.jit(JP.softmax_kernel_features, static_argnums=2)(
                *_j(x, proj), is_query, mask=jnp.asarray(mask))
            got = TP.softmax_kernel_features(*_t(x, proj), is_query, mask=torch.from_numpy(mask))
        assert torch.isfinite(got).all()
        _close(got.numpy()[:2], np.asarray(want)[:2])
        if kernel == "softmax" and not is_query:
            assert not np.isfinite(np.asarray(want)[2]).any()


@pytest.mark.parametrize("kernel", ["softmax", "relu"])
def test_attention_matches_jax_and_a_masked_row_stays_finite(kernel):
    """Rows 0-1 (one padded) against the reference; the all-padding row 2
    is zero in the port (no key to attend to) where the reference's
    softmax kernel gives NaN."""
    q, k, v, mask = _qkv(b=3)
    mask[2] = 0                                   # a row of padding only
    proj = _jax_proj(16, 16)
    want = np.asarray(jax.jit(JP.performer_attention, static_argnames="kernel")(
        *_j(q, k, v, proj, mask), kernel=kernel))
    got = TP.performer_attention(*_t(q, k, v, proj, mask), kernel=kernel).numpy()
    _close(got[:2], want[:2])
    assert np.array_equal(got[2], np.zeros_like(got[2]))
    if kernel == "softmax":
        assert np.isnan(want[2]).all()


@pytest.mark.parametrize("kernel", ["softmax", "relu"])
def test_causal_attention_matches_jax_off_the_chunk(kernel):
    """S 200 (pads to two chunks of 128), with and without a mask."""
    q, k, v, mask = _qkv()
    proj = _jax_proj(16, 16)
    for m in (mask, None):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want = jax.jit(JP.performer_attention_causal, static_argnames="kernel")(
            *_j(q, k, v, proj), jm, kernel=kernel)
        got = TP.performer_attention_causal(*_t(q, k, v, proj), tm, kernel=kernel)
        _close(got.numpy(), want)


def test_causal_attention_reference_matches_jax():
    q, k, v, mask = _qkv(s=48)
    for window, cls in ((0, False), (8, False), (8, True)):
        want = jax.jit(JA.attention_reference, static_argnames=("window", "global_cls", "causal"))(
            *_j(q, k, v, mask), window=window, global_cls=cls, causal=True)
        got = attention_reference(*_t(q, k, v, mask), window=window, global_cls=cls, causal=True)
        _close(got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_local_and_global_heads_match_jax(causal):
    """Two of three heads exact over a band of 8, the third linear; a head
    mask scales the output."""
    q, k, v, mask = _qkv(s=64)
    proj, hm = _jax_proj(16, 16), np.asarray([1.0, 0.5, 0.25], np.float32)
    kw = dict(impl="performer", causal=causal, performer_local_heads=2,
              performer_local_window=8)
    want = jax.jit(functools.partial(JA.multi_head_attention, **kw))(
        *_j(q, k, v, mask), head_mask=jnp.asarray(hm), performer_proj=jnp.asarray(proj))
    got = multi_head_attention(*_t(q, k, v, mask), head_mask=torch.from_numpy(hm),
                               performer_proj=torch.from_numpy(proj), **kw)
    _close(got.numpy(), want)
    with pytest.raises(ValueError, match="performer_proj"):
        multi_head_attention(*_t(q, k, v, mask), impl="performer")
    with pytest.raises(ValueError, match="causal"):
        multi_head_attention(*_t(q, k, v, mask), impl="reference", causal=True)


def _performer_arch(kernel="softmax", **kw):
    jarch = JAX_PRESETS["tiny-test"].replace(attention_type="performer", performer_kernel=kernel,
                                             **kw)
    return jarch, EncoderArch.from_json(jarch.to_json())


@pytest.mark.parametrize("kernel", ["softmax", "relu"])
def test_encoder_forward_matches_jax(kernel):
    """tiny-test with Performer attention on a padded batch, the JAX
    matrix passed in; ``attention_impl`` cannot move it off the performer."""
    jarch, arch = _performer_arch(kernel)
    jp = jax_init(jax.random.PRNGKey(0), jarch)
    rng = np.random.default_rng(1)
    mask = (np.arange(24)[None] < np.asarray([24, 17, 9])[:, None]).astype(np.int32)
    ids = (rng.integers(5, 1000, (3, 24)) * mask).astype(np.int32)
    want = jax.jit(jax_forward, static_argnames=("arch", "precision"))(
        jp, jnp.asarray(ids), jnp.asarray(mask), arch=jarch, precision=JAX_FP32).last_hidden_state
    tp = params_from_jax(jax.device_get(jp), arch)
    proj = torch.from_numpy(_jax_proj(arch.head_dim, arch.head_dim))
    for impl in ("auto", "flash", "packed"):
        got = encoder_forward(tp, *_t(ids, mask), arch=arch, precision=FP32_PRECISION,
                              attention_impl=impl, performer_proj=proj).last_hidden_state
        _close(got.numpy(), want)


def test_port_draws_are_orthogonal_cached_and_redraw_at_epoch_boundaries():
    arch = ARCH_PRESETS["tiny-test"].replace(attention_type="performer", performer_features=40,
                                             performer_redraw_every=4)
    w = TP.draw_projection(40, 16)
    assert w.shape == (40, 16) and w.dtype == torch.float32
    for blk in (w[:16], w[16:32]):                  # rows of a block are orthogonal
        gram = blk @ blk.T
        off = gram - torch.diag(torch.diag(gram))
        assert float(off.abs().max()) <= 1e-4 * float(gram.diag().max())
    assert torch.equal(TP.projection(arch), w)      # no step: the base draw
    hits = TP.draw_projection.cache_info().hits
    mats = [TP.projection(arch, step) for step in range(9)]
    assert TP.draw_projection.cache_info().hits > hits
    for step in range(9):
        same_epoch = step // 4 == (step - 1) // 4
        if step:
            assert torch.equal(mats[step], mats[step - 1]) == same_epoch, step
        assert not torch.equal(mats[step], w)
    assert torch.equal(TP.draw_projection(40, 16, 1), mats[5])   # epoch 5 // 4
    # the same seeds give the same matrix, drawn on the CPU for every device
    assert torch.equal(TP.orthogonal_random_features(torch.Generator().manual_seed(42), 40, 16),
                       w)


def test_bi_encoder_step_with_redraw_matches_jax(monkeypatch):
    """Two steps of the bi-encoder step, the features redrawn every step:
    the port's draw of each epoch replaced by the JAX package's
    (``redraw_features``: ``fold_in(PRNGKey(42), step // every)``)."""
    monkeypatch.setattr(TP, "draw_projection", lambda m, d, epoch=None, device="cpu":
                        torch.from_numpy(_jax_proj(m, d, epoch)).to(device))
    from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer

    tok = WordPieceTokenizer(train_wordpiece_vocab([" ".join(WORDS)] * 3, 256, min_freq=1))
    jarch, arch = _performer_arch(performer_redraw_every=1, vocab_size=tok.vocab_size,
                                  **NO_DROP)
    jp = {"encoder": jax_init(jax.random.PRNGKey(0), jarch)}
    pairs, t = _pairs(16, 0)
    batches = build_pair_batches(tok, pairs, t, batch_size=8, max_len=32, buckets=(32,))
    _step_parity(
        lambda tx: JS.make_bi_encoder_train_step(jarch, tx, precision=JAX_FP32),
        lambda tx: TS.make_bi_encoder_train_step(arch, tx, precision=FP32_PRECISION,
                                                 device="cpu"),
        jp, arch, batches[:2], ["loss"])


SENTS = [" ".join(np.random.default_rng(i).choice(WORDS, 3 + i % 11)) for i in range(30)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    vocab = train_wordpiece_vocab(SENTS, vocab_size=300, min_freq=1)
    jarch = _performer_arch(vocab_size=len(vocab))[0]
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(3), jarch), jarch,
                              tokenizer=JaxTokenizer(vocab), precision=JAX_FP32)
    path = str(tmp_path_factory.mktemp("performer"))
    jenc.save(path)
    return path, np.asarray(jenc.encode(SENTS, packed=False))


def test_jax_saved_performer_encoder_loads_and_encodes(saved, monkeypatch):
    """30 texts of 3-13 words: ``"auto"`` runs bucketed; with the JAX
    matrix the port's encode equals the JAX package's (1e-5), with its own
    matrix it differs by the feature approximation only (min cosine ≥ 0.99,
    and not equal)."""
    path, want = saved
    enc = SentenceEncoder.load(path, bf16=False, device="cpu")
    rows = enc._tokenize_rows(SENTS, 256)
    assert not enc.use_packed(rows, 128, (8, 16, 32))
    own = enc.encode(SENTS)                         # "auto": bucketed, no error
    cos = (own * want).sum(1)
    print(f"the port's own matrix against the JAX matrix: min cosine {cos.min():.6f}, "
          f"max|Δ| {np.abs(own - want).max():.3e}")
    assert cos.min() >= 0.99 and np.abs(own - want).max() > 1e-4, cos.min()
    with pytest.raises(ValueError, match="Performer"):
        enc.encode(SENTS, packed=True)
    monkeypatch.setattr(TP, "draw_projection", lambda m, d, epoch=None, device="cpu":
                        torch.from_numpy(_jax_proj(m, d, epoch)).to(device))
    np.testing.assert_allclose(enc.encode(SENTS, packed=False), want, atol=1e-5, rtol=0)
