"""The port's bi-encoder training path against the JAX package on the CPU:
the losses, dropout, the optimizer against optax, the train step's loss,
gradients and parameters against the JAX step (reference and flash
attention), ``build_pair_batches``, and a port-trained encoder loaded by
the JAX package. Inputs are made with numpy and handed to both; JAX runs
on the CPU (Pallas kernels in interpret mode)."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import TrainConfig as JaxTrainConfig
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.pairs import build_pair_batches as jax_build_pair_batches
from text_similarity_tpu.models import encoder_forward as jax_encoder_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models import losses as JL
from text_similarity_tpu.models.pooling import mean_pool as jax_mean_pool
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.train import init_train_state as jax_init_train_state
from text_similarity_tpu.train import make_bi_encoder_train_step as jax_make_step
from text_similarity_tpu.train import make_optimizer as jax_make_optimizer
from text_similarity_tpu.train.steps import _pair_objective as jax_pair_objective
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, TrainConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.pairs import build_pair_batches
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, params_from_jax
from text_similarity_tpu_torch.models import losses as TL
from text_similarity_tpu_torch.models.encoder import dropout, encoder_forward
from text_similarity_tpu_torch.train import (
    init_train_state,
    make_bi_encoder_train_step,
    make_optimizer,
)
from text_similarity_tpu_torch.train.steps import bi_encoder_loss, value_and_grad

LOSS_TYPES = ["cosine_mse", "softmax", "mnrl", "online_contrastive"]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# Losses and dropout
# ---------------------------------------------------------------------------

def _loss_inputs(seed=0, b=6, d=16, classes=3):
    rng = np.random.default_rng(seed)
    u, v = rng.standard_normal((2, b, d)).astype(np.float32)
    v[1] = u[1]                       # one pair at distance 0
    return dict(
        u=u, v=v,
        scores=rng.random(b).astype(np.float32),
        labels=np.array([1, 0, 1, 0, 1, 0], np.int32)[:b],
        classes=rng.integers(0, classes, b).astype(np.int32),
        w=(rng.standard_normal((3 * d, classes)) * 0.1).astype(np.float32),
        bias=rng.standard_normal(classes).astype(np.float32),
        teacher=rng.standard_normal((b, d)).astype(np.float32),
        logits=rng.standard_normal((b, classes)).astype(np.float32),
        valid=np.array([1, 1, 1, 1, 0, 0], np.int32)[:b],
    )


def _call_loss(mod, name, x, valid):
    t = (lambda a: torch.from_numpy(a)) if mod is TL else jnp.asarray
    u, v = t(x["u"]), t(x["v"])
    if name == "softmax":
        return mod.softmax_loss(u, v, t(x["w"]), t(x["bias"]), t(x["classes"]), valid)[0]
    if name == "cosine_mse":
        return mod.cosine_mse_loss(u, v, t(x["scores"]), valid)[0]
    if name == "contrastive":
        return mod.contrastive_loss(u, v, t(x["labels"]), 0.5, valid)[0]
    if name == "online_contrastive":
        return mod.online_contrastive_loss(u, v, t(x["labels"]), 0.5, valid)[0]
    if name == "distill_mse":
        return mod.distill_mse_loss(u, t(x["teacher"]), valid)
    if name == "mnrl":
        return mod.multiple_negatives_loss(u, v, valid=valid)[0]
    return mod.cross_entropy_loss(t(x["logits"]), t(x["classes"]), valid)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "name", ["softmax", "cosine_mse", "contrastive", "online_contrastive", "distill_mse",
             "mnrl", "cross_entropy"],
)
def test_losses_match_jax(name, masked):
    """Each loss against ``text_similarity_tpu.models.losses`` on the same
    inputs, with and without the ``valid`` mask: allclose 1e-6 (f32)."""
    x = _loss_inputs()
    want = _call_loss(JL, name, x, jnp.asarray(x["valid"]) if masked else None)
    got = _call_loss(TL, name, x, torch.from_numpy(x["valid"]) if masked else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_dropout_rate_scale_seed_and_deterministic():
    """Inverted dropout: about rate of the elements zeroed, the rest scaled
    by 1 / (1 − rate), the same mask from the same generator seed, and the
    identity when deterministic (or at rate 0)."""
    x = torch.ones((256, 256), dtype=torch.bfloat16)
    y = dropout(x, 0.1, torch.Generator().manual_seed(3), deterministic=False)
    assert y.dtype == torch.bfloat16
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.1) < 0.01
    kept = y[y != 0].float()
    assert torch.all(kept == torch.tensor(1 / 0.9, dtype=torch.bfloat16).float())
    again = dropout(x, 0.1, torch.Generator().manual_seed(3), deterministic=False)
    assert torch.equal(y, again)
    other = dropout(x, 0.1, torch.Generator().manual_seed(4), deterministic=False)
    assert not torch.equal(y, other)
    assert dropout(x, 0.1, None, deterministic=True) is x
    assert dropout(x, 0.0, None, deterministic=False) is x
    with pytest.raises(ValueError):
        dropout(x, 0.1, None, deterministic=False)


def test_encoder_dropout_in_training_only():
    """``encoder_forward``: deterministic gives the inference output;
    training draws new masks from the generator (reproducible from its
    seed) and changes the output."""
    arch = ARCH_PRESETS["tiny-test"]
    params = params_from_jax(_np_tree(jax_init(jax.random.PRNGKey(0), _jax_arch())), arch)
    ids = torch.from_numpy(np.random.default_rng(0).integers(5, 1000, (2, 16)).astype(np.int32))
    kw = dict(arch=arch, precision=FP32_PRECISION)
    base = encoder_forward(params, ids, **kw).last_hidden_state
    a = encoder_forward(params, ids, deterministic=False, generator=torch.Generator().manual_seed(1),
                        **kw).last_hidden_state
    b = encoder_forward(params, ids, deterministic=False, generator=torch.Generator().manual_seed(1),
                        **kw).last_hidden_state
    assert torch.equal(a, b) and not torch.allclose(a, base, atol=1e-3)


# ---------------------------------------------------------------------------
# The optimizer against optax
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "layers": {
            "attn": {"q": {"w": rng.standard_normal((2, 4, 4)), "b": rng.standard_normal((2, 4))}},
            "attn_ln": {"scale": rng.standard_normal((2, 4)), "bias": rng.standard_normal((2, 4))},
        },
        "embeddings": {"word": rng.standard_normal((8, 4))},
        "head": {"w": rng.standard_normal((4, 3)), "b": rng.standard_normal(3)},
    }


def _as_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize(
    "label,cfg",
    [
        ("warmup, decay, clip below the norm",
         TrainConfig(lr=1e-2, warmup_ratio=0.34, max_grad_norm=100.0, weight_decay=0.1)),
        ("clip above the norm", TrainConfig(lr=1e-2, warmup_ratio=0.0, max_grad_norm=0.5)),
        ("accumulation of 2", TrainConfig(lr=1e-2, warmup_ratio=0.25, grad_accum_steps=2)),
    ],
)
def test_optimizer_matches_optax(label, cfg):
    """Six steps of given gradients: the parameters after every step
    against optax through the JAX package's ``make_optimizer`` (f32,
    allclose 1e-6): the warmup from lr 0, the decay, global-norm clipping
    above and below the norm, the no-decay mask on a layer-stacked tree
    (biases and LayerNorm leaves keep their values under zero Adam
    steps) and MultiSteps accumulation."""
    params = _as_f32(_opt_tree(0))
    grads = [_as_f32(_opt_tree(10 + i)) for i in range(6)]
    jcfg = JaxTrainConfig(**dataclasses.asdict(cfg))
    jtx = jax_make_optimizer(jcfg, total_steps=6, params_example=params)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tx = make_optimizer(cfg, total_steps=6, params_example=params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    tstate = tx.init(tp)
    for i, g in enumerate(grads):
        up, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, up)
        tx.step(tp, jax.tree.map(torch.from_numpy, g), tstate)
        want, got = _flat(jp), _flat(tp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{label}: step {i}, {k}")


def test_optimizer_first_step_has_lr_zero_and_mask_by_name():
    """The first update of a warmup schedule moves nothing (lr 0), and with
    zero gradients only the leaves that decay move: kernels and tables,
    not the stacked (L, H) biases or the LayerNorm leaves."""
    params = jax.tree.map(torch.from_numpy, _as_f32(_opt_tree(0)))
    before = {k: v.copy() for k, v in _flat(params).items()}
    tx = make_optimizer(TrainConfig(lr=1e-2, warmup_ratio=0.5), total_steps=4,
                        params_example=params)
    state = tx.init(params)
    zeros = jax.tree.map(torch.zeros_like, params)
    tx.step(params, zeros, state)
    assert all(np.array_equal(v, before[k]) for k, v in _flat(params).items())
    tx.step(params, zeros, state)
    moved = {k for k, v in _flat(params).items() if not np.array_equal(v, before[k])}
    assert moved == {"layers/attn/q/w", "embeddings/word", "head/w"}


# ---------------------------------------------------------------------------
# The bi-encoder step against the JAX step
# ---------------------------------------------------------------------------

def _jax_arch(**kw):
    return JAX_PRESETS["tiny-test"].replace(hidden_dropout=0.0, attention_dropout=0.0, **kw)


def _batches(n, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        la = rng.integers(3, s + 1, b)
        lb = rng.integers(3, s + 1, b)
        mask_a = (np.arange(s)[None] < la[:, None]).astype(np.int32)
        mask_b = (np.arange(s)[None] < lb[:, None]).astype(np.int32)
        out.append({
            "ids_a": (rng.integers(5, 1000, (b, s)) * mask_a).astype(np.int32),
            "mask_a": mask_a,
            "ids_b": (rng.integers(5, 1000, (b, s)) * mask_b).astype(np.int32),
            "mask_b": mask_b,
            "valid": np.array([1] * (b - 1) + [0], np.int32),
        })
    return out


def _targets(loss_type, batch, seed):
    rng = np.random.default_rng(seed)
    b = batch["valid"].shape[0]
    if loss_type == "softmax":
        return rng.integers(0, 3, b).astype(np.int32)
    if loss_type == "online_contrastive":
        return np.array([1, 0] * (b // 2), np.float32)
    return rng.random(b).astype(np.float32)


def _setup(loss_type, n_batches, **arch_kw):
    jarch = _jax_arch(**arch_kw)
    arch = ARCH_PRESETS["tiny-test"].replace(hidden_dropout=0.0, attention_dropout=0.0, **arch_kw)
    jparams = {"encoder": jax_init(jax.random.PRNGKey(0), jarch)}
    if loss_type == "softmax":
        rng = np.random.default_rng(5)
        jparams["head"] = {"w": jnp.asarray(rng.standard_normal((3 * 64, 3)) * 0.02, jnp.float32),
                           "b": jnp.zeros((3,), jnp.float32)}
    npp = _np_tree(jparams)
    tparams = {"encoder": params_from_jax(npp["encoder"], arch)}
    if "head" in npp:
        tparams["head"] = {k: torch.from_numpy(v) for k, v in npp["head"].items()}
    batches = _batches(n_batches, s=64 if arch_kw else 16)
    for i, b in enumerate(batches):
        b["target"] = _targets(loss_type, b, i)
    return jarch, arch, jparams, tparams, batches


def _jax_loss(jarch, loss_type, impl):
    def loss(params, batch):
        def embed(ids, mask):
            h = jax_encoder_forward(params["encoder"], ids, mask, arch=jarch,
                                    precision=JAX_FP32, attention_impl=impl).last_hidden_state
            return jax_mean_pool(h, mask)

        u = embed(batch["ids_a"], batch["mask_a"])
        v = embed(batch["ids_b"], batch["mask_b"])
        return jax_pair_objective(loss_type, params, u, v, batch["target"], batch["valid"], 0.5)

    return loss


TRAIN_CFG = TrainConfig(lr=1e-3, warmup_ratio=0.25)


def _check_step_parity(loss_type, impl, arch_kw, jax_step):
    """Loss and every gradient leaf (f32: rtol 1e-4) on the first batch,
    then the parameters after 4 steps: the port's train step (the auto
    rule, which runs the reference on the CPU), or with ``impl="flash"``
    4 steps of the same optimizer over the flash loss's gradients."""
    jarch, arch, jparams, tparams, batches = _setup(loss_type, 4, **arch_kw)
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    jloss = _jax_loss(jarch, loss_type, impl)
    (want_loss, _), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams, jb[0])
    tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    leaves = init_train_state(tparams, make_optimizer(TRAIN_CFG, 8), device="cpu").params
    loss, _, grads = value_and_grad(
        bi_encoder_loss, leaves, tb, arch=arch, loss_type=loss_type, precision=FP32_PRECISION,
        deterministic=True, attention_impl=impl,
    )
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want_g, got_g = _flat(_np_tree(want_g)), _flat(grads)
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got_g[k], w, rtol=1e-4, atol=1e-4 * scale, err_msg=k)

    want_p = _flat(_np_tree(jax_step(jparams, jb, jloss)))
    tx = make_optimizer(TRAIN_CFG, 8, params_example=tparams)
    state = init_train_state(tparams, tx, device="cpu")
    if impl == "flash":
        for b in batches:
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            _, _, grads = value_and_grad(
                bi_encoder_loss, state.params, tb, arch=arch, loss_type=loss_type,
                precision=FP32_PRECISION, deterministic=True, attention_impl=impl,
            )
            tx.step(state.params, grads, state.opt_state)
    else:
        step = make_bi_encoder_train_step(arch, tx, loss_type=loss_type,
                                          precision=FP32_PRECISION, device="cpu")
        for b in batches:
            state, metrics = step(state, b)
        assert state.step == 4 and np.isfinite(float(metrics["loss"]))
    got_p = _flat(state.params)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=1e-4, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_bi_encoder_step_matches_jax(loss_type):
    """tiny-test (hidden_dropout 0), reference attention: the JAX package's
    own ``make_bi_encoder_train_step`` for 4 steps."""
    def jax_step(jparams, jb, _):
        jtx = jax_make_optimizer(JaxTrainConfig(lr=1e-3, warmup_ratio=0.25, bf16=False), 8,
                                 params_example=jparams)
        state = jax_init_train_state(jparams, jtx)
        step = jax_make_step(_jax_arch(), jtx, loss_type=loss_type, precision=JAX_FP32)
        for b in jb:
            state, _ = step(state, b)
        return state.params

    _check_step_parity(loss_type, "reference", {}, jax_step)


def test_bi_encoder_step_with_flash_matches_jax():
    """The same with two heads of 32, window 8 and the global CLS through
    flash attention on both sides (the port's plain K5 / K6 under the
    autograd Function; the Pallas kernels in interpret mode): the JAX loss
    through ``encoder_forward(attention_impl="flash")`` and 4 optax steps
    of its gradients."""
    def jax_step(jparams, jb, jloss):
        jtx = jax_make_optimizer(JaxTrainConfig(lr=1e-3, warmup_ratio=0.25, bf16=False), 8,
                                 params_example=jparams)
        grad = jax.jit(jax.grad(lambda p, b: jloss(p, b)[0]))
        p, opt = jparams, jtx.init(jparams)
        for b in jb:
            up, opt = jtx.update(grad(p, b), opt, p)
            p = optax.apply_updates(p, up)
        return p

    _check_step_parity("mnrl", "flash", dict(num_heads=2, attention_window=8,
                                             window_global_cls=True), jax_step)


# ---------------------------------------------------------------------------
# Data and the trained encoder
# ---------------------------------------------------------------------------

def _sentences(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}x" for i in range(300)]
    return [" ".join(rng.choice(words, rng.integers(3, 30))) for _ in range(n)]


def test_build_pair_batches_matches_jax():
    """Bi-mode batches equal the JAX package's array for array (the same
    tokenizer, pairs, targets and seed), with a tail batch and a bucket
    past the list (max_len above the last bucket)."""
    texts = _sentences(90)
    tok = WordPieceTokenizer(train_wordpiece_vocab(texts, vocab_size=400, min_freq=1))
    pairs = list(zip(texts[:45], texts[45:]))
    targets = np.random.default_rng(1).random(45).astype(np.float32)
    for kw in (dict(batch_size=8, max_len=24), dict(batch_size=16, max_len=40, buckets=(8, 16))):
        want = jax_build_pair_batches(tok, pairs, targets, seed=3, **kw)
        got = build_pair_batches(tok, pairs, targets, seed=3, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_port_trained_encoder_loads_in_jax(tmp_path):
    """Train two steps on the CPU, hand the parameters back to the
    SentenceEncoder and save it: the JAX package's ``SentenceEncoder.load``
    encodes the same vectors (f32, allclose 1e-4), and they differ from the
    untrained encoder's. The encoder holds copies: another step on the
    train state leaves its vectors as they were."""
    texts = _sentences(40, seed=2)
    tok = WordPieceTokenizer(train_wordpiece_vocab(texts, vocab_size=400, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    params = params_from_jax(_np_tree(jax_init(jax.random.PRNGKey(1), _jax_arch(
        vocab_size=tok.vocab_size))), arch)
    enc = SentenceEncoder(params, arch, tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    before = enc.encode(texts[:10])
    batches = build_pair_batches(tok, list(zip(texts[:20], texts[20:])),
                                 np.linspace(0, 1, 20, dtype=np.float32), batch_size=10, max_len=32)
    tx = make_optimizer(TrainConfig(lr=1e-2, warmup_ratio=0.0), 2)
    state = init_train_state({"encoder": enc.params}, tx, device="cpu")
    step = make_bi_encoder_train_step(arch, tx, precision=FP32_PRECISION, device="cpu")
    for b in batches:
        state, _ = step(state, b)
    enc.params = state.params["encoder"]
    enc.save(str(tmp_path))
    jenc = JaxSentenceEncoder.load(str(tmp_path), bf16=False)
    got = enc.encode(texts[:10])
    np.testing.assert_allclose(got, np.asarray(jenc.encode(texts[:10], packed=False)), atol=1e-4)
    assert not np.allclose(got, before, atol=1e-3)
    step(state, batches[0])
    np.testing.assert_array_equal(enc.encode(texts[:10]), got)
