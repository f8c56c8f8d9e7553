"""The port's compression against the JAX package on the tiny-test arch
(f32, dropout 0), the same weights (JAX-initialised, carried across as
numpy) and the same numpy inputs: the encoder's hidden states and head
masks, a JAX-pruned model (``head_dim_override``), head / FFN importance,
``prune_rewire``, the distillation losses, layer extraction and distill
batches, PCA, one distill, FastFormers and theseus step (loss and every
gradient), theseus's forward and scheduler; then ``distill``, ``theseus``
and ``prune`` → ``eval-classification`` through the CLI."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import text_similarity_tpu.compress.distill as JD
import text_similarity_tpu.compress.prune as JP
import text_similarity_tpu.compress.theseus as JT
import text_similarity_tpu.models.losses as JL
import text_similarity_tpu.train.steps as JS
from text_similarity_tpu.core import checkpoint as jax_ckpt
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import TrainConfig as JaxTrainConfig
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.pairs import build_distill_batches as jax_build_distill_batches
from text_similarity_tpu.models import encoder_forward as jax_encoder_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.ops.pca import pca_fit_transform as jax_pca
from text_similarity_tpu.train import init_train_state as jax_init_train_state
import text_similarity_tpu_torch.compress.distill as TD
import text_similarity_tpu_torch.compress.prune as TP
import text_similarity_tpu_torch.compress.theseus as TT
import text_similarity_tpu_torch.models.losses as TL
import text_similarity_tpu_torch.train.steps as TS
from text_similarity_tpu_torch.cli.main import main
from text_similarity_tpu_torch.core import checkpoint as ckpt
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, EncoderArch, TrainConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.pairs import build_distill_batches, build_sequence_batches
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, cross_params_from_jax, params_from_jax
from text_similarity_tpu_torch.models.encoder import encoder_forward
from text_similarity_tpu_torch.ops.pca import pca_fit_transform
from text_similarity_tpu_torch.train import init_train_state, make_optimizer
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
WORDS = ["cat", "dog", "sat", "on", "the", "mat", "rug", "big", "small", "red", "blue",
         "fast", "slow", "bird", "fish", "ran", "jumped", "house", "tree", "river"]
# f32 forwards of the two frameworks: the same products in another order
ATOL = 2e-5


def _np(tree):
    return jax.tree.map(np.array, jax.device_get(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in _np(tree).items()}


def _sentences(n, seed):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(2, 12))) for _ in range(n)]


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(train_wordpiece_vocab([" ".join(WORDS)] * 3, 256, min_freq=1))


@pytest.fixture(scope="module")
def model(tok):
    """A 4-layer tiny-test classifier (JAX init, 3 classes) in both
    packages, and four classification batches of synthetic documents."""
    kw = dict(NO_DROP, vocab_size=tok.vocab_size, num_layers=4)
    jarch, arch = JAX_PRESETS["tiny-test"].replace(**kw), ARCH_PRESETS["tiny-test"].replace(**kw)
    rng = np.random.default_rng(1)
    jp = {"encoder": jax_init(jax.random.PRNGKey(0), jarch),
          "head": {"w": jnp.asarray(rng.standard_normal((64, 3)) * 0.3, jnp.float32),
                   "b": jnp.asarray(rng.standard_normal(3) * 0.1, jnp.float32)}}
    tp = cross_params_from_jax(_np(jp), arch, 3)
    # one width, so that the JAX package's jitted gradients compile once
    docs = _sentences(32, 2)
    batches = build_sequence_batches(tok, docs, np.arange(32) % 3, batch_size=8, max_len=32,
                                     buckets=(32,), seed=0)
    jax_forward = jax.jit(lambda ids, mask, hm: jax_encoder_forward(
        jp["encoder"], ids, mask, arch=jarch, precision=JAX_FP32, output_hidden_states=True,
        head_mask=hm))
    return dict(jarch=jarch, arch=arch, jp=jp, tp=tp, batches=batches, jax_forward=jax_forward)


def _ids(arch, b=3, s=16, seed=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, s + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(5, arch.vocab_size, (b, s)) * mask).astype(np.int32)
    return ids, mask


# ---------------------------------------------------------------------------
# the encoder: hidden states, head masks, a pruned width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_mask", ["none", "binary", "fractional"])
def test_hidden_states_and_head_mask_match_jax(model, head_mask):
    """(L + 1, B, S, H) hidden states, embeddings first, and the pooler
    output, with no mask, a 0/1 mask and a fractional (L, nh) mask."""
    arch = model["arch"]
    ids, mask = _ids(arch)
    rng = np.random.default_rng(4)
    hm = {"none": None, "binary": (rng.random((4, 4)) < 0.6).astype(np.float32),
          "fractional": rng.random((4, 4)).astype(np.float32)}[head_mask]
    # the JAX side takes a mask of ones for none (probabilities × 1), so the
    # three cases share one compiled forward
    want = model["jax_forward"](jnp.asarray(ids), jnp.asarray(mask),
                                jnp.ones((4, 4)) if hm is None else jnp.asarray(hm))
    got = encoder_forward(model["tp"]["encoder"], torch.from_numpy(ids), torch.from_numpy(mask),
                          arch=arch, precision=FP32_PRECISION, output_hidden_states=True,
                          head_mask=None if hm is None else torch.from_numpy(hm))
    assert got.hidden_states.shape == (5, 3, 16, 64)
    np.testing.assert_allclose(got.hidden_states.numpy(), np.asarray(want.hidden_states),
                               atol=ATOL)
    torch.testing.assert_close(got.hidden_states[-1], got.last_hidden_state, rtol=0, atol=0)
    np.testing.assert_allclose(got.pooler_output.numpy(), np.asarray(want.pooler_output),
                               atol=ATOL)
    plain = encoder_forward(model["tp"]["encoder"], torch.from_numpy(ids), torch.from_numpy(mask),
                            arch=arch, precision=FP32_PRECISION)
    assert plain.hidden_states is None
    if hm is None:
        torch.testing.assert_close(plain.last_hidden_state, got.last_hidden_state, rtol=0, atol=0)


def _importances(model):
    jimp = (JP.head_importance(model["jp"], model["jarch"], model["batches"]),
            JP.ffn_importance(model["jp"], model["jarch"], model["batches"]))
    timp = (TP.head_importance(model["tp"], model["arch"], model["batches"]),
            TP.ffn_importance(model["tp"], model["arch"], model["batches"]))
    return jimp, timp


@pytest.fixture(scope="module")
def importances(model):
    return _importances(model)


def test_head_and_ffn_importance_match_jax(importances):
    """|∂loss/∂head_mask| and |W_out ⊙ ∂loss/∂W_out| over six batches,
    normalised per layer: rtol 1e-4."""
    (jh, jf), (th, tf) = importances
    assert th.shape == (4, 4) and tf.shape == (4, 128) and th.dtype == np.float64
    np.testing.assert_allclose(th, jh, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-9)


@pytest.fixture(scope="module")
def pruned(model, importances):
    """The JAX package's prune_rewire to 3 heads and 96 neurons, saved with
    its classifier head and arch as ``prune`` saves them."""
    (jh, jf), _ = importances
    jenc, jarch = JP.prune_rewire(model["jp"]["encoder"], model["jarch"], jh, jf,
                                  target_heads=3, target_ffn=96)
    return jenc, jarch


def test_prune_rewire_leaves_equal_jax_exactly(model, importances, pruned):
    (jh, jf), _ = importances
    tenc, tarch = TP.prune_rewire(model["tp"]["encoder"], model["arch"], jh, jf,
                                  target_heads=3, target_ffn=96)
    jenc, jarch = pruned
    assert json.loads(tarch.to_json()) == json.loads(jarch.to_json())
    assert tarch.head_dim_override == 16 and tarch.num_heads == 3
    want, got = _flat(_np(jenc)), _flat(tenc)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_jax_pruned_model_loads_and_runs_equally(model, pruned, tmp_path):
    """A pruned checkpoint written by the JAX package (q/k/v (H, 48), o
    (48, H), FFN 96) loads through ``cross_params_from_jax`` and gives the
    JAX package's logits and hidden states."""
    jenc, jarch = pruned
    jax_ckpt.save_checkpoint(str(tmp_path), {"encoder": jenc, "head": model["jp"]["head"]},
                             step=0, meta={"pruned": True})
    (tmp_path / "arch.json").write_text(jarch.to_json())
    arch = EncoderArch.from_json((tmp_path / "arch.json").read_text())
    tree, _, _ = ckpt.restore_checkpoint_raw(ckpt.latest_checkpoint(str(tmp_path)))
    tp = cross_params_from_jax(tree, arch, 3)
    assert tp["encoder"]["layers"]["attn"]["o"]["w"].shape == (4, 48, 64)
    ids, mask = _ids(arch, seed=5)
    jout = jax_encoder_forward(jenc, jnp.asarray(ids), jnp.asarray(mask), arch=jarch,
                               precision=JAX_FP32)
    tout = encoder_forward(tp["encoder"], torch.from_numpy(ids), torch.from_numpy(mask),
                           arch=arch, precision=FP32_PRECISION)
    np.testing.assert_allclose(tout.last_hidden_state.numpy(), np.asarray(jout.last_hidden_state),
                               atol=ATOL)
    # the classifier's cls pooling reads the pooler: the JAX package's logits
    head = _np(model["jp"]["head"])
    want = np.asarray(jout.pooler_output) @ head["w"] + head["b"]
    got = TS.classifier_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask), arch=arch,
                                precision=FP32_PRECISION)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_pruned_logits_equal_the_unpruned_model_with_its_head_mask(model, importances):
    """Heads only (the FFN kept whole): the pruned model's logits equal the
    unpruned model's run with the 0/1 mask of the kept heads (f32, atol
    1e-5: the dropped heads' products are exact zeros in one, absent in
    the other)."""
    _, (th, tf) = importances
    tenc, tarch = TP.prune_rewire(model["tp"]["encoder"], model["arch"], th, tf,
                                  target_heads=2, target_ffn=128)
    hm = np.zeros((4, 4), np.float32)
    for i in range(4):
        hm[i, np.argsort(-th[i])[:2]] = 1.0
    ids, mask = _ids(model["arch"], b=6, seed=6)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    small = TS.classifier_forward({"encoder": tenc, "head": model["tp"]["head"]}, ids_t, mask_t,
                                  arch=tarch, precision=FP32_PRECISION)
    masked = TS.classifier_forward(model["tp"], ids_t, mask_t, arch=model["arch"],
                                   precision=FP32_PRECISION, head_mask=torch.from_numpy(hm))
    full = TS.classifier_forward(model["tp"], ids_t, mask_t, arch=model["arch"],
                                 precision=FP32_PRECISION)
    torch.testing.assert_close(small, masked, rtol=0, atol=1e-5)
    assert (small - full).abs().max() > 1e-3      # the mask changes the logits


# ---------------------------------------------------------------------------
# losses, layer extraction, batches, PCA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer_map", [None, [0, 2, 4]])
@pytest.mark.parametrize("with_mask", [False, True])
def test_distillation_losses_match_jax(layer_map, with_mask):
    rng = np.random.default_rng(7)
    s, t = rng.standard_normal((3, 4, 6, 8)), rng.standard_normal((5, 4, 6, 8))
    mask = (rng.random((4, 6)) < 0.7).astype(np.int32) if with_mask else None
    got = TL.hidden_state_mse(torch.tensor(s), torch.tensor(t),
                              None if mask is None else torch.tensor(mask), layer_map=layer_map)
    want = JL.hidden_state_mse(jnp.asarray(s, jnp.float32), jnp.asarray(t, jnp.float32),
                               None if mask is None else jnp.asarray(mask), layer_map=layer_map)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    sl, tl = rng.standard_normal((4, 5)) * 3, rng.standard_normal((4, 5)) * 3
    valid = np.array([1, 1, 0, 1], np.int32) if with_mask else None
    for temp in (1.0, 2.0):
        got = TL.kl_distill_loss(torch.tensor(sl), torch.tensor(tl), temp,
                                 None if valid is None else torch.tensor(valid))
        want = JL.kl_distill_loss(jnp.asarray(sl, jnp.float32), jnp.asarray(tl, jnp.float32),
                                  temp, None if valid is None else jnp.asarray(valid))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_layer_extraction_and_distill_batches_equal_jax(model, tok):
    """extract_student_layers (copies, not views), every_other_layers and
    build_distill_batches (with and without the multilingual sources)
    equal the JAX package's exactly."""
    got = TD.extract_student_layers(model["tp"]["encoder"], [0, 3])
    want = _flat(_np(JD.extract_student_layers(model["jp"]["encoder"], [0, 3])))
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    leaf = got["embeddings"]["word"]
    assert leaf.data_ptr() != model["tp"]["encoder"]["embeddings"]["word"].data_ptr()
    for n, keep in [(6, 3), (12, 4), (4, 2), (3, 5), (6, 1)]:
        assert TD.every_other_layers(n, keep) == JD.every_other_layers(n, keep)
    sents = _sentences(20, 8)
    src = _sentences(20, 9)
    emb = np.random.default_rng(10).standard_normal((20, 6)).astype(np.float32)
    for kw in ({}, {"src_sentences": src}):
        got = build_distill_batches(tok, sents, emb, batch_size=8, max_len=32, seed=3, **kw)
        want = jax_build_distill_batches(tok, sents, emb, batch_size=8, max_len=32, seed=3, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_pca_matches_jax_up_to_each_components_sign():
    x = np.random.default_rng(11).standard_normal((40, 12)).astype(np.float32) * np.arange(1, 13)
    red, mu, comp = pca_fit_transform(torch.from_numpy(x), 5)
    jred, jmu, jcomp = (np.asarray(a) for a in jax_pca(x, 5))
    np.testing.assert_allclose(mu.numpy(), jmu, atol=1e-5)
    sign = np.sign((comp.numpy() * jcomp).sum(axis=1))
    assert np.all(sign != 0)
    np.testing.assert_allclose(comp.numpy() * sign[:, None], jcomp, atol=1e-4)
    np.testing.assert_allclose(red.numpy() * sign[None], jred, atol=1e-4)


def test_jax_students_load_and_the_dim_reducing_distiller_runs(model, tok, tmp_path):
    """Students the JAX package builds (a layer-drop student with
    ``DimReducingDistiller``'s new projection, a theseus student) saved by
    it load leaf for leaf; the port's ``DimReducingDistiller`` trains a
    64 → 16-dimensional student on the CPU."""
    rng = np.random.default_rng(19)
    jstudent = dict(JD.extract_student_layers(model["jp"]["encoder"], [0, 3]), projection={
        "w": jnp.asarray(rng.standard_normal((64, 16)) * 0.02, jnp.float32),
        "b": jnp.zeros((16,), jnp.float32)})
    jd = JT.TheseusDistiller(model["jp"]["encoder"], model["jarch"], 2)
    cases = {"dim": (jstudent, model["jarch"].replace(num_layers=2, projection_dim=16)),
             "theseus": (jd.compressed_params(), jd.compressed_arch)}
    for name, (tree, jarch) in cases.items():
        JaxSentenceEncoder(tree, jarch, tokenizer=tok, precision=JAX_FP32).save(
            str(tmp_path / name))
        enc = SentenceEncoder.load(str(tmp_path / name), bf16=False, device="cpu")
        want, got = _flat(_np(tree)), _flat(enc.params)
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"{name}/{k}")
        emb = enc.encode(_sentences(3, 20))
        assert emb.shape == (3, jarch.embedding_size) and np.isfinite(emb).all()

    teacher = SentenceEncoder(model["tp"]["encoder"], model["arch"], tokenizer=tok,
                              precision=FP32_PRECISION, device="cpu")
    d = TD.DimReducingDistiller(teacher, 16, num_student_layers=2,
                                train_config=TrainConfig(lr=1e-3, batch_size=8, bf16=False))
    student = d.distill(_sentences(16, 21), max_len=32)
    assert student.arch.num_layers == 2 and student.embedding_dim == 16
    mu, comp = d.pca
    assert mu.shape == (1, 64) and comp.shape == (16, 64)
    assert np.isfinite(student.encode(_sentences(3, 22))).all()


# ---------------------------------------------------------------------------
# one step of each trainer: the loss and every gradient
# ---------------------------------------------------------------------------

class _RecordGrads:
    """A port optimizer that only records the gradients it is given."""

    def init(self, params):
        return {}

    def step(self, params, grads, opt_state):
        self.grads = grads


def _jax_recorder():
    """An optax transformation that keeps the gradients as its state and
    leaves the params alone."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _grads_parity(jstep_of, tstep_of, jparams, tparams, batch, jextra=(), textra=()):
    """One step of each package from the same weights: the metrics (rtol
    1e-5) and every gradient (rtol 1e-4, atol 1e-7) → the port's grads."""
    jtx = _jax_recorder()
    jstate = jax_init_train_state(jax.tree.map(jnp.array, jparams), jtx)
    jstate, jm = jstep_of(jtx)(jstate, jax.tree.map(jnp.asarray, batch), *jextra)
    ttx = _RecordGrads()
    tstate = init_train_state(tparams, ttx, device="cpu")
    _, tm = tstep_of(ttx)(tstate, batch, *textra)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want, got = _flat(_np(jstate.opt_state)), _flat(ttx.grads)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7, err_msg=k)
    return ttx.grads


def test_distill_step_matches_jax(model, tok):
    """The student's distill-MSE step (remat on, a projection head as
    DimReducingDistiller gives it) against the JAX package's."""
    sents = _sentences(8, 12)
    target = np.random.default_rng(13).standard_normal((8, 16)).astype(np.float32) * 0.1
    batch = build_distill_batches(tok, sents, target, batch_size=8, max_len=32)[0]
    student = {"encoder": dict(JD.extract_student_layers(model["jp"]["encoder"], [1, 3]),
                               projection={"w": jnp.asarray(
                                   np.random.default_rng(14).standard_normal((64, 16)) * 0.02,
                                   jnp.float32), "b": jnp.zeros((16,), jnp.float32)})}
    jarch = model["jarch"].replace(num_layers=2, projection_dim=16)
    arch = model["arch"].replace(num_layers=2, projection_dim=16)
    _grads_parity(
        lambda tx: JS.make_bi_encoder_train_step(jarch, tx, loss_type="distill_mse",
                                                 precision=JAX_FP32, remat=True),
        lambda tx: TS.make_bi_encoder_train_step(arch, tx, loss_type="distill_mse",
                                                 precision=FP32_PRECISION, remat=True,
                                                 device="cpu"),
        student, {"encoder": params_from_jax(_np(student["encoder"]), arch)}, batch)


def test_fastformers_step_matches_jax(model):
    """KL + layer-mapped state MSE + hard-label CE, the teacher frozen."""
    keep = [1, 3]
    # the student's head is its own, so that the KL is far from 0
    head = jax.tree.map(lambda p: p * 2.0, model["jp"]["head"])
    jstudent = {"encoder": JD.extract_student_layers(model["jp"]["encoder"], keep), "head": head}
    tstudent = {"encoder": TD.extract_student_layers(model["tp"]["encoder"], keep),
                "head": _tensors(head)}
    sarch_j, sarch = model["jarch"].replace(num_layers=2), model["arch"].replace(num_layers=2)
    layer_map = np.asarray([0] + [k + 1 for k in keep], np.int32)
    kw = dict(alpha_ce=0.5, layer_map=layer_map)
    grads = _grads_parity(
        lambda tx: JS.make_fastformers_distill_step(sarch_j, model["jarch"], tx,
                                                    precision=JAX_FP32, **kw),
        lambda tx: TS.make_fastformers_distill_step(sarch, model["arch"], tx,
                                                    precision=FP32_PRECISION, device="cpu", **kw),
        jstudent, tstudent, model["batches"][0], (model["jp"],), (model["tp"],))
    assert float(grads["head"]["w"].abs().max()) > 0


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_theseus_forward_matches_jax_and_the_plain_stacks(model, rate):
    """Rate 1 runs every successor (equal to the 2-layer student's plain
    ``encoder_forward``), rate 0 every predecessor (the teacher's)."""
    ids, mask = _ids(model["arch"], seed=15)
    jenc, tenc = model["jp"]["encoder"], model["tp"]["encoder"]
    jsucc = JT.init_successors_from_predecessors(jenc["layers"], 2)
    tsucc = TT.init_successors_from_predecessors(tenc["layers"], 2)
    for k, v in _flat(tsucc).items():
        np.testing.assert_array_equal(v, _flat(_np(jsucc))[k], err_msg=k)
    # the successors get their own weights, so the two paths differ
    tsucc = {k: v for k, v in _tensors(jax.tree.map(lambda p: p * 1.5, jsucc)).items()}
    jsucc = jax.tree.map(lambda p: p * 1.5, jsucc)
    want = JT.theseus_encoder_forward(jenc["layers"], jsucc, jenc["embeddings"], jnp.asarray(ids),
                                      jnp.asarray(mask), arch=model["jarch"], replace_rate=rate,
                                      rng=jax.random.PRNGKey(0), precision=JAX_FP32)
    got = TT.theseus_encoder_forward(tenc["layers"], tsucc, tenc["embeddings"],
                                     torch.from_numpy(ids), torch.from_numpy(mask),
                                     arch=model["arch"], replace_rate=rate,
                                     generator=torch.Generator().manual_seed(0),
                                     precision=FP32_PRECISION)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if rate == 1.0:
        plain = encoder_forward(dict(tenc, layers=tsucc), torch.from_numpy(ids),
                                torch.from_numpy(mask), arch=model["arch"].replace(num_layers=2),
                                precision=FP32_PRECISION)
    else:
        plain = encoder_forward(tenc, torch.from_numpy(ids), torch.from_numpy(mask),
                                arch=model["arch"], precision=FP32_PRECISION)
    torch.testing.assert_close(got, plain.last_hidden_state, rtol=0, atol=1e-6)


def test_replacement_scheduler_equals_jax():
    for base, k in [(0.3, 0.0), (0.3, 5e-4), (0.5, 0.1), (1.2, 0.0)]:
        t, j = TT.ReplacementScheduler(base, k), JT.ReplacementScheduler(base, k)
        assert [t.rate(s) for s in (0, 1, 7, 100, 5000)] == [j.rate(s) for s in
                                                            (0, 1, 7, 100, 5000)]


@pytest.fixture(scope="module")
def theseus_setup(model, tok):
    rng = np.random.RandomState(16)
    pairs = [(" ".join(rng.choice(WORDS, 5)), " ".join(rng.choice(WORDS, 6))) for _ in range(8)]
    from text_similarity_tpu_torch.data.pairs import build_pair_batches

    batch = build_pair_batches(tok, pairs, np.arange(8) % 2, batch_size=8, max_len=32,
                               target_dtype=np.int32)[0]
    cfg = JaxTrainConfig(lr=1e-3, bf16=False)
    jd = JT.TheseusDistiller(model["jp"]["encoder"], model["jarch"], 2, train_config=cfg)
    td = TT.TheseusDistiller(model["tp"]["encoder"], model["arch"], 2,
                             train_config=TrainConfig(lr=1e-3, bf16=False))
    head = np.random.default_rng(17).standard_normal((192, 2)).astype(np.float32) * 0.05
    jparams = {"succ": jd.succ, "head": {"w": jnp.asarray(head), "b": jnp.zeros((2,))}}
    # one compiled JAX step for both rates (the rate is an argument)
    jrecord = jd.make_train_step(_jax_recorder(), num_classes=2)
    return jd, td, jparams, batch, jrecord


@pytest.mark.parametrize("rate", [1.0, 0.0])
def test_theseus_step_matches_jax(model, theseus_setup, rate):
    """One step at rate 1 (every successor runs) and at rate 0 (none does:
    the successors' gradients are zeros, not missing)."""
    jd, td, jparams, batch, jrecord = theseus_setup
    enc_j, enc_t = model["jp"]["encoder"], model["tp"]["encoder"]
    grads = _grads_parity(
        lambda tx: jrecord,
        lambda tx: td.make_train_step(tx, num_classes=2),
        jparams, _tensors(jparams), batch,
        (rate, enc_j["layers"], enc_j["embeddings"]), (rate, enc_t["layers"], enc_t["embeddings"]))
    succ_max = max(float(np.abs(g).max()) for g in _flat(grads["succ"]).values())
    assert (succ_max > 0) == (rate == 1.0)


def test_unchosen_successors_still_move_under_adamw(model, theseus_setup):
    """Two AdamW steps at rate 0 (the first has lr 0): the successors' zero
    gradients leave the moments at 0, so weight decay alone moves their
    kernels, p · (1 − lr · wd), as optax moves them (the optimizer itself
    is held to optax in test_torch_train)."""
    _, td, jparams, batch, _ = theseus_setup
    enc = model["tp"]["encoder"]
    tparams = _tensors(jparams)
    tx = make_optimizer(TrainConfig(lr=1e-2, warmup_ratio=0.25), 8, params_example=tparams)
    state = init_train_state(tparams, tx, device="cpu")
    step = td.make_train_step(tx, num_classes=2)
    for _ in range(2):
        state, _ = step(state, batch, 0.0, enc["layers"], enc["embeddings"])
    before, got = _flat(_np(jparams)), _flat(state.params)
    lr1 = 1e-2 * 0.5                       # the second step's rate on the warmup ramp
    for k in ("succ/attn/q/w", "succ/mlp/out/w"):
        np.testing.assert_allclose(got[k], before[k] * (1 - lr1 * 0.01), rtol=1e-6, err_msg=k)
        assert not np.array_equal(got[k], before[k])
    np.testing.assert_array_equal(got["succ/attn/q/b"], before["succ/attn/q/b"])  # no decay
    assert not np.allclose(got["head/w"], before["head/w"])


# ---------------------------------------------------------------------------
# the CLI: distill, theseus, prune → eval-classification
# ---------------------------------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_distill_theseus_and_prune_commands(model, tok, tmp_path, capsys):
    """The three commands in this process on the CPU, from directories the
    JAX package wrote: each prints the JAX CLI's JSON keys; the students
    load and encode; the pruned classifier goes through
    ``eval-classification``."""
    jenc = JaxSentenceEncoder(model["jp"]["encoder"], model["jarch"], tokenizer=tok,
                              precision=JAX_FP32)
    teacher = str(tmp_path / "teacher")
    jenc.save(teacher)
    sents = _sentences(24, 18)
    (tmp_path / "sents.txt").write_text("\n".join(sents) + "\n")
    (tmp_path / "paws.tsv").write_text("id\tsentence1\tsentence2\tlabel\n" + "".join(
        f"{i}\t{sents[i]}\t{sents[i + 1]}\t{i % 2}\n" for i in range(16)))
    common = ["--model", teacher, "--fp32", "--batch-size", "8", "--max-len", "32",
              "--device", "cpu"]
    main(["distill", "--data", str(tmp_path / "sents.txt"), "--student-layers", "2",
          "--save-path", str(tmp_path / "student")] + common)
    assert _last_json(capsys) == {"student_layers": 2, "saved": str(tmp_path / "student")}
    main(["theseus", "--data", str(tmp_path / "paws.tsv"), "--slots", "2",
          "--save-path", str(tmp_path / "theseus")] + common)
    assert _last_json(capsys) == {"layers": 2, "saved": str(tmp_path / "theseus")}
    for d in ("student", "theseus"):
        port = SentenceEncoder.load(str(tmp_path / d), bf16=False, device="cpu")
        assert port.arch.num_layers == 2
        emb = port.encode(sents[:6])
        assert emb.shape == (6, 64) and np.isfinite(emb).all()

    # a classifier directory as train-classification writes it, then prune
    clf = tmp_path / "clf"
    jax_ckpt.save_checkpoint(str(clf), model["jp"], step=0)
    (clf / "arch.json").write_text(model["jarch"].to_json())
    (clf / "labels.json").write_text(json.dumps(["a", "b", "c"]))
    tok.save_vocab(str(clf / "vocab.txt"))
    docs = [{"text": s, "label": "abc"[i % 3]} for i, s in enumerate(sents)]
    (tmp_path / "docs.json").write_text(json.dumps(docs))
    main(["prune", "--model", str(clf), "--data", str(tmp_path / "docs.json"), "--target-heads",
          "2", "--target-ffn", "64", "--batch-size", "8", "--max-len", "32", "--save-path",
          str(tmp_path / "pruned"), "--device", "cpu"])
    assert _last_json(capsys) == {"heads": 2, "ffn": 64, "saved": str(tmp_path / "pruned")}
    arch = json.loads((tmp_path / "pruned" / "arch.json").read_text())
    assert arch["head_dim_override"] == 16 and arch["num_heads"] == 2
    evaluate = ["eval-classification", "--model", str(tmp_path / "pruned"), "--data",
                str(tmp_path / "docs.json"), "--fp32", "--batch-size", "8", "--max-len", "32"]
    main(evaluate + ["--device", "cpu"])
    got = _last_json(capsys)
    assert got["n"] == 24 and 0.0 <= got["accuracy"] <= 1.0
