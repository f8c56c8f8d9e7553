"""The port's classifier, packed, token and masked-LM train steps against
the JAX package's steps on the same carried weights and batches (dropout
0, f32): the loss, the metrics and the parameters after two AdamW steps
(the first has lr 0). Also: the packed steps against the dense ones, the
masked-LM forward and loss on a fixed corrupted batch, ``mlm_mask_batch``'s
law, ``remat`` against no remat with dropout on, and MLM on ALBERT."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import text_similarity_tpu.train.steps as JS
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import TrainConfig as JaxTrainConfig
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.losses import mlm_loss as jax_mlm_loss
from text_similarity_tpu.train import init_train_state as jax_init_train_state
from text_similarity_tpu.train import make_optimizer as jax_make_optimizer
import text_similarity_tpu_torch.models.encoder as TE
import text_similarity_tpu_torch.train.steps as TS
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, TrainConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.pairs import build_packed_pair_batches, build_pair_batches
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import params_from_jax
from text_similarity_tpu_torch.models.losses import mlm_loss
from text_similarity_tpu_torch.train import init_train_state, make_optimizer

NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
WORDS = ["cat", "dog", "sat", "on", "the", "mat", "rug", "big", "small", "red", "blue",
         "fast", "slow", "bird", "fish", "ran", "jumped", "house", "tree", "river"]


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(train_wordpiece_vocab([" ".join(WORDS)] * 3, 256, min_freq=1))


def _pairs(n, seed):
    rng = np.random.RandomState(seed)
    pairs = [(" ".join(rng.choice(WORDS, rng.randint(2, 9))),
              " ".join(rng.choice(WORDS, rng.randint(2, 9)))) for _ in range(n)]
    return pairs, rng.rand(n).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.array, jax.device_get(tree))


def _port_tree(jtree, arch):
    """A JAX {"encoder", ...} tree → the port's tensors."""
    out = {}
    for k, v in _np(jtree).items():
        out[k] = (params_from_jax(v, arch) if k == "encoder" else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _jax_params(arch_name="tiny-test", head=None, mlm=False, **kw):
    jarch = JAX_PRESETS[arch_name].replace(**NO_DROP, **kw)
    arch = ARCH_PRESETS[arch_name].replace(**NO_DROP, **kw)
    jp = {"encoder": jax_init(jax.random.PRNGKey(0), jarch)}
    rng = np.random.default_rng(1)
    if head:
        jp["head"] = {"w": jnp.asarray(rng.standard_normal(head) * 0.02, jnp.float32),
                      "b": jnp.asarray(rng.standard_normal(head[1]) * 0.02, jnp.float32)}
    if mlm:
        jp["mlm_bias"] = jnp.asarray(rng.standard_normal(arch.vocab_size) * 0.1, jnp.float32)
    return jarch, arch, jp


def _step_parity(jstep_of, tstep_of, jparams, arch, batches, keys):
    """Two steps of each package's step from the same weights: metrics
    (rtol 1e-5) after each, parameters after both (rtol 1e-4, atol 2e-6)."""
    jtx = jax_make_optimizer(JaxTrainConfig(lr=1e-3, warmup_ratio=0.25, bf16=False), 8,
                             params_example=jparams)
    # the JAX step donates its state: it gets copies of the weights
    jstate = jax_init_train_state(jax.tree.map(jnp.array, jparams), jtx)
    jstep = jstep_of(jtx)
    tparams = _port_tree(jparams, arch)
    ttx = make_optimizer(TrainConfig(lr=1e-3, warmup_ratio=0.25), 8, params_example=tparams)
    tstate = init_train_state(tparams, ttx, device="cpu")
    tstep = tstep_of(ttx)
    for b in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, b)
        assert set(tm) == set(jm)
        for k in keys:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want, got = _flat(_np(jstate.params)), _flat(tstate.params)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=2e-6, err_msg=k)
    return tstate


def _packed_matches_dense(make_dense, make_packed, dense, packed, jp, arch, keys, **kw):
    """The same pairs in one dense and one packed batch: the same metrics
    (rtol 1e-4) and parameters after two steps (rtol 2e-3, atol 1e-5), as
    the JAX package's own packed tests hold them."""
    out = []
    for make, batch in ((make_dense, dense), (make_packed, packed)):
        tx = make_optimizer(TrainConfig(lr=1e-3, warmup_ratio=0.0), 4)
        st = init_train_state(_port_tree(jp, arch), tx, device="cpu")
        step = make(arch, tx, precision=FP32_PRECISION, device="cpu", **kw)
        for _ in range(2):
            st, m = step(st, batch)
        out.append((_flat(st.params), m))
    (pd, md), (pp, mp) = out
    for k in keys:
        np.testing.assert_allclose(float(mp[k]), float(md[k]), rtol=1e-4, err_msg=k)
    for k, w in pd.items():
        np.testing.assert_allclose(pp[k], w, rtol=2e-3, atol=1e-5, err_msg=k)


def test_classifier_step_matches_jax(tok):
    jarch, arch, jp = _jax_params(head=(64, 3), vocab_size=tok.vocab_size)
    pairs, t = _pairs(16, 0)
    batches = build_pair_batches(tok, pairs, (t * 3).astype(np.int32), batch_size=8,
                                 max_len=32, mode="cross", buckets=(32,), target_dtype=np.int32)
    _step_parity(
        lambda tx: JS.make_classifier_train_step(jarch, tx, precision=JAX_FP32),
        lambda tx: TS.make_classifier_train_step(arch, tx, precision=FP32_PRECISION,
                                                 device="cpu"),
        jp, arch, batches, ["loss", "accuracy"])


def test_token_classifier_step_matches_jax():
    jarch, arch, jp = _jax_params(head=(64, 5))
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        lens = rng.integers(4, 17, 4)
        mask = (np.arange(16)[None] < lens[:, None]).astype(np.int32)
        tags = np.where(rng.random((4, 16)) < 0.3, -100, rng.integers(0, 5, (4, 16)))
        tags[mask == 0] = 2                     # a tag on padding is ignored too
        batches.append({"ids": (rng.integers(5, 1000, (4, 16)) * mask).astype(np.int32),
                        "mask": mask, "tags": tags.astype(np.int32)})
    _step_parity(
        lambda tx: JS.make_token_classifier_train_step(jarch, tx, precision=JAX_FP32),
        lambda tx: TS.make_token_classifier_train_step(arch, tx, precision=FP32_PRECISION,
                                                       device="cpu"),
        jp, arch, batches, ["loss", "accuracy"])


@pytest.mark.parametrize("loss", ["cosine_mse", "softmax"])
def test_packed_bi_step_matches_jax_and_the_dense_step(tok, loss):
    jarch, arch, jp = _jax_params(head=(192, 3) if loss == "softmax" else None,
                                  vocab_size=tok.vocab_size, has_pooler=False)
    pairs, t = _pairs(24, 1)
    dt = np.int32 if loss == "softmax" else np.float32
    target = (t * 3).astype(dt) if loss == "softmax" else t
    packed = build_packed_pair_batches(tok, pairs, target, rows_per_side=4, width=32,
                                       shuffle=False, target_dtype=dt)
    assert len(packed) >= 2
    keys = ["loss"] + (["accuracy"] if loss == "softmax" else [])
    _step_parity(
        lambda tx: JS.make_packed_bi_encoder_train_step(jarch, tx, loss_type=loss,
                                                        precision=JAX_FP32),
        lambda tx: TS.make_packed_bi_encoder_train_step(arch, tx, loss_type=loss,
                                                        precision=FP32_PRECISION, device="cpu"),
        jp, arch, packed[:2], keys)
    one = build_packed_pair_batches(tok, pairs, target, rows_per_side=16, width=32,
                                    shuffle=False, target_dtype=dt)
    dense = build_pair_batches(tok, pairs, target, batch_size=24, max_len=32, shuffle=False,
                               target_dtype=dt)
    assert len(one) == len(dense) == 1
    _packed_matches_dense(TS.make_bi_encoder_train_step, TS.make_packed_bi_encoder_train_step,
                          dense[0], one[0], jp, arch, keys, loss_type=loss)


def test_packed_classifier_step_matches_jax_and_the_dense_step(tok):
    jarch, arch, jp = _jax_params(head=(64, 2), vocab_size=tok.vocab_size)
    pairs, t = _pairs(20, 2)
    labels = (t * 2).astype(np.int32)
    packed = build_packed_pair_batches(tok, pairs, labels, rows_per_side=6, width=32,
                                       mode="cross", shuffle=False, target_dtype=np.int32)
    assert len(packed) >= 2
    _step_parity(
        lambda tx: JS.make_packed_classifier_train_step(jarch, tx, precision=JAX_FP32),
        lambda tx: TS.make_packed_classifier_train_step(arch, tx, precision=FP32_PRECISION,
                                                        device="cpu"),
        jp, arch, packed[:2], ["loss", "accuracy"])
    one = build_packed_pair_batches(tok, pairs, labels, rows_per_side=16, width=32,
                                    mode="cross", shuffle=False, target_dtype=np.int32)
    dense = build_pair_batches(tok, pairs, labels, batch_size=20, max_len=32, mode="cross",
                               shuffle=False, target_dtype=np.int32)
    assert len(one) == len(dense) == 1
    _packed_matches_dense(TS.make_classifier_train_step, TS.make_packed_classifier_train_step,
                          dense[0], one[0], jp, arch, ["loss", "accuracy"])


def _mlm_batch(arch, b=3, s=24, seed=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, s + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(5, arch.vocab_size, (b, s)) * mask).astype(np.int32)
    labels = np.where((rng.random((b, s)) < 0.3) & (mask > 0), ids, -100).astype(np.int32)
    corrupted = np.where(labels >= 0, 4, ids).astype(np.int32)
    return ids, mask, corrupted, labels


@pytest.mark.parametrize("albert", [False, True])
def test_mlm_forward_loss_and_step_match_jax(monkeypatch, albert):
    """A fixed corrupted batch: mlm_forward + mlm_loss against the JAX
    package's; then two MLM steps with that corruption put in place of
    both packages' dynamic masking. ALBERT with E == H (the tied head
    needs the word table H wide)."""
    kw = dict(share_layers=True, embed_factor_size=64, num_layers=3) if albert else {}
    jarch, arch, jp = _jax_params(mlm=True, **kw)
    ids, mask, corrupted, labels = _mlm_batch(arch)
    want = JS.mlm_forward(jp, jnp.asarray(corrupted), jnp.asarray(mask), arch=jarch,
                          precision=JAX_FP32)
    tp = _port_tree(jp, arch)
    got = TS.mlm_forward(tp, torch.from_numpy(corrupted), torch.from_numpy(mask), arch=arch,
                         precision=FP32_PRECISION)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(mlm_loss(got, torch.from_numpy(labels))),
                               float(jax_mlm_loss(want, jnp.asarray(labels))), rtol=1e-5)

    monkeypatch.setattr(JS, "mlm_mask_batch",
                        lambda *a, **k: (jnp.asarray(corrupted), jnp.asarray(labels)))
    monkeypatch.setattr(TS, "mlm_mask_batch", lambda *a, **k: (
        torch.from_numpy(corrupted), torch.from_numpy(labels)))
    batch = {"ids": ids, "mask": mask}
    _step_parity(
        lambda tx: JS.make_mlm_train_step(jarch, tx, mask_token_id=4, precision=JAX_FP32),
        lambda tx: TS.make_mlm_train_step(arch, tx, mask_token_id=4, precision=FP32_PRECISION,
                                          device="cpu"),
        jp, arch, [batch, batch], ["loss", "masked_tokens"])


def test_mlm_on_albert_with_a_narrow_table_raises():
    arch = ARCH_PRESETS["tiny-test"].replace(share_layers=True, embed_factor_size=32)
    params = {"encoder": TE.init_params(arch, torch.Generator().manual_seed(0))}
    with pytest.raises(ValueError, match="embed_factor_size"):
        TS.make_mlm_train_step(arch, make_optimizer(TrainConfig(), 1), mask_token_id=4,
                               device="cpu")
    ids = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="embed_factor_size"):
        TS.mlm_forward(params, ids, ids, arch=arch)


def test_mlm_mask_batch_law():
    """64 × 512 tokens, 1/8 padding, specials sprinkled in: no special or
    padded token is selected; 15% ± 1% of the eligible are; of those, 80% ±
    3% become [MASK], 10% ± 2.5% a random token and 10% ± 2.5% stay (five
    standard deviations each); labels hold the original id where selected
    and −100 elsewhere."""
    rng = np.random.default_rng(0)
    vocab, specials, mask_id = 30000, (0, 100, 101, 102, 103), 103
    ids = rng.integers(0, vocab, (64, 512))
    ids[rng.random(ids.shape) < 0.05] = 101
    ids[:, 0] = 101
    mask = (np.arange(512)[None] < rng.integers(384, 513, 64)[:, None]).astype(np.int32)
    ids = torch.from_numpy(np.where(mask > 0, ids, 0).astype(np.int32))
    gen = torch.Generator().manual_seed(1)
    corrupted, labels = TS.mlm_mask_batch(gen, ids, torch.from_numpy(mask), vocab, mask_id,
                                          0.15, special_ids=specials)
    ids, corrupted, labels = ids.numpy(), corrupted.numpy(), labels.numpy()
    eligible = (mask > 0) & ~np.isin(ids, specials)
    sel = labels >= 0
    assert not (sel & ~eligible).any()
    assert (labels[sel] == ids[sel]).all() and (labels[~sel] == -100).all()
    assert (corrupted[~sel] == ids[~sel]).all()
    assert abs(sel.sum() / eligible.sum() - 0.15) <= 0.01
    n = sel.sum()
    to_mask = (corrupted[sel] == mask_id).sum() / n
    kept = (corrupted[sel] == ids[sel]).sum() / n
    assert abs(to_mask - 0.8) <= 0.03
    assert abs(kept - 0.1) <= 0.025
    assert abs(1 - to_mask - kept - 0.1) <= 0.025
    # drawn from the generator: the same seed gives the same corruption
    again = TS.mlm_mask_batch(torch.Generator().manual_seed(1), torch.from_numpy(ids),
                              torch.from_numpy(mask), vocab, mask_id, 0.15, special_ids=specials)
    np.testing.assert_array_equal(again[0].numpy(), corrupted)


@pytest.mark.parametrize("kind", ["bi", "packed", "albert", "moe"])
def test_remat_leaves_the_gradients_unchanged_with_dropout_on(tok, monkeypatch, kind):
    """tiny-test with hidden dropout 0.1: the loss's gradients from the same
    seed are equal with remat False, True and "dots", the generator ends in
    the same state, and remat really recomputes (each layer runs twice).
    ``moe``: 4 experts at capacity factor 0.5, each layer's (out, aux,
    drop) through the checkpoint and the aux term in the loss."""
    kw = dict(share_layers=True, embed_factor_size=32, num_layers=3) if kind == "albert" else {}
    if kind == "moe":
        kw = dict(num_experts=4, expert_capacity_factor=0.5)
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size, **kw)
    params = TS.trainable({"encoder": TE.init_params(arch, torch.Generator().manual_seed(0))})
    pairs, t = _pairs(12, 4)
    if kind == "packed":
        batch = build_packed_pair_batches(tok, pairs, t, rows_per_side=8, width=32)[0]
    else:
        batch = build_pair_batches(tok, pairs, t, batch_size=12, max_len=32)[0]
    batch = TS.batch_to(batch, torch.device("cpu"))
    calls = []
    real = TE.transformer_layer
    monkeypatch.setattr(TE, "transformer_layer", lambda *a, **k: calls.append(1) or real(*a, **k))

    def loss_fn(p, b, gen, remat):
        loss = TS.packed_bi_encoder_loss if kind == "packed" else TS.bi_encoder_loss
        return loss(p, b, arch=arch, precision=FP32_PRECISION, generator=gen, remat=remat)

    def grads(remat):
        g = torch.Generator().manual_seed(7)
        calls.clear()
        loss, aux, gr = TS.value_and_grad(loss_fn, params, batch, g, remat)
        return float(loss.detach()), _flat(gr), g.get_state(), len(calls), aux

    base = grads(False)
    assert (float(base[4]["moe_drop"].detach()) > 0) if kind == "moe" else "moe_drop" not in base[4]
    assert base[3] == 2 * arch.num_layers
    for remat in (True, "dots"):
        got = grads(remat)
        assert got[3] == 4 * arch.num_layers          # forward, then the recompute
        assert got[0] == base[0] and torch.equal(got[2], base[2])
        for k, w in base[1].items():
            np.testing.assert_allclose(got[1][k], w, rtol=1e-6, atol=1e-9, err_msg=k)
