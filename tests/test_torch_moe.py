"""The MoE expert FFN in the port against the JAX package, f32 on the CPU:
``expert_capacity`` over a grid; ``router_topk`` over several seeds with
padding and deliberate ties (choice, slot and keep equal; gate, aux and
drop within 1e-6); ``moe_ffn`` at top-k 1 and 2 with overflow, in bf16 within
one bf16 ulp of the JAX package's, one expert
equal to the dense FFN, ``top_k`` outside [1, E] refused; int8 experts
against the JAX package's int8 ``moe_ffn`` (capacity 8 and 16);
``encoder_forward`` (with ALBERT); a JAX-saved MoE ``SentenceEncoder``
loaded, encoded (bucketed and packed, the reference's batch shapes),
quantized and saved back; the bi-encoder, classifier and MLM steps after
two steps; ``train-sts --experts 2 --expert-top-k 1`` through the CLI; the
router-skew drive at a tiny size."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import text_similarity_tpu.train.steps as JS
from text_similarity_tpu.compress.quantize import _quant_leaf as jax_quant_leaf
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.ops import moe as JM
import text_similarity_tpu_torch.ops.moe as TM
import text_similarity_tpu_torch.train.steps as TS
from text_similarity_tpu_torch.cli.main import main
from text_similarity_tpu_torch.compress.quantize import _quant_leaf
from text_similarity_tpu_torch.core.config import EncoderArch
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.pairs import build_pair_batches
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.drives import moe_router_skew
from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward, params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_steps import NO_DROP, WORDS, _mlm_batch, _pairs, _step_parity


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _ffn_inputs(seed=0, b=2, s=12, h=8, i=16, e=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[-1, s - 3:] = 0
    w = [rng.standard_normal(shp).astype(np.float32) * sc for shp, sc in
         (((h, e), 1.0), ((e, h, i), 0.3), ((e, i), 0.1), ((e, i, h), 0.3), ((e, h), 0.1))]
    return [x, mask] + w


def test_expert_capacity_matches_jax():
    for t in (1, 7, 16, 100, 4096):
        for e in (1, 4, 8):
            for k in (1, 2):
                for cf in (0.5, 1.0, 1.25, 2.0):
                    assert TM.expert_capacity(t, e, k, cf) == JM.expert_capacity(t, e, k, cf)


@pytest.mark.parametrize("seed", range(4))
def test_router_topk_matches_jax(seed):
    """T 40, E 6, a padded tail; rows with two equal maxima and a row of
    equal logits (the first maximum wins in both); k 1-3 at a capacity of
    4, so later tokens overflow."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, 6)).astype(np.float32)
    logits[::5, 4] = logits[::5, 1] = logits[::5].max(axis=1) + 0.5
    logits[7] = 0.25
    valid = np.ones(40, np.float32)
    valid[33:] = 0
    for k in (1, 2, 3):
        want = jax.jit(JM.router_topk, static_argnums=(2, 3))(*_j(logits, valid), k, 4)
        got = TM.router_topk(*_t(logits, valid), k, 4)
        for name, w, g in zip(("choice", "slot", "gate", "keep", "aux", "drop"), want, got):
            w, g = np.asarray(w), g.numpy()
            if name in ("choice", "slot", "keep"):
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)
        assert got[0][0, 7] == 0 and (got[0][0, ::5] == 1).all()
        assert float(got[5]) > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax_with_overflow(top_k):
    args = _ffn_inputs(s=40)
    for cf in (0.5, 1.25):
        want = jax.jit(functools.partial(JM.moe_ffn, top_k=top_k, capacity_factor=cf))(
            *_j(*args))
        got = TM.moe_ffn(*_t(*args), top_k=top_k, capacity_factor=cf)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-6)
        np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6)
    assert float(TM.moe_ffn(*_t(*args), top_k=top_k, capacity_factor=0.5)[2]) > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_bf16_matches_jax(top_k):
    """bf16 hidden states, f32 weights: the expert products accumulate and
    stay in f32 through the bias and the activation in both packages, so
    only the f32 summation order differs. Each output is within one bf16
    ulp of the JAX package's (|Δ| ≤ 2^-7·|want|) and at most 1% of them
    differ at all (readings over seeds 0-3: 0.01-0.07%, max |Δ| / |want|
    7.75e-3 at |want| > 1e-2; a product rounded to bf16 before the bias
    makes 56-58% of them differ, by up to 0.125)."""
    x, *rest = _ffn_inputs(seed=0, b=4, s=64, h=64, i=128, e=4)
    want = jax.jit(functools.partial(JM.moe_ffn, top_k=top_k, capacity_factor=1.25))(
        jnp.asarray(x).astype(jnp.bfloat16), *_j(*rest))
    got = TM.moe_ffn(torch.from_numpy(x).bfloat16(), *_t(*rest), top_k=top_k,
                     capacity_factor=1.25)
    w0, g0 = np.asarray(want[0].astype(jnp.float32)), got[0].float().numpy()
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(g0, w0, rtol=2 ** -7, atol=1e-5)
    assert np.mean(g0 != w0) <= 0.01
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6)


def test_bf16_expert_product_and_its_gradients():
    """The bf16 expert product returns the f32 sum of exact products (the
    f32 product of the bf16 values), and its gradients are those autograd
    gives the product in bf16: the cotangent rounded to bf16."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 16, 32), generator=g).bfloat16().requires_grad_()
    w = torch.randn((4, 32, 24), generator=g).requires_grad_()
    y = TM._expert_gemm(x, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, torch.bmm(x.detach().float(), w.detach().bfloat16().float()))
    gy = torch.randn(y.shape, generator=g)
    (y * gy).sum().backward()
    x2, w2 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    (torch.bmm(x2, w2.bfloat16()).float() * gy).sum().backward()
    assert torch.equal(x.grad, x2.grad) and torch.equal(w.grad, w2.grad)


def test_one_expert_equals_the_dense_ffn():
    x, mask, rw, wi, bi, wo, bo = _ffn_inputs(e=1)
    y, aux, drop = TM.moe_ffn(*_t(x, mask, rw, wi, bi, wo, bo), top_k=1, capacity_factor=1.0)
    dense = torch.nn.functional.gelu(torch.from_numpy(x @ wi[0] + bi[0]), approximate="tanh")
    dense = (dense @ torch.from_numpy(wo[0]) + torch.from_numpy(bo[0])).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(y.numpy()[valid], dense[valid], atol=1e-5, rtol=1e-5)
    assert not y.numpy()[~valid].any() and float(drop) == 0 and float(aux) == pytest.approx(1.0)


def test_top_k_outside_the_experts_raises():
    args = _t(*_ffn_inputs())
    for k in (0, 5):
        with pytest.raises(ValueError, match="expert_top_k"):
            TM.moe_ffn(*args, top_k=k)


@pytest.mark.parametrize("b,s", [(1, 8), (4, 16)])
def test_int8_experts_match_jax(b, s):
    """Quantized experts ({"q", "s"} with the JAX package's codes and
    scales): int8 × int8 → int32 with per-slot scales, against the JAX
    package's jitted int8 ``moe_ffn``; the capacity is 8 at (1, 8)."""
    x, mask, rw, wi, bi, wo, bo = _ffn_inputs(seed=3, b=b, s=s, h=16, i=32)
    qi, qo = (jax_quant_leaf(jnp.asarray(w)) for w in (wi, wo))
    ti, to = _quant_leaf(torch.from_numpy(wi)), _quant_leaf(torch.from_numpy(wo))
    for jq, tq in ((qi, ti), (qo, to)):
        np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
        np.testing.assert_array_equal(tq["s"].numpy(), np.asarray(jq["s"]))
    assert TM.expert_capacity(b * s, 4, 2, 1.25) == (8 if b == 1 else 40)
    want = jax.jit(lambda *a: JM.moe_ffn(*a, top_k=2))(*_j(x, mask, rw), qi, jnp.asarray(bi),
                                                       qo, jnp.asarray(bo))
    got = TM.moe_ffn(*_t(x, mask, rw), ti, torch.from_numpy(bi), to, torch.from_numpy(bo),
                     top_k=2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6)


def _moe_arch(cf=1.0, **kw):
    jarch = JAX_PRESETS["tiny-test"].replace(num_experts=4, expert_top_k=2,
                                             expert_capacity_factor=cf, **kw)
    return jarch, EncoderArch.from_json(jarch.to_json())


ALBERT = dict(share_layers=True, embed_factor_size=32, num_layers=3)


@pytest.mark.parametrize("albert", [False, True])
def test_encoder_forward_matches_jax(albert):
    jarch, arch = _moe_arch(cf=0.25, **(ALBERT if albert else {}))
    jp = jax_init(jax.random.PRNGKey(0), jarch)
    rng = np.random.default_rng(1)
    mask = (np.arange(24)[None] < np.asarray([24, 17, 9])[:, None]).astype(np.int32)
    ids = (rng.integers(5, 1000, (3, 24)) * mask).astype(np.int32)
    want = jax.jit(jax_forward, static_argnames=("arch", "precision"))(
        jp, *_j(ids, mask), arch=jarch, precision=JAX_FP32)
    got = encoder_forward(params_from_jax(jax.device_get(jp), arch), *_t(ids, mask), arch=arch,
                          precision=FP32_PRECISION)
    np.testing.assert_allclose(got.last_hidden_state.numpy(), np.asarray(want.last_hidden_state),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(got.moe_aux), float(want.moe_aux), atol=1e-6)
    np.testing.assert_allclose(float(got.moe_drop), float(want.moe_drop), atol=1e-6)
    assert float(got.moe_drop) > 0


SENTS = [" ".join(np.random.default_rng(i).choice(WORDS, 3 + i % 11)) for i in range(30)]


def test_jax_saved_moe_encoder_loads_encodes_quantizes_and_saves(tmp_path):
    """A JAX-saved MoE encoder: the port's bucketed and packed ("auto")
    encodes equal the JAX package's (the reference's batch shapes, so the
    same capacity); ``to_int8`` quantizes the experts and keeps the router
    f32, within 0.1 of the f32 embeddings; the port's save loads in both."""
    vocab = train_wordpiece_vocab(SENTS, vocab_size=300, min_freq=1)
    jarch = _moe_arch(vocab_size=len(vocab))[0]
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(3), jarch), jarch,
                              tokenizer=JaxTokenizer(vocab), precision=JAX_FP32)
    jenc.save(str(tmp_path / "jax"))
    enc = SentenceEncoder.load(str(tmp_path / "jax"), bf16=False, device="cpu")
    assert enc.params["layers"]["mlp"]["in"]["w"].shape == (2, 4, 64, 128)
    for packed in (False, "auto"):
        want = np.asarray(jenc.encode(SENTS, batch_size=8, packed=packed))
        np.testing.assert_allclose(enc.encode(SENTS, batch_size=8, packed=packed), want,
                                   atol=1e-5, err_msg=str(packed))
    assert enc.use_packed(enc._tokenize_rows(SENTS, 256), 8, (8, 16, 32))

    f32 = enc.encode(SENTS, packed=False)
    enc.save(str(tmp_path / "port"))
    enc.to_int8()
    mlp = enc.params["layers"]["mlp"]
    assert mlp["in"]["w"]["q"].dtype == torch.int8 and mlp["in"]["w"]["s"].shape == (2, 4, 1, 128)
    assert isinstance(mlp["router"]["w"], torch.Tensor) and mlp["router"]["w"].is_floating_point()
    assert np.abs(enc.encode(SENTS, packed=False) - f32).max() < 0.1
    back = JaxSentenceEncoder.load(str(tmp_path / "port"), bf16=False)
    assert back.arch.num_experts == 4 and back.arch.expert_capacity_factor == 1.0
    np.testing.assert_allclose(np.asarray(back.encode(SENTS, packed=False)), f32, atol=1e-5)


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(train_wordpiece_vocab([" ".join(WORDS)] * 3, 256, min_freq=1))


MOE_KEYS = ["loss", "moe_aux", "moe_drop"]


def _jax_tree(jarch, head=None, mlm=False):
    jp = {"encoder": jax_init(jax.random.PRNGKey(0), jarch)}
    rng = np.random.default_rng(1)
    if head:
        jp["head"] = {"w": jnp.asarray(rng.standard_normal(head) * 0.02, jnp.float32),
                      "b": jnp.asarray(rng.standard_normal(head[1]) * 0.02, jnp.float32)}
    if mlm:
        jp["mlm_bias"] = jnp.asarray(rng.standard_normal(jarch.vocab_size) * 0.1, jnp.float32)
    return jp


def test_bi_encoder_step_matches_jax(tok):
    jarch, arch = _moe_arch(vocab_size=tok.vocab_size, **NO_DROP)
    pairs, t = _pairs(16, 0)
    batches = build_pair_batches(tok, pairs, t, batch_size=8, max_len=32, buckets=(32,))
    _step_parity(
        lambda tx: JS.make_bi_encoder_train_step(jarch, tx, precision=JAX_FP32),
        lambda tx: TS.make_bi_encoder_train_step(arch, tx, precision=FP32_PRECISION,
                                                 device="cpu"),
        _jax_tree(jarch), arch, batches[:2], MOE_KEYS)


def test_classifier_step_matches_jax(tok):
    jarch, arch = _moe_arch(vocab_size=tok.vocab_size, **NO_DROP)
    pairs, t = _pairs(16, 1)
    batches = build_pair_batches(tok, pairs, (t * 3).astype(np.int32), batch_size=8,
                                 max_len=32, mode="cross", buckets=(32,), target_dtype=np.int32)
    _step_parity(
        lambda tx: JS.make_classifier_train_step(jarch, tx, precision=JAX_FP32),
        lambda tx: TS.make_classifier_train_step(arch, tx, precision=FP32_PRECISION,
                                                 device="cpu"),
        _jax_tree(jarch, head=(64, 3)), arch, batches[:2], MOE_KEYS + ["accuracy"])


def test_mlm_step_matches_jax(monkeypatch):
    """Two MLM steps with one fixed corruption in place of both packages'
    dynamic masking."""
    jarch, arch = _moe_arch(**NO_DROP)
    ids, mask, corrupted, labels = _mlm_batch(arch)
    monkeypatch.setattr(JS, "mlm_mask_batch",
                        lambda *a, **k: (jnp.asarray(corrupted), jnp.asarray(labels)))
    monkeypatch.setattr(TS, "mlm_mask_batch", lambda *a, **k: (
        torch.from_numpy(corrupted), torch.from_numpy(labels)))
    batch = {"ids": ids, "mask": mask}
    _step_parity(
        lambda tx: JS.make_mlm_train_step(jarch, tx, mask_token_id=4, precision=JAX_FP32),
        lambda tx: TS.make_mlm_train_step(arch, tx, mask_token_id=4, precision=FP32_PRECISION,
                                          device="cpu"),
        _jax_tree(jarch, mlm=True), arch, [batch, batch], MOE_KEYS + ["masked_tokens"])


def test_fastformers_and_theseus_still_refuse_moe():
    from text_similarity_tpu_torch.compress.theseus import theseus_encoder_forward
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.train import make_optimizer

    arch = _moe_arch()[1]
    with pytest.raises(ValueError, match="MoE"):
        TS.make_fastformers_distill_step(arch, arch, make_optimizer(TrainConfig(), 1),
                                         device="cpu")
    ids = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="MoE"):
        theseus_encoder_forward({}, {}, {}, ids, None, arch=arch, replace_rate=0.5,
                                generator=torch.Generator())


def test_train_sts_with_experts_through_the_cli(tmp_path, capsys):
    """``--experts 2 --expert-top-k 1`` trains an MoE bi-encoder; the
    saved arch round-trips the MoE fields and the directory loads in both
    packages to the same embeddings."""
    sts = tmp_path / "sts.tsv"
    sts.write_text("\n".join(f"{a}\t{b}\t3.0" for a, b in zip(SENTS[:12], SENTS[1:13])))
    main(["train-sts", "--data", str(sts), "--no-eval", "--experts", "2", "--expert-top-k", "1",
          "--arch", "tiny-test", "--vocab-size", "256", "--fp32", "--batch-size", "4",
          "--max-len", "32", "--save-path", str(tmp_path / "run"), "--device", "cpu"])
    assert np.isfinite(json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                       ["best_metric"])
    arch = json.loads((tmp_path / "run" / "arch.json").read_text())
    assert arch["num_experts"] == 2 and arch["expert_top_k"] == 1
    enc = SentenceEncoder.load(str(tmp_path / "run"), bf16=False, device="cpu")
    assert enc.params["layers"]["mlp"]["in"]["w"].shape[1] == 2
    emb = enc.encode(SENTS[:4])
    assert np.isfinite(emb).all()
    jenc = JaxSentenceEncoder.load(str(tmp_path / "run"), bf16=False)
    np.testing.assert_allclose(np.asarray(jenc.encode(SENTS[:4])), emb, atol=1e-5)


def tiny_drive(monkeypatch):
    """The router-skew drive cut to the tiny-test geometry and small shapes."""
    for name, value in (("ARCH", "tiny-test"), ("TRAIN_SHAPE", (4, 32)), ("EVAL_SHAPE", (8, 32)),
                        ("EVAL_BATCHES", 1), ("SWEEP_SHAPE", (8, 32)), ("SWEEP_BATCHES", 1)):
        monkeypatch.setattr(moe_router_skew, name, value)


def test_router_skew_drive_at_a_tiny_size(tmp_path, capsys, monkeypatch):
    """--train (3 MLM steps, tiny-test geometry with 8 experts) saves a
    checkpoint and prints both tables; --sweep loads it and times every
    (top_k, cf)."""
    tiny_drive(monkeypatch)
    common = ["--ckpt", str(tmp_path), "--device", "cpu"]
    row = moe_router_skew.main(["--train", "--steps", "3"] + common)
    sweep = moe_router_skew.main(["--sweep"] + common)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["mode"] for x in lines] == ["train", "sweep"] and lines == [row, sweep]
    pairs = [(r["top_k"], r["cf"]) for r in row["trained"]]
    assert pairs == moe_router_skew.SWEEP
    for r in row["trained"] + row["random"] + sweep["trained"] + sweep["random"]:
        assert 0 <= r["moe_drop"] <= 1 and np.isfinite(r["moe_aux"])
    for r in sweep["trained"]:
        assert len(r["sent_per_s_windows"]) == 3 and r["sent_per_s"] > 0
    assert np.isfinite(row["final_loss"])
