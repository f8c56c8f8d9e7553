"""The port's word models against the JAX package on the tiny-test arch
(f32, dropout 0) with JAX-initialised weights and the same numpy inputs:
``word_span_pool``, ``token_spans`` (WordPiece and the ``tokenizer.json``
adapter), ``build_word_batches``, ``contextual_word_embedding``,
``match_sense``, ``WordEncoder`` (scores, WiC accuracy, graded
similarity, with and without a sense bank), one word-step's loss and
gradients, the sense-bank helpers, and ``train-wic`` through the CLI."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import text_similarity_tpu.train.steps as JS
import text_similarity_tpu.utils.senses as JSen
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.pairs import build_word_batches as jax_build_word_batches
from text_similarity_tpu.data.tokenization import HFTokenizerAdapter as JaxHFAdapter
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxWordPiece
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.pooling import word_span_pool as jax_word_span_pool
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.models.word_encoder import WordEncoder as JaxWordEncoder
from text_similarity_tpu.models.word_encoder import contextual_word_embedding as jax_cwe
from text_similarity_tpu.models.word_encoder import match_sense as jax_match_sense
from text_similarity_tpu.train import init_train_state as jax_init_train_state
import text_similarity_tpu_torch.train.steps as TS
import text_similarity_tpu_torch.utils.senses as TSen
from text_similarity_tpu_torch.cli.main import main
from text_similarity_tpu_torch.core.config import ARCH_PRESETS
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.pairs import build_word_batches
from text_similarity_tpu_torch.data.tokenization import (
    WordPieceTokenizer, load_tokenizer, train_wordpiece_vocab,
)
from text_similarity_tpu_torch.models import SentenceEncoder, params_from_jax, word_span_pool
from text_similarity_tpu_torch.models.word_encoder import (
    WordEncoder, contextual_word_embedding, match_sense,
)
from text_similarity_tpu_torch.train import init_train_state
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORDS = ["bank", "river", "money", "deposit", "the", "sat", "on", "by", "we", "loan",
         "water", "fish", "bright", "light", "heavy", "lamp", "unbelievable", "shore"]
ATOL = 2e-5
NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)


def _wic_rows(n, seed):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        s1 = list(rng.choice(WORDS, rng.randint(3, 9)))
        s2 = list(rng.choice(WORDS, rng.randint(3, 9)))
        i1, i2 = rng.randint(len(s1)), rng.randint(len(s2))
        s2[i2] = s1[i1]
        if i % 3 == 0:              # attached punctuation, as in real WiC rows
            s1[i1] += ","
        rows.append({"word": s1[i1].strip(","), "pos": "N", "idx1": int(i1), "idx2": int(i2),
                     "sent1": " ".join(s1), "sent2": " ".join(s2), "label": i % 2})
    return rows


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tok = WordPieceTokenizer(train_wordpiece_vocab([" ".join(WORDS)] * 2 + ["unbeliev"], 96,
                                                   min_freq=1))
    kw = dict(NO_DROP, vocab_size=tok.vocab_size)
    jarch, arch = JAX_PRESETS["tiny-test"].replace(**kw), ARCH_PRESETS["tiny-test"].replace(**kw)
    jp = jax_init(jax.random.PRNGKey(0), jarch)
    tp = params_from_jax(jax.tree.map(np.array, jax.device_get(jp)), arch)
    rows = _wic_rows(24, 0)
    batches = build_word_batches(tok, rows, batch_size=8, max_len=32, seed=1)
    return dict(tok=tok, jarch=jarch, arch=arch, jp=jp, tp=tp, rows=rows, batches=batches,
                tmp=tmp_path_factory.mktemp("word"))


def test_word_span_pool_equals_jax():
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((3, 10, 8)).astype(np.float32)
    span = np.array([[1, 2, -1], [-1, -1, -1], [9, 0, 4]], np.int32)
    got = word_span_pool(torch.from_numpy(hidden), torch.from_numpy(span))
    want = jax_word_span_pool(jnp.asarray(hidden), jnp.asarray(span))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert float(got[1].abs().max()) == 0.0       # an empty span pools to zeros


def test_token_spans_equal_jax(setup):
    """Positions of each word's pieces (WordPiece) and each word's piece
    ids (the tokenizer.json adapter, as the JAX package's gives them)."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

    tok = setup["tok"]
    texts = ["The river bank, unbelievable!", "we sat by the lamp-light", "Deposit money"]
    jtok = JaxWordPiece(tok.vocab)
    for t in texts:
        assert tok.token_spans(t) == jtok.token_spans(t)
    hf = Tokenizer(models.WordPiece(tok.vocab, unk_token="[UNK]"))
    hf.normalizer = normalizers.BertNormalizer(lowercase=True)
    hf.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    path = str(setup["tmp"] / "hf")
    os.makedirs(path, exist_ok=True)
    hf.save(os.path.join(path, "tokenizer.json"))
    adapter = load_tokenizer(path)
    jadapter = JaxHFAdapter.from_file(os.path.join(path, "tokenizer.json"))
    assert adapter.lowercase is False
    for t in texts:
        assert adapter.token_spans(t) == jadapter.token_spans(t)
        assert adapter._wordpiece("unbelievable") == jadapter._wordpiece("unbelievable")


def test_build_word_batches_equal_jax(setup):
    tok, rows = setup["tok"], setup["rows"]
    for kw in ({"max_len": 32, "seed": 1}, {"max_len": 8, "max_span": 2, "shuffle": False}):
        got = build_word_batches(tok, rows, batch_size=8, **kw)
        want = jax_build_word_batches(tok, rows, batch_size=8, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert (got[0]["span_a"] >= 0).any()


@pytest.mark.parametrize("last_k", [2, 4])
def test_contextual_word_embedding_equals_jax(setup, last_k):
    """The last k of the L + 1 hidden states (k 4 > L + 1 = 3 takes all)."""
    b = setup["batches"][0]
    want = jax_cwe(setup["jp"], jnp.asarray(b["ids_a"]), jnp.asarray(b["mask_a"]),
                   jnp.asarray(b["span_a"]), arch=setup["jarch"], precision=JAX_FP32,
                   last_k_layers=last_k)
    got = contextual_word_embedding(setup["tp"], torch.from_numpy(b["ids_a"]),
                                    torch.from_numpy(b["mask_a"]), torch.from_numpy(b["span_a"]),
                                    arch=setup["arch"], precision=FP32_PRECISION,
                                    last_k_layers=last_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL * last_k)


def test_match_sense_equals_jax():
    rng = np.random.default_rng(1)
    vecs, bank = rng.standard_normal((6, 8)), rng.standard_normal((10, 8)) * 3
    got = match_sense(torch.tensor(vecs, dtype=torch.float32), torch.tensor(bank,
                                                                          dtype=torch.float32))
    want = jax_match_sense(jnp.asarray(vecs, jnp.float32), jnp.asarray(bank, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("senses", [False, True])
def test_word_encoder_scores_and_wic_accuracy_equal_jax(setup, senses):
    bank = np.random.default_rng(2).standard_normal((12, 64)).astype(np.float32) if senses else None
    jw = JaxWordEncoder(setup["jp"], setup["jarch"], sense_bank=None if bank is None
                        else jnp.asarray(bank), precision=JAX_FP32)
    tw = WordEncoder(setup["tp"], setup["arch"], sense_bank=bank, precision=FP32_PRECISION,
                     device="cpu")
    for b in setup["batches"]:
        np.testing.assert_allclose(tw.score_tokens(b), jw.score_tokens(b), atol=1e-5)
    got, want = tw.evaluate_wic(setup["batches"]), jw.evaluate_wic(setup["batches"])
    assert got.keys() == want.keys()
    assert got["accuracy"] == pytest.approx(want["accuracy"])
    np.testing.assert_allclose(tw.graded_similarity(setup["batches"]),
                               jw.graded_similarity(setup["batches"]), atol=1e-5)
    gold = np.linspace(0.0, 1.0, len(setup["rows"]))
    g, w = tw.evaluate_gwsc(setup["batches"], gold), jw.evaluate_gwsc(setup["batches"], gold)
    assert g["spearman"] == pytest.approx(w["spearman"], abs=1e-6)


class _RecordGrads:
    def init(self, params):
        return {}

    def step(self, params, grads, opt_state):
        self.grads = grads


def test_word_step_loss_and_gradients_equal_jax(setup):
    """The default contrastive objective (the losses themselves are held
    to the JAX package's in test_torch_train)."""
    loss_type = "contrastive"
    jtx = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                       lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jstate = jax_init_train_state({"encoder": jax.tree.map(jnp.array, setup["jp"])}, jtx)
    jstep = JS.make_word_encoder_train_step(setup["jarch"], jtx, precision=JAX_FP32,
                                            loss_type=loss_type)
    b = setup["batches"][0]
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
    ttx = _RecordGrads()
    tstate = init_train_state({"encoder": setup["tp"]}, ttx, device="cpu")
    step = TS.make_word_encoder_train_step(setup["arch"], ttx, precision=FP32_PRECISION,
                                           loss_type=loss_type, device="cpu")
    _, tm = step(tstate, b)
    assert set(tm) == set(jm) == {"loss"}
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = jax.tree.map(np.asarray, jstate.opt_state)["encoder"]

    def flat(tree, p=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{p}/{k}") if isinstance(v, dict) else {f"{p}/{k}": v})
        return out

    want, got = flat(want), flat(ttx.grads["encoder"])
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-7, err_msg=k)


def test_sense_bank_helpers_equal_jax(setup):
    rng = np.random.default_rng(3)
    keys = ["bank%1:14:00::", "bank%1:17:01::", "river%1:17:00::", "light%1:19:00::"]
    vecs = rng.standard_normal((4, 6)).astype(np.float32)
    path = str(setup["tmp"] / "senses.txt")
    with open(path, "w") as f:
        f.write("4 6\n" + "".join(k + " " + " ".join(f"{v:.6f}" for v in row) + "\n"
                                  for k, row in zip(keys, vecs)))
    bank, jbank = TSen.load_sense_embeddings(path), JSen.load_sense_embeddings(path)
    assert list(bank) == list(jbank) == keys
    for a, b in ((TSen.reduce_dim(bank, 3), JSen.reduce_dim(jbank, 3)), (bank, jbank)):
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    mat, ks = TSen.build_sense_bank(bank, restrict_lemmas=["bank"])
    jmat, jks = JSen.build_sense_bank(jbank, restrict_lemmas=["bank"])
    assert ks == jks == keys[:2]
    np.testing.assert_array_equal(mat, jmat)
    TSen.save_sense_bank(str(setup["tmp"] / "bank"), bank)
    assert list(JSen.load_sense_bank_npz(str(setup["tmp"] / "bank"))) == keys


def test_train_wic_command(setup, tmp_path, capsys):
    """``train-wic`` on the CPU prints the JAX CLI's keys; the saved encoder
    loads in the JAX package and encodes as in the port."""
    rows = _wic_rows(16, 4)
    (tmp_path / "wic.tsv").write_text("".join(
        f"{r['word']}\t{r['pos']}\t{r['idx1']}-{r['idx2']}\t{r['sent1']}\t{r['sent2']}\n"
        for r in rows))
    (tmp_path / "gold.txt").write_text("".join("T\n" if r["label"] else "F\n" for r in rows))
    main(["train-wic", "--data", str(tmp_path / "wic.tsv"), "--gold", str(tmp_path / "gold.txt"),
          "--arch", "tiny-test", "--vocab-size", "128", "--fp32", "--batch-size", "8",
          "--max-len", "32", "--save-path", str(tmp_path / "run"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"wic", "best"} and 0.0 <= out["wic"]["accuracy"] <= 1.0
    assert np.isfinite(out["best"])
    port = SentenceEncoder.load(str(tmp_path / "run"), bf16=False, device="cpu")
    jax_side = JaxSentenceEncoder.load(str(tmp_path / "run"), bf16=False)
    texts = [r["sent1"] for r in rows[:4]]
    np.testing.assert_allclose(port.encode(texts), np.asarray(jax_side.encode(texts)), atol=1e-5)
