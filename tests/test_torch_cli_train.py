"""The port's training and evaluation commands through ``main([...,
"--device", "cpu"])`` on tiny synthetic files: each prints the JAX CLI's
JSON keys and saves artifacts the JAX package loads (the same embeddings,
scores and logits); the cross-encoder feeds ``RankingPipeline``;
``pretrain-long`` on a RoBERTa-offset model with a full row, where the JAX
package's states are NaN; the options not ported yet exit naming their
ROADMAP item."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core import checkpoint as jax_ckpt
from text_similarity_tpu.core.config import EncoderArch as JaxArch
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.evaluation.evaluators import ParaphraseEvaluator as JaxParaphrase
from text_similarity_tpu.evaluation.evaluators import RetrievalEvaluator as JaxRetrieval
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
from text_similarity_tpu.models.hf_convert import extend_positions as jax_extend_positions
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.train.steps import classifier_forward as jax_classifier_forward
from text_similarity_tpu_torch.cli.main import main
from text_similarity_tpu_torch.core.config import ARCH_PRESETS
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, init_params
from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
from text_similarity_tpu_torch.pipelines import RankingPipeline, SemanticSearchPipeline
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SENTS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast dark fox leaped over a sleepy dog",
    "machine learning on tensor processing units",
    "semantic similarity of sentences",
    "the dog sleeps while the fox runs",
    "investors worried about interest rates",
    "the cat sat on the mat",
    "a kitten rested on a rug",
]

# the JAX CLI's output keys (text_similarity_tpu/cli/main.py)
SIMILARITY_KEYS = {f"{c}_{s}" for c in ("pearson", "spearman")
                   for s in ("cosine", "euclidean", "manhattan", "dot")} | {"spearman_max"}
BINARY_KEYS = {"accuracy", "threshold", "f1", "precision", "recall", "average_precision"}
RETRIEVAL_KEYS = {"acc_src2tgt", "acc_tgt2src", "acc_mean"}


def _args(tmp_path, extra, save="run"):
    return extra + [
        "--arch", "tiny-test", "--vocab-size", "512", "--fp32",
        "--save-path", str(tmp_path / save), "--batch-size", "4", "--epochs", "1",
        "--max-len", "32", "--device", "cpu",
    ]


def _json_out(capsys):
    """The last JSON object printed (one line, or an indented block)."""
    lines = capsys.readouterr().out.strip().splitlines()
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    return json.loads("\n".join(lines[start:]))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    out = {}
    (d / "sts.tsv").write_text("\n".join(
        f"{SENTS[i % 8]}\t{SENTS[(i + 1) % 8]}\t{rng.uniform(0, 5):.2f}" for i in range(16)))
    (d / "nli.tsv").write_text("\n".join(
        f"{SENTS[i % 8]}\t{SENTS[(i + 3) % 8]}\t{lab}"
        for i, lab in enumerate(["entailment", "neutral", "contradiction"] * 4)))
    (d / "paws.tsv").write_text("id\ts1\ts2\tlabel\n" + "\n".join(
        f"{i}\t{SENTS[i % 8]}\t{SENTS[(i + 1) % 8]}\t{i % 2}" for i in range(16)))
    (d / "quora.tsv").write_text("\n".join(
        f"{i}\t{i + 1}\t{i + 2}\t{SENTS[i % 8]}\t{SENTS[(i + 2) % 8]}\t{i % 2}"
        for i in range(12)))
    (d / "docs.jsonl").write_text("\n".join(
        json.dumps({"text": s, "label": ["a", "b"][i % 2]}) for i, s in enumerate(SENTS * 2)))
    (d / "ner.txt").write_text("\n\n".join(
        "\n".join(f"{w} {'B-X' if j == 0 else 'O'}" for j, w in enumerate(s.split()))
        for s in SENTS))
    (d / "par.tsv").write_text("\n".join(f"{s}\t{SENTS[(i + 4) % 8]} {s}"
                                         for i, s in enumerate(SENTS)))
    (d / "long.txt").write_text("\n".join((s + " ") * 6 for s in SENTS * 2))
    for p in d.iterdir():
        out[p.stem if p.suffix != ".jsonl" else "docs"] = str(p)
    return out


@pytest.fixture(scope="module")
def sts_model(tmp_path_factory, files):
    """A port-trained tiny encoder (train-sts, bucketed, with its eval)."""
    path = tmp_path_factory.mktemp("sts")
    main(_args(path, ["train-sts", "--data", files["sts"]]))
    return str(path / "run")


def _encoders_agree(path, texts):
    """The saved directory encodes alike in both packages (f32, 1e-4)."""
    port = SentenceEncoder.load(path, bf16=False, device="cpu")
    ref = JaxSentenceEncoder.load(path, bf16=False)
    np.testing.assert_allclose(port.encode(texts), np.asarray(ref.encode(texts)), atol=1e-4)
    return port, ref


def test_train_sts_prints_best_metric_and_saves(sts_model, tmp_path, files, capsys):
    _encoders_agree(sts_model, SENTS)
    results = [json.loads(line) for line in open(f"{sts_model}/results.jsonl")]
    assert "spearman_cosine" in results[0]["eval"]
    main(_args(tmp_path, ["train-sts", "--data", files["sts"], "--packed", "--packed-rows", "2",
                          "--no-eval"]))
    assert set(_json_out(capsys)) == {"best_metric"}
    _encoders_agree(str(tmp_path / "run"), SENTS[:4])


@pytest.mark.parametrize("cmd", [
    ["train-nli", "--data", "@nli"],
    ["train-paws", "--data", "@paws", "--loss", "mnrl"],
    ["train-paws", "--data", "@quora", "--format", "quora", "--packed", "--packed-rows", "2"],
])
def test_bi_encoder_commands(tmp_path, files, capsys, cmd):
    cmd = [files[c[1:]] if c.startswith("@") else c for c in cmd]
    main(_args(tmp_path, cmd))
    res = _json_out(capsys)
    assert set(res) == {"best_metric"} and np.isfinite(res["best_metric"])
    assert (tmp_path / "run" / "LATEST").exists()
    _encoders_agree(str(tmp_path / "run"), SENTS[:4])


@pytest.mark.parametrize("cmd,mode", [
    ("eval-sts", "regression"), ("eval-paws", "binary"), ("eval-tatoeba", "retrieval"),
])
def test_eval_commands_match_the_jax_evaluators(sts_model, files, capsys, cmd, mode):
    data = {"eval-sts": "sts", "eval-paws": "paws", "eval-tatoeba": "par"}[cmd]
    main([cmd, "--model", sts_model, "--data", files[data], "--fp32", "--device", "cpu"])
    got = _json_out(capsys)
    ref = JaxSentenceEncoder.load(sts_model, bf16=False)
    if mode == "retrieval":
        assert set(got) == RETRIEVAL_KEYS
        pairs = [line.split("\t") for line in open(files["par"]).read().splitlines()]
        want = JaxRetrieval(ref).evaluate([a for a, _ in pairs], [b for _, b in pairs])
    else:
        assert set(got) == (SIMILARITY_KEYS if mode == "regression" else BINARY_KEYS)
        from text_similarity_tpu.data.datasets import load_paws, load_sts

        rows = load_sts(files["sts"]) if mode == "regression" else load_paws(files["paws"])
        want = JaxParaphrase(ref, mode=mode).evaluate(*zip(*rows))
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-4), k


def test_train_classification_then_eval(tmp_path, files, capsys):
    main(_args(tmp_path, ["train-classification", "--data", files["docs"]]))
    res = _json_out(capsys)
    assert set(res) == {"labels", "best"} and res["labels"] == ["a", "b"]
    main(["eval-classification", "--model", str(tmp_path / "run"), "--data", files["docs"],
          "--fp32", "--batch-size", "4", "--max-len", "32", "--device", "cpu"])
    ev = _json_out(capsys)
    assert set(ev) == {"accuracy", "per_class", "n"} and ev["n"] == 16
    assert 0.0 <= ev["accuracy"] <= 1.0 and set(ev["per_class"]) <= {"a", "b"}
    # the JAX package reads the saved classifier: the same logits
    path = str(tmp_path / "run")
    tree, _, _ = jax_ckpt.restore_checkpoint_raw(jax_ckpt.latest_checkpoint(path))
    arch = JaxArch.from_json(open(f"{path}/arch.json").read())
    from text_similarity_tpu_torch.data.tokenization import load_tokenizer
    from text_similarity_tpu_torch.models.encoder import cross_params_from_jax
    from text_similarity_tpu_torch.train import classifier_forward

    ids, mask = load_tokenizer(path).encode_batch(SENTS, max_len=32)
    want = jax_classifier_forward(tree, jnp.asarray(ids), jnp.asarray(mask), None, arch=arch,
                                  precision=JAX_FP32)
    got = classifier_forward(
        cross_params_from_jax(tree, ARCH_PRESETS["tiny-test"].replace(
            vocab_size=arch.vocab_size), 2), torch.from_numpy(ids), torch.from_numpy(mask),
        arch=ARCH_PRESETS["tiny-test"].replace(vocab_size=arch.vocab_size),
        precision=FP32_PRECISION)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
def test_train_cross_encoder_feeds_the_rerank(tmp_path, files, capsys, packed):
    extra = ["--packed", "--packed-rows", "2"] if packed else []
    main(_args(tmp_path, ["train-cross-encoder", "--data", files["paws"]] + extra))
    res = _json_out(capsys)
    assert set(res) == {"num_classes", "best"} and res["num_classes"] == 2
    path = str(tmp_path / "run")
    ce = CrossEncoder.load(path, bf16=False, device="cpu")
    pairs = [(SENTS[0], SENTS[1]), (SENTS[2], SENTS[3]), (SENTS[4], SENTS[6])]
    scores = ce.predict(pairs, packed=False)
    np.testing.assert_allclose(np.asarray(JaxCrossEncoder.load(path, bf16=False).predict(
        pairs, packed=False)), scores, atol=1e-4)
    tok = WordPieceTokenizer(train_wordpiece_vocab(SENTS, vocab_size=300, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    enc = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                          tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    pipe = SemanticSearchPipeline(enc, corpus=SENTS, device="cpu")
    ranked = RankingPipeline(pipe, ce, retrieve_k=4)([SENTS[0]], top_k=3)[0]
    assert len(ranked) == 3
    want = ce.predict([(SENTS[0], doc) for doc, _, _ in ranked], packed=False)
    np.testing.assert_allclose([s for _, s, _ in ranked], want, atol=1e-5)


def test_train_ner(tmp_path, files, capsys):
    main(_args(tmp_path, ["train-ner", "--data", files["ner"]]))
    res = _json_out(capsys)
    assert set(res) == {"tags", "best"} and res["tags"] == ["B-X", "O"]
    assert np.isfinite(res["best"])


def test_pretrain_long(tmp_path, files, capsys):
    main(_args(tmp_path, [
        "pretrain-long", "--data", files["long"], "--target-len", "64", "--window", "8",
        "--mask-prob", "0.3", "--lr", "3e-4", "--warmup-ratio", "0.0",
    ]) + ["--epochs", "3"])
    res = _json_out(capsys)
    assert set(res) == {"target_len", "window", "mlm_loss_first", "mlm_loss_last", "saved"}
    assert res["mlm_loss_last"] < res["mlm_loss_first"]
    port, ref = _encoders_agree(str(tmp_path / "run"), SENTS[:4])
    assert port.arch.max_position >= 64 and port.arch.attention_window == 8
    assert ref.arch.attention_window == 8


def test_pretrain_long_full_roberta_row_stays_finite(tmp_path, capsys):
    """RoBERTa positions (offset 2, pad 1) on tiny-test: a 64-token row
    reads position 65. The reference tiles the table to exactly
    --target-len and its states go NaN on that row; the port sizes the
    table at target_len + 2 and its MLM loss stays finite."""
    texts = [" ".join([s] * 12) for s in SENTS]          # every row fills 64 tokens
    tok = WordPieceTokenizer(train_wordpiece_vocab(SENTS, vocab_size=300, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size, position_offset=2,
                                             pad_token_id=1, max_position=34)
    model = tmp_path / "model"
    SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch, tokenizer=tok,
                    precision=FP32_PRECISION, device="cpu").save(str(model))
    (tmp_path / "docs.txt").write_text("\n".join(texts))
    ids, mask = tok.encode_batch(texts[:2], max_len=64)
    assert mask.sum(1).min() == 64

    # the fault: the JAX package extended to exactly 64 positions
    jenc = JaxSentenceEncoder.load(str(model), bf16=False)
    jp, jarch = jax_extend_positions(jenc.params, jenc.arch, 64)
    states = jax_forward(jp, jnp.asarray(ids), jnp.asarray(mask), arch=jarch,
                         precision=JAX_FP32).last_hidden_state
    assert np.isnan(np.asarray(states)).any()

    main(["pretrain-long", "--model", str(model), "--data", str(tmp_path / "docs.txt"),
          "--target-len", "64", "--window", "0", "--fp32", "--batch-size", "2",
          "--save-path", str(tmp_path / "run"), "--device", "cpu"])
    res = _json_out(capsys)
    assert np.isfinite(res["mlm_loss_first"]) and np.isfinite(res["mlm_loss_last"])
    saved = SentenceEncoder.load(str(tmp_path / "run"), bf16=False, device="cpu")
    assert saved.arch.max_position == 66
    assert np.isfinite(saved.encode(texts[:2], max_len=64)).all()


@pytest.mark.parametrize("argv,item", [
    (["train-wic", "--data", "x", "--pipe", "N"], "cards"),
    (["distill", "--pipe", "N"], "distill does not train pipeline-parallel"),
    (["theseus", "--data", "x", "--pipe", "N"], "theseus does not train pipeline-parallel"),
    (["train-paws", "--data", "x", "--pipe", "N"], "cards"),
    (["train-sts", "--data", "STS", "--pipe", "N"], "cards"),
    (["train-nli", "--data", "STS", "--pipe", "N"], "cards"),
])
def test_commands_not_ported_yet_exit_naming_their_item(tmp_path, files, argv, item):
    """Every command is ported now: ``--pipe N`` with more stages than cards
    exits naming the count before any work, and a command that does not
    train pipeline-parallel refuses the flag (the reference ignores it)."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(visible + 1, 2)
    argv = [files["sts"] if a == "STS" else str(n) if a == "N" else a for a in argv]
    want = f"--pipe {n} needs {n} cards; {visible} visible" if item == "cards" else item
    with pytest.raises(SystemExit, match=want):
        main(argv + ["--device", "cuda"])
