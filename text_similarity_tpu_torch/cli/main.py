"""The port's CLI: ``python -m text_similarity_tpu_torch <command>``.

Port of ``text_similarity_tpu.cli.main``, with the reference's flags plus
``--device`` (``cuda`` by default; it raises without a card):

  train-sts            bi-encoder, cosine MSE on STS scores (evaluates
                       Spearman each epoch unless ``--no-eval``)
  train-nli            bi-encoder, softmax loss over 3 NLI classes
  train-paws           bi-encoder on PAWS / Quora pairs (``--loss``)
  train-classification document classifier (CLS head)
  train-cross-encoder  pair classifier (``--packed`` or bucketed); saves a
                       ``CrossEncoder`` directory
  train-wic            word-in-context twin towers over the target words'
                       spans; prints the best-threshold WiC accuracy
  train-ner            token classifier on CoNLL files
  distill              layer-drop student trained to a teacher's embeddings
                       (``--parallel-data``: the multilingual mode)
  theseus              compress an encoder to ``--slots`` layers by
                       successor replacement on labelled pairs
  prune                head and FFN importance pruning of a classifier
  eval-classification  accuracy and per-class accuracy of a classifier
  pretrain-long        tile the positions to ``--target-len``, set the
                       attention window, then masked-LM steps
  eval-sts / eval-paws / eval-tatoeba
                       evaluate a saved encoder
  quantize             write a saved encoder's int8 deployment checkpoint
  export               ``torch.export`` bundles of the encode step, one a
                       (batch, seq) shape, with int8 params
  encode               embed a text file → (N, D) f32 ``.npy`` (``--packed``)
  search               top-k search over a text file (``--query``, else an
                       interactive loop until an empty line or EOF)
  mine                 paraphrase pairs inside a text file (``--ivf``)
  compare-models       teacher / student top-k overlap over a text file
  cluster / topics     k-means clusters; topics (k-means or density, PCA or
                       spectral reduction, c-TF-IDF words, ``--lexicon``
                       names)
  serve                the search daemon (``pipelines.serve``)

``--packed`` (bi-encoder and cross-encoder training) packs several short
rows a ``--max-len``-token row, ``--packed-rows`` rows a side and step.
Every command prints the reference's JSON line and saves its artifacts in
the shared layout, so the JAX package loads what the port saves.

    python -m text_similarity_tpu_torch train-sts --data sts.tsv \\
        --save-path runs/sts [--packed] [--device cpu]
    python -m text_similarity_tpu_torch serve --model ENC_DIR \\
        (--corpus docs.txt | --load PIPELINE_DIR) [--rerank-model CE_DIR] \\
        [--int8] [--port 8080] [--device cuda]

``pretrain-long`` sizes the position table at ``--target-len`` plus the
arch's ``position_offset``: a RoBERTa-family model numbers a row's tokens
from ``pad_token_id + 1``, so a full row needs that many more rows than
tokens (the reference tiles to ``--target-len`` and reads past its table).

``build_server`` does the serve set-up (load the encoder, the corpus or
saved pipeline and the cross-encoder, warm them) and returns the server;
``cmd_serve`` only serves it, so a caller can drive the same set-up without
blocking. ``--experts N`` (with ``--expert-top-k``) gives a random-init
model MoE FFNs of N experts; a loaded model carries its own arch.
``serve --shards N`` (N > 1) serves a ``ShardedSearchPipeline`` over the
first N cards (``--device cpu``: N shards on the CPU), the corpus on the
mesh's index axis and the encode data-parallel over the same devices when
N divides the 128-row batch; it raises where fewer than N cards are
visible. ``--pipe N`` (N > 1; the bi-encoder, classification, cross-encoder,
NER, WiC and ``pretrain-long`` training) runs the layer stack in N pipeline
stages (``models.pipeline``) over the visible cards, the rest of them data
parallel; it exits naming the count where fewer than N are visible, and
``--device cpu`` puts the N stages on the CPU. ``--pipe`` and ``--packed``
exclude each other, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..core.precision import precision_for, resolve_device


# the reference's shared flags that configure a random-init model or a
# training run: serve loads --model and reads none of them
_UNREAD = ("tokenizer", "arch", "pooling", "vocab_size", "seed", "save_path")


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", help="model dir to load (else random init)")
    p.add_argument("--tokenizer", help="tokenizer dir (vocab.txt/tokenizer.json)")
    p.add_argument("--arch", default="minilm-l6")
    p.add_argument("--pooling", default=None, choices=["mean", "cls", "max"],
                   help="default: the loaded model's pooling")
    p.add_argument("--vocab-size", type=int, default=30522)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--save-path", default="checkpoints/run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the models, the index and training run (cuda raises "
                        "without a card)")


def _train_common(p: argparse.ArgumentParser) -> None:
    _common(p)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--warmup-ratio", type=float, default=0.1)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--pipe", type=int, default=1,
                   help="pipeline-parallel stages: the layer stack over a pipe mesh axis "
                        "(the remaining cards go to data parallelism; --device cpu: N "
                        "stages on the CPU)")
    p.add_argument("--experts", type=int, default=0,
                   help="MoE experts in each FFN of a random-init model (0: dense)")
    p.add_argument("--expert-top-k", type=int, default=2,
                   help="experts consulted per token (MoE routing)")
    p.add_argument("--packed", action="store_true",
                   help="sequence-packed training: several short sentences a row behind "
                        "a block-diagonal mask (bi-encoder and cross-encoder objectives)")
    p.add_argument("--packed-rows", type=int, default=32,
                   help="packed rows per tower per step (the step's pairs are those that "
                        "pack into these rows)")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _pp_mesh(args):
    """The mesh of ``--pipe N``: N pipeline stages over the visible cards,
    the rest data parallel (the reference's ``make_mesh(data=-1,
    pipe=N)``); ``--device cpu``: N stages on the CPU. None for N ≤ 1."""
    n = getattr(args, "pipe", 1)
    if n <= 1:
        return None
    from ..core.mesh import make_mesh

    if args.device == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise SystemExit(f"--pipe {n} needs {n} cards; {visible} visible")
        devs = [torch.device("cuda", i) for i in range(visible - visible % n)]
    else:
        devs = [resolve_device(args.device)] * n
    return make_mesh(data=-1, pipe=n, devices=devs)


def _no_packed_pipe(args) -> None:
    if getattr(args, "pipe", 1) > 1:
        raise SystemExit("--packed and --pipe are mutually exclusive")


def _tokenizer(args, texts=None):
    from ..data.tokenization import WordPieceTokenizer, load_tokenizer, train_wordpiece_vocab

    if getattr(args, "tokenizer", None):
        return load_tokenizer(args.tokenizer)
    if texts is None:
        raise SystemExit("--tokenizer required (no training texts to fit one)")
    return WordPieceTokenizer(train_wordpiece_vocab(texts, vocab_size=args.vocab_size))


def _encoder(args, tokenizer=None, texts=None):
    """A SentenceEncoder on ``--device``: loaded from ``--model``, else
    random weights of ``--arch`` drawn from ``--seed`` (with ``--experts``,
    MoE FFNs)."""
    from ..core.config import ARCH_PRESETS
    from ..models import SentenceEncoder, init_params

    if getattr(args, "model", None):
        if not os.path.isdir(args.model):
            # a mistyped path must not fall back to a random model
            raise SystemExit(f"--model dir not found: {args.model!r}")
        return SentenceEncoder.load(args.model, bf16=not args.fp32, device=args.device)
    tok = tokenizer or _tokenizer(args, texts)
    arch = ARCH_PRESETS[args.arch].replace(vocab_size=tok.vocab_size)
    if getattr(args, "experts", 0):
        arch = arch.replace(num_experts=args.experts, expert_top_k=args.expert_top_k)
    params = init_params(arch, torch.Generator().manual_seed(args.seed))
    return SentenceEncoder(params, arch, tokenizer=tok, pooling=args.pooling or "mean",
                           precision=precision_for(not args.fp32), device=args.device)


def _train_cfg(args):
    from ..core.config import TrainConfig

    return TrainConfig(
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        warmup_ratio=args.warmup_ratio, grad_accum_steps=args.grad_accum,
        seed=args.seed, bf16=not args.fp32,
    )


def _fit(args, step, state, batches, epochs, **kw):
    """``Trainer.execute`` over the same batches every epoch, on
    ``--device``, saving under ``--save-path``."""
    from ..train import Trainer

    trainer = Trainer(step, state, save_path=args.save_path, device=args.device, **kw)
    return trainer.execute(lambda epoch: iter(batches), epochs=epochs)


def _run_bi_encoder_training(args, pairs, targets, loss_type, eval_fn=None,
                             target_dtype=np.float32, encoder=None):
    from ..data.pairs import build_packed_pair_batches, build_pair_batches
    from ..train import (
        init_classifier_head, init_train_state, make_bi_encoder_train_step,
        make_optimizer, make_packed_bi_encoder_train_step,
    )

    texts = [p[0] for p in pairs] + [p[1] for p in pairs]
    enc = encoder or _encoder(args, texts=texts)
    if args.packed:
        _no_packed_pipe(args)
        batches = build_packed_pair_batches(
            enc.tokenizer, pairs, targets, rows_per_side=args.packed_rows, width=args.max_len,
            seed=args.seed, target_dtype=target_dtype,
        )
    else:
        batches = build_pair_batches(
            enc.tokenizer, pairs, targets, batch_size=args.batch_size, max_len=args.max_len,
            seed=args.seed, target_dtype=target_dtype,
        )
    cfg = _train_cfg(args)
    params = {"encoder": enc.params}
    if loss_type == "softmax":
        # embedding_size, not hidden_size: a projection head narrows it
        params["head"] = init_classifier_head(
            torch.Generator().manual_seed(args.seed + 1), 3 * enc.arch.embedding_size,
            args.num_classes, device=args.device,
        )
    tx = make_optimizer(cfg, len(batches) * cfg.epochs, params_example=params)
    state = init_train_state(params, tx, seed=args.seed, device=args.device)
    # the loaded encoder's pooling unless --pooling: training with another
    # pooler than encode() would mismatch the objective and the eval
    kw = {} if args.packed else {"pp_mesh": _pp_mesh(args)}
    make = make_packed_bi_encoder_train_step if args.packed else make_bi_encoder_train_step
    step = make(enc.arch, tx, loss_type=loss_type, pooling=args.pooling or enc.pooling,
                precision=precision_for(cfg.bf16), device=args.device, **kw)
    result = _fit(args, step, state, batches, cfg.epochs, eval_fn=eval_fn,
                  tracked_metric=getattr(args, "metric", "loss"),
                  direction="max" if eval_fn else "min")
    enc.params = result["state"].params["encoder"]
    enc.save(args.save_path)
    print(json.dumps({"best_metric": result["best_metric"]}))
    return enc, result


# ---------------------------------------------------------------------------
# training commands
# ---------------------------------------------------------------------------

def cmd_train_sts(args):
    from ..data.datasets import load_sts
    from ..evaluation.evaluators import ParaphraseEvaluator

    rows = load_sts(args.data)
    pairs = [(a, b) for a, b, _ in rows]
    scores = [s for _, _, s in rows]
    eval_rows = load_sts(args.eval_data) if args.eval_data else None
    # built up front so the evaluation can take the live train state's weights
    enc = _encoder(args, texts=[a for a, _ in pairs] + [b for _, b in pairs])

    def eval_fn(state):
        enc.params = state.params["encoder"]
        rows_ = eval_rows or rows[:512]
        return ParaphraseEvaluator(enc, mode="regression").evaluate(
            [r[0] for r in rows_], [r[1] for r in rows_], [r[2] for r in rows_])

    args.metric = "spearman_cosine"
    _run_bi_encoder_training(args, pairs, scores, "cosine_mse",
                             eval_fn=None if args.no_eval else eval_fn, encoder=enc)


def cmd_train_nli(args):
    from ..data.datasets import load_nli

    rows = load_nli(args.data)
    args.num_classes = 3
    _run_bi_encoder_training(args, [(a, b) for a, b, _ in rows], [lab for _, _, lab in rows],
                             "softmax", target_dtype=np.int32)


def cmd_train_paws(args):
    from ..data.datasets import load_paws, load_quora

    rows = load_quora(args.data) if args.format == "quora" else load_paws(args.data)
    _run_bi_encoder_training(args, [(a, b) for a, b, _ in rows], [lab for _, _, lab in rows],
                             args.loss, target_dtype=np.float32)


def cmd_train_classification(args):
    from ..data.datasets import load_documents_json
    from ..data.pairs import build_sequence_batches
    from ..train import (
        init_classifier_head, init_train_state, make_classifier_train_step, make_optimizer,
    )

    docs = load_documents_json(args.data, max_paragraph_words=args.paragraph_words)
    labels = sorted({d["label"] for d in docs})
    lab2id = {lab: i for i, lab in enumerate(labels)}
    texts = [d["text"] for d in docs]
    enc = _encoder(args, texts=texts)
    batches = build_sequence_batches(enc.tokenizer, texts, [lab2id[d["label"]] for d in docs],
                                     batch_size=args.batch_size, max_len=args.max_len,
                                     seed=args.seed)
    cfg = _train_cfg(args)
    params = {
        "encoder": enc.params,
        "head": init_classifier_head(torch.Generator().manual_seed(1), enc.arch.hidden_size,
                                     len(labels), device=args.device),
    }
    tx = make_optimizer(cfg, len(batches) * cfg.epochs, params_example=params)
    state = init_train_state(params, tx, seed=args.seed, device=args.device)
    step = make_classifier_train_step(enc.arch, tx, pooling="cls",
                                      precision=precision_for(cfg.bf16), device=args.device,
                                      pp_mesh=_pp_mesh(args))
    result = _fit(args, step, state, batches, cfg.epochs)
    with open(os.path.join(args.save_path, "arch.json"), "w") as f:
        f.write(enc.arch.to_json())
    if hasattr(enc.tokenizer, "save_vocab"):
        enc.tokenizer.save_vocab(os.path.join(args.save_path, "vocab.txt"))
    with open(os.path.join(args.save_path, "labels.json"), "w") as f:
        json.dump(labels, f)
    print(json.dumps({"labels": labels, "best": result["best_metric"]}))


def cmd_train_cross_encoder(args):
    """Train a cross-encoder pair classifier (the reranker's model)."""
    from ..data.datasets import load_nli, load_paws
    from ..data.pairs import build_packed_pair_batches, build_pair_batches
    from ..models.cross_encoder import CrossEncoder
    from ..train import (
        init_classifier_head, init_train_state, make_classifier_train_step, make_optimizer,
        make_packed_classifier_train_step,
    )

    if args.format == "nli":
        rows, num_classes = load_nli(args.data), 3
    else:
        rows, num_classes = load_paws(args.data), 2
    enc = _encoder(args, texts=[a for a, _, _ in rows] + [b for _, b, _ in rows])
    pairs, labels = [(a, b) for a, b, _ in rows], [lab for _, _, lab in rows]
    if args.packed:
        _no_packed_pipe(args)
        batches = build_packed_pair_batches(
            enc.tokenizer, pairs, labels, rows_per_side=args.packed_rows, width=args.max_len,
            mode="cross", target_dtype=np.int32, seed=args.seed,
        )
    else:
        batches = build_pair_batches(
            enc.tokenizer, pairs, labels, batch_size=args.batch_size, max_len=args.max_len,
            mode="cross", target_dtype=np.int32, seed=args.seed,
        )
    cfg = _train_cfg(args)
    params = {
        "encoder": enc.params,
        "head": init_classifier_head(torch.Generator().manual_seed(args.seed + 1),
                                     enc.arch.hidden_size, num_classes, device=args.device),
    }
    tx = make_optimizer(cfg, len(batches) * cfg.epochs, params_example=params)
    state = init_train_state(params, tx, seed=args.seed, device=args.device)
    precision = precision_for(cfg.bf16)
    if args.packed:
        step = make_packed_classifier_train_step(enc.arch, tx, precision=precision,
                                                 device=args.device)
    else:
        step = make_classifier_train_step(enc.arch, tx, pooling="cls", precision=precision,
                                          device=args.device, pp_mesh=_pp_mesh(args))
    result = _fit(args, step, state, batches, cfg.epochs)
    ce = CrossEncoder(result["state"].params, enc.arch, tokenizer=enc.tokenizer,
                      num_classes=num_classes, precision=precision, device=args.device)
    ce.save(args.save_path)
    print(json.dumps({"num_classes": num_classes, "best": result["best_metric"]}))


def _ner_batches(tok, sents, tag2id, batch_size: int, max_len: int):
    """Token batches {ids, mask, tags}: a word's first sub-token carries its
    tag, the other sub-tokens, [CLS], [SEP] and padding −100; rows sorted
    by length, each batch padded to its bucket."""
    from ..data.batching import BUCKETS
    from ..data.pairs import _cap_bucket

    rows, tag_rows = [], []
    for s in sents:
        ids, tg = [tok.cls_id], [-100]
        for w, t in zip(s["tokens"], s["tags"]):
            pieces = tok._wordpiece(w.lower() if tok.lowercase else w)
            ids.extend(pieces[: max_len - 2 - len(ids)])
            tg.extend([tag2id[t]] + [-100] * (len(pieces) - 1))
            tg = tg[: len(ids)]
            if len(ids) >= max_len - 2:   # the row is full
                break
        rows.append(ids + [tok.sep_id])
        tag_rows.append(tg + [-100])
    batches = []
    order = np.argsort([len(r) for r in rows])
    for st in range(0, len(order), batch_size):
        g = order[st : st + batch_size]
        width = _cap_bucket(max(len(rows[i]) for i in g), BUCKETS, max_len)
        ids = np.full((batch_size, width), tok.pad_id, np.int32)
        mask = np.zeros((batch_size, width), np.int32)
        tg = np.full((batch_size, width), -100, np.int32)
        for j, i in enumerate(g):
            ids[j, : len(rows[i])] = rows[i]
            mask[j, : len(rows[i])] = 1
            tg[j, : len(tag_rows[i])] = tag_rows[i]
        batches.append({"ids": ids, "mask": mask, "tags": tg})
    return batches


def cmd_train_ner(args):
    from ..data.datasets import load_conll_ner
    from ..train import (
        init_classifier_head, init_train_state, make_optimizer,
        make_token_classifier_train_step,
    )

    sents = load_conll_ner(args.data)
    tags = sorted({t for s in sents for t in s["tags"]})
    enc = _encoder(args, texts=[" ".join(s["tokens"]) for s in sents])
    batches = _ner_batches(enc.tokenizer, sents, {t: i for i, t in enumerate(tags)},
                           args.batch_size, args.max_len)
    cfg = _train_cfg(args)
    params = {
        "encoder": enc.params,
        "head": init_classifier_head(torch.Generator().manual_seed(1), enc.arch.hidden_size,
                                     len(tags), device=args.device),
    }
    tx = make_optimizer(cfg, len(batches) * cfg.epochs, params_example=params)
    state = init_train_state(params, tx, device=args.device)
    step = make_token_classifier_train_step(enc.arch, tx, device=args.device,
                                            pp_mesh=_pp_mesh(args))
    result = _fit(args, step, state, batches, cfg.epochs)
    print(json.dumps({"tags": tags, "best": result["best_metric"]}))


def cmd_train_wic(args):
    """Word-in-context training, then the trained encoder's best-threshold
    accuracy on the training batches."""
    from ..data.datasets import load_wic
    from ..data.pairs import build_word_batches
    from ..models.word_encoder import WordEncoder
    from ..train import init_train_state, make_optimizer, make_word_encoder_train_step

    rows = load_wic(args.data, args.gold)
    enc = _encoder(args, texts=[r["sent1"] for r in rows] + [r["sent2"] for r in rows])
    batches = build_word_batches(enc.tokenizer, rows, batch_size=args.batch_size,
                                 max_len=args.max_len, seed=args.seed)
    cfg = _train_cfg(args)
    params = {"encoder": enc.params}
    tx = make_optimizer(cfg, len(batches) * cfg.epochs, params_example=params)
    state = init_train_state(params, tx, seed=args.seed, device=args.device)
    precision = precision_for(cfg.bf16)
    step = make_word_encoder_train_step(enc.arch, tx, precision=precision, device=args.device,
                                        pp_mesh=_pp_mesh(args))
    result = _fit(args, step, state, batches, cfg.epochs)
    trained = result["state"].params["encoder"]
    metrics = WordEncoder(trained, enc.arch, tokenizer=enc.tokenizer, precision=precision,
                          device=args.device).evaluate_wic(batches)
    enc.params = trained
    enc.save(args.save_path)
    print(json.dumps({"wic": metrics, "best": result["best_metric"]}))


def cmd_distill(args):
    """A layer-drop student of ``--model`` trained to its embeddings of
    ``--data`` (or of the source side of ``--parallel-data``)."""
    from ..compress.distill import SentenceEncoderDistiller
    from ..data.datasets import load_parallel, load_sentence_pool

    teacher = _load_encoder(args)
    if args.parallel_data:
        pairs = load_parallel(args.parallel_data, max_pairs=args.max_sentences)
        sentences, src = [t for _, t in pairs], [s for s, _ in pairs]
    else:
        sentences = load_sentence_pool(args.data, max_sentences=args.max_sentences)
        src = None
    distiller = SentenceEncoderDistiller(teacher, num_student_layers=args.student_layers,
                                         train_config=_train_cfg(args))
    student = distiller.distill(sentences, src_sentences=src, max_len=args.max_len)
    student.save(args.save_path)
    print(json.dumps({"student_layers": student.arch.num_layers, "saved": args.save_path}))


def cmd_theseus(args):
    """Theseus compression of ``--model`` to ``--slots`` layers on labelled
    pairs (softmax loss over a new head; the loss of each epoch on
    stderr)."""
    from ..compress.theseus import ReplacementScheduler, TheseusDistiller
    from ..data.datasets import load_nli, load_paws
    from ..data.pairs import build_pair_batches
    from ..models import SentenceEncoder
    from ..train import init_classifier_head, init_train_state, make_optimizer

    teacher = _load_encoder(args)
    rows = load_nli(args.data) if args.format == "nli" else load_paws(args.data)
    num_classes = 3 if args.format == "nli" else 2
    batches = build_pair_batches(teacher.tokenizer, [(a, b) for a, b, _ in rows],
                                 [lab for _, _, lab in rows], batch_size=args.batch_size,
                                 max_len=args.max_len, target_dtype=np.int32, seed=args.seed)
    cfg = _train_cfg(args)
    distiller = TheseusDistiller(teacher.params, teacher.arch, num_slots=args.slots,
                                 scheduler=ReplacementScheduler(args.base_rate, args.rate_k),
                                 train_config=cfg)
    params = {
        "succ": distiller.succ,
        "head": init_classifier_head(torch.Generator().manual_seed(args.seed + 1),
                                     3 * teacher.arch.embedding_size, num_classes,
                                     device=args.device),
    }
    tx = make_optimizer(cfg, len(batches) * cfg.epochs, params_example=params)
    state = init_train_state(params, tx, seed=args.seed, device=args.device)
    step = distiller.make_train_step(tx, num_classes=num_classes)
    pred_layers, embeddings = teacher.params["layers"], teacher.params["embeddings"]
    step_no = 0
    for epoch in range(cfg.epochs):
        losses = []
        for b in batches:
            state, m = step(state, b, distiller.scheduler.rate(step_no), pred_layers, embeddings)
            step_no += 1
            losses.append(m["loss"])
        print(f"epoch {epoch}: loss {float(torch.stack(losses).mean()):.4f}", file=sys.stderr)
    student = SentenceEncoder(distiller.compressed_params(state.params["succ"]),
                              distiller.compressed_arch, tokenizer=teacher.tokenizer,
                              pooling=teacher.pooling, precision=teacher.precision,
                              device=args.device)
    student.save(args.save_path)
    print(json.dumps({"layers": distiller.compressed_arch.num_layers, "saved": args.save_path}))


def cmd_prune(args):
    """Head and FFN importance pruning of a ``train-classification``
    directory; the result (``head_dim_override`` in its arch, labels and
    vocab beside it) loads in ``eval-classification``."""
    from ..compress.prune import ffn_importance, head_importance, prune_rewire
    from ..core import checkpoint as ckpt
    from ..core.config import EncoderArch
    from ..data.datasets import load_documents_json
    from ..data.pairs import build_sequence_batches
    from ..data.tokenization import load_tokenizer
    from ..models.encoder import cross_params_from_jax

    with open(os.path.join(args.model, "arch.json")) as f:
        arch = EncoderArch.from_json(f.read())
    tree, _, _ = ckpt.restore_checkpoint_raw(ckpt.latest_checkpoint(args.model))
    params = cross_params_from_jax(tree, arch, int(np.asarray(tree["head"]["b"]).shape[0]),
                                   resolve_device(args.device))
    tok = load_tokenizer(args.model)
    docs = load_documents_json(args.data)
    labels = sorted({d["label"] for d in docs})
    lab2id = {lab: i for i, lab in enumerate(labels)}
    # shuffled: the batches are length-sorted, and the shortest documents
    # alone would prune the heads that long inputs need
    batches = build_sequence_batches(
        tok, [d["text"] for d in docs], [lab2id[d["label"]] for d in docs],
        batch_size=args.batch_size, max_len=args.max_len, shuffle=True, seed=args.seed,
    )[: args.importance_batches]
    hi = head_importance(params, arch, batches)
    fi = ffn_importance(params, arch, batches)
    new_enc, new_arch = prune_rewire(params["encoder"], arch, hi, fi,
                                     target_heads=args.target_heads, target_ffn=args.target_ffn)
    os.makedirs(args.save_path, exist_ok=True)
    ckpt.save_checkpoint(args.save_path, {"encoder": new_enc, "head": params["head"]}, step=0,
                         meta={"pruned": True})
    with open(os.path.join(args.save_path, "arch.json"), "w") as f:
        f.write(new_arch.to_json())
    # eval-classification reads the label list beside the weights
    with open(os.path.join(args.save_path, "labels.json"), "w") as f:
        json.dump(labels, f)
    if hasattr(tok, "save_vocab"):
        tok.save_vocab(os.path.join(args.save_path, "vocab.txt"))
    print(json.dumps({"heads": new_arch.num_heads, "ffn": new_arch.intermediate_size,
                      "saved": args.save_path}))


def cmd_pretrain_long(args):
    """Long-model conversion and masked-LM re-pretraining: tile the position
    embeddings, set the sliding attention window, then MLM steps over the
    documents of ``--data`` tokenized to ``--target-len``."""
    from ..data.datasets import load_sentence_pool
    from ..models.hf_convert import extend_positions
    from ..train import init_train_state, make_mlm_train_step, make_optimizer

    texts_boot = None if args.model else load_sentence_pool(args.data, max_sentences=256)
    enc = _encoder(args, texts=texts_boot)
    # a RoBERTa-family row of target_len tokens reads position
    # target_len + pad_token_id: the table needs position_offset more rows
    params, arch = extend_positions(enc.params, enc.arch,
                                    args.target_len + enc.arch.position_offset)
    arch = arch.replace(attention_window=args.window)

    texts = load_sentence_pool(args.data, max_sentences=args.max_sentences)
    ids, mask = enc.tokenizer.encode_batch(texts, max_len=args.target_len)
    cfg = _train_cfg(args)
    n = (len(texts) // cfg.batch_size) * cfg.batch_size
    batches = [{"ids": ids[i:i + cfg.batch_size], "mask": mask[i:i + cfg.batch_size]}
               for i in range(0, n, cfg.batch_size)]
    if not batches:
        raise SystemExit("not enough documents for one batch")
    mlm_params = {
        "encoder": params,
        "mlm_bias": torch.zeros((arch.vocab_size,), dtype=torch.float32),
    }
    tx = make_optimizer(cfg, len(batches) * cfg.epochs, params_example=mlm_params)
    state = init_train_state(mlm_params, tx, seed=args.seed, device=args.device)
    tok = enc.tokenizer
    specials = sorted({tok.pad_id, getattr(tok, "unk_id", tok.pad_id), tok.cls_id,
                       tok.sep_id, tok.mask_id})
    step = make_mlm_train_step(arch, tx, mask_token_id=tok.mask_id, mask_prob=args.mask_prob,
                               special_ids=tuple(specials),
                               precision=precision_for(cfg.bf16), device=args.device,
                               pp_mesh=_pp_mesh(args))
    first = last = None
    for _ in range(cfg.epochs):
        pend = []
        for b in batches:
            state, m = step(state, b)
            pend.append(m["loss"])
        losses = [float(x) for x in pend]    # one sync an epoch
        if first is None:
            first = losses[0]
        last = losses[-1]
    enc.arch = arch
    enc.params = state.params["encoder"]
    enc.save(args.save_path)
    print(json.dumps({
        "target_len": args.target_len,
        "window": args.window,
        "mlm_loss_first": first,
        "mlm_loss_last": last,
        "saved": args.save_path,
    }))


# ---------------------------------------------------------------------------
# evaluation commands
# ---------------------------------------------------------------------------

def cmd_eval_classification(args):
    """A trained document classifier's accuracy and per-class accuracy over
    a labelled document set."""
    from ..core import checkpoint as ckpt
    from ..core.config import EncoderArch
    from ..data.datasets import load_documents_json
    from ..data.pairs import build_sequence_batches
    from ..data.tokenization import load_tokenizer
    from ..models.encoder import cross_params_from_jax
    from ..train import classifier_forward

    with open(os.path.join(args.model, "arch.json")) as f:
        arch = EncoderArch.from_json(f.read())
    with open(os.path.join(args.model, "labels.json")) as f:
        labels = json.load(f)
    lab2id = {lab: i for i, lab in enumerate(labels)}
    tok = load_tokenizer(args.model)
    tree, _, _ = ckpt.restore_checkpoint_raw(ckpt.latest_checkpoint(args.model))
    device = resolve_device(args.device)
    params = cross_params_from_jax(tree, arch, len(labels), device)
    docs = load_documents_json(args.data)
    y = [lab2id.get(d["label"], -1) for d in docs]
    batches = build_sequence_batches(tok, [d["text"] for d in docs], y,
                                     batch_size=args.batch_size, max_len=args.max_len,
                                     seed=0, shuffle=False)
    precision = precision_for(not args.fp32)
    preds, gold = [], []
    with torch.no_grad():
        for b in batches:
            logits = classifier_forward(
                params, torch.from_numpy(b["ids"]).to(device),
                torch.from_numpy(b["mask"]).to(device), None, arch=arch, precision=precision,
                pooling="cls",
            )
            valid = b["valid"].astype(bool)
            preds.extend(logits.argmax(dim=-1).cpu().numpy()[valid].tolist())
            gold.extend(b["labels"][valid].tolist())
    preds, gold = np.asarray(preds), np.asarray(gold)
    acc = float((preds == gold).mean()) if len(gold) else 0.0
    per_class = {lab: float((preds[gold == i] == i).mean())
                 for i, lab in enumerate(labels) if (gold == i).any()}
    print(json.dumps({"accuracy": acc, "per_class": per_class, "n": int(len(gold))}))


def _load_encoder(args):
    from ..models import SentenceEncoder

    return SentenceEncoder.load(args.model, bf16=not args.fp32, device=args.device)


def cmd_eval_sts(args):
    from ..data.datasets import load_sts
    from ..evaluation.evaluators import ParaphraseEvaluator

    rows = load_sts(args.data)[: args.max_pairs]
    out = ParaphraseEvaluator(_load_encoder(args), mode="regression").evaluate(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows])
    print(json.dumps(out, indent=2))


def cmd_eval_paws(args):
    from ..data.datasets import load_paws
    from ..evaluation.evaluators import ParaphraseEvaluator

    rows = load_paws(args.data)[: args.max_pairs]
    out = ParaphraseEvaluator(_load_encoder(args), mode="binary").evaluate(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows])
    print(json.dumps(out, indent=2))


def cmd_eval_tatoeba(args):
    from ..data.datasets import load_parallel
    from ..evaluation.evaluators import RetrievalEvaluator

    pairs = load_parallel(args.data, max_pairs=args.max_pairs)
    out = RetrievalEvaluator(_load_encoder(args)).evaluate(
        [s for s, _ in pairs], [t for _, t in pairs])
    print(json.dumps(out, indent=2))


# ---------------------------------------------------------------------------
# encode, search, mining, compression
# ---------------------------------------------------------------------------

def _lines(path: str):
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def cmd_quantize(args):
    """The int8 deployment checkpoint of ``--model`` (codes and scales,
    ``format: int8``, the pooling in its meta), with its arch and vocab."""
    from ..compress.quantize import save_quantized

    enc = _load_encoder(args)
    # without the pooling in meta the reloaded model would take mean pooling
    save_quantized(args.save_path, enc.params, meta={"pooling": enc.pooling})
    with open(os.path.join(args.save_path, "arch.json"), "w") as f:
        f.write(enc.arch.to_json())
    if enc.tokenizer is not None and hasattr(enc.tokenizer, "save_vocab"):
        enc.tokenizer.save_vocab(os.path.join(args.save_path, "vocab.txt"))
    print(json.dumps({"saved": args.save_path, "format": "int8"}))


def cmd_export(args):
    """``torch.export`` bundles of ``--model``'s encode step on
    ``--device``, one a (batch, seq) shape, with int8 params."""
    from ..compress.export import export_encoder

    manifest = export_encoder(_load_encoder(args), args.save_path,
                              batch_sizes=tuple(args.batch_sizes), seq_lens=tuple(args.seq_lens))
    print(json.dumps(manifest["functions"]))


def cmd_encode(args):
    """Embed a text file (one sentence a line) → an (N, D) f32 ``.npy``;
    ``--packed`` packs several short sentences a ``--width``-token row."""
    enc = _load_encoder(args)
    texts = _lines(args.corpus)
    if args.packed:
        emb = enc.encode_packed(texts, width=args.width, max_len=args.width)
    else:
        emb = enc.encode(texts, max_len=args.width)
    np.save(args.out, np.asarray(emb))
    print(f"encoded {len(texts)} texts -> {args.out} {emb.shape}")


def cmd_search(args):
    from ..core.config import IndexConfig
    from ..pipelines import SemanticSearchPipeline

    enc = _load_encoder(args)
    pipe = SemanticSearchPipeline(
        enc, corpus=_lines(args.corpus),
        index_config=IndexConfig(num_clusters=args.clusters, num_probes=args.probes),
        device=args.device,
    )
    if args.query:
        for row in pipe([args.query], args.top_k)[0]:
            print(f"{row[1]:.4f}\t{row[0]}")
        return
    print("interactive search — empty line to exit")
    while True:
        try:
            q = input("query> ").strip()
        except EOFError:   # Ctrl-D or the end of piped input
            break
        if not q:
            break
        for row in pipe([q], args.top_k)[0]:
            print(f"{row[1]:.4f}\t{row[0]}")


def cmd_mine(args):
    from ..pipelines import SentenceMiningPipeline

    enc = _load_encoder(args)
    corpus = _lines(args.corpus)
    use_ivf = {"auto": None, "on": True, "off": False}[args.ivf]
    pairs = SentenceMiningPipeline(enc, use_ivf=use_ivf, device=args.device)(
        corpus, k=args.top_k, min_score=args.min_score)
    for i, j, s in pairs[: args.max_pairs]:
        print(f"{s:.4f}\t{corpus[i]}\t{corpus[j]}")


def cmd_compare_models(args):
    """Teacher (``--model``) against student (``--student``): the top-k
    overlap of their brute-force searches, the first ``--num-queries``
    lines of the corpus as queries."""
    from ..models import SentenceEncoder
    from ..pipelines import compare_models

    teacher = _load_encoder(args)
    student = SentenceEncoder.load(args.student, bf16=not args.fp32, device=args.device)
    if student.tokenizer is None:
        student.tokenizer = teacher.tokenizer
    corpus = _lines(args.corpus)
    print(json.dumps(compare_models(teacher, student, corpus, corpus[: args.num_queries],
                                    k=args.top_k, device=args.device)))


def cmd_cluster(args):
    """k-means clusters of a text file: a JSON line a cluster (its id, size
    and first five texts)."""
    from ..pipelines import ClusteringPipeline

    corpus = _lines(args.corpus)
    clusters = ClusteringPipeline(_encoder(args, texts=corpus),
                                  num_clusters=args.num_clusters)(corpus)
    for cid in sorted(clusters):
        print(json.dumps({"cluster": cid, "size": len(clusters[cid]),
                          "examples": clusters[cid][:5]}))


def cmd_topics(args):
    """Topics of a text file: a line a topic (id, size, top words[, the
    lexicon's names])."""
    from ..pipelines import TopicModelingPipeline

    enc = _load_encoder(args)
    corpus = _lines(args.corpus)
    lexicon = None
    if args.lexicon:
        from ..utils.lexicon import Lexicon

        lexicon = (Lexicon.from_wordnet() if args.lexicon == "wordnet"   # needs nltk's corpus
                   else Lexicon.from_json(args.lexicon))
    res = TopicModelingPipeline(enc, num_topics=args.num_topics, method=args.method,
                                reduce=args.reduce, lexicon=lexicon)(corpus)
    names = res.get("names", {})
    for t, words in sorted(res["topics"].items()):
        row = [t, res["sizes"].get(t, 0), [w for w, _ in words]]
        if lexicon is not None:
            row.append("/".join(names.get(t, [])))
        print(*row)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def build_server(args):
    """The ``serve`` set-up → a ``SearchServer`` bound to ``--host`` /
    ``--port``, not yet serving."""
    from ..models.cross_encoder import CrossEncoder
    from ..models.sentence_encoder import SentenceEncoder
    from ..pipelines.rerank import RankingPipeline
    from ..pipelines.search import SemanticSearchPipeline
    from ..pipelines.serve import SearchServer

    defaults = vars(build_parser().parse_args(["serve"]))
    unread = ["--" + k.replace("_", "-") for k in _UNREAD if getattr(args, k) != defaults[k]]
    if unread:
        raise SystemExit(f"serve reads no {', '.join(unread)}: it serves the --model "
                         "directory's own tokenizer, architecture and pooling")
    if not args.model or not os.path.isdir(args.model):
        raise SystemExit(f"--model dir not found: {args.model!r}")
    if args.shards > 1:
        pipe = _sharded_pipeline(args)
        device = pipe.encoder.device
    else:
        device = resolve_device(args.device)
        enc = SentenceEncoder.load(args.model, bf16=not args.fp32, device=device)
        if args.int8:
            enc.to_int8()
        pipe = SemanticSearchPipeline(enc, device=device)
        if args.load:
            pipe.load_corpus(args.load)
        elif args.corpus:
            pipe.add_documents(_lines(args.corpus))
    if args.warmup:
        n = pipe.warmup(max_queries=args.warmup)
        print(f"warmed {n} (bucket, k) serving shapes", flush=True)
    reranker = None
    if args.rerank_model:
        ce = CrossEncoder.load(args.rerank_model, bf16=not args.fp32, device=device)
        if args.int8:
            ce.to_int8()
        reranker = RankingPipeline(pipe, ce, retrieve_k=args.retrieve_k, batch_size=512)
        if len(pipe.corpus) > 0:
            # the first /rerank would otherwise pay the retrieve + scoring
            # set-up (and the IVF build); warmed with or without --warmup
            reranker([pipe.corpus[0]], top_k=min(10, args.retrieve_k))
            print("warmed rerank path", flush=True)
    return SearchServer(
        pipe, host=args.host, port=args.port, batch_window=args.batch_window_ms / 1000.0,
        reranker=reranker,
    )


def _sharded_pipeline(args):
    """``serve --shards N``: the corpus over the index axis of the first N
    cards (N CPU shards with ``--device cpu``); the encode data-parallel
    over the same devices where N divides the 128-row encode batch."""
    from ..core.mesh import make_mesh
    from ..models.sentence_encoder import SentenceEncoder
    from ..pipelines.search import ShardedSearchPipeline

    n = args.shards
    if args.device == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise SystemExit(f"--shards {n} needs {n} cards; {visible} visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [resolve_device(args.device)] * n
    enc_mesh = make_mesh(data=n, devices=devs) if 128 % n == 0 else None
    enc = SentenceEncoder.load(args.model, bf16=not args.fp32, device=devs[0], mesh=enc_mesh)
    if args.int8:
        enc.to_int8()
    mesh = make_mesh(data=1, index=n, devices=devs)
    if args.load:
        return ShardedSearchPipeline.load(args.load, enc, mesh)
    pipe = ShardedSearchPipeline(enc, mesh)
    if args.corpus:
        pipe.add_documents(_lines(args.corpus))
    return pipe


def cmd_serve(args) -> None:
    """Search serving daemon: serves until interrupted."""
    server = build_server(args)
    print(f"serving on http://{args.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m text_similarity_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train-sts")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--eval-data")
    p.add_argument("--no-eval", action="store_true")
    p.set_defaults(fn=cmd_train_sts)

    p = sub.add_parser("train-nli")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.set_defaults(fn=cmd_train_nli)

    p = sub.add_parser("train-paws")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--format", default="paws", choices=["paws", "quora"])
    p.add_argument("--loss", default="online_contrastive",
                   choices=["contrastive", "online_contrastive", "mnrl", "cosine_mse"])
    p.set_defaults(fn=cmd_train_paws)

    p = sub.add_parser("train-classification")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--paragraph-words", type=int, default=0)
    p.set_defaults(fn=cmd_train_classification)

    p = sub.add_parser("train-cross-encoder")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--format", default="paws", choices=["paws", "nli"])
    p.set_defaults(fn=cmd_train_cross_encoder)

    p = sub.add_parser("train-wic")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--gold")
    p.set_defaults(fn=cmd_train_wic)

    p = sub.add_parser("train-ner")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.set_defaults(fn=cmd_train_ner)

    p = sub.add_parser("distill")
    _train_common(p)
    p.add_argument("--data")
    p.add_argument("--parallel-data")
    p.add_argument("--student-layers", type=int, default=4)
    p.add_argument("--max-sentences", type=int, default=100000)
    p.set_defaults(fn=cmd_distill)

    p = sub.add_parser("eval-classification")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.set_defaults(fn=cmd_eval_classification)

    p = sub.add_parser("pretrain-long")
    _train_common(p)
    p.add_argument("--data", required=True, help="text file, one document per line")
    p.add_argument("--target-len", type=int, default=1024)
    p.add_argument("--window", type=int, default=128,
                   help="sliding attention window for the long model")
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--max-sentences", type=int, default=100000)
    p.set_defaults(fn=cmd_pretrain_long)

    p = sub.add_parser("theseus")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--format", default="paws", choices=["paws", "nli"])
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--base-rate", type=float, default=0.3)
    p.add_argument("--rate-k", type=float, default=1e-3)
    p.set_defaults(fn=cmd_theseus)

    p = sub.add_parser("prune")
    _train_common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--target-heads", type=int, required=True)
    p.add_argument("--target-ffn", type=int, required=True)
    p.add_argument("--importance-batches", type=int, default=8)
    p.set_defaults(fn=cmd_prune)

    for name, fn in (("eval-sts", cmd_eval_sts), ("eval-paws", cmd_eval_paws),
                     ("eval-tatoeba", cmd_eval_tatoeba)):
        p = sub.add_parser(name)
        _common(p)
        p.add_argument("--data", required=True)
        p.add_argument("--max-pairs", type=int, default=5000)
        p.set_defaults(fn=fn)

    p = sub.add_parser("quantize")
    _common(p)
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("export")
    _common(p)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[32])
    p.add_argument("--seq-lens", type=int, nargs="+", default=[128])
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("encode")
    _common(p)
    p.add_argument("--corpus", required=True, help="text file, one sentence per line")
    p.add_argument("--out", required=True, help="output .npy path")
    p.add_argument("--packed", action="store_true",
                   help="greedy sequence packing: several short sentences a row behind a "
                        "block-diagonal attention mask (short-text throughput)")
    p.add_argument("--width", type=int, default=128,
                   help="row width / max tokens per sentence")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("search")
    _common(p)
    p.add_argument("--corpus", required=True)
    p.add_argument("--query")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--clusters", type=int, default=1024)
    p.add_argument("--probes", type=int, default=16)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("mine")
    _common(p)
    p.add_argument("--corpus", required=True)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--min-score", type=float, default=0.8)
    p.add_argument("--max-pairs", type=int, default=100)
    p.add_argument("--ivf", choices=("auto", "on", "off"), default="auto",
                   help="IVF approximate mining (auto: on from 100k docs; exact mining is "
                        "O(N^2))")
    p.set_defaults(fn=cmd_mine)

    p = sub.add_parser("compare-models")
    _common(p)
    p.add_argument("--student", required=True)
    p.add_argument("--corpus", required=True)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--num-queries", type=int, default=100)
    p.set_defaults(fn=cmd_compare_models)

    p = sub.add_parser("cluster")
    _common(p)
    p.add_argument("--corpus", required=True)
    p.add_argument("--num-clusters", type=int, default=10)
    p.set_defaults(fn=cmd_cluster)

    p = sub.add_parser("topics")
    _common(p)
    p.add_argument("--corpus", required=True)
    p.add_argument("--num-topics", type=int, default=10)
    p.add_argument("--method", default="kmeans", choices=["kmeans", "density", "hdbscan"])
    p.add_argument("--reduce", default="pca", choices=["pca", "spectral"])
    p.add_argument("--lexicon", default=None,
                   help="taxonomy JSON for hypernym topic names (or 'wordnet' to use the nltk "
                        "corpus if installed)")
    p.set_defaults(fn=cmd_topics)

    p = sub.add_parser("serve")
    _common(p)
    p.add_argument("--corpus", help="text file, one document per line")
    p.add_argument("--load", help="saved pipeline dir (from /save or save())")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="micro-batch window for concurrent /search requests (0 disables)")
    p.add_argument("--shards", type=int, default=1,
                   help=">1: shard the corpus over this many devices (the first N cards; N "
                        "shards on the CPU with --device cpu)")
    p.add_argument("--warmup", type=int, default=0,
                   help="run the query buckets up to this many queries before accepting "
                        "requests")
    p.add_argument("--int8", action="store_true",
                   help="serve with int8 encoder and cross-encoder weights (dynamic "
                        "activation quant + int8 products)")
    p.add_argument("--rerank-model",
                   help="cross-encoder dir: enables POST /rerank (retrieve the top "
                        "--retrieve-k, re-score, return the top k)")
    p.add_argument("--retrieve-k", type=int, default=100,
                   help="candidates retrieved per query before reranking")
    p.set_defaults(fn=cmd_serve)
    return ap


# the commands whose training runs pipeline-parallel under --pipe N (the
# reference wires the same ones and ignores the flag elsewhere)
_PIPELINED = {cmd_train_sts, cmd_train_nli, cmd_train_paws, cmd_train_classification,
              cmd_train_cross_encoder, cmd_train_ner, cmd_train_wic, cmd_pretrain_long}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if getattr(args, "pipe", 1) > 1:
        if args.fn not in _PIPELINED:
            raise SystemExit(f"--pipe {args.pipe}: {args.cmd} does not train pipeline-parallel")
        _pp_mesh(args)   # too few cards: exit naming the count before any work
    args.fn(args)


if __name__ == "__main__":
    main()
