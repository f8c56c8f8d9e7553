"""The port's CLI: ``python -m text_similarity_tpu_torch <command>``.

Port of ``text_similarity_tpu.cli.main``; so far its ``serve`` subcommand,
the search daemon (``pipelines.serve.SearchServer``):

    python -m text_similarity_tpu_torch serve --model ENC_DIR \\
        (--corpus docs.txt | --load PIPELINE_DIR) [--rerank-model CE_DIR] \\
        [--int8] [--port 8080] [--device cuda]

The flags are the reference's, plus ``--device`` (``cuda`` by default; it
raises without a card). ``build_server`` does the set-up (load the encoder,
the corpus or saved pipeline and the cross-encoder, warm them) and returns
the server; ``cmd_serve`` only serves it, so a caller can drive the same
set-up without blocking.
"""

from __future__ import annotations

import argparse
import os

from ..core.precision import resolve_device


# the reference's shared flags that configure a random-init model or a
# training run: serve loads --model and reads none of them
_UNREAD = ("tokenizer", "arch", "pooling", "vocab_size", "seed", "save_path")


def _common(p: argparse.ArgumentParser) -> None:
    # the reference's shared flags; serve reads --model, --fp32 and --device
    p.add_argument("--model", help="model dir to load")
    p.add_argument("--tokenizer", help="tokenizer dir (vocab.txt/tokenizer.json)")
    p.add_argument("--arch", default="minilm-l6")
    p.add_argument("--pooling", default=None, choices=["mean", "cls", "max"],
                   help="default: the loaded model's pooling")
    p.add_argument("--vocab-size", type=int, default=30522)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--save-path", default="checkpoints/run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the models and the index run (cuda raises without a card)")


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
    if args.shards > 1:
        raise SystemExit("--shards > 1: the sharded pipeline is not ported yet")
    if not args.model or not os.path.isdir(args.model):
        raise SystemExit(f"--model dir not found: {args.model!r}")
    device = resolve_device(args.device)
    enc = SentenceEncoder.load(args.model, bf16=not args.fp32, device=device)
    if args.int8:
        enc.to_int8()
    pipe = SemanticSearchPipeline(enc, device=device)
    if args.load:
        pipe.load_corpus(args.load)
    elif args.corpus:
        with open(args.corpus, encoding="utf-8") as f:
            pipe.add_documents([line.strip() for line in f if line.strip()])
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

    p = sub.add_parser("serve")
    _common(p)
    p.add_argument("--corpus", help="text file, one document per line")
    p.add_argument("--load", help="saved pipeline dir (from /save or save())")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="micro-batch window for concurrent /search requests (0 disables)")
    p.add_argument("--shards", type=int, default=1,
                   help=">1: shard the corpus over this many devices (not ported yet)")
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
