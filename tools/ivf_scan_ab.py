"""Times K1, K4, K1-opt per_probe and emit_acc, K9, K10, K11a and K11b of
one source tree on the card, with K2 as a control:

- at chip_smoke.py's shapes: the 1M × 384 bench corpus,
  ``IndexConfig.auto(1M)``, 4096 queries with the serving args (block_q 64,
  union_factor 1): K1 at k 10 and k 100 (deferred, w = Mc, the planned
  slots) and at k 10 exact; K4 at k_scan 20 (deferred) and exact; K1-opt
  per_probe at k 10 (bf16, int8; bf16 also with every probe −1, which
  times its CTAs' fixed cost alone); K9 (``final_merge="packed"``) at k 10
  (w = Mc) and k 100 (w 512, the planned slots); K10
  (``dma_pipeline``) at k 10 with 2, 3 and 4 buffers and at k 100 (its
  planned slots); K1-opt emit_acc (``final_merge="xla"``) at bench.py's
  k 100 args (w 512, the planned slots; int8 at the rescore's k_scan 200)
  and the stable select the query path runs on its (4096, S·w) output;
  the rescore of the int8 scan's 200 candidates a query down to k 100;
  K11a (``probes_per_step``) at k 10 with P 2, 3 and 4; K11b (the idless
  scan) at k 10 on a ``sentinel=True`` build of the same corpus (2048 ×
  1536 × 385, w = Mc); K11a (P 2) and K10 (2 buffers) where the tile does
  not run, beside K1's CUDA-core fold at (Mc, 1): on f32 copies of the
  bf16 slabs and on the sentinel build's 385-wide slabs;
  ``IVFIndex.query``'s 4096-query QPS, bf16 at k 10, int8 + rescore,
  ``per_probe`` (bf16, int8 + rescore with k_coarse 20) and
  ``final_merge="packed"`` at k 10 and 100 with their recall against the
  exact top-k (``cosine_topk_cuda``), ``dma_pipeline``,
  ``probes_per_step=2``, ``final_merge="xla"`` at k 100 (bf16, int8 +
  rescore) and the sentinel index's idless scan;
- at the pipeline's request shapes: chip_smoke.py phase 4's index of
  120,000 synthetic documents (minilm-l6 with random weights, bf16 slabs)
  and phase 5's (the same encoder in int8, int8 slabs), requests of 1, 5
  and 64 stored documents as ``serving_plan`` hands them to the scan
  (block_q 1, 8, 64; the pipeline's approx_width rule, k 10, int8 k_scan
  20);
- K2 at Q 256 × N 100,003.

The pipeline's embeddings are encoded once, and each index's centroids and
id map built once, and kept in ``_archive/ab_cache/`` (git-ignored) for
the runs that follow, so that every tree scans the same slabs. To compare
two commits on one card, unpack the other with ``git archive`` into a
git-ignored directory and run, from the repository root, in turns:

    python3 tools/ivf_scan_ab.py <other tree>
    python3 tools/ivf_scan_ab.py .
    python3 tools/ivf_scan_ab.py .
    python3 tools/ivf_scan_ab.py <other tree>

Each run builds that tree's kernels (into its own ``_build/``) and prints
one line ``AB <tree> ...``.
"""

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, "_archive", "ab_cache")


def pipeline_embeddings(torch, cs, int8: bool):
    """Phase 4's (bf16) or phase 5's (int8 encoder) stored embeddings of
    the 120,000-document corpus, encoded once and cached."""
    path = os.path.join(CACHE, f"pipeline_{'int8' if int8 else 'bf16'}.pt")
    if os.path.exists(path):
        return torch.load(path).cuda()
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.data.tokenization import (
        WordPieceTokenizer, train_wordpiece_vocab,
    )
    from text_similarity_tpu_torch.models import SentenceEncoder, init_params
    from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline

    corpus = cs.synthetic_corpus(120_000)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=30522))
    arch = ARCH_PRESETS["minilm-l6"]
    enc = SentenceEncoder(init_params(arch, torch.Generator().manual_seed(0)), arch,
                          tokenizer=tok, device="cuda")
    if int8:
        enc = enc.to_int8()
    view = SemanticSearchPipeline(enc, corpus=corpus, device="cuda").store.view
    os.makedirs(CACHE, exist_ok=True)
    torch.save(view.cpu(), path)
    return view


def same_index(torch, name, corpus, cfg, sentinel=False):
    """The IVF index of ``corpus`` that every run scans: built once (k-means
    on the card is not deterministic: its centroid sums go through
    ``index_add_``, so two builds lay the slabs out differently), its
    centroids and id map kept in ``_archive/ab_cache/``, and the slabs laid
    out from them each run as ``IVFIndex.build`` lays them out (bf16 rows,
    the sentinel's +2 column; int8 codes and scales, the bf16 rescore
    copy)."""
    from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
    from text_similarity_tpu_torch.index.ivf import IVFIndex

    path = os.path.join(CACHE, f"ivf_{name}.pt")
    if not os.path.exists(path):
        ivf = IVFIndex.build(corpus, cfg, data_dtype=torch.bfloat16, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0),
                             sentinel=sentinel)
        os.makedirs(CACHE, exist_ok=True)
        torch.save({"centroids": ivf.centroids.cpu(), "ids": ivf.ids_padded.cpu(),
                    "num_base": ivf.num_base_clusters}, path)
        del ivf
    z = torch.load(path)
    ids = z["ids"].cuda()
    c_tot, mc = ids.shape
    d = corpus.shape[1]
    slot = torch.nonzero(ids.reshape(-1) >= 0).squeeze(1)
    rows = corpus[ids.reshape(-1)[slot].long()]
    scales = rescore = None
    if cfg.quantize_int8:
        data = torch.zeros((c_tot * mc, d), dtype=torch.int8, device="cuda")
        scales = torch.zeros(c_tot * mc, device="cuda")
        data[slot], scales[slot] = quantize_embeddings_int8(rows)
        scales, rescore = scales.view(c_tot, mc), corpus.to(torch.bfloat16)
    else:
        data = torch.zeros((c_tot * mc, d + int(sentinel)), dtype=torch.bfloat16, device="cuda")
        data[slot, :d] = rows.to(torch.bfloat16)
        if sentinel:
            data[slot, d] = 2.0
    return IVFIndex(z["centroids"].cuda(), data.view(c_tot, mc, -1), ids, z["num_base"], cfg,
                    scales_padded=scales, rescore_data=rescore)


def main(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, REPO)
    import torch

    import chip_smoke as cs
    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index import ivf_modes
    from text_similarity_tpu_torch.index.ivf import (
        _rescore, _top_by_position, ivf_scan_cuda,
    )
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    torch.backends.cuda.matmul.allow_tf32 = False
    times = {}

    def scan_ms(ivf, qs, pl, k, bq, w, s, iters):
        return cs.time_ms(torch, lambda: ivf_scan_cuda(qs, pl, ivf.data_padded, ivf.ids_padded, k,
                                                       bq, w, s, ivf.scales_padded),
                          iters=iters, warmup=2)

    def off_tile(name, qs, pl, data, ids, bq):
        mc = data.shape[1]
        assert ivf_modes.tile_plan_cuda(ivf_modes.data_kind(data), data.shape[2], mc, bq, 10, mc,
                                        1) is None
        for label, fn in (
                ("K1 core k=10 w=Mc S=1", lambda: ivf_scan_cuda(qs, pl, data, ids, 10, bq, mc, 1)),
                ("K11a k=10 P=2", lambda: ivf_modes.ivf_scan_multiprobe_cuda(qs, pl, data, ids, 10,
                                                                             bq, 2)),
                ("K10 k=10 S=1 buffers 2", lambda: ivf_modes.ivf_scan_dma_cuda(qs, pl, data, ids,
                                                                               10, bq, 1, 2))):
            times[f"{label} 1M {name}"] = cs.time_ms(torch, fn, iters=5, warmup=1)

    # the pipeline's request shapes
    rng = np.random.default_rng(4)
    for int8 in (False, True):
        emb = pipeline_embeddings(torch, cs, int8)
        cfg = dataclasses.replace(IndexConfig.auto(emb.shape[0]), quantize_int8=int8)
        ivf = same_index(torch, f"pipeline_{'int8' if int8 else 'bf16'}", emb, cfg)
        mc = ivf.data_padded.shape[1]
        k = ivf.scan_k(10)
        w, s = ivf.scan_mode(k, 2048 if mc >= 1024 else 0, 0)
        for b in (1, 5, 64):
            q = _pad_pow2(emb[torch.as_tensor(rng.choice(emb.shape[0], b), device="cuda")].float())
            qs, pl, _, bq = cs.serving_plan(ivf, q)
            times[f"{'K4' if int8 else 'K1'} pipeline B={b} (bq {bq} U {pl.shape[1]} Mc {mc} "
                  f"k {k} w {w} S {s})"] = scan_ms(ivf, qs, pl, k, bq, w, s, 50)
        del ivf, emb

    # the 1M bench shapes
    n, n_q = 1_000_000, 4096
    corpus, queries = cs.bench_corpus(torch, n, n_q)
    exact = {k: cosine_topk_cuda(queries, corpus, k)[1].cpu().numpy() for k in (10, 100)}

    def recall(out, k):   # of the query's ids against the exact top-k
        return cs.overlap(out[1].cpu().numpy(), exact[k])
    cfg = IndexConfig.auto(n)
    qargs = dict(k=10, block_q=64, union_factor=1, approx_width=2048)
    for int8 in (False, True):
        ivf = same_index(torch, f"1m_{'int8' if int8 else 'bf16'}", corpus,
                         dataclasses.replace(cfg, quantize_int8=int8))
        qs, pl, _, bq = cs.serving_plan(ivf, queries)
        mc = ivf.data_padded.shape[1]
        runs = ((20, mc, 2), (20, 0, 1)) if int8 else ((10, mc, 1), (100, mc, 2), (10, 0, 1))
        for k, w, s in runs:
            times[f"{'K4' if int8 else 'K1'} 1M k={k} w={w} S={s}"] = scan_ms(ivf, qs, pl, k, bq, w,
                                                                              s, 10)
        q_ms = cs.time_ms(torch, lambda: ivf.query(queries, **qargs), iters=5, warmup=1)
        times[f"query 4096 {'int8 + rescore' if int8 else 'bf16'} k=10 "
              f"({n_q / q_ms * 1e3:.0f} QPS)"] = q_ms
        # K1-opt per_probe at k 10 (int8: the query's scan, before its rescore)
        times[f"per_probe 1M {'int8' if int8 else 'bf16'} k=10"] = cs.time_ms(
            torch, lambda: ivf_scan_cuda(qs, pl, ivf.data_padded, ivf.ids_padded, 10, bq,
                                         scales=ivf.scales_padded, per_probe=True),
            iters=10, warmup=2)
        if not int8:   # the same launch with every probe −1: its CTAs' fixed cost, no tile read
            none = torch.full_like(pl, -1)
            times["per_probe 1M bf16 k=10, every probe -1"] = cs.time_ms(
                torch, lambda: ivf_scan_cuda(qs, none, ivf.data_padded, ivf.ids_padded, 10, bq,
                                             per_probe=True),
                iters=10, warmup=2)
        pp_args = dict(k=10, block_q=64, union_factor=1, per_probe=True,
                       **(dict(k_coarse=20) if int8 else {}))
        q_ms = cs.time_ms(torch, lambda: ivf.query(queries, **pp_args), iters=5, warmup=1)
        rec = recall(ivf.query(queries, **pp_args), 10)
        times[f"query 4096 per_probe {'int8 + rescore (k_coarse 20)' if int8 else 'bf16'} k=10 "
              f"({n_q / q_ms * 1e3:.0f} QPS, recall {rec:.4f})"] = q_ms
        if not int8:   # K9 (final_merge "packed") at k 10 (w = Mc) and k 100 (w 512)
            for k, args in ((10, qargs), (100, cs.K100_ARGS)):
                w, s = ivf.scan_mode(k, args["approx_width"], final_merge="packed")
                times[f"K9 1M k={k} w={w} S={s}"] = cs.time_ms(
                    torch, lambda: ivf_modes.ivf_scan_packed_cuda(qs, pl, ivf.data_padded,
                                                                  ivf.ids_padded, k, bq, w, s),
                    iters=10, warmup=2)
                pk = dict(args, k=k, final_merge="packed")
                q_ms = cs.time_ms(torch, lambda: ivf.query(queries, **pk), iters=5, warmup=1)
                rec = recall(ivf.query(queries, **pk), k)
                times[f"query 4096 final_merge packed k={k} ({n_q / q_ms * 1e3:.0f} QPS, "
                      f"recall {rec:.4f})"] = q_ms
        if not int8:   # K10 (dma_pipeline) on the bf16 index: phase 5b's cases
            for k, nb in ((10, 2), (10, 3), (10, 4), (100, 2)):
                s = ivf.scan_mode(k, dma_pipeline=True)[1]
                times[f"K10 1M k={k} S={s} buffers {nb}"] = cs.time_ms(
                    torch, lambda: ivf_modes.ivf_scan_dma_cuda(qs, pl, ivf.data_padded,
                                                               ivf.ids_padded, k, bq, s, nb),
                    iters=10, warmup=2)
            q_ms = cs.time_ms(torch, lambda: ivf.query(queries, dma_pipeline=True, **qargs),
                              iters=5, warmup=1)
            times[f"query 4096 dma_pipeline k=10 ({n_q / q_ms * 1e3:.0f} QPS)"] = q_ms
            # K11a (probes_per_step) on the bf16 index: phase 5b's cases
            for p in (2, 3, 4):
                times[f"K11a 1M k=10 P={p}"] = cs.time_ms(
                    torch, lambda: ivf_modes.ivf_scan_multiprobe_cuda(qs, pl, ivf.data_padded,
                                                                      ivf.ids_padded, 10, bq, p),
                    iters=10, warmup=2)
            q_ms = cs.time_ms(torch, lambda: ivf.query(queries, probes_per_step=2, **qargs),
                              iters=5, warmup=1)
            times[f"query 4096 probes_per_step 2 k=10 ({n_q / q_ms * 1e3:.0f} QPS)"] = q_ms
            # K10 and K11a off the tile, on f32 copies of the same slabs, beside
            # K1's CUDA-core fold at (Mc, S)
            off_tile(f"f32 D {ivf.data_padded.shape[2]}", qs, pl, ivf.data_padded.float(),
                     ivf.ids_padded, bq)
        # K1-opt emit_acc (final_merge "xla") at k 100: the scan's k_scan
        k_e = ivf.scan_k(100)
        w, s = ivf.scan_mode(k_e, 512, final_merge="xla")
        emit = lambda: ivf_scan_cuda(qs, pl, ivf.data_padded, ivf.ids_padded, k_e, bq,  # noqa: E731
                                     w, s, ivf.scales_padded, emit_acc=True)
        times[f"emit_acc 1M {'int8' if int8 else 'bf16'} k={k_e} w={w} S={s}"] = cs.time_ms(
            torch, emit, iters=10, warmup=2)
        acc = emit()
        if not int8:
            times[f"stable select of emit_acc's (4096, {s * w}) at k={k_e}"] = cs.time_ms(
                torch, lambda: _top_by_position(*acc, k_e), iters=10, warmup=2)
        else:   # the rescore of the int8 scan's k_scan candidates down to k 100
            cand = _top_by_position(*acc, k_e)[1]
            times[f"rescore of {k_e} candidates to k=100 (bf16 copy)"] = cs.time_ms(
                torch, lambda: _rescore(qs, cand, ivf.rescore_data, 100), iters=10, warmup=2)
        q_ms = cs.time_ms(torch, lambda: ivf.query(queries, k=100, final_merge="xla",
                                                   **cs.K100_ARGS), iters=5, warmup=1)
        times[f"query 4096 final_merge xla {'int8 + rescore' if int8 else 'bf16'} k=100 "
              f"({n_q / q_ms * 1e3:.0f} QPS)"] = q_ms
        del ivf
    # K11b on a sentinel build of the same corpus (phase 5b's case)
    sent = same_index(torch, "1m_sentinel", corpus, cfg, sentinel=True)
    qs, pl, _, bq = cs.serving_plan(sent, queries)
    w = sent.scan_mode(10, 2048, 1)[0]
    # the index's zero-tile map where the tree keeps one (read, not rebuilt, by each call)
    extra = {"zero_tiles": sent.zero_tiles} if getattr(sent, "zero_tiles", None) is not None else {}
    times[f"K11b 1M sentinel k=10 w={w}"] = cs.time_ms(
        torch, lambda: ivf_modes.ivf_scan_idless_cuda(qs, pl, sent.data_padded, 10, bq, w, **extra),
        iters=10, warmup=2)
    q_ms = cs.time_ms(torch, lambda: sent.query(queries, acc_slots=1, **qargs), iters=5, warmup=1)
    times[f"query 4096 sentinel idless k=10 ({n_q / q_ms * 1e3:.0f} QPS)"] = q_ms
    off_tile(f"sentinel D+1 {sent.data_padded.shape[2]}", qs, pl, sent.data_padded,
             sent.ids_padded, bq)
    del sent
    q256, c100k = queries[:256].contiguous(), corpus[:100_003].contiguous()
    times["K2 Q=256 N=100003"] = cs.time_ms(torch, lambda: cosine_topk_cuda(q256, c100k, 10))
    print("AB", tree, cs.card_line(), " | ".join(f"{k}: {v:.4f} ms" for k, v in times.items()),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
