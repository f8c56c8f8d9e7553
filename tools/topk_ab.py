"""Times the exact top-k kernels of one source tree on the card at
chip_smoke.py's phase-2 shapes (N 100,003 × D 384, k 10, the corpus with
copied rows): K2 at Q 1, 8, 64 and 256 (f32) and at Q 256 over a bf16
corpus, K3 at Q 1, 8, 64 and 256 (int8 corpus), K8's fold and count at Q 256 alone
(and, where the tree has them, the fold keeping its scores and the count
over them), both passes with the certification as the call runs them, and
the call ``cosine_topk_2pass`` (which falls back to K2 at Q 256). To
compare two commits on one card, unpack the other with ``git archive``
into a git-ignored directory and run, from the repository root, in turns:

    python3 tools/topk_ab.py <other tree>
    python3 tools/topk_ab.py .
    python3 tools/topk_ab.py .
    python3 tools/topk_ab.py <other tree>

Each run builds that tree's kernels (into its own ``_build/``) and prints
one line ``AB <tree> <card> ...`` with the mean time of a call over 50
calls (CUDA events, after 5 warm-up calls), and one line ``DEV`` with the
device's time of a K2 and a K3 call, 100 calls in a CUDA graph (no host
cost between launches: ``chip_smoke.graph_ms``); with ``--library`` it
also prints lines ``LIB`` and ``LIBDEV`` with ``torch.topk(q @ cᵀ)``
(``torch.topk((q @ c.float()ᵀ) · s)`` for K3) at each shape, timed both
ways, and each shape's bound: the larger of its bytes (inputs read once,
outputs written once) over 3.35 TB/s and its f32 operations (2·Q·N·D)
over 67 TFLOP/s. The timing helpers come from this checkout's
``chip_smoke.py``, the kernels from the tree named.

With ``--large-k`` it times the large-k route instead (k above the
selectors' 256, ``csrc/topk_select.cu``) at Q 1, 8, 64 and 256 × k 300,
1000 and 4096 on the same corpus: the select alone over the (Q, N) f32
scores (``topk_select_cuda``), K2 over the f32 and the bf16 corpus, K3
over the int8 corpus, then K1 and K4 exact at k 300 for 256 of the 1M
bench queries on ``tools/ivf_scan_ab.py``'s cached index (the scan, and
the select alone over its (U, B, Mc) candidates). It prints ``AB-LARGE``
(calls between CUDA events, 20 after 3 warm-up calls) and ``DEV-LARGE``
(the brute-force calls in a CUDA graph); with ``--library`` also
``LIB-LARGE`` and ``LIBDEV-LARGE`` (``torch.topk(q @ cᵀ, k)``, K3's
``torch.topk((q @ c.float()ᵀ) · s, k)``) and ``BOUND-LARGE``: the select's
bytes (the scores read once, the answer written once) and the route's,
the larger of its bytes (inputs, the (Q, N) scores written and read, the
answer) and its f32 operations, as ``chip_smoke.py`` phase 2 bounds it.
"""

import dataclasses
import os
import sys

LARGE_QS = (1, 8, 64, 256)
LARGE_KS = (300, 1000, 4096)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(tree: str, library: bool) -> None:
    sys.path.insert(0, REPO)
    import chip_smoke as cs   # this checkout's timing and bounds, whatever the tree

    sys.path.insert(0, os.path.abspath(tree))   # the kernels of the tree under test
    import torch

    from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
    from text_similarity_tpu_torch.ops import topk

    torch.backends.cuda.matmul.allow_tf32 = False
    corpus, queries = cs.topk_inputs(torch)
    n, d = corpus.shape
    corpus_bf16 = corpus.to(torch.bfloat16)
    codes, scales = quantize_embeddings_int8(corpus)
    k = 10

    def t(fn):
        return cs.time_ms(torch, fn, iters=50, warmup=5)

    graphed = {}   # key → the call again, for the device time of a CUDA graph of it

    def passes(q):
        # the call's own two passes where the tree has them (pass B over the
        # kept scores), else the fold and the tile's count
        if hasattr(topk, "_passes_cuda"):
            out_s, _, thr, cnt = topk._passes_cuda(q, corpus, k, 2048)
        else:
            out_s, _ = topk.topk_2pass_fold_cuda(q, corpus, k)
            thr = out_s[:, k - 1].clone()
            cnt = topk.topk_2pass_count_cuda(q, corpus, thr)
        return bool((cnt == (out_s > thr[:, None]).sum(dim=1, dtype=torch.int32)).all())

    q = queries.contiguous()
    thr = topk.topk_2pass_fold_cuda(q, corpus, k)[0][:, k - 1].clone()
    times, lib, bounds = {}, {}, {}
    for q_n in (1, 8, 64, 256):
        qq = queries[:q_n].contiguous()
        times[f"K2 Q={q_n}"] = t(lambda: topk.cosine_topk_cuda(qq, corpus, k))
        graphed[f"K2 Q={q_n}"] = lambda qq=qq: topk.cosine_topk_cuda(qq, corpus, k)
        lib[f"K2 Q={q_n}"] = lambda qq=qq: torch.topk(qq @ corpus.T, k, dim=1)
        bounds[f"K2 Q={q_n}"] = cs.bound_ms(q_n * d * 4 + n * d * 4 + q_n * k * 8,
                                            2.0 * q_n * n * d, cs.PEAK_F32)
    times["K2 bf16 Q=256"] = t(lambda: topk.cosine_topk_cuda(q, corpus_bf16, k))
    lib["K2 bf16 Q=256"] = lambda: torch.topk(q.to(torch.bfloat16).float() @ corpus_bf16.float().T,
                                              k, dim=1)
    bounds["K2 bf16 Q=256"] = cs.bound_ms(256 * d * 4 + n * d * 2 + 256 * k * 8,
                                          2.0 * 256 * n * d, cs.PEAK_F32)
    for q_n in (1, 8, 64, 256):
        qq = queries[:q_n].contiguous()
        times[f"K3 Q={q_n}"] = t(lambda: topk.cosine_topk_int8_cuda(qq, codes, scales, k))
        graphed[f"K3 Q={q_n}"] = lambda qq=qq: topk.cosine_topk_int8_cuda(qq, codes, scales, k)
        lib[f"K3 Q={q_n}"] = lambda qq=qq: torch.topk((qq @ codes.float().T) * scales, k, dim=1)
        bounds[f"K3 Q={q_n}"] = cs.bound_ms(q_n * d * 4 + n * d + n * 4 + q_n * k * 8,
                                            2.0 * q_n * n * d, cs.PEAK_F32)
    times["K8 fold Q=256"] = t(lambda: topk.topk_2pass_fold_cuda(q, corpus, k))
    times["K8 count Q=256"] = t(lambda: topk.topk_2pass_count_cuda(q, corpus, thr))
    if hasattr(topk, "_fold_cuda"):
        _, _, kept = topk._fold_cuda(q, corpus, k, 2048, True)
        times["K8 fold keeping scores Q=256"] = t(
            lambda: topk._fold_cuda(q, corpus, k, 2048, True))
        times["K8 count over scores Q=256"] = t(
            lambda: topk.topk_2pass_count_cuda(q, corpus, thr, scores=kept))
        bounds["K8 count over scores Q=256"] = cs.bound_ms(256 * n * 4 + 256 * 8, 256 * n,
                                                           cs.PEAK_F32)
    times["K8 passes+cert Q=256"] = t(lambda: passes(q))
    times["K8 call Q=256"] = t(lambda: topk.cosine_topk_2pass(q, corpus, k))
    ops = 2.0 * 256 * n * d
    bounds["K8 fold Q=256"] = cs.bound_ms(256 * d * 4 + n * d * 4 + 256 * k * 8, ops, cs.PEAK_F32)
    bounds["K8 count Q=256"] = cs.bound_ms(256 * d * 4 + n * d * 4 + 256 * 8, ops, cs.PEAK_F32)
    card = cs.card_line()
    print("AB", tree, card, " | ".join(f"{key}: {v:.4f} ms" for key, v in times.items()),
          flush=True)
    print("DEV", tree, card, " | ".join(
        f"{key}: {cs.graph_ms(torch, fn):.4f} ms" for key, fn in graphed.items()), flush=True)
    if library:
        print("LIB", card, " | ".join(
            f"{key}: {t(fn):.4f} ms" for key, fn in lib.items()), flush=True)
        print("LIBDEV", card, " | ".join(
            f"{key}: {cs.graph_ms(torch, fn):.4f} ms" for key, fn in lib.items()), flush=True)
        print("BOUND", " | ".join(
            f"{key}: {b:.4f} ms ({by})" for key, (b, by) in bounds.items()), flush=True)


def main_large_k(tree: str, library: bool) -> None:
    sys.path.insert(0, REPO)
    sys.path.insert(1, os.path.join(REPO, "tools"))
    import chip_smoke as cs
    import ivf_scan_ab   # the 1M index every tree scans

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index import ivf_modes
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.ops import topk

    torch.backends.cuda.matmul.allow_tf32 = False
    corpus, queries = cs.topk_inputs(torch)
    n, d = corpus.shape
    corpus_bf16 = corpus.to(torch.bfloat16)
    codes, scales = quantize_embeddings_int8(corpus)
    times, graphed, lib, bounds = {}, {}, {}, {}

    def t(fn):
        return cs.time_ms(torch, fn, iters=20, warmup=3)

    for q_n in LARGE_QS:
        qq = queries[:q_n].contiguous()
        scores = qq @ corpus.T
        for k in LARGE_KS:
            calls = {
                f"select Q={q_n} k={k}": lambda k=k, s=scores: topk.topk_select_cuda(s, k),
                f"K2 f32 Q={q_n} k={k}": lambda k=k, qq=qq: topk.cosine_topk_cuda(qq, corpus, k),
                f"K2 bf16 Q={q_n} k={k}": lambda k=k, qq=qq: topk.cosine_topk_cuda(
                    qq, corpus_bf16, k),
                f"K3 Q={q_n} k={k}": lambda k=k, qq=qq: topk.cosine_topk_int8_cuda(
                    qq, codes, scales, k),
            }
            for key, fn in calls.items():
                times[key] = t(fn)
                graphed[key] = fn
            lib[f"torch.topk f32 Q={q_n} k={k}"] = lambda k=k, qq=qq: torch.topk(
                qq @ corpus.T, k, dim=1)
            lib[f"torch.topk int8 Q={q_n} k={k}"] = lambda k=k, qq=qq: torch.topk(
                (qq @ codes.float().T) * scales, k, dim=1)
            answer = q_n * k * 8
            bounds[f"select Q={q_n} k={k}"] = cs.bound_ms(q_n * n * 4 + answer, 0.0, cs.PEAK_F32)
            routes = (("K2 f32", n * d * 4), ("K2 bf16", n * d * 2), ("K3", n * d + n * 4))
            for name, c_bytes in routes:
                bounds[f"{name} Q={q_n} k={k}"] = cs.bound_ms(
                    q_n * d * 4 + c_bytes + 2 * q_n * n * 4 + answer, 2.0 * q_n * n * d,
                    cs.PEAK_F32)
        del scores

    # K1 / K4 exact at k 300: 256 of the 1M bench queries, the serving plan
    big, big_q = cs.bench_corpus(torch, 1_000_000, 4096)
    big_q = big_q[:256].contiguous()
    cfg = IndexConfig.auto(big.shape[0])
    for int8 in (False, True):
        ivf = ivf_scan_ab.same_index(torch, f"1m_{'int8' if int8 else 'bf16'}", big,
                                     dataclasses.replace(cfg, quantize_int8=int8))
        qs, pl, _, bq = cs.serving_plan(ivf, big_q)
        name = "K4" if int8 else "K1"
        args = (qs, pl, ivf.data_padded, ivf.ids_padded, 300, bq, 0, 1)
        times[f"{name} exact k=300 B=256"] = cs.time_ms(
            torch, lambda: ivf_scan_cuda(*args, scales=ivf.scales_padded), iters=10, warmup=2)
        s, i = ivf_modes._per_probe_scores(qs, pl, ivf.data_padded, ivf.ids_padded, bq,
                                           ivf.scales_padded)
        times[f"{name} exact k=300 B=256: its select alone"] = t(
            lambda: topk.topk_select_cuda(s, 300, i, segments=True))
        bounds[f"{name} exact k=300 B=256: its select alone"] = cs.bound_ms(
            s.numel() * 8 + 256 * 300 * 8, 0.0, cs.PEAK_F32)
        del ivf, s, i

    card = cs.card_line()
    print("AB-LARGE", tree, card, " | ".join(f"{key}: {v:.4f} ms" for key, v in times.items()),
          flush=True)
    print("DEV-LARGE", tree, card, " | ".join(
        f"{key}: {cs.graph_ms(torch, fn):.4f} ms" for key, fn in graphed.items()), flush=True)
    if library:
        print("LIB-LARGE", card, " | ".join(
            f"{key}: {t(fn):.4f} ms" for key, fn in lib.items()), flush=True)
        print("LIBDEV-LARGE", card, " | ".join(
            f"{key}: {cs.graph_ms(torch, fn):.4f} ms" for key, fn in lib.items()), flush=True)
        print("BOUND-LARGE", " | ".join(
            f"{key}: {b:.4f} ms ({by})" for key, (b, by) in bounds.items()), flush=True)


if __name__ == "__main__":
    flags = {"--library", "--large-k"}
    args = [a for a in sys.argv[1:] if a not in flags]
    run = main_large_k if "--large-k" in sys.argv[1:] else main
    run(args[0] if args else ".", "--library" in sys.argv[1:])
