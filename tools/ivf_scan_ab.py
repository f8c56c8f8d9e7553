"""Times K1 (k 10 and 100, deferred; exact), K4 and K2 of one source tree
on the card at chip_smoke.py's shapes (the 1M × 384 bench corpus, 4096
queries, the serving args; K2 at Q 256 × N 100,003). To compare two
commits on one card, unpack the other with ``git archive`` into a
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, REPO)
    import torch

    import chip_smoke as cs
    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index.ivf import (
        IVFIndex, _plan_probes, _round_up, ivf_scan_cuda,
    )
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    n, n_q = 1_000_000, 4096
    corpus, queries = cs.bench_corpus(torch, n, n_q)
    cfg = IndexConfig.auto(n)
    times = {}
    for int8 in (False, True):
        ivf = IVFIndex.build(
            corpus, dataclasses.replace(cfg, quantize_int8=int8), data_dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
        )
        union = min(_round_up(min(cfg.num_probes, ivf.num_base_clusters), 8), ivf.num_base_clusters)
        qs, pl, _ = _plan_probes(queries, ivf.centroids, ivf.num_base_clusters,
                                 ivf.data_padded.shape[0], 64, union)
        mc = ivf.data_padded.shape[1]
        runs = ((20, mc, 2),) if int8 else ((10, mc, 1), (100, mc, 2), (10, 0, 1))
        for k, w, s in runs:
            times[f"{'K4' if int8 else 'K1'} k={k} w={w} S={s}"] = cs.time_ms(
                torch, lambda: ivf_scan_cuda(qs, pl, ivf.data_padded, ivf.ids_padded, k, 64, w, s,
                                             ivf.scales_padded),
                iters=10, warmup=2)
        del ivf
    q256, c100k = queries[:256].contiguous(), corpus[:100_003].contiguous()
    times["K2 Q=256 N=100003"] = cs.time_ms(torch, lambda: cosine_topk_cuda(q256, c100k, 10))
    print("AB", tree, cs.card_line(), " | ".join(f"{k}: {v:.3f} ms" for k, v in times.items()),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
