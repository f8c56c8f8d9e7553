"""Splits the large-k route's device time by kernel on the card: the select
kernel alone (``topk_select_cuda`` over (Q, N) f32 scores) and K2's route
(``cosine_topk_cuda`` above k 256: the score writer, then the select
without its count), at Q 1, 64 and 256 × k 300 and 4096 on chip_smoke.py's
phase-2 corpus (N 100,003 × D 384). For each it runs ten calls under
``torch.profiler`` (CUDA activity, after three warm-up calls) and prints
one line: the device µs a call of each kernel (``hist_rows``,
``refine_rows``, ``compact_rows``, ``finish_rows``, ``sort_runs``,
``merge_pass``, ``score_rows``) and of the workspace's zeroing
(``Memset``), largest first. Run it from the repository root, optionally
naming another tree whose kernels to profile:

    python3 tools/topk_profile.py [tree]

The corpus comes from this checkout's ``chip_smoke.py``; the kernels from
the tree named (default: this checkout).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("hist_rows", "refine_rows", "compact_rows", "finish_rows", "sort_runs", "merge_pass",
           "score_rows", "Memset")


def main(tree: str) -> None:
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from text_similarity_tpu_torch.ops import _cuda, topk

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()
    card = cs.card_line()
    corpus, queries = cs.topk_inputs(torch)
    for q_n in (1, 64, 256):
        qq = queries[:q_n].contiguous()
        scores = qq @ corpus.T
        for k in (300, 4096):
            calls = (("select", lambda: topk.topk_select_cuda(scores, k)),
                     ("K2 f32", lambda: topk.cosine_topk_cuda(qq, corpus, k)))
            for name, fn in calls:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
                us = {}
                for ev in prof.key_averages():
                    t = getattr(ev, "self_device_time_total", None)
                    if t is None:
                        t = ev.self_cuda_time_total
                    kernel = next((w for w in KERNELS if w in ev.key), None)
                    if kernel and t > 0:
                        us[kernel] = us.get(kernel, 0.0) + t / 10
                print(f"PROFILE {tree} [{card}] {name} Q={q_n} k={k}: " + ", ".join(
                    f"{kern} {t:.1f}" for kern, t in sorted(us.items(), key=lambda x: -x[1])),
                    flush=True)
        del scores


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
