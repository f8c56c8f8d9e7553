"""Times K5 (flash forward) and K6 (flash backward: dq, then dk/dv) of one
source tree on the card at chip_smoke.py's shapes: bf16, K5 at B 8 and K6
at B 4, × S 4096 × H 12 × D 64, full lengths, q, k, v as views of a fused
QKV, at window 256 + global CLS and at window 0. To compare two commits on
one card, unpack the other with ``git archive`` into a git-ignored
directory and run, from the repository root, in turns:

    python3 tools/flash_ab.py <other tree>
    python3 tools/flash_ab.py .
    python3 tools/flash_ab.py .
    python3 tools/flash_ab.py <other tree>

Each run builds that tree's kernels (into its own ``_build/``) and prints
one line ``AB <tree> <card> ...`` with the mean time of a launch over 50
launches (CUDA events, after 5 warm-up launches).
"""

import os
import subprocess
import sys


def time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from text_similarity_tpu_torch.ops.attention import (
        flash_attention_backward_cuda, flash_attention_cuda,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    s, h, d = 4096, 12, 64
    times = {}
    for b, kernel in ((8, "K5"), (4, "K6")):
        x = torch.randn(b, s, h, 3, d, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        do = torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
        for window, cls in ((256, True), (0, False)):
            if kernel == "K5":
                fn = lambda: flash_attention_cuda(q, k, v, lengths, window, cls)  # noqa: E731
            else:
                out, lse = flash_attention_cuda(q, k, v, lengths, window, cls, return_lse=True)
                args = (q, k, v, lengths, out, lse, do, window, cls)
                fn = lambda: flash_attention_backward_cuda(*args)  # noqa: E731
            times[f"{kernel} B={b} window={window}{' cls' if cls else ''}"] = time_ms(torch, fn)
    print("AB", tree, card, " | ".join(f"{k}: {v:.4f} ms" for k, v in times.items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
