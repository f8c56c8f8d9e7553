"""Times K7 (packed attention) of one source tree on the card at
chip_smoke.py's phase-8 shape: B 128 × S 128 × H 12 × D 32, bf16, lengths
16-128 drawn from a seed, q, k, v as views of a fused QKV. To compare two
commits on one card, unpack the other with ``git archive`` into a
git-ignored directory and run, from the repository root, in turns:

    python3 tools/packed_ab.py <other tree>
    python3 tools/packed_ab.py .
    python3 tools/packed_ab.py .
    python3 tools/packed_ab.py <other tree>

Each run builds that tree's kernels (into its own ``_build/``) and prints
one line ``AB <tree> <card> ...`` with K7's time a call: the median of
three rounds of 100 calls (CUDA events, after 10 warm-up calls), each
round beside a round of ``scaled_dot_product_attention`` with a boolean
key mask, as phase 8 times them; the device's time of each, 100 calls in
a CUDA graph (no host cost between launches: ``chip_smoke.graph_ms``);
the rounds, the bound (q read and o written in full, K and V for the
valid keys only, over 3.35 TB/s; 4·D operations a (query row, valid key)
pair over 989 TFLOP/s) and, on the same inputs, K7's max |Δ| against its
plain version. The timing helpers come from this checkout's
``chip_smoke.py``, the kernels from the tree named.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(tree: str) -> None:
    sys.path.insert(0, REPO)
    import chip_smoke as cs   # this checkout's timing and bounds, whatever the tree

    sys.path.insert(0, os.path.abspath(tree))   # the kernels of the tree under test
    import numpy as np
    import torch
    import torch.nn.functional as F

    from text_similarity_tpu_torch.ops.attention import packed_attention_cuda, packed_attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    b, s, h, d = 128, 128, 12, 32
    x = torch.randn(b, s, h, 3, d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
    lengths = torch.randint(16, s + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    key_ok = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rounds = [(cs.time_ms(torch, lambda: packed_attention_cuda(q, k, v, lengths), 100, 10),
               cs.time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                         attn_mask=key_ok),
                          100, 10))
              for _ in range(3)]
    ms, lib = (float(np.median(r)) for r in zip(*rounds))
    dev = cs.graph_ms(torch, lambda: packed_attention_cuda(q, k, v, lengths))
    lib_dev = cs.graph_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                         attn_mask=key_ok))
    err = float((packed_attention_cuda(q, k, v, lengths).float()
                 - packed_attention_plain(q, k, v, lengths).float()).abs().max())
    n_valid = float(lengths.sum())
    n_bytes = 2 * b * s * h * d * 2 + 2 * n_valid * h * d * 2 + b * 4
    b_ms, b_by = cs.bound_ms(n_bytes, 4.0 * d * h * s * n_valid, cs.PEAK_BF16)
    print("AB", tree, cs.card_line(),
          f"K7 B={b} S={s} H={h} D={d} bf16: call {ms:.4f} ms, device {dev:.4f} ms | "
          f"SDPA (bool key mask): call {lib:.4f} ms, device {lib_dev:.4f} ms | "
          f"bound {b_ms:.4f} ms ({b_by}) | max|Δ| vs plain {err:.2e} | rounds (K7, SDPA): "
          + ", ".join(f"({x:.4f}, {y:.4f})" for x, y in rounds), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
