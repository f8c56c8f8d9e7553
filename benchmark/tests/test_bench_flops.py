"""The roofline and MFU arithmetic against hand counts and the kernel
table's bounds (K5 at 8 × 4096, window 256 + CLS: 0.0601 ms; K6 at 4 ×
4096: 0.0635 ms)."""

import numpy as np
import pytest
import torch

from benchmark import flops, readlib, weights
from benchmark.cells import Window
from benchmark.trace import Reading


def brute_pairs(n, window, cls):
    total = 0
    for i in range(n):
        for j in range(n):
            if window <= 0 or abs(i - j) <= window or (cls and (i == 0 or j == 0)):
                total += 1
    return total


@pytest.mark.parametrize("n,window,cls", [(1, 4, True), (9, 0, False), (40, 4, True),
                                          (40, 4, False), (7, 16, True)])
def test_band_pairs_by_hand(n, window, cls):
    assert flops.band_pairs([n], window, cls) == brute_pairs(n, window, cls)


def test_k5_bound_at_the_table_shape():
    n_bytes, ops = flops.flash_fwd(8, 4096, 12, 64, [4096] * 8, 256, True)
    assert n_bytes == pytest.approx(0.2013e9, rel=1e-3)
    assert flops.bound_s(n_bytes, ops) * 1e3 == pytest.approx(0.0601, abs=5e-5)


def test_k6_bound_at_the_table_shape():
    n_bytes, ops = flops.flash_bwd(4, 4096, 12, 64, [4096] * 4, 256, True)
    assert ops == pytest.approx(62.8e9, rel=2e-3)
    assert flops.bound_s(n_bytes, ops) * 1e3 == pytest.approx(0.0635, abs=5e-5)


def test_ivf_scan_counts_each_slab_once():
    valid = torch.tensor([10, 0, 5, 7])
    probes = torch.tensor([[0, 2], [2, 3]])           # two blocks; slab 2 twice
    n_bytes, ops = flops.ivf_scan(probes, valid, mc=16, d=4, row_bytes=8, n_q=3, k=2, block_q=2)
    assert n_bytes == (10 + 5 + 7) * 8 + 3 * 16 * 4 + 3 * 4 * 4 + 3 * 2 * 8
    assert ops == 2 * 2 * 4 * (10 + 5 + 5 + 7)


def test_plan_probes_matches_the_rule():
    g = torch.Generator().manual_seed(0)
    cent = torch.nn.functional.normalize(torch.randn(12, 8, generator=g), dim=1)
    q = torch.randn(8, 8, generator=g)
    pr = flops.plan_probes(q, cent, num_base=12, c_tot=14, block_q=4, union=3)
    assert pr.shape == (2, 5)                         # 2 blocks; 3 + 2 overflow slabs
    assert pr[:, 3:].tolist() == [[12, 13], [12, 13]]
    qn = torch.nn.functional.normalize(q, dim=1)
    s = qn @ cent.T
    order = torch.argsort(s.argmax(1), stable=True)
    first = s[order[:4]].amax(0)
    assert set(pr[0, :3].tolist()) == set(torch.topk(first, 3).indices.tolist())


def test_encoder_flops():
    a = {"vocab_size": 10, "hidden_size": 4, "num_layers": 2, "intermediate_size": 8,
         "max_position": 6, "type_vocab_size": 1}
    non_emb = weights.non_embedding_params(a)
    assert non_emb == 2 * (4 * (16 + 4) + 2 * 4 + 32 + 8 + 32 + 4 + 2 * 4)
    got = flops.encoder_flops(non_emb, [3, 5], layers=2, hidden=4)
    assert got == 2 * non_emb * 8 + 4 * 4 * 2 * (9 + 25)


def _reading(kernels, host=()):
    events = [{"cat": "kernel", "name": n, "ts": t, "dur": d} for n, t, d in kernels]
    events += [{"cat": "user_annotation", "name": n, "ts": t, "dur": d} for n, t, d in host]
    return Reading(events, wall_s=1.0, units=2)


def test_busy_is_the_union_of_intervals():
    r = _reading([("a", 0, 10), ("b", 5, 10), ("c", 30, 5)])
    assert r.busy_s() == pytest.approx(20e-6)
    gaps = r.idle_gaps()
    assert gaps and gaps[0][1] == pytest.approx(15e-6)


def test_readers_on_a_made_up_trace():
    r = _reading([("void flash_fwd_bf16<64>(FwdMaps, FlashArgs)", 0, 100),
                  ("elementwise", 100, 100)])
    win = Window()
    win.latencies, win.work, win.wall_s = [0.25, 0.25], [1.0, 1.0], 0.5
    work = [(3.35e12 * 50e-6, 0.0)]                     # 50 µs of bytes
    ctx = {"reading": r, "window": win, "flash_fwd_work": work,
           "flash_fwd_kernels": ("flash_fwd_bf16",), "useful_flops": 989e12 * 0.5 * 0.1}
    assert readlib.roofline_pct(ctx, "flash_fwd_work", "flash_fwd_kernels") == pytest.approx(50.0)
    assert readlib.mfu_pct(ctx) == pytest.approx(10.0)
    # busy 200 µs over 2 units against a wall of 0.25 s a unit
    assert readlib.idle_pct(ctx) == pytest.approx(100 * (1 - 100e-6 / 0.25))
    ctx["flash_fwd_kernels"] = ("no_such_kernel",)
    assert readlib.roofline_pct(ctx, "flash_fwd_work", "flash_fwd_kernels") is None


def test_absent_trace_reads_nothing():
    assert readlib.idle_pct({}) is None
    assert readlib.mfu_pct({}) is None
    empty = Reading([], wall_s=1.0, units=3)
    win = Window()
    win.latencies, win.work, win.wall_s = [1.0], [1.0], 1.0
    assert readlib.idle_pct({"reading": empty, "window": win}) is None
    assert np.isfinite(flops.bound_s(1.0, 1.0))
