#!/usr/bin/env python3
"""Run the PyTorch port's semantic-search and long-document paths on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. the card: ``nvidia-smi`` name and power limit; build the CUDA kernels
    from ``text_similarity_tpu_torch/csrc`` (nvcc, sm_90a; one process per
    source, started together).
 2. K2 (exact cosine top-k) against its plain version at N = 100,003 ragged,
    D = 384, Q ∈ {1, 7, 256}, k ∈ {10, 20}, f32 and bf16 corpora with
    duplicated rows.
 3. K1 (IVF scan) against its plain version on a 1M × 384 IVF index built
    on the card from the bench recipe (4096 gaussian centres ×3 + unit
    noise; queries = corpus rows + 0.1 noise), bf16 slabs,
    ``IndexConfig.auto(1M)``, 4096 queries with the serving args at k = 10
    and k = 100 (deferred merge) and approx_width = 0 (exact merge); IVF
    recall@10 against K2's exact top-k over the f32 corpus ≥ 0.95.
 4. The pipeline at the full width of minilm-l6 (random weights from a
    seed, vocab trained on a synthetic corpus): 120,000 documents (the IVF
    path, K1) and 2,000 documents (the brute-force path, K2), requests of 1,
    5 and 64 verbatim corpus sentences; each must find itself in its top 10
    at score ≥ 0.99 (≥ 95% of queries; on a multi-query IVF request, of
    the queries whose own slab was in their block's shared probe list).
    Both kernels' launch counters must rise during this phase, and each
    kernel must agree with its plain version at the pipeline's shapes.
 5. int8 serving:
    - K3 (int8 top-k) against its plain version at N = 100,003 ragged,
      D = 384, Q ∈ {1, 7, 256}, k ∈ {10, 20}, duplicated rows; timed at
      Q = 256, k = 10 beside ``torch.topk((q @ c.float().T) * s, k)``;
    - K4 (int8 IVF scan) against its plain version on an int8 index of the
      phase-3 corpus (``IndexConfig.auto(1M)``, ``quantize_int8=True``, bf16
      rescore copy), 4096 queries with the serving args: k = 10 raw, the
      rescore's k_scan = 20 (deferred, S = 2) and the exact merge; recall@10
      of int8 + rescore against K2's exact top-10 ≥ 0.95 (raw int8
      recall and both QPS printed);
    - the int8 pipeline: the phase-4 minilm-l6 weights through ``to_int8``,
      the 120,000 documents with an int8 IVF (``IndexConfig.auto`` with
      ``quantize_int8=True``), requests of 1, 5 and 64 under phase 4's
      self-retrieval gate, one ``add_documents`` (the new document finds
      itself) and one ``remove_documents`` (the removed id never comes
      back) on the built index, one ``BruteForceIndex`` query over an
      ``EmbeddingStore(quantized=True)`` of 2,000 of those embeddings. The
      K3 and K4 launch counters, zeroed just before, must rise. Printed:
      the mean cosine between the int8 and the bf16 encoder's embeddings of
      64 texts and the int8 encoder's sentences/s.
 6. long documents:
    - K5 (flash attention forward) against its plain version at the
      shapes the long encodes below give it, B 8 × S 4096 × H 12 with D 64
      (roberta-base-long) and D 32 (minilm-l6), lengths 3001-4096, and at
      B 3 × S 512 × D 32 with a zero-length row; f32 and bf16; window 0,
      256 and 256 + global CLS;
      q, k, v as views of a fused QKV; outputs on valid rows (f32 max |Δ| ≤
      1e-4; bf16 max ≤ 1e-2, mean ≤ 5e-4), lse (≤ 1e-4), zero-length rows
      exactly 0. Timed at the serving shape (B 8, S 4096, H 12, D 64, bf16;
      window 256 + global CLS, and window 0) beside the plain version and
      ``scaled_dot_product_attention`` with the equivalent boolean mask;
    - roberta-base converted for long documents (random weights from a
      seed, positions tiled to 4098, window 256, global CLS, bf16) encodes
      128 documents joined from the phase-4 sentences (112 of 3000-4040
      tokens, 16 of 600-980) with ``encode(max_len=4096, buckets=… 1024,
      2048, 4096, batch_size=8)`` into an ``EmbeddingStore`` searched by
      ``BruteForceIndex`` (K2). Gates: K5's launches in that encode = 12 ×
      the batches at bucket 4096, and K2, zeroed with it, launches in the
      search; 16 documents queried with their own text
      find themselves in the top 10 at score ≥ 0.99 (≥ 95%); one batch of 8
      documents through ``encoder_forward`` with ``attention_impl="auto"``
      (K5) and ``"reference"`` on the card: last_hidden_state on valid rows
      within ``AGREE_MEAN`` / ``AGREE_MAX``, pooled cosine ≥ 0.99, and
      another document's rows at least 10 × ``AGREE_MEAN`` away (so the
      gate can tell documents apart). Printed: docs/s, tokens/s and a
      ``torch.profiler`` split of one 8 × 4096 encode (K5, GEMMs, the rest,
      the device's idle share);
    - window 0 on the path: minilm-l6 with positions tiled to 4096 encodes
      16 long documents (K5 launches = 6 × batches at 4096; the same
      agreement gate against its reference path).
 7. One JSON line ``{"kernels": [...]}`` for K1-K5: launches in the
    pipeline window of their phase (4, 5 or 6), time, plain time, bound and
    library time at the phase-2/3/5/6 shapes.
 8. The card again, then ``{"ok": true, "device": {...}}`` as the last line.

Every time is measured here, on this card, with CUDA events (kernels) or
the host clock around synchronised work (pipeline). f32 matmuls run
without TF32 (``allow_tf32 = False``): the plain versions are exact f32.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_BYTES = 3.35e12        # HBM3 bytes/s
PEAK_F32 = 67e12            # f32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12          # bf16 tensor-core FLOP/s


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def overlap(a, b) -> float:
    return float(np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)]))


def separated_ids_equal(ki, ri, rs, tol=1e-5) -> bool:
    """ids equal at every rank whose reference score differs from both
    neighbours by more than tol (near-ties may swap under another
    summation order)."""
    gap = np.minimum(
        np.abs(np.diff(rs, axis=1, prepend=np.inf)),
        np.abs(np.diff(rs, axis=1, append=-np.inf)),
    )
    sep = gap > tol
    return bool(np.array_equal(ki[sep], ri[sep]))


# ---------------------------------------------------------------------------
# Phase 2: K2
# ---------------------------------------------------------------------------

def phase_topk(torch, card):
    from text_similarity_tpu_torch.ops.topk import (
        cosine_topk_cuda, cosine_topk_reference, l2_normalize,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    n, d = 100_003, 384
    corpus = l2_normalize(torch.randn(n, d, generator=g, device=dev))
    src = torch.randperm(n // 2, generator=g, device=dev)[:256]
    dst = n // 2 + torch.randperm(n - n // 2, generator=g, device=dev)[:512]
    corpus[dst[:256]] = corpus[src]
    corpus[dst[256:]] = corpus[src]       # three copies: exact ties
    queries = l2_normalize(corpus[src] + 0.05 * torch.randn(256, d, generator=g, device=dev))
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        c = corpus.to(dtype).contiguous()
        for q_n in (1, 7, 256):
            q = queries[:q_n].contiguous()
            for k in (10, 20):
                ks, ki = cosine_topk_cuda(q, c, k)
                rs, ri = cosine_topk_reference(q, c, k)
                torch.cuda.synchronize()
                ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
                err = float(np.abs(ks - rs).max())
                worst = max(worst, err)
                if dtype == torch.float32:
                    ok = err <= 1e-5 and separated_ids_equal(ki, ri, rs)
                    detail = f"ids equal {np.mean(ki == ri):.4f}"
                else:
                    ov = overlap(ki, ri)
                    ok = err <= 1e-4 and ov >= 0.99
                    detail = f"overlap {ov:.4f}"
                log(f"K2 {str(dtype)[6:]} Q={q_n} k={k}: max|Δscore| {err:.2e}, {detail}"
                    f" -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K2 disagrees with its plain version")
    # timing at the main shape: f32 corpus (the pipeline's store), Q=256, k=10
    q, k = queries.contiguous(), 10
    ms = time_ms(torch, lambda: cosine_topk_cuda(q, corpus, k))
    plain = time_ms(torch, lambda: cosine_topk_reference(q, corpus, k), iters=3, warmup=1)
    lib = time_ms(torch, lambda: torch.topk(q @ corpus.T, k, dim=1))
    qn = q.shape[0]
    b_ms, b_by = bound_ms(qn * d * 4 + n * d * 4 + qn * k * 8, 2.0 * qn * n * d, PEAK_F32)
    corpus_bf16 = corpus.to(torch.bfloat16)
    ms_bf16 = time_ms(torch, lambda: cosine_topk_cuda(q, corpus_bf16, k))
    ms_q1 = time_ms(torch, lambda: cosine_topk_cuda(q[:1], corpus, k))
    log(f"K2 times [{card}]: f32 Q=256 k=10 kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"torch.topk(q@cT) {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"bf16 corpus {ms_bf16:.3f} ms; Q=1 {ms_q1:.3f} ms")
    return {
        "name": "cosine_topk", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/topk.cu",
        "replaces": "text_similarity_tpu/ops/topk.py:307",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"Q=256 N={n} D={d} k=10 f32",
    }


# ---------------------------------------------------------------------------
# Phase 3: K1
# ---------------------------------------------------------------------------

def bench_corpus(torch, n, n_q, d=384, seed=0):
    """bench.py's recipe with torch: 4096 gaussian centres ×3 + unit noise;
    queries are corpus rows + 0.1 noise."""
    from text_similarity_tpu_torch.ops.topk import l2_normalize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(4096, d, generator=g, device=dev)
    assign = torch.randint(0, 4096, (n,), generator=g, device=dev)
    corpus = torch.empty((n, d), device=dev)
    for i in range(0, n, 1 << 18):
        j = min(i + (1 << 18), n)
        corpus[i:j] = l2_normalize(
            centers[assign[i:j]] * 3.0 + torch.randn(j - i, d, generator=g, device=dev)
        )
    queries = l2_normalize(corpus[:n_q] + 0.1 * torch.randn(n_q, d, generator=g, device=dev))
    return corpus, queries


def serving_plan(ivf, queries):
    """The probe plan ``IVFIndex.query`` makes with the pipeline's serving
    args (block_q 64, union_factor 1) → (sorted queries, probe list, order,
    block_q): the inputs K1 gets on the main path."""
    from text_similarity_tpu_torch.index.ivf import _plan_probes, _round_up

    block_q = min(64, queries.shape[0])
    probes = min(ivf.config.num_probes, ivf.num_base_clusters)
    union = min(_round_up(probes, 8), ivf.num_base_clusters)
    q_s, probe_list, order = _plan_probes(
        queries, ivf.centroids, ivf.num_base_clusters, ivf.data_padded.shape[0], block_q, union
    )
    return q_s, probe_list, order, block_q


def phase_ivf(torch, card):
    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index.ivf import IVFIndex, ivf_scan_cuda, ivf_scan_reference
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    n, n_q, d = 1_000_000, 4096, 384
    corpus, queries = bench_corpus(torch, n, n_q, d)
    cfg = IndexConfig.auto(n)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf = IVFIndex.build(
        corpus, cfg, data_dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    torch.cuda.synchronize()
    build_s = time.time() - t0
    mc = ivf.data_padded.shape[1]
    log(f"IVF build [{card}]: {build_s:.2f} s for {n}x{d}, C={ivf.num_base_clusters} "
        f"(+{ivf.num_overflow} overflow), Mc={mc}, probes={cfg.num_probes}")

    q_s, probes, _, block_q = serving_plan(ivf, queries)
    worst, main = 0.0, None
    for k, aw in ((10, 2048), (100, 2048), (10, 0)):
        w, slots = ivf.scan_mode(k, aw, 0)
        mode = f"deferred w={w} S={slots}" if w else "exact"
        args = (q_s, probes, ivf.data_padded, ivf.ids_padded, k, block_q, w, slots)
        ks, ki = ivf_scan_cuda(*args)
        rs, ri = ivf_scan_reference(*args)
        torch.cuda.synchronize()
        ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
        err = float(np.abs(ks - rs).max())
        worst = max(worst, err)
        ov = overlap(ki, ri)
        ok = ov >= 0.99 and err <= 1e-4
        ms = time_ms(torch, lambda: ivf_scan_cuda(*args), iters=5, warmup=1)
        log(f"K1 Mc={mc} k={k} mode {mode}: overlap {ov:.4f}, max|Δscore| {err:.2e}, "
            f"kernel {ms:.3f} ms [{card}] -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K1 disagrees with its plain version")
        if k == 10 and w:
            plain = time_ms(torch, lambda: ivf_scan_reference(*args), iters=1, warmup=1)
            main = (args, ms, plain, mode)
    if main is None:
        raise AssertionError("the deferred merge did not run at Mc >= 1024")

    # recall@10 of the serving query against the exact top-10 (K2, f32)
    _, exact = cosine_topk_cuda(queries, corpus, 10)
    _, got = ivf.query(queries, k=10, block_q=64, union_factor=1, approx_width=2048)
    recall = overlap(got.cpu().numpy(), exact.cpu().numpy())
    t_q = time_ms(torch, lambda: ivf.query(queries, k=10, block_q=64, union_factor=1,
                                           approx_width=2048), iters=3, warmup=1)
    log(f"IVF recall@10 vs exact: {recall:.4f} (gate 0.95); query 4096 @k=10 "
        f"{t_q:.2f} ms = {n_q / t_q * 1e3:.0f} QPS [{card}]")
    if recall < 0.95:
        raise AssertionError("IVF recall@10 below 0.95")

    args, ms, plain, mode = main
    slabs = torch.unique(args[1])
    valid = (ivf.ids_padded >= 0).sum(dim=1)
    n_bytes = int(valid[slabs].sum()) * d * 2 + slabs.numel() * mc * 4 + n_q * d * 4 + n_q * 10 * 8
    per_block = valid[args[1].long()].sum(dim=1)          # valid slots scanned per block
    ops = 2.0 * block_q * d * float(per_block.sum())
    b_ms, b_by = bound_ms(n_bytes, ops, PEAK_BF16)
    log(f"K1 bound [{card}]: {n_bytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP -> {b_ms:.4f} ms ({b_by})")
    return {
        "name": "ivf_scan", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/ivf_scan.cu",
        "replaces": "text_similarity_tpu/index/ivf.py:1945",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"B={n_q} U={args[1].shape[1]} Mc={mc} D={d} k=10 {mode} bf16",
    }, (corpus, queries, exact)


# ---------------------------------------------------------------------------
# Phase 4: the pipeline
# ---------------------------------------------------------------------------

def synthetic_corpus(n, seed=0, n_words=20_000):
    """n unique sentences of 8-40 words over ~20k synthetic words."""
    rng = np.random.default_rng(seed)
    syll = [a + b for a in "bcdfghjklmnprstvwz" for b in "aeiou"]
    words = set()
    while len(words) < n_words:
        words.add("".join(rng.choice(syll, rng.integers(2, 5))))
    words = sorted(words)
    out, seen = [], set()
    while len(out) < n:
        lens = rng.integers(8, 41, n)
        picks = rng.integers(0, len(words), lens.sum())
        pos = 0
        for length in lens:
            s = " ".join(words[j] for j in picks[pos:pos + length])
            pos += length
            if s not in seen:
                seen.add(s)
                out.append(s)
                if len(out) == n:
                    break
    return out


def own_slab_probed(torch, pipe, texts, doc_ids):
    """Per query of one IVF request: is the slab that holds its own document
    in the probe list of its query block? The pipeline's serving args
    (block_q 64, union round_up(probes, 8)) give all queries of a block one
    shared list, so a request of queries from many clusters cannot have
    every query's own slab probed."""
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    ivf = pipe.ivf
    mc = ivf.data_padded.shape[1]
    _, probe_list, order, block_q = serving_plan(
        ivf, _pad_pow2(pipe.encoder.encode(texts, device_output=True))
    )
    block_of = torch.argsort(order)[: len(texts)] // block_q
    ids = ivf.ids_padded.reshape(-1)
    slab = torch.full((int(ids.max()) + 1,), -1, dtype=torch.long, device=ids.device)
    live = torch.nonzero(ids >= 0)[:, 0]
    slab[ids[live].long()] = live // mc
    own = slab[torch.as_tensor(np.asarray(doc_ids), device=ids.device)]
    hit = (probe_list[block_of].long() == own[:, None]).any(dim=1)
    return hit.cpu().tolist()


def serve_requests(torch, pipe, label, n_docs, sizes, rng, results, requests):
    """Requests of verbatim corpus sentences → self-retrieval hits (own
    document in the top 10 at score ≥ 0.99) per request size, into
    ``results[(label, size)] = [queries, hits, own slab probed, hits among
    those, [ms]]``; IVF requests also go to ``requests`` for the
    probe-coverage check."""
    picks = rng.choice(n_docs, size=sum(sizes), replace=False)
    start = 0
    for size in sizes:
        req = picks[start:start + size]
        start += size
        texts = [pipe.corpus[j] for j in req]
        torch.cuda.synchronize()
        t = time.time()
        out = pipe(texts, max_num_results=10)
        torch.cuda.synchronize()
        dt = time.time() - t
        hit = [any(d == j and s >= 0.99 for _, s, d in row) for j, row in zip(req, out)]
        if pipe.ivf is not None:
            requests.append((pipe, label, size, texts, req, hit))
        rec = results.setdefault((label, size), [0, 0, 0, 0, []])
        rec[0] += size
        rec[1] += sum(hit)
        rec[4].append(dt * 1e3)


def gate_requests(torch, results, requests, card):
    """Log each (pipeline, request size) and gate it: ≥ 95% self-retrieval
    on every brute-force request and every single-query IVF request; on a
    multi-query IVF request, ≥ 95% among the queries whose own slab was
    probed. The serving args share one union of round_up(probes, 8) slabs
    across a 64-query block, which cannot hold the own slab of every query
    of a request drawn from many clusters."""
    ivf_labels = {label for _, label, *_ in requests}
    for pipe, label, size, texts, req, hit in requests:
        rec = results[(label, size)]
        for probed, h in zip(own_slab_probed(torch, pipe, texts, req), hit):
            rec[2] += probed
            rec[3] += probed and h
    for (label, size), (total, hits, probed, probed_hits, ms) in sorted(results.items()):
        cover = (f"; own slab probed for {probed}/{total}, of which {probed_hits} find "
                 f"themselves" if label in ivf_labels else "")
        log(f"{label}: {len(ms)} request(s) of {size}: {hits}/{total} queries find "
            f"themselves in the top 10 at score >= 0.99{cover}; median {np.median(ms):.1f} ms "
            f"= {size / np.median(ms) * 1e3:.1f} QPS [{card}]")
    for (label, size), (total, hits, probed, probed_hits, _) in results.items():
        if label not in ivf_labels or size == 1:
            if hits < 0.95 * total:
                raise AssertionError(f"{label}, requests of {size}: self-retrieval "
                                     f"{hits}/{total} below 95%")
        elif probed_hits < 0.95 * probed or probed == 0:
            raise AssertionError(f"{label}, requests of {size}: self-retrieval "
                                 f"{probed_hits}/{probed} of probed queries below 95%")


def host_ms(torch, fn, reps=5):
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t) / reps * 1e3


def profile_split(torch, label, fn, card, top=8, groups=()):
    """One call of ``fn`` under ``torch.profiler`` → log its wall time, the
    device's busy and idle share of it (the sum of the device time of every
    kernel, one stream, over the wall time), and the ops that took the most
    device time; with ``groups`` ((label, name substrings), ...) also the
    device time of each group and of the rest. The profiler's own overhead
    lengthens the wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
    # device-side events only (the CPU op that launched a kernel reports the
    # same time again), as the profiler's own table totals them
    ops = [
        (e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
        and e.self_device_time_total > 0
    ]
    busy = sum(ms for ms, _, _ in ops)
    if busy == 0:
        log(f"profile of {label}: wall {wall:.2f} ms; device time not measured "
            f"(the profiler recorded no device events) [{card}]")
        return
    ops.sort(reverse=True)
    head = "; ".join(f"{key[:60]} x{n} {ms:.3f} ms" for ms, n, key in ops[:top])
    log(f"profile of {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; top device ops: {head} [{card}]")
    if groups:
        split, rest = {}, busy
        for name, keys in groups:
            ms = sum(t for t, _, key in ops if any(w in key.lower() for w in keys))
            split[name] = ms
            rest -= ms
        parts = "; ".join(f"{name} {ms:.2f} ms ({ms / busy:.1%})" for name, ms in split.items())
        log(f"profile of {label}, device time by group: {parts}; the rest {rest:.2f} ms "
            f"({rest / busy:.1%}) [{card}]")


def phase_pipeline(torch, card):
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.data.tokenization import (
        WordPieceTokenizer, train_wordpiece_vocab,
    )
    from text_similarity_tpu_torch.index import BruteForceIndex
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda, ivf_scan_reference
    from text_similarity_tpu_torch.models import SentenceEncoder, init_params
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda, cosine_topk_reference
    from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    t0 = time.time()
    corpus = synthetic_corpus(120_000)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=30522))
    arch = ARCH_PRESETS["minilm-l6"]
    params = init_params(arch, torch.Generator().manual_seed(0))
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    log(f"pipeline set-up: corpus + vocab ({tok.vocab_size}) + minilm-l6 init "
        f"{time.time() - t0:.1f} s")

    rng = np.random.default_rng(1)
    results, requests = {}, []

    torch.cuda.synchronize()
    t = time.time()
    big = SemanticSearchPipeline(enc, corpus=corpus, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.time() - t
    log(f"encode 120000 docs: {enc_s:.1f} s = {len(corpus) / enc_s:.0f} sentences/s "
        f"(tokenize + minilm-l6 bf16) [{card}]")
    sample = big.store.view[:2000]
    cos = sample @ sample.T
    log(f"random-weight embeddings: mean cosine between distinct documents "
        f"{float((cos.sum() - cos.diagonal().sum()) / (2000 * 1999)):.4f}")
    t = time.time()
    big._build_ivf()
    torch.cuda.synchronize()
    log(f"IVF build over 120000 docs: {time.time() - t:.2f} s, Mc={big.ivf.data_padded.shape[1]}, "
        f"C={big.ivf.num_base_clusters} (+{big.ivf.num_overflow}) [{card}]")
    small = SemanticSearchPipeline(enc, corpus=corpus[:2000], device="cuda")
    # warm both paths so the counted window holds serving calls only
    big(corpus[:1], 10)
    small(corpus[:1], 10)

    cosine_topk_cuda.launches = 0
    ivf_scan_cuda.launches = 0
    serve_requests(torch, big, "ivf pipeline (120000 docs)", len(corpus), [1] * 20 + [5, 64],
                   rng, results, requests)
    serve_requests(torch, small, "brute pipeline (2000 docs)", 2000, [1, 5, 64],
                   rng, results, requests)
    launches = {"cosine_topk": cosine_topk_cuda.launches, "ivf_scan": ivf_scan_cuda.launches}
    log(f"launches during the pipeline phase: {launches}")

    # repeated 64-query requests on both paths, and where their time goes:
    # encode alone, search alone (the index's query on encoded rows)
    q64 = [corpus[j] for j in rng.choice(2000, 64, replace=False)]
    qe = _pad_pow2(enc.encode(q64, device_output=True))
    mc = big.ivf.data_padded.shape[1]
    enc_ms = host_ms(torch, lambda: enc.encode(q64, device_output=True))
    for label, pipe, search in (
        ("ivf pipeline", big, lambda: big.ivf.query(
            qe, k=10, block_q=64, union_factor=1, approx_width=2048 if mc >= 1024 else 0)),
        ("brute pipeline", small, lambda: BruteForceIndex(small.store).query(qe, k=10)),
    ):
        total = host_ms(torch, lambda: pipe(q64, 10))
        log(f"{label}: 64-query request {total:.2f} ms = {64 / total * 1e3:.0f} QPS; "
            f"encode alone {enc_ms:.2f} ms, search alone {host_ms(torch, search):.2f} ms [{card}]")

    # the kernels against their plain versions at the pipeline's shapes
    ks, ki = cosine_topk_cuda(qe, small.store.view.contiguous(), 20)
    rs, ri = cosine_topk_reference(qe, small.store.view, 20)
    ivf = big.ivf
    w, slots = ivf.scan_mode(10, 2048 if mc >= 1024 else 0, 0)
    qs, probes, _, block_q = serving_plan(ivf, qe)
    args = (qs, probes, ivf.data_padded, ivf.ids_padded, 10, block_q, w, slots)
    ks2, ki2 = ivf_scan_cuda(*args)
    rs2, ri2 = ivf_scan_reference(*args)
    torch.cuda.synchronize()
    ov1, ov2 = overlap(ki.cpu().numpy(), ri.cpu().numpy()), overlap(ki2.cpu().numpy(), ri2.cpu().numpy())
    e1 = float((ks - rs).abs().max())
    e2 = float((ks2 - rs2).abs().max())
    log(f"at pipeline shapes: K2 (64x{small.store.size}, k=20) overlap {ov1:.4f} max|Δ| {e1:.2e}; "
        f"K1 (64 queries, {'deferred' if w else 'exact'}) overlap {ov2:.4f} max|Δ| {e2:.2e}")
    if min(ov1, ov2) < 0.99 or max(e1, e2) > 1e-4:
        raise AssertionError("a kernel disagrees with its plain version at pipeline shapes")

    gate_requests(torch, results, requests, card)
    if launches["cosine_topk"] == 0 or launches["ivf_scan"] == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return launches, {"corpus": corpus, "tok": tok, "params": params, "enc": enc,
                      "bf16_store": big.store}


# ---------------------------------------------------------------------------
# Phase 5: int8 serving
# ---------------------------------------------------------------------------

def phase_int8_topk(torch, card):
    """K3 against its plain version, and its times, at the phase-2 shapes."""
    from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
    from text_similarity_tpu_torch.ops.topk import (
        cosine_topk_int8_cuda, cosine_topk_int8_reference, l2_normalize,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    n, d = 100_003, 384
    corpus = l2_normalize(torch.randn(n, d, generator=g, device=dev))
    src = torch.randperm(n // 2, generator=g, device=dev)[:256]
    dst = n // 2 + torch.randperm(n - n // 2, generator=g, device=dev)[:512]
    corpus[dst[:256]] = corpus[src]
    corpus[dst[256:]] = corpus[src]       # three copies: exact ties
    queries = l2_normalize(corpus[src] + 0.05 * torch.randn(256, d, generator=g, device=dev))
    codes, scales = quantize_embeddings_int8(corpus)
    worst = 0.0
    for q_n in (1, 7, 256):
        q = queries[:q_n].contiguous()
        for k in (10, 20):
            ks, ki = cosine_topk_int8_cuda(q, codes, scales, k)
            rs, ri = cosine_topk_int8_reference(q, codes, scales, k)
            torch.cuda.synchronize()
            ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
            err = float(np.abs(ks - rs).max())
            worst = max(worst, err)
            ok = err <= 1e-5 and separated_ids_equal(ki, ri, rs)
            log(f"K3 int8 Q={q_n} k={k}: max|Δscore| {err:.2e}, ids equal "
                f"{np.mean(ki == ri):.4f} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K3 disagrees with its plain version")
    q, k = queries.contiguous(), 10
    ms = time_ms(torch, lambda: cosine_topk_int8_cuda(q, codes, scales, k))
    plain = time_ms(torch, lambda: cosine_topk_int8_reference(q, codes, scales, k),
                    iters=3, warmup=1)
    lib = time_ms(torch, lambda: torch.topk((q @ codes.float().T) * scales, k, dim=1))
    qn = q.shape[0]
    b_ms, b_by = bound_ms(qn * d * 4 + n * d + n * 4 + qn * k * 8, 2.0 * qn * n * d, PEAK_F32)
    ms_q1 = time_ms(torch, lambda: cosine_topk_int8_cuda(q[:1], codes, scales, k))
    log(f"K3 times [{card}]: int8 Q=256 k=10 kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"torch.topk((q@c.float()T)*s) {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"Q=1 {ms_q1:.3f} ms")
    return {
        "name": "cosine_topk_int8", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/topk.cu",
        "replaces": "text_similarity_tpu/ops/topk.py:617",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"Q=256 N={n} D={d} k=10 int8",
    }


def phase_int8_ivf(torch, card, corpus, queries, exact):
    """K4 against its plain version on an int8 index of the phase-3 corpus;
    recall@10 of int8 + rescore (gate) and of raw int8 against exact."""
    import dataclasses

    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index.ivf import IVFIndex, ivf_scan_cuda, ivf_scan_reference

    n, d = corpus.shape
    n_q = queries.shape[0]
    cfg = dataclasses.replace(IndexConfig.auto(n), quantize_int8=True)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf = IVFIndex.build(corpus, cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    mc = ivf.data_padded.shape[1]
    log(f"int8 IVF build [{card}]: {time.time() - t0:.2f} s for {n}x{d}, "
        f"C={ivf.num_base_clusters} (+{ivf.num_overflow}), Mc={mc}, rescore copy "
        f"{str(ivf.rescore_data.dtype)[6:]}")

    q_s, probes, _, block_q = serving_plan(ivf, queries)
    worst, main = 0.0, None
    for label, k_scan, aw in (("k=10 raw", 10, 2048), ("k=10 rescore scan", 20, 2048),
                              ("k=10 rescore scan, exact", 20, 0)):
        w, slots = ivf.scan_mode(k_scan, aw, 0)
        mode = f"deferred w={w} S={slots}" if w else "exact"
        args = (q_s, probes, ivf.data_padded, ivf.ids_padded, k_scan, block_q, w, slots)
        ks, ki = ivf_scan_cuda(*args, scales=ivf.scales_padded)
        rs, ri = ivf_scan_reference(*args, scales=ivf.scales_padded)
        torch.cuda.synchronize()
        ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
        err = float(np.abs(ks - rs).max())
        worst = max(worst, err)
        ov = overlap(ki, ri)
        ok = ov >= 0.99 and err <= 1e-4
        ms = time_ms(torch, lambda: ivf_scan_cuda(*args, scales=ivf.scales_padded),
                     iters=5, warmup=1)
        log(f"K4 Mc={mc} {label} (k_scan {k_scan}) mode {mode}: overlap {ov:.4f}, "
            f"max|Δscore| {err:.2e}, kernel {ms:.3f} ms [{card}] -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K4 disagrees with its plain version")
        if k_scan == 20 and w:
            plain = time_ms(torch, lambda: ivf_scan_reference(*args, scales=ivf.scales_padded),
                            iters=1, warmup=1)
            main = (args, ms, plain, mode, slots)
    if main is None or main[4] != 2:
        raise AssertionError("the rescore scan did not run the two-slot deferred fold")

    exact_h = exact.cpu().numpy()
    qargs = dict(k=10, block_q=64, union_factor=1, approx_width=2048)
    recall = {}
    for label, kc in (("int8 + rescore", 0), ("raw int8", -1)):
        _, got = ivf.query(queries, k_coarse=kc, **qargs)
        recall[label] = overlap(got.cpu().numpy(), exact_h)
        t_q = time_ms(torch, lambda: ivf.query(queries, k_coarse=kc, **qargs), iters=3, warmup=1)
        log(f"int8 IVF {label}: recall@10 vs exact {recall[label]:.4f}; query 4096 @k=10 "
            f"{t_q:.2f} ms = {n_q / t_q * 1e3:.0f} QPS [{card}]")
    if recall["int8 + rescore"] < 0.95:
        raise AssertionError("int8 + rescore recall@10 below 0.95")

    args, ms, plain, mode, _ = main
    slabs = torch.unique(args[1])
    valid = (ivf.ids_padded >= 0).sum(dim=1)
    # codes + scale of every valid slot, the ids of every probed slot, the
    # queries once, the (B, k_scan) results
    n_bytes = (int(valid[slabs].sum()) * (d + 4) + slabs.numel() * mc * 4
               + n_q * d * 4 + n_q * args[4] * 8)
    ops = 2.0 * block_q * d * float(valid[args[1].long()].sum())
    b_ms, b_by = bound_ms(n_bytes, ops, PEAK_BF16)
    log(f"K4 bound [{card}]: {n_bytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP -> {b_ms:.4f} ms ({b_by})")
    return {
        "name": "ivf_scan_int8", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/ivf_scan.cu",
        "replaces": "text_similarity_tpu/index/ivf.py:1945 (_ivf_kernel_int8 :1709)",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"B={n_q} U={args[1].shape[1]} Mc={mc} D={d} k_scan=20 {mode} int8",
    }


def phase_int8_pipeline(torch, card, ctx):
    """The int8 serving path end to end; → the K3/K4 launches of its window."""
    import dataclasses

    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda, ivf_scan_reference
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.ops.topk import (
        cosine_topk_cuda, cosine_topk_int8_cuda, cosine_topk_int8_reference,
    )
    from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    corpus, enc = ctx["corpus"], ctx["enc"]
    enc8 = SentenceEncoder(ctx["params"], enc.arch, tokenizer=ctx["tok"], device="cuda").to_int8()
    rng = np.random.default_rng(2)
    q64 = [corpus[j] for j in rng.choice(len(corpus), 64, replace=False)]
    e16 = enc.encode(q64, device_output=True)
    e8 = enc8.encode(q64, device_output=True)
    log(f"int8 vs bf16 encoder (minilm-l6, same weights): mean cosine of 64 embeddings "
        f"{float((e16 * e8).sum(dim=1).mean()):.5f}, min {float((e16 * e8).sum(dim=1).min()):.5f}")

    cfg = dataclasses.replace(IndexConfig.auto(len(corpus)), quantize_int8=True)
    torch.cuda.synchronize()
    t = time.time()
    pipe = SemanticSearchPipeline(enc8, corpus=corpus, index_config=cfg, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.time() - t
    log(f"int8 encode 120000 docs: {enc_s:.1f} s = {len(corpus) / enc_s:.0f} sentences/s "
        f"(tokenize + minilm-l6 int8) [{card}]")
    t = time.time()
    pipe._build_ivf()
    torch.cuda.synchronize()
    ivf = pipe.ivf
    log(f"int8 IVF build over 120000 docs: {time.time() - t:.2f} s, Mc={ivf.data_padded.shape[1]}, "
        f"C={ivf.num_base_clusters} (+{ivf.num_overflow}), slabs {str(ivf.data_padded.dtype)[6:]}, "
        f"rescore {str(ivf.rescore_data.dtype)[6:]} [{card}]")
    store8 = EmbeddingStore(2000, enc8.embedding_dim, quantized=True, device="cuda")
    store8.add(pipe.store.view[:2000])
    brute = BruteForceIndex(store8)
    qb = _pad_pow2(enc8.encode(corpus[:64], device_output=True))
    pipe(corpus[:1], 10)        # warm the path outside the counted window
    brute.query(qb, k=10)
    new_doc = "zyx quantized serving check sentence that was never indexed before"
    gone = int(rng.integers(0, len(corpus)))

    results, requests = {}, []
    for counter in ("launches", "launches_int8"):
        setattr(ivf_scan_cuda, counter, 0)
    cosine_topk_cuda.launches = 0
    cosine_topk_int8_cuda.launches = 0
    serve_requests(torch, pipe, "int8 ivf pipeline (120000 docs)", len(corpus),
                   [1] * 20 + [5, 64], rng, results, requests)
    new_id = int(pipe.add_documents([new_doc])[0])
    found = pipe([new_doc], 10)[0]
    pipe.remove_documents([gone])
    after = pipe([corpus[gone]], 10)[0]
    s_b, i_b = brute.query(qb, k=10)
    launches = {"cosine_topk_int8": cosine_topk_int8_cuda.launches,
                "ivf_scan_int8": ivf_scan_cuda.launches_int8,
                "cosine_topk": cosine_topk_cuda.launches, "ivf_scan": ivf_scan_cuda.launches}
    log(f"launches during the int8 pipeline window: {launches}")

    ok_add = bool(found) and found[0][2] == new_id and found[0][1] >= 0.99
    ok_remove = all(d != gone for _, _, d in after)
    log(f"int8 add_documents: new id {new_id} first at score "
        f"{found[0][1] if found else float('nan'):.4f} -> {'ok' if ok_add else 'FAIL'}; "
        f"remove_documents({gone}): absent from its own query's top 10 -> "
        f"{'ok' if ok_remove else 'FAIL'}")
    self_hits = int(sum(i_b[r, 0] == r and s_b[r, 0] >= 0.99 for r in range(64)))
    log(f"BruteForceIndex over an int8 store of 2000 embeddings: {self_hits}/64 verbatim "
        f"queries first at score >= 0.99")

    enc8_ms = host_ms(torch, lambda: enc8.encode(q64, device_output=True))
    qe = _pad_pow2(e8)
    search_ms = host_ms(torch, lambda: ivf.query(qe, k=10, block_q=64, union_factor=1))
    total = host_ms(torch, lambda: pipe(q64, 10))
    log(f"int8 ivf pipeline: 64-query request {total:.2f} ms = {64 / total * 1e3:.0f} QPS; "
        f"int8 encode alone {enc8_ms:.2f} ms, int8 search alone (scan + rescore) "
        f"{search_ms:.2f} ms [{card}]")
    profile_split(torch, "one 64-query int8 request", lambda: pipe(q64, 10), card)
    profile_split(torch, "int8 encode of 64 texts", lambda: enc8.encode(q64, device_output=True),
                  card)
    profile_split(torch, "bf16 encode of the same 64 texts",
                  lambda: enc.encode(q64, device_output=True), card)

    # the kernels against their plain versions at the int8 pipeline's shapes
    ks, ki = cosine_topk_int8_cuda(qb, store8.view, store8.scales_view, 20)
    rs, ri = cosine_topk_int8_reference(qb, store8.view, store8.scales_view, 20)
    mc = ivf.data_padded.shape[1]
    k_scan = ivf.scan_k(10)
    w, slots = ivf.scan_mode(k_scan, 2048 if mc >= 1024 else 0, 0)
    qs, probes, _, block_q = serving_plan(ivf, qe)
    args = (qs, probes, ivf.data_padded, ivf.ids_padded, k_scan, block_q, w, slots)
    ks2, ki2 = ivf_scan_cuda(*args, scales=ivf.scales_padded)
    rs2, ri2 = ivf_scan_reference(*args, scales=ivf.scales_padded)
    torch.cuda.synchronize()
    ov1, ov2 = overlap(ki.cpu().numpy(), ri.cpu().numpy()), overlap(ki2.cpu().numpy(), ri2.cpu().numpy())
    e1, e2 = float((ks - rs).abs().max()), float((ks2 - rs2).abs().max())
    log(f"at int8 pipeline shapes: K3 (64x2000, k=20) overlap {ov1:.4f} max|Δ| {e1:.2e}; "
        f"K4 (64 queries, k_scan {k_scan}, {'deferred' if w else 'exact'}) overlap {ov2:.4f} "
        f"max|Δ| {e2:.2e}")
    if min(ov1, ov2) < 0.99 or max(e1, e2) > 1e-4:
        raise AssertionError("an int8 kernel disagrees with its plain version at pipeline shapes")

    gate_requests(torch, results, requests, card)
    if not (ok_add and ok_remove):
        raise AssertionError("add_documents / remove_documents on the int8 index failed")
    if self_hits < 0.95 * 64:
        raise AssertionError(f"int8 brute-force self-retrieval {self_hits}/64 below 95%")
    if launches["cosine_topk_int8"] == 0 or launches["ivf_scan_int8"] == 0:
        raise AssertionError(f"an int8 kernel of the path never launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: long documents
# ---------------------------------------------------------------------------

LONG_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# bf16 last_hidden_state, K5 path against the banded reference path, valid
# rows: about 2.5x the largest readings on an H100 (roberta-base-long mean
# 7.9e-3, max 0.117; minilm-l6 window 0 mean 2.8e-3, max 0.070), where
# another document's rows differ by a mean of 0.52-0.63
AGREE_MEAN, AGREE_MAX = 2e-2, 0.3
FLASH_GROUPS = (("K5 flash_fwd", ("flash_fwd",)),
                ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")))


def band_pairs(lens, window, global_cls):
    """(query, key) pairs one head's attention needs: valid rows i < len
    against valid keys j < len in the band |i − j| ≤ window (every valid key
    at window 0), plus the CLS row and column with ``global_cls``."""
    total = 0
    for n in lens:
        if n <= 0:
            continue
        if window <= 0:
            total += n * n
            continue
        i = np.arange(n)
        cnt = np.minimum(i + window, n - 1) - np.maximum(i - window, 0) + 1
        if global_cls:
            cnt[0] = n                  # the CLS row sees every valid key
            cnt[1:] += i[1:] > window   # key 0 outside the band of row i
        total += int(cnt.sum())
    return total


def flash_case(torch, q, k, v, lengths, window, cls):
    """K5 and its plain version on one input → (max |Δ| and mean |Δ| of the
    outputs on valid rows, max |Δ| of lse there, zero-length rows exactly
    0)."""
    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_plain

    out, lse = flash_attention_cuda(q, k, v, lengths, window, cls, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, lengths, window, cls, return_lse=True)
    torch.cuda.synchronize()
    valid = torch.arange(q.shape[1], device=q.device)[None, :] < lengths[:, None]
    diff = (out.float() - ref.float()).abs()[valid]
    lse_err = float((lse - ref_lse).abs().transpose(1, 2)[valid].max())
    zero = lengths == 0
    zero_ok = bool((out[zero] == 0).all()) and bool((lse[zero] == 0).all())
    return float(diff.max()), float(diff.mean()), lse_err, zero_ok


def phase_flash(torch, card):
    """K5 against its plain version (B 8 × S 4096 × H 12, D 64 and D 32,
    lengths 3001-4096; B 3 × S 512 × D 32 with a zero-length row; f32 and bf16;
    window 0, 256, 256 + global CLS; q, k, v as views of a fused QKV), then
    its times at the serving shape beside the plain version and SDPA."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    long_lens = (4096, 3001, 4090, 3500, 3800, 3100, 4000, 3333)
    for b, s, h, d, lens in ((8, 4096, 12, 64, long_lens), (8, 4096, 12, 32, long_lens),
                             (3, 512, 12, 32, (512, 300, 0))):
        qkv = torch.randn(b, s, h, 3, d, generator=g, device=dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = qkv.to(dtype)
            q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
            for window, cls in ((0, False), (256, False), (256, True)):
                err, mean, lse_err, zero_ok = flash_case(torch, q, k, v, lengths, window, cls)
                worst = max(worst, err)
                if dtype == torch.float32:
                    ok = err <= 1e-4
                else:
                    ok = err <= 1e-2 and mean <= 5e-4
                ok = ok and lse_err <= 1e-4 and zero_ok
                log(f"K5 {str(dtype)[6:]} B={b} S={s} D={d} lens={lens} window={window} "
                    f"cls={cls}: max|Δ| {err:.2e}, mean|Δ| {mean:.2e}, lse max|Δ| "
                    f"{lse_err:.2e}, zero rows exact {zero_ok} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K5 disagrees with its plain version")

    # times at the serving shape: roberta-base-long's attention, one batch
    b, s, h, d = 8, 4096, 12, 64
    x = torch.randn(b, s, h, 3, d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(s, device=dev)
    times = {}
    for window, cls in ((256, True), (0, False)):
        allowed = None
        if window:
            allowed = (pos[:, None] - pos[None, :]).abs() <= window
            allowed |= (pos[:, None] == 0) | (pos[None, :] == 0)
        ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, lengths, window, cls))
        plain = time_ms(torch, lambda: flash_attention_plain(q, k, v, lengths, window, cls),
                        iters=2, warmup=1)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed))
        sdpa_err = float((F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)
                          .transpose(1, 2).float()
                          - flash_attention_cuda(q, k, v, lengths, window, cls).float())
                         .abs().max())
        pairs = h * band_pairs([s] * b, window, cls)
        n_bytes = 4 * b * s * h * d * 2 + b * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * d * pairs, PEAK_BF16)
        log(f"K5 times [{card}]: bf16 B={b} S={s} H={h} D={d} window={window} cls={cls}: kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms, SDPA (bool mask) {lib:.3f} ms (max|Δ| vs "
            f"kernel {sdpa_err:.2e}), bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB, "
            f"{4.0 * d * pairs / 1e9:.1f} GFLOP; {pairs} pairs)")
        times[window] = (ms, plain, lib, b_ms, b_by)
    ms, plain, lib, b_ms, b_by = times[256]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "text_similarity_tpu/ops/attention.py:253 (:272 with lse)",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"B={b} S={s} H={h} D={d} window=256 global CLS bf16",
    }


def long_documents(tok, sentences, rng, n_long, n_short):
    """Documents joined from corpus sentences: n_long of 3000-4040 tokens,
    then n_short of 600-980 (sentences are added until the drawn length is
    reached; one adds at most 40 tokens)."""
    counts = [len(r) for r in tok.tokenize_many(sentences)]
    targets = list(rng.integers(3000, 4001, n_long)) + list(rng.integers(600, 941, n_short))
    docs, pos = [], 0
    for target in targets:
        parts, n = [], 0
        while n < target:
            parts.append(sentences[pos % len(sentences)])
            n += counts[pos % len(sentences)]
            pos += 1
        docs.append(" ".join(parts))
    return docs


def bucket_batches(enc, docs, batch_size, max_len=4096):
    """(bucket, row lengths) of each batch that ``encode`` forms: rows
    sorted by token length, grouped by batch_size, each batch padded to the
    bucket of its longest row."""
    from text_similarity_tpu_torch.data.batching import pick_bucket

    lens = sorted(len(r) for r in enc._tokenize_rows(docs, max_len))
    groups = [lens[i:i + batch_size] for i in range(0, len(lens), batch_size)]
    return [(pick_bucket(rows[-1], LONG_BUCKETS), rows) for rows in groups]


def path_agreement(torch, enc, texts, bucket=4096):
    """One batch of texts padded to ``bucket`` through ``encoder_forward``
    with attention_impl "auto" (K5 in every layer at 4096 on the card) and
    "reference" (the banded reference) → (mean |Δ| and max |Δ| of
    last_hidden_state on valid rows; the mean |Δ| between each document's
    auto rows and the next document's reference rows, which is what an
    answer for the wrong document would give; min cosine of the pooled
    unit embeddings)."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.models import encoder_forward
    from text_similarity_tpu_torch.models.pooling import pool

    rows = enc._tokenize_rows(texts, bucket)
    ids = np.full((len(rows), bucket), enc.tokenizer.pad_id, np.int32)
    mask = np.zeros((len(rows), bucket), np.int32)
    for r, row in enumerate(rows):
        ids[r, :len(row)], mask[r, :len(row)] = row, 1
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    hidden, emb = {}, {}
    with torch.no_grad():
        for impl in ("auto", "reference"):
            h = encoder_forward(enc.params, ids, mask, arch=enc.arch, precision=enc.precision,
                                attention_impl=impl).last_hidden_state
            hidden[impl] = h.float()
            emb[impl] = F.normalize(pool(enc.pooling, h, mask).float(), dim=-1)
    valid = mask.bool()
    diff = (hidden["auto"] - hidden["reference"]).abs()[valid]
    both = valid & valid.roll(1, 0)
    control = (hidden["auto"] - hidden["reference"].roll(1, 0)).abs()[both]
    cos = (emb["auto"] * emb["reference"]).sum(dim=1)
    return float(diff.mean()), float(diff.max()), float(control.mean()), float(cos.min())


def phase_long_documents(torch, card, ctx):
    """roberta-base converted for 4096 tokens (positions tiled to 4098,
    band 256, global CLS; random weights, bf16) encodes 128 documents with
    the long-encode arguments into a store searched by K2; → K5's launches
    in that encode (K2's launches in the search are gated here)."""
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.models import SentenceEncoder, init_params
    from text_similarity_tpu_torch.models.hf_convert import extend_positions
    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    tok, corpus = ctx["tok"], ctx["corpus"]
    rng = np.random.default_rng(6)
    kw = dict(max_len=4096, buckets=LONG_BUCKETS, batch_size=8)
    t0 = time.time()
    docs = long_documents(tok, corpus[:24_000], rng, 112, 16)
    arch = ARCH_PRESETS["roberta-base"]
    params, arch = extend_positions(init_params(arch, torch.Generator().manual_seed(0)), arch, 4098)
    arch = arch.replace(attention_window=256, window_global_cls=True)
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    batches = bucket_batches(enc, docs, 8)
    n_4096 = sum(bucket == 4096 for bucket, _ in batches)
    n_tokens = sum(sum(rows) for _, rows in batches)
    log(f"long set-up: {len(docs)} documents ({n_tokens} tokens; batches of 8 at buckets "
        f"{[bucket for bucket, _ in batches]}), roberta-base-long init "
        f"{time.time() - t0:.1f} s")
    enc.encode(docs[:8], **kw)           # warm the path outside the counted window

    flash_attention_cuda.launches = 0
    cosine_topk_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    emb = enc.encode(docs, device_output=True, **kw)
    torch.cuda.synchronize()
    enc_s = time.time() - t
    launches = flash_attention_cuda.launches
    log(f"long encode [{card}]: {len(docs)} documents in {enc_s:.2f} s = "
        f"{len(docs) / enc_s:.1f} docs/s, {n_tokens / enc_s:.0f} tokens/s (tokenize + "
        f"roberta-base-long bf16); K5 launches {launches} (12 layers x {n_4096} batches at 4096)")

    store = EmbeddingStore(len(docs), enc.embedding_dim, device="cuda")
    store.add(emb)
    index = BruteForceIndex(store)
    picks = rng.choice(len(docs), 16, replace=False)
    scores, ids = index.query(enc.encode([docs[j] for j in picks], device_output=True, **kw), k=10)
    hits = sum(any(i == j and sc >= 0.99 for sc, i in zip(srow, irow))
               for j, srow, irow in zip(picks, scores, ids))
    k2_launches = cosine_topk_cuda.launches
    n = len(docs)
    cos = emb @ emb.T
    log(f"long self-retrieval (K2 launches {k2_launches}): {hits}/16 documents find themselves "
        f"in the top 10 at score "
        f">= 0.99; mean cosine between distinct documents "
        f"{float((cos.sum() - cos.diagonal().sum()) / (n * (n - 1))):.5f}")

    # the same encoder through the banded reference on the card
    rows = enc._tokenize_rows(docs, 4096)
    long_idx = [j for j in range(n) if len(rows[j]) > 2048][:8]
    agree = path_agreement(torch, enc, [docs[j] for j in long_idx])
    log(f"K5 path against the reference path (8 documents at bucket 4096): last_hidden_state "
        f"on valid rows mean|Δ| {agree[0]:.3e}, max|Δ| {agree[1]:.3e} (another document's "
        f"rows: mean|Δ| {agree[2]:.3e}); pooled min cosine {agree[3]:.6f}")
    profile_split(torch, "one 8 x 4096 roberta-base-long encode",
                  lambda: enc.encode([docs[j] for j in long_idx], device_output=True, **kw),
                  card, groups=FLASH_GROUPS)

    # window 0 on the path: minilm-l6 with positions tiled to 4096, full attention
    march = ARCH_PRESETS["minilm-l6"]
    mparams, march = extend_positions(ctx["params"], march, 4096)
    menc = SentenceEncoder(mparams, march, tokenizer=tok, device="cuda")
    mdocs = [docs[j] for j in long_idx] + [docs[j] for j in range(n) if len(rows[j]) > 2048][8:16]
    m_4096 = sum(bucket == 4096 for bucket, _ in bucket_batches(menc, mdocs, 8))
    before = flash_attention_cuda.launches
    torch.cuda.synchronize()
    t = time.time()
    memb = menc.encode(mdocs, device_output=True, **kw)
    torch.cuda.synchronize()
    m_s = time.time() - t
    m_launches = flash_attention_cuda.launches - before
    m_agree = path_agreement(torch, menc, mdocs[:8])
    log(f"minilm-l6 at 4096, window 0 [{card}]: {len(mdocs)} documents in {m_s:.2f} s; K5 "
        f"launches {m_launches} (6 layers x {m_4096} batches at 4096); against the reference "
        f"path: last_hidden_state mean|Δ| {m_agree[0]:.3e}, max|Δ| {m_agree[1]:.3e} (another "
        f"document's rows: mean|Δ| {m_agree[2]:.3e}); pooled min cosine {m_agree[3]:.6f}")

    finite = bool(torch.isfinite(emb).all()) and bool(torch.isfinite(memb).all())
    unit = float((emb.norm(dim=1) - 1).abs().max())
    if not finite or emb.shape != (n, 768) or unit > 1e-4:
        raise AssertionError(f"long embeddings: finite {finite}, shape {tuple(emb.shape)}, "
                             f"max |norm - 1| {unit:.2e}")
    if launches != 12 * n_4096 or n_4096 == 0:
        raise AssertionError(f"K5 launched {launches} times, expected 12 x {n_4096}")
    if k2_launches == 0:
        raise AssertionError("K2 never launched in the search over the long-document store")
    if m_launches != 6 * m_4096 or m_4096 == 0:
        raise AssertionError(f"K5 (window 0) launched {m_launches} times, expected 6 x {m_4096}")
    if hits < 0.95 * 16:
        raise AssertionError(f"long self-retrieval {hits}/16 below 95%")
    for name, (mean, worst, control, cos) in (("roberta-base-long", agree),
                                                ("minilm-l6 window 0", m_agree)):
        if mean > AGREE_MEAN or worst > AGREE_MAX or cos < 0.99:
            raise AssertionError(f"{name}: the K5 path and the reference path disagree "
                                 f"(mean|Δ| {mean:.3e}, max|Δ| {worst:.3e}, min cosine {cos:.6f})")
        if control < 10 * AGREE_MEAN:
            raise AssertionError(f"{name}: another document's rows differ by only {control:.3e}; "
                                 f"the agreement gate could not tell them apart")
    return launches


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from text_similarity_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {REPO}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.time()
    _cuda.build(verbose=True)
    _cuda.lib()
    log(f"kernels built in {time.time() - t:.1f} s")

    k2 = phase_topk(torch, card)
    k1, (corpus, queries, exact) = phase_ivf(torch, card)
    launches, ctx = phase_pipeline(torch, card)
    k3 = phase_int8_topk(torch, card)
    k4 = phase_int8_ivf(torch, card, corpus, queries, exact)
    del corpus, queries, exact
    launches8 = phase_int8_pipeline(torch, card, ctx)
    k5 = phase_flash(torch, card)
    k5["launches"] = phase_long_documents(torch, card, ctx)
    kernels = [k1, k2, k3, k4, k5]
    for kern in (k1, k2):
        kern["launches"] = launches[kern["name"]]
    for kern in (k3, k4):
        kern["launches"] = launches8[kern["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
