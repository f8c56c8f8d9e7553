"""Exact cosine top-k (kernel K2), its int8-corpus variant (kernel K3) and
their plain versions.

Port of ``text_similarity_tpu.ops.topk``: ``cosine_topk`` returns the exact
top-k of ``queries · corpusᵀ`` ordered by (score desc, id asc) — among
equal scores the lowest id wins, as the reference's merge rounds and
``lax.top_k`` do. ``cosine_topk_int8`` does the same over an int8 corpus
with per-row scales, scoring ``(q · float(c_row)) × scale_row`` with the
queries in f32 (the semantics of the reference's Pallas kernel
``cosine_topk_pallas_int8``, on both devices).

* ``cosine_topk_reference``: plain tensor code, chunked over the corpus like
  the reference's ``cosine_topk_xla``; selection uses stable sorts so ties
  keep the lowest id (``torch.topk`` promises no tie order).
* ``cosine_topk_cuda``: the hand-written CUDA kernel (``csrc/topk.cu`` on the
  score tile of ``csrc/score_tile.cuh``).
* ``cosine_topk``: dispatches on the corpus's device — the kernel for a
  CUDA tensor, the plain version for a CPU tensor.
* ``cosine_topk_int8_reference`` / ``cosine_topk_int8_cuda`` /
  ``cosine_topk_int8``: the same three for K3 (``csrc/topk.cu``, on the
  same score tile with an int8 loader).
* ``cosine_topk_2pass``: the certified two-pass top-k (kernel K8, the
  reference's ``cosine_topk_pallas_2pass``). Pass A keeps, per lane class
  (corpus position mod ``block_c``), the best score and its id (strict >,
  so the lower id wins a tie), then k merge rounds pick the top k of those
  winners; pass B counts the corpus scores strictly above the k-th. When a
  query's count differs from its count among the reported k, a class hid a
  winner and the whole call falls back to K2's exact answer. On a CUDA
  tensor both passes are kernels (``csrc/topk_2pass.cu``:
  ``topk_2pass_fold_cuda``, ``topk_2pass_count_cuda``) and the fallback is
  ``cosine_topk_cuda``; where the (Q, N) scores fit ``_SCORES_MAX``, pass
  A keeps them and pass B counts over them instead of computing them
  again. On a CPU tensor their plain versions
  (``cosine_topk_2pass_reference``).
* The large-k route (``csrc/topk_select.cu``): the selectors above hold at
  most ``MAX_K`` = 256 winners a query, so above that K2 and K3 write
  their scores, counting each query's leading key digits as they go
  (``cosine_topk_large_cuda``), and the select kernel cuts each row at the
  digit of its k-th score, compacts what lies at or above it in one read,
  selects among the candidates and sorts the k; K8's pass A selects its
  classes' winners the same way, and the IVF scans their candidates
  (``topk_select_cuda``). ``MAX_K`` only chooses between the two routes:
  every entry point takes 1 ≤ k ≤ N.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _cuda

MAX_K = 256   # above this k the kernels take the large-k route (topk_select.cu)
_INT_MAX = 2**31 - 1
_SCORES_BYTES = 1 << 30   # the large-k route's score buffer, at most
_SORT_RUN = 4096          # entries the select's sort takes in shared memory
_SELECT_CAP = 8192        # candidates a row of the select keeps
_SELECT_ZEROED = 4 + 1024 + 4096   # a row's counters and histograms (int32)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x.float().square(), dim=dim, keepdim=True))
    return (x / n.clamp_min(eps)).to(x.dtype)


def select_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis by (score desc, id asc), at most as many as
    there are. On CUDA tensors above ``MAX_K`` the select kernel
    (``topk_select_cuda``) takes it, else ``select_topk_plain``."""
    if scores.is_cuda and k > MAX_K:
        *lead, n = scores.shape
        k = min(k, n)
        s, i = topk_select_cuda(scores.reshape(-1, n).float().contiguous(), k,
                                ids.reshape(-1, n).to(torch.int32).contiguous())
        return s.reshape(*lead, k).to(scores.dtype), i.reshape(*lead, k).to(ids.dtype)
    return select_topk_plain(scores, ids, k)


def select_topk_plain(scores: torch.Tensor, ids: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The select kernel's plain version: sort by id, then stably by score."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    s = torch.gather(scores, -1, by_id)
    i = torch.gather(ids, -1, by_id)
    by_score = torch.argsort(s, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(s, -1, by_score), torch.gather(i, -1, by_score)


def topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k lists (..., S, k') into the global top k (...,
    k) by (score desc, id asc): the reference's merge after the all-gather
    over the index axis."""
    *lead, s, kk = scores.shape
    return select_topk(scores.reshape(*lead, s * kk), ids.reshape(*lead, s * kk), k)


def _dot_dtype_queries(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    # the reference casts the queries to the corpus dtype before the dot
    if corpus.dtype == torch.bfloat16:
        return queries.to(torch.bfloat16).float()
    return queries.float()


def cosine_topk_reference(
    queries: torch.Tensor,  # (Q, D) L2-normalized
    corpus: torch.Tensor,   # (N, D) L2-normalized, f32 or bf16
    k: int = 10,
    chunk: int = 65536,
    scales: Optional[torch.Tensor] = None,  # (N,) f32 for an int8 corpus
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (and of K3 with ``scales``): chunked f32 scores
    (products of bf16 values are exact in f32; int8 codes widen exactly and
    the row scale multiplies the dot) with a running (score desc, id asc)
    merge, so the full (Q, N) score matrix never exists."""
    q = queries.float() if scales is not None else _dot_dtype_queries(queries, corpus)
    n = corpus.shape[0]
    best_s = best_i = None
    for start in range(0, n, chunk):
        c = corpus[start:start + chunk].float()
        s = q @ c.T
        if scales is not None:
            s = s * scales[start:start + chunk].float()[None, :]
        # within a chunk ids increase with the column, so a stable sort
        # already breaks score ties toward the lowest id
        order = torch.argsort(s, dim=1, descending=True, stable=True)[:, :k]
        cs = torch.gather(s, 1, order)
        ci = (order + start).to(torch.int32)
        if best_s is None:
            best_s, best_i = cs, ci
            continue
        # running winners hold lower ids than this chunk: put them first
        ms = torch.cat([best_s, cs], dim=1)
        mi = torch.cat([best_i, ci], dim=1)
        order = torch.argsort(ms, dim=1, descending=True, stable=True)[:, :k]
        best_s, best_i = torch.gather(ms, 1, order), torch.gather(mi, 1, order)
    return best_s, best_i


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, N={n}]")


# ---------------------------------------------------------------------------
# The large-k route (k > MAX_K): csrc/topk_select.cu
# ---------------------------------------------------------------------------

def _select_row_bytes(n: int, k: int) -> int:
    """The select's workspace a row (``_select_work`` less its alignment)."""
    return _SELECT_ZEROED * 4 + max(1, min(n, _SELECT_CAP)) * 8 + (8 * k if k > _SORT_RUN else 0)


def _select_work(rows: int, n: int, k: int, dev) -> torch.Tensor:
    """The select kernel's workspace for ``rows`` rows of ``n`` at k, as
    ``work_layout`` of ``csrc/topk_select.cu`` lays it out (and checks its
    size): a row's counters (four ints) and two histograms, its min(n, 8,192)
    candidates as (key, id), and past one sort run the merge passes'
    second (score, id) buffer, each part 16-byte aligned."""
    def align(x):
        return -(-x // 16) * 16

    size = align(rows * _SELECT_ZEROED * 4) + rows * max(1, min(n, _SELECT_CAP)) * 8
    if k > _SORT_RUN:
        size = align(align(size) + rows * k * 4) + rows * k * 4
    return torch.empty(size, dtype=torch.uint8, device=dev)


def topk_select_cuda(
    scores: torch.Tensor,
    k: int,
    ids: Optional[torch.Tensor] = None,
    segments: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The large-k route's select kernel: the top k of each row by (score
    desc, id asc), sorted; rows with fewer than k candidates pad with
    (−inf, −1). scores (R, n) f32, or with ``segments`` (U, R, M), read as R
    rows of U·M candidates (entry (u, r, m) is candidate u·M + m of row r:
    the IVF scan's per-probe scores in place); ``ids`` int32 of the same
    shape, or None for positions (a candidate's index in its row). An
    int32 ``scores`` is taken as int keys (K9's packets), padded with 0.
    Contiguous CUDA tensors. → (scores (R, k) of scores' dtype, ids (R, k)
    int32)."""
    _cuda.require_cuda(scores, "scores", (torch.float32, torch.int32), 3 if segments else 2)
    if ids is not None:
        _cuda.require_cuda(ids, "ids", (torch.int32,), scores.dim())
        if ids.shape != scores.shape or ids.device != scores.device:
            raise ValueError(f"ids {tuple(ids.shape)} must match scores {tuple(scores.shape)}")
    if segments:
        u, rows, m = scores.shape
        n, seg_len, seg_stride = u * m, m, rows * m
    else:
        rows, n = scores.shape
        seg_len, seg_stride = max(n, 1), 0
    if k < 1:
        raise ValueError(f"k={k} must be ≥ 1")
    dev = scores.device
    out_s = torch.empty((rows, k), dtype=scores.dtype, device=dev)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=dev)
    if rows == 0:
        return out_s, out_i
    work = _select_work(rows, n, k, dev)
    err = _cuda.lib().ts_topk_select(
        scores.data_ptr(), ids.data_ptr() if ids is not None else None, rows, n, seg_len,
        seg_stride, seg_len, k, out_s.data_ptr(), out_i.data_ptr(), work.data_ptr(),
        work.numel(), int(scores.dtype == torch.int32), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "top-k select kernel")
    topk_select_cuda.launches += 1
    return out_s, out_i


topk_select_cuda.launches = 0


def cosine_topk_large_cuda(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (and K3 with ``scales``) at any k on the card, the route taken
    above ``MAX_K``: for each chunk of queries whose (Qc, N) f32 scores and
    the select's workspace fit ``_SCORES_BYTES``, the score tile writes them
    (K2's and K3's bits) and counts their leading key digits, then the
    select kernel takes each query's top k by (score desc, id asc) and sorts
    it (``csrc/topk_select.cu``). Inputs as ``cosine_topk_cuda``
    / ``cosine_topk_int8_cuda`` check them. Each chunk adds one to
    ``cosine_topk_large_cuda.launches`` (K3: ``.launches_int8``) and to
    ``topk_select_cuda.launches``."""
    q_n, d = queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_s, out_i
    ld = -(-n // 4) * 4
    chunk = max(1, min(q_n, _SCORES_BYTES // (4 * ld + _select_row_bytes(n, k))))
    scores = torch.empty((chunk, ld), dtype=torch.float32, device=dev)
    work = _select_work(chunk, n, k, dev)
    kind = 2 if scales is not None else int(corpus.dtype == torch.bfloat16)
    for c0 in range(0, q_n, chunk):
        qc = min(chunk, q_n - c0)
        _, splits, rows_per_split = _plan_topk(qc, n)
        err = _cuda.lib().ts_topk_large(
            queries[c0].data_ptr(), corpus.data_ptr(), kind,
            scales.data_ptr() if scales is not None else None, qc, n, d, k, splits,
            rows_per_split, scores.data_ptr(), ld, out_s[c0].data_ptr(), out_i[c0].data_ptr(),
            work.data_ptr(), work.numel(), _cuda.stream_handle(dev),
        )
        _cuda.check(err, "large-k top-k kernels")
        if scales is not None:
            cosine_topk_large_cuda.launches_int8 += 1
        else:
            cosine_topk_large_cuda.launches += 1
        topk_select_cuda.launches += 1
    return out_s, out_i


cosine_topk_large_cuda.launches = 0
cosine_topk_large_cuda.launches_int8 = 0


_SMS = 132   # streaming multiprocessors of an H100 SXM


def _qtile(q_n: int, k: int = 1) -> int:
    """The query tile (QT) of the score-tile kernels (K2, K3, K8's passes)
    for ``q_n`` queries: 16 up to 16 queries, 64 up to 64, 128 above; K2's
    and K3's is
    capped by k, since each query's selector takes 2·kp (score, id) pairs
    of shared memory (kp = pow2 ≥ max(k, 32)). Mirrors ``qt_for`` of
    ``csrc/score_tile.cuh``, which picks the kernel; here it sizes the grid."""
    qt = 16 if q_n <= 16 else 64 if q_n <= 64 else 128
    kp = max(32, 1 << (k - 1).bit_length())
    return min(qt, 128 if kp <= 32 else 64 if kp <= 64 else 16)


@functools.lru_cache(maxsize=4096)
def _runs(base: int, units: int) -> Tuple[int, int]:
    """Cut ``units`` (128-row tiles, or corpus blocks) into runs of equal
    length, one CTA a run for each of ``base`` CTAs (query tiles × class
    tiles) → (runs, units a run). A score-tile CTA holds an SM, so the
    length taken is the one with the fewest waves of 132 CTAs × units a
    run, among those that give at least 132 CTAs where base × units
    allows (ties: fewer runs)."""
    need = min(_SMS, base * units)
    best = None
    for runs in range(1, min(units, -(-4 * _SMS // base)) + 1):
        per = -(-units // runs)
        got = -(-units // per)
        if base * got < need:
            continue
        cost = (-(-base * got // _SMS) * per, got)
        if best is None or cost < best[0]:
            best = (cost, got, per)
    return best[1], best[2]


def _plan_topk(q_n: int, n: int, k: int = 1) -> Tuple[int, int, int]:
    """K2's, K3's and K8's count grid → (QT, splits, rows_per_split): splits of
    whole 128-row tiles (the last one ragged)."""
    qt = _qtile(q_n, k)
    splits, per = _runs(-(-q_n // qt), -(-n // 128))
    return qt, splits, per * 128


def cosine_topk_cuda(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 on the card. queries (Q, D) f32, corpus (N, D) f32 or
    bf16, both contiguous CUDA tensors; D a multiple of 32, 1 ≤ k ≤ N;
    above ``MAX_K`` the large-k route (``cosine_topk_large_cuda``).
    → (scores (Q, k) f32, ids (Q, k) int32)."""
    _cuda.require_cuda(queries, "queries", (torch.float32,), 2)
    _cuda.require_cuda(corpus, "corpus", (torch.float32, torch.bfloat16), 2)
    q_n, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d or d % 32 or d > 1024:
        raise ValueError(f"dims: queries {d}, corpus {corpus.shape[1]} (need equal, %32, ≤1024)")
    if queries.device != corpus.device:
        raise ValueError("queries and corpus must be on one device")
    _check_k(k, n)
    if k > MAX_K:
        return cosine_topk_large_cuda(queries, corpus, k)
    dev = corpus.device
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_s, out_i
    _, splits, rows_per_split = _plan_topk(q_n, n, k)
    part_s = torch.empty((q_n, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, splits, k), dtype=torch.int32, device=dev)
    err = _cuda.lib().ts_cosine_topk(
        queries.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16),
        q_n, n, d, k, splits, rows_per_split,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "cosine_topk kernel")
    cosine_topk_cuda.launches += 1
    return out_s, out_i


cosine_topk_cuda.launches = 0


def cosine_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k (inputs L2-normalized): the CUDA kernel for a
    CUDA corpus, the plain version for a CPU corpus."""
    if corpus.is_cuda:
        return cosine_topk_cuda(queries.float().contiguous(), corpus.contiguous(), k)
    _check_k(k, corpus.shape[0])
    return cosine_topk_reference(queries, corpus, k)


def cosine_topk_int8_reference(
    queries: torch.Tensor,   # (Q, D) f32 L2-normalized
    corpus_q: torch.Tensor,  # (N, D) int8
    scales: torch.Tensor,    # (N,) f32 per-row scales
    k: int = 10,
    chunk: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: top-k of ``(q · float(c)) × scale`` by (score
    desc, id asc), queries in f32 (not quantized)."""
    return cosine_topk_reference(queries, corpus_q, k, chunk, scales=scales)


def cosine_topk_int8_cuda(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    scales: torch.Tensor,
    k: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 on the card: K2's score tile and merge (``csrc/topk.cu`` on
    ``csrc/score_tile.cuh``, the grid of ``_plan_topk``) over int8 codes,
    each stage's codes widened to f32 once in shared memory; a score is
    the fmaf chain over the dims in order (f32 queries, not quantized)
    times the row's scale, so it equals K2's score over ``c.float()``
    times ``scale`` bit for bit and does not depend on Q.
    queries (Q, D) f32, corpus_q (N, D) int8, scales (N,) f32, contiguous
    CUDA tensors; D a multiple of 32, 1 ≤ k ≤ N; above ``MAX_K`` the
    large-k route (``cosine_topk_large_cuda``).
    → (scores (Q, k) f32, ids (Q, k) int32)."""
    _cuda.require_cuda(queries, "queries", (torch.float32,), 2)
    _cuda.require_cuda(corpus_q, "corpus_q", (torch.int8,), 2)
    _cuda.require_cuda(scales, "scales", (torch.float32,), 1)
    q_n, d = queries.shape
    n = corpus_q.shape[0]
    if corpus_q.shape[1] != d or d % 32 or d > 1024:
        raise ValueError(f"dims: queries {d}, corpus {corpus_q.shape[1]} (need equal, %32, ≤1024)")
    if scales.shape[0] != n:
        raise ValueError(f"scales {tuple(scales.shape)} != ({n},)")
    if not queries.device == corpus_q.device == scales.device:
        raise ValueError("queries, corpus and scales must be on one device")
    _check_k(k, n)
    if k > MAX_K:
        return cosine_topk_large_cuda(queries, corpus_q, k, scales)
    dev = corpus_q.device
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_s, out_i
    _, splits, rows_per_split = _plan_topk(q_n, n, k)
    part_s = torch.empty((q_n, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, splits, k), dtype=torch.int32, device=dev)
    err = _cuda.lib().ts_cosine_topk_int8(
        queries.data_ptr(), corpus_q.data_ptr(), scales.data_ptr(),
        q_n, n, d, k, splits, rows_per_split,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "cosine_topk_int8 kernel")
    cosine_topk_int8_cuda.launches += 1
    return out_s, out_i


cosine_topk_int8_cuda.launches = 0


def cosine_topk_int8(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    scales: torch.Tensor,
    k: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an int8 corpus (queries L2-normalized): K3 for a
    CUDA corpus, the plain version for a CPU corpus."""
    if corpus_q.is_cuda:
        return cosine_topk_int8_cuda(
            queries.float().contiguous(), corpus_q.contiguous(), scales.float().contiguous(), k
        )
    _check_k(k, corpus_q.shape[0])
    return cosine_topk_int8_reference(queries, corpus_q, scales, k)


# ---------------------------------------------------------------------------
# Certified two-pass top-k (kernel K8)
# ---------------------------------------------------------------------------

def exact_merge_rounds(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int):
    """k rounds of (row max → lowest id among the maxima → mask that
    (score, id)) over the candidates, the reference's
    ``_exact_merge_rounds``; a masked candidate keeps its id. → ((Q, k)
    scores, (Q, k) int32 ids)."""
    cand = cand_s.clone()
    new_s = torch.zeros((cand.shape[0], k), dtype=torch.float32, device=cand.device)
    new_i = torch.zeros((cand.shape[0], k), dtype=torch.int32, device=cand.device)
    for r in range(k):
        m = cand.amax(dim=1)
        hit = cand == m[:, None]
        picked = torch.where(hit, cand_i, _INT_MAX).amin(dim=1)
        new_s[:, r] = m
        new_i[:, r] = picked
        cand = torch.where(hit & (cand_i == picked[:, None]), -torch.inf, cand)
    return new_s, new_i


def _block_scores(q: torch.Tensor, corpus: torch.Tensor, start: int, block_c: int) -> torch.Tensor:
    """Scores of corpus rows [start, start + block_c), with −inf for rows
    past the corpus → (Q, block_c) f32. Both plain passes take their scores
    from here, so pass B counts the very scores pass A folded."""
    s = q @ corpus[start:start + block_c].float().T
    pad = block_c - s.shape[1]
    return torch.nn.functional.pad(s, (0, pad), value=-torch.inf) if pad else s


def topk_2pass_fold_plain(queries, corpus, k: int, block_c: int):
    """Plain version of K8's pass A: per lane class (position mod
    ``block_c``) the running best (score, id) over the corpus blocks, strict
    > (empty classes hold (−inf, −1)), then ``exact_merge_rounds`` → ((Q,
    k) f32, (Q, k) int32)."""
    q = _dot_dtype_queries(queries, corpus)
    acc_s = torch.full((q.shape[0], block_c), -torch.inf, device=q.device)
    acc_i = torch.full((q.shape[0], block_c), -1, dtype=torch.int32, device=q.device)
    col = torch.arange(block_c, dtype=torch.int32, device=q.device)
    for start in range(0, corpus.shape[0], block_c):
        s = _block_scores(q, corpus, start, block_c)
        upd = s > acc_s
        acc_s = torch.where(upd, s, acc_s)
        acc_i = torch.where(upd, col + start, acc_i)
    return exact_merge_rounds(acc_s, acc_i, k)


def topk_2pass_count_plain(queries, corpus, thr: torch.Tensor, block_c: int) -> torch.Tensor:
    """Plain version of K8's pass B: per query, the number of corpus scores
    strictly above ``thr`` → (Q,) int32."""
    q = _dot_dtype_queries(queries, corpus)
    cnt = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for start in range(0, corpus.shape[0], block_c):
        cnt += (_block_scores(q, corpus, start, block_c) > thr[:, None]).sum(dim=1, dtype=torch.int32)
    return cnt


def _check_2pass(queries, corpus, k: int, block_c: int) -> None:
    _cuda.require_cuda(queries, "queries", (torch.float32,), 2)
    _cuda.require_cuda(corpus, "corpus", (torch.float32, torch.bfloat16), 2)
    d = queries.shape[1]
    if corpus.shape[1] != d or d % 32 or d > 1024:
        raise ValueError(f"dims: queries {d}, corpus {corpus.shape[1]} (need equal, %32, ≤1024)")
    if queries.device != corpus.device:
        raise ValueError("queries and corpus must be on one device")
    if not 1 <= block_c <= 16384:
        raise ValueError(f"block_c={block_c} must be in [1, 16384]")
    _check_k(k, corpus.shape[0])


def _plan_fold(q_n: int, n: int, block_c: int) -> Tuple[int, int, int]:
    """K8's fold grid → (QT, splits, corpus blocks a split) over the
    (query tile, 128-class tile, split) CTAs."""
    qt = _qtile(q_n)
    splits, per = _runs(-(-q_n // qt) * -(-block_c // 128), -(-n // block_c))
    return qt, splits, per


def _fold_cuda(queries, corpus, k: int, block_c: int, keep_scores: bool):
    """K8's pass A on the card → (out_s, out_i, scores): with
    ``keep_scores``, every score the fold computes also goes to a (Q,
    round_up(N, 4)) f32 scratch (4·Q·N bytes) for the streaming pass B."""
    _check_2pass(queries, corpus, k, block_c)
    q_n, d = queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_s, out_i, None
    _, splits, per = _plan_fold(q_n, n, block_c)
    win_s = torch.empty((splits, q_n, block_c), dtype=torch.float32, device=dev)
    win_i = torch.empty((splits, q_n, block_c), dtype=torch.int32, device=dev)
    scores, ld = None, 0
    if keep_scores:
        ld = -(-n // 4) * 4
        scores = torch.empty((q_n, ld), dtype=torch.float32, device=dev)
    head = (queries.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16), q_n, n, d)
    if k > MAX_K:
        _fold_large_cuda(head, q_n, k, block_c, splits, per, win_s, win_i, out_s, out_i,
                         scores, ld, dev)
        return out_s, out_i, scores
    args = (*head, k, block_c, splits, per, win_s.data_ptr(), win_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr())
    if keep_scores:
        err = _cuda.lib().ts_topk_2pass_fold_scores(*args, scores.data_ptr(), ld,
                                                    _cuda.stream_handle(dev))
    else:
        err = _cuda.lib().ts_topk_2pass_fold(*args, _cuda.stream_handle(dev))
    _cuda.check(err, "two-pass top-k fold kernel")
    topk_2pass_fold_cuda.launches += 1
    return out_s, out_i, scores


def _fold_large_cuda(head, q_n, k, block_c, splits, per, win_s, win_i, out_s, out_i, scores,
                     ld, dev):
    """K8's pass A above ``MAX_K``: the fold, then the select kernel over
    the classes' winners in place of the k rounds. Past the block_c
    winners the rounds repeat (−inf, the lowest id of them), and so does
    this."""
    k_sel = min(k, block_c)
    cls_s = torch.empty((q_n, block_c), dtype=torch.float32, device=dev)
    cls_i = torch.empty((q_n, block_c), dtype=torch.int32, device=dev)
    sel_s, sel_i = (out_s, out_i) if k_sel == k else (
        torch.empty((q_n, k_sel), dtype=torch.float32, device=dev),
        torch.empty((q_n, k_sel), dtype=torch.int32, device=dev))
    work = _select_work(q_n, block_c, k_sel, dev)
    err = _cuda.lib().ts_topk_2pass_fold_large(
        *head, k_sel, block_c, splits, per, win_s.data_ptr(), win_i.data_ptr(),
        cls_s.data_ptr(), cls_i.data_ptr(), sel_s.data_ptr(), sel_i.data_ptr(),
        work.data_ptr(), work.numel(),
        scores.data_ptr() if scores is not None else None, ld, _cuda.stream_handle(dev),
    )
    _cuda.check(err, "two-pass top-k fold kernel (large k)")
    topk_2pass_fold_cuda.launches += 1
    topk_2pass_fold_cuda.launches_large += 1
    topk_select_cuda.launches += 1
    if k_sel < k:
        out_s[:, :k_sel], out_i[:, :k_sel] = sel_s, sel_i
        out_s[:, k_sel:] = -torch.inf
        out_i[:, k_sel:] = sel_i.amin(dim=1, keepdim=True)


def topk_2pass_fold_cuda(queries, corpus, k: int, block_c: int = 2048):
    """K8's pass A on the card: the class fold (CTAs over QT queries × 128
    classes × a run of corpus blocks on the score tile, QT = 16, 64 or 128
    by Q; winners to device memory), then one CTA a query runs the k merge
    rounds over its ``block_c`` classes (above ``MAX_K``, the select kernel
    over them: ``launches_large``).
    queries (Q, D) f32, corpus (N, D) f32 or bf16, contiguous CUDA; D a
    multiple of 32. → ((Q, k) f32, (Q, k) int32)."""
    out_s, out_i, _ = _fold_cuda(queries, corpus, k, block_c, False)
    return out_s, out_i


topk_2pass_fold_cuda.launches = 0
topk_2pass_fold_cuda.launches_large = 0


def topk_2pass_count_cuda(queries, corpus, thr: torch.Tensor, block_c: int = 2048,
                          scores: Optional[torch.Tensor] = None):
    """K8's pass B on the card: per query, the number of corpus scores
    strictly above ``thr`` → (Q,) int32, counts added with integer atomics
    (exact, order-free). Without ``scores``, CTAs over (QT-query tile,
    corpus split) compute the scores again on the score tile: pass A's and
    K2's bit for bit (one fmaf chain over the dims in order). With
    ``scores``, pass A's kept (Q, ld) f32 scores (ld ≥ N, a multiple of 4),
    a streaming kernel counts over them, bound by reading them once. Each
    launch adds one to ``topk_2pass_count_cuda.launches``; a launch of the
    streaming kernel also to ``topk_2pass_count_cuda.launches_scores``."""
    _check_2pass(queries, corpus, 1, block_c)
    _cuda.require_cuda(thr, "thr", (torch.float32,), 1)
    q_n, d = queries.shape
    n = corpus.shape[0]
    if thr.shape[0] != q_n:
        raise ValueError(f"thr {tuple(thr.shape)} != ({q_n},)")
    if scores is not None:
        _cuda.require_cuda(scores, "scores", (torch.float32,), 2)
        if (scores.shape[0] != q_n or scores.shape[1] % 4 or scores.shape[1] < n
                or q_n > 65535):
            raise ValueError(f"scores {tuple(scores.shape)} for Q {q_n}, N {n}")
    cnt = torch.zeros(q_n, dtype=torch.int32, device=corpus.device)
    if q_n == 0:
        return cnt
    if scores is not None:
        err = _cuda.lib().ts_topk_2pass_count_scores(
            scores.data_ptr(), scores.shape[1], thr.data_ptr(), q_n, n, cnt.data_ptr(),
            _cuda.stream_handle(corpus.device),
        )
        _cuda.check(err, "two-pass top-k count kernel (kept scores)")
        topk_2pass_count_cuda.launches += 1
        topk_2pass_count_cuda.launches_scores += 1
        return cnt
    _, splits, rows_per_split = _plan_topk(q_n, n)
    err = _cuda.lib().ts_topk_2pass_count(
        queries.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16),
        thr.data_ptr(), q_n, n, d, splits, rows_per_split, cnt.data_ptr(),
        _cuda.stream_handle(corpus.device),
    )
    _cuda.check(err, "two-pass top-k count kernel")
    topk_2pass_count_cuda.launches += 1
    return cnt


topk_2pass_count_cuda.launches = 0
topk_2pass_count_cuda.launches_scores = 0


# Pass B counts over pass A's kept scores where they take at most this many
# f32 values (256 MiB), else it recomputes them on the score tile.
_SCORES_MAX = 1 << 26


def topk_2pass_count_scores_plain(scores: torch.Tensor, thr: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K8's pass B over kept scores: per query, the number
    of the first ``n`` scores of its row strictly above ``thr`` → (Q,)
    int32."""
    return (scores[:, :n] > thr[:, None]).sum(dim=1, dtype=torch.int32)


def _passes_cuda(queries, corpus, k: int, block_c: int):
    """Both passes on the card → (out_s, out_i, thr, count). Where the (Q, N)
    scores fit ``_SCORES_MAX``, pass A keeps them and pass B counts over
    them; else pass B computes them again on the score tile (bit for bit
    pass A's)."""
    n = corpus.shape[0]
    keep = 0 < queries.shape[0] <= 65535 and queries.shape[0] * n <= _SCORES_MAX
    out_s, out_i, scores = _fold_cuda(queries, corpus, k, block_c, keep)
    thr = out_s[:, k - 1].clone()        # its own (aligned) allocation
    return out_s, out_i, thr, topk_2pass_count_cuda(queries, corpus, thr, block_c, scores)


def _passes_plain(queries, corpus, k: int, block_c: int):
    out_s, out_i = topk_2pass_fold_plain(queries, corpus, k, block_c)
    thr = out_s[:, k - 1].clone()
    return out_s, out_i, thr, topk_2pass_count_plain(queries, corpus, thr, block_c)


def _two_pass(queries, corpus, k, block_c, passes, exact):
    out_s, out_i, thr, cnt = passes(queries, corpus, k, block_c)
    cnt_rep = (out_s > thr[:, None]).sum(dim=1, dtype=torch.int32)
    if bool((cnt == cnt_rep).all()):      # one host sync a call
        return out_s, out_i
    cosine_topk_2pass.fallbacks += 1
    return exact(queries, corpus, k)


def cosine_topk_2pass_reference(queries, corpus, k: int = 10, block_c: int = 2048):
    """Plain version of K8: pass A and pass B plain, the certification,
    and the fallback to K2's plain version. → ((Q, k) f32, (Q, k) int32)."""
    _check_k(k, corpus.shape[0])
    return _two_pass(queries, corpus, k, block_c, _passes_plain, cosine_topk_reference)


def cosine_topk_2pass(
    queries: torch.Tensor,  # (Q, D) L2-normalized
    corpus: torch.Tensor,   # (N, D) L2-normalized, f32 or bf16
    k: int = 10,
    block_q: int = 256,
    block_c: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Certified two-pass exact top-k (the reference's
    ``cosine_topk_pallas_2pass``): the kernels for a CUDA corpus, the plain
    versions for a CPU corpus. ``block_c`` sets the lane classes and so
    which calls fall back. ``block_q`` is accepted only so that calls
    written for the reference's signature still work: nothing reads it
    (the port's CTAs take QT = 16, 64 or 128 queries by Q, and K2 takes no
    block size). Dots in
    f32 for an f32 corpus, in bf16 (queries rounded) for a bf16 one, f32
    sums.

    Where the reference decides between its two branches on the device
    (``lax.cond``), the port reads the certification on the host: one
    synchronisation a call. Each fallback adds one to
    ``cosine_topk_2pass.fallbacks``. → ((Q, k) f32, (Q, k) int32)."""
    del block_q
    if corpus.is_cuda:
        # both passes' kernels, the certification, K2 on the card where it fails
        return _two_pass(queries.float().contiguous(), corpus.contiguous(), k, block_c,
                         _passes_cuda, cosine_topk_cuda)
    return cosine_topk_2pass_reference(queries, corpus, k, block_c)


cosine_topk_2pass.fallbacks = 0
