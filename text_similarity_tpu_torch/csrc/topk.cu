// Exact cosine top-k over a dense corpus (kernel K2) or an int8 corpus
// with per-row scales (kernel K3).
//
// K2 replaces text_similarity_tpu/ops/topk.py cosine_topk_pallas →
// _topk_kernel (whose TPU grid walks the corpus in order and carries the
// winners in VMEM). Computes, for each query, the exact top-k of
// q·corpusᵀ over rows [0, N), ordered by (score desc, id asc).
//
// K3 replaces cosine_topk_pallas_int8 → _topk_int8_kernel: the same top-k
// of (q · float(c_row)) × scale_row, with f32 queries (not quantized) and
// the int8 codes widened exactly to f32, one f32 fmaf chain over the dims
// (no TF32), then one f32 multiply by the row's scale: the reference's
// order, dot then scale. It reads a quarter of K2's f32 bytes (N·D int8 +
// N·4 scale bytes: 0.0116 ms at Q 1 × N 100,003 × D 384), so it is
// operation-bound on the CUDA cores above a few queries (0.29 ms at Q 256).
//
// Bound on the H100: an f32 corpus must stay exact (no TF32), so the dot
// products run on the CUDA cores and the kernel is operation-bound there
// (2·Q·N·D flops against 67 TFLOP/s: 0.29 ms at Q 256 × N 100,003 × D 384)
// once Q reaches a few dozen; at the serving batch of 1-64 queries it is
// bound by reading the corpus once (N·D·4 bytes at 3.35 TB/s: 0.046 ms).
//
// Design. CTAs are unordered, so the corpus is split. Pass 1 runs CTAs over
// (query tile, corpus split); pass 2 (merge_runs, one CTA a query) reduces
// the (Q, splits, k) partials to (Q, k). The wrapper sizes the splits so
// the grid fills the 132 SMs in whole waves, even for a single query.
// Both kernels run on score_tile.cuh: a 128-row × QT-query register-blocked
// tile fed by a cp.async ring, QT = 16, 64 or 128 by Q (qt_for), so at Q
// 256 the corpus is staged twice instead of 16 times and shared memory no
// longer binds the product (what does: the note of score_tile.cuh). An
// int8 stage is widened to f32 once, by the threads that copied it, so
// K3's FMA loop is K2's over an f32 corpus, and K3's raw dots equal K2's
// over the widened codes bit for bit. A finished tile's score (K3: times
// the row's scale) becomes a candidate only if it beats its query's
// current k-th (score, id), so after the first tiles a tile gives a query
// a candidate or two; warp w merges the candidates of queries w, w + 8, …:
// for k ≤ 32 into a list of 32 held one a lane (insertion by ballot, or a
// bitonic sort and merge of shuffles for a larger batch), for larger k
// through the warp selector of common.cuh. Pass 2 takes the same two
// paths. QT is capped by k, since each query's selector holds 2·kp pairs
// in shared memory.
#include "common.cuh"
#include "score_tile.cuh"

namespace {

// The per-query selection state (K2, K3) in shared memory, behind the copy ring:
// for each of the CTA's QT queries a selector's list and buffer (2·kp
// (score, id) pairs), its (n, threshold) and the current tile's candidates.
struct TileSelect {
  float* sel_f;            // QT × 2kp scores
  int* sel_i;              // QT × 2kp ids
  int* sel_n;              // QT buffered counts
  float* sel_ts;           // QT thresholds: the current k-th (score, id)
  int* sel_ti;             // QT
  int* cand_n;             // QT candidates of the current tile
  float* cand_s;           // QT × 128
  unsigned char* cand_r;   // QT × 128 rows within the tile
  int kp, k;

  __device__ TileSelect(unsigned char* base, int QT, int k_) : kp(kp_for(k_)), k(k_) {
    cand_s = reinterpret_cast<float*>(base);
    sel_f = cand_s + QT * kTileRows;
    sel_i = reinterpret_cast<int*>(sel_f + QT * 2 * kp);
    sel_n = sel_i + QT * 2 * kp;
    sel_ts = reinterpret_cast<float*>(sel_n + QT);
    sel_ti = reinterpret_cast<int*>(sel_ts + QT);
    cand_n = sel_ti + QT;
    cand_r = reinterpret_cast<unsigned char*>(cand_n + QT);
  }
  static size_t bytes(int QT, int kp) {
    return (size_t)QT * kTileRows * 5 + (size_t)QT * 2 * kp * 8 + (size_t)QT * 16;
  }
  // a selector rebuilt from its shared-memory state (warp-uniform)
  __device__ Selector at(int ql) const {
    Selector s;
    s.ls = sel_f + ql * 2 * kp;
    s.bs = s.ls + kp;
    s.li = sel_i + ql * 2 * kp;
    s.bi = s.li + kp;
    s.kp = kp;
    s.k = k;
    s.n = sel_n[ql];
    s.ts = sel_ts[ql];
    s.ti = sel_ti[ql];
    return s;
  }
  __device__ void keep(int ql, const Selector& s, int lane) const {
    __syncwarp();
    if (lane == 0) {
      sel_n[ql] = s.n;
      sel_ts[ql] = s.ts;
      sel_ti[ql] = s.ti;
      cand_n[ql] = 0;
    }
    __syncwarp();
  }
};

constexpr int kInsertMax = 6;   // candidates a query inserts one by one

// Warp w takes the tile's candidates of queries w, w + 8, … < q_here: for
// k ≤ 32 into a list of 32 in registers (up to kInsertMax by insertion,
// more through warp_merge32), else through the selector of common.cuh.
__device__ __forceinline__ void push_candidates(const TileSelect& ts, int q_here, int row0) {
  const int lane = threadIdx.x & 31;
  for (int ql = threadIdx.x >> 5; ql < q_here; ql += kTileWarps) {
    const int n = ts.cand_n[ql];
    if (n == 0) continue;   // warp-uniform
    if (ts.kp == 32) {
      float* lf = ts.sel_f + ql * 64;
      int* lid = ts.sel_i + ql * 64;
      float ls = lf[lane];
      int li = lid[lane];
      if (n <= kInsertMax) {
        // a few candidates: insert each at its rank (the lanes after it
        // shift down one; lane 31 falls off)
        for (int c = 0; c < n; ++c) {
          const float s = ts.cand_s[ql * kTileRows + c];
          const int id = row0 + ts.cand_r[ql * kTileRows + c];
          const int pos = __popc(__ballot_sync(0xffffffffu, better(ls, li, s, id)));
          const float up_s = __shfl_up_sync(0xffffffffu, ls, 1);
          const int up_i = __shfl_up_sync(0xffffffffu, li, 1);
          if (lane == pos) {
            ls = s;
            li = id;
          } else if (lane > pos) {
            ls = up_s;
            li = up_i;
          }
        }
      } else {
        for (int base = 0; base < n; base += 32) {
          const int c = base + lane;
          const bool has = c < n;
          warp_merge32(ls, li, has ? ts.cand_s[ql * kTileRows + c] : -INFINITY,
                       has ? row0 + ts.cand_r[ql * kTileRows + c] : 0x7fffffff, lane);
        }
      }
      const float ks = __shfl_sync(0xffffffffu, ls, ts.k - 1);
      const int ki = __shfl_sync(0xffffffffu, li, ts.k - 1);
      lf[lane] = ls;
      lid[lane] = li;
      if (lane == 0) {
        ts.sel_ts[ql] = ks;
        ts.sel_ti[ql] = ki;
        ts.cand_n[ql] = 0;
      }
      __syncwarp();
      continue;
    }
    Selector s = ts.at(ql);
    for (int base = 0; base < n; base += 32) {
      const int c = base + lane;
      const bool has = c < n;
      sel_push(s, has, has ? ts.cand_s[ql * kTileRows + c] : -INFINITY,
               has ? row0 + ts.cand_r[ql * kTileRows + c] : -1, lane);
    }
    ts.keep(ql, s, lane);
  }
}

// K2's and K3's pass 1 on the score tile: CTA (query tile of QT, corpus
// split) → part_s / part_i (Q, splits, k). A finished tile's score (K3:
// times the row's scale) becomes a
// candidate only if it beats its query's current k-th (score, id), which
// the query's list publishes in shared memory; warp w then merges the
// candidates of queries w, w + 8, … (push_candidates). After the first
// tiles few scores pass, so the selection costs little beside the product.
template <typename T, int QT>
__global__ void __launch_bounds__(kTileThreads, 1)
topk_tile_pass1(const float* __restrict__ q, const T* __restrict__ corpus,
                const float* __restrict__ scales, int Q, int N, int D, int k,
                int rows_per_split, int splits, float* __restrict__ part_s,
                int* __restrict__ part_i) {
  using S = ScoreTile<T, QT>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const TileSelect sel(tile_smem + S::kRingBytes, QT, k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = S::qg_of(tid), rg = S::rg_of(tid);
  const int q0 = blockIdx.x * QT, split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int q_here = min(QT, Q - q0);
  for (int ql = warp; ql < QT; ql += kTileWarps) {
    Selector s;
    sel_init(s, sel.sel_f + ql * 2 * sel.kp, sel.sel_i + ql * 2 * sel.kp, k, lane);
    sel.keep(ql, s, lane);   // queries past Q keep −inf and are never read
  }
  // the first ring step's barrier publishes the selectors' state

  const int n_tiles = (row_end - row_begin + kTileRows - 1) / kTileRows;
  auto tile_of = [&](int t) {
    const int row0 = row_begin + t * kTileRows;
    return make_int2(row0, min(kTileRows, row_end - row0));
  };
  auto epi = [&](int t, float (&acc)[S::RM][S::QN]) {
    const int row0 = row_begin + t * kTileRows;
    const int nv = min(kTileRows, row_end - row0);
    if constexpr (std::is_same_v<T, int8_t>) {
      // K3: the dot, then one f32 multiply by the row's scale
#pragma unroll
      for (int i = 0; i < S::RM; ++i) {
        const int r = rg + S::RG * i;
        const float sc = r < nv ? scales[row0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < S::QN; ++j) acc[i][j] *= sc;
      }
    }
    // the thresholds were last written before the previous ring step's
    // barrier, the candidate counts reset there too
#pragma unroll
    for (int j = 0; j < S::QN; ++j) {
      const int ql = qg + S::QG * j;
      if (ql >= q_here) continue;
      const float ts = sel.sel_ts[ql];
      const int ti = sel.sel_ti[ql];
      unsigned pass = 0;
#pragma unroll
      for (int i = 0; i < S::RM; ++i) {
        const int r = rg + S::RG * i;
        if (r < nv && better(acc[i][j], row0 + r, ts, ti)) pass |= 1u << i;
      }
      if (pass == 0) continue;
      int pos = atomicAdd(sel.cand_n + ql, __popc(pass));   // one atomic a thread
#pragma unroll
      for (int i = 0; i < S::RM; ++i)
        if (pass >> i & 1u) {
          sel.cand_s[ql * kTileRows + pos] = acc[i][j];
          sel.cand_r[ql * kTileRows + pos] = static_cast<unsigned char>(rg + S::RG * i);
          ++pos;
        }
    }
    __syncthreads();
    // the lists are rewritten only after the next ring step's barrier
    push_candidates(sel, q_here, row0);
  };
  score_tiles<T, QT>(q, Q, q0, corpus, D, n_tiles, tile_of, epi, tile_smem);
  for (int ql = warp; ql < q_here; ql += kTileWarps) {
    Selector s = sel.at(ql);
    if (sel.kp != 32) sel_flush(s, lane);   // k ≤ 32: the list is already exact
    const size_t o = ((size_t)(q0 + ql) * splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[o + j] = s.ls[j];
      part_i[o + j] = s.li[j];
    }
  }
}

// K2's and K3's pass 2: one CTA a query reduces its (splits, k) partials
// to k. Each warp takes every 8th run of 32 partials, with the next run's
// loads in flight while it takes one (k ≤ 32: warp_merge32 into a list in
// registers; else its own selector); warp 0 then takes the other warps'
// lists. Exact whatever the order, by (score desc, id asc).
__global__ void __launch_bounds__(kTileThreads)
merge_runs(const float* __restrict__ part_s, const int* __restrict__ part_i, int P, int k,
           float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  const int kp = kp_for(k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* fbase = reinterpret_cast<float*>(merge_smem);                    // 8 × 2kp
  int* ibase = reinterpret_cast<int*>(fbase + kTileWarps * 2 * kp);       // 8 × 2kp
  const int total = P * k;
  const float* ps = part_s + (size_t)blockIdx.x * total;
  const int* pi = part_i + (size_t)blockIdx.x * total;
  float* out_f = out_s + (size_t)blockIdx.x * k;
  int* out_d = out_i + (size_t)blockIdx.x * k;
  int j = warp * 32 + lane;
  float sc = j < total ? ps[j] : -INFINITY;
  int id = j < total ? pi[j] : 0x7fffffff;
  if (kp == 32) {
    float ls = -INFINITY;
    int li = -1;
    for (int base = warp * 32; base < total; base += kTileThreads) {
      const int jn = base + kTileThreads + lane;
      const float sc_next = jn < total ? ps[jn] : -INFINITY;
      const int id_next = jn < total ? pi[jn] : 0x7fffffff;
      warp_merge32(ls, li, sc, id, lane);
      sc = sc_next;
      id = id_next;
    }
    fbase[warp * 32 + lane] = ls;
    ibase[warp * 32 + lane] = li;
    __syncthreads();
    if (warp != 0) return;
    for (int w = 1; w < kTileWarps; ++w)
      warp_merge32(ls, li, fbase[w * 32 + lane], ibase[w * 32 + lane], lane);
    if (lane < k) {
      out_f[lane] = ls;
      out_d[lane] = li;
    }
    return;
  }
  Selector s;
  sel_init(s, fbase + warp * 2 * kp, ibase + warp * 2 * kp, k, lane);
  for (int base = warp * 32; base < total; base += kTileThreads) {
    const int jn = base + kTileThreads + lane;
    const float sc_next = jn < total ? ps[jn] : -INFINITY;
    const int id_next = jn < total ? pi[jn] : -1;
    sel_push(s, base + lane < total, sc, id, lane);
    sc = sc_next;
    id = id_next;
  }
  sel_flush(s, lane);
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kTileWarps; ++w)
    for (int b = 0; b < k; b += 32) {
      const int e = w * 2 * kp + b + lane;
      sel_push(s, b + lane < k, fbase[e], ibase[e], lane);
    }
  sel_flush(s, lane);
  for (int e = lane; e < k; e += 32) {
    out_f[e] = s.ls[e];
    out_d[e] = s.li[e];
  }
}

template <typename T, int QT>
cudaError_t launch_tile_pass1(const float* q, const T* corpus, const float* scales, int Q, int N,
                              int D, int k, int splits, int rows_per_split, float* part_s,
                              int* part_i, cudaStream_t st) {
  const size_t smem = ScoreTile<T, QT>::kRingBytes + TileSelect::bytes(QT, host_kp_for(k));
  cudaError_t err = cudaFuncSetAttribute(topk_tile_pass1<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + QT - 1) / QT, splits);
  topk_tile_pass1<T, QT><<<grid, kTileThreads, smem, st>>>(
      q, corpus, scales, Q, N, D, k, rows_per_split, splits, part_s, part_i);
  return cudaGetLastError();
}

// scales: the int8 corpus's per-row scales (K3), nullptr for K2.
template <typename T>
cudaError_t run_tile_topk(const float* q, const T* corpus, const float* scales, int Q, int N,
                          int D, int k, int splits, int rows_per_split, float* part_s,
                          int* part_i, float* out_s, int* out_i, cudaStream_t st) {
  cudaError_t err;
  switch (qt_for(Q, k)) {
    case 16:
      err = launch_tile_pass1<T, 16>(q, corpus, scales, Q, N, D, k, splits, rows_per_split,
                                     part_s, part_i, st);
      break;
    case 64:
      err = launch_tile_pass1<T, 64>(q, corpus, scales, Q, N, D, k, splits, rows_per_split,
                                     part_s, part_i, st);
      break;
    default:
      err = launch_tile_pass1<T, 128>(q, corpus, scales, Q, N, D, k, splits, rows_per_split,
                                      part_s, part_i, st);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)kTileWarps * 2 * host_kp_for(k) * (sizeof(float) + sizeof(int));
  merge_runs<<<Q, kTileThreads, smem, st>>>(part_s, part_i, splits, k, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ts_cosine_topk(const float* q, const void* corpus, int corpus_bf16,
                              int Q, int N, int D, int k, int splits,
                              int rows_per_split, float* part_s, int* part_i,
                              float* out_s, int* out_i, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (corpus_bf16)
    return (int)run_tile_topk(q, static_cast<const __nv_bfloat16*>(corpus), nullptr, Q, N, D,
                              k, splits, rows_per_split, part_s, part_i, out_s, out_i, st);
  return (int)run_tile_topk(q, static_cast<const float*>(corpus), nullptr, Q, N, D, k, splits,
                            rows_per_split, part_s, part_i, out_s, out_i, st);
}

// K3: int8 corpus (N, D) with per-row f32 scales (N,).
extern "C" int ts_cosine_topk_int8(const float* q, const int8_t* corpus,
                                   const float* scales, int Q, int N, int D, int k,
                                   int splits, int rows_per_split, float* part_s,
                                   int* part_i, float* out_s, int* out_i, void* stream) {
  return (int)run_tile_topk(q, corpus, scales, Q, N, D, k, splits, rows_per_split, part_s,
                            part_i, out_s, out_i, reinterpret_cast<cudaStream_t>(stream));
}
