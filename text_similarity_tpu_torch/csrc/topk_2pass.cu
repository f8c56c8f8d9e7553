// Certified two-pass exact top-k (kernel K8).
//
// Replaces text_similarity_tpu/ops/topk.py cosine_topk_pallas_2pass: pass A
// _topk_fold_kernel (the pallas_call at :445) and pass B _topk_count_kernel
// (:474). For each query, over corpus rows [0, N):
//  * pass A: a lane class is the set of rows with one position mod block_c;
//    each class keeps its best (score, id), strict > in row order, so the
//    lower id wins a tie (empty classes hold (-inf, -1)); then k merge rounds
//    (the reference's _exact_merge_rounds: the row max, the lowest id among
//    the maxima, that (score, id) masked to -inf, its id kept) give the
//    reported top k;
//  * pass B: the count of scores strictly above the reported k-th.
// The wrapper compares the count with the count among the reported k and
// falls back to K2 where they differ (a class hid a winner).
//
// Bound on the H100: at the timed shape (Q 256, N 100,003, D 384, f32) the
// function needs the Q·N·D f32 dot once (2·Q·N·D = 19.7 GFLOP against 67
// TFLOP/s on the CUDA cores: 0.29 ms); the corpus is 154 MB (0.046 ms).
//
// Design. Pass A runs on the score tile of score_tile.cuh (a 128-row ×
// QT-query register-blocked f32 tile fed by a cp.async ring, QT = 16, 64 or
// 128 by Q), so every score is K2's, bit for bit.
//  * The fold. The TPU keeps a (block_q, block_c) accumulator in VMEM (4 MB
//    at 256 × 2048), far over a CTA's shared memory, so the classes are
//    split across CTAs: CTA (query tile, 128-class tile, run of corpus
//    blocks) scores, block by block, the 128 contiguous rows of its classes;
//    thread (rg, qg) keeps the running (best score, lowest id) of its RM
//    classes × QN queries in shared memory (thread-major, so conflict-free;
//    128 KB at QT 128), strict > in row order, and writes its winners to
//    device memory. select_winners then runs one CTA a query: it folds the
//    runs of each class in row order (strict >) and runs the k rounds as
//    block-wide (score desc, id asc) reductions over the block_c classes.
//  * The product once. Where the caller gives it a (Q, ld) f32 scratch (ld =
//    round_up(N, 4): 4·Q·ld bytes, 102 MB at the timed shape; the wrapper
//    does so while Q·N ≤ 2^26), the fold also writes every score it
//    computes there, and pass B (count_scores_above) streams over them:
//    bound by reading them once (4·Q·N bytes: 0.031 ms at the timed shape)
//    instead of a second product.
//  * The count on the tile, where the scores were not kept: CTA (query tile,
//    corpus split) computes the scores again (the same bits), counts, per
//    query, those strictly above thr in registers, sums them in shared
//    memory and adds one integer atomic a query.
// Both counts are exact and order-free, so the certification compares
// counts of exactly the scores the fold folded.
//  * k > 256: the k rounds give way to topk_select.cu's select over the
//    classes' winners (fold_splits, then ts_topk_select): the same top k by
//    (score desc, id asc). A bf16 corpus rounds the
// queries to bf16, as the reference; sums are f32 throughout.
#include "score_tile.cuh"

namespace {

constexpr int kSelectThreads = 256;
constexpr int kIntMax = 0x7fffffff;

// Pass A, the fold: CTA (query tile, class tile, split) → win_s / win_i
// (splits, Q, block_c) for its classes and its run of corpus blocks.
template <typename T, int QT>
__global__ void __launch_bounds__(kTileThreads, 1)
fold_classes(const float* __restrict__ q, const T* __restrict__ corpus, int Q, int N, int D,
             int block_c, int blocks_per_split, float* __restrict__ win_s,
             int* __restrict__ win_i, float* __restrict__ scores, int ld) {
  using S = ScoreTile<T, QT>;
  constexpr int kOwn = S::RM * S::QN;   // (class, query) pairs a thread keeps
  extern __shared__ __align__(16) unsigned char fold_smem[];
  float* best_s = reinterpret_cast<float*>(fold_smem + S::kRingBytes);   // kOwn × 256
  int* best_i = reinterpret_cast<int*>(best_s + kOwn * kTileThreads);    // kOwn × 256
  const int tid = threadIdx.x;
  const int qg = S::qg_of(tid), rg = S::rg_of(tid);
  const int q0 = blockIdx.x * QT;
  const int c0 = blockIdx.y * kTileRows;
  const int split = blockIdx.z;
#pragma unroll
  for (int e = 0; e < kOwn; ++e) {
    best_s[e * kTileThreads + tid] = -INFINITY;
    best_i[e * kTileThreads + tid] = -1;
  }
  const int width = min(kTileRows, block_c - c0);   // classes of this tile
  const int b_begin = split * blocks_per_split;
  const int b_end = min(b_begin + blocks_per_split, (N + block_c - 1) / block_c);
  // the blocks whose rows of these classes start before N
  const int n_tiles = c0 < N ? max(0, min(b_end, (N - 1 - c0) / block_c + 1) - b_begin) : 0;
  auto tile_of = [&](int t) {
    const int row0 = (b_begin + t) * block_c + c0;
    return make_int2(row0, min(width, N - row0));
  };
  auto epi = [&](int t, float (&acc)[S::RM][S::QN]) {
    const int row0 = (b_begin + t) * block_c + c0;
    const int nv = min(width, N - row0);
#pragma unroll
    for (int i = 0; i < S::RM; ++i) {
      const int r = rg + S::RG * i;
      if (r >= nv) continue;
#pragma unroll
      for (int j = 0; j < S::QN; ++j) {
        const int e = (i * S::QN + j) * kTileThreads + tid;
        const int qi = q0 + qg + S::QG * j;
        if (scores != nullptr && qi < Q) scores[(size_t)qi * ld + row0 + r] = acc[i][j];
        if (acc[i][j] > best_s[e]) {
          best_s[e] = acc[i][j];
          best_i[e] = row0 + r;
        }
      }
    }
  };
  score_tiles<T, QT>(q, Q, q0, corpus, D, n_tiles, tile_of, epi, fold_smem);
#pragma unroll
  for (int i = 0; i < S::RM; ++i) {
    const int r = rg + S::RG * i;
    if (r >= width) continue;
#pragma unroll
    for (int j = 0; j < S::QN; ++j) {
      const int qi = q0 + qg + S::QG * j;
      if (qi >= Q) continue;
      const int e = (i * S::QN + j) * kTileThreads + tid;
      const size_t o = ((size_t)split * Q + qi) * block_c + c0 + r;
      win_s[o] = best_s[e];
      win_i[o] = best_i[e];
    }
  }
}

__device__ __forceinline__ bool ahead(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Pass A, the merge: one CTA a query folds the splits of each class (strict
// >, in split order: lower rows first), then runs the k rounds.
__global__ void __launch_bounds__(kSelectThreads)
select_winners(const float* __restrict__ win_s, const int* __restrict__ win_i, int Q,
               int block_c, int splits, int k, float* __restrict__ out_s,
               int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  float* cs = reinterpret_cast<float*>(sel_smem);     // block_c
  int* ci = reinterpret_cast<int*>(cs + block_c);     // block_c
  __shared__ float red_s[kSelectThreads / 32];
  __shared__ int red_i[kSelectThreads / 32];
  const int qi = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int c = threadIdx.x; c < block_c; c += kSelectThreads) {
    float s = -INFINITY;
    int id = -1;
    for (int sp = 0; sp < splits; ++sp) {
      const size_t o = ((size_t)sp * Q + qi) * block_c + c;
      const float v = win_s[o];
      if (v > s) {
        s = v;
        id = win_i[o];
      }
    }
    cs[c] = s;
    ci[c] = id;
  }
  __syncthreads();
  for (int round = 0; round < k; ++round) {
    float bs = -INFINITY;
    int bi = kIntMax;   // a thread with no class never beats a real one
    for (int c = threadIdx.x; c < block_c; c += kSelectThreads)
      if (ahead(cs[c], ci[c], bs, bi)) {
        bs = cs[c];
        bi = ci[c];
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ahead(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    bs = red_s[0];
    bi = red_i[0];
#pragma unroll
    for (int w = 1; w < kSelectThreads / 32; ++w)
      if (ahead(red_s[w], red_i[w], bs, bi)) {
        bs = red_s[w];
        bi = red_i[w];
      }
    if (threadIdx.x == 0) {
      out_s[(size_t)qi * k + round] = bs;
      out_i[(size_t)qi * k + round] = bi;
    }
    for (int c = threadIdx.x; c < block_c; c += kSelectThreads)
      if (cs[c] == bs && ci[c] == bi) cs[c] = -INFINITY;
    __syncthreads();   // masks written, red_* read by every thread
  }
}

// The large-k route's merge of pass A (k > 256): CTA (query, class chunk)
// folds the splits of each class as select_winners does (strict >, in
// split order: lower rows first) into cls (Q, block_c); topk_select.cu's
// ts_topk_select then takes the top k of those winners, as the k rounds
// would.
__global__ void __launch_bounds__(kSelectThreads)
fold_splits(const float* __restrict__ win_s, const int* __restrict__ win_i, int Q, int block_c,
            int splits, float* __restrict__ cls_s, int* __restrict__ cls_i) {
  const int c = blockIdx.y * kSelectThreads + threadIdx.x;
  const int qi = blockIdx.x;
  if (c >= block_c) return;
  float s = -INFINITY;
  int id = -1;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t o = ((size_t)sp * Q + qi) * block_c + c;
    const float v = win_s[o];
    if (v > s) {
      s = v;
      id = win_i[o];
    }
  }
  cls_s[(size_t)qi * block_c + c] = s;
  cls_i[(size_t)qi * block_c + c] = id;
}

// Pass B: CTA (query tile, corpus split) adds, per query, the count of its
// rows' scores strictly above thr[query].
template <typename T, int QT>
__global__ void __launch_bounds__(kTileThreads, 1)
count_above(const float* __restrict__ q, const T* __restrict__ corpus,
            const float* __restrict__ thr, int Q, int N, int D, int rows_per_split,
            int* __restrict__ cnt) {
  using S = ScoreTile<T, QT>;
  extern __shared__ __align__(16) unsigned char count_smem[];
  __shared__ float th[QT];
  __shared__ int total[QT];
  const int tid = threadIdx.x;
  const int qg = S::qg_of(tid), rg = S::rg_of(tid);
  const int q0 = blockIdx.x * QT;
  if (tid < QT) {
    th[tid] = q0 + tid < Q ? thr[q0 + tid] : INFINITY;
    total[tid] = 0;
  }
  __syncthreads();
  float t[S::QN];
  int n_above[S::QN];
#pragma unroll
  for (int j = 0; j < S::QN; ++j) {
    t[j] = th[qg + S::QG * j];
    n_above[j] = 0;
  }
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int n_tiles = (row_end - row_begin + kTileRows - 1) / kTileRows;
  auto tile_of = [&](int tile) {
    const int row0 = row_begin + tile * kTileRows;
    return make_int2(row0, min(kTileRows, row_end - row0));
  };
  auto epi = [&](int tile, float (&acc)[S::RM][S::QN]) {
    const int nv = min(kTileRows, row_end - row_begin - tile * kTileRows);
#pragma unroll
    for (int i = 0; i < S::RM; ++i) {
      if (rg + S::RG * i >= nv) continue;
#pragma unroll
      for (int j = 0; j < S::QN; ++j) n_above[j] += acc[i][j] > t[j];
    }
  };
  score_tiles<T, QT>(q, Q, q0, corpus, D, n_tiles, tile_of, epi, count_smem);
#pragma unroll
  for (int j = 0; j < S::QN; ++j)
    if (n_above[j] > 0) atomicAdd(total + qg + S::QG * j, n_above[j]);
  __syncthreads();
  if (tid < QT && q0 + tid < Q && total[tid] > 0) atomicAdd(cnt + q0 + tid, total[tid]);
}

// Pass B over pass A's scores (Q, ld): CTA (chunk, query) counts the row's
// scores [0, N) strictly above thr[query], 4 a thread a step, one integer
// atomic a warp. Bound by reading the scores once.
__global__ void __launch_bounds__(kSelectThreads)
count_scores_above(const float* __restrict__ scores, int ld, const float* __restrict__ thr,
                   int N, int* __restrict__ cnt) {
  const int qi = blockIdx.y;
  const float t = thr[qi];
  const float4* row = reinterpret_cast<const float4*>(scores + (size_t)qi * ld);
  int n = 0;
  for (int v = blockIdx.x * kSelectThreads + threadIdx.x; v * 4 < N;
       v += gridDim.x * kSelectThreads) {
    const float4 x = __ldg(row + v);
    const int e = v * 4;
    n += (x.x > t) + (e + 1 < N && x.y > t) + (e + 2 < N && x.z > t) + (e + 3 < N && x.w > t);
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (threadIdx.x % 32 == 0 && n > 0) atomicAdd(cnt + qi, n);
}

template <typename T, int QT>
cudaError_t launch_fold(const float* q, const T* corpus, int Q, int N, int D, int block_c,
                        int splits, int blocks_per_split, float* win_s, int* win_i,
                        float* scores, int ld, cudaStream_t st) {
  using S = ScoreTile<T, QT>;
  const size_t smem = S::kRingBytes + (size_t)S::RM * S::QN * kTileThreads * 8;
  cudaError_t err = cudaFuncSetAttribute(fold_classes<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + QT - 1) / QT, (block_c + kTileRows - 1) / kTileRows, splits);
  fold_classes<T, QT><<<grid, kTileThreads, smem, st>>>(q, corpus, Q, N, D, block_c,
                                                        blocks_per_split, win_s, win_i,
                                                        scores, ld);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_fold_classes(const float* q, const T* corpus, int Q, int N, int D, int block_c,
                             int splits, int blocks_per_split, float* win_s, int* win_i,
                             float* scores, int ld, cudaStream_t st) {
  switch (qt_for(Q, 1)) {
    case 16:
      return launch_fold<T, 16>(q, corpus, Q, N, D, block_c, splits, blocks_per_split, win_s,
                                win_i, scores, ld, st);
    case 64:
      return launch_fold<T, 64>(q, corpus, Q, N, D, block_c, splits, blocks_per_split, win_s,
                                win_i, scores, ld, st);
    default:
      return launch_fold<T, 128>(q, corpus, Q, N, D, block_c, splits, blocks_per_split, win_s,
                                 win_i, scores, ld, st);
  }
}

template <typename T>
cudaError_t run_fold(const float* q, const T* corpus, int Q, int N, int D, int k, int block_c,
                     int splits, int blocks_per_split, float* win_s, int* win_i, float* out_s,
                     int* out_i, float* scores, int ld, cudaStream_t st) {
  cudaError_t err = run_fold_classes(q, corpus, Q, N, D, block_c, splits, blocks_per_split,
                                     win_s, win_i, scores, ld, st);
  if (err != cudaSuccess) return err;
  const size_t sel = (size_t)block_c * (sizeof(float) + sizeof(int));
  err = cudaFuncSetAttribute(select_winners, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel);
  if (err != cudaSuccess) return err;
  select_winners<<<Q, kSelectThreads, sel, st>>>(win_s, win_i, Q, block_c, splits, k, out_s,
                                                 out_i);
  return cudaGetLastError();
}

template <typename T, int QT>
cudaError_t launch_count(const float* q, const T* corpus, const float* thr, int Q, int N, int D,
                         int splits, int rows_per_split, int* cnt, cudaStream_t st) {
  const size_t smem = ScoreTile<T, QT>::kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(count_above<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + QT - 1) / QT, splits);
  count_above<T, QT><<<grid, kTileThreads, smem, st>>>(q, corpus, thr, Q, N, D, rows_per_split,
                                                       cnt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_count(const float* q, const T* corpus, const float* thr, int Q, int N, int D,
                      int splits, int rows_per_split, int* cnt, cudaStream_t st) {
  switch (qt_for(Q, 1)) {
    case 16:
      return launch_count<T, 16>(q, corpus, thr, Q, N, D, splits, rows_per_split, cnt, st);
    case 64:
      return launch_count<T, 64>(q, corpus, thr, Q, N, D, splits, rows_per_split, cnt, st);
    default:
      return launch_count<T, 128>(q, corpus, thr, Q, N, D, splits, rows_per_split, cnt, st);
  }
}

}  // namespace

// The fold that also writes every score it computes to scores (Q, ld),
// ld ≥ N a multiple of 4 (scores nullptr: none).
extern "C" int ts_topk_2pass_fold_scores(const float* q, const void* corpus, int corpus_bf16,
                                         int Q, int N, int D, int k, int block_c, int splits,
                                         int blocks_per_split, float* win_s, int* win_i,
                                         float* out_s, int* out_i, float* scores, int ld,
                                         void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (corpus_bf16)
    return (int)run_fold(q, static_cast<const __nv_bfloat16*>(corpus), Q, N, D, k, block_c,
                         splits, blocks_per_split, win_s, win_i, out_s, out_i, scores, ld, st);
  return (int)run_fold(q, static_cast<const float*>(corpus), Q, N, D, k, block_c, splits,
                       blocks_per_split, win_s, win_i, out_s, out_i, scores, ld, st);
}

extern "C" int ts_topk_select(const float* scores, const int* ids, int R, int n, int seg_len,
                              long long seg_stride, long long row_stride, int k, float* out_s,
                              int* out_i, void* work, long long work_bytes, int int_keys,
                              void* stream);

// Pass A at k > 256: the fold (scores kept in scores (Q, ld) unless it is
// NULL), the splits folded into cls_s / cls_i (Q, block_c), then the top
// k_sel ≤ block_c of them → out_s / out_i (Q, k_sel), sorted, through
// ts_topk_select (work: its workspace over (Q, block_c) at k_sel).
extern "C" int ts_topk_2pass_fold_large(const float* q, const void* corpus, int corpus_bf16,
                                        int Q, int N, int D, int k_sel, int block_c, int splits,
                                        int blocks_per_split, float* win_s, int* win_i,
                                        float* cls_s, int* cls_i, float* out_s, int* out_i,
                                        void* work, long long work_bytes, float* scores, int ld,
                                        void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (corpus_bf16)
    err = run_fold_classes(q, static_cast<const __nv_bfloat16*>(corpus), Q, N, D, block_c,
                           splits, blocks_per_split, win_s, win_i, scores, ld, st);
  else
    err = run_fold_classes(q, static_cast<const float*>(corpus), Q, N, D, block_c, splits,
                           blocks_per_split, win_s, win_i, scores, ld, st);
  if (err != cudaSuccess) return (int)err;
  fold_splits<<<dim3(Q, (block_c + kSelectThreads - 1) / kSelectThreads), kSelectThreads, 0,
                st>>>(win_s, win_i, Q, block_c, splits, cls_s, cls_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return ts_topk_select(cls_s, cls_i, Q, block_c, block_c, 0, block_c, k_sel, out_s, out_i,
                        work, work_bytes, 0, stream);
}

// q (Q, D) f32; corpus (N, D) f32 or bf16 (corpus_bf16); D % 32 == 0;
// win_s / win_i (splits, Q, block_c) scratch; out_s / out_i (Q, k).
extern "C" int ts_topk_2pass_fold(const float* q, const void* corpus, int corpus_bf16, int Q,
                                  int N, int D, int k, int block_c, int splits,
                                  int blocks_per_split, float* win_s, int* win_i, float* out_s,
                                  int* out_i, void* stream) {
  return ts_topk_2pass_fold_scores(q, corpus, corpus_bf16, Q, N, D, k, block_c, splits,
                                   blocks_per_split, win_s, win_i, out_s, out_i, nullptr, 0,
                                   stream);
}

// thr (Q,) f32; cnt (Q,) int32, zeroed by the caller.
extern "C" int ts_topk_2pass_count(const float* q, const void* corpus, int corpus_bf16,
                                   const float* thr, int Q, int N, int D, int splits,
                                   int rows_per_split, int* cnt, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (corpus_bf16)
    return (int)run_count(q, static_cast<const __nv_bfloat16*>(corpus), thr, Q, N, D, splits,
                          rows_per_split, cnt, st);
  return (int)run_count(q, static_cast<const float*>(corpus), thr, Q, N, D, splits,
                        rows_per_split, cnt, st);
}

// Pass B over the fold's scores (Q, ld): cnt (Q,) int32, zeroed by the caller.
extern "C" int ts_topk_2pass_count_scores(const float* scores, int ld, const float* thr, int Q,
                                          int N, int* cnt, void* stream) {
  const int per = (N / 4 + kSelectThreads) / kSelectThreads;   // CTAs to cover a row
  const int chunks = per < 64 ? per : 64;
  const dim3 grid(chunks, Q);
  count_scores_above<<<grid, kSelectThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      scores, ld, thr, N, cnt);
  return (int)cudaGetLastError();
}
