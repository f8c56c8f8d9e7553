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
// This version computes the dot twice, once a pass, so it cannot come within
// 2× of that bound.
//
// Design. The TPU keeps a (block_q, block_c) accumulator in VMEM (4 MB at
// 256 × 2048), far over a CTA's shared memory. Here the classes are split
// across CTAs: the fold runs CTAs over (16-query tile, 128-class tile, run
// of corpus blocks); each scores, block by block, the 128 contiguous rows of
// its classes with the 128-row × 16-query tile of common.cuh (thread (r, g)
// owns class c0 + r for queries 8g..8g+7, in registers) and writes its
// winners to device memory. The select kernel then runs one CTA a query:
// it folds the runs of each class in row order (strict >) and runs the k
// rounds as block-wide (score desc, id asc) reductions over the block_c
// classes in shared memory. The count kernel runs K2's (query tile, corpus
// split) grid with the same tile product, so every score equals pass A's
// bit for bit, and adds per-warp counts with integer atomics. A bf16 corpus
// rounds the queries to bf16, as the reference; sums are f32 throughout.
#include "common.cuh"

namespace {

constexpr int kSelectThreads = 256;
constexpr int kIntMax = 0x7fffffff;

// queries [q0, q0 + kQTile) → qs (row-major, stride D), rounded to bf16 for
// a bf16 corpus; rows past Q read as zeros.
template <typename T>
__device__ __forceinline__ void stage_queries(const float* __restrict__ q, int Q, int D, int q0,
                                              float* qs) {
  for (int idx = threadIdx.x; idx < kQTile * D; idx += kThreads) {
    const int qi = idx / D;
    const float v = q0 + qi < Q ? q[(size_t)(q0 + qi) * D + idx % D] : 0.f;
    qs[idx] = std::is_same_v<T, __nv_bfloat16> ? round_bf16(v) : v;
  }
}

// Pass A, the fold: CTA (query tile, class tile, split) → win_s / win_i
// (splits, Q, block_c) for its classes and its run of corpus blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_classes(const float* __restrict__ q, const T* __restrict__ corpus, int Q, int N, int D,
             int block_c, int blocks_per_split, float* __restrict__ win_s,
             int* __restrict__ win_i) {
  extern __shared__ __align__(16) float fold_smem[];
  float* qs = fold_smem;            // kQTile × D
  float* ct = qs + kQTile * D;      // kRows × kDCP
  const int q0 = blockIdx.x * kQTile;
  const int c0 = blockIdx.y * kRows;
  const int split = blockIdx.z;
  const int r = threadIdx.x % kRows, g = threadIdx.x / kRows;
  stage_queries<T>(q, Q, D, q0, qs);
  float best_s[kQPT];
  int best_i[kQPT];
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    best_s[j] = -INFINITY;
    best_i[j] = -1;
  }
  __syncthreads();
  const int width = min(kRows, block_c - c0);   // classes of this tile
  const int b_end = min((split + 1) * blocks_per_split, (N + block_c - 1) / block_c);
  for (int blk = split * blocks_per_split; blk < b_end; ++blk) {
    const int row0 = blk * block_c + c0;
    const int nv = min(width, N - row0);   // CTA-uniform
    if (nv <= 0) break;                    // later blocks lie past N too
    float acc[kQPT];
    tile_scores<T, false>(corpus + (size_t)row0 * D, nv, D, qs, D, ct, acc);
    if (r < nv) {
#pragma unroll
      for (int j = 0; j < kQPT; ++j)
        if (acc[j] > best_s[j]) {
          best_s[j] = acc[j];
          best_i[j] = row0 + r;
        }
    }
  }
  if (r >= width) return;
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    const int qi = q0 + g * kQPT + j;
    if (qi >= Q) continue;
    const size_t o = ((size_t)split * Q + qi) * block_c + c0 + r;
    win_s[o] = best_s[j];
    win_i[o] = best_i[j];
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

// Pass B: CTA (query tile, corpus split) adds, per query, the count of its
// rows' scores strictly above thr[query].
template <typename T>
__global__ void __launch_bounds__(kThreads)
count_above(const float* __restrict__ q, const T* __restrict__ corpus,
            const float* __restrict__ thr, int Q, int N, int D, int rows_per_split,
            int* __restrict__ cnt) {
  extern __shared__ __align__(16) float count_smem[];
  float* qs = count_smem;           // kQTile × D
  float* ct = qs + kQTile * D;      // kRows × kDCP
  __shared__ float th[kQTile];
  const int q0 = blockIdx.x * kQTile;
  const int r = threadIdx.x % kRows, g = threadIdx.x / kRows;
  const int lane = threadIdx.x % 32;
  stage_queries<T>(q, Q, D, q0, qs);
  if (threadIdx.x < kQTile)
    th[threadIdx.x] = q0 + threadIdx.x < Q ? thr[q0 + threadIdx.x] : INFINITY;
  __syncthreads();
  float t[kQPT];
#pragma unroll
  for (int j = 0; j < kQPT; ++j) t[j] = th[g * kQPT + j];
  int n_above[kQPT] = {0, 0, 0, 0, 0, 0, 0, 0};
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int nv = min(kRows, row_end - row0);
    float acc[kQPT];
    tile_scores<T, false>(corpus + (size_t)row0 * D, nv, D, qs, D, ct, acc);
    if (r < nv) {
#pragma unroll
      for (int j = 0; j < kQPT; ++j) n_above[j] += acc[j] > t[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    const int total = __reduce_add_sync(0xffffffffu, n_above[j]);   // a warp shares g
    const int qi = q0 + g * kQPT + j;
    if (lane == 0 && total > 0 && qi < Q) atomicAdd(cnt + qi, total);
  }
}

template <typename T>
cudaError_t run_fold(const float* q, const T* corpus, int Q, int N, int D, int k, int block_c,
                     int splits, int blocks_per_split, float* win_s, int* win_i, float* out_s,
                     int* out_i, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)kQTile * D + kRows * kDCP);
  cudaError_t err = cudaFuncSetAttribute(fold_classes<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kQTile - 1) / kQTile, (block_c + kRows - 1) / kRows, splits);
  fold_classes<T><<<grid, kThreads, smem, st>>>(q, corpus, Q, N, D, block_c, blocks_per_split,
                                                win_s, win_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t sel = (size_t)block_c * (sizeof(float) + sizeof(int));
  err = cudaFuncSetAttribute(select_winners, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel);
  if (err != cudaSuccess) return err;
  select_winners<<<Q, kSelectThreads, sel, st>>>(win_s, win_i, Q, block_c, splits, k, out_s,
                                                 out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_count(const float* q, const T* corpus, const float* thr, int Q, int N, int D,
                      int splits, int rows_per_split, int* cnt, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)kQTile * D + kRows * kDCP);
  cudaError_t err = cudaFuncSetAttribute(count_above<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kQTile - 1) / kQTile, splits);
  count_above<T><<<grid, kThreads, smem, st>>>(q, corpus, thr, Q, N, D, rows_per_split, cnt);
  return cudaGetLastError();
}

}  // namespace

// q (Q, D) f32; corpus (N, D) f32 or bf16 (corpus_bf16); D % 32 == 0;
// win_s / win_i (splits, Q, block_c) scratch; out_s / out_i (Q, k).
extern "C" int ts_topk_2pass_fold(const float* q, const void* corpus, int corpus_bf16, int Q,
                                  int N, int D, int k, int block_c, int splits,
                                  int blocks_per_split, float* win_s, int* win_i, float* out_s,
                                  int* out_i, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (corpus_bf16)
    return (int)run_fold(q, static_cast<const __nv_bfloat16*>(corpus), Q, N, D, k, block_c,
                         splits, blocks_per_split, win_s, win_i, out_s, out_i, st);
  return (int)run_fold(q, static_cast<const float*>(corpus), Q, N, D, k, block_c, splits,
                       blocks_per_split, win_s, win_i, out_s, out_i, st);
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
