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
// the int8 codes widened exactly to f32, an f32 dot (f32 FMAs, no TF32),
// then the row's scale. It reads a quarter of K2's f32 bytes (N·D int8 +
// N·4 scale bytes), so it is operation-bound on the CUDA cores at any
// batch above a few queries; the design is K2's, with an int8 tile loader.
//
// Bound on the H100: an f32 corpus must stay exact (no TF32), so the dot
// products run on the CUDA cores and the kernel is operation-bound there
// (2·Q·N·D flops against 67 TFLOP/s) once Q reaches a few dozen; at the
// serving batch of 1-64 queries it is bound by reading the corpus once
// (N·D·4 bytes at 3.35 TB/s).
//
// Design: CTAs are unordered, so the corpus is split. Pass 1 runs CTAs
// over (16-query tile, corpus split); each streams its rows through shared
// memory in 128-row tiles and keeps an exact per-query top-k with the warp
// selector of common.cuh, writing (Q, splits, k) partials. Pass 2
// (merge_partials) reduces the partials to (Q, k). Splitting fills the
// 132 SMs even for a single query. A bf16 corpus is the same template (bf16
// in, queries rounded to bf16 as the reference does, f32 accumulation).
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_pass1(const float* __restrict__ q, const T* __restrict__ corpus,
           const float* __restrict__ scales, int Q, int N, int D, int k,
           int rows_per_split, int splits, float* __restrict__ part_s,
           int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = kp_for(k);
  float* qs = reinterpret_cast<float*>(smem);        // kQTile × D
  float* ct = qs + kQTile * D;                       // kRows × kDCP
  float* sc = ct + kRows * kDCP;                     // kQTile × kRows
  float* sel_f = sc + kQTile * kRows;                // kQTile × 2kp
  int* sel_i = reinterpret_cast<int*>(sel_f + kQTile * 2 * kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQTile;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);

  for (int idx = tid; idx < kQTile * D; idx += kThreads) {
    const int qi = idx / D;
    const float v = (q0 + qi < Q) ? q[(size_t)(q0 + qi) * D + idx % D] : 0.f;
    // bf16 rows: queries rounded to bf16, as the reference; f32 and int8
    // rows: f32 queries
    qs[idx] = std::is_same_v<T, __nv_bfloat16> ? round_bf16(v) : v;
  }
  Selector sel[kQPW];
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    const int ql = warp + a * kWarps;
    sel_init(sel[a], sel_f + ql * 2 * kp, sel_i + ql * 2 * kp, k, lane);
  }
  __syncthreads();

  const int r = tid % kRows, g = tid / kRows;
  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int nv = min(kRows, row_end - row0);
    float acc[kQPT];
    tile_scores<T, false>(corpus + (size_t)row0 * D, nv, D, qs, D, ct, acc);
    if constexpr (std::is_same_v<T, int8_t>) {
      const float sc = r < nv ? scales[row0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < kQPT; ++j) acc[j] *= sc;
    }
#pragma unroll
    for (int j = 0; j < kQPT; ++j) sc[(g * kQPT + j) * kRows + r] = acc[j];
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kQPW; ++a) {
      const int ql = warp + a * kWarps;
      if (q0 + ql >= Q) continue;  // warp-uniform
      for (int base = 0; base < nv; base += 32) {
        const int rr = base + lane;
        const bool has = rr < nv;
        sel_push(sel[a], has, has ? sc[ql * kRows + rr] : -INFINITY, row0 + rr, lane);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    const int ql = warp + a * kWarps;
    if (q0 + ql >= Q) continue;
    sel_flush(sel[a], lane);
    const size_t o = ((size_t)(q0 + ql) * splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[o + j] = sel[a].ls[j];
      part_i[o + j] = sel[a].li[j];
    }
  }
}

template <typename T>
cudaError_t run_topk(const float* q, const T* corpus, const float* scales, int Q, int N,
                     int D, int k, int splits, int rows_per_split, float* part_s,
                     int* part_i, float* out_s, int* out_i, cudaStream_t st) {
  const int kp = host_kp_for(k);
  const size_t smem =
      sizeof(float) * ((size_t)kQTile * D + kRows * kDCP + kQTile * kRows) +
      (size_t)kQTile * 2 * kp * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + kQTile - 1) / kQTile, splits);
  topk_pass1<T><<<grid, kThreads, smem, st>>>(q, corpus, scales, Q, N, D, k,
                                              rows_per_split, splits, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part_s, part_i, Q, splits, k, out_s, out_i, st);
}

}  // namespace

extern "C" int ts_cosine_topk(const float* q, const void* corpus, int corpus_bf16,
                              int Q, int N, int D, int k, int splits,
                              int rows_per_split, float* part_s, int* part_i,
                              float* out_s, int* out_i, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (corpus_bf16)
    return (int)run_topk(q, static_cast<const __nv_bfloat16*>(corpus), nullptr, Q, N,
                         D, k, splits, rows_per_split, part_s, part_i, out_s, out_i, st);
  return (int)run_topk(q, static_cast<const float*>(corpus), nullptr, Q, N, D, k,
                       splits, rows_per_split, part_s, part_i, out_s, out_i, st);
}

// K3: int8 corpus (N, D) with per-row f32 scales (N,).
extern "C" int ts_cosine_topk_int8(const float* q, const int8_t* corpus,
                                   const float* scales, int Q, int N, int D, int k,
                                   int splits, int rows_per_split, float* part_s,
                                   int* part_i, float* out_s, int* out_i, void* stream) {
  return (int)run_topk(q, corpus, scales, Q, N, D, k, splits, rows_per_split, part_s,
                       part_i, out_s, out_i, reinterpret_cast<cudaStream_t>(stream));
}
