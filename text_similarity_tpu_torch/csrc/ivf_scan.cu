// IVF block-union scan (kernel K1), its int8 variant (kernel K4), their
// per-probe and raw-accumulator modes (K1-opt) and the idless scan of the
// sentinel layout (K11b).
//
// K1 replaces text_similarity_tpu/index/ivf.py _ivf_query_pallas →
// _ivf_kernel → _ivf_body; K4 replaces the same call with _ivf_kernel_int8:
// int8 slabs (C_tot, Mc, D) with per-slot f32 scales (C_tot, Mc), scored as
// the reference does — queries rounded to bf16, codes widened exactly, an
// f32-accumulated dot, THEN × the slot's scale, then empty slots (id < 0)
// masked to −inf. Both keep the two merge modes:
//  * exact (width = Mc, slots = 0): the exact top-k of the scores of a
//    query block's probed slabs (the reference's _merge_block_topk);
//  * deferred (approx_width = w, acc_slots = S in 1..4): every lane class
//    (slab position mod w) keeps a running top-S (score, id); a later probe
//    displaces a slot only on a strictly greater score and the loser
//    cascades to the next slot; at the end the exact top-k of the S·w
//    accumulator entries is taken, lowest id first among equal scores.
// Queries of one block_q block share one probe list (the block union);
// probe ids outside [0, C_tot) are skipped.
//
// K1-opt (the reference's per_probe and emit_acc, ivf.py:1130-1132,
// :1212-1222, :1908-1919), f32/bf16 and int8 slabs:
//  * per_probe: the exact mode over ONE probe → (U, B, k), each probe's
//    own exact top-k (the caller merges across probes); below, a CTA scans
//    one probe (grid z) and the merge pass reduces (probe, query) rows;
//  * emit_acc: the deferred fold, then each thread writes its S
//    accumulator entries to (B, S·w), slot s at columns s·w … s·w + w − 1
//    (the reference's slot-major order); no selection, no second pass.
// K11b (idless, ivf.py:1304-1363 _ivf_kernel_idless): the deferred fold
// with S = 1 reading no ids: slot id = probe · Mc + position, no slot is
// masked (the sentinel column scores dead slots 0, live rows 1 to 3), and
// the result holds flat slot ids that the caller translates.
// D need not be a multiple of 32 (the sentinel layout's D+1 rows).
//
// K1 with bf16 slabs and K4, and per_probe and emit_acc over both, run on
// the tensor cores (ivf_tile.cu) wherever ivf_tile_plan takes the shape (D
// a multiple of 64 that shared memory holds, Mc a multiple of 4), and so
// does K11b over bf16 sentinel rows of D' + 1 columns (D' a multiple of
// 64, Mc and the width multiples of 8). The CUDA-core kernel below runs
// the rest, as ts_ivf_scan / ts_ivf_scan_int8 (through ivf_k1_scan, which
// ivf_modes.cu's K10 and K11a call too) / ts_ivf_scan_per_probe /
// ts_ivf_scan_emit_acc / ts_ivf_scan_idless choose by shape: f32 slabs
// (exact f32, no TF32), the other D (the sentinel layout's D + 1 among
// them), Mc and widths.
//
// Bound on the H100: with bf16 slabs the scan reads U·Mc·D·2 bytes per
// query block (int8: U·Mc·(D + 4) plus the ids); the arithmetic
// (2·B·U·Mc·D) runs here on the CUDA cores in f32, so this kernel is
// operation-bound far above the card's bf16 tensor rate: it serves only
// the shapes the tile does not take.
//
// Design: the TPU accumulator is block_q × S·w × 8 bytes (1 MB at 64 ×
// 2048 × 2), far over 227 KB of shared memory. Here a CTA takes 16 queries
// of a block and a 128-lane range of the lane classes, so each thread owns
// 8 queries × 1 lane class × S slots in registers, and walks the block's
// whole probe list in order (probe ids loaded by the CTA itself): the same
// insertion order, the same collisions, hence the same ids as the Pallas
// kernel. Each CTA writes its per-query top-k of its accumulator entries
// (or, in exact mode, of its slab positions); merge_partials takes the top-k
// over the lane ranges. Queries are rounded to bf16 before the dot when the
// slabs are bf16 or int8, as the reference does; slots with id < 0 score
// −inf.
#include "common.cuh"
#include "ivf_tile.cuh"

namespace {

enum Mode : int { kMerge = 0, kPerProbe = 1, kEmitAcc = 2, kIdless = 3 };

#define PASS1_PARAMS                                                                  \
  const float* __restrict__ q, const int* __restrict__ probes, const T* __restrict__ data, \
      const float* __restrict__ scales, const int* __restrict__ ids, int B, int D, int U,  \
      int C_tot, int Mc, int block_q, int n_sub, int k, int width, int n_ranges,          \
      float* __restrict__ part_s, int *__restrict__ part_i
#define PASS1_ARGS \
  q, probes, data, scales, ids, B, D, U, C_tot, Mc, block_q, n_sub, k, width, n_ranges, part_s, part_i

template <typename T, int S, int M>
__device__ __forceinline__ void ivf_pass1(PASS1_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = kp_for(k);
  const int ldq = q_stride(D);
  float* qs = reinterpret_cast<float*>(smem);        // kQTile × ldq
  float* ct = qs + kQTile * ldq;                     // kRows × kDCP
  float* sc = ct + kRows * kDCP;                     // kQTile × kRows
  int* sid = reinterpret_cast<int*>(sc + kQTile * kRows);  // kQTile × kRows
  float* sel_f = reinterpret_cast<float*>(sid + kQTile * kRows);
  int* sel_i = reinterpret_cast<int*>(sel_f + kQTile * 2 * kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x / n_sub, sub = blockIdx.x % n_sub;
  const int range = blockIdx.y, r0 = range * kRows;
  const int qrow0 = blk * block_q + sub * kQTile;
  const int qn = min(kQTile, block_q - sub * kQTile);
  const int lanes = min(kRows, width - r0);
  const int chunks = Mc / width;
  const int u_lo = M == kPerProbe ? (int)blockIdx.z : 0;
  const int u_hi = M == kPerProbe ? u_lo + 1 : U;

  for (int idx = tid; idx < kQTile * ldq; idx += kThreads) {
    const int qi = idx / ldq, d = idx % ldq;
    const float v = qi < qn && d < D ? q[(size_t)(qrow0 + qi) * D + d] : 0.f;
    qs[idx] = std::is_same_v<T, float> ? v : round_bf16(v);
  }
  Selector sel[kQPW];
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    const int ql = warp + a * kWarps;
    sel_init(sel[a], sel_f + ql * 2 * kp, sel_i + ql * 2 * kp, k, lane);
  }
  __syncthreads();

  const int r = tid % kRows, g = tid / kRows;
  constexpr int kS = S > 0 ? S : 1;
  float acc_s[kQPT][kS];
  int acc_i[kQPT][kS];
#pragma unroll
  for (int j = 0; j < kQPT; ++j)
#pragma unroll
    for (int t = 0; t < kS; ++t) {
      acc_s[j][t] = -INFINITY;
      acc_i[j][t] = -1;
    }

  for (int u = u_lo; u < u_hi; ++u) {
    const int c = probes[(size_t)blk * U + u];
    if (c < 0 || c >= C_tot) continue;  // CTA-uniform
    for (int ch = 0; ch < chunks; ++ch) {
      const size_t pos0 = (size_t)c * Mc + (size_t)ch * width + r0;
      float a[kQPT];
      tile_scores<T>(data + pos0 * D, lanes, D, qs, ldq, ct, a);
      if constexpr (std::is_same_v<T, int8_t>) {
        const float sc = r < lanes ? scales[pos0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < kQPT; ++j) a[j] *= sc;
      }
      // idless: the flat slot id, every slot live (the sentinel column
      // scores dead slots 0)
      const int id = M == kIdless ? (r < lanes ? (int)(pos0 + r) : -1)
                                  : (r < lanes ? ids[pos0 + r] : -1);
      if constexpr (S > 0) {
        if (r < lanes) {
#pragma unroll
          for (int j = 0; j < kQPT; ++j) {
            float ds = M == kIdless || id >= 0 ? a[j] : -INFINITY;
            int di = id;
#pragma unroll
            for (int t = 0; t < S; ++t) {
              if (ds > acc_s[j][t]) {
                const float ts = acc_s[j][t];
                const int ti = acc_i[j][t];
                acc_s[j][t] = ds;
                acc_i[j][t] = di;
                ds = ts;
                di = ti;
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kQPT; ++j) {
          sc[(g * kQPT + j) * kRows + r] = id >= 0 ? a[j] : -INFINITY;
          sid[(g * kQPT + j) * kRows + r] = id;
        }
        __syncthreads();
#pragma unroll
        for (int a2 = 0; a2 < kQPW; ++a2) {
          const int ql = warp + a2 * kWarps;
          if (ql >= qn) continue;  // warp-uniform
          for (int base = 0; base < lanes; base += 32) {
            const int rr = base + lane;
            const bool has = rr < lanes;
            sel_push(sel[a2], has, has ? sc[ql * kRows + rr] : -INFINITY,
                     has ? sid[ql * kRows + rr] : -1, lane);
          }
        }
        __syncthreads();
      }
    }
  }

  if constexpr (M == kEmitAcc) {
    // the raw accumulator, slot-major: (B, S·width), part_* are the outputs
    if (r < lanes) {
      const size_t ow = (size_t)S * width;
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        const int ql = g * kQPT + j;
        if (ql >= qn) continue;
#pragma unroll
        for (int t = 0; t < kS; ++t) {
          const size_t o = (size_t)(qrow0 + ql) * ow + (size_t)t * width + r0 + r;
          part_s[o] = acc_s[j][t];
          part_i[o] = acc_i[j][t];
        }
      }
    }
    return;
  }

  if constexpr (S > 0) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        sc[(g * kQPT + j) * kRows + r] = acc_s[j][t];
        sid[(g * kQPT + j) * kRows + r] = acc_i[j][t];
      }
      __syncthreads();
#pragma unroll
      for (int a2 = 0; a2 < kQPW; ++a2) {
        const int ql = warp + a2 * kWarps;
        if (ql >= qn) continue;
        for (int base = 0; base < lanes; base += 32) {
          const int rr = base + lane;
          const bool has = rr < lanes;
          sel_push(sel[a2], has, has ? sc[ql * kRows + rr] : -INFINITY,
                   has ? sid[ql * kRows + rr] : -1, lane);
        }
      }
      __syncthreads();
    }
  }

  // per_probe: rows of the merge pass are (probe, query) pairs
  const size_t row_base = M == kPerProbe ? (size_t)u_lo * B : 0;
#pragma unroll
  for (int a2 = 0; a2 < kQPW; ++a2) {
    const int ql = warp + a2 * kWarps;
    if (ql >= qn) continue;
    sel_flush(sel[a2], lane);
    const size_t o = ((row_base + qrow0 + ql) * n_ranges + range) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[o + j] = sel[a2].ls[j];
      part_i[o + j] = sel[a2].li[j];
    }
  }
}

// Register budgets: the single-slot and exact modes ask for 3 CTAs an SM
// (at most 85 registers; their shared memory allows 3), the multi-slot raw
// accumulator for 2 (without it the compiler takes 144 and one CTA runs),
// the multi-slot merge keeps the compiler's choice for its S accumulators.
template <typename T, int S, int M>
__global__ void __launch_bounds__(kThreads, 3) ivf_pass1_lean(PASS1_PARAMS) {
  ivf_pass1<T, S, M>(PASS1_ARGS);
}
template <typename T, int S, int M>
__global__ void __launch_bounds__(kThreads, 2) ivf_pass1_mid(PASS1_PARAMS) {
  ivf_pass1<T, S, M>(PASS1_ARGS);
}
template <typename T, int S, int M>
__global__ void __launch_bounds__(kThreads) ivf_pass1_wide(PASS1_PARAMS) {
  ivf_pass1<T, S, M>(PASS1_ARGS);
}
#undef PASS1_PARAMS
#undef PASS1_ARGS

template <typename T, int S, int M>
auto pass1_kernel() {
  if constexpr (S <= 1) return ivf_pass1_lean<T, S, M>;
  else if constexpr (M == kEmitAcc) return ivf_pass1_mid<T, S, M>;
  else return ivf_pass1_wide<T, S, M>;
}

template <typename T, int S, int M>
cudaError_t run_scan(const float* q, const int* probes, const T* data, const float* scales,
                     const int* ids, int B, int D, int U, int C_tot, int Mc, int block_q, int k,
                     int width, float* part_s, int* part_i, float* out_s, int* out_i,
                     cudaStream_t st) {
  const int kp = host_kp_for(k);
  const size_t smem =
      sizeof(float) * ((size_t)kQTile * q_stride(D) + kRows * kDCP + kQTile * kRows) +
      sizeof(int) * (size_t)kQTile * kRows +
      (size_t)kQTile * 2 * kp * (sizeof(float) + sizeof(int));
  const auto kernel = pass1_kernel<T, S, M>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_blocks = B / block_q;
  const int n_sub = (block_q + kQTile - 1) / kQTile;
  const int n_ranges = (width + kRows - 1) / kRows;
  dim3 grid(n_blocks * n_sub, n_ranges, M == kPerProbe ? U : 1);
  kernel<<<grid, kThreads, smem, st>>>(q, probes, data, scales, ids, B, D, U, C_tot, Mc,
                                      block_q, n_sub, k, width, n_ranges, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || M == kEmitAcc) return err;
  return launch_merge(part_s, part_i, M == kPerProbe ? U * B : B, n_ranges, k, out_s, out_i,
                      st);
}

template <typename T, int M>
cudaError_t dispatch_slots(int slots, const float* q, const int* probes, const T* data,
                           const float* scales, const int* ids, int B, int D, int U, int C_tot, int Mc,
                           int block_q, int k, int width, float* part_s, int* part_i,
                           float* out_s, int* out_i, cudaStream_t st) {
#define TS_RUN(S_) run_scan<T, S_, M>(q, probes, data, scales, ids, B, D, U, C_tot, Mc, \
                                      block_q, k, width, part_s, part_i, out_s, out_i, st)
  if constexpr (M == kPerProbe) {
    return slots == 0 ? TS_RUN(0) : cudaErrorInvalidValue;
  } else if constexpr (M == kIdless) {
    return slots == 1 ? TS_RUN(1) : cudaErrorInvalidValue;
  } else {
    switch (slots) {
      case 0: if constexpr (M == kMerge) return TS_RUN(0); else return cudaErrorInvalidValue;
      case 1: return TS_RUN(1);
      case 2: return TS_RUN(2);
      case 3: return TS_RUN(3);
      case 4: return TS_RUN(4);
      default: return cudaErrorInvalidValue;
    }
  }
#undef TS_RUN
}

// data_kind: 0 f32, 1 bf16, 2 int8 (with scales)
template <int M>
int dispatch_kind(int data_kind, int slots, const float* q, const int* probes, const void* data,
                  const float* scales, const int* ids, int B, int D, int U, int C_tot, int Mc,
                  int block_q, int k, int width, float* part_s, int* part_i, float* out_s,
                  int* out_i, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (data_kind) {
    case 0:
      return (int)dispatch_slots<float, M>(slots, q, probes, static_cast<const float*>(data),
                                           nullptr, ids, B, D, U, C_tot, Mc, block_q, k, width,
                                           part_s, part_i, out_s, out_i, st);
    case 1:
      return (int)dispatch_slots<__nv_bfloat16, M>(
          slots, q, probes, static_cast<const __nv_bfloat16*>(data), nullptr, ids, B, D, U,
          C_tot, Mc, block_q, k, width, part_s, part_i, out_s, out_i, st);
    case 2:
      if constexpr (M == kIdless) return (int)cudaErrorInvalidValue;
      else
        return (int)dispatch_slots<int8_t, M>(slots, q, probes, static_cast<const int8_t*>(data),
                                              scales, ids, B, D, U, C_tot, Mc, block_q, k, width,
                                              part_s, part_i, out_s, out_i, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1 / K4 at one shape: the wgmma tile where ivf_tile_plan takes it (its
// ring at most max_stages deep), else the CUDA-core kernel.
int ivf_k1_scan(int data_kind, const float* q, const int* probes, const void* data,
                const float* scales, const int* ids, int B, int D, int U, int C_tot, int Mc,
                int block_q, int k, int width, int slots, int max_stages, float* part_s,
                int* part_i, float* out_s, int* out_i, void* stream) {
  IvfTilePlan plan;
  if (ivf_tile_plan(data_kind, D, Mc, block_q, k, width, slots, max_stages, &plan))
    return ivf_tile_scan(data_kind, q, probes, data, scales, ids, nullptr, nullptr, B, D, U,
                         C_tot, Mc, block_q, k, width, slots, max_stages, part_s, part_i, out_s,
                         out_i, stream);
  return dispatch_kind<kMerge>(data_kind, slots, q, probes, data, scales, ids, B, D, U, C_tot,
                               Mc, block_q, k, width, part_s, part_i, out_s, out_i, stream);
}

// slots = 0: exact merge over slab positions (width must equal Mc);
// slots = S ≥ 1: deferred lane-class fold of width `width` (Mc % width == 0).
// The wgmma tile where ivf_tile_plan takes the shape (part_*: (B,
// ceil(width / 64), k)), else the CUDA-core kernel (part_*: (B,
// ceil(width / 128), k)); ts_ivf_scan_tile_plan tells the caller which.
extern "C" int ts_ivf_scan(const float* q, const int* probes, const void* data,
                           int data_bf16, const int* ids, int B, int D, int U,
                           int C_tot, int Mc, int block_q, int k, int width, int slots,
                           float* part_s, int* part_i, float* out_s, int* out_i,
                           void* stream) {
  return ivf_k1_scan(data_bf16 ? 1 : 0, q, probes, data, nullptr, ids, B, D, U, C_tot, Mc,
                     block_q, k, width, slots, 0, part_s, part_i, out_s, out_i, stream);
}

// K4: int8 slabs with per-slot f32 scales (C_tot, Mc); modes and kernel
// choice as above.
extern "C" int ts_ivf_scan_int8(const float* q, const int* probes, const int8_t* data,
                                const float* scales, const int* ids, int B, int D, int U,
                                int C_tot, int Mc, int block_q, int k, int width,
                                int slots, float* part_s, int* part_i, float* out_s,
                                int* out_i, void* stream) {
  return ivf_k1_scan(2, q, probes, data, scales, ids, B, D, U, C_tot, Mc, block_q, k, width,
                     slots, 0, part_s, part_i, out_s, out_i, stream);
}

// K1-opt per_probe: exact top-k of each probe → out (U, B, k). data_kind 0
// f32, 1 bf16, 2 int8 + scales. The wgmma tile where ivf_tile_plan takes
// the exact mode's shape (ts_ivf_scan_tile_plan(kind, D, Mc, block_q, k,
// Mc, 0) tells the caller; part_* unused), else the CUDA-core kernel (part
// holds (U·B, ceil(Mc/128), k)).
extern "C" int ts_ivf_scan_per_probe(const float* q, const int* probes, const void* data,
                                     int data_kind, const float* scales, const int* ids,
                                     int B, int D, int U, int C_tot, int Mc, int block_q,
                                     int k, float* part_s, int* part_i, float* out_s,
                                     int* out_i, void* stream) {
  IvfTilePlan plan;
  if (data_kind <= 2 && ivf_tile_plan(data_kind, D, Mc, block_q, k, Mc, 0, 0, &plan))
    return ivf_tile_per_probe(data_kind, q, probes, data, scales, ids, B, D, U, C_tot, Mc,
                              block_q, k, out_s, out_i, stream);
  return dispatch_kind<kPerProbe>(data_kind, 0, q, probes, data, scales, ids, B, D, U, C_tot,
                                  Mc, block_q, k, Mc, part_s, part_i, out_s, out_i, stream);
}

// K1-opt emit_acc: the deferred fold's accumulator → out (B, slots·width),
// slot s at columns s·width … s·width + width − 1; no merge. data_kind 0
// f32, 1 bf16, 2 int8 + scales. The wgmma tile's deferred mode where
// ivf_tile_plan takes the shape (ts_ivf_scan_tile_plan(kind, D, Mc,
// block_q, 1, width, slots) tells the caller), else the CUDA-core kernel.
extern "C" int ts_ivf_scan_emit_acc(const float* q, const int* probes, const void* data,
                                    int data_kind, const float* scales, const int* ids,
                                    int B, int D, int U, int C_tot, int Mc, int block_q,
                                    int width, int slots, float* out_s, int* out_i,
                                    void* stream) {
  IvfTilePlan plan;
  if (data_kind <= 2 && ivf_tile_plan(data_kind, D, Mc, block_q, 1, width, slots, 0, &plan))
    return ivf_tile_emit(data_kind, q, probes, data, scales, ids, B, D, U, C_tot, Mc, block_q,
                         width, slots, out_s, out_i, stream);
  return dispatch_kind<kEmitAcc>(data_kind, slots, q, probes, data, scales, ids, B, D, U,
                                 C_tot, Mc, block_q, 1, width, out_s, out_i, nullptr, nullptr,
                                 stream);
}

// K11b: idless deferred scan (S = 1) → flat slot ids (probe · Mc + position).
// bf16 rows of D = D' + 1 columns with D' a multiple of 64, Mc and width
// multiples of 8 take the wgmma tile (ivf_tile.cu; part_*: (B, ceil(width
// / 64), 64), zero_tiles read, counts added to when not null); the rest
// (f32, other D, Mc, width) the CUDA-core kernel (part_*: (B, ceil(width /
// 128), k); zero_tiles and counts unused). ts_ivf_scan_tile_plan(3, ...)
// tells the caller which.
extern "C" int ts_ivf_scan_idless(const float* q, const int* probes, const void* data,
                                  int data_bf16, const unsigned char* zero_tiles, int* counts,
                                  int B, int D, int U, int C_tot, int Mc, int block_q, int k,
                                  int width, float* part_s, int* part_i, float* out_s,
                                  int* out_i, void* stream) {
  IvfTilePlan plan;
  if (data_bf16 && ivf_tile_plan(3, D, Mc, block_q, k, width, 1, 0, &plan))
    return ivf_tile_scan(3, q, probes, data, nullptr, nullptr, zero_tiles, counts, B, D, U,
                         C_tot, Mc, block_q, k, width, 1, 0, part_s, part_i, out_s, out_i,
                         stream);
  return dispatch_kind<kIdless>(data_bf16 ? 1 : 0, 1, q, probes, data, nullptr, nullptr, B, D,
                                U, C_tot, Mc, block_q, k, width, part_s, part_i, out_s, out_i,
                                stream);
}
