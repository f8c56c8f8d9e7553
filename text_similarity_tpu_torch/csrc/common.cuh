// Shared building blocks of the search kernels (topk.cu, ivf_scan.cu); the
// flash kernels include it through flash_common.cuh and use only its f32
// loader (load16).
//
// * A 128-row × 16-query score tile: a CTA of 256 threads stages 128 rows
//   of the corpus (or of an IVF slab; f32, bf16 or int8 codes) through
//   shared memory, 32 dims at a time, converted to f32 (exactly); thread (row r, group g) accumulates the dot
//   products of row r with queries g*8 .. g*8+7 in f32 on the CUDA cores,
//   in a fixed order over the dims (so equal rows give bit-equal scores).
//   Any D: rows whose byte length is not a multiple of 16 (the sentinel
//   layout's D+1) load element by element, and the last chunk pads with
//   zeros; the query tile then has a padded stride ldq ≥ round_up(D, 32).
// * A warp-level exact top-k selector: a sorted list of KP = pow2 ≥ k
//   (score, id) pairs plus a candidate buffer in shared memory. Candidates
//   better than the current k-th enter the buffer; a full buffer is
//   bitonic-sorted and merged into the list. The order is (score desc,
//   id asc): among equal scores the lowest id wins, as in the reference's
//   _exact_merge_rounds (ops/topk.py).
// * merge_partials: the second pass that reduces (rows, P, k) per-CTA
//   partial top-k lists (or any rows of candidates) to (rows, k) with the
//   same selector.
// * warp_merge32: a batch of 32 candidates into a list of 32 held one a
//   lane, in registers, by bitonic networks of shuffles (k ≤ 32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 128;                  // rows per score tile
constexpr int kGroups = 2;                  // query groups per CTA
constexpr int kQPT = 8;                     // queries per thread
constexpr int kQTile = kGroups * kQPT;      // 16 queries per CTA
constexpr int kThreads = kRows * kGroups;   // 256
constexpr int kWarps = kThreads / 32;       // 8
constexpr int kQPW = kQTile / kWarps;       // 2 queries selected per warp
constexpr int kDC = 32;                     // dims staged per step
constexpr int kDCP = kDC + 4;               // padded smem row stride
constexpr int kMaxK = 256;
constexpr int kMergeWarps = 4;

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of T at p → f32 values in out (4 floats, 8 bf16 or 16 int8).
__device__ __forceinline__ void load16(const float* p, float* out) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const char4* c = reinterpret_cast<const char4*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[4 * e] = c[e].x;
    out[4 * e + 1] = c[e].y;
    out[4 * e + 2] = c[e].z;
    out[4 * e + 3] = c[e].w;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Query stride in shared memory for width D: a whole number of 32-dim
// chunks, so the last chunk reads zeros past D.
__host__ __device__ __forceinline__ int q_stride(int D) { return (D + kDC - 1) / kDC * kDC; }

// Scores of tile rows [0, n_valid) (row r at rows + r*D) against the 16
// queries in qs (row-major, stride ldq = q_stride(D), zero past D, already
// rounded). Thread (r = tid % kRows, g = tid / kRows) gets acc[j] = <row r,
// query g*8+j>. Rows ≥ n_valid read as zeros. Every thread of the CTA must
// call this. kAnyD = false: D is a multiple of 32 (16-byte loads only).
template <typename T, bool kAnyD = true>
__device__ __forceinline__ void tile_scores(const T* __restrict__ rows, int n_valid,
                                            int D, const float* qs, int ldq, float* ct,
                                            float acc[kQPT]) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kDC / kVec;
  const int tid = threadIdx.x;
  const int r = tid % kRows, g = tid / kRows;
  // every row 16-byte aligned
  const bool vec = !kAnyD || (D * sizeof(T)) % 16 == 0;
#pragma unroll
  for (int j = 0; j < kQPT; ++j) acc[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDC) {
    for (int idx = tid; idx < kRows * kPerRow; idx += kThreads) {
      const int row = idx / kPerRow, v = idx % kPerRow;
      const int dd = d0 + v * kVec;
      const T* src = rows + (size_t)row * D + dd;
      float vals[kVec];
      if (row < n_valid && vec && (!kAnyD || dd + kVec <= D)) {
        load16(src, vals);
      } else if (!kAnyD) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          vals[e] = row < n_valid && dd + e < D ? to_f32(src[e]) : 0.f;
      }
      float* dst = ct + row * kDCP + v * kVec;
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
    }
    __syncthreads();
    const float* crow = ct + r * kDCP;
    const float* qg = qs + (size_t)(g * kQPT) * ldq + d0;
#pragma unroll
    for (int d = 0; d < kDC; d += 4) {
      const float4 c = *reinterpret_cast<const float4*>(crow + d);
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qg + (size_t)j * ldq + d);
        acc[j] = fmaf(c.x, qv.x, acc[j]);
        acc[j] = fmaf(c.y, qv.y, acc[j]);
        acc[j] = fmaf(c.z, qv.z, acc[j]);
        acc[j] = fmaf(c.w, qv.w, acc[j]);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Warp-level exact top-k selector
// ---------------------------------------------------------------------------

struct Selector {
  float* ls;  // list scores, sorted best first (KP)
  int* li;    // list ids
  float* bs;  // candidate buffer (KP)
  int* bi;
  int kp, k;
  int n;      // buffered candidates (warp-uniform)
  float ts;   // current k-th best (threshold), warp-uniform
  int ti;
};

__device__ __forceinline__ int kp_for(int k) {
  int kp = 32;
  while (kp < k) kp <<= 1;
  return kp;
}

__device__ __forceinline__ void sel_init(Selector& s, float* fbase, int* ibase,
                                         int k, int lane) {
  s.kp = kp_for(k);
  s.k = k;
  s.ls = fbase;
  s.bs = fbase + s.kp;
  s.li = ibase;
  s.bi = ibase + s.kp;
  for (int j = lane; j < s.kp; j += 32) {
    s.ls[j] = -INFINITY;
    s.li[j] = -1;
  }
  s.n = 0;
  s.ts = -INFINITY;
  s.ti = -1;
  __syncwarp();
}

__device__ __forceinline__ void cmp_swap(float* vs, int* vi, int lo, int hi,
                                         bool hi_wins_if_better) {
  // puts the better element at lo when hi_wins_if_better, else at hi
  const float a = vs[lo], b = vs[hi];
  const int ia = vi[lo], ib = vi[hi];
  const bool sw = hi_wins_if_better ? better(b, ib, a, ia) : better(a, ia, b, ib);
  if (sw) {
    vs[lo] = b; vs[hi] = a;
    vi[lo] = ib; vi[hi] = ia;
  }
}

// Merge the buffer into the list: sort the buffer worst-first (bitonic),
// keep the better of list[j] / buffer[j] (a bitonic sequence holding the
// best KP of both), then bitonic-merge it best-first.
__device__ void sel_flush(Selector& s, int lane) {
  const int kp = s.kp;
  for (int j = s.n + lane; j < kp; j += 32) {
    s.bs[j] = -INFINITY;
    s.bi[j] = -1;
  }
  __syncwarp();
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < kp / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        const bool worst_first = (lo & size) == 0;
        cmp_swap(s.bs, s.bi, lo, lo + stride, !worst_first);
      }
      __syncwarp();
    }
  }
  for (int j = lane; j < kp; j += 32) {
    if (better(s.bs[j], s.bi[j], s.ls[j], s.li[j])) {
      s.ls[j] = s.bs[j];
      s.li[j] = s.bi[j];
    }
  }
  __syncwarp();
  for (int stride = kp >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < kp / 2; t += 32) {
      const int lo = 2 * t - (t & (stride - 1));
      cmp_swap(s.ls, s.li, lo, lo + stride, true);
    }
    __syncwarp();
  }
  s.n = 0;
  s.ts = s.ls[s.k - 1];
  s.ti = s.li[s.k - 1];
  __syncwarp();
}

// Offer one candidate per lane. All 32 lanes must call with warp-uniform
// control flow.
__device__ __forceinline__ void sel_push(Selector& s, bool has, float sc, int id,
                                         int lane) {
  has = has && better(sc, id, s.ts, s.ti);
  unsigned m = __ballot_sync(0xffffffffu, has);
  if (m == 0) return;
  int cnt = __popc(m);
  if (s.n + cnt > s.kp) {
    sel_flush(s, lane);
    has = has && better(sc, id, s.ts, s.ti);
    m = __ballot_sync(0xffffffffu, has);
    cnt = __popc(m);
  }
  if (has) {
    const int pos = s.n + __popc(m & ((1u << lane) - 1u));
    s.bs[pos] = sc;
    s.bi[pos] = id;
  }
  s.n += cnt;
  __syncwarp();
}

// One compare-exchange of a bitonic network across the lanes: the lane
// keeps the better of its (score, id) and its partner's, or the worse.
__device__ __forceinline__ void lane_exchange(float& s, int& id, int stride, bool keep_better) {
  const float os = __shfl_xor_sync(0xffffffffu, s, stride);
  const int oi = __shfl_xor_sync(0xffffffffu, id, stride);
  if (keep_better ? better(os, oi, s, id) : better(s, id, os, oi)) {
    s = os;
    id = oi;
  }
}

// k ≤ 32: merge a batch of 32 candidates (one a lane, any order) into a
// list of 32 held one a lane, best first, in registers: sort the batch
// with a bitonic network of shuffles, keep the better of list[i] and
// batch[31 − i] (the best 32 of both, a bitonic sequence), merge it. Every
// batch merges at once, so the published threshold is always exact.
__device__ __forceinline__ void warp_merge32(float& ls, int& li, float s, int id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      lane_exchange(s, id, stride, ((lane & size) == 0) == ((lane & stride) == 0));
  const float rs = __shfl_sync(0xffffffffu, s, 31 - lane);
  const int ri = __shfl_sync(0xffffffffu, id, 31 - lane);
  if (better(rs, ri, ls, li)) {
    ls = rs;
    li = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    lane_exchange(ls, li, stride, (lane & stride) == 0);
}

// Second pass: rows × (total candidates, e.g. P partial lists of k) → rows
// × k, one warp a row.
__global__ void __launch_bounds__(32 * kMergeWarps)
merge_partials(const float* __restrict__ part_s, const int* __restrict__ part_i,
               int rows, int total, int k, float* __restrict__ out_s,
               int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = kp_for(k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= rows) return;  // warp-uniform; no CTA-wide barrier below
  float* fbase = reinterpret_cast<float*>(smem) + warp * 2 * kp;
  int* ibase = reinterpret_cast<int*>(smem) + kMergeWarps * 2 * kp + warp * 2 * kp;
  Selector s;
  sel_init(s, fbase, ibase, k, lane);
  const float* ps = part_s + (size_t)row * total;
  const int* pi = part_i + (size_t)row * total;
  for (int base = 0; base < total; base += 32) {
    const int j = base + lane;
    const bool has = j < total;
    sel_push(s, has, has ? ps[j] : -INFINITY, has ? pi[j] : -1, lane);
  }
  sel_flush(s, lane);
  for (int j = lane; j < k; j += 32) {
    out_s[(size_t)row * k + j] = s.ls[j];
    out_i[(size_t)row * k + j] = s.li[j];
  }
}

// K9's packet of a candidate (text_similarity_tpu/index/ivf.py
// _pack_candidates): [30:17] the score's 14 bits, [16:11] the probe's index
// u in the block union, [10:0] the slot's position in its slab; s14 =
// (int)clamp((s + 1) · 8191.75, 0, 16383), truncating. Packets are ≥ 0 and
// unique apart from 0 (a dead slot's).
constexpr float kPackScale = 8191.75f;   // (2^14) / 2 − 0.25: (s + 1) · scale ≤ 2^14 − 1
constexpr int kPackLow = (1 << 17) - 1;  // the u and pos bits

__device__ __forceinline__ int pack_candidate(float s, int u, int pos) {
  const float v = fminf(fmaxf((s + 1.0f) * kPackScale, 0.f), 16383.f);
  return (static_cast<int>(v) << 17) | (u << 11) | pos;
}

inline int host_kp_for(int k) {
  int kp = 32;
  while (kp < k) kp <<= 1;
  return kp;
}

// rows × `total` candidates (part_*, row-major) → rows × k
inline cudaError_t launch_merge_rows(const float* part_s, const int* part_i, int rows,
                                     int total, int k, float* out_s, int* out_i,
                                     cudaStream_t st) {
  const size_t smem = (size_t)kMergeWarps * 4 * host_kp_for(k) * 4;
  merge_partials<<<(rows + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, smem,
                   st>>>(part_s, part_i, rows, total, k, out_s, out_i);
  return cudaGetLastError();
}

// rows × (P partial lists of k) → rows × k
inline cudaError_t launch_merge(const float* part_s, const int* part_i, int rows,
                                int P, int k, float* out_s, int* out_i,
                                cudaStream_t st) {
  return launch_merge_rows(part_s, part_i, rows, P * k, k, out_s, out_i, st);
}

}  // namespace
