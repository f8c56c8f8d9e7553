// The IVF scan's other modes: the packed accumulator (kernel K9), the
// copy-ring scan (K10) and several probes a staging step (K11a).
//
// K9 replaces text_similarity_tpu/index/ivf.py _ivf_query_pallas_packed →
// _ivf_kernel_packed (:1392-1457): the deferred fold over ONE int32 packet
// a candidate, [30:17] = 14-bit score, [16:11] = the probe's index u in the
// union, [10:0] = the slot's position in its slab (_pack_candidates), so
// the fold is an integer max (a max/min cascade for S > 1 slots) and the
// flush takes the k largest packets; dead slots (id < 0) give packet 0.
// The packet is built from the f32 score exactly as the reference does:
// s14 = (int)clamp((s + 1) · 8191.75, 0, 16383), truncating. Packets are
// unique, so the selection is an exact top-k with no ties; it runs on the
// shared selector with (score = s14, id = 2^17 − 1 − (packet & (2^17 − 1))),
// which orders pairs as the packets order, and ts_ivf_scan_packed converts
// the winners back to packets (missing → 0). U ≤ 64 and Mc ≤ 2048.
//
// K10 replaces _ivf_query_pallas_dma → _ivf_kernel_dma (:1533-1627): the
// reference copies each probed slab and its ids into VMEM through a ring of
// n_buffers async copies while the previous slab is scored, and folds at
// the slab's full width Mc into acc_slots slots, merged once at the end.
// That is K1's deferred mode at (approx_width = Mc, acc_slots = S), which
// ivf_tile.cu computes on the tensor cores: where ivf_tile_plan takes the
// shape (bf16 slabs, D a multiple of 64, Mc a multiple of 4),
// ts_ivf_scan_dma runs that tile at width Mc with S slots, its TMA +
// mbarrier ring n_buffers stages deep, capped by what shared memory holds
// beside the block's queries (3 stages at D 384, so 3 and 4 buffers run
// alike there); its result equals K1's at (Mc, S) bit for bit. Other shapes
// (f32 slabs, any other D, the sentinel layout's D + 1 among them, Mc % 4
// ≠ 0) run ivf_dma_pass1 below, on the CUDA cores: the copied tile is one
// (probe, 32-dim chunk) of a CTA's 128 rows, and a ring of n_buffers
// stages of cp.async keeps the copy of tile t + n − 1 in flight while tile
// t is scored (the probe's 128 ids ride with its first chunk). The rows
// are copied as raw bytes: 16-byte copies where every row starts 16-byte
// aligned (D · sizeof(T) % 16 == 0), else 4-byte copies from the 4-byte
// boundary below each row segment, read back at that offset (the sentinel
// layout's D+1 rows need no alignment of the global stride). Its dot runs
// in the order of K1's CUDA-core kernel over the dims, so its ids equal
// that kernel's deferred fold at (Mc, S) bit for bit (K1 itself sums in
// wgmma's order on the tile).
//
// K11a replaces _ivf_kernel_multiprobe (:1248-1301): P probes a step (up to
// 4; the wrapper stages a larger P four at a time, which changes nothing in
// the result). The caller pads the probe list to a multiple of P by
// repeating its last probe;
// each staging step brings 32 dims of the CTA's 128 rows of all P slabs into
// shared memory, scores them, and after the last chunk folds the P slabs in
// probe order into a full-width single-slot accumulator (strict >, so a
// repeated probe changes nothing); one selection at the end. f32, bf16 and
// int8 (× the slot's scale) slabs.
//
// Bound on the H100: as K1, the slab bytes of the probed slabs against
// 2·B·U·Mc·D f32 FMAs on the CUDA cores: operation-bound well above the
// byte bound (K10 on the tile: K1's, bound by the bytes of its live tiles).
// A wgmma pipeline for K9 and K11a is later work.
#include "common.cuh"
#include "ivf_tile.cuh"

namespace {

constexpr float kPackScale = 8191.75f;   // (2^14) / 2 − 0.25: (s + 1) · scale ≤ 2^14 − 1
constexpr int kPackLow = (1 << 17) - 1;  // the u and pos bits

__device__ __forceinline__ int pack_candidate(float s, int u, int pos) {
  const float v = fminf(fmaxf((s + 1.0f) * kPackScale, 0.f), 16383.f);
  return (static_cast<int>(v) << 17) | (u << 11) | pos;
}

// Offer the 128 × 16 values staged in sc / sid (query-major, kRows a query)
// to the per-warp selectors: the same as K1's flush of a slot.
__device__ __forceinline__ void push_tile(Selector* sel, const float* sc, const int* sid,
                                          int qn, int lanes, int warp, int lane) {
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
}

__device__ __forceinline__ void write_partials(Selector* sel, int qn, int warp, int lane,
                                               int qrow0, int n_ranges, int range, int k,
                                               float* part_s, int* part_i) {
#pragma unroll
  for (int a2 = 0; a2 < kQPW; ++a2) {
    const int ql = warp + a2 * kWarps;
    if (ql >= qn) continue;
    sel_flush(sel[a2], lane);
    const size_t o = ((size_t)(qrow0 + ql) * n_ranges + range) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[o + j] = sel[a2].ls[j];
      part_i[o + j] = sel[a2].li[j];
    }
  }
}

__device__ __forceinline__ void fill_queries(const float* q, float* qs, int D, int ldq,
                                             int qrow0, int qn, bool to_bf16) {
  for (int idx = threadIdx.x; idx < kQTile * ldq; idx += kThreads) {
    const int qi = idx / ldq, d = idx % ldq;
    const float v = qi < qn && d < D ? q[(size_t)(qrow0 + qi) * D + d] : 0.f;
    qs[idx] = to_bf16 ? round_bf16(v) : v;
  }
}

// Shared memory of the pass-1 kernels after their own regions: sc, sid and
// the selectors.
inline size_t select_smem(int k) {
  return sizeof(float) * kQTile * kRows + sizeof(int) * kQTile * kRows +
         (size_t)kQTile * 2 * host_kp_for(k) * (sizeof(float) + sizeof(int));
}

// ---------------------------------------------------------------------------
// K9: the packed fold
// ---------------------------------------------------------------------------

#define PACKED_PARAMS                                                                   \
  const float* __restrict__ q, const int* __restrict__ probes, const T* __restrict__ data, \
      const int* __restrict__ ids, int D, int U, int C_tot, int Mc, int block_q, int n_sub, \
      int k, int width, int n_ranges, float* __restrict__ part_s, int *__restrict__ part_i
#define PACKED_ARGS \
  q, probes, data, ids, D, U, C_tot, Mc, block_q, n_sub, k, width, n_ranges, part_s, part_i

template <typename T, int S>
__device__ __forceinline__ void ivf_packed_pass1(PACKED_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = kp_for(k);
  const int ldq = q_stride(D);
  float* qs = reinterpret_cast<float*>(smem);
  float* ct = qs + kQTile * ldq;
  float* sc = ct + kRows * kDCP;
  int* sid = reinterpret_cast<int*>(sc + kQTile * kRows);
  float* sel_f = reinterpret_cast<float*>(sid + kQTile * kRows);
  int* sel_i = reinterpret_cast<int*>(sel_f + kQTile * 2 * kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x / n_sub, sub = blockIdx.x % n_sub;
  const int range = blockIdx.y, r0 = range * kRows;
  const int qrow0 = blk * block_q + sub * kQTile;
  const int qn = min(kQTile, block_q - sub * kQTile);
  const int lanes = min(kRows, width - r0);
  const int chunks = Mc / width;

  fill_queries(q, qs, D, ldq, qrow0, qn, !std::is_same_v<T, float>);
  Selector sel[kQPW];
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    const int ql = warp + a * kWarps;
    sel_init(sel[a], sel_f + ql * 2 * kp, sel_i + ql * 2 * kp, k, lane);
  }
  __syncthreads();

  const int r = tid % kRows, g = tid / kRows;
  int acc[kQPT][S];
#pragma unroll
  for (int j = 0; j < kQPT; ++j)
#pragma unroll
    for (int t = 0; t < S; ++t) acc[j][t] = 0;

  for (int u = 0; u < U; ++u) {
    const int c = probes[(size_t)blk * U + u];
    if (c < 0 || c >= C_tot) continue;  // CTA-uniform
    for (int ch = 0; ch < chunks; ++ch) {
      const size_t pos0 = (size_t)c * Mc + (size_t)ch * width + r0;
      float a[kQPT];
      tile_scores<T>(data + pos0 * D, lanes, D, qs, ldq, ct, a);
      if (r < lanes) {
        const int id = ids[pos0 + r];
        const int pos = ch * width + r0 + r;
#pragma unroll
        for (int j = 0; j < kQPT; ++j) {
          int p = id >= 0 ? pack_candidate(a[j], u, pos) : 0;
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const int hi = max(acc[j][t], p);
            p = min(acc[j][t], p);
            acc[j][t] = hi;
          }
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < S; ++t) {
#pragma unroll
    for (int j = 0; j < kQPT; ++j) {
      const int p = acc[j][t];
      sc[(g * kQPT + j) * kRows + r] = p > 0 ? static_cast<float>(p >> 17) : -INFINITY;
      sid[(g * kQPT + j) * kRows + r] = p > 0 ? kPackLow - (p & kPackLow) : -1;
    }
    __syncthreads();
    push_tile(sel, sc, sid, qn, lanes, warp, lane);
    __syncthreads();
  }
  write_partials(sel, qn, warp, lane, qrow0, n_ranges, range, k, part_s, part_i);
}

// K1's two register budgets (ivf_scan.cu): 3 CTAs an SM for one slot
template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 3) ivf_packed_lean(PACKED_PARAMS) {
  ivf_packed_pass1<T, S>(PACKED_ARGS);
}
template <typename T, int S>
__global__ void __launch_bounds__(kThreads) ivf_packed_wide(PACKED_PARAMS) {
  ivf_packed_pass1<T, S>(PACKED_ARGS);
}
#undef PACKED_PARAMS
#undef PACKED_ARGS

template <typename T, int S>
auto packed_kernel() {
  if constexpr (S <= 1) return ivf_packed_lean<T, S>;
  else return ivf_packed_wide<T, S>;
}

__global__ void pairs_to_packets(const float* __restrict__ s, const int* __restrict__ i,
                                 int n, int* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  out[x] = s[x] == -INFINITY ? 0 : (static_cast<int>(s[x]) << 17) | (kPackLow - i[x]);
}

template <typename T, int S>
cudaError_t run_packed(const float* q, const int* probes, const T* data, const int* ids, int B,
                       int D, int U, int C_tot, int Mc, int block_q, int k, int width,
                       float* part_s, int* part_i, float* sel_s, int* sel_i, int* out_p,
                       cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)kQTile * q_stride(D) + kRows * kDCP) +
                      select_smem(k);
  const auto kernel = packed_kernel<T, S>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_sub = (block_q + kQTile - 1) / kQTile;
  const int n_ranges = (width + kRows - 1) / kRows;
  dim3 grid(B / block_q * n_sub, n_ranges);
  kernel<<<grid, kThreads, smem, st>>>(q, probes, data, ids, D, U, C_tot, Mc, block_q, n_sub, k,
                                      width, n_ranges, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_merge(part_s, part_i, B, n_ranges, k, sel_s, sel_i, st);
  if (err != cudaSuccess) return err;
  const int n = B * k;
  pairs_to_packets<<<(n + 255) / 256, 256, 0, st>>>(sel_s, sel_i, n, out_p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10: the copy ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most n (0-3) committed groups of this thread are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// a row's 32-dim chunk plus room for the offset of an unaligned row
template <typename T>
__host__ __device__ constexpr int seg_bytes() { return kDC * (int)sizeof(T) + 16; }

// one stage: 128 row chunks, then the probe's 128 ids
template <typename T>
__host__ __device__ constexpr int stage_bytes() { return kRows * seg_bytes<T>() + kRows * 4; }

// Start the copies of tile t = (probe index u, chunk cc) into its stage;
// every thread commits one group (empty when there is nothing to copy).
template <typename T>
__device__ __forceinline__ void issue_tile(int t, int n_tiles, int n_chunks, const int* probes,
                                           int blk, int U, int C_tot, int Mc, int D, int r0,
                                           int lanes, const T* data, const int* ids,
                                           const unsigned char* data_end, unsigned char* ring,
                                           int n_buf) {
  if (t < n_tiles) {
    const int u = t / n_chunks, cc = t % n_chunks;
    const int c = probes[(size_t)blk * U + u];
    if (c >= 0 && c < C_tot) {
      unsigned char* stage = ring + (size_t)(t % n_buf) * stage_bytes<T>();
      const int d0 = cc * kDC;
      const int len = min(kDC, D - d0) * (int)sizeof(T);
      const bool vec = (D * sizeof(T)) % 16 == 0;
      const int unit = vec ? 16 : 4;
      const int per_row = vec ? kDC * (int)sizeof(T) / 16 : kDC * (int)sizeof(T) / 4 + 1;
      for (int idx = threadIdx.x; idx < kRows * per_row; idx += kThreads) {
        const int row = idx / per_row, un = idx % per_row;
        if (row >= lanes) continue;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            data + ((size_t)c * Mc + r0 + row) * D + d0);
        const unsigned char* a0 = reinterpret_cast<const unsigned char*>(
            reinterpret_cast<uintptr_t>(src) & ~static_cast<uintptr_t>(unit - 1));
        const int n_units = (int)((src - a0) + len + unit - 1) / unit;
        if (un >= n_units) continue;
        const unsigned char* from = a0 + un * unit;
        unsigned char* to = stage + row * seg_bytes<T>() + un * unit;
        if (vec) {
          cp_async16(to, from);
        } else if (from + 4 <= data_end) {
          cp_async4(to, from);
        } else {
          for (int b = 0; b < 4 && from + b < data_end; ++b) to[b] = from[b];
        }
      }
      if (cc == 0) {
        int* sid = reinterpret_cast<int*>(stage + kRows * seg_bytes<T>());
        for (int row = threadIdx.x; row < lanes; row += kThreads)
          cp_async4(sid + row, ids + (size_t)c * Mc + r0 + row);
      }
    }
  }
  cp_async_commit();
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
ivf_dma_pass1(const float* __restrict__ q, const int* __restrict__ probes,
              const T* __restrict__ data, const int* __restrict__ ids,
              const unsigned char* data_end, int D, int U, int C_tot, int Mc, int block_q,
              int n_sub, int k, int n_ranges, int n_buf, float* __restrict__ part_s,
              int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = kp_for(k);
  const int ldq = q_stride(D);
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = reinterpret_cast<unsigned char*>(qs + kQTile * ldq);
  float* sc = reinterpret_cast<float*>(ring + (size_t)n_buf * stage_bytes<T>());
  int* sid = reinterpret_cast<int*>(sc + kQTile * kRows);
  float* sel_f = reinterpret_cast<float*>(sid + kQTile * kRows);
  int* sel_i = reinterpret_cast<int*>(sel_f + kQTile * 2 * kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x / n_sub, sub = blockIdx.x % n_sub;
  const int range = blockIdx.y, r0 = range * kRows;
  const int qrow0 = blk * block_q + sub * kQTile;
  const int qn = min(kQTile, block_q - sub * kQTile);
  const int lanes = min(kRows, Mc - r0);
  const int n_chunks = (D + kDC - 1) / kDC;
  const int n_tiles = U * n_chunks;

  // prime the ring: n_buf − 1 tiles in flight before the first is scored
  for (int t = 0; t < n_buf - 1; ++t)
    issue_tile<T>(t, n_tiles, n_chunks, probes, blk, U, C_tot, Mc, D, r0, lanes, data, ids,
                  data_end, ring, n_buf);
  fill_queries(q, qs, D, ldq, qrow0, qn, !std::is_same_v<T, float>);
  Selector sel[kQPW];
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    const int ql = warp + a * kWarps;
    sel_init(sel[a], sel_f + ql * 2 * kp, sel_i + ql * 2 * kp, k, lane);
  }

  const int r = tid % kRows, g = tid / kRows;
  const bool vec = (D * sizeof(T)) % 16 == 0;
  float acc_s[kQPT][S];
  int acc_i[kQPT][S];
  float a[kQPT];
  int my_id = -1;
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    a[j] = 0.f;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      acc_s[j][t] = -INFINITY;
      acc_i[j][t] = -1;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    // the copy of tile t + n − 1 goes out before tile t is scored
    issue_tile<T>(t + n_buf - 1, n_tiles, n_chunks, probes, blk, U, C_tot, Mc, D, r0, lanes,
                  data, ids, data_end, ring, n_buf);
    cp_async_wait(n_buf - 1);
    __syncthreads();
    const int u = t / n_chunks, cc = t % n_chunks;
    const int c = probes[(size_t)blk * U + u];
    if (c >= 0 && c < C_tot && r < lanes) {
      const unsigned char* stage = ring + (size_t)(t % n_buf) * stage_bytes<T>();
      const int d0 = cc * kDC;
      const int dn = min(kDC, D - d0);
      if (cc == 0) {
        my_id = reinterpret_cast<const int*>(stage + kRows * seg_bytes<T>())[r];
#pragma unroll
        for (int j = 0; j < kQPT; ++j) a[j] = 0.f;
      }
      const size_t gaddr = reinterpret_cast<uintptr_t>(data + ((size_t)c * Mc + r0 + r) * D + d0);
      const T* row = reinterpret_cast<const T*>(stage + r * seg_bytes<T>() + (vec ? 0 : gaddr & 3));
      const float* qg = qs + (size_t)(g * kQPT) * ldq + d0;
      if (vec) {
        constexpr int kVec = 16 / sizeof(T);
        for (int d = 0; d < dn; d += kVec) {
          float vals[kVec];
          if constexpr (std::is_same_v<T, float>) {
            const float4 v = *reinterpret_cast<const float4*>(row + d);
            vals[0] = v.x; vals[1] = v.y; vals[2] = v.z; vals[3] = v.w;
          } else {
            const uint4 v = *reinterpret_cast<const uint4*>(row + d);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h[e]);
              vals[2 * e] = f.x;
              vals[2 * e + 1] = f.y;
            }
          }
          // K1's order: per query, dims d, d+1, d+2, d+3 in turn
#pragma unroll
          for (int e = 0; e < kVec; e += 4)
#pragma unroll
            for (int j = 0; j < kQPT; ++j) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + (size_t)j * ldq + d + e);
              a[j] = fmaf(vals[e], qv.x, a[j]);
              a[j] = fmaf(vals[e + 1], qv.y, a[j]);
              a[j] = fmaf(vals[e + 2], qv.z, a[j]);
              a[j] = fmaf(vals[e + 3], qv.w, a[j]);
            }
        }
      } else {
        for (int d = 0; d < dn; ++d) {
          const float v = to_f32(row[d]);
#pragma unroll
          for (int j = 0; j < kQPT; ++j) a[j] = fmaf(v, qg[(size_t)j * ldq + d], a[j]);
        }
      }
      if (cc == n_chunks - 1) {
#pragma unroll
        for (int j = 0; j < kQPT; ++j) {
          float ds = my_id >= 0 ? a[j] : -INFINITY;
          int di = my_id;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (ds > acc_s[j][s]) {
              const float ts = acc_s[j][s];
              const int ti = acc_i[j][s];
              acc_s[j][s] = ds;
              acc_i[j][s] = di;
              ds = ts;
              di = ti;
            }
          }
        }
      }
    }
    __syncthreads();   // the stage is free for the copy issued next
  }
  cp_async_wait(0);

#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < kQPT; ++j) {
      sc[(g * kQPT + j) * kRows + r] = acc_s[j][s];
      sid[(g * kQPT + j) * kRows + r] = acc_i[j][s];
    }
    __syncthreads();
    push_tile(sel, sc, sid, qn, lanes, warp, lane);
    __syncthreads();
  }
  write_partials(sel, qn, warp, lane, qrow0, n_ranges, range, k, part_s, part_i);
}

template <typename T, int S>
cudaError_t run_dma(const float* q, const int* probes, const T* data, long long data_bytes,
                    const int* ids, int B, int D, int U, int C_tot, int Mc, int block_q, int k,
                    int n_buf, float* part_s, int* part_i, float* out_s, int* out_i,
                    cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)kQTile * q_stride(D) +
                      (size_t)n_buf * stage_bytes<T>() + select_smem(k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_dma_pass1<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_sub = (block_q + kQTile - 1) / kQTile;
  const int n_ranges = (Mc + kRows - 1) / kRows;
  dim3 grid(B / block_q * n_sub, n_ranges);
  const unsigned char* end = reinterpret_cast<const unsigned char*>(data) + data_bytes;
  ivf_dma_pass1<T, S><<<grid, kThreads, smem, st>>>(q, probes, data, ids, end, D, U, C_tot, Mc,
                                                    block_q, n_sub, k, n_ranges, n_buf,
                                                    part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part_s, part_i, B, n_ranges, k, out_s, out_i, st);
}

// ---------------------------------------------------------------------------
// K11a: P probes a staging step
// ---------------------------------------------------------------------------

constexpr int kMaxP = 4;   // slabs staged a step (the wrapper stages P > 4 four at a time)

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
ivf_multiprobe_pass1(const float* __restrict__ q, const int* __restrict__ probes,
                     const T* __restrict__ data, const float* __restrict__ scales,
                     const int* __restrict__ ids, int D, int U, int C_tot, int Mc,
                     int block_q, int n_sub, int k, int n_ranges, float* __restrict__ part_s,
                     int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kDC / kVec;
  const int kp = kp_for(k);
  const int ldq = q_stride(D);
  float* qs = reinterpret_cast<float*>(smem);
  float* ct = qs + kQTile * ldq;                   // P × kRows × kDCP
  float* sc = ct + (size_t)P * kRows * kDCP;
  int* sid = reinterpret_cast<int*>(sc + kQTile * kRows);
  float* sel_f = reinterpret_cast<float*>(sid + kQTile * kRows);
  int* sel_i = reinterpret_cast<int*>(sel_f + kQTile * 2 * kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x / n_sub, sub = blockIdx.x % n_sub;
  const int range = blockIdx.y, r0 = range * kRows;
  const int qrow0 = blk * block_q + sub * kQTile;
  const int qn = min(kQTile, block_q - sub * kQTile);
  const int lanes = min(kRows, Mc - r0);
  const bool vec = (D * sizeof(T)) % 16 == 0;

  fill_queries(q, qs, D, ldq, qrow0, qn, !std::is_same_v<T, float>);
  Selector sel[kQPW];
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    const int ql = warp + a * kWarps;
    sel_init(sel[a], sel_f + ql * 2 * kp, sel_i + ql * 2 * kp, k, lane);
  }
  __syncthreads();

  const int r = tid % kRows, g = tid / kRows;
  float acc_s[kQPT];
  int acc_i[kQPT];
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    acc_s[j] = -INFINITY;
    acc_i[j] = -1;
  }

  for (int step = 0; step < U / P; ++step) {
    const int* plist = probes + (size_t)blk * U + (size_t)step * P;
    float a[P][kQPT];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < kQPT; ++j) a[p][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      // stage 32 dims of the CTA's rows of all P slabs
      for (int idx = tid; idx < P * kRows * kPerRow; idx += kThreads) {
        const int p = idx / (kRows * kPerRow);
        const int row = (idx / kPerRow) % kRows, v = idx % kPerRow;
        const int c = plist[p];
        const int dd = d0 + v * kVec;
        const bool live = c >= 0 && c < C_tot && row < lanes;
        const T* src = data + ((size_t)(live ? c : 0) * Mc + r0 + row) * D + dd;
        float vals[kVec];
        if (live && vec && dd + kVec <= D) {
          load16(src, vals);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) vals[e] = live && dd + e < D ? to_f32(src[e]) : 0.f;
        }
        float* dst = ct + ((size_t)p * kRows + row) * kDCP + v * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
      }
      __syncthreads();
      const float* qg = qs + (size_t)(g * kQPT) * ldq + d0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* crow = ct + ((size_t)p * kRows + r) * kDCP;
#pragma unroll
        for (int d = 0; d < kDC; d += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(crow + d);
#pragma unroll
          for (int j = 0; j < kQPT; ++j) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + (size_t)j * ldq + d);
            a[p][j] = fmaf(cv.x, qv.x, a[p][j]);
            a[p][j] = fmaf(cv.y, qv.y, a[p][j]);
            a[p][j] = fmaf(cv.z, qv.z, a[p][j]);
            a[p][j] = fmaf(cv.w, qv.w, a[p][j]);
          }
        }
      }
      __syncthreads();
    }
    // fold the P slabs in probe order (strict >: a repeated probe is a no-op)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = plist[p];
      if (c < 0 || c >= C_tot || r >= lanes) continue;
      const size_t pos = (size_t)c * Mc + r0 + r;
      const int id = ids[pos];
      float scale = 1.f;
      if constexpr (std::is_same_v<T, int8_t>) scale = scales[pos];
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        float s = a[p][j];
        if constexpr (std::is_same_v<T, int8_t>) s *= scale;
        const float ds = id >= 0 ? s : -INFINITY;
        if (ds > acc_s[j]) {
          acc_s[j] = ds;
          acc_i[j] = id;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    sc[(g * kQPT + j) * kRows + r] = acc_s[j];
    sid[(g * kQPT + j) * kRows + r] = acc_i[j];
  }
  __syncthreads();
  push_tile(sel, sc, sid, qn, lanes, warp, lane);
  __syncthreads();
  write_partials(sel, qn, warp, lane, qrow0, n_ranges, range, k, part_s, part_i);
}

template <typename T, int P>
cudaError_t run_multiprobe_p(const float* q, const int* probes, const T* data,
                             const float* scales, const int* ids, int B, int D, int U, int C_tot,
                             int Mc, int block_q, int k, float* part_s, int* part_i,
                             float* out_s, int* out_i, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)kQTile * q_stride(D) + (size_t)P * kRows * kDCP) +
                      select_smem(k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_multiprobe_pass1<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_sub = (block_q + kQTile - 1) / kQTile;
  const int n_ranges = (Mc + kRows - 1) / kRows;
  dim3 grid(B / block_q * n_sub, n_ranges);
  ivf_multiprobe_pass1<T, P><<<grid, kThreads, smem, st>>>(q, probes, data, scales, ids, D, U,
                                                           C_tot, Mc, block_q, n_sub, k,
                                                           n_ranges, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part_s, part_i, B, n_ranges, k, out_s, out_i, st);
}

template <typename T>
cudaError_t run_multiprobe(const float* q, const int* probes, const T* data, const float* scales,
                           const int* ids, int B, int D, int U, int P, int C_tot, int Mc,
                           int block_q, int k, float* part_s, int* part_i, float* out_s,
                           int* out_i, cudaStream_t st) {
  if (P < 1 || P > kMaxP || U % P) return cudaErrorInvalidValue;
#define TS_MP(P_) run_multiprobe_p<T, P_>(q, probes, data, scales, ids, B, D, U, C_tot, Mc, \
                                          block_q, k, part_s, part_i, out_s, out_i, st)
  switch (P) {
    case 1: return TS_MP(1);
    case 2: return TS_MP(2);
    case 3: return TS_MP(3);
    default: return TS_MP(4);
  }
#undef TS_MP
}

}  // namespace

// K9: packed deferred scan (f32 / bf16 slabs) → out_p (B, k) int32 packets.
// part_*: (B, ceil(width/128), k); sel_*: (B, k) scratch.
extern "C" int ts_ivf_scan_packed(const float* q, const int* probes, const void* data,
                                  int data_bf16, const int* ids, int B, int D, int U, int C_tot,
                                  int Mc, int block_q, int k, int width, int slots,
                                  float* part_s, int* part_i, float* sel_s, int* sel_i,
                                  int* out_p, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (U > 64 || Mc > 2048) return (int)cudaErrorInvalidValue;
#define TS_PACKED(T_, S_) run_packed<T_, S_>(q, probes, static_cast<const T_*>(data), ids, B, D, \
                                             U, C_tot, Mc, block_q, k, width, part_s, part_i,    \
                                             sel_s, sel_i, out_p, st)
  cudaError_t err;
  switch (slots * 2 + (data_bf16 ? 1 : 0)) {
    case 2: err = TS_PACKED(float, 1); break;
    case 3: err = TS_PACKED(__nv_bfloat16, 1); break;
    case 4: err = TS_PACKED(float, 2); break;
    case 5: err = TS_PACKED(__nv_bfloat16, 2); break;
    case 6: err = TS_PACKED(float, 3); break;
    case 7: err = TS_PACKED(__nv_bfloat16, 3); break;
    case 8: err = TS_PACKED(float, 4); break;
    case 9: err = TS_PACKED(__nv_bfloat16, 4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef TS_PACKED
  return (int)err;
}

// K10: the copy-ring scan at full width Mc with `slots` slots (f32 / bf16);
// n_buf stages (2-4). On the wgmma tile where ivf_tile_plan takes the shape
// (part_*: (B, ceil(Mc / 64), 64·S); the ring at most n_buf deep), else
// ivf_dma_pass1 (part_*: (B, ceil(Mc / 128), k)); ts_ivf_scan_tile_plan
// with max_stages n_buf tells the caller which. data_bytes = the whole slab
// tensor's size (ivf_dma_pass1's 4-byte copies never read past it).
extern "C" int ts_ivf_scan_dma(const float* q, const int* probes, const void* data,
                               int data_bf16, long long data_bytes, const int* ids, int B, int D,
                               int U, int C_tot, int Mc, int block_q, int k, int slots,
                               int n_buf, float* part_s, int* part_i, float* out_s, int* out_i,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n_buf < 2 || n_buf > 4) return (int)cudaErrorInvalidValue;
  IvfTilePlan plan;
  if (data_bf16 && ivf_tile_plan(1, D, Mc, block_q, k, Mc, slots, n_buf, &plan))
    return ivf_tile_scan(1, q, probes, data, nullptr, ids, nullptr, nullptr, B, D, U, C_tot, Mc,
                         block_q, k, Mc, slots, n_buf, part_s, part_i, out_s, out_i, stream);
#define TS_DMA(T_, S_) run_dma<T_, S_>(q, probes, static_cast<const T_*>(data), data_bytes, ids, \
                                       B, D, U, C_tot, Mc, block_q, k, n_buf, part_s, part_i,   \
                                       out_s, out_i, st)
  cudaError_t err;
  switch (slots * 2 + (data_bf16 ? 1 : 0)) {
    case 2: err = TS_DMA(float, 1); break;
    case 3: err = TS_DMA(__nv_bfloat16, 1); break;
    case 4: err = TS_DMA(float, 2); break;
    case 5: err = TS_DMA(__nv_bfloat16, 2); break;
    case 6: err = TS_DMA(float, 3); break;
    case 7: err = TS_DMA(__nv_bfloat16, 3); break;
    case 8: err = TS_DMA(float, 4); break;
    case 9: err = TS_DMA(__nv_bfloat16, 4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef TS_DMA
  return (int)err;
}

// K11a: P probes a step (U a multiple of P, P ≤ 4), full-width single-slot
// fold. data_kind 0 f32, 1 bf16, 2 int8 + scales.
extern "C" int ts_ivf_scan_multiprobe(const float* q, const int* probes, const void* data,
                                      int data_kind, const float* scales, const int* ids, int B,
                                      int D, int U, int P, int C_tot, int Mc, int block_q, int k,
                                      float* part_s, int* part_i, float* out_s, int* out_i,
                                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (data_kind) {
    case 0:
      return (int)run_multiprobe<float>(q, probes, static_cast<const float*>(data), nullptr, ids,
                                        B, D, U, P, C_tot, Mc, block_q, k, part_s, part_i, out_s,
                                        out_i, st);
    case 1:
      return (int)run_multiprobe<__nv_bfloat16>(q, probes,
                                                static_cast<const __nv_bfloat16*>(data), nullptr,
                                                ids, B, D, U, P, C_tot, Mc, block_q, k, part_s,
                                                part_i, out_s, out_i, st);
    case 2:
      return (int)run_multiprobe<int8_t>(q, probes, static_cast<const int8_t*>(data), scales,
                                         ids, B, D, U, P, C_tot, Mc, block_q, k, part_s, part_i,
                                         out_s, out_i, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
