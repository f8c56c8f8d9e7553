// The IVF scan's other modes: the packed accumulator (kernel K9; on
// ivf_tile.cu's wgmma tile for bf16 slabs, its CUDA-core kernel here for
// the rest), the copy-ring scan (K10) and several probes a staging step
// (K11a), both K1's entry.
//
// K9 replaces text_similarity_tpu/index/ivf.py _ivf_query_pallas_packed →
// _ivf_kernel_packed (:1392-1457): the deferred fold over ONE int32 packet
// a candidate, [30:17] = 14-bit score, [16:11] = the probe's index u in the
// union, [10:0] = the slot's position in its slab (_pack_candidates), so
// the fold is an integer max (a max/min cascade for S > 1 slots) and the
// flush takes the k largest packets; dead slots (id < 0) give packet 0.
// The packet is built from the f32 score exactly as the reference does:
// s14 = (int)clamp((s + 1) · 8191.75, 0, 16383), truncating
// (common.cuh's pack_candidate). Packets are unique, so the selection is
// an exact top-k with no ties; it runs on the shared selector with (score
// = s14, id = 2^17 − 1 − (packet & (2^17 − 1))), which orders pairs as the
// packets order, and ts_ivf_scan_packed converts the winners back to
// packets (missing → 0). U ≤ 64 and Mc ≤ 2048.
//
// With bf16 slabs, where ivf_tile_plan takes the shape (D a multiple of
// 64, Mc a multiple of 4), K9 runs on ivf_tile.cu's wgmma tile
// (ivf_tile_packed): K1's deferred mode at (w, S), each accumulator entry
// a packet built from the f32 wgmma accumulator in registers (u the
// probe's index in the CTA's walk, pos = chunk · w + range + row) and
// folded by the integer max / max-min cascade, 16·S registers a thread at
// N 32; empty tiles skipped, as K1 skips them (each of their slots would
// give packet 0, which changes neither fold); each CTA writes its 64·S
// entries a query as the pairs above, and the merge pass and
// pairs_to_packets follow. f32 slabs and the other shapes run the CUDA-core
// kernel below.
// Above k 256, where the selectors stop, K9 takes the large-k route:
// emit_acc writes every probed slot's score probe by probe, pack_classes
// below builds each candidate's packet in the lane-class layout, and
// topk_select.cu selects on int keys (each class's S largest, then the k
// largest of the (S·w) accumulator).
//
// K10 replaces _ivf_query_pallas_dma → _ivf_kernel_dma (:1533-1627): the
// reference copies each probed slab and its ids into VMEM through a ring of
// n_buffers async copies while the previous slab is scored, and folds at
// the slab's full width Mc into acc_slots slots, merged once at the end.
// That is K1's deferred mode at (approx_width = Mc, acc_slots = S), so
// ts_ivf_scan_dma runs K1 (ivf_k1_scan) at width Mc with S slots: on
// ivf_tile.cu's wgmma tile where ivf_tile_plan takes the shape (bf16 slabs,
// D a multiple of 64, Mc a multiple of 4), its TMA + mbarrier ring
// n_buffers stages deep, capped by what shared memory holds beside the
// block's queries (3 stages at D 384, so 3 and 4 buffers run alike there);
// on K1's CUDA-core kernel for the rest (f32 slabs, any other D, the
// sentinel layout's D + 1 among them, Mc % 4 ≠ 0). Its result is K1's at
// (Mc, S), bit for bit.
//
// K11a replaces _ivf_kernel_multiprobe (:1248-1301): P probes a step
// folded into a full-width single-slot accumulator. The caller pads the
// probe list to a multiple of P by repeating its last probe (strict >, so
// a repeated probe changes nothing). That is K1's deferred mode at
// (approx_width = Mc, acc_slots = 1) over the padded list, so
// ts_ivf_scan_multiprobe runs K1 (ivf_k1_scan) at width Mc with one slot:
// the wgmma tile with its own ring depth where ivf_tile_plan takes the
// shape (bf16 or int8 slabs, D a multiple of 64, Mc a multiple of 4), K1's
// CUDA-core kernel elsewhere; its result is K1's at (Mc, 1), bit for bit.
// P has no part in the scan: the reference stages P slabs a grid step to
// spread a TPU's fixed cost of some 3 µs a step over P probes
// (ivf.py:1252-1258); on Hopper the tile's TMA ring already copies the
// next live tile while the current one multiplies, and a CTA walks its
// whole probe list in one launch, so there is no step cost to spread.
//
// Bound on the H100: K9, K10 and K11a as K1, the bytes of the probed
// slabs' live tiles. K9's CUDA-core kernel does 2·B·U·Mc·D f32 FMAs:
// operation-bound well above the byte bound, it serves only the shapes the
// tile does not take.
#include "common.cuh"
#include "ivf_tile.cuh"

namespace {

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

// The merge's (B, k) pairs → out_p (B, k) packets.
cudaError_t to_packets(const float* sel_s, const int* sel_i, int n, int* out_p,
                       cudaStream_t st) {
  pairs_to_packets<<<(n + 255) / 256, 256, 0, st>>>(sel_s, sel_i, n, out_p);
  return cudaGetLastError();
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
  return to_packets(sel_s, sel_i, B * k, out_p, st);
}

}  // namespace

// K9: packed deferred scan (f32 / bf16 slabs) → out_p (B, k) int32 packets;
// sel_*: (B, k) scratch. The wgmma tile where ivf_tile_plan takes the bf16
// shape (ts_ivf_scan_tile_plan(1, D, Mc, block_q, k, width, slots) tells
// the caller; part_*: (B, ceil(width/64), 64·slots)), else the CUDA-core
// kernel (part_*: (B, ceil(width/128), k)).
extern "C" int ts_ivf_scan_packed(const float* q, const int* probes, const void* data,
                                  int data_bf16, const int* ids, int B, int D, int U, int C_tot,
                                  int Mc, int block_q, int k, int width, int slots,
                                  float* part_s, int* part_i, float* sel_s, int* sel_i,
                                  int* out_p, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (U > 64 || Mc > 2048) return (int)cudaErrorInvalidValue;
  IvfTilePlan plan;
  if (data_bf16 && ivf_tile_plan(1, D, Mc, block_q, k, width, slots, 0, &plan)) {
    const int err = ivf_tile_packed(q, probes, data, ids, B, D, U, C_tot, Mc, block_q, k, width,
                                    slots, part_s, part_i, sel_s, sel_i, stream);
    return err != 0 ? err : (int)to_packets(sel_s, sel_i, B * k, out_p, st);
  }
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
// n_buf stages (2-4): K1 at (Mc, slots), its tile ring at most n_buf deep.
// part_* as ts_ivf_scan sizes them; ts_ivf_scan_tile_plan with max_stages
// n_buf tells the caller which kernel runs.
extern "C" int ts_ivf_scan_dma(const float* q, const int* probes, const void* data,
                               int data_bf16, const int* ids, int B, int D, int U, int C_tot,
                               int Mc, int block_q, int k, int slots, int n_buf, float* part_s,
                               int* part_i, float* out_s, int* out_i, void* stream) {
  if (n_buf < 2 || n_buf > 4 || slots < 1) return (int)cudaErrorInvalidValue;
  return ivf_k1_scan(data_bf16 ? 1 : 0, q, probes, data, nullptr, ids, B, D, U, C_tot, Mc,
                     block_q, k, Mc, slots, n_buf, part_s, part_i, out_s, out_i, stream);
}

// K11a: P probes a step (U a multiple of P), full-width single-slot fold:
// K1 at (Mc, 1) over the padded list. data_kind 0 f32, 1 bf16, 2 int8 +
// scales; part_* as ts_ivf_scan sizes them, ts_ivf_scan_tile_plan(kind,
// D, Mc, block_q, k, Mc, 1) tells the caller which kernel runs.
extern "C" int ts_ivf_scan_multiprobe(const float* q, const int* probes, const void* data,
                                      int data_kind, const float* scales, const int* ids, int B,
                                      int D, int U, int P, int C_tot, int Mc, int block_q, int k,
                                      float* part_s, int* part_i, float* out_s, int* out_i,
                                      void* stream) {
  if (P < 1 || U % P || data_kind < 0 || data_kind > 2) return (int)cudaErrorInvalidValue;
  return ivf_k1_scan(data_kind, q, probes, data, scales, ids, B, D, U, C_tot, Mc, block_q, k,
                     Mc, 1, 0, part_s, part_i, out_s, out_i, stream);
}

namespace {

// One thread a candidate: (u, r, m) of the (U, R, Mc) scores goes to lane
// class c = m % w of row r, entry u · (Mc / w) + m / w.
__global__ void pack_classes(const float* __restrict__ s, const int* __restrict__ ids, int U,
                             int R, int Mc, int w, int* __restrict__ out) {
  const size_t total = (size_t)U * R * Mc;
  const size_t row_len = (size_t)U * (Mc / w);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(e % Mc);
    const size_t ur = e / Mc;
    const int r = (int)(ur % R), u = (int)(ur / R);
    out[((size_t)r * w + m % w) * row_len + (size_t)u * (Mc / w) + m / w] =
        ids[e] >= 0 ? pack_candidate(s[e], u, m) : 0;
  }
}

}  // namespace

// K9 above the selectors' k: the per-probe scores (U, R, Mc) f32 and ids
// of R queries (emit_acc at width Mc, one slot, the queries repeated once a
// probe) → each candidate's packet (pack_candidate; a dead slot, id < 0,
// gives 0), laid out as R·w rows of U·(Mc / w) packets, row r·w + c holding
// query r's lane class c in (u, chunk) order: the select kernel's int-key
// input for the fold. U ≤ 64, Mc ≤ 2048, w divides Mc.
extern "C" int ts_ivf_pack_classes(const float* s, const int* ids, int U, int R, int Mc, int w,
                                   int* out, void* stream) {
  if (U < 1 || U > 64 || Mc < 1 || Mc > 2048 || w < 1 || Mc % w || R < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const size_t total = (size_t)U * R * Mc;
  const int threads = 256;
  const size_t need = (total + threads - 1) / threads;
  const int blocks = need < 65535 * 8 ? (int)need : 65535 * 8;
  pack_classes<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(s, ids, U, R, Mc,
                                                                             w, out);
  return (int)cudaGetLastError();
}
