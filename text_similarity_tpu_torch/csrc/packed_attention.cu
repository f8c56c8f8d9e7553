// Exact softmax attention over per-sequence key lengths (kernel K7).
//
// Replaces text_similarity_tpu/ops/attention.py _packed_forward →
// _packed_kernel (the pallas_call at :684), the head-packed kernel behind
// multi_head_attention(impl="packed"). For batch b, head h and every query
// row i < S (padded rows included):
//   s_ij = <q_i, k_j> · D^-1/2, operands in the input dtype, f32 sums;
//   keys j >= len[b] get weight exactly 0; m_i = max_j s_ij over the valid
//   keys; p_ij = exp(s_ij - m_i) / l_i with l_i = sum_j exp(s_ij - m_i), and
//   l_i = 1 where it is 0 (a zero-length row gives 0); p rounded to the input
//   dtype before P·V, f32 sums; o_i in the input dtype.
// Unlike K5, p is normalised before it is rounded, as the reference does.
//
// Bound on the H100: at the timed shape (B 128, S 128, H 12, D 32, bf16)
// the function reads q and writes o in full and reads K and V for the
// valid keys only (about 39 MB at lengths 16-128: 0.012 ms), and does
// 4·S·len·D operations per (b, h) (1.9 GFLOP: 0.002 ms at 989 TFLOP/s),
// so it is bound by bytes. On the card it is bound by neither: the
// softmax's instructions, an exp and a division for every score, bind it
// (PERF.md §6). The one-sweep kernel below takes about 0.043 ms of device
// time at that shape on an H100 SXM (tools/packed_ab.py), 3.7× its bound.
//
// Design. The TPU kernel folds 128 / D heads into its 128 lanes and masks
// the lanes per head; on the card the heads need no folding. q, k and v
// are read through (batch, token, head) strides with the last dim
// contiguous, so the encoder hands over views of its fused QKV without
// copies.
//  * bf16, S ≤ 128 (the encoder's packed and bucketed rows): one sweep.
//    One CTA owns all S query rows of one (b, h), a warp for each 16 rows,
//    so K and V are read once a head (neighbouring CTAs take neighbouring
//    heads, whose pieces sit side by side in the fused QKV). Q, the keys
//    below len and the values below len go into shared memory by
//    cp.async, 16 bytes a thread, all issued at once; rows from len to the
//    next 16 are zero-filled without a read, keys past that are neither
//    read nor staged, and the values land while the scores are computed.
//    A warp's 16 rows × ⌈len / 8⌉ key groups of scores fit in registers
//    (64 f32 a lane at S 128), so the softmax is the reference's own: the
//    row max, exp, the sum, p / l rounded to bf16, with no online
//    rescaling and no second pass over K. Its cost is cut without
//    changing a bit: the score products, the exps and the divisions of
//    whole 8-key groups at or past len are skipped (warp-uniform tests),
//    only the group that holds key len − 1 is masked, and p / l is one
//    multiply by 1 / l and one fma correction (correctly rounded, as the
//    division). Three CTAs of 8 warps share an SM (80 registers a thread
//    at D ≤ 64), so one CTA's copies overlap another's softmax.
//    mma.sync m16n8k16 (bf16 operands, f32 sums); every fragment comes by
//    ldmatrix from rows padded by 16 bytes, V's by ldmatrix.trans from V
//    as it was copied, so nothing is transposed on the way in. The output
//    goes through the warp's own Q rows in shared memory, so it is written
//    16 bytes a lane.
//  * bf16, S > 128: one CTA owns one (b·h, 64-row q-block) and walks the
//    key blocks of 64 below ceil(len / 64) twice: the first sweep keeps
//    the running max and sum (m, l) of each row, the second recomputes the
//    scores, forms p = exp(s − m) / l, rounds it and accumulates P·V in
//    registers; 4 warps on mma.sync m16n8k16 (flash_common.cuh).
//  * f32 (exact, no TF32): the same two sweeps, 256 threads on the CUDA
//    cores; thread (ty, tx) scores rows 4ty..4ty+3 against keys
//    4tx..4tx+3 and accumulates output columns tx·D/16 .. of the same rows.
#include "flash_common.cuh"

namespace {

struct PackedArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;              // (B, S, H, D) contiguous, q's dtype
  const int* lengths;   // (B,)
  int B, S, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16, S ≤ 128: one sweep
// ---------------------------------------------------------------------------

constexpr int kOneSweepMaxS = 128;   // a warp's 16 rows × S keys of scores in registers
constexpr int kOneSweepThreads = kOneSweepMaxS / 16 * 32;

// A staged row: D bf16 values and 16 bytes of padding, so the 8 rows an
// ldmatrix reads start in 8 distinct 16-byte bank groups.
template <int D>
constexpr int kSweepRowBytes = 2 * D + 16;

// Shared memory for S ≤ 128: Q, K and V, each round_up(S, 16) rows.
template <int D>
size_t one_sweep_smem_bytes(int S) {
  return 3 * (size_t)((S + 15) / 16 * 16) * kSweepRowBytes<D>;
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));   // src-size 0: 16 zero bytes, nothing read
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 × 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and lane 4g + t receives row g, columns 2t, 2t + 1 of each (with
// kTrans: column g, rows 2t, 2t + 1).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

// Rows [0, n) of one (b, h) slice (token stride ss) into dst, kSweepRowBytes
// a row; rows in [valid, n) are zero-filled without a read.
template <int D>
__device__ __forceinline__ void copy_rows_async(const __nv_bfloat16* __restrict__ base,
                                                long long ss, int n, int valid,
                                                unsigned char* dst) {
  constexpr int kPieces = D / 8;   // 16 bytes each
  for (int p = threadIdx.x; p < n * kPieces; p += blockDim.x) {
    const int r = p / kPieces, c = p % kPieces;
    const bool ok = r < valid;
    copy16_async(dst + r * kSweepRowBytes<D> + c * 16, ok ? base + r * ss + c * 8 : base, ok);
  }
}

// p / l correctly rounded from r = 1 / l (itself correctly rounded): the
// residual p − l·q is exact in an fma, and one correction step rounds the
// quotient as a division does (Markstein), for the normal p and l here.
__device__ __forceinline__ float div_by(float p, float l, float r) {
  const float q = p * r;
  return fmaf(fmaf(-l, q, p), r, q);
}

// One CTA a (b, h), a warp for each 16 query rows. Lane 4g + t holds, of a
// 16 × 8 f32 mma accumulator, rows g and g + 8 at columns 2t, 2t + 1 (PTX
// m16n8k16).
template <int D>
__global__ void __launch_bounds__(kOneSweepThreads, D <= 64 ? 3 : 1)
packed_attn_bf16_one_sweep(const PackedArgs a) {
  constexpr int kRow = kSweepRowBytes<D>;
  constexpr int kGroups = kOneSweepMaxS / 8;   // 8-key column groups
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  using bf16 = __nv_bfloat16;
  const int S = a.S, H = a.H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int rows = blockDim.x / 2;             // 16 query rows a warp: round_up(S, 16)
  unsigned char* qs = sweep_smem;
  unsigned char* ks = qs + rows * kRow;
  unsigned char* vs = ks + rows * kRow;
  // Q, then the keys and values below round_up(len, 16) (zero past len),
  // as two groups: the values land while the scores are computed
  copy_rows_async<D>(static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh, a.qss, rows, S, qs);
  const int len = max(0, min(a.lengths[b], S));
  const int len16 = (len + 15) / 16 * 16;
  copy_rows_async<D>(static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh, a.kss, len16, len,
                     ks);
  copy_commit();
  copy_rows_async<D>(static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh, a.vss, len16, len,
                     vs);
  copy_commit();
  copy_wait<1>();      // Q and K landed (this thread's copies)
  __syncthreads();     // ... and everyone's

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4<false>(qa[kk], qs + (r0 + (lane & 15)) * kRow + kk * 32 + (lane >> 4) * 16);

  // scores of the warp's 16 rows against every valid 8-key group; groups
  // past len are skipped (warp-uniform)
  const int n_groups = (len + 7) / 8, n_full = len / 8;
  float sc[kGroups][4];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    if (j < n_groups) {
#pragma unroll
      for (int kk2 = 0; kk2 < D / 32; ++kk2) {
        uint32_t kb[4];
        ldsm_x4<false>(kb, ks + (j * 8 + (lane & 7)) * kRow + kk2 * 64 + (lane >> 3) * 16);
        mma_16816(sc[j], qa[2 * kk2], kb[0], kb[1]);
        mma_16816(sc[j], qa[2 * kk2 + 1], kb[2], kb[3]);
      }
    }
  }

  // the reference's softmax over the valid groups (only the group that
  // holds key len − 1 is masked): s · D^-1/2, the row max, p = exp(s − m)
  // (0 past len), l = Σ p (1 where 0), p / l rounded to bf16 pairs
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    if (j >= n_groups) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = j < n_full || j * 8 + 2 * t + (e & 1) < len;
      sc[j][e] = ok ? sc[j][e] * a.scale : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    if (j >= n_groups) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = j < n_full || j * 8 + 2 * t + (e & 1) < len;
      sc[j][e] = ok ? expf(sc[j][e] - mx[e >> 1]) : 0.f;
      l[e >> 1] += sc[j][e];
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float ld[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  const float rl[2] = {1.f / ld[0], 1.f / ld[1]};
  uint32_t pp[kGroups][2];   // P·V's A operand: rows g and g + 8, keys 2t, 2t + 1
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    pp[j][0] = pp[j][1] = 0u;
    if (j >= n_groups) continue;
    pp[j][0] = pack_bf16x2(div_by(sc[j][0], ld[0], rl[0]), div_by(sc[j][1], ld[0], rl[0]));
    pp[j][1] = pack_bf16x2(div_by(sc[j][2], ld[1], rl[1]), div_by(sc[j][3], ld[1], rl[1]));
  }

  // P · V over the valid 16-key chunks
  copy_wait<0>();
  __syncthreads();     // V landed
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int n_chunks = len16 / 16;
#pragma unroll
  for (int kk = 0; kk < kGroups / 2; ++kk) {
    if (kk < n_chunks) {   // warp-uniform
      const uint32_t pa[4] = {pp[2 * kk][0], pp[2 * kk][1], pp[2 * kk + 1][0], pp[2 * kk + 1][1]};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vb[4];
        ldsm_x4<true>(vb, vs + (kk * 16 + (lane & 15)) * kRow + n2 * 32 + (lane >> 4) * 16);
        mma_16816(o[2 * n2], pa, vb[0], vb[1]);
        mma_16816(o[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // o → the warp's own Q rows (read by no other warp) → 16-byte stores
  unsigned char* os = qs + r0 * kRow;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * kRow + n * 16 + 4 * t) = pack_bf16x2(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * kRow + n * 16 + 4 * t) =
        pack_bf16x2(o[n][2], o[n][3]);
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.o);
  for (int p = lane; p < 16 * (D / 8); p += 32) {
    const int r = p / (D / 8), c = p % (D / 8);
    if (r0 + r >= S) continue;
    *reinterpret_cast<uint4*>(out + (((long long)b * S + r0 + r) * H + h) * D + c * 8) =
        *reinterpret_cast<const uint4*>(os + r * kRow + c * 16);
  }
}

// ---------------------------------------------------------------------------
// bf16, S > 128: two sweeps on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t mma_smem_bytes() {
  return 4 * ((size_t)(kBK + kBQ) * kRowWords<D> + (size_t)D * kVtWords);
}

// Fragment layout (PTX m16n8k16): lane 4g + t holds, of a 16×8 f32
// accumulator, rows g and g + 8 at columns 2t, 2t + 1.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) packed_attn_bf16(const PackedArgs a) {
  constexpr int kKSteps = D / 16;
  constexpr int kNTiles = D / 8;
  extern __shared__ __align__(16) uint32_t mma_smem[];
  uint32_t* ks = mma_smem;                   // kBK × kRowWords: K rows
  uint32_t* qs = ks + kBK * kRowWords<D>;    // kBQ × kRowWords: Q rows
  uint32_t* vts = qs + kBQ * kRowWords<D>;   // D × kVtWords: V^T rows

  const int S = a.S, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int len = max(0, min(a.lengths[b], S));
  const int n_blocks = (len + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;

  stage_rows<D>(qb, a.qss, q0, S, qs);
  __syncthreads();
  uint32_t qa[kKSteps][4];
  load_a_frags<D>(qs, warp * 16, g, t, qa);

  // sweep 1: the row max m and the sum l of exp(s - m) over the valid keys
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * kBK;
    __syncthreads();   // the previous K tile is consumed
    stage_rows<D>(kb, a.kss, k0, S, ks);
    __syncthreads();
    float sc[kBK / 8][4];
    scores_16x64<D>(qa, ks, g, t, sc);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        sc[j][e] = key < len ? sc[j][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] += sc[j][e] == kNegInf ? 0.f : expf(sc[j][e] - m[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
  }
  const float ld[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};

  // sweep 2: p = exp(s - m) / l, rounded to bf16, times V
  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * kBK;
    __syncthreads();   // the previous tiles are consumed
    stage_rows<D>(kb, a.kss, k0, S, ks);
    stage_vt<D>(vb, a.vss, k0, S, vts);
    __syncthreads();
    float sc[kBK / 8][4];
    scores_16x64<D>(qa, ks, g, t, sc);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        sc[j][e] = key < len ? expf(sc[j][e] * a.scale - m[r]) / ld[r] : 0.f;
      }
    accumulate_pv<D>(sc, vts, g, t, o);
  }

  bf16* out = static_cast<bf16*>(a.o);
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* orow = out + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;     // 16 × 16 threads: 4 rows × 4 keys each
constexpr int kLdt = kBQ + 4;        // stride of a transposed tile (floats)

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * (size_t)D * kLdt + (size_t)kBK * D + (size_t)kBK * kLdt);
}

// 64 rows of one (b, h) slice as f32, transposed (dst[d * kLdt + r]) or
// row-major (dst[r * D + d]); rows >= S read as zeros.
template <int D, bool kTransposed>
__device__ __forceinline__ void stage_f32(const float* __restrict__ base, long long ss, int row0,
                                          int S, float* dst) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kF32Threads) {
    const int r = kTransposed ? idx % kBK : idx / kChunks;
    const int c = kTransposed ? idx / kBK : idx % kChunks;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load16(base + (long long)(row0 + r) * ss + c * 4, vals);
    if constexpr (kTransposed) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(c * 4 + e) * kLdt + r] = vals[e];
    } else {
      *reinterpret_cast<float4*>(dst + r * D + c * 4) =
          make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] = <q row 4ty + i, k row 4tx + j> (unscaled), both staged transposed.
template <int D>
__device__ __forceinline__ void dot_4x4(const float* qt, const float* kt, int ty, int tx,
                                        float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 qa = *reinterpret_cast<const float4*>(qt + d * kLdt + ty * 4);
    const float4 ka = *reinterpret_cast<const float4*>(kt + d * kLdt + tx * 4);
    const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
    const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) packed_attn_f32(const PackedArgs a) {
  constexpr int kCpt = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float f32_smem[];
  float* qt = f32_smem;        // D × kLdt:   qt[d * kLdt + row]
  float* kt = qt + D * kLdt;   // D × kLdt:   kt[d * kLdt + key]
  float* vs = kt + D * kLdt;   // kBK × D:    vs[key * D + d]
  float* pt = vs + kBK * D;    // kBK × kLdt: pt[key * kLdt + row]

  const int S = a.S, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int len = max(0, min(a.lengths[b], S));
  const int n_blocks = (len + kBK - 1) / kBK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;

  stage_f32<D, true>(qb, a.qss, q0, S, qt);

  // sweep 1: the row max m and the sum l of exp(s - m) over the valid keys
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * kBK;
    __syncthreads();   // the previous K tile is consumed (and qt is staged)
    stage_f32<D, true>(kb, a.kss, k0, S, kt);
    __syncthreads();
    float s[4][4];
    dot_4x4<D>(qt, kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx * 4 + j < len ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += s[i][j] == kNegInf ? 0.f : expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(rs);
      m[i] = m_new;
    }
  }

  // sweep 2: p = exp(s - m) / l times V
  float acc[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * kBK;
    __syncthreads();   // the previous tiles are consumed
    stage_f32<D, true>(kb, a.kss, k0, S, kt);
    stage_f32<D, false>(vb, a.vss, k0, S, vs);
    __syncthreads();
    float s[4][4];
    dot_4x4<D>(qt, kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = k0 + tx * 4 + j < len ? expf(s[i][j] * a.scale - m[i]) / li : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLdt + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + kk * kLdt + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vrow = vs + kk * D + tx * kCpt;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) acc[i][c] = fmaf(pv[i], vrow[c], acc[i][c]);
    }
  }

  float* out = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    float* orow = out + (((long long)b * S + row) * H + h) * D + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) orow[c] = acc[i][c];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, const PackedArgs& a,
                   cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The one choice of kernel: bf16 rows of at most kOneSweepMaxS tokens take
// the one-sweep kernel, all others the two-sweep kernels.
bool one_sweep(int S, bool bf16) { return bf16 && S <= kOneSweepMaxS; }

template <int D>
cudaError_t launch_dtype(const PackedArgs& a, bool bf16, cudaStream_t st) {
  if (one_sweep(a.S, bf16))   // a CTA of round_up(S, 16) / 16 warps a (b, h)
    return launch(packed_attn_bf16_one_sweep<D>, dim3(a.B * a.H), (a.S + 15) / 16 * 32,
                  one_sweep_smem_bytes<D>(a.S), a, st);
  const dim3 grid(a.B * a.H, (a.S + kBQ - 1) / kBQ);   // a CTA a (b·h, q-block)
  if (bf16) return launch(packed_attn_bf16<D>, grid, kMmaThreads, mma_smem_bytes<D>(), a, st);
  return launch(packed_attn_f32<D>, grid, kF32Threads, f32_smem_bytes<D>(), a, st);
}

}  // namespace

// q, k, v: (B, S, H, D) views with strides (batch, token, head) in elements
// and the last dim contiguous; out: (B, S, H, D) contiguous; lengths: (B,)
// int32. D ∈ {32, 64, 128}.
extern "C" int ts_packed_attention(const void* q, const void* k, const void* v, void* out,
                                   const int* lengths, int is_bf16, int B, int S, int H, int D,
                                   long long qsb, long long qss, long long qsh, long long ksb,
                                   long long kss, long long ksh, long long vsb, long long vss,
                                   long long vsh, float scale, void* stream) {
  PackedArgs a;
  a.q = q; a.k = k; a.v = v; a.o = out; a.lengths = lengths;
  a.B = B; a.S = S; a.H = H;
  a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.scale = scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dtype<32>(a, is_bf16 != 0, st);
    case 64: return (int)launch_dtype<64>(a, is_bf16 != 0, st);
    case 128: return (int)launch_dtype<128>(a, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1 where ts_packed_attention with these arguments runs the one-sweep
// kernel, 0 where it runs a two-sweep kernel: the launcher's own choice.
extern "C" int ts_packed_attention_one_sweep(int is_bf16, int S) {
  return one_sweep(S, is_bf16 != 0) ? 1 : 0;
}
