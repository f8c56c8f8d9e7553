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
// so it is bound by bytes. This version computes q·kᵀ twice (below) and loads K
// twice, with no copy overlapping the math.
//
// Design. The TPU kernel folds 128 / D heads into its 128 lanes and masks
// the lanes per head; on the card the heads need no folding. One CTA owns
// one (b·h, 64-row q-block) and walks the key blocks of 64 below
// ceil(len / 64) twice: the first sweep keeps the running max and sum (m,
// l) of each row, the second recomputes the scores, forms p = exp(s − m) /
// l, rounds it and accumulates P·V in registers. q, k and v are read
// through (batch, token, head) strides with the last dim contiguous, so
// the encoder hands over views of its fused QKV without copies.
//  * bf16: 4 warps on the tensor cores, mma.sync m16n8k16 with bf16
//    operands and f32 accumulators (flash_common.cuh, as in K5); each warp
//    owns 16 query rows and turns its score accumulators into the A
//    fragments of P·V.
//  * f32 (exact, no TF32): 256 threads on the CUDA cores; thread (ty, tx)
//    scores rows 4ty..4ty+3 against keys 4tx..4tx+3 and accumulates output
//    columns tx·D/16 .. of the same rows.
#include "flash_common.cuh"

namespace {

struct PackedArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;              // (B, S, H, D) contiguous, q's dtype
  const int* lengths;   // (B,)
  int S, H;
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
// bf16: tensor cores
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
cudaError_t launch(Kernel kernel, int threads, size_t smem, const PackedArgs& a, int B,
                   cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const PackedArgs& a, int B, bool bf16, cudaStream_t st) {
  if (bf16) return launch(packed_attn_bf16<D>, kMmaThreads, mma_smem_bytes<D>(), a, B, st);
  return launch(packed_attn_f32<D>, kF32Threads, f32_smem_bytes<D>(), a, B, st);
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
  a.S = S; a.H = H;
  a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.scale = scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dtype<32>(a, B, is_bf16 != 0, st);
    case 64: return (int)launch_dtype<64>(a, B, is_bf16 != 0, st);
    case 128: return (int)launch_dtype<128>(a, B, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
