// Flash attention forward (kernel K5): exact softmax attention over
// per-sequence key lengths, with an optional band |i - j| <= window and an
// optional global CLS row and column, and the optional log-sum-exp.
//
// Replaces text_similarity_tpu/ops/attention.py _flash_forward →
// _flash_kernel (the pallas_call sites :253 without and :272 with the lse
// residual). For batch b, head h and query row i:
//   s_ij = <q_i, k_j> · D^-1/2 with the operands in the input dtype and f32
//   sums; keys j >= len[b] and, with window > 0, keys outside the band
//   (unless global_cls and i == 0 or j == 0) get -1e9; an online softmax in
//   f32 over the visited key blocks; p rounded to the input dtype before
//   P·V, f32 sums; o_i = acc / l, and 0 where l == 0 (zero-length rows);
//   lse_i = m + log l, and 0 where l == 0.
//
// Bound on the H100: at the serving shape (B 8, S 4096, H 12, D 64, bf16,
// window 256 with global CLS) the kernel must move about 0.2 GB (q, k, v
// read once, o written once) and do about 50 GFLOP (4·D per (q, k) pair in
// the band): at the bf16 tensor-core rate that is bound by bytes (about
// 0.06 ms); at window 0 and full length, by operations (about 412 GFLOP,
// 0.42 ms). This version stays about ten times above both bounds
// (PERF.md): each key block's tiles are loaded and staged before any
// product starts (no copy pipeline), mma.sync issues below wgmma's rate,
// and every score costs an exp on the special-function units.
//
// Design. The TPU grid walks the key blocks of one q-block in order and
// carries (m, l, acc) in VMEM. Here one CTA owns one (b·h, 64-row q-block)
// and loops over its key blocks of 64 itself, with m, l and the output
// accumulator in registers. It visits only the key blocks that meet the
// band and lie below ceil(len / 64), plus key block 0 (the CLS column)
// and, for the q-block that holds row 0, every valid key block: at window
// 256 it reads O(S·w) keys, not O(S²). Padding query rows (i >= len) get
// whatever their visited blocks give; nothing reads them. q, k and v are
// read through (batch, token, head) strides with the last dim contiguous,
// so the encoder hands over views of its fused QKV without copies. The
// q-blocks of row 0, the longest with global CLS, get the lowest CTA ids
// and start first.
//  * bf16 (the serving path): 4 warps on the tensor cores, mma.sync
//    m16n8k16 with bf16 operands and f32 accumulators; each warp owns 16
//    query rows, keeps its Q fragments in registers and turns its score
//    accumulators into the A fragments of P·V (rounded to bf16) without
//    going through shared memory. K is staged row-major and V transposed,
//    as bf16 with rows padded by 16 bytes so fragment loads hit distinct
//    banks.
//  * f32 (exact, no TF32): 256 threads on the CUDA cores. Q and K are
//    staged transposed as f32 (a float4 holds 4 rows of one dim), V
//    row-major, P transposed; thread (ty, tx) scores rows 4ty..4ty+3
//    against keys 4tx..4tx+3 and accumulates output columns tx·D/16 .. of
//    the same rows.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 64;              // keys per block
constexpr float kNegInf = -1e9f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;              // (B, S, H, D) contiguous, q's dtype
  float* lse;           // (B, H, S) or nullptr
  const int* lengths;   // (B,)
  int S, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int window, global_cls;
  float scale;
};

// The key blocks a q-block visits (the Pallas kernel's lo / hi): blocks
// it in [first, hi), block 0 standing in for it < lo (the CLS column).
struct KeyBlocks {
  int first, lo, hi;
};

__device__ __forceinline__ KeyBlocks key_blocks(int q0, int len, int window, bool global_cls) {
  const int n_valid = (len + kBK - 1) / kBK;
  KeyBlocks kb{0, 0, n_valid};
  if (window > 0) {
    kb.lo = max(q0 - window, 0) / kBK;
    kb.hi = min((q0 + kBQ - 1 + window) / kBK + 1, n_valid);
    kb.first = kb.lo;
    if (global_cls) {
      if (q0 == 0) kb.hi = n_valid;                        // the CLS row sees every key
      if (kb.lo > 0 && kb.lo - 1 < kb.hi) kb.first = kb.lo - 1;   // visit block 0 first
    }
  }
  return kb;
}

__device__ __forceinline__ bool kept(int row, int key, int len, int window, bool global_cls) {
  bool keep = key < len;
  if (window > 0)
    keep = keep && (abs(row - key) <= window || (global_cls && (row == 0 || key == 0)));
  return keep;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = (kBQ / 16) * 32;   // one warp per 16 query rows

template <int D>
constexpr int kRowWords = D / 2 + 4;           // 32-bit words per staged K or Q row
constexpr int kVtWords = kBK / 2 + 4;          // 32-bit words per staged V^T row

template <int D>
constexpr size_t mma_smem_bytes() {
  return 4 * ((size_t)(kBK + kBQ) * kRowWords<D> + (size_t)D * kVtWords);
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows of one (b, h) slice (token stride ss) → dst row-major, kRowWords
// words a row; rows >= S read as zeros.
template <int D>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ base, long long ss,
                                           int row0, int S, uint32_t* dst) {
  constexpr int kChunks = D / 8;   // 16 bytes each
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      v = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * ss + c * 8));
    *reinterpret_cast<uint4*>(dst + r * kRowWords<D> + c * 4) = v;
  }
}

// 64 rows of V → dst transposed (dim-major, kVtWords words a dim row).
template <int D>
__device__ __forceinline__ void stage_vt(const __nv_bfloat16* __restrict__ base, long long ss,
                                         int row0, int S, uint32_t* dst) {
  constexpr int kChunks = D / 8;
  __nv_bfloat16* dh = reinterpret_cast<__nv_bfloat16*>(dst);
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kMmaThreads) {
    const int r = idx % kBK, c = idx / kBK;   // neighbouring threads: neighbouring keys
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      v = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * ss + c * 8));
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) dh[(c * 8 + e) * (2 * kVtWords) + r] = hv[e];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layout (PTX m16n8k16): lane = 4g + t holds, of a 16×8 f32
// accumulator, rows g and g + 8 at columns 2t, 2t + 1 (c[0..1] and
// c[2..3]); of the 16×16 A tile, rows g and g + 8 at k = 2t.. and 2t + 8..;
// of the 16×8 B tile, column g at k = 2t.. and 2t + 8.. .
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16(const FlashArgs a) {
  constexpr int kRW = kRowWords<D>;
  constexpr int kKSteps = D / 16;   // k-steps of the score product
  constexpr int kNTiles = D / 8;    // 8-column tiles of the output
  extern __shared__ __align__(16) uint32_t mma_smem[];
  uint32_t* ks = mma_smem;          // kBK × kRW: K rows (bf16 pairs)
  uint32_t* qs = ks + kBK * kRW;    // kBQ × kRW: Q rows, read once into registers
  uint32_t* vts = qs + kBQ * kRW;   // D × kVtWords: V^T rows

  const int S = a.S, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int len = min(a.lengths[b], S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0 and row0 + 8
  const int window = a.window;
  const bool global_cls = a.global_cls != 0;
  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;

  stage_rows<D>(qb, a.qss, q0, S, qs);
  __syncthreads();
  uint32_t qa[kKSteps][4];
  const uint32_t* qw = qs + (warp * 16 + g) * kRW;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    qa[kk][0] = qw[kk * 8 + t];
    qa[kk][1] = qw[8 * kRW + kk * 8 + t];
    qa[kk][2] = qw[kk * 8 + 4 + t];
    qa[kk][3] = qw[8 * kRW + kk * 8 + 4 + t];
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const KeyBlocks blocks = key_blocks(q0, len, window, global_cls);
  for (int it = blocks.first; it < blocks.hi; ++it) {
    const int k0 = (it < blocks.lo ? 0 : it) * kBK;
    __syncthreads();   // the previous tiles are consumed
    stage_rows<D>(kb, a.kss, k0, S, ks);
    stage_vt<D>(vb, a.vss, k0, S, vts);
    __syncthreads();

    float sc[kBK / 8][4];   // scores: 8 tiles of 8 keys
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const uint32_t* kw = ks + (j * 8 + g) * kRW;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) mma_16816(sc[j], qa[kk], kw[kk * 8 + t], kw[kk * 8 + 4 + t]);
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8, key = k0 + j * 8 + 2 * t + (e & 1);
        sc[j][e] = kept(row, key, len, window, global_cls) ? sc[j][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = __expf(sc[j][e] - m[e >> 1]);
        rs[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // P·V: the score tiles of keys 16kk.. and 16kk + 8.. are the A
    // fragment of k-step kk, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const uint32_t* vw = vts + (n * 8 + g) * kVtWords;
        mma_16816(o[n], pa, vw[kk * 8 + t], vw[kk * 8 + 4 + t]);
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float li = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = out + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] / li, o[n][2 * r + 1] / li);
    if (a.lse != nullptr && t == 0)
      a.lse[(long long)bh * S + row] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
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
    // transposed: neighbouring threads take neighbouring rows (conflict-free
    // smem stores); row-major: neighbouring chunks of one row
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

// N consecutive floats of shared memory (N = 2, 4 or 8; 8-byte aligned
// for 2, 16-byte aligned otherwise).
template <int N>
__device__ __forceinline__ void load_smem(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      out[e] = v.x; out[e + 1] = v.y; out[e + 2] = v.z; out[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + e);
      out[e] = v.x; out[e + 1] = v.y;
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

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(const FlashArgs a) {
  constexpr int kCpt = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float f32_smem[];
  float* qt = f32_smem;        // D × kLdt:   qt[d * kLdt + row]
  float* kt = qt + D * kLdt;   // D × kLdt:   kt[d * kLdt + key]
  float* vs = kt + D * kLdt;   // kBK × D:    vs[key * D + d]
  float* pt = vs + kBK * D;    // kBK × kLdt: pt[key * kLdt + row]

  const int S = a.S, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int len = min(a.lengths[b], S);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int window = a.window;
  const bool global_cls = a.global_cls != 0;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;

  stage_f32<D, true>(qb, a.qss, q0, S, qt);

  float m[4], l[4], acc[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.f;
  }

  const KeyBlocks blocks = key_blocks(q0, len, window, global_cls);
  for (int it = blocks.first; it < blocks.hi; ++it) {
    const int k0 = (it < blocks.lo ? 0 : it) * kBK;
    __syncthreads();   // the previous tiles are consumed (and qt is staged)
    stage_f32<D, true>(kb, a.kss, k0, S, kt);
    stage_f32<D, false>(vb, a.vss, k0, S, vs);
    __syncthreads();

    float s[4][4];
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        s[i][j] = kept(row, key, len, window, global_cls) ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) acc[i][c] *= alpha;
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
      float vv[kCpt];
      load_smem<kCpt>(vs + kk * D + tx * kCpt, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCpt; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* out = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    float* orow = out + (((long long)b * S + row) * H + h) * D + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) orow[c] = acc[i][c] / li;
    if (a.lse != nullptr && tx == 0)
      a.lse[(long long)bh * S + row] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const FlashArgs& a, int B,
                   cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const FlashArgs& a, int B, bool bf16, cudaStream_t st) {
  if (bf16) return launch(flash_fwd_bf16<D>, kMmaThreads, mma_smem_bytes<D>(), a, B, st);
  return launch(flash_fwd_f32<D>, kF32Threads, f32_smem_bytes<D>(), a, B, st);
}

}  // namespace

// q, k, v: (B, S, H, D) views with strides (batch, token, head) in elements
// and the last dim contiguous; out: (B, S, H, D) contiguous; lse: (B, H, S)
// f32 or NULL; lengths: (B,) int32. D ∈ {32, 64, 128}.
extern "C" int ts_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                            const int* lengths, int is_bf16, int B, int S, int H, int D,
                            long long qsb, long long qss, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb, long long vss,
                            long long vsh, int window, int global_cls, float scale,
                            void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = out; a.lse = lse; a.lengths = lengths;
  a.S = S; a.H = H;
  a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.window = window; a.global_cls = global_cls; a.scale = scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dtype<32>(a, B, is_bf16 != 0, st);
    case 64: return (int)launch_dtype<64>(a, B, is_bf16 != 0, st);
    case 128: return (int)launch_dtype<128>(a, B, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
