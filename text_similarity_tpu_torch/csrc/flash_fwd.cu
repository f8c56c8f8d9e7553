// Flash attention forward (kernel K5): exact softmax attention over
// per-sequence key lengths, with an optional band |i - j| <= window and an
// optional global CLS row and column, and the optional log-sum-exp.
//
// Replaces text_similarity_tpu/ops/attention.py _flash_forward →
// _flash_kernel (the pallas_call sites :253 without and :272 with the lse
// residual). For batch b, head h and query row i:
//   s_ij = <q_i, k_j> · D^-1/2 with the operands in the input dtype and f32
//   sums over the kept keys (flash_common.cuh: j < len[b], and with
//   window > 0 the band plus, with global_cls, the CLS row and column); an
//   online softmax in f32 in which other pairs have p = 0; p rounded to the
//   input dtype before P·V, f32 sums; o_i = acc / l, and 0 where l == 0 (a
//   row with no kept key: zero-length rows); lse_i = m + log l, and 0 where
//   l == 0. The Pallas kernel gives a padded row that meets no kept key in
//   its visited blocks the mean of those blocks' V rows instead (its masked
//   scores are finite); no valid row differs.
//
// Bound on the H100: at the serving shape (B 8, S 4096, H 12, D 64, bf16,
// window 256 with global CLS) the kernel must move about 0.2 GB (q, k, v
// read once, o written once) and do about 50 GFLOP (4·D per (q, k) pair in
// the band): bound by bytes, about 0.06 ms. At window 0 and full length it
// is bound by operations: about 412 GFLOP, 0.42 ms at the bf16 tensor-core
// rate. Besides the products every score costs an FMA, an exp2 on the
// special-function units (16 a clock an SM: at D 64 as long as the score's
// 2·D multiply-adds take on the tensor cores), a max, an add and half a
// bf16 pack, so the softmax has to run beside the tensor cores, not after
// them. PERF.md §6 has the measured times (tools/flash_ab.py).
//
// Design. The TPU grid walks the key blocks of one q-block in order and
// carries (m, l, acc) in VMEM. Here one CTA owns one (b·h, 128-row q-tile)
// and loops over its key blocks itself, with m, l and the output
// accumulator in registers. It visits only the key blocks that meet the
// band and lie below ceil(len / Bk), plus key block 0 (the CLS column)
// and, for the tile that holds row 0, every valid key block: at window
// 256 it reads O(S·w) keys, not O(S²). Padding query rows (i >= len) are
// computed like valid ones; the backward (K6) reads their lse. q, k and v
// are read through (batch, token, head) strides with the last dim
// contiguous, so the encoder hands over views of its fused QKV without
// copies. The grid is 1-D and head-major (flash_common.cuh cta_tile): the
// CTAs on the card at once share a few heads' K and V through L2 (about
// 15% off window 0, PERF.md §6); with the global CLS the tiles of row 0,
// the longest, get the lowest CTA ids and start first.
//  * bf16 (the serving path): warp-specialised, 288 threads. One producer
//    warp issues TMA loads (hopper.cuh: 4-D tensor maps over (D, H, S, B),
//    zeros past S) of the Q tile once and of K and V into a ring of
//    kStages stages of Bk keys (128 at D <= 64, 64 at D 128), each stage
//    guarded by a full and an empty mbarrier. Two consumer warpgroups own
//    64 query rows each and share every K/V stage, so a tile of K and V
//    feeds 128 rows: S = Q·Kᵀ is one wgmma SS chain (Q and K K-major, as
//    they lie in memory); the online softmax runs on the accumulator
//    fragments with exp2 and scale·log2 e folded into one FMA, and only a
//    block that crosses len or leaves the band runs kept(); P, rounded to
//    bf16 in registers, is the A operand of a wgmma RS chain against V as
//    an MN-major B, so nothing is transposed or staged by threads. While
//    one warpgroup runs its softmax the other's products keep the tensor
//    cores busy. (Overlapping a warpgroup's own softmax with its P·V, as
//    K6 does, and exp2 on the FMA pipe for half the scores were both
//    slower here: PERF.md §6.)
//  * f32 (exact, no TF32): 256 threads on the CUDA cores, 64-row blocks.
//    Q and K are staged transposed as f32 (a float4 holds 4 rows of one
//    dim), V row-major, P transposed; thread (ty, tx) scores rows
//    4ty..4ty+3 against keys 4tx..4tx+3 and accumulates output columns
//    tx·D/16 .. of the same rows.
#include "flash_common.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                           // warpgroups of 64 query rows
constexpr int kTileRows = 64 * kConsumers;              // query rows a CTA
constexpr int kHopperThreads = 128 * kConsumers + 32;   // and one producer warp
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int fwd_keys() { return D <= 64 ? 128 : 64; }   // Bk

struct __align__(64) FwdMaps {
  CUtensorMap q, k, v;
};

template <int D>
constexpr size_t fwd_smem_bytes() {   // Q; K and V stages; barriers; alignment slack
  return 2 * (size_t)D * (kTileRows + 2 * kStages * fwd_keys<D>()) + 8 * (1 + 2 * kStages) + 1024;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_bf16(const __grid_constant__ FwdMaps maps, const FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = fwd_keys<D>();
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(align_1024(fwd_smem));
  bf16* ks = qs + kTileRows * D;       // kStages tiles of BK × D
  bf16* vs = ks + kStages * BK * D;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * BK * D);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int S = a.S, H = a.H;
  const int window = a.window;
  const bool global_cls = a.global_cls != 0;
  int bh, tile;
  cta_tile((S + kTileRows - 1) / kTileRows, (int)gridDim.x / ((S + kTileRows - 1) / kTileRows),
           global_cls, bh, tile);
  const int b = bh / H, h = bh % H;
  const int q0 = tile * kTileRows;
  const int len = min(a.lengths[b], S);
  const Blocks blocks = key_blocks<kTileRows, BK>(q0, len, window, global_cls);
  const int n_it = max(blocks.hi - blocks.first, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * kConsumers);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {   // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kTileRows * D * 2);
      tma_rows<D>(qs, &maps.q, q_full, kTileRows, q0, h, b);
      for (int i = 0; i < n_it; ++i) {
        const int st = i % kStages, it = blocks.first + i;
        const int k0 = (it < blocks.lo ? 0 : it) * BK;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * BK * D * 2);
        tma_rows<D>(ks + st * BK * D, &maps.k, &full[st], BK, k0, h, b);
        tma_rows<D>(vs + st * BK * D, &maps.v, &full[st], BK, k0, h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wq0 .. wq0 + 63; this thread's rows row0
  // and row0 + 8, columns 8j + 2t, 8j + 2t + 1 of every accumulator
  const int wg = warp / 4;
  const int wq0 = q0 + 64 * wg;
  const int row0 = wq0 + (warp % 4) * 16 + lane / 4, t = lane % 4;
  const float c = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_it; ++i) {
    const int st = i % kStages, it = blocks.first + i;
    const int k0 = (it < blocks.lo ? 0 : it) * BK;
    const bf16* kt = ks + st * BK * D;
    const bf16* vt = vs + st * BK * D;
    mbar_wait(&full[st], (i / kStages) & 1);

    wgmma_fence();   // S = Q·Kᵀ
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK, 0>(s, desc_k_major<D>(qs, kTileRows, 64 * wg, kk),
                      desc_k_major<D>(kt, BK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (needs_mask(wq0, 64, k0, BK, len, window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8, key = k0 + 8 * j + 2 * t + (e & 1);
          if (!kept(row, key, len, window, global_cls)) s[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;   // no kept key yet: p = 0
      alpha[r] = fast_exp2(m[r] * c - base[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], c, -base[r]));
        l[r] += s[4 * j + e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= alpha[0]; o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1]; o[4 * n + 3] *= alpha[1];
    }

    uint32_t pa[BK / 16][4];   // P rounded to bf16: the A operand, read asynchronously
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(s, kk, pa[kk]);
    wgmma_fence();   // O += P·V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D, 1>(o, pa[kk], desc_mn_major<D>(vt, BK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  bf16* out = static_cast<bf16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lr = quad_sum(l[r]);
    if (row >= S) continue;
    const float li = lr == 0.f ? 1.f : lr;
    bf16* orow = out + (((long long)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] / li, o[4 * n + 2 * r + 1] / li);
    if (a.lse != nullptr && t == 0)
      a.lse[(long long)bh * S + row] = lr > 0.f ? m[r] * a.scale + logf(lr) : 0.f;
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

  const Blocks blocks = key_blocks<kBQ, kBK>(q0, len, window, global_cls);
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
        s[i][j] = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - m_new);
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
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_bf16(const FlashArgs& a, int B, cudaStream_t st) {
  FwdMaps maps;
  cudaError_t err = rows_map(&maps.q, a.q, B, a.S, a.H, D, a.qsb, a.qss, a.qsh, kTileRows);
  if (err == cudaSuccess)
    err = rows_map(&maps.k, a.k, B, a.S, a.H, D, a.ksb, a.kss, a.ksh, fwd_keys<D>());
  if (err == cudaSuccess)
    err = rows_map(&maps.v, a.v, B, a.S, a.H, D, a.vsb, a.vss, a.vsh, fwd_keys<D>());
  if (err == cudaSuccess) err = set_smem(flash_fwd_bf16<D>, fwd_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H * ((a.S + kTileRows - 1) / kTileRows));
  flash_fwd_bf16<D><<<grid, kHopperThreads, fwd_smem_bytes<D>(), st>>>(maps, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const FlashArgs& a, int B, cudaStream_t st) {
  cudaError_t err = set_smem(flash_fwd_f32<D>, f32_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  flash_fwd_f32<D><<<grid, kF32Threads, f32_smem_bytes<D>(), st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const FlashArgs& a, int B, bool bf16, cudaStream_t st) {
  return bf16 ? launch_bf16<D>(a, B, st) : launch_f32<D>(a, B, st);
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
