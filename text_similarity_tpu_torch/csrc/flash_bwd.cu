// Flash attention backward (kernel K6): dq, and dk / dv, of exact softmax
// attention over per-sequence key lengths, with the optional band
// |i - j| <= window and global CLS row and column of the forward (K5).
//
// Replaces text_similarity_tpu/ops/attention.py _flash_backward →
// _flash_bwd_dq_kernel (the pallas_call at :469) and _flash_bwd_dkv_kernel
// (:498). For batch b, head h, query row i and key j, with the forward's
// lse_i and di_i = sum_d o_id · do_id (f32, taken by the caller):
//   s_ij = <q_i, k_j> · D^-1/2 (input-dtype operands, f32 sums);
//   p_ij = exp(s_ij - lse_i) on the kept pairs (flash_common.cuh), else 0;
//   dp_ij = <do_i, v_j> (f32 sums);  ds_ij = p_ij · (dp_ij - di_i);
//   dq_i = D^-1/2 · sum_j ds_ij k_j, with ds rounded to the input dtype;
//   dk_j = D^-1/2 · sum_i ds_ij q_i, with ds rounded to the input dtype;
//   dv_j = sum_i p_ij do_i, with p rounded to the input dtype;
// f32 sums, the scale applied once at the end, the outputs in the input
// dtype. Every query row takes part, padded rows (i >= len) included: their
// lse is the forward's, so a nonzero do there reaches dk and dv of valid
// keys, as in the Pallas kernels. A zero-length sequence keeps no pair and
// gets zero gradients.
//
// Bound on the H100: at the training shape (B 4, S 4096, H 12, D 64, bf16,
// window 256 with global CLS) the backward must read q, k, v, o, do (bf16)
// and lse (f32) once and write dq, dk, dv once: about 0.20 GB, 0.060 ms.
// Per kept pair it needs five products (q·kᵀ, do·vᵀ, ds·k, pᵀ·do, dsᵀ·q):
// 10·D operations, about 63 GFLOP at that shape, 0.064 ms on the bf16
// tensor cores, so operations bound it (chip_smoke.py computes the bound
// from its inputs). At window 0 it is about 515 GFLOP, 0.52 ms. The two
// kernels do 14·D a pair: dq and dk / dv each recompute q·kᵀ and do·vᵀ,
// the price of writing every gradient from one CTA without atomics.
//
// Design. The TPU grid walks the blocks of one CTA in order and carries
// the sums in VMEM; here a CTA loops over its blocks itself with the sums
// in registers, and nothing is shared between CTAs: no atomics, so dq, dk
// and dv are the same from run to run.
//  * dq: one CTA per (b·h, 64-row q-block) walks the key blocks K5 visits
//    (key_blocks: the band below ceil(len / 64), key block 0 for the CLS
//    column, every valid block for the q-block of row 0).
//  * dk / dv: one CTA per (b·h, 64-key block) walks the q-blocks whose rows
//    meet the band (query_blocks), plus q-block 0 (the CLS row) first, and
//    every q-block for key block 0 (the CLS column) or at window 0. A key
//    block at or past len writes zeros and reads nothing.
//  * bf16 (the training path): 4 warps on the tensor cores, mma.sync
//    m16n8k16 with bf16 operands and f32 accumulators, as K5. Each warp owns
//    16 rows (dq) or 16 keys (dk / dv). The recomputed score tiles become,
//    in registers, the A fragments of the next product (ds·K, pᵀ·dO,
//    dsᵀ·Q, rounded to bf16 there); the B operands of those products are
//    staged transposed. This version stages each block before its products
//    start (no copy pipeline), like K5.
//  * f32 (exact, no TF32): 256 threads on the CUDA cores; thread (ty, tx)
//    computes a 4 × 4 tile of scores from rows staged row-major (padded by
//    16 bytes), stores p or ds through shared memory and accumulates 4
//    output rows × D/16 columns.
#include "flash_common.cuh"

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // do, (B, S, H, D) view
  const float* lse;     // (B, H, S)
  const float* di;      // (B, H, S)
  void* dq;             // (B, S, H, D) contiguous, the input dtype
  void* dk;
  void* dv;
  const int* lengths;   // (B,)
  int S, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  int window, global_cls;
  float scale;
};

// The q-blocks whose rows meet a kept pair of keys [k0, k0 + kBK) (all rows
// below S, padded rows included): every q-block at window 0 or for key
// block 0 with the global CLS; else the band's q-blocks, plus q-block 0
// (the CLS row) first with the global CLS.
__device__ __forceinline__ Blocks query_blocks(int k0, int S, int window, bool global_cls) {
  const int n_qb = (S + kBQ - 1) / kBQ;
  Blocks qb{0, 0, n_qb};
  if (window > 0 && !(global_cls && k0 == 0)) {
    qb.lo = max(k0 - window, 0) / kBQ;
    qb.hi = min((k0 + kBK - 1 + window) / kBQ + 1, n_qb);
    qb.first = global_cls && qb.lo > 0 ? qb.lo - 1 : qb.lo;
  }
  return qb;
}

__device__ __forceinline__ long long out_offset(int b, int row, int h, int S, int H, int D) {
  return (((long long)b * S + row) * H + h) * D;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {   // Q, dO, K, V rows; Kᵀ
  return 4 * (4 * (size_t)kBK * kRowWords<D> + (size_t)D * kVtWords);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO rows; Qᵀ, dOᵀ; lse, di
  return 4 * (4 * (size_t)kBK * kRowWords<D> + 2 * (size_t)D * kVtWords + 2 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_bf16(const BwdArgs a) {
  constexpr int kKSteps = D / 16, kNTiles = D / 8;
  extern __shared__ __align__(16) uint32_t bwd_smem[];
  uint32_t* qs = bwd_smem;
  uint32_t* dos = qs + kBQ * kRowWords<D>;
  uint32_t* ks = dos + kBQ * kRowWords<D>;
  uint32_t* vs = ks + kBK * kRowWords<D>;
  uint32_t* kts = vs + kBK * kRowWords<D>;

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
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.osb + h * a.osh;

  stage_rows<D>(qb, a.qss, q0, S, qs);
  stage_rows<D>(ob, a.oss, q0, S, dos);
  __syncthreads();
  uint32_t qa[kKSteps][4], da[kKSteps][4];
  load_a_frags<D>(qs, warp * 16, g, t, qa);
  load_a_frags<D>(dos, warp * 16, g, t, da);
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < S ? a.lse[(long long)bh * S + row] : 0.f;
    di_r[r] = row < S ? a.di[(long long)bh * S + row] : 0.f;
  }
  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const Blocks blocks = key_blocks(q0, len, window, global_cls);
  for (int it = blocks.first; it < blocks.hi; ++it) {
    const int k0 = (it < blocks.lo ? 0 : it) * kBK;
    __syncthreads();   // the previous tiles are consumed
    stage_rows<D>(kb, a.kss, k0, S, ks);
    stage_rows<D>(vb, a.vss, k0, S, vs);
    stage_vt<D>(kb, a.kss, k0, S, kts);
    __syncthreads();

    float sc[kBK / 8][4], dp[kBK / 8][4];
    scores_16x64<D>(qa, ks, g, t, sc);   // Q·Kᵀ
    scores_16x64<D>(da, vs, g, t, dp);   // dO·Vᵀ
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = row0 + r * 8, key = k0 + j * 8 + 2 * t + (e & 1);
        const float p =
            kept(row, key, len, window, global_cls) ? __expf(sc[j][e] * a.scale - lse_r[r]) : 0.f;
        sc[j][e] = p * (dp[j][e] - di_r[r]);   // ds
      }
    accumulate_pv<D>(sc, kts, g, t, acc);   // dq += ds·K
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* drow = dq + out_offset(b, row, h, S, H, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkv_bf16(const BwdArgs a) {
  constexpr int kKSteps = D / 16, kNTiles = D / 8;
  extern __shared__ __align__(16) uint32_t bwd_smem[];
  uint32_t* ks = bwd_smem;
  uint32_t* vs = ks + kBK * kRowWords<D>;
  uint32_t* qs = vs + kBK * kRowWords<D>;
  uint32_t* dos = qs + kBQ * kRowWords<D>;
  uint32_t* qts = dos + kBQ * kRowWords<D>;
  uint32_t* dots = qts + D * kVtWords;
  float* ls = reinterpret_cast<float*>(dots + D * kVtWords);   // lse of the q-block's rows
  float* dis = ls + kBQ;                                        // di of the q-block's rows

  const int S = a.S, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBK;
  const int len = min(a.lengths[b], S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0 and key0 + 8
  const int window = a.window;
  const bool global_cls = a.global_cls != 0;
  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.osb + h * a.osh;

  float dk[kNTiles][4], dv[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (k0 < len) {   // CTA-uniform: a block of padded keys keeps no pair
    stage_rows<D>(kb, a.kss, k0, S, ks);
    stage_rows<D>(vb, a.vss, k0, S, vs);
    const Blocks blocks = query_blocks(k0, S, window, global_cls);
    for (int it = blocks.first; it < blocks.hi; ++it) {
      const int q0 = (it < blocks.lo ? 0 : it) * kBQ;
      __syncthreads();   // the previous tiles are consumed (and K, V are staged)
      stage_rows<D>(qb, a.qss, q0, S, qs);
      stage_rows<D>(ob, a.oss, q0, S, dos);
      stage_vt<D>(qb, a.qss, q0, S, qts);
      stage_vt<D>(ob, a.oss, q0, S, dots);
      for (int r = threadIdx.x; r < kBQ; r += kMmaThreads) {
        const bool in = q0 + r < S;
        ls[r] = in ? a.lse[(long long)bh * S + q0 + r] : 0.f;
        dis[r] = in ? a.di[(long long)bh * S + q0 + r] : 0.f;
      }
      __syncthreads();

      uint32_t fa[kKSteps][4];
      float st[kBQ / 8][4], dpt[kBQ / 8][4];
      load_a_frags<D>(ks, warp * 16, g, t, fa);
      scores_16x64<D>(fa, qs, g, t, st);    // K·Qᵀ = Sᵀ
      load_a_frags<D>(vs, warp * 16, g, t, fa);
      scores_16x64<D>(fa, dos, g, t, dpt);  // V·dOᵀ = dPᵀ
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e >> 1) * 8, r = j * 8 + 2 * t + (e & 1), row = q0 + r;
          const float p = row < S && kept(row, key, len, window, global_cls)
                              ? __expf(st[j][e] * a.scale - ls[r])
                              : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dis[r]);   // dsᵀ
        }
      accumulate_pv<D>(st, dots, g, t, dv);    // dv += pᵀ·dO
      accumulate_pv<D>(dpt, qts, g, t, dk);    // dk += dsᵀ·Q
    }
  }

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    const long long off = out_offset(b, key, h, S, H, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + n * 8) =
          __floats2bfloat162_rn(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + n * 8) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;   // 16 × 16 threads: 4 × 4 scores each
constexpr int kLdt = kBQ + 4;      // stride of a p / ds tile (floats)

template <int D>
constexpr int kLdr = D + 4;        // stride of a staged f32 row (floats)

template <int D>
constexpr size_t dq_f32_smem_bytes() {    // Q, dO, K, V rows; dsᵀ
  return sizeof(float) * (4 * (size_t)kBK * kLdr<D> + (size_t)kBK * kLdt);
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {   // K, V, Q, dO rows; p, ds; lse, di
  return sizeof(float) * (4 * (size_t)kBK * kLdr<D> + 2 * (size_t)kBQ * kLdt + 2 * kBQ);
}

// 64 rows of one (b, h) slice → dst row-major (kLdr floats a row); rows
// >= S read as zeros.
template <int D>
__device__ __forceinline__ void stage_rows_f32(const float* __restrict__ base, long long ss,
                                               int row0, int S, float* dst) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kF32Threads) {
    const int r = idx / kChunks, c = idx % kChunks;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      v = __ldg(reinterpret_cast<const float4*>(base + (long long)(row0 + r) * ss + c * 4));
    *reinterpret_cast<float4*>(dst + r * kLdr<D> + c * 4) = v;
  }
}

// s[i][j] = <A row 4ty + i, B row 4tx + j> over the D dims, in order.
template <int D>
__device__ __forceinline__ void dot_4x4(const float* A, const float* B, int ty, int tx,
                                        float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * kLdr<D> + d);
      bv[i] = *reinterpret_cast<const float4*>(B + (4 * tx + i) * kLdr<D> + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum_k w[k][4ty + i] · X[k][tx·D/16 + c] over the 64 staged
// rows k of X (w: kLdt floats a row).
template <int D>
__device__ __forceinline__ void accumulate_f32(const float* w, const float* X, int ty, int tx,
                                               float acc[4][D / 16]) {
  constexpr int kCpt = D / 16;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(w + k * kLdt + 4 * ty);
    const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
    const float* x = X + k * kLdr<D> + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) {
      const float xv = x[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(wk[i], xv, acc[i][c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32(const BwdArgs a) {
  constexpr int kCpt = D / 16;
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;
  float* dos = qs + kBQ * kLdr<D>;
  float* ks = dos + kBQ * kLdr<D>;
  float* vs = ks + kBK * kLdr<D>;
  float* dst = vs + kBK * kLdr<D>;   // dst[key * kLdt + row]

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
  const float* ob = static_cast<const float*>(a.dout) + b * a.osb + h * a.osh;

  stage_rows_f32<D>(qb, a.qss, q0, S, qs);
  stage_rows_f32<D>(ob, a.oss, q0, S, dos);
  float lse_r[4], di_r[4], acc[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < S ? a.lse[(long long)bh * S + row] : 0.f;
    di_r[i] = row < S ? a.di[(long long)bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.f;
  }

  const Blocks blocks = key_blocks(q0, len, window, global_cls);
  for (int it = blocks.first; it < blocks.hi; ++it) {
    const int k0 = (it < blocks.lo ? 0 : it) * kBK;
    __syncthreads();   // the previous tiles are consumed (and Q, dO are staged)
    stage_rows_f32<D>(kb, a.kss, k0, S, ks);
    stage_rows_f32<D>(vb, a.vss, k0, S, vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_4x4<D>(qs, ks, ty, tx, s);
    dot_4x4<D>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + 4 * ty + i, key = k0 + 4 * tx + j;
        const float p =
            kept(row, key, len, window, global_cls) ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - di_r[i]);   // ds
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (4 * tx + j) * kLdt + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    accumulate_f32<D>(dst, ks, ty, tx, acc);   // dq += ds·K
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    float* drow = dq + out_offset(b, row, h, S, H, D) + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) drow[c] = acc[i][c] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32(const BwdArgs a) {
  constexpr int kCpt = D / 16;
  extern __shared__ __align__(16) float f32_smem[];
  float* ks = f32_smem;
  float* vs = ks + kBK * kLdr<D>;
  float* qs = vs + kBK * kLdr<D>;
  float* dos = qs + kBQ * kLdr<D>;
  float* pt = dos + kBQ * kLdr<D>;   // pt[row * kLdt + key]
  float* dst = pt + kBQ * kLdt;      // dst[row * kLdt + key]
  float* ls = dst + kBQ * kLdt;
  float* dis = ls + kBQ;

  const int S = a.S, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBK;
  const int len = min(a.lengths[b], S);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;   // keys 4ty.., rows 4tx..
  const int window = a.window;
  const bool global_cls = a.global_cls != 0;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  const float* ob = static_cast<const float*>(a.dout) + b * a.osb + h * a.osh;

  float dk[4][kCpt], dv[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCpt; ++c) dk[i][c] = dv[i][c] = 0.f;

  if (k0 < len) {   // CTA-uniform: a block of padded keys keeps no pair
    stage_rows_f32<D>(kb, a.kss, k0, S, ks);
    stage_rows_f32<D>(vb, a.vss, k0, S, vs);
    const Blocks blocks = query_blocks(k0, S, window, global_cls);
    for (int it = blocks.first; it < blocks.hi; ++it) {
      const int q0 = (it < blocks.lo ? 0 : it) * kBQ;
      __syncthreads();   // the previous tiles are consumed (and K, V are staged)
      stage_rows_f32<D>(qb, a.qss, q0, S, qs);
      stage_rows_f32<D>(ob, a.oss, q0, S, dos);
      for (int r = tid; r < kBQ; r += kF32Threads) {
        const bool in = q0 + r < S;
        ls[r] = in ? a.lse[(long long)bh * S + q0 + r] : 0.f;
        dis[r] = in ? a.di[(long long)bh * S + q0 + r] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
      dot_4x4<D>(ks, qs, ty, tx, st);    // st[i][j]: key 4ty + i, row 4tx + j
      dot_4x4<D>(vs, dos, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * tx + j, row = q0 + r, key = k0 + 4 * ty + i;
          const float p = row < S && kept(row, key, len, window, global_cls)
                              ? expf(st[i][j] * a.scale - ls[r])
                              : 0.f;
          st[i][j] = p;
          dpt[i][j] = p * (dpt[i][j] - dis[r]);   // ds
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float4*>(pt + (4 * tx + j) * kLdt + 4 * ty) =
            make_float4(st[0][j], st[1][j], st[2][j], st[3][j]);
        *reinterpret_cast<float4*>(dst + (4 * tx + j) * kLdt + 4 * ty) =
            make_float4(dpt[0][j], dpt[1][j], dpt[2][j], dpt[3][j]);
      }
      __syncthreads();
      accumulate_f32<D>(pt, dos, ty, tx, dv);    // dv += pᵀ·dO
      accumulate_f32<D>(dst, qs, ty, tx, dk);    // dk += dsᵀ·Q
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= S) continue;
    const long long off = out_offset(b, key, h, S, H, D) + tx * kCpt;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) {
      dkp[off + c] = dk[i][c] * a.scale;
      dvp[off + c] = dv[i][c];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const BwdArgs& a, int B,
                   cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int B, bool bf16, cudaStream_t st) {
  if (bf16) return launch(flash_bwd_dq_bf16<D>, kMmaThreads, dq_smem_bytes<D>(), a, B, st);
  return launch(flash_bwd_dq_f32<D>, kF32Threads, dq_f32_smem_bytes<D>(), a, B, st);
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, bool bf16, cudaStream_t st) {
  if (bf16) return launch(flash_bwd_dkv_bf16<D>, kMmaThreads, dkv_smem_bytes<D>(), a, B, st);
  return launch(flash_bwd_dkv_f32<D>, kF32Threads, dkv_f32_smem_bytes<D>(), a, B, st);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* di, const int* lengths, int S, int H, const long long* strides,
                  int window, int global_cls, float scale) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.di = di; a.lengths = lengths;
  a.S = S; a.H = H;
  a.qsb = strides[0]; a.qss = strides[1]; a.qsh = strides[2];
  a.ksb = strides[3]; a.kss = strides[4]; a.ksh = strides[5];
  a.vsb = strides[6]; a.vss = strides[7]; a.vsh = strides[8];
  a.osb = strides[9]; a.oss = strides[10]; a.osh = strides[11];
  a.window = window; a.global_cls = global_cls; a.scale = scale;
  return a;
}

}  // namespace

// q, k, v, dout: (B, S, H, D) views with the last dim contiguous;
// strides: 12 values, the (batch, token, head) strides in elements of q, k,
// v and dout; lse, di: (B, H, S) f32; dq: (B, S, H, D) contiguous in the
// input dtype; lengths: (B,) int32. D ∈ {32, 64, 128}.
extern "C" int ts_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* di, void* dq, const int* lengths,
                               int is_bf16, int B, int S, int H, int D, const long long* strides,
                               int window, int global_cls, float scale, void* stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, di, lengths, S, H, strides, window, global_cls, scale);
  a.dq = dq;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dq<32>(a, B, is_bf16 != 0, st);
    case 64: return (int)launch_dq<64>(a, B, is_bf16 != 0, st);
    case 128: return (int)launch_dq<128>(a, B, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same inputs; dk, dv: (B, S, H, D) contiguous in the input dtype.
extern "C" int ts_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* di, void* dk, void* dv,
                                const int* lengths, int is_bf16, int B, int S, int H, int D,
                                const long long* strides, int window, int global_cls, float scale,
                                void* stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, di, lengths, S, H, strides, window, global_cls, scale);
  a.dk = dk;
  a.dv = dv;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dkv<32>(a, B, is_bf16 != 0, st);
    case 64: return (int)launch_dkv<64>(a, B, is_bf16 != 0, st);
    case 128: return (int)launch_dkv<128>(a, B, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
