// Flash attention backward (kernel K6): dq, and dk / dv, of exact softmax
// attention over per-sequence key lengths, with the optional band
// |i - j| <= window and global CLS row and column of the forward (K5).
//
// Replaces text_similarity_tpu/ops/attention.py _flash_backward →
// _flash_bwd_dq_kernel (the pallas_call at :469) and _flash_bwd_dkv_kernel
// (:498), and the di reduction the reference leaves to XLA. For batch b,
// head h, query row i and key j, with the forward's lse_i:
//   di_i = sum_d o_id · do_id (f32);
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
// the price of writing every gradient from one CTA without atomics, so
// dq, dk and dv are the same bits from run to run. (Accumulating dq with
// f32 atomics from the dk/dv kernel would save the recompute but make the
// sums' order, and so the bits, change from run to run.) Each score also
// costs an exp2 on the special-function units in each kernel. PERF.md §6
// has the measured times (tools/flash_ab.py).
//
// Design. The TPU grid walks the blocks of one CTA in order and carries
// the sums in VMEM; here a CTA loops over its blocks itself with the sums
// in registers, and nothing is shared between CTAs. The grid is 1-D and
// head-major, as K5's (cta_tile).
//  * dq: one CTA per (b·h, 128-row q-tile) walks the key blocks K5 visits
//    (key_blocks: the band below ceil(len / 64), key block 0 for the CLS
//    column, every valid block for the tile of row 0). Its prologue takes
//    di of its rows from o and do and writes it, (B, H, S) f32, for the
//    dk / dv kernel, which runs after it on the stream.
//  * dk / dv: one CTA per (b·h, 128-key block) walks the q-blocks whose
//    rows meet the band (query_blocks), plus q-block 0 (the CLS row) first,
//    and every q-block for the block of key 0 (the CLS column) or at window
//    0. A key block at or past len writes zeros and reads nothing.
//  * bf16 (the training path): warp-specialised, 384 threads: a producer
//    warpgroup, which gives its registers to the two consumer warpgroups
//    (setmaxnreg: 40 and 232 a thread), and whose first warp loads with TMA
//    (hopper.cuh) what a CTA keeps (Q and dO for dq; K and V for dk / dv)
//    once, and what it walks (K and V blocks of 64 keys; Q and dO blocks of
//    64 rows, 32 at D 128, with their lse and di) into a ring of kStages
//    stages under full and empty mbarriers. The consumer warpgroups own 64
//    rows (dq) or 64 keys (dk / dv) each. The score products S = Q·Kᵀ and
//    dP = dO·Vᵀ (dq), Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dk / dv) are wgmma SS
//    chains with both operands K-major, as they lie in memory. p, ds (and
//    their transposes) are formed on the accumulator fragments, with exp2
//    and one FMA a score, kept() only in blocks that cross len, S or the band,
//    then rounded to bf16 in registers as the A operand of wgmma RS chains
//    against K, dO or Q as MN-major B operands (dq += dS·K, dv += Pᵀ·dO,
//    dk += dSᵀ·Q): no operand is transposed or staged by threads. Block
//    i's score products are issued together with block i − 1's gradient
//    products, and p and ds of block i are formed while those run.
//  * f32 (exact, no TF32): 256 threads on the CUDA cores, 64-row blocks;
//    thread (ty, tx) computes a 4 × 4 tile of scores from rows staged
//    row-major (padded by 16 bytes), stores p or ds through shared memory
//    and accumulates 4 output rows × D/16 columns; the dq kernel's
//    prologue takes di as the bf16 one does.
#include "flash_common.cuh"

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // do, (B, S, H, D) view
  const void* o;        // the forward's output, (B, S, H, D) view
  const float* lse;     // (B, H, S)
  float* di;            // (B, H, S): written by the dq kernel, read by dk / dv
  void* dq;             // (B, S, H, D) contiguous, the input dtype
  void* dk;
  void* dv;
  const int* lengths;   // (B,)
  int S, H;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, osb, oss, osh;
  int window, global_cls;
  float scale;
};

__device__ __forceinline__ long long out_offset(int b, int row, int h, int S, int H, int D) {
  return (((long long)b * S + row) * H + h) * D;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                           // warpgroups of 64 rows or keys
constexpr int kTileRows = 64 * kConsumers;              // rows (dq) or keys (dk / dv) a CTA
constexpr int kHopperThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232; // 40 + 2 · 232 ≤ 512 a lane
constexpr int kStages = 4;
constexpr int kDqKeys = 64;                             // keys a dq step
constexpr float kLog2e = 1.4426950408889634f;

template <int D>   // query rows a dk / dv step
__host__ __device__ constexpr int dkv_rows() { return D <= 64 ? 64 : 32; }

struct __align__(64) BwdMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
constexpr size_t dq_smem_bytes() {   // Q, dO; K and V stages; di; barriers; slack
  return 2 * (size_t)D * (2 * kTileRows + 2 * kStages * kDqKeys) + 4 * kTileRows +
         8 * (1 + 2 * kStages) + 1024;
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V; Q and dO stages; lse and di stages; barriers; slack
  return 2 * (size_t)D * (2 * kTileRows + 2 * kStages * dkv_rows<D>()) +
         8 * kStages * dkv_rows<D>() + 8 * (1 + 2 * kStages) + 1024;
}

__device__ __forceinline__ void consumers_sync() {   // the consumer warpgroups alone
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// ds = p · (dp − di) on the accumulators of S and dP (this thread's rows
// row0 and row0 + 8, keys k0 + 8j + 2t, + 1), with p = exp2(s·c − lse·log2
// e) and 0 for the pairs kept() drops (only when `mask`); ds goes into s.
template <int BK>
__device__ __forceinline__ void ds_block(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                         const float (&lse2)[2], const float (&di)[2], bool mask,
                                         int row0, int t, int k0, int len, int window,
                                         bool global_cls, float c) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = fast_exp2(fmaf(s[4 * j + e], c, -lse2[r]));
      if (mask && !kept(row0 + 8 * r, k0 + 8 * j + 2 * t + (e & 1), len, window, global_cls))
        p = 0.f;
      s[4 * j + e] = p * (dp[4 * j + e] - di[r]);
    }
}

// pᵀ and dsᵀ on the accumulators of Sᵀ and dPᵀ (this thread's keys key0 and
// key0 + 8, query rows q0 + 8j + 2t, + 1, whose lse · log2 e and di are
// ls and dis): p into sT, ds into dpT; 0 for the pairs kept() drops and
// for rows past S (only when `mask`).
template <int BQ>
__device__ __forceinline__ void dst_block(float (&sT)[BQ / 2], float (&dpT)[BQ / 2],
                                          const float* ls, const float* dis, bool mask, int key0,
                                          int t, int q0, int S, int len, int window,
                                          bool global_cls, float c) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * j + 2 * t + (e & 1), row = q0 + r, key = key0 + (e >> 1) * 8;
      float p = fast_exp2(fmaf(sT[4 * j + e], c, -ls[r]));
      if (mask && !(row < S && kept(row, key, len, window, global_cls))) p = 0.f;
      sT[4 * j + e] = p;
      dpT[4 * j + e] = p * (dpT[4 * j + e] - dis[r]);
    }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = kDqKeys;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  bf16* qs = reinterpret_cast<bf16*>(align_1024(dq_smem));
  bf16* dos = qs + kTileRows * D;
  bf16* ks = dos + kTileRows * D;     // kStages tiles of BK × D
  bf16* vs = ks + kStages * BK * D;
  float* dis = reinterpret_cast<float*>(vs + kStages * BK * D);   // di of the tile's rows
  uint64_t* q_full = reinterpret_cast<uint64_t*>(dis + kTileRows);
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
      mbar_init(&empty[st], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {   // the producer warpgroup: one thread issues the loads
    regs_release<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * kTileRows * D * 2);
      tma_rows<D>(qs, &maps.q, q_full, kTileRows, q0, h, b);
      tma_rows<D>(dos, &maps.dout, q_full, kTileRows, q0, h, b);
      for (int i = 0; i < n_it; ++i) {
        const int st = i % kStages, it = blocks.first + i;
        const int k0 = (it < blocks.lo ? 0 : it) * BK;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * BK * D * 2);
        tma_rows<D>(ks + st * BK * D, &maps.k, &full[st], BK, k0, h, b);
        tma_rows<D>(vs + st * BK * D, &maps.v, &full[st], BK, k0, h, b);
      }
    }
  } else {
    regs_claim<kConsumerRegs>();
    {   // di = Σ o·do of the tile's rows in f32, two threads a row
      const int r = threadIdx.x / 2, half = threadIdx.x % 2, row = q0 + r;
      float di = 0.f;
      if (row < S) {
        const int off = half * (D / 2);
        const uint4* orow = reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(a.o) + b * a.osb + (long long)row * a.oss + h * a.osh + off);
        const uint4* grow = reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(a.dout) + b * a.dsb + (long long)row * a.dss + h * a.dsh +
            off);
#pragma unroll
        for (int c8 = 0; c8 < D / 16; ++c8) {
          const uint4 ov = __ldg(orow + c8), gv = __ldg(grow + c8);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]), gf = __bfloat1622float2(g2[e]);
            di = fmaf(of.x, gf.x, di);
            di = fmaf(of.y, gf.y, di);
          }
        }
      }
      di += __shfl_xor_sync(0xffffffffu, di, 1);
      if (half == 0) {
        dis[r] = di;
        if (row < S) a.di[(long long)bh * S + row] = di;
      }
    }
    consumers_sync();

    // a consumer warpgroup: rows wq0 .. wq0 + 63; this thread's rows row0
    // and row0 + 8, columns 8j + 2t, 8j + 2t + 1 of every accumulator
    const int wg = warp / 4;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + (warp % 4) * 16 + lane / 4, t = lane % 4;
    const float c = a.scale * kLog2e;
    float lse2[2], di_r[2];   // lse in log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < S ? a.lse[(long long)bh * S + row] * kLog2e : 0.f;
      di_r[r] = dis[row - q0];
    }
    float dq[D / 2], s[BK / 2], dp[BK / 2];
    uint32_t da[BK / 16][4] = {};   // dS of the previous block, rounded to bf16: the A operand
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;

    auto issue_s = [&](int st) {   // S = Q·Kᵀ, dP = dO·Vᵀ of the block in stage st
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK, 0>(s, desc_k_major<D>(qs, kTileRows, 64 * wg, kk),
                        desc_k_major<D>(ks + st * BK * D, BK, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK, 0>(dp, desc_k_major<D>(dos, kTileRows, 64 * wg, kk),
                        desc_k_major<D>(vs + st * BK * D, BK, 0, kk), kk > 0);
    };
    auto issue_dq = [&](int st) {   // dq += dS·K of the block in stage st
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D, 1>(dq, da[kk], desc_mn_major<D>(ks + st * BK * D, BK, kk), 1);
    };
    auto form_ds = [&](int i) {   // ds into s
      const int it = blocks.first + i;
      const int k0 = (it < blocks.lo ? 0 : it) * BK;
      ds_block<BK>(s, dp, lse2, di_r, needs_mask(wq0, 64, k0, BK, len, window), row0, t, k0, len,
                   window, global_cls, c);
    };
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(s, kk, da[kk]);
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };

    // Block i's S = Q·Kᵀ and dP = dO·Vᵀ are issued together with block
    // i − 1's dq += dS·K, and ds of block i is formed while that runs.
    mbar_wait(q_full, 0);
    if (n_it > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      form_ds(0);
      to_a();
      for (int i = 1; i < n_it; ++i) {
        const int st = i % kStages, prev = (i - 1) % kStages;
        mbar_wait(&full[st], (i / kStages) & 1);
        wgmma_fence();
        issue_s(st);
        wgmma_commit();
        issue_dq(prev);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        form_ds(i);
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
        release(prev);
        to_a();
      }
      const int last = (n_it - 1) % kStages;
      wgmma_fence();
      issue_dq(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      release(last);
    }

    bf16* out = static_cast<bf16*>(a.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      bf16* drow = out + out_offset(b, row, h, S, H, D) + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(drow + n * 8) =
            __floats2bfloat162_rn(dq[4 * n + 2 * r] * a.scale, dq[4 * n + 2 * r + 1] * a.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = dkv_rows<D>();
  const int S = a.S, H = a.H;
  int bh, tile;
  cta_tile((S + kTileRows - 1) / kTileRows, (int)gridDim.x / ((S + kTileRows - 1) / kTileRows),
           a.global_cls != 0, bh, tile);
  const int b = bh / H, h = bh % H;
  const int k0 = tile * kTileRows;
  const int len = min(a.lengths[b], S);
  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);

  if (k0 >= len) {   // CTA-uniform: a block of padded keys keeps no pair
    for (int idx = threadIdx.x; idx < kTileRows * D / 8; idx += kHopperThreads) {
      const int key = k0 + idx / (D / 8), c8 = idx % (D / 8);
      if (key >= S) continue;
      const long long off = out_offset(b, key, h, S, H, D) + 8 * c8;
      *reinterpret_cast<uint4*>(dkp + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dvp + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  bf16* ks = reinterpret_cast<bf16*>(align_1024(dkv_smem));
  bf16* vs = ks + kTileRows * D;
  bf16* qs = vs + kTileRows * D;      // kStages tiles of BQ × D
  bf16* dos = qs + kStages * BQ * D;
  float* lses = reinterpret_cast<float*>(dos + kStages * BQ * D);   // lse · log2 e, kStages × BQ
  float* dis = lses + kStages * BQ;                                 // di, kStages × BQ
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dis + kStages * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int window = a.window;
  const bool global_cls = a.global_cls != 0;
  const Blocks blocks = query_blocks<BQ, kTileRows>(k0, S, window, global_cls);
  const int n_it = max(blocks.hi - blocks.first, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);   // the producer warp: TMA plus its lse and di stores
      mbar_init(&empty[st], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {   // the producer warpgroup: its first warp loads
    regs_release<kProducerRegs>();
    if (warp == 4 * kConsumers) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * kTileRows * D * 2);
        tma_rows<D>(ks, &maps.k, kv_full, kTileRows, k0, h, b);
        tma_rows<D>(vs, &maps.v, kv_full, kTileRows, k0, h, b);
      }
      for (int i = 0; i < n_it; ++i) {
        const int st = i % kStages, it = blocks.first + i;
        const int q0 = (it < blocks.lo ? 0 : it) * BQ;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * BQ * D * 2);
          tma_rows<D>(qs + st * BQ * D, &maps.q, &full[st], BQ, q0, h, b);
          tma_rows<D>(dos + st * BQ * D, &maps.dout, &full[st], BQ, q0, h, b);
        }
        for (int r = lane; r < BQ; r += 32) {
          const int row = q0 + r;
          lses[st * BQ + r] = row < S ? a.lse[(long long)bh * S + row] * kLog2e : 0.f;
          dis[st * BQ + r] = row < S ? a.di[(long long)bh * S + row] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // a consumer warpgroup: keys wk0 .. wk0 + 63; this thread's keys key0
    // and key0 + 8, query rows q0 + 8j + 2t, q0 + 8j + 2t + 1 of Sᵀ and dPᵀ
    regs_claim<kConsumerRegs>();
    const int wg = warp / 4;
    const int wk0 = k0 + 64 * wg;
    const int key0 = wk0 + (warp % 4) * 16 + lane / 4, t = lane % 4;
    const float c = a.scale * kLog2e;
    float dk[D / 2], dv[D / 2], sT[BQ / 2], dpT[BQ / 2];
    // pᵀ and dsᵀ of the previous q-block, rounded to bf16: the A operands
    uint32_t pa[BQ / 16][4] = {}, sa[BQ / 16][4] = {};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sT[i] = dpT[i] = 0.f;

    auto issue_s = [&](int st) {   // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ of the q-block in stage st
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(sT, desc_k_major<D>(ks, kTileRows, 64 * wg, kk),
                        desc_k_major<D>(qs + st * BQ * D, BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(dpT, desc_k_major<D>(vs, kTileRows, 64 * wg, kk),
                        desc_k_major<D>(dos + st * BQ * D, BQ, 0, kk), kk > 0);
    };
    auto issue_dkv = [&](int st) {   // dv += Pᵀ·dO, dk += dSᵀ·Q of the q-block in stage st
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dv, pa[kk], desc_mn_major<D>(dos + st * BQ * D, BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dk, sa[kk], desc_mn_major<D>(qs + st * BQ * D, BQ, kk), 1);
    };
    auto form_pds = [&](int i, int st) {   // pᵀ into sT, dsᵀ into dpT
      const int it = blocks.first + i;
      const int q0 = (it < blocks.lo ? 0 : it) * BQ;
      const bool mask = q0 + BQ > S || needs_mask(q0, BQ, wk0, 64, len, window);
      dst_block<BQ>(sT, dpT, lses + st * BQ, dis + st * BQ, mask, key0, t, q0, S, len, window,
                    global_cls, c);
    };
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        acc_to_a(sT, kk, pa[kk]);
        acc_to_a(dpT, kk, sa[kk]);
      }
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };

    // q-block i's Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are issued together with
    // q-block i − 1's dv += Pᵀ·dO and dk += dSᵀ·Q, and pᵀ and dsᵀ of
    // q-block i are formed while those run.
    mbar_wait(kv_full, 0);
    if (n_it > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      form_pds(0, 0);
      to_a();
      for (int i = 1; i < n_it; ++i) {
        const int st = i % kStages, prev = (i - 1) % kStages;
        mbar_wait(&full[st], (i / kStages) & 1);
        wgmma_fence();
        issue_s(st);
        wgmma_commit();
        issue_dkv(prev);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sT);
        fence_regs(dpT);
        form_pds(i, st);
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(sa);
        release(prev);
        to_a();
      }
      const int last = (n_it - 1) % kStages;
      wgmma_fence();
      issue_dkv(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(sa);
      release(last);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= S) continue;
      const long long off = out_offset(b, key, h, S, H, D) + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + off + n * 8) =
            __floats2bfloat162_rn(dk[4 * n + 2 * r] * a.scale, dk[4 * n + 2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + off + n * 8) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
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
constexpr size_t dq_f32_smem_bytes() {    // Q, dO, K, V rows; dsᵀ; di
  return sizeof(float) * (4 * (size_t)kBK * kLdr<D> + (size_t)kBK * kLdt + kBQ);
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
  float* dis = dst + kBK * kLdt;     // di of the q-block's rows

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
  const float* ob = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;

  stage_rows_f32<D>(qb, a.qss, q0, S, qs);
  stage_rows_f32<D>(ob, a.dss, q0, S, dos);
  {   // di = Σ o·do of the q-block's rows, four threads a row; dk/dv reads it
    const int r = tid / 4, part = tid % 4, row = q0 + r;
    float di = 0.f;
    if (row < S) {
      const float* orow = static_cast<const float*>(a.o) + b * a.osb + (long long)row * a.oss +
                          h * a.osh + part * (D / 4);
      const float* grow = ob + (long long)row * a.dss + part * (D / 4);
#pragma unroll 4
      for (int d = 0; d < D / 4; ++d) di = fmaf(orow[d], grow[d], di);
    }
    di += __shfl_xor_sync(0xffffffffu, di, 1);
    di += __shfl_xor_sync(0xffffffffu, di, 2);
    if (part == 0) {
      dis[r] = di;
      if (row < S) a.di[(long long)bh * S + row] = di;
    }
  }
  __syncthreads();
  float lse_r[4], di_r[4], acc[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < S ? a.lse[(long long)bh * S + row] : 0.f;
    di_r[i] = dis[4 * ty + i];
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.f;
  }

  const Blocks blocks = key_blocks<kBQ, kBK>(q0, len, window, global_cls);
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
  const float* ob = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;

  float dk[4][kCpt], dv[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCpt; ++c) dk[i][c] = dv[i][c] = 0.f;

  if (k0 < len) {   // CTA-uniform: a block of padded keys keeps no pair
    stage_rows_f32<D>(kb, a.kss, k0, S, ks);
    stage_rows_f32<D>(vb, a.vss, k0, S, vs);
    const Blocks blocks = query_blocks<kBQ, kBK>(k0, S, window, global_cls);
    for (int it = blocks.first; it < blocks.hi; ++it) {
      const int q0 = (it < blocks.lo ? 0 : it) * kBQ;
      __syncthreads();   // the previous tiles are consumed (and K, V are staged)
      stage_rows_f32<D>(qb, a.qss, q0, S, qs);
      stage_rows_f32<D>(ob, a.dss, q0, S, dos);
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
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The four maps of q, k, v and do: boxes of `rows` rows for q and do, of
// `keys` rows for k and v.
template <int D>
cudaError_t make_maps(BwdMaps* m, const BwdArgs& a, int B, int rows, int keys) {
  cudaError_t err = rows_map(&m->q, a.q, B, a.S, a.H, D, a.qsb, a.qss, a.qsh, rows);
  if (err == cudaSuccess) err = rows_map(&m->k, a.k, B, a.S, a.H, D, a.ksb, a.kss, a.ksh, keys);
  if (err == cudaSuccess) err = rows_map(&m->v, a.v, B, a.S, a.H, D, a.vsb, a.vss, a.vsh, keys);
  if (err == cudaSuccess)
    err = rows_map(&m->dout, a.dout, B, a.S, a.H, D, a.dsb, a.dss, a.dsh, rows);
  return err;
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int B, bool bf16, cudaStream_t st) {
  if (bf16) {
    BwdMaps maps;
    cudaError_t err = make_maps<D>(&maps, a, B, kTileRows, kDqKeys);
    if (err == cudaSuccess) err = set_smem(flash_bwd_dq_bf16<D>, dq_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    const dim3 grid(B * a.H * ((a.S + kTileRows - 1) / kTileRows));
    flash_bwd_dq_bf16<D><<<grid, kHopperThreads, dq_smem_bytes<D>(), st>>>(maps, a);
    return cudaGetLastError();
  }
  cudaError_t err = set_smem(flash_bwd_dq_f32<D>, dq_f32_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.S + kBQ - 1) / kBQ);
  flash_bwd_dq_f32<D><<<grid, kF32Threads, dq_f32_smem_bytes<D>(), st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, bool bf16, cudaStream_t st) {
  if (bf16) {
    BwdMaps maps;
    cudaError_t err = make_maps<D>(&maps, a, B, dkv_rows<D>(), kTileRows);
    if (err == cudaSuccess) err = set_smem(flash_bwd_dkv_bf16<D>, dkv_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    const dim3 grid(B * a.H * ((a.S + kTileRows - 1) / kTileRows));
    flash_bwd_dkv_bf16<D><<<grid, kHopperThreads, dkv_smem_bytes<D>(), st>>>(maps, a);
    return cudaGetLastError();
  }
  cudaError_t err = set_smem(flash_bwd_dkv_f32<D>, dkv_f32_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.S + kBK - 1) / kBK);
  flash_bwd_dkv_f32<D><<<grid, kF32Threads, dkv_f32_smem_bytes<D>(), st>>>(a);
  return cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout, const void* o,
                  const float* lse, float* di, const int* lengths, int S, int H,
                  const long long* strides, int window, int global_cls, float scale) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.o = o; a.lse = lse; a.di = di;
  a.lengths = lengths;
  a.S = S; a.H = H;
  a.qsb = strides[0]; a.qss = strides[1]; a.qsh = strides[2];
  a.ksb = strides[3]; a.kss = strides[4]; a.ksh = strides[5];
  a.vsb = strides[6]; a.vss = strides[7]; a.vsh = strides[8];
  a.dsb = strides[9]; a.dss = strides[10]; a.dsh = strides[11];
  a.osb = strides[12]; a.oss = strides[13]; a.osh = strides[14];
  a.window = window; a.global_cls = global_cls; a.scale = scale;
  return a;
}

}  // namespace

// q, k, v, dout, out: (B, S, H, D) views with the last dim contiguous;
// strides: 15 values, the (batch, token, head) strides in elements of q,
// k, v, dout and out; lse: (B, H, S) f32; di: (B, H, S) f32, written here
// (Σ out·dout a row) for ts_flash_bwd_dkv, which must run after this on
// the same stream; dq: (B, S, H, D) contiguous in the input dtype;
// lengths: (B,) int32. D ∈ {32, 64, 128}.
extern "C" int ts_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* out, const float* lse, float* di, void* dq,
                               const int* lengths, int is_bf16, int B, int S, int H, int D,
                               const long long* strides, int window, int global_cls, float scale,
                               void* stream) {
  BwdArgs a = make_args(q, k, v, dout, out, lse, di, lengths, S, H, strides, window, global_cls,
                        scale);
  a.dq = dq;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch_dq<32>(a, B, is_bf16 != 0, st);
    case 64: return (int)launch_dq<64>(a, B, is_bf16 != 0, st);
    case 128: return (int)launch_dq<128>(a, B, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same inputs, di as ts_flash_bwd_dq wrote it; dk, dv: (B, S, H, D)
// contiguous in the input dtype.
extern "C" int ts_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* out, const float* lse, float* di, void* dk, void* dv,
                                const int* lengths, int is_bf16, int B, int S, int H, int D,
                                const long long* strides, int window, int global_cls, float scale,
                                void* stream) {
  BwdArgs a = make_args(q, k, v, dout, out, lse, di, lengths, S, H, strides, window, global_cls,
                        scale);
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
