// Building blocks shared by the flash forward (flash_fwd.cu, kernel K5),
// backward (flash_bwd.cu, kernel K6) and the head-packed attention
// (packed_attention.cu, kernel K7): the kept (query, key) pairs, the blocks
// a tile visits (for any tile sizes), whether a block needs the mask at
// all, and the 64-row mma.sync bf16 fragments with their shared-memory
// staging (K7 and nothing else; K5's and K6's bf16 paths use wgmma,
// hopper.cuh).
//
// Kept pairs: key j of sequence b is kept for query row i when j < len[b]
// and, with window > 0, |i - j| <= window or (global_cls and (i == 0 or
// j == 0)). Every other pair has p = 0: a row with no kept key (a
// zero-length sequence, or a padded row outside every band) gets zero
// output, lse 0 and zero gradients.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;              // query rows per block (K7, and the f32 paths)
constexpr int kBK = 64;              // keys per block
constexpr float kNegInf = -1e9f;
constexpr int kMmaThreads = (kBQ / 16) * 32;   // mma.sync kernels: one warp per 16 rows

// The blocks a CTA visits: blocks it in [first, hi), block 0 standing in
// for it < lo (the CLS column, or the CLS row in the backward's dk/dv).
struct Blocks {
  int first, lo, hi;
};

// The key blocks (BK keys each) that hold every kept key of query rows
// [q0, q0 + BQ): the band's blocks below ceil(len / BK), key block 0 once
// more when the band leaves it out (global CLS), every valid block for the
// tile of row 0 (global CLS) or at window 0.
template <int BQ, int BK>
__device__ __forceinline__ Blocks key_blocks(int q0, int len, int window, bool global_cls) {
  const int n_valid = (len + BK - 1) / BK;
  Blocks kb{0, 0, n_valid};
  if (window > 0) {
    kb.lo = max(q0 - window, 0) / BK;
    kb.hi = min((q0 + BQ - 1 + window) / BK + 1, n_valid);
    kb.first = kb.lo;
    if (global_cls && n_valid > 0) {
      if (q0 == 0) kb.hi = n_valid;                 // the CLS row sees every key
      if (kb.lo > 0) {                              // visit block 0 first
        kb.first = kb.lo - 1;
        kb.hi = max(kb.hi, kb.lo);
      }
    }
  }
  return kb;
}

// The q-blocks (BQ rows each) whose rows meet a kept pair of keys [k0, k0
// + BK) (all rows below S, padded rows included): every q-block at window
// 0 or for the key block of key 0 with the global CLS; else the band's
// q-blocks, plus q-block 0 (the CLS row) first with the global CLS.
template <int BQ, int BK>
__device__ __forceinline__ Blocks query_blocks(int k0, int S, int window, bool global_cls) {
  const int n_qb = (S + BQ - 1) / BQ;
  Blocks qb{0, 0, n_qb};
  if (window > 0 && !(global_cls && k0 == 0)) {
    qb.lo = max(k0 - window, 0) / BQ;
    qb.hi = min((k0 + BK - 1 + window) / BQ + 1, n_qb);
    qb.first = global_cls && qb.lo > 0 ? qb.lo - 1 : qb.lo;
  }
  return qb;
}

// The (b·h, tile) of this CTA in a 1-D grid of BH · n_tiles CTAs. The
// tiles of one head take neighbouring ids, so the CTAs on the card at once
// cover a few heads and read each head's keys and values (or queries and
// output gradients) from L2 rather than from device memory. With the
// global CLS the tile of row 0 (or of key 0) of every head, the one that
// visits every block, takes the lowest ids and starts first.
__device__ __forceinline__ void cta_tile(int n_tiles, int BH, bool cls_first, int& bh,
                                         int& tile) {
  int id = blockIdx.x;
  if (cls_first) {
    if (id < BH) {
      bh = id;
      tile = 0;
      return;
    }
    id -= BH;
    bh = id / (n_tiles - 1);
    tile = 1 + id % (n_tiles - 1);
  } else {
    bh = id / n_tiles;
    tile = id % n_tiles;
  }
}

// Whether some pair of rows [q0, q0 + nq) and keys [k0, k0 + nk) is not
// kept: the keys cross len, or (window > 0) the block is not wholly inside
// the band. The global CLS only adds pairs to those of the band, so a
// block wholly inside the band (block 0 included) keeps every pair; only
// the other blocks run kept().
__device__ __forceinline__ bool needs_mask(int q0, int nq, int k0, int nk, int len, int window) {
  if (k0 + nk > len) return true;
  return window > 0 && (q0 + nq - 1 - k0 > window || k0 + nk - 1 - q0 > window);
}

__device__ __forceinline__ bool kept(int row, int key, int len, int window, bool global_cls) {
  bool keep = key < len;
  if (window > 0)
    keep = keep && (abs(row - key) <= window || (global_cls && (row == 0 || key == 0)));
  return keep;
}

// bf16 staging: a row of D bf16 values is D / 2 32-bit words, padded by 4
// words (16 bytes) so the fragment loads of neighbouring rows hit distinct
// banks; a transposed block (dim-major) holds kBK values a row, padded the
// same way.
template <int D>
constexpr int kRowWords = D / 2 + 4;
constexpr int kVtWords = kBK / 2 + 4;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// 64 rows → dst transposed (dim-major, kVtWords words a dim row).
template <int D>
__device__ __forceinline__ void stage_vt(const __nv_bfloat16* __restrict__ base, long long ss,
                                         int row0, int S, uint32_t* dst) {
  constexpr int kChunks = D / 8;
  __nv_bfloat16* dh = reinterpret_cast<__nv_bfloat16*>(dst);
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kMmaThreads) {
    const int r = idx % kBK, c = idx / kBK;   // neighbouring threads: neighbouring rows
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      v = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * ss + c * 8));
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) dh[(c * 8 + e) * (2 * kVtWords) + r] = hv[e];
  }
}

// The A fragments (PTX m16n8k16: lane 4g + t holds rows g and g + 8 at
// k = 2t.. and 2t + 8..) of 16 staged rows starting at row r0, for the
// D / 16 k-steps of a product over the head dim.
template <int D>
__device__ __forceinline__ void load_a_frags(const uint32_t* rows, int r0, int g, int t,
                                             uint32_t a[][4]) {
  const uint32_t* w = rows + (r0 + g) * kRowWords<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = w[kk * 8 + t];
    a[kk][1] = w[8 * kRowWords<D> + kk * 8 + t];
    a[kk][2] = w[kk * 8 + 4 + t];
    a[kk][3] = w[8 * kRowWords<D> + kk * 8 + 4 + t];
  }
}

// c[j] (8 tiles of 16 × 8) = A (16 × D, fragments a) · rowsᵀ (the 64 staged
// rows as the B operand: column n of tile j is staged row 8j + n).
template <int D>
__device__ __forceinline__ void scores_16x64(const uint32_t a[][4], const uint32_t* rows, int g,
                                             int t, float c[kBK / 8][4]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const uint32_t* w = rows + (j * 8 + g) * kRowWords<D>;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_16816(c[j], a[kk], w[kk * 8 + t], w[kk * 8 + 4 + t]);
  }
}

// acc (16 × D as D / 8 tiles) += P (16 × 64, the score tiles c rounded to
// bf16) · X, where xt is X (64 × D) staged transposed.
template <int D>
__device__ __forceinline__ void accumulate_pv(const float c[kBK / 8][4], const uint32_t* xt,
                                              int g, int t, float acc[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16x2(c[2 * kk][0], c[2 * kk][1]),
                            pack_bf16x2(c[2 * kk][2], c[2 * kk][3]),
                            pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                            pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t* w = xt + (n * 8 + g) * kVtWords;
      mma_16816(acc[n], pa, w[kk * 8 + t], w[kk * 8 + 4 + t]);
    }
  }
}

}  // namespace
