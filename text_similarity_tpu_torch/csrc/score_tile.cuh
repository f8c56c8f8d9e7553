// The score tile of the exact top-k kernels K2 (topk.cu, f32 and bf16
// corpora), K3 (topk.cu, int8 corpus) and K8 (topk_2pass.cu, fold and
// count), designed for the H100.
//
// A CTA of 256 threads computes the scores of a 128-row × QT-query tile,
// QT ∈ {16, 64, 128}, in f32 on the CUDA cores. An f32 corpus must stay
// exact (no TF32), so the tile is bound by the card's f32 FMA rate once QT
// queries share each staged row; the design keeps the FMA pipes busy:
//
// * Register blocking. Thread (rg, qg) owns rows rg + RG·i (i < RM) and
//   queries qg + QG·j (j < QN) in RM × QN accumulators (a warp: 4 row
//   groups × 8 query groups): 8 × 8 at QT 128,
//   8 × 4 at QT 64, 4 × 2 at QT 16. Every 4 dims it reads one float4 a row
//   and one a query from shared memory (RM + QN loads for 4·RM·QN FMAs: 16
//   for 256 at QT 128), so shared memory no longer bounds the product. Row
//   and query strides are padded by 16 bytes, so the 8 threads of a load
//   phase hit 8 different bank quads (or one broadcast address).
// * A copy ring. The tile walks the dims kStep at a time (16 at QT 128, 32
//   below) through kStages (4, 3) stages of shared memory, each holding the
//   rows' and the queries' kStep dims. cp.async.cg copies the stages of the
//   next kStages − 1 steps while step s runs its FMAs; one
//   cp.async.wait_group and one __syncthreads a step.
//   The ring runs across tile boundaries, so an epilogue overlaps the next
//   tile's copies. Rows past the tile's valid count and queries past Q are
//   zero-filled by the copy itself (src-size 0).
// * A bf16 corpus stays bf16 in shared memory and widens to f32 at the read
//   (exactly: a 16-bit shift). Its queries are rounded to bf16 (as the
//   reference casts them to the corpus dtype): the thread that copied a
//   query piece rounds it in place once its copy has landed, before the
//   step's barrier publishes it.
// * An int8 corpus (K3) widens once a stage, not at every read: a row's 16
//   codes land by one cp.async in the first 16 bytes of the 64 that their
//   f32 values take in an f32 stage, and the thread that copied them
//   widens them in place (exactly) once its copy has landed, before the
//   step's barrier. The FMA loop then reads f32 rows as for an f32 corpus,
//   at one conversion a code instead of one a code and query group. The
//   queries stay f32, as the reference keeps them.
// * The same bits everywhere. Every score is one fmaf chain over d = 0 …
//   D − 1 in order, from 0, whatever QT, the tile's position or the kernel:
//   K2's scores, K8's fold scores and K8's count scores are equal bit for
//   bit, and a query's answer does not depend on Q.
//
// Measured on an H100 SXM (PERF.md §6): at QT 128 the tile runs at
// about half the f32 peak, and neither 25% fewer shared-memory loads nor 25%
// fewer FMAs moves it in proportion: with 254 registers a thread, one CTA
// (two warps a scheduler) holds an SM, and the warps' stalls bind.
//
// score_tiles() drives the ring over a CTA's run of tiles; tile_of(t) gives
// tile t's first row and its valid row count, and epi(t, acc) sees each
// finished tile's accumulators (every thread calls it; it may hold
// __syncthreads). The IVF kernels keep common.cuh's tile_scores.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTileRows = 128;       // rows of a score tile
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

// A thread's RM rows × QN queries; the dims a ring stage holds (kStep) and
// the ring's stages. QT 128 takes 16-dim steps so that K2's selection and
// K8's class state fit beside the ring; the narrower tiles take 32.
template <int QT>
struct TileShape;
template <>
struct TileShape<128> { static constexpr int RM = 8, QN = 8, kStep = 16, kStages = 4; };
template <>
struct TileShape<64> { static constexpr int RM = 8, QN = 4, kStep = 32, kStages = 3; };
template <>
struct TileShape<16> { static constexpr int RM = 4, QN = 2, kStep = 32, kStages = 3; };

// The type a corpus value takes in a stage: an int8 code is widened to f32
// there (widen_own_codes); f32 and bf16 values stay as copied.
template <typename T>
struct Staged { using type = T; };
template <>
struct Staged<int8_t> { using type = float; };

template <typename T, int QT>
struct ScoreTile {
  using C = typename Staged<T>::type;
  static constexpr int RM = TileShape<QT>::RM, QN = TileShape<QT>::QN;
  static constexpr int RG = kTileRows / RM;   // row groups
  static constexpr int QG = QT / QN;          // query groups
  static_assert(RG * QG == kTileThreads, "one thread per (row group, query group)");
  static constexpr int kStep = TileShape<QT>::kStep, kStages = TileShape<QT>::kStages;
  static constexpr int kVec = 16 / (int)sizeof(T);               // values a 16-byte copy
  static constexpr int kCStride = kStep + 16 / (int)sizeof(C);   // staged values a row
  static constexpr int kQStride = kStep + 4;                     // floats
  static constexpr int kCorpusBytes = kTileRows * kCStride * (int)sizeof(C);
  static constexpr int kQueryBytes = QT * kQStride * 4;
  static constexpr int kStageBytes = kCorpusBytes + kQueryBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kCPiecesPerRow = kStep / kVec;
  static constexpr int kCPieces = kTileRows * kCPiecesPerRow;   // 16-byte copies a stage
  static constexpr int kQPieces = QT * kStep / 4;
  // A warp covers 8 query groups × 4 row groups: 8 queries and 4 rows
  // distinct a load, and 4 consecutive rows a query in a store.
  __device__ static int qg_of(int tid) { return tid % 8 + 8 * ((tid / 32) % (QG / 8)); }
  __device__ static int rg_of(int tid) { return tid % 32 / 8 + 4 * (tid / 32 / (QG / 8)); }
};

// The query tile a call uses: by Q (16 up to 16 queries, 64 up to 64, 128
// above), capped by k for K2, whose per-query selectors take 2·kp (score,
// id) pairs of shared memory each (kp = pow2 ≥ max(k, 32)). The wrapper's
// planner (ops/topk.py _qtile) mirrors this rule to size the grid.
inline int qt_for(int Q, int k) {
  const int qt = Q <= 16 ? 16 : Q <= 64 ? 64 : 128;
  const int kp = host_kp_for(k);
  const int cap = kp <= 32 ? 128 : kp <= 64 ? 64 : 16;
  return qt < cap ? qt : cap;
}

__device__ __forceinline__ void ring_copy16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void ring_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [row0, row0 + nv) (zeros past nv) and queries [q0, q0 + QT)
// (zeros past Q), dims [d0, d0 + kStep), into one stage.
template <typename T, int QT>
__device__ __forceinline__ void load_stage(unsigned char* stage, const float* __restrict__ q,
                                           int Q, int q0, const T* __restrict__ corpus, int D,
                                           int row0, int nv, int d0) {
  using S = ScoreTile<T, QT>;
  for (int p = threadIdx.x; p < S::kCPieces; p += kTileThreads) {
    const int row = p / S::kCPiecesPerRow, v = p % S::kCPiecesPerRow;
    const bool ok = row < nv;
    const T* src = ok ? corpus + (size_t)(row0 + row) * D + d0 + v * S::kVec : corpus;
    // an int8 piece lands at the start of its 16 values' f32 slot
    ring_copy16(stage + (row * S::kCStride + v * S::kVec) * sizeof(typename S::C), src, ok);
  }
  float* qs = reinterpret_cast<float*>(stage + S::kCorpusBytes);
  for (int p = threadIdx.x; p < S::kQPieces; p += kTileThreads) {
    const int qi = p / (S::kStep / 4), v = p % (S::kStep / 4);
    const bool ok = q0 + qi < Q;
    const float* src = ok ? q + (size_t)(q0 + qi) * D + d0 + v * 4 : q;
    ring_copy16(qs + qi * S::kQStride + v * 4, src, ok);
  }
}

// bf16 corpus: round this thread's own query pieces of a landed stage to
// bf16 (its cp.async writes are visible to itself after the wait).
template <int QT>
__device__ __forceinline__ void round_own_queries(unsigned char* stage) {
  using S = ScoreTile<__nv_bfloat16, QT>;
  float* qs = reinterpret_cast<float*>(stage + S::kCorpusBytes);
  for (int p = threadIdx.x; p < S::kQPieces; p += kTileThreads) {
    float4* v = reinterpret_cast<float4*>(qs + (p / (S::kStep / 4)) * S::kQStride +
                                          (p % (S::kStep / 4)) * 4);
    float4 x = *v;
    x.x = round_bf16(x.x);
    x.y = round_bf16(x.y);
    x.z = round_bf16(x.z);
    x.w = round_bf16(x.w);
    *v = x;
  }
}

// int8 corpus: widen this thread's own pieces of a landed stage in place,
// 16 codes (16 bytes) → 16 f32 (the piece's 64-byte slot). Only this
// thread copied into the slot; it reads the codes before it writes, both
// through int4 so that the compiler keeps that order.
__device__ __forceinline__ int widen_code(int word, int byte) {
  return __float_as_int((float)(int8_t)((word >> (8 * byte)) & 0xff));
}

template <int QT>
__device__ __forceinline__ void widen_own_codes(unsigned char* stage) {
  using S = ScoreTile<int8_t, QT>;
  float* cs = reinterpret_cast<float*>(stage);
  for (int p = threadIdx.x; p < S::kCPieces; p += kTileThreads) {
    int4* slot = reinterpret_cast<int4*>(cs + (p / S::kCPiecesPerRow) * S::kCStride +
                                         (p % S::kCPiecesPerRow) * 16);
    const int4 raw = slot[0];
    const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)   // byte b of word e is code 4e + b (little-endian)
      slot[e] = make_int4(widen_code(w[e], 0), widen_code(w[e], 1), widen_code(w[e], 2),
                          widen_code(w[e], 3));
  }
}

// acc[i][j] += the 4 dims of c[i] · v[j], dim by dim in order; all RM × QN
// accumulators take one dim before any takes the next, so each fmaf's
// input was written RM·QN instructions before it.
template <int RM, int QN>
__device__ __forceinline__ void fma4(const float4 (&c)[RM], const float4 (&v)[QN],
                                     float (&acc)[RM][QN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = fmaf(c[i].x, v[j].x, acc[i][j]);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = fmaf(c[i].y, v[j].y, acc[i][j]);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = fmaf(c[i].z, v[j].z, acc[i][j]);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = fmaf(c[i].w, v[j].w, acc[i][j]);
}

// One stage's dims into the accumulators, in order.
template <int QT>
__device__ __forceinline__ void stage_fma(const unsigned char* stage, int rg, int qg,
                                          float (&acc)[TileShape<QT>::RM][TileShape<QT>::QN],
                                          const float*) {
  using S = ScoreTile<float, QT>;
  const float* cs = reinterpret_cast<const float*>(stage);
  const float* qs = reinterpret_cast<const float*>(stage + S::kCorpusBytes);
#pragma unroll
  for (int d = 0; d < S::kStep; d += 4) {
    float4 c[S::RM], v[S::QN];
#pragma unroll
    for (int i = 0; i < S::RM; ++i)
      c[i] = *reinterpret_cast<const float4*>(cs + (rg + S::RG * i) * S::kCStride + d);
#pragma unroll
    for (int j = 0; j < S::QN; ++j)
      v[j] = *reinterpret_cast<const float4*>(qs + (qg + S::QG * j) * S::kQStride + d);
    fma4(c, v, acc);
  }
}

template <int QT>
__device__ __forceinline__ void stage_fma(const unsigned char* stage, int rg, int qg,
                                          float (&acc)[TileShape<QT>::RM][TileShape<QT>::QN],
                                          const __nv_bfloat16*) {
  using S = ScoreTile<__nv_bfloat16, QT>;
  const __nv_bfloat16* cs = reinterpret_cast<const __nv_bfloat16*>(stage);
  const float* qs = reinterpret_cast<const float*>(stage + S::kCorpusBytes);
#pragma unroll
  for (int d = 0; d < S::kStep; d += 4) {
    float4 c[S::RM], v[S::QN];
#pragma unroll
    for (int i = 0; i < S::RM; ++i) {
      // 4 bf16 → f32: element 0 sits in the low half of the first word
      const uint2 raw =
          *reinterpret_cast<const uint2*>(cs + (rg + S::RG * i) * S::kCStride + d);
      c[i] = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                         __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
    }
#pragma unroll
    for (int j = 0; j < S::QN; ++j)
      v[j] = *reinterpret_cast<const float4*>(qs + (qg + S::QG * j) * S::kQStride + d);
    fma4(c, v, acc);
  }
}

// Scores of the CTA's n_tiles tiles against queries [q0, q0 + QT) through
// the copy ring at `ring` (ScoreTile::kRingBytes of shared memory). D must
// be a multiple of 32; every thread of the CTA must call this.
template <typename T, int QT, class TileOf, class Epi>
__device__ __forceinline__ void score_tiles(const float* __restrict__ q, int Q, int q0,
                                            const T* __restrict__ corpus, int D, int n_tiles,
                                            TileOf tile_of, Epi epi, unsigned char* ring) {
  using S = ScoreTile<T, QT>;
  const int qg = S::qg_of(threadIdx.x), rg = S::rg_of(threadIdx.x);
  const int n_chunks = D / S::kStep;
  const int n_steps = n_tiles * n_chunks;
  int lt = 0, lc = 0;   // tile and chunk of the next step to copy
  auto copy_step = [&](int s) {
    if (s < n_steps) {
      const int2 tile = tile_of(lt);
      load_stage<T, QT>(ring + (s % S::kStages) * S::kStageBytes, q, Q, q0, corpus, D, tile.x,
                        tile.y, lc * S::kStep);
      if (++lc == n_chunks) {
        lc = 0;
        ++lt;
      }
    }
    ring_commit();   // empty groups keep the wait count uniform
  };
#pragma unroll 1
  for (int s = 0; s < S::kStages - 1; ++s) copy_step(s);
  float acc[S::RM][S::QN];
#pragma unroll
  for (int i = 0; i < S::RM; ++i)
#pragma unroll
    for (int j = 0; j < S::QN; ++j) acc[i][j] = 0.f;
  int t = 0, c = 0;
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    ring_wait<S::kStages - 2>();
    unsigned char* stage = ring + (s % S::kStages) * S::kStageBytes;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) round_own_queries<QT>(stage);
    if constexpr (std::is_same_v<T, int8_t>) widen_own_codes<QT>(stage);
    __syncthreads();   // stage s landed for all; stage s - 1 read by all
    copy_step(s + S::kStages - 1);
    stage_fma<QT>(stage, rg, qg, acc, static_cast<const typename S::C*>(nullptr));
    if (++c == n_chunks) {
      epi(t, acc);
      c = 0;
      ++t;
#pragma unroll
      for (int i = 0; i < S::RM; ++i)
#pragma unroll
        for (int j = 0; j < S::QN; ++j) acc[i][j] = 0.f;
    }
  }
  ring_wait<0>();
}

}  // namespace
