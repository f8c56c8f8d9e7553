// The IVF block-union scan on Hopper's tensor cores: kernel K1 with bf16
// slabs and kernel K4 with int8 slabs, in both merge modes (exact: width =
// Mc, slots 0; deferred: width w, slots S in 1..4). ivf_scan.cu's
// ts_ivf_scan / ts_ivf_scan_int8 take this tile wherever ivf_tile_plan
// accepts the shape; f32 slabs (which stay exact f32, no TF32) and the
// shapes below stay on ivf_scan.cu's CUDA-core kernel.
//
// Replaces text_similarity_tpu/index/ivf.py _ivf_query_pallas → _ivf_kernel
// / _ivf_kernel_int8 → _ivf_body: a bf16 dot with f32 accumulation (queries
// rounded to bf16, int8 codes widened to bf16, exactly: |c| ≤ 127), then ×
// the slot's scale (int8), then −inf where id < 0, then the exact or the
// deferred lane-class merge (semantics in ivf_scan.cu's header).
//
// Bound on the H100: at the main path's shape (B 4096 in 64-query blocks,
// U 56, Mc 1536, D 384, bf16) a block's dot products reach 64 FLOP a slab
// byte, under the 295 at which the bf16 tensor cores, and not the memory,
// bind: the scan is bound by the bytes of its live slab rows. So the design
// reads each live tile once a query block and no empty one:
//
// * One CTA a (query block of up to 64, 64-lane range). It walks the
//   block's probe list in order, (probe u, chunk ch), so the deferred fold
//   meets the same entries in the same order as the reference and keeps
//   the same ids. The grid is range-major (range 0 of every block first):
//   live rows sit at the front of each slab, so the heavy CTAs start first
//   and the last wave holds the light ones. What is left: the heaviest
//   CTA's own length (56 tiles at the main path), and at the pipeline's
//   one-block requests, fewer CTAs than SMs.
// * Scores transposed, Sᵀ = X·Qᵀ: 64 slab rows are wgmma's M, the block's
//   queries N, D the depth. A thread's accumulator entries are fixed
//   (lane class, query) pairs, so the running top-S of the deferred fold
//   stays in its registers across probes. Two consumer warpgroups split
//   the queries (N 32 each at 64 queries; 8 each at 16; one warpgroup of 8
//   at ≤ 8): at N 32 a thread holds 16 scores and 32·S registers of fold
//   state, 128 at S 4, so S 1-4 take the same tile (S 4 spills a few
//   registers).
// * The queries, rounded to bf16, sit once in shared memory as the
//   K-major B operand (128B swizzle; padded to the CTA's query count with
//   zeros). bf16 slabs: 64 × D row tiles arrive by TMA (a 3-D map over
//   (C_tot, Mc, D): rows past Mc read as zeros, so nothing is read past a
//   slab) through a ring of stages, one producer warp, SS wgmma. int8
//   slabs: the codes arrive as bytes by TMA (64B swizzle); each consumer
//   widens its A fragments from them in registers, exactly, for RS wgmma,
//   so no bf16 copy of a slab is written; then × the slot's scale. The
//   ids (and scales) of a tile arrive with it by TMA.
// * Empty tiles skipped. Before a window of up to 512 tiles, every warp of
//   the CTA reads those tiles' ids (64 a tile, coalesced) and the CTA keeps
//   the list of tiles with a live slot: only those are copied and
//   multiplied. An empty slot scores −inf, which never displaces an entry
//   of the fold (strictly greater displaces) and never enters an exact
//   top-k, so the answer is unchanged. The ids are read, not the build's
//   fill counts, so holes left by remove() and slots filled by add() are
//   both seen.
// * Selection. The deferred mode (and K9) selects nothing in the tile: each CTA
//   writes its 64·S accumulator entries a query, and merge_partials takes
//   each query's top-k over all its ranges' entries, one warp a query,
//   with every SM's warps at once. A selection at the end of each CTA
//   would hold its SM, with its memory idle, for as long as it selects
//   each query's top-k of its 64·S entries. Exact mode: after each tile
//   a score becomes a candidate only if it beats its query's
//   current k-th (score, id); each warp then takes its queries'
//   candidates, for k ≤ 32 into a list of 32 held one a lane (insertion
//   by ballot, or warp_merge32 for a batch), else through common.cuh's
//   selector; each CTA writes its top-k a query and merge_partials
//   reduces the ranges.
//
// Shapes the tile takes (ivf_tile_plan): bf16 or int8 slabs; D a multiple
// of 64 (a TMA box is 64 dims: 128-byte rows in the 128B swizzle, and
// wgmma steps 16 dims), up to what shared memory holds (512 at bf16); Mc
// a multiple of 4 (the ids' and scales' row pitch must be 16 bytes). D
// 384, the main path's, is taken.
//
// The same tile runs K1-opt emit_acc (ts_ivf_scan_emit_acc through
// ivf_tile_emit, the reference's _ivf_body with emit_acc,
// ivf.py:1212-1222): K1's deferred fold at (w, S), written raw in the
// reference's slot-major order, entry (query, slot s, lane class c) at
// part[(query · S + s) · w + c], with no merge pass (the caller selects);
// lane classes at or past w (the last range's rows past its lanes) are
// not written. K1-opt per_probe (ts_ivf_scan_per_probe through
// ivf_tile_per_probe, ivf.py:1130-1132, :1238-1240): the exact mode with
// one CTA a (query block, probe u), grid (blocks, U), whose walk is every
// 64-row tile of that one slab (a last tile of Mc % 64 rows offers only
// those), empty tiles skipped as K1 skips them; each query's top-k goes
// straight to out (U, B, k), with no merge pass: the CTA's selection is
// the probe's. A CTA a (block, range, probe) would load its queries for
// one tile; a CTA a (block, range) that wrote a top-k a probe would send
// U·B·ranges partial rows through device memory. And four scan modes of
// ivf_modes.cu's entries:
// * K9, the packed fold (ts_ivf_scan_packed through ivf_tile_packed,
//   _ivf_kernel_packed; bf16 slabs): K1's deferred fold at (w, S) with an
//   int32 packet an accumulator entry (common.cuh's pack_candidate: the
//   f32 accumulator's 14-bit score, the probe's index u in the walk, kept
//   beside each listed tile, and pos = chunk · w + range + row), folded by
//   an integer max or a max/min cascade (S ≤ 4; a dead slot's packet 0,
//   like a skipped tile's, changes neither); the CTA writes its 64·S
//   entries as (s14, 2^17 − 1 − low bits) pairs, which order as the
//   packets do, for the merge pass; the caller turns the winners back into
//   packets.
// * K11a, several probes a step (ts_ivf_scan_multiprobe, _ivf_kernel_
//   multiprobe), through ivf_k1_scan as K1's other shapes: K1's deferred
//   fold at width Mc with one slot over the probe list padded with its
//   last probe (re-folding a slab changes nothing under the strict >
//   fold), at the tile's own ring depth.
// * K10, the copy-ring scan (ts_ivf_scan_dma, text_similarity_tpu/index/
//   ivf.py _ivf_kernel_dma), likewise: K1's deferred fold at width Mc with
//   S slots, its ring depth the call's n_buffers (2-4), capped by what
//   shared memory holds beside the queries (3 stages at D 384).
// * K11b, the idless scan of the sentinel layout (ts_ivf_scan_idless,
//   _ivf_kernel_idless): bf16 rows of D + 1 columns, the last +2 on live
//   rows and 0 on dead ones; no ids are read: slot id = slab · Mc +
//   position and no slot is masked; one slot a lane class (S 1), width w.
//   - Copy. A row is 2(D + 1) bytes, not a multiple of 16, so no tensor
//     map spans the slabs; but 8 rows are, so a tile of 64 rows (fewer in
//     a last partial range) starts 16-byte aligned wherever Mc and w are
//     multiples of 8, and lands by one cp.async.bulk as raw bytes.
//   - Repack. Odd rows start 2 bytes past a word: fragments gathered from
//     the raw rows would conflict about 4-way (a row is 192.5 words) and
//     need two loads each, in both warpgroups. So the consumers first
//     rewrite the raw rows once, a warp a row, into the 128B-swizzled tile
//     that K1's SS product reads (consecutive words in, one swizzled
//     128-byte row out: no bank conflict), then run K1's product over D
//     dims. The last column's product q[D]·x[D] (both bf16: exact in f32)
//     is added after the dot, as K4 applies its scale, so the sum differs
//     from the reference's only in its order. The repack sits in the CTA's
//     critical path between the copy and the product, fenced by two
//     barriers of the consumer warpgroups a tile (the raw stage is free
//     after the first, the repacked tile after the second); it waits on
//     its loads' latency, so a warp issues all of a row's loads before its
//     stores. With the queries (48 KB at 64 × 384), the repacked tile (48
//     KB) and two raw stages (2 × 48.1 KB) the ring holds two stages.
//   - Skip. A dead slot is not −inf here: a never-written slot is a row of
//     zeros and scores exactly 0, which displaces −inf and any negative
//     entry of the fold; a removed slot keeps its vector and scores q·x.
//     So a tile is skipped only if all its rows are zero: a map with one
//     byte a (slab, 64-row tile), 1 where every row is zero (the index
//     keeps it beside the slabs), read in the liveness pass in place of
//     K1's ids. A skipped tile is not copied or multiplied: its constant 0
//     is folded, with its flat slot ids, in its place in the probe order
//     (an S-1 fold is a running max where a strictly greater score wins,
//     so the order decides among equal scores). Every row of such a tile
//     would score exactly ±0, which compares as 0: the answer is the one
//     the product gives. An optional counter adds (tiles of valid probes,
//     tiles skipped) for the caller.
//   Other sentinel shapes (f32, D not a multiple of 64, Mc or w not a
//   multiple of 8, S ≠ 1) stay on ivf_scan.cu's CUDA-core kernel.
#include "common.cuh"
#include "hopper.cuh"
#include "ivf_tile.cuh"

namespace {

constexpr int kTileM = 64;          // slab rows a tile (wgmma's M), lanes a CTA
constexpr int kWin = 512;           // tiles whose liveness one pass decides
constexpr int kMaxStages = 4;
constexpr int kMaxThreads = 2 * 128 + 32;
constexpr size_t kSmemBudget = 232448;

constexpr int kSentinel = 3;         // data kind of K11b's raw sentinel rows

// The slab type of K11b's tile: bf16 rows of D + 1 columns, read raw.
struct SentinelRows {};

// A ring stage: a tile and its ids (and scales); for K11b the raw rows.
// D counts the dot's dims (the sentinel rows hold one more).
size_t tile_stage_bytes(int kind, int D) {
  if (kind == kSentinel) return ((size_t)kTileM * (D + 1) * 2 + 127) / 128 * 128;
  const size_t data = (size_t)kTileM * D * (kind == 2 ? 1 : 2);
  return (data + (kind == 2 ? 512 : 256) + 1023) / 1024 * 1024;   // + ids (+ scales)
}

// The exact mode's state a query: selector list and buffer, a tile's
// candidates, and (n, k-th score, k-th id, candidate count)
__host__ __device__ size_t tile_epi_bytes(int nq, int kp) {
  return (size_t)nq * (16 * (size_t)kp + kTileM * 8 + 16);
}

// The exact mode keeps its selection beside the ring; the deferred mode
// keeps none (its entries go to the merge pass). K11b adds the repacked
// tile and the queries' last column.
size_t tile_smem(int kind, int D, int nq, int kp, int slots, int stages) {
  const size_t ring = (size_t)stages * tile_stage_bytes(kind, D);
  size_t body = slots == 0 ? ring + tile_epi_bytes(nq, kp) : ring;
  if (kind == kSentinel) body += (size_t)kTileM * D * 2 + (size_t)nq * 4;
  return 1024 + (size_t)nq * D * 2 + body + (size_t)kWin * 9 + 2 * kMaxStages * 8 + 16;
}

struct TileArgs {
  const float* q;
  const int* probes;
  const int* ids;
  float* part_s;
  int* part_i;
  const unsigned char* raw;    // K11b: the sentinel slabs
  const unsigned char* zero;   // K11b: 1 a (slab, 64-row tile) whose rows are all zero
  int* counts;                 // K11b, or null: += (tiles of valid probes, tiles skipped)
  int D, U, C_tot, Mc, block_q, k, kp, width, n_ranges, n_sub, nq, nwg, stages, stage_bytes;
  int n_mt;                    // 64-row tiles a slab (K11b's zero map; per_probe's walk)
  bool emit;                   // emit_acc: part_* are (B, S·width), slot-major; no merge
  bool per_probe;              // per_probe (exact mode): a CTA scans probe blockIdx.y alone
                               // and writes its top-k to part_* as (U, B, k); no merge
};
// At 136 bytes nvcc read these fields through a pointer into the parameter
// space, and ptxas serialised K11b's wgmma (C7520): 8% slower on the H100.
static_assert(sizeof(TileArgs) <= 128, "keep the tile's arguments within 128 bytes");

struct __align__(64) TileMaps {
  CUtensorMap data, ids, scales;
};

// Per-query selection state in shared memory (layout of tile_epi_bytes).
struct QuerySel {
  float* sel_f;   // nq × 2kp
  int* sel_i;
  float* cs;      // nq × 64
  int* ci;
  int* n;         // nq each
  float* ts;
  int* ti;
  int* cn;
  int kp, k;

  __device__ QuerySel(unsigned char* base, int nq, int kp_, int k_) : kp(kp_), k(k_) {
    sel_f = reinterpret_cast<float*>(base);
    sel_i = reinterpret_cast<int*>(sel_f + (size_t)nq * 2 * kp);
    cs = reinterpret_cast<float*>(sel_i + (size_t)nq * 2 * kp);
    ci = reinterpret_cast<int*>(cs + nq * kTileM);
    n = ci + nq * kTileM;
    ts = reinterpret_cast<float*>(n + nq);
    ti = reinterpret_cast<int*>(ts + nq);
    cn = ti + nq;
  }
  __device__ Selector at(int q) const {
    Selector s;
    s.ls = sel_f + (size_t)q * 2 * kp;
    s.bs = s.ls + kp;
    s.li = sel_i + (size_t)q * 2 * kp;
    s.bi = s.li + kp;
    s.kp = kp;
    s.k = k;
    s.n = n[q];
    s.ts = ts[q];
    s.ti = ti[q];
    return s;
  }
  __device__ void keep(int q, const Selector& s, int lane) const {
    __syncwarp();
    if (lane == 0) {
      n[q] = s.n;
      ts[q] = s.ts;
      ti[q] = s.ti;
      cn[q] = 0;
    }
    __syncwarp();
  }
  __device__ void init(int q, int lane) const {
    Selector s;
    sel_init(s, sel_f + (size_t)q * 2 * kp, sel_i + (size_t)q * 2 * kp, k, lane);
    keep(q, s, lane);
  }
};

// The 128 threads of warpgroup wg (named barrier wg + 1).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// B operand: queries n0 .. n0 + N − 1 of the nq-row query tile at k-step
// kk (sub-tiles of nq rows × 64 dims, 128-byte rows, 128B swizzle).
__device__ __forceinline__ uint64_t q_desc(const unsigned char* qs, int nq, int n0, int kk) {
  return make_desc(qs + (size_t)(kk >> 2) * nq * 128 + n0 * 128 + (kk & 3) * 32, 16, 1024, 64);
}

// acc = the 64 rows of a bf16 tile (D / 64 sub-tiles of 64 rows × 128
// bytes, 128B swizzle, as TMA lays them) · queries n0 .. n0 + N − 1: SS.
template <int N>
__device__ __forceinline__ void tile_dot(float (&acc)[N / 2], const unsigned char* tile,
                                         const unsigned char* qs, int nq, int n0, int D, int,
                                         int, const __nv_bfloat16*) {
  wgmma_fence();
  for (int j = 0; j < D / 64; ++j) {
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
      wgmma_ss<N, 0>(acc, make_desc(tile + j * (kTileM * 128) + kq * 32, 16, 1024, 64),
                     q_desc(qs, nq, n0, 4 * j + kq), (j | kq) != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The same over an int8 tile (D / 64 sub-tiles of 64 rows × 64 bytes, 64B
// swizzle: 16-byte piece c of row r at c ^ ((r >> 1) & 3)). This thread's
// A fragment of k-step kk holds rows R0 and R0 + 8, codes 16kk + 2t, +1
// and 16kk + 2t + 8, +9, each pair widened to bf16x2 (exact): RS. Two
// k-steps a group, D / 32 groups (even, as D % 64 == 0) in two register
// buffers: a group is widened while the one before it multiplies.
// Two int8 codes (the first in the low byte) → bf16x2, exactly, on the
// integer and FP32 pipes (through the conversion unit's I2F / F2F, some 16
// a clock an SM, the widening would bind K4): each code, biased by 128,
// becomes the low mantissa byte of 2^23 + u; one FADD removes 2^23 + 128;
// an f32 integer with |c| ≤ 128 has 16 zero low bits, so its high half is
// its bf16.
__device__ __forceinline__ uint32_t codes_to_bf16x2(unsigned w) {
  const unsigned x = w ^ 0x8080u;
  const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

__device__ __forceinline__ void widen_a(const unsigned char* tile, int g2, int R0, int t,
                                        uint32_t (&a)[2][4]) {
  const unsigned char* sub = tile + (g2 >> 1) * (kTileM * 64);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kq = 2 * (g2 & 1) + h;   // k-step within the 64-dim sub-tile
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = R0 + 8 * (e & 1);
      const int off = r * 64 + ((kq ^ ((r >> 1) & 3)) << 4) + 2 * t + 8 * (e >> 1);
      a[h][e] = codes_to_bf16x2(*reinterpret_cast<const unsigned short*>(sub + off));
    }
  }
}

template <int N>
__device__ __forceinline__ void rs_group(float (&acc)[N / 2], const uint32_t (&a)[2][4],
                                         const unsigned char* qs, int nq, int n0, int g2) {
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    wgmma_rs<N, 0>(acc, a[h], q_desc(qs, nq, n0, 2 * g2 + h), (g2 | h) != 0);
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void tile_dot(float (&acc)[N / 2], const unsigned char* tile,
                                         const unsigned char* qs, int nq, int n0, int D, int R0,
                                         int t, const int8_t*) {
  uint32_t a0[2][4], a1[2][4];
  widen_a(tile, 0, R0, t, a0);
  rs_group<N>(acc, a0, qs, nq, n0, 0);
  widen_a(tile, 1, R0, t, a1);
  rs_group<N>(acc, a1, qs, nq, n0, 1);
  for (int g2 = 2; g2 < D / 32; g2 += 2) {
    wgmma_wait<1>();   // group g2 − 2 is done with a0
    fence_regs(a0);
    widen_a(tile, g2, R0, t, a0);
    rs_group<N>(acc, a0, qs, nq, n0, g2);
    wgmma_wait<1>();
    fence_regs(a1);
    widen_a(tile, g2 + 1, R0, t, a1);
    rs_group<N>(acc, a1, qs, nq, n0, g2 + 1);
  }
  wgmma_wait<0>();
  fence_regs(a0);
  fence_regs(a1);
  fence_regs(acc);
}

// The liveness of 8 tiles of a window (tiles b0 .. b0 + 7): a warp reads
// their probes, then their ids (two per lane), then keeps whether any
// slot is live and each tile's (slab, row). Tile t of a CTA's walk is
// probe plist[t / chunks] at rows (t % chunks)·ww + r0 …, at most lanes of
// them and none past Mc (per_probe's last tile of a slab).
struct LiveGroup {
  static constexpr int kTiles = 8;
  int c[kTiles], v[kTiles][2];

  __device__ __forceinline__ void load(const TileArgs& a, const int* plist, int t0, int win,
                                       int b0, int chunks, int ww, int r0, int lanes, int lane) {
#pragma unroll
    for (int e = 0; e < kTiles; ++e) c[e] = b0 + e < win ? plist[(t0 + b0 + e) / chunks] : -1;
#pragma unroll
    for (int e = 0; e < kTiles; ++e) {
      const int row = ((t0 + b0 + e) % chunks) * ww + r0;
      const int n = min(lanes, a.Mc - row);
      v[e][0] = v[e][1] = -1;
      if (b0 + e < win && c[e] >= 0 && c[e] < a.C_tot) {   // other probe ids scan nothing
        const int* src = a.ids + (size_t)c[e] * a.Mc + row;
        if (2 * lane < n) v[e][0] = src[2 * lane];
        if (2 * lane + 1 < n) v[e][1] = src[2 * lane + 1];
      }
    }
  }
  __device__ __forceinline__ void store(int t0, int win, int b0, int chunks, int ww, int r0,
                                        int lane, int2* list, unsigned char* live) const {
#pragma unroll
    for (int e = 0; e < kTiles; ++e) {
      const bool any = __any_sync(0xffffffffu, v[e][0] >= 0 || v[e][1] >= 0);
      if (lane == 0 && b0 + e < win) {
        live[b0 + e] = any;
        list[b0 + e] = make_int2(c[e], ((t0 + b0 + e) % chunks) * ww + r0);
      }
    }
  }
};

// K11b's liveness of a window: each thread takes tiles b = tid, tid +
// blockDim, …; a probe outside [0, C_tot) leaves its tiles out (live 0);
// a tile whose rows lie in all-zero 64-row tiles of its slab is listed as
// (−1 − slab, row): folded as a constant 0, never copied.
__device__ __forceinline__ void idless_live(const TileArgs& a, int blk, int t0, int win,
                                            int chunks, int r0, int lanes, int2* list,
                                            unsigned char* live) {
  for (int b = threadIdx.x; b < win; b += blockDim.x) {
    const int c = a.probes[(size_t)blk * a.U + (t0 + b) / chunks];
    const int row = ((t0 + b) % chunks) * a.width + r0;
    const bool valid = c >= 0 && c < a.C_tot;
    bool zero = false;
    if (valid) {
      const unsigned char* z = a.zero + (size_t)c * a.n_mt;
      zero = z[row / kTileM] && z[(row + lanes - 1) / kTileM];
    }
    live[b] = valid;
    list[b] = make_int2(zero ? -1 - c : c, row);
  }
}

// K11b: rows 0 .. lanes − 1 of a raw stage (a row every 2(D + 1) bytes, so
// odd rows start 2 bytes past a word) → the swizzled K-major tile that
// tile_dot reads (D / 64 sub-tiles of 64 rows × 128 bytes, 16-byte piece c
// of row r at c ^ (r & 7), as TMA lays them), dims 0 .. D − 1. A warp takes
// a row: lane i reads word i of each sub-tile's span of the row (and word
// i + 1 where the row is 2 bytes off a word): consecutive words, so no two
// lanes share a bank; the funnel shift puts dims 2i, 2i + 1 in one word,
// and the warp writes one swizzled 128-byte row. All of a row's loads are
// issued before its stores (D ≤ 64 · kMaxSub): the repack waits on load
// latency, not on shared memory's bandwidth, so a load and a store a
// sub-tile in turn held K11b markedly longer.
constexpr int kMaxSub = 8;

__device__ __forceinline__ void repack_rows(const unsigned char* raw, unsigned char* swz, int D,
                                            int lanes, int cw, int n_cw, int lane) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(raw);
  const int n_sub = D / 64;
  for (int r = cw; r < lanes; r += n_cw) {
    const int b0 = r * 2 * (D + 1);
    const uint32_t* src = words + (b0 >> 2) + lane;
    unsigned char* dst = swz + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4;
    uint32_t v[kMaxSub];
    if (b0 & 2) {   // warp-uniform
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j)
        if (j < n_sub) v[j] = __funnelshift_r(src[32 * j], src[32 * j + 1], 16);
    } else {
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j)
        if (j < n_sub) v[j] = src[32 * j];
    }
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j)
      if (j < n_sub) *reinterpret_cast<uint32_t*>(dst + j * (kTileM * 128)) = v[j];
  }
}

// The consumer warpgroups together (named barrier 3; the producer warp is
// not in it).
__device__ __forceinline__ void cons_sync(int n_threads) {
  asm volatile("bar.sync 3, %0;\n" ::"r"(n_threads) : "memory");
}

// Exact mode, k ≤ 32: query ql's n candidates into its list of 32 (in
// shared memory between tiles, one entry a lane here), best first: a few
// by insertion at their rank, more by warp_merge32; then its k-th is
// published. The whole warp calls this.
__device__ __forceinline__ void push_list32(const QuerySel& sel, int ql, int n, int k, int lane) {
  constexpr int kInsertMax = 6;
  float* lf = sel.sel_f + (size_t)ql * 64;
  int* lid = sel.sel_i + (size_t)ql * 64;
  const float* cs = sel.cs + ql * kTileM;
  const int* ci = sel.ci + ql * kTileM;
  float ls = lf[lane];
  int li = lid[lane];
  if (n <= kInsertMax) {
    for (int c = 0; c < n; ++c) {
      const float s = cs[c];
      const int id = ci[c];
      const int pos = __popc(__ballot_sync(0xffffffffu, better(ls, li, s, id)));
      const float up_s = __shfl_up_sync(0xffffffffu, ls, 1);
      const int up_i = __shfl_up_sync(0xffffffffu, li, 1);
      if (lane == pos) {
        ls = s;
        li = id;
      } else if (lane > pos) {
        ls = up_s;
        li = up_i;
      }
    }
  } else {
    for (int b = 0; b < n; b += 32) {
      const bool has = b + lane < n;
      warp_merge32(ls, li, has ? cs[b + lane] : -INFINITY, has ? ci[b + lane] : 0x7fffffff, lane);
    }
  }
  const float ks = __shfl_sync(0xffffffffu, ls, k - 1);
  const int ki = __shfl_sync(0xffffffffu, li, k - 1);
  lf[lane] = ls;
  lid[lane] = li;
  if (lane == 0) {
    sel.ts[ql] = ks;
    sel.ti[ql] = ki;
    sel.cn[ql] = 0;
  }
  __syncwarp();
}

// Exact mode, k > 32: through common.cuh's selector.
__device__ __forceinline__ void push_selector(const QuerySel& sel, int ql, int n, int lane) {
  Selector s = sel.at(ql);
  for (int b = 0; b < n; b += 32) {
    const int c = b + lane;
    const bool has = c < n;
    sel_push(s, has, has ? sel.cs[ql * kTileM + c] : -INFINITY,
             has ? sel.ci[ql * kTileM + c] : -1, lane);
  }
  sel.keep(ql, s, lane);
}

// P: K9's packed fold (S ≥ 1): one int32 packet an accumulator entry.
template <typename T, int S, int N, bool P = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ivf_tile_kernel(const __grid_constant__ TileMaps maps, const TileArgs a) {
  constexpr bool kInt8 = std::is_same_v<T, int8_t>;
  constexpr bool kIdless = std::is_same_v<T, SentinelRows>;
  constexpr int kS = S > 0 ? S : 1;
  extern __shared__ __align__(1024) unsigned char ivf_tile_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_cons_warps = 4 * a.nwg;
  const int n_warps = n_cons_warps + 1;
  const int blk = blockIdx.x / a.n_sub, sub = blockIdx.x % a.n_sub;
  // the CTA's walk: its lane range of every chunk of every probe, in
  // order; per_probe: every 64-row tile of probe blockIdx.y's slab
  const bool pp = S == 0 && a.per_probe;
  const int range = pp ? 0 : blockIdx.y, r0 = range * kTileM;
  const int ww = pp ? kTileM : a.width;   // rows a chunk of the walk
  const int lanes = min(kTileM, ww - r0);
  const int qrow0 = blk * a.block_q + sub * a.nq;
  const int qn = min(a.nq, a.block_q - sub * a.nq);
  const int chunks = pp ? a.n_mt : a.Mc / a.width;
  const int n_tiles = (pp ? 1 : a.U) * chunks;
  const int* plist = a.probes + (size_t)blk * a.U + (pp ? blockIdx.y : 0);
  const int data_bytes = kIdless ? 0 : kTileM * a.D * (int)sizeof(T);
  const int row_bytes = 2 * (a.D + 1);   // K11b's raw rows

  unsigned char* qs = align_1024(ivf_tile_smem);
  unsigned char* swz = qs + (size_t)a.nq * a.D * 2;   // K11b: the repacked tile
  unsigned char* ring = swz + (kIdless ? (size_t)kTileM * a.D * 2 : 0);
  const size_t ring_bytes = (size_t)a.stages * a.stage_bytes;
  const size_t epi_bytes = tile_epi_bytes(a.nq, a.kp);
  unsigned char* epi = ring + ring_bytes;   // exact mode only
  float* qlast = reinterpret_cast<float*>(ring + ring_bytes);   // K11b: q[D] a query
  unsigned char* body_end =
      ring + ring_bytes + (S == 0 ? epi_bytes : 0) + (kIdless ? (size_t)a.nq * 4 : 0);
  int2* list = reinterpret_cast<int2*>(body_end);          // (slab, row) of a window's tiles
  unsigned char* live = reinterpret_cast<unsigned char*>(list + kWin);
  uint64_t* full = reinterpret_cast<uint64_t*>(live + kWin);
  uint64_t* empty = full + kMaxStages;
  int* n_live_s = reinterpret_cast<int*>(empty + kMaxStages);
  const QuerySel sel(epi, a.nq, a.kp, a.k);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_cons_warps);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  const int win0 = min(kWin, n_tiles);
  constexpr int kLive = LiveGroup::kTiles;
  LiveGroup grp;
  // K1 / K4: window 0's first liveness group is read while the queries load
  if constexpr (!kIdless) grp.load(a, plist, 0, win0, warp * kLive, chunks, ww, r0, lanes, lane);
  const int pieces = a.D / 8, n_pieces = a.nq * pieces;
  if constexpr (kIdless) {
    // rows of D + 1 floats (no 16-byte pitch): the first D dims rounded to
    // bf16 → the B operand, the last → qlast (zeros past qn)
    const int ldq = a.D + 1;
    for (int p = tid; p < n_pieces; p += blockDim.x) {
      const int qi = p / pieces, c = p % pieces;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = qi < qn ? __ldg(a.q + (size_t)(qrow0 + qi) * ldq + 8 * c + e) : 0.f;
      *reinterpret_cast<uint4*>(qs + (size_t)(c >> 3) * a.nq * 128 + qi * 128 +
                                (((c & 7) ^ (qi & 7)) << 4)) =
          make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]), pack_bf16x2(x[4], x[5]),
                     pack_bf16x2(x[6], x[7]));
    }
    for (int qi = tid; qi < a.nq; qi += blockDim.x)
      qlast[qi] = qi < qn ? round_bf16(__ldg(a.q + (size_t)(qrow0 + qi) * ldq + a.D)) : 0.f;
  } else {
    // the CTA's queries rounded to bf16 → the B operand (zeros past qn),
    // kQLoads pieces of 8 dims a thread in flight at once
    constexpr int kQLoads = 4;
    for (int p0 = tid; p0 < n_pieces; p0 += kQLoads * blockDim.x) {
      float4 x[kQLoads][2];
#pragma unroll
      for (int b = 0; b < kQLoads; ++b) {
        const int p = p0 + b * blockDim.x, qi = p / pieces;
        x[b][0] = x[b][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < n_pieces && qi < qn) {
          const float4* src = reinterpret_cast<const float4*>(
              a.q + (size_t)(qrow0 + qi) * a.D + 8 * (p % pieces));
          x[b][0] = __ldg(src);
          x[b][1] = __ldg(src + 1);
        }
      }
#pragma unroll
      for (int b = 0; b < kQLoads; ++b) {
        const int p = p0 + b * blockDim.x, qi = p / pieces, c = p % pieces;
        if (p >= n_pieces) break;
        *reinterpret_cast<uint4*>(qs + (size_t)(c >> 3) * a.nq * 128 + qi * 128 +
                                  (((c & 7) ^ (qi & 7)) << 4)) =
            make_uint4(pack_bf16x2(x[b][0].x, x[b][0].y), pack_bf16x2(x[b][0].z, x[b][0].w),
                       pack_bf16x2(x[b][1].x, x[b][1].y), pack_bf16x2(x[b][1].z, x[b][1].w));
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if constexpr (!kIdless) grp.store(0, win0, warp * kLive, chunks, ww, r0, lane, list, live);
  if constexpr (S == 0) {
    if (warp < n_cons_warps)
      for (int ql = warp; ql < a.nq; ql += n_cons_warps) sel.init(ql, lane);
  }
  __syncthreads();

  const bool producer = warp == n_cons_warps;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int n0 = wg * N;            // the warpgroup's first query
  const int R0 = wl * 16 + g;       // this thread's tile rows R0 and R0 + 8
  // accumulator entry p: row R0 + 8·((p >> 1) & 1), query n0 + 8·(p >> 2) + 2t + (p & 1)
  float acc[N / 2];
  float acc_s[N / 2][kS];
  int acc_i[N / 2][kS];
#pragma unroll
  for (int p = 0; p < N / 2; ++p)
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      acc_s[p][s] = -INFINITY;
      acc_i[p][s] = P ? 0 : -1;   // K9: packet 0, a dead slot's
    }
  float qd[N / 4];   // K11b: q[D] of this thread's queries, entry p at 2·(p >> 2) + (p & 1)
  if constexpr (kIdless) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) qd[2 * j + e] = qlast[n0 + 8 * j + 2 * t + e];
  }

  int it = 0;   // live tiles through the ring so far
  int n_listed = 0, n_zero = 0;   // K11b's counts (warp 0)
  for (int t0 = 0; t0 < n_tiles; t0 += kWin) {
    const int win = min(kWin, n_tiles - t0);
    if constexpr (kIdless) {
      idless_live(a, blk, t0, win, chunks, r0, lanes, list, live);
    } else {
      // liveness of the window's other groups (window 0's first: above)
      for (int b0 = warp * kLive + (t0 == 0 ? n_warps * kLive : 0); b0 < win;
           b0 += n_warps * kLive) {
        grp.load(a, plist, t0, win, b0, chunks, ww, r0, lanes, lane);
        grp.store(t0, win, b0, chunks, ww, r0, lane, list, live);
      }
    }
    __syncthreads();
    if (warp == 0) {   // keep the live (K11b: the listed) tiles, in order
      int n = 0;
      for (int b0 = 0; b0 < win; b0 += 32) {
        const int tt = b0 + lane;
        const bool on = tt < win && live[tt];
        const int2 cr = on ? list[tt] : make_int2(0, 0);
        const unsigned m = __ballot_sync(0xffffffffu, on);
        if constexpr (kIdless) n_zero += __popc(__ballot_sync(0xffffffffu, on && cr.x < 0));
        __syncwarp();
        if (on) {
          const int at = n + __popc(m & ((1u << lane) - 1u));
          list[at] = cr;
          // K9: live[at] (read above, before the warp's barrier) now holds
          // the tile's probe index u in the union
          if constexpr (P) live[at] = (unsigned char)((t0 + tt) / chunks);
        }
        n += __popc(m);
        __syncwarp();
      }
      if (lane == 0) *n_live_s = n;
      if constexpr (kIdless) n_listed += n;
    }
    __syncthreads();
    const int n_live = *n_live_s;

    if constexpr (kIdless) {
      // K11b: the listed tiles in order; an all-zero one (slab −1 − c) is
      // neither copied nor multiplied: its rows fold a constant 0
      if (producer) {
        if (lane == 0) {
          for (int i = 0; i < n_live; ++i) {
            const int2 cr = list[i];
            if (cr.x < 0) continue;
            const int st = it % a.stages;
            mbar_wait(&empty[st], ((it / a.stages) & 1) ^ 1);
            ++it;
            const uint32_t bytes = (uint32_t)lanes * row_bytes;
            unsigned char* sp = ring + (size_t)st * a.stage_bytes;
            mbar_arrive_expect_tx(&full[st], bytes);
            bulk_load(sp, a.raw + ((size_t)cr.x * a.Mc + cr.y) * row_bytes, bytes, &full[st]);
          }
        }
        __syncwarp();
      } else {
        for (int i = 0; i < n_live; ++i) {
          const int2 cr = list[i];
          // flat slot ids; rows past the range's lanes are never offered
          const int base = (cr.x < 0 ? -1 - cr.x : cr.x) * a.Mc + cr.y;
          int rid[2];
          rid[0] = R0 < lanes ? base + R0 : -1;
          rid[1] = R0 + 8 < lanes ? base + R0 + 8 : -1;
          if (cr.x >= 0) {
            const int st = it % a.stages;
            mbar_wait(&full[st], (it / a.stages) & 1);
            ++it;
            const unsigned char* sp = ring + (size_t)st * a.stage_bytes;
            float xl[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              xl[h] = rid[h] >= 0 ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                                        sp + (size_t)(R0 + 8 * h) * row_bytes + 2 * a.D))
                                  : 0.f;
            repack_rows(sp, swz, a.D, lanes, warp, n_cons_warps, lane);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            cons_sync(32 * n_cons_warps);   // the tile is repacked; the raw stage is read
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[st]);
            tile_dot<N>(acc, swz, qs, a.nq, n0, a.D, R0, t,
                        static_cast<const __nv_bfloat16*>(nullptr));
            cons_sync(32 * n_cons_warps);   // both products have read the repacked tile
#pragma unroll
            for (int p = 0; p < N / 2; ++p)   // the last column after the dot
              acc[p] = fmaf(qd[2 * (p >> 2) + (p & 1)], xl[(p >> 1) & 1], acc[p]);
          }
          // the fold (S 1), every row of the lanes offered
#pragma unroll
          for (int p = 0; p < N / 2; ++p) {
            const int di = rid[(p >> 1) & 1];
            const float ds = cr.x >= 0 ? acc[p] : 0.f;
            if (di >= 0 && ds > acc_s[p][0]) {
              acc_s[p][0] = ds;
              acc_i[p][0] = di;
            }
          }
        }
      }
    } else {
      if (producer) {
        if (lane == 0) {
          for (int i = 0; i < n_live; ++i) {
            const int st = (it + i) % a.stages;
            mbar_wait(&empty[st], (((it + i) / a.stages) & 1) ^ 1);
            unsigned char* sp = ring + (size_t)st * a.stage_bytes;
            const int2 cr = list[i];
            mbar_arrive_expect_tx(&full[st], data_bytes + (kInt8 ? 512 : 256));
            for (int j = 0; j < a.D / 64; ++j)
              tma_load_3d(sp + j * (kTileM * 64 * (int)sizeof(T)), &maps.data, &full[st], j * 64,
                          cr.y, cr.x);
            tma_load_2d(sp + data_bytes, &maps.ids, &full[st], cr.y, cr.x);
            if constexpr (kInt8)
              tma_load_2d(sp + data_bytes + 256, &maps.scales, &full[st], cr.y, cr.x);
          }
        }
        __syncwarp();
      } else {
        for (int i = 0; i < n_live; ++i) {
          const int st = (it + i) % a.stages;
          mbar_wait(&full[st], ((it + i) / a.stages) & 1);
          const unsigned char* sp = ring + (size_t)st * a.stage_bytes;
          const int* sid = reinterpret_cast<const int*>(sp + data_bytes);
          int rid[2];
          // rows past Mc (per_probe's last tile of a slab: TMA fills ids 0) are not offered
          const int tl = S == 0 ? min(lanes, a.Mc - list[i].y) : lanes;
          rid[0] = R0 < tl ? sid[R0] : -1;
          rid[1] = R0 + 8 < tl ? sid[R0 + 8] : -1;
          float rsc[2] = {1.f, 1.f};
          if constexpr (kInt8) {
            const float* ssc = reinterpret_cast<const float*>(sp + data_bytes + 256);
            rsc[0] = ssc[R0];
            rsc[1] = ssc[R0 + 8];
          }
          tile_dot<N>(acc, sp, qs, a.nq, n0, a.D, R0, t, static_cast<const T*>(nullptr));
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
          if constexpr (kInt8) {
  #pragma unroll
            for (int p = 0; p < N / 2; ++p) acc[p] *= rsc[(p >> 1) & 1];   // dot, then × scale
          }
          if constexpr (P) {
            // K9: the entry's packet (probe index u, position in the slab),
            // folded by an integer max, or a max/min cascade for S > 1; a
            // dead slot's packet 0 changes neither, so it is not offered
            const int ub = (int)live[i] << 11;
            const int pos = list[i].y + R0;
  #pragma unroll
            for (int p = 0; p < N / 2; ++p) {
              const int h = (p >> 1) & 1;
              if (rid[h] < 0) continue;
              int pk = pack_candidate(acc[p], 0, pos + 8 * h) | ub;
  #pragma unroll
              for (int s = 0; s < S; ++s) {
                const int hi = max(acc_i[p][s], pk);
                pk = min(acc_i[p][s], pk);
                acc_i[p][s] = hi;
              }
            }
          } else if constexpr (S > 0) {
            // the fold: a later entry displaces only on a strictly greater
            // score; an empty slot (−inf) never does, so it is not offered
  #pragma unroll
            for (int p = 0; p < N / 2; ++p) {
              int di = rid[(p >> 1) & 1];
              if (di < 0) continue;
              float ds = acc[p];
  #pragma unroll
              for (int s = 0; s < S; ++s) {
                if (ds > acc_s[p][s]) {
                  const float ts = acc_s[p][s];
                  const int ti = acc_i[p][s];
                  acc_s[p][s] = ds;
                  acc_i[p][s] = di;
                  ds = ts;
                  di = ti;
                }
              }
            }
          } else {
            // candidates: scores above their query's current k-th
  #pragma unroll
            for (int p = 0; p < N / 2; ++p) {
              const int ql = n0 + 8 * (p >> 2) + 2 * t + (p & 1);
              const int id = rid[(p >> 1) & 1];
              if (ql >= qn || id < 0) continue;
              if (better(acc[p], id, sel.ts[ql], sel.ti[ql])) {
                const int pos = atomicAdd(sel.cn + ql, 1);
                sel.cs[ql * kTileM + pos] = acc[p];
                sel.ci[ql * kTileM + pos] = id;
              }
            }
            wg_sync(wg);
            for (int ql = n0 + wl; ql < n0 + N && ql < qn; ql += 4) {
              const int n = sel.cn[ql];
              if (n == 0) continue;   // warp-uniform
              if (a.kp == 32)
                push_list32(sel, ql, n, a.k, lane);
              else
                push_selector(sel, ql, n, lane);
            }
            wg_sync(wg);
          }
        }
      }
      it += n_live;
    }
    __syncthreads();
  }
  if (producer) return;
  if constexpr (kIdless) {
    if (a.counts != nullptr && tid == 0) {
      atomicAdd(a.counts, n_listed);
      atomicAdd(a.counts + 1, n_zero);
    }
  }

  if constexpr (S > 0) {
    // the raw accumulator entries → part: (query, range, slot, lane), from
    // which the merge pass selects each query's top-k; or, for emit_acc,
    // (query, slot, lane class), only the range's lanes
    const size_t q_pitch = a.emit ? (size_t)S * a.width : (size_t)a.n_ranges * S * kTileM;
    const size_t base = a.emit ? (size_t)r0 : (size_t)range * S * kTileM;
    const size_t step = a.emit ? a.width : kTileM;
    const int rows = a.emit ? lanes : kTileM;
#pragma unroll
    for (int p = 0; p < N / 2; ++p) {
      const int ql = n0 + 8 * (p >> 2) + 2 * t + (p & 1);
      const int row = R0 + 8 * ((p >> 1) & 1);
      if (ql >= qn || row >= rows) continue;
      const size_t o = (size_t)(qrow0 + ql) * q_pitch + base + row;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if constexpr (P) {
          // K9: a packet as the merge's pair (s14, 2^17 − 1 − low bits),
          // which orders as the packets do; packet 0 → (−inf, −1)
          const int pk = acc_i[p][s];
          a.part_s[o + s * step] = pk > 0 ? (float)(pk >> 17) : -INFINITY;
          a.part_i[o + s * step] = pk > 0 ? kPackLow - (pk & kPackLow) : -1;
        } else {
          a.part_s[o + s * step] = acc_s[p][s];
          a.part_i[o + s * step] = acc_i[p][s];
        }
      }
    }
  } else {
    for (int ql = n0 + wl; ql < n0 + N && ql < qn; ql += 4) {
      Selector sl = sel.at(ql);
      if (a.kp != 32) sel_flush(sl, lane);   // a list of 32 is kept exact
      // per_probe: out (U, B, k), B = the grid's query blocks × block_q
      const size_t B = (size_t)(gridDim.x / a.n_sub) * a.block_q;
      const size_t o = pp ? (blockIdx.y * B + qrow0 + ql) * a.k
                          : ((size_t)(qrow0 + ql) * a.n_ranges + range) * a.k;
      for (int j = lane; j < a.k; j += 32) {
        a.part_s[o + j] = sl.ls[j];
        a.part_i[o + j] = sl.li[j];
      }
    }
  }
}

template <typename T, int S, int N, bool P>
cudaError_t launch_tile(const TileMaps& maps, const TileArgs& a, dim3 grid, size_t smem,
                        cudaStream_t st) {
  const auto kernel = ivf_tile_kernel<T, S, N, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128 * a.nwg + 32, smem, st>>>(maps, a);
  return cudaGetLastError();
}

template <typename T, int S, bool P = false>
cudaError_t launch_n(const TileMaps& maps, const TileArgs& a, dim3 grid, size_t smem,
                     cudaStream_t st) {
  return a.nq == 64 ? launch_tile<T, S, 32, P>(maps, a, grid, smem, st)
                    : launch_tile<T, S, 8, P>(maps, a, grid, smem, st);
}

// What a tile launch computes; only the named entries below set a mode
// other than kTileMerge.
enum TileMode : int {
  kTileMerge = 0,     // K1 / K4 / K10 / K11a / K11b: the tile, then the merge of the ranges
  kTileEmit = 1,      // emit_acc (ivf_tile_emit): the raw fold, slot-major; no merge
  kTilePerProbe = 2,  // per_probe (ivf_tile_per_probe): one probe a CTA → (U, B, k); no merge
  kTilePacked = 3,    // K9 (ivf_tile_packed): the packed fold, then the merge of the ranges
};

template <typename T>
cudaError_t run_tile(const IvfTilePlan& plan, const float* q, const int* probes, const T* data,
                     const float* scales, const int* ids, const unsigned char* zero, int* counts,
                     int B, int D, int U, int C_tot, int Mc, int block_q, int k, int width,
                     int slots, int mode, float* part_s, int* part_i, float* out_s,
                     int* out_i, cudaStream_t st) {
  constexpr bool kInt8 = std::is_same_v<T, int8_t>;
  constexpr bool kIdless = std::is_same_v<T, SentinelRows>;
  TileMaps maps{};
  cudaError_t err = cudaSuccess;
  if constexpr (!kIdless) {
    const cuuint64_t ddims[3] = {(cuuint64_t)D, (cuuint64_t)Mc, (cuuint64_t)C_tot};
    const cuuint64_t dstrides[2] = {(cuuint64_t)D * sizeof(T), (cuuint64_t)Mc * D * sizeof(T)};
    const cuuint32_t dbox[3] = {64, kTileM, 1};
    err = tiled_map(&maps.data,
                    kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                    data, ddims, dstrides, dbox,
                    kInt8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
    const cuuint64_t idims[2] = {(cuuint64_t)Mc, (cuuint64_t)C_tot};
    const cuuint64_t istrides[1] = {(cuuint64_t)Mc * 4};
    const cuuint32_t ibox[2] = {kTileM, 1};
    if (err == cudaSuccess)
      err = tiled_map(&maps.ids, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, ids, idims, istrides, ibox,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
    maps.scales = maps.ids;   // read only with int8 slabs
    if (err == cudaSuccess && kInt8)
      err = tiled_map(&maps.scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, idims, istrides,
                      ibox, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  TileArgs a;
  a.q = q;
  a.probes = probes;
  a.ids = ids;
  a.part_s = part_s;
  a.part_i = part_i;
  a.raw = reinterpret_cast<const unsigned char*>(data);
  a.zero = zero;
  a.counts = counts;
  a.D = D;
  a.U = U;
  a.C_tot = C_tot;
  a.Mc = Mc;
  a.block_q = block_q;
  a.k = k;
  a.kp = host_kp_for(k);
  a.width = width;
  a.n_ranges = (width + kTileM - 1) / kTileM;
  a.n_sub = (block_q + plan.nq - 1) / plan.nq;
  a.nq = plan.nq;
  a.nwg = plan.nwg;
  a.stages = plan.stages;
  a.stage_bytes = (int)tile_stage_bytes(kIdless ? kSentinel : kInt8 ? 2 : 1, D);
  a.n_mt = (Mc + kTileM - 1) / kTileM;
  a.emit = mode == kTileEmit;
  a.per_probe = mode == kTilePerProbe;
  // range-major: range 0 of every query block first (the heaviest CTAs);
  // per_probe: a CTA a (query block, probe)
  const dim3 grid((B / block_q) * a.n_sub, a.per_probe ? U : a.n_ranges);
  if constexpr (kIdless) {
    err = launch_n<T, 1>(maps, a, grid, plan.smem, st);
  } else if (mode == kTilePacked) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {   // K9: bf16 slabs, as the reference
      switch (slots) {
        case 1: err = launch_n<T, 1, true>(maps, a, grid, plan.smem, st); break;
        case 2: err = launch_n<T, 2, true>(maps, a, grid, plan.smem, st); break;
        case 3: err = launch_n<T, 3, true>(maps, a, grid, plan.smem, st); break;
        case 4: err = launch_n<T, 4, true>(maps, a, grid, plan.smem, st); break;
        default: return cudaErrorInvalidValue;
      }
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    switch (slots) {
      case 0: err = launch_n<T, 0>(maps, a, grid, plan.smem, st); break;
      case 1: err = launch_n<T, 1>(maps, a, grid, plan.smem, st); break;
      case 2: err = launch_n<T, 2>(maps, a, grid, plan.smem, st); break;
      case 3: err = launch_n<T, 3>(maps, a, grid, plan.smem, st); break;
      case 4: err = launch_n<T, 4>(maps, a, grid, plan.smem, st); break;
      default: return cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess || a.emit || a.per_probe) return err;
  return launch_merge_rows(part_s, part_i, B, a.n_ranges * (slots ? slots * kTileM : k), k,
                           out_s, out_i, st);
}

}  // namespace

// Queries a CTA: the block's (8, 16 or 64), fewer where shared memory
// cannot hold the selection state beside the ring; two stages to
// max_stages (0: kMaxStages), as many as shared memory holds.
bool ivf_tile_plan(int data_kind, int D, int Mc, int block_q, int k, int width, int slots,
                   int max_stages, IvfTilePlan* plan) {
  if (data_kind < 1 || data_kind > kSentinel) return false;
  if (block_q < 1 || width < 1 || Mc % width) return false;
  if (k < 1 || k > kMaxK || slots < 0 || slots > 4) return false;
  if (data_kind == kSentinel) {
    // D + 1 columns; 16-byte aligned tiles of 8-row multiples; one slot
    --D;
    if (Mc % 8 || width % 8 || slots != 1 || D > 64 * kMaxSub) return false;
  } else if (Mc % 4) {
    return false;
  }
  if (D < 64 || D % 64) return false;
  const int kp = host_kp_for(k);
  const int top = max_stages > 0 ? (max_stages < kMaxStages ? max_stages : kMaxStages) : kMaxStages;
  int nq = block_q <= 8 ? 8 : block_q <= 16 ? 16 : 64;
  for (;;) {
    int stages = top;
    while (stages >= 2 && tile_smem(data_kind, D, nq, kp, slots, stages) > kSmemBudget) --stages;
    if (stages >= 2) {
      plan->nq = nq;
      plan->nwg = nq == 8 ? 1 : 2;
      plan->n = nq / plan->nwg;
      plan->stages = stages;
      plan->smem = tile_smem(data_kind, D, nq, kp, slots, stages);
      return true;
    }
    if (nq == 8) return false;
    nq = nq == 64 ? 16 : 8;
  }
}

namespace {

int tile_scan(int data_kind, const float* q, const int* probes, const void* data,
              const float* scales, const int* ids, const unsigned char* zero_tiles, int* counts,
              int B, int D, int U, int C_tot, int Mc, int block_q, int k, int width, int slots,
              int max_stages, int mode, float* part_s, int* part_i, float* out_s, int* out_i,
              void* stream) {
  IvfTilePlan plan;
  if (!ivf_tile_plan(data_kind, D, Mc, block_q, k, width, slots, max_stages, &plan))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (data_kind == kSentinel) {
    if (reinterpret_cast<uintptr_t>(data) % 16) return (int)cudaErrorMisalignedAddress;
    return (int)run_tile(plan, q, probes, static_cast<const SentinelRows*>(data), nullptr,
                         nullptr, zero_tiles, counts, B, D - 1, U, C_tot, Mc, block_q, k, width,
                         slots, mode, part_s, part_i, out_s, out_i, st);
  }
  if (data_kind == 2)
    return (int)run_tile(plan, q, probes, static_cast<const int8_t*>(data), scales, ids, nullptr,
                         nullptr, B, D, U, C_tot, Mc, block_q, k, width, slots, mode, part_s,
                         part_i, out_s, out_i, st);
  return (int)run_tile(plan, q, probes, static_cast<const __nv_bfloat16*>(data), nullptr, ids,
                       nullptr, nullptr, B, D, U, C_tot, Mc, block_q, k, width, slots, mode,
                       part_s, part_i, out_s, out_i, st);
}

}  // namespace

int ivf_tile_scan(int data_kind, const float* q, const int* probes, const void* data,
                  const float* scales, const int* ids, const unsigned char* zero_tiles,
                  int* counts, int B, int D, int U, int C_tot, int Mc, int block_q, int k,
                  int width, int slots, int max_stages, float* part_s, int* part_i,
                  float* out_s, int* out_i, void* stream) {
  if (!out_s || !out_i) return (int)cudaErrorInvalidValue;
  return tile_scan(data_kind, q, probes, data, scales, ids, zero_tiles, counts, B, D, U, C_tot,
                   Mc, block_q, k, width, slots, max_stages, kTileMerge, part_s, part_i, out_s,
                   out_i, stream);
}

int ivf_tile_emit(int data_kind, const float* q, const int* probes, const void* data,
                  const float* scales, const int* ids, int B, int D, int U, int C_tot, int Mc,
                  int block_q, int width, int slots, float* out_s, int* out_i, void* stream) {
  if (data_kind != 1 && data_kind != 2) return (int)cudaErrorInvalidValue;
  if (slots < 1 || !out_s || !out_i) return (int)cudaErrorInvalidValue;
  return tile_scan(data_kind, q, probes, data, scales, ids, nullptr, nullptr, B, D, U, C_tot, Mc,
                   block_q, 1, width, slots, 0, kTileEmit, out_s, out_i, nullptr, nullptr, stream);
}

int ivf_tile_per_probe(int data_kind, const float* q, const int* probes, const void* data,
                       const float* scales, const int* ids, int B, int D, int U, int C_tot,
                       int Mc, int block_q, int k, float* out_s, int* out_i, void* stream) {
  if (data_kind != 1 && data_kind != 2) return (int)cudaErrorInvalidValue;
  if (!out_s || !out_i) return (int)cudaErrorInvalidValue;
  return tile_scan(data_kind, q, probes, data, scales, ids, nullptr, nullptr, B, D, U, C_tot, Mc,
                   block_q, k, Mc, 0, 0, kTilePerProbe, out_s, out_i, nullptr, nullptr, stream);
}

int ivf_tile_packed(const float* q, const int* probes, const void* data, const int* ids, int B,
                    int D, int U, int C_tot, int Mc, int block_q, int k, int width, int slots,
                    float* part_s, int* part_i, float* out_s, int* out_i, void* stream) {
  if (U > 64 || Mc > 2048 || slots < 1 || !out_s || !out_i) return (int)cudaErrorInvalidValue;
  return tile_scan(1, q, probes, data, nullptr, ids, nullptr, nullptr, B, D, U, C_tot, Mc,
                   block_q, k, width, slots, 0, kTilePacked, part_s, part_i, out_s, out_i, stream);
}

// The plan the scan entry points take for a shape: 1 and out = (nq, nwg,
// n, stages, shared bytes) where the wgmma tile runs, 0 where a CUDA-core
// kernel runs (data_kind 0 f32, 1 bf16, 2 int8, 3 bf16 sentinel rows of D
// columns scanned without ids; max_stages the ring depth asked for, 0 for
// the tile's own).
extern "C" int ts_ivf_scan_tile_plan(int data_kind, int D, int Mc, int block_q, int k,
                                     int width, int slots, int* out, int max_stages) {
  IvfTilePlan plan;
  if (!ivf_tile_plan(data_kind, D, Mc, block_q, k, width, slots, max_stages, &plan)) return 0;
  out[0] = plan.nq;
  out[1] = plan.nwg;
  out[2] = plan.n;
  out[3] = plan.stages;
  out[4] = (int)plan.smem;
  return 1;
}
