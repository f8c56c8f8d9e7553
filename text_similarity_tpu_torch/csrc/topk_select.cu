// Exact top-k at any k: the large-k route of K2, K3, K8 and the IVF scans.
//
// The selectors of topk.cu, topk_2pass.cu and ivf_tile.cu keep 2·kp
// (score, id) pairs a query in shared memory, so they stop at k = 256
// (MAX_K in ops/topk.py). Above that every caller takes this route; it
// gives what the reference's k merge rounds give: the top k by (score desc,
// id asc), the lowest id first among equal scores.
//
// Replaces, for k > 256, the selection of text_similarity_tpu/ops/topk.py
// cosine_topk_pallas → _topk_kernel (:307; k rounds of _exact_merge_rounds,
// :109, inside _merge_block_topk, :137), of cosine_topk_pallas_int8 →
// _topk_int8_kernel (:617), the k merge rounds of cosine_topk_pallas_2pass
// (:416), and the merge of text_similarity_tpu/index/ivf.py
// _ivf_query_pallas (:1945).
//
// The select (ts_topk_select) of R rows of n values. Its bound on the H100
// is one read of the rows and one write of the answer: at R 256 × n 100,003
// f32, 102.4 MB, 0.031 ms at 3.35 TB/s. The design reads a row about once:
//  * Keys and digits. Each value's order-preserving uint32 key (−0 taken as
//    +0). The first digit is the key's top 12 bits (sign, exponent, three
//    mantissa bits: eighths of an octave), so a cosine row spreads over
//    tens of bins and the bin of its k-th score holds a few hundred to a
//    few thousand of 100,003 values.
//  * Count (hist_rows): CTAs (row, slice) count their slice's first digits
//    in shared memory and add them to the row's histogram in the
//    workspace. K2 and K3 skip it: their score writer counts as it writes.
//  * Cut. Every later CTA finds, from the row's histogram, the bin in which
//    the k-th largest falls (a block scan from the top): the keys above it
//    are winners, those in it candidates, one range of keys. Where that
//    bin holds more than kCap, refine_rows counts the next 10 bits of its
//    values (another read of those rows only) and the cut narrows to their
//    bin.
//  * Compact (compact_rows, the one full read): CTAs (row, slice) test each
//    key against the cut's range (one warp vote where none is a hit, most
//    of a row), gather the winners and the candidates with their ids in a
//    warp's own slots of shared memory, and move them to the answer and to
//    the row's kCap slots of the workspace (one atomic a batch of up to 256).
//  * Finish (finish_rows, one CTA a row): where the winners and the
//    candidates together sort no longer than the k would, one sort of them
//    all and the first k out; else the candidates into shared memory, the
//    `need` largest of them by an 8-bit radix select of the key bits below
//    those the cut's keys share, and where the k-th key is tied beyond
//    what is still wanted, a radix select over the tied ids; the gather,
//    the k-th pair as often as it is still wanted (equal pairs are the same
//    entry), padding (−inf, −1), then the sort. Where the cut still holds
//    more than kCap (a row of one repeated value), the same select runs
//    over the row in device memory, filtered by the cut: 4 to 8 more reads.
//  * Sort, by one 64-bit key (the value's key, then the id's inverted):
//    each warp sorts its 32·E entries in registers (a bitonic network,
//    shuffles across lanes), then merge paths merge the warps' runs in
//    shared memory, a thread E outputs a level, up to 4,096 entries; past
//    that sort_runs in runs of 4,096 and merge passes over device memory.
//  * Spread: the passes run one wave of at most 5·132 CTAs, slices of at
//    least 4,096 values (a row of 100,003 over up to 25 SMs); the choice
//    (pass_slices) lives here. Reads are 16-byte loads, 4 in flight a
//    thread.
// Measured on an H100 (PERF.md §6, tools/topk_ab.py --large-k): the count
// and the compaction each stream at 2.1-2.5 TB/s; at k 4096 the finish's
// sort and merges take about half of its time.
//
// K2's and K3's score writer (score_rows, ts_topk_large): the score tile of
// score_tile.cuh writes every score (K3: × the row's scale) to a (Qc, ld)
// f32 buffer, K2's and K3's bits exactly; each tile's scores are staged in
// shared memory and stored a query's 128 rows by a warp as float4s (whole
// 32-byte sectors). Beside it the tile counts each query's first digits in
// shared memory (256 bins over positive scores in [2^-31, 2), clamped at
// both ends; two 16-bit counters a word), added to the row's histogram at
// the CTA's end, so the select starts at its cut and reads the scores once.
// Bound: the tile's 2·Q·N·D f32 operations (0.29 ms at Q 256 × N 100,003 ×
// D 384 at 67 TFLOP/s); the score write and read, 0.031 ms each, lie
// beneath it.
//
// With int_keys the values are int32 bits (K9's packets, unique but for
// the dead slots' 0) compared as ints, and rows with fewer than k
// candidates pad with 0: the same kernels, another key.
//
// Rows may be segmented: element e of row r lies at r·row_stride +
// (e / seg_len)·seg_stride + e % seg_len, so the IVF scan's (U, B, Mc)
// per-probe scores are read as B rows of U·Mc candidates in place. ids
// (optional) share the scores' layout; without them an element's id is its
// position e (the corpus row for K2 and K3, lax.top_k's order elsewhere).
#include <algorithm>

#include "score_tile.cuh"

namespace {

constexpr int kSelThreads = 512;    // finish_rows, sort_runs
constexpr int kPassThreads = 256;   // hist_rows, refine_rows, compact_rows
constexpr int kPassPerSM = 5;       // pass CTAs an SM holds
constexpr int kPassCTAs = kPassPerSM * 132;   // the passes' CTAs at most: one wave on an H100
constexpr int kSliceMin = 4096;     // values a pass CTA takes, at least
constexpr int kBins1 = 4096;        // the first digit: key bits 31..20
constexpr int kBins2 = 1024;        // the second: key bits 19..10 (a clamped bin: 31..22)
constexpr int kScoreBase = 0xB00;   // the score writer's first digit: (key >> 20) − 0xB00,
constexpr int kScoreBins = 256;     //   clamped to [0, 256): positive scores in [2^-31, 2)
constexpr int kMaxRun = 65408;      // score rows a CTA counts in 16 bits (511 tiles)
constexpr int kRadix = 256;         // the finish's radix digit
constexpr int kCap = 8192;          // candidates a row keeps (workspace, shared memory)
constexpr int kSortRun = 4096;      // entries a CTA sorts in shared memory
constexpr int kMergeThreads = 256;
constexpr int kVisit = 4;           // 16-byte loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

// The rows' layout (see the header): n = whole segments of seg_len.
struct RowView {
  const float* s;
  const int* ids;   // nullptr: the id is the position
  long long row_stride, seg_stride;
  int seg_len;
  __device__ __forceinline__ int id(long long at, int e) const { return ids ? ids[at] : e; }
};

// Elements [e0, e1) of row r, all threads of the CTA in step: f(ok, e,
// value, at) with the element's position e and address at; ok is false
// past the range (f is still called: its warp votes). A segment's piece is
// read as 16-byte loads, kVisit in flight a thread (a warp's lanes on
// neighbouring ones), between a head and a tail of up to 3 values.
template <class F>
__device__ __forceinline__ void visit(const RowView& v, int r, int e0, int e1, F f) {
  const int t = threadIdx.x;
  for (int e = e0; e < e1;) {
    const int sg = e / v.seg_len;
    const int end = min(e1, (sg + 1) * v.seg_len);
    // element x of segment sg lies at base + x
    const long long base =
        (long long)r * v.row_stride + (long long)sg * (v.seg_stride - v.seg_len);
    const int head = min(end - e, (int)((4 - ((base + e) & 3)) & 3));
    if (head > 0) {
      const bool ok = t < head;
      f(ok, e + t, ok ? v.s[base + e + t] : 0.f, base + e + t);
    }
    const int b0 = e + head, n4 = (end - b0) >> 2;
    const float4* p4 = reinterpret_cast<const float4*>(v.s + base + b0);
    for (int q0 = 0; q0 < n4; q0 += kVisit * (int)blockDim.x) {
      float4 x[kVisit];
#pragma unroll
      for (int j = 0; j < kVisit; ++j) {
        const int q = q0 + j * blockDim.x + t;
        x[j] = q < n4 ? __ldg(p4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kVisit; ++j) {
        const int q = q0 + j * blockDim.x + t;
        const bool ok = q < n4;
        const int o = b0 + 4 * q;
        f(ok, o, x[j].x, base + o);
        f(ok, o + 1, x[j].y, base + o + 1);
        f(ok, o + 2, x[j].z, base + o + 2);
        f(ok, o + 3, x[j].w, base + o + 3);
      }
    }
    const int t0 = b0 + 4 * n4;   // the tail
    if (t0 < end) {
      const bool ok = t0 + t < end;
      f(ok, t0 + t, ok ? v.s[base + t0 + t] : 0.f, base + t0 + t);
    }
    e = end;
  }
}

__device__ __forceinline__ int slice_begin(int n, int s, int slices) {
  return (int)((long long)n * s / slices);
}

// The order-preserving key of a score: larger score, larger key; −0 and +0
// one key, as they compare equal.
__device__ __forceinline__ unsigned score_key(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}
// ids ascending as unsigned keys
__device__ __forceinline__ unsigned id_key(int id) { return (unsigned)id ^ 0x80000000u; }

// A value's key and back: a score's, or int32 bits' (int_keys)
template <bool kInt>
__device__ __forceinline__ unsigned value_key(float v) {
  return kInt ? id_key(__float_as_int(v)) : score_key(v);
}
template <bool kInt>
__device__ __forceinline__ float key_value(unsigned key) {
  return kInt ? __int_as_float((int)(key ^ 0x80000000u)) : key_score(key);
}
// (value desc, id asc)
template <bool kInt>
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  if (kInt) {
    const int x = __float_as_int(a), y = __float_as_int(b);
    return x > y || (x == y && ia < ib);
  }
  return better(a, ia, b, ib);
}

// The first digit of a key: its top 12 bits less base, clamped to [0,
// bins) (base 0 and 4096 bins clamp nothing; the score writer's 256 clamp
// both ends). Within a first-digit bin, the second: the next 10 bits, or
// for a clamped end bin, whose keys share no prefix, the top 10.
struct Digits {
  int base, bins;
  __device__ __forceinline__ int first(unsigned key) const {
    return min(max((int)(key >> 20) - base, 0), bins - 1);
  }
  __device__ __forceinline__ int second(unsigned key, int b1) const {
    const bool clamped = bins < kBins1 && (b1 == 0 || b1 == bins - 1);
    return clamped ? (int)(key >> 22) : (int)((key >> 10) & (kBins2 - 1));
  }
};

// Where a row's k-th largest falls: the first-digit bin b1 and, where that
// bin held more than kCap values, the second-digit bin b2 within it (else
// −1); `above` values lie above the cut, `count` in it. Either is one range
// of keys, [lo, hi) (hi up to 2^32), whose first `known` bits all its keys
// share.
struct Cut {
  int b1, b2, above, count;
  unsigned long long lo, hi;
  int known;
  // 1: above the cut (a winner), 0: in it (a candidate), −1: below
  __device__ __forceinline__ int place(unsigned key) const {
    return key >= hi ? 1 : key >= lo ? 0 : -1;
  }
};

// The workspace, which the wrapper allocates (ops/topk.py _select_work
// mirrors the layout): a row's two counters (winners, candidates written;
// four ints, so that every part stays 16-byte aligned),
// its second- and first-digit histograms (zeroed before the passes, in
// this order, adjacent), its min(n, kCap) candidates as (key, id), and
// past one sort run the merge passes' second buffer.
struct Work {
  int* counts;      // (R, 4): winners, candidates written, two unused
  int* hist2;       // (R, kBins2)
  int* hist1;       // (R, kBins1); the score writer's (R, kScoreBins)
  int2* cand;       // (R, cap)
  float* tmp_s;     // (R, k) past kSortRun, else nullptr
  int* tmp_i;
  int cap;
};

inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// The bytes of the rows' zeroed head: counters and histograms
inline size_t zeroed_bytes(int R, int bins1) { return (size_t)R * (4 + kBins2 + bins1) * 4; }

// → the workspace's bytes; fills w when base is not null
inline size_t work_layout(int R, int n, int k, unsigned char* base, Work* w) {
  const size_t rows = (size_t)R;
  const int cap = std::max(1, std::min(n, kCap));
  size_t off = align16(zeroed_bytes(R, kBins1));
  const size_t cand = off;
  off += rows * cap * 8;
  size_t tmp_s = 0, tmp_i = 0;
  if (k > kSortRun) {
    tmp_s = off = align16(off);
    off += rows * k * 4;
    tmp_i = off = align16(off);
    off += rows * k * 4;
  }
  if (base != nullptr) {
    w->counts = reinterpret_cast<int*>(base);
    w->hist2 = w->counts + rows * 4;
    w->hist1 = w->hist2 + rows * kBins2;
    w->cand = reinterpret_cast<int2*>(base + cand);
    w->tmp_s = k > kSortRun ? reinterpret_cast<float*>(base + tmp_s) : nullptr;
    w->tmp_i = k > kSortRun ? reinterpret_cast<int*>(base + tmp_i) : nullptr;
    w->cap = cap;
  }
  return off;
}

struct ScanShared {
  int warp_sum[32];
  int bin, above, count;
};

// The bin of hist[0, nb) at which the count from the largest bin reaches
// want (1 ≤ want ≤ the total) → (bin, the count in larger bins, its own),
// in every thread's hands. Every thread calls it (it holds barriers); a
// thread takes nb / blockDim ≤ kScanPer bins, read once into registers.
constexpr int kScanPer = 16;

__device__ void find_bin(const int* __restrict__ hist, int nb, int want, ScanShared& sh, int& bin,
                         int& above, int& count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = max(1, nb / (int)blockDim.x);
  const int top = nb - threadIdx.x * per;   // this thread's bins: [top − per, top), down
  int c[kScanPer];
  int own = 0;
  if (per % 4 == 0) {   // 16-byte aligned runs of bins
#pragma unroll
    for (int j = 0; j < kScanPer; j += 4) {
      int4 x = make_int4(0, 0, 0, 0);
      if (j < per) x = *reinterpret_cast<const int4*>(hist + top - j - 4);
      c[j] = x.w;
      c[j + 1] = x.z;
      c[j + 2] = x.y;
      c[j + 3] = x.x;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) c[j] = j < per && top - 1 - j >= 0 ? hist[top - 1 - j] : 0;
  }
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) own += c[j];
  int incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) sh.warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < (int)(blockDim.x >> 5) ? sh.warp_sum[lane] : 0;
    int x = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += o;
    }
    sh.warp_sum[lane] = x - w;   // the warps before this one
  }
  __syncthreads();
  incl += sh.warp_sum[warp];
  const int excl = incl - own;
  if (excl < want && want <= incl) {   // exactly one thread
    int acc = excl, b = 0, a = 0, cnt = 0;
    bool done = false;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      if (!done && want <= acc + c[j]) {
        b = j;
        a = acc;
        cnt = c[j];
        done = true;
      }
      acc += c[j];
    }
    sh.bin = top - 1 - b;
    sh.above = a;
    sh.count = cnt;
  }
  __syncthreads();
  bin = sh.bin;
  above = sh.above;
  count = sh.count;
  __syncthreads();   // read by all before a later call writes them again
}

// Row r's cut for its kk = min(k, n) ≥ 1 largest.
__device__ Cut row_cut(const Work& w, const Digits& dg, int r, int kk, ScanShared& sh) {
  Cut c;
  find_bin(w.hist1 + (size_t)r * dg.bins, dg.bins, kk, sh, c.b1, c.above, c.count);
  // a clamped end bin reaches to the end of the keys
  c.lo = c.b1 == 0 ? 0ull : (unsigned long long)(c.b1 + dg.base) << 20;
  c.hi = c.b1 == dg.bins - 1 ? 1ull << 32 : (unsigned long long)(c.b1 + dg.base + 1) << 20;
  c.b2 = -1;
  if (c.count > kCap) {
    int above2;
    find_bin(w.hist2 + (size_t)r * kBins2, kBins2, kk - c.above, sh, c.b2, above2, c.count);
    c.above += above2;
    if (dg.bins < kBins1 && (c.b1 == 0 || c.b1 == dg.bins - 1)) {   // the top 10 bits
      c.lo = max(c.lo, (unsigned long long)c.b2 << 22);
      c.hi = min(c.hi, (unsigned long long)(c.b2 + 1) << 22);
    } else {   // the 10 bits below the first digit
      c.hi = c.lo + ((unsigned long long)(c.b2 + 1) << 10);
      c.lo += (unsigned long long)c.b2 << 10;
    }
  }
  const unsigned diff = (unsigned)c.lo ^ (unsigned)(c.hi - 1);
  c.known = diff ? __clz(diff) : 32;
  return c;
}

// Adds a CTA's shared-memory counts to a histogram in device memory.
__device__ __forceinline__ void flush_counts(const int* h, int nb, int* __restrict__ g) {
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    if (h[b]) atomicAdd(&g[b], h[b]);
}

// Count: CTA (row, slice) → the row's first-digit histogram.
template <bool kInt>
__global__ void __launch_bounds__(kPassThreads, kPassPerSM)
hist_rows(RowView v, int n, Digits dg, int* __restrict__ hist1) {
  __shared__ int h[kBins1];
  for (int b = threadIdx.x; b < dg.bins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int r = blockIdx.x;
  visit(v, r, slice_begin(n, blockIdx.y, gridDim.y), slice_begin(n, blockIdx.y + 1, gridDim.y),
        [&](bool ok, int, float x, long long) {
          if (ok) atomicAdd(&h[dg.first(value_key<kInt>(x))], 1);
        });
  flush_counts(h, dg.bins, hist1 + (size_t)r * dg.bins);
}

// Refine: where the bin of a row's k-th holds more than kCap values, CTA
// (row, slice) counts their second digits; other rows return at once.
template <bool kInt>
__global__ void __launch_bounds__(kPassThreads, kPassPerSM)
refine_rows(RowView v, int n, int k, Digits dg, Work w) {
  __shared__ int h[kBins2];
  __shared__ ScanShared ss;
  const int r = blockIdx.x;
  const int kk = min(k, n);
  if (kk == 0) return;
  int b1, above, count;
  find_bin(w.hist1 + (size_t)r * dg.bins, dg.bins, kk, ss, b1, above, count);
  if (count <= kCap) return;
  for (int b = threadIdx.x; b < kBins2; b += blockDim.x) h[b] = 0;
  __syncthreads();
  visit(v, r, slice_begin(n, blockIdx.y, gridDim.y), slice_begin(n, blockIdx.y + 1, gridDim.y),
        [&](bool ok, int, float x, long long) {
          const unsigned key = value_key<kInt>(x);
          if (ok && dg.first(key) == b1) atomicAdd(&h[dg.second(key, b1)], 1);
        });
  flush_counts(h, kBins2, w.hist2 + (size_t)r * kBins2);
}

// A warp's slots for the lanes in m among `counter`'s next ones.
__device__ __forceinline__ int warp_slot(unsigned m, int* counter) {
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int slot = 0;
  if (lane == leader) slot = atomicAdd(counter, __popc(m));
  return __shfl_sync(kFull, slot, leader) + __popc(m & ((1u << lane) - 1u));
}

// Compact: CTA (row, slice) → the winners of its slice to the answer (out
// row r from 0), its candidates to the row's slots (where they fit). Each
// warp gathers its own in kWarpHeld (key, id) slots of shared memory
// (winners from the front, candidates from the back; its lanes agree on
// the counts by their votes, so no atomic), and moves them out when the
// next element could overfill them: a slot range of the row's by one
// atomic a warp and kind.
constexpr int kWarpHeld = 256;

// A warp's held winners (held[0, fw)) to the answer and candidates
// (held[kWarpHeld − fc, kWarpHeld)) to the row's slots. Kept out of line:
// the visit's loop calls it from each of its unrolled elements.
template <bool kInt>
__device__ __noinline__ void move_out(const int2* held, int fw, int fc, int* cnt, float* os,
                                      int* oi, int2* cd) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  int bw = 0, bc = 0;
  if (lane == 0) {
    if (fw) bw = atomicAdd(cnt, fw);
    if (fc) bc = atomicAdd(cnt + 1, fc);
  }
  bw = __shfl_sync(kFull, bw, 0);
  bc = __shfl_sync(kFull, bc, 0);
  for (int j = lane; j < fw; j += 32) {
    os[bw + j] = key_value<kInt>((unsigned)held[j].x);
    oi[bw + j] = held[j].y;
  }
  for (int j = lane; j < fc; j += 32) cd[bc + j] = held[kWarpHeld - 1 - j];
  __syncwarp();
}

template <bool kInt>
__global__ void __launch_bounds__(kPassThreads)
compact_rows(RowView v, int n, int k, Digits dg, Work w, float* __restrict__ out_s,
             int* __restrict__ out_i) {
  __shared__ int2 held_all[kPassThreads / 32 * kWarpHeld];
  __shared__ ScanShared ss;
  const int r = blockIdx.x, lane = threadIdx.x & 31;
  const int kk = min(k, n);
  if (kk == 0) return;
  const Cut cut = row_cut(w, dg, r, kk, ss);
  const bool keep = cut.count <= kCap;
  int* cnt = w.counts + (size_t)r * 4;
  float* os = out_s + (size_t)r * k;
  int* oi = out_i + (size_t)r * k;
  int2* cd = w.cand + (size_t)r * w.cap;
  int2* held = held_all + (threadIdx.x >> 5) * kWarpHeld;
  int fw = 0, fc = 0;   // the warp's winners and candidates held
  visit(v, r, slice_begin(n, blockIdx.y, gridDim.y), slice_begin(n, blockIdx.y + 1, gridDim.y),
        [&](bool ok, int e, float x, long long at) {
          const unsigned key = value_key<kInt>(x);
          const int p = ok ? cut.place(key) : -1;
          const bool win = p > 0, cand = keep && p == 0;
          if (!__any_sync(kFull, win || cand)) return;   // most of a row
          const unsigned mw = __ballot_sync(kFull, win), mc = __ballot_sync(kFull, cand);
          if (fw + fc + __popc(mw) + __popc(mc) > kWarpHeld) {
            move_out<kInt>(held, fw, fc, cnt, os, oi, cd);
            fw = fc = 0;
          }
          const int2 entry = make_int2((int)key, win || cand ? v.id(at, e) : 0);
          const unsigned below = (1u << lane) - 1u;
          if (win) held[fw + __popc(mw & below)] = entry;
          if (cand) held[kWarpHeld - 1 - fc - __popc(mc & below)] = entry;
          fw += __popc(mw);
          fc += __popc(mc);
        });
  if (fw + fc) move_out<kInt>(held, fw, fc, cnt, os, oi, cd);
}

struct SelectShared {
  int hist[kRadix];
  int bin, need, count;   // the scan's answer: digit, still wanted, its count
  int pos;                // the gather's next slot
};

// Warp 0 finds the digit at which the running count (from the largest
// digit when `largest`, else from the smallest) reaches sh.need; every
// thread must call it (it ends on a barrier).
__device__ __forceinline__ void scan_bins(SelectShared& sh, bool largest) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int b[8], c[8], own = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b[j] = largest ? kRadix - 1 - (lane * 8 + j) : lane * 8 + j;
      c[j] = sh.hist[b[j]];
      own += c[j];
    }
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    const int need = sh.need;
    const int excl = incl - own;
    if (excl < need && need <= incl) {   // exactly one lane
      int rem = need - excl;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (rem <= c[j]) {
          sh.bin = b[j];
          sh.need = rem;
          sh.count = c[j];
          break;
        }
        rem -= c[j];
      }
    }
  }
  __syncthreads();
}

// The want-th largest (or smallest) selection key among the elements of
// src that sel admits, 8 bits a pass below the first `known` bits, which
// every admitted key shares with `prefix` → (key, how many of the want are
// equal to it, how many admitted elements are equal to it). want ≥ 1 and
// at most the admitted count. src.each(f) calls f(ok, key, at, e) on every
// element, all threads in step; sel(key, at, e, skey) → admitted.
template <class Src, class Sel>
__device__ void radix_select(SelectShared& sh, const Src& src, int want, bool largest, Sel sel,
                             int known, unsigned prefix, unsigned* out_key, int* out_need,
                             int* out_count) {
  unsigned mask = known ? ~0u << (32 - known) : 0u;
  prefix &= mask;
  if (threadIdx.x == 0) sh.need = want;
  for (int top = 32 - known; top > 0; top -= 8) {
    const int shift = max(top - 8, 0);
    const unsigned digit = (1u << (top - shift)) - 1u;
    for (int b = threadIdx.x; b < kRadix; b += blockDim.x) sh.hist[b] = 0;
    __syncthreads();
    src.each([&](bool ok, unsigned key, long long at, int e) {
      unsigned skey = 0;
      if (ok && sel(key, at, e, skey) && (skey & mask) == prefix)
        atomicAdd(&sh.hist[(skey >> shift) & digit], 1);
    });
    __syncthreads();
    scan_bins(sh, largest);
    prefix |= (unsigned)sh.bin << shift;
    mask |= digit << shift;
    *out_need = sh.need;
    *out_count = sh.count;
    __syncthreads();   // read by all before thread 0 or the next scan writes them again
  }
  *out_key = prefix;
}

// A row's candidates in shared memory: count (key, id) pairs.
struct SmemSource {
  const int2* c;
  int count;
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int j0 = 0; j0 < count; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      const bool ok = j < count;
      f(ok, ok ? (unsigned)c[j].x : 0u, (long long)j, 0);
    }
  }
  __device__ __forceinline__ int id(long long at, int) const { return c[at].y; }
};

// A row's candidates read in place: the elements in its cut.
template <bool kInt>
struct RowSource {
  RowView v;
  int r, n;
  Cut cut;
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    visit(v, r, 0, n, [&](bool ok, int e, float x, long long at) {
      const unsigned key = value_key<kInt>(x);
      f(ok && cut.place(key) == 0, key, at, e);
    });
  }
  __device__ __forceinline__ int id(long long at, int e) const { return v.id(at, e); }
};

// The `need` largest of src by (value desc, id asc) → os / oi [0, need),
// unsorted; 1 ≤ need ≤ src's count.
template <bool kInt, class Src>
__device__ void select_into(SelectShared& sh, const Src& src, const Cut& cut, int need, float* os,
                            int* oi) {
  unsigned t_key = 0, t_id = 0;
  int need1 = 0, count1 = 0;
  radix_select(sh, src, need, true, [](unsigned key, long long, int, unsigned& s) {
    s = key;
    return true;
  }, cut.known, (unsigned)cut.lo, &t_key, &need1, &count1);
  const bool all_ties = need1 == count1;   // every element at the k-th key is wanted
  int need2 = 0;
  if (!all_ties) {
    int unused;
    radix_select(sh, src, need1, false, [&](unsigned key, long long at, int e, unsigned& s) {
      if (key != t_key) return false;
      s = id_key(src.id(at, e));
      return true;
    }, 0, 0u, &t_id, &need2, &unused);
  }
  if (threadIdx.x == 0) sh.pos = 0;
  __syncthreads();
  src.each([&](bool ok, unsigned key, long long at, int e) {
    bool take = false;
    int id = 0;
    if (ok && key >= t_key) {
      id = src.id(at, e);
      take = key > t_key || all_ties || id_key(id) < t_id;
    }
    const unsigned m = __ballot_sync(kFull, take);
    if (m == 0) return;
    const int slot = warp_slot(m, &sh.pos);
    if (take) {
      os[slot] = key_value<kInt>(key);
      oi[slot] = id;
    }
  });
  // the k-th pair as often as it is still wanted
  for (int j = need - need2 + threadIdx.x; j < need; j += blockDim.x) {
    os[j] = key_value<kInt>(t_key);
    oi[j] = (int)(t_id ^ 0x80000000u);
  }
}

// (value desc, id asc) as one descending 64-bit key: the value's key, then
// the id's key inverted.
__device__ __forceinline__ unsigned long long pair_key(unsigned key, int id) {
  return (unsigned long long)key << 32 | (unsigned)~id_key(id);
}
__device__ __forceinline__ int pair_id(unsigned long long p) {
  return (int)(~(unsigned)p ^ 0x80000000u);
}

// One bitonic stage within a thread's E registers (partner j ^ S).
template <int E, int S>
__device__ __forceinline__ void stage_in_thread(unsigned long long (&v)[E], int i0, int size) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if ((j & S) == 0) {
      const unsigned long long x = v[j], y = v[j | S];
      if (((i0 + j) & size) == 0 ? x < y : x > y) {   // runs alternate: descending first
        v[j] = y;
        v[j | S] = x;
      }
    }
  }
}

// Sorts each warp's run of 32·E entries of a (a[32·E·w, 32·E·(w + 1)))
// descending in registers: lane l holds entries [E·l, E·l + E); a bitonic
// stage of stride below E runs in them, a wider one by shuffles.
template <int E>
__device__ void warp_sort_desc(unsigned long long* a) {
  const int lane = threadIdx.x & 31, i0 = E * lane;
  unsigned long long* run = a + (threadIdx.x >> 5) * 32 * E;
  unsigned long long v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = run[i0 + j];
  for (int size = 2; size <= 32 * E; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < E) {
        if (stride == 1) stage_in_thread<E, 1>(v, i0, size);
        if constexpr (E > 2) if (stride == 2) stage_in_thread<E, (E > 2 ? 2 : 1)>(v, i0, size);
        if constexpr (E > 4) if (stride == 4) stage_in_thread<E, (E > 4 ? 4 : 1)>(v, i0, size);
        continue;
      }
      // the lower of a descending pair, or the upper of an ascending one,
      // keeps the larger (the same for all of a lane's entries)
      const bool larger = ((i0 & stride) == 0) == ((i0 & size) == 0);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const unsigned long long y = __shfl_xor_sync(kFull, v[j], stride / E);
        v[j] = larger == (v[j] > y) ? v[j] : y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) run[i0 + j] = v[j];
}

// Merges the descending runs of `run` entries of a[0, E·blockDim) pairwise
// until one remains, through b, equal entries of a left run first: thread t
// writes outputs [E·t, E·t + E) of its pair of runs, from where a binary
// search on its diagonal puts them (a merge path), one entry a step. → a
// or b, whichever holds the result.
__device__ unsigned long long* merge_runs(unsigned long long* a, unsigned long long* b, int e,
                                          int run) {
  const int p = e * blockDim.x, g = e * threadIdx.x;
  for (; run < p; run <<= 1) {
    const int pair0 = g / (2 * run) * (2 * run), d = g - pair0;
    const unsigned long long* left = a + pair0;
    const unsigned long long* right = left + run;
    int lo = max(0, d - run), hi = min(d, run);   // left entries among the first d
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (left[mid] >= right[d - mid - 1])
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = d - lo;
    for (int o = 0; o < e; ++o) {
      const bool take_left = j >= run || (i < run && left[i] >= right[j]);
      b[g + o] = take_left ? left[i++] : right[j++];
    }
    __syncthreads();
    unsigned long long* t = a;
    a = b;
    b = t;
  }
  return a;
}

// Sorts a[0, p) descending, p = max(p2, blockDim) (p2 a power of two ≤
// 8·blockDim; entries past the caller's are 0, after every real one): the
// warps' runs in registers, then the merges through b (p entries). Every
// thread calls it. → a or b, whichever holds the result.
__device__ unsigned long long* sort_desc(unsigned long long* a, unsigned long long* b, int p2) {
  const int e = p2 / (int)blockDim.x;
  if (e >= 8)
    warp_sort_desc<8>(a);
  else if (e >= 4)
    warp_sort_desc<4>(a);
  else if (e >= 2)
    warp_sort_desc<2>(a);
  else
    warp_sort_desc<1>(a);
  __syncthreads();
  const int ee = e >= 8 ? 8 : e >= 4 ? 4 : e >= 2 ? 2 : 1;
  return merge_runs(a, b, ee, 32 * ee);
}

// Sorts s / ids [0, len) by (value desc, id asc) in place through shared
// memory (smem: 2·max(p2, blockDim) entries of 8 bytes, p2 = pow2 ≥ len).
// Every thread calls it.
template <bool kInt>
__device__ void sort_block(float* s, int* ids, int len, int p2, unsigned char* smem) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(smem);
  const int p = max(p2, (int)blockDim.x);
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    a[j] = j < len ? pair_key(value_key<kInt>(s[j]), ids[j]) : 0ull;   // after every entry
  __syncthreads();
  a = sort_desc(a, a + p, p2);
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    s[j] = key_value<kInt>((unsigned)(a[j] >> 32));
    ids[j] = pair_id(a[j]);
  }
}

// Finish: one CTA a row → its top k in out row r (winners already at [0,
// above)), then padding, then (p2 > 0) sorted.
template <bool kInt>
__global__ void __launch_bounds__(kSelThreads)
finish_rows(RowView v, int n, int k, Digits dg, Work w, float* __restrict__ out_s,
            int* __restrict__ out_i, int p2) {
  extern __shared__ __align__(16) unsigned char fin_smem[];
  __shared__ SelectShared sh;
  __shared__ ScanShared ss;
  const int r = blockIdx.x;
  const int kk = min(k, n);
  float* os = out_s + (size_t)r * k;
  int* oi = out_i + (size_t)r * k;
  if (kk > 0) {
    const Cut cut = row_cut(w, dg, r, kk, ss);
    const int need = kk - cut.above;
    const int total = cut.above + cut.count;
    // one sort of the winners and candidates where it is no longer than the
    // sort of the k that the select would leave (within a sort run)
    const int fits = p2 > 0 ? max(p2, (int)blockDim.x) : kSortRun;
    if (cut.count <= kCap && total <= fits) {
      // the first kk of the sorted winners and candidates out
      int t2 = 2;
      while (t2 < total) t2 <<= 1;
      unsigned long long* a = reinterpret_cast<unsigned long long*>(fin_smem);
      const int2* cd = w.cand + (size_t)r * w.cap;
      for (int j = threadIdx.x; j < max(t2, (int)blockDim.x); j += blockDim.x) {
        unsigned long long x = 0ull;
        if (j < cut.above)
          x = pair_key(value_key<kInt>(os[j]), oi[j]);
        else if (j < total)
          x = pair_key((unsigned)cd[j - cut.above].x, cd[j - cut.above].y);
        a[j] = x;
      }
      __syncthreads();
      a = sort_desc(a, a + max(t2, (int)blockDim.x), t2);
      for (int j = threadIdx.x; j < kk; j += blockDim.x) {
        os[j] = key_value<kInt>((unsigned)(a[j] >> 32));
        oi[j] = pair_id(a[j]);
      }
      p2 = 0;   // sorted
    } else if (cut.count <= kCap) {
      int2* c = reinterpret_cast<int2*>(fin_smem);
      const int2* src = w.cand + (size_t)r * w.cap;
      for (int j = threadIdx.x; j < cut.count; j += blockDim.x) c[j] = src[j];
      __syncthreads();
      select_into<kInt>(sh, SmemSource{c, cut.count}, cut, need, os + cut.above,
                        oi + cut.above);
    } else {
      select_into<kInt>(sh, RowSource<kInt>{v, r, n, cut}, cut, need, os + cut.above,
                        oi + cut.above);
    }
  }
  for (int j = kk + threadIdx.x; j < k; j += blockDim.x) {
    os[j] = kInt ? 0.f : -INFINITY;   // int_keys: the bits of 0
    oi[j] = -1;
  }
  if (p2 > 0) {
    __syncthreads();   // the row's entries, this CTA's included, visible to all its threads
    sort_block<kInt>(os, oi, k, p2, fin_smem);
  }
}

// Sorts each run of `run` entries of a row (the last may be shorter) in
// place; p2 = pow2 ≥ min(run, k).
template <bool kInt>
__global__ void __launch_bounds__(kSelThreads)
sort_runs(float* __restrict__ s, int* __restrict__ ids, int k, int run, int p2) {
  extern __shared__ __align__(16) unsigned char sort_smem[];
  const size_t base = (size_t)blockIdx.x * k + (size_t)blockIdx.y * run;
  sort_block<kInt>(s + base, ids + base, min(run, k - (int)blockIdx.y * run), p2, sort_smem);
}

// One merge pass: sorted runs of `run` → runs of 2·run, src → dst. An
// element's place is its rank in its run plus the entries of the partner
// run before it: strictly better for the left run, better or equal for
// the right one, so equal entries keep the left run's first.
template <bool kInt>
__global__ void __launch_bounds__(kMergeThreads)
merge_pass(const float* __restrict__ src_s, const int* __restrict__ src_i, int k, int run,
           float* __restrict__ dst_s, int* __restrict__ dst_i) {
  const int j = blockIdx.y * kMergeThreads + threadIdx.x;
  if (j >= k) return;
  const size_t row = (size_t)blockIdx.x * k;
  const float s = src_s[row + j];
  const int id = src_i[row + j];
  const int ri = j / run, start = ri * run;
  const int ps = (ri ^ 1) * run;
  if (ps >= k) {
    dst_s[row + j] = s;
    dst_i[row + j] = id;
    return;
  }
  const int plen = min(run, k - ps);
  const bool left = (ri & 1) == 0;
  int lo = 0, hi = plen;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float os = src_s[row + ps + mid];
    const int oi = src_i[row + ps + mid];
    const bool before = left ? ahead<kInt>(os, oi, s, id) : !ahead<kInt>(s, id, os, oi);
    if (before)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int to = min(start, ps) + (j - start) + lo;
  dst_s[row + to] = s;
  dst_i[row + to] = id;
}

// The passes' slices a row: at most kPassCTAs CTAs in all (one wave),
// kSliceMin values a CTA at least.
inline int pass_slices(int R, int n) {
  const int by_rows = kPassCTAs / R;
  const int by_len = (n + kSliceMin - 1) / kSliceMin;
  return std::max(1, std::min(std::min(by_rows, by_len), 65535));
}

// The select after its zeroing (and, when `counted`, the first-digit
// histogram already written).
template <bool kInt>
cudaError_t run_select(const RowView& v, int R, int n, int k, const Digits& dg, bool counted,
                       const Work& w, float* out_s, int* out_i, cudaStream_t st) {
  const int runs = (k + kSortRun - 1) / kSortRun;
  int passes = 0;
  while ((1 << passes) < runs) ++passes;
  // the winners land where the last merge pass leaves them in out
  float* ws = passes % 2 ? w.tmp_s : out_s;
  int* wi = passes % 2 ? w.tmp_i : out_i;
  const dim3 grid(R, pass_slices(R, n));
  if (!counted) hist_rows<kInt><<<grid, kPassThreads, 0, st>>>(v, n, dg, w.hist1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  refine_rows<kInt><<<grid, kPassThreads, 0, st>>>(v, n, k, dg, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  compact_rows<kInt><<<grid, kPassThreads, 0, st>>>(v, n, k, dg, w, ws, wi);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int run = runs > 1 ? kSortRun : k;
  int p2 = 2;
  while (p2 < run) p2 <<= 1;
  // the candidates (≤ kCap), or a sort run's entries and the merges' second
  // buffer, 8 bytes each
  const size_t fin_smem = (size_t)std::max(kCap * 8, kSortRun * 16),
               sort_smem = (size_t)std::max(p2, kSelThreads) * 16;
  err = cudaFuncSetAttribute(finish_rows<kInt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fin_smem);
  if (err != cudaSuccess) return err;
  finish_rows<kInt><<<R, kSelThreads, fin_smem, st>>>(v, n, k, dg, w, ws, wi,
                                                      runs > 1 ? 0 : p2);
  if ((err = cudaGetLastError()) != cudaSuccess || runs == 1) return err;
  err = cudaFuncSetAttribute(sort_runs<kInt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sort_smem);
  if (err != cudaSuccess) return err;
  sort_runs<kInt><<<dim3(R, runs), kSelThreads, sort_smem, st>>>(ws, wi, k, run, p2);
  err = cudaGetLastError();
  for (int p = 0, len = run; p < passes && err == cudaSuccess; ++p, len *= 2) {
    float* ds = ws == out_s ? w.tmp_s : out_s;
    int* di = wi == out_i ? w.tmp_i : out_i;
    merge_pass<kInt><<<dim3(R, (k + kMergeThreads - 1) / kMergeThreads), kMergeThreads, 0, st>>>(
        ws, wi, k, len, ds, di);
    err = cudaGetLastError();
    ws = ds;
    wi = di;
  }
  return err;
}

// The shared memory of score_rows: the copy ring, then the tile's scores
// staged a query's row of kTileRows (+ 4 floats) at a time, then each
// query's kScoreBins first-digit counts, two 16-bit counters a word.
constexpr int kStagedStride = kTileRows + 4;

template <typename T, int QT>
struct ScoreRowsSmem {
  static constexpr int kStaged = ScoreTile<T, QT>::kRingBytes;
  static constexpr int kCounts = kStaged + QT * kStagedStride * 4;
  static constexpr int kBytes = kCounts + QT * (kScoreBins / 2) * 4;
};

// K2's and K3's scores: CTA (query tile, corpus split) → scores (Q, ld),
// rows [0, N) of each query's row (K3: × the row's scale), and each
// query's first-digit counts added to hist (Q, kScoreBins). A split holds
// at most kMaxRun rows.
template <typename T, int QT>
__global__ void __launch_bounds__(kTileThreads, 1)
score_rows(const float* __restrict__ q, const T* __restrict__ corpus,
           const float* __restrict__ scales, int Q, int N, int D, int rows_per_split,
           float* __restrict__ scores, int ld, int* __restrict__ hist) {
  using S = ScoreTile<T, QT>;
  using L = ScoreRowsSmem<T, QT>;
  extern __shared__ __align__(16) unsigned char rows_smem[];
  float* staged = reinterpret_cast<float*>(rows_smem + L::kStaged);
  unsigned* counts = reinterpret_cast<unsigned*>(rows_smem + L::kCounts);
  const int qg = S::qg_of(threadIdx.x), rg = S::rg_of(threadIdx.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int n_tiles = (row_end - row_begin + kTileRows - 1) / kTileRows;
  const Digits dg{kScoreBase, kScoreBins};
  for (int i = threadIdx.x; i < QT * (kScoreBins / 2); i += kTileThreads) counts[i] = 0;
  __syncthreads();
  auto tile_of = [&](int t) {
    const int row0 = row_begin + t * kTileRows;
    return make_int2(row0, min(kTileRows, row_end - row0));
  };
  // (the ring's step barriers lie between two tiles' epilogues, so the
  // staged scores of the last are read before the next writes them)
  auto epi = [&](int t, float (&acc)[S::RM][S::QN]) {
    const int row0 = row_begin + t * kTileRows;
    const int nv = min(kTileRows, row_end - row0);
#pragma unroll
    for (int i = 0; i < S::RM; ++i) {
      const int r = rg + S::RG * i;
      float sc = 1.f;
      if constexpr (std::is_same_v<T, int8_t>) sc = r < nv ? scales[row0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < S::QN; ++j) {
        const int ql = qg + S::QG * j;
        float x = acc[i][j];
        if constexpr (std::is_same_v<T, int8_t>) x *= sc;   // K3: the dot, then the scale
        staged[ql * kStagedStride + r] = x;
        if (r < nv && q0 + ql < Q) {
          const int b = dg.first(score_key(x));
          atomicAdd(&counts[ql * (kScoreBins / 2) + (b >> 1)], 1u << (16 * (b & 1)));
        }
      }
    }
    __syncthreads();
    // a warp a query: the tile's 128 scores as 32 float4, whole sectors
    for (int ql = warp; ql < QT && q0 + ql < Q; ql += kTileWarps) {
      const int r = 4 * lane;
      const float4 x = *reinterpret_cast<const float4*>(staged + ql * kStagedStride + r);
      float* dst = scores + (size_t)(q0 + ql) * ld + row0 + r;
      if (r + 4 <= nv) {
        *reinterpret_cast<float4*>(dst) = x;
      } else {
        if (r < nv) dst[0] = x.x;
        if (r + 1 < nv) dst[1] = x.y;
        if (r + 2 < nv) dst[2] = x.z;
      }
    }
  };
  score_tiles<T, QT>(q, Q, q0, corpus, D, n_tiles, tile_of, epi, rows_smem);
  __syncthreads();
  for (int i = threadIdx.x; i < QT * (kScoreBins / 2); i += kTileThreads) {
    const int ql = i / (kScoreBins / 2);
    const unsigned c = counts[i];
    if (c == 0 || q0 + ql >= Q) continue;
    int* g = hist + (size_t)(q0 + ql) * kScoreBins + 2 * (i % (kScoreBins / 2));
    if (c & 0xffffu) atomicAdd(g, (int)(c & 0xffffu));
    if (c >> 16) atomicAdd(g + 1, (int)(c >> 16));
  }
}

template <typename T, int QT>
cudaError_t launch_score_rows(const float* q, const T* corpus, const float* scales, int Q, int N,
                              int D, int splits, int rows_per_split, float* scores, int ld,
                              int* hist, cudaStream_t st) {
  const size_t smem = ScoreRowsSmem<T, QT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(score_rows<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  score_rows<T, QT><<<dim3((Q + QT - 1) / QT, splits), kTileThreads, smem, st>>>(
      q, corpus, scales, Q, N, D, rows_per_split, scores, ld, hist);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_score_rows(const float* q, const T* corpus, const float* scales, int Q, int N,
                           int D, int splits, int rows_per_split, float* scores, int ld,
                           int* hist, cudaStream_t st) {
  switch (qt_for(Q, 1)) {
    case 16:
      return launch_score_rows<T, 16>(q, corpus, scales, Q, N, D, splits, rows_per_split,
                                      scores, ld, hist, st);
    case 64:
      return launch_score_rows<T, 64>(q, corpus, scales, Q, N, D, splits, rows_per_split,
                                      scores, ld, hist, st);
    default:
      return launch_score_rows<T, 128>(q, corpus, scales, Q, N, D, splits, rows_per_split,
                                       scores, ld, hist, st);
  }
}

}  // namespace

// The top k of each of R rows of n candidates → out_s / out_i (R, k),
// sorted by (score desc, id asc). Element e of row r at r·row_stride +
// (e / seg_len)·seg_stride + e % seg_len of scores (and of ids, or its id
// is e when ids is NULL). work: work_bytes ≥ the layout's (ops/topk.py
// _select_work). Rows with fewer than k candidates pad with (−inf, −1).
// int_keys: the values are int32 bits, compared as ints, padded with 0.
extern "C" int ts_topk_select(const float* scores, const int* ids, int R, int n, int seg_len,
                              long long seg_stride, long long row_stride, int k, float* out_s,
                              int* out_i, void* work, long long work_bytes, int int_keys,
                              void* stream) {
  if (seg_len < 1 || n < 0 || n % seg_len || R < 0 || k < 1 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  Work w;
  if ((long long)work_layout(R, n, k, static_cast<unsigned char*>(work), &w) > work_bytes)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const RowView v{scores, ids, row_stride, seg_stride, seg_len};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(w.counts, 0, zeroed_bytes(R, kBins1), st);
  if (err != cudaSuccess) return (int)err;
  const Digits dg{0, kBins1};
  if (int_keys) return (int)run_select<true>(v, R, n, k, dg, false, w, out_s, out_i, st);
  return (int)run_select<false>(v, R, n, k, dg, false, w, out_s, out_i, st);
}

// K2 (corpus_kind 0 f32, 1 bf16) and K3 (2: int8 with scales) at any k:
// the scores of Q queries (a chunk) to scores (Q, ld), ld ≥ N and a
// multiple of 4, counted as they are written, then their top k → out_s /
// out_i (Q, k). splits / rows_per_split: the score grid (ops/topk.py
// _plan_topk at k 1; halved here past kMaxRun rows a split); work as for
// ts_topk_select over (Q, N).
extern "C" int ts_topk_large(const float* q, const void* corpus, int corpus_kind,
                             const float* scales, int Q, int N, int D, int k, int splits,
                             int rows_per_split, float* scores, int ld, float* out_s, int* out_i,
                             void* work, long long work_bytes, void* stream) {
  if (N < 1 || k < 1 || ld < N || ld % 4 || rows_per_split % kTileRows || work == nullptr)
    return (int)cudaErrorInvalidValue;
  Work w;
  if ((long long)work_layout(Q, N, k, static_cast<unsigned char*>(work), &w) > work_bytes)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  while (rows_per_split > kMaxRun) {   // a CTA's counts stay within 16 bits
    rows_per_split = ((rows_per_split + 1) / 2 + kTileRows - 1) / kTileRows * kTileRows;
    splits = (N + rows_per_split - 1) / rows_per_split;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(w.counts, 0, zeroed_bytes(Q, kScoreBins), st);
  if (err != cudaSuccess) return (int)err;
  if (corpus_kind == 2)
    err = run_score_rows(q, static_cast<const int8_t*>(corpus), scales, Q, N, D, splits,
                         rows_per_split, scores, ld, w.hist1, st);
  else if (corpus_kind == 1)
    err = run_score_rows(q, static_cast<const __nv_bfloat16*>(corpus), nullptr, Q, N, D,
                         splits, rows_per_split, scores, ld, w.hist1, st);
  else
    err = run_score_rows(q, static_cast<const float*>(corpus), nullptr, Q, N, D, splits,
                         rows_per_split, scores, ld, w.hist1, st);
  if (err != cudaSuccess) return (int)err;
  const RowView v{scores, nullptr, ld, 0, N};
  return (int)run_select<false>(v, Q, N, k, Digits{kScoreBase, kScoreBins}, true, w, out_s,
                                out_i, st);
}
