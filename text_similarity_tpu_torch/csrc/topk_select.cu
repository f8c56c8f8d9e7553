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
// Three steps, each its own kernel:
//  * Score (K2, K3: score_rows). CTA (query tile, corpus split) runs the
//    score tile of score_tile.cuh and writes every score (K3: × the row's
//    scale) to a (Qc, ld) f32 buffer: K2's and K3's bits exactly. The
//    wrapper sizes Qc so that the buffer stays ≤ 1 GiB. The IVF scans
//    write theirs with their own tile (emit_acc); K8 hands over its lane
//    classes' winners.
//  * Select (select_rows, one CTA a row). The k-th largest score by a radix
//    select over the order-preserving uint32 of each f32 (−0 taken as +0):
//    four 8-bit passes, the histogram in shared memory (one atomic a run
//    of equal digits in a warp). Where the ties at that score are more
//    than the k still wanted, a second radix select over the ids of the
//    tied elements finds the lowest ones. Then every element before the
//    k-th (score, id) is gathered (one atomic a warp), and the k-th pair
//    itself as often as it is still wanted (equal pairs are the same
//    entry). Fewer than k elements pad with (−inf, −1).
//  * Sort (sort_runs, merge_pass). The k winners of a row sorted by (score
//    desc, id asc): a bitonic sort in shared memory, in runs of up to
//    8,192; above that, merge passes over device memory, each element
//    placed by a binary search in its partner run (ceil(log2(k / 8192))
//    passes).
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
//
// Bound on the H100: at Q 256 × N 100,003 × D 384 f32 the score tile's
// 2·Q·N·D f32 operations (0.29 ms at 67 TFLOP/s) bound the whole; the
// (Q, N) score write and its reads (4·Q·N bytes each: 0.031 ms) and the
// winners are small beside it. What the design pays for its simplicity:
// the select reads a row once a pass (four passes, eight with a tie), and
// the score tile's stores cover half of each 32-byte sector.
#include "score_tile.cuh"

namespace {

constexpr int kSelThreads = 1024;
constexpr int kBins = 256;
constexpr int kSortRun = 8192;     // winners a CTA sorts in shared memory
constexpr int kMergeThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The rows' layout (see the header): n = whole segments of seg_len.
struct RowView {
  const float* s;
  const int* ids;   // nullptr: the id is the position
  long long row_stride, seg_stride;
  int seg_len;
  __device__ __forceinline__ int id(long long at, int e) const { return ids ? ids[at] : e; }
};

constexpr int kVisit = 4;   // elements a thread loads before it takes them

// Every element of row r, all threads of the CTA in step (a warp's lanes
// on neighbouring elements, kVisit loads in flight a thread): f(ok, e,
// value, at) with the element's position e and address at; ok is false
// past a segment's end (f is still called: its warp votes).
template <class F>
__device__ __forceinline__ void visit(const RowView& v, int r, int n, F f) {
  const int n_seg = n / v.seg_len;
  for (int sg = 0; sg < n_seg; ++sg) {
    const long long base = (long long)r * v.row_stride + (long long)sg * v.seg_stride;
    for (int o0 = 0; o0 < v.seg_len; o0 += kVisit * (int)blockDim.x) {
      float x[kVisit];
#pragma unroll
      for (int j = 0; j < kVisit; ++j) {
        const int o = o0 + j * blockDim.x + threadIdx.x;
        x[j] = o < v.seg_len ? v.s[base + o] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVisit; ++j) {
        const int o = o0 + j * blockDim.x + threadIdx.x;
        f(o < v.seg_len, sg * v.seg_len + o, x[j], base + o);
      }
    }
  }
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
template <bool kInt>
__device__ __forceinline__ float lowest() {
  return kInt ? __int_as_float((int)0x80000000u) : -INFINITY;
}

struct SelectShared {
  int hist[kBins];
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
      b[j] = largest ? kBins - 1 - (lane * 8 + j) : lane * 8 + j;
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

// The want-th largest (or smallest) key among the elements of row r that
// key_of admits, 8 bits a pass → (key, how many of the want are equal to
// it, how many admitted elements are equal to it). want ≥ 1 and at most
// the admitted count. key_of(e, value, at, key) → admitted.
template <class KeyOf>
__device__ void radix_select(SelectShared& sh, const RowView& v, int r, int n, int want,
                             bool largest, KeyOf key_of, unsigned* out_key, int* out_need,
                             int* out_count) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0, mask = 0;
  if (threadIdx.x == 0) sh.need = want;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < kBins; b += blockDim.x) sh.hist[b] = 0;
    __syncthreads();
    visit(v, r, n, [&](bool ok, int e, float x, long long at) {
      unsigned key = 0;
      ok = ok && key_of(e, x, at, key) && (key & mask) == prefix;
      const unsigned act = __ballot_sync(kFull, ok);
      if (ok) {
        const unsigned bin = (key >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&sh.hist[bin], __popc(peers));
      }
    });
    __syncthreads();
    scan_bins(sh, largest);
    prefix |= (unsigned)sh.bin << shift;
    mask |= 0xffu << shift;
    *out_need = sh.need;
    *out_count = sh.count;
    __syncthreads();   // read by all before thread 0 or the next scan writes them again
  }
  *out_key = prefix;
}

// One CTA a row: the row's top k (unsorted) to out (R, k).
template <bool kInt>
__global__ void __launch_bounds__(kSelThreads)
select_rows(RowView v, int n, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ SelectShared sh;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int kk = min(k, n);
  float* os = out_s + (size_t)r * k;
  int* oi = out_i + (size_t)r * k;
  unsigned t_key = 0, t_id = 0;
  int need = 0, count = 0;
  if (kk > 0) {
    radix_select(sh, v, r, n, kk, true, [&](int, float x, long long, unsigned& key) {
      key = value_key<kInt>(x);
      return true;
    }, &t_key, &need, &count);
  }
  const bool all_ties = need == count;   // every element at the k-th score is wanted
  int need2 = 0;
  if (kk > 0 && !all_ties) {
    int unused;
    radix_select(sh, v, r, n, need, false, [&](int e, float x, long long at, unsigned& key) {
      if (value_key<kInt>(x) != t_key) return false;
      key = id_key(v.id(at, e));
      return true;
    }, &t_id, &need2, &unused);
  }
  if (threadIdx.x == 0) sh.pos = 0;
  __syncthreads();
  if (kk > 0) {
    visit(v, r, n, [&](bool ok, int e, float x, long long at) {
      const unsigned key = value_key<kInt>(x);
      bool take = false;
      int id = 0;
      if (ok && key >= t_key) {
        id = v.id(at, e);
        take = key > t_key || all_ties || id_key(id) < t_id;
      }
      const unsigned m = __ballot_sync(kFull, take);
      if (m == 0) return;
      int slot = 0;
      if (lane == __ffs(m) - 1) slot = atomicAdd(&sh.pos, __popc(m));
      slot = __shfl_sync(kFull, slot, __ffs(m) - 1) + __popc(m & ((1u << lane) - 1u));
      if (take) {
        os[slot] = key_value<kInt>(key);
        oi[slot] = id;
      }
    });
  }
  // the k-th pair as often as it is still wanted, then the padding
  const int first = kk - need2;
  for (int j = first + threadIdx.x; j < k; j += blockDim.x) {
    if (j < kk) {
      os[j] = key_value<kInt>(t_key);
      oi[j] = (int)(t_id ^ 0x80000000u);
    } else {
      os[j] = kInt ? 0.f : -INFINITY;   // int_keys: the bits of 0
      oi[j] = -1;
    }
  }
}

// Sorts each run of `run` entries of a row (the last may be shorter) by
// (score desc, id asc) in shared memory; p2 = pow2 ≥ min(run, k). In place.
template <bool kInt>
__global__ void __launch_bounds__(kSelThreads)
sort_runs(float* __restrict__ s, int* __restrict__ ids, int k, int run, int p2) {
  extern __shared__ __align__(16) unsigned char sort_smem[];
  float* ss = reinterpret_cast<float*>(sort_smem);
  int* si = reinterpret_cast<int*>(ss + p2);
  const size_t base = (size_t)blockIdx.x * k + (size_t)blockIdx.y * run;
  const int len = min(run, k - (int)blockIdx.y * run);
  for (int j = threadIdx.x; j < p2; j += blockDim.x) {
    const bool ok = j < len;
    ss[j] = ok ? s[base + j] : lowest<kInt>();
    si[j] = ok ? ids[base + j] : 0x7fffffff;   // after every real entry
  }
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p2 / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const bool best_first = (lo & size) == 0;
        const float a = ss[lo], b = ss[hi];
        const int ia = si[lo], ib = si[hi];
        if (best_first ? ahead<kInt>(b, ib, a, ia) : ahead<kInt>(a, ia, b, ib)) {
          ss[lo] = b;
          ss[hi] = a;
          si[lo] = ib;
          si[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    s[base + j] = ss[j];
    ids[base + j] = si[j];
  }
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

template <bool kInt>
cudaError_t run_select(const RowView& v, int R, int n, int k, float* out_s, int* out_i,
                       float* tmp_s, int* tmp_i, cudaStream_t st) {
  if (R == 0 || k == 0) return cudaSuccess;
  const int runs = (k + kSortRun - 1) / kSortRun;
  int passes = 0;
  while ((1 << passes) < runs) ++passes;
  if (passes > 0 && (tmp_s == nullptr || tmp_i == nullptr)) return cudaErrorInvalidValue;
  // the winners land where the last merge pass leaves them in out
  float* ws = passes % 2 ? tmp_s : out_s;
  int* wi = passes % 2 ? tmp_i : out_i;
  select_rows<kInt><<<R, kSelThreads, 0, st>>>(v, n, k, ws, wi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int run = runs > 1 ? kSortRun : k;
  int p2 = 2;
  while (p2 < run) p2 <<= 1;
  const size_t smem = (size_t)p2 * 8;
  err = cudaFuncSetAttribute(sort_runs<kInt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  sort_runs<kInt><<<dim3(R, runs), kSelThreads, smem, st>>>(ws, wi, k, run, p2);
  err = cudaGetLastError();
  for (int p = 0, len = run; p < passes && err == cudaSuccess; ++p, len *= 2) {
    float* ds = ws == out_s ? tmp_s : out_s;
    int* di = wi == out_i ? tmp_i : out_i;
    merge_pass<kInt><<<dim3(R, (k + kMergeThreads - 1) / kMergeThreads), kMergeThreads, 0, st>>>(
        ws, wi, k, len, ds, di);
    err = cudaGetLastError();
    ws = ds;
    wi = di;
  }
  return err;
}

// K2's and K3's scores: CTA (query tile, corpus split) → scores (Q, ld),
// rows [0, N) of each query's row (K3: × the row's scale).
template <typename T, int QT>
__global__ void __launch_bounds__(kTileThreads, 1)
score_rows(const float* __restrict__ q, const T* __restrict__ corpus,
           const float* __restrict__ scales, int Q, int N, int D, int rows_per_split,
           float* __restrict__ scores, int ld) {
  using S = ScoreTile<T, QT>;
  extern __shared__ __align__(16) unsigned char rows_smem[];
  const int qg = S::qg_of(threadIdx.x), rg = S::rg_of(threadIdx.x);
  const int q0 = blockIdx.x * QT;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int n_tiles = (row_end - row_begin + kTileRows - 1) / kTileRows;
  auto tile_of = [&](int t) {
    const int row0 = row_begin + t * kTileRows;
    return make_int2(row0, min(kTileRows, row_end - row0));
  };
  auto epi = [&](int t, float (&acc)[S::RM][S::QN]) {
    const int row0 = row_begin + t * kTileRows;
    const int nv = min(kTileRows, row_end - row0);
#pragma unroll
    for (int i = 0; i < S::RM; ++i) {
      const int r = rg + S::RG * i;
      if (r >= nv) continue;
      float sc = 1.f;
      if constexpr (std::is_same_v<T, int8_t>) sc = scales[row0 + r];
#pragma unroll
      for (int j = 0; j < S::QN; ++j) {
        const int qi = q0 + qg + S::QG * j;
        if (qi >= Q) continue;
        float x = acc[i][j];
        if constexpr (std::is_same_v<T, int8_t>) x *= sc;   // K3: the dot, then the scale
        scores[(size_t)qi * ld + row0 + r] = x;
      }
    }
  };
  score_tiles<T, QT>(q, Q, q0, corpus, D, n_tiles, tile_of, epi, rows_smem);
}

template <typename T, int QT>
cudaError_t launch_score_rows(const float* q, const T* corpus, const float* scales, int Q, int N,
                              int D, int splits, int rows_per_split, float* scores, int ld,
                              cudaStream_t st) {
  const size_t smem = ScoreTile<T, QT>::kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(score_rows<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  score_rows<T, QT><<<dim3((Q + QT - 1) / QT, splits), kTileThreads, smem, st>>>(
      q, corpus, scales, Q, N, D, rows_per_split, scores, ld);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_score_rows(const float* q, const T* corpus, const float* scales, int Q, int N,
                           int D, int splits, int rows_per_split, float* scores, int ld,
                           cudaStream_t st) {
  switch (qt_for(Q, 1)) {
    case 16:
      return launch_score_rows<T, 16>(q, corpus, scales, Q, N, D, splits, rows_per_split,
                                      scores, ld, st);
    case 64:
      return launch_score_rows<T, 64>(q, corpus, scales, Q, N, D, splits, rows_per_split,
                                      scores, ld, st);
    default:
      return launch_score_rows<T, 128>(q, corpus, scales, Q, N, D, splits, rows_per_split,
                                       scores, ld, st);
  }
}

}  // namespace

// The top k of each of R rows of n candidates → out_s / out_i (R, k),
// sorted by (score desc, id asc). Element e of row r at r·row_stride +
// (e / seg_len)·seg_stride + e % seg_len of scores (and of ids, or its id
// is e when ids is NULL). tmp_s / tmp_i (R, k) scratch, needed when k >
// 8192 (else NULL). Rows with fewer than k candidates pad with (−inf, −1).
// int_keys: the values are int32 bits, compared as ints, padded with 0.
extern "C" int ts_topk_select(const float* scores, const int* ids, int R, int n, int seg_len,
                              long long seg_stride, long long row_stride, int k, float* out_s,
                              int* out_i, float* tmp_s, int* tmp_i, int int_keys,
                              void* stream) {
  if (seg_len < 1 || n % seg_len) return (int)cudaErrorInvalidValue;
  const RowView v{scores, ids, row_stride, seg_stride, seg_len};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (int_keys) return (int)run_select<true>(v, R, n, k, out_s, out_i, tmp_s, tmp_i, st);
  return (int)run_select<false>(v, R, n, k, out_s, out_i, tmp_s, tmp_i, st);
}

// K2 (corpus_kind 0 f32, 1 bf16) and K3 (2: int8 with scales) at any k:
// the scores of Q queries (a chunk) to scores (Q, ld), ld ≥ N, then their
// top k → out_s / out_i (Q, k). splits / rows_per_split: the score grid
// (ops/topk.py _plan_topk at k 1); tmp_* as for ts_topk_select.
extern "C" int ts_topk_large(const float* q, const void* corpus, int corpus_kind,
                             const float* scales, int Q, int N, int D, int k, int splits,
                             int rows_per_split, float* scores, int ld, float* out_s, int* out_i,
                             float* tmp_s, int* tmp_i, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (corpus_kind == 2)
    err = run_score_rows(q, static_cast<const int8_t*>(corpus), scales, Q, N, D, splits,
                         rows_per_split, scores, ld, st);
  else if (corpus_kind == 1)
    err = run_score_rows(q, static_cast<const __nv_bfloat16*>(corpus), nullptr, Q, N, D,
                         splits, rows_per_split, scores, ld, st);
  else
    err = run_score_rows(q, static_cast<const float*>(corpus), nullptr, Q, N, D, splits,
                         rows_per_split, scores, ld, st);
  if (err != cudaSuccess) return (int)err;
  return ts_topk_select(scores, nullptr, Q, N, N, 0, ld, k, out_s, out_i, tmp_s, tmp_i, 0,
                        stream);
}
