// The IVF block-union scan on Hopper's tensor cores (ivf_tile.cu), as the
// entry points of ivf_scan.cu (ts_ivf_scan, ts_ivf_scan_int8,
// ts_ivf_scan_per_probe, ts_ivf_scan_emit_acc, and ts_ivf_scan_idless for
// K11b) and ivf_modes.cu (ts_ivf_scan_packed for K9; ts_ivf_scan_dma for
// K10 and ts_ivf_scan_multiprobe for K11a, both through ivf_k1_scan) reach
// it. The kernel choice lives here: ivf_tile_plan says whether the wgmma
// tile takes a shape, and ivf_tile_scan / ivf_tile_emit /
// ivf_tile_per_probe / ivf_tile_packed launch it.
#pragma once

#include <stddef.h>

// The tile's launch plan: queries a CTA (nq), consumer warpgroups (nwg),
// queries a warpgroup (n = nq / nwg, wgmma's N), ring stages, and the
// dynamic shared memory.
struct IvfTilePlan {
  int nq, nwg, n, stages;
  size_t smem;
};

// data_kind 1 bf16, 2 int8, 3 the sentinel layout's bf16 rows scanned
// without ids (K11b; D counts the rows' D + 1 columns; f32 slabs, kind 0,
// never take the tile) → true and *plan where the tile takes the call, its
// ring at most max_stages deep (0: the tile's own depth).
bool ivf_tile_plan(int data_kind, int D, int Mc, int block_q, int k, int width, int slots,
                   int max_stages, IvfTilePlan* plan);

// Both passes (tile scan, merge of the lane ranges) on the stream; the
// shape must have a plan. part_* hold (B, ceil(width / 64), 64·S), or k
// in the exact mode. Kind 3 reads zero_tiles ((C_tot, ceil(Mc / 64))
// bytes, 1 where a 64-row tile's rows are all zero) in place of ids, adds
// (tiles of valid probes, tiles skipped) to counts when it is not null,
// and needs 16-byte aligned slabs.
int ivf_tile_scan(int data_kind, const float* q, const int* probes, const void* data,
                  const float* scales, const int* ids, const unsigned char* zero_tiles,
                  int* counts, int B, int D, int U, int C_tot, int Mc, int block_q, int k,
                  int width, int slots, int max_stages, float* part_s, int* part_i,
                  float* out_s, int* out_i, void* stream);

// K1-opt emit_acc on the tile (kinds 1 and 2, slots ≥ 1; the shape must
// have a plan at k 1): the deferred fold's entries written slot-major to
// out_* (B, S·width), slot s at columns s·width … s·width + width − 1; no
// merge runs.
int ivf_tile_emit(int data_kind, const float* q, const int* probes, const void* data,
                  const float* scales, const int* ids, int B, int D, int U, int C_tot, int Mc,
                  int block_q, int width, int slots, float* out_s, int* out_i, void* stream);

// K1-opt per_probe on the tile (kinds 1 and 2; the shape must have a plan
// at (k, width Mc, slots 0)): the exact mode with one CTA a (query block,
// probe u), each probe's own top-k written to out_* (U, B, k); probes
// outside [0, C_tot) give (−inf, −1) rows; no merge runs.
int ivf_tile_per_probe(int data_kind, const float* q, const int* probes, const void* data,
                       const float* scales, const int* ids, int B, int D, int U, int C_tot,
                       int Mc, int block_q, int k, float* out_s, int* out_i, void* stream);

// K9 on the tile (bf16 slabs, kind 1; U ≤ 64, Mc ≤ 2048, slots ≥ 1; the
// shape must have a plan at (k, width, slots)): the deferred fold over one
// int32 packet a slot, then the merge of the ranges, out_* (B, k) pairs
// (s14, 2^17 − 1 − the packet's low bits), (−inf, −1) for packet 0; part_*
// hold (B, ceil(width / 64), 64·S).
int ivf_tile_packed(const float* q, const int* probes, const void* data, const int* ids, int B,
                    int D, int U, int C_tot, int Mc, int block_q, int k, int width, int slots,
                    float* part_s, int* part_i, float* out_s, int* out_i, void* stream);

// K1 / K4 (ivf_scan.cu), and K10 and K11a through them: the tile where
// ivf_tile_plan takes the shape (its ring at most max_stages deep, 0: its
// own depth), else K1's CUDA-core kernel (data_kind 0 f32, 1 bf16, 2 int8
// + scales; slots 0 the exact merge, 1-4 the deferred fold).
int ivf_k1_scan(int data_kind, const float* q, const int* probes, const void* data,
                const float* scales, const int* ids, int B, int D, int U, int C_tot, int Mc,
                int block_q, int k, int width, int slots, int max_stages, float* part_s,
                int* part_i, float* out_s, int* out_i, void* stream);
