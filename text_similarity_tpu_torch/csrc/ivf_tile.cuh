// The IVF block-union scan on Hopper's tensor cores (ivf_tile.cu), as the
// merge entry points of ivf_scan.cu (ts_ivf_scan, ts_ivf_scan_int8) reach
// it. The kernel choice lives here: ivf_tile_plan says whether the wgmma
// tile takes a shape, and ivf_tile_scan launches it.
#pragma once

#include <stddef.h>

// The tile's launch plan: queries a CTA (nq), consumer warpgroups (nwg),
// queries a warpgroup (n = nq / nwg, wgmma's N), ring stages, and the
// dynamic shared memory.
struct IvfTilePlan {
  int nq, nwg, n, stages;
  size_t smem;
};

// data_kind 1 bf16, 2 int8 (f32 slabs, kind 0, never take the tile) →
// true and *plan where the tile takes the call.
bool ivf_tile_plan(int data_kind, int D, int Mc, int block_q, int k, int width, int slots,
                   IvfTilePlan* plan);

// Both passes (tile scan, merge of the lane ranges) on the stream; the
// shape must have a plan. part_* hold (B, ceil(width / 64), k).
int ivf_tile_scan(int data_kind, const float* q, const int* probes, const void* data,
                  const float* scales, const int* ids, int B, int D, int U, int C_tot, int Mc,
                  int block_q, int k, int width, int slots, float* part_s, int* part_i,
                  float* out_s, int* out_i, void* stream);
