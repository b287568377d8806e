// The finest multigrid level on the quad layout: its constants and the
// interior and band tests, which serve the tile bodies of level0_tile.cuh
// (the separable pre and post kernels, quad_vcycle.cu, the fused-pre
// carry, quad_fused_pre.cu, and the whole-solve, whole_solve.cuh), whose
// arithmetic is mg_smooth.cuh's. On a local block (row0 != 0, common.cuh)
// every j is global: the masks and the row vectors keep their global
// meaning, and a residual outside the block is 0.
#pragma once

#include "common.cuh"
#include "mg_smooth.cuh"

namespace cfd {

struct Level0 {
  int Hq8, Wqa, ny, nx;
  float idx2, idy2, omega;
  const float* wE;  // (2*Wqa,) natural column vectors, 0 outside the interior
  const float* wW;
  const float* wN;  // (2*Hq8,) natural row vectors, indexed by the global j
  const float* wS;
  int row0 = 0;  // a sharded local block's global plane row of row 0
  int halo = 0;  // its halo strip in plane rows; 0 on a whole field
};

__device__ __forceinline__ bool interior(int j, int i, const Level0& L) {
  return j >= 1 && j <= L.ny && i >= 1 && i <= L.nx;
}

// Whether half-sweep ``lo`` (from 1) updates local plane row Jl: every row of
// a whole field; on a local block the band of the TPU kernel's single slab
// (cfd_tpu/kernels/quad.py:611-627), lo rows in from each block edge except
// at a physical edge: the bottom shard (row0 <= 0, whose dead rows end the
// dependency chain as the ghost row does) and the top shard
__device__ __forceinline__ bool in_band(int Jl, int lo, const Level0& L) {
  if (L.halo == 0) return true;
  const bool bottom = L.row0 <= 0, top = L.row0 + L.Hq8 >= (L.ny + 1) / 2 + 1;
  return Jl >= (bottom ? 0 : lo) && Jl < (top ? L.Hq8 : L.Hq8 - lo);
}

}  // namespace cfd
