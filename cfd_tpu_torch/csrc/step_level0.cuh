// The finest multigrid level of the backward step on the quad layout: the
// constants and the masks of the EXACT masked operator of the defect
// correction (cfd_tpu/kernels/step_quad.py:270-351), whose arithmetic the
// tile bodies of level0_tile.cuh run for the per-kernel V-cycle kernels
// (step_vcycle.cu) and the masked whole-solve (whole_solve.cuh).
//
// The ghost stage (step_quad.py _step_ghosts_quad) sets the domain ghosts
// from the OLD values (column 0 = column 1 and column nx+1 = 0 on rows
// 1..ny, then row 0 = row 1 and row ny+1 = row ny on columns 1..nx), THEN
// gives each solid cell on the block's east column (i == step_i < nx) or
// bottom row (j == inlet_j + 1 > 1) the mean of its east/south fluid
// neighbour. Some domain ghosts read solid cells that the same stage
// re-averages (column 0 at row inlet_j + 1 reads cell (inlet_j + 1, 1); row
// ny + 1 at column step_i reads cell (ny, step_i)), so an in-place
// grid-parallel stage would depend on thread order: the stage's output at
// a cell is computed purely from the stage's INPUT (level0_tile.cuh
// t_ghost), read from one buffer and written to another. The solid
// averaging reads only interior fluid cells, which the stage does not
// change.
//
// Local blocks (kBlock, row 16f; cfd_tpu/parallel/quad_sharded.py): the
// arrays are a shard's (4, P + 16, Wqa) block at global plane row row0
// (common.cuh); every j is global, so the masks, the domain ghosts and the
// solid averaging keep their global meaning, and a neighbour outside the
// block reads 0. Stage ``lo`` (from 1) writes only the rows of its band
// (step_in_band, the TPU kernel's single slab, cfd_tpu/kernels/quad.py:
// 611-627): the ghost stage keeps its input outside the band, a sweep
// leaves the cells outside it alone, and a value read from a banded ghost
// stage is its input outside the band. The whole-field instances (kBlock
// false, every row in every band) fold the offset and the bands away at
// compile time, so the masked whole-solve runs them unchanged.
#pragma once

#include "common.cuh"

namespace cfd {

struct StepL0 {
  int Hq8, Wqa, ny, nx, step_i, inlet_j;
  float idx2, idy2, denom, omega, one_minus_omega;  // denom = 2 (idx2 + idy2)
  int row0 = 0;  // a sharded local block's global plane row of row 0
  int halo = 0;  // its halo strip in plane rows; 0 on a whole field
};

__device__ __forceinline__ bool step_fluid(int j, int i, const StepL0& L) {
  return j >= 1 && j <= L.ny && i >= 1 && i <= L.nx && !(i <= L.step_i && j > L.inlet_j);
}

// the block's row offset: 0 on a whole field, folded at compile time
template <bool kBlock>
__device__ __forceinline__ int step_row0(const StepL0& L) {
  return kBlock ? L.row0 : 0;
}

// Whether stage ``lo`` (from 1) writes global row j: every row of a whole
// field; on a local block the rows of the band, lo plane rows in from each
// block edge except at a physical edge (the bottom shard, row0 <= 0, and
// the top one), and never a row outside the block (quad_level0.cuh in_band
// on the global row)
template <bool kBlock>
__device__ __forceinline__ bool step_in_band(int j, int lo, const StepL0& L) {
  if constexpr (!kBlock) {
    return true;
  } else {
    const int Jl = (j >> 1) - L.row0;  // floor(j / 2): dead rows have j < 0
    const bool bottom = L.row0 <= 0, top = L.row0 + L.Hq8 >= (L.ny + 1) / 2 + 1;
    return Jl >= (bottom ? 0 : lo) && Jl < (top ? L.Hq8 : L.Hq8 - lo);
  }
}

}  // namespace cfd
