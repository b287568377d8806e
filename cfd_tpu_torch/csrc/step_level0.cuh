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
// a cell is computed purely from the stage's INPUT (step_ghost below), read
// from one buffer and written to another. The solid averaging reads only
// interior fluid cells, which the stage does not change.
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

// The arithmetic of the exact masked operator on the step's rectangle, for
// a geometry G with the fields ny, nx, step_i, inlet_j (the solid block
// {i <= step_i, j > inlet_j}) and the constants idx2, idy2, denom, omega,
// one_minus_omega: StepL0 here, and the natural layout's level 0
// (step_smoother.cu), whose tiles run the same cell arithmetic. src(j, i)
// reads a stage's input at global logical (j, i).

template <class G>
__device__ __forceinline__ bool step_fluid(int j, int i, const G& L) {
  return j >= 1 && j <= L.ny && i >= 1 && i <= L.nx && !(i <= L.step_i && j > L.inlet_j);
}

// The ghost stage's output at (j, i) from its input src (step_quad.py:
// 270-302, cfd_tpu/kernels/step_smoother.py:140-152): the domain ghosts,
// then a solid cell on the block's east column or bottom row takes
// (east + south) * (1 / count) of its fluid neighbours, the absent one as
// 0; every other cell keeps src. It reads the 3 x 3 box around (j, i).
template <class A, class G>
__device__ __forceinline__ float step_ghost(const A& src, int j, int i, const G& L) {
  const bool row_in = j >= 1 && j <= L.ny, col_in = i >= 1 && i <= L.nx;
  if (i == 0 && row_in) return src(j, 1);
  if (i == L.nx + 1 && row_in) return 0.f;
  if (j == 0 && col_in) return src(1, i);
  if (j == L.ny + 1 && col_in) return src(L.ny, i);
  if (row_in && col_in && i <= L.step_i && j > L.inlet_j) {
    const bool eastw = i == L.step_i && i < L.nx;
    const bool southw = j == L.inlet_j + 1 && j > 1;
    if (eastw || southw) {
      const float cnt = (eastw ? 1.0f : 0.0f) + (southw ? 1.0f : 0.0f);
      const float inv = 1.0f / cnt;
      return ((eastw ? src(j, i + 1) : 0.0f) + (southw ? src(j - 1, i) : 0.0f)) * inv;
    }
  }
  return src(j, i);
}

// A fluid cell's Gauss-Seidel update from its value c, its neighbours and
// b: (1 - omega) c + omega gs, gs = (idx2 (E + W) + idy2 (N + S) - b) /
// denom (multigrid.py:995-999), a true division as the twins'
template <class G>
__device__ __forceinline__ float step_gs(float c, float E, float W, float N, float S, float b,
                                         const G& L) {
  const float gs = (L.idx2 * (E + W) + L.idy2 * (N + S) - b) / L.denom;
  return L.one_minus_omega * c + L.omega * gs;
}

// b - lap at a fluid cell of ghosted value pc and ghosted neighbours
// (multigrid.py residual0, :1010-1014)
template <class G>
__device__ __forceinline__ float step_residual(float pc, float E, float W, float N, float S,
                                               float b, const G& L) {
  const float lap = (E - 2.0f * pc + W) * L.idx2 + (N - 2.0f * pc + S) * L.idy2;
  return b - lap;
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
