// The finest multigrid level of the backward step on the quad layout: the
// EXACT masked operator of the defect correction (cfd_tpu/kernels/
// step_quad.py:270-351) and its per-cell arithmetic. Shared by the
// per-kernel V-cycle kernels (step_vcycle.cu) and the masked whole-solve
// (whole_solve.cu), so that the two agree bit for bit.
//
// The ghost stage (step_quad.py _step_ghosts_quad) sets the domain ghosts
// from the OLD values (column 0 = column 1 and column nx+1 = 0 on rows
// 1..ny, then row 0 = row 1 and row ny+1 = row ny on columns 1..nx), THEN
// gives each solid cell on the block's east column (i == step_i < nx) or
// bottom row (j == inlet_j + 1 > 1) the mean of its east/south fluid
// neighbour. Some domain ghosts read solid cells that the same stage
// re-averages (column 0 at row inlet_j + 1 reads cell (inlet_j + 1, 1); row
// ny + 1 at column step_i reads cell (ny, step_i)), so an in-place
// grid-parallel stage would depend on thread order. ghost_value therefore
// computes the stage's output at one cell purely from the stage's INPUT
// array, and every launch that applies the stage reads one array and writes
// another. The solid averaging reads only interior fluid cells, which the
// stage does not change.
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
// compile time, so the masked whole-solve (whole_solve.cuh) runs them
// unchanged.
#pragma once

#include "common.cuh"
#include "quad_level0.cuh"

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

// the ghost stage's output at cell (j, i) from its input src
template <bool kBlock = false>
__device__ __forceinline__ float ghost_value(const float* src, int j, int i,
                                             const StepL0& L) {
  const int H = L.Hq8, W = L.Wqa, r0 = step_row0<kBlock>(L);
  const bool row_in = j >= 1 && j <= L.ny, col_in = i >= 1 && i <= L.nx;
  if (i == 0 && row_in) return qld(src, j, 1, H, W, r0);
  if (i == L.nx + 1 && row_in) return 0.f;
  if (j == 0 && col_in) return qld(src, 1, i, H, W, r0);
  if (j == L.ny + 1 && col_in) return qld(src, L.ny, i, H, W, r0);
  if (row_in && col_in && i <= L.step_i && j > L.inlet_j) {
    const bool eastw = i == L.step_i && i < L.nx;
    const bool southw = j == L.inlet_j + 1 && j > 1;
    if (eastw || southw) {
      const float cnt = (eastw ? 1.0f : 0.0f) + (southw ? 1.0f : 0.0f);
      const float inv = 1.0f / cnt;
      return ((eastw ? qld(src, j, i + 1, H, W, r0) : 0.0f) +
              (southw ? qld(src, j - 1, i, H, W, r0) : 0.0f)) *
             inv;
    }
  }
  return qld(src, j, i, H, W, r0);
}

// the value at (j, i) after ghost stage ``lo`` of src: its output in the
// band, its input outside
template <bool kBlock>
__device__ __forceinline__ float banded_ghost(const float* src, int j, int i, int lo,
                                              const StepL0& L) {
  if (step_in_band<kBlock>(j, lo, L)) return ghost_value<kBlock>(src, j, i, L);
  return qld(src, j, i, L.Hq8, L.Wqa, step_row0<kBlock>(L));
}

// Ghost stage ``lo``, then the red half-sweep ``lo + 1``, at quad cell c,
// from src: a red fluid cell's Gauss-Seidel update from the ghosted src,
// every other cell its ghosted value. Red = (i + j) even = quad planes
// {0, 3}. The update is (1 - omega)*p + omega*gs, gs = (idx2*(E + W) +
// idy2*(N + S) - b) / denom (multigrid.py:995-999), a true division as the
// twin's.
template <bool kBlock = false>
__device__ __forceinline__ float ghost_red_value(const float* src, const float* b,
                                                 const QuadCell& c, const StepL0& L,
                                                 int lo = 1) {
  const int j = c.j, i = c.i;
  if (!((c.q == 0 || c.q == 3) && step_fluid(j, i, L) && step_in_band<kBlock>(j, lo + 1, L)))
    return banded_ghost<kBlock>(src, j, i, lo, L);
  const float E = banded_ghost<kBlock>(src, j, i + 1, lo, L);
  const float Wv = banded_ghost<kBlock>(src, j, i - 1, lo, L);
  const float N = banded_ghost<kBlock>(src, j + 1, i, lo, L);
  const float S = banded_ghost<kBlock>(src, j - 1, i, lo, L);
  const float gs = (L.idx2 * (E + Wv) + L.idy2 * (N + S) - b[c.idx]) / L.denom;
  return L.one_minus_omega * src[c.idx] + L.omega * gs;
}

// The black half-sweep ``lo`` in place at quad cell c (planes {1, 2}); true
// when c is a black fluid cell of the band, with its update in *out. A
// black cell reads only red-parity cells, which the black sweep does not
// write.
template <bool kBlock = false>
__device__ __forceinline__ bool black_update(const float* p, const float* b, const QuadCell& c,
                                             const StepL0& L, float* out, int lo = 1) {
  const int j = c.j, i = c.i;
  if (!((c.q == 1 || c.q == 2) && step_fluid(j, i, L) && step_in_band<kBlock>(j, lo, L)))
    return false;
  const int H = L.Hq8, W = L.Wqa, r0 = step_row0<kBlock>(L);
  const float E = qld(p, j, i + 1, H, W, r0), Wv = qld(p, j, i - 1, H, W, r0);
  const float N = qld(p, j + 1, i, H, W, r0), S = qld(p, j - 1, i, H, W, r0);
  const float gs = (L.idx2 * (E + Wv) + L.idy2 * (N + S) - b[c.idx]) / L.denom;
  *out = L.one_minus_omega * p[c.idx] + L.omega * gs;
  return true;
}

// The exact residual at (j, i): ghost stage ``lo`` re-applied to p, then
// b - lap on fluid cells, 0 elsewhere and outside a block
// (step_quad.py:339-351)
template <bool kBlock = false>
__device__ __forceinline__ float step_residual(const float* p, const float* b, int j, int i,
                                               const StepL0& L, int lo = 1) {
  if (!step_fluid(j, i, L)) return 0.f;
  const int jl = j - 2 * step_row0<kBlock>(L);
  if (kBlock && (jl < 0 || jl >= 2 * L.Hq8)) return 0.f;
  const float pc = banded_ghost<kBlock>(p, j, i, lo, L);
  const float E = banded_ghost<kBlock>(p, j, i + 1, lo, L);
  const float Wv = banded_ghost<kBlock>(p, j, i - 1, lo, L);
  const float N = banded_ghost<kBlock>(p, j + 1, i, lo, L);
  const float S = banded_ghost<kBlock>(p, j - 1, i, lo, L);
  const float lap = (E - 2.0f * pc + Wv) * L.idx2 + (N - 2.0f * pc + S) * L.idy2;
  return b[qidx(jl, i, L.Hq8, L.Wqa)] - lap;
}

// Level-1 source at aligned cell idx of (Hq8, Wqa): 0.25 * the four exact
// residuals of its children (the quad pre kernel's child order) on the
// coarse interior, else 0; on a block the coarse row Jc is global
template <bool kBlock = false>
__device__ __forceinline__ float step_restrict_value(const float* p, const float* b,
                                                     long long idx, const StepL0& L,
                                                     int lo = 1) {
  const int Jl = static_cast<int>(idx / L.Wqa);
  const int Ic = static_cast<int>(idx - static_cast<long long>(Jl) * L.Wqa);
  const int Jc = Jl + step_row0<kBlock>(L);
  if (!(Jc >= 1 && Jc <= L.ny / 2 && Ic >= 1 && Ic <= L.nx / 2)) return 0.f;
  const int j = 2 * Jc, i = 2 * Ic;
  return 0.25f * (step_residual<kBlock>(p, b, j, i, L, lo) +
                  step_residual<kBlock>(p, b, j, i - 1, L, lo) +
                  step_residual<kBlock>(p, b, j - 1, i, L, lo) +
                  step_residual<kBlock>(p, b, j - 1, i - 1, L, lo));
}

// p + prolong(ec) at quad cell idx on the FLUID cells, p elsewhere
// (step_quad.py:470); ec is the solid-filled level-1 correction, on a block
// its local (Hq8, Wqa) rows, whose row J + 1 wraps within the block
template <bool kBlock = false>
__device__ __forceinline__ float step_prolong_add_value(const float* p, const float* ec,
                                                        long long idx, const StepL0& L) {
  const int r0 = step_row0<kBlock>(L);
  const QuadCell c = quad_cell(idx, L.Hq8, L.Wqa, r0);
  const float pc = p[idx];
  if (!step_fluid(c.j, c.i, L)) return pc;
  return pc + quad_prolong_corr(ec, c, L.Hq8, L.Wqa, L.ny, L.nx, r0);
}

}  // namespace cfd
