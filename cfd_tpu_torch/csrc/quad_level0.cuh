// The finest multigrid level on the quad layout: its constants, the
// interior and band tests, and the per-cell arithmetic of the half-sweep,
// the residual and the full-weighting restriction into level 1. The
// constants and tests serve the tile bodies of level0_tile.cuh (the
// separable pre and post kernels, quad_vcycle.cu, and the whole-solve,
// whole_solve.cuh); the per-cell arithmetic the fused-pre carry's
// grid-stride phases (quad_fused_pre.cu). On a local block (row0 != 0,
// common.cuh) every j is global: the masks and the row vectors keep their
// global meaning, the loads subtract 2 * row0, and a residual outside the
// block is 0.
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

// True when quad cell c is an interior cell of `colour` (0 = red = planes
// {0, 3}), which a half-sweep of that colour updates.
__device__ __forceinline__ bool quad_updates(const QuadCell& c, int colour,
                                             const Level0& L) {
  return ((c.q == 0 || c.q == 3) ? 0 : 1) == colour && interior(c.j, c.i, L);
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

// The Gauss-Seidel update of quad cell c from the other colour in src.
__device__ __forceinline__ float quad_gs(const float* src, const float* b,
                                         const QuadCell& c, const Level0& L) {
  const int j = c.j, i = c.i, H = L.Hq8, W = L.Wqa, r0 = L.row0;
  return gs_update(src[c.idx], qld(src, j, i + 1, H, W, r0), qld(src, j, i - 1, H, W, r0),
                   qld(src, j + 1, i, H, W, r0), qld(src, j - 1, i, H, W, r0), b[c.idx],
                   L.wE[i], L.wW[i], L.wN[j], L.wS[j], L.idx2, L.idy2, L.omega);
}

// signed residual b - A p at interior cell (j, i) of the block, 0 elsewhere
__device__ __forceinline__ float quad_residual(const float* p, const float* b, int j, int i,
                                               const Level0& L) {
  const int H = L.Hq8, W = L.Wqa, r0 = L.row0, jl = j - 2 * r0;
  if (!interior(j, i, L) || jl < 0 || jl >= 2 * H) return 0.f;
  long long k = qidx(jl, i, H, W);
  float ap = apply_a(p[k], qld(p, j, i + 1, H, W, r0), qld(p, j, i - 1, H, W, r0),
                     qld(p, j + 1, i, H, W, r0), qld(p, j - 1, i, H, W, r0), L.wE[i],
                     L.wW[i], L.wN[j], L.wS[j], L.idx2, L.idy2);
  return b[k] - ap;
}

// Level-1 source at aligned cell idx of (Hq8, Wqa): rc[Jc, Ic] = 0.25 *
// (r(2Jc, 2Ic) + r(2Jc, 2Ic-1) + r(2Jc-1, 2Ic) + r(2Jc-1, 2Ic-1)) on the
// coarse interior, else 0 (quad.py:678-687); Jc global
__device__ __forceinline__ float quad_restrict_value(const float* p, const float* b,
                                                     long long idx, const Level0& L) {
  int Jl = static_cast<int>(idx / L.Wqa);
  int Ic = static_cast<int>(idx - static_cast<long long>(Jl) * L.Wqa);
  int Jc = Jl + L.row0;
  if (!(Jc >= 1 && Jc <= L.ny / 2 && Ic >= 1 && Ic <= L.nx / 2)) return 0.f;
  int j = 2 * Jc, i = 2 * Ic;
  return 0.25f * (quad_residual(p, b, j, i, L) + quad_residual(p, b, j, i - 1, L) +
                  quad_residual(p, b, j - 1, i, L) + quad_residual(p, b, j - 1, i - 1, L));
}

}  // namespace cfd
