// Red/black Gauss-Seidel arithmetic shared by the fine-level quad kernels
// (quad_vcycle.cu), the coarse levels' tiles (level_tile.cuh: the coarse
// smoother, rb_smoother.cu, and the whole-solve) and the aligned levels'
// per-cell updates (aligned_level.cuh).
//
// The weighted 5-point operator of cfd_tpu.poisson.multigrid:
//   A(p) = idx2*(wE*(pE - p) + wW*(pW - p)) + idy2*(wN*(pN - p) + wS*(pS - p))
// with separable weights: wE/wW depend on the column only, wN/wS on the
// row only, so each kernel reads them from two short vectors.
//
// A half-sweep reads the other colour's values around each cell. The
// per-cell kernels (quad_vcycle.cu) run one half-sweep a launch, so that no
// block starts the next one before every block finished this one; the tile
// kernels (level_tile.cuh, level0_tile.cuh) run every half-sweep of a call
// in shared memory, each on a box one cell smaller than the last, so that
// a tile's cells need no other block's values. A half-sweep updates its
// colour in place: a cell reads only cells of the other colour, which the
// pass does not write, so the in-place update is race-free and equals the
// TPU's whole-array update exactly. Red = (i + j) even = quad planes {0, 3}
// (cfd_tpu/kernels/quad.py:569-596), updated first.
#pragma once

namespace cfd {

// One weighted Gauss-Seidel update (cfd_tpu.poisson.multigrid._smooth):
// gs = (idx2*(wE*E + wW*W) + idy2*(wN*N + wS*S) - b) * inv,
// p + omega*(gs - p), in the JAX package's operation order.
__device__ __forceinline__ float gs_update(float p, float E, float W, float N, float S,
                                           float b, float we, float ww, float wn,
                                           float ws, float idx2, float idy2,
                                           float omega) {
  float denom = idx2 * (we + ww) + idy2 * (wn + ws);
  float inv = 1.0f / (denom > 0.f ? denom : 1.0f);
  float gs = (idx2 * (we * E + ww * W) + idy2 * (wn * N + ws * S) - b) * inv;
  return p + omega * (gs - p);
}

// A(p) of the weighted 5-point operator, in the JAX package's order
__device__ __forceinline__ float apply_a(float p, float E, float W, float N, float S,
                                         float we, float ww, float wn, float ws,
                                         float idx2, float idy2) {
  return idx2 * (we * (E - p) + ww * (W - p)) + idy2 * (wn * (N - p) + ws * (S - p));
}

}  // namespace cfd
