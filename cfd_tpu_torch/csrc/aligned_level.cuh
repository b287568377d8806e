// One aligned (H8, W) multigrid level with separable weights: its
// constants and the per-cell red/black update, shared by the coarse-level
// smoother (rb_smoother.cu) and the whole-solve kernel (whole_solve.cu).
//
// Layout: row-major (H8, W); the interior is j in [1, ny], i in [1, nx].
// Storage is float or bfloat16, the arithmetic always float32.
#pragma once

#include "common.cuh"
#include "mg_smooth.cuh"

namespace cfd {

struct Level {
  int H8, W, ny, nx;
  float idx2, idy2, omega;
  const float* wE;  // (W,)
  const float* wW;
  const float* wN;  // (H8,)
  const float* wS;
};

template <typename T>
__device__ __forceinline__ float ld(const T* a, int j, int i, const Level& L) {
  return (j >= 0 && j < L.H8 && i >= 0 && i < L.W)
             ? to_f32(a[static_cast<long long>(j) * L.W + i])
             : 0.f;
}

__device__ __forceinline__ bool interior(int j, int i, const Level& L) {
  return j >= 1 && j <= L.ny && i >= 1 && i <= L.nx;
}

// The weighted Gauss-Seidel update of interior cell (j, i) from the other
// colour's values in src.
template <typename TS, typename TB>
__device__ __forceinline__ float rb_update(const TS* src, const TB* b, int j, int i,
                                           const Level& L) {
  const long long k = static_cast<long long>(j) * L.W + i;
  return gs_update(to_f32(src[k]), ld(src, j, i + 1, L), ld(src, j, i - 1, L),
                   ld(src, j + 1, i, L), ld(src, j - 1, i, L), to_f32(b[k]), L.wE[i],
                   L.wW[i], L.wN[j], L.wS[j], L.idx2, L.idy2, L.omega);
}

// signed residual b - A p at interior cell (j, i), 0 elsewhere
template <typename T>
__device__ __forceinline__ float rb_residual(const T* p, const T* b, int j, int i,
                                             const Level& L) {
  if (!interior(j, i, L)) return 0.f;
  const long long k = static_cast<long long>(j) * L.W + i;
  float ap = apply_a(to_f32(p[k]), ld(p, j, i + 1, L), ld(p, j, i - 1, L),
                     ld(p, j + 1, i, L), ld(p, j - 1, i, L), L.wE[i], L.wW[i], L.wN[j],
                     L.wS[j], L.idx2, L.idy2);
  return to_f32(b[k]) - ap;
}

}  // namespace cfd
