// One aligned (H8, W) multigrid level: its constants and the per-cell
// red/black update, shared by the coarse levels' tiles (level_tile.cuh:
// the coarse smoother, rb_smoother.cu, and the whole-solve) and the
// whole-solve's grid-stride phases (whole_solve.cuh).
//
// Layout: row-major (H8, W); the interior is j in [1, ny], i in [1, nx].
// Storage is float or bfloat16, the arithmetic always float32.
//
// Weights: a separable level keeps wE/wW as (W,) column vectors and wN/wS
// as (H8,) row vectors; a masked level (full = 1, the backward step's
// coarse hierarchy, cfd_tpu/kernels/rb_smoother.py:106-127) keeps four
// whole (H8, W) arrays. On a masked level a cell is active only where its
// coupling sum denom > 0: solid cells never update and stay 0, and the
// residual is 0 there (multigrid.py _inline_masks).
#pragma once

#include "common.cuh"
#include "mg_smooth.cuh"

namespace cfd {

struct Level {
  int H8, W, ny, nx;
  float idx2, idy2, omega;
  const float* wE;  // (W,) or (H8, W)
  const float* wW;
  const float* wN;  // (H8,) or (H8, W)
  const float* wS;
  int full;
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

// the four coupling weights of cell (j, i)
struct Weights {
  float e, w, n, s;
};

__device__ __forceinline__ Weights weights(int j, int i, const Level& L) {
  if (L.full) {
    const long long k = static_cast<long long>(j) * L.W + i;
    return {L.wE[k], L.wW[k], L.wN[k], L.wS[k]};
  }
  return {L.wE[i], L.wW[i], L.wN[j], L.wS[j]};
}

// true for the cells the smoother updates: the interior, and on a masked
// level only where denom > 0 (computed as gs_update does)
__device__ __forceinline__ bool active(int j, int i, const Level& L) {
  if (!interior(j, i, L)) return false;
  if (!L.full) return true;
  const Weights w = weights(j, i, L);
  return L.idx2 * (w.e + w.w) + L.idy2 * (w.n + w.s) > 0.f;
}

// The weighted Gauss-Seidel update of active cell (j, i) from the other
// colour's values in src.
template <typename TS, typename TB>
__device__ __forceinline__ float rb_update(const TS* src, const TB* b, int j, int i,
                                           const Level& L) {
  const long long k = static_cast<long long>(j) * L.W + i;
  const Weights w = weights(j, i, L);
  return gs_update(to_f32(src[k]), ld(src, j, i + 1, L), ld(src, j, i - 1, L),
                   ld(src, j + 1, i, L), ld(src, j - 1, i, L), to_f32(b[k]), w.e, w.w, w.n,
                   w.s, L.idx2, L.idy2, L.omega);
}

// signed residual b - A p at active cell (j, i), 0 elsewhere
template <typename T>
__device__ __forceinline__ float rb_residual(const T* p, const T* b, int j, int i,
                                             const Level& L) {
  if (!active(j, i, L)) return 0.f;
  const long long k = static_cast<long long>(j) * L.W + i;
  const Weights w = weights(j, i, L);
  float ap = apply_a(to_f32(p[k]), ld(p, j, i + 1, L), ld(p, j, i - 1, L), ld(p, j + 1, i, L),
                     ld(p, j - 1, i, L), w.e, w.w, w.n, w.s, L.idx2, L.idy2);
  return to_f32(b[k]) - ap;
}

// The solid fill of a masked level's correction e at cell (j, i)
// (multigrid.py _solid_fill, :317-347): an interior cell that is not active
// but has an active 4-neighbour takes the mean of its active neighbours'
// values, num / max(den, 1), summed E, W, N, S as the twin; every other
// cell keeps e.
__device__ __forceinline__ float solid_fill_value(const float* e, int j, int i,
                                                  const Level& L) {
  const float ec = e[static_cast<long long>(j) * L.W + i];
  if (!interior(j, i, L) || active(j, i, L)) return ec;
  auto nb = [&](int jj, int ii, float* f) {
    // jnp.roll wraparound: the neighbours of an interior cell are in range
    const bool a = jj >= 0 && jj < L.H8 && ii >= 0 && ii < L.W && active(jj, ii, L);
    *f = a ? 1.0f : 0.0f;
    return ld(e, jj, ii, L) * *f;
  };
  float fE, fW, fN, fS;
  const float vE = nb(j, i + 1, &fE), vW = nb(j, i - 1, &fW);
  const float vN = nb(j + 1, i, &fN), vS = nb(j - 1, i, &fS);
  const float den = ((fE + fW) + fN) + fS;
  if (!(den > 0.f)) return ec;
  const float num = ((vE + vW) + vN) + vS;
  return num / fmaxf(den, 1.0f);
}

}  // namespace cfd
