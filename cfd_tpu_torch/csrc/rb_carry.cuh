// Per-cell bodies of the Rayleigh-Benard tentative-carry stages on the quad
// layout: the corrector with the box no-slip ghosts, the temperature
// transport with its ghosts, and the predictor with the buoyancy and the
// source. Shared by the standalone stage kernels (rb_stage.cu) and the
// whole-step kernel (whole_step.cu). The ghost order is described in
// rb_stage.cu. ``row0`` is a sharded local block's global plane row of its
// row 0 (common.cuh): every j below is the global logical row, so the ghost
// rows (j = 0, ny + 1) and the walls keep their global meaning on any
// shard; 0 on a whole field.
#pragma once

#include "common.cuh"
#include "predictor.cuh"

namespace cfd {
namespace rb {

struct RBCorr {
  int Hq8, Wqa, ny, nx;
  float cu, cv;
  int row0 = 0;
};

struct RBTemp {
  int Hq8, Wqa, ny, nx;
  float dt, kappa, idx, idy, idx2, idy2, two_tb, two_tt;
  int row0 = 0;
};

__device__ __forceinline__ bool u_valid(int j, int i, int ny, int nx) {
  return j >= 1 && j <= ny && i >= 1 && i <= nx - 1;
}

__device__ __forceinline__ bool v_valid(int j, int i, int ny, int nx) {
  return j >= 1 && j <= ny - 1 && i >= 1 && i <= nx;
}

__device__ __forceinline__ bool is_cell(int j, int i, int ny, int nx) {
  return j >= 1 && j <= ny && i >= 1 && i <= nx;
}

// u after the box no-slip ghost update of a pre-ghost field f(j, i)
template <class F>
__device__ __forceinline__ float box_u(F f, int j, int i, int ny, int nx) {
  if (j == 0 && i <= nx) return -f(1, i);
  if (j == ny + 1 && i <= nx) return -f(ny, i);
  if ((i == 0 || i == nx) && j >= 1 && j <= ny) return 0.f;
  return f(j, i);
}

// v after the box no-slip ghost update of a pre-ghost field f(j, i)
template <class F>
__device__ __forceinline__ float box_v(F f, int j, int i, int ny, int nx) {
  if (i == 0 && j <= ny) return -f(j, 1);
  if (i == nx + 1 && j <= ny) return -f(j, nx);
  if ((j == 0 || j == ny) && i >= 1 && i <= nx) return 0.f;
  return f(j, i);
}

// The arithmetic of the stages from accessors a(j, i): global logical
// (j, i), reads of the quad arrays (cfd::QuadRead, through qld) or of a
// shared-memory tile (carry_tile.cuh). The *_formula functions are the
// arithmetic alone, for a face or cell known to be valid (a tile's interior
// path).

template <class LUS, class LP>
__device__ __forceinline__ float rb_u_corr_formula(LUS us, LP p, int j, int i,
                                                   const RBCorr& c) {
  return us(j, i) - c.cu * (p(j, i + 1) - p(j, i));
}

template <class LVS, class LP>
__device__ __forceinline__ float rb_v_corr_formula(LVS vs, LP p, int j, int i,
                                                   const RBCorr& c) {
  return vs(j, i) - c.cv * (p(j + 1, i) - p(j, i));
}

// corrected u on valid faces, the tentative value elsewhere
template <class LUS, class LP>
__device__ __forceinline__ float rb_u_corr_at(LUS us, LP p, int j, int i, const RBCorr& c) {
  if (!u_valid(j, i, c.ny, c.nx)) return us(j, i);
  return rb_u_corr_formula(us, p, j, i, c);
}

template <class LVS, class LP>
__device__ __forceinline__ float rb_v_corr_at(LVS vs, LP p, int j, int i, const RBCorr& c) {
  if (!v_valid(j, i, c.ny, c.nx)) return vs(j, i);
  return rb_v_corr_formula(vs, p, j, i, c);
}

// the corrected u, v at (j, i) with the box no-slip ghosts
template <class LUS, class LVS, class LP>
__device__ __forceinline__ float2 rb_uv_at(LUS us, LVS vs, LP p, int j, int i,
                                           const RBCorr& c) {
  auto fu = [&](int jj, int ii) { return rb_u_corr_at(us, p, jj, ii, c); };
  auto fv = [&](int jj, int ii) { return rb_v_corr_at(vs, p, jj, ii, c); };
  return make_float2(box_u(fu, j, i, c.ny, c.nx), box_v(fv, j, i, c.ny, c.nx));
}

// T on a cell: the flux-form advection + diffusion (the twin's operation
// order)
template <class LT, class LU, class LV>
__device__ __forceinline__ float t_pre_formula(LT T, LU u, LV v, int j, int i,
                                               const RBTemp& c) {
  const float t = T(j, i);
  const float te = T(j, i + 1), tw = T(j, i - 1);
  const float tn = T(j + 1, i), ts = T(j - 1, i);
  const float fe = u(j, i) * 0.5f * (t + te);
  const float fw = u(j, i - 1) * 0.5f * (tw + t);
  const float fn = v(j, i) * 0.5f * (t + tn);
  const float fs = v(j - 1, i) * 0.5f * (ts + t);
  const float adv = (fe - fw) * c.idx + (fn - fs) * c.idy;
  const float lap = (te - 2.0f * t + tw) * c.idx2 + (tn - 2.0f * t + ts) * c.idy2;
  return t + c.dt * (c.kappa * lap - adv);
}

// T before its ghost update: t_pre_formula on the cells, the old value
// elsewhere
template <class LT, class LU, class LV>
__device__ __forceinline__ float t_pre_at(LT T, LU u, LV v, int j, int i, const RBTemp& c) {
  if (!is_cell(j, i, c.ny, c.nx)) return T(j, i);
  return t_pre_formula(T, u, v, j, i, c);
}

// T' at (j, i) with the Dirichlet ghost rows and the adiabatic ghost columns
template <class LT, class LU, class LV>
__device__ __forceinline__ float temperature_at(LT T, LU u, LV v, int j, int i,
                                                const RBTemp& c) {
  const int ny = c.ny, nx = c.nx;
  if (j == 0 && i >= 1 && i <= nx) return c.two_tb - t_pre_at(T, u, v, 1, i, c);
  if (j == ny + 1 && i >= 1 && i <= nx) return c.two_tt - t_pre_at(T, u, v, ny, i, c);
  if (i == 0 && j >= 1 && j <= ny) return t_pre_at(T, u, v, j, 1, c);
  if (i == nx + 1 && j >= 1 && j <= ny) return t_pre_at(T, u, v, j, nx, c);
  return t_pre_at(T, u, v, j, i, c);
}

// the tentative u on a valid face (the predictor), u2 elsewhere
template <class LU, class LV>
__device__ __forceinline__ float rb_fu_at(LU u, LV v, int j, int i, const Pred& c) {
  return u_valid(j, i, c.ny, c.nx) ? cfd::u_star_at(u, v, j, i, c) : u(j, i);
}

// the tentative v on a valid face (the predictor and the buoyancy buoy *
// (T'(j) + T'(j+1))), v2 elsewhere
template <class LU, class LV, class LT>
__device__ __forceinline__ float rb_fv_at(LU u, LV v, LT T2, int j, int i, const Pred& c,
                                          float buoy) {
  if (!v_valid(j, i, c.ny, c.nx)) return v(j, i);
  const float t = T2(j, i) + T2(j + 1, i);
  return cfd::v_star_at(u, v, j, i, c) + buoy * t;
}

// The RB corrector at quad cell idx: the corrected, ghosted u2, v2; the
// guess 2p - p_prev where p_prev is given. Returns (|u2|, |v2|).
__device__ __forceinline__ float2 corrector_cell(const float* us, const float* vs,
                                                 const float* p, const float* p_prev,
                                                 float* u2, float* v2, float* guess,
                                                 long long idx, const RBCorr& c) {
  const cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa, c.row0);
  const float2 uv = rb_uv_at(quad_read(us, c), quad_read(vs, c), quad_read(p, c), cell.j,
                             cell.i, c);
  u2[idx] = uv.x;
  v2[idx] = uv.y;
  if (p_prev != nullptr) guess[idx] = 2.0f * p[idx] - p_prev[idx];
  return make_float2(fabsf(uv.x), fabsf(uv.y));
}

// T' at quad cell idx with the Dirichlet ghost rows and the adiabatic ghost
// columns
__device__ __forceinline__ void temperature_cell(const float* T, const float* u,
                                                 const float* v, float* T2, long long idx,
                                                 const RBTemp& c) {
  const cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa, c.row0);
  T2[idx] = temperature_at(quad_read(T, c), quad_read(u, c), quad_read(v, c), cell.j, cell.i,
                           c);
}

// The RB predictor at quad cell idx on the valid faces (u2, v2 elsewhere),
// the buoyancy buoy * (T'(j) + T'(j+1)) on the valid v faces, the box ghosts
// on the tentative fields, b = rho/dt * div on the cells (0 elsewhere);
// returns b.
__device__ __forceinline__ float predictor_source_cell(const float* u, const float* v,
                                                       const float* T2, float* us2,
                                                       float* vs2, float* b, long long idx,
                                                       const Pred& c, float buoy) {
  const cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa, c.row0);
  const int j = cell.j, i = cell.i;
  const QuadRead lu = quad_read(u, c), lv = quad_read(v, c), lt = quad_read(T2, c);
  auto fu = [&](int jj, int ii) { return rb_fu_at(lu, lv, jj, ii, c); };
  auto fv = [&](int jj, int ii) { return rb_fv_at(lu, lv, lt, jj, ii, c, buoy); };
  const float a = box_u(fu, j, i, c.ny, c.nx);
  const float bv = box_v(fv, j, i, c.ny, c.nx);
  us2[idx] = a;
  vs2[idx] = bv;
  float bb = 0.f;
  if (is_cell(j, i, c.ny, c.nx)) {
    const float aw = box_u(fu, j, i - 1, c.ny, c.nx);
    const float bs = box_v(fv, j - 1, i, c.ny, c.nx);
    const float div = (a - aw) * c.idx + (bv - bs) * c.idy;
    bb = c.rho_dt * div;
  }
  b[idx] = bb;
  return bb;
}

}  // namespace rb
}  // namespace cfd
