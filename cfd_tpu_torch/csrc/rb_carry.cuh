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

// corrected u on valid faces, the tentative value elsewhere
__device__ __forceinline__ float rb_u_corr(const float* us, const float* p, int j, int i,
                                           const RBCorr& c) {
  const float a = qld(us, j, i, c.Hq8, c.Wqa, c.row0);
  if (!u_valid(j, i, c.ny, c.nx)) return a;
  return a - c.cu * (qld(p, j, i + 1, c.Hq8, c.Wqa, c.row0) -
                     qld(p, j, i, c.Hq8, c.Wqa, c.row0));
}

__device__ __forceinline__ float rb_v_corr(const float* vs, const float* p, int j, int i,
                                           const RBCorr& c) {
  const float a = qld(vs, j, i, c.Hq8, c.Wqa, c.row0);
  if (!v_valid(j, i, c.ny, c.nx)) return a;
  return a - c.cv * (qld(p, j + 1, i, c.Hq8, c.Wqa, c.row0) -
                     qld(p, j, i, c.Hq8, c.Wqa, c.row0));
}

// T before its ghost update: the flux-form advection + diffusion on the
// cells (the twin's operation order), the old value elsewhere
__device__ __forceinline__ float t_pre(const float* T, const float* u, const float* v, int j,
                                       int i, const RBTemp& c) {
  const int H = c.Hq8, W = c.Wqa, r = c.row0;
  const float t = qld(T, j, i, H, W, r);
  if (!is_cell(j, i, c.ny, c.nx)) return t;
  const float te = qld(T, j, i + 1, H, W, r), tw = qld(T, j, i - 1, H, W, r);
  const float tn = qld(T, j + 1, i, H, W, r), ts = qld(T, j - 1, i, H, W, r);
  const float fe = qld(u, j, i, H, W, r) * 0.5f * (t + te);
  const float fw = qld(u, j, i - 1, H, W, r) * 0.5f * (tw + t);
  const float fn = qld(v, j, i, H, W, r) * 0.5f * (t + tn);
  const float fs = qld(v, j - 1, i, H, W, r) * 0.5f * (ts + t);
  const float adv = (fe - fw) * c.idx + (fn - fs) * c.idy;
  const float lap = (te - 2.0f * t + tw) * c.idx2 + (tn - 2.0f * t + ts) * c.idy2;
  return t + c.dt * (c.kappa * lap - adv);
}

// The RB corrector at quad cell idx: the corrected, ghosted u2, v2; the
// guess 2p - p_prev where p_prev is given. Returns (|u2|, |v2|).
__device__ __forceinline__ float2 corrector_cell(const float* us, const float* vs,
                                                 const float* p, const float* p_prev,
                                                 float* u2, float* v2, float* guess,
                                                 long long idx, const RBCorr& c) {
  const cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa, c.row0);
  auto fu = [&](int j, int i) { return rb_u_corr(us, p, j, i, c); };
  auto fv = [&](int j, int i) { return rb_v_corr(vs, p, j, i, c); };
  const float u = box_u(fu, cell.j, cell.i, c.ny, c.nx);
  const float v = box_v(fv, cell.j, cell.i, c.ny, c.nx);
  u2[idx] = u;
  v2[idx] = v;
  if (p_prev != nullptr) guess[idx] = 2.0f * p[idx] - p_prev[idx];
  return make_float2(fabsf(u), fabsf(v));
}

// T' at quad cell idx with the Dirichlet ghost rows and the adiabatic ghost
// columns
__device__ __forceinline__ void temperature_cell(const float* T, const float* u,
                                                 const float* v, float* T2, long long idx,
                                                 const RBTemp& c) {
  const cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa, c.row0);
  const int j = cell.j, i = cell.i, ny = c.ny, nx = c.nx;
  float out;
  if (j == 0 && i >= 1 && i <= nx) {
    out = c.two_tb - t_pre(T, u, v, 1, i, c);
  } else if (j == ny + 1 && i >= 1 && i <= nx) {
    out = c.two_tt - t_pre(T, u, v, ny, i, c);
  } else if (i == 0 && j >= 1 && j <= ny) {
    out = t_pre(T, u, v, j, 1, c);
  } else if (i == nx + 1 && j >= 1 && j <= ny) {
    out = t_pre(T, u, v, j, nx, c);
  } else {
    out = t_pre(T, u, v, j, i, c);
  }
  T2[idx] = out;
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
  auto fu = [&](int jj, int ii) {
    return u_valid(jj, ii, c.ny, c.nx) ? cfd::u_star(u, v, jj, ii, c)
                                       : qld(u, jj, ii, c.Hq8, c.Wqa, c.row0);
  };
  auto fv = [&](int jj, int ii) {
    if (!v_valid(jj, ii, c.ny, c.nx)) return qld(v, jj, ii, c.Hq8, c.Wqa, c.row0);
    const float t = qld(T2, jj, ii, c.Hq8, c.Wqa, c.row0) +
                    qld(T2, jj + 1, ii, c.Hq8, c.Wqa, c.row0);
    return cfd::v_star(u, v, jj, ii, c) + buoy * t;
  };
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
