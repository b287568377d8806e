// The Rayleigh-Benard tentative-carry stages on the quad layout: the
// corrector with the box no-slip ghosts, the temperature transport with its
// ghosts, and the predictor with the buoyancy and the source, as
// accessor-taking arithmetic; the corrector's per-cell body; and the
// carry's body on a shared-memory tile (rb_tile, carry_tile.cuh). Shared by
// the standalone stage kernels (rb_stage.cu) and the whole-step kernel
// (whole_step.cu). The ghost order is described in rb_stage.cu. ``row0``
// is a sharded local block's global plane row of its row 0 (common.cuh):
// every j below is the global logical row, so the ghost rows (j = 0, ny +
// 1) and the walls keep their global meaning on any shard; 0 on a whole
// field.
#pragma once

#include "carry_tile.cuh"
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

// The logical rows the carry's stages reach, one row each: the corrector
// (p at j+1), the box ghosts (the ghost rows read rows 1 and ny), the
// temperature transport (T, v2 at j-1 ... j+1), the T ghosts, the
// predictor with the buoyancy (u2, v2 at j-1 ... j+1, T' at j+1), the box
// ghosts on the tentative fields and the source (vs at j-1); a tile's halo
// covers them (kernels/plan.py CARRY_RADIUS)
constexpr int kRBRadius = 7;
// the inputs the carry's tile stages: us, vs, p, T
constexpr int kRBInputs = 4;

// The RB carry on tile t (rb_stage.cu describes the design) from its
// staged us, vs, p, T in `in` (kRBInputs buffers) with the corrected u2, v2
// in `work` (tile::kWorkBuffers): u2, v2 where T' and the predictor read
// them, T' (over p) where the predictor reads it, us', vs' (over us, vs)
// where the source reads them (own cells, one row south, one column west),
// then us', vs', T', b and the guess (kG; kExtrapolate: 2p - p_prev where
// p_prev is given) of the own cells; m takes the Courant maxima of u2, v2
// over the own rows (kAdaptive; kBlock: a local block's rows between its
// `halo`-row strips). p is the field in device memory, read for the guess.
template <bool kAdaptive, bool kBlock, tile::Guess kG>
__device__ __forceinline__ void rb_tile(const tile::Tile& t, float* in, float* work,
                                        const float* p, const float* p_prev, float* us2,
                                        float* vs2, float* T2, float* b, float* guess,
                                        const RBCorr& cc, const RBTemp& tc, const Pred& pc,
                                        float buoy, int halo, float (&m)[2]) {
  const int Hq8 = cc.Hq8, Wqa = cc.Wqa, ny = cc.ny, nx = cc.nx, plane = Hq8 * Wqa, LC = t.LC;
  float* const s_us = in;
  float* const s_vs = in + t.N;
  float* const s_p = in + 2 * t.N;
  float* const s_T = in + 3 * t.N;
  float* const s_u = work;
  float* const s_v = work + t.N;
  const tile::Box A = tile::around(t, 3, 3, 4, 3), TB = tile::around(t, 1, 1, 2, 1);
  const tile::Box B = tile::around(t, 1, 0, 1, 0);
  const tile::View vus = tile::view(s_us, t), vvs = tile::view(s_vs, t);
  const tile::View vp = tile::view(s_p, t), vT = tile::view(s_T, t);
  const tile::View vu = tile::view(s_u, t), vv = tile::view(s_v, t), vT2 = vp;
  const bool inner = tile::interior(t, A, ny, nx, Hq8);
  if (inner) {
    tile::each_cell(A, LC, [&](int lj, int li, int k) {
      const int j = t.gj + lj, i = t.ai + li;
      s_u[k] = rb_u_corr_formula(vus, vp, j, i, cc);
      s_v[k] = rb_v_corr_formula(vvs, vp, j, i, cc);
    });
    __syncthreads();
    tile::each_cell(TB, LC, [&](int lj, int li, int k) {
      s_p[k] = t_pre_formula(vT, vu, vv, t.gj + lj, t.ai + li, tc);
    });
    __syncthreads();
    tile::each_cell(B, LC, [&](int lj, int li, int k) {
      const int j = t.gj + lj, i = t.ai + li;
      s_us[k] = cfd::u_star_formula(vu, vv, j, i, pc);
      s_vs[k] = cfd::v_star_formula(vu, vv, j, i, pc) + buoy * (vT2(j, i) + vT2(j + 1, i));
    });
  } else {
    tile::each_cell(A, LC, [&](int lj, int li, int k) {
      float2 uv = make_float2(0.f, 0.f);  // outside the array a neighbour reads 0
      if (tile::in_array(t, lj, li, Hq8, Wqa)) {
        uv = rb_uv_at(vus, vvs, vp, t.gj + lj, t.ai + li, cc);
      }
      s_u[k] = uv.x;
      s_v[k] = uv.y;
    });
    __syncthreads();
    tile::each_cell(TB, LC, [&](int lj, int li, int k) {
      s_p[k] = tile::in_array(t, lj, li, Hq8, Wqa)
                   ? temperature_at(vT, vu, vv, t.gj + lj, t.ai + li, tc)
                   : 0.f;
    });
    __syncthreads();
    auto fu = [&](int j, int i) { return rb_fu_at(vu, vv, j, i, pc); };
    auto fv = [&](int j, int i) { return rb_fv_at(vu, vv, vT2, j, i, pc, buoy); };
    tile::each_cell(B, LC, [&](int lj, int li, int k) {
      const int j = t.gj + lj, i = t.ai + li;
      s_us[k] = box_u(fu, j, i, ny, nx);
      s_vs[k] = box_v(fv, j, i, ny, nx);
    });
  }
  __syncthreads();
  const bool extrapolate = kG == tile::Guess::kExtrapolate && p_prev != nullptr;
  tile::each_own(t, Wqa, [&](int g, int gr, int lj0, int li0) {
    const bool own = !kBlock || (gr >= halo && gr < Hq8 - halo);
    float pv[4] = {}, pp[4] = {};
    if (kG == tile::Guess::kCopy || extrapolate) tile::own4(p, g, plane, pv);
    if (extrapolate) tile::own4(p_prev, g, plane, pp);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lj = lj0 + (q >> 1), li = li0 + (q & 1);
      const int k = lj * LC + li, gq = q * plane + g;
      const float a = s_us[k], bv = s_vs[k];
      float bb = 0.f;
      if (inner || is_cell(t.gj + lj, t.ai + li, ny, nx)) {
        const float div = (a - s_us[k - 1]) * pc.idx + (bv - s_vs[k - LC]) * pc.idy;
        bb = pc.rho_dt * div;
      }
      us2[gq] = a;
      vs2[gq] = bv;
      T2[gq] = s_p[k];
      b[gq] = bb;
      if constexpr (kG == tile::Guess::kCopy) guess[gq] = pv[q];
      if (extrapolate) guess[gq] = 2.0f * pv[q] - pp[q];
      if (kAdaptive && own) {
        m[0] = cfd::bits_max(m[0], fabsf(s_u[k]));
        m[1] = cfd::bits_max(m[1], fabsf(s_v[k]));
      }
    }
  });
}

}  // namespace rb
}  // namespace cfd
