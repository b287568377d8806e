// The MAC predictor on the quad layout, shared by the stage kernels of
// every case (quad_stage.cu, step_stage.cu, rb_stage.cu).
#pragma once

#include "common.cuh"

namespace cfd {

struct Pred {
  int Hq8, Wqa, ny, nx;
  float dt, nu, idx, idy, idx2, idy2, rho_dt;
  float rho;  // the density, read only by the traced-dt instances (pred_at)
  int row0 = 0;  // a sharded local block's global plane row of row 0 (common.cuh)
};

// The coefficients of a traced-dt launch (adaptive stepping): dt read from
// the card and rho/dt formed from it in float32, the reference's
// coeffs.density / dt_pred (cfd_tpu/kernels/quad.py:457, :1083, :1181).
// The fixed-dt instances keep the host's dt and rho/dt.
template <bool kTraced>
__device__ __forceinline__ Pred pred_at(Pred c, const float* dt) {
  if constexpr (kTraced) {
    c.dt = *dt;
    c.rho_dt = c.rho / c.dt;
  }
  return c;
}

// MAC predictor (cfd_tpu/kernels/quad.py _predictor_quad, :808-844), in the
// JAX package's operation order. ``u(j, i)`` and ``v(j, i)`` read the input
// fields from a shared-memory tile (carry_tile.cuh). The *_formula
// functions are the arithmetic alone, for a face known to be valid (a
// tile's interior path); the *_at functions give 0 outside the valid faces.
template <class LU, class LV>
__device__ __forceinline__ float u_star_formula(LU u, LV v, int j, int i, const Pred& c) {
  float uc = u(j, i), uE = u(j, i + 1), uW = u(j, i - 1);
  float uN = u(j + 1, i), uS = u(j - 1, i);
  float vc = v(j, i), vE = v(j, i + 1);
  float vS = v(j - 1, i), vSE = v(j - 1, i + 1);
  float lap_u = (uE - 2.0f * uc + uW) * c.idx2 + (uN - 2.0f * uc + uS) * c.idy2;
  float u_e = 0.5f * (uc + uE);
  float u_w = 0.5f * (uW + uc);
  float conv_ux = (u_e * u_e - u_w * u_w) * c.idx;
  float v_n = 0.5f * (vc + vE);
  float v_s = 0.5f * (vS + vSE);
  float u_n = 0.5f * (uN + uc);
  float u_s = 0.5f * (uS + uc);
  float conv_uy = (v_n * u_n - v_s * u_s) * c.idy;
  return uc + c.dt * (c.nu * lap_u - conv_ux - conv_uy);
}

template <class LU, class LV>
__device__ __forceinline__ float v_star_formula(LU u, LV v, int j, int i, const Pred& c) {
  float vc = v(j, i), vE = v(j, i + 1), vW = v(j, i - 1);
  float vN = v(j + 1, i), vS = v(j - 1, i);
  float uc = u(j, i), uN = u(j + 1, i);
  float uW = u(j, i - 1), uNW = u(j + 1, i - 1);
  float lap_v = (vE - 2.0f * vc + vW) * c.idx2 + (vN - 2.0f * vc + vS) * c.idy2;
  float v_nn = 0.5f * (vc + vN);
  float v_ss = 0.5f * (vS + vc);
  float conv_vy = (v_nn * v_nn - v_ss * v_ss) * c.idy;
  float u_e2 = 0.5f * (uc + uN);
  float u_w2 = 0.5f * (uW + uNW);
  float v_e2 = 0.5f * (vc + vE);
  float v_w2 = 0.5f * (vW + vc);
  float conv_vx = (u_e2 * v_e2 - u_w2 * v_w2) * c.idx;
  return vc + c.dt * (c.nu * lap_v - conv_vy - conv_vx);
}

template <class LU, class LV>
__device__ __forceinline__ float u_star_at(LU u, LV v, int j, int i, const Pred& c) {
  if (!(j >= 1 && j <= c.ny && i >= 1 && i <= c.nx - 1)) return 0.f;
  return u_star_formula(u, v, j, i, c);
}

template <class LU, class LV>
__device__ __forceinline__ float v_star_at(LU u, LV v, int j, int i, const Pred& c) {
  if (!(j >= 1 && j <= c.ny - 1 && i >= 1 && i <= c.nx)) return 0.f;
  return v_star_formula(u, v, j, i, c);
}

}  // namespace cfd
