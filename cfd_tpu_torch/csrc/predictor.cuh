// The MAC predictor on the quad layout, shared by the stage kernels of
// every case (quad_stage.cu, step_stage.cu).
#pragma once

#include "common.cuh"

namespace cfd {

struct Pred {
  int Hq8, Wqa, ny, nx;
  float dt, nu, idx, idy, idx2, idy2, rho_dt;
};

// MAC predictor (cfd_tpu/kernels/quad.py _predictor_quad, :808-844), in the
// JAX package's operation order; 0 outside the valid faces.
__device__ __forceinline__ float u_star(const float* u, const float* v, int j, int i,
                                        const Pred& c) {
  if (!(j >= 1 && j <= c.ny && i >= 1 && i <= c.nx - 1)) return 0.f;
  const int H = c.Hq8, W = c.Wqa;
  float uc = qld(u, j, i, H, W), uE = qld(u, j, i + 1, H, W), uW = qld(u, j, i - 1, H, W);
  float uN = qld(u, j + 1, i, H, W), uS = qld(u, j - 1, i, H, W);
  float vc = qld(v, j, i, H, W), vE = qld(v, j, i + 1, H, W);
  float vS = qld(v, j - 1, i, H, W), vSE = qld(v, j - 1, i + 1, H, W);
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

__device__ __forceinline__ float v_star(const float* u, const float* v, int j, int i,
                                        const Pred& c) {
  if (!(j >= 1 && j <= c.ny - 1 && i >= 1 && i <= c.nx)) return 0.f;
  const int H = c.Hq8, W = c.Wqa;
  float vc = qld(v, j, i, H, W), vE = qld(v, j, i + 1, H, W), vW = qld(v, j, i - 1, H, W);
  float vN = qld(v, j + 1, i, H, W), vS = qld(v, j - 1, i, H, W);
  float uc = qld(u, j, i, H, W), uN = qld(u, j + 1, i, H, W);
  float uW = qld(u, j, i - 1, H, W), uNW = qld(u, j + 1, i - 1, H, W);
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

}  // namespace cfd
