// Stage kernels of the tentative-carry lid-driven cavity step, quad layout.
//
// Replaces cfd_tpu/kernels/quad.py make_quad_corrector (:488) and
// make_quad_corr_predictor_source (:938, math in cavity_carry_compute
// :1062-1123).
//
// Bound on the H100: device-memory bytes. The corrector reads 4 quad
// fields and writes 3; the carry reads 4 and writes 4 plus the scalar
// max|b| (19 MB per field at 2048^2). The arithmetic (about 60 flops a cell
// for the predictor) is far below the card's rate.
//
// Design: one thread per quad cell, neighbours through the guarded quad
// accessor, so one code path serves every plane and no halo bookkeeping is
// needed. The carry runs as TWO launches: (1) the corrector writes the
// corrected and ghost-rebuilt u, v into scratch fields, (2) the predictor +
// source + max|b| reads them. A thread of launch 2 evaluates the predictor
// at its own faces and again at the west/south faces its divergence needs
// (re-reads that hit L1/L2). This costs one extra round trip of u, v through
// device memory compared with a single fused launch with a shared-memory
// tile and a 3-cell halo, which is the next kernel step.
//
// Ghost rebuild order (cfd_tpu/kernels/quad.py:420-435, cavity-01.cpp:
// 523-543): u top ghost row j = ny+1 for i <= nx, then u bottom row j = 0
// for i <= nx, then v west column i = 0 for j <= ny, then v east column
// i = nx+1 for j <= ny. Each ghost reads the corrected interior value,
// which no earlier step of that order changes, so every thread can
// recompute its own ghost value independently.
#include "common.cuh"

namespace {

using cfd::qld;

struct Corr {
  int Hq8, Wqa, ny, nx;
  float cu, cv, two_lid;
};

struct Pred {
  int Hq8, Wqa, ny, nx;
  float dt, nu, idx, idy, idx2, idy2, rho_dt;
};

// corrected u on valid faces (j in [1, ny], i in [1, nx-1]), else 0
__device__ __forceinline__ float u_corr(const float* us, const float* p, int j, int i,
                                        const Corr& c) {
  if (!(j >= 1 && j <= c.ny && i >= 1 && i <= c.nx - 1)) return 0.f;
  float pc = qld(p, j, i, c.Hq8, c.Wqa);
  float pe = qld(p, j, i + 1, c.Hq8, c.Wqa);
  return qld(us, j, i, c.Hq8, c.Wqa) - c.cu * (pe - pc);
}

// corrected v on valid faces (j in [1, ny-1], i in [1, nx]), else 0
__device__ __forceinline__ float v_corr(const float* vs, const float* p, int j, int i,
                                        const Corr& c) {
  if (!(j >= 1 && j <= c.ny - 1 && i >= 1 && i <= c.nx)) return 0.f;
  float pc = qld(p, j, i, c.Hq8, c.Wqa);
  float pn = qld(p, j + 1, i, c.Hq8, c.Wqa);
  return qld(vs, j, i, c.Hq8, c.Wqa) - c.cv * (pn - pc);
}

__global__ void corrector_kernel(const float* us, const float* vs, const float* p,
                                 const float* p_prev, float* u2, float* v2,
                                 float* guess, Corr c) {
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa);
  int j = cell.j, i = cell.i;
  float u;
  if (j == c.ny + 1 && i <= c.nx) {
    u = c.two_lid - u_corr(us, p, c.ny, i, c);
  } else if (j == 0 && i <= c.nx) {
    u = -u_corr(us, p, 1, i, c);
  } else {
    u = u_corr(us, p, j, i, c);
  }
  float v;
  if (i == 0 && j <= c.ny) {
    v = -v_corr(vs, p, j, 1, c);
  } else if (i == c.nx + 1 && j <= c.ny) {
    v = -v_corr(vs, p, j, c.nx, c);
  } else {
    v = v_corr(vs, p, j, i, c);
  }
  u2[idx] = u;
  v2[idx] = v;
  guess[idx] = 2.0f * p[idx] - p_prev[idx];
}

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

__global__ void predictor_source_kernel(const float* u, const float* v, float* us2,
                                        float* vs2, float* b, float* max_b, Pred c) {
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float absb = 0.f;
  if (idx < n) {
    cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa);
    int j = cell.j, i = cell.i;
    float a = u_star(u, v, j, i, c);
    float bv = v_star(u, v, j, i, c);
    us2[idx] = a;
    vs2[idx] = bv;
    float bb = 0.f;
    if (j >= 1 && j <= c.ny && i >= 1 && i <= c.nx) {
      float aw = u_star(u, v, j, i - 1, c);
      float bs = v_star(u, v, j - 1, i, c);
      float div = (a - aw) * c.idx + (bv - bs) * c.idy;
      bb = c.rho_dt * div;
    }
    b[idx] = bb;
    absb = fabsf(bb);
  }
  cfd::block_max_into(absb, max_b);
}

}  // namespace

extern "C" int cfd_quad_corrector(const float* us, const float* vs, const float* p,
                                  const float* p_prev, float* u2, float* v2,
                                  float* guess, int Hq8, int Wqa, int ny, int nx,
                                  float cu, float cv, float two_lid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu, cv, two_lid};
  corrector_kernel<<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cfd_quad_carry(const float* us, const float* vs, const float* p,
                              const float* p_prev, float* u_scr, float* v_scr,
                              float* us2, float* vs2, float* b, float* guess,
                              float* max_b, int Hq8, int Wqa, int ny, int nx, float cu,
                              float cv, float two_lid, float dt, float nu, float idx,
                              float idy, float idx2, float idy2, float rho_dt,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = 4LL * Hq8 * Wqa;
  Corr c{Hq8, Wqa, ny, nx, cu, cv, two_lid};
  corrector_kernel<<<cfd::blocks_for(n), cfd::kThreads, 0, s>>>(us, vs, p, p_prev,
                                                                 u_scr, v_scr, guess, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(max_b, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt};
  predictor_source_kernel<<<cfd::blocks_for(n), cfd::kThreads, 0, s>>>(
      u_scr, v_scr, us2, vs2, b, max_b, pc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cfd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
