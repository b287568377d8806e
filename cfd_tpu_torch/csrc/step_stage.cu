// Stage kernels of the tentative-carry backward-facing step on the quad
// layout.
//
// Replaces cfd_tpu/kernels/step_quad.py make_quad_step_corr_predictor_source
// (:100, math in step_carry_compute :144-201; fixed dt, and traced_dt +
// emit_courant) and make_quad_step_corrector (:204; fixed and traced_dt).
//
// Bound on the H100: device-memory bytes. The corrector reads 3 quad fields
// and writes 2; the carry reads 3 and writes 3 plus one scalar (2.5 MB per
// field at 2048x256). The arithmetic (about 85 flops a cell) is far below
// the card's rate.
//
// Design: the channel stage kernels' (quad_stage.cu) with the step's masks.
// One thread per quad cell. The carry is three launches: (1) the corrected
// and BC'd u, v into scratch fields; (2) the predictor on valid faces, the
// step BCs again on the tentative fields, b = rho/dt * div on FLUID cells
// (0 elsewhere) and each block's partial sum of b by a fixed pairwise tree;
// (3) one block folds the partials in the twin's fold_sum order.
//
// Step BC order (cfd_tpu/kernels/step_quad.py:60-97, bc.step_bc): u inlet
// column (uin on rows 1..inlet_j, 0 above), v inlet column 0, u outlet
// column i = nx copied from nx-1, v outlet column copied from nx, v bottom
// wall 0, u ghost row 0 = -row 1, v top wall 0, u ghost row ny+1 = -row ny,
// then the interface faces: u at i = step_i on rows inlet_j+1..ny and v at
// row inlet_j on columns 1..step_i set to 0. The ghost rows read rows 1 and
// ny AFTER the inlet and outlet updates and BEFORE the interface zeroing, so
// a thread rebuilding a ghost recomputes the value it depends on (step_u).
//
// The adaptive-stepping instances (template flags kTraced, kCourant) follow
// csrc/quad_stage.cu: dt from the card, the rho-divided coefficients
// dt / (rho*dx) in float32 (step_quad.py:163), the carry's pair (dt_corr,
// dt_pred), and max|u|, max|v| of the corrected, BC'd fields.
#include "common.cuh"
#include "predictor.cuh"

namespace {

using cfd::Pred;
using cfd::qld;

struct Step {
  int Hq8, Wqa, ny, nx, step_i, inlet_j;
  float cu, cv, uin;
};

__device__ __forceinline__ bool u_valid(int j, int i, const Step& s) {
  return j >= 1 && j <= s.ny && i >= 1 && i <= s.nx - 1 &&
         !(i < s.step_i && j > s.inlet_j);
}

__device__ __forceinline__ bool v_valid(int j, int i, const Step& s) {
  return j >= 1 && j <= s.ny - 1 && i >= 1 && i <= s.nx && !(i <= s.step_i && j > s.inlet_j);
}

__device__ __forceinline__ bool fluid(int j, int i, const Step& s) {
  return j >= 1 && j <= s.ny && i >= 1 && i <= s.nx && !(i <= s.step_i && j > s.inlet_j);
}

// u after the step BCs of a pre-BC field f(j, i) (0 outside the valid u
// faces), in the reference's order
template <class F>
__device__ __forceinline__ float step_u(F f, int j, int i, const Step& s) {
  // rows 1..ny after the inlet and outlet column updates
  auto row = [&](int jj, int ii) -> float {
    if (ii == s.nx) ii = s.nx - 1;
    if (ii == 0) return jj <= s.inlet_j ? s.uin : 0.f;
    return f(jj, ii);
  };
  float val;
  if (j == 0 && i <= s.nx) {
    val = -row(1, i);
  } else if (j == s.ny + 1 && i <= s.nx) {
    val = -row(s.ny, i);
  } else if (j >= 1 && j <= s.ny) {
    val = row(j, i);
  } else {
    val = f(j, i);
  }
  if (i == s.step_i && j > s.inlet_j && j <= s.ny) val = 0.f;
  return val;
}

// v after the step BCs of a pre-BC field f(j, i) (0 outside the valid v
// faces)
template <class F>
__device__ __forceinline__ float step_v(F f, int j, int i, const Step& s) {
  float val;
  if (i == 0 && j <= s.ny) {
    val = 0.f;
  } else if (i == s.nx + 1 && j <= s.ny) {
    val = s.nx == 0 ? 0.f : f(j, s.nx);
  } else if ((j == 0 || j == s.ny) && i >= 1 && i <= s.nx) {
    val = 0.f;
  } else {
    val = f(j, i);
  }
  if (j == s.inlet_j && i >= 1 && i <= s.step_i) val = 0.f;
  return val;
}

// the rho-divided correction on valid faces, else 0
__device__ __forceinline__ float u_corr(const float* us, const float* p, int j, int i,
                                        const Step& s) {
  if (!u_valid(j, i, s)) return 0.f;
  const float pc = qld(p, j, i, s.Hq8, s.Wqa);
  const float pe = qld(p, j, i + 1, s.Hq8, s.Wqa);
  return qld(us, j, i, s.Hq8, s.Wqa) - s.cu * (pe - pc);
}

__device__ __forceinline__ float v_corr(const float* vs, const float* p, int j, int i,
                                        const Step& s) {
  if (!v_valid(j, i, s)) return 0.f;
  const float pc = qld(p, j, i, s.Hq8, s.Wqa);
  const float pn = qld(p, j + 1, i, s.Hq8, s.Wqa);
  return qld(vs, j, i, s.Hq8, s.Wqa) - s.cv * (pn - pc);
}

// kTraced: cu, cv formed from *dt (s0 holds rho*dx, rho*dy); kCourant:
// max|u|, max|v| of the outputs into courant[0], courant[1]
template <bool kTraced, bool kCourant>
__global__ void step_corrector_kernel(const float* us, const float* vs, const float* p,
                                      float* u2, float* v2, Step s0, const float* dt,
                                      float* courant) {
  Step s = s0;
  if constexpr (kTraced) {
    s.cu = cfd::traced_coeff<true>(*dt, s0.cu);
    s.cv = cfd::traced_coeff<true>(*dt, s0.cv);
  }
  const long long n = 4LL * s.Hq8 * s.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float au = 0.f, av = 0.f;
  if (idx < n) {
    const cfd::QuadCell cell = cfd::quad_cell(idx, s.Hq8, s.Wqa);
    auto uc = [&](int j, int i) { return u_corr(us, p, j, i, s); };
    auto vc = [&](int j, int i) { return v_corr(vs, p, j, i, s); };
    const float u = step_u(uc, cell.j, cell.i, s);
    const float v = step_v(vc, cell.j, cell.i, s);
    u2[idx] = u;
    v2[idx] = v;
    au = fabsf(u);
    av = fabsf(v);
  }
  if constexpr (kCourant) cfd::block_max2_into(au, av, courant);
}

// predictor on valid faces, the step BCs on the tentative fields, b on the
// fluid cells, and the block's partial sum of b (fixed tree)
template <bool kTraced>
__global__ void step_predictor_source_kernel(const float* u, const float* v, float* us2,
                                             float* vs2, float* b, float* partials, Pred c0,
                                             Step s, const float* dt) {
  const Pred c = cfd::pred_at<kTraced>(c0, dt);
  const long long n = 4LL * s.Hq8 * s.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float bb = 0.f;
  if (idx < n) {
    const cfd::QuadCell cell = cfd::quad_cell(idx, s.Hq8, s.Wqa);
    const int j = cell.j, i = cell.i;
    auto fu = [&](int jj, int ii) {
      return u_valid(jj, ii, s) ? cfd::u_star(u, v, jj, ii, c) : 0.f;
    };
    auto fv = [&](int jj, int ii) {
      return v_valid(jj, ii, s) ? cfd::v_star(u, v, jj, ii, c) : 0.f;
    };
    const float a = step_u(fu, j, i, s);
    const float bv = step_v(fv, j, i, s);
    us2[idx] = a;
    vs2[idx] = bv;
    if (fluid(j, i, s)) {
      const float aw = step_u(fu, j, i - 1, s);
      const float bs = step_v(fv, j - 1, i, s);
      const float div = (a - aw) * c.idx + (bv - bs) * c.idy;
      bb = c.rho_dt * div;
    }
    b[idx] = bb;
  }
  cfd::block_sum_to(bb, partials + blockIdx.x);
}

}  // namespace

namespace {

// the carry's three launches: corrector, predictor + source + partial sums,
// fold
template <bool kAdaptive>
cudaError_t step_carry(const float* us, const float* vs, const float* p, float* u_scr,
                       float* v_scr, float* us2, float* vs2, float* b, float* partials,
                       float* sum_b, float* courant, const float* dts, const Step& s,
                       const Pred& c, cudaStream_t st) {
  const int blocks = cfd::blocks_for(4LL * s.Hq8 * s.Wqa);
  step_corrector_kernel<kAdaptive, kAdaptive><<<blocks, cfd::kThreads, 0, st>>>(
      us, vs, p, u_scr, v_scr, s, dts, courant);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  step_predictor_source_kernel<kAdaptive><<<blocks, cfd::kThreads, 0, st>>>(
      u_scr, v_scr, us2, vs2, b, partials, c, s, kAdaptive ? dts + 1 : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cfd::fold_partials(partials, blocks, sum_b, st);
}

}  // namespace

extern "C" int cfd_step_corrector(const float* us, const float* vs, const float* p,
                                  float* u2, float* v2, int Hq8, int Wqa, int ny, int nx,
                                  int step_i, int inlet_j, float cu, float cv, float uin,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu, cv, uin};
  step_corrector_kernel<false, false>
      <<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, st>>>(us, vs, p, u2, v2, s,
                                                                  nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// traced dt: *dt on the card; cu_f, cv_f the float32 rho*dx, rho*dy
extern "C" int cfd_step_corrector_traced(const float* us, const float* vs, const float* p,
                                         float* u2, float* v2, const float* dt, int Hq8,
                                         int Wqa, int ny, int nx, int step_i, int inlet_j,
                                         float cu_f, float cv_f, float uin, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu_f, cv_f, uin};
  step_corrector_kernel<true, false>
      <<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, st>>>(us, vs, p, u2, v2, s, dt,
                                                                  nullptr);
  return static_cast<int>(cudaGetLastError());
}

// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch
extern "C" int cfd_step_carry(const float* us, const float* vs, const float* p,
                              float* u_scr, float* v_scr, float* us2, float* vs2, float* b,
                              float* partials, float* sum_b, int Hq8, int Wqa, int ny,
                              int nx, int step_i, int inlet_j, float cu, float cv,
                              float uin, float dt, float nu, float idx, float idy,
                              float idx2, float idy2, float rho_dt, void* stream) {
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu, cv, uin};
  Pred c{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt};
  return static_cast<int>(step_carry<false>(us, vs, p, u_scr, v_scr, us2, vs2, b, partials,
                                             sum_b, nullptr, nullptr, s, c,
                                             static_cast<cudaStream_t>(stream)));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho*dx, rho*dy; courant: 2 floats, zeroed here
extern "C" int cfd_step_carry_adaptive(const float* us, const float* vs, const float* p,
                                       float* u_scr, float* v_scr, float* us2, float* vs2,
                                       float* b, float* partials, float* sum_b,
                                       float* courant, const float* dts, int Hq8, int Wqa,
                                       int ny, int nx, int step_i, int inlet_j, float cu_f,
                                       float cv_f, float uin, float nu, float idx, float idy,
                                       float idx2, float idy2, float rho, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu_f, cv_f, uin};
  Pred c{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho};
  return static_cast<int>(step_carry<true>(us, vs, p, u_scr, v_scr, us2, vs2, b, partials,
                                            sum_b, courant, dts, s, c, st));
}
