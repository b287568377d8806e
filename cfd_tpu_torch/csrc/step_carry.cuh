// Per-cell bodies of the backward step's tentative-carry stages on the quad
// layout: the masked corrector and the masked predictor + source, with the
// step BCs. Shared by the standalone stage kernels (step_stage.cu, on a
// whole field or on a shard's local block) and the whole-step kernel
// (whole_step.cu). The BC order is described in step_stage.cu. On a local
// block (row0 != 0, common.cuh) every j is global, so the masks, the
// inlet rows and the interface faces keep their global meaning.
#pragma once

#include "common.cuh"
#include "predictor.cuh"

namespace cfd {
namespace step {

struct Step {
  int Hq8, Wqa, ny, nx, step_i, inlet_j;
  float cu, cv, uin;
  int row0 = 0;  // a sharded local block's global plane row of row 0 (common.cuh)
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
  const float pc = qld(p, j, i, s.Hq8, s.Wqa, s.row0);
  const float pe = qld(p, j, i + 1, s.Hq8, s.Wqa, s.row0);
  return qld(us, j, i, s.Hq8, s.Wqa, s.row0) - s.cu * (pe - pc);
}

__device__ __forceinline__ float v_corr(const float* vs, const float* p, int j, int i,
                                        const Step& s) {
  if (!v_valid(j, i, s)) return 0.f;
  const float pc = qld(p, j, i, s.Hq8, s.Wqa, s.row0);
  const float pn = qld(p, j + 1, i, s.Hq8, s.Wqa, s.row0);
  return qld(vs, j, i, s.Hq8, s.Wqa, s.row0) - s.cv * (pn - pc);
}

// The step corrector at quad cell idx: the rho-divided correction on valid
// faces and the step BCs into u2, v2. Returns (|u|, |v|). kBlock: a shard's
// local block at s.row0; a whole field folds the row offset away at compile
// time.
template <bool kBlock = false>
__device__ __forceinline__ float2 corrector_cell(const float* us, const float* vs,
                                                 const float* p, float* u2, float* v2,
                                                 long long idx, Step s) {
  if constexpr (!kBlock) s.row0 = 0;
  const cfd::QuadCell cell = cfd::quad_cell(idx, s.Hq8, s.Wqa, s.row0);
  auto uc = [&](int j, int i) { return u_corr(us, p, j, i, s); };
  auto vc = [&](int j, int i) { return v_corr(vs, p, j, i, s); };
  const float u = step_u(uc, cell.j, cell.i, s);
  const float v = step_v(vc, cell.j, cell.i, s);
  u2[idx] = u;
  v2[idx] = v;
  return make_float2(fabsf(u), fabsf(v));
}

// The step predictor at quad cell idx on valid faces, the step BCs on the
// tentative fields, b = rho/dt * div on the fluid cells (0 elsewhere);
// returns b. kBlock as corrector_cell's (c.row0 == s.row0 on a block).
template <bool kBlock = false>
__device__ __forceinline__ float predictor_source_cell(const float* u, const float* v,
                                                       float* us2, float* vs2, float* b,
                                                       long long idx, Pred c, Step s) {
  if constexpr (!kBlock) {
    c.row0 = 0;
    s.row0 = 0;
  }
  const cfd::QuadCell cell = cfd::quad_cell(idx, s.Hq8, s.Wqa, s.row0);
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
  float bb = 0.f;
  if (fluid(j, i, s)) {
    const float aw = step_u(fu, j, i - 1, s);
    const float bs = step_v(fv, j - 1, i, s);
    const float div = (a - aw) * c.idx + (bv - bs) * c.idy;
    bb = c.rho_dt * div;
  }
  b[idx] = bb;
  return bb;
}

}  // namespace step
}  // namespace cfd
