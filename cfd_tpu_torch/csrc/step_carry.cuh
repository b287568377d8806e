// The backward step's tentative-carry stages on the quad layout: the
// masked corrector with the step BCs, the masked predictor, the
// accessor-taking arithmetic they are built of, and the step's arithmetic
// for the carry's shared-memory tile (StepTile, for carry_tile.cuh
// duct_tile). Shared by the corrector kernel and the carry's tiles
// (step_stage.cu, on a whole field or on a shard's local block) and the
// whole-step kernel (whole_step.cu). The BC order is described in
// step_stage.cu. On a local block (row0 != 0, common.cuh) every j is
// global, so the masks, the inlet rows and the interface faces keep their
// global meaning.
#pragma once

#include "carry_tile.cuh"
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

// The stages' arithmetic from accessors a(j, i): global logical (j, i),
// reads of the quad arrays (cfd::QuadRead, through qld) or of a
// shared-memory tile (carry_tile.cuh). The *_formula functions are the
// arithmetic alone, for a face known to be valid (a tile's interior path).

// the rho-divided correction of a u face
template <class LUS, class LP>
__device__ __forceinline__ float u_corr_formula(LUS us, LP p, int j, int i, const Step& s) {
  const float pc = p(j, i);
  const float pe = p(j, i + 1);
  return us(j, i) - s.cu * (pe - pc);
}

// the rho-divided correction of a v face
template <class LVS, class LP>
__device__ __forceinline__ float v_corr_formula(LVS vs, LP p, int j, int i, const Step& s) {
  const float pc = p(j, i);
  const float pn = p(j + 1, i);
  return vs(j, i) - s.cv * (pn - pc);
}

// the correction on valid faces, else 0
template <class LUS, class LP>
__device__ __forceinline__ float u_corr_at(LUS us, LP p, int j, int i, const Step& s) {
  if (!u_valid(j, i, s)) return 0.f;
  return u_corr_formula(us, p, j, i, s);
}

template <class LVS, class LP>
__device__ __forceinline__ float v_corr_at(LVS vs, LP p, int j, int i, const Step& s) {
  if (!v_valid(j, i, s)) return 0.f;
  return v_corr_formula(vs, p, j, i, s);
}

// The corrected u, v at (j, i) with the step BCs
template <class LUS, class LVS, class LP>
__device__ __forceinline__ float2 step_uv_at(LUS us, LVS vs, LP p, int j, int i,
                                             const Step& s) {
  auto uc = [&](int jj, int ii) { return u_corr_at(us, p, jj, ii, s); };
  auto vc = [&](int jj, int ii) { return v_corr_at(vs, p, jj, ii, s); };
  return make_float2(step_u(uc, j, i, s), step_v(vc, j, i, s));
}

// The predictor of a u (v) face of the corrected fields u, v on the valid
// faces, else 0: the tentative field before the step BCs
template <class LU, class LV>
__device__ __forceinline__ float fu_at(LU u, LV v, int j, int i, const Pred& c,
                                       const Step& s) {
  return u_valid(j, i, s) ? cfd::u_star_at(u, v, j, i, c) : 0.f;
}

template <class LU, class LV>
__device__ __forceinline__ float fv_at(LU u, LV v, int j, int i, const Pred& c,
                                       const Step& s) {
  return v_valid(j, i, s) ? cfd::v_star_at(u, v, j, i, c) : 0.f;
}

// The logical rows the carry's stages reach, one row each: the corrector
// (p at j+1), the step BCs on the corrected fields (the ghost rows read
// rows 1 and ny), the predictor (j-1 ... j+1), the step BCs on the
// tentative fields and the source (vs at j-1); a tile's halo covers them
// (kernels/plan.py CARRY_RADIUS)
constexpr int kStepRadius = 5;

// The step's arithmetic on a tile (tile::duct_tile): the masked correction
// with the step BCs, the masked predictor with the step BCs on the
// tentative fields, the source on the fluid cells; the unmasked path also
// off the solid block and its interface faces
struct StepTile {
  Step c;
  Pred pc;
  __device__ bool inner(const tile::Tile& t, const tile::Box& A) const {
    return tile::interior(t, A, c.ny, c.nx, c.Hq8) &&
           tile::misses_corner(t, A, c.step_i, c.inlet_j);
  }
  __device__ float2 uv_formula(tile::View us, tile::View vs, tile::View p, int j, int i) const {
    return make_float2(u_corr_formula(us, p, j, i, c), v_corr_formula(vs, p, j, i, c));
  }
  __device__ float2 uv_at(tile::View us, tile::View vs, tile::View p, int j, int i) const {
    return step_uv_at(us, vs, p, j, i, c);
  }
  __device__ float us_at(tile::View u, tile::View v, int j, int i) const {
    auto fu = [&](int jj, int ii) { return fu_at(u, v, jj, ii, pc, c); };
    return step_u(fu, j, i, c);
  }
  __device__ float vs_at(tile::View u, tile::View v, int j, int i) const {
    auto fv = [&](int jj, int ii) { return fv_at(u, v, jj, ii, pc, c); };
    return step_v(fv, j, i, c);
  }
  __device__ bool cell(int j, int i) const { return fluid(j, i, c); }
};

}  // namespace step
}  // namespace cfd
