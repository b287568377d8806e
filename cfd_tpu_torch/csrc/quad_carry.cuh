// Per-cell bodies of the cavity and channel tentative-carry stages on the
// quad layout: the correctors, and the accessor-taking arithmetic they are
// built of; and the bodies on a shared-memory tile (carry_tile.cuh): the
// cavity carry's (cavity_tile), the channel's arithmetic for
// tile::duct_tile (ChannelTile), the cavity's non-carry predictor + source
// (lid_predictor_source_tile), whose stages (lid_ghosts, predictor_box,
// source_at) the natural layout's cavity predictor + source runs on its
// own tiles too (projection.cu), and the channel's non-carry predictor +
// source (channel_predictor_source_tile), whose predictor stage
// (channel_predictor_boxes) the natural layout's channel predictor +
// source runs too. Shared by
// the standalone stage kernels and tile carries (quad_stage.cu), the
// fused-pre carry (quad_fused_pre.cu) and the whole-step kernel
// (whole_step.cu), so that all run the same code. The ghost orders and
// the traced-dt instances are described in quad_stage.cu.
#pragma once

#include "carry_tile.cuh"
#include "common.cuh"
#include "predictor.cuh"

namespace cfd {
namespace quad {

struct Corr {
  int Hq8, Wqa, ny, nx;
  float cu, cv;  // traced-dt instances: the dt-free factors (cfd::traced_coeff)
  float ghost;  // the cavity's 2 * lid velocity, or the channel's inlet velocity
  int row0 = 0;  // a sharded local block's global plane row of row 0 (common.cuh)
};

// the correction coefficients of a launch: the host's, or formed from the
// traced dt (the cavity multiplies, the channel divides)
template <bool kTraced, bool kDivided>
__device__ __forceinline__ Corr corr_at(Corr c, const float* dt) {
  if constexpr (kTraced) {
    c.cu = cfd::traced_coeff<kDivided>(*dt, c.cu);
    c.cv = cfd::traced_coeff<kDivided>(*dt, c.cv);
  }
  return c;
}

// The pressure correction of a face from accessors us(j, i), vs(j, i),
// p(j, i): global logical (j, i), reads of the quad arrays (qld) or of a
// shared-memory tile (carry_tile.cuh). The *_formula functions are the
// arithmetic alone, for a face known to be valid (a tile's interior path).
template <class LUS, class LP>
__device__ __forceinline__ float u_corr_formula(LUS us, LP p, int j, int i, const Corr& c) {
  const float pc = p(j, i);
  const float pe = p(j, i + 1);
  return us(j, i) - c.cu * (pe - pc);
}

template <class LVS, class LP>
__device__ __forceinline__ float v_corr_formula(LVS vs, LP p, int j, int i, const Corr& c) {
  const float pc = p(j, i);
  const float pn = p(j + 1, i);
  return vs(j, i) - c.cv * (pn - pc);
}

// corrected u on valid faces (j in [1, ny], i in [1, nx-1]), else 0
template <class LUS, class LP>
__device__ __forceinline__ float u_corr_at(LUS us, LP p, int j, int i, const Corr& c) {
  if (!(j >= 1 && j <= c.ny && i >= 1 && i <= c.nx - 1)) return 0.f;
  return u_corr_formula(us, p, j, i, c);
}

// corrected v on valid faces (j in [1, ny-1], i in [1, nx]), else 0
template <class LVS, class LP>
__device__ __forceinline__ float v_corr_at(LVS vs, LP p, int j, int i, const Corr& c) {
  if (!(j >= 1 && j <= c.ny - 1 && i >= 1 && i <= c.nx)) return 0.f;
  return v_corr_formula(vs, p, j, i, c);
}

// The cavity's corrected u, v at (j, i) with the lid ghosts, from
// accessors (u_corr_at's)
template <class LUS, class LVS, class LP>
__device__ __forceinline__ float2 cavity_uv_at(LUS us, LVS vs, LP p, int j, int i,
                                               const Corr& c) {
  float u;
  if (j == c.ny + 1 && i <= c.nx) {
    u = c.ghost - u_corr_at(us, p, c.ny, i, c);
  } else if (j == 0 && i <= c.nx) {
    u = -u_corr_at(us, p, 1, i, c);
  } else {
    u = u_corr_at(us, p, j, i, c);
  }
  float v;
  if (i == 0 && j <= c.ny) {
    v = -v_corr_at(vs, p, j, 1, c);
  } else if (i == c.nx + 1 && j <= c.ny) {
    v = -v_corr_at(vs, p, j, c.nx, c);
  } else {
    v = v_corr_at(vs, p, j, i, c);
  }
  return make_float2(u, v);
}

// The cavity corrector at quad cell idx: the corrected u, v with the lid
// ghosts into u2, v2 and the warm start 2p - p_prev into guess. Returns
// (|u|, |v|) for the Courant maxima.
__device__ __forceinline__ float2 cavity_corrector_cell(const float* us, const float* vs,
                                                        const float* p, const float* p_prev,
                                                        float* u2, float* v2, float* guess,
                                                        long long idx, const Corr& c) {
  cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa, c.row0);
  const float2 uv = cavity_uv_at(quad_read(us, c), quad_read(vs, c), quad_read(p, c), cell.j,
                                 cell.i, c);
  u2[idx] = uv.x;
  v2[idx] = uv.y;
  guess[idx] = 2.0f * p[idx] - p_prev[idx];
  return make_float2(fabsf(uv.x), fabsf(uv.y));
}

// u after the channel ghost update of a pre-ghost field f(j, i) (0 outside
// the valid u faces), in the reference's order: rows 1..ny take the inlet
// value at i = 0 and f(j, nx-1) at i = nx; the ghost rows j = 0 and
// j = ny+1 (i <= nx) are minus rows 1 and ny AFTER that.
template <class F>
__device__ __forceinline__ float channel_u(F f, int j, int i, int ny, int nx, float uin) {
  auto row = [&](int jj, int ii) -> float {
    if (ii == 0) return uin;
    if (ii == nx) return nx == 1 ? uin : f(jj, nx - 1);
    return f(jj, ii);
  };
  if (j == 0 && i <= nx) return -row(1, i);
  if (j == ny + 1 && i <= nx) return -row(ny, i);
  if (j >= 1 && j <= ny) return row(j, i);
  return f(j, i);
}

// v after the channel ghost update of a pre-ghost field f(j, i) (0 outside
// the valid v faces): 0 on the inlet column and on the wall rows, the
// outlet column i = nx+1 copied from i = nx.
template <class F>
__device__ __forceinline__ float channel_v(F f, int j, int i, int ny, int nx) {
  if (i == 0 && j <= ny) return 0.f;
  if (i == nx + 1 && j <= ny) return f(j, nx);
  if ((j == 0 || j == ny) && i >= 1 && i <= nx) return 0.f;
  return f(j, i);
}

// The channel's corrected u, v at (j, i) with the channel ghosts, from
// accessors (u_corr_at's): the rho-divided correction of the valid faces,
// the inlet and outlet columns, the walls and the ghost rows
template <class LUS, class LVS, class LP>
__device__ __forceinline__ float2 channel_uv_at(LUS us, LVS vs, LP p, int j, int i,
                                                const Corr& c) {
  auto uc = [&](int jj, int ii) { return u_corr_at(us, p, jj, ii, c); };
  auto vc = [&](int jj, int ii) { return v_corr_at(vs, p, jj, ii, c); };
  return make_float2(channel_u(uc, j, i, c.ny, c.nx, c.ghost), channel_v(vc, j, i, c.ny, c.nx));
}

// The channel corrector at quad cell idx: the rho-divided correction, the
// channel ghosts, the warm start. Returns (|u|, |v|).
__device__ __forceinline__ float2 channel_corrector_cell(const float* us, const float* vs,
                                                         const float* p, const float* p_prev,
                                                         float* u2, float* v2, float* guess,
                                                         long long idx, const Corr& c) {
  cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa, c.row0);
  const float2 uv = channel_uv_at(quad_read(us, c), quad_read(vs, c), quad_read(p, c), cell.j,
                                  cell.i, c);
  u2[idx] = uv.x;
  v2[idx] = uv.y;
  guess[idx] = 2.0f * p[idx] - p_prev[idx];
  return make_float2(fabsf(uv.x), fabsf(uv.y));
}

// ------------------------------------------------- the carries' tile bodies

// The logical rows the cavity carry's stages reach (the reference's
// CARRY_RADIUS, cfd_tpu/kernels/quad.py:1021) and the channel's (one row
// for each stage: the corrector, the ghosts on the corrected fields, the
// predictor, the ghosts on the tentative fields, the source); a tile's
// halo covers them (kernels/plan.py CARRY_RADIUS)
constexpr int kCavityRadius = 5;
constexpr int kChannelRadius = 5;
// the inputs the cavity's tile stages: us, vs, p
constexpr int kCavityInputs = 3;
// The logical rows the cavity's non-carry predictor + source reaches (the
// predictor 1, the source 1; kernels/plan.py CARRY_RADIUS) and the inputs
// its tile stages: u, v (u*, v* go to the tile::kWorkBuffers buffers)
constexpr int kPredictorRadius = 2;
constexpr int kPredictorInputs = 2;

// u*, v* once a face on box B of a tile's buffers (pitch LC, buffer cell
// (lj, li) at global logical (gj + lj, ai + li)) from the views u, v into
// the buffers us, vs: the *_formula arithmetic on the interior path
// (kInner: every face of B is valid), else the *_at (0 off the valid
// faces). The predictor stage of the cavity carry and of the non-carry
// predictor + source, both layouts.
template <bool kInner>
__device__ __forceinline__ void predictor_box(const tile::Box& B, int LC, int gj, int ai,
                                              tile::View u, tile::View v, float* us, float* vs,
                                              const Pred& pc) {
  tile::each_cell(B, LC, [&](int lj, int li, int k) {
    const int j = gj + lj, i = ai + li;
    if constexpr (kInner) {
      us[k] = cfd::u_star_formula(u, v, j, i, pc);
      vs[k] = cfd::v_star_formula(u, v, j, i, pc);
    } else {
      us[k] = cfd::u_star_at(u, v, j, i, pc);
      vs[k] = cfd::v_star_at(u, v, j, i, pc);
    }
  });
}

// b = rho/dt * div at buffer cell k (pitch LC), logical (j, i), from u*, v*
// of the cell and of its west and south neighbours; 0 off the cells [1, ny]
// x [1, nx] (no test where `inner`: every own cell is one)
__device__ __forceinline__ float source_at(const float* us, const float* vs, int k, int LC,
                                           int j, int i, int ny, int nx, const Pred& pc,
                                           bool inner) {
  float bb = 0.f;
  if (inner || (j >= 1 && j <= ny && i >= 1 && i <= nx)) {
    const float div = (us[k] - us[k - 1]) * pc.idx + (vs[k] - vs[k - LC]) * pc.idy;
    bb = pc.rho_dt * div;
  }
  return bb;
}

// The lid-cavity ghosts of the non-carry stage's input (the reference's
// order, cfd_tpu/kernels/quad.py:420-435) applied once, in place, to a
// tile's u and v buffers (LR x LC, buffer cell (lj, li) at logical (j0 +
// lj, i0 + li)): u's top ghost row j = ny + 1 is 2 lid minus row ny and its
// bottom row j = 0 minus row 1 (i <= nx); v's west ghost column i = 0 is
// minus column 1 and its east one i = nx + 1 minus column nx (j <= ny). A
// ghost reads an interior value and none reads another ghost, so one pass
// gives each the value of the ordered updates. A ghost whose source lies
// past the buffer keeps its load: no valid face of the tile's predictor box
// reads it (a valid face reads a ghost only beside its own row or column).
// Every thread of the block calls it after the loads' barrier; a barrier
// follows.
__device__ __forceinline__ void lid_ghosts(float* u, float* v, int j0, int i0, int LR, int LC,
                                           int ny, int nx, float two_lid) {
  const int n = 2 * (LC + LR);
  for (int k = static_cast<int>(threadIdx.x); k < n; k += static_cast<int>(blockDim.x)) {
    if (k < 2 * LC) {  // u: the top ghost row, then the bottom one
      const bool top = k < LC;
      const int li = top ? k : k - LC;
      const int lj = (top ? ny + 1 : 0) - j0, ls = top ? lj - 1 : lj + 1;
      if (lj < 0 || lj >= LR || ls < 0 || ls >= LR || i0 + li > nx) continue;
      const float s = u[ls * LC + li];
      u[lj * LC + li] = top ? two_lid - s : -s;
    } else {  // v: the west ghost column, then the east one
      const bool west = k - 2 * LC < LR;
      const int lj = west ? k - 2 * LC : k - 2 * LC - LR;
      const int li = (west ? 0 : nx + 1) - i0, ls = west ? li + 1 : li - 1;
      if (li < 0 || li >= LC || ls < 0 || ls >= LC || j0 + lj > ny) continue;
      v[lj * LC + li] = -v[lj * LC + ls];
    }
  }
}

// The cavity carry on tile t (quad_stage.cu describes the design) from its
// staged us, vs, p in `in` (kCavityInputs buffers) with the corrected u, v
// in `work` (tile::kWorkBuffers): the corrected u, v where the predictor
// reads them, u*, v* (over us, vs) where the source reads them (own cells,
// one row south, one column west), then us', vs', b and the guess 2p -
// p_prev of the own cells; m[0] takes max|b| and, kAdaptive, m[1], m[2]
// max|u|, max|v| of the corrected fields, over the own rows (kBlock: a
// local block's rows between its `halo`-row strips).
template <bool kAdaptive, bool kBlock, int NM>
__device__ __forceinline__ void cavity_tile(const tile::Tile& t, float* in, float* work,
                                            const float* p_prev, float* us2, float* vs2,
                                            float* b, float* guess, const Corr& c,
                                            const Pred& pc, int halo, float (&m)[NM]) {
  static_assert(NM == (kAdaptive ? 3 : 1), "max|b|, and the Courant maxima when adaptive");
  const int Hq8 = c.Hq8, Wqa = c.Wqa, plane = Hq8 * Wqa, LC = t.LC;
  float* const s_us = in;
  float* const s_vs = in + t.N;
  float* const s_p = in + 2 * t.N;
  float* const s_u = work;
  float* const s_v = work + t.N;
  const tile::Box A = tile::around(t, 2, 1, 2, 1), B = tile::around(t, 1, 0, 1, 0);
  const tile::View vus = tile::view(s_us, t), vvs = tile::view(s_vs, t);
  const tile::View vp = tile::view(s_p, t), vu = tile::view(s_u, t), vv = tile::view(s_v, t);
  const bool inner = tile::interior(t, A, c.ny, c.nx, Hq8);
  if (inner) {
    tile::each_cell(A, LC, [&](int lj, int li, int k) {
      const int j = t.gj + lj, i = t.ai + li;
      s_u[k] = u_corr_formula(vus, vp, j, i, c);
      s_v[k] = v_corr_formula(vvs, vp, j, i, c);
    });
    __syncthreads();
    predictor_box<true>(B, LC, t.gj, t.ai, vu, vv, s_us, s_vs, pc);
  } else {
    tile::each_cell(A, LC, [&](int lj, int li, int k) {
      float2 uv = make_float2(0.f, 0.f);  // outside the array a neighbour reads 0
      if (tile::in_array(t, lj, li, Hq8, Wqa)) {
        uv = cavity_uv_at(vus, vvs, vp, t.gj + lj, t.ai + li, c);
      }
      s_u[k] = uv.x;
      s_v[k] = uv.y;
    });
    __syncthreads();
    predictor_box<false>(B, LC, t.gj, t.ai, vu, vv, s_us, s_vs, pc);
  }
  __syncthreads();
  tile::each_own(t, Wqa, [&](int g, int gr, int lj0, int li0) {
    const bool own = !kBlock || (gr >= halo && gr < Hq8 - halo);
    float pp[4];
    tile::own4(p_prev, g, plane, pp);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lj = lj0 + (q >> 1), li = li0 + (q & 1);
      const int k = lj * LC + li, gq = q * plane + g;
      const float a = s_us[k], bv = s_vs[k];
      const float bb = source_at(s_us, s_vs, k, LC, t.gj + lj, t.ai + li, c.ny, c.nx, pc,
                                 inner);
      us2[gq] = a;
      vs2[gq] = bv;
      b[gq] = bb;
      guess[gq] = 2.0f * s_p[k] - pp[q];
      if (own) {
        m[0] = cfd::bits_max(m[0], fabsf(bb));
        if constexpr (kAdaptive) {
          m[1] = cfd::bits_max(m[1], fabsf(s_u[k]));
          m[2] = cfd::bits_max(m[2], fabsf(s_v[k]));
        }
      }
    }
  });
}

// The cavity's non-carry predictor + source on tile t (quad.py:438;
// quad_stage.cu describes the design) from its staged u, v in `in`
// (kPredictorInputs buffers) with u*, v* in `work` (tile::kWorkBuffers):
// the lid ghosts once on the staged u, v (a tile whose predictor box A
// lies off the ghost rows and columns skips them), u*, v* once a face on
// box B (the own cells, one row south, one column west), then us', vs' and
// b = rho/dt * div of the own cells. Returns their max|b|.
__device__ __forceinline__ float lid_predictor_source_tile(const tile::Tile& t, float* in,
                                                           float* work, float* us2,
                                                           float* vs2, float* b,
                                                           const Pred& pc, float two_lid) {
  const int Hq8 = pc.Hq8, Wqa = pc.Wqa, plane = Hq8 * Wqa, LC = t.LC;
  float* const s_u = in;
  float* const s_v = in + t.N;
  float* const s_us = work;
  float* const s_vs = work + t.N;
  const tile::Box A = tile::around(t, 2, 1, 2, 1), B = tile::around(t, 1, 0, 1, 0);
  const bool inner = tile::interior(t, A, pc.ny, pc.nx, Hq8);
  const tile::View vu = tile::view(s_u, t), vv = tile::view(s_v, t);
  if (inner) {
    predictor_box<true>(B, LC, t.gj, t.ai, vu, vv, s_us, s_vs, pc);
  } else {
    lid_ghosts(s_u, s_v, t.gj, t.ai, t.N / LC, LC, pc.ny, pc.nx, two_lid);
    __syncthreads();
    predictor_box<false>(B, LC, t.gj, t.ai, vu, vv, s_us, s_vs, pc);
  }
  __syncthreads();
  float m = 0.f;
  tile::each_own(t, Wqa, [&](int g, int, int lj0, int li0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lj = lj0 + (q >> 1), li = li0 + (q & 1);
      const int k = lj * LC + li, gq = q * plane + g;
      const float a = s_us[k], bv = s_vs[k];
      const float bb =
          source_at(s_us, s_vs, k, LC, t.gj + lj, t.ai + li, pc.ny, pc.nx, pc, inner);
      us2[gq] = a;
      vs2[gq] = bv;
      b[gq] = bb;
      m = cfd::bits_max(m, fabsf(bb));
    }
  });
  return m;
}

// The channel's arithmetic on a tile (tile::duct_tile): the rho-divided
// correction with the channel ghosts, the predictor with the channel ghosts
// on the tentative fields, the source on the cells
struct ChannelTile {
  Corr c;
  Pred pc;
  __device__ bool inner(const tile::Tile& t, const tile::Box& A) const {
    return tile::interior(t, A, c.ny, c.nx, c.Hq8);
  }
  __device__ float2 uv_formula(tile::View us, tile::View vs, tile::View p, int j, int i) const {
    return make_float2(u_corr_formula(us, p, j, i, c), v_corr_formula(vs, p, j, i, c));
  }
  __device__ float2 uv_at(tile::View us, tile::View vs, tile::View p, int j, int i) const {
    return channel_uv_at(us, vs, p, j, i, c);
  }
  __device__ float us_at(tile::View u, tile::View v, int j, int i) const {
    auto fu = [&](int jj, int ii) { return cfd::u_star_at(u, v, jj, ii, pc); };
    return channel_u(fu, j, i, c.ny, c.nx, c.ghost);
  }
  __device__ float vs_at(tile::View u, tile::View v, int j, int i) const {
    auto fv = [&](int jj, int ii) { return cfd::v_star_at(u, v, jj, ii, pc); };
    return channel_v(fv, j, i, c.ny, c.nx);
  }
  __device__ bool cell(int j, int i) const {
    return j >= 1 && j <= c.ny && i >= 1 && i <= c.nx;
  }
};

// The logical rows and columns the channel's non-carry predictor + source
// reaches around a tile's own cells (box A below: 2 rows south, 1 north, 3
// columns west, 1 east) and the inputs its tile stages: u, v (u*, v* go to
// the tile::kWorkBuffers buffers). Its halo is kernels/plan.py
// CARRY_RADIUS["channel_predictor"] logical cells, ceil(3 / 2) = 2 plane
// rows and columns.
constexpr int kChannelPredictorRadius = 3;
constexpr int kChannelPredictorInputs = 2;

// u* on box BU and v* on box BV of a tile's buffers (pitch LC, buffer cell
// (lj, li) at global logical (gj + lj, ai + li)) from the views u, v into
// the buffers us, vs, once a face: the *_formula arithmetic on the interior
// path (kInner: no face of the boxes is invalid or a ghost), else f's
// us_at, vs_at (the predictor on the valid faces, 0 off them, then the
// channel ghosts of the tentative fields, a ghost evaluating the face it
// copies). The predictor stage of the channel's non-carry predictor +
// source on both layouts (tile::duct_tile's second stage on the given u, v).
template <bool kInner>
__device__ __forceinline__ void channel_predictor_boxes(const ChannelTile& f,
                                                        const tile::Box& BU,
                                                        const tile::Box& BV, int LC, int gj,
                                                        int ai, tile::View u, tile::View v,
                                                        float* us, float* vs) {
  tile::each_cell(BU, LC, [&](int lj, int li, int k) {
    const int j = gj + lj, i = ai + li;
    if constexpr (kInner) {
      us[k] = cfd::u_star_formula(u, v, j, i, f.pc);
    } else {
      us[k] = f.us_at(u, v, j, i);
    }
  });
  tile::each_cell(BV, LC, [&](int lj, int li, int k) {
    const int j = gj + lj, i = ai + li;
    if constexpr (kInner) {
      vs[k] = cfd::v_star_formula(u, v, j, i, f.pc);
    } else {
      vs[k] = f.vs_at(u, v, j, i);
    }
  });
}

// The channel's non-carry predictor + source on tile t (quad.py:847;
// quad_stage.cu describes the design) from its staged u, v in `in`
// (kChannelPredictorInputs buffers, as given: no ghost applies to them)
// with u*, v* in `work` (tile::kWorkBuffers): u* once a face on the own
// cells and one column west, v* on the own cells and one row south, with
// the channel ghosts of the tentative fields (channel_predictor_boxes;
// box A, the positions they read, decides the interior path), then us',
// vs' and b = rho/dt * div on the flow's cells of the own cells.
__device__ __forceinline__ void channel_predictor_source_tile(const ChannelTile& f,
                                                              const tile::Tile& t, float* in,
                                                              float* work, float* us2,
                                                              float* vs2, float* b) {
  const int Wqa = f.c.Wqa, plane = f.c.Hq8 * Wqa, LC = t.LC;
  const Pred& pc = f.pc;
  float* const s_us = work;
  float* const s_vs = work + t.N;
  const tile::Box A = tile::around(t, 2, 1, 3, 1), BU = tile::around(t, 0, 0, 1, 0),
                  BV = tile::around(t, 1, 0, 0, 0);
  const bool inner = f.inner(t, A);
  const tile::View vu = tile::view(in, t), vv = tile::view(in + t.N, t);
  if (inner) {
    channel_predictor_boxes<true>(f, BU, BV, LC, t.gj, t.ai, vu, vv, s_us, s_vs);
  } else {
    channel_predictor_boxes<false>(f, BU, BV, LC, t.gj, t.ai, vu, vv, s_us, s_vs);
  }
  __syncthreads();
  tile::each_own(t, Wqa, [&](int g, int, int lj0, int li0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lj = lj0 + (q >> 1), li = li0 + (q & 1);
      const int k = lj * LC + li, gq = q * plane + g;
      const float a = s_us[k], bv = s_vs[k];
      const float bb =
          source_at(s_us, s_vs, k, LC, t.gj + lj, t.ai + li, f.c.ny, f.c.nx, pc, inner);
      us2[gq] = a;
      vs2[gq] = bv;
      b[gq] = bb;
    }
  });
}

}  // namespace quad
}  // namespace cfd
