// Stage kernels of the tentative-carry backward-facing step on the quad
// layout.
//
// Replaces cfd_tpu/kernels/step_quad.py make_quad_step_corr_predictor_source
// (:100, math in step_carry_compute :144-201; fixed dt, and traced_dt +
// emit_courant) and make_quad_step_corrector (:204; fixed and traced_dt).
// The carry, fixed and traced_dt + emit_courant, also runs with
// shard=(P, mdy) on one shard's local block (rows 16f and 16f+,
// cfd_tpu/parallel/quad_sharded.py): the arrays are a
// shard's (4, P + 16, Wqa) block between two 8-row halo strips, row_base =
// jy * P - 8 is the global plane row of local row 0 (every mask, inlet row
// and interface face keeps its global meaning, common.cuh), a neighbour
// outside the block reads 0, and the partial sums of b take the own rows
// only (cfd::own_row), in the twin's fold order: the shard's partial, as do
// the Courant maxima of the traced-dt instance. The
// carry's stages reach kStepRadius rows: the corrector (p at j+1), the step
// BCs on the corrected fields (the ghost rows read rows 1 and ny), the
// predictor (j-1 ... j+1), the step BCs on the tentative fields and the
// source (vs at j-1), one row each; inside the 8-row halo, so the own rows
// are exact. A whole field is row_base 0, halo 0, and its instances fold
// the row offset away at compile time (kBlock).
//
// Bound on the H100: device-memory bytes. The corrector reads 3 quad fields
// and writes 2; the carry reads 3 and writes 3 plus one scalar (2.5 MB per
// field at 2048x256). The arithmetic (about 85 flops a cell) is far below
// the card's rate.
//
// Design: the channel stage kernels' (quad_stage.cu) with the step's masks.
// One thread per quad cell; the per-cell bodies live in step_carry.cuh,
// which the whole-step kernel (whole_step.cu) runs too. The carry is three launches: (1) the corrected
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
#include "step_carry.cuh"

namespace {

using cfd::Pred;
using cfd::step::Step;

// the dependency radius of the carry's stages, in rows (above)
constexpr int kStepRadius = 5;
static_assert(kStepRadius <= 8, "the step carry reaches past the 8-row halo");

// kTraced: cu, cv formed from *dt (s0 holds rho*dx, rho*dy); kCourant:
// max|u|, max|v| of the outputs into courant[0], courant[1]; kBlock: a
// shard's local block (its row offset, and the Courant maxima over its own
// rows only, cfd::own_row)
template <bool kTraced, bool kCourant, bool kBlock = false>
__global__ void step_corrector_kernel(const float* us, const float* vs, const float* p,
                                      float* u2, float* v2, Step s0, const float* dt,
                                      float* courant, int halo) {
  Step s = s0;
  if constexpr (kTraced) {
    s.cu = cfd::traced_coeff<true>(*dt, s0.cu);
    s.cv = cfd::traced_coeff<true>(*dt, s0.cv);
  }
  const long long n = 4LL * s.Hq8 * s.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float au = 0.f, av = 0.f;
  if (idx < n) {
    const float2 a = cfd::step::corrector_cell<kBlock>(us, vs, p, u2, v2, idx, s);
    if (!kBlock || cfd::own_row(idx, s.Hq8, s.Wqa, halo)) {
      au = a.x;
      av = a.y;
    }
  }
  if constexpr (kCourant) cfd::block_max2_into(au, av, courant);
}

// predictor on valid faces, the step BCs on the tentative fields, b on the
// fluid cells, and the block's partial sum of b (fixed tree); kBlock: a
// shard's local block, whose partials take its own rows only (cfd::own_row)
template <bool kTraced, bool kBlock = false>
__global__ void step_predictor_source_kernel(const float* u, const float* v, float* us2,
                                             float* vs2, float* b, float* partials, Pred c0,
                                             Step s, const float* dt, int halo) {
  const Pred c = cfd::pred_at<kTraced>(c0, dt);
  const long long n = 4LL * s.Hq8 * s.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float part = 0.f;
  if (idx < n) {
    const float bb =
        cfd::step::predictor_source_cell<kBlock>(u, v, us2, vs2, b, idx, c, s);
    if (!kBlock || cfd::own_row(idx, s.Hq8, s.Wqa, halo)) part = bb;
  }
  cfd::block_sum_to(part, partials + blockIdx.x);
}

}  // namespace

namespace {

// the carry's three launches: corrector, predictor + source + partial sums
// (own rows of a block with a `halo`-row strip), fold
template <bool kAdaptive, bool kBlock = false>
cudaError_t step_carry(const float* us, const float* vs, const float* p, float* u_scr,
                       float* v_scr, float* us2, float* vs2, float* b, float* partials,
                       float* sum_b, float* courant, const float* dts, const Step& s,
                       const Pred& c, int halo, cudaStream_t st) {
  const int blocks = cfd::blocks_for(4LL * s.Hq8 * s.Wqa);
  step_corrector_kernel<kAdaptive, kAdaptive, kBlock><<<blocks, cfd::kThreads, 0, st>>>(
      us, vs, p, u_scr, v_scr, s, dts, courant, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  step_predictor_source_kernel<kAdaptive, kBlock><<<blocks, cfd::kThreads, 0, st>>>(
      u_scr, v_scr, us2, vs2, b, partials, c, s, kAdaptive ? dts + 1 : nullptr, halo);
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
                                                                  nullptr, nullptr, 0);
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
                                                                  nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch; row_base,
// halo: a local block's global plane row of row 0 and its halo strip (0, 0
// on a whole field), sum_b then the sum over the own rows
extern "C" int cfd_step_carry(const float* us, const float* vs, const float* p,
                              float* u_scr, float* v_scr, float* us2, float* vs2, float* b,
                              float* partials, float* sum_b, int Hq8, int Wqa, int ny,
                              int nx, int step_i, int inlet_j, float cu, float cv,
                              float uin, float dt, float nu, float idx, float idy,
                              float idx2, float idy2, float rho_dt, int row_base, int halo,
                              void* stream) {
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu, cv, uin, row_base};
  Pred c{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(step_carry<false, true>(us, vs, p, u_scr, v_scr, us2, vs2, b,
                                                    partials, sum_b, nullptr, nullptr, s, c,
                                                    halo, st));
  }
  return static_cast<int>(step_carry<false>(us, vs, p, u_scr, v_scr, us2, vs2, b, partials,
                                             sum_b, nullptr, nullptr, s, c, 0, st));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho*dx, rho*dy; courant: 2 floats, zeroed here; row_base,
// halo as cfd_step_carry's, the sum and the Courant maxima then over the
// own rows (row 16f+)
extern "C" int cfd_step_carry_adaptive(const float* us, const float* vs, const float* p,
                                       float* u_scr, float* v_scr, float* us2, float* vs2,
                                       float* b, float* partials, float* sum_b,
                                       float* courant, const float* dts, int Hq8, int Wqa,
                                       int ny, int nx, int step_i, int inlet_j, float cu_f,
                                       float cv_f, float uin, float nu, float idx, float idy,
                                       float idx2, float idy2, float rho, int row_base,
                                       int halo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu_f, cv_f, uin, row_base};
  Pred c{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(step_carry<true, true>(us, vs, p, u_scr, v_scr, us2, vs2, b,
                                                   partials, sum_b, courant, dts, s, c, halo,
                                                   st));
  }
  return static_cast<int>(step_carry<true>(us, vs, p, u_scr, v_scr, us2, vs2, b, partials,
                                            sum_b, courant, dts, s, c, 0, st));
}
