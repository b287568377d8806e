// Stage kernels of the Rayleigh-Benard tentative-carry step on the quad
// layout: the fused carry and the stats/export corrector.
//
// Replaces cfd_tpu/kernels/rb_quad.py make_quad_rb_step_kernel (:81, math in
// rb_carry_compute :130-222; the plain and emit_guess variants, and
// traced_dt + emit_courant) and make_quad_rb_corrector (:225; fixed and
// traced_dt).
//
// Bound on the H100: device-memory bytes. The carry reads 4 quad fields
// (5 with the warm-start guess) and writes 4 (5) plus one scalar, 3.8 MB per
// field at 1536x512; its arithmetic (about 110 flops a cell: the corrector,
// the temperature update, the predictor with buoyancy, the source) is far
// below the card's rate.
//
// Design: one thread per quad cell, neighbours through the guarded quad
// accessor, as csrc/quad_stage.cu; the per-cell bodies live in
// rb_carry.cuh, which the whole-step kernel (whole_step.cu) runs too. The
// stages depend on their neighbours' results of the stage before, so the
// carry runs as FOUR launches:
// (1) the corrector with the box no-slip ghosts writes the corrected u2, v2
// into scratch (and the guess 2p - p_prev), (2) the temperature stage reads
// T and the scratch u2, v2 and writes T' with its ghosts, (3) the predictor,
// the buoyancy from T', the box ghosts on the tentative fields, the source
// and the per-block partial sums of b, (4) one block folds the partials in
// the order of the PyTorch twin's fixed_order_sum. A thread that writes a
// ghost recomputes the pre-ghost value it copies from (box_u, box_v,
// temperature), so no stage needs a second pass for its ghosts.
//
// The corrector keeps the tentative value on invalid faces (u_else = us,
// rb_quad.py:171-174, 251-252), unlike the cavity and channel correctors,
// which write 0 there.
//
// Ghost order (rb_quad.py:40-78): u's ghost rows j = 0 and ny+1 (i <= nx)
// are minus rows 1 and ny, read BEFORE the side columns i = 0 and nx are
// zeroed, so u's four corner ghosts are minus the pre-ghost side-column
// values; v's ghost columns i = 0 and nx+1 (j <= ny) read columns 1 and nx
// before the wall rows j = 0 and ny are zeroed. T's ghost rows (1 <= i <=
// nx) reflect the wall values, its ghost columns (1 <= j <= ny) copy
// columns 1 and nx, and its four corners keep the pre-step T.
//
// One shard's local block (row 16e, shard=(P, mdy) of rb_quad.py:81 under
// cfd_tpu/parallel/quad_sharded.py): the carry's arrays are a shard's
// (4, P + 16, Wqa) block between two 8-row halo strips and row_base =
// jy * P - 8 is the global plane row of local row 0, as the cavity's and
// the channel's (csrc/quad_stage.cu): the ghosts test the global row, so
// the T ghost rows j = 0 and ny + 1 and the walls are written by the shard
// that holds them; a neighbour outside the block reads 0 (the scratch u2,
// v2 and T' exist on the block only); the partial sums of b take the own
// rows only, and so do the Courant maxima of its traced-dt instance (row
// 16e+). The stages' dependency radius (kRBRadius), one row for each:
// the corrector (p at j+1), the box ghosts (the ghost rows read rows 1 and
// ny), the temperature transport (T, v2 at j-1 ... j+1), the T ghosts, the
// predictor with the buoyancy (u2, v2 at j-1 ... j+1, T' at j+1), the box
// ghosts on the tentative fields and the source (vs at j-1): 7 rows, inside
// the 8-row halo, so the own rows are exact. A whole field is row_base 0,
// halo 0, and its instances fold the row offset away at compile time
// (kBlock).
//
// Adaptive stepping (template flags kTraced, kCourant, as csrc/quad_stage.cu):
// the carry completes step n with dt_corr, the corrector AND the temperature
// transport (rb_quad.py:153-157), and advances step n+1 with dt_pred, the
// predictor, the buoyancy dt_pred * 0.5 (rb_quad.py:195) and the source; the
// corrector reduces max|u2|, max|v2| (rb_quad.py:211).
#include "common.cuh"
#include "predictor.cuh"
#include "rb_carry.cuh"

namespace {

using cfd::Pred;
using cfd::rb::RBCorr;
using cfd::rb::RBTemp;

// the dependency radius of the carry's stages, in rows (above)
constexpr int kRBRadius = 7;
static_assert(kRBRadius <= 8, "the RB carry reaches past the 8-row halo");

// launch 1 (and the corrector entry point): the corrected, ghosted u2, v2;
// guess = 2p - p_prev where p_prev is given. kTraced: cu, cv formed from
// *dt (c0 holds rho*dx, rho*dy); kCourant: max|u2|, max|v2| into courant[0],
// courant[1]; kBlock: a shard's local block (its row offset, and the
// Courant maxima over its own rows only, cfd::own_row), else row0 folds to 0
template <bool kTraced, bool kCourant, bool kBlock = false>
__global__ void rb_corrector_kernel(const float* us, const float* vs, const float* p,
                                    const float* p_prev, float* u2, float* v2, float* guess,
                                    RBCorr c0, const float* dt, float* courant, int halo) {
  RBCorr c = c0;
  if constexpr (!kBlock) c.row0 = 0;
  if constexpr (kTraced) {
    c.cu = cfd::traced_coeff<true>(*dt, c0.cu);
    c.cv = cfd::traced_coeff<true>(*dt, c0.cv);
  }
  const long long n = 4LL * c.Hq8 * c.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float au = 0.f, av = 0.f;
  if (idx < n) {
    const float2 a = cfd::rb::corrector_cell(us, vs, p, p_prev, u2, v2, guess, idx, c);
    if (!kBlock || cfd::own_row(idx, c.Hq8, c.Wqa, halo)) {
      au = a.x;
      av = a.y;
    }
  }
  if constexpr (kCourant) cfd::block_max2_into(au, av, courant);
}

// launch 2: T' with the Dirichlet ghost rows and the adiabatic ghost columns
// (kTraced: over the step of *dt, dt_corr)
template <bool kTraced, bool kBlock = false>
__global__ void rb_temperature_kernel(const float* T, const float* u, const float* v,
                                      float* T2, RBTemp c0, const float* dt) {
  RBTemp c = c0;
  if constexpr (!kBlock) c.row0 = 0;
  if constexpr (kTraced) c.dt = *dt;
  const long long n = 4LL * c.Hq8 * c.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  cfd::rb::temperature_cell(T, u, v, T2, idx, c);
}

// launch 3: the predictor, the buoyancy, the box ghosts, the source and the
// block's partial sum of b (fixed tree; kBlock: the own rows of a shard's
// block only, cfd::own_row). kTraced: dt, rho/dt and buoy = dt * 0.5 from
// *dt (dt_pred), the reference's (dt_pred * buoyancy) * 0.5 at buoyancy 1
template <bool kTraced, bool kBlock = false>
__global__ void rb_predictor_source_kernel(const float* u, const float* v, const float* T2,
                                           float* us2, float* vs2, float* b, float* partials,
                                           Pred c0, float buoy0, const float* dt, int halo) {
  Pred c = cfd::pred_at<kTraced>(c0, dt);
  if constexpr (!kBlock) c.row0 = 0;
  const float buoy = kTraced ? c.dt * 0.5f : buoy0;
  const long long n = 4LL * c.Hq8 * c.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float part = 0.f;
  if (idx < n) {
    const float bb = cfd::rb::predictor_source_cell(u, v, T2, us2, vs2, b, idx, c, buoy);
    if (!kBlock || cfd::own_row(idx, c.Hq8, c.Wqa, halo)) part = bb;
  }
  cfd::block_sum_to(part, partials + blockIdx.x);
}

}  // namespace

namespace {

// the carry's four launches; kAdaptive: dts = (dt_corr, dt_pred) on the
// card; kBlock: a shard's local block with a `halo`-row strip
template <bool kAdaptive, bool kBlock = false>
cudaError_t rb_carry(const float* us, const float* vs, const float* p, const float* T,
                     const float* p_prev, float* u_scr, float* v_scr, float* us2, float* vs2,
                     float* T2, float* b, float* guess, float* partials, float* sum_b,
                     float* courant, const float* dts, const RBCorr& cc, const RBTemp& tc,
                     const Pred& pc, float buoy, int halo, cudaStream_t s) {
  if ((p_prev == nullptr) != (guess == nullptr)) return cudaErrorInvalidValue;
  const int blocks = cfd::blocks_for(4LL * cc.Hq8 * cc.Wqa);
  rb_corrector_kernel<kAdaptive, kAdaptive, kBlock><<<blocks, cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u_scr, v_scr, guess, cc, dts, courant, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rb_temperature_kernel<kAdaptive, kBlock><<<blocks, cfd::kThreads, 0, s>>>(
      T, u_scr, v_scr, T2, tc, dts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rb_predictor_source_kernel<kAdaptive, kBlock><<<blocks, cfd::kThreads, 0, s>>>(
      u_scr, v_scr, T2, us2, vs2, b, partials, pc, buoy, kAdaptive ? dts + 1 : nullptr, halo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cfd::fold_partials(partials, blocks, sum_b, s);  // launch 4
}

}  // namespace

extern "C" int cfd_rb_corrector(const float* us, const float* vs, const float* p, float* u2,
                                float* v2, int Hq8, int Wqa, int ny, int nx, float cu,
                                float cv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RBCorr c{Hq8, Wqa, ny, nx, cu, cv};
  rb_corrector_kernel<false, false><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, nullptr, u2, v2, nullptr, c, nullptr, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// traced dt: *dt on the card; cu_f, cv_f the float32 rho*dx, rho*dy
extern "C" int cfd_rb_corrector_traced(const float* us, const float* vs, const float* p,
                                       float* u2, float* v2, const float* dt, int Hq8,
                                       int Wqa, int ny, int nx, float cu_f, float cv_f,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RBCorr c{Hq8, Wqa, ny, nx, cu_f, cv_f};
  rb_corrector_kernel<true, false><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, nullptr, u2, v2, nullptr, c, dt, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// p_prev and guess: both null (plain carry) or both given (emit_guess);
// u_scr, v_scr: quad scratch; partials: cfd::blocks_for(4 * Hq8 * Wqa)
// floats of scratch; two_tb, two_tt: 2 * the wall temperatures; buoy:
// dt * 0.5 (the free-fall buoyancy 1); row_base, halo: a local block's
// global plane row of row 0 and its halo strip (0, 0 on a whole field),
// sum_b then the sum over the own rows
extern "C" int cfd_rb_carry(const float* us, const float* vs, const float* p, const float* T,
                            const float* p_prev, float* u_scr, float* v_scr, float* us2,
                            float* vs2, float* T2, float* b, float* guess, float* partials,
                            float* sum_b, int Hq8, int Wqa, int ny, int nx, float cu, float cv,
                            float dt, float nu, float idx, float idy, float idx2, float idy2,
                            float rho_dt, float kappa, float two_tb, float two_tt, float buoy,
                            int row_base, int halo, void* stream) {
  RBCorr cc{Hq8, Wqa, ny, nx, cu, cv, row_base};
  RBTemp tc{Hq8, Wqa, ny, nx, dt, kappa, idx, idy, idx2, idy2, two_tb, two_tt, row_base};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(rb_carry<false, true>(us, vs, p, T, p_prev, u_scr, v_scr, us2, vs2,
                                                  T2, b, guess, partials, sum_b, nullptr,
                                                  nullptr, cc, tc, pc, buoy, halo, s));
  }
  return static_cast<int>(rb_carry<false>(us, vs, p, T, p_prev, u_scr, v_scr, us2, vs2, T2, b,
                                           guess, partials, sum_b, nullptr, nullptr, cc, tc, pc,
                                           buoy, 0, s));
}

// traced_dt + emit_courant (no guess: the adaptive RB step warm-starts from
// plain p, and so does the sharded one): dts = (dt_corr, dt_pred) on the
// card; cu_f, cv_f the float32 rho*dx, rho*dy; courant: 2 floats, zeroed
// here; row_base, halo as cfd_rb_carry's, the sum and the Courant maxima
// then over the own rows (row 16e+)
extern "C" int cfd_rb_carry_adaptive(const float* us, const float* vs, const float* p,
                                     const float* T, float* u_scr, float* v_scr, float* us2,
                                     float* vs2, float* T2, float* b, float* partials,
                                     float* sum_b, float* courant, const float* dts, int Hq8,
                                     int Wqa, int ny, int nx, float cu_f, float cv_f, float nu,
                                     float idx, float idy, float idx2, float idy2, float rho,
                                     float kappa, float two_tb, float two_tt, int row_base,
                                     int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  RBCorr cc{Hq8, Wqa, ny, nx, cu_f, cv_f, row_base};
  RBTemp tc{Hq8, Wqa, ny, nx, 0.f, kappa, idx, idy, idx2, idy2, two_tb, two_tt, row_base};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(rb_carry<true, true>(us, vs, p, T, nullptr, u_scr, v_scr, us2,
                                                 vs2, T2, b, nullptr, partials, sum_b, courant,
                                                 dts, cc, tc, pc, 0.f, halo, s));
  }
  return static_cast<int>(rb_carry<true>(us, vs, p, T, nullptr, u_scr, v_scr, us2, vs2, T2, b,
                                          nullptr, partials, sum_b, courant, dts, cc, tc, pc,
                                          0.f, 0, s));
}
