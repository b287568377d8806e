// The whole projection time step in ONE cooperative launch: the flavor's
// tentative-carry stages, the source mean removal, the tolerance and the
// whole tolerance-driven multigrid solve.
//
// Replaces cfd_tpu/kernels/whole_step.py make_quad_whole_step_cavity
// (:165), make_quad_whole_step_channel (:186), make_quad_whole_step_rb
// (:211) and make_quad_whole_step_step (:239), all built by
// _make_whole_step (:75, pl.pallas_call at :144):
//
//   (us, vs, p[, p_prev | T]) -> (us', vs', p'[, T'], cycles, res)
//
// Bound on the H100: the carried state read once and written once (4 or 5
// quad fields, 19 MB each at 2048^2, 2.5-3.8 MB at the other flows) plus
// the solve's V-cycles, which at these sizes run mostly from the 50 MB L2
// cache and are bound by their chains of dependent phases (whole_solve.cu).
// The TPU kernel kept b and every intermediate in VMEM; here they stay in
// device memory (scratch the caller allocates once), which the L2 serves.
//
// Design: the whole-solve's persistent grid and launch plan (whole_solve.cu,
// kernels/plan.py), launched with cudaLaunchCooperativeKernel. The carry's
// dependent stages, which the standalone carries run as separate launches
// (quad_stage.cu, step_stage.cu, rb_stage.cu), run here as grid-stride
// phases separated by grid.sync(), through the same per-cell bodies
// (quad_carry.cuh, step_carry.cuh, rb_carry.cuh):
//
//   cavity   corrector (+ guess 2p - p_prev into the output p),
//            predictor + source + max|b|
//   channel  corrector (+ guess), predictor + source + per-chunk sums,
//            fold, mean removal + max|b|
//   step     corrector (+ the plain previous p into the output p),
//            predictor + source + per-chunk sums, fold, mean removal +
//            max|b| (fluid cells only)
//   RB       corrector (+ the previous p), temperature, predictor +
//            buoyancy + source + per-chunk sums, fold, mean removal +
//            max|b|
//
// then the solve's cycles (cfd::ws::solve_cycles) from the warm start in
// the output p, with the tolerance max(tol_factor * max|b|, abs_tol) formed
// after the mean removal. The flavor is a template parameter: four
// instances, the step's with the masked solve, RB's with the pin_mean
// phase.
//
// Sums and maxima repeat the composed path's order exactly: the predictor
// phase walks the quad cells in 256-wide chunks, one 256-thread group of a
// block a chunk (cfd::ws::chunk_sums), and sums each by the fixed tree of
// cfd::block_sum_to, as the standalone predictor's blocks do; one block folds the partials in fold_sum's order;
// the mean is the IEEE float32 division sum_b / n_fluid, subtracted on the
// cells, as solver.remove_mean_quad does; maxima are taken on int bits. So
// the step equals the composition carry -> remove_mean_quad -> whole-solve
// bit for bit, with the same cycles.
//
// The control slots (max|b|, the two residual slots, the sum) are zeroed by
// the first thread before the first barrier, so one step is exactly one
// launch; (cycles, res) go to a 2-int output the caller allocates fresh for
// every call.
#include "quad_carry.cuh"
#include "rb_carry.cuh"
#include "step_carry.cuh"
#include "whole_solve.cuh"

namespace {

namespace cg = cooperative_groups;
using cfd::ws::Params;
using cfd::ws::Sweep;

enum Flavor : int { kCavity = 0, kChannel = 1, kRB = 2, kStep = 3 };

struct Carry {
  const float* us;
  const float* vs;
  const float* p;
  const float* p_prev;  // cavity, channel: the previous step's p
  const float* T;       // RB
  float* us2;
  float* vs2;
  float* T2;            // RB
  float* u_scr;         // the corrected u, v (scratch)
  float* v_scr;
  float* b;             // the source (scratch), the solve's b0
  float* partials;      // blocks_for(4 * Hq8 * Wqa) floats
  cfd::quad::Corr qc;   // cavity, channel (ghost: 2 * lid, or the inlet velocity)
  cfd::step::Step sc;   // step
  cfd::rb::RBCorr rc;   // RB
  cfd::rb::RBTemp rt;   // RB
  cfd::Pred pc;
  float buoy;           // RB: dt * 0.5
  float n_fluid;        // the cells the mean is taken over
};

template <int kFlavor>
__global__ void __launch_bounds__(cfd::ws::kBlockThreads, 1) whole_step_kernel(Params P,
                                                                             Carry C) {
  constexpr bool kMasked = kFlavor == kStep;
  cg::grid_group grid = cg::this_grid();
  const Sweep s{static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
                static_cast<long long>(gridDim.x) * blockDim.x};
  const int Hq8 = P.L0.Hq8, Wqa = P.L0.Wqa;
  const long long n0 = 4LL * Hq8 * Wqa;

  // the corrector into the scratch u, v and the warm start into the output p
  if (s.first == 0) {
    for (int k = 0; k < 4; ++k) P.ctl[k] = 0.f;
  }
  s.each(n0, [&](long long idx) {
    if constexpr (kFlavor == kCavity) {
      cfd::quad::cavity_corrector_cell(C.us, C.vs, C.p, C.p_prev, C.u_scr, C.v_scr, P.p0,
                                       idx, C.qc);
    } else if constexpr (kFlavor == kChannel) {
      cfd::quad::channel_corrector_cell(C.us, C.vs, C.p, C.p_prev, C.u_scr, C.v_scr, P.p0,
                                        idx, C.qc);
    } else if constexpr (kFlavor == kStep) {
      cfd::step::corrector_cell(C.us, C.vs, C.p, C.u_scr, C.v_scr, idx, C.sc);
      P.p0[idx] = C.p[idx];
    } else {
      cfd::rb::corrector_cell(C.us, C.vs, C.p, nullptr, C.u_scr, C.v_scr, nullptr, idx,
                              C.rc);
      P.p0[idx] = C.p[idx];
    }
  });
  grid.sync();
  if constexpr (kFlavor == kRB) {
    s.each(n0, [&](long long idx) {
      cfd::rb::temperature_cell(C.T, C.u_scr, C.v_scr, C.T2, idx, C.rt);
    });
    grid.sync();
  }

  if constexpr (kFlavor == kCavity) {
    // predictor + source + max|b| (no mean removal: the operator is
    // nonsingular)
    float m = 0.f;
    s.each(n0, [&](long long idx) {
      const float bb = cfd::quad::predictor_source_cell<false>(C.u_scr, C.v_scr, C.us2,
                                                               C.vs2, C.b, idx, C.pc, 0.f);
      m = cfd::bits_max(m, fabsf(bb));
    });
    cfd::ws::block_max_into(m, P.ctl);
    grid.sync();
  } else {
    // predictor + source by kSumChunk-wide chunks, each summed by the fixed
    // tree into its partial
    const int chunks = static_cast<int>((n0 + cfd::ws::kSumChunk - 1) / cfd::ws::kSumChunk);
    cfd::ws::chunk_sums(n0, C.partials, [&](long long idx) {
      if constexpr (kFlavor == kChannel) {
        return cfd::quad::channel_predictor_source_cell(C.u_scr, C.v_scr, C.us2, C.vs2, C.b,
                                                        idx, C.pc, C.qc.ghost);
      } else if constexpr (kFlavor == kStep) {
        return cfd::step::predictor_source_cell(C.u_scr, C.v_scr, C.us2, C.vs2, C.b, idx,
                                                C.pc, C.sc);
      } else {
        return cfd::rb::predictor_source_cell(C.u_scr, C.v_scr, C.T2, C.us2, C.vs2, C.b, idx,
                                              C.pc, C.buoy);
      }
    });
    grid.sync();
    if (blockIdx.x == 0) {
      const float sum = cfd::fold_sum(C.partials, chunks, static_cast<int>(threadIdx.x),
                                      static_cast<int>(blockDim.x), [] { __syncthreads(); });
      if (threadIdx.x == 0) P.ctl[3] = sum;
    }
    grid.sync();
    // b - sum_b / n_fluid on the cells (the fluid cells of the step), and
    // max|b| of the result
    const float mean = __ldcg(P.ctl + 3) / C.n_fluid;
    float m = 0.f;
    s.each(n0, [&](long long idx) {
      const cfd::QuadCell q = cfd::quad_cell(idx, Hq8, Wqa);
      bool cell;
      if constexpr (kFlavor == kStep) {
        cell = cfd::step::fluid(q.j, q.i, C.sc);
      } else {
        cell = q.j >= 1 && q.j <= P.L0.ny && q.i >= 1 && q.i <= P.L0.nx;
      }
      float bv = C.b[idx];
      if (cell) {
        bv = bv - mean;
        C.b[idx] = bv;
      }
      m = cfd::bits_max(m, fabsf(bv));
    });
    cfd::ws::block_max_into(m, P.ctl);
    grid.sync();
  }
  cfd::ws::solve_cycles<kMasked>(s, grid, P, __ldcg(P.ctl));
}

void* kernel_of(int flavor) {
  switch (flavor) {
    case kCavity:
      return reinterpret_cast<void*>(whole_step_kernel<kCavity>);
    case kChannel:
      return reinterpret_cast<void*>(whole_step_kernel<kChannel>);
    case kRB:
      return reinterpret_cast<void*>(whole_step_kernel<kRB>);
    case kStep:
      return reinterpret_cast<void*>(whole_step_kernel<kStep>);
    default:
      return nullptr;
  }
}

}  // namespace

// Readies a flavor's kernel (0 cavity, 1 channel, 2 RB, 3 step) on the
// current device and returns its co-residency at smem_bytes of dynamic
// shared memory a block (cfd::ws::coop_grid): blocks, blocks per SM,
// registers.
extern "C" int cfd_whole_step_grid(int flavor, int smem_bytes, int* blocks, int* per_sm,
                                   int* regs) {
  const void* fn = kernel_of(flavor);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cfd::ws::coop_grid(fn, smem_bytes, blocks, per_sm, regs);
}

// One time step of a flavor. io (a host array): us, vs, p, p_prev (cavity,
// channel) or T (RB) or null (step), us2, vs2, T2 (RB, else null), u_scr,
// v_scr, b (quad scratch), partials (blocks_for(4 * Hq8 * Wqa) floats). cf
// (a host array): cu, cv, ghost (2 * lid or the inlet velocity), dt, nu,
// idx, idy, idx2, idy2, rho_dt, kappa, 2 * t_bottom, 2 * t_top, buoy,
// n_fluid. The rest are cfd_whole_solve's arguments from `masked` on, with
// p_in and max_b unused (the warm start and max|b| are formed in-kernel):
// masked must be 1 exactly for the step and pin_mean 1 exactly for RB; p0
// receives p', stats (2 ints) the cycles and the bits of the final residual;
// store_bf16, corr_opt (the step only), rc32 and the plan as for
// cfd_whole_solve; cfd_whole_step_grid readies the kernel.
extern "C" int cfd_whole_step(int flavor, void* const* io, const float* cf, int masked,
                              float* p0, float* q0, float* filled, float* ctl, int* stats,
                              const float* pinv, const float* wE,
                              const float* wW, const float* wN, const float* wS, int Hq8,
                              int Wqa, int ny, int nx, int step_i, int inlet_j, float idx2,
                              float idy2, float denom, float one_minus_omega, int n_coarse,
                              const int* idims, const float* fdims, void* const* ptrs,
                              float omega, int pre, int post, int max_cycles,
                              float tol_factor, float abs_tol, float stall, int pin_mean,
                              float* partials, float n_int, int store_bf16, int corr_opt,
                              float* rc32, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = kernel_of(flavor);
  if (fn == nullptr || masked != (flavor == kStep) || pin_mean != (flavor == kRB)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Carry C{};
  C.us = static_cast<const float*>(io[0]);
  C.vs = static_cast<const float*>(io[1]);
  C.p = static_cast<const float*>(io[2]);
  if (flavor == kRB) {
    C.T = static_cast<const float*>(io[3]);
  } else {
    C.p_prev = static_cast<const float*>(io[3]);
  }
  C.us2 = static_cast<float*>(io[4]);
  C.vs2 = static_cast<float*>(io[5]);
  C.T2 = static_cast<float*>(io[6]);
  C.u_scr = static_cast<float*>(io[7]);
  C.v_scr = static_cast<float*>(io[8]);
  C.b = static_cast<float*>(io[9]);
  C.partials = static_cast<float*>(io[10]);
  const bool needs_io3 = flavor != kStep;
  if (C.us == nullptr || C.vs == nullptr || C.p == nullptr || C.us2 == nullptr ||
      C.vs2 == nullptr || C.u_scr == nullptr || C.v_scr == nullptr || C.b == nullptr ||
      (needs_io3 && io[3] == nullptr) || (flavor == kRB && C.T2 == nullptr) ||
      (flavor != kCavity && C.partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  C.qc = cfd::quad::Corr{Hq8, Wqa, ny, nx, cf[0], cf[1], cf[2]};
  C.sc = cfd::step::Step{Hq8, Wqa, ny, nx, step_i, inlet_j, cf[0], cf[1], cf[2]};
  C.rc = cfd::rb::RBCorr{Hq8, Wqa, ny, nx, cf[0], cf[1]};
  C.rt = cfd::rb::RBTemp{Hq8, Wqa, ny, nx, cf[3], cf[10], cf[5], cf[6], cf[7], cf[8],
                         cf[11], cf[12]};
  C.pc = cfd::Pred{Hq8, Wqa, ny, nx, cf[3], cf[4], cf[5], cf[6], cf[7], cf[8], cf[9]};
  C.buoy = cf[13];
  C.n_fluid = cf[14];
  if (flavor != kCavity && !(C.n_fluid > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  int e = cfd::ws::solve_params(&P, masked, nullptr, C.b, p0, q0, filled, nullptr, ctl, stats,
                                pinv, wE, wW, wN, wS, Hq8, Wqa, ny, nx, step_i, inlet_j,
                                idx2, idy2, denom, one_minus_omega, n_coarse, idims, fdims,
                                ptrs, omega, pre, post, max_cycles, tol_factor, abs_tol,
                                stall, pin_mean, partials, n_int, store_bf16, corr_opt, rc32,
                                plan);
  if (e) return e;
  void* args[] = {&P, &C};
  return static_cast<int>(cudaLaunchCooperativeKernel(fn, P.plan.blocks, cfd::ws::kBlockThreads,
                                                      args, P.plan.smem_bytes, s));
}
