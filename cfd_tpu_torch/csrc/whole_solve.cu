// The whole tolerance-driven multigrid solve of a quad path in ONE
// cooperative launch: the separable flavor (cavity, channel) and the masked
// flavor (the backward step).
//
// Replaces cfd_tpu/kernels/whole_solve.py make_quad_whole_solve (:507;
// the body is separable_vcycle_ctx :178 inside _solve_from_ctx :442 and
// tolerance_loop :138; with or without pin_mean) and
// make_quad_step_whole_solve (:569; the body is
// masked_vcycle_ctx :297-424): the finest-level pairs, residual and restriction,
// the coarse hierarchy (kernels/mg_tail.py run_tail_vcycle), the coarsest
// dense pseudo-inverse, the prolongations and post pairs back up, the
// tolerance residual max and the stop rule, for every cycle of one solve.
//
// Bound on the H100: at the channel's 1536x512 the finest quad field is
// 3.8 MB and the whole hierarchy about 10 MB, so after the first cycle every
// level is served from the 50 MB L2 cache. What bounds a cycle is then the
// number of dependent phases: each red or black half-sweep needs the other
// colour's final values over the whole level, so the grid synchronises
// between phases (about 60 grid-wide barriers a V(1,2) cycle on 8 levels).
// The per-kernel composition pays a launch and a host round trip for each
// of those steps instead (PERF.md section 5).
//
// Design: one persistent grid of kThreads-thread blocks, as many as can be
// co-resident (the occupancy API, at most kMaxBlocksPerSM per SM, since a
// grid-wide barrier costs more with more blocks), launched with
// cudaLaunchCooperativeKernel; every phase is a grid-stride loop followed by
// cooperative_groups' grid sync. The iterate and source of every level stay
// in device memory (scratch the caller allocates once). The device code
// (the phases and the cycle loop) lives in whole_solve.cuh, which the
// whole-step kernel (whole_step.cu) runs after its carry stages. The
// arithmetic of each phase is the per-kernel path's, through the same
// device functions
// (quad_level0.cuh, step_level0.cuh, aligned_level.cuh) or, for the
// transfers between coarse levels and the coarsest solve, in the exact
// operation order of their PyTorch glue (kernels/mg_tail.py _restrict,
// _solid_fill, _prolong, dense_coarse_solve), so the solve equals the
// per-kernel composition bit for bit.
//
// The masked flavor (kMasked): the finest level is the step's exact
// operator (step_level0.cuh). Its ghost stage reads one array and writes
// another, so the finest iterate alternates between the output array and a
// scratch array, phase by phase exactly as the per-kernel kernels
// (step_vcycle.cu) run it; the coarse levels carry full-2D weights, and a
// correction leaving a masked coarse level is first solid-filled into a
// scratch array (a phase of its own: the fill reads the neighbours of the
// cells it writes).
//
// Reductions and the stop rule: max|b| and each cycle's residual max are
// taken on the int bits of |x| with atomicMax (order-independent, so exact).
// The residual goes to one of two slots by cycle parity; the slot the next
// cycle uses is zeroed after the first barrier of this cycle, when no
// thread reads it any more. After each cycle's last barrier every thread
// reads the slot and evaluates the same float32 stop rule as the host loop
// (poisson/multigrid.py tolerance_loop), so all blocks leave together.
//
// The bfloat16 hierarchy (store_bf16, coarse_dtype="bfloat16";
// whole_solve.py:156, 216-219, 340): the buffers stay float32 and every
// value is rounded where the reference stores it in bfloat16: each coarse
// source b[k] as it is written (the fine and coarse restrictions), each
// pre-smoothed iterate ps[k] as the prolong-add reads it (a cell reads only
// its own value there), the weights and the pinv by the caller; the
// arithmetic and the correction between levels stay float32. corr_opt
// (masked; whole_solve.py:379-398): after the ascent, one more phase scales
// the level-1 correction by its clamped line-search steplength from the
// unrounded rc (whole_solve.cuh corr_alpha_phase), three barriers a cycle.
//
// The pure-Neumann mean pin (pin_mean, the Rayleigh-Benard solve;
// whole_solve.py:285-289): after each cycle's tolerance residual, which is
// taken BEFORE the shift as in the reference, every block sums its
// kThreads-wide chunks of p by the fixed tree into per-chunk partials, one
// block folds the partials in fixed_order_sum's order after a grid sync,
// and after a second grid sync every thread subtracts sum / n_int (an IEEE
// division) on the quad cells. p is 0 off the cells by construction, so the
// sum over the whole array is the cell sum. Two more barriers a cycle; the
// host loop's twin (MultigridPoisson.cycle) does the same arithmetic.
#include "whole_solve.cuh"

namespace {

namespace cg = cooperative_groups;
using cfd::ws::Params;
using cfd::ws::Sweep;

template <bool kMasked>
__global__ void __launch_bounds__(cfd::kThreads) whole_solve_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const Sweep s{static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
                static_cast<long long>(gridDim.x) * blockDim.x};
  const long long n0 = 4LL * P.L0.Hq8 * P.L0.Wqa;

  // the warm start into the output, and max|b| for the tolerance
  float m = 0.f;
  s.each(n0, [&](long long idx) {
    P.p0[idx] = P.p_in[idx];
    m = cfd::bits_max(m, fabsf(P.b0[idx]));
  });
  if (P.max_b == nullptr) cfd::block_max_into(m, P.ctl);
  grid.sync();
  const float max_b = P.max_b != nullptr ? *P.max_b : __ldcg(P.ctl);
  cfd::ws::solve_cycles<kMasked>(s, grid, P, max_b);
}

void* kernel_of(int masked) {
  return masked ? reinterpret_cast<void*>(whole_solve_kernel<true>)
                : reinterpret_cast<void*>(whole_solve_kernel<false>);
}

}  // namespace

// Grid of the cooperative launch of the separable (masked = 0) or masked
// kernel on the current device: blocks, blocks per SM, and the kernel's
// registers per thread (for the build log).
extern "C" int cfd_whole_solve_grid(int masked, int* blocks, int* per_sm, int* regs) {
  return cfd::ws::coop_grid(kernel_of(masked), blocks, per_sm, regs);
}

// masked: 0 = the separable flavor (fine weights wE..wS, q0, filled and the
// step geometry unused), 1 = the masked flavor (wE..wS null; q0 a quad
// field, filled a level-1-size array). idims: n_coarse * (H8, W, ny, nx,
// full); fdims: n_coarse * (idx2, idy2); ptrs: n_coarse * (wE, wW, wN, wS,
// p, b), levels 1..n_coarse, all host arrays. ctl: 4 floats of device
// scratch; stats: 2 ints, the cycles and the bits of the final float32
// residual; fold: n * n floats for the coarsest level. pin_mean (separable
// only): partials is blocks_for(4 * Hq8 * Wqa) floats of scratch and n_int
// the interior cell count. corr_opt (masked only): partials is 2 *
// blocks_for(H8 * W of level 1) floats of scratch. Otherwise partials is
// null. store_bf16: the bfloat16 rounding points of the hierarchy (the
// caller passes weights and pinv already rounded); rc32, a level-1-size
// array, exactly when corr_opt and store_bf16 are both on.
extern "C" int cfd_whole_solve(int masked, const float* p_in, const float* b0, float* p0,
                               float* q0, float* filled, const float* max_b, float* ctl,
                               int* stats, float* fold, const float* pinv, const float* wE,
                               const float* wW, const float* wN, const float* wS, int Hq8,
                               int Wqa, int ny, int nx, int step_i, int inlet_j, float idx2,
                               float idy2, float denom, float one_minus_omega, int n_coarse,
                               const int* idims, const float* fdims, void* const* ptrs,
                               float omega, int pre, int post, int max_cycles,
                               float tol_factor, float abs_tol, float stall, int pin_mean,
                               float* partials, float n_int, int store_bf16, int corr_opt,
                               float* rc32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params P;
  int e = cfd::ws::solve_params(&P, masked, p_in, b0, p0, q0, filled, max_b, ctl, stats, fold,
                                pinv, wE, wW, wN, wS, Hq8, Wqa, ny, nx, step_i, inlet_j, idx2,
                                idy2, denom, one_minus_omega, n_coarse, idims, fdims, ptrs,
                                omega, pre, post, max_cycles, tol_factor, abs_tol, stall,
                                pin_mean, partials, n_int, store_bf16, corr_opt, rc32);
  if (e) return e;
  int blocks = 0, per_sm = 0, regs = 0;
  e = cfd_whole_solve_grid(masked, &blocks, &per_sm, &regs);
  if (e) return e;
  cudaError_t err = cudaMemsetAsync(ctl, 0, 4 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(kernel_of(masked), blocks, cfd::kThreads, args, 0, s);
  return static_cast<int>(err);
}
