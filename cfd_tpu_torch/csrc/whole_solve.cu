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
// level is served from the 50 MB L2 cache (the 2048^2 cavity's finest p and
// b, 38 MB, mostly so). What bounds a cycle is the chain of dependent
// phases: each red or black half-sweep needs the other colour's final
// values over the whole level, so in a grid-stride design the grid
// synchronises between phases (75 grid-wide barriers a V(2,1) cycle on the
// cavity's 10 levels, 59-61 at the other shapes), each costing 2-3 us with
// its L2 round trips, against an operation bound of about 1 us a cycle.
//
// Design: one persistent cooperative grid of one 512-thread block an SM
// (cudaLaunchCooperativeKernel with the plan's dynamic shared memory),
// laid out by a plan computed on the host (kernels/plan.py, whole_solve.cuh
// Plan) so that most dependent stages meet at a block barrier instead of a
// grid one:
//
//   * the finest level runs in shared-memory tiles: each block loads its
//     tile of all four quad planes with a halo as deep as the stages the
//     phase fuses, runs them there, and writes its own cells. Pre: the pre
//     pairs (masked: each ghost+red stage, black stage and the trailing
//     ghost stage), then the residual's restriction into level 1. Post: the
//     prolong-add of the level-1 correction, the post pairs, the tolerance
//     residual's max. Halo cells are computed redundantly by the same
//     arithmetic on the same inputs, so they carry the same bits; the tiles
//     read one quad iterate and write the other (P.p0, P.q0), two phases a
//     cycle, so no block reads a cell another block writes in that phase.
//   * the coarse levels above the plan's switch run on the grid: a level of
//     at most 100,000 cells in tiles the same way (one phase down from its
//     zero iterate: the pre pairs and the restriction; one up: the
//     prolong-add and the post pairs), a larger one as grid-stride phases;
//   * the levels from the switch down, the coarsest dense pinv product
//     included, run in ONE block from its shared memory, separated by
//     __syncthreads(); the other blocks wait at one grid barrier.
//
// At the main shapes that leaves 31 (cavity), 17 (channel), 18 (step) and
// 20 (RB) grid-wide barriers a V-cycle, as the plan counts them
// (kernels/plan.py grid_barriers). The arithmetic of each cell is the per-kernel path's,
// through the same device functions where they take arrays
// (aligned_level.cuh, mg_smooth.cuh) and in their exact operation order
// where a tile reads shared memory (quad_level0.cuh; the masked level's
// tile bodies in level0_tile.cuh, which step_vcycle.cu runs too), and
// for the transfers between coarse levels and the coarsest solve in the
// order of their PyTorch glue (kernels/mg_tail.py _restrict, _solid_fill,
// _prolong, dense_coarse_solve), so the solve equals the per-kernel
// composition bit for bit.
//
// The masked flavor (kMasked): the finest level is the step's exact
// operator (step_level0.cuh), whose ghost stage reads one array and writes
// another; inside a tile the stages alternate between two shared-memory
// buffers. The coarse levels carry full-2D weights, and a correction
// leaving a masked coarse level is solid-filled where the prolongation
// reads it (the level-1 correction's fill is a phase of its own).
//
// Reductions and the stop rule: max|b| and each cycle's residual max are
// taken on the int bits of |x| with atomicMax (order-independent, so exact).
// The residual goes to one of two slots by cycle parity; the slot the next
// cycle uses is zeroed after the first barrier of this cycle (which follows
// every read of it, at the end of the previous cycle) and many barriers
// before the next cycle's atomics. After each cycle's last barrier every
// thread reads the slot and evaluates the same float32 stop rule as the
// host loop (poisson/multigrid.py tolerance_loop), so all blocks leave
// together.
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
// taken BEFORE the shift as in the reference, and a barrier, the p0 cells
// are summed in 256-wide flat chunks, each by the fixed tree (whatever the
// block size: each 256-thread group of a block takes one chunk at a time),
// into per-chunk partials; one block folds the partials in fixed_order_sum's
// order after a grid sync, and after a second grid sync every thread
// subtracts sum / n_int (an IEEE division) on the quad cells. p is 0 off the
// cells by construction, so the sum over the whole array is the cell sum.
// Three more barriers a cycle; the host loop's twin (MultigridPoisson.cycle)
// does the same arithmetic.
#include "whole_solve.cuh"

namespace {

namespace cg = cooperative_groups;
using cfd::ws::Params;
using cfd::ws::Sweep;

template <bool kMasked>
__global__ void __launch_bounds__(cfd::ws::kBlockThreads, 1) whole_solve_kernel(Params P) {
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
  if (P.max_b == nullptr) cfd::ws::block_max_into(m, P.ctl);
  grid.sync();
  const float max_b = P.max_b != nullptr ? *P.max_b : __ldcg(P.ctl);
  cfd::ws::solve_cycles<kMasked>(s, grid, P, max_b);
}

void* kernel_of(int masked) {
  return masked ? reinterpret_cast<void*>(whole_solve_kernel<true>)
                : reinterpret_cast<void*>(whole_solve_kernel<false>);
}

}  // namespace

// Readies the separable (masked = 0) or masked kernel on the current
// device and returns its co-residency at smem_bytes of dynamic shared
// memory a block (cfd::ws::coop_grid): blocks (SMs x blocks per SM), blocks
// per SM, and the kernel's registers per thread.
extern "C" int cfd_whole_solve_grid(int masked, int smem_bytes, int* blocks, int* per_sm,
                                    int* regs) {
  return cfd::ws::coop_grid(kernel_of(masked), smem_bytes, blocks, per_sm, regs);
}

// masked: 0 = the separable flavor (fine weights wE..wS, the step geometry
// unused, filled null), 1 = the masked flavor (wE..wS null; filled a
// level-1-size array). q0: a quad field of scratch (the second finest
// iterate). idims: n_coarse * (H8, W, ny, nx, full); fdims: n_coarse *
// (idx2, idy2); ptrs: n_coarse * (wE, wW, wN, wS, p, b), levels
// 1..n_coarse, all host arrays. ctl: 4 floats of device scratch; stats: 2
// ints, the cycles and the bits of the final float32 residual; pinv: the
// coarsest level's (n, n) pseudo-inverse. pin_mean (separable only): partials is
// ceil(4 * Hq8 * Wqa / 256) floats of scratch and n_int the interior cell
// count. corr_opt (masked only): partials is 2 * ceil(H8 * W of level 1 /
// 256) floats of scratch. Otherwise partials is null. store_bf16: the
// bfloat16 rounding points of the hierarchy (the caller passes weights and
// pinv already rounded); rc32, a level-1-size array, exactly when corr_opt
// and store_bf16 are both on. plan: a host array of the launch plan
// (cfd::ws::Plan, 8 + 2 kMaxLevels ints). A plan that does not fit the solve
// returns an error and launches nothing; cfd_whole_solve_grid must have
// readied the kernel on this device, or a launch above 48 KB of shared
// memory fails.
extern "C" int cfd_whole_solve(int masked, const float* p_in, const float* b0, float* p0,
                               float* q0, float* filled, const float* max_b, float* ctl,
                               int* stats, const float* pinv, const float* wE,
                               const float* wW, const float* wN, const float* wS, int Hq8,
                               int Wqa, int ny, int nx, int step_i, int inlet_j, float idx2,
                               float idy2, float denom, float one_minus_omega, int n_coarse,
                               const int* idims, const float* fdims, void* const* ptrs,
                               float omega, int pre, int post, int max_cycles,
                               float tol_factor, float abs_tol, float stall, int pin_mean,
                               float* partials, float n_int, int store_bf16, int corr_opt,
                               float* rc32, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params P;
  int e = cfd::ws::solve_params(&P, masked, p_in, b0, p0, q0, filled, max_b, ctl, stats, pinv, wE, wW, wN, wS, Hq8, Wqa, ny, nx, step_i, inlet_j, idx2,
                                idy2, denom, one_minus_omega, n_coarse, idims, fdims, ptrs,
                                omega, pre, post, max_cycles, tol_factor, abs_tol, stall,
                                pin_mean, partials, n_int, store_bf16, corr_opt, rc32, plan);
  if (e) return e;
  const void* fn = kernel_of(masked);
  cudaError_t err = cudaMemsetAsync(ctl, 0, 4 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(fn, P.plan.blocks, cfd::ws::kBlockThreads, args,
                                    P.plan.smem_bytes, s);
  return static_cast<int>(err);
}
