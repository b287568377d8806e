// The fused multigrid coarse tail: one V-cycle over the aligned levels from
// tail_from down, from zero iterates, in ONE cooperative launch.
//
// Replaces cfd_tpu/kernels/mg_tail.py make_mg_tail (:329, pl.pallas_call at
// :363): tail(b) -> e, the drop-in for the recursion vcycle(k, zeros, b)
// below level tail_from, with separable weights (cavity, channel,
// Rayleigh-Benard) or full-2D masked weights and the solid fill (the
// backward step).
//
// Bound on the H100: the source read once, the correction written once and
// the levels' constants; at tail_from = 1 every level below fits the 50 MB
// L2 cache (level 1 is 4.8 MB at the 2048^2 cavity), so what bounds it is
// the chain of dependent phases, as in the whole-solve (whole_solve.cu):
// each red or black half-sweep, restriction and prolongation of every level
// needs its predecessor over the whole level.
//
// Design: the whole-solve's persistent grid and launch plan (kernels/plan.py
// without the finest level's tiles) runs the whole-solve's own coarse
// V-cycle (cfd::ws::coarse_vcycle in whole_solve.cuh): the large levels as
// grid-stride phases, the smaller ones in tiles, the levels from the plan's
// switch down in one block's shared memory, the same arithmetic in the same
// order as the plain twin (mg_tail.run_tail_vcycle over the rb_smoother
// twins and the PyTorch glue), so the two agree bit for bit. The source b
// stands in the first level's source slot and the output e in its iterate
// slot; the levels below keep their iterates and sources in scratch the
// caller allocates once. The reference runs the lane transfers as matmuls;
// here they are the glue's sums, so the reference's tail and this one
// differ by float32 rounding.
#include "whole_solve.cuh"

namespace {

namespace cg = cooperative_groups;
using cfd::ws::Params;
using cfd::ws::Sweep;

__global__ void __launch_bounds__(cfd::ws::kBlockThreads, 1) mg_tail_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const Sweep s{static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
                static_cast<long long>(gridDim.x) * blockDim.x};
  cfd::ws::coarse_vcycle(s, grid, P);
}

}  // namespace

// One tail V-cycle over n_levels aligned levels. b: the source on the first
// level (read only); e: the correction on it (every cell written). idims,
// fdims, ptrs: as for cfd_whole_solve, levels 1..n_levels being the tail's,
// with the first level's (p, b) slots holding (e, b). pinv: the coarsest
// level's (n, n) pseudo-inverse; plan: the launch plan as for
// cfd_whole_solve (its tile fields unused); cfd_mg_tail_grid readies the
// kernel.
extern "C" int cfd_mg_tail(const float* b, float* e, const float* pinv, int n_levels,
                           const int* idims,
                           const float* fdims, void* const* ptrs, float omega, int pre,
                           int post, const int* plan, void* stream) {
  Params P{};
  int err = cfd::ws::coarse_params(&P, n_levels, idims, fdims, ptrs, omega);
  if (err) return err;
  if (P.b_lv[1] != b || P.p_lv[1] != e || pinv == nullptr || pre < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.pinv = pinv;
  P.pre = pre;
  P.post = post;
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  P.plan = cfd::ws::plan_from(plan);
  err = cfd::ws::check_plan(P, false, false);
  if (err) return err;
  void* args[] = {&P};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mg_tail_kernel), P.plan.blocks, cfd::ws::kBlockThreads,
      args, P.plan.smem_bytes, static_cast<cudaStream_t>(stream)));
}

// Readies the tail's kernel on the current device and returns its
// co-residency at smem_bytes of dynamic shared memory a block
// (cfd::ws::coop_grid): blocks, blocks per SM, registers.
extern "C" int cfd_mg_tail_grid(int smem_bytes, int* blocks, int* per_sm, int* regs) {
  return cfd::ws::coop_grid(reinterpret_cast<const void*>(mg_tail_kernel), smem_bytes, blocks,
                            per_sm, regs);
}
