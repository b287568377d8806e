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
// The TPU kernel kept b and every intermediate in VMEM; here b stays in
// device memory (scratch the caller allocates once), which the L2 serves.
//
// Design: the whole-solve's persistent grid and launch plan (whole_solve.cu,
// kernels/plan.py), launched with cudaLaunchCooperativeKernel, one block of
// 512 threads an SM. The carry runs on the shared-memory tiles of the
// standalone carries (carry_tile.cuh; quad_stage.cu, step_stage.cu,
// rb_stage.cu describe them), through the same tile bodies
// (cfd::quad::cavity_tile, tile::duct_tile with ChannelTile or StepTile,
// cfd::rb::rb_tile): each block walks the tiles of the plan's carry grid in
// turn (tile::each_tile), the next tile's loads in flight (cp.async) while
// the current one runs its stages, and writes its tiles' own cells of us',
// vs' (T'), b and the warm start into the output p (2p - p_prev for the
// cavity and the channel, the previous p for the step and RB). The
// corrected fields never leave shared memory. Then:
//
//   cavity   each block's max|b| into its own slot; 1 barrier; every block
//            takes the max of the slots
//   channel, per-chunk sums of b (tile::warp_chunk_sums); 1 barrier; every
//   step,    block folds the partials itself in fold_sum's order (the same
//   RB       float in each), removes the mean from b on the cells (the
//            step's fluid cells) and takes max|b| of the result; 1 barrier
//
// after the tile phase's barrier: 1 grid barrier in all for the cavity, 3
// for the others (kernels/plan.py WHOLE_STEP_CARRY_BARRIERS). Then the
// solve's cycles (cfd::ws::solve_cycles) from the warm start in the output
// p, with the tolerance max(tol_factor * max|b|, abs_tol) formed after the
// mean removal. The flavor is a template parameter: four instances, the
// step's with the masked solve, RB's with the pin_mean phase. The dynamic
// shared memory serves the tiles, then the sums and the fold, then the
// solve (kernels/plan.py whole_step_plan: the largest need).
//
// Sums and maxima repeat the composed path's order exactly: the tile
// bodies are the standalone carries' (bit-identical to their twins); the
// sum walks the quad cells in 256-wide chunks, one warp a chunk, each
// summed by the fixed tree of cfd::block_sum_to (as the standalone sum
// launch, carry_tile.cuh source_sum); the
// fold is fold_sum's; the mean is the IEEE float32 division sum_b /
// n_fluid, subtracted on the cells, as solver.remove_mean_quad does;
// maxima are taken on int bits. So the step equals the composition carry
// -> remove_mean_quad -> whole-solve bit for bit, with the same cycles.
//
// The control slots (max|b|, the two residual slots, the solve's sum) are
// zeroed by the first thread before the first barrier, so one step is
// exactly one launch; (cycles, res) go to a 2-int output the caller
// allocates fresh for every call.
#include "quad_carry.cuh"
#include "rb_carry.cuh"
#include "step_carry.cuh"
#include "whole_solve.cuh"

namespace {

namespace cg = cooperative_groups;
namespace tile = cfd::tile;
using cfd::ws::Params;
using cfd::ws::Sweep;

enum Flavor : int { kCavity = 0, kChannel = 1, kRB = 2, kStep = 3 };

static_assert(tile::kThreads == cfd::ws::kBlockThreads,
              "the tiles' loops run on the solve's blocks");

// the inputs a flavor's tile stages, the logical rows its stages reach
__host__ __device__ constexpr int inputs(int flavor) {
  return flavor == kRB ? cfd::rb::kRBInputs
                       : (flavor == kCavity ? cfd::quad::kCavityInputs : tile::kDuctInputs);
}

int radius(int flavor) {
  switch (flavor) {
    case kCavity:
      return cfd::quad::kCavityRadius;
    case kChannel:
      return cfd::quad::kChannelRadius;
    case kRB:
      return cfd::rb::kRBRadius;
    default:
      return cfd::step::kStepRadius;
  }
}

struct Carry {
  const float* us;
  const float* vs;
  const float* p;
  const float* p_prev;  // cavity, channel: the previous step's p
  const float* T;       // RB
  float* us2;
  float* vs2;
  float* T2;            // RB
  float* b;             // the source (scratch), the solve's b0
  float* partials;      // the chunk sums of b; the cavity: the blocks' max|b|
  tile::Plan pl;        // the carry's tiles
  cfd::quad::Corr qc;   // cavity, channel (ghost: 2 * lid, or the inlet velocity)
  cfd::step::Step sc;   // step
  cfd::rb::RBCorr rc;   // RB
  cfd::rb::RBTemp rt;   // RB
  cfd::Pred pc;
  float buoy;           // RB: dt * 0.5
  float n_fluid;        // the cells the mean is taken over
};

// The max of the blocks' slots[0:gridDim.x] (int bits), written before the
// last barrier; the same float in every block. Like the kernel's other
// reductions it keeps its scratch in the dynamic shared memory: the kernel
// has no static shared memory, so a plan may ask for all of a block's.
__device__ float slots_max(const float* slots) {
  int* const top = reinterpret_cast<int*>(cfd::ws::dyn_smem());
  if (threadIdx.x < 32) {
    int x = 0;
    for (int k = static_cast<int>(threadIdx.x); k < static_cast<int>(gridDim.x); k += 32) {
      x = max(x, __float_as_int(__ldcg(slots + k)));
    }
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_down_sync(0xffffffffu, x, o));
    if (threadIdx.x == 0) *top = x;
  }
  __syncthreads();
  const float m = __int_as_float(*top);
  __syncthreads();  // every thread's read before the shared memory is reused
  return m;
}

// The sum of partials[0:n], written by every block before the last
// barrier, in fold_sum's order: the block copies them into its shared
// memory (read past L1, __ldcg; a batch of loads a thread in flight at
// once) and folds there, so every block gets the same float. n floats fit
// the plan's shared memory (kernels/plan.py whole_step_plan).
__device__ float block_fold(const float* partials, int n) {
  constexpr int kBatch = 8;
  float* const s = cfd::ws::dyn_smem();
  const int t = static_cast<int>(threadIdx.x), nt = static_cast<int>(blockDim.x);
  for (int base = 0; base < n; base += kBatch * nt) {
    float v[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int k = base + t + r * nt;
      v[r] = k < n ? __ldcg(partials + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int k = base + t + r * nt;
      if (k < n) s[k] = v[r];
    }
  }
  __syncthreads();
  const float sum = cfd::fold_sum(s, n, t, nt, [] { __syncthreads(); });
  __syncthreads();  // every thread's read of s[0] before the buffer is reused
  return sum;
}

template <int kFlavor>
__global__ void __launch_bounds__(cfd::ws::kBlockThreads, 1) whole_step_kernel(Params P,
                                                                             Carry C) {
  constexpr bool kMasked = kFlavor == kStep;
  constexpr int NF = inputs(kFlavor);
  // the warm start: extrapolated for the cavity and the channel, the
  // previous p for the step and RB (kernels/whole_step.py)
  constexpr tile::Guess kG = kFlavor == kCavity || kFlavor == kChannel
                                 ? tile::Guess::kExtrapolate
                                 : tile::Guess::kCopy;
  cg::grid_group grid = cg::this_grid();
  const Sweep s{static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
                static_cast<long long>(gridDim.x) * blockDim.x};
  const int Hq8 = P.L0.Hq8, Wqa = P.L0.Wqa, ny = P.L0.ny, nx = P.L0.nx;
  const long long n0 = 4LL * Hq8 * Wqa;
  if (s.first == 0) {
    for (int k = 0; k < 4; ++k) P.ctl[k] = 0.f;
  }
  // the cavity: the block's max|b| slot, which only this block touches
  if (kFlavor == kCavity && threadIdx.x == 0) C.partials[blockIdx.x] = 0.f;

  // the carry's tiles: us', vs' (T'), b and the warm start into P.p0
  float m[1] = {0.f};  // the cavity's max|b|
  float courant[2] = {0.f, 0.f};  // unused: no Courant maxima here
  if constexpr (kFlavor == kCavity) {
    const float* src[NF] = {C.us, C.vs, C.p};
    tile::each_tile(
        C.pl, Hq8, Wqa, 0, src, [](const tile::Tile&) { return true; },
        [&](const tile::Tile& t, float* in, float* work) {
          cfd::quad::cavity_tile<false, false>(t, in, work, C.p_prev, C.us2, C.vs2, C.b, P.p0,
                                               C.qc, C.pc, 0, m);
        });
  } else if constexpr (kFlavor == kRB) {
    const float* src[NF] = {C.us, C.vs, C.p, C.T};
    tile::each_tile(
        C.pl, Hq8, Wqa, 0, src, [](const tile::Tile&) { return true; },
        [&](const tile::Tile& t, float* in, float* work) {
          cfd::rb::rb_tile<false, false, kG>(t, in, work, C.p, nullptr, C.us2, C.vs2, C.T2, C.b,
                                             P.p0, C.rc, C.rt, C.pc, C.buoy, 0, courant);
        });
  } else {
    const float* src[NF] = {C.us, C.vs, C.p};
    auto duct = [&](const auto& f) {
      tile::each_tile(
          C.pl, Hq8, Wqa, 0, src,
          [&](const tile::Tile& t) { return !tile::outside(t, ny, nx); },
          [&](const tile::Tile& t, float* in, float* work) {
            if (tile::outside(t, ny, nx)) {
              tile::duct_pad<kG>(t, C.p, C.p_prev, C.us2, C.vs2, C.b, P.p0, Hq8, Wqa);
            } else {
              tile::duct_tile<false, false, kG>(f, t, in, work, C.p_prev, C.us2, C.vs2, C.b,
                                                P.p0, courant, 0);
            }
          });
    };
    if constexpr (kFlavor == kChannel) {
      duct(cfd::quad::ChannelTile{C.qc, C.pc});
    } else {
      duct(cfd::step::StepTile{C.sc, C.pc});
    }
  }

  float max_b;
  if constexpr (kFlavor == kCavity) {
    // no mean removal: the operator is nonsingular
    cfd::ws::block_max_into(m[0], C.partials + blockIdx.x);
    grid.sync();
    max_b = slots_max(C.partials);
  } else {
    grid.sync();
    // the sum of b by kSumChunk-wide chunks, each by the fixed tree, a warp
    // a chunk
    static_assert(cfd::ws::kSumChunk == cfd::kThreads, "the twin's chunks");
    const int warps = static_cast<int>(blockDim.x) / 32;
    tile::warp_chunk_sums<false>(C.b, Hq8, Wqa, 0, C.partials,
                                 static_cast<int>(blockIdx.x) * warps +
                                     static_cast<int>(threadIdx.x) / 32,
                                 static_cast<int>(gridDim.x) * warps);
    grid.sync();
    // b - sum_b / n_fluid on the cells (the fluid cells of the step), and
    // max|b| of the result; a batch of a thread's loads in flight at once
    const int chunks = static_cast<int>((n0 + cfd::ws::kSumChunk - 1) / cfd::ws::kSumChunk);
    const float mean = block_fold(C.partials, chunks) / C.n_fluid;
    constexpr int kBatch = 4;
    float mb = 0.f;
    for (long long base = s.first; base < n0; base += kBatch * s.step) {
      float v[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const long long idx = base + r * s.step;
        v[r] = idx < n0 ? C.b[idx] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const long long idx = base + r * s.step;
        if (idx >= n0) continue;
        const cfd::QuadCell q = cfd::quad_cell(idx, Hq8, Wqa);
        bool cell;
        if constexpr (kFlavor == kStep) {
          cell = cfd::step::fluid(q.j, q.i, C.sc);
        } else {
          cell = q.j >= 1 && q.j <= ny && q.i >= 1 && q.i <= nx;
        }
        if (cell) {
          v[r] = v[r] - mean;
          C.b[idx] = v[r];
        }
        mb = cfd::bits_max(mb, fabsf(v[r]));
      }
    }
    cfd::ws::block_max_into(mb, P.ctl);
    grid.sync();
    max_b = __ldcg(P.ctl);
  }
  cfd::ws::solve_cycles<kMasked>(s, grid, P, max_b);
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
// channel) or T (RB) or null (step), us2, vs2, T2 (RB, else null), b
// (quad scratch), partials (the larger of blocks_for(4 * Hq8 * Wqa) and
// the plan's blocks floats). cf (a host array): cu, cv, ghost (2 * lid or
// the inlet velocity), dt, nu, idx, idy, idx2, idy2, rho_dt, kappa, 2 *
// t_bottom, 2 * t_top, buoy, n_fluid. carry_plan: the 6 ints of the
// carry's tile plan (tile::Plan, kernels/plan.py whole_step_plan), its
// buffers tile::kInputSets sets of the flavor's inputs and the work
// buffers, within
// the plan's shared memory. The rest are cfd_whole_solve's arguments from
// `masked` on, with p_in and max_b unused (the warm start and max|b| are
// formed in-kernel): masked must be 1 exactly for the step and pin_mean 1
// exactly for RB; p0 receives p', stats (2 ints) the cycles and the bits
// of the final residual; store_bf16, corr_opt (the step only), rc32 and
// the plan as for cfd_whole_solve, the plan's shared memory also holding
// the carry's tiles and the partials' fold; cfd_whole_step_grid readies
// the kernel.
extern "C" int cfd_whole_step(int flavor, void* const* io, const float* cf,
                              const int* carry_plan, int masked, float* p0, float* q0,
                              float* filled, float* ctl, int* stats, const float* pinv,
                              const float* wE, const float* wW, const float* wN,
                              const float* wS, int Hq8, int Wqa, int ny, int nx, int step_i,
                              int inlet_j, float idx2, float idy2, float denom,
                              float one_minus_omega, int n_coarse, const int* idims,
                              const float* fdims, void* const* ptrs, float omega, int pre,
                              int post, int max_cycles, float tol_factor, float abs_tol,
                              float stall, int pin_mean, float* partials, float n_int,
                              int store_bf16, int corr_opt, float* rc32, const int* plan,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = kernel_of(flavor);
  if (fn == nullptr || carry_plan == nullptr || masked != (flavor == kStep) ||
      pin_mean != (flavor == kRB)) {
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
  C.b = static_cast<float*>(io[7]);
  C.partials = static_cast<float*>(io[8]);
  const bool needs_io3 = flavor != kStep;
  if (C.us == nullptr || C.vs == nullptr || C.p == nullptr || C.us2 == nullptr ||
      C.vs2 == nullptr || C.b == nullptr || C.partials == nullptr ||
      (needs_io3 && io[3] == nullptr) || (flavor == kRB && C.T2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  C.pl = tile::Plan{carry_plan[0], carry_plan[1], carry_plan[2],
                    carry_plan[3], carry_plan[4], carry_plan[5]};
  cudaError_t err = tile::check(C.pl, Hq8, Wqa, radius(flavor),
                                tile::kInputSets * inputs(flavor) + tile::kWorkBuffers);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  // the tiles' buffers and the partials' fold in the plan's shared memory
  const long long chunks = (4LL * Hq8 * Wqa + cfd::ws::kSumChunk - 1) / cfd::ws::kSumChunk;
  if (C.pl.smem_bytes > P.plan.smem_bytes ||
      (flavor != kCavity && 4 * chunks > P.plan.smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&P, &C};
  return static_cast<int>(cudaLaunchCooperativeKernel(fn, P.plan.blocks, cfd::ws::kBlockThreads,
                                                      args, P.plan.smem_bytes, s));
}
