// The cavity carry with the first V-cycle's finest-level pre-smooth,
// residual and restriction folded in, in ONE cooperative launch.
//
// Replaces cfd_tpu/kernels/quad.py make_quad_corr_predictor_source_fused_pre
// (:985): (us, vs, p, p_prev) -> (us', vs', b', p1, rc, max|b'|), where p1
// is the warm start 2p - p_prev after n_pairs red/black pairs on b' and rc
// (Hq8, Wqa) the full-weighting restriction of its residual onto the
// aligned level 1, 0 outside the coarse interior 1 <= J <= ny/2,
// 1 <= I <= nx/2. The solve then starts its first cycle at the coarse stage
// (poisson/multigrid.py MultigridPoisson.solve_rc).
//
// Bound on the H100: device-memory bytes. It must read 4 quad fields and
// write 4 plus rc (19 MB a field at 2048^2, 157 MB in all, 0.047 ms at
// 3.35 TB/s); the arithmetic (the predictor's ~80 flops a cell and 20 a
// cell for each half-sweep) is far below the card's float32 rate.
//
// Design: the tile bodies of the composed carry -> pre pair, one phase
// each, on a persistent cooperative grid with one grid barrier between
// them, so the result is bit-identical to the composition and to its plain
// twin:
//
//   A. the carry's tiles (kernels/plan.py fused_pre_plan: carry_plan's
//      cavity tile, two input sets): each block walks them in turn
//      (tile::each_tile), the next tile's us, vs, p in flight (cp.async)
//      while the current one runs cfd::quad::cavity_tile, the body of the
//      standalone carry (quad_stage.cu) and of the whole step's cavity
//      (whole_step.cu). It writes us', vs', b and the warm start 2p -
//      p_prev of its own cells, the warm start into the scratch `guess`;
//      the corrected u, v never leave shared memory. Each block folds the
//      max|b| of its tiles' own cells into its own slot, which it zeroed
//      itself (no memset: every slot is written before the barrier).
//   -- one grid.sync() --
//   B. the separable level-0 pre tiles (level0_plan(masked=False)'s tile):
//      each block walks them in turn through cfd::ws::sep_pre_tile, the
//      body of the standalone pre kernel (quad_vcycle.cu sep_pre_kernel)
//      and of the whole-solve: n_pairs pairs from guess on b into p1 (own
//      cells) and the residual's full weighting into rc. A tile whose own
//      cells all lie off the domain (the padding columns) copies guess to
//      p1 and zeroes rc, as sep_pre_kernel does. Block 0's first warp folds
//      the slots into max_b.
//
// About 11 passes over a field: A reads us, vs, p (with their halo) and
// p_prev and writes us', vs', b, guess; B reads guess and b (with their
// halo, mostly from L2) and writes p1 and the quarter-size rc. The block
// count is the card's co-residency at the plan's shared memory (the larger
// of the phases' needs), at most kBlocksPerSM an SM: 512 threads at 64
// registers under __launch_bounds__.
#include <cooperative_groups.h>

#include "carry_tile.cuh"
#include "level0_tile.cuh"
#include "quad_carry.cuh"

namespace {

namespace cg = cooperative_groups;
namespace tile = cfd::tile;
namespace ws = cfd::ws;

constexpr int kBlocksPerSM = 2;
// the carry phase's buffers: two input sets of us, vs, p and the corrected u, v
constexpr int kCarryBuffers = tile::kInputSets * cfd::quad::kCavityInputs + tile::kWorkBuffers;

struct FusedPre {
  const float* us;
  const float* vs;
  const float* p;
  const float* p_prev;
  float* us2;
  float* vs2;
  float* b;
  float* guess;  // the warm start (scratch), phase B's input
  float* p1;
  float* rc;     // (Hq8, Wqa)
  float* slots;  // gridDim.x floats: each block's max|b|
  float* max_b;
  cfd::quad::Corr qc;
  cfd::Pred pc;
  cfd::Level0 L;
  int n_pairs;
  tile::Plan carry;  // phase A's tiles
  tile::Plan pre;    // phase B's tiles
};

__global__ void __launch_bounds__(tile::kThreads, kBlocksPerSM)
    fused_pre_kernel(FusedPre F) {
  cg::grid_group grid = cg::this_grid();
  const cfd::Level0& L = F.L;
  // the block's max|b| slot, which only this block touches (tile::block_max
  // folds into it by the same thread after a barrier)
  if (threadIdx.x == 0) F.slots[blockIdx.x] = 0.f;

  // A. the carry's tiles
  float m[1] = {0.f};
  const float* src[cfd::quad::kCavityInputs] = {F.us, F.vs, F.p};
  tile::each_tile(
      F.carry, L.Hq8, L.Wqa, 0, src, [](const tile::Tile&) { return true; },
      [&](const tile::Tile& t, float* in, float* work) {
        cfd::quad::cavity_tile<false, false>(t, in, work, F.p_prev, F.us2, F.vs2, F.b, F.guess,
                                             F.qc, F.pc, 0, m);
      });
  tile::block_max(m, F.slots + blockIdx.x);
  grid.sync();

  // the slots' max, by one warp (no shared memory: phase B's tiles may start)
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    int x = 0;
    for (int k = static_cast<int>(threadIdx.x); k < static_cast<int>(gridDim.x); k += 32) {
      x = max(x, __float_as_int(__ldcg(F.slots + k)));
    }
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_down_sync(0xffffffffu, x, o));
    if (threadIdx.x == 0) *F.max_b = __int_as_float(x);
  }

  // B. the pre tiles
  const int nt = F.pre.grid_x * F.pre.grid_y;
  for (int t = static_cast<int>(blockIdx.x); t < nt; t += static_cast<int>(gridDim.x)) {
    const ws::Tile T = ws::make_tile(F.pre.rows, F.pre.cols, L.Wqa, t, F.pre.halo);
    if (ws::tile_outside(T, L.ny, L.nx)) {
      ws::copy_own(F.guess, F.p1, T, L.Hq8, L.Wqa);
      ws::each_cell(T.R0, min(T.R0 + T.rows, L.Hq8), T.C0, min(T.C0 + T.cols, L.Wqa),
                    [&](int Jl, int Ic) { F.rc[static_cast<long long>(Jl) * L.Wqa + Ic] = 0.f; });
      continue;
    }
    ws::sep_pre_tile<false>(T, F.guess, F.b, F.p1, L, F.n_pairs, tile::smem(),
                            [&](long long idx, float v) { F.rc[idx] = v; });
  }
}

}  // namespace

// Readies the kernel for `smem_bytes` of dynamic shared memory on the
// current device and returns its co-residency there (tile::ready): blocks
// (SMs x blocks per SM), blocks per SM and registers per thread; the
// cooperative grid's block count (kernels/plan.py fused_pre_plan). Errors
// where the card has no cooperative launch.
extern "C" int cfd_quad_fused_pre_grid(int smem_bytes, int* blocks, int* per_sm, int* regs) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  return tile::ready(reinterpret_cast<const void*>(fused_pre_kernel), smem_bytes, blocks, per_sm,
                     regs);
}

// The carry's arguments as cfd_quad_carry's, with guess (quad scratch), p1
// (quad) and rc (Hq8, Wqa) out, slots (plan blocks floats of scratch) and
// max_b; then the finest level's as cfd_quad_pre_smooth_restrict's
// (weights, dims, idx2, idy2, omega, n_pairs >= 1); plan: 14 ints (a host
// array, kernels/plan.py FusedPrePlan): phase A's tile::Plan (the cavity
// carry's tiles, kCarryBuffers buffers), phase B's (level0_plan's, halo
// n_pairs + 1), the launch's shared memory (the larger of the two) and
// blocks, which cfd_quad_fused_pre_grid readied.
extern "C" int cfd_quad_fused_pre(const float* us, const float* vs, const float* p,
                                  const float* p_prev, float* us2, float* vs2, float* b,
                                  float* guess, float* p1, float* rc, float* slots,
                                  float* max_b, float cu, float cv, float two_lid, float dt,
                                  float nu, float idx, float idy, float idx2, float idy2,
                                  float rho_dt, const float* wE, const float* wW,
                                  const float* wN, const float* wS, int Hq8, int Wqa, int ny,
                                  int nx, float l_idx2, float l_idy2, float omega, int n_pairs,
                                  const int* plan, void* stream) {
  const tile::Plan carry{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const tile::Plan pre{plan[6], plan[7], plan[8], plan[9], plan[10], plan[11]};
  const int smem = plan[12], blocks = plan[13];
  const cfd::Level0 L{Hq8, Wqa, ny, nx, l_idx2, l_idy2, omega, wE, wW, wN, wS};
  cudaError_t err =
      tile::check(carry, Hq8, Wqa, cfd::quad::kCavityRadius, kCarryBuffers);
  if (err == cudaSuccess) err = ws::check_sep_plan(pre, L, n_pairs, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem != (carry.smem_bytes > pre.smem_bytes ? carry.smem_bytes : pre.smem_bytes) ||
      blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedPre F{us, vs, p, p_prev, us2, vs2, b, guess, p1, rc, slots, max_b,
             cfd::quad::Corr{Hq8, Wqa, ny, nx, cu, cv, two_lid},
             cfd::Pred{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt},
             L, n_pairs, carry, pre};
  void* args[] = {&F};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_pre_kernel), blocks, tile::kThreads, args, smem,
      static_cast<cudaStream_t>(stream)));
}
