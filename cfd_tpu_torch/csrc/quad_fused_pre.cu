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
// Bound on the H100: device-memory bytes. It reads 4 quad fields and
// writes 4 plus rc (19 MB a field at 2048^2, 157 MB in all, 0.047 ms at
// 3.35 TB/s); the arithmetic (the predictor's ~80 flops a cell and 20 a
// cell for each half-sweep) is far below the card's float32 rate.
//
// Design: the grid-wide phases of the composed carry -> pre pair, run as
// grid-stride loops on a persistent cooperative grid, separated by
// grid.sync(), through the per-cell bodies the standalone kernels run
// (quad_carry.cuh, quad_level0.cuh), so the result is bit-identical to the
// composition and to its plain twin:
//
//   1. the cavity corrector into the scratch u, v and the warm start
//      2p - p_prev into p1 (the first thread zeroes max|b'|);
//   2. the predictor us', vs', each face once;
//   3. the source b' from them and the block maxima of |b'| (atomicMax on
//      int bits, the carry's reduction);
//   4. n_pairs red then black half-sweeps on p1 in place, one phase each
//      (a half-sweep reads the other colour only, so in place is
//      race-free);
//   5. the restriction of b' - A p1 into rc.
//
// Phases 2 and 3 split predictor_source_cell: the standalone carry, which
// has no barrier between them, evaluates the predictor three times a cell
// (its own faces and the west and south faces its divergence needs) and
// is bound by that arithmetic; here each face is evaluated once and read
// back, for one more pass over two fields. The values are the same
// float32 operations, so the result stays bit-identical.
//
// The grid barriers replace the TPU kernel's slab halo (16 rows: the
// carry's radius 5 plus 2 * n_pairs + 3, quad.py:1041): every phase sees
// the previous one's final values everywhere, so no band shrinks. Unlike
// the TPU kernel, the warm start and the corrected u, v do pass through
// device memory (one field and two of scratch); keeping them in shared
// memory with a halo is a later design. The grid is kBlocksPerSM blocks a
// SM (64 registers a thread under __launch_bounds__, no spills).
#include <cooperative_groups.h>

#include "quad_carry.cuh"
#include "quad_level0.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBlocksPerSM = 4;

struct FusedPre {
  const float* us;
  const float* vs;
  const float* p;
  const float* p_prev;
  float* u_scr;  // the corrected u, v (scratch)
  float* v_scr;
  float* us2;
  float* vs2;
  float* b;
  float* p1;
  float* rc;     // (Hq8, Wqa)
  float* max_b;
  cfd::quad::Corr qc;
  cfd::Pred pc;
  cfd::Level0 L;
  int n_pairs;
};

// b = rho/dt * div of the tentative fields at quad cell idx on the cells, 0
// elsewhere, in predictor_source_cell's operation order (quad_carry.cuh);
// returns b
__device__ __forceinline__ float source_cell(const float* us2, const float* vs2, float* b,
                                             long long idx, const cfd::Pred& c) {
  const cfd::QuadCell q = cfd::quad_cell(idx, c.Hq8, c.Wqa);
  const int j = q.j, i = q.i;
  float bb = 0.f;
  if (j >= 1 && j <= c.ny && i >= 1 && i <= c.nx) {
    const float aw = cfd::qld(us2, j, i - 1, c.Hq8, c.Wqa);
    const float bs = cfd::qld(vs2, j - 1, i, c.Hq8, c.Wqa);
    const float div = (us2[idx] - aw) * c.idx + (vs2[idx] - bs) * c.idy;
    bb = c.rho_dt * div;
  }
  b[idx] = bb;
  return bb;
}

__global__ void __launch_bounds__(cfd::kThreads, kBlocksPerSM)
    fused_pre_kernel(FusedPre F) {
  cg::grid_group grid = cg::this_grid();
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n0 = 4LL * F.L.Hq8 * F.L.Wqa;
  const long long n1 = static_cast<long long>(F.L.Hq8) * F.L.Wqa;

  if (first == 0) *F.max_b = 0.f;
  for (long long idx = first; idx < n0; idx += stride) {
    cfd::quad::cavity_corrector_cell(F.us, F.vs, F.p, F.p_prev, F.u_scr, F.v_scr, F.p1, idx,
                                     F.qc);
  }
  grid.sync();

  // the predictor once a face; the source then reads its west and south
  // neighbours' values back (the standalone carry recomputes them)
  for (long long idx = first; idx < n0; idx += stride) {
    const cfd::QuadCell c = cfd::quad_cell(idx, F.L.Hq8, F.L.Wqa);
    F.us2[idx] = cfd::u_star(F.u_scr, F.v_scr, c.j, c.i, F.pc);
    F.vs2[idx] = cfd::v_star(F.u_scr, F.v_scr, c.j, c.i, F.pc);
  }
  grid.sync();

  float m = 0.f;
  for (long long idx = first; idx < n0; idx += stride) {
    const float bb = source_cell(F.us2, F.vs2, F.b, idx, F.pc);
    m = cfd::bits_max(m, fabsf(bb));
  }
  cfd::block_max_into(m, F.max_b);
  grid.sync();

  for (int k = 0; k < F.n_pairs; ++k) {
    for (int colour = 0; colour < 2; ++colour) {
      for (long long idx = first; idx < n0; idx += stride) {
        const cfd::QuadCell c = cfd::quad_cell(idx, F.L.Hq8, F.L.Wqa);
        if (cfd::quad_updates(c, colour, F.L)) F.p1[idx] = cfd::quad_gs(F.p1, F.b, c, F.L);
      }
      grid.sync();
    }
  }

  for (long long idx = first; idx < n1; idx += stride) {
    F.rc[idx] = cfd::quad_restrict_value(F.p1, F.b, idx, F.L);
  }
}

int fused_pre_grid(int* blocks, int* per_sm, int* regs) {
  int dev = 0, coop = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_pre_kernel, cfd::kThreads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms * min(*per_sm, kBlocksPerSM);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_pre_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  return 0;
}

}  // namespace

// The cooperative grid of the launch on the current device: blocks,
// blocks per SM, registers per thread.
extern "C" int cfd_quad_fused_pre_grid(int* blocks, int* per_sm, int* regs) {
  return fused_pre_grid(blocks, per_sm, regs);
}

// The carry's arguments as cfd_quad_carry's (u_scr, v_scr scratch; max_b
// zeroed in-kernel), then p1 (quad) and rc (Hq8, Wqa) out, then the finest
// level's as cfd_quad_pre_smooth_restrict's (weights, dims, idx2, idy2,
// omega, n_pairs >= 1).
extern "C" int cfd_quad_fused_pre(const float* us, const float* vs, const float* p,
                                  const float* p_prev, float* u_scr, float* v_scr, float* us2,
                                  float* vs2, float* b, float* p1, float* rc, float* max_b,
                                  float cu, float cv, float two_lid, float dt, float nu,
                                  float idx, float idy, float idx2, float idy2, float rho_dt,
                                  const float* wE, const float* wW, const float* wN,
                                  const float* wS, int Hq8, int Wqa, int ny, int nx,
                                  float l_idx2, float l_idy2, float omega, int n_pairs,
                                  void* stream) {
  if (n_pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  FusedPre F{us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b, p1, rc, max_b,
             cfd::quad::Corr{Hq8, Wqa, ny, nx, cu, cv, two_lid},
             cfd::Pred{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt},
             cfd::Level0{Hq8, Wqa, ny, nx, l_idx2, l_idy2, omega, wE, wW, wN, wS},
             n_pairs};
  int blocks = 0, per_sm = 0, regs = 0;
  const int e = fused_pre_grid(&blocks, &per_sm, &regs);
  if (e) return e;
  void* args[] = {&F};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_pre_kernel), blocks, cfd::kThreads, args, 0,
      static_cast<cudaStream_t>(stream)));
}
