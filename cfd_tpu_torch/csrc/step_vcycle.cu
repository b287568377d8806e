// Finest-level V-cycle kernels of the backward step on the quad layout.
//
// Replaces cfd_tpu/kernels/step_quad.py make_quad_step_pre_smooth_restrict
// (:354) and make_quad_step_post_prolong_smooth (:419), on a whole field
// and with shard=(P, mdy) on one shard's local block (row 16f).
//
// pre:  n exact masked pairs (ghost stage, red, black), the trailing ghost
//       stage, then the exact residual (ghosts re-applied) restricted by
//       full weighting into the aligned level-1 source rc (Hq8, Wqa).
// post: the bilinear prolongation of the solid-filled level-1 correction
//       added on FLUID cells, n exact pairs, the trailing ghost stage, then
//       max|exact residual| over the fluid cells.
//
// A local block (halo > 0; cfd_tpu/parallel/quad_sharded.py): the arrays
// are a shard's (4, P + 16, Wqa) block, its P own plane rows between two
// 8-row halo strips that the caller refreshes, and row_base = jy * P - 8 is
// the global plane row of local row 0 (step_level0.cuh: every mask, ghost
// and interface keeps its global meaning, a neighbour outside the block
// reads 0, a residual outside it is 0). The stages are banded as the TPU
// kernel's single slab (step_quad.py:305-336): stage k of the ledger (the
// ghost stage, red, black of each pair, the trailing ghost stage, the
// residual's ghost stage) writes only the rows of band k, which starts one
// row further in for the post kernel (its prolongation's row J + 1 wraps
// within the block, :471-474). At V(1,1) the pre kernel's ledger reaches
// 3 + 2 stages, then the residual's stencil and the restriction's row
// below: 7 of the 8 halo rows; the post kernel's one more. Only n_pairs = 1
// fits, as the reference's factories enforce. The level-1 source of the
// block's rows and the own rows' max|r| (the shard's partial) are the
// outputs. A whole field is halo 0 and row_base 0: every row in every band,
// and its instances fold the offset away at compile time (kBlock).
//
// Bound on the H100: at 2048x256 (2.5 MB quad fields, all in L2) and on a
// shard's block (0.55 MB) the latency of the launches and of the stages'
// dependent passes, far above the bytes' bound: each call reads p, b (and
// ec) and writes p and rc (or one float) once.
//
// Design: ONE launch of shared-memory tiles a call, one tile a block
// (kernels/plan.py level0_plan: the tile, a halo of
// n_pairs + 2 plane rows and columns on pre and n_pairs + 1 on post, the
// shared memory, the grid). A block loads p and b with the halo, and on
// post the level-1 correction's rows and columns under them, into shared
// memory, and runs the bodies of level0_tile.cuh, which the masked
// whole-solve runs on its tiles too: each ghost stage and half-sweep a
// pass over a box that shrinks by one logical cell a stage, the exact
// residual from the last; it writes p_out's own cells and rc's own coarse
// cells, or folds the own cells' max|r| into the op's running max (an
// atomicMax on the int bits, tile::fold_max_into): the last block to finish
// (a __threadfence and an atomic count) moves it into res and leaves the
// max and the count at 0 for the next call, so no launch zeroes them. The
// iterate never goes through device memory between the stages. A tile whose own cells all lie outside the
// domain (the padding columns: 1025 of the 2048x256 step's 1152 quad
// columns are used; a block's rows beyond the field) is left unchanged by
// every stage: it copies p to p_out (and writes rc's zeros) without
// staging.
#include "carry_tile.cuh"
#include "level0_tile.cuh"
#include "step_level0.cuh"

namespace {

using cfd::StepL0;
namespace tile = cfd::tile;
namespace ws = cfd::ws;

// the block's tile of the launch's grid (one tile a block)
template <bool kBlock>
__device__ __forceinline__ ws::Tile grid_tile(const tile::Plan& pl, const StepL0& L) {
  const int t = static_cast<int>(blockIdx.y) * pl.grid_x + static_cast<int>(blockIdx.x);
  return ws::make_tile(pl.rows, pl.cols, L.Wqa, t, pl.halo, cfd::step_row0<kBlock>(L));
}

template <bool kBlock>
__global__ void __launch_bounds__(tile::kThreads)
    step_pre_kernel(const float* p, const float* b, float* p_out, float* rc, StepL0 L,
                    int n_pairs, tile::Plan pl) {
  const ws::Tile T = grid_tile<kBlock>(pl, L);
  if (ws::tile_outside(T, L.ny, L.nx)) {
    ws::copy_own(p, p_out, T, L.Hq8, L.Wqa);
    ws::each_cell(T.R0, min(T.R0 + T.rows, L.Hq8), T.C0, min(T.C0 + T.cols, L.Wqa),
                  [&](int Jl, int Ic) { rc[static_cast<long long>(Jl) * L.Wqa + Ic] = 0.f; });
    return;
  }
  ws::step_pre_tile<kBlock>(T, p, b, p_out, L, n_pairs, tile::smem(),
                            [&](long long idx, float v) { rc[idx] = v; });
}

// acc: the running max and the blocks' count of tile::fold_max_into
template <bool kBlock>
__global__ void __launch_bounds__(tile::kThreads)
    step_post_kernel(const float* p, const float* b, const float* ec, float* p_out, float* res,
                     unsigned int* acc, StepL0 L, int n_pairs, tile::Plan pl) {
  const ws::Tile T = grid_tile<kBlock>(pl, L);
  float r = 0.f;
  if (ws::tile_outside(T, L.ny, L.nx)) {
    ws::copy_own(p, p_out, T, L.Hq8, L.Wqa);
  } else {
    r = ws::step_post_tile<kBlock>(T, p, b, ec, p_out, L, n_pairs, tile::smem(), 0.f);
  }
  tile::fold_max_into(r, acc, res);
}

const void* level0_fn(bool post, bool block) {
  if (post) {
    return block ? reinterpret_cast<const void*>(step_post_kernel<true>)
                 : reinterpret_cast<const void*>(step_post_kernel<false>);
  }
  return block ? reinterpret_cast<const void*>(step_pre_kernel<true>)
               : reinterpret_cast<const void*>(step_pre_kernel<false>);
}

// cudaSuccess when the plan covers a (4, Hq8, Wqa) field with the halo the
// kernel's stages reach (n_pairs + 2 plane rows on pre, n_pairs + 1 on
// post) and the shared memory of its three buffers (and on post the coarse
// tile), else cudaErrorInvalidValue (the wrapper raises)
cudaError_t check_plan(const tile::Plan& pl, const StepL0& L, int n_pairs, bool post) {
  if (n_pairs < 1 || pl.halo != n_pairs + (post ? 1 : 2)) return cudaErrorInvalidValue;
  if (pl.rows < 1 || pl.cols < 1 || L.Hq8 < 1 || L.Wqa < 1) return cudaErrorInvalidValue;
  if (pl.grid_x != (L.Wqa + pl.cols - 1) / pl.cols ||
      pl.grid_y != (L.Hq8 + pl.rows - 1) / pl.rows)
    return cudaErrorInvalidValue;
  const long long lr = 2LL * (pl.rows + 2 * pl.halo), lc = 2LL * (pl.cols + 2 * pl.halo);
  const long long coarse =
      post ? (pl.rows + 2LL * pl.halo + 1) * (pl.cols + 2 * pl.halo + 1) : 0;
  const long long bytes = 4 * (3 * lr * lc + coarse);
  if (pl.smem_bytes != bytes || bytes > tile::kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool kBlock>
int pre(const float* p, const float* b, float* p_out, float* rc, int n_pairs, const StepL0& L,
        const tile::Plan& pl, cudaStream_t s) {
  const cudaError_t err = check_plan(pl, L, n_pairs, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  step_pre_kernel<kBlock><<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes, s>>>(
      p, b, p_out, rc, L, n_pairs, pl);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int post(const float* p, const float* b, const float* ec, float* p_out, float* res,
         unsigned int* acc, int n_pairs, const StepL0& L, const tile::Plan& pl,
         cudaStream_t s) {
  const cudaError_t err = check_plan(pl, L, n_pairs, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  step_post_kernel<kBlock><<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes, s>>>(
      p, b, ec, p_out, res, acc, L, n_pairs, pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Readies the pre (post 0) or post kernel (block: its local-block instance)
// for `smem_bytes` of dynamic shared memory on the current device: blocks
// (SMs x blocks per SM), blocks per SM and registers out (tile::ready)
extern "C" int cfd_step_level0_grid(int post, int block, int smem_bytes, int* blocks,
                                    int* per_sm, int* regs) {
  return tile::ready(level0_fn(post != 0, block != 0), smem_bytes, blocks, per_sm, regs);
}

// row_base, halo: a local block's global plane row of row 0 and its halo
// strip (0, 0 on a whole field); rc: (Hq8, Wqa), the block's level-1 rows;
// plan: the 6 ints of the tile plan (tile::Plan, kernels/plan.py
// level0_plan), a host array
extern "C" int cfd_step_pre_smooth_restrict(const float* p, const float* b, float* p_out,
                                            float* rc, int Hq8, int Wqa, int ny, int nx,
                                            int step_i, int inlet_j, float idx2, float idy2,
                                            float denom, float omega, float one_minus_omega,
                                            int n_pairs, int row_base, int halo,
                                            const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepL0 L{Hq8,  Wqa,   ny,    nx,    step_i,          inlet_j,
           idx2, idy2,  denom, omega, one_minus_omega, row_base, halo};
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  if (halo > 0) return pre<true>(p, b, p_out, rc, n_pairs, L, pl, s);
  return pre<false>(p, b, p_out, rc, n_pairs, L, pl, s);
}

// res: max|r| over the own rows of a block (every row of a whole field);
// acc: two unsigned ints on the device, 0 (the launch leaves them 0);
// plan as the pre kernel's
extern "C" int cfd_step_post_prolong_smooth(const float* p, const float* b, const float* ec,
                                            float* p_out, float* res, unsigned int* acc,
                                            int Hq8, int Wqa, int ny, int nx, int step_i,
                                            int inlet_j, float idx2, float idy2, float denom,
                                            float omega, float one_minus_omega, int n_pairs,
                                            int row_base, int halo, const int* plan,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepL0 L{Hq8,  Wqa,   ny,    nx,    step_i,          inlet_j,
           idx2, idy2,  denom, omega, one_minus_omega, row_base, halo};
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  if (halo > 0) return post<true>(p, b, ec, p_out, res, acc, n_pairs, L, pl, s);
  return post<false>(p, b, ec, p_out, res, acc, n_pairs, L, pl, s);
}
