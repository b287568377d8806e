// Finest-level V-cycle kernels on the quad layout.
//
// Replaces cfd_tpu/kernels/quad.py make_quad_pre_smooth_restrict (:630) and
// make_quad_post_prolong_smooth (:700), on a whole field (rows 3, 4) and
// with shard=(P, mdy) on one shard's local block (rows 16b, 16c).
//
// pre:  n red/black pairs, then the residual, then full weighting straight
//       into the aligned level-1 source rc (Hq8, Wqa).
// post: bilinear 9-3-3-1 prolongation of the level-1 correction ec with
//       edge clamps, added on the interior, then n pairs, then max|b - Ap|.
//
// A local block (halo > 0; cfd_tpu/parallel/quad_sharded.py): the arrays are
// a shard's (4, P + 16, Wqa) block, its P own plane rows between two 8-row
// halo strips that the caller refreshes from the neighbouring shards, and
// row_base = jy * P - 8 is the global plane row of local row 0. Every mask,
// band and weight-vector index keeps its global meaning (row0 = row_base,
// quad_level0.cuh); the row weight vectors are the global ones with a
// `halo`-plane-row zero prefix, so the global row -2 * halo <= j of any
// block reads inside them. A neighbour outside the block reads 0 and a
// residual outside it is 0; the prolongation's row J + 1 wraps within the
// block. What such a read feeds is a halo row, which the next refresh
// replaces: with the 8-row halo the own rows are exact. Half-sweep k updates
// the band of the TPU kernel's single slab (in_band), the post kernel's one
// row further in (quad.py:762-767), and max|b - Ap| covers the own rows
// only: the shard's partial, whose maximum over the shards the caller takes.
// A whole field is halo 0 and row_base 0: every row in every band and owned.
//
// Bound on the H100: device-memory bytes. Each call reads p and b (and ec)
// and writes p and rc (or one float) once: at 2048^2 (19 MB quad fields,
// more than the 50 MB L2 holds together) about 3.25 field passes; a
// shard's block and the 1536x512 fields fit the L2.
//
// Design: ONE launch of shared-memory tiles a call, one tile a block
// (kernels/plan.py level0_plan with masked=False: the tile, a halo of
// n_pairs + 1 plane rows and columns, the shared memory of the iterate,
// the source, the weight vectors and on post the level-1 correction's
// tile, the grid). A block loads p, b and the weights with the halo into
// shared memory and runs the separable bodies of level0_tile.cuh, which
// the whole-solve runs on its tiles too: each half-sweep a pass over a box
// that shrinks by one logical cell, the residual from the last; it writes
// p_out's own cells and rc's own coarse cells, or folds the own cells'
// max|r| into the op's running max (an atomicMax on the int bits,
// tile::fold_max_into): the last block to finish (a __threadfence and an
// atomic count) moves it into res and leaves the max and the count at 0
// for the next call, so no launch zeroes them. The iterate never goes
// through device memory between the half-sweeps. The tiles cover the whole
// array, padding included (p_out and rc are fresh tensors); a tile whose
// own cells all lie outside the domain (ws::tile_outside: the padding
// columns, 1025 of the 2048^2 cavity's 1152 quad columns being used; a
// block's rows beyond the field) is left unchanged by every half-sweep: it
// copies p to p_out (and writes rc's zeros) without staging.
#include "carry_tile.cuh"
#include "level0_tile.cuh"
#include "quad_level0.cuh"

namespace {

using cfd::Level0;
namespace tile = cfd::tile;
namespace ws = cfd::ws;

// the block's tile of the launch's grid (one tile a block)
template <bool kBlock>
__device__ __forceinline__ ws::Tile grid_tile(const tile::Plan& pl, const Level0& L) {
  const int t = static_cast<int>(blockIdx.y) * pl.grid_x + static_cast<int>(blockIdx.x);
  return ws::make_tile(pl.rows, pl.cols, L.Wqa, t, pl.halo, kBlock ? L.row0 : 0);
}

template <bool kBlock>
__global__ void __launch_bounds__(tile::kThreads)
    sep_pre_kernel(const float* p, const float* b, float* p_out, float* rc, Level0 L,
                   int n_pairs, tile::Plan pl) {
  const ws::Tile T = grid_tile<kBlock>(pl, L);
  if (ws::tile_outside(T, L.ny, L.nx)) {
    ws::copy_own(p, p_out, T, L.Hq8, L.Wqa);
    ws::each_cell(T.R0, min(T.R0 + T.rows, L.Hq8), T.C0, min(T.C0 + T.cols, L.Wqa),
                  [&](int Jl, int Ic) { rc[static_cast<long long>(Jl) * L.Wqa + Ic] = 0.f; });
    return;
  }
  ws::sep_pre_tile<kBlock>(T, p, b, p_out, L, n_pairs, tile::smem(),
                           [&](long long idx, float v) { rc[idx] = v; });
}

// acc: the running max and the blocks' count of tile::fold_max_into
template <bool kBlock>
__global__ void __launch_bounds__(tile::kThreads)
    sep_post_kernel(const float* p, const float* b, const float* ec, float* p_out,
                    float* res, unsigned int* acc, Level0 L, int n_pairs, tile::Plan pl) {
  const ws::Tile T = grid_tile<kBlock>(pl, L);
  float r = 0.f;
  if (ws::tile_outside(T, L.ny, L.nx)) {
    ws::copy_own(p, p_out, T, L.Hq8, L.Wqa);
  } else {
    r = ws::sep_post_tile<kBlock>(T, p, b, ec, p_out, L, n_pairs, tile::smem(), 0.f);
  }
  tile::fold_max_into(r, acc, res);
}

const void* level0_fn(bool post, bool block) {
  if (post) {
    return block ? reinterpret_cast<const void*>(sep_post_kernel<true>)
                 : reinterpret_cast<const void*>(sep_post_kernel<false>);
  }
  return block ? reinterpret_cast<const void*>(sep_pre_kernel<true>)
               : reinterpret_cast<const void*>(sep_pre_kernel<false>);
}

Level0 level(int Hq8, int Wqa, int ny, int nx, float idx2, float idy2, float omega,
             const float* wE, const float* wW, const float* wN, const float* wS,
             int row_base, int halo) {
  // the row vectors' zero prefix: global row j reads element j + 2 * halo
  return Level0{Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN + 2 * halo,
                wS + 2 * halo, row_base, halo};
}

tile::Plan plan_of(const int* plan) {
  return tile::Plan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
}

}  // namespace

// Readies the pre (post 0) or post kernel (block: its local-block instance)
// for `smem_bytes` of dynamic shared memory on the current device: blocks
// (SMs x blocks per SM), blocks per SM and registers out (tile::ready)
extern "C" int cfd_quad_level0_grid(int post, int block, int smem_bytes, int* blocks,
                                    int* per_sm, int* regs) {
  return tile::ready(level0_fn(post != 0, block != 0), smem_bytes, blocks, per_sm, regs);
}

// row_base, halo: a local block's global plane row of row 0 and its halo
// strip (0, 0 on a whole field); rc: (Hq8, Wqa), the block's level-1 rows;
// plan: the 6 ints of the tile plan (tile::Plan, kernels/plan.py
// level0_plan with masked=False), a host array
extern "C" int cfd_quad_pre_smooth_restrict(const float* p, const float* b, float* p_out,
                                            float* rc, const float* wE, const float* wW,
                                            const float* wN, const float* wS, int Hq8,
                                            int Wqa, int ny, int nx, float idx2,
                                            float idy2, float omega, int n_pairs,
                                            int row_base, int halo, const int* plan,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Level0 L = level(Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, row_base, halo);
  const tile::Plan pl = plan_of(plan);
  const cudaError_t err = ws::check_sep_plan(pl, L, n_pairs, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(pl.grid_x, pl.grid_y);
  if (halo > 0) {
    sep_pre_kernel<true><<<grid, tile::kThreads, pl.smem_bytes, s>>>(p, b, p_out, rc, L,
                                                                    n_pairs, pl);
  } else {
    sep_pre_kernel<false><<<grid, tile::kThreads, pl.smem_bytes, s>>>(p, b, p_out, rc, L,
                                                                     n_pairs, pl);
  }
  return static_cast<int>(cudaGetLastError());
}

// res: max|r| over the own rows of a block (every row of a whole field);
// acc: two unsigned ints on the device, 0 (the launch leaves them 0);
// plan as the pre kernel's
extern "C" int cfd_quad_post_prolong_smooth(const float* p, const float* b,
                                            const float* ec, float* p_out, float* res,
                                            unsigned int* acc, const float* wE,
                                            const float* wW, const float* wN,
                                            const float* wS, int Hq8, int Wqa, int ny,
                                            int nx, float idx2, float idy2, float omega,
                                            int n_pairs, int row_base, int halo,
                                            const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Level0 L = level(Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, row_base, halo);
  const tile::Plan pl = plan_of(plan);
  const cudaError_t err = ws::check_sep_plan(pl, L, n_pairs, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(pl.grid_x, pl.grid_y);
  if (halo > 0) {
    sep_post_kernel<true><<<grid, tile::kThreads, pl.smem_bytes, s>>>(p, b, ec, p_out, res,
                                                                     acc, L, n_pairs, pl);
  } else {
    sep_post_kernel<false><<<grid, tile::kThreads, pl.smem_bytes, s>>>(p, b, ec, p_out, res,
                                                                      acc, L, n_pairs, pl);
  }
  return static_cast<int>(cudaGetLastError());
}
