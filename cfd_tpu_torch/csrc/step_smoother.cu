// The backward step's exact masked finest-level smoother on the natural
// layout.
//
// Replaces cfd_tpu/kernels/step_smoother.py make_step_masked_pairs (:45) in
// its three variants: the plain pairs, with_residual_field (the V-cycle's
// pre-smooth and restriction input) and with_residual (the post-smooth and
// tolerance check). Each pair is the exact reference operator of
// cfd_tpu/poisson/multigrid.py smooth0 (:993-1008): a pressure-ghost
// refresh (the channel domain ghosts, then each solid cell with a fluid
// neighbour set to the mean of its fluid neighbours,
// backwards_step-01.cpp:685-740), then a red and a black half-sweep over
// the fluid cells; one more ghost refresh follows the last pair. The
// residual variants take b - lap over the fluid cells of the refreshed
// state refreshed once more (residual0, :1010-1014).
//
// Layout: the logical (ny+2, nx+2) float32 array, row-major. The geometry
// is the reference's single solid rectangle {i <= step_i, j > inlet_j_max}
// (backwards_step-01.cpp:499-520); every mask comes from the indices. The
// cell arithmetic (the refresh, the half-sweep's division by denom, the
// residual) is step_level0.cuh's, which the quad layout's masked level
// runs too.
//
// Bound on the H100: the latency of the launch and of its dependent passes
// at the natural sizes (the natural step's 32 x 514 level is 16k cells:
// nanoseconds of bytes), device-memory bytes only at sizes far beyond
// them (a call reads p and b once and writes p, and r, once).
//
// Design: ONE launch of shared-memory tiles a call, one tile a block, as
// the TPU kernel runs all pairs in one slab whose valid band shrinks by
// three rows a pair (step_smoother.py:66-75). A block loads its tile of p
// and b with a halo of h = 3 n_pairs + 1 cells, 3 n_pairs + 3 with a
// residual (kernels/plan.py step_pairs_plan), in rows and columns, into
// shared memory (0 outside the array), on the boxes of level_tile.cuh's
// tiles (ws::LTile), and runs the 3 n_pairs + 1 stages (n_pairs x (refresh,
// red, black) and the trailing refresh), stage s on the cells s + 1 from
// the buffer's edge: every stage reads only the 3 x 3 box around a cell.
// A refresh goes out of place into the tile's second buffer, because a
// domain ghost may read a solid cell that the same refresh averages; the
// half-sweeps update their colour in place (a cell reads only the other
// colour). The block writes its own cells of out, and of r (the residual
// field, 0 off the fluid), or folds their max|r| into the op's running max
// (tile::fold_max_into: the last block to finish moves it into res and
// leaves the max and the count at 0, so no launch zeroes them). The
// iterate never goes through device memory between the stages, and no
// scratch field exists.
#include "carry_tile.cuh"
#include "level_tile.cuh"
#include "step_level0.cuh"

namespace {

namespace tile = cfd::tile;
namespace ws = cfd::ws;

// the level: its (H, W) array, the step's geometry and the operator's
// constants (cfd::step_ghost, cfd::step_gs, cfd::step_residual)
struct Step {
  int H, W, ny, nx, step_i, inlet_j;
  float idx2, idy2, omega, one_minus_omega, denom;
};

// r: null unless the residual field is written; res: null unless max|r|
// is folded, then acc holds the running max (int bits) and the blocks'
// count, both 0 before the launch and after it
__global__ void __launch_bounds__(tile::kThreads)
    pairs_kernel(const float* p, const float* b, float* out, float* r, float* res,
                 unsigned int* acc, Step s, int n_pairs, tile::Plan pl) {
  const int t = static_cast<int>(blockIdx.y) * pl.grid_x + static_cast<int>(blockIdx.x);
  const ws::LTile T = ws::make_ltile(t, pl.rows, pl.cols, s.W, pl.halo);
  const int n = T.LR * T.LC;
  float* a = tile::smem();
  float* o = a + n;
  float* const bb = o + n;
  // the tile's p and b, both loads of a cell issued before their stores
  ws::each_cell(0, T.LR, 0, T.LC, [&](int lj, int li) {
    const int j = T.oj + lj, i = T.oi + li;
    const bool in = j >= 0 && j < s.H && i >= 0 && i < s.W;
    const int g = in ? j * s.W + i : 0;
    const float pv = in ? p[g] : 0.f, bv = in ? b[g] : 0.f;
    a[lj * T.LC + li] = pv;
    bb[lj * T.LC + li] = bv;
  });
  __syncthreads();
  const ws::TileView bv{bb, T.oj, T.oi, T.LC};
  int st = 0;  // the stage: it writes the cells st + 1 from the buffer's edge
  auto refresh = [&]() {
    const ws::TileView av{a, T.oj, T.oi, T.LC};
    ws::update2(o, T.LC, st + 1, T.LR - st - 1, st + 1, T.LC - st - 1, -1, [&](int lj, int li) {
      return ws::Upd{true, cfd::step_ghost(av, T.oj + lj, T.oi + li, s)};
    });
    __syncthreads();
    float* const x = a;
    a = o;
    o = x;
    ++st;
  };
  auto half = [&](int colour) {
    const ws::TileView av{a, T.oj, T.oi, T.LC};
    const int local = (colour + T.oj + T.oi) & 1;  // the local parity of the global colour
    ws::update2(a, T.LC, st + 1, T.LR - st - 1, st + 1, T.LC - st - 1, local,
                [&](int lj, int li) {
      const int j = T.oj + lj, i = T.oi + li;
      if (!cfd::step_fluid(j, i, s)) return ws::Upd{false, 0.f};
      return ws::Upd{true, cfd::step_gs(a[lj * T.LC + li], av(j, i + 1), av(j, i - 1),
                                        av(j + 1, i), av(j - 1, i), bv(j, i), s)};
    });
    __syncthreads();
    ++st;
  };
  for (int k = 0; k < n_pairs; ++k) {
    refresh();
    half(0);
    half(1);
  }
  refresh();
  // the own cells: out, and the residual of the state refreshed once more
  const ws::TileView av{a, T.oj, T.oi, T.LC};
  const bool resid = r != nullptr || res != nullptr;
  float m = 0.f;
  ws::each_cell(T.R0, min(T.R0 + T.rows, s.H), T.C0, min(T.C0 + T.cols, s.W), [&](int j, int i) {
    const int g = j * s.W + i;
    out[g] = av(j, i);
    if (!resid) return;
    float rv = 0.f;
    if (cfd::step_fluid(j, i, s)) {
      rv = cfd::step_residual(cfd::step_ghost(av, j, i, s), cfd::step_ghost(av, j, i + 1, s),
                              cfd::step_ghost(av, j, i - 1, s), cfd::step_ghost(av, j + 1, i, s),
                              cfd::step_ghost(av, j - 1, i, s), bv(j, i), s);
    }
    if (r != nullptr) r[g] = rv;
    m = cfd::bits_max(m, fabsf(rv));
  });
  if (res != nullptr) tile::fold_max_into(m, acc, res);
}

// cudaSuccess when the plan covers the (H, W) array with the halo the
// stages reach (3 n_pairs + 1 cells, 2 more with the residual) and the
// shared memory of its three buffers (the iterate, its second buffer, the
// source), else cudaErrorInvalidValue (the wrapper raises)
cudaError_t check_plan(const tile::Plan& pl, const Step& s, int n_pairs, bool residual) {
  if (n_pairs < 1 || pl.halo != 3 * n_pairs + 1 + (residual ? 2 : 0))
    return cudaErrorInvalidValue;
  if (pl.rows < 1 || pl.cols < 1 || s.ny < 1 || s.nx < 1 || s.H != s.ny + 2 ||
      s.W != s.nx + 2 || 1LL * s.H * s.W >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (pl.grid_x != (s.W + pl.cols - 1) / pl.cols || pl.grid_y != (s.H + pl.rows - 1) / pl.rows)
    return cudaErrorInvalidValue;
  const long long floats = 3LL * (pl.rows + 2 * pl.halo) * (pl.cols + 2 * pl.halo);
  if (pl.smem_bytes != 4 * floats || 4 * floats > tile::kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// Readies the kernel for `smem_bytes` of dynamic shared memory on the
// current device: blocks (SMs x blocks per SM), blocks per SM and
// registers out (tile::ready)
extern "C" int cfd_step_pairs_grid(int smem_bytes, int* blocks, int* per_sm, int* regs) {
  return tile::ready(reinterpret_cast<const void*>(pairs_kernel), smem_bytes, blocks, per_sm,
                     regs);
}

// p, b: (H, W) = (ny+2, nx+2); out: (H, W) (p is not written); r: null
// unless with_residual_field; res: null unless with_residual (one float),
// then acc: two unsigned ints on the device, 0 (the launch leaves them 0).
// one_minus_omega, denom: the host's 1 - omega and 2 (idx2 + idy2),
// rounded to float32. plan: the 6 ints of the tile plan (tile::Plan,
// kernels/plan.py step_pairs_plan), a host array.
extern "C" int cfd_step_pairs(const float* p, const float* b, float* out, float* r, float* res,
                              unsigned int* acc, int H, int W, int ny, int nx, int step_i,
                              int inlet_j, float idx2, float idy2, float omega,
                              float one_minus_omega, float denom, int n_pairs, const int* plan,
                              void* stream) {
  if ((res != nullptr) != (acc != nullptr) || (res != nullptr && r != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Step s{H, W, ny, nx, step_i, inlet_j, idx2, idy2, omega, one_minus_omega, denom};
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const cudaError_t err = check_plan(pl, s, n_pairs, r != nullptr || res != nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairs_kernel<<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes,
                 static_cast<cudaStream_t>(stream)>>>(p, b, out, r, res, acc, s, n_pairs, pl);
  return static_cast<int>(cudaGetLastError());
}
