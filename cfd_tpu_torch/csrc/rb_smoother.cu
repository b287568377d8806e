// Coarse-level red/black smoother on the natural (H8, W) layout.
//
// Replaces cfd_tpu/kernels/rb_smoother.py make_rb_pairs (:37), reached
// through rb_pairs_for_level (:322): the plain variant (post-smooth) and
// the with_residual_field variant (pre-smooth + the signed residual field
// b - A p, masked to the interior), on separable weights (cfd_rb_pairs,
// float or bfloat16 storage, the arithmetic always float32,
// rb_smoother.py:199-200,255) and on the full-2D weights of a masked level
// (cfd_rb_pairs_full, float32, rb_smoother.py:106-127,185-198: a cell
// updates only where denom > 0, see aligned_level.cuh); and the
// with_residual variant on separable weights (cfd_rb_pairs with res: the
// pairs and max|b - A p| over the interior of the smoothed state, the
// natural finest level's post-smooth and tolerance check,
// multigrid.py:715-719).
//
// Bound on the H100: at the main path's levels (the cavity's level 1,
// 1040 x 1152 in bfloat16, down to 16 x 128; the natural cavity's level 0,
// 2056 x 2176) the latency of the launch and of its dependent passes, far
// above the bytes' bound: a call reads p and b (and the weights) once and
// writes p (and r) once.
//
// Design: ONE launch of shared-memory tiles a call, one tile a block, as
// the TPU kernel runs every half-sweep and the residual on overlapping
// slabs in VMEM (rb_smoother.py:37-70). A block loads its tile of p and b
// (float32 in shared memory whatever the storage) with a halo of 2 n_pairs
// cells (2 n_pairs + 1 when it also computes the residual, which reads one
// ring more) and the weights under it, runs the 2 n_pairs half-sweeps in
// place on boxes that shrink by one cell a half-sweep, red first, through
// the tile bodies of level_tile.cuh (the whole-solve's coarse levels run
// the same), and writes its own cells of out, rounded once to the storage
// type, and of r (the residual field; 0 off the active cells), or folds
// their max|r| into the op's running max (an atomicMax on the int bits,
// tile::block_max): the last block to finish (a __threadfence and an
// atomic count) moves it into res and leaves the max and the count at 0
// for the next call, so no launch zeroes them. The iterate never goes
// through device memory between the half-sweeps, and no scratch field
// exists. The tiles cover the whole (H8, W) array, the ghost ring and the
// aligned padding included, because out and r are fresh arrays; a tile
// whose own cells all miss the interior (the padding columns and rows)
// copies p to out (and writes r's zeros) without staging. The plan (the
// tile, its halo, the shared memory, the grid) is kernels/plan.py
// pairs_plan, checked here.
#include "carry_tile.cuh"
#include "level_tile.cuh"

namespace {

using cfd::Level;
namespace tile = cfd::tile;
namespace ws = cfd::ws;

// the block's tile of the launch's grid (one tile a block)
__device__ __forceinline__ ws::LTile grid_tile(const tile::Plan& pl, const Level& L) {
  const int t = static_cast<int>(blockIdx.y) * pl.grid_x + static_cast<int>(blockIdx.x);
  return ws::make_ltile(t, pl.rows, pl.cols, L.W, pl.halo);
}

// Whether the tile's own cells all miss the interior [1, ny] x [1, nx]: no
// half-sweep changes them and their residual is 0
__device__ __forceinline__ bool outside(const ws::LTile& T, const Level& L) {
  return T.R0 > L.ny || T.R0 + T.rows - 1 < 1 || T.C0 > L.nx || T.C0 + T.cols - 1 < 1;
}

// r: null unless the residual field is written; res: null unless max|r|
// is folded, then acc holds the running max (int bits) and the blocks'
// count, both 0 before the launch and after it
template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
    pairs_kernel(const T* p, const T* b, T* out, T* r, float* res, unsigned int* acc, Level L,
                 int n_pairs, tile::Plan pl) {
  const ws::LTile Tl = grid_tile(pl, L);
  const int r1 = min(Tl.R0 + Tl.rows, L.H8), c1 = min(Tl.C0 + Tl.cols, L.W);
  float m = 0.f;
  if (outside(Tl, L)) {
    ws::each_cell(Tl.R0, r1, Tl.C0, c1, [&](int j, int i) {
      const int g = j * L.W + i;
      out[g] = p[g];
      if (r != nullptr) r[g] = cfd::from_f32<T>(0.f);
    });
  } else {
    const ws::LBuf B = ws::level_buf(L, Tl, tile::smem());
    ws::load_level_tile(p, b, B, Tl, L);
    __syncthreads();
    for (int s = 0; s < 2 * n_pairs; ++s) ws::l_half_sweep(B, Tl, L, s & 1, s);
    const bool resid = r != nullptr || res != nullptr;
    ws::each_cell(Tl.R0, r1, Tl.C0, c1, [&](int j, int i) {
      const int lj = j - Tl.oj, li = i - Tl.oi, g = j * L.W + i;
      out[g] = cfd::from_f32<T>(B.p[lj * Tl.LC + li]);
      if (resid) {
        const float rv = ws::l_residual(B, Tl, lj, li, L);
        if (r != nullptr) r[g] = cfd::from_f32<T>(rv);
        m = cfd::bits_max(m, fabsf(rv));
      }
    });
  }
  if (res != nullptr) tile::fold_max_into(m, acc, res);
}

const void* pairs_fn(int storage) {
  return storage == 1 ? reinterpret_cast<const void*>(pairs_kernel<__nv_bfloat16>)
                      : reinterpret_cast<const void*>(pairs_kernel<float>);
}

// cudaSuccess when the plan covers the (H8, W) array (which holds the
// interior and its ghost ring) with the halo the half-sweeps reach (2
// n_pairs cells, one more with the residual) and the shared memory of the
// tile's buffers (level_buf: iterate, source, then four weight arrays on
// a masked level, two row and two column vectors on a separable one),
// else cudaErrorInvalidValue (the wrapper raises)
cudaError_t check_plan(const tile::Plan& pl, const Level& L, int n_pairs, bool residual) {
  if (n_pairs < 1 || pl.halo != 2 * n_pairs + (residual ? 1 : 0)) return cudaErrorInvalidValue;
  if (pl.rows < 1 || pl.cols < 1 || L.ny < 1 || L.nx < 1 || L.ny + 2 > L.H8 ||
      L.nx + 2 > L.W || 1LL * L.H8 * L.W >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (pl.grid_x != (L.W + pl.cols - 1) / pl.cols || pl.grid_y != (L.H8 + pl.rows - 1) / pl.rows)
    return cudaErrorInvalidValue;
  const long long lr = pl.rows + 2LL * pl.halo, lc = pl.cols + 2LL * pl.halo;
  const long long floats = 2 * lr * lc + (L.full ? 4 * lr * lc : 2 * (lr + lc));
  if (pl.smem_bytes != 4 * floats || 4 * floats > tile::kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
int run(const T* p, const T* b, T* out, T* r, float* res, unsigned int* acc, int n_pairs,
        const Level& L, const int* plan, cudaStream_t s) {
  if (res != nullptr && (acc == nullptr || r != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const cudaError_t err = check_plan(pl, L, n_pairs, r != nullptr || res != nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairs_kernel<T><<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes, s>>>(
      p, b, out, r, res, acc, L, n_pairs, pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Readies the kernel of storage 0 (float32) or 1 (bfloat16) for
// `smem_bytes` of dynamic shared memory on the current device: blocks (SMs
// x blocks per SM), blocks per SM and registers out (tile::ready)
extern "C" int cfd_rb_pairs_grid(int storage, int smem_bytes, int* blocks, int* per_sm,
                                 int* regs) {
  if (storage != 0 && storage != 1) return static_cast<int>(cudaErrorInvalidValue);
  return tile::ready(pairs_fn(storage), smem_bytes, blocks, per_sm, regs);
}

// storage: 0 = float32, 1 = bfloat16. r: null unless the residual-field
// variant; res: null unless the with_residual variant (one float), then
// acc: two unsigned ints on the device, 0 (the launch leaves them 0);
// plan: the 6 ints of the tile plan (tile::Plan, kernels/plan.py
// pairs_plan), a host array.
extern "C" int cfd_rb_pairs(int storage, const void* p, const void* b, void* out, void* r,
                            float* res, unsigned int* acc, const float* wE, const float* wW,
                            const float* wN, const float* wS, int H8, int W, int ny, int nx,
                            float idx2, float idy2, float omega, int n_pairs, const int* plan,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level L{H8, W, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, 0};
  if (storage == 0) {
    return run<float>(static_cast<const float*>(p), static_cast<const float*>(b),
                      static_cast<float*>(out), static_cast<float*>(r), res, acc, n_pairs, L,
                      plan, s);
  }
  if (storage == 1) {
    return run<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(r), res, acc, n_pairs,
        L, plan, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Full-2D weights (a masked level), float32 storage: wE, wW, wN, wS are
// (H8, W) arrays. r: null for the plain variant. plan as cfd_rb_pairs'.
extern "C" int cfd_rb_pairs_full(const float* p, const float* b, float* out, float* r,
                                 const float* wE, const float* wW, const float* wN,
                                 const float* wS, int H8, int W, int ny, int nx, float idx2,
                                 float idy2, float omega, int n_pairs, const int* plan,
                                 void* stream) {
  Level L{H8, W, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, 1};
  return run<float>(p, b, out, r, nullptr, nullptr, n_pairs, L, plan,
                    static_cast<cudaStream_t>(stream));
}
