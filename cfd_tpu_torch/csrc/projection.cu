// Stage kernels of the non-carry step on the natural aligned layout: the
// lid-driven cavity and the channel.
//
// Replaces cfd_tpu/kernels/projection.py make_predictor_source (:210, with
// emit_max_b), make_corrector (:281, with emit_guess),
// make_channel_predictor_source (:386) and make_channel_corrector (:423,
// with emit_guess), all with aligned_io: every field is a row-major
// (H8, W) = (round_up(ny+2, 8), round_up(nx+2, 128)) float32 array that is
// zero beyond the logical (ny+2, nx+2) grid (projection.py:176-178).
//
// Bound on the H100: device-memory bytes. The predictors read 2 fields and
// write 3 plus one scalar, the correctors read 4 and write 3 (17.9 MB a
// field at the 2048^2 cavity's 2056x2176, 3.5 MB at the 1536x512
// channel's 520x1664); about 60 flops a cell for the predictor is far
// below the card's rate.
//
// Design. The cavity's predictor + source is ONE launch of shared-memory
// tiles of the aligned array, one tile a block (ws::LTile, the natural
// level's tile of level_tile.cuh), with no memset: a block loads u and v on
// its own rows and columns with a halo of 2 cells (the predictor's 1 and
// the source's 1; kernels/plan.py natural_predictor_plan), applies the lid
// ghosts once in shared memory (cfd::quad::lid_ghosts; tiles whose stages
// touch no ghost skip it), computes u*, v* once a face on the region the
// source reads (its own cells, one row south, one column west:
// cfd::quad::predictor_box, the quad tiles' stage on natural indices),
// writes us, vs and b of every own cell, and folds max|b| into the
// launch's running max, which the last block to finish moves into the
// output (tile::fold_max_into). Every element is written, the padding
// included (0 there), because the next kernel reads the padding and the
// aligned contract says it is zero; a tile whose own cells lie wholly in
// the padding writes zeros without loading. 5 passes over the field (2 in,
// 3 out), plus the halo's re-reads.
//
// The channel's predictor + source is ONE launch of the same tiles plus
// the carries' sum launch, with no memset: a block loads u and v with a
// halo of 3 cells (the stages reach 3 columns west and 2 rows south and
// north: kChannelPredictorRadius; kernels/plan.py
// natural_predictor_plan(channel=True)), computes u* once a face on its own
// cells and one column west and v* on its own cells and one row south,
// with the channel ghosts of the tentative fields
// (cfd::quad::channel_predictor_boxes, the quad tiles' stage on natural
// indices), and writes us, vs and b of every own cell, the padding
// included; then the carries' sum, launched as the tile kernel's
// programmatic dependent (tile::launch_dependent_source_sum: its blocks
// are set up while the tiles' last blocks run), sums the flat (H8, W)
// array as a (4, H8 / 4, W) one (H8 is a multiple of 8, so the flat order
// and its 256-wide chunks are the same). 5 passes over the field (2 in, 3
// out) and one more over b, plus the halo's re-reads.
//
// The correctors keep the first design: one thread per aligned cell,
// row-major, so a warp reads 32 neighbouring floats of a row; every
// element written, the padding included. Neighbours come through a
// guarded accessor (0 outside the array): the TPU kernels roll their slabs
// with wraparound, and every value a masked-in cell reads lies inside the
// array. The per-cell arithmetic is the quad stage kernels' (the channel
// ghost order of quad_carry.cuh) on natural indices.
//
// Cavity ghosts (projection.py _cavity_bc_slab, :193-208): applied on read
// to the predictor's input u, v and, in the corrector, to the corrected
// interior. Every ghost derives from an interior value: u's top row
// j = ny+1 is 2*lid minus row ny, its bottom row minus row 1 (i <= nx); v's
// west column minus column 1, its east minus column nx (j <= ny). So the
// lid row and the corner cells are rebuilt from the interior too.
//
// Channel ghosts (projection.py _channel_bc_slab, :336-355): the order of
// cfd::quad::channel_u / channel_v. The corrector zeroes the invalid faces
// before them (the slim-ghost convention, projection.py:423-436), so the v
// top ghost row and the corners stay 0 for the whole run.
//
// Reductions: max|b| is tile::fold_max_into (each block's max, atomicMax on
// the int bits of a non-negative float, order-free); the channel's sum of b is
// the carries' fixed-order sum (tile::source_sum), equal bit for bit to the
// plain twin's fixed_order_sum over the flat (H8, W) array.
#include "carry_tile.cuh"
#include "common.cuh"
#include "level_tile.cuh"
#include "predictor.cuh"
#include "quad_carry.cuh"

namespace {

using cfd::Pred;
namespace tile = cfd::tile;
namespace ws = cfd::ws;

// the cells the cavity's predictor + source reaches around its own (the
// predictor 1, the source 1; kernels/plan.py NATURAL_PREDICTOR_RADIUS), the
// channel's (3 columns west: kernels/plan.py
// NATURAL_CHANNEL_PREDICTOR_RADIUS) and their tiles' buffers: u, v, then
// u*, v* (NATURAL_PREDICTOR_BUFFERS)
constexpr int kPredictorRadius = 2;
constexpr int kChannelPredictorRadius = 3;
constexpr int kPredictorBuffers = 4;

struct Nat {
  int H8, W, ny, nx;
  float cu, cv;  // the correction coefficients (the correctors)
  float ghost;   // the cavity's 2 * lid velocity, or the channel's inlet velocity
};

__device__ __forceinline__ float nld(const float* a, int j, int i, int H8, int W) {
  return (j >= 0 && j < H8 && i >= 0 && i < W) ? a[static_cast<long long>(j) * W + i] : 0.f;
}

// corrected u on valid faces (j in [1, ny], i in [1, nx-1]), else 0
__device__ __forceinline__ float u_corr(const float* us, const float* p, int j, int i,
                                        const Nat& c) {
  if (!(j >= 1 && j <= c.ny && i >= 1 && i <= c.nx - 1)) return 0.f;
  float pc = nld(p, j, i, c.H8, c.W);
  float pe = nld(p, j, i + 1, c.H8, c.W);
  return nld(us, j, i, c.H8, c.W) - c.cu * (pe - pc);
}

// corrected v on valid faces (j in [1, ny-1], i in [1, nx]), else 0
__device__ __forceinline__ float v_corr(const float* vs, const float* p, int j, int i,
                                        const Nat& c) {
  if (!(j >= 1 && j <= c.ny - 1 && i >= 1 && i <= c.nx)) return 0.f;
  float pc = nld(p, j, i, c.H8, c.W);
  float pn = nld(p, j + 1, i, c.H8, c.W);
  return nld(vs, j, i, c.H8, c.W) - c.cv * (pn - pc);
}

// the cavity ghosts of a field f(j, i) at (j, i): u's rows, v's columns
template <class F>
__device__ __forceinline__ float lid_u(F f, int j, int i, int ny, int nx, float two_lid) {
  if (j == ny + 1 && i <= nx) return two_lid - f(ny, i);
  if (j == 0 && i <= nx) return -f(1, i);
  return f(j, i);
}

template <class F>
__device__ __forceinline__ float lid_v(F f, int j, int i, int ny, int nx) {
  if (i == 0 && j <= ny) return -f(j, 1);
  if (i == nx + 1 && j <= ny) return -f(j, nx);
  return f(j, i);
}

// A predictor tile's buffers s_u, s_v = u, v on its rows and columns from
// (oj, oi), 0 outside the (H8, W) array; both loads of a cell are issued
// before their stores
__device__ __forceinline__ void load_uv(const float* u, const float* v, float* s_u, float* s_v,
                                        const ws::LTile& T, int H8, int W) {
  ws::each_cell(0, T.LR, 0, T.LC, [&](int lj, int li) {
    const int j = T.oj + lj, i = T.oi + li;
    const bool in = j >= 0 && j < H8 && i >= 0 && i < W;
    const int g = in ? j * W + i : 0;
    const float a = in ? u[g] : 0.f, bv = in ? v[g] : 0.f;
    s_u[lj * T.LC + li] = a;
    s_v[lj * T.LC + li] = bv;
  });
}

// The padding path of the predictor tiles: a tile whose own cells [R0, r1)
// x [C0, c1) hold no valid face and no cell writes 0 to us, vs and b there
__device__ __forceinline__ void zero_own(float* us, float* vs, float* b, const ws::LTile& T,
                                         int r1, int c1, int W) {
  ws::each_cell(T.R0, r1, T.C0, c1, [&](int j, int i) {
    const int g = j * W + i;
    us[g] = 0.f;
    vs[g] = 0.f;
    b[g] = 0.f;
  });
}

// The cavity's predictor + source in one launch (the design above): the
// lid ghosts, the MAC predictor, b = rho/dt * div on the cells and max|b|
// (projection.py:210, emit_max_b) on a block's tile, or a padding tile's
// zeros without loading; max|b| folded into the running max in acc and
// moved into *max_b by the last block
__global__ void __launch_bounds__(tile::kThreads)
    predictor_source_kernel(const float* u, const float* v, float* us, float* vs, float* b,
                            float* max_b, unsigned int* acc, Pred c, int H8, int W,
                            float two_lid, tile::Plan pl) {
  const int t = static_cast<int>(blockIdx.y) * pl.grid_x + static_cast<int>(blockIdx.x);
  const ws::LTile T = ws::make_ltile(t, pl.rows, pl.cols, W, pl.halo);
  const int r1 = min(T.R0 + T.rows, H8), c1 = min(T.C0 + T.cols, W);
  float m = 0.f;
  if (T.R0 > c.ny + 1 || T.C0 > c.nx + 1) {  // the padding: no valid face, no cell
    zero_own(us, vs, b, T, r1, c1, W);
  } else {
    const int n = T.LR * T.LC;
    float* const s_u = tile::smem();
    float* const s_v = s_u + n;
    float* const s_us = s_u + 2 * n;
    float* const s_vs = s_u + 3 * n;
    load_uv(u, v, s_u, s_v, T, H8, W);
    __syncthreads();
    // the own cells from buffer cell (H, H); box A, the predictor's reads
    // (2 south and west, 1 north and east), box B, its faces (1 south and
    // west); the path with no test where A lies in rows [1, ny - 1] x
    // columns [1, nx - 1]
    const int o = T.H;
    const tile::Box A{o - 2, o + T.rows + 1, o - 2, o + T.cols + 1};
    const tile::Box B{o - 1, o + T.rows, o - 1, o + T.cols};
    const bool inner = T.oj + A.r0 >= 1 && T.oj + A.r1 - 1 <= c.ny - 1 && T.oi + A.c0 >= 1 &&
                       T.oi + A.c1 - 1 <= c.nx - 1;
    const tile::View vu{s_u, T.oj, T.oi, T.LC}, vv{s_v, T.oj, T.oi, T.LC};
    if (inner) {
      cfd::quad::predictor_box<true>(B, T.LC, T.oj, T.oi, vu, vv, s_us, s_vs, c);
    } else {
      cfd::quad::lid_ghosts(s_u, s_v, T.oj, T.oi, T.LR, T.LC, c.ny, c.nx, two_lid);
      __syncthreads();
      cfd::quad::predictor_box<false>(B, T.LC, T.oj, T.oi, vu, vv, s_us, s_vs, c);
    }
    __syncthreads();
    ws::each_cell(T.R0, r1, T.C0, c1, [&](int j, int i) {
      const int k = (j - T.oj) * T.LC + (i - T.oi), g = j * W + i;
      const float a = s_us[k], bv = s_vs[k];
      const float bb = cfd::quad::source_at(s_us, s_vs, k, T.LC, j, i, c.ny, c.nx, c, inner);
      us[g] = a;
      vs[g] = bv;
      b[g] = bb;
      m = cfd::bits_max(m, fabsf(bb));
    });
  }
  tile::fold_max_into(m, acc, max_b);
}

// The channel's predictor + source in one launch (the design above): the
// MAC predictor on (u, v) as given, the channel ghosts on the tentative
// fields and b = rho/dt * div on the cells (projection.py:386) on a
// block's tile, or a padding tile's zeros without loading; the sum of b is
// the next launch
__global__ void __launch_bounds__(tile::kThreads)
    channel_predictor_source_kernel(const float* u, const float* v, float* us, float* vs,
                                    float* b, cfd::quad::ChannelTile f, int H8, int W,
                                    tile::Plan pl) {
  tile::launch_dependents();  // the sum's blocks may launch
  const int ny = f.c.ny, nx = f.c.nx;
  const int t = static_cast<int>(blockIdx.y) * pl.grid_x + static_cast<int>(blockIdx.x);
  const ws::LTile T = ws::make_ltile(t, pl.rows, pl.cols, W, pl.halo);
  const int r1 = min(T.R0 + T.rows, H8), c1 = min(T.C0 + T.cols, W);
  if (T.R0 > ny + 1 || T.C0 > nx + 1) {  // the padding: no valid face, no cell
    zero_own(us, vs, b, T, r1, c1, W);
    return;
  }
  const int n = T.LR * T.LC;
  float* const s_u = tile::smem();
  float* const s_v = s_u + n;
  float* const s_us = s_u + 2 * n;
  float* const s_vs = s_u + 3 * n;
  load_uv(u, v, s_u, s_v, T, H8, W);
  __syncthreads();
  // the own cells from buffer cell (H, H); box A, the positions the
  // stages read (2 rows south, 3 columns west, 1 east, and 2 rows north:
  // a tile whose last own row is the ghost row 0 copies u* of row 1, which
  // reads row 2), box BU, u*'s faces (1 column west), box BV, v*'s (1 row
  // south); the path with no test where A lies in rows [1, ny - 1] x
  // columns [1, nx - 1]
  const int o = T.H;
  const tile::Box A{o - 2, o + T.rows + 2, o - 3, o + T.cols + 1};
  const tile::Box BU{o, o + T.rows, o - 1, o + T.cols};
  const tile::Box BV{o - 1, o + T.rows, o, o + T.cols};
  const bool inner = T.oj + A.r0 >= 1 && T.oj + A.r1 - 1 <= ny - 1 && T.oi + A.c0 >= 1 &&
                     T.oi + A.c1 - 1 <= nx - 1;
  const tile::View vu{s_u, T.oj, T.oi, T.LC}, vv{s_v, T.oj, T.oi, T.LC};
  if (inner) {
    cfd::quad::channel_predictor_boxes<true>(f, BU, BV, T.LC, T.oj, T.oi, vu, vv, s_us, s_vs);
  } else {
    cfd::quad::channel_predictor_boxes<false>(f, BU, BV, T.LC, T.oj, T.oi, vu, vv, s_us,
                                              s_vs);
  }
  __syncthreads();
  ws::each_cell(T.R0, r1, T.C0, c1, [&](int j, int i) {
    const int k = (j - T.oj) * T.LC + (i - T.oi), g = j * W + i;
    const float a = s_us[k], bv = s_vs[k];
    const float bb = cfd::quad::source_at(s_us, s_vs, k, T.LC, j, i, ny, nx, f.pc, inner);
    us[g] = a;
    vs[g] = bv;
    b[g] = bb;
  });
}

// cudaSuccess when the plan covers the (H8, W) array with a halo of at
// least `radius` (the stages' reach) and the shared memory of its four
// buffers, else cudaErrorInvalidValue (the wrapper raises)
cudaError_t check_plan(const tile::Plan& pl, int H8, int W, int ny, int nx, int radius) {
  if (pl.rows < 1 || pl.cols < 1 || pl.halo < radius) return cudaErrorInvalidValue;
  if (ny < 1 || nx < 1 || H8 < ny + 2 || W < nx + 2 || 1LL * H8 * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (pl.grid_x != (W + pl.cols - 1) / pl.cols || pl.grid_y != (H8 + pl.rows - 1) / pl.rows)
    return cudaErrorInvalidValue;
  const long long floats =
      1LL * kPredictorBuffers * (pl.rows + 2 * pl.halo) * (pl.cols + 2 * pl.halo);
  if (pl.smem_bytes != 4 * floats || 4 * floats > tile::kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// the rho-multiplied cavity projection, the cavity ghosts rebuilt from the
// corrected interior, the guess 2p - p_prev (projection.py:281, emit_guess)
__global__ void corrector_kernel(const float* us, const float* vs, const float* p,
                                 const float* p_prev, float* u2, float* v2, float* guess,
                                 Nat c) {
  const long long n = static_cast<long long>(c.H8) * c.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx / c.W);
  const int i = static_cast<int>(idx - static_cast<long long>(j) * c.W);
  auto uc = [&](int jj, int ii) { return u_corr(us, p, jj, ii, c); };
  auto vc = [&](int jj, int ii) { return v_corr(vs, p, jj, ii, c); };
  u2[idx] = lid_u(uc, j, i, c.ny, c.nx, c.ghost);
  v2[idx] = lid_v(vc, j, i, c.ny, c.nx);
  guess[idx] = 2.0f * p[idx] - p_prev[idx];
}

// the rho-divided channel projection on valid faces (0 elsewhere), the
// channel ghosts, the guess 2p - p_prev (projection.py:423, emit_guess)
__global__ void channel_corrector_kernel(const float* us, const float* vs, const float* p,
                                         const float* p_prev, float* u2, float* v2,
                                         float* guess, Nat c) {
  const long long n = static_cast<long long>(c.H8) * c.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx / c.W);
  const int i = static_cast<int>(idx - static_cast<long long>(j) * c.W);
  auto uc = [&](int jj, int ii) { return u_corr(us, p, jj, ii, c); };
  auto vc = [&](int jj, int ii) { return v_corr(vs, p, jj, ii, c); };
  u2[idx] = cfd::quad::channel_u(uc, j, i, c.ny, c.nx, c.ghost);
  v2[idx] = cfd::quad::channel_v(vc, j, i, c.ny, c.nx);
  guess[idx] = 2.0f * p[idx] - p_prev[idx];
}

// the predictor's coefficients (Pred's Hq8, Wqa are not read on this layout)
Pred pred(int ny, int nx, float dt, float nu, float idx, float idy, float idx2, float idy2,
          float rho_dt) {
  return Pred{0, 0, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f};
}

}  // namespace

// max_b: one float; acc: the running max (int bits) and the blocks' count,
// two unsigned ints on the device, 0 before the launch (it leaves them 0);
// plan: the 6 ints of the tile plan (tile::Plan, kernels/plan.py
// natural_predictor_plan), a host array
extern "C" int cfd_predictor_source(const float* u, const float* v, float* us, float* vs,
                                    float* b, float* max_b, unsigned int* acc, int H8, int W,
                                    int ny, int nx, float two_lid, float dt, float nu,
                                    float idx, float idy, float idx2, float idy2,
                                    float rho_dt, const int* plan, void* stream) {
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const cudaError_t err = check_plan(pl, H8, W, ny, nx, kPredictorRadius);
  if (err != cudaSuccess) return static_cast<int>(err);
  predictor_source_kernel<<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      u, v, us, vs, b, max_b, acc, pred(ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt), H8, W,
      two_lid, pl);
  return static_cast<int>(cudaGetLastError());
}

// Readies the predictor + source's tile kernel for `smem_bytes` of dynamic
// shared memory on the current device: blocks (SMs x blocks per SM),
// blocks per SM and registers out (tile::ready)
extern "C" int cfd_predictor_source_grid(int smem_bytes, int* blocks, int* per_sm,
                                         int* regs) {
  return tile::ready(reinterpret_cast<const void*>(predictor_source_kernel), smem_bytes,
                     blocks, per_sm, regs);
}

extern "C" int cfd_corrector(const float* us, const float* vs, const float* p,
                             const float* p_prev, float* u2, float* v2, float* guess, int H8,
                             int W, int ny, int nx, float cu, float cv, float two_lid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  corrector_kernel<<<cfd::blocks_for(static_cast<long long>(H8) * W), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, Nat{H8, W, ny, nx, cu, cv, two_lid});
  return static_cast<int>(cudaGetLastError());
}

// The channel's predictor + source in two launches: the tile kernel, then
// the sum of b. partials: ceil(H8 W / 256) floats of scratch; count: one
// unsigned int, 0 before the call (the sum leaves it 0); sum_b: one float;
// plan: the 6 ints of the tile plan (tile::Plan, kernels/plan.py
// natural_predictor_plan(channel=True)), a host array
extern "C" int cfd_channel_predictor_source(const float* u, const float* v, float* us,
                                            float* vs, float* b, float* partials,
                                            unsigned int* count, float* sum_b, int H8, int W,
                                            int ny, int nx, float uin, float dt, float nu,
                                            float idx, float idy, float idx2, float idy2,
                                            float rho_dt, const int* plan, void* stream) {
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  // the sum takes the array as (4, H8 / 4, W)
  if (H8 % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = check_plan(pl, H8, W, ny, nx, kChannelPredictorRadius);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cfd::quad::ChannelTile f{cfd::quad::Corr{0, 0, ny, nx, 0.f, 0.f, uin},
                                 pred(ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt)};
  channel_predictor_source_kernel<<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes,
                                    s>>>(u, v, us, vs, b, f, H8, W, pl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tile::launch_dependent_source_sum(b, H8 / 4, W, partials, count, sum_b, s));
}

// Readies the channel's predictor + source tile kernel for `smem_bytes` of
// dynamic shared memory on the current device (cfd_predictor_source_grid's
// outputs)
extern "C" int cfd_channel_predictor_source_grid(int smem_bytes, int* blocks, int* per_sm,
                                                 int* regs) {
  return tile::ready(reinterpret_cast<const void*>(channel_predictor_source_kernel),
                     smem_bytes, blocks, per_sm, regs);
}

extern "C" int cfd_channel_corrector(const float* us, const float* vs, const float* p,
                                     const float* p_prev, float* u2, float* v2, float* guess,
                                     int H8, int W, int ny, int nx, float cu, float cv,
                                     float uin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  channel_corrector_kernel<<<cfd::blocks_for(static_cast<long long>(H8) * W), cfd::kThreads,
                             0, s>>>(us, vs, p, p_prev, u2, v2, guess,
                                     Nat{H8, W, ny, nx, cu, cv, uin});
  return static_cast<int>(cudaGetLastError());
}
