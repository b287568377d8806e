// Shared-memory tiles of the one-launch carries: the cavity's and the
// channel's (quad_stage.cu), the backward step's (step_stage.cu) and
// Rayleigh-Benard's (rb_stage.cu). The tile machinery
// of the reference's slab kernels (cfd_tpu/kernels/quad.py
// _make_quad_slab_kernel :132, pl.pallas_call :376), which keeps a row slab
// and a CARRY_RADIUS-row halo in VMEM, on Hopper: a block owns `rows` x
// `cols` plane cells of all four parity planes (a 2 rows x 2 cols logical
// region), loads its inputs with a halo of `halo` plane rows and columns
// into shared memory in the LOGICAL layout, runs the carry's stages there,
// each on the region the next stage reads (a box around the own region
// that shrinks stage by stage), and writes its own cells only. The halo is
// computed redundantly by the neighbouring tiles, so one launch needs no
// grid-wide barrier and the corrected fields never go through device
// memory.
//
// Bits. A tile reproduces the per-cell chains of the first design (the
// twins' arithmetic) exactly: the stages call the accessor-taking
// arithmetic of quad_carry.cuh, step_carry.cuh and rb_carry.cuh through
// accessors that read the shared buffers instead of the quad arrays; a
// position outside the array reads 0, as qld (the loader writes 0 there),
// and a stage whose result the per-cell kernels kept in a scratch array
// reads 0 outside the array too (the kernels zero those positions).
// Reductions take each quad cell once, in its own tile, never a halo copy;
// the maxima are order-free (cfd::bits_max, atomicMax on the int bits) and
// the source sum runs after the tile kernel in the twin's fixed order
// (source_sum below, one launch: launch_source_sum).
//
// Paths. A tile whose every staged position lies at least one cell inside
// the domain's faces (interior(); the step's also off its solid block and
// interface faces, misses_corner()) runs the stages with no ghost or mask
// test, through the *_formula arithmetic; a tile that touches the walls,
// the ghost rows and columns, the padding or the array's edge runs the
// ghost-aware stages (the *_at functions). Both paths compute the same
// operations on the same operands where both apply. The channel's and the
// step's tiles whose own cells all lie outside the domain's ghost ring
// (outside(): the padding columns and rows, a block's rows beyond the
// field) write their outputs' constants without loading. All index arithmetic
// is 32-bit (the entry points refuse fields of 2^31 floats or more), and
// the block loops divide once per thread, not per cell (each()).
//
// The standalone carries launch one block a tile (block_tile). The whole
// step (whole_step.cu) runs the same tile bodies inside its cooperative
// grid of one block an SM: each block walks the tiles t = blockIdx.x + k
// gridDim.x in turn (each_tile), with the next tile's loads in flight
// (cp.async) while the current tile runs its stages.
#pragma once

#include "common.cuh"
#include "predictor.cuh"

namespace cfd {
namespace tile {

// the threads of a tile block (the kernels' launch bounds)
constexpr int kThreads = 512;
// the shared memory a block may use on the H100 (bytes)
constexpr int kSmemMax = 232448;
// the partials the source sum's last block folds in shared memory; levels
// above it fold in device memory first
constexpr int kFoldShared = 4096;

// the buffers a tile's stages write besides its staged inputs: the
// corrected u, v
constexpr int kWorkBuffers = 2;

// What a carry writes into its guess output: nothing, the extrapolated
// warm start 2p - p_prev, or the previous p (the whole step's warm start
// for the step and RB)
enum class Guess { kNone, kExtrapolate, kCopy };

// The launch plan, computed on the host (kernels/plan.py carry_plan,
// whole_step_plan): tiles of rows x cols plane cells with a halo of `halo`
// plane rows and columns, smem_bytes of dynamic shared memory (the flow's
// buffers, each 2 (rows + 2 halo) x 2 (cols + 2 halo) floats), a grid of
// grid_x tile columns by grid_y tile rows: one tile a block, or the tiles
// of a cooperative block in turn (each_tile).
struct Plan {
  int rows, cols, halo, smem_bytes, grid_x, grid_y;
};

// the floats of one logical buffer of a tile
__host__ __device__ inline long long buffer_floats(int rows, int cols, int halo) {
  return 4LL * (rows + 2 * halo) * (cols + 2 * halo);
}

// cudaSuccess when the plan covers a (4, Hq8, Wqa) field with a halo of at
// least `radius` logical rows and its `buffers` buffers, else
// cudaErrorInvalidValue (the wrapper raises)
inline cudaError_t check(const Plan& pl, int Hq8, int Wqa, int radius, int buffers) {
  if (pl.rows < 1 || pl.cols < 1 || 2 * pl.halo < radius) return cudaErrorInvalidValue;
  if (Hq8 < 1 || Wqa < 1 || 4LL * Hq8 * Wqa >= (1LL << 31)) return cudaErrorInvalidValue;
  if (pl.grid_x != (Wqa + pl.cols - 1) / pl.cols || pl.grid_y != (Hq8 + pl.rows - 1) / pl.rows)
    return cudaErrorInvalidValue;
  const long long bytes = 4LL * buffers * buffer_floats(pl.rows, pl.cols, pl.halo);
  if (pl.smem_bytes != bytes || bytes > kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Allow `fn` the card's most dynamic shared memory and report its
// occupancy at smem_bytes: blocks (SMs x blocks per SM), blocks per SM and
// registers per thread. The modules call it once before their first
// launch (kernels/plan.py ready_grid), so a launch makes no query.
inline int ready(const void* fn, int smem_bytes, int* blocks, int* per_sm, int* regs) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *blocks = sms * *per_sm;
  return 0;
}

// the block's dynamic shared memory
__device__ __forceinline__ float* smem() {
  extern __shared__ float4 carry_tile_smem[];
  return reinterpret_cast<float*>(carry_tile_smem);
}

// A tile: own plane rows [R0, R0 + rows) x columns [C0, C0 + cols) of the
// (4, Hq8, Wqa) arrays (clipped at their edge); buffer cell (lj, li) holds
// array logical (aj + lj, ai + li), global logical row gj + lj.
struct Tile {
  int R0, C0, rows, cols, h;
  int LC;      // the buffers' pitch: logical columns
  int N;       // the floats of one buffer (buffer_floats)
  int aj, ai;  // the array's logical row and column of buffer cell (0, 0)
  int gj;      // its global logical row (aj + 2 row0)
};

// the tile in tile column tx, tile row ty of the plan's grid
__device__ __forceinline__ Tile make_tile(const Plan& pl, int Hq8, int Wqa, int row0, int tx,
                                          int ty) {
  Tile T;
  T.R0 = ty * pl.rows;
  T.C0 = tx * pl.cols;
  T.rows = min(pl.rows, Hq8 - T.R0);
  T.cols = min(pl.cols, Wqa - T.C0);
  T.h = pl.halo;
  T.LC = 2 * (pl.cols + 2 * pl.halo);
  T.N = static_cast<int>(buffer_floats(pl.rows, pl.cols, pl.halo));
  T.aj = 2 * (T.R0 - pl.halo);
  T.ai = 2 * (T.C0 - pl.halo);
  T.gj = T.aj + 2 * row0;
  return T;
}

// the block's tile of a launch of one tile a block
__device__ __forceinline__ Tile block_tile(const Plan& pl, int Hq8, int Wqa, int row0) {
  return make_tile(pl, Hq8, Wqa, row0, static_cast<int>(blockIdx.x),
                   static_cast<int>(blockIdx.y));
}

// tile t of the plan's grid, in row-major order
__device__ __forceinline__ Tile tile_at(const Plan& pl, int Hq8, int Wqa, int row0, int t) {
  const int ty = t / pl.grid_x;
  return make_tile(pl, Hq8, Wqa, row0, t - ty * pl.grid_x, ty);
}

// buffer logical rows [r0, r1) x columns [c0, c1)
struct Box {
  int r0, r1, c0, c1;
};

// the own region widened by s rows south, n north, w columns west, e east
__device__ __forceinline__ Box around(const Tile& T, int s, int n, int w, int e) {
  const int o = 2 * T.h;
  return Box{o - s, o + 2 * T.rows + n, o - w, o + 2 * T.cols + e};
}

// Whether every position of box B lies in the domain's rows [1, ny - 1] x
// columns [1, nx - 1] and in the array: there every face is valid, no
// ghost rule applies and no stage value is zeroed, so the stages need no
// test (the interior path)
__device__ __forceinline__ bool interior(const Tile& T, const Box& B, int ny, int nx,
                                         int Hq8) {
  return T.gj + B.r0 >= 1 && T.gj + B.r1 - 1 <= ny - 1 && T.ai + B.c0 >= 1 &&
         T.ai + B.c1 - 1 <= nx - 1 && T.aj + B.r0 >= 0 && T.aj + B.r1 <= 2 * Hq8;
}

// Whether box B misses every position with i <= ci and j >= cj: the
// backward step's solid block {i <= step_i, j > inlet_j} and its interface
// faces (u at i = step_i, v at j = inlet_j), where a face is invalid or
// zeroed (step_carry.cuh); with interior() the step's interior path
__device__ __forceinline__ bool misses_corner(const Tile& T, const Box& B, int ci, int cj) {
  return T.ai + B.c0 > ci || T.gj + B.r1 - 1 < cj;
}

// Whether the tile's own cells all lie outside the domain's logical rows
// [0, ny + 1] or columns [0, nx + 1] (the padding, or a local block's rows
// beyond the field): there every face is invalid, no ghost rule writes and
// no cell has a source, so the channel's and the step's carries give 0 for
// us', vs' and b (the padding path)
__device__ __forceinline__ bool outside(const Tile& T, int ny, int nx) {
  const int o = 2 * T.h;
  const int j0 = T.gj + o, i0 = T.ai + o;
  return i0 > nx + 1 || j0 > ny + 1 || j0 + 2 * T.rows - 1 < 0;
}

// whether buffer cell (lj, li) lies in the array
__device__ __forceinline__ bool in_array(const Tile& T, int lj, int li, int Hq8, int Wqa) {
  const int r = T.aj + lj, c = T.ai + li;
  return r >= 0 && r < 2 * Hq8 && c >= 0 && c < 2 * Wqa;
}

// A buffer read at global logical (j, i): the stage arithmetic's accessor
struct View {
  const float* a;
  int gj, ai, LC;
  __device__ __forceinline__ float operator()(int j, int i) const {
    return a[(j - gj) * LC + (i - ai)];
  }
};

__device__ __forceinline__ View view(const float* a, const Tile& T) {
  return View{a, T.gj, T.ai, T.LC};
}

// f(r, c) over rows [r0, r1) x columns [c0, c1) by the block's kThreads
// threads in flat order, consecutive threads on consecutive columns; one
// division a thread, none a cell
template <class F>
__device__ __forceinline__ void each(int r0, int r1, int c0, int c1, F f) {
  const int nr = r1 - r0, nc = c1 - c0;
  if (nr <= 0 || nc <= 0) return;
  const int t = static_cast<int>(threadIdx.x);
  int r = t / nc, c = t - r * nc;
  const int dr = kThreads / nc, dc = kThreads - dr * nc;
  while (r < nr) {
    f(r0 + r, c0 + c);
    c += dc;
    r += dr;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

// f(lj, li, k) over the cells of box B, k = lj * LC + li
template <class F>
__device__ __forceinline__ void each_cell(const Box& B, int LC, F f) {
  each(B.r0, B.r1, B.c0, B.c1, [&](int lj, int li) { f(lj, li, lj * LC + li); });
}

// Buffer f of dst (dst + f N) = the tile's region (own and halo) of quad
// field src[f] in the logical layout, 0 outside the array (qld's value);
// the 4 NF loads of a plane cell are issued together
template <int NF>
__device__ __forceinline__ void load(const float* const (&src)[NF], float* dst, const Tile& T,
                                     int Hq8, int Wqa) {
  const int plane = Hq8 * Wqa;
  each(0, T.rows + 2 * T.h, 0, T.cols + 2 * T.h, [&](int r, int c) {
    const int gr = T.R0 - T.h + r, gc = T.C0 - T.h + c;
    const bool in = gr >= 0 && gr < Hq8 && gc >= 0 && gc < Wqa;
    const int g = gr * Wqa + gc;
    float v[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[f][q] = in ? src[f][q * plane + g] : 0.f;
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[f * T.N + (2 * r + (q >> 1)) * T.LC + 2 * c + (q & 1)] = v[f][q];
      }
    }
  });
}

// One float copied from device memory into shared memory without passing
// through registers (cp.async, completed by cp_async_wait); 0 written
// where !in (a source size of 0 bytes: nothing is read)
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// load's copies issued as cp.async (the same values into the same places);
// the caller commits them as one group
template <int NF>
__device__ __forceinline__ void load_async(const float* const (&src)[NF], float* dst,
                                           const Tile& T, int Hq8, int Wqa) {
  const int plane = Hq8 * Wqa;
  each(0, T.rows + 2 * T.h, 0, T.cols + 2 * T.h, [&](int r, int c) {
    const int gr = T.R0 - T.h + r, gc = T.C0 - T.h + c;
    const bool in = gr >= 0 && gr < Hq8 && gc >= 0 && gc < Wqa;
    const int g = in ? gr * Wqa + gc : 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cp_async_f32(dst + f * T.N + (2 * r + (q >> 1)) * T.LC + 2 * c + (q & 1),
                     src[f] + q * plane + g, in);
      }
    }
  });
}

// The input sets each_tile stages: the running tile's and the next one's
constexpr int kInputSets = 2;

// The tiles of one block of a cooperative grid, in turn: t = blockIdx.x +
// k gridDim.x over the plan's grid_x * grid_y tiles (the whole step,
// whole_step.cu). body(tile, in, work) runs a carry's stages from the
// tile's NF staged inputs of src (in: NF buffers) with the kWorkBuffers
// buffers at work; loads(tile) says whether a tile stages its inputs (the
// padding path's do not). The next tile's loads are in flight (cp.async)
// into the other of kInputSets input sets while this tile runs. A
// __syncthreads() separates a tile's last reads of the buffers from the
// loads that overwrite them, and ends the loop, so the caller may reuse
// the shared memory. Shared memory: kInputSets NF + kWorkBuffers buffers.
// Every thread of the block calls it.
template <int NF, class Loads, class Body>
__device__ __forceinline__ void each_tile(const Plan& pl, int Hq8, int Wqa, int row0,
                                          const float* const (&src)[NF], Loads loads,
                                          Body body) {
  static_assert(kInputSets == 2, "the running tile's inputs and the next one's");
  const int n = pl.grid_x * pl.grid_y, stride = static_cast<int>(gridDim.x);
  const int N = static_cast<int>(buffer_floats(pl.rows, pl.cols, pl.halo));
  float* cur = smem();
  float* next = cur + NF * N;
  float* const work = cur + kInputSets * NF * N;
  int k = static_cast<int>(blockIdx.x);
  Tile t{};
  if (k < n) {
    t = tile_at(pl, Hq8, Wqa, row0, k);
    if (loads(t)) load_async<NF>(src, cur, t, Hq8, Wqa);
  }
  cp_async_commit();
  for (; k < n; k += stride) {
    Tile t2{};
    if (k + stride < n) {
      t2 = tile_at(pl, Hq8, Wqa, row0, k + stride);
      if (loads(t2)) load_async<NF>(src, next, t2, Hq8, Wqa);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group
    __syncthreads();
    body(t, cur, work);
    __syncthreads();
    t = t2;
    float* const done = cur;
    cur = next;
    next = done;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// f(g, gr, lj, li) over the tile's own plane cells: gr the array plane
// row, g the flat index of plane 0's cell, (lj, li) the buffer cell of its
// plane-0 logical cell (plane q's at (lj + (q >> 1), li + (q & 1))): the
// output pass, coalesced over each plane
template <class F>
__device__ __forceinline__ void each_own(const Tile& T, int Wqa, F f) {
  const int o = 2 * T.h;
  each(0, T.rows, 0, T.cols, [&](int r, int c) {
    const int gr = T.R0 + r;
    f(gr * Wqa + T.C0 + c, gr, o + 2 * r, o + 2 * c);
  });
}

// f(gq) over every quad index gq of the tile's own cells, all four planes:
// the padding path's output pass
template <class F>
__device__ __forceinline__ void each_own_index(const Tile& T, int Hq8, int Wqa, F f) {
  const int plane = Hq8 * Wqa;
  each(0, T.rows, 0, T.cols, [&](int r, int c) {
    const int g = (T.R0 + r) * Wqa + T.C0 + c;
#pragma unroll
    for (int q = 0; q < 4; ++q) f(q * plane + g);
  });
}

// Block-wide maxima of v[k] >= 0 (or NaN, sorting above +inf) into out[k]
// as int bits (atomicMax: the order does not matter); every thread calls it
template <int N>
__device__ __forceinline__ void block_max(const float (&v)[N], float* out) {
  __shared__ int warp_max[N][kThreads / 32];
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int x = __float_as_int(v[k]);
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane == 0) warp_max[k][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      int x = lane < kThreads / 32 ? warp_max[k][lane] : 0;
      for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_down_sync(0xffffffffu, x, o));
      if (lane == 0) atomicMax(reinterpret_cast<int*>(out) + k, x);
    }
  }
}

// The block's max of v >= 0 folded into a launch's running max, moved
// into *res by the last block to finish: acc holds the running max (int
// bits) and the blocks' count, both 0 before the launch and left 0 after
// it, so no launch zeroes them (a __threadfence and an atomic count order
// every block's fold before the last block's read). Every thread of every
// block of the grid calls it.
__device__ __forceinline__ void fold_max_into(float v, unsigned int* acc, float* res) {
  const float m[1] = {v};
  block_max(m, reinterpret_cast<float*>(acc));
  if (threadIdx.x == 0) {  // the thread that folded the block's max into acc[0]
    __threadfence();
    if (atomicAdd(acc + 1, 1u) == gridDim.x * gridDim.y - 1) {
      __threadfence();
      *res = __uint_as_float(atomicExch(acc, 0u));
      atomicExch(acc + 1, 0u);
    }
  }
}

// Whether flat quad index k of a (4, Hq8, Wqa) block lies in its own plane
// rows [halo, Hq8 - halo) (cfd::own_row in 32 bits)
__device__ __forceinline__ bool own_row32(int k, int Hq8, int Wqa, int halo) {
  const int J = (k % (Hq8 * Wqa)) / Wqa;
  return J >= halo && J < Hq8 - halo;
}

// The sums of b's cfd::kThreads-wide chunks c = c0, c0 + dc, ... of the
// flat array into partials[c] (over the own rows: a local block's halo
// rows read 0, kBlock), each by cfd::block_sum_to's pairwise tree. One
// warp sums one chunk (the calling warp: c0 and dc count warps): its lanes
// hold the chunk's values 32 apart, so the tree's first three levels
// (strides 128, 64, 32) add a lane's own values and the last five (16 ...
// 1) are shuffles, the same pairs in the same order as the shared-memory
// tree (and cfd::ws::chunk_sums). No barrier.
template <bool kBlock>
__device__ __forceinline__ void warp_chunk_sums(const float* b, int Hq8, int Wqa, int halo,
                                                float* partials, int c0, int dc) {
  static_assert(cfd::kThreads == 256, "a chunk is 8 values a lane");
  const int n = 4 * Hq8 * Wqa;
  const int chunks = (n + cfd::kThreads - 1) / cfd::kThreads;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  for (int c = c0; c < chunks; c += dc) {
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int k = c * cfd::kThreads + lane + 32 * m;
      v[m] = (k < n && (!kBlock || own_row32(k, Hq8, Wqa, halo))) ? b[k] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] = v[m] + v[m + 4];
    v[0] = v[0] + v[2];
    v[1] = v[1] + v[3];
    float x = v[0] + v[1];
    for (int o = 16; o > 0; o >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) partials[c] = x;
  }
}

// Programmatic dependent launch (Hopper's griddepcontrol): a kernel lets
// the kernel launched after it with the programmatic stream serialization
// attribute start its blocks once every block of this one has called
// launch_dependents (or exited); the dependent calls wait_prerequisites,
// which returns when the kernel before it has completed and its memory is
// visible, before it reads what that kernel wrote.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The source sum of b over the own rows (all rows where halo is 0) in the
// order of the twin's fixed_order_sum (kernels/quad.py): the flat array in
// cfd::kThreads-wide chunks, each summed by cfd::block_sum_to's pairwise
// tree (warp_chunk_sums), then the chunk partials by fold_sum. The last
// block to finish (a __threadfence and an
// atomic count, which it resets, so no launch zeroes it) folds the
// partials: the levels above kFoldShared partials in device memory, the
// rest in shared memory. Launched with cfd::kThreads threads a block.
template <bool kBlock>
__device__ __forceinline__ void source_sum(const float* b, int Hq8, int Wqa, int halo,
                                           float* partials, unsigned int* count, float* sum) {
  const int n = 4 * Hq8 * Wqa;
  const int chunks = (n + cfd::kThreads - 1) / cfd::kThreads;
  const int warps = cfd::kThreads / 32;
  warp_chunk_sums<kBlock>(b, Hq8, Wqa, halo, partials,
                          static_cast<int>(blockIdx.x) * warps +
                              (static_cast<int>(threadIdx.x) >> 5),
                          static_cast<int>(gridDim.x) * warps);
  __shared__ bool last;
  __shared__ float s[kFoldShared];
  __threadfence();  // this block's partials before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int first = static_cast<int>(threadIdx.x), step = static_cast<int>(blockDim.x);
  auto sync = [] { __syncthreads(); };
  // the partials other blocks wrote are read past L1 (volatile, __ldcg)
  volatile float* x = partials;
  int m = chunks;
  while (m > kFoldShared) m = cfd::fold_level(x, m, first, step, sync);
  // all of a thread's (at most kFoldShared / kThreads) loads in flight
  // before its stores: one round trip to L2, not one a partial
  constexpr int kBatch = kFoldShared / cfd::kThreads;
  float v[kBatch];
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    const int t = first + r * step;
    v[r] = t < m ? __ldcg(partials + t) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    const int t = first + r * step;
    if (t < m) s[t] = v[r];
  }
  __syncthreads();
  const float total = cfd::fold_sum(s, m, first, step, sync);
  if (threadIdx.x == 0) {
    *sum = total;
    *count = 0u;
  }
}

// The inputs a duct carry's tile stages (us, vs, p) and its buffers: the
// inputs, then the corrected u, v (u*, v* overwrite us, vs)
constexpr int kDuctInputs = 3;
constexpr int kDuctBuffers = kDuctInputs + kWorkBuffers;

// The guess output of a carry at quad index gq: 2p - p_prev or p, from p's
// value pv (kG)
template <Guess kG>
__device__ __forceinline__ void write_guess(float* guess, int gq, float pv, float p_prev) {
  if constexpr (kG == Guess::kExtrapolate) guess[gq] = 2.0f * pv - p_prev;
  if constexpr (kG == Guess::kCopy) guess[gq] = pv;
}

// The four planes' values of quad field a at plane cell g into v, loaded
// together before an output pass's stores: the compiler may not move a
// load past a store to another float array, so a load among the stores
// would cost a round trip of its own
__device__ __forceinline__ void own4(const float* a, int g, int plane, float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = a[q * plane + g];
}

// The padding path of the duct carries: a tile whose own cells all lie
// outside the ghost ring (outside) writes the outputs' constants without
// loading (us', vs', b 0, and the guess)
template <Guess kG>
__device__ __forceinline__ void duct_pad(const Tile& t, const float* p, const float* p_prev,
                                         float* us2, float* vs2, float* b, float* guess,
                                         int Hq8, int Wqa) {
  each_own_index(t, Hq8, Wqa, [&](int gq) {
    const float pv = kG == Guess::kNone ? 0.f : p[gq];
    const float pp = kG == Guess::kExtrapolate ? p_prev[gq] : 0.f;
    us2[gq] = 0.f;
    vs2[gq] = 0.f;
    b[gq] = 0.f;
    write_guess<kG>(guess, gq, pv, pp);
  });
}

// The carry of the duct flows, the channel's and the step's (an inlet, an
// outlet, walls; quad_stage.cu, step_stage.cu), on tile t from its staged
// us, vs, p in `in` (kDuctInputs buffers, the plan's halo) with the
// corrected u, v in `work`: the corrected, ghosted u, v on box A, which
// the predictor and the ghosts of the tentative fields read (the own
// region widened 2 rows south, 1 north, 3 columns west, 1 east: the outlet
// copies reach one column further than the predictor), u* on the own cells
// and one column west, v* on the own cells and one row south, then us',
// vs', b = rho/dt * div on the flow's cells and the guess (kG) of the own
// cells, with the Courant maxima of the corrected u, v over the own rows
// into m (kAdaptive). F, the flow, gives the arithmetic at global logical
// (j, i) on tile Views: inner(t, A) (the path with no ghost or mask
// test), uv_formula / uv_at (the corrected u, v without and with the
// ghosts), us_at / vs_at (u*, v* with the ghosts of the tentative fields),
// cell(j, i), and its constants c (Hq8, Wqa, ny, nx, row0) and pc (the
// predictor's, dt already read on the card). A tile outside the ghost
// ring takes duct_pad instead.
template <bool kAdaptive, bool kBlock, Guess kG, class F>
__device__ __forceinline__ void duct_tile(const F& f, const Tile& t, float* in, float* work,
                                          const float* p_prev, float* us2, float* vs2,
                                          float* b, float* guess, float (&m)[2], int halo) {
  const int Hq8 = f.c.Hq8, Wqa = f.c.Wqa, plane = Hq8 * Wqa, LC = t.LC;
  const cfd::Pred& pc = f.pc;
  float* const s_us = in;
  float* const s_vs = in + t.N;
  float* const s_p = in + 2 * t.N;
  float* const s_u = work;
  float* const s_v = work + t.N;
  const Box A = around(t, 2, 1, 3, 1), BU = around(t, 0, 0, 1, 0), BV = around(t, 1, 0, 0, 0);
  const View vus = view(s_us, t), vvs = view(s_vs, t), vp = view(s_p, t);
  const View vu = view(s_u, t), vv = view(s_v, t);
  const bool inner = f.inner(t, A);
  if (inner) {
    each_cell(A, LC, [&](int lj, int li, int k) {
      const float2 uv = f.uv_formula(vus, vvs, vp, t.gj + lj, t.ai + li);
      s_u[k] = uv.x;
      s_v[k] = uv.y;
    });
    __syncthreads();
    each_cell(BU, LC, [&](int lj, int li, int k) {
      s_us[k] = cfd::u_star_formula(vu, vv, t.gj + lj, t.ai + li, pc);
    });
    each_cell(BV, LC, [&](int lj, int li, int k) {
      s_vs[k] = cfd::v_star_formula(vu, vv, t.gj + lj, t.ai + li, pc);
    });
  } else {
    each_cell(A, LC, [&](int lj, int li, int k) {
      float2 uv = make_float2(0.f, 0.f);  // outside the array a neighbour reads 0
      if (in_array(t, lj, li, Hq8, Wqa)) uv = f.uv_at(vus, vvs, vp, t.gj + lj, t.ai + li);
      s_u[k] = uv.x;
      s_v[k] = uv.y;
    });
    __syncthreads();
    each_cell(BU, LC, [&](int lj, int li, int k) {
      s_us[k] = f.us_at(vu, vv, t.gj + lj, t.ai + li);
    });
    each_cell(BV, LC, [&](int lj, int li, int k) {
      s_vs[k] = f.vs_at(vu, vv, t.gj + lj, t.ai + li);
    });
  }
  __syncthreads();
  each_own(t, Wqa, [&](int g, int gr, int lj0, int li0) {
    const bool own = !kBlock || (gr >= halo && gr < Hq8 - halo);
    float pp[4] = {};
    if constexpr (kG == Guess::kExtrapolate) own4(p_prev, g, plane, pp);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lj = lj0 + (q >> 1), li = li0 + (q & 1);
      const int k = lj * LC + li, gq = q * plane + g;
      const float a = s_us[k], bv = s_vs[k];
      float bb = 0.f;
      if (inner || f.cell(t.gj + lj, t.ai + li)) {
        const float div = (a - s_us[k - 1]) * pc.idx + (bv - s_vs[k - LC]) * pc.idy;
        bb = pc.rho_dt * div;
      }
      us2[gq] = a;
      vs2[gq] = bv;
      b[gq] = bb;
      write_guess<kG>(guess, gq, s_p[k], pp[q]);
      if (kAdaptive && own) {
        m[0] = cfd::bits_max(m[0], fabsf(s_u[k]));
        m[1] = cfd::bits_max(m[1], fabsf(s_v[k]));
      }
    }
  });
}

// A duct carry's launch of one tile a block (the standalone carries): the
// padding path, or the loads, then duct_tile, then the Courant maxima into
// courant[0], courant[1] (kAdaptive)
template <bool kAdaptive, bool kBlock, Guess kG, class F>
__device__ __forceinline__ void duct_carry(const F& f, const float* us, const float* vs,
                                           const float* p, const float* p_prev, float* us2,
                                           float* vs2, float* b, float* guess, float* courant,
                                           const Plan& pl, int halo) {
  const int Hq8 = f.c.Hq8, Wqa = f.c.Wqa;
  const Tile t = block_tile(pl, Hq8, Wqa, f.c.row0);
  if (outside(t, f.c.ny, f.c.nx)) {  // the maxima keep their zeroing
    duct_pad<kG>(t, p, p_prev, us2, vs2, b, guess, Hq8, Wqa);
    return;
  }
  const float* src[kDuctInputs] = {us, vs, p};
  load<kDuctInputs>(src, smem(), t, Hq8, Wqa);
  __syncthreads();
  float m[2] = {0.f, 0.f};
  duct_tile<kAdaptive, kBlock, kG>(f, t, smem(), smem() + kDuctInputs * t.N, p_prev, us2, vs2,
                                   b, guess, m, halo);
  if constexpr (kAdaptive) block_max(m, courant);
}

// The source sum's launch over the own rows of a (4, Hq8, Wqa) field or a
// local block with a `halo`-row strip (halo 0: every row): a warp a chunk,
// at most 256 blocks of cfd::kThreads threads, so that few arrive at the
// count. partials: ceil(4 Hq8 Wqa / 256) floats of scratch; count: one
// unsigned int, 0 before the launch and after it. Shared by the channel's,
// the step's and RB's carries; defined once, in rb_stage.cu. Returns the
// launch's error.
cudaError_t launch_source_sum(const float* b, int Hq8, int Wqa, int halo, float* partials,
                              unsigned int* count, float* sum, cudaStream_t stream);

// The same sum over a whole field launched as the programmatic dependent
// of the kernel before it on the stream, which writes b and lets its
// dependents launch from each block's start
// (launch_dependents): the sum's blocks are set up while that kernel's
// last blocks run and wait for its completion and its memory
// (wait_prerequisites) before they read b. The channel's non-carry stages'
// second launch; defined once, in rb_stage.cu.
cudaError_t launch_dependent_source_sum(const float* b, int Hq8, int Wqa, float* partials,
                                        unsigned int* count, float* sum, cudaStream_t stream);

}  // namespace tile
}  // namespace cfd
