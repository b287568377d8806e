// The finest multigrid level in shared-memory tiles: the block-level
// loops, the tile machinery (a tile's buffers, their loads and stores, the
// level-1 correction's tile and its prolongation) and the bodies of the
// pre and post kernels on one tile, for the separable level (the
// quad_level0.cuh arithmetic: the cavity, the channel, RB) and for the
// backward step's exact masked level. Shared by the whole-solve
// (whole_solve.cuh: every tile of a whole field inside its cooperative
// grid) and the standalone finest-level kernels (quad_vcycle.cu,
// step_vcycle.cu: one tile a block, on a whole field or a shard's local
// block), so that the two run the same bodies.
//
// A tile is the block's own plane rows [R0, R0 + rows) x columns [C0, C0 +
// cols) of all four planes, loaded with a halo of h plane rows and columns
// into shared memory as a LOGICAL (2 (rows + 2h)) x (2 (cols + 2h)) array
// (logical cell (j, i) of the quad layout at local (j - oj, i - oi), j the
// global row); a position outside the array reads 0, as qld's. Stage s of
// a phase (from 0) updates the local cells [s + 1, LR - s - 1) x [s + 1,
// LC - s - 1) from stage s - 1's values, so after s + 1 stages the cells
// at least s + 1 from the buffer's edge hold exactly what the per-cell
// kernels compute there: every stage reads only the 3 x 3 box around a
// cell (the masked ghost stage included, step_level0.cuh). The halo is as
// deep as the stages need (kernels/plan.py halos); the tile writes its own
// cells only.
//
// Local blocks (kBlock; the shard kernels of rows 16b, 16c and 16f): the
// arrays are a shard's (4, P + 16, Wqa) block at global plane row row0, so
// j is global in every mask, weight, ghost and interface test; stage
// ``lo`` of the ledger writes only the rows of its band (in_band,
// step_in_band), a cell outside the band keeping its input; a position
// outside the block stays 0 (no band reaches it, and the prolongation
// adds nothing there); a residual outside the block is 0; and the level-1
// correction's row Hq8 of the coarse tile reads the block's row 0 (the
// TPU kernel's roll within its slab, quad.py:762-767). The whole-field
// instances (kBlock false) fold the offset, the bands and the wrap away at
// compile time.
#pragma once

#include "carry_tile.cuh"
#include "common.cuh"
#include "quad_level0.cuh"
#include "step_level0.cuh"

namespace cfd {
namespace ws {

// ------------------------------------------------------- block-level loops

// f(j, i) on rows [r0, r1) x columns [c0, c1): warps over rows, lanes over
// columns
template <class F>
__device__ __forceinline__ void each_cell(int r0, int r1, int c0, int c1, F f) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int nw = static_cast<int>(blockDim.x) >> 5;
  for (int j = r0 + (static_cast<int>(threadIdx.x) >> 5); j < r1; j += nw) {
    for (int i = c0 + lane; i < c1; i += 32) f(j, i);
  }
}

// An update of one cell: whether it is written, and its value
struct Upd {
  bool on;
  float v;
};

// out[j * pitch + i] = f(j, i).v where f(j, i).on, over the cells of
// `colour` ((j + i) & 1; every cell if colour < 0) of rows [r0, r1) x
// columns [c0, c1): warps over rows, two cells a lane at a time, both
// values computed before either is stored. f may read out: no cell an
// update reads is one that the same pass writes (a red/black sweep's
// other colour, a pointwise update's own cell).
template <class F>
__device__ __forceinline__ void update2(float* out, int pitch, int r0, int r1, int c0, int c1,
                                        int colour, F f) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int nw = static_cast<int>(blockDim.x) >> 5;
  const int step = colour < 0 ? 32 : 64;
  for (int j = r0 + (static_cast<int>(threadIdx.x) >> 5); j < r1; j += nw) {
    const int first = colour < 0 ? c0 + lane : c0 + ((j + c0 + colour) & 1) + 2 * lane;
    for (int i = first; i < c1; i += 2 * step) {
      const int i2 = i + step;
      const Upd a = f(j, i);
      const Upd b = i2 < c1 ? f(j, i2) : Upd{false, 0.f};
      if (a.on) out[j * pitch + i] = a.v;
      if (b.on) out[j * pitch + i2] = b.v;
    }
  }
}

// dst[j * dp + i] = src(j, i) on rows [0, rows) x columns [0, cols): warps
// over rows, each lane's four columns 32 apart loaded before they are
// stored, so four loads are in flight a thread
template <class Src>
__device__ __forceinline__ void copy_rect(float* dst, int dp, int rows, int cols, Src src) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int nw = static_cast<int>(blockDim.x) >> 5;
  for (int j = static_cast<int>(threadIdx.x) >> 5; j < rows; j += nw) {
    for (int i0 = lane; i0 < cols; i0 += 128) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = i0 + 32 * u < cols ? src(j, i0 + 32 * u) : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + 32 * u < cols) dst[j * dp + i0 + 32 * u] = v[u];
      }
    }
  }
}

// ------------------------------------------------------------ the tiles

struct Tile {
  int R0, C0, rows, cols, h;
  int oj, oi;  // the global logical origin of the buffers
  int LR, LC;  // the buffers' logical rows and columns
  int row0;    // the array's global plane row of its row 0 (a local block's)
};

// tile t (row-major) of the tiles of tile_rows x tile_cols plane cells
// over an array of Wqa plane columns at global plane row row0
__device__ inline Tile make_tile(int tile_rows, int tile_cols, int Wqa, int t, int h,
                                 int row0 = 0) {
  const int ncol = (Wqa + tile_cols - 1) / tile_cols;
  Tile T;
  T.R0 = (t / ncol) * tile_rows;
  T.C0 = (t % ncol) * tile_cols;
  T.rows = tile_rows;
  T.cols = tile_cols;
  T.h = h;
  T.oj = 2 * (T.R0 - h + row0);
  T.oi = 2 * (T.C0 - h);
  T.LR = 2 * (T.rows + 2 * h);
  T.LC = 2 * (T.cols + 2 * h);
  T.row0 = row0;
  return T;
}

__device__ inline int tile_count(int tile_rows, int tile_cols, int Hq8, int Wqa) {
  return ((Hq8 + tile_rows - 1) / tile_rows) * ((Wqa + tile_cols - 1) / tile_cols);
}

// buf_a, buf_b = the tile's region of quad fields a, b in the logical
// layout (all four planes' loads of a cell issued together)
__device__ inline void load_tile(const float* a, const float* b, const Tile& T, int Hq8, int Wqa,
                                 float* buf_a, float* buf_b) {
  const long long plane = static_cast<long long>(Hq8) * Wqa;
  each_cell(0, T.rows + 2 * T.h, 0, T.cols + 2 * T.h, [&](int r, int c) {
    const int gr = T.R0 - T.h + r, gc = T.C0 - T.h + c;
    const bool in = gr >= 0 && gr < Hq8 && gc >= 0 && gc < Wqa;
    const long long g = static_cast<long long>(gr) * Wqa + gc;
    float va[4], vb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      va[q] = in ? a[q * plane + g] : 0.f;
      vb[q] = in ? b[q * plane + g] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = (2 * r + (q >> 1)) * T.LC + 2 * c + (q & 1);
      buf_a[k] = va[q];
      buf_b[k] = vb[q];
    }
  });
}

// the tile's own cells of buf into quad field dst
__device__ inline void store_tile(const float* buf, const Tile& T, int Hq8, int Wqa, float* dst) {
  const long long plane = static_cast<long long>(Hq8) * Wqa;
  each_cell(T.R0, min(T.R0 + T.rows, Hq8), T.C0, min(T.C0 + T.cols, Wqa), [&](int gr, int gc) {
    const int r = gr - T.R0 + T.h, c = gc - T.C0 + T.h;
    const long long g = static_cast<long long>(gr) * Wqa + gc;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dst[q * plane + g] = buf[(2 * r + (q >> 1)) * T.LC + 2 * c + (q & 1)];
    }
  });
}

// Whether the tile's own cells all lie outside the domain's logical rows
// [0, ny + 1] or columns [0, nx + 1] (the padding columns; a block's rows
// beyond the field): no stage changes them and their residual and level-1
// source are 0, so the standalone kernels copy them (copy_own) without
// staging
__device__ __forceinline__ bool tile_outside(const Tile& T, int ny, int nx) {
  const int j0 = 2 * (T.R0 + T.row0), i0 = 2 * T.C0;
  return i0 > nx + 1 || j0 > ny + 1 || j0 + 2 * T.rows - 1 < 0;
}

// dst = src on the tile's own cells of (4, Hq8, Wqa) fields
__device__ inline void copy_own(const float* src, float* dst, const Tile& T, int Hq8, int Wqa) {
  const long long plane = static_cast<long long>(Hq8) * Wqa;
  each_cell(T.R0, min(T.R0 + T.rows, Hq8), T.C0, min(T.C0 + T.cols, Wqa), [&](int gr, int gc) {
    const long long g = static_cast<long long>(gr) * Wqa + gc;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = src[q * plane + g];
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q * plane + g] = v[q];
  });
}

// The level-1 correction rows [R0 - h, R0 + rows + h] x columns [C0 - h, C0
// + cols + h] of aligned (Hq8, Wqa) array ec, the rows and columns the
// tile's prolongation reads, read at the global coarse row J
struct CoarseTile {
  const float* e;
  int J0, I0, pitch;
  __device__ __forceinline__ float operator()(int J, int I) const {
    return e[(J - J0) * pitch + (I - I0)];
  }
};

// kWrap (a local block): the array's row Hq8 is its row 0, as the
// twins' torch.roll(ec, -1) within the block; elsewhere a row outside the
// array reads 0 (no fluid cell of a whole field reads one)
template <bool kWrap = false>
__device__ inline CoarseTile load_coarse_tile(const float* ec, const Tile& T, int Hq8, int Wqa,
                                              float* buf) {
  const int rows = T.rows + 2 * T.h + 1, cols = T.cols + 2 * T.h + 1;
  copy_rect(buf, cols, rows, cols, [&](int r, int c) {
    int J = T.R0 - T.h + r;
    if (kWrap && J == Hq8) J = 0;
    const int I = T.C0 - T.h + c;
    return (J >= 0 && J < Hq8 && I >= 0 && I < Wqa) ? ec[static_cast<long long>(J) * Wqa + I]
                                                    : 0.f;
  });
  return CoarseTile{buf, T.R0 - T.h + T.row0, T.C0 - T.h, cols};
}

// The 9-3-3-1 prolongation of the level-1 correction at logical (j, i)
// from a coarse tile, with the edge clamps on J = 0, J = ny/2, I = 0, I =
// nx/2 (cfd_tpu/kernels/quad.py:741-760; a cell of the interior reads rows
// J, J + 1 and columns I, I + 1, all in the tile)
__device__ __forceinline__ float tile_prolong_corr(const CoarseTile& E, int j, int i, int ny,
                                                   int nx) {
  const int r = j & 1, s = i & 1, J = j >> 1, I = i >> 1;
  const int nyc = ny / 2, nxc = nx / 2;
  auto rowmix = [&](int col) {
    const float e0 = E(J, col);
    const float e1 = E(J + 1, col);
    const float ecJ0 = (J == 0) ? e1 : e0;
    const float ecJ1 = (J == nyc) ? e0 : e1;
    return r == 0 ? 0.75f * ecJ0 + 0.25f * ecJ1 : 0.25f * ecJ0 + 0.75f * ecJ1;
  };
  const float rm = rowmix(I);
  const float rm1 = rowmix(I + 1);
  const float m0 = (I == 0) ? rm1 : rm;
  const float m1 = (I == nxc) ? rm : rm1;
  return s == 0 ? 0.75f * m0 + 0.25f * m1 : 0.25f * m0 + 0.75f * m1;
}

// A logical buffer of a tile read at global logical (j, i)
struct TileView {
  const float* a;
  int oj, oi, LC;
  __device__ __forceinline__ float operator()(int j, int i) const {
    return a[(j - oj) * LC + (i - oi)];
  }
};

// ------------------------------- the separable finest level (quad_level0.cuh)

// the tile's weight vectors in shared memory, by local column (e, w) and
// local row (n, s); 0 outside the array (on a block, j global: L.wN and
// L.wS are indexed by the global row)
struct TileW {
  float *e, *w, *n, *s;
};

// The floats of the weight vectors of a tile
__device__ __forceinline__ int tile_weight_floats(const Tile& T) { return 2 * (T.LR + T.LC); }

template <bool kBlock>
__device__ inline TileW load_tile_weights(const cfd::Level0& L, const Tile& T, float* buf) {
  const TileW W{buf, buf + T.LC, buf + 2 * T.LC, buf + 2 * T.LC + T.LR};
  for (int k = static_cast<int>(threadIdx.x); k < T.LC; k += static_cast<int>(blockDim.x)) {
    const int i = T.oi + k;
    const bool in = i >= 0 && i < 2 * L.Wqa;
    W.e[k] = in ? L.wE[i] : 0.f;
    W.w[k] = in ? L.wW[i] : 0.f;
  }
  for (int k = static_cast<int>(threadIdx.x); k < T.LR; k += static_cast<int>(blockDim.x)) {
    const int j = T.oj + k, jl = kBlock ? j - 2 * T.row0 : j;
    const bool in = jl >= 0 && jl < 2 * L.Hq8;
    W.n[k] = in ? L.wN[j] : 0.f;
    W.s[k] = in ? L.wS[j] : 0.f;
  }
  return W;
}

// signed residual b - A p at local (lj, li) of a tile (cfd::apply_a): 0
// off the interior and outside a block
template <bool kBlock>
__device__ __forceinline__ float sep_residual(const float* p, const float* b, const TileW& W,
                                              const Tile& T, int lj, int li,
                                              const cfd::Level0& L) {
  const int j = T.oj + lj;
  if (!cfd::interior(j, T.oi + li, L)) return 0.f;
  if constexpr (kBlock) {
    const int jl = j - 2 * T.row0;
    if (jl < 0 || jl >= 2 * L.Hq8) return 0.f;
  }
  const int k = lj * T.LC + li;
  const float* c = p + k;
  const float ap = cfd::apply_a(c[0], c[1], c[-1], c[T.LC], c[-T.LC], W.e[li], W.w[li],
                                W.n[lj], W.s[lj], L.idx2, L.idy2);
  return b[k] - ap;
}

// n_pairs red/black pairs of the tile's iterate p in place (cfd::gs_update),
// half-sweep k (from 1) on the band k + shift of a block
template <bool kBlock>
__device__ inline void sep_pairs(float* p, const float* b, const TileW& W, const Tile& T,
                                 const cfd::Level0& L, int n_pairs, int shift) {
  for (int k = 0; k < 2 * n_pairs; ++k) {
    update2(p, T.LC, k + 1, T.LR - k - 1, k + 1, T.LC - k - 1, k & 1, [&](int lj, int li) {
      const int j = T.oj + lj;
      if (!cfd::interior(j, T.oi + li, L)) return Upd{false, 0.f};
      if (kBlock && !cfd::in_band((j >> 1) - T.row0, k + 1 + shift, L)) return Upd{false, 0.f};
      const float* c = p + lj * T.LC + li;
      return Upd{true, cfd::gs_update(c[0], c[1], c[-1], c[T.LC], c[-T.LC], b[lj * T.LC + li],
                                      W.e[li], W.w[li], W.n[lj], W.s[lj], L.idx2, L.idy2,
                                      L.omega)};
    });
    __syncthreads();
  }
}

// The floats of the separable bodies' buffers: the iterate, the source and
// the weight vectors; the post body's coarse tile follows them
__device__ __forceinline__ int sep_tile_floats(const Tile& T) {
  return 2 * T.LR * T.LC + tile_weight_floats(T);
}

// cudaSuccess when a separable pre (post false) or post kernel's tile plan
// covers L's (4, Hq8, Wqa) field with the halo its half-sweeps and
// residual reach (n_pairs + 1 plane rows) and the shared memory of the
// iterate, the source, the weight vectors (and on post the coarse tile),
// else cudaErrorInvalidValue (the wrapper raises); quad_vcycle.cu's kernels
// and the fused-pre carry's phase B (quad_fused_pre.cu) check their plans
// so
inline cudaError_t check_sep_plan(const tile::Plan& pl, const cfd::Level0& L, int n_pairs,
                                  bool post) {
  if (n_pairs < 1 || pl.halo != n_pairs + 1) return cudaErrorInvalidValue;
  if (pl.rows < 1 || pl.cols < 1 || L.Hq8 < 1 || L.Wqa < 1) return cudaErrorInvalidValue;
  if (pl.grid_x != (L.Wqa + pl.cols - 1) / pl.cols ||
      pl.grid_y != (L.Hq8 + pl.rows - 1) / pl.rows)
    return cudaErrorInvalidValue;
  const long long lr = 2LL * (pl.rows + 2 * pl.halo), lc = 2LL * (pl.cols + 2 * pl.halo);
  const long long coarse =
      post ? (pl.rows + 2LL * pl.halo + 1) * (pl.cols + 2 * pl.halo + 1) : 0;
  const long long bytes = 4 * (2 * lr * lc + 2 * (lr + lc) + coarse);
  if (pl.smem_bytes != bytes || bytes > tile::kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The separable pre body on tile T from shared memory buf: n_pairs pairs
// from src (half-sweeps 1..), the result into dst (own cells), then rc(idx,
// v) with the residual's full weighting (cfd_tpu/kernels/quad.py:678-687)
// at each own coarse cell idx of the (Hq8, Wqa) level-1 array: 0.25 * the four
// residuals of its children on the coarse interior (the global coarse row
// Jc), else 0. Every thread of the block calls it.
template <bool kBlock, class Rc>
__device__ inline void sep_pre_tile(const Tile& T, const float* src, const float* b0, float* dst,
                                    const cfd::Level0& L, int n_pairs, float* buf, Rc rc) {
  float* p = buf;
  float* b = p + T.LR * T.LC;
  load_tile(src, b0, T, L.Hq8, L.Wqa, p, b);
  const TileW W = load_tile_weights<kBlock>(L, T, b + T.LR * T.LC);
  __syncthreads();
  sep_pairs<kBlock>(p, b, W, T, L, n_pairs, 0);
  store_tile(p, T, L.Hq8, L.Wqa, dst);
  each_cell(T.R0, min(T.R0 + T.rows, L.Hq8), T.C0, min(T.C0 + T.cols, L.Wqa),
            [&](int Jl, int Ic) {
              const int Jc = Jl + (kBlock ? T.row0 : 0);
              float v = 0.f;
              if (Jc >= 1 && Jc <= L.ny / 2 && Ic >= 1 && Ic <= L.nx / 2) {
                const int lj = 2 * Jc - T.oj, li = 2 * Ic - T.oi;
                v = 0.25f * (sep_residual<kBlock>(p, b, W, T, lj, li, L) +
                             sep_residual<kBlock>(p, b, W, T, lj, li - 1, L) +
                             sep_residual<kBlock>(p, b, W, T, lj - 1, li, L) +
                             sep_residual<kBlock>(p, b, W, T, lj - 1, li - 1, L));
              }
              rc(static_cast<long long>(Jl) * L.Wqa + Ic, v);
            });
  __syncthreads();
}

// The separable post body on tile T from shared memory buf: the
// prolong-add of the level-1 correction ec on the interior cells of the
// array (tile_prolong_corr), n_pairs pairs (half-sweeps 2..: a
// block's bands start one row further in, as the prolongation's row J + 1
// wraps), the result into dst (own cells); returns r folded with the max
// |b - A p| over the tile's own cells (of a block's own rows [halo, Hq8 -
// halo)). Every thread of the block calls it.
template <bool kBlock>
__device__ inline float sep_post_tile(const Tile& T, const float* src, const float* b0,
                                      const float* ec, float* dst, const cfd::Level0& L,
                                      int n_pairs, float* buf, float r) {
  float* p = buf;
  float* b = p + T.LR * T.LC;
  load_tile(src, b0, T, L.Hq8, L.Wqa, p, b);
  const TileW W = load_tile_weights<kBlock>(L, T, b + T.LR * T.LC);
  const CoarseTile E = load_coarse_tile<kBlock>(ec, T, L.Hq8, L.Wqa, buf + sep_tile_floats(T));
  __syncthreads();
  update2(p, T.LC, 0, T.LR, 0, T.LC, -1, [&](int lj, int li) {
    const int j = T.oj + lj, i = T.oi + li;
    if (!cfd::interior(j, i, L)) return Upd{false, 0.f};
    if constexpr (kBlock) {
      const int J = (j >> 1) - T.row0;  // the array's plane row
      if (J < 0 || J >= L.Hq8) return Upd{false, 0.f};
    }
    return Upd{true, p[lj * T.LC + li] + tile_prolong_corr(E, j, i, L.ny, L.nx)};
  });
  __syncthreads();
  sep_pairs<kBlock>(p, b, W, T, L, n_pairs, 1);
  store_tile(p, T, L.Hq8, L.Wqa, dst);
  each_cell(2 * T.h, 2 * (T.h + T.rows), 2 * T.h, 2 * (T.h + T.cols), [&](int lj, int li) {
    const int J = ((T.oj + lj) >> 1) - (kBlock ? T.row0 : 0);
    const bool own = kBlock ? J >= L.halo && J < L.Hq8 - L.halo : J < L.Hq8;
    if (own && ((T.oi + li) >> 1) < L.Wqa) {
      r = cfd::bits_max(r, fabsf(sep_residual<kBlock>(p, b, W, T, lj, li, L)));
    }
  });
  __syncthreads();
  return r;
}

// ------------------------------------- the masked finest level (step_level0.cuh)

// the value at (j, i) after ghost stage ``lo`` of src: its output in the
// band, its input outside
template <bool kBlock, class A>
__device__ __forceinline__ float t_banded_ghost(const A& src, int j, int i, int lo,
                                                const cfd::StepL0& L) {
  if (cfd::step_in_band<kBlock>(j, lo, L)) return cfd::step_ghost(src, j, i, L);
  return src(j, i);
}

// ghost stage ``lo`` then the red half-sweep ``lo + 1`` at (j, i): a red
// fluid cell's Gauss-Seidel update (step_gs) from the ghosted src, every
// other cell its ghosted value. Red = (i + j) even.
template <bool kBlock, class A>
__device__ __forceinline__ float t_ghost_red(const A& src, const A& b, int j, int i,
                                             const cfd::StepL0& L, int lo) {
  const bool red = ((j + i) & 1) == 0;
  if (!(red && cfd::step_fluid(j, i, L) && cfd::step_in_band<kBlock>(j, lo + 1, L)))
    return t_banded_ghost<kBlock>(src, j, i, lo, L);
  const float E = t_banded_ghost<kBlock>(src, j, i + 1, lo, L);
  const float Wv = t_banded_ghost<kBlock>(src, j, i - 1, lo, L);
  const float N = t_banded_ghost<kBlock>(src, j + 1, i, lo, L);
  const float S = t_banded_ghost<kBlock>(src, j - 1, i, lo, L);
  return cfd::step_gs(src(j, i), E, Wv, N, S, b(j, i), L);
}

// the exact residual at (j, i): ghost stage ``lo`` re-applied to p, then b
// - lap on fluid cells, 0 elsewhere and outside a block
// (step_quad.py:339-351)
template <bool kBlock, class A>
__device__ __forceinline__ float t_step_residual(const A& p, const A& b, int j, int i,
                                                 const cfd::StepL0& L, int lo) {
  if (!cfd::step_fluid(j, i, L)) return 0.f;
  if constexpr (kBlock) {
    const int jl = j - 2 * L.row0;
    if (jl < 0 || jl >= 2 * L.Hq8) return 0.f;
  }
  const float pc = t_banded_ghost<kBlock>(p, j, i, lo, L);
  const float E = t_banded_ghost<kBlock>(p, j, i + 1, lo, L);
  const float Wv = t_banded_ghost<kBlock>(p, j, i - 1, lo, L);
  const float N = t_banded_ghost<kBlock>(p, j + 1, i, lo, L);
  const float S = t_banded_ghost<kBlock>(p, j - 1, i, lo, L);
  return cfd::step_residual(pc, E, Wv, N, S, b(j, i), L);
}

// out = stage s of in on the cells s + 1 from the buffer's edge
template <class F>
__device__ inline void tile_stage(float* out, const Tile& T, int s, F f) {
  update2(out, T.LC, s + 1, T.LR - s - 1, s + 1, T.LC - s - 1, -1,
          [&](int lj, int li) { return Upd{true, f(T.oj + lj, T.oi + li)}; });
  __syncthreads();
}

// n_pairs exact masked pairs and the trailing ghost stage on the tile, the
// ledger's stage k (from shift + 1) on the band k; *a holds the iterate
// before and after, *o is the second buffer. Returns the ledger count of
// the trailing ghost stage (the residual's ghost stage is the next one).
template <bool kBlock>
__device__ inline int step_pairs(float** a, float** o, const float* b, const Tile& T,
                                 const cfd::StepL0& L, int n_pairs, int shift) {
  const TileView bv{b, T.oj, T.oi, T.LC};
  int s = 0, k = shift;
  for (int pair = 0; pair < n_pairs; ++pair) {
    const TileView av{*a, T.oj, T.oi, T.LC};
    tile_stage(*o, T, s++,
               [&](int j, int i) { return t_ghost_red<kBlock>(av, bv, j, i, L, k + 1); });
    float* t = *a;
    *a = *o;
    *o = t;
    float* p = *a;
    const TileView pv{p, T.oj, T.oi, T.LC};
    update2(p, T.LC, s + 1, T.LR - s - 1, s + 1, T.LC - s - 1, 1, [&](int lj, int li) {
      const int j = T.oj + lj, i = T.oi + li;
      if (!(cfd::step_fluid(j, i, L) && cfd::step_in_band<kBlock>(j, k + 3, L)))
        return Upd{false, 0.f};
      return Upd{true, cfd::step_gs(p[lj * T.LC + li], pv(j, i + 1), pv(j, i - 1),
                                    pv(j + 1, i), pv(j - 1, i), bv(j, i), L)};
    });
    ++s;
    k += 3;
    __syncthreads();
  }
  const TileView av{*a, T.oj, T.oi, T.LC};
  tile_stage(*o, T, s, [&](int j, int i) { return t_banded_ghost<kBlock>(av, j, i, k + 1, L); });
  float* t = *a;
  *a = *o;
  *o = t;
  return k + 1;
}

// The floats of the three logical buffers the masked bodies stage (the
// iterate, its second buffer, the source); the post body's coarse tile
// follows them
__device__ __forceinline__ int step_tile_floats(const Tile& T) { return 3 * T.LR * T.LC; }

// The pre body on tile T from shared memory buf: n_pairs exact pairs and
// the trailing ghost stage from src (ledger stages 1..), the result into
// dst (own cells), then rc(idx, v) with the exact residual's full
// weighting at each own coarse cell idx of the (Hq8, Wqa) level-1 array:
// 0.25 * the four residuals of its children on the coarse interior (the
// global coarse row Jc), else 0. Every thread of the block calls it.
template <bool kBlock, class Rc>
__device__ inline void step_pre_tile(const Tile& T, const float* src, const float* b0, float* dst,
                                     const cfd::StepL0& L, int n_pairs, float* buf, Rc rc) {
  float* a = buf;
  float* o = a + T.LR * T.LC;
  float* b = o + T.LR * T.LC;
  load_tile(src, b0, T, L.Hq8, L.Wqa, a, b);
  __syncthreads();
  const int lo = step_pairs<kBlock>(&a, &o, b, T, L, n_pairs, 0) + 1;
  store_tile(a, T, L.Hq8, L.Wqa, dst);
  const TileView av{a, T.oj, T.oi, T.LC}, bv{b, T.oj, T.oi, T.LC};
  each_cell(T.R0, min(T.R0 + T.rows, L.Hq8), T.C0, min(T.C0 + T.cols, L.Wqa),
            [&](int Jl, int Ic) {
              const int Jc = Jl + (kBlock ? T.row0 : 0);
              float v = 0.f;
              if (Jc >= 1 && Jc <= L.ny / 2 && Ic >= 1 && Ic <= L.nx / 2) {
                const int j = 2 * Jc, i = 2 * Ic;
                v = 0.25f * (t_step_residual<kBlock>(av, bv, j, i, L, lo) +
                             t_step_residual<kBlock>(av, bv, j, i - 1, L, lo) +
                             t_step_residual<kBlock>(av, bv, j - 1, i, L, lo) +
                             t_step_residual<kBlock>(av, bv, j - 1, i - 1, L, lo));
              }
              rc(static_cast<long long>(Jl) * L.Wqa + Ic, v);
            });
  __syncthreads();
}

// The post body on tile T from shared memory buf: the prolong-add of the
// solid-filled level-1 correction ec on the fluid cells of the array
// (step_quad.py:470), n_pairs exact pairs and the trailing ghost
// stage (ledger stages 2..: the bands start one row further in), the
// result into dst (own cells); returns r folded with the max |exact
// residual| over the tile's own cells (of a block's own rows [halo, Hq8 -
// halo)). Every thread of the block calls it.
template <bool kBlock>
__device__ inline float step_post_tile(const Tile& T, const float* src, const float* b0,
                                       const float* ec, float* dst, const cfd::StepL0& L,
                                       int n_pairs, float* buf, float r) {
  float* a = buf;
  float* o = a + T.LR * T.LC;
  float* b = o + T.LR * T.LC;
  load_tile(src, b0, T, L.Hq8, L.Wqa, a, b);
  const CoarseTile E = load_coarse_tile<kBlock>(ec, T, L.Hq8, L.Wqa, buf + step_tile_floats(T));
  __syncthreads();
  update2(a, T.LC, 0, T.LR, 0, T.LC, -1, [&](int lj, int li) {
    const int j = T.oj + lj, i = T.oi + li;
    if (!cfd::step_fluid(j, i, L)) return Upd{false, 0.f};
    const int J = (j >> 1) - T.row0;  // the array's plane row
    if (kBlock && (J < 0 || J >= L.Hq8)) return Upd{false, 0.f};
    return Upd{true, a[lj * T.LC + li] + tile_prolong_corr(E, j, i, L.ny, L.nx)};
  });
  __syncthreads();
  const int lo = step_pairs<kBlock>(&a, &o, b, T, L, n_pairs, 1) + 1;
  store_tile(a, T, L.Hq8, L.Wqa, dst);
  const TileView av{a, T.oj, T.oi, T.LC}, bv{b, T.oj, T.oi, T.LC};
  each_cell(2 * T.h, 2 * (T.h + T.rows), 2 * T.h, 2 * (T.h + T.cols), [&](int lj, int li) {
    const int j = T.oj + lj, i = T.oi + li;
    const int J = (j >> 1) - (kBlock ? T.row0 : 0);
    const bool own = kBlock ? J >= L.halo && J < L.Hq8 - L.halo : J < L.Hq8;
    if (own && (i >> 1) < L.Wqa) {
      r = cfd::bits_max(r, fabsf(t_step_residual<kBlock>(av, bv, j, i, L, lo)));
    }
  });
  __syncthreads();
  return r;
}

}  // namespace ws
}  // namespace cfd
