// An aligned coarse multigrid level in shared-memory tiles: a tile's
// buffers (iterate, source, weights), their loads, the red/black
// half-sweep on a box that shrinks by one cell a stage, and the residual.
// Shared by the whole-solve (whole_solve.cuh: a grid level's tiles and
// the coarse tail's compact levels in one block, inside the cooperative
// grid that the whole-solve, the whole step and the fused tail launch)
// and the coarse smoother (rb_smoother.cu: one tile a block), so that the
// two run the same bodies.
//
// A tile is the level's own rows [R0, R0 + rows) x columns [C0, C0 +
// cols), loaded with a halo of H cells into (rows + 2H) x (cols + 2H)
// buffers; a position outside the array reads 0, as cfd::ld's. Stage s of
// a phase (from 0) updates the cells at least s + 1 from the buffer's edge
// from stage s - 1's values, so after s + 1 stages those cells hold
// exactly what a whole-array sweep computes there (a red/black update
// reads only its four neighbours). The smoother's storage may be
// bfloat16: its tile loads it into float32 buffers (load_level_tile) and
// rounds to the storage type only where it writes.
#pragma once

#include "aligned_level.cuh"
#include "level0_tile.cuh"

namespace cfd {
namespace ws {

// one tile of an aligned level: own rows [R0, R0 + rows) x columns [C0,
// C0 + cols), buffers of (rows + 2H) x (cols + 2H) from (oj, oi); the
// block's compact level (whole_solve.cuh) is the tile of the whole level's
// interior and ghost ring from (0, 0)
struct LTile {
  int R0, C0, rows, cols, H, oj, oi, LR, LC;
};

// tile t (row-major) of the tiles of rows x cols cells over w_ext columns
__device__ inline LTile make_ltile(int t, int rows, int cols, int w_ext, int H) {
  const int ncol = (w_ext + cols - 1) / cols;
  LTile T;
  T.R0 = (t / ncol) * rows;
  T.C0 = (t % ncol) * cols;
  T.rows = rows;
  T.cols = cols;
  T.H = H;
  T.oj = T.R0 - H;
  T.oi = T.C0 - H;
  T.LR = rows + 2 * H;
  T.LC = cols + 2 * H;
  return T;
}

// a level tile's shared-memory iterate, source and weights (four arrays of
// a masked level; a separable level's vectors by local column (e, w) and
// local row (n, s))
struct LBuf {
  float* p;
  float* b;
  float *we, *ww, *wn, *ws;
  int full, LC;
  __device__ __forceinline__ cfd::Weights w(int lj, int li) const {
    if (full) {
      const int k = lj * LC + li;
      return {we[k], ww[k], wn[k], ws[k]};
    }
    return {we[li], ww[li], wn[lj], ws[lj]};
  }
};

// the buffers of tile T of level L from shared-memory address base: the
// iterate, the source, then the weights
__device__ inline LBuf level_buf(const cfd::Level& L, const LTile& T, float* base) {
  const int n = T.LR * T.LC;
  float* w = base + 2 * n;
  if (L.full) return LBuf{base, base + n, w, w + n, w + 2 * n, w + 3 * n, 1, T.LC};
  return LBuf{base, base + n, w, w + T.LC, w + 2 * T.LC, w + 2 * T.LC + T.LR, 0, T.LC};
}

// cfd::active at local (lj, li) from the tile's weights
__device__ __forceinline__ bool l_active(const LBuf& B, const LTile& T, int lj, int li,
                                         const cfd::Level& L) {
  if (!cfd::interior(T.oj + lj, T.oi + li, L)) return false;
  if (!B.full) return true;
  const cfd::Weights w = B.w(lj, li);
  return L.idx2 * (w.e + w.w) + L.idy2 * (w.n + w.s) > 0.f;
}

// dst = the tile's region of level array src (0 outside it)
__device__ inline void load_level(const float* src, float* dst, const LTile& T,
                                  const cfd::Level& L) {
  copy_rect(dst, T.LC, T.LR, T.LC, [&](int lj, int li) {
    const int j = T.oj + lj, i = T.oi + li;
    return (j >= 0 && j < L.H8 && i >= 0 && i < L.W) ? src[j * L.W + i] : 0.f;
  });
}

// the level's weights on the tile's region
__device__ inline void load_level_weights(const LBuf& B, const LTile& T, const cfd::Level& L) {
  if (B.full) {
    const float* g[4] = {L.wE, L.wW, L.wN, L.wS};
    float* d[4] = {B.we, B.ww, B.wn, B.ws};
    for (int a = 0; a < 4; ++a) load_level(g[a], d[a], T, L);
    return;
  }
  for (int k = static_cast<int>(threadIdx.x); k < T.LC; k += static_cast<int>(blockDim.x)) {
    const int i = T.oi + k;
    const bool in = i >= 0 && i < L.W;
    B.we[k] = in ? L.wE[i] : 0.f;
    B.ww[k] = in ? L.wW[i] : 0.f;
  }
  for (int k = static_cast<int>(threadIdx.x); k < T.LR; k += static_cast<int>(blockDim.x)) {
    const int j = T.oj + k;
    const bool in = j >= 0 && j < L.H8;
    B.wn[k] = in ? L.wN[j] : 0.f;
    B.ws[k] = in ? L.wS[j] : 0.f;
  }
}

// The tile's iterate and source from level arrays p and b (storage TS) in
// float32 and its weights (0 outside the array): on a masked level the
// four weight arrays in the same pass, each lane's loads of two columns
// (six arrays) issued before their stores, so that one round trip to
// device memory fills the buffers; a separable level's vectors as
// load_level_weights
template <typename TS>
__device__ inline void load_level_tile(const TS* p, const TS* b, const LBuf& B, const LTile& T,
                                       const cfd::Level& L) {
  const float* w[4] = {L.wE, L.wW, L.wN, L.wS};
  float* d[4] = {B.we, B.ww, B.wn, B.ws};
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int nw = static_cast<int>(blockDim.x) >> 5;
  for (int lj = static_cast<int>(threadIdx.x) >> 5; lj < T.LR; lj += nw) {
    const int j = T.oj + lj;
    const bool row_in = j >= 0 && j < L.H8;
    for (int i0 = lane; i0 < T.LC; i0 += 64) {
      float v[2][6];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = T.oi + i0 + 32 * u;
        const bool in = row_in && i0 + 32 * u < T.LC && i >= 0 && i < L.W;
        const int k = in ? j * L.W + i : 0;
        v[u][0] = in ? cfd::to_f32(p[k]) : 0.f;
        v[u][1] = in ? cfd::to_f32(b[k]) : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) v[u][2 + a] = in && B.full ? w[a][k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int li = i0 + 32 * u;
        if (li >= T.LC) continue;
        const int k = lj * T.LC + li;
        B.p[k] = v[u][0];
        B.b[k] = v[u][1];
        if (B.full) {
#pragma unroll
          for (int a = 0; a < 4; ++a) d[a][k] = v[u][2 + a];
        }
      }
    }
  }
  if (!B.full) load_level_weights(B, T, L);
}

// a half-sweep of `colour` (red 0) of a level tile in place (rb_update's
// arithmetic) on the cells shrink + 1 from the buffer's edge
__device__ inline void l_half_sweep(const LBuf& B, const LTile& T, const cfd::Level& L,
                                    int colour, int shrink) {
  const int local = (colour + T.oj + T.oi) & 1;  // the local parity of the global colour
  update2(B.p, T.LC, shrink + 1, T.LR - shrink - 1, shrink + 1, T.LC - shrink - 1, local,
          [&](int lj, int li) {
    if (!l_active(B, T, lj, li, L)) return Upd{false, 0.f};
    const float* c = B.p + lj * T.LC + li;
    const cfd::Weights w = B.w(lj, li);
    return Upd{true, cfd::gs_update(c[0], c[1], c[-1], c[T.LC], c[-T.LC], B.b[lj * T.LC + li],
                                    w.e, w.w, w.n, w.s, L.idx2, L.idy2, L.omega)};
  });
  __syncthreads();
}

// the signed residual b - A p at local (lj, li) of a level tile, 0 off the
// active cells (rb_residual's arithmetic)
__device__ __forceinline__ float l_residual(const LBuf& B, const LTile& T, int lj, int li,
                                            const cfd::Level& L) {
  if (!l_active(B, T, lj, li, L)) return 0.f;
  const float* c = B.p + lj * T.LC + li;
  const cfd::Weights w = B.w(lj, li);
  const float ap = cfd::apply_a(c[0], c[1], c[-1], c[T.LC], c[-T.LC], w.e, w.w, w.n, w.s,
                                L.idx2, L.idy2);
  return B.b[lj * T.LC + li] - ap;
}

}  // namespace ws
}  // namespace cfd
