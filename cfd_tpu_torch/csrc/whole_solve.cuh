// The whole tolerance-driven multigrid solve as device code for one
// cooperative grid: the parameters and the launch plan, the finest level's
// shared-memory tiles, the grid-resident coarse levels, the coarse tail in
// one block, and the V-cycle loop with its stop rule. Run by the
// whole-solve kernel (whole_solve.cu) after its warm-start copy, and by the
// whole-step kernel (whole_step.cu) after the carry stages; the fused
// coarse tail (mg_tail.cu) runs the coarse V-cycle alone. whole_solve.cu
// describes the design.
#pragma once

#include <cooperative_groups.h>

#include "aligned_level.cuh"
#include "level0_tile.cuh"
#include "level_tile.cuh"
#include "quad_level0.cuh"
#include "step_level0.cuh"

namespace cfd {
namespace ws {

namespace cg = cooperative_groups;

constexpr int kMaxLevels = 16;
// the threads of a block of these kernels (their launch bounds; a multiple
// of kSumChunk)
constexpr int kBlockThreads = 512;
// the width of the fixed-order sums' chunks (the pin's, corr_opt's and the
// carries' source sums): cfd::kThreads, whatever the block size
constexpr int kSumChunk = cfd::kThreads;
// the reduction scratch at the start of the dynamic shared memory (floats)
constexpr int kRedFloats = kBlockThreads;
// the shared memory a block may use on the H100 (bytes)
constexpr int kSmemMax = 232448;

// The launch plan, computed on the host (kernels/plan.py plan_for): coarse
// levels block_from..n_coarse run in ONE block from its shared memory,
// levels 1..block_from-1 on the whole grid in tiles of level_rows[k - 1] x
// level_cols[k - 1] cells; the finest level runs in tiles of tile_rows x
// tile_cols plane cells (all four planes) with a halo of halo_pre /
// halo_post plane rows and columns.
struct Plan {
  int block_from;
  int tile_rows, tile_cols;
  int halo_pre, halo_post;
  int smem_bytes;  // dynamic shared memory of a block
  int blocks, threads;
  int level_rows[kMaxLevels], level_cols[kMaxLevels];
};

struct Params {
  cfd::Level0 L0;              // the finest level, quad layout (separable)
  cfd::StepL0 S0;              // the finest level, quad layout (masked)
  int n_coarse;                // aligned levels 1..n_coarse (>= 2)
  cfd::Level lv[kMaxLevels];   // lv[k - 1] is level k
  float* p_lv[kMaxLevels];     // iterate of level k
  float* b_lv[kMaxLevels];     // source of level k
  float* q_lv[kMaxLevels];     // a grid level's pre-smoothed iterate
  const float* p_in;           // warm start (quad)
  const float* b0;             // source (quad)
  float* p0;                   // the solution (quad)
  float* q0;                   // the second finest iterate (quad): the tiles read one, write the other
  float* filled;               // masked: a solid-filled correction (level-1 size)
  const float* max_b;          // null: max|b| is computed here
  float* ctl;                  // [0] max|b|, [1] [2] residual slots, [3] the pin's sum
                               // or corr_opt's alpha; zeroed before launch
  int* stats;                  // (cycles, the bits of res)
  const float* pinv;           // (n, n), n = ny * nx of the coarsest level
  int pre, post, max_cycles;
  float tol_factor, abs_tol, stall;
  int pin_mean;                // separable only: shift p to zero mean each cycle
  float* partials;             // pin_mean: ceil(4 * Hq8 * Wqa / kSumChunk) floats of scratch;
                               // corr_opt: 2 * ceil(H8 * W of level 1 / kSumChunk)
  float n_int;                 // pin_mean: the number of interior cells
  int store_bf16;              // round the coarse sources and pre-smoothed iterates
                               // to bfloat16 where the reference stores them
  int corr_opt;                // masked only: line-search the level-1 correction
  float* rc32;                 // corr_opt with store_bf16: the unrounded level-1 source
  Plan plan;
};

// x rounded to the nearest bfloat16 (ties to even, as torch's .to(bfloat16))
// and back to float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the block's dynamic shared memory: kRedFloats of reduction scratch, then
// the phase's arrays
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float4 ws_dyn_smem[];
  return reinterpret_cast<float*>(ws_dyn_smem);
}

struct Sweep {
  long long first, step;
  template <class F>
  __device__ __forceinline__ void each(long long n, F f) const {
    for (long long k = first; k < n; k += step) f(k);
  }
  // the same over n < 2^31 with 32-bit indices (an aligned coarse level)
  template <class F>
  __device__ __forceinline__ void each32(int n, F f) const {
    for (int k = static_cast<int>(first); k < n; k += static_cast<int>(step)) f(k);
  }
};

// ---------------------------------------------------------------- reductions

// Block-wide max of v >= 0 into *out (an atomicMax on the int bits; the
// order does not matter). Every thread of the block calls it.
__device__ inline void block_max_into(float v, float* out) {
  int* s = reinterpret_cast<int*>(dyn_smem());
  const int t = static_cast<int>(threadIdx.x);
  s[t] = __float_as_int(v);
  __syncthreads();
  for (int stride = static_cast<int>(blockDim.x) / 2; stride > 0; stride >>= 1) {
    if (t < stride) s[t] = max(s[t], s[t + stride]);
    __syncthreads();
  }
  if (t == 0) atomicMax(reinterpret_cast<int*>(out), s[0]);
  __syncthreads();
}

// Fixed-order sums of val(k), k in [0, n), in kSumChunk-wide chunks: chunk
// c's sum into out[c], by the pairwise tree of cfd::block_sum_to (s[t] +=
// s[t + stride], stride = kSumChunk/2 ... 1), so the sums do not depend on
// the block size. Each kSumChunk-thread group of a block sums one chunk at
// a time; val is called once for each k. Every thread of the grid calls it.
template <class F>
__device__ inline void chunk_sums(long long n, float* out, F val) {
  const int groups = static_cast<int>(blockDim.x) / kSumChunk;
  const int g = static_cast<int>(threadIdx.x) / kSumChunk;
  const int t = static_cast<int>(threadIdx.x) % kSumChunk;
  float* s = dyn_smem() + g * kSumChunk;
  const long long chunks = (n + kSumChunk - 1) / kSumChunk;
  const long long rounds = (chunks + groups - 1) / groups;
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
    const long long c = r * groups + g;
    const long long k = c * kSumChunk + t;
    s[t] = k < n ? val(k) : 0.f;
    __syncthreads();
    for (int stride = kSumChunk / 2; stride > 0; stride >>= 1) {
      if (t < stride) s[t] = s[t] + s[t + stride];
      __syncthreads();
    }
    if (t == 0 && c < chunks) out[c] = s[0];
    __syncthreads();
  }
}

// ------------------------------------------------------- block-level loops

// (each_cell, update2, copy_rect: level0_tile.cuh)

// a[0:n] = 0 by the block
__device__ inline void s_zero(float* a, int n) {
  for (int k = static_cast<int>(threadIdx.x); k < n; k += static_cast<int>(blockDim.x)) a[k] = 0.f;
}

// -------------------------------------------------- grid-resident coarse levels
//
// A large grid level runs as grid-stride phases, one barrier after each
// (the half-sweeps, the restriction, the prolongation); a smaller one
// (the plan's level_rows > 0) runs in tiles, one phase on the way down and
// one on the way up, each a tile of rows x cols cells (both even) with a
// halo of H:
// down, from a zero iterate, the 2 pre half-sweeps and the residual's full
// weighting into the next level (H = 2 pre + 2: the restriction's lower
// children read one row below, their residuals one more); up, the
// prolong-add of the coarser level's correction and the 2 post
// half-sweeps (H = 2 post). The pre-smoothed iterate goes to q_lv[k], the
// level's final correction to p_lv[k], where every phase after reads it.
// Each stage updates the cells s + 1 from the buffer's edge, as the finest
// level's tiles.

// one red (colour 0) or black half-sweep of an aligned level in place,
// over the cells of the colour; from_zero: the iterate is all zeros (the
// first half-sweep of a descent), so its reads are zeros and every other
// cell becomes 0
__device__ inline void level_half_sweep(const Sweep& s, const cfd::Level& L, float* p,
                                        const float* b, int colour, bool from_zero) {
  if (from_zero) {
    s.each32(L.H8 * L.W, [&](int idx) {
      const int j = idx / L.W, i = idx - j * L.W;
      if (((j + i) & 1) == colour && cfd::active(j, i, L)) {
        const cfd::Weights w = cfd::weights(j, i, L);
        p[idx] = cfd::gs_update(0.f, 0.f, 0.f, 0.f, 0.f, b[idx], w.e, w.w, w.n, w.s, L.idx2,
                                L.idy2, L.omega);
      } else {
        p[idx] = 0.f;
      }
    });
    return;
  }
  const int hw = (L.W + 1) / 2;
  s.each32(L.H8 * hw, [&](int t) {
    const int j = t / hw;
    const int i = 2 * (t - j * hw) + ((j + colour) & 1);
    if (i < L.W && cfd::active(j, i, L)) p[j * L.W + i] = cfd::rb_update(p, b, j, i, L);
  });
}

// bc = full weighting of the residual b - A p of level L into level Lc, in
// the order of mg_tail._restrict: ((r(2J-1,2I-1) + r(2J-1,2I)) + r(2J,2I-1)
// + r(2J,2I)) * 0.25 on the coarse interior, 0 elsewhere; rounded to
// bfloat16 with bf16 (the stored b[k + 1] of run_tail_vcycle(store_dtype))
__device__ inline void level_restrict(const Sweep& s, const cfd::Level& L, const float* p,
                                      const float* b, const cfd::Level& Lc, float* bc,
                                      bool bf16) {
  s.each32(Lc.H8 * Lc.W, [&](int idx) {
    const int J = idx / Lc.W, I = idx - J * Lc.W;
    float out = 0.f;
    if (cfd::interior(J, I, Lc)) {
      const int j = 2 * J, i = 2 * I;
      out = (((cfd::rb_residual(p, b, j - 1, i - 1, L) + cfd::rb_residual(p, b, j - 1, i, L)) +
              cfd::rb_residual(p, b, j, i - 1, L)) +
             cfd::rb_residual(p, b, j, i, L)) *
            0.25f;
    }
    bc[idx] = bf16 ? round_bf16(out) : out;
  });
}

// The bilinear 9-3-3-1 prolongation of the coarse correction E(a, c)
// (level Lc, interior cell (a + 1, c + 1), edge-replicated ghosts) at
// active cell (j, i) of level L, in the order of mg_tail._prolong:
// 0.0625 * (((9c + 3h) + 3v) + d)
template <class Ec>
__device__ __forceinline__ float prolong_value(const Ec& E, const cfd::Level& Lc, int j, int i) {
  const int jc = (j - 1) >> 1, ic = (i - 1) >> 1;
  const int dj = ((j - 1) & 1) ? 1 : -1, di = ((i - 1) & 1) ? 1 : -1;
  auto Ecl = [&](int a, int c) {
    a = min(max(a, 0), Lc.ny - 1);
    c = min(max(c, 0), Lc.nx - 1);
    return E(a, c);
  };
  return 0.0625f * (((9.0f * Ecl(jc, ic) + 3.0f * Ecl(jc, ic + di)) + 3.0f * Ecl(jc + dj, ic)) +
                    Ecl(jc + dj, ic + di));
}

// p += the prolongation of the coarse correction e (level Lc) on the active
// cells of level L; a masked Lc's correction is solid-filled first, each
// filled value computed where the prolongation reads it (the same
// arithmetic as a fill phase, without its barrier). With bf16 the
// pre-smoothed p is rounded to bfloat16 first (the stored ps[k]): a cell
// reads only its own p here, so rounding on read is race-free.
__device__ inline void level_prolong_add(const Sweep& s, const cfd::Level& Lc, const float* e,
                                         const cfd::Level& L, float* p, bool bf16) {
  auto E = [&](int a, int c) {
    return Lc.full ? cfd::solid_fill_value(e, a + 1, c + 1, Lc) : e[(a + 1) * Lc.W + (c + 1)];
  };
  s.each32(L.H8 * L.W, [&](int idx) {
    const int j = idx / L.W, i = idx - j * L.W;
    if (!cfd::active(j, i, L)) return;
    const float v = prolong_value(E, Lc, j, i);
    p[idx] = (bf16 ? round_bf16(p[idx]) : p[idx]) + v;
  });
}

// out = the solid fill of a masked level's correction e (the whole array)
__device__ inline void level_solid_fill(const Sweep& s, const cfd::Level& L, const float* e,
                                        float* out) {
  s.each32(L.H8 * L.W, [&](int idx) {
    const int j = idx / L.W, i = idx - j * L.W;
    out[idx] = cfd::solid_fill_value(e, j, i, L);
  });
}

// (a level tile, LTile, its buffers, LBuf, their loads, l_half_sweep and
// l_residual: level_tile.cuh, shared with the coarse smoother)

// Level k's way down on every tile: 2 pre half-sweeps from a zero iterate
// (the first reads zeros, every cell it does not update is 0), the
// pre-smoothed iterate into q_lv[k], and the residual's full weighting in
// mg_tail._restrict's order, ((r(2J-1,2I-1) + r(2J-1,2I)) + r(2J,2I-1) +
// r(2J,2I)) * 0.25 on the coarse interior and 0 elsewhere, into b_lv[k +
// 1] (rounded to bfloat16 with store_bf16). The tiles span max(H8, 2 H8 of
// level k + 1) x max(W, 2 W of level k + 1), so that every cell of both
// arrays is written.
__device__ inline void level_pre_tiles(const Params& P, int k) {
  const cfd::Level& L = P.lv[k - 1];
  const cfd::Level& Lc = P.lv[k];
  const bool bf16 = P.store_bf16 != 0;
  const int rows = P.plan.level_rows[k - 1], cols = P.plan.level_cols[k - 1];
  const int h_ext = max(L.H8, 2 * Lc.H8), w_ext = max(L.W, 2 * Lc.W);
  const int nt = ((h_ext + rows - 1) / rows) * ((w_ext + cols - 1) / cols);
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const LTile T = make_ltile(t, rows, cols, w_ext, 2 * P.pre + 2);
    const LBuf B = level_buf(L, T, dyn_smem() + kRedFloats);
    load_level(P.b_lv[k], B.b, T, L);
    load_level_weights(B, T, L);
    s_zero(B.p, T.LR * T.LC);
    __syncthreads();
    for (int s = 0; s < 2 * P.pre; ++s) l_half_sweep(B, T, L, s & 1, s);
    each_cell(T.R0, min(T.R0 + rows, L.H8), T.C0, min(T.C0 + cols, L.W), [&](int j, int i) {
      P.q_lv[k][j * L.W + i] = B.p[(j - T.oj) * T.LC + (i - T.oi)];
    });
    each_cell(T.R0 / 2, min((T.R0 + rows) / 2, Lc.H8), T.C0 / 2, min((T.C0 + cols) / 2, Lc.W),
              [&](int J, int I) {
                float out = 0.f;
                if (cfd::interior(J, I, Lc)) {
                  const int lj = 2 * J - T.oj, li = 2 * I - T.oi;
                  out = (((l_residual(B, T, lj - 1, li - 1, L) +
                           l_residual(B, T, lj - 1, li, L)) +
                          l_residual(B, T, lj, li - 1, L)) +
                         l_residual(B, T, lj, li, L)) *
                        0.25f;
                }
                P.b_lv[k + 1][J * Lc.W + I] = bf16 ? round_bf16(out) : out;
              });
    __syncthreads();
  }
}

// Level k's way up on every tile: the pre-smoothed q_lv[k] (rounded to
// bfloat16 first with store_bf16: the stored ps[k]) plus the 9-3-3-1
// prolongation of level k + 1's correction p_lv[k + 1] (solid-filled
// where the prolongation reads it when level k + 1 is masked) on the
// active cells, then 2 post half-sweeps; the result into p_lv[k].
__device__ inline void level_post_tiles(const Params& P, int k) {
  const cfd::Level& L = P.lv[k - 1];
  const cfd::Level& Lc = P.lv[k];
  const bool bf16 = P.store_bf16 != 0;
  const int rows = P.plan.level_rows[k - 1], cols = P.plan.level_cols[k - 1];
  const int nt = ((L.H8 + rows - 1) / rows) * ((L.W + cols - 1) / cols);
  const float* e = P.p_lv[k + 1];
  auto E = [&](int a, int c) {
    return Lc.full ? cfd::solid_fill_value(e, a + 1, c + 1, Lc) : e[(a + 1) * Lc.W + (c + 1)];
  };
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const LTile T = make_ltile(t, rows, cols, L.W, 2 * P.post);
    const LBuf B = level_buf(L, T, dyn_smem() + kRedFloats);
    load_level(P.q_lv[k], B.p, T, L);
    load_level(P.b_lv[k], B.b, T, L);
    load_level_weights(B, T, L);
    __syncthreads();
    update2(B.p, T.LC, 0, T.LR, 0, T.LC, -1, [&](int lj, int li) {
      if (!l_active(B, T, lj, li, L)) return Upd{false, 0.f};
      const float v = prolong_value(E, Lc, T.oj + lj, T.oi + li);
      const float pc = B.p[lj * T.LC + li];
      return Upd{true, (bf16 ? round_bf16(pc) : pc) + v};
    });
    __syncthreads();
    for (int s = 0; s < 2 * P.post; ++s) l_half_sweep(B, T, L, s & 1, s);
    each_cell(T.R0, min(T.R0 + rows, L.H8), T.C0, min(T.C0 + cols, L.W), [&](int j, int i) {
      P.p_lv[k][j * L.W + i] = B.p[(j - T.oj) * T.LC + (i - T.oi)];
    });
    __syncthreads();
  }
}

// ------------------------------------------------ the coarse tail in one block
//
// Levels block_from..n_coarse live in the block's shared memory, each as
// the level tile of its compact (ny + 2) x (nx + 2) rectangle (every cell a
// phase reads lies in it: the interior and the ghost ring; the aligned
// padding around it holds zeros in device memory): iterate, source and
// weights. After the levels, a row of n floats per warp for the coarsest
// solve's folds. The phases are those of the grid levels in the same order,
// through the same arithmetic, separated by __syncthreads().

__host__ __device__ inline long long compact_cells(const cfd::Level& L) {
  return static_cast<long long>(L.ny + 2) * (L.nx + 2);
}

// shared-memory floats of one level of the tail (level_buf's layout)
__host__ __device__ inline long long tail_level_floats(const cfd::Level& L) {
  const long long cc = compact_cells(L);
  return 2 * cc + (L.full ? 4 * cc : 2LL * (L.nx + 2) + 2LL * (L.ny + 2));
}

__device__ inline LTile compact_tile(const cfd::Level& L) {
  return LTile{0, 0, L.ny + 2, L.nx + 2, 0, 0, 0, L.ny + 2, L.nx + 2};
}

// the shared memory after levels from..k-1 of the tail (k = n_coarse + 1:
// the fold rows)
__device__ inline float* tail_base(const Params& P, int from, int k) {
  float* base = dyn_smem() + kRedFloats;
  for (int l = from; l < k; ++l) base += tail_level_floats(P.lv[l - 1]);
  return base;
}

__device__ inline LBuf tail_buf(const Params& P, int from, int k) {
  const cfd::Level& L = P.lv[k - 1];
  return level_buf(L, compact_tile(L), tail_base(P, from, k));
}

// The solid fill of a masked level's compact correction e at (j, i)
// (cfd::solid_fill_value's arithmetic)
__device__ __forceinline__ float l_fill_value(const LBuf& B, const LTile& T, const float* e,
                                              int j, int i, const cfd::Level& L) {
  const float ec = e[j * T.LC + i];
  if (!cfd::interior(j, i, L) || l_active(B, T, j, i, L)) return ec;
  auto nb = [&](int jj, int ii, float* f) {
    const bool a = l_active(B, T, jj, ii, L);  // the neighbours of an interior cell are in range
    *f = a ? 1.0f : 0.0f;
    return e[jj * T.LC + ii] * *f;
  };
  float fE, fW, fN, fS;
  const float vE = nb(j, i + 1, &fE), vW = nb(j, i - 1, &fW);
  const float vN = nb(j + 1, i, &fN), vS = nb(j - 1, i, &fS);
  const float den = ((fE + fW) + fN) + fS;
  if (!(den > 0.f)) return ec;
  const float num = ((vE + vW) + vN) + vS;
  return num / fmaxf(den, 1.0f);
}

// The rest of the V-cycle from level k0 in ONE block: b_lv[k0] and the
// levels' weights from device memory, the descent's pairs and
// restrictions, the coarsest pinv product, the ascent's fills,
// prolong-adds and post pairs; then level k0's correction into p_lv[k0]
// (the whole (H8, W) array, zeros outside the compact rectangle). Called
// by one block.
__device__ inline void block_tail(const Params& P, int k0) {
  const int nc = P.n_coarse;
  const bool bf16 = P.store_bf16 != 0;
  {
    const cfd::Level& L = P.lv[k0 - 1];
    load_level(P.b_lv[k0], tail_buf(P, k0, k0).b, compact_tile(L), L);
    for (int k = k0; k <= nc; ++k) {
      load_level_weights(tail_buf(P, k0, k), compact_tile(P.lv[k - 1]), P.lv[k - 1]);
    }
    __syncthreads();
  }
  // --- descent from zero iterates
  for (int k = k0; k < nc; ++k) {
    const cfd::Level& L = P.lv[k - 1];
    const LTile T = compact_tile(L);
    const LBuf S = tail_buf(P, k0, k);
    s_zero(S.p, T.LR * T.LC);
    __syncthreads();
    for (int h = 0; h < 2 * P.pre; ++h) l_half_sweep(S, T, L, h & 1, 0);
    const cfd::Level& Lc = P.lv[k];
    const LBuf C = tail_buf(P, k0, k + 1);
    const int pc = Lc.nx + 2;
    each_cell(0, Lc.ny + 2, 0, pc, [&](int J, int I) {
      float out = 0.f;
      if (cfd::interior(J, I, Lc)) {
        const int j = 2 * J, i = 2 * I;
        out = (((l_residual(S, T, j - 1, i - 1, L) + l_residual(S, T, j - 1, i, L)) +
                l_residual(S, T, j, i - 1, L)) +
               l_residual(S, T, j, i, L)) *
              0.25f;
      }
      C.b[J * pc + I] = bf16 ? round_bf16(out) : out;
    });
    __syncthreads();
  }
  // --- coarsest level: the dense pinv product, each row's products folded
  // in the fold_sum order by one warp in its shared-memory row
  {
    const cfd::Level& L = P.lv[nc - 1];
    const LBuf S = tail_buf(P, k0, nc);
    const int n = L.ny * L.nx, pitch = L.nx + 2;
    s_zero(S.p, static_cast<int>(compact_cells(L)));
    __syncthreads();
    const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
    float* x = tail_base(P, k0, nc + 1) + warp * n;
    for (int r = warp; r < n; r += static_cast<int>(blockDim.x) >> 5) {
      const float* row = P.pinv + static_cast<long long>(r) * n;
      for (int t0 = lane; t0 < n; t0 += 128) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = t0 + 32 * u < n ? row[t0 + 32 * u] : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u;
          if (t < n) x[t] = v[u] * S.b[(1 + t / L.nx) * pitch + 1 + t % L.nx];
        }
      }
      __syncwarp();
      const float e = cfd::fold_sum(x, n, lane, 32, [] { __syncwarp(); });
      if (lane == 0) S.p[(1 + r / L.nx) * pitch + 1 + r % L.nx] = e;
      __syncwarp();
    }
    __syncthreads();
  }
  // --- ascent: the solid fill of a masked correction (into the coarse
  // level's source, which its post pairs no longer need), prolongation,
  // post pairs
  for (int k = nc - 1; k >= k0; --k) {
    const cfd::Level& L = P.lv[k - 1];
    const cfd::Level& Lc = P.lv[k];
    const LTile T = compact_tile(L), Tc = compact_tile(Lc);
    const LBuf S = tail_buf(P, k0, k);
    const LBuf C = tail_buf(P, k0, k + 1);
    const float* e = C.p;
    if (Lc.full) {
      each_cell(0, Tc.LR, 0, Tc.LC, [&](int j, int i) {
        C.b[j * Tc.LC + i] = l_fill_value(C, Tc, C.p, j, i, Lc);
      });
      __syncthreads();
      e = C.b;
    }
    auto E = [&](int a, int c) { return e[(a + 1) * Tc.LC + (c + 1)]; };
    update2(S.p, T.LC, 1, L.ny + 1, 1, L.nx + 1, -1, [&](int j, int i) {
      if (!l_active(S, T, j, i, L)) return Upd{false, 0.f};
      const float v = prolong_value(E, Lc, j, i);
      const float pc = S.p[j * T.LC + i];
      return Upd{true, (bf16 ? round_bf16(pc) : pc) + v};
    });
    __syncthreads();
    for (int h = 0; h < 2 * P.post; ++h) l_half_sweep(S, T, L, h & 1, 0);
  }
  // --- hand-over to device memory
  const cfd::Level& L = P.lv[k0 - 1];
  const LBuf S = tail_buf(P, k0, k0);
  each_cell(0, L.H8, 0, L.W, [&](int j, int i) {
    const bool in = j < L.ny + 2 && i < L.nx + 2;
    P.p_lv[k0][j * L.W + i] = in ? S.p[j * (L.nx + 2) + i] : 0.f;
  });
}

// The V-cycle over the coarse levels 1..n_coarse from zero iterates: the
// source in P.b_lv[1], the correction left in P.p_lv[1] (the body of
// mg_tail.run_tail_vcycle). Levels 1..block_from-1 run on the grid, as
// grid-stride phases or in tiles (one barrier each way); block 0 runs the
// rest (block_tail) while the others wait at one barrier. With
// P.store_bf16 it rounds where run_tail_vcycle(store_dtype) stores; the
// caller rounds b_lv[1]. Every thread of the grid calls it.
__device__ inline void coarse_vcycle(const Sweep& s, cg::grid_group& grid, const Params& P) {
  const int k0 = P.plan.block_from;
  const bool bf16 = P.store_bf16 != 0;
  for (int k = 1; k < k0; ++k) {
    if (P.plan.level_rows[k - 1] > 0) {
      level_pre_tiles(P, k);
      grid.sync();
      continue;
    }
    const cfd::Level& L = P.lv[k - 1];
    for (int pair = 0; pair < P.pre; ++pair) {
      level_half_sweep(s, L, P.p_lv[k], P.b_lv[k], 0, pair == 0);
      grid.sync();
      level_half_sweep(s, L, P.p_lv[k], P.b_lv[k], 1, false);
      grid.sync();
    }
    level_restrict(s, L, P.p_lv[k], P.b_lv[k], P.lv[k], P.b_lv[k + 1], bf16);
    grid.sync();
  }
  if (blockIdx.x == 0) block_tail(P, k0);
  grid.sync();
  for (int k = k0 - 1; k >= 1; --k) {
    if (P.plan.level_rows[k - 1] > 0) {
      level_post_tiles(P, k);
      grid.sync();
      continue;
    }
    const cfd::Level& L = P.lv[k - 1];
    level_prolong_add(s, P.lv[k], P.p_lv[k + 1], L, P.p_lv[k], bf16);
    grid.sync();
    for (int pair = 0; pair < P.post; ++pair) {
      level_half_sweep(s, L, P.p_lv[k], P.b_lv[k], 0, false);
      grid.sync();
      level_half_sweep(s, L, P.p_lv[k], P.b_lv[k], 1, false);
      grid.sync();
    }
  }
}

// ------------------------------------------------- the finest level in tiles
//
// level0_tile.cuh: the tiles, their loads and stores, the level-1
// correction's tile, and the separable and masked levels' bodies on one
// tile. Each block walks the tiles t = blockIdx.x + k gridDim.x of the
// plan's tile_rows x tile_cols. A separable tile also stages its weight
// vectors (wE, wW by column, wN, wS by row).

// The level-1 source rc at idx: b_lv[1] (rounded to bfloat16 with
// store_bf16, the stored b[0] of run_tail_vcycle(store_dtype)), and its
// unrounded value in rc32 where corr_opt needs it
__device__ __forceinline__ void store_rc(const Params& P, long long idx, float v) {
  P.b_lv[1][idx] = P.store_bf16 ? round_bf16(v) : v;
  if (P.rc32 != nullptr) P.rc32[idx] = v;
}

// --- the separable finest level (level0_tile.cuh's bodies on a whole field)

// The pre phase of the separable finest level on every tile: P.pre pairs
// from src, the smoothed iterate into dst (own cells), the residual's full
// weighting into level 1 (sep_pre_tile) through store_rc.
__device__ inline void sep_pre_tiles(const Params& P, const float* src, float* dst) {
  const cfd::Level0& L = P.L0;
  const Plan& pl = P.plan;
  const int nt = tile_count(pl.tile_rows, pl.tile_cols, L.Hq8, L.Wqa);
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const Tile T = make_tile(pl.tile_rows, pl.tile_cols, L.Wqa, t, pl.halo_pre);
    sep_pre_tile<false>(T, src, P.b0, dst, L, P.pre, dyn_smem() + kRedFloats,
                        [&](long long idx, float v) { store_rc(P, idx, v); });
  }
}

// The post phase of the separable finest level on every tile: the
// prolong-add of the level-1 correction P.p_lv[1] to the pre-smoothed src,
// P.post pairs, the result into dst (own cells); returns the thread's max
// |b - A p| over its own cells.
__device__ inline float sep_post_tiles(const Params& P, const float* src, float* dst) {
  const cfd::Level0& L = P.L0;
  const Plan& pl = P.plan;
  float r = 0.f;
  const int nt = tile_count(pl.tile_rows, pl.tile_cols, L.Hq8, L.Wqa);
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const Tile T = make_tile(pl.tile_rows, pl.tile_cols, L.Wqa, t, pl.halo_post);
    r = sep_post_tile<false>(T, src, P.b0, P.p_lv[1], dst, L, P.post, dyn_smem() + kRedFloats,
                             r);
  }
  return r;
}

// --- the masked finest level (level0_tile.cuh's bodies on a whole field)

// The pre phase of the masked finest level on every tile: P.pre exact pairs
// and the trailing ghost stage from src, the result into dst (own cells),
// the exact residual's restriction into level 1 through store_rc.
__device__ inline void step_pre_tiles(const Params& P, const float* src, float* dst) {
  const cfd::StepL0& L = P.S0;
  const Plan& pl = P.plan;
  const int nt = tile_count(pl.tile_rows, pl.tile_cols, L.Hq8, L.Wqa);
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const Tile T = make_tile(pl.tile_rows, pl.tile_cols, L.Wqa, t, pl.halo_pre);
    step_pre_tile<false>(T, src, P.b0, dst, L, P.pre, dyn_smem() + kRedFloats,
                         [&](long long idx, float v) { store_rc(P, idx, v); });
  }
}

// The post phase of the masked finest level on every tile: the prolong-add
// of the solid-filled level-1 correction P.filled on the fluid cells,
// P.post exact pairs and the trailing ghost stage, the result into dst
// (own cells); returns the thread's max |exact residual| over its own
// cells.
__device__ inline float step_post_tiles(const Params& P, const float* src, float* dst) {
  const cfd::StepL0& L = P.S0;
  const Plan& pl = P.plan;
  float r = 0.f;
  const int nt = tile_count(pl.tile_rows, pl.tile_cols, L.Hq8, L.Wqa);
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const Tile T = make_tile(pl.tile_rows, pl.tile_cols, L.Wqa, t, pl.halo_post);
    r = step_post_tile<false>(T, src, P.b0, P.filled, dst, L, P.post, dyn_smem() + kRedFloats,
                              r);
  }
  return r;
}

// ------------------------------------------------------ the per-cycle phases

// p0 -= fixed_order_sum(p0) / n_int on the quad cells (see whole_solve.cu)
__device__ inline void pin_mean_phase(const Sweep& s, cg::grid_group& grid, const Params& P) {
  const cfd::Level0& L0 = P.L0;
  const long long n0 = 4LL * L0.Hq8 * L0.Wqa;
  const int chunks = static_cast<int>((n0 + kSumChunk - 1) / kSumChunk);
  chunk_sums(n0, P.partials, [&](long long k) { return P.p0[k]; });
  grid.sync();
  if (blockIdx.x == 0) {
    const float sum = cfd::fold_sum(P.partials, chunks, static_cast<int>(threadIdx.x),
                                    static_cast<int>(blockDim.x), [] { __syncthreads(); });
    if (threadIdx.x == 0) P.ctl[3] = sum;
  }
  grid.sync();
  const float mean = __ldcg(P.ctl + 3) / P.n_int;
  s.each(n0, [&](long long idx) {
    const cfd::QuadCell c = cfd::quad_cell(idx, L0.Hq8, L0.Wqa);
    if (c.j >= 1 && c.j <= L0.ny && c.i >= 1 && c.i <= L0.nx) P.p0[idx] = P.p0[idx] - mean;
  });
}

// corr_opt (masked; multigrid._corr_alpha, whole_solve.py:379-398): the
// level-1 correction e = P.p_lv[1] scaled by alpha = clip(<rc, A e> /
// <A e, A e>, 1, 1.5), 1 where the denominator is 0, with A the level-1
// weighted operator on its active cells and rc the unrounded source. The
// two products are summed in kSumChunk-wide chunks by the fixed tree into
// per-chunk partials (P.partials, then P.partials + chunks), one block
// folds them in fixed_order_sum's order and writes alpha into P.ctl[3],
// and every thread scales its cells: three barriers.
__device__ inline void corr_alpha_phase(const Sweep& s, cg::grid_group& grid,
                                        const Params& P) {
  const cfd::Level& L = P.lv[0];
  float* e = P.p_lv[1];
  const float* rc = P.rc32 != nullptr ? P.rc32 : P.b_lv[1];
  const long long n1 = static_cast<long long>(L.H8) * L.W;
  const int chunks = static_cast<int>((n1 + kSumChunk - 1) / kSumChunk);
  auto a_at = [&](long long k) {
    const int j = static_cast<int>(k / L.W);
    const int i = static_cast<int>(k - static_cast<long long>(j) * L.W);
    float a = 0.f;
    if (cfd::active(j, i, L)) {
      const cfd::Weights w = cfd::weights(j, i, L);
      a = cfd::apply_a(e[k], cfd::ld(e, j, i + 1, L), cfd::ld(e, j, i - 1, L),
                       cfd::ld(e, j + 1, i, L), cfd::ld(e, j - 1, i, L), w.e, w.w, w.n, w.s,
                       L.idx2, L.idy2);
    }
    return a;
  };
  chunk_sums(n1, P.partials, [&](long long k) { return rc[k] * a_at(k); });
  chunk_sums(n1, P.partials + chunks, [&](long long k) {
    const float a = a_at(k);
    return a * a;
  });
  grid.sync();
  if (blockIdx.x == 0) {
    const int t = static_cast<int>(threadIdx.x), nt = static_cast<int>(blockDim.x);
    const float num = cfd::fold_sum(P.partials, chunks, t, nt, [] { __syncthreads(); });
    const float den = cfd::fold_sum(P.partials + chunks, chunks, t, nt, [] { __syncthreads(); });
    if (t == 0) {
      const float raw = den > 0.f ? num / den : 1.0f;
      // torch.clamp: NaN stays NaN
      P.ctl[3] = raw != raw ? raw : fminf(fmaxf(raw, 1.0f), 1.5f);
    }
  }
  grid.sync();
  const float alpha = __ldcg(P.ctl + 3);
  s.each(n1, [&](long long idx) { e[idx] = alpha * e[idx]; });
  grid.sync();
}

// The finest iterate: P.p0 or P.q0, whichever holds it; each tile phase
// reads one and writes the other, two phases a cycle.
struct FineIterate {
  float* cur;
  float* other;
  __device__ inline void swap() {
    float* t = cur;
    cur = other;
    other = t;
  }
};

// Every V-cycle of one solve from the warm start in P.p0 (and the source
// in P.b0), with the tolerance max(tol_factor * max|b|, abs_tol), then the
// solution into P.p0 and (cycles, res) into P.stats. P.ctl[1] must be 0
// before the call's first barrier. Every thread of the grid calls it.
//
// Grid-wide barriers per V-cycle: one after the pre tiles, the grid
// levels' (coarse_vcycle), the masked level-1 phases (corr_opt's three,
// the solid fill's one), and the last one before the residual is read;
// the pin adds three (after the post tiles, after the partial sums, after
// the fold). The next cycle's residual slot is zeroed right after the
// first barrier of this cycle, which follows every read of it (the end of
// the previous cycle), and many barriers before the next cycle's atomics.
template <bool kMasked>
__device__ __forceinline__ void solve_cycles(const Sweep& s, cg::grid_group& grid,
                                             const Params& P, float max_b) {
  const bool lead = s.first == 0;
  const float tol = fmaxf(P.tol_factor * (max_b > 0.f ? max_b : 1.0f), P.abs_tol);

  float prev = 1e30f;
  float res = prev / 2.0f;
  int it = 0;
  FineIterate fine{P.p0, P.q0};
  while (res > tol && it < P.max_cycles && res < P.stall * prev) {
    // --- finest level: pre pairs, then the residual restricted into level 1
    if constexpr (kMasked) {
      step_pre_tiles(P, fine.cur, fine.other);
    } else {
      sep_pre_tiles(P, fine.cur, fine.other);
    }
    fine.swap();
    grid.sync();
    if (lead) P.ctl[1 + ((it + 1) & 1)] = 0.f;  // the next cycle's residual slot

    coarse_vcycle(s, grid, P);

    // --- finest level: prolongation, post pairs, the tolerance residual
    float r;
    if constexpr (kMasked) {
      if (P.corr_opt) corr_alpha_phase(s, grid, P);
      // the level-1 correction solid-filled, then added on the fluid cells
      level_solid_fill(s, P.lv[0], P.p_lv[1], P.filled);
      grid.sync();
      r = step_post_tiles(P, fine.cur, fine.other);
    } else {
      r = sep_post_tiles(P, fine.cur, fine.other);
    }
    fine.swap();
    block_max_into(r, P.ctl + 1 + (it & 1));
    if constexpr (!kMasked) {
      if (P.pin_mean) {
        grid.sync();  // every tile's p before the sums
        pin_mean_phase(s, grid, P);
      }
    }
    grid.sync();
    prev = res;
    res = __ldcg(P.ctl + 1 + (it & 1));
    ++it;
  }
  if (fine.cur != P.p0) {  // the solution into the output array
    s.each(4LL * P.L0.Hq8 * P.L0.Wqa, [&](long long idx) { P.p0[idx] = fine.cur[idx]; });
  }
  if (lead) {
    P.stats[0] = it;
    P.stats[1] = __float_as_int(res);
  }
}

// ------------------------------------------------------------- host side

// Shared-memory floats (after the reduction scratch) that the coarse tail
// from level block_from needs: its levels' arrays, then a row of n floats
// per warp for the coarsest solve (n = its cells)
inline long long tail_floats(const Params& P) {
  long long n = 0;
  for (int k = P.plan.block_from; k <= P.n_coarse; ++k) n += tail_level_floats(P.lv[k - 1]);
  const cfd::Level& Lc = P.lv[P.n_coarse - 1];
  return n + static_cast<long long>(kBlockThreads / 32) * Lc.ny * Lc.nx;
}

// ... and one finest-level tile with halo h: `arrays` logical buffers, the
// separable weight vectors and, for a post phase, the level-1 correction's
// tile
inline long long tile_floats(const Plan& pl, int h, int arrays, bool weights, bool post) {
  const long long lr = 2LL * (pl.tile_rows + 2 * h), lc = 2LL * (pl.tile_cols + 2 * h);
  return arrays * lr * lc + (weights ? 2 * (lr + lc) : 0) +
         (post ? static_cast<long long>(pl.tile_rows + 2 * h + 1) * (pl.tile_cols + 2 * h + 1)
               : 0);
}

// Whether P.plan holds for P (fine: the finest level runs in tiles;
// masked: the step's stages): block_from in [1, n_coarse], halos as deep
// as the stages, blocks of kBlockThreads threads, and shared memory for
// every phase within smem_bytes and kSmemMax. Returns a CUDA error code.
inline int check_plan(const Params& P, bool fine, bool masked) {
  const Plan& pl = P.plan;
  if (pl.block_from < 1 || pl.block_from > P.n_coarse || pl.blocks < 1 ||
      pl.threads != kBlockThreads || pl.smem_bytes > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long need = tail_floats(P);
  for (int k = 1; k < pl.block_from; ++k) {
    const int r = pl.level_rows[k - 1], c = pl.level_cols[k - 1];
    if (r == 0) continue;  // a level of grid-stride phases
    if (r < 2 || c < 2 || (r & 1) || (c & 1) || P.q_lv[k] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int h = 2 * P.pre + 2 > 2 * P.post ? 2 * P.pre + 2 : 2 * P.post;
    const long long lr = r + 2 * h, lc = c + 2 * h;
    const long long n = 2 * lr * lc + (P.lv[k - 1].full ? 4 * lr * lc : 2 * (lr + lc));
    need = need > n ? need : n;
  }
  if (fine) {
    if (pl.tile_rows < 1 || pl.tile_cols < 1 || pl.halo_pre < P.pre + (masked ? 2 : 1) ||
        pl.halo_post < P.post + 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int arrays = masked ? 3 : 2;
    const long long pre = tile_floats(pl, pl.halo_pre, arrays, !masked, false);
    const long long post = tile_floats(pl, pl.halo_post, arrays, !masked, true);
    need = need > pre ? need : pre;
    need = need > post ? need : post;
  }
  if ((kRedFloats + need) * 4 > pl.smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The plan from a host array of 8 + 2 kMaxLevels ints (block_from, tile_rows,
// tile_cols, halo_pre, halo_post, smem_bytes, blocks, threads, then
// kMaxLevels level_rows and kMaxLevels level_cols)
inline Plan plan_from(const int* a) {
  Plan pl{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], {}, {}};
  for (int k = 0; k < kMaxLevels; ++k) {
    pl.level_rows[k] = a[8 + k];
    pl.level_cols[k] = a[8 + kMaxLevels + k];
  }
  return pl;
}

// Ready kernel fn for cooperative launches on the current device and
// report its grid there: allow it all the dynamic shared memory a block may
// opt into, and count the blocks of kBlockThreads threads with smem_bytes
// of it each that can be resident at once: blocks (SMs x blocks per SM),
// per_sm, and regs, the kernel's registers per thread. The wrappers call
// this once before a module's first launch (kernels/plan.py ready_grid), so
// a launch makes no query; a launch the card cannot hold fails there.
// Returns a CUDA error code.
inline int coop_grid(const void* fn, int smem_bytes, int* blocks, int* per_sm, int* regs) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, optin = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kBlockThreads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *blocks = sms * *per_sm;
  return 0;
}

// The coarse levels 1..n_coarse of P from the host arrays idims (H8, W,
// ny, nx, full), fdims (idx2, idy2) and ptrs (wE, wW, wN, wS, p, b, q) per
// level (cfd_whole_solve describes them); returns a CUDA error code.
inline int coarse_params(Params* P, int n_coarse, const int* idims, const float* fdims,
                         void* const* ptrs, float omega) {
  if (n_coarse < 2 || n_coarse >= kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  P->n_coarse = n_coarse;
  for (int k = 1; k <= n_coarse; ++k) {
    const int* d = idims + 5 * (k - 1);
    const float* f = fdims + 2 * (k - 1);
    void* const* q = ptrs + 7 * (k - 1);
    P->lv[k - 1] = cfd::Level{d[0], d[1], d[2], d[3], f[0], f[1], omega,
                              static_cast<const float*>(q[0]), static_cast<const float*>(q[1]),
                              static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
                              d[4]};
    P->p_lv[k] = static_cast<float*>(q[4]);
    P->b_lv[k] = static_cast<float*>(q[5]);
    P->q_lv[k] = static_cast<float*>(q[6]);
  }
  return 0;
}

// Params of one solve from the C arguments of cfd_whole_solve (described
// there); returns a CUDA error code, 0 when the arguments are consistent.
inline int solve_params(Params* P, int masked, const float* p_in, const float* b0, float* p0,
                        float* q0, float* filled, const float* max_b, float* ctl, int* stats,
                        const float* pinv, const float* wE, const float* wW,
                        const float* wN, const float* wS, int Hq8, int Wqa, int ny, int nx,
                        int step_i, int inlet_j, float idx2, float idy2, float denom,
                        float one_minus_omega, int n_coarse, const int* idims,
                        const float* fdims, void* const* ptrs, float omega, int pre,
                        int post, int max_cycles, float tol_factor, float abs_tol,
                        float stall, int pin_mean, float* partials, float n_int,
                        int store_bf16, int corr_opt, float* rc32, const int* plan) {
  if (q0 == nullptr || (masked && filled == nullptr) || plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pin_mean && (masked || partials == nullptr || !(n_int > 0.f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (corr_opt && (!masked || partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((rc32 != nullptr) != (corr_opt && store_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *P = Params{};
  const int e = coarse_params(P, n_coarse, idims, fdims, ptrs, omega);
  if (e) return e;
  P->L0 = cfd::Level0{Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN, wS};
  P->S0 = cfd::StepL0{Hq8, Wqa, ny, nx, step_i, inlet_j, idx2, idy2, denom, omega,
                      one_minus_omega};
  P->p_in = p_in;
  P->b0 = b0;
  P->p0 = p0;
  P->q0 = q0;
  P->filled = filled;
  P->max_b = max_b;
  P->ctl = ctl;
  P->stats = stats;
  P->pinv = pinv;
  P->pre = pre;
  P->post = post;
  P->max_cycles = max_cycles;
  P->tol_factor = tol_factor;
  P->abs_tol = abs_tol;
  P->stall = stall;
  P->pin_mean = pin_mean;
  P->partials = partials;
  P->n_int = n_int;
  P->store_bf16 = store_bf16;
  P->corr_opt = corr_opt;
  P->rc32 = rc32;
  P->plan = plan_from(plan);
  if (pre < 1 || post < 0) return static_cast<int>(cudaErrorInvalidValue);
  return check_plan(*P, true, masked != 0);
}

}  // namespace ws
}  // namespace cfd
