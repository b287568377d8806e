// The whole tolerance-driven multigrid solve as device code for one
// cooperative grid: the parameters, the per-level phases, the coarse
// V-cycle and the V-cycle loop with its stop rule. Run by the whole-solve
// kernel (whole_solve.cu) after its warm-start copy, and by the whole-step
// kernel (whole_step.cu) after the carry stages; the fused coarse tail
// (mg_tail.cu) runs the coarse V-cycle alone. whole_solve.cu describes the
// design.
#pragma once

#include <cooperative_groups.h>

#include "aligned_level.cuh"
#include "quad_level0.cuh"
#include "step_level0.cuh"

namespace cfd {
namespace ws {

namespace cg = cooperative_groups;

constexpr int kMaxLevels = 16;
constexpr int kMaxBlocksPerSM = 2;

struct Params {
  cfd::Level0 L0;              // the finest level, quad layout (separable)
  cfd::StepL0 S0;              // the finest level, quad layout (masked)
  int n_coarse;                // aligned levels 1..n_coarse (>= 2)
  cfd::Level lv[kMaxLevels];   // lv[k - 1] is level k
  float* p_lv[kMaxLevels];     // iterate of level k
  float* b_lv[kMaxLevels];     // source of level k
  const float* p_in;           // warm start (quad)
  const float* b0;             // source (quad)
  float* p0;                   // the solution (quad)
  float* q0;                   // masked: the second finest iterate (quad)
  float* filled;               // masked: a solid-filled correction (level-1 size)
  const float* max_b;          // null: max|b| is computed here
  float* ctl;                  // [0] max|b|, [1] [2] residual slots, [3] the pin's sum
                               // or corr_opt's alpha; zeroed before launch
  int* stats;                  // (cycles, the bits of res)
  float* fold;                 // n * n scratch of the coarsest solve
  const float* pinv;           // (n, n), n = ny * nx of the coarsest level
  int pre, post, max_cycles;
  float tol_factor, abs_tol, stall;
  int pin_mean;                // separable only: shift p to zero mean each cycle
  float* partials;             // pin_mean: blocks_for(4 * Hq8 * Wqa) floats of scratch;
                               // corr_opt: 2 * blocks_for(H8 * W of level 1)
  float n_int;                 // pin_mean: the number of interior cells
  int store_bf16;              // round the coarse sources and pre-smoothed iterates
                               // to bfloat16 where the reference stores them
  int corr_opt;                // masked only: line-search the level-1 correction
  float* rc32;                 // corr_opt with store_bf16: the unrounded level-1 source
};

// x rounded to the nearest bfloat16 (ties to even, as torch's .to(bfloat16))
// and back to float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Sweep {
  long long first, step;
  template <class F>
  __device__ __forceinline__ void each(long long n, F f) const {
    for (long long k = first; k < n; k += step) f(k);
  }
};

// one red (colour 0) or black half-sweep of an aligned level in place;
// from_zero: the iterate is all zeros (the first half-sweep of a descent),
// so its reads are zeros and the cells it does not update become 0
__device__ inline void level_half_sweep(const Sweep& s, const cfd::Level& L, float* p,
                                 const float* b, int colour, bool from_zero) {
  s.each(static_cast<long long>(L.H8) * L.W, [&](long long idx) {
    const int j = static_cast<int>(idx / L.W);
    const int i = static_cast<int>(idx - static_cast<long long>(j) * L.W);
    if (((j + i) & 1) == colour && cfd::active(j, i, L)) {
      const cfd::Weights w = cfd::weights(j, i, L);
      p[idx] = from_zero ? cfd::gs_update(0.f, 0.f, 0.f, 0.f, 0.f, b[idx], w.e, w.w, w.n,
                                          w.s, L.idx2, L.idy2, L.omega)
                         : cfd::rb_update(p, b, j, i, L);
    } else if (from_zero) {
      p[idx] = 0.f;
    }
  });
}

// bc = full weighting of the residual b - A p of level L into level Lc, in
// the order of mg_tail._restrict: ((r(2J-1,2I-1) + r(2J-1,2I)) + r(2J,2I-1)
// + r(2J,2I)) * 0.25 on the coarse interior, 0 elsewhere; rounded to
// bfloat16 with bf16 (the stored b[k + 1] of run_tail_vcycle(store_dtype))
__device__ inline void level_restrict(const Sweep& s, const cfd::Level& L, const float* p,
                               const float* b, const cfd::Level& Lc, float* bc, bool bf16) {
  s.each(static_cast<long long>(Lc.H8) * Lc.W, [&](long long idx) {
    const int J = static_cast<int>(idx / Lc.W);
    const int I = static_cast<int>(idx - static_cast<long long>(J) * Lc.W);
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

// p += the bilinear 9-3-3-1 prolongation of the coarse correction e (level
// Lc, edge-replicated ghosts) on the active cells of level L, in the order
// of mg_tail._prolong: 0.0625 * (((9c + 3h) + 3v) + d). With bf16 the
// pre-smoothed p is rounded to bfloat16 first (the stored ps[k]): a cell
// reads only its own p here, so rounding on read is race-free.
__device__ inline void level_prolong_add(const Sweep& s, const cfd::Level& Lc, const float* e,
                                  const cfd::Level& L, float* p, bool bf16) {
  s.each(static_cast<long long>(L.H8) * L.W, [&](long long idx) {
    const int j = static_cast<int>(idx / L.W);
    const int i = static_cast<int>(idx - static_cast<long long>(j) * L.W);
    if (!cfd::active(j, i, L)) return;
    const int jc = (j - 1) >> 1, ic = (i - 1) >> 1;
    const int dj = ((j - 1) & 1) ? 1 : -1, di = ((i - 1) & 1) ? 1 : -1;
    auto E = [&](int a, int c) {
      a = min(max(a, 0), Lc.ny - 1);
      c = min(max(c, 0), Lc.nx - 1);
      return e[static_cast<long long>(a + 1) * Lc.W + (c + 1)];
    };
    const float v = 0.0625f * (((9.0f * E(jc, ic) + 3.0f * E(jc, ic + di)) +
                                3.0f * E(jc + dj, ic)) +
                               E(jc + dj, ic + di));
    p[idx] = (bf16 ? round_bf16(p[idx]) : p[idx]) + v;
  });
}

// out = the solid fill of a masked level's correction e (the whole array)
__device__ inline void level_solid_fill(const Sweep& s, const cfd::Level& L, const float* e,
                                 float* out) {
  s.each(static_cast<long long>(L.H8) * L.W, [&](long long idx) {
    const int j = static_cast<int>(idx / L.W);
    const int i = static_cast<int>(idx - static_cast<long long>(j) * L.W);
    out[idx] = cfd::solid_fill_value(e, j, i, L);
  });
}

// p0 -= fixed_order_sum(p0) / n_int on the quad cells (see the header)
__device__ inline void pin_mean_phase(const Sweep& s, cg::grid_group& grid, const Params& P) {
  const cfd::Level0& L0 = P.L0;
  const long long n0 = 4LL * L0.Hq8 * L0.Wqa;
  const int chunks = static_cast<int>((n0 + cfd::kThreads - 1) / cfd::kThreads);
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long k = static_cast<long long>(c) * cfd::kThreads + threadIdx.x;
    cfd::block_sum_to(k < n0 ? P.p0[k] : 0.f, P.partials + c);
  }
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

// The masked finest level's iterate: P.p0 or P.q0, whichever holds it;
// every phase that applies the ghost stage writes the other one.
struct FineIterate {
  float* cur;
  float* other;
  __device__ inline void swap() {
    float* t = cur;
    cur = other;
    other = t;
  }
};

// n exact masked pairs and the trailing ghost stage (step_vcycle.cu smooth)
__device__ inline void step_smooth(const Sweep& s, cg::grid_group& grid, const Params& P,
                            FineIterate& it, int n_pairs) {
  const cfd::StepL0& L = P.S0;
  const long long n0 = 4LL * L.Hq8 * L.Wqa;
  for (int k = 0; k < n_pairs; ++k) {
    s.each(n0, [&](long long idx) {
      it.other[idx] = cfd::ghost_red_value(it.cur, P.b0, cfd::quad_cell(idx, L.Hq8, L.Wqa), L);
    });
    grid.sync();
    it.swap();
    s.each(n0, [&](long long idx) {
      float v;
      if (cfd::black_update(it.cur, P.b0, cfd::quad_cell(idx, L.Hq8, L.Wqa), L, &v)) {
        it.cur[idx] = v;
      }
    });
    grid.sync();
  }
  s.each(n0, [&](long long idx) {
    const cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa);
    it.other[idx] = cfd::ghost_value(it.cur, c.j, c.i, L);
  });
  grid.sync();
  it.swap();
}

// The V-cycle over the coarse levels 1..n_coarse from zero iterates: the
// source in P.b_lv[1], the correction left in P.p_lv[1] (the body of
// mg_tail.run_tail_vcycle: the descent's pre pairs and restrictions, the
// coarsest dense pinv product, the ascent's prolongations and post pairs).
// With P.store_bf16 it rounds where run_tail_vcycle(store_dtype) stores;
// the caller rounds b_lv[1]. Every thread of the grid calls it.
__device__ __forceinline__ void coarse_vcycle(const Sweep& s, cg::grid_group& grid,
                                              const Params& P) {
  const int nc = P.n_coarse;
  const bool bf16 = P.store_bf16 != 0;
  // --- coarse descent from zero iterates
  for (int k = 1; k < nc; ++k) {
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

  // --- coarsest level: the dense pinv product, rows summed in the
  // fold_sum order
  {
    const cfd::Level& L = P.lv[nc - 1];
    const int n = L.ny * L.nx;
    float* pc = P.p_lv[nc];
    const float* bc = P.b_lv[nc];
    s.each(static_cast<long long>(n) * n, [&](long long idx) {
      const int k = static_cast<int>(idx % n);
      const float vec = bc[static_cast<long long>(1 + k / L.nx) * L.W + 1 + k % L.nx];
      P.fold[idx] = P.pinv[idx] * vec;
    });
    s.each(static_cast<long long>(L.H8) * L.W, [&](long long idx) {
      const int j = static_cast<int>(idx / L.W);
      if (!cfd::interior(j, static_cast<int>(idx - static_cast<long long>(j) * L.W), L)) {
        pc[idx] = 0.f;
      }
    });
    grid.sync();
    s.each(n, [&](long long r) {
      const float e = cfd::fold_sum(P.fold + r * n, n, 0, 1, [] {});
      pc[static_cast<long long>(1 + r / L.nx) * L.W + 1 + r % L.nx] = e;
    });
    grid.sync();
  }

  // --- coarse ascent: prolongation, post pairs
  for (int k = nc - 1; k >= 1; --k) {
    const cfd::Level& L = P.lv[k - 1];
    const float* e = P.p_lv[k + 1];
    if (P.lv[k].full) {
      level_solid_fill(s, P.lv[k], e, P.filled);
      grid.sync();
      e = P.filled;
    }
    level_prolong_add(s, P.lv[k], e, L, P.p_lv[k], bf16);
    grid.sync();
    for (int pair = 0; pair < P.post; ++pair) {
      level_half_sweep(s, L, P.p_lv[k], P.b_lv[k], 0, false);
      grid.sync();
      level_half_sweep(s, L, P.p_lv[k], P.b_lv[k], 1, false);
      grid.sync();
    }
  }
}

// The level-1 source rc at idx: b_lv[1] (rounded to bfloat16 with
// store_bf16, the stored b[0] of run_tail_vcycle(store_dtype)), and its
// unrounded value in rc32 where corr_opt needs it
__device__ __forceinline__ void store_rc(const Params& P, long long idx, float v) {
  P.b_lv[1][idx] = P.store_bf16 ? round_bf16(v) : v;
  if (P.rc32 != nullptr) P.rc32[idx] = v;
}

// corr_opt (masked; multigrid._corr_alpha, whole_solve.py:379-398): the
// level-1 correction e = P.p_lv[1] scaled by alpha = clip(<rc, A e> /
// <A e, A e>, 1, 1.5), 1 where the denominator is 0, with A the level-1
// weighted operator on its active cells and rc the unrounded source. Each
// block sums its kThreads-wide chunks of the two products by the fixed tree
// into per-chunk partials (P.partials, then P.partials + chunks), one block
// folds them in fixed_order_sum's order and writes alpha into P.ctl[3],
// and every thread scales its cells: three barriers.
__device__ inline void corr_alpha_phase(const Sweep& s, cg::grid_group& grid,
                                        const Params& P) {
  const cfd::Level& L = P.lv[0];
  float* e = P.p_lv[1];
  const float* rc = P.rc32 != nullptr ? P.rc32 : P.b_lv[1];
  const long long n1 = static_cast<long long>(L.H8) * L.W;
  const int chunks = static_cast<int>((n1 + cfd::kThreads - 1) / cfd::kThreads);
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long k = static_cast<long long>(c) * cfd::kThreads + threadIdx.x;
    float num = 0.f, den = 0.f;
    if (k < n1) {
      const int j = static_cast<int>(k / L.W);
      const int i = static_cast<int>(k - static_cast<long long>(j) * L.W);
      float a = 0.f;
      if (cfd::active(j, i, L)) {
        const cfd::Weights w = cfd::weights(j, i, L);
        a = cfd::apply_a(e[k], cfd::ld(e, j, i + 1, L), cfd::ld(e, j, i - 1, L),
                         cfd::ld(e, j + 1, i, L), cfd::ld(e, j - 1, i, L), w.e, w.w, w.n, w.s,
                         L.idx2, L.idy2);
      }
      num = rc[k] * a;
      den = a * a;
    }
    cfd::block_sum_to(num, P.partials + c);
    cfd::block_sum_to(den, P.partials + chunks + c);
  }
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

// Every V-cycle of one solve from the warm start in P.p0 (and the source
// in P.b0), with the tolerance max(tol_factor * max|b|, abs_tol), then the
// solution into P.p0 and (cycles, res) into P.stats. P.ctl[1] must be 0
// before the call's first barrier. Every thread of the grid calls it.
template <bool kMasked>
__device__ __forceinline__ void solve_cycles(const Sweep& s, cg::grid_group& grid,
                                             const Params& P, float max_b) {
  const bool lead = s.first == 0;
  const cfd::Level0& L0 = P.L0;
  const long long n0 = 4LL * L0.Hq8 * L0.Wqa;
  const long long n1 = static_cast<long long>(L0.Hq8) * L0.Wqa;
  const float tol = fmaxf(P.tol_factor * (max_b > 0.f ? max_b : 1.0f), P.abs_tol);

  float prev = 1e30f;
  float res = prev / 2.0f;
  int it = 0;
  FineIterate fine{P.p0, P.q0};
  while (res > tol && it < P.max_cycles && res < P.stall * prev) {
    // --- finest level: pre pairs, then the residual restricted into level 1
    if constexpr (kMasked) {
      step_smooth(s, grid, P, fine, P.pre);
      if (lead) P.ctl[1 + ((it + 1) & 1)] = 0.f;  // the next cycle's residual slot
      s.each(n1, [&](long long idx) {
        store_rc(P, idx, cfd::step_restrict_value(fine.cur, P.b0, idx, P.S0));
      });
    } else {
      for (int k = 0; k < P.pre; ++k) {
        for (int colour = 0; colour < 2; ++colour) {
          s.each(n0, [&](long long idx) {
            cfd::QuadCell c = cfd::quad_cell(idx, L0.Hq8, L0.Wqa);
            if (cfd::quad_updates(c, colour, L0)) P.p0[idx] = cfd::quad_gs(P.p0, P.b0, c, L0);
          });
          grid.sync();
        }
      }
      if (lead) P.ctl[1 + ((it + 1) & 1)] = 0.f;  // the next cycle's residual slot
      s.each(n1, [&](long long idx) { store_rc(P, idx, cfd::quad_restrict_value(P.p0, P.b0, idx, L0)); });
    }
    grid.sync();

    coarse_vcycle(s, grid, P);

    // --- finest level: prolongation, post pairs, the tolerance residual
    float r = 0.f;
    if constexpr (kMasked) {
      if (P.corr_opt) corr_alpha_phase(s, grid, P);
      // the level-1 correction solid-filled, then added on the fluid cells
      level_solid_fill(s, P.lv[0], P.p_lv[1], P.filled);
      grid.sync();
      s.each(n0, [&](long long idx) {
        fine.other[idx] = cfd::step_prolong_add_value(fine.cur, P.filled, idx, P.S0);
      });
      grid.sync();
      fine.swap();
      step_smooth(s, grid, P, fine, P.post);
      s.each(n0, [&](long long idx) {
        const cfd::QuadCell c = cfd::quad_cell(idx, P.S0.Hq8, P.S0.Wqa);
        r = cfd::bits_max(r, fabsf(cfd::step_residual(fine.cur, P.b0, c.j, c.i, P.S0)));
      });
    } else {
      s.each(n0, [&](long long idx) {
        P.p0[idx] = cfd::quad_prolong_add_value(P.p0, P.p_lv[1], idx, L0);
      });
      grid.sync();
      for (int k = 0; k < P.post; ++k) {
        for (int colour = 0; colour < 2; ++colour) {
          s.each(n0, [&](long long idx) {
            cfd::QuadCell c = cfd::quad_cell(idx, L0.Hq8, L0.Wqa);
            if (cfd::quad_updates(c, colour, L0)) P.p0[idx] = cfd::quad_gs(P.p0, P.b0, c, L0);
          });
          grid.sync();
        }
      }
      s.each(n0, [&](long long idx) { r = cfd::bits_max(r, cfd::quad_abs_residual(P.p0, P.b0, idx, L0)); });
    }
    cfd::block_max_into(r, P.ctl + 1 + (it & 1));
    if constexpr (!kMasked) {
      if (P.pin_mean) pin_mean_phase(s, grid, P);
    }
    grid.sync();
    prev = res;
    res = __ldcg(P.ctl + 1 + (it & 1));
    ++it;
  }
  if constexpr (kMasked) {
    if (fine.cur != P.p0) {  // the solution into the output array
      s.each(n0, [&](long long idx) { P.p0[idx] = fine.cur[idx]; });
    }
  }
  if (lead) {
    P.stats[0] = it;
    P.stats[1] = __float_as_int(res);
  }
}

// The cooperative grid of kernel fn on the current device: blocks, blocks
// per SM (at most kMaxBlocksPerSM) and registers per thread.
inline int coop_grid(const void* fn, int* blocks, int* per_sm, int* regs) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, cfd::kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms * min(*per_sm, kMaxBlocksPerSM);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  return 0;
}

// The coarse levels 1..n_coarse of P from the host arrays idims (H8, W,
// ny, nx, full), fdims (idx2, idy2) and ptrs (wE, wW, wN, wS, p, b) per
// level (cfd_whole_solve describes them); returns a CUDA error code.
inline int coarse_params(Params* P, int n_coarse, const int* idims, const float* fdims,
                         void* const* ptrs, float omega) {
  if (n_coarse < 2 || n_coarse >= kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  P->n_coarse = n_coarse;
  for (int k = 1; k <= n_coarse; ++k) {
    const int* d = idims + 5 * (k - 1);
    const float* f = fdims + 2 * (k - 1);
    void* const* q = ptrs + 6 * (k - 1);
    P->lv[k - 1] = cfd::Level{d[0], d[1], d[2], d[3], f[0], f[1], omega,
                              static_cast<const float*>(q[0]), static_cast<const float*>(q[1]),
                              static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
                              d[4]};
    P->p_lv[k] = static_cast<float*>(q[4]);
    P->b_lv[k] = static_cast<float*>(q[5]);
  }
  return 0;
}

// Params of one solve from the C arguments of cfd_whole_solve (described
// there); returns a CUDA error code, 0 when the arguments are consistent.
inline int solve_params(Params* P, int masked, const float* p_in, const float* b0, float* p0,
                        float* q0, float* filled, const float* max_b, float* ctl, int* stats,
                        float* fold, const float* pinv, const float* wE, const float* wW,
                        const float* wN, const float* wS, int Hq8, int Wqa, int ny, int nx,
                        int step_i, int inlet_j, float idx2, float idy2, float denom,
                        float one_minus_omega, int n_coarse, const int* idims,
                        const float* fdims, void* const* ptrs, float omega, int pre,
                        int post, int max_cycles, float tol_factor, float abs_tol,
                        float stall, int pin_mean, float* partials, float n_int,
                        int store_bf16, int corr_opt, float* rc32) {
  if (masked && (q0 == nullptr || filled == nullptr)) {
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
  P->fold = fold;
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
  return 0;
}

}  // namespace ws
}  // namespace cfd
