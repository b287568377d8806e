// Stage kernels of the tentative-carry backward-facing step on the quad
// layout.
//
// Replaces cfd_tpu/kernels/step_quad.py make_quad_step_corr_predictor_source
// (:100, math in step_carry_compute :144-201; fixed dt, and traced_dt +
// emit_courant) and make_quad_step_corrector (:204; fixed and traced_dt).
// The carry, fixed and traced_dt + emit_courant, also runs with
// shard=(P, mdy) on one shard's local block (rows 16f and 16f+,
// cfd_tpu/parallel/quad_sharded.py): the arrays are a
// shard's (4, P + 16, Wqa) block between two 8-row halo strips, row_base =
// jy * P - 8 is the global plane row of local row 0 (every mask, inlet row
// and interface face keeps its global meaning, common.cuh), a neighbour
// outside the block reads 0, and the sum of b takes the own rows only, in
// the twin's fold order: the shard's partial, as do the Courant maxima of
// the traced-dt instance. The carry's stages reach kStepRadius rows: the
// corrector (p at j+1), the step BCs on the corrected fields (the ghost
// rows read rows 1 and ny), the predictor (j-1 ... j+1), the step BCs on
// the tentative fields and the source (vs at j-1), one row each; inside
// the 8-row halo, so the own rows are exact. A whole field is row_base 0,
// halo 0, and its instances fold the row offset away at compile time
// (kBlock).
//
// Bound on the H100: device-memory bytes. The corrector reads 3 quad fields
// and writes 2; the carry reads 3 and writes 3 plus one scalar (2.5 MB per
// field at 2048x256). The arithmetic (about 85 flops a cell) is far below
// the card's rate.
//
// Design. The carry is ONE tile launch and one sum launch, as the
// channel's (quad_stage.cu) with the step's masks: both run
// carry_tile.cuh's duct_carry, each with its own arithmetic (StepTile, in
// step_carry.cuh, which the whole-step kernel runs too). The tile kernel
// loads us, vs and p with a halo of 3 plane rows and columns (6 logical,
// >= kStepRadius) into shared memory, computes the
// corrected, BC'd u, v on the region the predictor reads, then u* (own
// cells and one column west) and v* (own cells and one row south) with the
// step BCs on the tentative fields, and writes us', vs' and b = rho/dt *
// div on the FLUID cells (0 elsewhere) of its own cells, reducing the
// Courant maxima over them (kAdaptive). A tile whose staged region misses
// the walls, the ghost rows and columns, the padding, the array's edge and
// the solid block with its interface faces (i <= step_i, j >= inlet_j:
// tile::misses_corner) takes a path with no mask or BC test; a tile whose
// own cells all lie outside the domain (the padding columns: 1025 of the
// 2048x256 step's 1152 quad columns are used) writes its zeros without
// loading. The sum launch (carry_tile.cuh source_sum) sums b in the twin's
// fixed_order_sum order; b is 0 off the fluid cells, so that is the
// fluid-only sum. 6 passes over the fields (3 in, 3 out) and one more over
// b, where the earlier three-launch chain made 10.
//
// The corrector (rows 9b, 9b+) is one launch of one thread a plane cell
// (J, I), all four quads of it: the logical cells j = 2J + qy, i = 2I + qx.
// Most of a cell's reach lies in its own 2 x 2 block (the ghost rows read
// rows 1 and ny, v's outlet column reads nx); of what leaves it, p's two
// quads east and two north are loaded once a thread, where the first
// design's threads, one a quad cell in four blocks, loaded each p up to
// three times through guarded 64-bit indices. Neighbouring threads take
// neighbouring I, so every load and store is coalesced. A plane cell whose
// four cells are interior faces of u and v (corrector_interior, once a
// thread) runs u_corr_formula and v_corr_formula on registers with no mask
// or BC test; any other takes step_uv_at on each cell (the ghost rows, u's
// outlet copy, the solid block and its interface faces), and one wholly in
// the padding writes zeros without loading. The formulas are step_uv_at's
// expressions on the same values, so under --fmad=false the bits are the
// twin's. Runs of 2 and 4 plane columns a thread (float2, float4 loads)
// timed 34-48% and 104-141% slower at 2048x256: half and a quarter of the
// warps to hide the latency with (PERF.md, the step corrector's findings).
// The block is kernels/plan.py step_corrector_plan's; the field fits the
// 50 MB L2, so instructions and latency, not bytes, bound it.
//
// Step BC order (cfd_tpu/kernels/step_quad.py:60-97, bc.step_bc): u inlet
// column (uin on rows 1..inlet_j, 0 above), v inlet column 0, u outlet
// column i = nx copied from nx-1, v outlet column copied from nx, v bottom
// wall 0, u ghost row 0 = -row 1, v top wall 0, u ghost row ny+1 = -row ny,
// then the interface faces: u at i = step_i on rows inlet_j+1..ny and v at
// row inlet_j on columns 1..step_i set to 0. The ghost rows read rows 1 and
// ny AFTER the inlet and outlet updates and BEFORE the interface zeroing, so
// a thread rebuilding a ghost recomputes the value it depends on (step_u).
//
// The adaptive-stepping instances (template flags kTraced on the
// corrector, kAdaptive on the carry) follow csrc/quad_stage.cu: dt from
// the card, the rho-divided coefficients dt / (rho*dx) in float32
// (step_quad.py:163), the carry's pair (dt_corr, dt_pred), and max|u|,
// max|v| of the corrected, BC'd fields.
#include "carry_tile.cuh"
#include "common.cuh"
#include "predictor.cuh"
#include "step_carry.cuh"

namespace {

using cfd::Pred;
using cfd::step::Step;
namespace tile = cfd::tile;

using cfd::step::kStepRadius;
static_assert(kStepRadius <= 8, "the step carry reaches past the 8-row halo");

// Whether the four cells of plane cell (J, I) (logical rows 2J, 2J + 1,
// columns 2I, 2I + 1) are all faces that step_uv_at corrects and leaves as
// they are: u's 1 <= j <= ny, 1 <= i <= nx - 1 and v's 1 <= j <= ny - 1,
// 1 <= i <= nx, none in the solid block or on its interface faces (i <=
// step_i and j >= inlet_j). There step_uv_at is u_corr_formula,
// v_corr_formula, whose reads (j + 1, i + 1) lie in the array.
__device__ __forceinline__ bool corrector_interior(int J, int I, const Step& s) {
  const int j0 = 2 * J, j1 = j0 + 1, i0 = 2 * I, i1 = i0 + 1;
  return j0 >= 1 && j1 <= s.ny - 1 && i0 >= 1 && i1 <= s.nx - 1 &&
         (i0 > s.step_i || j1 < s.inlet_j);
}

// The corrector (the design above; kTraced: cu, cv formed from *dt, s
// holding rho*dx, rho*dy): thread (x, y) of the grid takes plane cell (J,
// I) = (y, x).
template <bool kTraced>
__global__ void step_corrector_kernel(const float* __restrict__ us,
                                      const float* __restrict__ vs,
                                      const float* __restrict__ p, float* __restrict__ u2,
                                      float* __restrict__ v2, Step s, const float* dt) {
  if constexpr (kTraced) {
    s.cu = cfd::traced_coeff<true>(*dt, s.cu);
    s.cv = cfd::traced_coeff<true>(*dt, s.cv);
  }
  const int J = blockIdx.y * blockDim.y + threadIdx.y;
  const int I = blockIdx.x * blockDim.x + threadIdx.x;
  if (J >= s.Hq8 || I >= s.Wqa) return;
  const long long plane = static_cast<long long>(s.Hq8) * s.Wqa;
  const long long at = static_cast<long long>(J) * s.Wqa + I;
  if (corrector_interior(J, I, s)) {
    // U, V: logical (2J + a, 2I + b); P the same, P[a][2] the east column
    // (quads 0, 2 at I + 1) and P[2] the north row (quads 0, 1 at J + 1)
    float U[2][2], V[2][2], P[3][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      U[q >> 1][q & 1] = __ldg(us + q * plane + at);
      V[q >> 1][q & 1] = __ldg(vs + q * plane + at);
      P[q >> 1][q & 1] = __ldg(p + q * plane + at);
    }
    P[0][2] = __ldg(p + at + 1);
    P[1][2] = __ldg(p + 2 * plane + at + 1);
    P[2][0] = __ldg(p + at + s.Wqa);
    P[2][1] = __ldg(p + plane + at + s.Wqa);
    auto ur = [&](int a, int b) { return U[a][b]; };
    auto vr = [&](int a, int b) { return V[a][b]; };
    auto pr = [&](int a, int b) { return P[a][b]; };
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u2[q * plane + at] = cfd::step::u_corr_formula(ur, pr, q >> 1, q & 1, s);
      v2[q * plane + at] = cfd::step::v_corr_formula(vr, pr, q >> 1, q & 1, s);
    }
    return;
  }
  const bool padding = 2 * J > s.ny + 1 || 2 * I > s.nx + 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float2 uv = make_float2(0.f, 0.f);
    if (!padding) {
      uv = cfd::step::step_uv_at(cfd::quad_read(us, s), cfd::quad_read(vs, s),
                                 cfd::quad_read(p, s), 2 * J + (q >> 1), 2 * I + (q & 1), s);
    }
    u2[q * plane + at] = uv.x;
    v2[q * plane + at] = uv.y;
  }
}

// The corrector's launch: blocks of rows x cols plane cells
// (kernels/plan.py step_corrector_plan), as many as cover the field;
// refused unless a block holds 1 to 1024 threads
template <bool kTraced>
cudaError_t step_corrector(const float* us, const float* vs, const float* p, float* u2,
                           float* v2, const float* dt, const Step& s, int rows, int cols,
                           cudaStream_t st) {
  if (rows < 1 || cols < 1 || rows * cols > 1024) return cudaErrorInvalidValue;
  const dim3 grid((s.Wqa + cols - 1) / cols, (s.Hq8 + rows - 1) / rows);
  step_corrector_kernel<kTraced><<<grid, dim3(cols, rows), 0, st>>>(us, vs, p, u2, v2, s, dt);
  return cudaGetLastError();
}

// The carry's tile kernel (the design above). kAdaptive: the coefficients
// from dts = (dt_corr, dt_pred) on the card and the Courant maxima into
// courant[0], courant[1]; kBlock: a shard's local block, whose maxima take
// its own rows only, else row0 folds to 0. The fixed-dt instances fit four
// blocks an SM in 32 registers a thread without spilling, 3% faster than
// three at the 40 the compiler picks unbounded; the adaptive instances two,
// at 64 (a bound of one block let the compiler take more registers and fit
// one block an SM, 13% slower; PERF.md, the carries' findings).
template <bool kAdaptive, bool kBlock>
__global__ void __launch_bounds__(tile::kThreads, kAdaptive ? 2 : 4)
    step_carry_kernel(const float* us, const float* vs, const float* p, float* us2,
                      float* vs2, float* b, float* courant, Step s, Pred pc,
                      const float* dts, tile::Plan pl, int halo) {
  if constexpr (kAdaptive) {
    s.cu = cfd::traced_coeff<true>(*dts, s.cu);
    s.cv = cfd::traced_coeff<true>(*dts, s.cv);
  }
  pc = cfd::pred_at<kAdaptive>(pc, kAdaptive ? dts + 1 : nullptr);
  if constexpr (!kBlock) s.row0 = pc.row0 = 0;
  tile::duct_carry<kAdaptive, kBlock, tile::Guess::kNone>(
      cfd::step::StepTile{s, pc}, us, vs, p, nullptr, us2, vs2, b, nullptr, courant, pl, halo);
}

const void* step_carry_fn(bool adaptive, bool block) {
  if (adaptive) {
    return block ? reinterpret_cast<const void*>(step_carry_kernel<true, true>)
                 : reinterpret_cast<const void*>(step_carry_kernel<true, false>);
  }
  return block ? reinterpret_cast<const void*>(step_carry_kernel<false, true>)
               : reinterpret_cast<const void*>(step_carry_kernel<false, false>);
}

// The carry's two launches: the plan checked, the Courant maxima zeroed
// (kAdaptive), the tile kernel, then the sum. kBlock: a shard's local block
// with a `halo`-row strip, whose sum and maxima take its own rows only.
template <bool kAdaptive, bool kBlock>
cudaError_t step_carry(const float* us, const float* vs, const float* p, float* us2,
                       float* vs2, float* b, float* partials, unsigned int* count,
                       float* sum_b, float* courant, const float* dts, const Step& s,
                       const Pred& pc, const int* plan, int halo, cudaStream_t st) {
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaError_t err = tile::check(pl, s.Hq8, s.Wqa, kStepRadius, tile::kDuctBuffers);
  if (err != cudaSuccess) return err;
  if constexpr (kAdaptive) {
    err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), st);
    if (err != cudaSuccess) return err;
  }
  step_carry_kernel<kAdaptive, kBlock>
      <<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes, st>>>(
          us, vs, p, us2, vs2, b, courant, s, pc, dts, pl, halo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tile::launch_source_sum(b, s.Hq8, s.Wqa, halo, partials, count, sum_b, st);
}

}  // namespace

// rows, cols: the block in plane cells (kernels/plan.py step_corrector_plan)
extern "C" int cfd_step_corrector(const float* us, const float* vs, const float* p,
                                  float* u2, float* v2, int Hq8, int Wqa, int ny, int nx,
                                  int step_i, int inlet_j, float cu, float cv, float uin,
                                  int rows, int cols, void* stream) {
  const Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu, cv, uin};
  return static_cast<int>(step_corrector<false>(us, vs, p, u2, v2, nullptr, s, rows, cols,
                                                static_cast<cudaStream_t>(stream)));
}

// traced dt: *dt on the card; cu_f, cv_f the float32 rho*dx, rho*dy; rows,
// cols as cfd_step_corrector's
extern "C" int cfd_step_corrector_traced(const float* us, const float* vs, const float* p,
                                         float* u2, float* v2, const float* dt, int Hq8,
                                         int Wqa, int ny, int nx, int step_i, int inlet_j,
                                         float cu_f, float cv_f, float uin, int rows,
                                         int cols, void* stream) {
  const Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu_f, cv_f, uin};
  return static_cast<int>(step_corrector<true>(us, vs, p, u2, v2, dt, s, rows, cols,
                                               static_cast<cudaStream_t>(stream)));
}

// Readies the carry's tile kernel (adaptive, block: its instance) for
// `smem_bytes` of dynamic shared memory on the current device: blocks (SMs
// x blocks per SM), blocks per SM and registers out (tile::ready)
extern "C" int cfd_step_carry_grid(int adaptive, int block, int smem_bytes, int* blocks,
                                   int* per_sm, int* regs) {
  return tile::ready(step_carry_fn(adaptive != 0, block != 0), smem_bytes, blocks, per_sm,
                     regs);
}

// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch; count: one
// unsigned int, 0 (the sum leaves it 0); row_base, halo: a local block's
// global plane row of row 0 and its halo strip (0, 0 on a whole field),
// sum_b then the sum over the own rows; plan: the 6 ints of the tile plan
// (tile::Plan, kernels/plan.py carry_plan), a host array
extern "C" int cfd_step_carry(const float* us, const float* vs, const float* p, float* us2,
                              float* vs2, float* b, float* partials, unsigned int* count,
                              float* sum_b, int Hq8, int Wqa, int ny, int nx, int step_i,
                              int inlet_j, float cu, float cv, float uin, float dt, float nu,
                              float idx, float idy, float idx2, float idy2, float rho_dt,
                              int row_base, int halo, const int* plan, void* stream) {
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu, cv, uin, row_base};
  Pred c{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(step_carry<false, true>(us, vs, p, us2, vs2, b, partials, count,
                                                    sum_b, nullptr, nullptr, s, c, plan, halo,
                                                    st));
  }
  return static_cast<int>(step_carry<false, false>(us, vs, p, us2, vs2, b, partials, count,
                                                   sum_b, nullptr, nullptr, s, c, plan, 0, st));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho*dx, rho*dy; courant: 2 floats, zeroed here; partials,
// count, row_base, halo, plan as cfd_step_carry's, the sum and the Courant
// maxima then over the own rows (row 16f+)
extern "C" int cfd_step_carry_adaptive(const float* us, const float* vs, const float* p,
                                       float* us2, float* vs2, float* b, float* partials,
                                       unsigned int* count, float* sum_b, float* courant,
                                       const float* dts, int Hq8, int Wqa, int ny, int nx,
                                       int step_i, int inlet_j, float cu_f, float cv_f,
                                       float uin, float nu, float idx, float idy, float idx2,
                                       float idy2, float rho, int row_base, int halo,
                                       const int* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Step s{Hq8, Wqa, ny, nx, step_i, inlet_j, cu_f, cv_f, uin, row_base};
  Pred c{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(step_carry<true, true>(us, vs, p, us2, vs2, b, partials, count,
                                                   sum_b, courant, dts, s, c, plan, halo, st));
  }
  return static_cast<int>(step_carry<true, false>(us, vs, p, us2, vs2, b, partials, count,
                                                  sum_b, courant, dts, s, c, plan, 0, st));
}
