// Stage kernels of the Rayleigh-Benard tentative-carry step on the quad
// layout: the fused carry and the stats/export corrector.
//
// Replaces cfd_tpu/kernels/rb_quad.py make_quad_rb_step_kernel (:81, math in
// rb_carry_compute :130-222; the plain and emit_guess variants, and
// traced_dt + emit_courant) and make_quad_rb_corrector (:225; fixed and
// traced_dt).
//
// Bound on the H100: device-memory bytes. The carry reads 4 quad fields
// (5 with the warm-start guess) and writes 4 (5) plus one scalar, 3.8 MB per
// field at 1536x512; its arithmetic (about 110 flops a cell: the corrector,
// the temperature update, the predictor with buoyancy, the source) is far
// below the card's rate.
//
// Design. The carry is ONE tile launch and one sum launch. The tile kernel
// (carry_tile.cuh) loads us, vs, p and T with a halo of 4 plane rows and
// columns (8 logical, >= the stages' 7 rows, kRBRadius) into shared memory
// and runs the stages there, each on the region the next one reads: the
// corrector with the box no-slip ghosts (u2, v2), the temperature stage
// with its ghosts (T'), the predictor with the buoyancy from T' and the box
// ghosts on the tentative fields (us', vs'), then the source b of its own
// cells; it writes us', vs', T', b (and the guess 2p - p_prev) of its own
// cells and reduces the Courant maxima over them. A thread that writes a
// ghost evaluates the pre-ghost value it copies from (box_u, box_v,
// temperature_at), as the per-cell corrector does. Tiles that touch no wall,
// ghost row or padding take a path with no ghost or mask test. The sum
// launch (carry_tile.cuh source_sum) sums b in the order of the PyTorch
// twin's fixed_order_sum: 256-wide chunks by the pairwise tree, then the
// last block to finish folds the partials (tile::launch_source_sum, which
// the channel's and the step's carries launch too). 8 passes over the fields (4
// in, 4 out) and one more over b, where the earlier four-launch chain
// made about 15.
//
// The corrector keeps the tentative value on invalid faces (u_else = us,
// rb_quad.py:171-174, 251-252), unlike the cavity and channel correctors,
// which write 0 there.
//
// Ghost order (rb_quad.py:40-78): u's ghost rows j = 0 and ny+1 (i <= nx)
// are minus rows 1 and ny, read BEFORE the side columns i = 0 and nx are
// zeroed, so u's four corner ghosts are minus the pre-ghost side-column
// values; v's ghost columns i = 0 and nx+1 (j <= ny) read columns 1 and nx
// before the wall rows j = 0 and ny are zeroed. T's ghost rows (1 <= i <=
// nx) reflect the wall values, its ghost columns (1 <= j <= ny) copy
// columns 1 and nx, and its four corners keep the pre-step T.
//
// One shard's local block (row 16e, shard=(P, mdy) of rb_quad.py:81 under
// cfd_tpu/parallel/quad_sharded.py): the carry's arrays are a shard's
// (4, P + 16, Wqa) block between two 8-row halo strips and row_base =
// jy * P - 8 is the global plane row of local row 0, as the cavity's and
// the channel's (csrc/quad_stage.cu): the ghosts test the global row, so
// the T ghost rows j = 0 and ny + 1 and the walls are written by the shard
// that holds them; a neighbour outside the block reads 0 (the tiles stage
// u2, v2 and T' on the block only, zero outside it); the sum of b takes the own
// rows only, and so do the Courant maxima of its traced-dt instance (row
// 16e+). The stages' dependency radius (kRBRadius), one row for each:
// the corrector (p at j+1), the box ghosts (the ghost rows read rows 1 and
// ny), the temperature transport (T, v2 at j-1 ... j+1), the T ghosts, the
// predictor with the buoyancy (u2, v2 at j-1 ... j+1, T' at j+1), the box
// ghosts on the tentative fields and the source (vs at j-1): 7 rows, inside
// the 8-row halo, so the own rows are exact. A whole field is row_base 0,
// halo 0, and its instances fold the row offset away at compile time
// (kBlock).
//
// Adaptive stepping (template flag kAdaptive, as csrc/quad_stage.cu's):
// the carry completes step n with dt_corr, the corrector AND the temperature
// transport (rb_quad.py:153-157), and advances step n+1 with dt_pred, the
// predictor, the buoyancy dt_pred * 0.5 (rb_quad.py:195) and the source; the
// tiles reduce max|u2|, max|v2| (rb_quad.py:211). The stats/export
// corrector (make_quad_rb_corrector) keeps the first design, one thread per
// quad cell through the guarded quad accessor.
#include "carry_tile.cuh"
#include "common.cuh"
#include "predictor.cuh"
#include "rb_carry.cuh"

namespace {

using cfd::Pred;
using cfd::rb::RBCorr;
using cfd::rb::RBTemp;

using cfd::rb::kRBRadius;
static_assert(kRBRadius <= 8, "the RB carry reaches past the 8-row halo");

// the corrector entry point: the corrected, ghosted u2, v2 (kTraced: cu, cv
// formed from *dt; c0 holds rho*dx, rho*dy)
template <bool kTraced>
__global__ void rb_corrector_kernel(const float* us, const float* vs, const float* p,
                                    float* u2, float* v2, RBCorr c0, const float* dt) {
  RBCorr c = c0;
  c.row0 = 0;
  if constexpr (kTraced) {
    c.cu = cfd::traced_coeff<true>(*dt, c0.cu);
    c.cv = cfd::traced_coeff<true>(*dt, c0.cv);
  }
  const long long n = 4LL * c.Hq8 * c.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < n) cfd::rb::corrector_cell(us, vs, p, nullptr, u2, v2, nullptr, idx, c);
}

namespace tile = cfd::tile;

// the buffers a tile stages: us, vs, p, T, then the corrected u2, v2 (T'
// overwrites p, us' and vs' overwrite us and vs)
constexpr int kRBBuffers = cfd::rb::kRBInputs + tile::kWorkBuffers;

// The carry's tile kernel (the design above; its stages cfd::rb::rb_tile).
// kAdaptive: the coefficients from dts = (dt_corr, dt_pred) on the card,
// dt_corr for the corrector and the temperature transport, dt_pred for the
// predictor, the buoyancy dt_pred * 0.5 (the reference's (dt_pred *
// buoyancy) * 0.5 at buoyancy 1) and the source, and the Courant maxima
// into courant[0], courant[1]; kBlock: a shard's local block, whose maxima
// take its own rows only, else row0 folds to 0. guess = 2p - p_prev where
// p_prev is given.
template <bool kAdaptive, bool kBlock>
__global__ void __launch_bounds__(tile::kThreads)
    rb_carry_kernel(const float* us, const float* vs, const float* p, const float* T,
                    const float* p_prev, float* us2, float* vs2, float* T2, float* b,
                    float* guess, float* courant, RBCorr cc, RBTemp tc, Pred pc, float buoy,
                    const float* dts, tile::Plan pl, int halo) {
  if constexpr (kAdaptive) {
    cc.cu = cfd::traced_coeff<true>(*dts, cc.cu);
    cc.cv = cfd::traced_coeff<true>(*dts, cc.cv);
    tc.dt = *dts;
  }
  pc = cfd::pred_at<kAdaptive>(pc, kAdaptive ? dts + 1 : nullptr);
  if constexpr (kAdaptive) buoy = pc.dt * 0.5f;
  if constexpr (!kBlock) cc.row0 = tc.row0 = pc.row0 = 0;
  const tile::Tile t = tile::block_tile(pl, cc.Hq8, cc.Wqa, cc.row0);
  const float* src[cfd::rb::kRBInputs] = {us, vs, p, T};
  tile::load<cfd::rb::kRBInputs>(src, tile::smem(), t, cc.Hq8, cc.Wqa);
  __syncthreads();
  float m[2] = {0.f, 0.f};
  cfd::rb::rb_tile<kAdaptive, kBlock, tile::Guess::kExtrapolate>(
      t, tile::smem(), tile::smem() + cfd::rb::kRBInputs * t.N, p, p_prev, us2, vs2, T2, b,
      guess, cc, tc, pc, buoy, halo, m);
  if constexpr (kAdaptive) tile::block_max(m, courant);
}

// the sum of b over the own rows (all rows on a whole field) into *sum, in
// fixed_order_sum's order (tile::source_sum): the second launch of the
// channel's, the step's and RB's carries (tile::launch_source_sum)
template <bool kBlock>
__global__ void __launch_bounds__(cfd::kThreads)
    source_sum_kernel(const float* b, int Hq8, int Wqa, int halo, float* partials,
                      unsigned int* count, float* sum) {
  tile::source_sum<kBlock>(b, Hq8, Wqa, halo, partials, count, sum);
}

// the same sum over a whole field, launched as the programmatic dependent
// of the kernel that writes b (tile::launch_dependent_source_sum): it waits
// for that grid's completion and its memory before any read. The second
// launch of the channel's non-carry stages.
__global__ void __launch_bounds__(cfd::kThreads)
    dependent_source_sum_kernel(const float* b, int Hq8, int Wqa, float* partials,
                                unsigned int* count, float* sum) {
  tile::wait_prerequisites();
  tile::source_sum<false>(b, Hq8, Wqa, 0, partials, count, sum);
}

const void* rb_carry_fn(bool adaptive, bool block) {
  if (adaptive) {
    return block ? reinterpret_cast<const void*>(rb_carry_kernel<true, true>)
                 : reinterpret_cast<const void*>(rb_carry_kernel<true, false>);
  }
  return block ? reinterpret_cast<const void*>(rb_carry_kernel<false, true>)
               : reinterpret_cast<const void*>(rb_carry_kernel<false, false>);
}

// The carry's two launches: the plan checked, the Courant maxima zeroed
// (kAdaptive), the tile kernel, then the sum. kBlock: a shard's local block
// with a `halo`-row strip, whose sum and maxima take its own rows only.
// partials: ceil(4 Hq8 Wqa / 256) floats of scratch; count: one unsigned
// int, 0 before the launch and after it (the sum's last block resets it).
template <bool kAdaptive, bool kBlock>
cudaError_t rb_carry(const float* us, const float* vs, const float* p, const float* T,
                     const float* p_prev, float* us2, float* vs2, float* T2, float* b,
                     float* guess, float* partials, unsigned int* count, float* sum_b,
                     float* courant, const float* dts, const RBCorr& cc, const RBTemp& tc,
                     const Pred& pc, float buoy, const int* plan, int halo, cudaStream_t s) {
  if ((p_prev == nullptr) != (guess == nullptr)) return cudaErrorInvalidValue;
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaError_t err = tile::check(pl, cc.Hq8, cc.Wqa, kRBRadius, kRBBuffers);
  if (err != cudaSuccess) return err;
  if constexpr (kAdaptive) {
    err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), s);
    if (err != cudaSuccess) return err;
  }
  rb_carry_kernel<kAdaptive, kBlock>
      <<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes, s>>>(
          us, vs, p, T, p_prev, us2, vs2, T2, b, guess, courant, cc, tc, pc, buoy, dts, pl,
          halo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tile::launch_source_sum(b, cc.Hq8, cc.Wqa, halo, partials, count, sum_b, s);
}

// the source sum's blocks over a (4, Hq8, Wqa) field: a warp a chunk, at
// most 256 blocks, so few arrive at the count
int source_sum_blocks(int Hq8, int Wqa) {
  const int chunks = cfd::blocks_for(4LL * Hq8 * Wqa);
  const int groups = (chunks + cfd::kThreads / 32 - 1) / (cfd::kThreads / 32);
  return groups < 256 ? groups : 256;
}

}  // namespace

cudaError_t cfd::tile::launch_source_sum(const float* b, int Hq8, int Wqa, int halo,
                                         float* partials, unsigned int* count, float* sum,
                                         cudaStream_t stream) {
  const int blocks = source_sum_blocks(Hq8, Wqa);
  if (halo > 0) {
    source_sum_kernel<true><<<blocks, cfd::kThreads, 0, stream>>>(b, Hq8, Wqa, halo, partials,
                                                                   count, sum);
  } else {
    source_sum_kernel<false><<<blocks, cfd::kThreads, 0, stream>>>(b, Hq8, Wqa, 0, partials,
                                                                    count, sum);
  }
  return cudaGetLastError();
}

cudaError_t cfd::tile::launch_dependent_source_sum(const float* b, int Hq8, int Wqa,
                                                   float* partials, unsigned int* count,
                                                   float* sum, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(source_sum_blocks(Hq8, Wqa));
  cfg.blockDim = dim3(cfd::kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dependent_source_sum_kernel, b, Hq8, Wqa, partials, count,
                            sum);
}

extern "C" int cfd_rb_corrector(const float* us, const float* vs, const float* p, float* u2,
                                float* v2, int Hq8, int Wqa, int ny, int nx, float cu,
                                float cv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RBCorr c{Hq8, Wqa, ny, nx, cu, cv};
  rb_corrector_kernel<false><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, u2, v2, c, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// traced dt: *dt on the card; cu_f, cv_f the float32 rho*dx, rho*dy
extern "C" int cfd_rb_corrector_traced(const float* us, const float* vs, const float* p,
                                       float* u2, float* v2, const float* dt, int Hq8,
                                       int Wqa, int ny, int nx, float cu_f, float cv_f,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RBCorr c{Hq8, Wqa, ny, nx, cu_f, cv_f};
  rb_corrector_kernel<true><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, u2, v2, c, dt);
  return static_cast<int>(cudaGetLastError());
}

// Readies the carry's tile kernel (adaptive, block: its instance) for
// `smem_bytes` of dynamic shared memory on the current device: blocks (SMs
// x blocks per SM), blocks per SM and registers out (tile::ready)
extern "C" int cfd_rb_carry_grid(int adaptive, int block, int smem_bytes, int* blocks,
                                 int* per_sm, int* regs) {
  return tile::ready(rb_carry_fn(adaptive != 0, block != 0), smem_bytes, blocks, per_sm, regs);
}

// p_prev and guess: both null (plain carry) or both given (emit_guess);
// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch; count: one
// unsigned int, 0 (the sum leaves it 0); two_tb, two_tt: 2 * the wall
// temperatures; buoy: dt * 0.5 (the free-fall buoyancy 1); row_base, halo:
// a local block's global plane row of row 0 and its halo strip (0, 0 on a
// whole field), sum_b then the sum over the own rows; plan: the 6 ints of
// the tile plan (tile::Plan, kernels/plan.py carry_plan), a host array
extern "C" int cfd_rb_carry(const float* us, const float* vs, const float* p, const float* T,
                            const float* p_prev, float* us2, float* vs2, float* T2, float* b,
                            float* guess, float* partials, unsigned int* count, float* sum_b,
                            int Hq8, int Wqa, int ny, int nx, float cu, float cv, float dt,
                            float nu, float idx, float idy, float idx2, float idy2,
                            float rho_dt, float kappa, float two_tb, float two_tt, float buoy,
                            int row_base, int halo, const int* plan, void* stream) {
  RBCorr cc{Hq8, Wqa, ny, nx, cu, cv, row_base};
  RBTemp tc{Hq8, Wqa, ny, nx, dt, kappa, idx, idy, idx2, idy2, two_tb, two_tt, row_base};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(rb_carry<false, true>(us, vs, p, T, p_prev, us2, vs2, T2, b, guess,
                                                  partials, count, sum_b, nullptr, nullptr,
                                                  cc, tc, pc, buoy, plan, halo, s));
  }
  return static_cast<int>(rb_carry<false, false>(us, vs, p, T, p_prev, us2, vs2, T2, b, guess,
                                                 partials, count, sum_b, nullptr, nullptr, cc,
                                                 tc, pc, buoy, plan, 0, s));
}

// traced_dt + emit_courant (no guess: the adaptive RB step warm-starts from
// plain p, and so does the sharded one): dts = (dt_corr, dt_pred) on the
// card; cu_f, cv_f the float32 rho*dx, rho*dy; courant: 2 floats, zeroed
// here; partials, count, row_base, halo, plan as cfd_rb_carry's, the sum
// and the Courant maxima then over the own rows (row 16e+)
extern "C" int cfd_rb_carry_adaptive(const float* us, const float* vs, const float* p,
                                     const float* T, float* us2, float* vs2, float* T2,
                                     float* b, float* partials, unsigned int* count,
                                     float* sum_b, float* courant, const float* dts, int Hq8,
                                     int Wqa, int ny, int nx, float cu_f, float cv_f, float nu,
                                     float idx, float idy, float idx2, float idy2, float rho,
                                     float kappa, float two_tb, float two_tt, int row_base,
                                     int halo, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RBCorr cc{Hq8, Wqa, ny, nx, cu_f, cv_f, row_base};
  RBTemp tc{Hq8, Wqa, ny, nx, 0.f, kappa, idx, idy, idx2, idy2, two_tb, two_tt, row_base};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(rb_carry<true, true>(us, vs, p, T, nullptr, us2, vs2, T2, b,
                                                 nullptr, partials, count, sum_b, courant, dts,
                                                 cc, tc, pc, 0.f, plan, halo, s));
  }
  return static_cast<int>(rb_carry<true, false>(us, vs, p, T, nullptr, us2, vs2, T2, b,
                                                nullptr, partials, count, sum_b, courant, dts,
                                                cc, tc, pc, 0.f, plan, 0, s));
}
