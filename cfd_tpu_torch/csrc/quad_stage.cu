// Stage kernels of the tentative-carry step on the quad layout: the
// lid-driven cavity and the channel.
//
// Replaces cfd_tpu/kernels/quad.py make_quad_predictor_source (:438,
// traced_dt), make_quad_corrector (:488, fixed and traced_dt),
// make_quad_corr_predictor_source (:938, math in cavity_carry_compute
// :1062-1123), make_quad_channel_corrector (:892),
// make_quad_channel_corr_predictor_source (:1126, math in
// channel_carry_compute :1160-1222), the carries fixed and with
// traced_dt + emit_courant, and make_quad_channel_predictor_source (:847:
// the predictor + source of the channel's first design on (u, v) as
// given). The cavity and channel carries, fixed and traced_dt +
// emit_courant, also run with shard=(P, mdy) on one shard's local block
// (rows 16a and 16d, and 16a+ and 16d+, cfd_tpu/parallel/quad_sharded.py):
// the arrays are a shard's (4, P + 16, Wqa) block between two 8-row halo
// strips, row_base = jy * P - 8 is the global plane row of local row 0
// (every mask and ghost keeps its global meaning, common.cuh), a neighbour
// outside the block reads 0, and the reductions (the cavity's max|b|, the
// channel's sum of b, and the Courant maxima) cover the own rows only: the
// shard's partials (quad.py:308-312 masks every scalar so). The tiles
// stage the corrected u, v on the block alone (zero outside it, as a read
// of the earlier chain's scratch there was). The cavity's stages reach 5
// rows (quad.py:970-971); the channel's reach 5 too, counting one row for
// each stage: the corrector (p at j+1), the ghosts on the corrected fields
// (the ghost rows read rows 1 and ny), the predictor (j-1 ... j+1), the
// ghosts on the tentative fields and the source (vs at j-1). Both are
// inside the 8-row halo (kChannelRadius below), so the own rows are exact.
// A whole field is row_base 0, halo 0, and its instances fold the row
// offset away at compile time (kBlock).
//
// Bound on the H100: device-memory bytes. The correctors read 4 quad fields
// and write 3; the carries read 4 and write 4 plus one scalar, the
// non-carry stages read 2 and write 3 plus one scalar (19 MB per field at
// 2048^2, 3.8 MB at 1536x512). The arithmetic (about 60 flops a
// cell for the predictor) is far below the card's rate.
//
// Design. Each carry is ONE launch over shared-memory tiles
// (carry_tile.cuh), the channel's followed by one launch for its source
// sum: a block loads us, vs and p with a halo of 3 plane rows and columns
// (6 logical, >= the reference's CARRY_RADIUS of 5), computes the
// corrected, ghosted u, v on the region the predictor reads, then u*, v*
// once a face on the region the source reads (its own cells and one row
// and column to the south and west), then writes us', vs', b and the guess
// of its own cells and reduces max|b| (the cavity) and the Courant maxima
// over them. Tiles that touch no wall, ghost row or padding take a path
// with no ghost or mask test; the channel's tiles whose own cells lie
// wholly in the padding write its constants without loading. The tile
// bodies live in quad_carry.cuh (cavity_tile; ChannelTile, the channel's
// arithmetic for carry_tile.cuh's duct_tile, as the step's StepTile is),
// which the whole-step kernel (whole_step.cu) runs too. The channel's
// sum launch (carry_tile.cuh source_sum, shared with RB's and the step's)
// sums b in the twin's fixed_order_sum order. The corrected u, v never go
// through device memory: 8 passes over the field (4 in, 4 out) where the
// earlier chains made 12, plus the halo's re-reads, mostly from L2.
//
// The cavity's non-carry stage (make_quad_predictor_source, traced dt: the
// exact adaptive controller's first stage) is ONE launch over the same
// tiles, with no memset: a block loads u and v with a halo of 1 plane row
// and column (2 logical: the predictor's 1 and the source's 1), applies
// the lid ghosts once in shared memory (cfd::quad::lid_ghosts; tiles whose
// stages touch no ghost skip it), computes u*, v* once a face on the
// region the source reads (its own cells, one row south, one column west),
// writes us', vs' and b of its own cells, and folds max|b| into the
// launch's running max, which the last block to finish moves into the
// output (tile::fold_max_into); a tile whose own cells lie wholly in the
// padding writes zeros without loading. 5 passes over the field (2 in, 3
// out), plus the halo's re-reads. The tile body is quad_carry.cuh's
// lid_predictor_source_tile; its predictor and source stages are the
// cavity carry's (predictor_box, source_at).
//
// The channel's non-carry stage (row 8c, make_quad_channel_predictor_source:
// the predictor on (u, v) as given, the channel ghosts on the tentative
// fields, the raw source and its sum) is ONE launch over the same tiles
// plus the carries' sum launch, with no memset: a block loads u and v with
// a halo of 2 plane rows and columns (the stages reach 3 logical columns
// west and 2 rows south: kChannelPredictorRadius), computes u* once a face
// on its own cells and one column west and v* on its own cells and one row
// south, with the channel ghosts of the tentative fields (a ghost face
// evaluates the face it copies: ChannelTile us_at, vs_at, as the channel
// carry's tile does; tiles whose stages touch no wall, ghost or padding
// take the formula with no test), and writes us', vs' and b of its own
// cells; a tile whose own cells lie wholly in the padding writes zeros
// without loading. Then the carries' sum, launched as the tile kernel's
// programmatic dependent (tile::launch_dependent_source_sum: its blocks
// are set up while the tiles' last blocks run), sums b in the twin's
// fixed_order_sum order. 5 passes over the field (2 in, 3 out) and one
// more over b, plus the halo's re-reads. The tile body is quad_carry.cuh's
// channel_predictor_source_tile, on the channel carry's arithmetic
// (ChannelTile) with a tile body of its own, not the carry's duct_tile.
//
// The correctors keep the first design: one thread per quad cell,
// neighbours through the guarded quad accessor. Their per-cell bodies live
// in quad_carry.cuh, whose arithmetic the tiles share.
//
// Cavity ghost order (cfd_tpu/kernels/quad.py:420-435, cavity-01.cpp:
// 523-543): u top ghost row j = ny+1 for i <= nx, then u bottom row j = 0
// for i <= nx, then v west column i = 0 for j <= ny, then v east column
// i = nx+1 for j <= ny. Each ghost reads the corrected interior value,
// which no earlier step of that order changes, so every thread can
// recompute its own ghost value independently.
//
// Channel ghost order (quad.py:781-805, channel-01.cpp:513-529): u inlet
// column, v inlet column, u outlet column i = nx copied from nx-1, v outlet
// column, v bottom wall, u ghost row 0, v top wall, u ghost row ny+1. The u
// ghost rows read row 1 / row ny AFTER the inlet and outlet updates, so a
// thread that rebuilds a corner ghost (j = 0 or ny+1 at i = 0 or nx)
// recomputes the inlet or outlet value it depends on (channel_u). The
// channel carry applies these ghosts twice, on the corrected fields and on
// the tentative fields.
//
// Adaptive stepping (cfd_tpu/adaptive.py) adds instances of these kernels,
// chosen by template flags, so the fixed-dt instances keep their code:
// kTraced reads dt from a device pointer (never a host float: the chunked
// and lagged controllers keep dt on the card) and forms the coefficients
// from it in the reference's float32 order (cfd::traced_coeff,
// cfd::pred_at); the carries take the pair (dt_corr, dt_pred), dt_corr for
// the correction of the carried tentative fields, dt_pred for this step's
// predictor and source, and also reduce max|u| and max|v| of the corrected,
// ghosted fields over every quad cell of a whole field, or the own rows of
// a shard's block (the region of the reference's scalar_reduce,
// quad.py:300-360), into two device scalars zeroed before the launch. The
// carries' tiles take one flag, kAdaptive, for both. The non-carry cavity
// stage make_quad_predictor_source (quad.py:438, traced dt) is the tile
// kernel above with dt read from the card (cfd::pred_at).
//
// Row 8c's source sum is the carries' (tile::source_sum): no float
// atomics, the same on every run, and equal bit for bit to the plain twin's
// fixed_order_sum.
#include "carry_tile.cuh"
#include "common.cuh"
#include "predictor.cuh"
#include "quad_carry.cuh"

namespace {

using cfd::Pred;
using cfd::quad::Corr;
using cfd::quad::corr_at;

using cfd::quad::kCavityRadius;
using cfd::quad::kChannelRadius;
static_assert(kChannelRadius <= 8, "the channel carry reaches past the 8-row halo");
// the buffers of the cavity's tile: its inputs, then the corrected u, v
constexpr int kCavityBuffers = cfd::quad::kCavityInputs + cfd::tile::kWorkBuffers;

// the cavity corrector (kTraced: cu, cv formed from *dt)
template <bool kTraced>
__global__ void corrector_kernel(const float* us, const float* vs, const float* p,
                                 const float* p_prev, float* u2, float* v2, float* guess,
                                 Corr c0, const float* dt) {
  const Corr c = corr_at<kTraced, false>(c0, dt);
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < n) cfd::quad::cavity_corrector_cell(us, vs, p, p_prev, u2, v2, guess, idx, c);
}

namespace tile = cfd::tile;

// the buffers of the non-carry stage's tile: u, v, then u*, v*
constexpr int kPredictorBuffers = cfd::quad::kPredictorInputs + tile::kWorkBuffers;

// The cavity's non-carry stage with a traced dt (quad.py:438) in one launch
// (the design above): a block's tile of the lid ghosts, the predictor and
// the source (cfd::quad::lid_predictor_source_tile), or a padding tile's
// zeros without loading; max|b| folded into the launch's running max in
// acc and moved into *max_b by the last block (tile::fold_max_into)
__global__ void __launch_bounds__(tile::kThreads)
    lid_predictor_source_kernel(const float* u, const float* v, float* us2, float* vs2,
                                float* b, float* max_b, unsigned int* acc, Pred pc,
                                const float* dt, float two_lid, tile::Plan pl) {
  pc = cfd::pred_at<true>(pc, dt);
  const tile::Tile t = tile::block_tile(pl, pc.Hq8, pc.Wqa, 0);
  float m = 0.f;
  if (tile::outside(t, pc.ny, pc.nx)) {  // no valid face, no cell: zeros
    tile::each_own_index(t, pc.Hq8, pc.Wqa, [&](int gq) {
      us2[gq] = 0.f;
      vs2[gq] = 0.f;
      b[gq] = 0.f;
    });
  } else {
    const float* src[cfd::quad::kPredictorInputs] = {u, v};
    tile::load<cfd::quad::kPredictorInputs>(src, tile::smem(), t, pc.Hq8, pc.Wqa);
    __syncthreads();
    m = cfd::quad::lid_predictor_source_tile(
        t, tile::smem(), tile::smem() + cfd::quad::kPredictorInputs * t.N, us2, vs2, b, pc,
        two_lid);
  }
  tile::fold_max_into(m, acc, max_b);
}

// The cavity carry in one launch (the design above): a block's tile of the
// corrector, the lid ghosts, the predictor and the source
// (cfd::quad::cavity_tile). kAdaptive: the coefficients from dts =
// (dt_corr, dt_pred) on the card and the Courant maxima, red = (max|b|,
// max|u|, max|v|), else red = max|b|; kBlock: a shard's local block, whose
// reductions take its own rows only, else row0 folds to 0.
template <bool kAdaptive, bool kBlock>
__global__ void __launch_bounds__(tile::kThreads)
    cavity_carry_kernel(const float* us, const float* vs, const float* p, const float* p_prev,
                        float* us2, float* vs2, float* b, float* guess, float* red, Corr c,
                        Pred pc, const float* dts, tile::Plan pl, int halo) {
  c = corr_at<kAdaptive, false>(c, dts);
  pc = cfd::pred_at<kAdaptive>(pc, kAdaptive ? dts + 1 : nullptr);
  if constexpr (!kBlock) c.row0 = pc.row0 = 0;
  const tile::Tile t = tile::block_tile(pl, c.Hq8, c.Wqa, c.row0);
  const float* src[cfd::quad::kCavityInputs] = {us, vs, p};
  tile::load<cfd::quad::kCavityInputs>(src, tile::smem(), t, c.Hq8, c.Wqa);
  __syncthreads();
  float m[kAdaptive ? 3 : 1] = {};
  cfd::quad::cavity_tile<kAdaptive, kBlock>(t, tile::smem(),
                                            tile::smem() + cfd::quad::kCavityInputs * t.N,
                                            p_prev, us2, vs2, b, guess, c, pc, halo, m);
  tile::block_max(m, red);
}

// the channel corrector (kTraced: cu, cv formed from *dt)
template <bool kTraced>
__global__ void channel_corrector_kernel(const float* us, const float* vs, const float* p,
                                         const float* p_prev, float* u2, float* v2,
                                         float* guess, Corr c0, const float* dt) {
  Corr c = corr_at<kTraced, true>(c0, dt);
  c.row0 = 0;
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < n) cfd::quad::channel_corrector_cell(us, vs, p, p_prev, u2, v2, guess, idx, c);
}

// the buffers of the channel's non-carry tile: u, v, then u*, v*
constexpr int kChannelPredictorBuffers =
    cfd::quad::kChannelPredictorInputs + tile::kWorkBuffers;

// The channel's non-carry stage (row 8c) in one launch (the design above):
// a block's tile of the predictor on (u, v) as given, the channel ghosts on
// the tentative fields and the source (cfd::quad::channel_predictor_source_tile),
// or a padding tile's zeros without loading
__global__ void __launch_bounds__(tile::kThreads)
    channel_predictor_source_kernel(const float* u, const float* v, float* us2, float* vs2,
                                    float* b, cfd::quad::ChannelTile f, tile::Plan pl) {
  tile::launch_dependents();  // the sum's blocks may launch
  const tile::Tile t = tile::block_tile(pl, f.c.Hq8, f.c.Wqa, 0);
  if (tile::outside(t, f.c.ny, f.c.nx)) {  // no valid face, no cell: zeros
    tile::each_own_index(t, f.c.Hq8, f.c.Wqa, [&](int gq) {
      us2[gq] = 0.f;
      vs2[gq] = 0.f;
      b[gq] = 0.f;
    });
    return;
  }
  const float* src[cfd::quad::kChannelPredictorInputs] = {u, v};
  tile::load<cfd::quad::kChannelPredictorInputs>(src, tile::smem(), t, f.c.Hq8, f.c.Wqa);
  __syncthreads();
  cfd::quad::channel_predictor_source_tile(
      f, t, tile::smem(), tile::smem() + cfd::quad::kChannelPredictorInputs * t.N, us2, vs2, b);
}

// The channel carry's tile kernel (the design above). kAdaptive: the
// coefficients from dts = (dt_corr, dt_pred) on the card and the Courant
// maxima into courant[0], courant[1]; kBlock: a shard's local block, whose
// maxima take its own rows only, else row0 folds to 0.
template <bool kAdaptive, bool kBlock>
__global__ void __launch_bounds__(tile::kThreads)
    channel_carry_kernel(const float* us, const float* vs, const float* p,
                         const float* p_prev, float* us2, float* vs2, float* b, float* guess,
                         float* courant, Corr c, Pred pc, const float* dts, tile::Plan pl,
                         int halo) {
  c = corr_at<kAdaptive, true>(c, dts);
  pc = cfd::pred_at<kAdaptive>(pc, kAdaptive ? dts + 1 : nullptr);
  if constexpr (!kBlock) c.row0 = pc.row0 = 0;
  tile::duct_carry<kAdaptive, kBlock, tile::Guess::kExtrapolate>(
      cfd::quad::ChannelTile{c, pc}, us, vs, p, p_prev, us2, vs2, b, guess, courant, pl, halo);
}

// one block: the partials folded into *sum in the twin's fold_sum order (no
// stage launches it since the channel's non-carry stages moved onto the
// carries' sum launch; tests/test_torch_foundation.py names it among the
// port's kernels)
__global__ void fold_partials_kernel(float* partials, int n, float* sum) {
  float s = cfd::fold_sum(partials, n, static_cast<int>(threadIdx.x),
                          static_cast<int>(blockDim.x), [] { __syncthreads(); });
  if (threadIdx.x == 0) *sum = s;
}

}  // namespace

cudaError_t cfd::fold_partials(float* partials, int n, float* sum, cudaStream_t stream) {
  fold_partials_kernel<<<1, kThreads, 0, stream>>>(partials, n, sum);
  return cudaGetLastError();
}

namespace {

const void* cavity_carry_fn(bool adaptive, bool block) {
  if (adaptive) {
    return block ? reinterpret_cast<const void*>(cavity_carry_kernel<true, true>)
                 : reinterpret_cast<const void*>(cavity_carry_kernel<true, false>);
  }
  return block ? reinterpret_cast<const void*>(cavity_carry_kernel<false, true>)
               : reinterpret_cast<const void*>(cavity_carry_kernel<false, false>);
}

// the cavity carry's launch: the plan checked, the reductions zeroed (red:
// 1 float, or 3 with kAdaptive), one tile kernel; kBlock: a shard's local
// block with a `halo`-row strip, whose reductions take its own rows only
template <bool kAdaptive, bool kBlock>
cudaError_t cavity_carry(const float* us, const float* vs, const float* p,
                         const float* p_prev, float* us2, float* vs2, float* b, float* guess,
                         float* red, const float* dts, const Corr& c, const Pred& pc,
                         const int* plan, int halo, cudaStream_t s) {
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaError_t err = tile::check(pl, c.Hq8, c.Wqa, kCavityRadius, kCavityBuffers);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(red, 0, (kAdaptive ? 3 : 1) * sizeof(float), s);
  if (err != cudaSuccess) return err;
  cavity_carry_kernel<kAdaptive, kBlock>
      <<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes, s>>>(
          us, vs, p, p_prev, us2, vs2, b, guess, red, c, pc, dts, pl, halo);
  return cudaGetLastError();
}

const void* channel_carry_fn(bool adaptive, bool block) {
  if (adaptive) {
    return block ? reinterpret_cast<const void*>(channel_carry_kernel<true, true>)
                 : reinterpret_cast<const void*>(channel_carry_kernel<true, false>);
  }
  return block ? reinterpret_cast<const void*>(channel_carry_kernel<false, true>)
               : reinterpret_cast<const void*>(channel_carry_kernel<false, false>);
}

// the channel carry's two launches: the plan checked, the Courant maxima
// zeroed (kAdaptive), the tile kernel, then the sum of b (own rows of a
// block with a `halo`-row strip). partials: ceil(4 Hq8 Wqa / 256) floats
// of scratch; count: one unsigned int, 0 before the launch and after it
template <bool kAdaptive, bool kBlock>
cudaError_t channel_carry(const float* us, const float* vs, const float* p,
                          const float* p_prev, float* us2, float* vs2, float* b, float* guess,
                          float* partials, unsigned int* count, float* sum_b, float* courant,
                          const float* dts, const Corr& c, const Pred& pc, const int* plan,
                          int halo, cudaStream_t s) {
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaError_t err = tile::check(pl, c.Hq8, c.Wqa, kChannelRadius, tile::kDuctBuffers);
  if (err != cudaSuccess) return err;
  if constexpr (kAdaptive) {
    err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), s);
    if (err != cudaSuccess) return err;
  }
  channel_carry_kernel<kAdaptive, kBlock>
      <<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes, s>>>(
          us, vs, p, p_prev, us2, vs2, b, guess, courant, c, pc, dts, pl, halo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tile::launch_source_sum(b, c.Hq8, c.Wqa, halo, partials, count, sum_b, s);
}

}  // namespace

extern "C" int cfd_quad_corrector(const float* us, const float* vs, const float* p,
                                  const float* p_prev, float* u2, float* v2,
                                  float* guess, int Hq8, int Wqa, int ny, int nx,
                                  float cu, float cv, float two_lid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu, cv, two_lid};
  corrector_kernel<false><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, c, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// traced dt: *dt on the card; cu_f, cv_f the float32 rho/dx, rho/dy
extern "C" int cfd_quad_corrector_traced(const float* us, const float* vs, const float* p,
                                         const float* p_prev, float* u2, float* v2,
                                         float* guess, const float* dt, int Hq8, int Wqa,
                                         int ny, int nx, float cu_f, float cv_f,
                                         float two_lid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, two_lid};
  corrector_kernel<true><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, c, dt);
  return static_cast<int>(cudaGetLastError());
}

// The non-carry cavity stage with a traced dt (*dt on the card): lid
// ghosts on the input u, v, predictor, source, max|b|. acc: the running
// max (int bits) and the blocks' count, two unsigned ints on the device, 0
// before the launch (it leaves them 0); plan: the 6 ints of the tile plan
// (tile::Plan, kernels/plan.py carry_plan("cavity_predictor")), a host
// array
extern "C" int cfd_quad_predictor_source(const float* u, const float* v, float* us2,
                                         float* vs2, float* b, float* max_b,
                                         unsigned int* acc, const float* dt, int Hq8, int Wqa,
                                         int ny, int nx, float two_lid, float nu, float idx,
                                         float idy, float idx2, float idy2, float rho,
                                         const int* plan, void* stream) {
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const cudaError_t err = tile::check(pl, Hq8, Wqa, cfd::quad::kPredictorRadius,
                                      kPredictorBuffers);
  if (err != cudaSuccess) return static_cast<int>(err);
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho};
  lid_predictor_source_kernel<<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      u, v, us2, vs2, b, max_b, acc, pc, dt, two_lid, pl);
  return static_cast<int>(cudaGetLastError());
}

// Readies the non-carry stage's tile kernel for `smem_bytes` of dynamic
// shared memory on the current device (cfd_quad_carry_grid's outputs)
extern "C" int cfd_quad_predictor_source_grid(int smem_bytes, int* blocks, int* per_sm,
                                              int* regs) {
  return tile::ready(reinterpret_cast<const void*>(lid_predictor_source_kernel), smem_bytes,
                     blocks, per_sm, regs);
}

// Readies the cavity carry's tile kernel (adaptive, block: its instance)
// for `smem_bytes` of dynamic shared memory on the current device: blocks
// (SMs x blocks per SM), blocks per SM and registers out (tile::ready)
extern "C" int cfd_quad_carry_grid(int adaptive, int block, int smem_bytes, int* blocks,
                                   int* per_sm, int* regs) {
  return tile::ready(cavity_carry_fn(adaptive != 0, block != 0), smem_bytes, blocks, per_sm,
                     regs);
}

// plan: the 6 ints of the tile plan (tile::Plan, kernels/plan.py
// carry_plan), a host array; row_base, halo: a local block's global plane
// row of row 0 and its halo strip (0, 0 on a whole field), max|b| then over
// the own rows
extern "C" int cfd_quad_carry(const float* us, const float* vs, const float* p,
                              const float* p_prev, float* us2, float* vs2, float* b,
                              float* guess, float* max_b, int Hq8, int Wqa, int ny, int nx,
                              float cu, float cv, float two_lid, float dt, float nu, float idx,
                              float idy, float idx2, float idy2, float rho_dt, int row_base,
                              int halo, const int* plan, void* stream) {
  Corr c{Hq8, Wqa, ny, nx, cu, cv, two_lid, row_base};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(cavity_carry<false, true>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                      max_b, nullptr, c, pc, plan, halo, s));
  }
  return static_cast<int>(cavity_carry<false, false>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                     max_b, nullptr, c, pc, plan, 0, s));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho/dx, rho/dy; scal: 3 floats (max|b|, max|u|, max|v|),
// zeroed here; row_base, halo, plan as cfd_quad_carry's, the maxima then
// over the own rows (row 16a+)
extern "C" int cfd_quad_carry_adaptive(const float* us, const float* vs, const float* p,
                                       const float* p_prev, float* us2, float* vs2, float* b,
                                       float* guess, float* scal, const float* dts, int Hq8,
                                       int Wqa, int ny, int nx, float cu_f, float cv_f,
                                       float two_lid, float nu, float idx, float idy,
                                       float idx2, float idy2, float rho, int row_base,
                                       int halo, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, two_lid, row_base};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(cavity_carry<true, true>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                     scal, dts, c, pc, plan, halo, s));
  }
  return static_cast<int>(cavity_carry<true, false>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                    scal, dts, c, pc, plan, 0, s));
}

extern "C" int cfd_quad_channel_corrector(const float* us, const float* vs,
                                          const float* p, const float* p_prev, float* u2,
                                          float* v2, float* guess, int Hq8, int Wqa, int ny,
                                          int nx, float cu, float cv, float uin,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu, cv, uin};
  channel_corrector_kernel<false><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, c, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// traced dt: *dt on the card; cu_f, cv_f the float32 rho*dx, rho*dy
extern "C" int cfd_quad_channel_corrector_traced(const float* us, const float* vs,
                                                 const float* p, const float* p_prev,
                                                 float* u2, float* v2, float* guess,
                                                 const float* dt, int Hq8, int Wqa, int ny,
                                                 int nx, float cu_f, float cv_f, float uin,
                                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, uin};
  channel_corrector_kernel<true><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, c, dt);
  return static_cast<int>(cudaGetLastError());
}

// Readies the channel carry's tile kernel (adaptive, block: its instance)
// for `smem_bytes` of dynamic shared memory on the current device
// (cfd_quad_carry_grid's outputs)
extern "C" int cfd_quad_channel_carry_grid(int adaptive, int block, int smem_bytes,
                                           int* blocks, int* per_sm, int* regs) {
  return tile::ready(channel_carry_fn(adaptive != 0, block != 0), smem_bytes, blocks, per_sm,
                     regs);
}

// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch; count: one
// unsigned int, 0 (the sum leaves it 0); row_base, halo: a local block's
// global plane row of row 0 and its halo strip (0, 0 on a whole field),
// sum_b then the sum over the own rows; plan: the 6 ints of the tile plan
// (tile::Plan, kernels/plan.py carry_plan), a host array
extern "C" int cfd_quad_channel_carry(const float* us, const float* vs, const float* p,
                                      const float* p_prev, float* us2, float* vs2, float* b,
                                      float* guess, float* partials, unsigned int* count,
                                      float* sum_b, int Hq8, int Wqa, int ny, int nx, float cu,
                                      float cv, float uin, float dt, float nu, float idx,
                                      float idy, float idx2, float idy2, float rho_dt,
                                      int row_base, int halo, const int* plan, void* stream) {
  Corr c{Hq8, Wqa, ny, nx, cu, cv, uin, row_base};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(channel_carry<false, true>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                       partials, count, sum_b, nullptr,
                                                       nullptr, c, pc, plan, halo, s));
  }
  return static_cast<int>(channel_carry<false, false>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                      partials, count, sum_b, nullptr, nullptr,
                                                      c, pc, plan, 0, s));
}

// The non-carry channel stage (row 8c, quad.py:847): the predictor on (u,
// v) as given, the channel ghosts on the tentative fields, the raw source
// and its sum, in two launches: the tile kernel, then the sum of b.
// partials: ceil(4 Hq8 Wqa / 256) floats of scratch; count: one unsigned
// int, 0 before the call (the sum leaves it 0); plan: the 6 ints of the
// tile plan (tile::Plan, kernels/plan.py carry_plan("channel_predictor")),
// a host array
extern "C" int cfd_quad_channel_predictor_source(const float* u, const float* v, float* us2,
                                                 float* vs2, float* b, float* partials,
                                                 unsigned int* count, float* sum_b, int Hq8,
                                                 int Wqa, int ny, int nx, float uin, float dt,
                                                 float nu, float idx, float idy, float idx2,
                                                 float idy2, float rho_dt, const int* plan,
                                                 void* stream) {
  const tile::Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaError_t err = tile::check(pl, Hq8, Wqa, cfd::quad::kChannelPredictorRadius,
                                kChannelPredictorBuffers);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cfd::quad::ChannelTile f{Corr{Hq8, Wqa, ny, nx, 0.f, 0.f, uin},
                                 Pred{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt}};
  channel_predictor_source_kernel<<<dim3(pl.grid_x, pl.grid_y), tile::kThreads, pl.smem_bytes,
                                    s>>>(u, v, us2, vs2, b, f, pl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tile::launch_dependent_source_sum(b, Hq8, Wqa, partials, count, sum_b, s));
}

// Readies row 8c's tile kernel for `smem_bytes` of dynamic shared memory on
// the current device (cfd_quad_carry_grid's outputs)
extern "C" int cfd_quad_channel_predictor_source_grid(int smem_bytes, int* blocks,
                                                      int* per_sm, int* regs) {
  return tile::ready(reinterpret_cast<const void*>(channel_predictor_source_kernel),
                     smem_bytes, blocks, per_sm, regs);
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho*dx, rho*dy; courant: 2 floats, zeroed here; partials,
// count, row_base, halo, plan as cfd_quad_channel_carry's, the sum and the
// Courant maxima then over the own rows (row 16d+)
extern "C" int cfd_quad_channel_carry_adaptive(
    const float* us, const float* vs, const float* p, const float* p_prev, float* us2,
    float* vs2, float* b, float* guess, float* partials, unsigned int* count, float* sum_b,
    float* courant, const float* dts, int Hq8, int Wqa, int ny, int nx, float cu_f,
    float cv_f, float uin, float nu, float idx, float idy, float idx2, float idy2, float rho,
    int row_base, int halo, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, uin, row_base};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(channel_carry<true, true>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                      partials, count, sum_b, courant, dts, c,
                                                      pc, plan, halo, s));
  }
  return static_cast<int>(channel_carry<true, false>(us, vs, p, p_prev, us2, vs2, b, guess,
                                                     partials, count, sum_b, courant, dts, c,
                                                     pc, plan, 0, s));
}

extern "C" const char* cfd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
