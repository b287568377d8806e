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
// the channel carry's second and third launches on (u, v) as given). The
// cavity and channel carries, fixed and traced_dt + emit_courant, also run
// with shard=(P, mdy) on one shard's local block (rows 16a and 16d, and
// 16a+ and 16d+, cfd_tpu/parallel/quad_sharded.py): the
// arrays are a shard's (4, P + 16, Wqa) block between two 8-row halo
// strips, row_base = jy * P - 8 is the global plane row of local row 0
// (every mask and ghost keeps its global meaning, common.cuh), a neighbour
// outside the block reads 0, and the reductions (the cavity's max|b|, the
// channel's sum of b, and the Courant maxima) cover the own rows only: the
// shard's partials (quad.py:308-312 masks every scalar so). The
// scratch u, v cover the whole block. The cavity's stages reach 5 rows
// (quad.py:970-971); the channel's reach 5 too, counting one row for each
// stage: the corrector (p at j+1), the ghosts on the corrected fields (the
// ghost rows read rows 1 and ny), the predictor (j-1 ... j+1), the ghosts
// on the tentative fields and the source (vs at j-1). Both are inside the
// 8-row halo (kChannelRadius below), so the own rows are exact. A whole
// field is row_base 0, halo 0, and its instances fold the row offset away
// at compile time (kBlock).
//
// Bound on the H100: device-memory bytes. The correctors read 4 quad fields
// and write 3; the carries read 4 and write 4 plus one scalar (19 MB per
// field at 2048^2, 3.8 MB at 1536x512). The arithmetic (about 60 flops a
// cell for the predictor) is far below the card's rate.
//
// Design: one thread per quad cell, neighbours through the guarded quad
// accessor, so one code path serves every plane and no halo bookkeeping is
// needed. The per-cell bodies live in quad_carry.cuh, which the whole-step
// kernel (whole_step.cu) runs too. A carry runs as TWO launches (three for
// the channel, see below): (1) the corrector writes the corrected and
// ghost-rebuilt u, v into scratch fields, (2) the predictor + source +
// reduction reads them. A thread of launch 2 evaluates the predictor at its
// own faces and again at the west/south faces its divergence needs
// (re-reads that hit L1/L2). This
// costs one extra round trip of u, v through device memory compared with a
// single fused launch with a shared-memory tile and a 3-cell halo, which is
// the next kernel step.
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
// chosen by two template flags, so the fixed-dt instances keep their code:
// kTraced reads dt from a device pointer (never a host float: the chunked
// and lagged controllers keep dt on the card) and forms the coefficients
// from it in the reference's float32 order (cfd::traced_coeff,
// cfd::pred_at); the carries take the pair (dt_corr, dt_pred), dt_corr for
// the correction of the carried tentative fields, dt_pred for this step's
// predictor and source. kCourant also reduces max|u| and max|v| of the
// corrected, ghosted fields over every quad cell of a whole field, or the
// own rows of a shard's block (the region of the reference's
// scalar_reduce, quad.py:300-360), into two device scalars the host zeroes. The non-carry cavity stage make_quad_predictor_source
// (quad.py:438, traced dt) is the carry's second launch with the lid ghosts
// applied to its input on read (lid_u, lid_v).
//
// Channel source sum: each block of launch 2 sums its kThreads values of b
// by a fixed pairwise tree into a per-block partial (cfd::block_sum_to);
// launch 3, one block, folds the partials in the order of the PyTorch
// twin's fold_sum. No float atomics: the sum is the same on every run, and
// equal bit for bit to the plain twin's fixed_order_sum.
#include "common.cuh"
#include "predictor.cuh"
#include "quad_carry.cuh"

namespace {

using cfd::Pred;
using cfd::quad::Corr;
using cfd::quad::corr_at;

// the dependency radius of the channel carry's stages, in rows (above)
constexpr int kChannelRadius = 5;
static_assert(kChannelRadius <= 8, "the channel carry reaches past the 8-row halo");

// kCourant: max|u|, max|v| of the outputs into courant[0], courant[1];
// kBlock: a shard's local block, whose maxima take its own rows only
// (cfd::own_row, the `halo`-row strips excluded)
template <bool kTraced, bool kCourant, bool kBlock = false>
__global__ void corrector_kernel(const float* us, const float* vs, const float* p,
                                 const float* p_prev, float* u2, float* v2, float* guess,
                                 Corr c0, const float* dt, float* courant, int halo) {
  const Corr c = corr_at<kTraced, false>(c0, dt);
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float au = 0.f, av = 0.f;
  if (idx < n) {
    const float2 a =
        cfd::quad::cavity_corrector_cell(us, vs, p, p_prev, u2, v2, guess, idx, c);
    if (!kBlock || cfd::own_row(idx, c.Hq8, c.Wqa, halo)) {
      au = a.x;
      av = a.y;
    }
  }
  if constexpr (kCourant) cfd::block_max2_into(au, av, courant);
}

// the predictor, b = rho/dt * div on the cells and max|b|; kLid applies the
// lid ghosts to u, v on read (the non-carry stage, quad.py:438). kBlock: a
// shard's local block, with its row offset and the max over its own rows
// only (cfd::own_row); a whole field's instance folds the row offset away
// at compile time (the run-time offset cost it 7% on the H100)
template <bool kTraced, bool kLid, bool kBlock = false>
__global__ void predictor_source_kernel(const float* u, const float* v, float* us2,
                                        float* vs2, float* b, float* max_b, Pred c0,
                                        const float* dt, float two_lid, int halo) {
  Pred c = cfd::pred_at<kTraced>(c0, dt);
  if constexpr (!kBlock) c.row0 = 0;
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float absb = 0.f;
  if (idx < n) {
    const float bb =
        cfd::quad::predictor_source_cell<kLid>(u, v, us2, vs2, b, idx, c, two_lid);
    if (!kBlock || cfd::own_row(idx, c.Hq8, c.Wqa, halo)) absb = fabsf(bb);
  }
  cfd::block_max_into(absb, max_b);
}

// kBlock: a shard's local block (its row offset, and the Courant maxima
// over its own rows only); else row0 folds to 0
template <bool kTraced, bool kCourant, bool kBlock = false>
__global__ void channel_corrector_kernel(const float* us, const float* vs, const float* p,
                                         const float* p_prev, float* u2, float* v2,
                                         float* guess, Corr c0, const float* dt,
                                         float* courant, int halo) {
  Corr c = corr_at<kTraced, true>(c0, dt);
  if constexpr (!kBlock) c.row0 = 0;
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float au = 0.f, av = 0.f;
  if (idx < n) {
    const float2 a =
        cfd::quad::channel_corrector_cell(us, vs, p, p_prev, u2, v2, guess, idx, c);
    if (!kBlock || cfd::own_row(idx, c.Hq8, c.Wqa, halo)) {
      au = a.x;
      av = a.y;
    }
  }
  if constexpr (kCourant) cfd::block_max2_into(au, av, courant);
}

// predictor, channel ghosts on the tentative fields, b = rho/dt * div on the
// cells, and the block's partial sum of b (fixed tree); kBlock: a shard's
// local block, whose partials take its own rows only (cfd::own_row)
template <bool kTraced, bool kBlock = false>
__global__ void channel_predictor_source_kernel(const float* u, const float* v, float* us2,
                                                float* vs2, float* b, float* partials,
                                                Pred c0, float uin, const float* dt,
                                                int halo) {
  Pred c = cfd::pred_at<kTraced>(c0, dt);
  if constexpr (!kBlock) c.row0 = 0;
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float part = 0.f;
  if (idx < n) {
    const float bb = cfd::quad::channel_predictor_source_cell(u, v, us2, vs2, b, idx, c, uin);
    if (!kBlock || cfd::own_row(idx, c.Hq8, c.Wqa, halo)) part = bb;
  }
  cfd::block_sum_to(part, partials + blockIdx.x);
}

// one block: the partials folded into *sum in the twin's fold_sum order
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

// the cavity carry's two launches: the corrector into the scratch u, v,
// then the predictor + source + max|b| from them; kBlock: a shard's local
// block with a `halo`-row strip, whose maxima take its own rows only
template <bool kAdaptive, bool kBlock = false>
cudaError_t cavity_carry(const float* us, const float* vs, const float* p,
                         const float* p_prev, float* u_scr, float* v_scr, float* us2,
                         float* vs2, float* b, float* guess, float* max_b, float* courant,
                         const float* dts, const Corr& c, const Pred& pc, int halo,
                         cudaStream_t s) {
  const long long n = 4LL * c.Hq8 * c.Wqa;
  corrector_kernel<kAdaptive, kAdaptive, kBlock><<<cfd::blocks_for(n), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u_scr, v_scr, guess, c, dts, courant, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(max_b, 0, sizeof(float), s);
  if (err != cudaSuccess) return err;
  predictor_source_kernel<kAdaptive, false, kBlock><<<cfd::blocks_for(n), cfd::kThreads, 0,
                                                      s>>>(u_scr, v_scr, us2, vs2, b, max_b,
                                                           pc, kAdaptive ? dts + 1 : nullptr,
                                                           0.f, halo);
  return cudaGetLastError();
}

// the channel carry's three launches: corrector, predictor + source +
// partial sums (own rows of a block with a `halo`-row strip), fold
template <bool kAdaptive, bool kBlock = false>
cudaError_t channel_carry(const float* us, const float* vs, const float* p,
                          const float* p_prev, float* u_scr, float* v_scr, float* us2,
                          float* vs2, float* b, float* guess, float* partials, float* sum_b,
                          float* courant, const float* dts, const Corr& c, const Pred& pc,
                          int halo, cudaStream_t s) {
  const int blocks = cfd::blocks_for(4LL * c.Hq8 * c.Wqa);
  channel_corrector_kernel<kAdaptive, kAdaptive, kBlock><<<blocks, cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u_scr, v_scr, guess, c, dts, courant, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  channel_predictor_source_kernel<kAdaptive, kBlock><<<blocks, cfd::kThreads, 0, s>>>(
      u_scr, v_scr, us2, vs2, b, partials, pc, c.ghost, kAdaptive ? dts + 1 : nullptr, halo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cfd::fold_partials(partials, blocks, sum_b, s);
}

}  // namespace

extern "C" int cfd_quad_corrector(const float* us, const float* vs, const float* p,
                                  const float* p_prev, float* u2, float* v2,
                                  float* guess, int Hq8, int Wqa, int ny, int nx,
                                  float cu, float cv, float two_lid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu, cv, two_lid};
  corrector_kernel<false, false><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, c, nullptr, nullptr, 0);
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
  corrector_kernel<true, false><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, c, dt, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// the non-carry cavity stage with a traced dt (*dt on the card): lid ghosts
// on the input u, v, predictor, source, max|b| (zeroed here)
extern "C" int cfd_quad_predictor_source(const float* u, const float* v, float* us2,
                                         float* vs2, float* b, float* max_b, const float* dt,
                                         int Hq8, int Wqa, int ny, int nx, float two_lid,
                                         float nu, float idx, float idy, float idx2,
                                         float idy2, float rho, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(max_b, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho};
  predictor_source_kernel<true, true><<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0,
                                        s>>>(u, v, us2, vs2, b, max_b, pc, dt, two_lid, 0);
  return static_cast<int>(cudaGetLastError());
}

// row_base, halo: a local block's global plane row of row 0 and its halo
// strip (0, 0 on a whole field)
extern "C" int cfd_quad_carry(const float* us, const float* vs, const float* p,
                              const float* p_prev, float* u_scr, float* v_scr,
                              float* us2, float* vs2, float* b, float* guess,
                              float* max_b, int Hq8, int Wqa, int ny, int nx, float cu,
                              float cv, float two_lid, float dt, float nu, float idx,
                              float idy, float idx2, float idy2, float rho_dt,
                              int row_base, int halo, void* stream) {
  Corr c{Hq8, Wqa, ny, nx, cu, cv, two_lid, row_base};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(cavity_carry<false, true>(us, vs, p, p_prev, u_scr, v_scr, us2,
                                                      vs2, b, guess, max_b, nullptr, nullptr,
                                                      c, pc, halo, s));
  }
  return static_cast<int>(cavity_carry<false>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                               guess, max_b, nullptr, nullptr, c, pc, 0, s));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho/dx, rho/dy; courant: 2 floats (max|u|, max|v|), zeroed here;
// row_base, halo as cfd_quad_carry's, max|b| and the Courant maxima then
// over the own rows (row 16a+)
extern "C" int cfd_quad_carry_adaptive(const float* us, const float* vs, const float* p,
                                       const float* p_prev, float* u_scr, float* v_scr,
                                       float* us2, float* vs2, float* b, float* guess,
                                       float* max_b, float* courant, const float* dts,
                                       int Hq8, int Wqa, int ny, int nx, float cu_f,
                                       float cv_f, float two_lid, float nu, float idx,
                                       float idy, float idx2, float idy2, float rho,
                                       int row_base, int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, two_lid, row_base};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(cavity_carry<true, true>(us, vs, p, p_prev, u_scr, v_scr, us2,
                                                     vs2, b, guess, max_b, courant, dts, c,
                                                     pc, halo, s));
  }
  return static_cast<int>(cavity_carry<true>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                              guess, max_b, courant, dts, c, pc, 0, s));
}

extern "C" int cfd_quad_channel_corrector(const float* us, const float* vs,
                                          const float* p, const float* p_prev, float* u2,
                                          float* v2, float* guess, int Hq8, int Wqa, int ny,
                                          int nx, float cu, float cv, float uin,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu, cv, uin};
  channel_corrector_kernel<false, false>
      <<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
          us, vs, p, p_prev, u2, v2, guess, c, nullptr, nullptr, 0);
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
  channel_corrector_kernel<true, false>
      <<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(
          us, vs, p, p_prev, u2, v2, guess, c, dt, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch; row_base,
// halo: a local block's global plane row of row 0 and its halo strip (0, 0
// on a whole field), sum_b then the sum over the own rows
extern "C" int cfd_quad_channel_carry(const float* us, const float* vs, const float* p,
                                      const float* p_prev, float* u_scr, float* v_scr,
                                      float* us2, float* vs2, float* b, float* guess,
                                      float* partials, float* sum_b, int Hq8, int Wqa,
                                      int ny, int nx, float cu, float cv, float uin,
                                      float dt, float nu, float idx, float idy,
                                      float idx2, float idy2, float rho_dt, int row_base,
                                      int halo, void* stream) {
  Corr c{Hq8, Wqa, ny, nx, cu, cv, uin, row_base};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f, row_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo > 0) {
    return static_cast<int>(channel_carry<false, true>(us, vs, p, p_prev, u_scr, v_scr, us2,
                                                       vs2, b, guess, partials, sum_b, nullptr,
                                                       nullptr, c, pc, halo, s));
  }
  return static_cast<int>(channel_carry<false>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                                guess, partials, sum_b, nullptr, nullptr, c,
                                                pc, 0, s));
}

// The non-carry channel stage (quad.py:847): the predictor on (u, v) as
// given, the channel ghosts on the tentative fields, the raw source and its
// interior sum; the channel carry's second and third launches.
// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch
extern "C" int cfd_quad_channel_predictor_source(const float* u, const float* v, float* us2,
                                                 float* vs2, float* b, float* partials,
                                                 float* sum_b, int Hq8, int Wqa, int ny,
                                                 int nx, float uin, float dt, float nu,
                                                 float idx, float idy, float idx2,
                                                 float idy2, float rho_dt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = cfd::blocks_for(4LL * Hq8 * Wqa);
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt};
  channel_predictor_source_kernel<false><<<blocks, cfd::kThreads, 0, s>>>(
      u, v, us2, vs2, b, partials, pc, uin, nullptr, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cfd::fold_partials(partials, blocks, sum_b, s));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho*dx, rho*dy; courant: 2 floats, zeroed here; row_base,
// halo as cfd_quad_channel_carry's, the sum and the Courant maxima then over
// the own rows (row 16d+)
extern "C" int cfd_quad_channel_carry_adaptive(
    const float* us, const float* vs, const float* p, const float* p_prev, float* u_scr,
    float* v_scr, float* us2, float* vs2, float* b, float* guess, float* partials,
    float* sum_b, float* courant, const float* dts, int Hq8, int Wqa, int ny, int nx,
    float cu_f, float cv_f, float uin, float nu, float idx, float idy, float idx2,
    float idy2, float rho, int row_base, int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, uin, row_base};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho, row_base};
  if (halo > 0) {
    return static_cast<int>(channel_carry<true, true>(us, vs, p, p_prev, u_scr, v_scr, us2,
                                                      vs2, b, guess, partials, sum_b, courant,
                                                      dts, c, pc, halo, s));
  }
  return static_cast<int>(channel_carry<true>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                               guess, partials, sum_b, courant, dts, c, pc, 0,
                                               s));
}

extern "C" const char* cfd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
