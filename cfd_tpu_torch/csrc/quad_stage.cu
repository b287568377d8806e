// Stage kernels of the tentative-carry step on the quad layout: the
// lid-driven cavity and the channel.
//
// Replaces cfd_tpu/kernels/quad.py make_quad_predictor_source (:438,
// traced_dt), make_quad_corrector (:488, fixed and traced_dt),
// make_quad_corr_predictor_source (:938, math in cavity_carry_compute
// :1062-1123), make_quad_channel_corrector (:892) and
// make_quad_channel_corr_predictor_source (:1126, math in
// channel_carry_compute :1160-1222), the carries fixed and with
// traced_dt + emit_courant.
//
// Bound on the H100: device-memory bytes. The correctors read 4 quad fields
// and write 3; the carries read 4 and write 4 plus one scalar (19 MB per
// field at 2048^2, 3.8 MB at 1536x512). The arithmetic (about 60 flops a
// cell for the predictor) is far below the card's rate.
//
// Design: one thread per quad cell, neighbours through the guarded quad
// accessor, so one code path serves every plane and no halo bookkeeping is
// needed. A carry runs as TWO launches (three for the channel, see below):
// (1) the corrector writes the corrected and ghost-rebuilt u, v into scratch
// fields, (2) the predictor + source + reduction reads them. A thread of
// launch 2 evaluates the predictor at its own faces and again at the
// west/south faces its divergence needs (re-reads that hit L1/L2). This
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
// corrected, ghosted fields over every quad cell (the region of the
// reference's scalar_reduce, quad.py:300-360) into two device scalars the
// host zeroes. The non-carry cavity stage make_quad_predictor_source
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

namespace {

using cfd::Pred;
using cfd::qld;
using cfd::u_star;
using cfd::v_star;

struct Corr {
  int Hq8, Wqa, ny, nx;
  float cu, cv;  // traced-dt instances: the dt-free factors (cfd::traced_coeff)
  float ghost;  // the cavity's 2 * lid velocity, or the channel's inlet velocity
};

// the correction coefficients of a launch: the host's, or formed from the
// traced dt (the cavity multiplies, the channel divides)
template <bool kTraced, bool kDivided>
__device__ __forceinline__ Corr corr_at(Corr c, const float* dt) {
  if constexpr (kTraced) {
    c.cu = cfd::traced_coeff<kDivided>(*dt, c.cu);
    c.cv = cfd::traced_coeff<kDivided>(*dt, c.cv);
  }
  return c;
}

// corrected u on valid faces (j in [1, ny], i in [1, nx-1]), else 0
__device__ __forceinline__ float u_corr(const float* us, const float* p, int j, int i,
                                        const Corr& c) {
  if (!(j >= 1 && j <= c.ny && i >= 1 && i <= c.nx - 1)) return 0.f;
  float pc = qld(p, j, i, c.Hq8, c.Wqa);
  float pe = qld(p, j, i + 1, c.Hq8, c.Wqa);
  return qld(us, j, i, c.Hq8, c.Wqa) - c.cu * (pe - pc);
}

// corrected v on valid faces (j in [1, ny-1], i in [1, nx]), else 0
__device__ __forceinline__ float v_corr(const float* vs, const float* p, int j, int i,
                                        const Corr& c) {
  if (!(j >= 1 && j <= c.ny - 1 && i >= 1 && i <= c.nx)) return 0.f;
  float pc = qld(p, j, i, c.Hq8, c.Wqa);
  float pn = qld(p, j + 1, i, c.Hq8, c.Wqa);
  return qld(vs, j, i, c.Hq8, c.Wqa) - c.cv * (pn - pc);
}

// kCourant: max|u|, max|v| of the outputs into courant[0], courant[1]
template <bool kTraced, bool kCourant>
__global__ void corrector_kernel(const float* us, const float* vs, const float* p,
                                 const float* p_prev, float* u2, float* v2, float* guess,
                                 Corr c0, const float* dt, float* courant) {
  const Corr c = corr_at<kTraced, false>(c0, dt);
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float au = 0.f, av = 0.f;
  if (idx < n) {
    cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa);
    int j = cell.j, i = cell.i;
    float u;
    if (j == c.ny + 1 && i <= c.nx) {
      u = c.ghost - u_corr(us, p, c.ny, i, c);
    } else if (j == 0 && i <= c.nx) {
      u = -u_corr(us, p, 1, i, c);
    } else {
      u = u_corr(us, p, j, i, c);
    }
    float v;
    if (i == 0 && j <= c.ny) {
      v = -v_corr(vs, p, j, 1, c);
    } else if (i == c.nx + 1 && j <= c.ny) {
      v = -v_corr(vs, p, j, c.nx, c);
    } else {
      v = v_corr(vs, p, j, i, c);
    }
    u2[idx] = u;
    v2[idx] = v;
    guess[idx] = 2.0f * p[idx] - p_prev[idx];
    au = fabsf(u);
    av = fabsf(v);
  }
  if constexpr (kCourant) cfd::block_max2_into(au, av, courant);
}

// the lid-cavity ghosts applied to an input field on read, in the
// corrector's order: u's top ghost row is 2*lid minus row ny, its bottom
// ghost row minus row 1 (i <= nx); v's west ghost column is minus column 1,
// its east minus column nx (j <= ny). No ghost reads another ghost.
__device__ __forceinline__ float lid_u(const float* u, int j, int i, const Pred& c,
                                       float two_lid) {
  if (j == c.ny + 1 && i <= c.nx) return two_lid - qld(u, c.ny, i, c.Hq8, c.Wqa);
  if (j == 0 && i <= c.nx) return -qld(u, 1, i, c.Hq8, c.Wqa);
  return qld(u, j, i, c.Hq8, c.Wqa);
}

__device__ __forceinline__ float lid_v(const float* v, int j, int i, const Pred& c) {
  if (i == 0 && j <= c.ny) return -qld(v, j, 1, c.Hq8, c.Wqa);
  if (i == c.nx + 1 && j <= c.ny) return -qld(v, j, c.nx, c.Hq8, c.Wqa);
  return qld(v, j, i, c.Hq8, c.Wqa);
}

// the predictor, b = rho/dt * div on the cells and max|b|; kLid applies the
// lid ghosts to u, v on read (the non-carry stage, quad.py:438)
template <bool kTraced, bool kLid>
__global__ void predictor_source_kernel(const float* u, const float* v, float* us2,
                                        float* vs2, float* b, float* max_b, Pred c0,
                                        const float* dt, float two_lid) {
  const Pred c = cfd::pred_at<kTraced>(c0, dt);
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float absb = 0.f;
  if (idx < n) {
    cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa);
    int j = cell.j, i = cell.i;
    auto lu = [&](int jj, int ii) {
      return kLid ? lid_u(u, jj, ii, c, two_lid) : qld(u, jj, ii, c.Hq8, c.Wqa);
    };
    auto lv = [&](int jj, int ii) {
      return kLid ? lid_v(v, jj, ii, c) : qld(v, jj, ii, c.Hq8, c.Wqa);
    };
    float a = cfd::u_star_at(lu, lv, j, i, c);
    float bv = cfd::v_star_at(lu, lv, j, i, c);
    us2[idx] = a;
    vs2[idx] = bv;
    float bb = 0.f;
    if (j >= 1 && j <= c.ny && i >= 1 && i <= c.nx) {
      float aw = cfd::u_star_at(lu, lv, j, i - 1, c);
      float bs = cfd::v_star_at(lu, lv, j - 1, i, c);
      float div = (a - aw) * c.idx + (bv - bs) * c.idy;
      bb = c.rho_dt * div;
    }
    b[idx] = bb;
    absb = fabsf(bb);
  }
  cfd::block_max_into(absb, max_b);
}

// u after the channel ghost update of a pre-ghost field f(j, i) (0 outside
// the valid u faces), in the reference's order: rows 1..ny take the inlet
// value at i = 0 and f(j, nx-1) at i = nx; the ghost rows j = 0 and
// j = ny+1 (i <= nx) are minus rows 1 and ny AFTER that.
template <class F>
__device__ __forceinline__ float channel_u(F f, int j, int i, int ny, int nx, float uin) {
  auto row = [&](int jj, int ii) -> float {
    if (ii == 0) return uin;
    if (ii == nx) return nx == 1 ? uin : f(jj, nx - 1);
    return f(jj, ii);
  };
  if (j == 0 && i <= nx) return -row(1, i);
  if (j == ny + 1 && i <= nx) return -row(ny, i);
  if (j >= 1 && j <= ny) return row(j, i);
  return f(j, i);
}

// v after the channel ghost update of a pre-ghost field f(j, i) (0 outside
// the valid v faces): 0 on the inlet column and on the wall rows, the
// outlet column i = nx+1 copied from i = nx.
template <class F>
__device__ __forceinline__ float channel_v(F f, int j, int i, int ny, int nx) {
  if (i == 0 && j <= ny) return 0.f;
  if (i == nx + 1 && j <= ny) return f(j, nx);
  if ((j == 0 || j == ny) && i >= 1 && i <= nx) return 0.f;
  return f(j, i);
}

template <bool kTraced, bool kCourant>
__global__ void channel_corrector_kernel(const float* us, const float* vs, const float* p,
                                         const float* p_prev, float* u2, float* v2,
                                         float* guess, Corr c0, const float* dt,
                                         float* courant) {
  const Corr c = corr_at<kTraced, true>(c0, dt);
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float au = 0.f, av = 0.f;
  if (idx < n) {
    cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa);
    auto uc = [&](int j, int i) { return u_corr(us, p, j, i, c); };
    auto vc = [&](int j, int i) { return v_corr(vs, p, j, i, c); };
    const float u = channel_u(uc, cell.j, cell.i, c.ny, c.nx, c.ghost);
    const float v = channel_v(vc, cell.j, cell.i, c.ny, c.nx);
    u2[idx] = u;
    v2[idx] = v;
    guess[idx] = 2.0f * p[idx] - p_prev[idx];
    au = fabsf(u);
    av = fabsf(v);
  }
  if constexpr (kCourant) cfd::block_max2_into(au, av, courant);
}

// predictor, channel ghosts on the tentative fields, b = rho/dt * div on the
// cells, and the block's partial sum of b (fixed tree)
template <bool kTraced>
__global__ void channel_predictor_source_kernel(const float* u, const float* v, float* us2,
                                                float* vs2, float* b, float* partials,
                                                Pred c0, float uin, const float* dt) {
  const Pred c = cfd::pred_at<kTraced>(c0, dt);
  long long n = 4LL * c.Hq8 * c.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float bb = 0.f;
  if (idx < n) {
    cfd::QuadCell cell = cfd::quad_cell(idx, c.Hq8, c.Wqa);
    const int j = cell.j, i = cell.i;
    auto fu = [&](int jj, int ii) { return u_star(u, v, jj, ii, c); };
    auto fv = [&](int jj, int ii) { return v_star(u, v, jj, ii, c); };
    float a = channel_u(fu, j, i, c.ny, c.nx, uin);
    float bv = channel_v(fv, j, i, c.ny, c.nx);
    us2[idx] = a;
    vs2[idx] = bv;
    if (j >= 1 && j <= c.ny && i >= 1 && i <= c.nx) {
      float aw = channel_u(fu, j, i - 1, c.ny, c.nx, uin);
      float bs = channel_v(fv, j - 1, i, c.ny, c.nx);
      float div = (a - aw) * c.idx + (bv - bs) * c.idy;
      bb = c.rho_dt * div;
    }
    b[idx] = bb;
  }
  cfd::block_sum_to(bb, partials + blockIdx.x);
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
// then the predictor + source + max|b| from them
template <bool kAdaptive>
cudaError_t cavity_carry(const float* us, const float* vs, const float* p,
                         const float* p_prev, float* u_scr, float* v_scr, float* us2,
                         float* vs2, float* b, float* guess, float* max_b, float* courant,
                         const float* dts, const Corr& c, const Pred& pc, cudaStream_t s) {
  const long long n = 4LL * c.Hq8 * c.Wqa;
  corrector_kernel<kAdaptive, kAdaptive><<<cfd::blocks_for(n), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u_scr, v_scr, guess, c, dts, courant);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(max_b, 0, sizeof(float), s);
  if (err != cudaSuccess) return err;
  predictor_source_kernel<kAdaptive, false><<<cfd::blocks_for(n), cfd::kThreads, 0, s>>>(
      u_scr, v_scr, us2, vs2, b, max_b, pc, kAdaptive ? dts + 1 : nullptr, 0.f);
  return cudaGetLastError();
}

// the channel carry's three launches: corrector, predictor + source +
// partial sums, fold
template <bool kAdaptive>
cudaError_t channel_carry(const float* us, const float* vs, const float* p,
                          const float* p_prev, float* u_scr, float* v_scr, float* us2,
                          float* vs2, float* b, float* guess, float* partials, float* sum_b,
                          float* courant, const float* dts, const Corr& c, const Pred& pc,
                          cudaStream_t s) {
  const int blocks = cfd::blocks_for(4LL * c.Hq8 * c.Wqa);
  channel_corrector_kernel<kAdaptive, kAdaptive><<<blocks, cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u_scr, v_scr, guess, c, dts, courant);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  channel_predictor_source_kernel<kAdaptive><<<blocks, cfd::kThreads, 0, s>>>(
      u_scr, v_scr, us2, vs2, b, partials, pc, c.ghost, kAdaptive ? dts + 1 : nullptr);
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
      us, vs, p, p_prev, u2, v2, guess, c, nullptr, nullptr);
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
      us, vs, p, p_prev, u2, v2, guess, c, dt, nullptr);
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
                                        s>>>(u, v, us2, vs2, b, max_b, pc, dt, two_lid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cfd_quad_carry(const float* us, const float* vs, const float* p,
                              const float* p_prev, float* u_scr, float* v_scr,
                              float* us2, float* vs2, float* b, float* guess,
                              float* max_b, int Hq8, int Wqa, int ny, int nx, float cu,
                              float cv, float two_lid, float dt, float nu, float idx,
                              float idy, float idx2, float idy2, float rho_dt,
                              void* stream) {
  Corr c{Hq8, Wqa, ny, nx, cu, cv, two_lid};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt};
  return static_cast<int>(cavity_carry<false>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                               guess, max_b, nullptr, nullptr, c, pc,
                                               static_cast<cudaStream_t>(stream)));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho/dx, rho/dy; courant: 2 floats (max|u|, max|v|), zeroed here
extern "C" int cfd_quad_carry_adaptive(const float* us, const float* vs, const float* p,
                                       const float* p_prev, float* u_scr, float* v_scr,
                                       float* us2, float* vs2, float* b, float* guess,
                                       float* max_b, float* courant, const float* dts,
                                       int Hq8, int Wqa, int ny, int nx, float cu_f,
                                       float cv_f, float two_lid, float nu, float idx,
                                       float idy, float idx2, float idy2, float rho,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, two_lid};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho};
  return static_cast<int>(cavity_carry<true>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                              guess, max_b, courant, dts, c, pc, s));
}

extern "C" int cfd_quad_channel_corrector(const float* us, const float* vs,
                                          const float* p, const float* p_prev, float* u2,
                                          float* v2, float* guess, int Hq8, int Wqa, int ny,
                                          int nx, float cu, float cv, float uin,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Corr c{Hq8, Wqa, ny, nx, cu, cv, uin};
  channel_corrector_kernel<false, false>
      <<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(us, vs, p, p_prev, u2, v2,
                                                                 guess, c, nullptr, nullptr);
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
      <<<cfd::blocks_for(4LL * Hq8 * Wqa), cfd::kThreads, 0, s>>>(us, vs, p, p_prev, u2, v2,
                                                                 guess, c, dt, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// partials: cfd::blocks_for(4 * Hq8 * Wqa) floats of scratch
extern "C" int cfd_quad_channel_carry(const float* us, const float* vs, const float* p,
                                      const float* p_prev, float* u_scr, float* v_scr,
                                      float* us2, float* vs2, float* b, float* guess,
                                      float* partials, float* sum_b, int Hq8, int Wqa,
                                      int ny, int nx, float cu, float cv, float uin,
                                      float dt, float nu, float idx, float idy,
                                      float idx2, float idy2, float rho_dt, void* stream) {
  Corr c{Hq8, Wqa, ny, nx, cu, cv, uin};
  Pred pc{Hq8, Wqa, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt};
  return static_cast<int>(channel_carry<false>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                                guess, partials, sum_b, nullptr, nullptr, c,
                                                pc, static_cast<cudaStream_t>(stream)));
}

// traced_dt + emit_courant: dts = (dt_corr, dt_pred) on the card; cu_f, cv_f
// the float32 rho*dx, rho*dy; courant: 2 floats, zeroed here
extern "C" int cfd_quad_channel_carry_adaptive(
    const float* us, const float* vs, const float* p, const float* p_prev, float* u_scr,
    float* v_scr, float* us2, float* vs2, float* b, float* guess, float* partials,
    float* sum_b, float* courant, const float* dts, int Hq8, int Wqa, int ny, int nx,
    float cu_f, float cv_f, float uin, float nu, float idx, float idy, float idx2,
    float idy2, float rho, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(courant, 0, 2 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Corr c{Hq8, Wqa, ny, nx, cu_f, cv_f, uin};
  Pred pc{Hq8, Wqa, ny, nx, 0.f, nu, idx, idy, idx2, idy2, 0.f, rho};
  return static_cast<int>(channel_carry<true>(us, vs, p, p_prev, u_scr, v_scr, us2, vs2, b,
                                               guess, partials, sum_b, courant, dts, c, pc, s));
}

extern "C" const char* cfd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
