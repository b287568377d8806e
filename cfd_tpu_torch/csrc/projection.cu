// Stage kernels of the non-carry step on the natural aligned layout: the
// lid-driven cavity and the channel.
//
// Replaces cfd_tpu/kernels/projection.py make_predictor_source (:210, with
// emit_max_b), make_corrector (:281, with emit_guess),
// make_channel_predictor_source (:386) and make_channel_corrector (:423,
// with emit_guess), all with aligned_io: every field is a row-major
// (H8, W) = (round_up(ny+2, 8), round_up(nx+2, 128)) float32 array that is
// zero beyond the logical (ny+2, nx+2) grid (projection.py:176-178).
//
// Bound on the H100: device-memory bytes. The predictors read 2 fields and
// write 3 plus one scalar, the correctors read 4 and write 3 (17.9 MB a
// field at the 2048^2 cavity's 2056x2176, 3.5 MB at the 1536x512
// channel's 520x1664); about 60 flops a cell for the predictor is far
// below the card's rate.
//
// Design: one thread per aligned cell, row-major, so a warp reads 32
// neighbouring floats of a row. Every element is written, the padding
// included (0 there), because the next kernel reads the padding and the
// aligned contract says it is zero. Neighbours come through a guarded
// accessor (0 outside the array): the TPU kernels roll their slabs with
// wraparound, and every value a masked-in cell reads lies inside the array.
// The per-cell arithmetic is the quad stage kernels' (predictor.cuh, the
// channel ghost order of quad_carry.cuh) on natural indices. A thread
// evaluates the predictor at its own faces and again at the west/south
// faces its divergence needs (re-reads that hit L1/L2).
//
// Cavity ghosts (projection.py _cavity_bc_slab, :193-208): applied on read
// to the predictor's input u, v and, in the corrector, to the corrected
// interior. Every ghost derives from an interior value: u's top row
// j = ny+1 is 2*lid minus row ny, its bottom row minus row 1 (i <= nx); v's
// west column minus column 1, its east minus column nx (j <= ny). So the
// lid row and the corner cells are rebuilt from the interior too.
//
// Channel ghosts (projection.py _channel_bc_slab, :336-355): the order of
// cfd::quad::channel_u / channel_v. The corrector zeroes the invalid faces
// before them (the slim-ghost convention, projection.py:423-436), so the v
// top ghost row and the corners stay 0 for the whole run.
//
// Reductions: max|b| is cfd::block_max_into (atomicMax on the int bits of a
// non-negative float into a scalar zeroed here); the channel's sum of b is
// the fixed-order fold of the quad channel carry (cfd::block_sum_to per
// block, then cfd::fold_partials), equal bit for bit to the plain twin's
// fixed_order_sum over the flat (H8, W) array.
#include "common.cuh"
#include "predictor.cuh"
#include "quad_carry.cuh"

namespace {

using cfd::Pred;

struct Nat {
  int H8, W, ny, nx;
  float cu, cv;  // the correction coefficients (the correctors)
  float ghost;   // the cavity's 2 * lid velocity, or the channel's inlet velocity
};

__device__ __forceinline__ float nld(const float* a, int j, int i, int H8, int W) {
  return (j >= 0 && j < H8 && i >= 0 && i < W) ? a[static_cast<long long>(j) * W + i] : 0.f;
}

// corrected u on valid faces (j in [1, ny], i in [1, nx-1]), else 0
__device__ __forceinline__ float u_corr(const float* us, const float* p, int j, int i,
                                        const Nat& c) {
  if (!(j >= 1 && j <= c.ny && i >= 1 && i <= c.nx - 1)) return 0.f;
  float pc = nld(p, j, i, c.H8, c.W);
  float pe = nld(p, j, i + 1, c.H8, c.W);
  return nld(us, j, i, c.H8, c.W) - c.cu * (pe - pc);
}

// corrected v on valid faces (j in [1, ny-1], i in [1, nx]), else 0
__device__ __forceinline__ float v_corr(const float* vs, const float* p, int j, int i,
                                        const Nat& c) {
  if (!(j >= 1 && j <= c.ny - 1 && i >= 1 && i <= c.nx)) return 0.f;
  float pc = nld(p, j, i, c.H8, c.W);
  float pn = nld(p, j + 1, i, c.H8, c.W);
  return nld(vs, j, i, c.H8, c.W) - c.cv * (pn - pc);
}

// the cavity ghosts of a field f(j, i) at (j, i): u's rows, v's columns
template <class F>
__device__ __forceinline__ float lid_u(F f, int j, int i, int ny, int nx, float two_lid) {
  if (j == ny + 1 && i <= nx) return two_lid - f(ny, i);
  if (j == 0 && i <= nx) return -f(1, i);
  return f(j, i);
}

template <class F>
__device__ __forceinline__ float lid_v(F f, int j, int i, int ny, int nx) {
  if (i == 0 && j <= ny) return -f(j, 1);
  if (i == nx + 1 && j <= ny) return -f(j, nx);
  return f(j, i);
}

// cavity ghosts on u, v, the MAC predictor, b = rho/dt * div on the cells
// and max|b| (projection.py:210, emit_max_b)
__global__ void predictor_source_kernel(const float* u, const float* v, float* us,
                                        float* vs, float* b, float* max_b, Pred c, int H8,
                                        int W, float two_lid) {
  const long long n = static_cast<long long>(H8) * W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float absb = 0.f;
  if (idx < n) {
    const int j = static_cast<int>(idx / W);
    const int i = static_cast<int>(idx - static_cast<long long>(j) * W);
    auto ru = [&](int jj, int ii) { return nld(u, jj, ii, H8, W); };
    auto rv = [&](int jj, int ii) { return nld(v, jj, ii, H8, W); };
    auto lu = [&](int jj, int ii) { return lid_u(ru, jj, ii, c.ny, c.nx, two_lid); };
    auto lv = [&](int jj, int ii) { return lid_v(rv, jj, ii, c.ny, c.nx); };
    const float a = cfd::u_star_at(lu, lv, j, i, c);
    const float bv = cfd::v_star_at(lu, lv, j, i, c);
    us[idx] = a;
    vs[idx] = bv;
    float bb = 0.f;
    if (j >= 1 && j <= c.ny && i >= 1 && i <= c.nx) {
      const float aw = cfd::u_star_at(lu, lv, j, i - 1, c);
      const float bs = cfd::v_star_at(lu, lv, j - 1, i, c);
      const float div = (a - aw) * c.idx + (bv - bs) * c.idy;
      bb = c.rho_dt * div;
    }
    b[idx] = bb;
    absb = fabsf(bb);
  }
  cfd::block_max_into(absb, max_b);
}

// the rho-multiplied cavity projection, the cavity ghosts rebuilt from the
// corrected interior, the guess 2p - p_prev (projection.py:281, emit_guess)
__global__ void corrector_kernel(const float* us, const float* vs, const float* p,
                                 const float* p_prev, float* u2, float* v2, float* guess,
                                 Nat c) {
  const long long n = static_cast<long long>(c.H8) * c.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx / c.W);
  const int i = static_cast<int>(idx - static_cast<long long>(j) * c.W);
  auto uc = [&](int jj, int ii) { return u_corr(us, p, jj, ii, c); };
  auto vc = [&](int jj, int ii) { return v_corr(vs, p, jj, ii, c); };
  u2[idx] = lid_u(uc, j, i, c.ny, c.nx, c.ghost);
  v2[idx] = lid_v(vc, j, i, c.ny, c.nx);
  guess[idx] = 2.0f * p[idx] - p_prev[idx];
}

// the MAC predictor, the channel ghosts on the tentative fields, b = rho/dt
// * div on the cells and the block's partial sum of b (projection.py:386)
__global__ void channel_predictor_source_kernel(const float* u, const float* v, float* us,
                                                float* vs, float* b, float* partials,
                                                Pred c, int H8, int W, float uin) {
  const long long n = static_cast<long long>(H8) * W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float bb = 0.f;
  if (idx < n) {
    const int j = static_cast<int>(idx / W);
    const int i = static_cast<int>(idx - static_cast<long long>(j) * W);
    auto ru = [&](int jj, int ii) { return nld(u, jj, ii, H8, W); };
    auto rv = [&](int jj, int ii) { return nld(v, jj, ii, H8, W); };
    auto fu = [&](int jj, int ii) { return cfd::u_star_at(ru, rv, jj, ii, c); };
    auto fv = [&](int jj, int ii) { return cfd::v_star_at(ru, rv, jj, ii, c); };
    const float a = cfd::quad::channel_u(fu, j, i, c.ny, c.nx, uin);
    const float bv = cfd::quad::channel_v(fv, j, i, c.ny, c.nx);
    us[idx] = a;
    vs[idx] = bv;
    if (j >= 1 && j <= c.ny && i >= 1 && i <= c.nx) {
      const float aw = cfd::quad::channel_u(fu, j, i - 1, c.ny, c.nx, uin);
      const float bs = cfd::quad::channel_v(fv, j - 1, i, c.ny, c.nx);
      const float div = (a - aw) * c.idx + (bv - bs) * c.idy;
      bb = c.rho_dt * div;
    }
    b[idx] = bb;
  }
  cfd::block_sum_to(bb, partials + blockIdx.x);
}

// the rho-divided channel projection on valid faces (0 elsewhere), the
// channel ghosts, the guess 2p - p_prev (projection.py:423, emit_guess)
__global__ void channel_corrector_kernel(const float* us, const float* vs, const float* p,
                                         const float* p_prev, float* u2, float* v2,
                                         float* guess, Nat c) {
  const long long n = static_cast<long long>(c.H8) * c.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx / c.W);
  const int i = static_cast<int>(idx - static_cast<long long>(j) * c.W);
  auto uc = [&](int jj, int ii) { return u_corr(us, p, jj, ii, c); };
  auto vc = [&](int jj, int ii) { return v_corr(vs, p, jj, ii, c); };
  u2[idx] = cfd::quad::channel_u(uc, j, i, c.ny, c.nx, c.ghost);
  v2[idx] = cfd::quad::channel_v(vc, j, i, c.ny, c.nx);
  guess[idx] = 2.0f * p[idx] - p_prev[idx];
}

// the predictor's coefficients (Pred's Hq8, Wqa are not read on this layout)
Pred pred(int ny, int nx, float dt, float nu, float idx, float idy, float idx2, float idy2,
          float rho_dt) {
  return Pred{0, 0, ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt, 0.f};
}

}  // namespace

// max_b: one float, zeroed here
extern "C" int cfd_predictor_source(const float* u, const float* v, float* us, float* vs,
                                    float* b, float* max_b, int H8, int W, int ny, int nx,
                                    float two_lid, float dt, float nu, float idx, float idy,
                                    float idx2, float idy2, float rho_dt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(max_b, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  predictor_source_kernel<<<cfd::blocks_for(static_cast<long long>(H8) * W), cfd::kThreads,
                            0, s>>>(u, v, us, vs, b, max_b,
                                    pred(ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt), H8,
                                    W, two_lid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cfd_corrector(const float* us, const float* vs, const float* p,
                             const float* p_prev, float* u2, float* v2, float* guess, int H8,
                             int W, int ny, int nx, float cu, float cv, float two_lid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  corrector_kernel<<<cfd::blocks_for(static_cast<long long>(H8) * W), cfd::kThreads, 0, s>>>(
      us, vs, p, p_prev, u2, v2, guess, Nat{H8, W, ny, nx, cu, cv, two_lid});
  return static_cast<int>(cudaGetLastError());
}

// partials: cfd::blocks_for(H8 * W) floats of scratch; sum_b: one float
extern "C" int cfd_channel_predictor_source(const float* u, const float* v, float* us,
                                            float* vs, float* b, float* partials,
                                            float* sum_b, int H8, int W, int ny, int nx,
                                            float uin, float dt, float nu, float idx,
                                            float idy, float idx2, float idy2,
                                            float rho_dt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = cfd::blocks_for(static_cast<long long>(H8) * W);
  channel_predictor_source_kernel<<<blocks, cfd::kThreads, 0, s>>>(
      u, v, us, vs, b, partials, pred(ny, nx, dt, nu, idx, idy, idx2, idy2, rho_dt), H8, W,
      uin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cfd::fold_partials(partials, blocks, sum_b, s));
}

extern "C" int cfd_channel_corrector(const float* us, const float* vs, const float* p,
                                     const float* p_prev, float* u2, float* v2, float* guess,
                                     int H8, int W, int ny, int nx, float cu, float cv,
                                     float uin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  channel_corrector_kernel<<<cfd::blocks_for(static_cast<long long>(H8) * W), cfd::kThreads,
                             0, s>>>(us, vs, p, p_prev, u2, v2, guess,
                                     Nat{H8, W, ny, nx, cu, cv, uin});
  return static_cast<int>(cudaGetLastError());
}
