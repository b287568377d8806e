// Finest-level V-cycle kernels on the quad layout.
//
// Replaces cfd_tpu/kernels/quad.py make_quad_pre_smooth_restrict (:630) and
// make_quad_post_prolong_smooth (:700).
//
// pre:  n red/black pairs, then the residual, then full weighting straight
//       into the aligned level-1 source rc (Hq8, Wqa).
// post: bilinear 9-3-3-1 prolongation of the level-1 correction ec with
//       edge clamps, added on the interior, then n pairs, then max|b - Ap|.
//
// Bound on the H100: device-memory bytes. Each half-sweep launch reads p
// and b and writes half of p (about 3 quad fields of traffic, 19 MB each at
// 2048^2); the restriction and residual launches read p and b once more.
// V(2,1) is therefore about 10 field passes per cycle on the finest level.
//
// Design: one launch per half-sweep (a half-sweep needs the other colour's
// final values over the whole grid), one thread per quad cell, updates in
// place (see mg_smooth.cuh). The first launch of each kernel writes a new
// output array, so the caller's input is never modified. The restriction
// runs one thread per coarse cell and sums its four children with the
// child mapping of quad.py:678-687. Keeping several sweeps in shared
// memory (temporal blocking) is the next step for these kernels; the slab,
// halo and band bookkeeping of the TPU kernels is not needed here.
#include "common.cuh"
#include "mg_smooth.cuh"

namespace {

using cfd::qld;

struct Level0 {
  int Hq8, Wqa, ny, nx;
  float idx2, idy2, omega;
  const float* wE;  // (2*Wqa,) natural column vectors, 0 outside the interior
  const float* wW;
  const float* wN;  // (2*Hq8,) natural row vectors
  const float* wS;
};

__device__ __forceinline__ bool interior(int j, int i, const Level0& L) {
  return j >= 1 && j <= L.ny && i >= 1 && i <= L.nx;
}

// One half-sweep over the planes of `colour` (0 = red = planes {0, 3}).
// src != dst copies the other colour's cells, so the first launch can move
// the iterate into a fresh array; src == dst updates in place.
__global__ void quad_half_sweep(const float* src, float* dst, const float* b, int colour,
                                Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa);
  int mine = ((c.q == 0 || c.q == 3) ? 0 : 1) == colour;
  float p = src[idx];
  if (mine && interior(c.j, c.i, L)) {
    const int j = c.j, i = c.i, H = L.Hq8, W = L.Wqa;
    p = cfd::gs_update(p, qld(src, j, i + 1, H, W), qld(src, j, i - 1, H, W),
                       qld(src, j + 1, i, H, W), qld(src, j - 1, i, H, W), b[idx],
                       L.wE[i], L.wW[i], L.wN[j], L.wS[j], L.idx2, L.idy2, L.omega);
    dst[idx] = p;
  } else if (src != dst) {
    dst[idx] = p;
  }
}

// signed residual b - A p at interior cell (j, i), 0 elsewhere
__device__ __forceinline__ float residual(const float* p, const float* b, int j, int i,
                                          const Level0& L) {
  if (!interior(j, i, L)) return 0.f;
  const int H = L.Hq8, W = L.Wqa;
  long long k = cfd::qidx(j, i, H, W);
  float ap = cfd::apply_a(p[k], qld(p, j, i + 1, H, W), qld(p, j, i - 1, H, W),
                          qld(p, j + 1, i, H, W), qld(p, j - 1, i, H, W), L.wE[i],
                          L.wW[i], L.wN[j], L.wS[j], L.idx2, L.idy2);
  return b[k] - ap;
}

// rc[Jc, Ic] = 0.25 * (r(2Jc, 2Ic) + r(2Jc, 2Ic-1) + r(2Jc-1, 2Ic)
//                      + r(2Jc-1, 2Ic-1)) on the coarse interior, else 0
__global__ void residual_restrict(const float* p, const float* b, float* rc, Level0 L) {
  long long n = static_cast<long long>(L.Hq8) * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int Jc = static_cast<int>(idx / L.Wqa);
  int Ic = static_cast<int>(idx - static_cast<long long>(Jc) * L.Wqa);
  float out = 0.f;
  if (Jc >= 1 && Jc <= L.ny / 2 && Ic >= 1 && Ic <= L.nx / 2) {
    int j = 2 * Jc, i = 2 * Ic;
    out = 0.25f * (residual(p, b, j, i, L) + residual(p, b, j, i - 1, L) +
                   residual(p, b, j - 1, i, L) + residual(p, b, j - 1, i - 1, L));
  }
  rc[idx] = out;
}

// p + prolong(ec) on the interior, p elsewhere (quad.py:741-760)
__global__ void prolong_add(const float* p, const float* ec, float* out, Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa);
  float pc = p[idx];
  if (!interior(c.j, c.i, L)) {
    out[idx] = pc;
    return;
  }
  const int r = c.q >> 1, s = c.q & 1, J = c.j >> 1, I = c.i >> 1;
  const int nyc = L.ny / 2, nxc = L.nx / 2, W = L.Wqa;
  const int J1 = (J + 1) % L.Hq8;  // jnp.roll(ec, -1, axis=0)
  auto rowmix = [&](int col) {
    float e0 = ec[static_cast<long long>(J) * W + col];
    float e1 = ec[static_cast<long long>(J1) * W + col];
    float ecJ0 = (J == 0) ? e1 : e0;    // clamp the J = 0 ghost to row 1
    float ecJ1 = (J == nyc) ? e0 : e1;  // clamp J + 1 > nyc to row nyc
    return r == 0 ? 0.75f * ecJ0 + 0.25f * ecJ1 : 0.25f * ecJ0 + 0.75f * ecJ1;
  };
  float rm = rowmix(I);
  float rm1 = rowmix((I + 1) % W);
  float m0 = (I == 0) ? rm1 : rm;
  float m1 = (I == nxc) ? rm : rm1;
  float corr = s == 0 ? 0.75f * m0 + 0.25f * m1 : 0.25f * m0 + 0.75f * m1;
  out[idx] = pc + corr;
}

__global__ void residual_max(const float* p, const float* b, float* res, Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float r = 0.f;
  if (idx < n) {
    cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa);
    r = fabsf(residual(p, b, c.j, c.i, L));
  }
  cfd::block_max_into(r, res);
}

// n_pairs red+black pairs on dst (already holding the iterate when
// first_src == dst); the first half-sweep reads first_src
int sweep_pairs(const float* first_src, float* dst, const float* b, int n_pairs,
                const Level0& L, cudaStream_t s) {
  const int blocks = cfd::blocks_for(4LL * L.Hq8 * L.Wqa);
  for (int k = 0; k < n_pairs; ++k) {
    quad_half_sweep<<<blocks, cfd::kThreads, 0, s>>>(k == 0 ? first_src : dst, dst, b,
                                                    0, L);
    quad_half_sweep<<<blocks, cfd::kThreads, 0, s>>>(dst, dst, b, 1, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfd_quad_pre_smooth_restrict(const float* p, const float* b, float* p_out,
                                            float* rc, const float* wE, const float* wW,
                                            const float* wN, const float* wS, int Hq8,
                                            int Wqa, int ny, int nx, float idx2,
                                            float idy2, float omega, int n_pairs,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level0 L{Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN, wS};
  int err = sweep_pairs(p, p_out, b, n_pairs, L, s);
  if (err) return err;
  residual_restrict<<<cfd::blocks_for(static_cast<long long>(Hq8) * Wqa), cfd::kThreads,
                      0, s>>>(p_out, b, rc, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cfd_quad_post_prolong_smooth(const float* p, const float* b,
                                            const float* ec, float* p_out, float* res,
                                            const float* wE, const float* wW,
                                            const float* wN, const float* wS, int Hq8,
                                            int Wqa, int ny, int nx, float idx2,
                                            float idy2, float omega, int n_pairs,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level0 L{Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN, wS};
  const int blocks = cfd::blocks_for(4LL * Hq8 * Wqa);
  prolong_add<<<blocks, cfd::kThreads, 0, s>>>(p, ec, p_out, L);
  int err = sweep_pairs(p_out, p_out, b, n_pairs, L, s);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(res, 0, sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  residual_max<<<blocks, cfd::kThreads, 0, s>>>(p_out, b, res, L);
  return static_cast<int>(cudaGetLastError());
}
