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
#include "quad_level0.cuh"

namespace {

using cfd::Level0;

// One half-sweep over the planes of `colour` (0 = red = planes {0, 3}).
// src != dst copies the other colour's cells, so the first launch can move
// the iterate into a fresh array; src == dst updates in place.
__global__ void quad_half_sweep(const float* src, float* dst, const float* b, int colour,
                                Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa);
  if (cfd::quad_updates(c, colour, L)) {
    dst[idx] = cfd::quad_gs(src, b, c, L);
  } else if (src != dst) {
    dst[idx] = src[idx];
  }
}

__global__ void residual_restrict(const float* p, const float* b, float* rc, Level0 L) {
  long long n = static_cast<long long>(L.Hq8) * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  rc[idx] = cfd::quad_restrict_value(p, b, idx, L);
}

__global__ void prolong_add(const float* p, const float* ec, float* out, Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  out[idx] = cfd::quad_prolong_add_value(p, ec, idx, L);
}

__global__ void residual_max(const float* p, const float* b, float* res, Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float r = idx < n ? cfd::quad_abs_residual(p, b, idx, L) : 0.f;
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
