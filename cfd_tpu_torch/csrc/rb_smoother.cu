// Coarse-level red/black smoother on the natural (H8, W) layout.
//
// Replaces cfd_tpu/kernels/rb_smoother.py make_rb_pairs (:37), reached
// through rb_pairs_for_level (:322): the plain variant (post-smooth) and
// the with_residual_field variant (pre-smooth + the signed residual field
// b - A p, masked to the interior), on separable weights (cfd_rb_pairs,
// float or bfloat16 storage, the arithmetic always float32,
// rb_smoother.py:199-200,255) and on the full-2D weights of a masked level
// (cfd_rb_pairs_full, float32, rb_smoother.py:106-127,185-198: a cell
// updates only where denom > 0, see aligned_level.cuh); and the
// with_residual variant on separable weights (cfd_rb_pairs with res_max:
// the pairs and max|b - A p| over the interior of the smoothed state, the
// natural finest level's post-smooth and tolerance check,
// multigrid.py:715-719).
//
// Bound on the H100: device-memory bytes and, on the small levels, launch
// latency. A half-sweep reads p and b and writes half of p; with bfloat16
// storage the inputs are half the bytes, but the iterate lives in a float32
// scratch array between half-sweeps so that, as on the TPU (one f32 slab in
// VMEM for all sweeps), rounding to the storage type happens once, at the
// end. The levels below 128^2 are a few microseconds of work each and the
// launches dominate; fusing the coarse tail into one persistent kernel is
// later work (ROADMAP.md queue B, make_mg_tail).
//
// Design: one launch per half-sweep, one thread per cell, in-place updates
// on the scratch iterate (see mg_smooth.cuh), then one finishing launch
// that rounds the iterate to the storage type and, for the residual
// variants, computes the residual from the float32 iterate: the field
// variant writes it, the max variant reduces |r| per block and takes an
// atomicMax on its int bits into a scalar zeroed here (common.cuh). The
// residual reads the neighbours' final values, which the last black
// half-sweep wrote in an earlier launch, so no halo is recomputed.
#include "aligned_level.cuh"

namespace {

using cfd::Level;

// half-sweep of colour (0 = red = (i + j) even) from src (storage T or the
// float scratch) into the float iterate dst
template <typename TS, typename TB>
__global__ void half_sweep(const TS* src, float* dst, const TB* b, int colour, bool copy,
                           Level L) {
  long long n = static_cast<long long>(L.H8) * L.W;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int j = static_cast<int>(idx / L.W);
  int i = static_cast<int>(idx - static_cast<long long>(j) * L.W);
  if (((j + i) & 1) == colour && cfd::active(j, i, L)) {
    dst[idx] = cfd::rb_update(src, b, j, i, L);
  } else if (copy) {
    dst[idx] = cfd::to_f32(src[idx]);
  }
}

// out = storage(iterate); r = storage(b - A iterate) on the interior, 0
// elsewhere (r may be null); res_max: max|b - A iterate| over the interior
// (may be null). Every thread of a block reaches the block reduction.
template <typename T>
__global__ void finish(const float* it, const T* b, T* out, T* r, float* res_max, Level L) {
  const long long n = static_cast<long long>(L.H8) * L.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float rv = 0.f;
  if (idx < n) {
    const int j = static_cast<int>(idx / L.W);
    const int i = static_cast<int>(idx - static_cast<long long>(j) * L.W);
    const float p = it[idx];
    if ((r != nullptr || res_max != nullptr) && cfd::active(j, i, L)) {
      const cfd::Weights w = cfd::weights(j, i, L);
      float ap = cfd::apply_a(p, cfd::ld(it, j, i + 1, L), cfd::ld(it, j, i - 1, L),
                              cfd::ld(it, j + 1, i, L), cfd::ld(it, j - 1, i, L), w.e, w.w,
                              w.n, w.s, L.idx2, L.idy2);
      rv = cfd::to_f32(b[idx]) - ap;
    }
    if (r != nullptr) r[idx] = cfd::from_f32<T>(rv);
    if (static_cast<const void*>(out) != static_cast<const void*>(it)) {
      out[idx] = cfd::from_f32<T>(p);
    }
  }
  if (res_max != nullptr) cfd::block_max_into(fabsf(rv), res_max);
}

template <typename T>
int run_pairs(const T* p, const T* b, T* out, float* it, T* r, float* res_max, int n_pairs,
              const Level& L, cudaStream_t s) {
  const int blocks = cfd::blocks_for(static_cast<long long>(L.H8) * L.W);
  for (int k = 0; k < n_pairs; ++k) {
    if (k == 0) {
      half_sweep<T, T><<<blocks, cfd::kThreads, 0, s>>>(p, it, b, 0, true, L);
    } else {
      half_sweep<float, T><<<blocks, cfd::kThreads, 0, s>>>(it, it, b, 0, false, L);
    }
    half_sweep<float, T><<<blocks, cfd::kThreads, 0, s>>>(it, it, b, 1, false, L);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res_max != nullptr) {
    err = cudaMemsetAsync(res_max, 0, sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (r != nullptr || res_max != nullptr || static_cast<void*>(out) != static_cast<void*>(it)) {
    finish<T><<<blocks, cfd::kThreads, 0, s>>>(it, b, out, r, res_max, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// storage: 0 = float32, 1 = bfloat16. scratch: a float32 (H8, W) iterate;
// for float32 storage the caller passes scratch == out. r: null unless the
// residual-field variant; res_max: null unless the with_residual variant
// (one float, zeroed here).
extern "C" int cfd_rb_pairs(int storage, const void* p, const void* b, void* out,
                            float* scratch, void* r, float* res_max, const float* wE,
                            const float* wW, const float* wN, const float* wS, int H8,
                            int W, int ny, int nx, float idx2, float idy2, float omega,
                            int n_pairs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level L{H8, W, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, 0};
  if (storage == 0) {
    return run_pairs<float>(static_cast<const float*>(p), static_cast<const float*>(b),
                            static_cast<float*>(out), scratch, static_cast<float*>(r),
                            res_max, n_pairs, L, s);
  }
  if (storage == 1) {
    return run_pairs<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), scratch, static_cast<__nv_bfloat16*>(r), res_max,
        n_pairs, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Full-2D weights (a masked level), float32 storage: wE, wW, wN, wS are
// (H8, W) arrays; out doubles as the float32 iterate. r: null for the plain
// variant.
extern "C" int cfd_rb_pairs_full(const float* p, const float* b, float* out, float* r,
                                 const float* wE, const float* wW, const float* wN,
                                 const float* wS, int H8, int W, int ny, int nx,
                                 float idx2, float idy2, float omega, int n_pairs,
                                 void* stream) {
  Level L{H8, W, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, 1};
  return run_pairs<float>(p, b, out, out, r, nullptr, n_pairs, L,
                          static_cast<cudaStream_t>(stream));
}
