// Shared device helpers for the cfd_tpu_torch kernels.
//
// Layouts. A "quad" field is the (4, Hq8, Wqa) float32 block-parity layout
// of cfd_tpu.kernels.quad: logical cell (j, i) lives in plane
// 2*(j&1) + (i&1), row j>>1, column i>>1. A "natural" field is a plain
// row-major (H, W) array. The ld helpers read 0 for an out-of-range
// neighbour: the TPU kernels rely on jnp.roll wraparound plus masks, and
// every neighbour a masked-in cell reads lies inside the array anyway.
//
// Local blocks. A sharded quad field (the plane-row decomposition of
// cfd_tpu/parallel/quad_sharded.py) is a device's (4, P + 16, Wqa) block
// whose plane row 0 is the global plane row ``row0``; every j of the
// helpers below stays the global logical row, so masks keep their global
// meaning, and the loads subtract 2 * row0. A neighbour outside the block
// reads 0. row0 is 0 on a whole field.
//
// Reductions. A max of non-negative floats is taken on their int bit
// patterns (same order for non-negative IEEE values; a NaN, sign cleared by
// fabsf, sorts above +inf and so propagates like jnp.max). One warp-shuffle
// + shared-memory pass per block, then one atomicMax into a device scalar
// the host zeroes on the same stream, or into a running max that the last
// block moves out and leaves 0 (carry_tile.cuh fold_max_into, no zeroing
// launch). The TPU kernels carried the running
// max in SMEM across their sequential grid, which Hopper's parallel
// blocks cannot do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cfd {

constexpr int kThreads = 256;

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ long long qidx(int j, int i, int Hq8, int Wqa) {
  return (static_cast<long long>(2 * (j & 1) + (i & 1)) * Hq8 + (j >> 1)) * Wqa +
         (i >> 1);
}

__device__ __forceinline__ float qld(const float* a, int j, int i, int Hq8, int Wqa,
                                    int row0 = 0) {
  j -= 2 * row0;
  return (j >= 0 && j < 2 * Hq8 && i >= 0 && i < 2 * Wqa) ? a[qidx(j, i, Hq8, Wqa)]
                                                          : 0.f;
}

// A quad array read at global logical (j, i) through qld: the accessor the
// stage arithmetic takes (quad_carry.cuh, rb_carry.cuh) where it reads
// device memory; ``c`` is any stage's constants (Hq8, Wqa, row0)
struct QuadRead {
  const float* a;
  int Hq8, Wqa, row0;
  __device__ __forceinline__ float operator()(int j, int i) const {
    return qld(a, j, i, Hq8, Wqa, row0);
  }
};

template <class C>
__device__ __forceinline__ QuadRead quad_read(const float* a, const C& c) {
  return QuadRead{a, c.Hq8, c.Wqa, c.row0};
}

// flat thread index -> (q, J, I) of a quad field -> logical (j, i), j
// global (row0: the global plane row of the block's row 0)
struct QuadCell {
  long long idx;
  int q, j, i;
};

__device__ __forceinline__ QuadCell quad_cell(long long idx, int Hq8, int Wqa,
                                              int row0 = 0) {
  long long plane = static_cast<long long>(Hq8) * Wqa;
  int q = static_cast<int>(idx / plane);
  long long rem = idx - q * plane;
  int J = static_cast<int>(rem / Wqa);
  int I = static_cast<int>(rem - static_cast<long long>(J) * Wqa);
  return {idx, q, 2 * (J + row0) + (q >> 1), 2 * I + (q & 1)};
}

// Whether flat quad index idx of a (4, Hq8, Wqa) array lies in its own plane
// rows [halo, Hq8 - halo): a local block's reductions cover only these
// (halo 8); a whole field (halo 0) owns every row
__device__ __forceinline__ bool own_row(long long idx, int Hq8, int Wqa, int halo) {
  if (halo == 0) return true;
  const int J = static_cast<int>((idx % (static_cast<long long>(Hq8) * Wqa)) / Wqa);
  return J >= halo && J < Hq8 - halo;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max of two values >= 0 (or NaN, which sorts above +inf) on their int bits
__device__ __forceinline__ float bits_max(float a, float b) {
  return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
}

// A pressure-correction coefficient from a traced dt (adaptive stepping) in
// the reference's float32 order: the cavity's rho-multiplied form
// dt * (rho/dx) (cfd_tpu/kernels/quad.py:505, :1080), the channel's, the
// step's and RB's rho-divided form dt / (rho*dx) (quad.py:913,
// step_quad.py:163, rb_quad.py:155). ``factor`` is the float32 rho/dx or
// rho*dx that the host folded in double.
template <bool kDivided>
__device__ __forceinline__ float traced_coeff(float dt, float factor) {
  return kDivided ? dt / factor : dt * factor;
}

// Fixed-order block sum of v into *out: a pairwise tree over the block's
// kThreads values in shared memory (s[t] += s[t + stride], stride =
// kThreads/2 ... 1). Every thread of the block must call it. The order does
// not depend on scheduling, so a plain PyTorch twin that folds the same
// kThreads-wide rows pairwise rounds identically.
__device__ __forceinline__ void block_sum_to(float v, float* out) {
  __shared__ float s[kThreads];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

// One level of the in-place fold of x[0:n] in the order of the PyTorch twin
// fold_sum: x[t] += x[t + h] for t < h = n/2, the odd last element moves
// to x[h]; returns the h + (n & 1) elements left. `first` is the calling
// thread's rank, `step` the number of threads that share the fold; `sync()`
// must be a barrier over exactly those threads. ``x``: a float* or a
// volatile float* (partials that other blocks wrote).
template <class P, class Sync>
__device__ __forceinline__ int fold_level(P x, int n, int first, int step, Sync sync) {
  const int h = n >> 1;
  for (int t = first; t < h; t += step) x[t] = x[t] + x[t + h];
  sync();
  if (n & 1) {
    if (first == 0) x[h] = x[2 * h];
    sync();
  }
  return h + (n & 1);
}

// In-place fold of x[0:n] to its sum, fold_level until one element is left
template <class Sync>
__device__ __forceinline__ float fold_sum(float* x, int n, int first, int step, Sync sync) {
  while (n > 1) n = fold_level(x, n, first, step, sync);
  return x[0];
}

// One block folds partials[0:n] into *sum in the PyTorch twin's fold_sum
// order (the second launch of the first design's block sums; no stage
// launches it since the channel's non-carry stages moved onto the carries'
// sum, carry_tile.cuh source_sum). Defined once, in quad_stage.cu; returns
// the launch's error.
cudaError_t fold_partials(float* partials, int n, float* sum, cudaStream_t stream);

}  // namespace cfd
