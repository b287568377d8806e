// Shared device helpers for the cfd_tpu_torch kernels.
//
// Layouts. A "quad" field is the (4, Hq8, Wqa) float32 block-parity layout
// of cfd_tpu.kernels.quad: logical cell (j, i) lives in plane
// 2*(j&1) + (i&1), row j>>1, column i>>1. A "natural" field is a plain
// row-major (H, W) array. The ld helpers read 0 for an out-of-range
// neighbour: the TPU kernels rely on jnp.roll wraparound plus masks, and
// every neighbour a masked-in cell reads lies inside the array anyway.
//
// Reductions. A max of non-negative floats is taken on their int bit
// patterns (same order for non-negative IEEE values; a NaN, sign cleared by
// fabsf, sorts above +inf and so propagates like jnp.max). One warp-shuffle
// + shared-memory pass per block, then one atomicMax into a device scalar
// the host zeroes on the same stream. The TPU kernels carried the running
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

__device__ __forceinline__ float qld(const float* a, int j, int i, int Hq8, int Wqa) {
  return (j >= 0 && j < 2 * Hq8 && i >= 0 && i < 2 * Wqa) ? a[qidx(j, i, Hq8, Wqa)]
                                                          : 0.f;
}

// flat thread index -> (q, J, I) of a quad field -> logical (j, i)
struct QuadCell {
  long long idx;
  int q, j, i;
};

__device__ __forceinline__ QuadCell quad_cell(long long idx, int Hq8, int Wqa) {
  long long plane = static_cast<long long>(Hq8) * Wqa;
  int q = static_cast<int>(idx / plane);
  long long rem = idx - q * plane;
  int J = static_cast<int>(rem / Wqa);
  int I = static_cast<int>(rem - static_cast<long long>(J) * Wqa);
  return {idx, q, 2 * J + (q >> 1), 2 * I + (q & 1)};
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

// Block-wide max of v >= 0 into *out (as int bits). Every thread of the
// block must call it.
__device__ __forceinline__ void block_max_into(float v, float* out) {
  __shared__ int warp_max[kThreads / 32];
  int x = __float_as_int(v);
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_down_sync(0xffffffffu, x, o));
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (kThreads / 32) ? warp_max[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(out), x);
  }
}

}  // namespace cfd
