// The backward step's exact masked finest-level smoother on the natural
// layout.
//
// Replaces cfd_tpu/kernels/step_smoother.py make_step_masked_pairs (:45) in
// its three variants: the plain pairs, with_residual_field (the V-cycle's
// pre-smooth and restriction input) and with_residual (the post-smooth and
// tolerance check). Each pair is the exact reference operator of
// cfd_tpu/poisson/multigrid.py smooth0 (:993-1008): a pressure-ghost
// refresh (the channel domain ghosts, then each solid cell with a fluid
// neighbour set to the mean of its fluid neighbours,
// backwards_step-01.cpp:685-740), then a red and a black half-sweep over
// the fluid cells; one more ghost refresh follows the last pair. The
// residual variants take b - lap over the fluid cells of the refreshed
// state refreshed once more (residual0, :1010-1014).
//
// Layout: the logical (ny+2, nx+2) float32 array, row-major. The geometry
// is the reference's single solid rectangle {i <= step_i, j > inlet_j_max}
// (backwards_step-01.cpp:499-520); every mask comes from the indices.
//
// Bound on the H100: launch latency at the natural sizes (a 32x640 level
// is 20k cells, microseconds of work a launch), device-memory bytes at
// large ones (each phase reads p and b and writes p).
//
// Design: one launch per dependent phase (ghosts, red, black), one thread
// per cell. The TPU kernel ran all pairs in one VMEM slab whose valid band
// shrinks by three rows a pair (step_smoother.py:66-72); a thread per cell
// with a launch per phase needs no band. A ghost refresh reads only
// interior cells (the domain ghosts read row 1, row ny, column 1; the solid
// mean reads the fluid cells east of the solid column and below the solid
// block), but a domain ghost may read a solid cell that the same refresh
// averages, so the refresh writes into the other of two buffers (the
// input, `scratch` and `out` ping-pong; the last refresh lands in `out`).
// The half-sweeps update their colour in place (a cell reads only the other
// colour). The residual recomputes the extra ghost refresh on read.
//
// The solid mean is (east + south) * (1 / count) with the absent neighbour
// as 0, the TPU kernel's form (step_smoother.py:147-152); it equals the
// reference's weighted form (cfd_tpu/bc.py step_pressure_ghosts) up to the
// sign of a zero. The half-sweep divides by 2 (idx2 + idy2) as the
// reference does (step_smoother.py:157-159), never multiplies by its
// reciprocal.
#include "common.cuh"

namespace {

struct Step {
  int H, W, ny, nx, step_i, inlet_j;
  float idx2, idy2, omega, one_m_omega, denom;
};

__device__ __forceinline__ bool solid(int j, int i, const Step& s) {
  return i <= s.step_i && j > s.inlet_j;
}

__device__ __forceinline__ bool fluid(int j, int i, const Step& s) {
  return j >= 1 && j <= s.ny && i >= 1 && i <= s.nx && !solid(j, i, s);
}

__device__ __forceinline__ float at(const float* p, int j, int i, const Step& s) {
  return p[static_cast<long long>(j) * s.W + i];
}

// p at (j, i) after one ghost refresh of p: the domain ghosts (column 0
// copies column 1, column nx+1 is 0, on rows 1..ny; row 0 copies row 1,
// row ny+1 copies row ny, on columns 1..nx), then the solid mean (east:
// the solid column's east face, i = step_i < nx; south: the solid block's
// bottom row, j = inlet_j + 1 > 1). Corners keep p.
__device__ __forceinline__ float ghosted(const float* p, int j, int i, const Step& s) {
  const bool row_in = j >= 1 && j <= s.ny, col_in = i >= 1 && i <= s.nx;
  if (i == 0 && row_in) return at(p, j, 1, s);
  if (i == s.nx + 1 && row_in) return 0.f;
  if (j == 0 && col_in) return at(p, 1, i, s);
  if (j == s.ny + 1 && col_in) return at(p, s.ny, i, s);
  if (row_in && col_in && solid(j, i, s)) {
    const bool east = i == s.step_i && i < s.nx;
    const bool south = j == s.inlet_j + 1 && j > 1;
    if (east || south) {
      const float cnt = (east ? 1.0f : 0.0f) + (south ? 1.0f : 0.0f);
      const float sum = (east ? at(p, j, i + 1, s) : 0.0f) + (south ? at(p, j - 1, i, s) : 0.0f);
      return sum * (1.0f / cnt);
    }
  }
  return at(p, j, i, s);
}

__global__ void ghost_kernel(const float* src, float* dst, Step s) {
  const long long n = static_cast<long long>(s.H) * s.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx / s.W);
  const int i = static_cast<int>(idx - static_cast<long long>(j) * s.W);
  dst[idx] = ghosted(src, j, i, s);
}

// half-sweep of colour (0 = red = (i + j) even) over the fluid cells, in place
__global__ void sweep_kernel(float* p, const float* b, int colour, Step s) {
  const long long n = static_cast<long long>(s.H) * s.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx / s.W);
  const int i = static_cast<int>(idx - static_cast<long long>(j) * s.W);
  if (((j + i) & 1) != colour || !fluid(j, i, s)) return;
  const float gs = (s.idx2 * (at(p, j, i + 1, s) + at(p, j, i - 1, s)) +
                    s.idy2 * (at(p, j + 1, i, s) + at(p, j - 1, i, s)) - b[idx]) /
                   s.denom;
  p[idx] = s.one_m_omega * p[idx] + s.omega * gs;
}

// r = b - lap(ghosted p) on the fluid cells, 0 elsewhere (r may be null);
// res_max: max|r| (may be null). Every thread reaches the block reduction.
__global__ void residual_kernel(const float* p, const float* b, float* r, float* res_max,
                                Step s) {
  const long long n = static_cast<long long>(s.H) * s.W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float rv = 0.f;
  if (idx < n) {
    const int j = static_cast<int>(idx / s.W);
    const int i = static_cast<int>(idx - static_cast<long long>(j) * s.W);
    if (fluid(j, i, s)) {
      const float pc = ghosted(p, j, i, s);
      const float lap = (ghosted(p, j, i + 1, s) - 2.0f * pc + ghosted(p, j, i - 1, s)) * s.idx2 +
                        (ghosted(p, j + 1, i, s) - 2.0f * pc + ghosted(p, j - 1, i, s)) * s.idy2;
      rv = b[idx] - lap;
    }
    if (r != nullptr) r[idx] = rv;
  }
  if (res_max != nullptr) cfd::block_max_into(fabsf(rv), res_max);
}

}  // namespace

// p, b: (H, W) = (ny+2, nx+2); out, scratch: (H, W) buffers (p is not
// written); r: null unless with_residual_field; res_max: null unless
// with_residual (one float, zeroed here). one_m_omega, denom: the host's
// 1 - omega and 2 (idx2 + idy2), rounded to float32.
extern "C" int cfd_step_pairs(const float* p, const float* b, float* out, float* scratch,
                              float* r, float* res_max, int H, int W, int ny, int nx,
                              int step_i, int inlet_j, float idx2, float idy2, float omega,
                              float one_m_omega, float denom, int n_pairs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Step s{H, W, ny, nx, step_i, inlet_j, idx2, idy2, omega, one_m_omega, denom};
  const int blocks = cfd::blocks_for(static_cast<long long>(H) * W);
  float* bufs[2] = {out, scratch};
  const int refreshes = n_pairs + 1;  // the last one writes out
  const float* src = p;
  for (int g = 0; g < refreshes; ++g) {
    float* dst = bufs[(refreshes - 1 - g) & 1];
    ghost_kernel<<<blocks, cfd::kThreads, 0, st>>>(src, dst, s);
    if (g < n_pairs) {
      sweep_kernel<<<blocks, cfd::kThreads, 0, st>>>(dst, b, 0, s);
      sweep_kernel<<<blocks, cfd::kThreads, 0, st>>>(dst, b, 1, s);
    }
    src = dst;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r == nullptr && res_max == nullptr) return 0;
  if (res_max != nullptr) {
    err = cudaMemsetAsync(res_max, 0, sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  residual_kernel<<<blocks, cfd::kThreads, 0, st>>>(out, b, r, res_max, s);
  return static_cast<int>(cudaGetLastError());
}
