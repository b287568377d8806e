// Finest-level V-cycle kernels of the backward step on the quad layout.
//
// Replaces cfd_tpu/kernels/step_quad.py make_quad_step_pre_smooth_restrict
// (:354) and make_quad_step_post_prolong_smooth (:419).
//
// pre:  n exact masked pairs (ghost stage, red, black), the trailing ghost
//       stage, then the exact residual (ghosts re-applied) restricted by
//       full weighting into the aligned level-1 source rc (Hq8, Wqa).
// post: the bilinear prolongation of the solid-filled level-1 correction
//       added on FLUID cells, n exact pairs, the trailing ghost stage, then
//       max|exact residual| over the fluid cells.
//
// Bound on the H100: device-memory bytes and, at 2048x256 (2.5 MB quad
// fields, all in L2), launch latency: a V(1,2) cycle is 10 launches of a
// few microseconds each.
//
// Design (step_level0.cuh): a ghost stage reads one array and writes
// another, so each pair is two launches, the ghost stage fused with the red
// half-sweep into the other buffer (each red update evaluates the ghost
// stage of its neighbours on the fly), then the black half-sweep in place.
// The trailing ghost stage is a launch of its own; the residual applies the
// stage again on the fly. The iterate alternates between the output array
// and a scratch array so that the last stage lands in the output; the
// caller's input is never written.
#include "step_level0.cuh"

namespace {

using cfd::StepL0;

__global__ void step_ghost_red(const float* src, const float* b, float* dst, StepL0 L) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  dst[idx] = cfd::ghost_red_value(src, b, cfd::quad_cell(idx, L.Hq8, L.Wqa), L);
}

__global__ void step_black(float* p, const float* b, StepL0 L) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float v;
  if (cfd::black_update(p, b, cfd::quad_cell(idx, L.Hq8, L.Wqa), L, &v)) p[idx] = v;
}

__global__ void step_ghosts(const float* src, float* dst, StepL0 L) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa);
  dst[idx] = cfd::ghost_value(src, c.j, c.i, L);
}

__global__ void step_residual_restrict(const float* p, const float* b, float* rc, StepL0 L) {
  const long long n = static_cast<long long>(L.Hq8) * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  rc[idx] = cfd::step_restrict_value(p, b, idx, L);
}

__global__ void step_prolong_add(const float* p, const float* ec, float* out, StepL0 L) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  out[idx] = cfd::step_prolong_add_value(p, ec, idx, L);
}

__global__ void step_residual_max(const float* p, const float* b, float* res, StepL0 L) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float r = 0.f;
  if (idx < n) {
    const cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa);
    r = fabsf(cfd::step_residual(p, b, c.j, c.i, L));
  }
  cfd::block_max_into(r, res);
}

// `stages` ghost-stage writes follow, each into the other buffer; the
// buffer to write first so that the last write lands in out
float* first_target(int stages, float* out, float* scr) {
  return (stages % 2 == 1) ? out : scr;
}

// n pairs from src (never written) and the trailing ghost stage into out
int smooth(const float* src, const float* b, float* out, float* scr, int n_pairs,
           const StepL0& L, cudaStream_t s) {
  const int blocks = cfd::blocks_for(4LL * L.Hq8 * L.Wqa);
  float* dst = first_target(n_pairs + 1, out, scr);
  for (int k = 0; k < n_pairs; ++k) {
    step_ghost_red<<<blocks, cfd::kThreads, 0, s>>>(src, b, dst, L);
    step_black<<<blocks, cfd::kThreads, 0, s>>>(dst, b, L);
    src = dst;
    dst = (dst == out) ? scr : out;
  }
  step_ghosts<<<blocks, cfd::kThreads, 0, s>>>(src, dst, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scr: one quad field of scratch
extern "C" int cfd_step_pre_smooth_restrict(const float* p, const float* b, float* p_out,
                                            float* scr, float* rc, int Hq8, int Wqa, int ny,
                                            int nx, int step_i, int inlet_j, float idx2,
                                            float idy2, float denom, float omega,
                                            float one_minus_omega, int n_pairs,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepL0 L{Hq8, Wqa, ny, nx, step_i, inlet_j, idx2, idy2, denom, omega, one_minus_omega};
  int err = smooth(p, b, p_out, scr, n_pairs, L, s);
  if (err) return err;
  step_residual_restrict<<<cfd::blocks_for(static_cast<long long>(Hq8) * Wqa),
                           cfd::kThreads, 0, s>>>(p_out, b, rc, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cfd_step_post_prolong_smooth(const float* p, const float* b, const float* ec,
                                            float* p_out, float* scr, float* res, int Hq8,
                                            int Wqa, int ny, int nx, int step_i,
                                            int inlet_j, float idx2, float idy2,
                                            float denom, float omega,
                                            float one_minus_omega, int n_pairs,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepL0 L{Hq8, Wqa, ny, nx, step_i, inlet_j, idx2, idy2, denom, omega, one_minus_omega};
  const int blocks = cfd::blocks_for(4LL * Hq8 * Wqa);
  // the prolonged iterate goes to the buffer the smoothing does not write
  // first, so that its first ghost stage reads one array and writes another
  float* prolonged = first_target(n_pairs + 1, p_out, scr) == p_out ? scr : p_out;
  step_prolong_add<<<blocks, cfd::kThreads, 0, s>>>(p, ec, prolonged, L);
  int err = smooth(prolonged, b, p_out, scr, n_pairs, L, s);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(res, 0, sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_residual_max<<<blocks, cfd::kThreads, 0, s>>>(p_out, b, res, L);
  return static_cast<int>(cudaGetLastError());
}
