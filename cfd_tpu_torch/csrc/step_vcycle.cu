// Finest-level V-cycle kernels of the backward step on the quad layout.
//
// Replaces cfd_tpu/kernels/step_quad.py make_quad_step_pre_smooth_restrict
// (:354) and make_quad_step_post_prolong_smooth (:419), on a whole field
// and with shard=(P, mdy) on one shard's local block (row 16f).
//
// pre:  n exact masked pairs (ghost stage, red, black), the trailing ghost
//       stage, then the exact residual (ghosts re-applied) restricted by
//       full weighting into the aligned level-1 source rc (Hq8, Wqa).
// post: the bilinear prolongation of the solid-filled level-1 correction
//       added on FLUID cells, n exact pairs, the trailing ghost stage, then
//       max|exact residual| over the fluid cells.
//
// A local block (halo > 0; cfd_tpu/parallel/quad_sharded.py): the arrays
// are a shard's (4, P + 16, Wqa) block, its P own plane rows between two
// 8-row halo strips that the caller refreshes, and row_base = jy * P - 8 is
// the global plane row of local row 0 (step_level0.cuh: every mask, ghost
// and interface keeps its global meaning, a neighbour outside the block
// reads 0, a residual outside it is 0). The stages are banded as the TPU
// kernel's single slab (step_quad.py:305-336): stage k of the ledger (the
// ghost stage, red, black of each pair, the trailing ghost stage, the
// residual's ghost stage) writes only the rows of band k, which starts one
// row further in for the post kernel (its prolongation's row J + 1 wraps
// within the block, :471-474). At V(1,1) the pre kernel's ledger reaches
// 3 + 2 stages, then the residual's stencil and the restriction's row
// below: 7 of the 8 halo rows; the post kernel's one more. Only n_pairs = 1
// fits, as the reference's factories enforce. The level-1 source of the
// block's rows and the own rows' max|r| (the shard's partial) are the
// outputs. A whole field is halo 0 and row_base 0: every row in every band,
// and its instances fold the offset away at compile time (kBlock).
//
// Bound on the H100: device-memory bytes and, at 2048x256 (2.5 MB quad
// fields, all in L2), launch latency: a V(1,2) cycle is 10 launches of a
// few microseconds each; a shard's block at 2048x256 on 4 shards (0.55 MB)
// is launch-bound outright.
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

// ghost stage ``lo`` fused with red half-sweep ``lo + 1``, src -> dst
template <bool kBlock>
__global__ void step_ghost_red(const float* src, const float* b, float* dst, StepL0 L,
                               int lo) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa, cfd::step_row0<kBlock>(L));
  dst[idx] = cfd::ghost_red_value<kBlock>(src, b, c, L, lo);
}

// black half-sweep ``lo`` in place
template <bool kBlock>
__global__ void step_black(float* p, const float* b, StepL0 L, int lo) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa, cfd::step_row0<kBlock>(L));
  float v;
  if (cfd::black_update<kBlock>(p, b, c, L, &v, lo)) p[idx] = v;
}

// ghost stage ``lo``, src -> dst
template <bool kBlock>
__global__ void step_ghosts(const float* src, float* dst, StepL0 L, int lo) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa, cfd::step_row0<kBlock>(L));
  dst[idx] = cfd::banded_ghost<kBlock>(src, c.j, c.i, lo, L);
}

// the residual with ghost stage ``lo``, restricted into rc
template <bool kBlock>
__global__ void step_residual_restrict(const float* p, const float* b, float* rc, StepL0 L,
                                       int lo) {
  const long long n = static_cast<long long>(L.Hq8) * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  rc[idx] = cfd::step_restrict_value<kBlock>(p, b, idx, L, lo);
}

template <bool kBlock>
__global__ void step_prolong_add(const float* p, const float* ec, float* out, StepL0 L) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  out[idx] = cfd::step_prolong_add_value<kBlock>(p, ec, idx, L);
}

// max|residual| with ghost stage ``lo`` over the block's own rows
template <bool kBlock>
__global__ void step_residual_max(const float* p, const float* b, float* res, StepL0 L,
                                  int lo) {
  const long long n = 4LL * L.Hq8 * L.Wqa;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float r = 0.f;
  if (idx < n && (!kBlock || cfd::own_row(idx, L.Hq8, L.Wqa, L.halo))) {
    const cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa, cfd::step_row0<kBlock>(L));
    r = fabsf(cfd::step_residual<kBlock>(p, b, c.j, c.i, L, lo));
  }
  cfd::block_max_into(r, res);
}

// `stages` ghost-stage writes follow, each into the other buffer; the
// buffer to write first so that the last write lands in out
float* first_target(int stages, float* out, float* scr) {
  return (stages % 2 == 1) ? out : scr;
}

// n pairs from src (never written) and the trailing ghost stage into out;
// stage k of the ledger (from 1) has band k + shift. Returns the ledger
// count of the trailing ghost stage.
template <bool kBlock>
int smooth(const float* src, const float* b, float* out, float* scr, int n_pairs, int shift,
           const StepL0& L, cudaStream_t s, int* err) {
  const int blocks = cfd::blocks_for(4LL * L.Hq8 * L.Wqa);
  float* dst = first_target(n_pairs + 1, out, scr);
  int k = shift;
  for (int pair = 0; pair < n_pairs; ++pair) {
    step_ghost_red<kBlock><<<blocks, cfd::kThreads, 0, s>>>(src, b, dst, L, k + 1);
    step_black<kBlock><<<blocks, cfd::kThreads, 0, s>>>(dst, b, L, k + 3);
    k += 3;
    src = dst;
    dst = (dst == out) ? scr : out;
  }
  step_ghosts<kBlock><<<blocks, cfd::kThreads, 0, s>>>(src, dst, L, k + 1);
  *err = static_cast<int>(cudaGetLastError());
  return k + 1;
}

template <bool kBlock>
int pre(const float* p, const float* b, float* p_out, float* scr, float* rc, int n_pairs,
        const StepL0& L, cudaStream_t s) {
  int err = 0;
  const int k = smooth<kBlock>(p, b, p_out, scr, n_pairs, 0, L, s, &err);
  if (err) return err;
  step_residual_restrict<kBlock><<<cfd::blocks_for(static_cast<long long>(L.Hq8) * L.Wqa),
                                   cfd::kThreads, 0, s>>>(p_out, b, rc, L, k + 1);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int post(const float* p, const float* b, const float* ec, float* p_out, float* scr,
         float* res, int n_pairs, const StepL0& L, cudaStream_t s) {
  const int blocks = cfd::blocks_for(4LL * L.Hq8 * L.Wqa);
  // the prolonged iterate goes to the buffer the smoothing does not write
  // first, so that its first ghost stage reads one array and writes another
  float* prolonged = first_target(n_pairs + 1, p_out, scr) == p_out ? scr : p_out;
  step_prolong_add<kBlock><<<blocks, cfd::kThreads, 0, s>>>(p, ec, prolonged, L);
  // the prolongation's row J + 1 wraps at a block's top: one more row of
  // shrink before the stages (step_quad.py:471-474)
  int err = 0;
  const int k = smooth<kBlock>(prolonged, b, p_out, scr, n_pairs, 1, L, s, &err);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(res, 0, sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  step_residual_max<kBlock><<<blocks, cfd::kThreads, 0, s>>>(p_out, b, res, L, k + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scr: one quad field of scratch; row_base, halo: a local block's global
// plane row of row 0 and its halo strip (0, 0 on a whole field); rc: (Hq8,
// Wqa), the block's level-1 rows
extern "C" int cfd_step_pre_smooth_restrict(const float* p, const float* b, float* p_out,
                                            float* scr, float* rc, int Hq8, int Wqa, int ny,
                                            int nx, int step_i, int inlet_j, float idx2,
                                            float idy2, float denom, float omega,
                                            float one_minus_omega, int n_pairs,
                                            int row_base, int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepL0 L{Hq8,  Wqa,   ny,    nx,    step_i,          inlet_j,
           idx2, idy2,  denom, omega, one_minus_omega, row_base, halo};
  if (halo > 0) return pre<true>(p, b, p_out, scr, rc, n_pairs, L, s);
  return pre<false>(p, b, p_out, scr, rc, n_pairs, L, s);
}

// res: max|r| over the own rows of a block (every row of a whole field)
extern "C" int cfd_step_post_prolong_smooth(const float* p, const float* b, const float* ec,
                                            float* p_out, float* scr, float* res, int Hq8,
                                            int Wqa, int ny, int nx, int step_i,
                                            int inlet_j, float idx2, float idy2,
                                            float denom, float omega,
                                            float one_minus_omega, int n_pairs,
                                            int row_base, int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepL0 L{Hq8,  Wqa,   ny,    nx,    step_i,          inlet_j,
           idx2, idy2,  denom, omega, one_minus_omega, row_base, halo};
  if (halo > 0) return post<true>(p, b, ec, p_out, scr, res, n_pairs, L, s);
  return post<false>(p, b, ec, p_out, scr, res, n_pairs, L, s);
}
