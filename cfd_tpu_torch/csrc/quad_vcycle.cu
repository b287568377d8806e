// Finest-level V-cycle kernels on the quad layout.
//
// Replaces cfd_tpu/kernels/quad.py make_quad_pre_smooth_restrict (:630) and
// make_quad_post_prolong_smooth (:700), on a whole field and with
// shard=(P, mdy) on one shard's local block (rows 16b, 16c).
//
// pre:  n red/black pairs, then the residual, then full weighting straight
//       into the aligned level-1 source rc (Hq8, Wqa).
// post: bilinear 9-3-3-1 prolongation of the level-1 correction ec with
//       edge clamps, added on the interior, then n pairs, then max|b - Ap|.
//
// A local block (halo > 0; cfd_tpu/parallel/quad_sharded.py): the arrays are
// a shard's (4, P + 16, Wqa) block, its P own plane rows between two 8-row
// halo strips that the caller refreshes from the neighbouring shards, and
// row_base = jy * P - 8 is the global plane row of local row 0. Every mask,
// band, ghost and weight-vector index keeps its global meaning (row0 =
// row_base, quad_level0.cuh); the row weight vectors are the global ones with
// a `halo`-plane-row zero prefix, so the global row -2 * halo <= j of any
// block reads inside them. A neighbour outside the block reads 0 and a
// residual outside it is 0; the prolongation's row J + 1 wraps within the
// block. What such a read feeds is a halo row, which the next refresh
// replaces: with the 8-row halo the own rows are exact. Half-sweep k updates
// the band of the TPU kernel's single slab (in_band), the post kernel's one
// row further in (quad.py:762-767), and max|b - Ap| covers the own rows
// only: the shard's partial, whose maximum over the shards the caller takes.
// A whole field is halo 0 and row_base 0: every row in every band and owned.
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
// halo and band bookkeeping of the TPU kernels is needed only on a local
// block.
#include "quad_level0.cuh"

namespace {

using cfd::Level0;

// Half-sweep ``lo`` over the planes of `colour` (0 = red = planes {0, 3}).
// src != dst copies the cells it does not update, so the first launch can
// move the iterate into a fresh array; src == dst updates in place.
__global__ void quad_half_sweep(const float* src, float* dst, const float* b, int colour,
                                int lo, Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  cfd::QuadCell c = cfd::quad_cell(idx, L.Hq8, L.Wqa, L.row0);
  if (cfd::quad_updates(c, colour, L) && cfd::in_band((c.j >> 1) - L.row0, lo, L)) {
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

// kBlock: a shard's local block; a whole field's instance folds the row
// offset away at compile time (the run-time offset cost it 3% on the H100)
template <bool kBlock>
__global__ void prolong_add(const float* p, const float* ec, float* out, Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  if constexpr (!kBlock) L.row0 = 0;
  out[idx] = cfd::quad_prolong_add_value(p, ec, idx, L);
}

__global__ void residual_max(const float* p, const float* b, float* res, Level0 L) {
  long long n = 4LL * L.Hq8 * L.Wqa;
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float r = (idx < n && cfd::own_row(idx, L.Hq8, L.Wqa, L.halo))
                ? cfd::quad_abs_residual(p, b, idx, L)
                : 0.f;
  cfd::block_max_into(r, res);
}

// n_pairs red+black pairs on dst (already holding the iterate when
// first_src == dst); the first half-sweep reads first_src; half-sweep k
// (from 1) has band lo = k + shift
int sweep_pairs(const float* first_src, float* dst, const float* b, int n_pairs, int shift,
                const Level0& L, cudaStream_t s) {
  const int blocks = cfd::blocks_for(4LL * L.Hq8 * L.Wqa);
  for (int k = 0; k < n_pairs; ++k) {
    quad_half_sweep<<<blocks, cfd::kThreads, 0, s>>>(k == 0 ? first_src : dst, dst, b, 0,
                                                    2 * k + 1 + shift, L);
    quad_half_sweep<<<blocks, cfd::kThreads, 0, s>>>(dst, dst, b, 1, 2 * k + 2 + shift, L);
  }
  return static_cast<int>(cudaGetLastError());
}

Level0 level(int Hq8, int Wqa, int ny, int nx, float idx2, float idy2, float omega,
             const float* wE, const float* wW, const float* wN, const float* wS,
             int row_base, int halo) {
  // the row vectors' zero prefix: global row j reads element j + 2 * halo
  return Level0{Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN + 2 * halo,
                wS + 2 * halo, row_base, halo};
}

}  // namespace

// row_base, halo: a local block's global plane row of row 0 and its halo
// strip (0, 0 on a whole field); rc: (Hq8, Wqa), the block's level-1 rows
extern "C" int cfd_quad_pre_smooth_restrict(const float* p, const float* b, float* p_out,
                                            float* rc, const float* wE, const float* wW,
                                            const float* wN, const float* wS, int Hq8,
                                            int Wqa, int ny, int nx, float idx2,
                                            float idy2, float omega, int n_pairs,
                                            int row_base, int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level0 L = level(Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, row_base, halo);
  int err = sweep_pairs(p, p_out, b, n_pairs, 0, L, s);
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
                                            int row_base, int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level0 L = level(Hq8, Wqa, ny, nx, idx2, idy2, omega, wE, wW, wN, wS, row_base, halo);
  const int blocks = cfd::blocks_for(4LL * Hq8 * Wqa);
  if (halo > 0) {
    prolong_add<true><<<blocks, cfd::kThreads, 0, s>>>(p, ec, p_out, L);
  } else {
    prolong_add<false><<<blocks, cfd::kThreads, 0, s>>>(p, ec, p_out, L);
  }
  // the prolongation's row J + 1 wraps at a block's top: one more row of
  // shrink before the sweeps (quad.py:764-767)
  int err = sweep_pairs(p_out, p_out, b, n_pairs, 1, L, s);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(res, 0, sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  residual_max<<<blocks, cfd::kThreads, 0, s>>>(p_out, b, res, L);
  return static_cast<int>(cudaGetLastError());
}
