"""The launch plan of the cavity's fused-pre carry (kernels/plan.py
fused_pre_plan, csrc/quad_fused_pre.cu: row 7) and a torch mirror of its
two tile phases against the unedited plain twin
(kernels/quad.py QuadCorrPredictorSourceFusedPre.plain: the carry twin,
then the pre twin), on the CPU.

Phase A of the mirror runs what a block of the kernel runs on each carry
tile (csrc/quad_carry.cuh cavity_tile), in the logical layout: us, vs, p
with the plan's halo (0 outside the array); the corrected u, v with the
lid ghosts on box A (the own region widened 2 rows south, 1 north, 2
columns west, 1 east; 0 outside the array); u*, v* on box B (1 south, 1
west; 0 off the valid faces); then us', vs', b = rho/dt div on the cells
and the warm start 2p - p_prev of the own cells. Every position outside a
stage's box is poisoned with NaN, so a read past it would show. The
blocks' max|b| is the max over the own cells. Phase B is the separable
pre tiles' mirror (test_torch_sep_level0_plan.SepMirror) from phase A's
warm start and b under the plan's pre tiles. The mirror is held to the
twin bit for bit (torch.equal) at n_pairs 1-3, under the plan's carry
tile and under tiles whose edges fall on the last interior row and
column."""

import re

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels._build import CSRC
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.poisson import multigrid as TM

from test_torch_level0_plan import _covered_once, _logical, _quad, _shift
from test_torch_sep_level0_plan import SepMirror

torch.set_num_threads(1)

# ------------------------------------------------------------------ the plan

# the 2048^2 cavity's quad field (the main path) and small ones
MAIN = (4, 1032, 1152)


@pytest.mark.parametrize("n_pairs", [1, 2, 3])
@pytest.mark.parametrize("qshape", [MAIN, (4, 40, 128), (4, 24, 128)])
def test_fused_pre_plan_joins_the_carry_and_the_pre_plans(qshape, n_pairs):
    pl = PL.fused_pre_plan(qshape, n_pairs)
    buffers = PL.FUSED_PRE_INPUT_SETS * PL.CARRY_INPUTS["cavity"] + PL.WORK_BUFFERS
    assert buffers == 8
    assert pl.carry == PL.carry_plan("cavity", qshape, PL.FUSED_PRE_TILE, buffers=buffers)
    assert pl.carry.halo == 3  # ceil(CARRY_RADIUS 5 / 2) plane rows
    assert pl.pre == PL.level0_plan(qshape, n_pairs, False, masked=False)
    assert pl.pre.halo == n_pairs + 1
    assert pl.smem_bytes == max(pl.carry.smem_bytes, pl.pre.smem_bytes) <= PL.SMEM_MAX
    assert pl.blocks == 0  # the module's readying sets the card's co-residency
    ints = list(pl.c_ints())
    assert ints == [pl.carry.rows, pl.carry.cols, pl.carry.halo, pl.carry.smem_bytes,
                    pl.carry.grid_x, pl.carry.grid_y, pl.pre.rows, pl.pre.cols, pl.pre.halo,
                    pl.pre.smem_bytes, pl.pre.grid_x, pl.pre.grid_y, pl.smem_bytes, 0]
    assert _covered_once(pl.carry, qshape) and _covered_once(pl.pre, qshape)


def test_two_blocks_an_sm_fit_at_the_main_shape():
    # 228 KB of shared memory an SM, 1 KB of it reserved a block; the
    # kernel's launch bounds hold 512 threads to 64 registers, two an SM
    pl = PL.fused_pre_plan(MAIN, 2)
    src = (CSRC / "quad_fused_pre.cu").read_text()
    per_sm = int(re.search(r"constexpr int kBlocksPerSM = (\d+);", src).group(1))
    assert per_sm == 2
    assert per_sm * (pl.smem_bytes + 1024) <= 233_472


def test_one_grid_barrier_in_the_source():
    src = (CSRC / "quad_fused_pre.cu").read_text()
    code = "\n".join(l.split("//")[0] for l in src.splitlines())
    assert code.count("grid.sync()") == PL.FUSED_PRE_BARRIERS == 1
    assert "cudaMemset" not in code


@pytest.mark.parametrize("tile", [(8, 64), (3, 5), (11, 11), (50, 20)])
def test_fused_pre_plan_takes_other_carry_tiles(tile):
    qshape = (4, 40, 128)
    pl = PL.fused_pre_plan(qshape, 2, tile=tile)
    assert (pl.carry.rows, pl.carry.cols) == (min(tile[0], 40), min(tile[1], 128))
    assert pl.pre == PL.fused_pre_plan(qshape, 2).pre
    assert _covered_once(pl.carry, qshape)


def test_fused_pre_plan_refuses_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        PL.fused_pre_plan(MAIN, 2, tile=(32, 64))
    PL.fused_pre_plan(MAIN, 2, tile=(16, 64))  # fits: one block an SM


# ---------------------------------------------------------------- the mirror


def _region(a, r0, c0, LR, LC):
    """a's rows [r0, r0 + LR) x columns [c0, c0 + LC), 0 outside a."""
    R, C = a.shape
    out = torch.zeros(LR, LC, dtype=torch.float32)
    j0, j1, i0, i1 = max(r0, 0), min(r0 + LR, R), max(c0, 0), min(c0 + LC, C)
    if j0 < j1 and i0 < i1:
        out[j0 - r0 : j1 - r0, i0 - c0 : i1 - c0] = a[j0:j1, i0:i1]
    return out


def _in_box(new, r0, r1, c0, c1):
    """new on local rows [r0, r1) x columns [c0, c1), NaN elsewhere."""
    out = torch.full_like(new, float("nan"))
    out[r0:r1, c0:c1] = new[r0:r1, c0:c1]
    return out


def _predictor(u, v, c: StencilCoeffs):
    """kernels/quad.py _predictor_quad's arithmetic on a logical buffer,
    NaN past its edge."""
    nu, dt, idx, idy, idx2, idy2 = c.viscosity, c.dt, c.idx, c.idy, c.idx2, c.idy2
    uE, uW, uN, uS = _shift(u, 0, 1), _shift(u, 0, -1), _shift(u, 1, 0), _shift(u, -1, 0)
    vE, vW, vN, vS = _shift(v, 0, 1), _shift(v, 0, -1), _shift(v, 1, 0), _shift(v, -1, 0)
    vSE, uNW = _shift(v, -1, 1), _shift(u, 1, -1)
    lap_u = (uE - 2.0 * u + uW) * idx2 + (uN - 2.0 * u + uS) * idy2
    u_e = 0.5 * (u + uE)
    u_w = 0.5 * (uW + u)
    conv_ux = (u_e * u_e - u_w * u_w) * idx
    v_n = 0.5 * (v + vE)
    v_s = 0.5 * (vS + vSE)
    u_n = 0.5 * (uN + u)
    u_s = 0.5 * (uS + u)
    conv_uy = (v_n * u_n - v_s * u_s) * idy
    us = u + dt * (nu * lap_u - conv_ux - conv_uy)
    lap_v = (vE - 2.0 * v + vW) * idx2 + (vN - 2.0 * v + vS) * idy2
    v_nn = 0.5 * (v + vN)
    v_ss = 0.5 * (vS + v)
    conv_vy = (v_nn * v_nn - v_ss * v_ss) * idy
    u_e2 = 0.5 * (u + uN)
    u_w2 = 0.5 * (uW + uNW)
    v_e2 = 0.5 * (v + vE)
    v_w2 = 0.5 * (vW + v)
    conv_vx = (u_e2 * v_e2 - u_w2 * v_w2) * idx
    return us, v + dt * (nu * lap_v - conv_vy - conv_vx)


def carry_mirror(op, us, vs, p, p_prev, pl):
    """Phase A (cfd::quad::cavity_tile on each tile of ``pl``, a carry
    plan) in torch: (us', vs', b, guess, max|b|) in the quad layout."""
    _, Hq8, Wqa = op.qshape
    ny, nx = op.ny, op.nx
    U, V, P, PP = (_logical(a) for a in (us, vs, p, p_prev))
    outs = [torch.full_like(U, float("nan")) for _ in range(4)]
    max_b = torch.zeros(())
    h, o = pl.halo, 2 * pl.halo
    for R0, C0, rows, cols in PL.carry_tiles(pl, op.qshape):
        aj, ai = 2 * (R0 - h), 2 * (C0 - h)
        LR, LC = 2 * (pl.rows + 2 * h), 2 * (pl.cols + 2 * h)
        su, sv, sp = (_region(a, aj, ai, LR, LC) for a in (U, V, P))
        gj = (aj + torch.arange(LR))[:, None].expand(LR, LC)
        gi = (ai + torch.arange(LC))[None, :].expand(LR, LC)
        in_array = (gj >= 0) & (gj < 2 * Hq8) & (gi >= 0) & (gi < 2 * Wqa)
        u_valid = (gj >= 1) & (gj <= ny) & (gi >= 1) & (gi <= nx - 1)
        v_valid = (gj >= 1) & (gj <= ny - 1) & (gi >= 1) & (gi <= nx)
        zero = torch.zeros_like(su)
        # the corrected u, v with the lid ghosts on box A
        uc = torch.where(u_valid, su - op.cu * (_shift(sp, 0, 1) - sp), zero)
        vc = torch.where(v_valid, sv - op.cv * (_shift(sp, 1, 0) - sp), zero)
        u = torch.where((gj == ny + 1) & (gi <= nx), 2.0 * op.lid - _shift(uc, -1, 0),
                        torch.where((gj == 0) & (gi <= nx), -_shift(uc, 1, 0), uc))
        v = torch.where((gi == 0) & (gj <= ny), -_shift(vc, 0, 1),
                        torch.where((gi == nx + 1) & (gj <= ny), -_shift(vc, 0, -1), vc))
        A = (o - 2, o + 2 * rows + 1, o - 2, o + 2 * cols + 1)
        u = _in_box(torch.where(in_array, u, zero), *A)
        v = _in_box(torch.where(in_array, v, zero), *A)
        # u*, v* on box B, 0 off the valid faces
        ps, qs = _predictor(u, v, op.coeffs)
        B = (o - 1, o + 2 * rows, o - 1, o + 2 * cols)
        s_us = _in_box(torch.where(u_valid, ps, zero), *B)
        s_vs = _in_box(torch.where(v_valid, qs, zero), *B)
        # the own cells
        div = ((s_us - _shift(s_us, 0, -1)) * op.coeffs.idx
               + (s_vs - _shift(s_vs, -1, 0)) * op.coeffs.idy)
        cell = (gj >= 1) & (gj <= ny) & (gi >= 1) & (gi <= nx)
        b = torch.where(cell, op.rho_dt * div, zero)
        mine = (slice(o, o + 2 * rows), slice(o, o + 2 * cols))
        own = (slice(2 * R0, 2 * (R0 + rows)), slice(2 * C0, 2 * (C0 + cols)))
        for out, val in zip(outs, (s_us, s_vs, b)):
            out[own] = val[mine]
        outs[3][own] = 2.0 * P[own] - PP[own]
        max_b = torch.maximum(max_b, b[mine].abs().max())
    for out in outs:
        assert bool(torch.isfinite(out).all()), "a tile wrote a poisoned cell"
    return (*(_quad(a) for a in outs), max_b)


def mirror(op, us, vs, p, p_prev, pl):
    """The kernel in torch: phase A on pl.carry, phase B on pl.pre."""
    us2, vs2, b, guess, max_b = carry_mirror(op, us, vs, p, p_prev, pl.carry)
    p1, rc = SepMirror(op.pre, pl.pre).pre(guess, b)
    return us2, vs2, b, p1, rc, max_b


def _op(n, n_pairs, omega=1.0):
    shape = (n + 2, n + 2)
    h = 1.0 / n
    coarse = TM._round_up8_128((n // 2 + 2, n // 2 + 2))
    pre = TQ.make_quad_pre_smooth_restrict(shape, TM.cavity_problem(n, n, h, h), omega,
                                           n_pairs, coarse)
    coeffs = StencilCoeffs(dx=h, dy=h, dt=0.25 * h, viscosity=1e-3, density=1.0)
    return TQ.QuadCorrPredictorSourceFusedPre(shape, coeffs, pre), shape


def _fields(shape, seed):
    """us, vs with ghosts; p, p_prev zero on the ghosts (the carried state)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(4):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k >= 2:
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(TQ.to_quad(torch.from_numpy(a), shape))
    return out


# (n, n_pairs, omega, carry tile): the cavity's V(2,1) pre at omega 1 and
# the others; tiles: the plan's; (11, 11): at 64^2 (plane rows 0..32 hold
# the interior and the ghost row) a tile row ends on plane row 32, the
# last interior row's, and a tile column on the last interior column's;
# (8, 64): carry_plan's cavity tile; (3, 5): ragged, many tiles
CASES = [(64, 2, 1.0, None), (64, 2, 1.0, (11, 11)), (64, 1, 1.0, (8, 64)),
         (64, 3, 1.15, (3, 5)), (32, 2, 1.0, (3, 5)), (48, 1, 1.0, None)]


@pytest.mark.parametrize("n,n_pairs,omega,tile", CASES)
def test_mirror_matches_the_twin_bit_for_bit(n, n_pairs, omega, tile):
    op, shape = _op(n, n_pairs, omega)
    fields = _fields(shape, [n, n_pairs])
    pl = PL.fused_pre_plan(op.qshape, n_pairs, tile=tile)
    got, want = mirror(op, *fields, pl), op.plain(*fields)
    for name, g, w in zip(("us'", "vs'", "b", "p1", "rc", "max|b|"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))


def test_mirror_tiles_reach_the_last_interior_row_and_column():
    op, _ = _op(64, 2)
    pl = PL.fused_pre_plan(op.qshape, 2, tile=(11, 11))
    last = 64 // 2  # the plane row (column) of logical row (column) 64
    tiles = list(PL.carry_tiles(pl.carry, op.qshape))
    assert any(r0 + rows - 1 == last for r0, _, rows, _ in tiles)
    assert any(c0 + cols - 1 == last for _, c0, _, cols in tiles)
