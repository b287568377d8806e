"""The tile plans of the cavity's two non-carry predictor + source kernels
and torch mirrors of their tiles against the unedited plain twins, on the
CPU: row 6, the quad layout's traced-dt stage (kernels/plan.py
carry_plan("cavity_predictor"), csrc/quad_stage.cu
lid_predictor_source_kernel, twin kernels/quad.py
QuadPredictorSource.plain), and row 11, the natural layout's
(natural_predictor_plan, csrc/projection.cu predictor_source_kernel, twin
kernels/projection.py PredictorSource.plain).

The plans: at the 2048^2 cavity's shapes, the CPU slice sizes, the 142^2
auto-rule cavity's and shapes whose rows or columns are not a multiple of
the tile, every cell lies in exactly one tile's own region, the halo
covers the stages' radius of 2 logical rows, a block's four buffers fit
its shared memory and the grid is the tile count.

The mirrors run what a block runs on each tile: u, v with the plan's halo
(0 outside the array); the lid ghosts once on the buffers (a ghost whose
source lies past the buffer poisoned with NaN: no face may read it); u, v
kept on box A (the own region widened 2 rows south, 1 north, 2 columns
west, 1 east), NaN elsewhere; u*, v* on box B (1 south, 1 west; 0 off the
valid faces), NaN elsewhere; then us, vs, b = rho/dt div on the cells of
the own region and their max|b|; a tile whose own cells lie wholly outside
the domain's ghost ring writes zeros without loading. A read past a
stage's box would show as NaN. Each mirror is held to its twin bit for bit
(torch.equal) under the plan's tile and under tiles whose edges fall on
the lid row, the ghost columns, the last interior row and column and (row
11) the padding."""

import re

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import projection as TP
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels._build import CSRC
from cfd_tpu_torch.kernels.quad import quad_shape
from cfd_tpu_torch.ops.stencil import StencilCoeffs

from test_torch_fused_pre_plan import _in_box, _region
from test_torch_level0_plan import _covered_once, _logical, _quad, _shift

torch.set_num_threads(1)

# ------------------------------------------------------------------ the plans

QSHAPES = {
    "cavity-2048": quad_shape((2050, 2050)),
    "cpu-cavity-32": quad_shape((34, 34)),
    "cpu-cavity-64": quad_shape((66, 66)),
    "ragged-rows": (4, 20, 128),
    "ragged-both": (4, 37, 200),
    "smaller-than-a-tile": (4, 5, 3),
}
ASHAPES = {
    "cavity-2048": TP.aligned_shape((2050, 2050)),
    "auto-rule-142": TP.aligned_shape((144, 144)),
    "cpu-cavity-32": TP.aligned_shape((34, 34)),
    "cpu-auto-30": TP.aligned_shape((32, 32)),
    "ragged-rows": (40, 128),
    "ragged-both": (37, 200),
    "smaller-than-a-tile": (5, 3),
}


def _natural_tiles(pl, shape):
    """Each tile's own region (row, column, rows, columns), clipped at the
    array's edge as the kernel clips its own cells."""
    H8, W = shape
    for ty in range(pl.grid_y):
        for tx in range(pl.grid_x):
            r0, c0 = ty * pl.rows, tx * pl.cols
            yield r0, c0, min(pl.rows, H8 - r0), min(pl.cols, W - c0)


@pytest.mark.parametrize("which", sorted(QSHAPES))
def test_quad_plan_covers_every_cell_once_with_a_halo_of_two_rows(which):
    qshape = QSHAPES[which]
    _, Hq8, Wqa = qshape
    pl = PL.carry_plan("cavity_predictor", qshape)
    assert PL.CARRY_RADIUS["cavity_predictor"] == 2
    assert 2 * pl.halo >= 2 and pl.halo == 1  # 2 logical rows: 1 plane row
    assert PL.CARRY_BUFFERS["cavity_predictor"] == 4  # u, v, u*, v*
    floats = 4 * (pl.rows + 2 * pl.halo) * (pl.cols + 2 * pl.halo)
    assert pl.smem_bytes == 4 * 4 * floats <= PL.SMEM_MAX
    assert (pl.rows, pl.cols) == tuple(min(a, b) for a, b in
                                       zip(PL.CARRY_TILES["cavity_predictor"], (Hq8, Wqa)))
    assert (pl.grid_x, pl.grid_y) == (-(-Wqa // pl.cols), -(-Hq8 // pl.rows))
    assert _covered_once(pl, qshape)


@pytest.mark.parametrize("which", sorted(ASHAPES))
def test_natural_plan_covers_every_cell_once_with_a_halo_of_two(which):
    shape = ASHAPES[which]
    H8, W = shape
    pl = PL.natural_predictor_plan(shape)
    assert pl.halo == PL.NATURAL_PREDICTOR_RADIUS == 2
    floats = (pl.rows + 2 * pl.halo) * (pl.cols + 2 * pl.halo)
    assert pl.smem_bytes == 4 * PL.NATURAL_PREDICTOR_BUFFERS * floats <= PL.SMEM_MAX
    assert PL.NATURAL_PREDICTOR_BUFFERS == 4
    assert (pl.rows, pl.cols) == tuple(min(a, b) for a, b in
                                       zip(PL.NATURAL_PREDICTOR_TILE, shape))
    assert (pl.grid_x, pl.grid_y) == (-(-W // pl.cols), -(-H8 // pl.rows))
    hits = np.zeros(shape, np.int32)
    tiles = list(_natural_tiles(pl, shape))
    assert len(tiles) == pl.grid_x * pl.grid_y
    for r0, c0, rows, cols in tiles:
        assert 1 <= rows <= pl.rows and 1 <= cols <= pl.cols
        hits[r0 : r0 + rows, c0 : c0 + cols] += 1
    assert (hits == 1).all()
    assert list(pl.c_ints()) == [pl.rows, pl.cols, pl.halo, pl.smem_bytes, pl.grid_x,
                                 pl.grid_y]


def test_natural_tiles_start_on_a_128_byte_line():
    # W is a multiple of 128 floats: a tile row's stores start on a line
    assert PL.NATURAL_PREDICTOR_TILE[1] % 128 == 0


@pytest.mark.parametrize("tile", [(3, 5), (11, 11), (40, 20)])
def test_plans_take_other_tiles_and_refuse_one_past_shared_memory(tile):
    qshape, shape = (4, 40, 128), (72, 128)
    q, n = PL.carry_plan("cavity_predictor", qshape, tile), PL.natural_predictor_plan(shape, tile)
    assert (q.rows, q.cols) == (min(tile[0], 40), min(tile[1], 128))
    assert (n.rows, n.cols) == (min(tile[0], 72), min(tile[1], 128))
    assert _covered_once(q, qshape)
    with pytest.raises(ValueError, match="shared"):
        PL.carry_plan("cavity_predictor", (4, 1032, 1152), (64, 256))
    with pytest.raises(ValueError, match="shared"):
        PL.natural_predictor_plan((2056, 2176), (128, 256))


@pytest.mark.parametrize("src,entry", [("quad_stage.cu", "cfd_quad_predictor_source"),
                                       ("projection.cu", "cfd_predictor_source")])
def test_one_launch_and_no_memset_in_the_entry_point(src, entry):
    text = (CSRC / src).read_text()
    body = re.search(rf'extern "C" int {entry}\(.*?\n}}\n', text, re.S).group(0)
    code = "\n".join(l.split("//")[0] for l in body.splitlines())
    assert "cudaMemset" not in code
    assert code.count("<<<") == 1


# ---------------------------------------------------------------- the mirrors


def _predictor(u, v, c: StencilCoeffs, dt):
    """The twins' MAC predictor (kernels/quad.py _predictor_quad,
    ops/stencil.py predictor) on a logical buffer, NaN past its edge."""
    nu, idx, idy, idx2, idy2 = c.viscosity, c.idx, c.idy, c.idx2, c.idy2
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


def _lid_ghosts(u, v, j0, i0, ny, nx, lid):
    """csrc/quad_carry.cuh lid_ghosts on buffers whose cell (lj, li) holds
    logical (j0 + lj, i0 + li): u's rows ny + 1 and 0 (i <= nx) from rows ny
    and 1, v's columns 0 and nx + 1 (j <= ny) from columns 1 and nx; a
    ghost whose source lies past the buffer poisoned with NaN."""
    LR, LC = u.shape
    u, v = u.clone(), v.clone()
    cols = (i0 + torch.arange(LC)) <= nx
    for ghost, src, top in ((ny + 1, ny, True), (0, 1, False)):
        lj, ls = ghost - j0, src - j0
        if 0 <= lj < LR:
            if 0 <= ls < LR:
                val = 2.0 * lid - u[ls] if top else -u[ls]
            else:
                val = torch.full((LC,), float("nan"))
            u[lj] = torch.where(cols, val, u[lj])
    rows = (j0 + torch.arange(LR)) <= ny
    for ghost, src in ((0, 1), (nx + 1, nx)):
        li, ls = ghost - i0, src - i0
        if 0 <= li < LC:
            val = -v[:, ls] if 0 <= ls < LC else torch.full((LR,), float("nan"))
            v[:, li] = torch.where(rows, val, v[:, li])
    return u, v


def _tile_stages(su, sv, j0, i0, o, rows, cols, ny, nx, lid, c, dt, rho_dt):
    """A tile's stages on its loaded buffers (own cells from buffer cell (o,
    o), rows x cols of them): (us, vs, b) of the buffer, NaN off box B for us
    and vs, on the own cells for b."""
    LR, LC = su.shape
    su, sv = _lid_ghosts(su, sv, j0, i0, ny, nx, lid)
    A = (o - 2, o + rows + 1, o - 2, o + cols + 1)
    B = (o - 1, o + rows, o - 1, o + cols)
    su, sv = _in_box(su, *A), _in_box(sv, *A)
    ps, qs = _predictor(su, sv, c, dt)
    gj = (j0 + torch.arange(LR))[:, None].expand(LR, LC)
    gi = (i0 + torch.arange(LC))[None, :].expand(LR, LC)
    u_valid = (gj >= 1) & (gj <= ny) & (gi >= 1) & (gi <= nx - 1)
    v_valid = (gj >= 1) & (gj <= ny - 1) & (gi >= 1) & (gi <= nx)
    cell = (gj >= 1) & (gj <= ny) & (gi >= 1) & (gi <= nx)
    zero = torch.zeros_like(su)
    s_us = _in_box(torch.where(u_valid, ps, zero), *B)
    s_vs = _in_box(torch.where(v_valid, qs, zero), *B)
    div = (s_us - _shift(s_us, 0, -1)) * c.idx + (s_vs - _shift(s_vs, -1, 0)) * c.idy
    b = _in_box(torch.where(cell, rho_dt * div, zero), o, o + rows, o, o + cols)
    return s_us, s_vs, b


def quad_mirror(op, dt, u, v, pl):
    """Row 6's kernel in torch on the tiles of ``pl`` (a carry_plan):
    (us', vs', b, max|b|) in the quad layout."""
    _, Hq8, Wqa = op.qshape
    ny, nx = op.ny, op.nx
    U, V = _logical(u), _logical(v)
    outs = [torch.full_like(U, float("nan")) for _ in range(3)]
    max_b = torch.zeros(())
    h, o = pl.halo, 2 * pl.halo
    LR, LC = 2 * (pl.rows + 2 * h), 2 * (pl.cols + 2 * h)
    rho_dt = TQ.rho_over(op.coeffs, dt)
    for R0, C0, rows, cols in PL.carry_tiles(pl, op.qshape):
        own = (slice(2 * R0, 2 * (R0 + rows)), slice(2 * C0, 2 * (C0 + cols)))
        if 2 * R0 > ny + 1 or 2 * C0 > nx + 1:  # tile::outside: zeros, no loads
            for out in outs:
                out[own] = 0.0
            continue
        aj, ai = 2 * (R0 - h), 2 * (C0 - h)
        su, sv = _region(U, aj, ai, LR, LC), _region(V, aj, ai, LR, LC)
        got = _tile_stages(su, sv, aj, ai, o, 2 * rows, 2 * cols, ny, nx, op.lid,
                           op.coeffs, dt, rho_dt)
        mine = (slice(o, o + 2 * rows), slice(o, o + 2 * cols))
        for out, val in zip(outs, got):
            out[own] = val[mine]
        max_b = torch.maximum(max_b, got[2][mine].abs().max())
    for out in outs:
        assert bool(torch.isfinite(out).all()), "a tile wrote a poisoned cell"
    return (*(_quad(a) for a in outs), max_b)


def natural_mirror(op, u, v, pl):
    """Row 11's kernel in torch on the tiles of ``pl`` (a
    natural_predictor_plan): (us, vs, b, max|b|) on the aligned array."""
    H8, W = op.shape
    ny, nx = op.ny, op.nx
    outs = [torch.full_like(u, float("nan")) for _ in range(3)]
    max_b = torch.zeros(())
    H = pl.halo
    c = op.coeffs
    for R0, C0, rows, cols in _natural_tiles(pl, op.shape):
        own = (slice(R0, R0 + rows), slice(C0, C0 + cols))
        if R0 > ny + 1 or C0 > nx + 1:  # the padding: zeros, no loads
            for out in outs:
                out[own] = 0.0
            continue
        oj, oi = R0 - H, C0 - H
        LR, LC = pl.rows + 2 * H, pl.cols + 2 * H
        su, sv = _region(u, oj, oi, LR, LC), _region(v, oj, oi, LR, LC)
        # the boxes of the unclipped tile, the outputs of its own cells
        got = _tile_stages(su, sv, oj, oi, H, pl.rows, pl.cols, ny, nx, op.ghost, c, c.dt,
                           c.density / c.dt)
        mine = (slice(H, H + rows), slice(H, H + cols))
        for out, val in zip(outs, got):
            out[own] = val[mine]
        max_b = torch.maximum(max_b, got[2][mine].abs().max())
    for out in outs:
        assert bool(torch.isfinite(out).all()), "a tile wrote a poisoned cell"
    return (*outs, max_b)


def _coeffs(n):
    h = 1.0 / n
    return StencilCoeffs(dx=h, dy=h, dt=0.25 * h, viscosity=1e-3, density=1.0)


def _noise(shape, seed):
    """Seeded noise over the whole array, its padding included (no face the
    stages compute reads the padding)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))


# (n, lid, tile) for row 6 at n^2: the plan's tile; at 64^2 (plane rows
# 0..32 hold logical rows 0..65) 16 x 16 and 8 x 8 start a tile on plane
# row 32 (the last interior row 64 and the lid row 65) and plane column 32
# (the last interior column and the east ghost column), 11 x 11 ends one
# there, the next tiles wholly in the padding; (3, 5) ragged, many tiles
QUAD_CASES = [(64, 1.0, None), (64, 1.0, (16, 16)), (64, 1.5, (8, 8)), (64, 1.0, (11, 11)),
              (32, 1.0, (3, 5)), (48, 2.0, None)]


@pytest.mark.parametrize("n,lid,tile", QUAD_CASES)
def test_quad_mirror_matches_the_twin_bit_for_bit(n, lid, tile):
    shape = (n + 2, n + 2)
    op = TQ.QuadPredictorSource(shape, _coeffs(n), lid)
    u, v = (_noise(op.qshape, [n, k]) for k in range(2))
    dt = torch.tensor(1.1 * op.coeffs.dt, dtype=torch.float32)
    pl = PL.carry_plan("cavity_predictor", op.qshape, tile)
    got, want = quad_mirror(op, dt, u, v, pl), op.plain(dt, u, v)
    for name, g, w in zip(("us'", "vs'", "b", "max|b|"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))


# (n, lid, tile) for row 11 at n^2 (aligned (H8, W), logical rows and
# columns 0..n+1): the plan's tile; at 64^2 (72 x 128) 13 x 13 starts a
# tile on row 65 (the lid row) and column 65 (the east ghost column), 11 x
# 11 ends one on them and starts the next in the padding (rows and columns
# 66 on), 8 x 64 starts one on the last interior row and column 64; at
# 30^2 (32 x 128) 4 x 31 starts one on the east ghost column 31 and the
# next in the padding; (3, 5) ragged, many tiles; 142^2 by the auto rule
NATURAL_CASES = [(64, 1.0, None), (64, 1.0, (13, 13)), (64, 1.5, (11, 11)),
                 (64, 1.0, (8, 64)), (30, 1.0, (4, 31)), (32, 2.0, (3, 5)),
                 (142, 1.0, None)]


@pytest.mark.parametrize("n,lid,tile", NATURAL_CASES)
def test_natural_mirror_matches_the_twin_bit_for_bit(n, lid, tile):
    shape = (n + 2, n + 2)
    op = TP.PredictorSource(shape, _coeffs(n), lid)
    u, v = (_noise(op.shape, [n, k, 11]) for k in range(2))
    pl = PL.natural_predictor_plan(op.shape, tile)
    got, want = natural_mirror(op, u, v, pl), op.plain(u, v)
    for name, g, w in zip(("us", "vs", "b", "max|b|"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))


def _starts(pl, shape):
    """The first rows and the first columns of the natural plan's tiles."""
    tiles = list(_natural_tiles(pl, shape))
    return {t[0] for t in tiles}, {t[1] for t in tiles}


def test_mirror_tiles_reach_the_lid_row_the_ghost_column_and_the_padding():
    # the edge cases above hold what their comments say (n = 64: the last
    # interior row and column 64, the lid row and the east ghost column 65)
    rows, cols = _starts(PL.natural_predictor_plan((72, 128), (13, 13)), (72, 128))
    assert 65 in rows and 65 in cols
    rows, cols = _starts(PL.natural_predictor_plan((72, 128), (11, 11)), (72, 128))
    assert 66 in rows and 66 in cols  # after tiles ending on 65: the padding
    rows, cols = _starts(PL.natural_predictor_plan((72, 128), (8, 64)), (72, 128))
    assert 64 in rows and 64 in cols
    rows, cols = _starts(PL.natural_predictor_plan((32, 128), (4, 31)), (32, 128))
    assert 31 in cols and 62 in cols  # n = 30: the ghost column, then the padding
    for tile, first in (((16, 16), True), ((8, 8), True), ((11, 11), False)):
        pl = PL.carry_plan("cavity_predictor", (4, 40, 128), tile)
        tiles = list(PL.carry_tiles(pl, (4, 40, 128)))
        if first:  # plane row and column 32 (logical 64, 65) start a tile
            assert any(r0 == 32 for r0, _, _, _ in tiles)
            assert any(c0 == 32 for _, c0, _, _ in tiles)
        else:  # they end one
            assert any(r0 + r - 1 == 32 for r0, _, r, _ in tiles)
            assert any(c0 + c - 1 == 32 for _, c0, _, c in tiles)
