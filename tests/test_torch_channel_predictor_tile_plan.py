"""The tile plans of the channel's two non-carry predictor + source kernels
and torch mirrors of their tiles against the unedited plain twins, on the
CPU: row 8c, the quad layout's (kernels/plan.py
carry_plan("channel_predictor"), csrc/quad_stage.cu
channel_predictor_source_kernel, twin kernels/quad.py
QuadChannelPredictorSource.plain), and row 11's channel predictor + source,
the natural layout's (natural_predictor_plan(channel=True),
csrc/projection.cu channel_predictor_source_kernel, twin
kernels/projection.py ChannelPredictorSource.plain).

The plans: at the 1536x512 channel's shapes, the CPU slice sizes and
shapes whose rows or columns are not a multiple of the tile, every cell
lies in exactly one tile's own region, the halo covers the stages' reach (3
logical columns west: 2 plane rows and columns on the quad layout, 3 cells
on the natural one), a block's four buffers fit its shared memory and the
grid is the tile count.

The mirrors run what a block runs on each tile: u, v with the plan's halo
(0 outside the array), kept on box A (the own region widened 2 rows south,
1 north, 3 columns west, 1 east; on the natural layout 2 rows north, as a
natural tile may end on the ghost row 0), NaN elsewhere; the predictor on
the valid faces (0 off them), then the channel ghosts of the tentative
fields in the reference's order on the buffers (a ghost reading past the
buffer reads NaN); u* kept on box BU (the own cells and one column west),
v* on box BV (the own cells and one row south), NaN elsewhere; then us',
vs', b = rho/dt div on the cells of the own region; a tile whose own cells
lie wholly outside the domain's ghost ring writes zeros without loading.
A read past a stage's box would show as NaN, in an output or in a face of
BU or BV that no output reads (the kernel computes those too). Each mirror
is held to its twin bit for bit (torch.equal) under the plan's tile and
under tiles whose edges fall on the inlet column, the outlet columns nx and
nx + 1, the wall rows 0, ny and ny + 1 and (natural) the padding; the sum
of b is the twin's fixed_order_sum of the mirror's b."""

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
from test_torch_predictor_tile_plan import _natural_tiles, _noise, _predictor

torch.set_num_threads(1)

# ------------------------------------------------------------------ the plans

QSHAPES = {
    "channel-1536x512": quad_shape((514, 1538)),
    "cpu-channel-32x16": quad_shape((18, 34)),
    "cpu-channel-64x32": quad_shape((34, 66)),
    "ragged-rows": (4, 20, 128),
    "ragged-both": (4, 37, 200),
    "smaller-than-a-tile": (4, 5, 3),
}
ASHAPES = {
    "channel-1536x512": TP.aligned_shape((514, 1538)),
    "cpu-channel-64x32": TP.aligned_shape((34, 66)),
    "cpu-auto-64x30": TP.aligned_shape((32, 66)),
    "ragged-rows": (40, 128),
    "ragged-both": (36, 200),
    "smaller-than-a-tile": (4, 3),
}


def test_the_full_shapes():
    assert QSHAPES["channel-1536x512"] == (4, 264, 896)
    assert ASHAPES["channel-1536x512"] == (520, 1664)


@pytest.mark.parametrize("which", sorted(QSHAPES))
def test_quad_plan_covers_every_cell_once_with_a_halo_of_two_plane_rows(which):
    qshape = QSHAPES[which]
    _, Hq8, Wqa = qshape
    pl = PL.carry_plan("channel_predictor", qshape)
    # 3 logical columns west (box A), 2 rows south: 2 plane rows and columns
    assert PL.CARRY_RADIUS["channel_predictor"] == 3
    assert 2 * pl.halo >= 3 and pl.halo == 2
    assert PL.CARRY_BUFFERS["channel_predictor"] == 4  # u, v, u*, v*
    floats = 4 * (pl.rows + 2 * pl.halo) * (pl.cols + 2 * pl.halo)
    assert pl.smem_bytes == 4 * 4 * floats <= PL.SMEM_MAX
    assert (pl.rows, pl.cols) == tuple(min(a, b) for a, b in
                                       zip(PL.CARRY_TILES["channel_predictor"], (Hq8, Wqa)))
    assert (pl.grid_x, pl.grid_y) == (-(-Wqa // pl.cols), -(-Hq8 // pl.rows))
    assert _covered_once(pl, qshape)


@pytest.mark.parametrize("which", sorted(ASHAPES))
def test_natural_plan_covers_every_cell_once_with_a_halo_of_three(which):
    shape = ASHAPES[which]
    H8, W = shape
    pl = PL.natural_predictor_plan(shape, channel=True)
    assert pl.halo == PL.NATURAL_CHANNEL_PREDICTOR_RADIUS == 3
    floats = (pl.rows + 2 * pl.halo) * (pl.cols + 2 * pl.halo)
    assert pl.smem_bytes == 4 * PL.NATURAL_PREDICTOR_BUFFERS * floats <= PL.SMEM_MAX
    assert (pl.rows, pl.cols) == tuple(min(a, b) for a, b in
                                       zip(PL.NATURAL_CHANNEL_PREDICTOR_TILE, shape))
    assert (pl.grid_x, pl.grid_y) == (-(-W // pl.cols), -(-H8 // pl.rows))
    hits = np.zeros(shape, np.int32)
    tiles = list(_natural_tiles(pl, shape))
    assert len(tiles) == pl.grid_x * pl.grid_y
    for r0, c0, rows, cols in tiles:
        assert 1 <= rows <= pl.rows and 1 <= cols <= pl.cols
        hits[r0 : r0 + rows, c0 : c0 + cols] += 1
    assert (hits == 1).all()
    # the cavity's plan keeps its own tile and halo
    assert PL.natural_predictor_plan(shape).halo == PL.NATURAL_PREDICTOR_RADIUS == 2


def test_natural_tiles_start_on_a_128_byte_line_and_rows_suit_the_sum():
    # W is a multiple of 128 floats: a tile row's stores start on a line;
    # H8 is a multiple of 8, so the sum's (4, H8 / 4, W) view is the flat array
    assert PL.NATURAL_CHANNEL_PREDICTOR_TILE[1] % 128 == 0
    for shape in ((514, 1538), (34, 66), (32, 66), (3, 3)):
        H8, W = TP.aligned_shape(shape)
        assert H8 % 8 == 0 and 4 * (H8 // 4) * W == H8 * W


@pytest.mark.parametrize("tile", [(3, 5), (11, 11), (40, 20)])
def test_plans_take_other_tiles_and_refuse_one_past_shared_memory(tile):
    qshape, shape = (4, 40, 128), (72, 128)
    q = PL.carry_plan("channel_predictor", qshape, tile)
    n = PL.natural_predictor_plan(shape, tile, channel=True)
    assert (q.rows, q.cols) == (min(tile[0], 40), min(tile[1], 128))
    assert (n.rows, n.cols) == (min(tile[0], 72), min(tile[1], 128))
    assert (q.halo, n.halo) == (2, 3)
    assert _covered_once(q, qshape)
    with pytest.raises(ValueError, match="shared"):
        PL.carry_plan("channel_predictor", (4, 264, 896), (64, 256))
    with pytest.raises(ValueError, match="shared"):
        PL.natural_predictor_plan((520, 1664), (128, 256), channel=True)


@pytest.mark.parametrize("src,entry", [("quad_stage.cu", "cfd_quad_channel_predictor_source"),
                                       ("projection.cu", "cfd_channel_predictor_source")])
def test_tile_launch_plus_sum_launch_and_no_memset(src, entry):
    text = (CSRC / src).read_text()
    body = re.search(rf'extern "C" int {entry}\(.*?\n}}\n', text, re.S).group(0)
    code = "\n".join(l.split("//")[0] for l in body.splitlines())
    assert "cudaMemset" not in code and "fold_partials" not in code
    assert code.count("<<<") == 1
    assert len(re.findall(r"tile::launch(_dependent)?_source_sum\(", code)) == 1


# ---------------------------------------------------------------- the mirrors


def _channel_ghosts(us, vs, gj, gi, ny, nx, uin):
    """The channel ghosts of the tentative fields (kernels/quad.py
    _channel_bc_quad's order) on buffers whose cells hold global logical
    (gj, gi): a ghost reading past the buffer reads NaN."""
    rows = (gj >= 1) & (gj <= ny)
    us = torch.where((gi == 0) & rows, torch.full_like(us, uin), us)
    vs = torch.where((gi == 0) & (gj <= ny), torch.zeros_like(vs), vs)
    us = torch.where((gi == nx) & rows, _shift(us, 0, -1), us)
    vs = torch.where((gi == nx + 1) & (gj <= ny), _shift(vs, 0, -1), vs)
    vs = torch.where((gj == 0) & (gi >= 1) & (gi <= nx), torch.zeros_like(vs), vs)
    us = torch.where((gj == 0) & (gi <= nx), -_shift(us, 1, 0), us)
    vs = torch.where((gj == ny) & (gi >= 1) & (gi <= nx), torch.zeros_like(vs), vs)
    us = torch.where((gj == ny + 1) & (gi <= nx), -_shift(us, -1, 0), us)
    return us, vs


def _tile_stages(su, sv, j0, i0, o, rows, cols, north, op):
    """A tile's stages on its loaded buffers (buffer cell (lj, li) at
    logical (j0 + lj, i0 + li), own cells from buffer cell (o, o), rows x
    cols of them; box A reaching ``north`` rows north): (us, vs, b) of the
    buffer, NaN off box BU for us, BV for vs, the own cells for b."""
    LR, LC = su.shape
    c, ny, nx = op.coeffs, op.ny, op.nx
    su = _in_box(su, o - 2, o + rows + north, o - 3, o + cols + 1)
    sv = _in_box(sv, o - 2, o + rows + north, o - 3, o + cols + 1)
    ps, qs = _predictor(su, sv, c, c.dt)
    gj = (j0 + torch.arange(LR))[:, None].expand(LR, LC)
    gi = (i0 + torch.arange(LC))[None, :].expand(LR, LC)
    u_valid = (gj >= 1) & (gj <= ny) & (gi >= 1) & (gi <= nx - 1)
    v_valid = (gj >= 1) & (gj <= ny - 1) & (gi >= 1) & (gi <= nx)
    cell = (gj >= 1) & (gj <= ny) & (gi >= 1) & (gi <= nx)
    zero = torch.zeros_like(su)
    s_us, s_vs = _channel_ghosts(torch.where(u_valid, ps, zero), torch.where(v_valid, qs, zero),
                                 gj, gi, ny, nx, op_inlet(op))
    s_us = _in_box(s_us, o, o + rows, o - 1, o + cols)
    s_vs = _in_box(s_vs, o - 1, o + rows, o, o + cols)
    # the kernel computes every face of BU and BV, used or not (the west
    # column's outlet copy reads 3 columns west): none may read past box A
    assert bool(torch.isfinite(s_us[o : o + rows, o - 1 : o + cols]).all()), "u* read past A"
    assert bool(torch.isfinite(s_vs[o - 1 : o + rows, o : o + cols]).all()), "v* read past A"
    div = (s_us - _shift(s_us, 0, -1)) * c.idx + (s_vs - _shift(s_vs, -1, 0)) * c.idy
    b = _in_box(torch.where(cell, (c.density / c.dt) * div, zero), o, o + rows, o, o + cols)
    return s_us, s_vs, b


def op_inlet(op):
    return op.uin if isinstance(op, TQ.QuadChannelPredictorSource) else op.ghost


def quad_mirror(op, u, v, pl):
    """Row 8c's kernel in torch on the tiles of ``pl`` (a carry_plan):
    (us', vs', b, sum b) in the quad layout."""
    ny, nx = op.ny, op.nx
    U, V = _logical(u), _logical(v)
    outs = [torch.full_like(U, float("nan")) for _ in range(3)]
    h, o = pl.halo, 2 * pl.halo
    LR, LC = 2 * (pl.rows + 2 * h), 2 * (pl.cols + 2 * h)
    for R0, C0, rows, cols in PL.carry_tiles(pl, op.qshape):
        own = (slice(2 * R0, 2 * (R0 + rows)), slice(2 * C0, 2 * (C0 + cols)))
        if 2 * R0 > ny + 1 or 2 * C0 > nx + 1:  # tile::outside: zeros, no loads
            for out in outs:
                out[own] = 0.0
            continue
        aj, ai = 2 * (R0 - h), 2 * (C0 - h)
        su, sv = _region(U, aj, ai, LR, LC), _region(V, aj, ai, LR, LC)
        got = _tile_stages(su, sv, aj, ai, o, 2 * rows, 2 * cols, 1, op)
        mine = (slice(o, o + 2 * rows), slice(o, o + 2 * cols))
        for out, val in zip(outs, got):
            out[own] = val[mine]
    for out in outs:
        assert bool(torch.isfinite(out).all()), "a tile wrote a poisoned cell"
    us, vs, b = (_quad(a) for a in outs)
    return us, vs, b, TQ.fixed_order_sum(b)


def natural_mirror(op, u, v, pl):
    """Row 11's channel kernel in torch on the tiles of ``pl`` (a
    natural_predictor_plan(channel=True)): (us, vs, b, sum b) on the
    aligned array."""
    ny, nx = op.ny, op.nx
    outs = [torch.full_like(u, float("nan")) for _ in range(3)]
    H = pl.halo
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
        got = _tile_stages(su, sv, oj, oi, H, pl.rows, pl.cols, 2, op)
        mine = (slice(H, H + rows), slice(H, H + cols))
        for out, val in zip(outs, got):
            out[own] = val[mine]
    for out in outs:
        assert bool(torch.isfinite(out).all()), "a tile wrote a poisoned cell"
    return (*outs, TQ.fixed_order_sum(outs[2]))


def _coeffs(ny, nx):
    dx, dy = 4.0 / nx, 1.0 / ny
    return StencilCoeffs(dx=dx, dy=dy, dt=0.2 * min(dx, dy), viscosity=1e-2, density=1.0)


# (ny, nx, uin, tile) for row 8c: 16 x 32 tiles at 32 x 64 (plane row 16
# and column 32 start tiles: the first own row is the wall row ny, the
# first own column the outlet column nx) and at 31 x 63 (the ghost row ny
# + 1 and the outlet column nx + 1 start tiles, ny and nx end the ones
# before); 8 x 8 tiles at 32 x 64; one plane row a tile (its own rows 0
# and 1, the wall and the first interior row); ragged tiles; the plan's
# tile at 32 x 64 and at the CPU slice's 16 x 32
QUAD_CASES = [(32, 64, 1.0, (16, 32)), (31, 63, 1.0, (16, 32)), (32, 64, 1.5, (8, 8)),
              (32, 64, 1.0, (1, 16)), (33, 65, 1.0, (5, 7)), (32, 64, 1.0, None),
              (16, 32, 1.0, None)]


@pytest.mark.parametrize("ny,nx,uin,tile", QUAD_CASES)
def test_quad_mirror_matches_the_twin_bit_for_bit(ny, nx, uin, tile):
    op = TQ.QuadChannelPredictorSource((ny + 2, nx + 2), _coeffs(ny, nx), uin)
    u, v = (_noise(op.qshape, [ny, nx, k]) for k in range(2))
    pl = PL.carry_plan("channel_predictor", op.qshape, tile)
    got, want = quad_mirror(op, u, v, pl), op.plain(u, v)
    for name, g, w in zip(("us'", "vs'", "b", "sum b"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))


# (ny, nx, uin, tile) for row 11's channel at (ny + 2) x (nx + 2) in an
# aligned (H8, W): at 32 x 64 (40 x 128) 16 x 128 (row 32, the wall row
# ny, starts a tile); 11 x 13 (row 33 = ny + 1 and column 65 = nx + 1
# start tiles); 8 x 64 (column 64 = nx starts one); 17 x 33 (row 34 and
# column 66 start tiles in the padding); one row a tile (a tile ending on
# the ghost row 0); ragged 3 x 5; the plan's tile at the CPU slices' 32 x
# 64 and 30 x 64
NATURAL_CASES = [(32, 64, 1.0, (16, 128)), (32, 64, 1.0, (11, 13)), (32, 64, 1.5, (8, 64)),
                 (32, 64, 1.0, (17, 33)), (32, 64, 1.0, (1, 64)), (30, 64, 1.0, (3, 5)),
                 (32, 64, 1.0, None), (30, 64, 1.0, None)]


@pytest.mark.parametrize("ny,nx,uin,tile", NATURAL_CASES)
def test_natural_mirror_matches_the_twin_bit_for_bit(ny, nx, uin, tile):
    op = TP.ChannelPredictorSource((ny + 2, nx + 2), _coeffs(ny, nx), uin)
    u, v = (_noise(op.shape, [ny, nx, k, 11]) for k in range(2))
    pl = PL.natural_predictor_plan(op.shape, tile, channel=True)
    got, want = natural_mirror(op, u, v, pl), op.plain(u, v)
    for name, g, w in zip(("us", "vs", "b", "sum b"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))


def test_mirror_tiles_reach_the_walls_the_outlet_and_the_padding():
    # the edge cases above hold what their comments say
    qshape = quad_shape((34, 66))
    starts = lambda tile: [(2 * r0, 2 * c0) for r0, c0, _, _ in
                           PL.carry_tiles(PL.carry_plan("channel_predictor", qshape, tile),
                                          qshape)]
    assert (32, 64) in starts((16, 32)) and (32, 64) in starts((8, 8))  # ny, nx
    s31 = [(2 * r0, 2 * c0) for r0, c0, _, _ in
           PL.carry_tiles(PL.carry_plan("channel_predictor", quad_shape((33, 65)), (16, 32)),
                          quad_shape((33, 65)))]
    assert (32, 64) in s31  # ny + 1 = 32 and nx + 1 = 64 at 31 x 63
    shape = TP.aligned_shape((34, 66))
    rows = lambda tile: {t[0] for t in _natural_tiles(
        PL.natural_predictor_plan(shape, tile, channel=True), shape)}
    cols = lambda tile: {t[1] for t in _natural_tiles(
        PL.natural_predictor_plan(shape, tile, channel=True), shape)}
    assert 32 in rows((16, 128)) and 33 in rows((11, 13)) and 65 in cols((11, 13))
    assert 64 in cols((8, 64)) and 34 in rows((17, 33)) and 66 in cols((17, 33))
    assert [t for t in _natural_tiles(PL.natural_predictor_plan(shape, (1, 64), channel=True),
                                      shape) if t[0] == 0 and t[2] == 1]
