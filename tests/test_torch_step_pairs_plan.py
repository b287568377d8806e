"""The launch plan of the natural step's exact masked pairs
(kernels/plan.py step_pairs_plan, csrc/step_smoother.cu) and a torch
mirror of its tile walk against the unedited plain twin
(kernels/step_smoother.py StepMaskedPairs.plain), on the CPU.

The mirror runs what a block of the kernel runs: its tile of p and b with
the plan's halo (0 outside the array), the 3 n_pairs + 1 stages
(n_pairs x (refresh, red, black) and the trailing refresh) on boxes that
shrink by one cell a stage, every position outside a stage's box
poisoned with NaN afterwards, so a read past it would show; its own cells
of out, and of the residual field or their max|r| (the refresh re-applied
before the 5-point stencil, on the own cells only). It is held to the twin
bit for bit (torch.equal) in the three variants at n_pairs 1-3, under the
plan's tile and under tiles whose edges fall on the last interior row and
column, on the step's corner column and on the solid block's bottom row,
at a small step and at the natural step's 32 x 514 level."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels.step_smoother import StepMaskedPairs, make_step_masked_pairs

from test_torch_level0_plan import _shift

torch.set_num_threads(1)

# ------------------------------------------------------------------ the plan

# (shape, step_i, inlet_j_max): the natural step's level 0 at 512x30 (the
# main path) and phase 27's masked solve at 512x64, and a small step
# (64x14) whose geometry step_rect_params gives too
NATURAL = ((32, 514), 128, 15)
PHASE27 = ((66, 514), 128, 32)
SMALL = ((16, 66), 16, 7)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n_pairs", [1, 2, 3])
@pytest.mark.parametrize("shape", [NATURAL[0], PHASE27[0], SMALL[0]])
def test_step_pairs_plan_halo_rule_and_shared_memory(shape, n_pairs, residual):
    pl = PL.step_pairs_plan(shape, n_pairs, residual)
    H, W = shape
    halo = 3 * n_pairs + 1 + (2 if residual else 0)
    assert pl.halo == halo == PL.step_pairs_halo(n_pairs, residual)
    # the rule: buffers STEP_PAIRS_TILE_WIDTH wide; the most rows of
    # STEP_PAIRS_TILE_ROWS whose grid holds STEP_PAIRS_MIN_TILES tiles,
    # else the last; cut to the level
    cols = PL.STEP_PAIRS_TILE_WIDTH - 2 * halo
    tiles = {r: -(-H // r) * -(-W // cols) for r in PL.STEP_PAIRS_TILE_ROWS}
    rows = max([r for r in PL.STEP_PAIRS_TILE_ROWS if tiles[r] >= PL.STEP_PAIRS_MIN_TILES],
               default=PL.STEP_PAIRS_TILE_ROWS[-1])
    assert (pl.rows, pl.cols) == (min(rows, H), min(cols, W))
    assert pl.smem_bytes == 4 * 3 * (pl.rows + 2 * halo) * (pl.cols + 2 * halo) <= PL.SMEM_MAX
    assert (pl.grid_x, pl.grid_y) == (-(-W // pl.cols), -(-H // pl.rows))
    assert len(pl.c_ints()) == 6


def _covered_once(pl, shape):
    seen = np.zeros(shape, int)
    for r0, c0, rows, cols in PL.carry_tiles(pl, (1, *shape)):  # one "plane" of (H, W)
        seen[r0 : r0 + rows, c0 : c0 + cols] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("tile", [None, (3, 7), (4, 17), (5, 13), (40, 100)])
@pytest.mark.parametrize("shape", [NATURAL[0], PHASE27[0], SMALL[0]])
def test_step_pairs_tiles_cover_every_cell_once(shape, tile):
    for residual in (False, True):
        pl = PL.step_pairs_plan(shape, 2, residual, tile=tile)
        assert _covered_once(pl, shape)
        if tile is not None:
            assert (pl.rows, pl.cols) == (min(tile[0], shape[0]), min(tile[1], shape[1]))


def test_step_pairs_plan_at_the_natural_step_level():
    # 32 x 514 at V(2,2): halo 9 with a residual, 46 own columns, 4-row
    # tiles (96 of them; 8-row tiles give 48, under STEP_PAIRS_MIN_TILES);
    # halo 7 without, 50 columns, 4-row tiles (the last candidate)
    for residual, halo, cols, tiles in ((True, 9, 46, 96), (False, 7, 50, 88)):
        pl = PL.step_pairs_plan(NATURAL[0], 2, residual)
        assert (pl.rows, pl.cols, pl.halo) == (4, cols, halo)
        assert (pl.grid_y, pl.grid_x * pl.grid_y) == (8, tiles)


def test_step_pairs_plan_refuses_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        PL.step_pairs_plan((4000, 4000), 2, True, tile=(128, 128))
    PL.step_pairs_plan((4000, 4000), 2, True, tile=(64, 64))  # fits


# ---------------------------------------------------------------- the mirror


def _region(a, r0, c0, LR, LC):
    """a's rows [r0, r0 + LR) x columns [c0, c0 + LC), 0 outside a."""
    H, W = a.shape
    out = torch.zeros(LR, LC, dtype=torch.float32)
    j0, j1, i0, i1 = max(r0, 0), min(r0 + LR, H), max(c0, 0), min(c0 + LC, W)
    if j0 < j1 and i0 < i1:
        out[j0 - r0 : j1 - r0, i0 - c0 : i1 - c0] = a[j0:j1, i0:i1]
    return out


def _box(new, s):
    """new on the cells s + 1 from the buffer's edge, NaN elsewhere."""
    out = torch.full_like(new, float("nan"))
    out[s + 1 : -(s + 1), s + 1 : -(s + 1)] = new[s + 1 : -(s + 1), s + 1 : -(s + 1)]
    return out


def _refresh(op: StepMaskedPairs, src, gj, gi):
    """The twin's refresh (StepMaskedPairs.refresh) on a tile buffer at
    global (gj, gi): every output from the input src; a neighbour past the
    buffer reads NaN."""
    ny, nx, si, ij = op.ny, op.nx, op.step_i, op.inlet_j_max
    row_in, col_in = (gj >= 1) & (gj <= ny), (gi >= 1) & (gi <= nx)
    solid = (gi >= 1) & (gi <= si) & (gj > ij) & (gj <= ny)
    east = solid & (gi == si) & (gi < nx)
    south = solid & (gj == ij + 1) & (gj > 1)
    inv = 1.0 / torch.clamp(east.float() + south.float(), min=1)
    zero = torch.zeros_like(src)
    q = torch.where((gi == 0) & row_in, _shift(src, 0, 1), src)
    q = torch.where((gi == nx + 1) & row_in, zero, q)
    q = torch.where((gj == 0) & col_in, _shift(src, 1, 0), q)
    q = torch.where((gj == ny + 1) & col_in, _shift(src, -1, 0), q)
    mean = (torch.where(east, _shift(src, 0, 1), zero)
            + torch.where(south, _shift(src, -1, 0), zero)) * inv
    return torch.where(east | south, mean, q)


def mirror(op: StepMaskedPairs, p, b, pl):
    """csrc/step_smoother.cu pairs_kernel in torch, one tile at a time."""
    H, W = op.shape
    h = pl.halo
    denom = torch.tensor(op.denom, dtype=torch.float32)
    out = torch.full_like(p, float("nan"))
    r = torch.full_like(p, float("nan")) if op.with_residual_field else None
    res = torch.zeros(())
    for R0, C0, rows, cols in PL.carry_tiles(pl, (1, H, W)):
        oj, oi = R0 - h, C0 - h
        LR, LC = pl.rows + 2 * h, pl.cols + 2 * h
        a, bb = _region(p, oj, oi, LR, LC), _region(b, oj, oi, LR, LC)
        gj = (oj + torch.arange(LR))[:, None].expand(LR, LC)
        gi = (oi + torch.arange(LC))[None, :].expand(LR, LC)
        fluid = ((gj >= 1) & (gj <= op.ny) & (gi >= 1) & (gi <= op.nx)
                 & ~((gi <= op.step_i) & (gj > op.inlet_j_max)))
        even = ((gj + gi) % 2) == 0
        st = 0

        def half(a, mask):
            gs = (op.idx2 * (_shift(a, 0, 1) + _shift(a, 0, -1))
                  + op.idy2 * (_shift(a, 1, 0) + _shift(a, -1, 0)) - bb) / denom
            return torch.where(mask, (1.0 - op.omega) * a + op.omega * gs, a)

        for _ in range(op.n_pairs):
            a = _box(_refresh(op, a, gj, gi), st)
            a = _box(half(a, fluid & even), st + 1)
            a = _box(half(a, fluid & ~even), st + 2)
            st += 3
        a = _box(_refresh(op, a, gj, gi), st)
        mine = (slice(h, h + rows), slice(h, h + cols))
        own = (slice(R0, R0 + rows), slice(C0, C0 + cols))
        out[own] = a[mine]
        if r is None and not op.with_residual:
            continue
        q = _refresh(op, a, gj, gi)
        lap = ((_shift(q, 0, 1) - 2.0 * q + _shift(q, 0, -1)) * op.idx2
               + (_shift(q, 1, 0) - 2.0 * q + _shift(q, -1, 0)) * op.idy2)
        rv = torch.where(fluid, bb - lap, torch.zeros_like(bb))[mine]
        assert bool(torch.isfinite(rv).all()), "the residual read a poisoned cell"
        if r is not None:
            r[own] = rv
        else:
            res = torch.maximum(res, rv.abs().max())
    assert bool(torch.isfinite(out).all()), "a tile wrote a poisoned cell"
    if op.with_residual:
        return out, res
    return out if r is None else (out, r)


VARIANTS = {"plain": {}, "field": {"with_residual_field": True}, "res": {"with_residual": True}}
# tiles on the small step (16 x 66: ny 14, nx 64, step_i 16, inlet_j 7):
# the plan's; (4, 17): a tile row starts on the solid block's bottom row 8
# and a tile column on column 17, east of the step's corner column 16;
# (5, 13): tile rows end on the last interior row 14 and columns on the
# last interior column 64; (8, 16): a tile corner on the step's corner
# (8, 16); (3, 7): ragged
TILES = [None, (4, 17), (5, 13), (8, 16), (3, 7)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(shape) * 10).astype(np.float32))
    return p, b


def _check(shape, step_i, inlet, n_pairs, variant, tile, omega, seed):
    op = make_step_masked_pairs(shape, step_i, inlet, 4096.0, 225.0, omega, n_pairs,
                                **VARIANTS[variant])
    p, b = _inputs(shape, seed)
    pl = PL.step_pairs_plan(shape, n_pairs, variant != "plain", tile=tile)
    got, want = mirror(op, p, b, pl), op.plain(p, b)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w), (shape, tile, float((g - w).abs().max()))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_mirror_matches_the_twin_on_a_small_step(n_pairs, variant, tile):
    _check(*SMALL, n_pairs, variant, tile, 1.0 if n_pairs != 3 else 1.15,
           [n_pairs, list(VARIANTS).index(variant)])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mirror_matches_the_twin_at_the_natural_step_level(variant):
    # the main path's instance: 32 x 514 at V(2,2), omega 1, the plan's tile
    _check(*NATURAL, 2, variant, None, 1.0, 7)


def test_mirror_tiles_reach_the_edges_and_the_corner():
    shape, step_i, inlet = SMALL
    ny, nx = shape[0] - 2, shape[1] - 2
    starts = lambda tile: list(PL.carry_tiles(PL.step_pairs_plan(shape, 2, True, tile=tile),
                                              (1, *shape)))
    assert any(r0 == inlet + 1 for r0, _, _, _ in starts((4, 17)))
    assert any(c0 == step_i + 1 for _, c0, _, _ in starts((4, 17)))
    assert any(r0 + rows - 1 == ny for r0, _, rows, _ in starts((5, 13)))
    assert any(c0 + cols - 1 == nx for _, c0, _, cols in starts((5, 13)))
    assert any((r0, c0) == (inlet + 1, step_i) for r0, c0, _, _ in starts((8, 16)))
