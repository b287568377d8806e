"""The launch plan of the coarse red/black smoother's tile kernel
(kernels/plan.py pairs_plan, csrc/rb_smoother.cu) and a torch mirror of
its tile walk (csrc/level_tile.cuh) against the unedited plain twin
(kernels/rb_smoother.py RBPairs.plain), on the CPU.

The mirror runs what a block of the kernel runs: its tile of p and b in
float32 with the plan's halo (0 outside the array) and the weights under
it, the 2 n_pairs half-sweeps red first on boxes that shrink by one cell a
half-sweep (every position outside a half-sweep's box poisoned with NaN
afterwards, so a read past it would show), its own cells of out rounded
once to the storage type, and its own cells' residual field or max|r|; a
tile whose own cells miss the interior copies p. The twin is whole-array;
the mirror is held to it bit for bit (torch.equal) on separable levels in
float32 and bfloat16 and on the step's full-2D masked levels, at n_pairs
1-3, in the three variants, under the plan's tile and under ragged ones
whose edges fall on the interior's last row and column."""

import functools

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_backwards_step_case, make_cavity_case, make_channel_case
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels.rb_smoother import RBPairs, rb_pairs_for_level
from cfd_tpu_torch.poisson.multigrid import _round_up8_128

torch.set_num_threads(1)

# ------------------------------------------------------------------ the plan


def _levels(nx: int, ny: int, first: int, dtype=torch.float32):
    """The aligned (H8, W) shapes of levels first.. of an nx x ny hierarchy
    but its coarsest (build_problems: halve while both are even and the
    halves >= min_coarse 4; the coarsest is the dense solve's)."""
    dims = [(nx, ny)]
    while dims[-1][0] % 2 == 0 and dims[-1][1] % 2 == 0 and min(dims[-1]) // 2 >= 4:
        dims.append((dims[-1][0] // 2, dims[-1][1] // 2))
    return [(_round_up8_128((y + 2, x + 2), dtype), y, x) for x, y in dims[first:-1]]


# (what, level shapes, full, the (n_pairs, residual) instances): the four
# flows' per-kernel hierarchies at the main widths (the cavity in both
# storages; the channel and the step V(1,2), the cavity and RB V(2,1)),
# the sharded step's V(1,1), and the natural levels (the aligned cavity's
# and channel's level 0 with both residual variants and their coarse
# levels, the auto-rule cavity, the masked 512x64 solve)
HIERARCHIES = [
    ("cavity f32", _levels(2048, 2048, 1), False, [(2, True), (1, False)]),
    ("cavity bf16", _levels(2048, 2048, 1, torch.bfloat16), False, [(2, True), (1, False)]),
    ("channel", _levels(1536, 512, 1), False, [(1, True), (2, False)]),
    ("rb", _levels(1536, 512, 1), False, [(2, True), (1, False)]),
    ("step", _levels(2048, 256, 1), True, [(1, True), (2, False), (1, False)]),
    ("natural cavity", _levels(2048, 2048, 0), False, [(2, True), (1, True), (1, False)]),
    ("natural channel", _levels(1536, 512, 0), False, [(1, True), (2, True), (2, False)]),
    ("auto cavity", _levels(142, 142, 0), False, [(2, True), (1, True), (1, False)]),
    ("masked natural", _levels(512, 64, 1), True, [(2, True), (2, False)]),
]
PLAN_CASES = [(what, shape, ny, nx, full, n, res)
              for what, levels, full, inst in HIERARCHIES
              for shape, ny, nx in levels for n, res in inst]


def _covered_once(pl, shape):
    seen = np.zeros(shape, int)
    for r0, c0, rows, cols in PL.carry_tiles(pl, (1, *shape)):  # one "plane" of (H8, W)
        seen[r0 : r0 + rows, c0 : c0 + cols] += 1
    return (seen == 1).all()


def test_the_hierarchies_reach_their_main_levels():
    # the cavity's level 1 at 2048^2 in bfloat16, its level 8, the natural
    # cavity's level 0, the step's level 1
    assert HIERARCHIES[1][1][0][0] == (1040, 1152) and HIERARCHIES[1][1][-1][0] == (16, 128)
    assert HIERARCHIES[5][1][0][0] == (2056, 2176)
    assert HIERARCHIES[4][1][0][0] == (136, 1152)


@pytest.mark.parametrize("what,shape,ny,nx,full,n_pairs,residual", PLAN_CASES)
def test_pairs_plan_covers_every_cell_with_its_halo(what, shape, ny, nx, full, n_pairs,
                                                    residual):
    pl = PL.pairs_plan(shape, n_pairs, residual, full)
    assert pl.halo == 2 * n_pairs + int(residual)
    # the rule: buffers PAIRS_TILE_WIDTH wide; among the candidate rows whose
    # buffers fit, the most whose grid gives 264 tiles (two an SM), else the
    # most giving 132 (one an SM), else PAIRS_SMALL_ROWS
    cols = PL.PAIRS_TILE_WIDTH - 2 * pl.halo
    fit = [r for r in PL.PAIRS_TILE_ROWS
           if 4 * PL.ltile_floats(r, cols, pl.halo, full) <= PL.SMEM_MAX]
    tiles = {r: -(-shape[0] // r) * -(-shape[1] // cols) for r in fit}
    rows = (max([r for r in fit if tiles[r] >= 264], default=0)
            or max([r for r in fit if tiles[r] >= 132], default=0) or PL.PAIRS_SMALL_ROWS)
    assert (pl.rows, pl.cols) == (min(rows, shape[0]), min(cols, shape[1]))
    lr, lc = pl.rows + 2 * pl.halo, pl.cols + 2 * pl.halo
    weights = 4 * lr * lc if full else 2 * (lr + lc)
    assert pl.smem_bytes == 4 * (2 * lr * lc + weights) <= PL.SMEM_MAX
    assert (pl.grid_x, pl.grid_y) == (-(-shape[1] // pl.cols), -(-shape[0] // pl.rows))
    assert _covered_once(pl, shape)
    assert len(pl.c_ints()) == 6


@pytest.mark.parametrize("shape,n_pairs,residual,full,tile", [
    ((1040, 1152), 2, True, False, (32, 118)),   # row 5: the cavity's bf16 level 1
    ((1032, 1152), 1, False, False, (32, 124)),  # its float32 post-smooth
    ((2056, 2176), 1, True, False, (64, 122)),   # row 5-wr: the natural cavity's level 0
    ((136, 256), 2, True, False, (4, 118)),      # the cavity's level 4: 102 tiles
    ((136, 1152), 1, True, True, (8, 122)),      # row 5b: the step's level 1, 170 tiles
    ((16, 128), 2, True, False, (4, 118))])      # the cavity's level 8: 8 tiles
def test_pairs_plan_takes_the_swept_tiles_at_the_main_levels(shape, n_pairs, residual, full,
                                                             tile):
    pl = PL.pairs_plan(shape, n_pairs, residual, full)
    assert (pl.rows, pl.cols) == tile


@pytest.mark.parametrize("tile,shapes", [((5, 7), ((16, 128), (1040, 1152), (136, 1152))),
                                         ((11, 33), ((16, 128), (1040, 1152), (136, 1152))),
                                         ((1000, 5000), ((16, 128), (40, 128)))])
def test_pairs_plan_cuts_and_covers_other_tiles(tile, shapes):
    for shape in shapes:
        pl = PL.pairs_plan(shape, 2, True, False, tile=tile)
        assert (pl.rows, pl.cols) == (min(tile[0], shape[0]), min(tile[1], shape[1]))
        assert _covered_once(pl, shape)


def test_pairs_plan_refuses_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        PL.pairs_plan((1040, 1152), 2, True, True, tile=(128, 128))
    PL.pairs_plan((1040, 1152), 2, True, False, tile=(128, 128))  # separable: fits


# ---------------------------------------------------------------- the mirror


def _shift(a, dj, di):
    """b[j, i] = a[j + dj, i + di], NaN outside a."""
    out = torch.full_like(a, float("nan"))
    R, C = a.shape
    out[max(0, -dj) : R - max(0, dj), max(0, -di) : C - max(0, di)] = \
        a[max(0, dj) : R - max(0, -dj), max(0, di) : C - max(0, -di)]
    return out


def _region(a, r0, c0, LR, LC):
    """a's rows [r0, r0 + LR) x columns [c0, c0 + LC) in float32, 0 outside."""
    H, W = a.shape
    out = torch.zeros(LR, LC, dtype=torch.float32)
    j0, j1, i0, i1 = max(r0, 0), min(r0 + LR, H), max(c0, 0), min(c0 + LC, W)
    if j0 < j1 and i0 < i1:
        out[j0 - r0 : j1 - r0, i0 - c0 : i1 - c0] = a[j0:j1, i0:i1].float()
    return out


def mirror(sm: RBPairs, p, b, pl):
    """csrc/rb_smoother.cu pairs_kernel in torch, one tile at a time:
    (out, r) with the residual field, (out, max|r|) with_residual, else
    out."""
    H8, W = sm.shape
    h = pl.halo
    we, ww, wn, ws = (w if sm.full else
                      (w.reshape(1, -1).expand(H8, W) if k < 2 else w.reshape(-1, 1).expand(H8, W))
                      for k, w in enumerate((sm.wE, sm.wW, sm.wN, sm.wS)))
    out = torch.empty_like(p)
    r = torch.empty_like(p) if sm.with_residual_field else None
    res = torch.zeros((), dtype=torch.float32)
    for R0, C0, rows, cols in PL.carry_tiles(pl, (1, H8, W)):
        own = (slice(R0, R0 + rows), slice(C0, C0 + cols))
        if R0 > sm.ny or R0 + pl.rows - 1 < 1 or C0 > sm.nx or C0 + pl.cols - 1 < 1:
            out[own] = p[own]
            if r is not None:
                r[own] = 0
            continue
        oj, oi = R0 - h, C0 - h
        LR, LC = pl.rows + 2 * h, pl.cols + 2 * h
        tp, tb = _region(p, oj, oi, LR, LC), _region(b, oj, oi, LR, LC)
        e, w_, n, s = (_region(x, oj, oi, LR, LC) for x in (we, ww, wn, ws))
        gj = torch.arange(oj, oj + LR)[:, None]
        gi = torch.arange(oi, oi + LC)[None, :]
        denom = sm.idx2 * (e + w_) + sm.idy2 * (n + s)
        active = (gj >= 1) & (gj <= sm.ny) & (gi >= 1) & (gi <= sm.nx)
        if sm.full:
            active = active & (denom > 0)
        inv = 1.0 / torch.where(denom > 0, denom, torch.ones_like(denom))
        lj = torch.arange(LR)[:, None]
        li = torch.arange(LC)[None, :]
        for st in range(2 * sm.n_pairs):
            box = (lj >= st + 1) & (lj < LR - st - 1) & (li >= st + 1) & (li < LC - st - 1)
            on = box & active & (((gj + gi) % 2) == (st & 1))
            gs = (sm.idx2 * (e * _shift(tp, 0, 1) + w_ * _shift(tp, 0, -1))
                  + sm.idy2 * (n * _shift(tp, 1, 0) + s * _shift(tp, -1, 0)) - tb) * inv
            tp = torch.where(on, tp + sm.omega * (gs - tp), tp)
            tp = torch.where(box, tp, torch.full_like(tp, float("nan")))
        mine = (slice(h, h + rows), slice(h, h + cols))
        out[own] = tp[mine].to(sm.dtype)
        if r is None and not sm.with_residual:
            continue
        ap = (sm.idx2 * (e * (_shift(tp, 0, 1) - tp) + w_ * (_shift(tp, 0, -1) - tp))
              + sm.idy2 * (n * (_shift(tp, 1, 0) - tp) + s * (_shift(tp, -1, 0) - tp)))
        rv = torch.where(active, tb - ap, torch.zeros_like(tb))[mine]
        assert bool(torch.isfinite(rv).all()), "the residual read a poisoned cell"
        if r is not None:
            r[own] = rv.to(sm.dtype)
        else:
            res = torch.maximum(res, rv.abs().max())
    assert bool(torch.isfinite(out.float()).all()), "a tile wrote a poisoned cell"
    if sm.with_residual:
        return out, res
    return out if r is None else (out, r)


@functools.lru_cache(maxsize=None)
def _case_levels(kind):
    """(levels, dtype) of a small per-kernel hierarchy on the CPU: the
    smoothed levels of the cavity at 64^2 (float32 or the bfloat16
    hierarchy), the channel at 64x32 and the step's masked one at 128x32."""
    if kind == "step":
        case = make_backwards_step_case(nx=128, ny=32, poisson="multigrid", device="cpu",
                                        dtype=torch.float32)
        return list(case.poisson_solve.levels[:-1])
    if kind == "channel":
        case = make_channel_case(nx=64, ny=32, poisson="multigrid", device="cpu",
                                 dtype=torch.float32)
    else:
        kw = {"mg_overrides": {"coarse_dtype": "bfloat16"}} if kind == "cavity bf16" else {}
        case = make_cavity_case(n_interior=64, poisson="multigrid", device="cpu",
                                dtype=torch.float32, **kw)
    return list(case.poisson_solve.levels[1:-1])


KINDS = ("cavity f32", "cavity bf16", "channel", "step")
VARIANTS = {"plain": {}, "field": {"with_residual_field": True}, "res": {"with_residual": True}}
# tiles: the plan's; 8 x 11 (a tile row ends on the last interior row of
# the 32-row level 1 of the cavity, a tile column on column 33 = nx + 1);
# 5 x 7 (ragged, many tiles); 11 x 20
TILES = [None, (8, 11), (5, 7), (11, 20)]
MIRROR_CASES = [(kind, v, n, tile) for kind in KINDS for v in VARIANTS for n in (1, 2, 3)
                for tile in TILES if not (kind == "step" and v == "res")]


@pytest.mark.parametrize("kind,variant,n_pairs,tile", MIRROR_CASES)
def test_mirror_matches_the_twin_bit_for_bit(kind, variant, n_pairs, tile):
    rng = np.random.default_rng([KINDS.index(kind), list(VARIANTS).index(variant), n_pairs])
    levels = _case_levels(kind) if tile is None else _case_levels(kind)[:1]
    for lv in levels:
        sm = rb_pairs_for_level(lv, 1.0, n_pairs, **VARIANTS[variant])
        p = torch.from_numpy(rng.standard_normal(lv.shape) * 0.1).to(lv.dtype)
        b = torch.from_numpy(rng.standard_normal(lv.shape) * 1e2).to(lv.dtype)
        residual = variant != "plain"
        pl = PL.pairs_plan(lv.shape, n_pairs, residual, sm.full, tile=tile)
        got, want = mirror(sm, p, b, pl), sm.plain(p, b)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w), (lv.shape, float((g - w).abs().max()))


def test_mirror_cases_reach_edges_and_padding():
    # level 1 of the cavity at 64^2: 32 interior rows and columns in a
    # (40, 128) array, so the 8 x 11 tiles end a tile row on row 31 and a
    # tile column on column 32 and 33, and tiles of the padding copy
    lv = _case_levels("cavity f32")[0]
    assert (lv.shape, lv.ny, lv.nx) == ((40, 128), 32, 32)
    pl = PL.pairs_plan(lv.shape, 1, False, False, tile=(8, 11))
    tiles = list(PL.carry_tiles(pl, (1, *lv.shape)))
    assert any(r0 + rows == lv.ny for r0, _, rows, _ in tiles)
    assert any(c0 + cols == lv.nx + 1 for _, c0, _, cols in tiles)
    assert any(c0 > lv.nx for _, c0, _, _ in tiles)
    assert _case_levels("step")[0].separable is False
    assert _case_levels("cavity bf16")[0].dtype == torch.bfloat16
