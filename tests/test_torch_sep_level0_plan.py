"""The launch plan of the separable finest-level tile kernels
(kernels/plan.py level0_plan with masked=False, csrc/quad_vcycle.cu: the
cavity's, the channel's and RB's pre and post kernels, rows 3, 4, 16b and
16c) and a torch mirror of their tile walk (csrc/level0_tile.cuh
sep_pre_tile, sep_post_tile) against the unedited plain twins
(kernels/quad.py QuadPreSmoothRestrict.plain, QuadPostProlongSmooth.plain
and their Shard twins), on the CPU.

The mirror runs what a block of the kernels runs, in the logical layout:
each tile's p, b and weight vectors with the plan's halo (0 outside the
array), the half-sweeps on boxes that shrink by one logical cell a
half-sweep (every position outside a half-sweep's box poisoned with NaN,
so a read past it would show), each cell's band from the block's row0,
the level-1 correction's tile with its row Hq8 wrapped to row 0 on a local
block, the tiles wholly off the domain copying p, the own cells written,
the own coarse cells' restriction and the own rows' max|r|. It is held to
the twins bit for bit (torch.equal) on small whole fields of the three
flows at V(2,1) and V(1,2), on the bottom, interior and top shards of
4-shard meshes (tile edges on the interior's last row and column in some
cases)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.poisson import multigrid as TM

from test_torch_level0_plan import Mirror, _covered_once, _logical, _quad, _shift

torch.set_num_threads(1)
H = TQ.DEV_HALO
PROBLEMS = {"cavity": TM.cavity_problem, "channel": TM.channel_problem,
            "rb": TM.neumann_problem}
OMEGA = 1.15

# ------------------------------------------------------------------ the plan

# (qshape, block, rows): the main widths' fields and 4-shard blocks (the
# 2048^2 cavity's, the 1536x512 channel's and RB's) and the tile rows that
# timed fastest there on an H100
MAIN = [((4, 1032, 1152), False, 24), ((4, 264, 896), False, 16),
        ((4, 280, 1152), True, 24), ((4, 88, 896), True, 8)]


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("n_pairs", [1, 2])
@pytest.mark.parametrize("qshape,block,rows", MAIN)
def test_sep_plan_tile_halo_and_shared_memory(qshape, block, rows, n_pairs, post):
    pl = PL.level0_plan(qshape, n_pairs, post, block=block, masked=False)
    _, Hq8, Wqa = qshape
    assert pl.halo == n_pairs + 1 == PL.halos(False, n_pairs, n_pairs)[1 if post else 0]
    # buffers SEP_LEVEL0_WIDTH plane columns wide: 64 logical cells of a
    # colour a row, two a lane
    assert (pl.rows, pl.cols) == (rows, PL.SEP_LEVEL0_WIDTH - 2 * pl.halo)
    assert (pl.rows, pl.cols) == PL.sep_level0_tile(qshape, pl.halo)
    lr, lc = 2 * (pl.rows + 2 * pl.halo), 2 * (pl.cols + 2 * pl.halo)
    assert lc == 128
    coarse = (pl.rows + 2 * pl.halo + 1) * (pl.cols + 2 * pl.halo + 1) if post else 0
    assert pl.smem_bytes == 4 * (2 * lr * lc + 2 * (lr + lc) + coarse) <= PL.SMEM_MAX
    # two blocks fit an SM
    assert 2 * (pl.smem_bytes + 1024) <= PL.SMEM_MAX + 1024
    assert (pl.grid_x, pl.grid_y) == (-(-Wqa // pl.cols), -(-Hq8 // pl.rows))
    assert _covered_once(pl, qshape)


@pytest.mark.parametrize("halo", [2, 3])
@pytest.mark.parametrize("qshape,block,rows", MAIN)
def test_sep_tile_rule_takes_the_most_rows_that_fill_the_card(qshape, block, rows, halo):
    # the first candidate whose grid holds SEP_LEVEL0_MIN_TILES tiles (the
    # last where none does); no taller one does
    _, Hq8, Wqa = qshape
    cols = PL.SEP_LEVEL0_WIDTH - 2 * halo
    tiles = lambda r: -(-Hq8 // r) * -(-Wqa // cols)
    k = PL.SEP_LEVEL0_ROWS.index(rows)
    assert tiles(rows) >= PL.SEP_LEVEL0_MIN_TILES or rows == PL.SEP_LEVEL0_ROWS[-1]
    assert all(tiles(r) < PL.SEP_LEVEL0_MIN_TILES for r in PL.SEP_LEVEL0_ROWS[:k])


def test_sep_tile_rule_takes_the_last_on_a_small_field():
    assert PL.sep_level0_tile((4, 40, 128), 3) == (PL.SEP_LEVEL0_ROWS[-1], 58)


@pytest.mark.parametrize("tile", [(5, 24), (3, 7), (1000, 5000)])
@pytest.mark.parametrize("qshape", [(4, 40, 128), (4, 16, 256)])
def test_sep_tiles_cover_every_cell_once(qshape, tile):
    for post in (False, True):
        pl = PL.level0_plan(qshape, 2, post, masked=False, tile=tile)
        assert _covered_once(pl, qshape)
        assert (pl.rows, pl.cols) == (min(tile[0], qshape[1]), min(tile[1], qshape[2]))


def test_sep_plan_refuses_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        PL.level0_plan((4, 1032, 1152), 2, True, masked=False, tile=(64, 128))
    PL.level0_plan((4, 1032, 1152), 2, True, masked=False, tile=(48, 64))  # fits


def test_the_masked_plan_is_unchanged_by_the_flag():
    # the step's plan before the separable case joined level0_plan
    for post, halo, smem in ((False, 3, 41952), (True, 2, 39544)):
        assert PL.level0_plan((4, 136, 1152), 1, post, masked=True) == PL.CarryPlan(
            17, 32, halo, smem, 36, 8)


# ---------------------------------------------------------------- the mirror

class SepMirror(Mirror):
    """The tile kernels of csrc/quad_vcycle.cu in torch: ``op`` a twin (its
    constants and weight vectors), ``plan`` a level0_plan(masked=False),
    ``row0`` and ``halo`` the block's (0, 0 on a whole field)."""

    def __init__(self, op, plan, row0=0, halo=0):
        self.op, self.pl, self.row0, self.halo = op, plan, row0, halo
        _, self.Hq8, self.Wqa = op.qshape
        self.block = halo > 0

    def _interior(self, gj, gi):
        o = self.op
        return (gj >= 1) & (gj <= o.ny) & (gi >= 1) & (gi <= o.nx)

    def _in_block(self, gj):
        jl = gj - 2 * self.row0
        return (jl >= 0) & (jl < 2 * self.Hq8)

    def _weights(self, gj, gi):
        """(we, ww, wn, ws) at each buffer position: the column vectors by
        the logical column, the row vectors by the global row (their zero
        prefix on a block), 0 outside the array."""
        o = self.op
        col_in = (gi >= 0) & (gi < 2 * self.Wqa)
        ci = gi.clamp(0, 2 * self.Wqa - 1)
        row_in = self._in_block(gj)
        ri = (gj + 2 * o.prefix).clamp(0, o.wN.numel() - 1)
        zero = torch.zeros(())
        return (torch.where(col_in, o.wE[ci], zero), torch.where(col_in, o.wW[ci], zero),
                torch.where(row_in, o.wN[ri], zero), torch.where(row_in, o.wS[ri], zero))

    def _pairs(self, a, b, w, gj, gi, shift):
        o = self.op
        we, ww, wn, ws = w
        interior, parity = self._interior(gj, gi), (gj + gi) & 1
        denom = o.idx2 * (we + ww) + o.idy2 * (wn + ws)
        inv = 1.0 / torch.where(denom > 0, denom, torch.ones_like(denom))
        for k in range(2 * o.n_pairs):
            upd = interior & (parity == (k & 1)) & self._band(gj, k + 1 + shift)
            E, W, N, S = _shift(a, 0, 1), _shift(a, 0, -1), _shift(a, 1, 0), _shift(a, -1, 0)
            gs = (o.idx2 * (we * E + ww * W) + o.idy2 * (wn * N + ws * S) - b) * inv
            a = self._box(torch.where(upd, a + o.omega * (gs - a), a), k)
        return a

    def _residual(self, a, b, w, gj, gi):
        o = self.op
        we, ww, wn, ws = w
        E, W, N, S = _shift(a, 0, 1), _shift(a, 0, -1), _shift(a, 1, 0), _shift(a, -1, 0)
        ap = (o.idx2 * (we * (E - a) + ww * (W - a)) + o.idy2 * (wn * (N - a) + ws * (S - a)))
        keep = self._interior(gj, gi) & self._in_block(gj)
        return torch.where(keep, b - ap, torch.zeros_like(b))

    def _outside(self, R0, C0):
        """The kernels' test: the tile's own cells all off the domain."""
        o = self.op
        j0, i0 = 2 * (R0 + self.row0), 2 * C0
        return i0 > o.nx + 1 or j0 > o.ny + 1 or j0 + 2 * self.pl.rows - 1 < 0

    def pre(self, p, b):
        P, B = _logical(p), _logical(b)
        out, rc = torch.full_like(P, float("nan")), torch.full(self.op.coarse_shape,
                                                                 float("nan"))
        h = self.pl.halo
        for R0, C0 in self._tiles():
            rows, cols = min(self.pl.rows, self.Hq8 - R0), min(self.pl.cols, self.Wqa - C0)
            own = (slice(2 * R0, 2 * (R0 + rows)), slice(2 * C0, 2 * (C0 + cols)))
            if self._outside(R0, C0):
                out[own] = P[own]
                rc[R0 : R0 + rows, C0 : C0 + cols] = 0.0
                continue
            oj, oi, gj, gi = self._grid(R0, C0)
            a, bb, w = self._load(P, oj, oi), self._load(B, oj, oi), self._weights(gj, gi)
            a = self._pairs(a, bb, w, gj, gi, 0)
            out[own] = self._own(a, R0, C0)[0]
            r = self._residual(a, bb, w, gj, gi)
            # coarse cell (Jc, Ic): children (2Jc, 2Ic), (2Jc, 2Ic - 1),
            # (2Jc - 1, 2Ic), (2Jc - 1, 2Ic - 1) at buffer rows 2h + 2r (- 1)
            hi, lo = r[2 * h :: 2], r[2 * h - 1 :: 2]
            v = 0.25 * (hi[:rows, 2 * h :: 2][:, :cols] + hi[:rows, 2 * h - 1 :: 2][:, :cols]
                        + lo[:rows, 2 * h :: 2][:, :cols] + lo[:rows, 2 * h - 1 :: 2][:, :cols])
            Jc = self.row0 + R0 + torch.arange(rows)[:, None]
            Ic = C0 + torch.arange(cols)[None, :]
            interior = (Jc >= 1) & (Jc <= self.op.ny // 2) & (Ic >= 1) & (Ic <= self.op.nx // 2)
            rc[R0 : R0 + rows, C0 : C0 + cols] = torch.where(interior, v, torch.zeros(()))
        return _quad(out), rc

    def post(self, p, b, ec):
        P, B = _logical(p), _logical(b)
        out, res = torch.full_like(P, float("nan")), torch.zeros(())
        for R0, C0 in self._tiles():
            rows, cols = min(self.pl.rows, self.Hq8 - R0), min(self.pl.cols, self.Wqa - C0)
            own = (slice(2 * R0, 2 * (R0 + rows)), slice(2 * C0, 2 * (C0 + cols)))
            if self._outside(R0, C0):
                out[own] = P[own]
                continue
            oj, oi, gj, gi = self._grid(R0, C0)
            a, bb, w = self._load(P, oj, oi), self._load(B, oj, oi), self._weights(gj, gi)
            add = self._interior(gj, gi) & self._in_block(gj)
            a = torch.where(add, a + self._prolong(ec, R0, C0, gj, gi), a)
            a = self._pairs(a, bb, w, gj, gi, 1)
            out[own] = self._own(a, R0, C0)[0]
            r = self._own(self._residual(a, bb, w, gj, gi).abs(), R0, C0)[0]
            J = R0 + torch.arange(rows).repeat_interleave(2)[:, None]
            if self.block:
                r = torch.where((J >= self.halo) & (J < self.Hq8 - self.halo), r,
                                torch.zeros(()))
            res = torch.maximum(res, r.max())
        return _quad(out), res


# ---------------------------------------------------------------- the cases

def _ops(flow, nx, ny, n_pre, n_post, mdy=None):
    """(pre, post, shape) twins of ``flow`` at nx x ny: the whole field's
    (mdy None) or one shard's local block on an mdy-way mesh."""
    shape = (ny + 2, nx + 2)
    prob = PROBLEMS[flow](nx, ny, 1.0 / nx, 1.0 / ny)
    _, _, Hq8, W = TQ.quad_dims(shape)
    shard, coarse = None, (Hq8, W)
    if mdy is not None:
        _, P, _ = TQ.quad_shard_dims(shape, mdy)
        shard, coarse = (P, mdy), (P + 2 * H, W)
    return (TQ.make_quad_pre_smooth_restrict(shape, prob, OMEGA, n_pre, coarse, shard=shard),
            TQ.make_quad_post_prolong_smooth(shape, prob, OMEGA, n_post, coarse, shard=shard),
            shape)


def _inputs(op, seed):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy((rng.standard_normal(op.qshape) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(op.qshape) * 1e2).astype(np.float32))
    ec = torch.from_numpy((rng.standard_normal(op.coarse_shape) * 0.1).astype(np.float32))
    return p, b, ec


def _check(pre, post, tile, row0=0, halo=0, seed=0):
    p, b, ec = _inputs(pre, seed)
    block = halo > 0
    plans = [PL.level0_plan(op.qshape, op.n_pairs, post_, block=block, masked=False, tile=tile)
             for op, post_ in ((pre, False), (post, True))]
    mp, mq = SepMirror(pre, plans[0], row0, halo), SepMirror(post, plans[1], row0, halo)
    if halo:
        want_pre, want_post = pre.plain(row0, p, b), post.plain(row0, p, b, ec)
    else:
        want_pre, want_post = pre.plain(p, b), post.plain(p, b, ec)
    for got, want in ((mp.pre(p, b), want_pre), (mq.post(p, b, ec), want_post)):
        for a, w in zip(got, want, strict=True):
            assert torch.equal(a, w), float((a - w).abs().max())


# 64^2: the last interior row and column (logical 64) lie in plane row and
# column 32, an edge of 16 x 32 tiles; (40, 128) quad planes, so the
# single-tile plan's post buffers still fit
@pytest.mark.parametrize("tile", [None, (16, 32), (5, 24), (3, 7), (1000, 5000)])
@pytest.mark.parametrize("n_pre,n_post", [(2, 1), (1, 2)])
def test_mirror_equals_the_twins_on_a_cavity_field(tile, n_pre, n_post):
    pre, post, _ = _ops("cavity", 64, 64, n_pre, n_post)
    _check(pre, post, tile, seed=n_pre + 3 * n_post)


# the channel at V(1,2) and RB at V(2,1), their per-kernel solves' cycles
@pytest.mark.parametrize("tile", [None, (4, 24), (3, 7)])
@pytest.mark.parametrize("flow,n_pre,n_post", [("channel", 1, 2), ("rb", 2, 1)])
def test_mirror_equals_the_twins_on_channel_and_rb_fields(flow, n_pre, n_post, tile):
    pre, post, _ = _ops(flow, 96, 32, n_pre, n_post)
    _check(pre, post, tile, seed=7 * n_pre + n_post)


# 128^2 on 4 shards: P = 24, blocks of 40 plane rows; the last interior
# column (logical 128) in plane column 64, an edge of 32-wide tiles, and
# the last interior row in plane row 64, shard 2's local row 24: an edge
# of 8-row tiles
@pytest.mark.parametrize("jy", [0, 1, 2, 3])
@pytest.mark.parametrize("tile", [None, (8, 32), (5, 24)])
def test_mirror_equals_the_twins_on_a_4_shard_cavity_mesh(jy, tile):
    pre, post, _ = _ops("cavity", 128, 128, 2, 1, mdy=4)
    P = pre.qshape[1] - 2 * H
    assert P == 24 and (128 // 2 - (2 * P - H)) % 8 == 0
    _check(pre, post, tile, row0=jy * P - H, halo=H, seed=10 * jy)


# the channel 96x32 on 4 shards at V(1,2): P = 8, the smallest block
@pytest.mark.parametrize("jy", [0, 1, 3])
@pytest.mark.parametrize("tile", [None, (3, 7)])
def test_mirror_equals_the_twins_on_a_4_shard_channel_mesh(jy, tile):
    pre, post, _ = _ops("channel", 96, 32, 1, 2, mdy=4)
    P = pre.qshape[1] - 2 * H
    _check(pre, post, tile, row0=jy * P - H, halo=H, seed=20 + jy)


def test_a_poisoned_halo_one_short_shows():
    # the mirror reads a NaN past a box when the halo is one plane row
    # short: the plan's halo is the least that the half-sweeps need
    pre, post, _ = _ops("cavity", 64, 64, 2, 1)
    p, b, ec = _inputs(pre, 1)
    pl = PL.level0_plan(pre.qshape, 2, False, masked=False, tile=(16, 32))
    short = PL.CarryPlan(pl.rows, pl.cols, pl.halo - 1, pl.smem_bytes, pl.grid_x, pl.grid_y)
    got = SepMirror(pre, short).pre(p, b)
    assert not torch.equal(got[1], pre.plain(p, b)[1])
