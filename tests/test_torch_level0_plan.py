"""The launch plan of the backward step's finest-level tile kernels
(kernels/plan.py level0_plan, csrc/step_vcycle.cu) and a torch mirror of
their tile decomposition (csrc/level0_tile.cuh) against the unedited plain
twins (kernels/step_quad.py), on the CPU.

The mirror runs what a block of the kernels runs, in the logical layout:
each tile's p and b with the plan's halo (0 outside the array), the stages
on boxes that shrink by one logical cell a stage (every position outside a
stage's box poisoned with NaN, so a read past it would show), each cell's
band from the block's row0, the level-1 correction's tile with its row
Hq8 wrapped to row 0 on a local block, the own cells written, the own
coarse cells' restriction and the own rows' max|r|. The twins are whole
arrays; the mirror is held to them bit for bit (torch.equal) on the whole
field at V(1,2) and V(1,1), on the bottom, corner and top shards of a
4-shard 512x64 mesh (a tile edge on the corner row in one case) and on
both shards of a 2-shard 32x8 mesh."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.poisson.multigrid import step_rect_params

torch.set_num_threads(1)
H = TQ.DEV_HALO

# ------------------------------------------------------------------ the plan

# (qshape, n_pairs, post, block, halo): the main path's four instances (the
# 2048x256 step's whole field at V(1,2), shard 1's block of its 4-shard
# mesh at V(1,1)) and small ones (512x64 on 4 shards, 64x16 whole)
INSTANCES = [((4, 136, 1152), 1, False, False, 3), ((4, 136, 1152), 2, True, False, 3),
             ((4, 56, 1152), 1, False, True, 3), ((4, 56, 1152), 1, True, True, 2),
             ((4, 32, 384), 1, False, True, 3), ((4, 32, 384), 1, True, True, 2),
             ((4, 16, 128), 1, False, False, 3), ((4, 16, 128), 2, True, False, 3)]


@pytest.mark.parametrize("qshape,n_pairs,post,block,halo", INSTANCES)
def test_level0_plan_tile_halo_and_shared_memory(qshape, n_pairs, post, block, halo):
    pl = PL.level0_plan(qshape, n_pairs, post, masked=True, block=block)
    _, Hq8, Wqa = qshape
    rows, cols = PL.LEVEL0_TILES["block" if block else "field"]
    assert (pl.rows, pl.cols) == (min(rows, Hq8), min(cols, Wqa))
    assert pl.halo == halo == PL.halos(True, n_pairs, n_pairs)[1 if post else 0]
    lr, lc = 2 * (pl.rows + 2 * halo), 2 * (pl.cols + 2 * halo)
    coarse = (pl.rows + 2 * halo + 1) * (pl.cols + 2 * halo + 1) if post else 0
    assert pl.smem_bytes == 4 * (3 * lr * lc + coarse) <= PL.SMEM_MAX
    assert (pl.grid_x, pl.grid_y) == (-(-Wqa // pl.cols), -(-Hq8 // pl.rows))
    assert len(pl.c_ints()) == 6


def _covered_once(pl, qshape):
    _, Hq8, Wqa = qshape
    seen = np.zeros((Hq8, Wqa), int)
    for r0, c0, rows, cols in PL.carry_tiles(pl, qshape):
        seen[r0 : r0 + rows, c0 : c0 + cols] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("qshape,n_pairs,post,block,halo", INSTANCES)
@pytest.mark.parametrize("tile", [None, (5, 24), (3, 7)])
def test_level0_tiles_cover_every_cell_once(qshape, n_pairs, post, block, halo, tile):
    pl = PL.level0_plan(qshape, n_pairs, post, masked=True, block=block, tile=tile)
    assert _covered_once(pl, qshape)


@pytest.mark.parametrize("qshape,n_pairs,post,block,halo", INSTANCES[6:])
def test_level0_plan_cuts_a_tile_larger_than_the_field(qshape, n_pairs, post, block, halo):
    pl = PL.level0_plan(qshape, n_pairs, post, masked=True, tile=(1000, 5000))
    assert (pl.rows, pl.cols, pl.grid_x, pl.grid_y) == (*qshape[1:], 1, 1)
    assert _covered_once(pl, qshape)


def test_level0_plan_refuses_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        PL.level0_plan((4, 136, 1152), 2, True, masked=True, tile=(64, 128))
    PL.level0_plan((4, 136, 1152), 2, True, masked=True, tile=(16, 64))  # fits


@pytest.mark.parametrize("qshape,block", [((4, 136, 1152), False), ((4, 56, 1152), True)])
def test_level0_tiles_strand_no_sliver_at_the_main_widths(qshape, block):
    # the 2048x256 step's field and 4-shard block: every tile row full, and
    # 264 tiles hold cells of the domain (2049 logical columns: plane
    # columns 0..1024), two an SM on 132 SMs
    for post in (False, True):
        pl = PL.level0_plan(qshape, 1, post, masked=True, block=block)
        assert qshape[1] % pl.rows == 0
        assert pl.grid_y * -(-1025 // pl.cols) == 2 * PL.H100_SMS


# ---------------------------------------------------------------- the mirror

def _logical(q):
    """(4, Hq8, Wqa) quad -> (2 Hq8, 2 Wqa) logical."""
    _, Hq8, Wqa = q.shape
    out = torch.empty(2 * Hq8, 2 * Wqa, dtype=q.dtype)
    for k in range(4):
        out[k >> 1 :: 2, k & 1 :: 2] = q[k]
    return out


def _quad(a):
    return torch.stack([a[k >> 1 :: 2, k & 1 :: 2] for k in range(4)])


def _shift(a, dj, di):
    """b[j, i] = a[j + dj, i + di], NaN outside a."""
    out = torch.full_like(a, float("nan"))
    R, C = a.shape
    out[max(0, -dj) : R - max(0, dj), max(0, -di) : C - max(0, di)] = \
        a[max(0, dj) : R - max(0, -dj), max(0, di) : C - max(0, -di)]
    return out


class Mirror:
    """The tile kernels of csrc/step_vcycle.cu in torch: ``op`` a twin (its
    constants), ``plan`` a level0_plan, ``row0`` and ``halo`` the block's
    (0, 0 on a whole field)."""

    def __init__(self, op, plan, row0=0, halo=0):
        self.op, self.pl, self.row0, self.halo = op, plan, row0, halo
        _, self.Hq8, self.Wqa = op.qshape
        self.block = halo > 0
        self.denom = torch.tensor(op.denom, dtype=torch.float32)

    def _grid(self, R0, C0):
        h, pl = self.pl.halo, self.pl
        oj, oi = 2 * (R0 - h + self.row0), 2 * (C0 - h)
        LR, LC = 2 * (pl.rows + 2 * h), 2 * (pl.cols + 2 * h)
        gj = (oj + torch.arange(LR))[:, None].expand(LR, LC)
        gi = (oi + torch.arange(LC))[None, :].expand(LR, LC)
        return oj, oi, gj, gi

    def _load(self, a, oj, oi):
        """The tile's region of logical array a, 0 outside it."""
        LR = 2 * (self.pl.rows + 2 * self.pl.halo)
        LC = 2 * (self.pl.cols + 2 * self.pl.halo)
        buf = torch.zeros(LR, LC)
        aj, R, C = oj - 2 * self.row0, a.shape[0], a.shape[1]
        r0, r1 = max(aj, 0), min(aj + LR, R)
        c0, c1 = max(oi, 0), min(oi + LC, C)
        if r0 < r1 and c0 < c1:
            buf[r0 - aj : r1 - aj, c0 - oi : c1 - oi] = a[r0:r1, c0:c1]
        return buf

    def _band(self, gj, lo):
        if not self.block:
            return torch.ones_like(gj, dtype=torch.bool)
        Jl = (gj >> 1) - self.row0
        bottom = self.row0 <= 0
        top = self.row0 + self.Hq8 >= (self.op.ny + 1) // 2 + 1
        return (Jl >= (0 if bottom else lo)) & (Jl < (self.Hq8 if top else self.Hq8 - lo))

    def _fluid(self, gj, gi):
        o = self.op
        return ((gj >= 1) & (gj <= o.ny) & (gi >= 1) & (gi <= o.nx)
                & ~((gi <= o.step_i) & (gj > o.inlet_j)))

    def _ghost(self, src, gj, gi):
        o = self.op
        row_in, col_in = (gj >= 1) & (gj <= o.ny), (gi >= 1) & (gi <= o.nx)
        solid = row_in & col_in & (gi <= o.step_i) & (gj > o.inlet_j)
        eastw = solid & (gi == o.step_i) & (gi < o.nx)
        southw = solid & (gj == o.inlet_j + 1) & (gj > 1)
        cnt = eastw.float() + southw.float()
        inv = 1.0 / torch.where(cnt > 0, cnt, torch.ones_like(cnt))
        zero = torch.zeros_like(src)
        avg = (torch.where(eastw, _shift(src, 0, 1), zero)
               + torch.where(southw, _shift(src, -1, 0), zero)) * inv
        out = torch.where(eastw | southw, avg, src)
        out = torch.where((gj == o.ny + 1) & col_in, _shift(src, -1, 0), out)
        out = torch.where((gj == 0) & col_in, _shift(src, 1, 0), out)
        out = torch.where((gi == o.nx + 1) & row_in, zero, out)
        return torch.where((gi == 0) & row_in, _shift(src, 0, 1), out)

    def _banded_ghost(self, src, gj, gi, lo):
        return torch.where(self._band(gj, lo), self._ghost(src, gj, gi), src)

    def _gs(self, src, nb, b):
        o = self.op
        E, W, N, S = (_shift(nb, 0, 1), _shift(nb, 0, -1), _shift(nb, 1, 0),
                      _shift(nb, -1, 0))
        gs = (o.idx2 * (E + W) + o.idy2 * (N + S) - b) / self.denom
        return (1.0 - o.omega) * src + o.omega * gs

    @staticmethod
    def _box(new, s):
        """new on the cells s + 1 from the buffer's edge, NaN elsewhere."""
        out = torch.full_like(new, float("nan"))
        out[s + 1 : -(s + 1), s + 1 : -(s + 1)] = new[s + 1 : -(s + 1), s + 1 : -(s + 1)]
        return out

    def _pairs(self, a, b, gj, gi, shift):
        fluid, parity = self._fluid(gj, gi), (gj + gi) & 1
        s, k = 0, shift
        for _ in range(self.op.n_pairs):
            g = self._banded_ghost(a, gj, gi, k + 1)
            red = (parity == 0) & fluid & self._band(gj, k + 2)
            a = self._box(torch.where(red, self._gs(a, g, b), g), s)
            black = (parity == 1) & fluid & self._band(gj, k + 3)
            a = torch.where(black, self._gs(a, a, b), a)
            a = self._box(a, s + 1)
            s, k = s + 2, k + 3
        return self._box(self._banded_ghost(a, gj, gi, k + 1), s), k + 2

    def _residual(self, a, b, gj, gi, lo):
        o = self.op
        pg = self._banded_ghost(a, gj, gi, lo)
        E, W, N, S = (_shift(pg, 0, 1), _shift(pg, 0, -1), _shift(pg, 1, 0),
                      _shift(pg, -1, 0))
        lap = (E - 2.0 * pg + W) * o.idx2 + (N - 2.0 * pg + S) * o.idy2
        jl = gj - 2 * self.row0
        keep = self._fluid(gj, gi) & (jl >= 0) & (jl < 2 * self.Hq8)
        return torch.where(keep, b - lap, torch.zeros_like(b))

    def _own(self, buf, R0, C0):
        """The tile's own region of a buffer, clipped at the array."""
        h, pl = self.pl.halo, self.pl
        rows, cols = min(pl.rows, self.Hq8 - R0), min(pl.cols, self.Wqa - C0)
        return buf[2 * h : 2 * (h + rows), 2 * h : 2 * (h + cols)], rows, cols

    def _coarse(self, ec, R0, C0, J, I):
        """The coarse tile's value at global (J, I): ec's rows R0 - h .. R0 +
        rows + h and columns C0 - h .. C0 + cols + h (NaN past them), row
        Hq8 wrapped to 0 on a block, 0 outside the array."""
        h, pl = self.pl.halo, self.pl
        Jl = J - self.row0
        tile = (Jl >= R0 - h) & (Jl <= R0 + pl.rows + h) & (I >= C0 - h) & (I <= C0 + pl.cols + h)
        if self.block:
            Jl = torch.where(Jl == self.Hq8, torch.zeros_like(Jl), Jl)
        ok = (Jl >= 0) & (Jl < self.Hq8) & (I >= 0) & (I < self.Wqa)
        v = torch.where(ok, ec[Jl.clamp(0, self.Hq8 - 1), I.clamp(0, self.Wqa - 1)],
                        torch.zeros(()))
        return torch.where(tile, v, torch.full((), float("nan")))

    def _prolong(self, ec, R0, C0, gj, gi):
        o = self.op
        r, s, J, I = gj & 1, gi & 1, gj >> 1, gi >> 1
        nyc, nxc = o.ny // 2, o.nx // 2

        def rowmix(col):
            e0, e1 = self._coarse(ec, R0, C0, J, col), self._coarse(ec, R0, C0, J + 1, col)
            ecJ0 = torch.where(J == 0, e1, e0)
            ecJ1 = torch.where(J == nyc, e0, e1)
            return torch.where(r == 0, 0.75 * ecJ0 + 0.25 * ecJ1, 0.25 * ecJ0 + 0.75 * ecJ1)

        rm, rm1 = rowmix(I), rowmix(I + 1)
        m0 = torch.where(I == 0, rm1, rm)
        m1 = torch.where(I == nxc, rm, rm1)
        return torch.where(s == 0, 0.75 * m0 + 0.25 * m1, 0.25 * m0 + 0.75 * m1)

    def _tiles(self):
        return ((r0, c0) for r0, c0, _, _ in PL.carry_tiles(self.pl, self.op.qshape))

    def pre(self, p, b):
        P, B = _logical(p), _logical(b)
        out, rc = torch.full_like(P, float("nan")), torch.full(self.op.coarse_shape,
                                                                 float("nan"))
        for R0, C0 in self._tiles():
            oj, oi, gj, gi = self._grid(R0, C0)
            a, bb = self._load(P, oj, oi), self._load(B, oj, oi)
            a, lo = self._pairs(a, bb, gj, gi, 0)
            own, rows, cols = self._own(a, R0, C0)
            out[2 * R0 : 2 * (R0 + rows), 2 * C0 : 2 * (C0 + cols)] = own
            r = self._residual(a, bb, gj, gi, lo)
            h = self.pl.halo
            # coarse cell (Jc, Ic): children (2Jc, 2Ic), (2Jc, 2Ic - 1),
            # (2Jc - 1, 2Ic), (2Jc - 1, 2Ic - 1) at buffer rows 2h + 2r (- 1)
            hi, lo_ = r[2 * h :: 2], r[2 * h - 1 :: 2]
            v = 0.25 * (hi[:rows, 2 * h :: 2][:, :cols] + hi[:rows, 2 * h - 1 :: 2][:, :cols]
                        + lo_[:rows, 2 * h :: 2][:, :cols]
                        + lo_[:rows, 2 * h - 1 :: 2][:, :cols])
            Jc = self.row0 + R0 + torch.arange(rows)[:, None]
            Ic = C0 + torch.arange(cols)[None, :]
            interior = (Jc >= 1) & (Jc <= self.op.ny // 2) & (Ic >= 1) & (Ic <= self.op.nx // 2)
            rc[R0 : R0 + rows, C0 : C0 + cols] = torch.where(interior, v, torch.zeros(()))
        return _quad(out), rc

    def post(self, p, b, ec):
        P, B = _logical(p), _logical(b)
        out, res = torch.full_like(P, float("nan")), torch.zeros(())
        for R0, C0 in self._tiles():
            oj, oi, gj, gi = self._grid(R0, C0)
            a, bb = self._load(P, oj, oi), self._load(B, oj, oi)
            jl = gj - 2 * self.row0
            add = self._fluid(gj, gi) & (jl >= 0) & (jl < 2 * self.Hq8)
            a = torch.where(add, a + self._prolong(ec, R0, C0, gj, gi), a)
            a, lo = self._pairs(a, bb, gj, gi, 1)
            own, rows, cols = self._own(a, R0, C0)
            out[2 * R0 : 2 * (R0 + rows), 2 * C0 : 2 * (C0 + cols)] = own
            r, _, _ = self._own(self._residual(a, bb, gj, gi, lo).abs(), R0, C0)
            J = R0 + torch.arange(rows).repeat_interleave(2)[:, None]
            if self.block:
                r = torch.where((J >= self.halo) & (J < self.Hq8 - self.halo), r,
                                torch.zeros(()))
            res = torch.maximum(res, r.max())
        return _quad(out), res


# ---------------------------------------------------------------- the cases

def _level0(nx, ny, n_pre, n_post, mdy=None):
    """(pre, post) twins of the step at nx x ny: the whole field's (mdy
    None) or one shard's local block on an mdy-way mesh, and the shard
    dims (Hq8s, P, Wqa)."""
    case = make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid", dtype=torch.float32,
                                    device="cpu")
    g = case.grid
    step_i, inlet_j = step_rect_params(g)
    mg = case.poisson_solve
    mg = getattr(mg, "mg", mg)
    consts = (g.shape, step_i, inlet_j, mg.pre0.idx2, mg.pre0.idy2, mg.pre0.omega)
    if mdy is None:
        coarse = mg.pre0.coarse_shape
        return (TS.make_quad_step_pre_smooth_restrict(*consts, n_pre, coarse),
                TS.make_quad_step_post_prolong_smooth(*consts, n_post, coarse), None)
    dims = TQ.quad_shard_dims(g.shape, mdy)
    loc, shard = (dims[1] + 2 * H, dims[2]), (dims[1], mdy)
    return (TS.make_quad_step_pre_smooth_restrict(*consts, 1, loc, shard=shard),
            TS.make_quad_step_post_prolong_smooth(*consts, 1, loc, shard=shard), dims)


def _inputs(op, seed):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy((rng.standard_normal(op.qshape) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(op.qshape) * 1e2).astype(np.float32))
    ec = torch.from_numpy((rng.standard_normal(op.coarse_shape) * 0.1).astype(np.float32))
    return p, b, ec


def _check(pre, post, tile, row0=0, halo=0, seed=0):
    p, b, ec = _inputs(pre, seed)
    block = halo > 0
    mp = Mirror(pre, PL.level0_plan(pre.qshape, pre.n_pairs, False, masked=True, block=block,
                                     tile=tile),
                row0, halo)
    mq = Mirror(post, PL.level0_plan(post.qshape, post.n_pairs, True, masked=True, block=block,
                                      tile=tile),
                row0, halo)
    if halo:
        want_pre, want_post = pre.plain(row0, p, b), post.plain(row0, p, b, ec)
    else:
        want_pre, want_post = pre.plain(p, b), post.plain(p, b, ec)
    for got, want in ((mp.pre(p, b), want_pre), (mq.post(p, b, ec), want_post)):
        for a, w in zip(got, want, strict=True):
            assert torch.equal(a, w), float((a - w).abs().max())


@pytest.mark.parametrize("tile", [None, (3, 5), (4, 24), (100, 300)])
@pytest.mark.parametrize("n_pre,n_post", [(1, 2), (1, 1), (2, 2)])
def test_mirror_equals_the_twins_on_a_whole_field(tile, n_pre, n_post):
    pre, post, _ = _level0(64, 16, n_pre, n_post)
    _check(pre, post, tile, seed=n_pre + 3 * n_post)


# 512x64 on 4 shards: P = 16 plane rows; inlet_j 32, so the corner row
# (plane row 16) is shard 1's first own row, local row 8: a tile edge
# under 8-row tiles, inside a 5-row tile
@pytest.mark.parametrize("jy", [0, 1, 3])
@pytest.mark.parametrize("tile", [None, (8, 32), (5, 24), (3, 7)])
def test_mirror_equals_the_twins_on_a_4_shard_512x64_mesh(jy, tile):
    pre, post, (_, P, _) = _level0(512, 64, 1, 1, mdy=4)
    _check(pre, post, tile, row0=jy * P - H, halo=H, seed=10 * jy)


def test_the_corner_row_falls_on_a_tile_edge_of_shard_1():
    pre, _, (_, P, _) = _level0(512, 64, 1, 1, mdy=4)
    corner = pre.inlet_j // 2  # the plane row of the corner cell (inlet_j, step_i)
    local = corner - (P - H)
    assert local == 8 and local % 8 == 0 and local % 5 != 0


@pytest.mark.parametrize("jy", [0, 1])
@pytest.mark.parametrize("tile", [None, (4, 8), (3, 3)])
def test_mirror_equals_the_twins_on_a_2_shard_32x8_mesh(jy, tile):
    pre, post, (_, P, _) = _level0(32, 8, 1, 1, mdy=2)
    _check(pre, post, tile, row0=jy * P - H, halo=H, seed=20 + jy)
