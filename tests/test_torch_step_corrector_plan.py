"""The launch plan of the backward step's corrector (rows 9b and 9b+,
csrc/step_stage.cu step_corrector_kernel, kernels/plan.py
step_corrector_plan) and a torch mirror of its threads against the unedited
plain twins (kernels/step_quad.py QuadStepCorrector.plain,
QuadStepCorrectorTraced.plain), on the CPU.

The plans: at the 2048x256 step's (4, 136, 1152), the CPU sizes of
tests/test_torch_step.py and ragged sizes with odd nx and odd ny, every
quad element belongs to exactly one thread (a thread takes all four quads
of its plane cell) and the grid is the plane columns and rows divided by
the block.

The mirror runs what each thread runs: a plane cell whose four cells are
all interior faces of u and v (the kernel's predicate, once a thread)
corrects them by u_corr_formula, v_corr_formula from its registers, its
quads of us, vs and p, p's two quads east and two north, every other
element read as NaN; any other takes step_uv_at on each cell with reads of
rows 2J - 1 .. 2J + 2 and columns 2I - 1 .. 2I + 2, 0 outside the array
(qld) and NaN elsewhere; a plane cell wholly in the padding writes zeros.
It is held bit for bit (torch.equal) to the twins, fixed and traced dt, at
sizes and step rectangles whose test-free cells end on the inlet column,
the outlet columns nx and nx + 1, the rows 0, ny and ny + 1, odd and even
step_i and inlet_j and the padding. Every element the predicate sends down
the test-free path also gives the same bits on the guarded path."""

import re

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.kernels._build import CSRC
from cfd_tpu_torch.kernels.quad import quad_shape
from cfd_tpu_torch.ops.stencil import StencilCoeffs

from test_torch_level0_plan import _logical, _quad

torch.set_num_threads(1)

# ------------------------------------------------------------------ the plans

QSHAPES = {
    "step-2048x256": quad_shape((258, 2050)),
    "cpu-step-64x16": quad_shape((18, 66)),
    "cpu-step-256x32": quad_shape((34, 258)),
    "ragged-odd-63x15": quad_shape((17, 65)),
    "ragged-odd-301x45": quad_shape((47, 303)),
}
# (plane rows, plane columns)
BLOCKS = [None, (1, 32), (4, 64), (3, 96), (7, 5), (1, 1024), (1, 1)]


def _threads(pl, qshape):
    """The plane cell (J, I) of each thread that lies in the field, in the
    kernel's walk: the grid's thread (x, y) takes (J, I) = (y, x), one past
    the field returns at once."""
    _, Hq8, Wqa = qshape
    for y in range(pl.grid_rows * pl.rows):
        for x in range(pl.grid_cols * pl.cols):
            if y < Hq8 and x < Wqa:
                yield y, x


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("which", sorted(QSHAPES))
def test_every_quad_element_belongs_to_one_thread(which, block):
    qshape = QSHAPES[which]
    _, Hq8, Wqa = qshape
    pl = PL.step_corrector_plan(qshape, block)
    assert (pl.rows, pl.cols) == (block or PL.STEP_CORRECTOR_BLOCK)
    # the grid: the field's plane rows and columns over the block, as the C
    # entry points form it
    assert (pl.grid_rows, pl.grid_cols) == (-(-Hq8 // pl.rows), -(-Wqa // pl.cols))
    hits = np.zeros((Hq8, Wqa), np.int32)
    for J, I in _threads(pl, qshape):
        hits[J, I] += 1  # all four quads of it
    assert (hits == 1).all()


def test_the_main_shape_launches_whole_warps_along_a_plane_row():
    pl = PL.step_corrector_plan(QSHAPES["step-2048x256"])
    assert pl.cols % 32 == 0 and 1152 % pl.cols == 0


@pytest.mark.parametrize("block", [(4, 0), (0, 4), (32, 64), (1, 1025)])
def test_plan_refuses_a_block_of_no_thread_or_past_1024(block):
    with pytest.raises(ValueError, match="step corrector"):
        PL.step_corrector_plan((4, 136, 1152), block)


# ------------------------------------------------------------ the entry points


def _body(text, head):
    return re.search(rf"{head}\(.*?\n}}\n", text, re.S).group(0)


def _code(body):
    return "\n".join(l.split("//")[0] for l in body.splitlines())


@pytest.mark.parametrize("entry", ["cfd_step_corrector", "cfd_step_corrector_traced"])
def test_one_launch_and_no_memset_in_the_entry_points(entry):
    text = (CSRC / "step_stage.cu").read_text()
    body = _code(_body(text, rf'extern "C" int {entry}'))
    assert "cudaMemset" not in body and "<<<" not in body
    assert re.search(r"step_corrector<(true|false)>\(", body)
    launch = _code(_body(text, r"cudaError_t step_corrector"))
    assert "cudaMemset" not in launch
    assert launch.count("<<<") == 1 and "step_corrector_kernel<kTraced><<<" in launch


def test_no_kernel_of_a_thread_a_quad_element_is_left():
    text = _code((CSRC / "step_stage.cu").read_text())
    assert "blocks_for(" not in text and "quad_cell(" not in text
    assert "corrector_cell" not in _code((CSRC / "step_carry.cuh").read_text())


# ---------------------------------------------------------------- the mirror


def _coeffs(ny, nx):
    dx, dy = 8.0 / nx, 2.0 / ny
    return StencilCoeffs(dx=dx, dy=dy, dt=0.05 * min(dx, dy), viscosity=0.01, density=1.0)


def _noise(shape, seed):
    """Seeded noise over the whole array, its padding included."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))


class Mirror:
    """The corrector's threads in torch, vectorised over the logical cells:
    each cell knows its thread's plane cell (J, I) and reads only that
    thread's reach."""

    def __init__(self, op, cu, cv):
        self.op, self.cu, self.cv = op, cu, cv
        _, Hq8, Wqa = op.qshape
        self.LJ, self.LI = 2 * Hq8, 2 * Wqa
        self.j = torch.arange(self.LJ)[:, None].expand(self.LJ, self.LI)
        self.i = torch.arange(self.LI)[None, :].expand(self.LJ, self.LI)
        self.J, self.I = self.j // 2, self.i // 2

    def interior(self):
        """csrc/step_stage.cu corrector_interior of each cell's plane cell."""
        op = self.op
        j0, j1, i0, i1 = 2 * self.J, 2 * self.J + 1, 2 * self.I, 2 * self.I + 1
        return ((j0 >= 1) & (j1 <= op.ny - 1) & (i0 >= 1) & (i1 <= op.nx - 1)
                & ((i0 > op.step_i) | (j1 < op.inlet_j)))

    def padding(self):
        return (2 * self.J > self.op.ny + 1) | (2 * self.I > self.op.nx + 1)

    def reader(self, A, box, hole=None):
        """A read at (jj, ii): NaN off the thread's ``box`` (rows, columns
        relative to 2J, 2I: (lo_j, hi_j, lo_i, hi_i)) or on its ``hole``,
        else 0 outside the array (qld), else A."""
        lo_j, hi_j, lo_i, hi_i = box
        bj, bi = 2 * self.J, 2 * self.I

        def read(jj, ii):
            inside = (jj >= 0) & (jj < self.LJ) & (ii >= 0) & (ii < self.LI)
            val = A[jj.clamp(0, self.LJ - 1), ii.clamp(0, self.LI - 1)]
            val = torch.where(inside, val, torch.zeros(()))
            reach = ((jj >= bj + lo_j) & (jj <= bj + hi_j) & (ii >= bi + lo_i)
                     & (ii <= bi + hi_i))
            if hole is not None:
                reach &= ~((jj == bj + hole[0]) & (ii == bi + hole[1]))
            return torch.where(reach, val, torch.full((), float("nan")))

        return read

    def formulas(self, us, vs, p):
        """u_corr_formula, v_corr_formula at every cell."""
        j, i = self.j, self.i
        u = us(j, i) - self.cu * (p(j, i + 1) - p(j, i))
        v = vs(j, i) - self.cv * (p(j + 1, i) - p(j, i))
        return u, v

    def step_uv_at(self, us, vs, p):
        """csrc/step_carry.cuh step_uv_at at every cell, branch for branch."""
        op, j, i = self.op, self.j, self.i
        ny, nx, si, ij = op.ny, op.nx, op.step_i, op.inlet_j
        zero = torch.zeros(())

        def u_corr_at(jj, ii):
            valid = ((jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx - 1)
                     & ~((ii < si) & (jj > ij)))
            return torch.where(valid, us(jj, ii) - self.cu * (p(jj, ii + 1) - p(jj, ii)), zero)

        def v_corr_at(jj, ii):
            valid = ((jj >= 1) & (jj <= ny - 1) & (ii >= 1) & (ii <= nx)
                     & ~((ii <= si) & (jj > ij)))
            return torch.where(valid, vs(jj, ii) - self.cv * (p(jj + 1, ii) - p(jj, ii)), zero)

        def row(jj, ii):
            ii = torch.where(ii == nx, nx - 1, ii)
            inlet = torch.where(jj <= ij, torch.tensor(op.uin, dtype=torch.float32), zero)
            return torch.where(ii == 0, inlet, u_corr_at(jj, ii))

        one, top = torch.ones_like(j), torch.full_like(j, ny)
        u = torch.where((j == 0) & (i <= nx), -row(one, i),
                        torch.where((j == ny + 1) & (i <= nx), -row(top, i),
                                    torch.where((j >= 1) & (j <= ny), row(j, i),
                                                u_corr_at(j, i))))
        u = torch.where((i == si) & (j > ij) & (j <= ny), zero, u)
        outlet = zero if nx == 0 else v_corr_at(j, torch.full_like(i, nx))
        v = torch.where((i == 0) & (j <= ny), zero,
                        torch.where((i == nx + 1) & (j <= ny), outlet,
                                    torch.where(((j == 0) | (j == ny)) & (i >= 1) & (i <= nx),
                                                zero, v_corr_at(j, i))))
        v = torch.where((j == ij) & (i >= 1) & (i <= si), zero, v)
        return u, v

    def run(self, us, vs, p):
        """(u, v) in the quad layout, as the kernel's threads write them."""
        US, VS, P = _logical(us), _logical(vs), _logical(p)
        # the test-free path: the registers (own quads; p's two quads north
        # and two east, not their corner)
        inner = self.formulas(self.reader(US, (0, 1, 0, 1)), self.reader(VS, (0, 1, 0, 1)),
                              self.reader(P, (0, 2, 0, 2), hole=(2, 2)))
        # the guarded path: step_uv_at through qld in the rows and columns it
        # reaches
        box = (-1, 2, -1, 2)
        guarded = self.step_uv_at(self.reader(US, box), self.reader(VS, box),
                                  self.reader(P, box))
        inside, pad = self.interior(), self.padding()
        out = []
        for a, g in zip(inner, guarded):
            a = torch.where(inside, a, torch.where(pad, torch.zeros(()), g))
            assert bool(torch.isfinite(a).all()), "a thread read past its reach"
            out.append(_quad(a))
        return tuple(out)

    def both_paths(self, us, vs, p):
        """(test-free, guarded, the predicate) on the whole arrays."""
        US, VS, P = _logical(us), _logical(vs), _logical(p)
        whole = (-self.LJ, self.LJ, -self.LI, self.LI)
        rd = [self.reader(a, whole) for a in (US, VS, P)]
        return self.formulas(*rd), self.step_uv_at(*rd), self.interior()


def _op(nx, ny, step_i, inlet_j, traced, uin=1.0):
    make = TS.QuadStepCorrectorTraced if traced else TS.QuadStepCorrector
    return make((ny + 2, nx + 2), _coeffs(ny, nx), step_i, inlet_j, uin)


def _inputs(op, seed, traced):
    fields = tuple(_noise(op.qshape, [seed, k]) for k in range(3))
    dt = torch.tensor(0.8 * op.coeffs.dt, dtype=torch.float32)
    return (dt, *fields) if traced else fields


def _mirror(op, args, traced):
    cu, cv = op._coeffs_at(args[0]) if traced else (op.cu, op.cv)
    return Mirror(op, cu, cv), args[1:] if traced else args


# (nx, ny, step_i, inlet_j). 64x16 (step 16, inlet 8; the CPU slice's): the
# test-free cells end on the inlet column (plane column 0 holds i = 0), on
# the outlet columns (plane column 32 holds nx = 64 and nx + 1) and on the
# rows 0, ny and ny + 1 (plane rows 0 and 8); 63x15, 61x13 and 65x17: odd,
# nx and nx + 1 in two plane columns, ny + 1 in the padding's first plane
# row; odd step_i and inlet_j (17, 7; 21, 9; 3: the corner cell on a plane
# column's odd quad and the interface row on a plane row's odd quad) and
# even ones (20, 5 and 33, 11 mixed); 130x20 and 256x32 with the padding
# columns from plane column 66 and 129; the 2048x256 step's own rectangle.
MIRROR_CASES = [
    (64, 16, 16, 8), (63, 15, 17, 7), (61, 13, 21, 9), (62, 14, 20, 5), (130, 20, 33, 11),
    (256, 32, 64, 16), (65, 17, 3, 12), (2048, 256, 512, 128),
]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("nx,ny,step_i,inlet_j", MIRROR_CASES)
def test_mirror_matches_the_twin_bit_for_bit(nx, ny, step_i, inlet_j, traced):
    op = _op(nx, ny, step_i, inlet_j, traced)
    args = _inputs(op, nx * ny + step_i, traced)
    m, fields = _mirror(op, args, traced)
    got, want = m.run(*fields), op.plain(*args)
    for name, g, w in zip(("u", "v"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))


@pytest.mark.parametrize("nx,ny,step_i,inlet_j", MIRROR_CASES[::2])
def test_the_predicate_sends_down_the_test_free_path_only_what_the_guarded_path_agrees_on(
        nx, ny, step_i, inlet_j):
    op = _op(nx, ny, step_i, inlet_j, True)
    args = _inputs(op, 7 * nx + ny, True)
    m, fields = _mirror(op, args, True)
    inner, guarded, inside = m.both_paths(*fields)
    assert bool(inside.any())
    for a, g in zip(inner, guarded):
        assert torch.equal(a[inside], g[inside])


def test_the_cases_put_the_paths_edges_where_they_say():
    # 64x16: the first test-free plane column is 1 (column 0 holds the
    # inlet), the last 31 (32 holds nx and nx + 1); the first test-free
    # plane row is 1 (row 0 holds the ghost row), the last 7 (8 holds ny
    # and ny + 1); past the corner (step_i 16) from plane column 9
    op = _op(64, 16, 16, 8, False)
    m = Mirror(op, op.cu, op.cv)
    inside = m.interior()[::2, ::2]  # a plane cell's quad 0
    rows = torch.nonzero(inside.any(1)).flatten()
    assert (int(rows.min()), int(rows.max())) == (1, 7)
    cols = torch.nonzero(inside.any(0)).flatten()
    assert (int(cols.min()), int(cols.max())) == (1, 31)
    top = inside[4:8]  # above inlet_j 8: rows j >= 8 lie on or over the solid
    assert not bool(top[:, :9].any()) and bool(top[:, 9:32].all())
    # 63x15: nx = 63 in plane column 31, nx + 1 in 32; ny = 15 in plane
    # row 7, ny + 1 = 16 in row 8, the padding from plane row 9
    op = _op(63, 15, 17, 7, False)
    m = Mirror(op, op.cu, op.cv)
    inside, pad = m.interior()[::2, ::2], m.padding()[::2, ::2]
    assert int(torch.nonzero(inside.any(0)).max()) == 30
    assert int(torch.nonzero(inside.any(1)).max()) == 6
    assert bool(pad[9:].all()) and not bool(pad[8, :32].any()) and bool(pad[:, 33:].all())
