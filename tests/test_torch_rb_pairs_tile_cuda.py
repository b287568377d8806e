"""The coarse red/black smoother's tile kernel (csrc/rb_smoother.cu: one
launch of shared-memory tiles a call, kernels/plan.py pairs_plan) against
its plain PyTorch twin (kernels/rb_smoother.py RBPairs.plain) on the card,
bit for bit (torch.equal): at every level shape that the four flows'
per-kernel solves smooth at their main widths (the cavity 2048^2 with the
float32 and the bfloat16 hierarchy, the channel and RB 1536x512, the step
2048x256 on its full-2D masked levels), the natural cavity's level 0 and
the natural masked solve's levels, in the three variants at n_pairs 1-3;
under tiles whose edges fall on the interior's last row or column, ragged
tiles and one larger than the level; and one device operation a call,
counted by torch.profiler in a child process (python -m
cfd_tpu_torch.time_pairs), as chip_smoke.py counts it.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_rb_pairs_tile_cuda.py
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch import cases
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import rb_smoother as TR
from cfd_tpu_torch.kernels.mg_tail import level_masks

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {"plain": {}, "field": {"with_residual_field": True}, "res": {"with_residual": True}}
# (name, factory, kwargs): the per-kernel solves of the main widths and the
# natural cavity (its level 0 smoothed by the pairs too)
SOLVES = [
    ("cavity f32", "make_cavity_case", dict(n_interior=2048, mg_overrides={"whole_solve": False})),
    ("cavity bf16", "make_cavity_case",
     dict(n_interior=2048, mg_overrides={"whole_solve": False, "coarse_dtype": "bfloat16"})),
    ("channel", "make_channel_case", dict(nx=1536, ny=512, mg_overrides={"whole_solve": False})),
    ("rb", "make_rayleigh_benard_case",
     dict(nx=1536, ny=512, rayleigh=1e6, mg_overrides={"whole_solve": False})),
    ("step", "make_backwards_step_case", dict(nx=2048, ny=256, mg_overrides={"whole_solve": False})),
    ("natural cavity", "make_cavity_case", dict(n_interior=2048, layout="aligned")),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _masked_natural_solve(device, nx=512, ny=64):
    """The natural masked solve of a 512x64 step (5 levels, its coarse ones
    on the full-2D pairs), built directly as chip_smoke.py phase 27 builds
    it: every natural step size has 2 levels."""
    from cfd_tpu_torch.grid import Grid
    from cfd_tpu_torch.ops.stencil import StencilCoeffs
    from cfd_tpu_torch.poisson.multigrid import MGConfig, make_masked_multigrid_poisson

    dx, dy = 8.0 / nx, 2.0 / ny
    step_i, inlet = int(2.0 / dx), int(1.0 / dy)
    jj, ii = np.arange(1, ny + 1)[:, None], np.arange(1, nx + 1)[None, :]
    fluid = np.broadcast_to(np.where(ii <= step_i, jj <= inlet, True), (ny, nx))
    grid = Grid.masked(nx, ny, 8.0, 2.0, np.ascontiguousarray(fluid))
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=1e-3, viscosity=0.01)
    return make_masked_multigrid_poisson(grid, coeffs, MGConfig(tol_factor=1e-6, abs_tol=0.0),
                                         device=device)


@functools.lru_cache(maxsize=None)
def _levels(name):
    if name == "natural masked":
        solve = _masked_natural_solve("cuda")
        return list(solve.levels[:-1]), solve.cfg.omega
    _, factory, kw = next(s for s in SOLVES if s[0] == name)
    kw = dict(kw)
    if name != "rb":
        kw["poisson"] = "multigrid"
    solve = getattr(cases, factory)(device="cuda", dtype=torch.float32, **kw).poisson_solve
    levels = list(solve.levels)
    if name == "natural cavity":
        return [levels[0]], solve.cfg.omega
    if name == "step":
        return levels[:-1], solve.cfg.omega
    return levels[1:-1], solve.cfg.omega


def _inputs(lv, seed):
    rng = np.random.default_rng(seed)
    active = level_masks(lv, "cuda")[1]
    p, b = (torch.from_numpy((rng.standard_normal(lv.shape) * s).astype(np.float32)).cuda()
            for s in (0.1, 1e2))
    # p everywhere (the inactive cells keep it), b on the active cells
    return p.to(lv.dtype), (b * active).to(lv.dtype)


def _equal(op, p, b):
    got, want = op(p, b), op.plain(p, b)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), float((g.float() - w.float()).abs().max())


def _counter(op):
    if op.full:
        return TR.RB_PAIRS_FULL
    return TR.RB_PAIRS_RES if op.with_residual else TR.RB_PAIRS


@pytest.mark.cuda
@pytest.mark.parametrize("name", [s[0] for s in SOLVES] + ["natural masked"])
@pytest.mark.parametrize("n_pairs", [1, 2, 3])
def test_pairs_bit_identical_at_every_level(cuda_device, name, n_pairs):
    levels, omega = _levels(name)
    for k, lv in enumerate(levels):
        p, b = _inputs(lv, 100 * k + n_pairs)
        for variant, kw in VARIANTS.items():
            if variant == "res" and not lv.separable:
                continue
            op = TR.rb_pairs_for_level(lv, omega, n_pairs, **kw)
            kern = _counter(op)
            before = kern.launches
            _equal(op, p, b)
            assert kern.launches == before + 1


# (name, level index, tile): tile edges on the last interior row and
# column (the cavity's level 3, 256 x 256 in a 264 x 384 array: 8 rows
# divide 256, 257 columns end on nx, one column ends on every column),
# ragged tiles, a tile larger than the level (cut to it: one tile) and the
# step's masked level 1 in small and odd tiles
TILE_CASES = [("cavity f32", 2, (8, 257)), ("cavity f32", 2, (32, 1)), ("cavity bf16", 0, (5, 7)),
              ("channel", 0, (11, 20)), ("cavity f32", 6, (1000, 5000)), ("step", 0, (5, 7)),
              ("step", 0, (16, 129)), ("rb", 3, (3, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,tile", TILE_CASES)
def test_pairs_bit_identical_under_other_tiles(cuda_device, name, k, tile):
    levels, omega = _levels(name)
    lv = levels[k]
    p, b = _inputs(lv, k)
    for n_pairs in (1, 2):
        for variant, kw in VARIANTS.items():
            if variant == "res" and not lv.separable:
                continue
            op = TR.rb_pairs_for_level(lv, omega, n_pairs, **kw)
            op._tile_plan = PL.pairs_plan(lv.shape, n_pairs, variant != "plain", op.full,
                                          tile=tile)
            _equal(op, p, b)
            if tile == (1000, 5000):
                assert (op._tile_plan.grid_x, op._tile_plan.grid_y) == (1, 1)


def test_masked_natural_solve_smooths_full_2d_levels():
    solve = _masked_natural_solve("cpu")
    assert len(solve.levels) + 1 == 5
    assert all(not lv.separable for lv in solve.levels[:-1])
    assert all(m.full for m in solve.pre) and len(solve.pre) == len(solve.levels) - 1


def test_tile_cases_reach_the_edges():
    # level 3 of the 2048^2 cavity: interior rows and columns 1..256 in
    # (264, 384); the 8 x 257 tiles start a tile row on row 256, the last
    # interior row, and end their first tile column on column 256, the
    # second starting at nx + 1
    H8, W = 264, 384
    pl = PL.pairs_plan((H8, W), 1, False, False, tile=(8, 257))
    tiles = list(PL.carry_tiles(pl, (1, H8, W)))
    assert any(r0 + rows == 256 for r0, _, rows, _ in tiles)
    assert any(c0 == 257 for _, c0, _, _ in tiles)


@pytest.mark.cuda
def test_pairs_with_residual_leaves_its_accumulator_at_zero(cuda_device):
    levels, omega = _levels("natural cavity")
    lv = levels[0]
    p, b = _inputs(lv, 7)
    op = TR.rb_pairs_for_level(lv, omega, 1, with_residual=True)
    for _ in range(3):
        _equal(op, p, b)
        assert op._max_acc[str(p.device)].tolist() == [0, 0]


@pytest.mark.cuda
def test_pairs_one_launch_a_call(cuda_device):
    # a fresh process: a process's later torch.profiler traces have come
    # back without device events on the H100 machine, its first has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_pairs", "cardtest",
                          "--only", "5,5-post,5b,5b-post,5-wr", "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [r["row"] for r in lines] == ["5", "5-post", "5b", "5b-post", "5-wr"]
    for r in lines:
        assert r["launches_a_call"] == 1 and "pairs_kernel" in r["ops"][0], r
