"""The natural layout's kernels on the card: the four stage kernels of
csrc/projection.cu, the with_residual pairs of csrc/rb_smoother.cu and the
step's exact masked pairs of csrc/step_smoother.cu (three variants), each
against its plain twin on the same seeded inputs at a small and at the
full-width shape; and the natural slices on the card against the CPU.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_natural_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so they are bit-identical (max error 0; the
limit is 1e-5 of the output's scale); card against CPU, equal cycles every
step and fields within 5e-5 of their scale (the chip_smoke.py limits)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_backwards_step_case, make_cavity_case, make_channel_case
from cfd_tpu_torch.grid import Grid
from cfd_tpu_torch.kernels import projection as P
from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level
from cfd_tpu_torch.kernels.step_smoother import make_step_masked_pairs
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same(got, want, what, tol=1e-5):
    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    assert got.shape == want.shape, what
    assert bool(torch.isfinite(got).all()), what
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{what}: {err} of {scale}"


def _aligned(shape, n, seed, dev, scale=0.1):
    H8, W = P.aligned_shape(shape)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = np.zeros((H8, W), np.float32)
        a[: shape[0], : shape[1]] = rng.standard_normal(shape) * scale
        out.append(torch.from_numpy(a).to(dev))
    return out


STAGES = {"cavity small": (64, 64), "cavity full": (2048, 2048),
          "channel small": (64, 30), "channel full": (1536, 512)}


@pytest.mark.parametrize("name", list(STAGES))
def test_stage_kernels_match_their_twins(dev, name):
    nx, ny = STAGES[name]
    shape = (ny + 2, nx + 2)
    c = StencilCoeffs(dx=1.0 / nx, dy=0.5 / ny, dt=1e-4, viscosity=1e-3)
    u, v, p, pp = _aligned(shape, 4, nx + ny, dev)
    if name.startswith("cavity"):
        stages = (P.make_predictor_source(shape, c), P.make_corrector(shape, c))
    else:
        stages = (P.make_channel_predictor_source(shape, c), P.make_channel_corrector(shape, c))
    for stage, args in ((stages[0], (u, v)), (stages[1], (u, v, p, pp))):
        what = f"{name} {type(stage).__name__}"
        got, want = stage.kernel(*args), stage.plain(*args)
        torch.cuda.synchronize()
        for k, (g, w) in enumerate(zip(got, want, strict=True)):
            _same(g, w, f"{what} output {k}")


@pytest.mark.parametrize("n", [32, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rb_pairs_with_residual_matches_its_twin(dev, n, dtype):
    lv = TM._build_level(TM.cavity_problem(n, n, 1 / n, 1 / n), dtype, dev)
    rng = np.random.default_rng(n)
    a = np.zeros(lv.shape, np.float32)
    a[1 : n + 1, 1 : n + 1] = rng.standard_normal((n, n))
    p = torch.from_numpy(a * 0.01).to(dev, dtype)
    b = torch.from_numpy(a * 10.0).to(dev, dtype)
    sm = rb_pairs_for_level(lv, 1.0, 1, with_residual=True)
    (gp, gr), (wp, wr) = sm.kernel(p, b), sm.plain(p, b)
    torch.cuda.synchronize()
    _same(gp, wp, "p")
    assert gr.dim() == 0 and float(gr) == float(wr)


def _step_grid(nx, ny):
    """The step factory's geometry (backwards_step-01.cpp:387,493,508-520):
    (grid, step_i, inlet_j_max)."""
    dx, dy = 8.0 / nx, 2.0 / ny
    step_i, inlet = int(2.0 / dx), int(1.0 / dy)
    jj, ii = np.arange(1, ny + 1)[:, None], np.arange(1, nx + 1)[None, :]
    fluid = np.ascontiguousarray(np.broadcast_to(np.where(ii <= step_i, jj <= inlet, True),
                                                 (ny, nx)))
    g = Grid.masked(nx, ny, 8.0, 2.0, fluid)
    assert TM.step_rect_params(g) == (step_i, inlet)
    return g, step_i, inlet


@pytest.mark.parametrize("nx, ny", [(64, 14), (512, 30)])
@pytest.mark.parametrize("variant", ["plain", "with_residual_field", "with_residual"])
def test_step_masked_pairs_match_their_twin(dev, nx, ny, variant):
    g, step_i, inlet = _step_grid(nx, ny)
    dx, dy = g.dx, g.dy
    kw = {} if variant == "plain" else {variant: True}
    pairs = make_step_masked_pairs(g.shape, step_i, inlet, 1 / dx**2, 1 / dy**2, 1.0, 2,
                                   device=dev, **kw)
    rng = np.random.default_rng(ny)
    p = torch.from_numpy(rng.standard_normal(g.shape).astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.standard_normal(g.shape) * 10).astype(np.float32)).to(dev)
    got, want = pairs.kernel(p, b), pairs.plain(p, b)
    torch.cuda.synchronize()
    if variant == "plain":
        got, want = (got,), (want,)
    for k, (gg, ww) in enumerate(zip(got, want, strict=True)):
        _same(gg, ww, f"{variant} output {k}")


def test_masked_natural_solve_runs_the_full_2d_pairs_on_its_coarse_levels(dev):
    """A masked natural solve with smoothed coarse levels (a grid built
    directly: every natural step size has 2 levels) runs RBPairs' full-2D
    kernel there on the card, and matches the CPU's solve."""
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.kernels.rb_smoother import RB_PAIRS_FULL

    g, _, _ = _step_grid(128, 32)
    c = StencilCoeffs(dx=g.dx, dy=g.dy, dt=1e-3, viscosity=0.01)
    rng = np.random.default_rng(32)
    fluid = g.cell_mask
    b = np.where(fluid, rng.standard_normal(g.shape), 0.0)
    b = torch.from_numpy(np.where(fluid, b - b[fluid].mean(), 0.0).astype(np.float32))
    cfg = TM.MGConfig(tol_factor=1e-5, abs_tol=0.0)
    out = {}
    for where in ("cuda", "cpu"):
        solve = TM.make_masked_multigrid_poisson(g, c, cfg, device=where)
        assert len(solve.levels) >= 2
        for k in KERNELS:
            k.launches = 0
        p, cycles, res = solve(torch.zeros_like(b).to(where), b.to(where))
        out[where] = (p, cycles, RB_PAIRS_FULL.launches)
    (pg, cg, ng), (pc, cc, nc) = out["cuda"], out["cpu"]
    assert ng > 0 and nc == 0
    assert cg == cc
    _same(pg, pc, "p", tol=5e-5)


SLICES = {
    "cavity aligned 64": (make_cavity_case, dict(n_interior=64, layout="aligned",
                                                 tolerance_factor=1e-6)),
    "cavity auto 46": (make_cavity_case, dict(n_interior=46, tolerance_factor=1e-6)),
    "channel auto 128x30": (make_channel_case, dict(nx=128, ny=30, tolerance_factor=1e-6,
                                                    abs_tol=0.0)),
    "step auto 128x14": (make_backwards_step_case, dict(nx=128, ny=14, tolerance_factor=1e-6,
                                                        abs_tol=0.0)),
}


@pytest.mark.parametrize("name", list(SLICES))
def test_natural_slice_card_matches_cpu(dev, name):
    make, kw = SLICES[name]
    out = {}
    for where in ("cuda", "cpu"):
        case = make(dtype=torch.float32, device=where, poisson="multigrid", print_interval=10,
                    **kw)
        assert not case.carry_tentative
        sim = Simulation(case, log=lambda m: None)
        st = sim._logical(sim.run(n_steps=10))
        out[where] = (sim.step_iters, st)
    (it_g, st_g), (it_c, st_c) = out["cuda"], out["cpu"]
    assert it_g == it_c
    for f in ("u", "v", "p"):
        _same(getattr(st_g, f), getattr(st_c, f), f, tol=5e-5)
