"""The natural layout's pressure solves (their plain twins on the CPU)
against cfd_tpu's, the reference's Pallas kernels in interpret mode:

- the aligned separable solve, MultigridPoisson without quad_level0,
  against make_multigrid_poisson(aligned_io=True, use_pallas=True,
  pallas_interpret=True): the 2-level hierarchy of the natural auto sizes
  (n = 30; the 64x30 channel's runs in tests/test_torch_natural_channel.py),
  3 levels, tail_from on 4, the bf16 coarse hierarchy and pin_mean on a
  pure-Neumann problem on 3;
- the step's natural masked solve, make_masked_multigrid_poisson, against
  the reference's with smoother_mode="interpret": on the 2 levels of the
  natural 64x14, plain and with corr_opt, and on 3 (64x16: a smoothed
  coarse level, which no natural size has).

Bands: equal V-cycle counts; p within 2e-6 of its scale (ROADMAP.md
section C, smoothed p 5e-7 to 2e-6); both final residuals at or below the
tolerance they stopped under and within 15% of it of each other (at ten
times the float32 roundoff of A p the residual differs by up to 10%
between the two packages, tests/test_torch_channel_slice.py; with the bf16
hierarchy by up to 24% of its own value, because the port rounds the
prolonged bf16 correction once and XLA after each operation). Every solve
stops at its tolerance, above the float32 floor, where the exit cycle does
not flip on ulps; the 2-level cavity runs at tol 1e-4 for that reason (at
1e-5 its eighth cycle ends within 0.2% of the tolerance)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.bc import step_pressure_ghosts as jax_step_ghosts
from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step_case
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch.grid import Grid
from cfd_tpu_torch.kernels.projection import aligned_shape
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.poisson import multigrid as TM

torch.set_num_threads(1)


def _source(nx, ny, seed, neumann=False):
    H8, W = aligned_shape((ny + 2, nx + 2))
    rng = np.random.default_rng(seed)
    b = np.zeros((H8, W), np.float32)
    b[1 : ny + 1, 1 : nx + 1] = rng.standard_normal((ny, nx))
    if neumann:  # compatible: zero mean
        b[1 : ny + 1, 1 : nx + 1] -= b[1 : ny + 1, 1 : nx + 1].mean()
    p = np.zeros((H8, W), np.float32)
    p[: ny + 2, : nx + 2] = rng.standard_normal((ny + 2, nx + 2)) * 0.01
    return p, b


SOLVES = {
    "cavity 16 (3 levels)": ("cavity_problem", 16, 16, 1e-5, {}, 3),
    "cavity 30 (2 levels)": ("cavity_problem", 30, 30, 1e-4, {}, 2),
    "cavity 32 tail_from=1": ("cavity_problem", 32, 32, 1e-5, {"tail_from": 1}, 4),
    "cavity 16 bf16": ("cavity_problem", 16, 16, 1e-5, {"coarse_dtype": "bfloat16"}, 3),
    "neumann 16 pin_mean": ("neumann_problem", 16, 16, 1e-5, {"pin_mean": True}, 3),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_aligned_solve_matches_jax(name):
    flavor, nx, ny, tol, knobs, n_levels = SOLVES[name]
    dx, dy = 1.0 / nx, 0.5 / ny
    p, b = _source(nx, ny, seed=nx + ny, neumann=flavor == "neumann_problem")
    jsolve = JM.make_multigrid_poisson(
        getattr(JM, flavor)(nx, ny, dx, dy), JM.MGConfig(tol_factor=tol, **knobs),
        jnp.float32, aligned_io=True, use_pallas=True, pallas_interpret=True)
    jp, jc, jr = jsolve(jnp.asarray(p), jnp.asarray(b))
    solve = TM.make_multigrid_poisson(getattr(TM, flavor)(nx, ny, dx, dy),
                                      TM.MGConfig(tol_factor=tol, **knobs))
    assert solve.aligned and len(solve.levels) == n_levels
    assert (solve.tail_from is not None) == ("tail_from" in knobs)
    tp, tc, tr = solve(torch.from_numpy(p), torch.from_numpy(b))
    assert tc == int(jc)
    scale = float(np.abs(np.asarray(jp)).max())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-6 * scale)
    stop = tol * float(np.abs(b).max())
    assert tr <= stop and float(jr) <= stop
    assert abs(tr - float(jr)) <= 0.15 * stop


def test_aligned_solve_masks_the_warm_start():
    """The warm start is masked to the interior (multigrid.py:843-847):
    ghosts and padding in p_warm change nothing."""
    n = 30
    p, b = _source(n, n, seed=3)
    solve = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n),
                                      TM.MGConfig(tol_factor=1e-4))
    inner = torch.from_numpy(p).clone()
    outer = torch.ones_like(inner) * 7.0
    outer[1 : n + 1, 1 : n + 1] = inner[1 : n + 1, 1 : n + 1]
    inner[0], inner[n + 1], inner[:, 0], inner[:, n + 1] = 0, 0, 0, 0
    a = solve(inner, torch.from_numpy(b))
    c = solve(outer, torch.from_numpy(b))
    assert a[1:] == c[1:] and torch.equal(a[0], c[0])


def test_aligned_solve_cycle_twin_is_the_wrapper():
    """cycle(plain=True) and the dispatching cycle agree on the CPU (the
    card holds the kernels to the same twins)."""
    n = 32
    p, b = _source(n, n, seed=5)
    solve = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), TM.MGConfig())
    pt, bt = torch.from_numpy(p), torch.from_numpy(b)
    p1, r1 = solve.cycle(pt, bt)
    p2, r2 = solve.cycle(pt, bt, plain=True)
    assert torch.equal(p1, p2) and torch.equal(r1, r2)


@pytest.mark.parametrize("knobs, err, match", [
    ({"pin_mean": True}, ValueError, "pin_mean only for pure-Neumann"),
    ({"corr_opt": True}, ValueError, "corr_opt is a masked defect-correction knob"),
    ({"coarse_dtype": "bfloat16", "tail_from": 1}, ValueError, "incompatible"),
])
def test_aligned_solve_rules(knobs, err, match):
    """The reference's refusals (multigrid.py:652-674) on the cavity's
    problem, which is not pure Neumann."""
    n = 32
    with pytest.raises(err, match=match):
        TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n),
                                  TM.MGConfig(**knobs))


def test_aligned_solve_needs_a_coarsening():
    with pytest.raises(ValueError, match="at least 2 levels"):
        TM.make_multigrid_poisson(TM.cavity_problem(63, 63, 1 / 63, 1 / 63), TM.MGConfig())


MASKED = {
    "64x14 (2 levels)": (64, 14, {}, 2),
    "64x14 corr_opt (2 levels)": (64, 14, {"corr_opt": True}, 2),
    "64x16 (3 levels)": (64, 16, {}, 3),
}


def _step_grid(nx, ny):
    jcase = jax_step_case(nx=nx, ny=ny, dtype=jnp.float32, poisson="multigrid",
                          smoother_mode="off")
    g = jcase.grid
    tg = Grid.masked(nx, ny, 8.0, 2.0, g.fluid[1:-1, 1:-1].copy())
    c = StencilCoeffs(dx=g.dx, dy=g.dy, dt=jcase.coeffs.dt, viscosity=jcase.coeffs.viscosity)
    return jcase, tg, c


@pytest.mark.parametrize("name", list(MASKED))
def test_masked_natural_solve_matches_jax(name):
    nx, ny, knobs, n_levels = MASKED[name]
    tol = 1e-5
    jcase, tg, c = _step_grid(nx, ny)
    g = jcase.grid
    rng = np.random.default_rng(ny)
    b = np.where(g.cell_mask, rng.standard_normal(g.shape), 0.0)
    b = np.where(g.cell_mask, b - b[g.cell_mask].mean(), 0.0).astype(np.float32)
    p = np.zeros(g.shape, np.float32)
    jsolve = JM.make_masked_multigrid_poisson(g, jcase.coeffs,
                                              JM.MGConfig(tol_factor=tol, **knobs),
                                              jax_step_ghosts(g), dtype=jnp.float32,
                                              smoother_mode="interpret")
    jp, jc, jr = jsolve(jnp.asarray(p), jnp.asarray(b))
    solve = TM.make_masked_multigrid_poisson(tg, c, TM.MGConfig(tol_factor=tol, **knobs))
    assert len(solve.levels) + 1 == n_levels
    tp, tc, tr = solve(torch.from_numpy(p), torch.from_numpy(b))
    assert tc == int(jc)
    scale = float(np.abs(np.asarray(jp)).max())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-6 * scale)
    stop = tol * float(np.abs(b).max())
    assert tr <= stop and float(jr) <= stop
    assert abs(tr - float(jr)) <= 0.15 * stop


@pytest.mark.parametrize("knobs, err", [({"coarse_dtype": "bfloat16"}, ValueError),
                                        ({"pin_mean": True}, None)])
def test_masked_natural_solve_rules(knobs, err):
    """coarse_dtype needs the aligned path (the reference's ValueError,
    multigrid.py:652-654); pin_mean is ignored, as the reference's masked
    solves never read it: the solve equals the one without it."""
    _, tg, c = _step_grid(64, 14)
    if err is not None:
        with pytest.raises(err):
            TM.make_masked_multigrid_poisson(tg, c, TM.MGConfig(**knobs))
        return
    rng = np.random.default_rng(3)
    b = torch.from_numpy(np.where(tg.cell_mask, rng.standard_normal(tg.shape), 0.0)
                         .astype(np.float32))
    p0 = torch.zeros_like(b)
    got = TM.make_masked_multigrid_poisson(tg, c, TM.MGConfig(tol_factor=1e-4, **knobs))(p0, b)
    want = TM.make_masked_multigrid_poisson(tg, c, TM.MGConfig(tol_factor=1e-4))(p0, b)
    assert got[1:] == want[1:] and torch.equal(got[0], want[0])


def test_masked_natural_solve_ignores_tail_from():
    """use_pallas is False on the masked levels, so tail_from is ignored
    (multigrid.py:689-694): the solve equals the one without it."""
    _, tg, c = _step_grid(64, 28)
    rng = np.random.default_rng(1)
    b = torch.from_numpy(np.where(tg.cell_mask, rng.standard_normal(tg.shape), 0.0)
                         .astype(np.float32))
    p0 = torch.zeros_like(b)
    cfg = TM.MGConfig(tol_factor=1e-4)
    a = TM.make_masked_multigrid_poisson(tg, c, cfg)(p0, b)
    t = TM.make_masked_multigrid_poisson(tg, c, dataclasses.replace(cfg, tail_from=1))(p0, b)
    assert a[1:] == t[1:] and torch.equal(a[0], t[0])
