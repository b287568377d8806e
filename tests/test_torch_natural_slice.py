"""The natural layout's slices against cfd_tpu on the CPU: 5 steps of the
same case from the same start in both packages, the JAX one with its
Pallas kernels in interpret mode (the cavity: step_kernel_mode="interpret";
the step: smoother_mode="interpret", which keeps the reference on its
natural path), the port with its plain twins:

- the cavity with layout="aligned" at 32^2 and by the auto rule at
  n_interior=30 (n = 14 mod 16: no quad layout; a 2-level hierarchy);
- the backward step by the auto rule at 64x14 (the natural masked solve,
  row 12 on its finest level, V(2,2): the reference's natural branch keeps
  the MGConfig defaults), at tol 1e-4 and at tol 1e-6.

Bands (ROADMAP.md section C): equal V-cycle counts every step; the cavity
at tol 1e-5, u/v within 5e-6 and p within 5e-5, avg_KE within 1e-7
(tests/test_torch_cavity_slice.py); the step at tol 1e-4 with the bands of
tests/test_torch_step_slice.py (u/v within 5e-6, p within 1e-4 of their
scale every step and 5e-5 at the end), except u and v at step 1, the
impulsive start (max|p| = 134, a hundred times its later size): there the
two solves' 1e-6 relative pressure difference moves u by 6.1e-6, so the
velocity band is 1e-5 at step 1, the channel's precedent
(tests/test_torch_channel_slice.py). Also the natural paths' rules: the
reference's ValueErrors, the adaptive refusals, the CLI."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.cavity import make_cavity_case as jax_cavity_case
from cfd_tpu_torch import cli
from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.cases import make_backwards_step_case, make_cavity_case
from cfd_tpu_torch.kernels.step_smoother import StepMaskedPairs
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation
from natural_step_cycles import record_port, record_reference, step_cases, tolerance

torch.set_num_threads(1)

N_STEPS = 5
CAVITY = dict(poisson="multigrid", tolerance_factor=1e-5, final_time=1.0, print_interval=5)
NATURAL_STEP = (64, 14)
STEP = dict(nx=64, ny=14, poisson="multigrid", tolerance_factor=1e-4, abs_tol=0.0,
            final_time=1.0, print_interval=5)


@pytest.fixture(scope="module", params=[dict(n_interior=32, layout="aligned"),
                                        dict(n_interior=30)],
                ids=["aligned-32", "auto-30"])
def cavity(request):
    kw = request.param
    layout = kw.get("layout", "auto")
    ref = record_reference(jax_cavity_case(dtype=jnp.float32, step_kernel_mode="interpret",
                                           **{**CAVITY, **kw, "layout": layout}), N_STEPS)
    return kw, ref


def test_cavity_slice_matches_jax_every_step(cavity):
    kw, ref = cavity
    case = make_cavity_case(dtype=torch.float32, device="cpu", **CAVITY, **kw)
    assert not case.carry_tentative
    assert case.poisson_solve.aligned and case.info["mg"].post_sweeps == 1
    port = record_port(case, N_STEPS)
    assert tuple(port["carry"].u.shape) == case.step_kernels[0].shape  # the aligned carry
    assert port["cycles"] == ref["cycles"]
    for k, (got, want) in enumerate(zip(port["states"], ref["states"], strict=True)):
        for name, band in (("u", 5e-6), ("v", 5e-6), ("p", 5e-5), ("p_prev", 5e-5)):
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=band,
                                       err_msg=f"{name} step {k}")
        assert abs(port["ke"][k] - ref["ke"][k]) < 1e-7, k


def _fields_close(got, want, bands, k):
    for name, band in zip(("u", "v", "p"), bands):
        w = want[name]
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[name], w, rtol=0, atol=band * scale,
                                   err_msg=f"{name} step {k}")


def test_step_slice_matches_jax_every_step():
    case, jcase = step_cases(*NATURAL_STEP, 1e-4)
    solve, mg = case.poisson_solve, case.info["mg"]
    assert not case.carry_tentative and case.step_kernels is None
    assert isinstance(solve, TM.MaskedMultigridPoisson) and len(solve.levels) == 1
    assert isinstance(solve.pre0, StepMaskedPairs) and solve.post0.with_residual
    assert (mg.pre_sweeps, mg.post_sweeps, mg.whole_solve) == (2, 2, False)
    port, ref = record_port(case, N_STEPS), record_reference(jcase, N_STEPS)
    s = port["carry"]
    assert tuple(s.u.shape) == case.grid.shape and s.p_prev is None
    assert port["cycles"] == ref["cycles"]
    for k, (got, want) in enumerate(zip(port["states"], ref["states"], strict=True)):
        uv = 1e-5 if k == 0 else 5e-6
        _fields_close(got, want, (uv, uv, 1e-4), k)
        assert abs(port["ke"][k] - ref["ke"][k]) <= 1e-6 * max(1.0, abs(ref["ke"][k])), k
    _fields_close(port["states"][-1], ref["states"][-1], (5e-5, 5e-5, 5e-5), N_STEPS)


def test_step_slice_at_tol_1e_6_is_within_one_stall_exit_cycle():
    """The step at the path's own tolerance, 1e-6 (chip_smoke.py phase 26).
    There its solves end on the float32 residual floor: a cycle's residual
    carries rounding noise of 1e-7 to 1e-6 of max|b| (tests/
    natural_step_cycles.py prints the sequences), so the loop leaves by the
    stall exit, res >= 0.9 prev, at a cycle the noise picks. The band of
    ROADMAP.md section C, written out: every step's count equal to the
    reference's, or one apart where both solves ended by that stall exit
    above the tolerance; the fields within the bands of the tol 1e-4 slice
    above."""
    tol = 1e-6
    case, jcase = step_cases(*NATURAL_STEP, tol)
    port, ref = record_port(case, N_STEPS), record_reference(jcase, N_STEPS)
    for k, (x, y) in enumerate(zip(port["cycles"], ref["cycles"], strict=True)):
        assert abs(x - y) <= 1, (k, port["cycles"], ref["cycles"])
        if x != y:
            assert port["res"][k] > tolerance(port["inputs"][k][1], tol), k
            assert ref["res"][k] > tolerance(ref["inputs"][k][1], tol), k
    for k, (got, want) in enumerate(zip(port["states"], ref["states"], strict=True)):
        uv = 1e-5 if k == 0 else 5e-6
        _fields_close(got, want, (uv, uv, 1e-4), k)


@pytest.mark.parametrize("make, kw", [
    (make_cavity_case, dict(n_interior=32, layout="aligned")),
    (make_cavity_case, dict(n_interior=30)),
    (make_backwards_step_case, dict(nx=64, ny=14)),
])
@pytest.mark.parametrize("ov", [{"whole_solve": True}, {"whole_step": True}])
def test_whole_solve_and_step_off_the_quad_path_raise(make, kw, ov):
    """The reference's ValueError (cfd_tpu/cases/cavity.py:421-426,
    backwards_step.py:282-289)."""
    with pytest.raises(ValueError, match="quad"):
        make(dtype=torch.float32, device="cpu", poisson="multigrid", mg_overrides=ov, **kw)


def test_step_aligned_layout_raises_the_references_value_error():
    with pytest.raises(ValueError, match="requires the f32 multigrid kernel path"):
        make_backwards_step_case(dtype=torch.float32, device="cpu", layout="aligned",
                                 **STEP)


@pytest.mark.parametrize("kw", [dict(layout="quad", n_interior=30),
                                dict(layout="natural", n_interior=32)])
def test_cavity_layout_rules(kw):
    """layout="quad" where the quad shape does not exist, and an unknown
    layout, raise ValueError."""
    with pytest.raises(ValueError, match="layout"):
        make_cavity_case(dtype=torch.float32, device="cpu", **{**CAVITY, **kw})


def test_cavity_aligned_pin_mean_raises_the_references_value_error():
    """The cavity's problem is not pure Neumann (multigrid.py:670-674)."""
    with pytest.raises(ValueError, match="pure-Neumann"):
        make_cavity_case(dtype=torch.float32, device="cpu", n_interior=30,
                         mg_overrides={"pin_mean": True}, **CAVITY)


@pytest.mark.parametrize("make, kw", [
    (make_cavity_case, dict(n_interior=30, **CAVITY)),
    (make_backwards_step_case, STEP),
])
def test_adaptive_dt_on_the_natural_layout(make, kw):
    """The exact controller: the reference's make_adaptive_step, not ported
    (ROADMAP.md queue A item 6); the lagged one: the reference's ValueError
    (no tentative carry)."""
    sim = Simulation(make(dtype=torch.float32, device="cpu", **kw), log=lambda m: None)
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        run_adaptive(sim, max_courant=0.7, n_steps=2, controller="exact")
    with pytest.raises(ValueError, match="lagged"):
        run_adaptive(sim, max_courant=0.7, n_steps=2, controller="lagged")


def test_natural_tail_from_and_bf16_build():
    """The aligned solve takes tail_from (row 13 from level 1) and the bf16
    coarse hierarchy, as the reference's aligned solve does."""
    tail = make_cavity_case(dtype=torch.float32, device="cpu", n_interior=32,
                            layout="aligned", mg_overrides={"tail_from": 1}, **CAVITY)
    assert tail.poisson_solve.tail_from == 1
    bf16 = make_cavity_case(dtype=torch.float32, device="cpu", n_interior=32,
                            layout="aligned", mg_overrides={"coarse_dtype": "bfloat16"},
                            **CAVITY)
    assert bf16.poisson_solve.levels[1].dtype == torch.bfloat16
    sim = Simulation(bf16, log=lambda m: None)
    s, d = sim._step(sim.initial_state())
    assert d.poisson_iters > 0 and bool(torch.isfinite(s.p).all())


@pytest.mark.parametrize("argv, title", [
    (["cavity", "--Nx", "30", "--Ny", "30"], "Lid-Driven Cavity Flow Simulation"),
    (["backwards_step", "--Nx", "64", "--Ny", "14"], "Backwards Step Flow Simulation"),
])
def test_cli_runs_the_natural_paths(argv, title, capsys):
    assert cli.main(argv + ["--T", "1.0", "--steps", "2", "--poisson", "multigrid",
                            "--device", "cpu", "--print-interval", "2",
                            "--save-interval", "2", "--steps-per-call", "2",
                            "--no-vtk"]) == 0
    out = capsys.readouterr().out
    assert title in out and "PPE iters" in out
