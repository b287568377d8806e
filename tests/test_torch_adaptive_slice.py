"""The port's adaptive time stepping (cfd_tpu_torch.adaptive.run_adaptive)
against cfd_tpu.adaptive.run_adaptive on the CPU, from the same initial
state: the cavity at 32^2 with the exact controller on the host loop and in
chunks of 5, and the lagged controller in chunks of 5; the channel at 96x32,
the step at 64x16 and Rayleigh-Benard at 48x16, Ra = 1e5, with the lagged
controller in chunks of 3. The reference runs its Pallas kernels in
interpret mode; its per-step dt and V-cycles are recorded through
jax.debug.callback around its Case.adaptive_impl(_carry) step.

Bands: dt within 1e-6 relative every step (the device controllers repeat
the reference's float32 arithmetic; the host loop records a float32 and a
double dt); equal V-cycles every step; the final fields within each flow's
fixed-dt slice bands (tests/test_torch_cavity_slice.py: u, v 5e-6, p 5e-5;
tests/test_torch_channel_slice.py: u, v 5e-6 and p 3e-4 of scale;
tests/test_torch_step_slice.py: u, v 5e-6 and p 5e-5 of scale;
tests/test_torch_rb_slice.py: 2e-6 of scale); the rows' dt and Courant
number within 1e-6 relative. Also the reference's behaviour tests
(tests/test_adaptive.py:246-412) on the port alone, the refusals and the
CLI."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.adaptive import run_adaptive as jax_run_adaptive
from cfd_tpu.cases import make_cavity_case as jax_cavity
from cfd_tpu.cases import make_channel_case as jax_channel
from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_rb
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch import cli
from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                 make_channel_case, make_rayleigh_benard_case)
from cfd_tpu_torch.poisson.multigrid import step_rect_params
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)


def quiet(*a, **k):
    pass


CAVITY_KW = dict(n_interior=32, reynolds_number=100.0, final_time=10.0, poisson="multigrid",
                 tolerance_factor=1e-5, print_interval=5, dt=1e-4)
CHANNEL_KW = dict(nx=96, ny=32, poisson="multigrid", tolerance_factor=1e-4, print_interval=3)
STEP_KW = dict(nx=64, ny=16, poisson="multigrid", tolerance_factor=1e-4, print_interval=3)
RB_KW = dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5, abs_tol=1e-7,
             print_interval=3)

# name -> (reference factory, port factory, fields, bands (u, v, p[, T]) of scale)
FLOWS = {
    "cavity": (lambda: jax_cavity(step_kernel_mode="interpret", layout="quad",
                                  dtype=jnp.float32, **CAVITY_KW),
               lambda **kw: make_cavity_case(dtype=torch.float32, device="cpu",
                                             **{**CAVITY_KW, **kw}),
               (5e-6, 5e-6, 5e-5)),
    "channel": (lambda: jax_channel(step_kernel_mode="interpret", layout="quad",
                                    dtype=jnp.float32, **CHANNEL_KW),
                lambda **kw: make_channel_case(dtype=torch.float32, device="cpu",
                                               **{**CHANNEL_KW, **kw}),
                (5e-6, 5e-6, 3e-4)),
    "step": (lambda: jax_step(smoother_mode="interpret", layout="quad", dtype=jnp.float32,
                              **STEP_KW),
             lambda **kw: make_backwards_step_case(dtype=torch.float32, device="cpu",
                                                   **{**STEP_KW, **kw}),
             (5e-6, 5e-6, 5e-5)),
    "rb": (lambda: jax_rb(step_kernel_mode="interpret", layout="quad", dtype=jnp.float32,
                          **RB_KW),
           lambda **kw: make_rayleigh_benard_case(device="cpu", **{**RB_KW, **kw}),
           (2e-6, 2e-6, 2e-6, 2e-6)),
}


def _recording(case, lagged: bool):
    """The reference case with its adaptive step wrapped to record every
    step's dt (dt_pred for the lagged step) and V-cycles."""
    rec = []

    def record(dt, iters):
        rec.append((float(dt), int(iters)))

    if lagged:
        build = case.adaptive_impl_carry

        def wrapped():
            step, to_aligned, to_logical = build()

            def step_rec(st, dt_corr, dt_pred):
                out = step(st, dt_corr, dt_pred)
                jax.debug.callback(record, dt_pred, out[1].poisson_iters, ordered=True)
                return out

            return step_rec, to_aligned, to_logical

        return dataclasses.replace(case, adaptive_impl_carry=wrapped), rec
    build = case.adaptive_impl

    def wrapped():
        step, to_aligned, to_logical = build()

        def step_rec(st, dt):
            out = step(st, dt)
            jax.debug.callback(record, dt, out[1].poisson_iters, ordered=True)
            return out

        return step_rec, to_aligned, to_logical

    return dataclasses.replace(case, adaptive_impl=wrapped), rec


RUNS = [("cavity", "exact", 1, 10, None), ("cavity", "exact", 5, 10, None),
        ("cavity", "lagged", 5, 10, None), ("channel", "lagged", 3, 6, 0.5),
        ("step", "lagged", 3, 6, 0.5), ("rb", "lagged", 3, 6, 0.5)]


@pytest.mark.parametrize("flow,controller,spc,n,dt0_scale", RUNS)
def test_run_adaptive_matches_jax(flow, controller, spc, n, dt0_scale):
    jmake, tmake, bands = FLOWS[flow]
    jcase, rec = _recording(jmake(), controller == "lagged")
    dt0 = None if dt0_scale is None else dt0_scale * jcase.dt
    kw = dict(max_courant=0.4, n_steps=n, steps_per_call=spc, controller=controller,
              dt0=dt0, log=quiet)
    jst, jrows = jax_run_adaptive(JaxSimulation(jcase, log=quiet), **kw)
    sim = Simulation(tmake(), log=quiet)
    st, rows = run_adaptive(sim, **kw)
    want_dts = [d for d, _ in rec]
    assert sim.step_iters == [i for _, i in rec]
    assert len(sim.step_dts) == len(want_dts) == n
    for k, (a, b) in enumerate(zip(sim.step_dts, want_dts, strict=True)):
        assert abs(a - b) <= 1e-6 * b, (k, a, b)
    assert want_dts[-1] > 1.5 * want_dts[0]  # the controller moved dt
    assert tuple(st.u.shape) == sim.case.grid.shape
    fields = ("u", "v", "p", "T")[: len(bands)]
    for name, band in zip(fields, bands, strict=True):
        want = np.asarray(getattr(jst, name))
        scale = 1.0 if flow == "cavity" else max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(getattr(st, name).numpy(), want, rtol=0,
                                   atol=band * scale, err_msg=name)
    assert len(rows) == len(jrows) == n // sim.case.print_interval
    for r, w in zip(rows, jrows, strict=True):
        assert r["step"] == w["step"] and r["poisson_iters"] == w["poisson_iters"]
        for key in ("dt", "courant", "time"):
            assert abs(r[key] - w[key]) <= 1e-6 * abs(w[key]), (key, r[key], w[key])


# ------------------------------------------- the reference's behaviour tests

def _fixed_logical(sim, n):
    st = sim.initial_state()
    for _ in range(n):
        st, _ = sim._step(st)
    return sim._logical(st)


@pytest.mark.parametrize("flow", ["cavity", "channel", "step", "rb"])
def test_lagged_with_unit_growth_is_the_fixed_dt_path(flow):
    """growth = 1 and a huge Courant target keep dt = case.dt: the lagged
    controller's trajectory is the fixed-dt carry's to float32 roundoff
    (tests/test_adaptive.py:257, 301, 353 hold 2e-4 of scale; the port
    holds 1e-5): the same stages, the coefficients formed on the card in
    another float32 order."""
    sim = Simulation(FLOWS[flow][1](print_interval=3), log=quiet)
    want = _fixed_logical(sim, 6)
    st, _ = run_adaptive(sim, max_courant=1e6, n_steps=6, growth=1.0, controller="lagged",
                         steps_per_call=3, log=quiet)
    assert sim.step_dts == [np.float32(sim.case.dt)] * 6
    for name in ("u", "v", "p", "T"):
        a = getattr(want, name)
        if a is None:
            continue
        scale = max(1.0, float(a.abs().max()))
        assert float((getattr(st, name) - a).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("flow,n", [("channel", 18), ("step", 12)])
def test_lagged_courant_target_respected(flow, n):
    """From dt0 = 0.2 dt, dt grows and the Courant number settles at or below
    the target; the one-step-stale overshoot is bounded by the growth factor
    (tests/test_adaptive.py:331, 385); the step's solid block stays 0."""
    sim = Simulation(FLOWS[flow][1](), log=quiet)
    st, rows = run_adaptive(sim, max_courant=0.4, n_steps=n, controller="lagged",
                            steps_per_call=3, dt0=sim.case.dt * 0.2, log=quiet)
    dts = [r["dt"] for r in rows]
    assert dts[-1] > dts[0]
    assert all(r["courant"] <= 0.4 * 1.25 for r in rows[2:]), rows
    assert bool(torch.isfinite(st.u).all())
    if flow == "step":
        step_i, inlet_j = step_rect_params(sim.case.grid)
        assert float(st.u[inlet_j + 1 : -1, 1:step_i].abs().max()) == 0.0


def test_exact_controller_courant_target_respected():
    """The cavity's exact controller from dt = 1e-5 grows dt far and holds the
    Courant number at or below the target after the start
    (tests/test_adaptive.py:14)."""
    sim = Simulation(FLOWS["cavity"][1](dt=1e-5, print_interval=10), log=quiet)
    st, rows = run_adaptive(sim, max_courant=0.5, n_steps=60, log=quiet)
    assert rows[-1]["dt"] > 50 * rows[0]["dt"] / 1.2 ** 9
    assert all(r["courant"] <= 0.5 * 1.05 for r in rows)
    assert bool(torch.isfinite(st.u).all())


def test_rb_lagged_grows_to_the_diffusive_ceiling():
    """RB starts near rest: dt grows by the growth factor until the ceiling
    0.25 h^2 / max(nu, kappa) caps it; T stays in the wall band
    (tests/test_adaptive.py:279)."""
    case = FLOWS["rb"][1]()
    h = min(case.coeffs.dx, case.coeffs.dy)
    ceiling = 0.25 * h * h / case.adaptive_diffusivity
    sim = Simulation(case, log=quiet)
    st, rows = run_adaptive(sim, max_courant=0.4, n_steps=30, controller="lagged",
                            steps_per_call=3, dt0=case.dt * 0.25, log=quiet)
    assert rows[-1]["dt"] > rows[0]["dt"]
    assert max(sim.step_dts) == pytest.approx(ceiling, rel=1e-6)
    assert all(d <= ceiling * (1 + 1e-6) for d in sim.step_dts)
    assert all(r["courant"] <= 0.4 * 1.25 for r in rows[2:]), rows
    assert bool(torch.isfinite(st.u).all())
    Ti = st.T[1:-1, 1:-1]
    assert float(Ti.min()) >= -0.25 and float(Ti.max()) <= 1.25


@pytest.mark.parametrize("flow", ["channel", "step", "rb"])
def test_exact_controller_refused_off_the_cavity(flow):
    """The exact controller exists for the cavity only: RB refuses with the
    reference's message, the channel and the step (where the reference's
    fallback crashes on the quad layout) with the same pointer to 'lagged'."""
    sim = Simulation(FLOWS[flow][1](), log=quiet)
    with pytest.raises(ValueError, match="controller='lagged'"):
        run_adaptive(sim, max_courant=0.4, n_steps=3, log=quiet)


def test_bad_arguments_raise():
    sim = Simulation(FLOWS["cavity"][1](), log=quiet)
    with pytest.raises(ValueError, match="unknown controller"):
        run_adaptive(sim, n_steps=3, controller="pid", log=quiet)
    with pytest.raises(ValueError, match="must divide"):
        run_adaptive(sim, n_steps=6, steps_per_call=3, log=quiet)
    with pytest.raises(ValueError, match="n_steps or final_time"):
        run_adaptive(sim, log=quiet)


def test_final_time_stops_the_lagged_run():
    sim = Simulation(FLOWS["cavity"][1](), log=quiet)
    _, rows = run_adaptive(sim, max_courant=0.4, final_time=2e-3, controller="lagged",
                           steps_per_call=5, log=quiet)
    t = np.cumsum(np.asarray(sim.step_dts, np.float64))
    assert len(sim.step_dts) % 5 == 0 and t[-1] >= 2e-3 > t[-6]


@pytest.mark.parametrize("controller", ["exact", "lagged"])
def test_cli_adaptive_dt(controller, capsys):
    assert cli.main(["cavity", "--Nx", "32", "--Ny", "32", "--poisson", "multigrid",
                     "--Re", "100", "--dt", "1e-4", "--no-vtk", "--steps", "10",
                     "--print-interval", "5", "--steps-per-call", "5", "--device", "cpu",
                     "--adaptive-dt", "0.4", "--adaptive-controller", controller]) == 0
    steps = re.findall(r"Step +(\d+) \| t=.*\| dt=(\S+) \| Co=(\S+)", capsys.readouterr().out)
    assert [int(s) for s, _, _ in steps] == [5, 10]
    assert float(steps[1][1]) > float(steps[0][1]) > 1e-4


def test_cli_adaptive_rb_lagged(capsys):
    assert cli.main(["rayleigh_benard", "--Nx", "48", "--Ny", "16", "--Ra", "1e5",
                     "--no-vtk", "--steps", "6", "--print-interval", "3",
                     "--steps-per-call", "3", "--device", "cpu", "--adaptive-dt", "0.7",
                     "--adaptive-controller", "lagged"]) == 0
    assert len(re.findall(r"Step +\d+ \| t=.*\| Co=", capsys.readouterr().out)) == 2
    with pytest.raises(ValueError, match="controller='lagged'"):
        cli.main(["rayleigh_benard", "--Nx", "48", "--Ny", "16", "--no-vtk", "--steps", "3",
                  "--print-interval", "3", "--device", "cpu", "--adaptive-dt", "0.7"])
