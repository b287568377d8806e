"""The ported Rayleigh-Benard slice against cfd_tpu on the CPU: the f32 quad
case at 48x16, Ra = 1e5, tol 1e-5, abs_tol 1e-7, stepped by both packages
from the same seed, the JAX one with its Pallas kernels in interpret mode,
the port with its plain twins.

Bands: the initial state bit for bit (the numpy threefry reproduces
jax.random.uniform); equal V-cycle counts every step; u, v, p and T within
2e-6 of their scale every step (the JAX package's own band,
tests/test_rb_quad.py:45, is 1e-4: the two packages round the source sum
and the mean pin in other orders, about 1e-7 apart here); nusselt_volume
and temperature_max within 1e-6 relative and avg_KE (about 3e-8 here)
within 1e-4 relative (the reference's band is 1e-3 absolute). The same
with mg_overrides whole_solve=True against cfd_tpu's interpret
whole-solve (tests/test_whole_solve.py:117), the port's
whole-solve twin equal to its per-kernel path bit for bit. Also the
extrapolated warm start against plain p (tests/test_rb_quad.py:54), the
resume through convert.py, the stats rows and banner, the factory's gates
and the CLI."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.io.checkpoint import CheckpointManager
from cfd_tpu.io.console import banner_lines as jax_banner
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_case
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu.state import State as JaxState
from cfd_tpu_torch import cli
from cfd_tpu_torch.cases import make_rayleigh_benard_case
from cfd_tpu_torch.convert import load_jax_checkpoint, state_from_numpy, state_to_numpy
from cfd_tpu_torch.io.console import banner_lines
from cfd_tpu_torch.kernels.whole_solve import WholeSolve
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

KW = dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5, abs_tol=1e-7,
          print_interval=2)
N_STEPS = 5
FIELDS = ("u", "v", "p", "T")
STATS = ("nusselt_volume", "temperature_max", "avg_kinetic_energy")


def _np_state(st):
    return {k: np.asarray(getattr(st, k)) for k in FIELDS}


def _jax_run(mg_overrides=None, rows=None):
    case = jax_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad",
                    mg_overrides=mg_overrides, **KW)
    sim = JaxSimulation(case, log=lambda m: None)
    if rows is not None:  # the same jitted step serves both runs
        sim.log = rows.append
        sim.run(n_steps=4)
    s = sim.initial_state()
    init = {k: np.asarray(getattr(s, k)) for k in FIELDS}
    iters, states = [], []
    for _ in range(N_STEPS):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(_np_state(sim._logical(s)))
    stats = {k: float(v) for k, v in sim.statistics(s).items()}
    return dict(iters=iters, states=states, init=init, stats=stats, rows=rows, case=case)


@pytest.fixture(scope="module")
def ref():
    return _jax_run(rows=[])


@pytest.fixture(scope="module")
def ref_ws():
    return _jax_run({"whole_solve": True})


def _port(**kw):
    return make_rayleigh_benard_case(device="cpu", **{**KW, **kw})


def _port_run(case, n=N_STEPS, state=None):
    sim = Simulation(case, log=lambda m: None)
    s = sim.initial_state() if state is None else state
    iters, states = [], []
    for _ in range(n):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(sim._logical(s))
    return iters, states, sim.statistics(s)


def _fields_close(got, want, k, band=2e-6):
    for name in FIELDS:
        w = want[name]
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=band * scale, err_msg=f"{name} step {k}")


def _stats_close(got, want):
    for k in STATS:
        # avg_KE is O(1e-8) here: relative to it, the fields' 1e-8 differences
        # weigh more
        rel = 1e-4 if k == "avg_kinetic_energy" else 1e-6
        assert abs(got[k] - want[k]) <= rel * abs(want[k]), (k, got[k], want[k])


def test_initial_state_is_jax_bit_for_bit(ref):
    """The conductive profile, the seeded noise (numpy threefry), the ghosts
    and the alignment into the carried quad layout."""
    st = Simulation(_port()).initial_state()
    assert st.p_prev is None
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), ref["init"][k], err_msg=k)


def test_slice_matches_jax_every_step(ref):
    case = _port()
    mg = case.info["mg"]
    assert mg.whole_solve is False and mg.pin_mean  # the CPU's per-kernel default
    assert (mg.pre_sweeps, mg.post_sweeps) == (2, 1)
    iters, states, stats = _port_run(case)
    assert iters == ref["iters"]
    for k, (got, want) in enumerate(zip(states, ref["states"], strict=True)):
        _fields_close(got, want, k)
    _stats_close(stats, ref["stats"])


def test_whole_solve_slice_matches_jax_whole_solve(ref_ws):
    case = _port(mg_overrides={"whole_solve": True})
    assert isinstance(case.poisson_solve, WholeSolve) and case.poisson_solve.cfg.pin_mean
    iters, states, stats = _port_run(case)
    assert iters == ref_ws["iters"]
    for k, (got, want) in enumerate(zip(states, ref_ws["states"], strict=True)):
        _fields_close(got, want, k)
    _stats_close(stats, ref_ws["stats"])
    # the whole-solve twin IS the per-kernel path's arithmetic
    pk_iters, pk_states, _ = _port_run(_port())
    assert iters == pk_iters
    for a, b in zip(states, pk_states, strict=True):
        assert all(torch.equal(getattr(a, n), getattr(b, n)) for n in FIELDS)


def test_extrapolated_warm_start_tracks_plain():
    """The extrapolated guess changes only the solve's initial guess, so the
    trajectory tracks the plain warm start to the solver tolerance
    (tests/test_rb_quad.py:54-83)."""
    ce = _port(extrapolate_warm_start=True)
    assert ce.extrapolate_warm_start and ce.step_kernels[0].emit_guess
    _, plain, _ = _port_run(_port(), 6)
    _, extra, _ = _port_run(ce, 6)
    assert extra[-1].p_prev is not None
    for name in FIELDS:
        a, b = getattr(plain[-1], name).numpy(), getattr(extra[-1], name).numpy()
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale, err_msg=name)


@pytest.mark.parametrize("via", ["numpy", "checkpoint"])
def test_handover_from_jax_continues(ref, via, tmp_path):
    """JAX ran 3 steps; its logical state, T included, crosses over (as
    arrays or as a CheckpointManager npz) and the port's next 2 steps track
    JAX's."""
    case = _port()
    s3 = ref["states"][2]
    if via == "numpy":
        state = state_from_numpy(s3["u"], s3["v"], s3["p"], T=s3["T"])
    else:
        CheckpointManager(tmp_path).save(
            JaxState(*(jnp.asarray(s3[k]) for k in FIELDS)), 3)
        state, start = load_jax_checkpoint(tmp_path / "ckpt_00000003.npz", case)
        assert start == 3
    np.testing.assert_array_equal(state_to_numpy(state)[4], s3["T"])
    sim = Simulation(case, log=lambda m: None)
    end = sim.run(state=state, n_steps=2, start_step=3)
    # the resume re-derives the tentative fields (one f32 rounding), so a
    # cycle count may sit one to either side of the tolerance knife edge
    assert all(abs(a - b) <= 1 for a, b in zip(sim.step_iters, ref["iters"][3:], strict=True))
    _fields_close(sim._logical(end), ref["states"][4], 4, band=1e-5)


_ROW = re.compile(r"Step\s+(\d+)/(\d+) \| t=\s*(\S+) \| max\(div\)=\s*(\S+) \| "
                  r"avg_KE=\s*(\S+) \| PPE iters=\s*(\d+) \| res=\s*(\S+)")


def test_stats_rows_and_banner_match_jax(ref):
    rows = []
    case = _port()
    sim = Simulation(case, log=rows.append)
    sim.run(n_steps=4, steps_per_call=2)
    assert len(rows) == len(ref["rows"]) == 2
    for got, want in zip(rows, ref["rows"]):
        g, w = _ROW.match(got).groups(), _ROW.match(want).groups()
        assert g[:3] == w[:3] and g[4:6] == w[4:6], (got, want)
    assert {"nusselt_bottom", "nusselt_top", "nusselt_volume", "temperature_min",
            "temperature_max"} <= set(sim.history[-1])
    assert banner_lines(case) == jax_banner(ref["case"])


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float64), dict(layout="aligned"), dict(ny=14),
    dict(layout="natural"),
    dict(nx=62, ny=30),
])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        _port(**kw)


@pytest.mark.parametrize("ov", [{"corr_opt": True}])
def test_separable_corr_opt_raises(ov):
    """The reference's ValueError for corr_opt on a separable hierarchy."""
    with pytest.raises(ValueError, match="corr_opt is a masked defect-correction knob"):
        _port(mg_overrides=ov)


def test_whole_step_option_builds_and_steps():
    """mg_overrides whole_step=True (refused until the whole step was
    ported) builds the one-kernel step, and on the CPU its twin takes the
    same steps as the composed path, bit for bit with equal cycles."""
    runs = []
    for ws in (False, True):
        case = _port(mg_overrides={"whole_step": ws})
        assert (case.whole_step_kernel is not None) == ws
        sim = Simulation(case, log=lambda m: None)
        s = sim.initial_state()
        iters = []
        for _ in range(2):
            s, d = sim._step(s)
            iters.append(int(d.poisson_iters))
        runs.append((iters, sim._logical(s)))
    (it0, s0), (it1, s1) = runs
    assert it0 == it1
    for a, b in zip(s0, s1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_build_rejections_raise(monkeypatch):
    """Never swallowed: a size that multigrid cannot coarsen, an explicit
    quad layout that the shape cannot take, and the cuda default without a
    card."""
    with pytest.raises(ValueError, match="multigrid-compatible"):
        _port(nx=47)
    with pytest.raises(ValueError, match="quad layout"):
        _port(ny=14, layout="quad")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_rayleigh_benard_case(**KW)


def test_v21_unless_overridden_and_bf16_per_kernel():
    mg = _port(mg_overrides={"post_sweeps": 2}).info["mg"]
    assert (mg.pre_sweeps, mg.post_sweeps) == (2, 2)
    mg = _port(mg_overrides={"coarse_dtype": "bfloat16"}).info["mg"]
    assert mg.coarse_dtype == "bfloat16" and not mg.whole_solve


def test_cli_runs_rayleigh_benard(capsys):
    assert cli.main(["rayleigh_benard", "--Nx", "48", "--Ny", "16", "--Ra", "1e5",
                     "--steps", "2", "--device", "cpu", "--print-interval", "2",
                     "--steps-per-call", "2", "--no-vtk"]) == 0
    out = capsys.readouterr().out
    assert "Rayleigh-Benard Convection Simulation" in out and "Rayleigh=100000" in out
    assert re.search(r"Step\s+2/\d+ .*PPE iters", out)
    args = cli.build_parser().parse_args(["rayleigh_benard", "--device", "cpu"])
    assert (args.Nx, args.Ny, args.Ra, args.Pr, args.T) == (192, 64, 1e6, 0.71, 50.0)
    with pytest.raises(SystemExit, match="FTLE"):
        cli.main(["rayleigh_benard", "--no-vtk", "--device", "cpu", "--ftle-window", "4"])
