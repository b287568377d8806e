"""The ported channel slice against cfd_tpu on the CPU: the f32 quad
multigrid channel at 64x32 stepped by both packages, the JAX one with its
Pallas kernels in interpret mode, the port with its plain twins.

Bands (ROADMAP.md section C; tests/test_quad.py, tests/test_whole_solve.py):
- at tol 1e-4, where every solve converges above the float32 floor: equal
  V-cycle counts every step, u/v within 5e-6 and p within 3e-4 of their
  scale, the stats rows' t, cycles, max(div) and avg_KE equal at printed
  precision and the final residual within 15% (at ten times the float32
  roundoff of A p it differs by up to 10% between the two packages).
  Step 1 is the impulsive start (max|p| = 241, fifty times its later
  size): there the two solves' 1e-6 relative pressure difference moves u
  and v by up to 9e-6, so the velocity band is 1e-5 at step 1;
- at tol 1e-5 the solves end on the float32 floor (the residual stalls
  above the tolerance), where the exit cycle flips on ulps of the inputs.
  There the bands are tests/test_whole_solve.py:66-94's: cycles within
  max(2, 25%), the same field bands; with mg_overrides whole_solve=True
  against cfd_tpu's whole-solve case, and the port's whole-solve twin
  equal to its per-kernel path every step.
Also the JAX state hand-over, the guards and the CLI."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.channel import make_channel_case as jax_case
from cfd_tpu.io.checkpoint import CheckpointManager
from cfd_tpu.io.console import banner_lines as jax_banner
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch import cli
from cfd_tpu_torch.cases import make_channel_case
from cfd_tpu_torch.convert import load_jax_checkpoint, state_from_numpy
from cfd_tpu_torch.io.console import banner_lines
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

KW = dict(nx=64, ny=32, poisson="multigrid", final_time=1.0, print_interval=2)
N_STEPS = 5
N_FLOOR = 3  # steps of the floor-terminated runs
WS = {"whole_solve": True}


def _np_state(st):
    return {k: np.asarray(getattr(st, k)) for k in ("u", "v", "p", "p_prev")}


def _jax_run(tol, mg_overrides=None, rows=None, n=N_STEPS):
    case = jax_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad",
                    tolerance_factor=tol, mg_overrides=mg_overrides, **KW)
    sim = JaxSimulation(case, log=lambda m: None)
    if rows is not None:  # the same jitted step serves both runs
        sim.log = rows.append
        sim.run(n_steps=4)
    s = sim.initial_state()
    iters, states = [], []
    for _ in range(n):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(_np_state(sim._logical(s)))
    return dict(iters=iters, states=states, init=_np_state(sim.initial_state()),
                rows=rows, case=case)


@pytest.fixture(scope="module")
def ref():
    return _jax_run(1e-4, rows=[])


@pytest.fixture(scope="module")
def ref_floor():
    return _jax_run(1e-5, n=N_FLOOR)


@pytest.fixture(scope="module")
def ref_floor_ws():
    return _jax_run(1e-5, dict(WS), n=N_FLOOR)


def _port(tol=1e-4, **kw):
    return make_channel_case(dtype=torch.float32, device="cpu", tolerance_factor=tol,
                             **{**KW, **kw})


def _port_run(case, n=N_STEPS, state=None):
    sim = Simulation(case, log=lambda m: None)
    s = sim.initial_state() if state is None else state
    iters, states = [], []
    for _ in range(n):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(sim._logical(s))
    return iters, states


def _fields_close(got, want, k):
    uv = 1e-5 if k == 0 else 5e-6
    for name, band in (("u", uv), ("v", uv), ("p", 3e-4)):
        w = want[name]
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=band * scale, err_msg=f"{name} step {k}")


def test_initial_state_matches_jax(ref):
    st = Simulation(_port()).initial_state()
    for k, want in ref["init"].items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), want, err_msg=k)


def test_slice_matches_jax_every_step(ref):
    case = _port()
    assert case.info["mg"].whole_solve is False  # the CPU's per-kernel default
    assert (case.info["mg"].pre_sweeps, case.info["mg"].post_sweeps) == (1, 2)
    iters, states = _port_run(case)
    assert iters == ref["iters"]
    for k, (got, want) in enumerate(zip(states, ref["states"], strict=True)):
        _fields_close(got, want, k)


def _cycle_band(a, b):
    return abs(a - b) <= max(2, round(0.25 * max(a, b)))


@pytest.mark.parametrize("whole", [False, True])
def test_floor_terminated_slice_within_bands(ref_floor, ref_floor_ws, whole):
    want = ref_floor_ws if whole else ref_floor
    case = _port(1e-5, mg_overrides=dict(WS) if whole else None)
    assert case.info["mg"].whole_solve is whole
    iters, states = _port_run(case, N_FLOOR)
    assert all(_cycle_band(a, b) for a, b in zip(iters, want["iters"], strict=True)), \
        (iters, want["iters"])
    for k, (got, w) in enumerate(zip(states, want["states"], strict=True)):
        _fields_close(got, w, k)
    if whole:  # the whole-solve twin IS the per-kernel path's arithmetic
        pk_iters, pk_states = _port_run(_port(1e-5), N_FLOOR)
        assert iters == pk_iters
        for a, b in zip(states, pk_states, strict=True):
            assert all(torch.equal(getattr(a, n), getattr(b, n)) for n in ("u", "v", "p"))


_ROW = re.compile(r"Step\s+(\d+)/(\d+) \| t=\s*(\S+) \| max\(div\)=\s*(\S+) \| "
                  r"avg_KE=\s*(\S+) \| PPE iters=\s*(\d+) \| res=\s*(\S+)")


def _same_at_print_precision(a: str, b: str) -> bool:
    """Two '%.2e' strings equal, or one unit apart in the last digit."""
    exp = int(b.split("e")[1])
    return abs(float(a) - float(b)) <= 1.0001 * 10.0 ** (exp - 2)


def test_stats_rows_and_banner_match_jax(ref):
    rows = []
    case = _port()
    Simulation(case, log=rows.append).run(n_steps=4, steps_per_call=2)
    assert len(rows) == len(ref["rows"]) == 2
    for got, want in zip(rows, ref["rows"]):
        g, w = _ROW.match(got).groups(), _ROW.match(want).groups()
        assert g[:3] == w[:3] and g[4:6] == w[4:6], (got, want)
        assert _same_at_print_precision(g[3], w[3]), (got, want)
        assert abs(float(g[6]) - float(w[6])) <= 0.15 * float(w[6]), (got, want)
    assert banner_lines(case) == jax_banner(ref["case"])


@pytest.mark.parametrize("via", ["numpy", "checkpoint"])
def test_handover_from_jax_continues(ref, via, tmp_path):
    """JAX ran 2 steps; its logical state crosses over (as arrays or as a
    CheckpointManager npz) and the port's next 3 steps track JAX's."""
    case = _port()
    s2 = ref["states"][1]
    if via == "numpy":
        state = state_from_numpy(s2["u"], s2["v"], s2["p"], s2["p_prev"])
    else:
        from cfd_tpu.state import State as JaxState

        CheckpointManager(tmp_path).save(
            JaxState(*(jnp.asarray(s2[k]) for k in ("u", "v", "p")), None,
                     jnp.asarray(s2["p_prev"])), 2)
        state, start = load_jax_checkpoint(tmp_path / "ckpt_00000002.npz", case)
        assert start == 2
    state = case.align_state(state)
    iters, states = _port_run(case, 3, state)
    # the resume re-derives the tentative fields (one f32 rounding), so a
    # cycle count may sit one to either side of the tolerance knife edge
    assert all(abs(a - b) <= 1 for a, b in zip(iters, ref["iters"][2:], strict=True))
    _fields_close(states[-1], ref["states"][4], 4)


@pytest.mark.parametrize("kw", [
    dict(poisson="sor"), dict(nx=93, ny=31, poisson="auto"), dict(dtype=torch.float64),
])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        make_channel_case(device="cpu", **{**KW, "dtype": torch.float32, **kw})


@pytest.mark.parametrize("ov", [{"corr_opt": True}])
def test_separable_corr_opt_raises(ov):
    """The reference's ValueError for corr_opt on a separable hierarchy."""
    with pytest.raises(ValueError, match="corr_opt is a masked defect-correction knob"):
        make_channel_case(device="cpu", **{**KW, "dtype": torch.float32, "mg_overrides": ov})


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


def test_build_rejections_raise():
    """Never swallowed: an explicit quad layout that the shape cannot take,
    and a hierarchy shallower than 3 levels."""
    with pytest.raises(ValueError, match="quad layout"):
        _port(ny=30, layout="quad")
    with pytest.raises(ValueError, match="3 levels"):
        _port(nx=16, ny=8)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_channel_case(**{**KW, "dtype": torch.float32})


def test_cli_runs_channel(capsys):
    assert cli.main(["channel", "--Nx", "64", "--Ny", "32", "--T", "1.0", "--steps", "2",
                     "--poisson", "multigrid", "--device", "cpu", "--print-interval", "2",
                     "--steps-per-call", "2", "--no-vtk"]) == 0
    out = capsys.readouterr().out
    assert "Channel Flow Simulation" in out and "Grid: 64x32" in out
    assert re.search(r"Step\s+2/\d+ .*PPE iters", out)
    args = cli.build_parser().parse_args(["channel", "--device", "cpu"])
    assert (args.Nx, args.Ny, args.Re, args.T) == (93, 31, 100.0, 10.0)
