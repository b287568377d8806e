"""The ported backward-step slice against cfd_tpu on the CPU: the f32 quad
masked multigrid step at 64x16 stepped by both packages, the JAX one with
its Pallas kernels in interpret mode (layout="quad",
smoother_mode="interpret", as tests/test_step_quad.py), the port with its
plain twins.

Bands (ROADMAP.md section C; tests/test_step_quad.py,
tests/test_whole_solve.py):
- at tol 1e-4: equal V-cycle counts every step, u and v within 5e-6 of
  their scale every step, and u, v and p within 5e-5 of scale after the 5
  steps (tests/test_step_quad.py:86-92). p is held per step at 1e-4 of
  scale: the two solves each stop at a 1e-4 relative residual, and at step
  2 their pressures differ by 5.1e-5 of scale (ROADMAP.md section C). The
  stats rows' t and cycles equal, max(div) and avg_KE equal at printed
  precision up to one unit of the last digit (at step 4 avg_KE prints
  0.097511 against 0.097510), the final residual within 15%;
- at tol 1e-5, where solves can end on the float32 floor, the
  tests/test_whole_solve.py:88 band: cycles within max(2, 25%), the same
  field bands, with mg_overrides whole_solve=True against cfd_tpu's
  masked whole-solve case, and the port's whole-solve twin equal to its
  per-kernel path every step.
Also the JAX state hand-over (no p_prev) followed by 2 more steps, the
guards, the default device and the CLI."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_case
from cfd_tpu.io.checkpoint import CheckpointManager
from cfd_tpu.io.console import banner_lines as jax_banner
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch import cli
from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.convert import load_jax_checkpoint, state_from_numpy
from cfd_tpu_torch.io.console import banner_lines
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

KW = dict(nx=64, ny=16, poisson="multigrid", final_time=1.0, print_interval=2)
N_STEPS = 5
N_FLOOR = 3  # steps of the floor-band runs
WS = {"whole_solve": True}


def _np_state(st):
    return {k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
            for k in ("u", "v", "p", "p_prev")}


def _jax_run(tol, mg_overrides=None, rows=None, n=N_STEPS):
    case = jax_case(dtype=jnp.float32, layout="quad", smoother_mode="interpret",
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
    stats = sim.statistics(s)
    return dict(iters=iters, states=states, init=_np_state(sim.initial_state()),
                rows=rows, case=case, stats=stats)


@pytest.fixture(scope="module")
def ref():
    return _jax_run(1e-4, rows=[])


@pytest.fixture(scope="module")
def ref_floor_ws():
    return _jax_run(1e-5, dict(WS), n=N_FLOOR)


def _port(tol=1e-4, **kw):
    return make_backwards_step_case(dtype=torch.float32, device="cpu", tolerance_factor=tol,
                                    **{**KW, **kw})


def _port_run(case, n=N_STEPS, state=None):
    sim = Simulation(case, log=lambda m: None)
    s = sim.initial_state() if state is None else state
    iters, states = [], []
    for _ in range(n):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(sim._logical(s))
    return iters, states, sim, s


def _fields_close(got, want, bands):
    for name, band in zip(("u", "v", "p"), bands):
        w = want[name]
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=band * scale, err_msg=name)


def test_initial_state_matches_jax(ref):
    st = Simulation(_port()).initial_state()
    for k, want in ref["init"].items():
        if want is None:
            assert getattr(st, k) is None, k
        else:
            np.testing.assert_array_equal(getattr(st, k).numpy(), want, err_msg=k)


def test_slice_matches_jax_every_step(ref):
    case = _port()
    mg = case.info["mg"]
    assert isinstance(case.poisson_solve, TM.MaskedQuadMultigridPoisson)
    assert (mg.whole_solve, mg.pre_sweeps, mg.post_sweeps) == (False, 1, 2)
    iters, states, sim, s = _port_run(case)
    assert iters == ref["iters"]
    for got, want in zip(states, ref["states"], strict=True):
        _fields_close(got, want, (5e-6, 5e-6, 1e-4))
    _fields_close(states[-1], ref["states"][-1], (5e-5, 5e-5, 5e-5))
    got = sim.statistics(s)
    for k in ("max_divergence", "avg_kinetic_energy"):
        assert abs(got[k] - ref["stats"][k]) <= 1e-4 * max(1.0, abs(ref["stats"][k])), k


def test_whole_solve_on_and_off_identical_on_cpu():
    runs = []
    for ov in (None, dict(WS)):
        case = _port(mg_overrides=ov)
        assert isinstance(case.poisson_solve, TW.StepWholeSolve) == bool(ov)
        iters, states, _, _ = _port_run(case, 3)
        runs.append((iters, states[-1]))
    (ia, sa), (ib, sb) = runs
    assert ia == ib
    assert all(torch.equal(getattr(sa, n), getattr(sb, n)) for n in ("u", "v", "p"))


def _cycle_band(a, b):
    return abs(a - b) <= max(2, round(0.25 * max(a, b)))


def test_floor_band_whole_solve_against_jax(ref_floor_ws):
    """tol 1e-5 with the whole-solve on both sides (cfd_tpu's is its
    in-VMEM masked solve, whose transfers round differently)."""
    case = _port(1e-5, mg_overrides=dict(WS))
    iters, states, _, _ = _port_run(case, N_FLOOR)
    assert all(_cycle_band(a, b) for a, b in zip(iters, ref_floor_ws["iters"], strict=True)), \
        (iters, ref_floor_ws["iters"])
    for got, want in zip(states, ref_floor_ws["states"], strict=True):
        _fields_close(got, want, (5e-6, 5e-6, 1e-4))


_ROW = re.compile(r"Step\s+(\d+)/(\d+) \| t=\s*(\S+) \| max\(div\)=\s*(\S+) \| "
                  r"avg_KE=\s*(\S+) \| PPE iters=\s*(\d+) \| res=\s*(\S+)")


def _same_at_print_precision(a: str, b: str) -> bool:
    """Two '%.2e' strings equal, or one unit apart in the last digit."""
    exp = int(b.split("e")[1])
    return abs(float(a) - float(b)) <= 1.0001 * 10.0 ** (exp - 2)


def test_stats_rows_and_banner_match_jax(ref, capsys):
    rows = []
    case = _port()
    Simulation(case, log=rows.append).run(n_steps=4, steps_per_call=2)
    assert len(rows) == len(ref["rows"]) == 2
    for got, want in zip(rows, ref["rows"]):
        g, w = _ROW.match(got).groups(), _ROW.match(want).groups()
        assert g[:3] == w[:3] and g[5] == w[5], (got, want)
        assert _same_at_print_precision(g[3], w[3]), (got, want)
        # avg_KE to its printed 6 decimals, one unit either side: the fields
        # differ by f32 roundoff, which can cross a rounding boundary
        assert abs(float(g[4]) - float(w[4])) <= 1.0001e-6, (got, want)
        assert abs(float(g[6]) - float(w[6])) <= 0.15 * float(w[6]), (got, want)
    assert banner_lines(case) == jax_banner(ref["case"])
    assert any(line.startswith("Step: height=1.000000") for line in banner_lines(case))


@pytest.mark.parametrize("via", ["numpy", "checkpoint"])
def test_handover_from_jax_continues(ref, via, tmp_path):
    """JAX ran 3 steps; its logical state (no p_prev: the plain warm start)
    crosses over as arrays or as a CheckpointManager npz, and the port's
    next 2 steps track JAX's steps 4 and 5."""
    case = _port()
    s3 = ref["states"][2]
    assert s3["p_prev"] is None
    if via == "numpy":
        state = state_from_numpy(s3["u"], s3["v"], s3["p"])
    else:
        from cfd_tpu.state import State as JaxState

        CheckpointManager(tmp_path).save(
            JaxState(*(jnp.asarray(s3[k]) for k in ("u", "v", "p"))), 3)
        state, start = load_jax_checkpoint(tmp_path / "ckpt_00000003.npz", case)
        assert start == 3 and state.p_prev is None
    state = case.align_state(state)
    iters, states, _, _ = _port_run(case, 2, state)
    # the resume re-derives the tentative fields (one f32 rounding), so a
    # cycle count may sit one to either side of the tolerance knife edge
    assert all(abs(a - b) <= 1 for a, b in zip(iters, ref["iters"][3:], strict=True))
    _fields_close(states[-1], ref["states"][4], (5e-5, 5e-5, 5e-5))


@pytest.mark.parametrize("kw", [
    dict(poisson="sor"), dict(nx=64, ny=16, poisson="auto"), dict(dtype=torch.float64),
])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        make_backwards_step_case(device="cpu", **{**KW, "dtype": torch.float32, **kw})


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
    the refused bf16 coarse hierarchy, and the geometry bounds."""
    with pytest.raises(ValueError, match="quad layout"):
        _port(ny=14, layout="quad")
    with pytest.raises(ValueError, match="coarse_dtype"):
        _port(mg_overrides={"coarse_dtype": "bfloat16"})
    with pytest.raises(ValueError, match="height_inlet"):
        _port(height_inlet=2.0)
    with pytest.raises(ValueError, match="step_location"):
        _port(step_location=9.0)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_backwards_step_case(**{**KW, "dtype": torch.float32})


def test_cli_runs_backwards_step(capsys):
    assert cli.main(["backwards_step", "--Nx", "64", "--Ny", "16", "--T", "1.0",
                     "--steps", "2", "--poisson", "multigrid", "--device", "cpu",
                     "--print-interval", "2", "--steps-per-call", "2", "--no-vtk"]) == 0
    out = capsys.readouterr().out
    assert "Backwards Step Flow Simulation" in out and "Grid: 64x16" in out
    assert "Fluid cells: 896/1024" in out
    assert re.search(r"Step\s+2/\d+ .*PPE iters", out)
    args = cli.build_parser().parse_args(["backwards_step", "--device", "cpu"])
    assert (args.Nx, args.Ny, args.Re, args.T) == (256, 32, 100.0, 15.0)
