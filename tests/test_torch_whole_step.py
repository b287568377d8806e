"""The whole time step in one kernel (cfd_tpu_torch.kernels.whole_step) on
the CPU, where each flavor runs its plain twin.

* Against the reference: for each flavor the port's whole step against
  cfd_tpu's make_quad_whole_step_* (through the reference factories with
  mg_overrides whole_step=True, the Pallas kernels in interpret mode) at the
  configs of tests/test_whole_step.py, 3 steps from one seeded state carried
  across by convert.py, within that test's bands: cycles within max(2, 25%)
  every step, u, v, p (and T) within 1e-4 of their scale. The reference's
  whole step rounds its in-VMEM transfers differently from its per-kernel
  path (kernels/whole_solve.py docstring), so the port's composition is
  held to the same bands.
* Against the port's own composition: whole_step on and off take the same
  steps, bit for bit with equal cycles.
* The (cycles, res) contract: 0-d tensors on the input's device, fresh for
  every call; Simulation.run reads them once a stats row (fault C.5 of
  ROADMAP.md), and gives the same rows and step_iters on every solve path.
* The repaired faults C.1 (the cavity's solve policy), C.2 (the save
  interval check and --save-interval), C.3 (the refusals that cited queue B
  rows now build their paths; fuse_pre's is tests/test_torch_fused_pre.py), the RB
  refusal of whole_step with extrapolate_warm_start, and the CLI's --mg.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step
from cfd_tpu.cases.cavity import make_cavity_case as jax_cavity
from cfd_tpu.cases.channel import make_channel_case as jax_channel
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_rb
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu.state import State as JaxState
from cfd_tpu_torch import cli, solver
from cfd_tpu_torch.cases import (
    cavity,
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.convert import state_from_numpy
from cfd_tpu_torch.kernels import KERNELS
from cfd_tpu_torch.kernels import whole_step as WS
from cfd_tpu_torch.kernels.whole_solve import WholeSolve, auto_whole_solve, split_stats
from cfd_tpu_torch.poisson.multigrid import MultigridPoisson
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

N_STEPS = 3
FIELDS = ("u", "v", "p", "T", "p_prev")

# (reference factory, its kwargs, the port's factory, its kwargs, compared
# fields): the configs of tests/test_whole_step.py
FLOWS = {
    "cavity": (jax_cavity,
               dict(n_interior=32, dtype=jnp.float32, poisson="multigrid",
                    tolerance_factor=1e-5, final_time=1.0, step_kernel_mode="interpret",
                    layout="quad"),
               make_cavity_case,
               dict(n_interior=32, poisson="multigrid", tolerance_factor=1e-5,
                    final_time=1.0),
               ("u", "v", "p")),
    "channel": (jax_channel,
                dict(nx=64, ny=32, dtype=jnp.float32, poisson="multigrid",
                     tolerance_factor=1e-5, layout="quad", step_kernel_mode="interpret"),
                make_channel_case,
                dict(nx=64, ny=32, poisson="multigrid", tolerance_factor=1e-5),
                ("u", "v", "p")),
    "rb": (jax_rb,
           dict(nx=48, ny=16, rayleigh=1e5, dtype=jnp.float32, tolerance_factor=1e-5,
                abs_tol=1e-7, step_kernel_mode="interpret", layout="quad"),
           make_rayleigh_benard_case,
           dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5, abs_tol=1e-7),
           ("u", "v", "p", "T")),
    "step": (jax_step,
             dict(nx=64, ny=16, dtype=jnp.float32, poisson="multigrid",
                  tolerance_factor=1e-5, layout="quad", smoother_mode="interpret"),
             make_backwards_step_case,
             dict(nx=64, ny=16, poisson="multigrid", tolerance_factor=1e-5),
             ("u", "v", "p")),
}
WS_ON = {"whole_step": True}


def _port_case(flow, **ov):
    _, _, make, kw, _ = FLOWS[flow]
    return make(dtype=torch.float32, device="cpu", **{**kw, **ov})


def _seeded_fields(case, seed: int) -> dict:
    """The port case's initial state in the logical layout, with seeded
    noise on u, v and p over its fluid cells (numpy arrays)."""
    sim = Simulation(case, log=lambda m: None)
    st = sim._logical(sim.initial_state())
    rng = np.random.default_rng(seed)
    mask = np.asarray(case.grid.cell_mask, dtype=np.float32)
    out = {k: getattr(st, k).numpy().copy() for k in FIELDS if getattr(st, k) is not None}
    for k, scale in (("u", 0.05), ("v", 0.05), ("p", 0.01)):
        out[k] = out[k] + (scale * rng.standard_normal(out[k].shape) * mask).astype(np.float32)
    return out


def _port_state(case, f):
    return case.align_state(state_from_numpy(f["u"], f["v"], f["p"], f.get("p_prev"),
                                             f.get("T")))


def _port_steps(case, f, n=N_STEPS):
    sim = Simulation(case, log=lambda m: None)
    s = _port_state(case, f)
    iters = []
    for _ in range(n):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
    return iters, sim._logical(s)


def _cycle_band(a: int, b: int) -> bool:
    return abs(a - b) <= max(2, round(0.25 * max(a, b)))


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_whole_step_matches_reference_whole_step(flow):
    make_jax, jkw, _, _, names = FLOWS[flow]
    case = _port_case(flow, mg_overrides=WS_ON)
    assert case.whole_step_kernel is not None
    f = _seeded_fields(case, seed=11)
    got_iters, got = _port_steps(case, f)

    jcase = make_jax(mg_overrides=WS_ON, **jkw)
    assert jcase.whole_step_kernel is not None or jcase.custom_step is not None
    jsim = JaxSimulation(jcase, log=lambda *a: None)
    js = jcase.align_state(JaxState(*(jnp.asarray(f[k]) if k in f else None
                                      for k in ("u", "v", "p", "T", "p_prev"))))
    want_iters = []
    for _ in range(N_STEPS):
        js, d = jsim._step(js)
        want_iters.append(int(d.poisson_iters))
    want = jsim._logical(js)
    assert all(_cycle_band(a, b) for a, b in zip(got_iters, want_iters)), (got_iters,
                                                                           want_iters)
    for name in names:
        w = np.asarray(getattr(want, name))
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"{flow} {name}")


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_whole_step_equals_composition(flow):
    """On the CPU whole_step on and off give bit-identical fields and equal
    cycles every step, and the step is the wrapper's twin."""
    on = _port_case(flow, mg_overrides=WS_ON)
    off = _port_case(flow)
    assert isinstance(on.whole_step_kernel, WS._WholeStep) and off.whole_step_kernel is None
    f = _seeded_fields(off, seed=5)
    it_on, s_on = _port_steps(on, f)
    it_off, s_off = _port_steps(off, f)
    assert it_on == it_off
    for name in FIELDS:
        a, b = getattr(s_on, name), getattr(s_off, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), f"{flow} {name}"


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_stats_are_fresh_device_tensors(flow):
    """(cycles, res) are an int32 and a float32 0-d tensor on the input's
    device; a second call leaves the first call's untouched."""
    case = _port_case(flow, mg_overrides=WS_ON)
    ws = case.whole_step_kernel
    s = _port_state(case, _seeded_fields(case, seed=3))
    fields = {"rb": (s.u, s.v, s.p, s.T), "step": (s.u, s.v, s.p)}.get(
        flow, (s.u, s.v, s.p, s.p_prev))
    first = ws(*fields)
    cycles, res = first[-2:]
    assert cycles.shape == () and cycles.dtype == torch.int32 and cycles.device == s.u.device
    assert res.shape == () and res.dtype == torch.float32 and res.device == s.u.device
    kept = (int(cycles), float(res))
    zeros = tuple(torch.zeros_like(t) for t in fields)
    again = ws(*zeros)
    assert (int(again[-2]), float(again[-1])) != kept
    assert (int(cycles), float(res)) == kept


def test_split_stats_views_the_kernel_output():
    bits = np.array([1.25e-3], np.float32).view(np.int32)[0]
    stats = torch.tensor([7, int(bits)], dtype=torch.int32)
    cycles, res = split_stats(stats)
    assert int(cycles) == 7 and float(res) == float(np.float32(1.25e-3))
    assert cycles.data_ptr() == stats.data_ptr()


def test_whole_step_kernels_are_registered():
    names = {k.name: k for k in KERNELS}
    for kern, line in ((WS.WHOLE_STEP_CAVITY, 165), (WS.WHOLE_STEP_CHANNEL, 186),
                       (WS.WHOLE_STEP_RB, 211), (WS.WHOLE_STEP_STEP, 239)):
        assert names[kern.name] is kern
        assert kern.replaces == f"cfd_tpu/kernels/whole_step.py:{line}"
        assert kern.source == "cfd_tpu_torch/csrc/whole_step.cu"


@pytest.mark.parametrize("path", ["whole_step", "whole_solve", "per_kernel"])
def test_run_reads_diagnostics_once_a_row(path, monkeypatch):
    """Simulation.run keeps every step's (cycles, res) until the stats row
    and reads them with one call a row; the rows and step_iters are those
    of stepping by hand."""
    ov = {"whole_step": {"whole_step": True}, "whole_solve": {"whole_solve": True},
          "per_kernel": None}[path]
    case = dataclasses.replace(_port_case("channel", mg_overrides=ov), print_interval=2)
    calls = []
    real = solver.read_diagnostics
    monkeypatch.setattr(solver, "read_diagnostics",
                        lambda diags: calls.append(len(diags)) or real(diags))
    sim = Simulation(case, log=lambda m: None)
    sim.run(n_steps=5, steps_per_call=1)
    assert calls == [2, 2, 1]
    by_hand = Simulation(case, log=lambda m: None)
    s = by_hand.initial_state()
    iters = []
    for _ in range(5):
        s, d = by_hand._step(s)
        iters.append(int(d.poisson_iters))
    assert sim.step_iters == iters
    assert [r["poisson_iters"] for r in sim.history] == [iters[1], iters[3], iters[4]]
    if path == "whole_step":
        ref = Simulation(dataclasses.replace(_port_case("channel"), print_interval=2),
                         log=lambda m: None)
        ref.run(n_steps=5)
        drop = ("wall_seconds", "cell_updates_per_sec")
        assert [{k: v for k, v in r.items() if k not in drop} for r in sim.history] == \
            [{k: v for k, v in r.items() if k not in drop} for r in ref.history]


def test_rb_whole_step_refuses_extrapolated_warm_start():
    """The reference's ValueError (cfd_tpu/physics/boussinesq.py:311-316)."""
    with pytest.raises(ValueError, match="extrapolate_warm_start"):
        _port_case("rb", mg_overrides=WS_ON, extrapolate_warm_start=True)


def test_steps_per_call_must_divide_the_save_interval():
    """Fault C.2: the reference's check (cfd_tpu/solver.py:466-474) on the
    command line of ROADMAP.md section C, and the --save-interval flag."""
    argv = ["backwards_step", "--Nx", "64", "--Ny", "16", "--precision", "f32",
            "--poisson", "multigrid", "--no-vtk", "--steps", "40", "--steps-per-call", "20",
            "--print-interval", "20", "--device", "cpu"]
    with pytest.raises(ValueError, match=r"must divide the save interval \(10\)"):
        cli.main(argv)
    args = cli.build_parser().parse_args(argv + ["--save-interval", "20"])
    assert cli.make_case_from_args(args).save_interval == 20
    with pytest.raises(ValueError, match="save interval"):
        Simulation(_port_case("cavity", save_interval=3), log=lambda m: None).run(
            n_steps=2, steps_per_call=2)


def test_cli_runs_whole_step(capsys):
    assert cli.main(["channel", "--Nx", "64", "--Ny", "32", "--T", "1.0", "--steps", "2",
                     "--poisson", "multigrid", "--device", "cpu", "--print-interval", "2",
                     "--save-interval", "2", "--steps-per-call", "2", "--no-vtk",
                     "--mg", "whole_step=true"]) == 0
    assert "PPE iters" in capsys.readouterr().out
    assert cli.parse_mg("pre_sweeps=2,tol_factor=1e-6,whole_step=true,tail_from=none,"
                        "coarse_dtype=bfloat16") == dict(
        pre_sweeps=2, tol_factor=1e-6, whole_step=True, tail_from=None,
        coarse_dtype="bfloat16")
    with pytest.raises(SystemExit, match="unknown MGConfig field"):
        cli.parse_mg("sweeps=2")


def test_cavity_goes_through_auto_whole_solve(monkeypatch):
    """Fault C.1: the cavity factory takes its solve from auto_whole_solve,
    as the reference's does (cfd_tpu/cases/cavity.py:207-245): the
    whole-solve on the card, the per-kernel path on the CPU and under a
    manual knob."""
    seen = []

    def spy(mg, mg_overrides, on_cuda, build, fallback):
        seen.append((mg, mg_overrides, build, fallback))
        return auto_whole_solve(mg, mg_overrides, on_cuda, build, fallback)

    monkeypatch.setattr(cavity, "auto_whole_solve", spy)
    case = _port_case("cavity")
    assert len(seen) == 1 and isinstance(case.poisson_solve, MultigridPoisson)
    mg, ov, build, fallback = seen[0]
    solve, mg_card = auto_whole_solve(mg, ov, True, build, fallback)
    assert isinstance(solve, WholeSolve) and mg_card.whole_solve
    assert mg_card.coarse_dtype is None  # the f32 hierarchy
    _port_case("cavity", mg_overrides={"whole_solve": False})
    mg, ov, build, fallback = seen[-1]
    solve, mg_manual = auto_whole_solve(mg, ov, True, build, fallback)
    assert isinstance(solve, MultigridPoisson) and not mg_manual.whole_solve


@pytest.mark.parametrize("kw", [dict(layout="aligned"), dict(n_interior=30)])
def test_cavity_natural_paths_build(kw):
    """The two refusals that cited row 11 (the natural layout) now build
    the natural stage kernels over the aligned solve."""
    from cfd_tpu_torch.kernels.projection import Corrector, PredictorSource

    case = _port_case("cavity", **kw)
    assert not case.carry_tentative and case.whole_step_kernel is None
    assert isinstance(case.step_kernels[0], PredictorSource)
    assert isinstance(case.step_kernels[1], Corrector)
    assert isinstance(case.poisson_solve, MultigridPoisson) and case.poisson_solve.aligned
