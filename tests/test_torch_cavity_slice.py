"""The ported cavity slice against cfd_tpu on the CPU: the same f32 quad
multigrid case (n = 32, tol 1e-5) stepped by both packages, the JAX one
with its Pallas kernels in interpret mode, the port with its plain twins.

Bands (tests/test_quad.py:218-227): equal V-cycle counts every step, u/v
within 5e-6, p within 5e-5, avg_KE within 1e-7, for the float32 hierarchy
and for the bf16 coarse hierarchy (each against JAX's own); the bf16-coarse
twin also within the bands of tests/test_coarse_dtype.py:67-93 of the
float32 trajectory; a state handed over from JAX
continues within the tentative-carry resume bands (tests/test_quad.py:
365-367). Also the guards: unported options raise, the CLI runs."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.cavity import make_cavity_case as jax_case
from cfd_tpu.io.checkpoint import CheckpointManager
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch import cli
from cfd_tpu_torch.cases import make_cavity_case
from cfd_tpu_torch.convert import load_jax_checkpoint, state_from_numpy, state_to_numpy
from cfd_tpu_torch.solver import Simulation, make_step

torch.set_num_threads(1)

KW = dict(n_interior=32, poisson="multigrid", tolerance_factor=1e-5, final_time=1.0,
          print_interval=2)
N_STEPS = 6


def _np_state(st):
    return {k: np.asarray(getattr(st, k)) for k in ("u", "v", "p", "p_prev")}


@pytest.fixture(scope="module")
def ref():
    """The JAX trajectory: per-step cycles and logical states, and the
    stats rows Simulation.run prints over 4 steps."""
    case = jax_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad", **KW)
    rows = []
    sim = JaxSimulation(case, log=rows.append)
    sim.run(n_steps=4)
    s = sim.initial_state()
    iters, states, ke = [], [], []
    for _ in range(N_STEPS):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(_np_state(sim._logical(s)))
        ke.append(sim.statistics(s)["avg_kinetic_energy"])
    return dict(rows=rows, iters=iters, states=states, ke=ke,
                init=_np_state(sim.initial_state()))


BF16 = {"coarse_dtype": "bfloat16"}
N_BF16_STEPS = 4


@pytest.fixture(scope="module")
def ref_bf16():
    """The JAX trajectory with the bf16 coarse hierarchy: per-step cycles,
    logical states and avg_KE."""
    case = jax_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad",
                    mg_overrides=dict(BF16), **KW)
    assert case.info["mg"].coarse_dtype == "bfloat16"
    sim = JaxSimulation(case, log=lambda m: None)
    s = sim.initial_state()
    iters, states, ke = [], [], []
    for _ in range(N_BF16_STEPS):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(_np_state(sim._logical(s)))
        ke.append(sim.statistics(s)["avg_kinetic_energy"])
    return dict(iters=iters, states=states, ke=ke)


def _port(**kw):
    return make_cavity_case(dtype=torch.float32, device="cpu", **{**KW, **kw})


def test_initial_state_matches_jax(ref):
    st = Simulation(_port()).initial_state()
    for k, want in ref["init"].items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), want, err_msg=k)


def test_slice_matches_jax_every_step(ref):
    sim = Simulation(_port(), log=lambda m: None)
    s = sim.initial_state()
    for k in range(N_STEPS):
        s, d = sim._step(s)
        assert d.poisson_iters == ref["iters"][k], k
        lg, want = sim._logical(s), ref["states"][k]
        np.testing.assert_allclose(lg.u.numpy(), want["u"], rtol=0, atol=5e-6)
        np.testing.assert_allclose(lg.v.numpy(), want["v"], rtol=0, atol=5e-6)
        np.testing.assert_allclose(lg.p.numpy(), want["p"], rtol=0, atol=5e-5)
        ke = sim.statistics(s)["avg_kinetic_energy"]
        assert abs(ke - ref["ke"][k]) < 1e-7, k


def test_bf16_coarse_matches_jax_bf16_every_step(ref_bf16):
    """The path the card runs (bf16 level weights, the 16-row padding of
    level 1, the bf16 pinv product) against the reference's bf16 path:
    equal cycles every step and the float32 bands."""
    sim = Simulation(_port(mg_overrides=dict(BF16)), log=lambda m: None)
    s = sim.initial_state()
    for k in range(N_BF16_STEPS):
        s, d = sim._step(s)
        assert d.poisson_iters == ref_bf16["iters"][k], k
        lg, want = sim._logical(s), ref_bf16["states"][k]
        np.testing.assert_allclose(lg.u.numpy(), want["u"], rtol=0, atol=5e-6)
        np.testing.assert_allclose(lg.v.numpy(), want["v"], rtol=0, atol=5e-6)
        np.testing.assert_allclose(lg.p.numpy(), want["p"], rtol=0, atol=5e-5)
        ke = sim.statistics(s)["avg_kinetic_energy"]
        assert abs(ke - ref_bf16["ke"][k]) < 1e-7, k


def test_bf16_coarse_twin_within_bands(ref):
    case = _port(mg_overrides=dict(BF16))
    assert case.info["mg"].coarse_dtype == "bfloat16"
    sim = Simulation(case, log=lambda m: None)
    s = sim.initial_state()
    for k in range(3):
        s, d = sim._step(s)
        assert d.poisson_iters <= ref["iters"][k] + 3, k
    lg = sim._logical(s)
    for name in ("u", "v", "p"):
        want = ref["states"][2][name]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(getattr(lg, name).numpy(), want, rtol=0,
                                   atol=1e-3 * scale, err_msg=name)


def test_cpu_default_keeps_f32_coarse_ladder():
    assert _port().info["mg"].coarse_dtype is None


def test_default_device_is_cuda(monkeypatch):
    """Without a card the default device raises: the CPU runs only when
    asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cavity_case(**{**KW, "dtype": torch.float32})


def test_dead_mg_override_is_refused():
    """The reference's coarse_sweeps is read by nothing; naming it fails."""
    with pytest.raises(TypeError, match="coarse_sweeps"):
        _port(mg_overrides={"coarse_sweeps": 8})


@pytest.mark.parametrize("via", ["numpy", "checkpoint"])
def test_handover_from_jax_continues(ref, via, tmp_path):
    """JAX ran 3 steps; its logical state crosses over (as arrays or as a
    CheckpointManager npz) and the port's next 3 steps track JAX's."""
    case = _port()
    s3 = ref["states"][2]
    if via == "numpy":
        state, start = state_from_numpy(s3["u"], s3["v"], s3["p"], s3["p_prev"]), 3
    else:
        from cfd_tpu.state import State as JaxState

        ckpt = CheckpointManager(tmp_path)
        ckpt.save(JaxState(*(jnp.asarray(s3[k]) for k in ("u", "v", "p")),
                           None, jnp.asarray(s3["p_prev"])), 3)
        state, start = load_jax_checkpoint(tmp_path / "ckpt_00000003.npz", case)
    np.testing.assert_array_equal(state_to_numpy(state)[2], s3["p"])
    sim = Simulation(case, log=lambda m: None)
    out = sim._logical(sim.run(state=state, n_steps=3, start_step=start))
    # the resume re-derives the tentative fields (one f32 rounding), so a
    # cycle count may sit one to either side of the tolerance knife edge
    assert all(abs(a - b) <= 1 for a, b in zip(sim.step_iters, ref["iters"][3:]))
    want = ref["states"][5]
    np.testing.assert_allclose(out.u.numpy(), want["u"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.v.numpy(), want["v"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.p.numpy(), want["p"], rtol=0, atol=1e-4)


_ROW = re.compile(r"Step\s+(\d+)/(\d+) \| t=\s*(\S+) \| max\(div\)=\s*(\S+) \| "
                  r"avg_KE=\s*(\S+) \| PPE iters=\s*(\d+) \| res=\s*(\S+)")


def _same_at_print_precision(a: str, b: str) -> bool:
    """Two '%.2e' strings equal, or one unit apart in the last digit."""
    exp = int(b.split("e")[1])
    return abs(float(a) - float(b)) <= 1.0001 * 10.0 ** (exp - 2)


def test_stats_rows_match_jax(ref):
    rows = []
    Simulation(_port(), log=rows.append).run(n_steps=4, steps_per_call=2)
    assert len(rows) == len(ref["rows"]) == 2
    for got, want in zip(rows, ref["rows"]):
        g, w = _ROW.match(got).groups(), _ROW.match(want).groups()
        assert g[:3] == w[:3] and g[4:6] == w[4:6], (got, want)
        assert _same_at_print_precision(g[3], w[3]), (got, want)
        assert _same_at_print_precision(g[6], w[6]), (got, want)


def test_run_aborts_on_blowup():
    with pytest.warns(UserWarning, match="stability"):
        case = _port(dt=0.5, print_interval=1)
    with pytest.raises(RuntimeError, match="diverged"):
        Simulation(case, log=lambda m: None).run(n_steps=20)


@pytest.mark.parametrize("kw", [
    dict(poisson="sor"), dict(n_interior=63, poisson="auto"), dict(dtype=torch.float64),
    dict(forcing=(0.0, 0.0)),
])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        make_cavity_case(device="cpu", **{**KW, "dtype": torch.float32, **kw})


@pytest.mark.parametrize("ov", [{"corr_opt": True}])
def test_separable_corr_opt_raises(ov):
    """corr_opt is the masked hierarchy's knob: the reference's ValueError
    (cfd_tpu/poisson/multigrid.py:664-667)."""
    with pytest.raises(ValueError, match="corr_opt is a masked defect-correction knob"):
        make_cavity_case(device="cpu", **{**KW, "dtype": torch.float32, "mg_overrides": ov})


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


def test_other_orderings_raise():
    """An ordering other than the tentative-carry cavity and channel ones
    raises instead of running a wrong step."""
    case = dataclasses.replace(_port(), ordering="natural")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_step(case)


def test_cli_runs_cavity(capsys):
    assert cli.main(["cavity", "--Nx", "32", "--Ny", "32", "--T", "1.0", "--steps", "2",
                     "--poisson", "multigrid", "--device", "cpu",
                     "--print-interval", "2", "--steps-per-call", "2", "--no-vtk"]) == 0
    out = capsys.readouterr().out
    assert "Lid-Driven Cavity Flow Simulation" in out
    assert re.search(r"Step\s+2/\d+ .*PPE iters", out)


@pytest.mark.parametrize("argv", [
    ["cavity", "--Nx", "32", "--Ny", "32", "--poisson", "multigrid"],  # no VTK yet
    ["cavity", "--no-vtk", "--png"],
    ["cavity", "--no-vtk", "--Nx", "32", "--Ny", "16"],
])
def test_cli_refuses_unported(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)
