"""The natural layout's channel against cfd_tpu on the CPU: 5 steps of the
same case from the same start in both packages, the JAX one with its
Pallas kernels in interpret mode (step_kernel_mode="interpret"), the port
with its plain twins: layout="aligned" at 64x32, and the auto rule at
64x30 (ny = 14 mod 16: no quad layout; a 2-level hierarchy).

Bands (ROADMAP.md section C, tests/test_torch_channel_slice.py): tol 1e-4,
where every solve converges above the float32 floor; equal V-cycle counts
every step; u/v within 5e-6 and p within 3e-4 of their scale, except u and
v at step 1, the impulsive start, within 1e-5; avg_KE within one unit of
its printed last digit, 1e-6 (the step's precedent, ROADMAP.md section C).
Also the rules of the natural channel."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.channel import make_channel_case as jax_case
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch import cli
from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.cases import make_channel_case
from cfd_tpu_torch.kernels.projection import ChannelCorrector, ChannelPredictorSource
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

N_STEPS = 5
KW = dict(poisson="multigrid", tolerance_factor=1e-4, abs_tol=0.0, final_time=1.0,
          print_interval=5)


@pytest.fixture(scope="module", params=[dict(nx=64, ny=32, layout="aligned"),
                                        dict(nx=64, ny=30)],
                ids=["aligned-64x32", "auto-64x30"])
def ref(request):
    kw = request.param
    case = jax_case(dtype=jnp.float32, step_kernel_mode="interpret",
                    **{**KW, **kw, "layout": kw.get("layout", "auto")})
    assert not case.carry_tentative
    sim = JaxSimulation(case, log=lambda m: None)
    s = sim.initial_state()
    iters, states, ke = [], [], []
    for _ in range(N_STEPS):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        lg = sim._logical(s)
        states.append({k: np.asarray(getattr(lg, k)) for k in ("u", "v", "p", "p_prev")})
        ke.append(sim.statistics(s)["avg_kinetic_energy"])
    return kw, dict(iters=iters, states=states, ke=ke)


def test_channel_slice_matches_jax_every_step(ref):
    kw, want = ref
    case = make_channel_case(dtype=torch.float32, device="cpu", **KW, **kw)
    assert not case.carry_tentative and case.poisson_solve.aligned
    assert isinstance(case.step_kernels[0], ChannelPredictorSource)
    assert isinstance(case.step_kernels[1], ChannelCorrector)
    mg = case.info["mg"]
    assert (mg.pre_sweeps, mg.post_sweeps) == (1, 2)
    assert len(case.poisson_solve.levels) == (2 if kw["ny"] == 30 else 4)
    sim = Simulation(case, log=lambda m: None)
    s = sim.initial_state()
    for k in range(N_STEPS):
        s, d = sim._step(s)
        assert d.poisson_iters == want["iters"][k], k
        got, w = sim._logical(s), want["states"][k]
        uv = 1e-5 if k == 0 else 5e-6
        for name, band in (("u", uv), ("v", uv), ("p", 3e-4), ("p_prev", 3e-4)):
            scale = max(1.0, float(np.abs(w[name]).max()))
            np.testing.assert_allclose(getattr(got, name).numpy(), w[name], rtol=0,
                                       atol=band * scale, err_msg=f"{name} step {k}")
        ke = sim.statistics(s)["avg_kinetic_energy"]
        assert abs(ke - want["ke"][k]) <= 1e-6, k


def test_channel_natural_source_mean_is_removed():
    """The step removes the source's interior mean before the solve (an
    iota cell mask and a true division): the solve's b sums to ~0 over the
    cells and is 0 beyond them."""
    case = make_channel_case(dtype=torch.float32, device="cpu", nx=64, ny=30, **KW)
    seen = []
    solve = case.poisson_solve

    def spy(p, b, max_b=None):
        seen.append(b)
        return solve(p, b, max_b)

    sim = Simulation(dataclasses.replace(case, poisson_solve=spy), log=lambda m: None)
    sim._step(sim.initial_state())
    b = seen[0]
    assert not b[32:].any() and not b[:, 66:].any()
    cells = b[1:31, 1:65]
    assert abs(float(cells.sum())) <= 1e-5 * float(cells.abs().sum())


@pytest.mark.parametrize("ov", [{"whole_solve": True}, {"whole_step": True},
                                {"pin_mean": True}, {"corr_opt": True}])
def test_natural_channel_knob_rules(ov):
    """whole_solve/whole_step off the quad path, pin_mean on a problem that
    is not pure Neumann and corr_opt on a separable one raise the
    reference's ValueErrors."""
    with pytest.raises(ValueError):
        make_channel_case(dtype=torch.float32, device="cpu", nx=64, ny=30,
                          mg_overrides=ov, **KW)


def test_channel_quad_layout_unavailable_raises():
    with pytest.raises(ValueError, match="quad layout unavailable"):
        make_channel_case(dtype=torch.float32, device="cpu", nx=64, ny=30, layout="quad",
                          **KW)


def test_channel_adaptive_on_the_natural_layout_raises():
    sim = Simulation(make_channel_case(dtype=torch.float32, device="cpu", nx=64, ny=30,
                                       **KW), log=lambda m: None)
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        run_adaptive(sim, max_courant=0.7, n_steps=2, controller="exact")


def test_cli_runs_the_natural_channel(capsys):
    assert cli.main(["channel", "--Nx", "64", "--Ny", "30", "--T", "1.0", "--steps", "2",
                     "--poisson", "multigrid", "--device", "cpu", "--print-interval", "2",
                     "--save-interval", "2", "--steps-per-call", "2", "--no-vtk"]) == 0
    out = capsys.readouterr().out
    assert "Channel Flow Simulation" in out and "PPE iters" in out
