"""MGConfig.pin_mean follows the reference on every path (fault C.6).

The reference pins the pressure's mean only where the problem is pure
Neumann: its whole-solve takes ``pin_mean`` as its own argument, which only
Rayleigh-Benard passes (cfd_tpu/kernels/whole_solve.py:507-520,
cfd_tpu/physics/boussinesq.py:286-290); a separable solve of any other
problem raises ValueError (cfd_tpu/poisson/multigrid.py:669-673); its masked
solves never read the field. Every test runs the reference's case factory
(cfd_tpu, f32, layout="quad", its Pallas kernels in interpret mode) on the
same configuration beside the port's: both raise the same ValueError, or
both build and run the same with the field as without it (the reference
for one step, the port for three).
"""

import jax.numpy as jnp
import pytest
import torch

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step
from cfd_tpu.cases.cavity import make_cavity_case as jax_cavity
from cfd_tpu.cases.channel import make_channel_case as jax_channel
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_rb
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                 make_channel_case, make_rayleigh_benard_case)
from cfd_tpu_torch.kernels.quad import from_quad
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

# name -> (port factory, reference factory, their shared kwargs, the
# reference's kernel mode)
FLOWS = {
    "cavity": (make_cavity_case, jax_cavity,
               dict(n_interior=32, poisson="multigrid", tolerance_factor=1e-5),
               dict(step_kernel_mode="interpret")),
    "channel": (make_channel_case, jax_channel,
                dict(nx=64, ny=32, poisson="multigrid", tolerance_factor=1e-5),
                dict(step_kernel_mode="interpret")),
    "step": (make_backwards_step_case, jax_step,
             dict(nx=64, ny=16, poisson="multigrid", tolerance_factor=1e-5),
             dict(smoother_mode="interpret")),
    "rb": (make_rayleigh_benard_case, jax_rb,
           dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5, abs_tol=1e-7),
           dict(step_kernel_mode="interpret")),
}
PIN = {"pin_mean": True}
C6 = "pin_mean only for pure-Neumann problems"


def _case(flow, ov):
    make, _, kw, _ = FLOWS[flow]
    return make(dtype=torch.float32, device="cpu", final_time=1.0, print_interval=1,
                mg_overrides=ov, **kw)


def _jax_case(flow, ov):
    _, make, kw, mode = FLOWS[flow]
    return make(dtype=jnp.float32, final_time=1.0, print_interval=1, layout="quad",
                mg_overrides=ov, **kw, **mode)


def _run(case, n):
    sim = Simulation(case, log=lambda m: None)
    state = sim.run(n_steps=n)
    return sim.step_iters, state


def _jax_step(case):
    """The reference's first step: (cycles, carried state)."""
    sim = JaxSimulation(case, log=lambda *a: None)
    state, diag = sim._step(sim.initial_state())
    return int(diag.poisson_iters), state


def _assert_same(runs, equal):
    (it0, st0), (it1, st1) = runs
    assert it0 == it1
    for a, b in zip(st0, st1, strict=True):
        if a is not None:
            assert equal(a, b)


def _assert_same_in_the_reference(flow, ovs):
    _assert_same([_jax_step(_jax_case(flow, ov)) for ov in ovs],
                 lambda a, b: bool(jnp.array_equal(a, b)))


@pytest.mark.parametrize("flow", ["cavity", "channel"])
@pytest.mark.parametrize("ov", [{}, {"whole_solve": False}, {"whole_step": True},
                                {"tail_from": 1}],
                         ids=["default", "per_kernel", "whole_step", "tail_from"])
def test_separable_pin_mean_raises_the_references_value_error(flow, ov):
    """The quad per-kernel solve of a problem that is not pure Neumann: the
    reference's ValueError (the whole step and the tail build that solve
    too), where the port raised NotImplementedError."""
    with pytest.raises(ValueError, match=C6):
        _jax_case(flow, {**PIN, **ov})
    with pytest.raises(ValueError, match=C6):
        _case(flow, {**PIN, **ov})


@pytest.mark.parametrize("flow,ov", [
    ("cavity", {"whole_solve": True}), ("channel", {"whole_solve": True}),
    ("step", {}), ("step", {"whole_solve": False}), ("step", {"whole_solve": True}),
    ("step", {"whole_step": True}), ("step", {"tail_from": 1}),
], ids=["cavity-whole_solve", "channel-whole_solve", "step", "step-per_kernel",
        "step-whole_solve", "step-whole_step", "step-tail_from"])
def test_pin_mean_is_ignored_where_the_reference_ignores_it(flow, ov):
    """The cavity's and the channel's whole-solve and every solve of the
    step build and run unpinned: bit-identical to pin_mean=False."""
    _assert_same_in_the_reference(flow, ({**PIN, **ov}, ov))
    _assert_same([_run(_case(flow, {**pin, **ov}), 3) for pin in ({}, PIN)], torch.equal)


@pytest.mark.parametrize("ov", [{"whole_solve": True}, {"whole_step": True}],
                         ids=["whole_solve", "whole_step"])
def test_rb_whole_solve_pins_whatever_the_config_says(ov):
    """Rayleigh-Benard's whole-solve (and whole step) pin the mean with
    pin_mean=False in the config, as the reference's factory does:
    bit-identical to the default config and a zero interior mean of p."""
    _assert_same_in_the_reference("rb", (ov, {**ov, "pin_mean": False}))
    runs = [_run(_case("rb", {**ov, **pin}), 5) for pin in ({}, {"pin_mean": False})]
    _assert_same(runs, torch.equal)
    case = _case("rb", ov)
    p = from_quad(runs[1][1].p, case.grid.shape)[1:-1, 1:-1]
    assert abs(float(p.double().mean())) < 1e-6 * float(p.abs().max())
