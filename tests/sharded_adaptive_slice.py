"""The slice check of tests/test_torch_quad_sharded_adaptive_{cavity,channel,
rb,step}.py (one reference run a file, each about 45 s on one core): the
port's run_adaptive on a 4-shard CPU mesh against the reference's, lagged,
max_courant 0.5, 4 steps in chunks of 2, a stats row every 2 steps, at
tests/test_adaptive_sharded.py's _compare bands (:21-35): dt rtol 1e-5,
Courant rtol 1e-4 atol 1e-7, the final logical fields within 3e-5 of
scale. Both engines take their default sharded solve (tol_factor 1e-9)."""

import jax
import numpy as np
import torch
from jax.sharding import Mesh as JaxMesh

from cfd_tpu.adaptive import run_adaptive as jax_run_adaptive
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.parallel import make_mesh
from cfd_tpu_torch.solver import Simulation

MDY = 4
RUN = dict(max_courant=0.5, n_steps=4, steps_per_call=2, controller="lagged")


def reference_run(case, mesh: bool = True):
    """The reference's lagged run on the 4-device host mesh (``mesh``) or on
    one device: (logical state, rows)."""
    jmesh = JaxMesh(np.array(jax.devices("cpu")[:MDY]), ("dy",)) if mesh else None
    return jax_run_adaptive(JaxSimulation(case, log=lambda *a: None, mesh=jmesh), **RUN)


def port_run(case):
    """The port's lagged run on a 4-shard CPU mesh: (logical state, rows, the
    Simulation)."""
    sim = Simulation(case, log=lambda m: None, mesh=make_mesh(MDY, device="cpu"))
    assert not sim._engine.delegated
    return (*run_adaptive(sim, **RUN), sim)


def hold(ref, got, fields=("u", "v", "p")):
    """The reference test's _compare: every row's step, dt and Courant number,
    then the final fields."""
    (ref_state, ref_rows), (got_state, got_rows, sim) = ref, got
    assert len(got_rows) == len(ref_rows) == 2
    for got_row, ref_row in zip(got_rows, ref_rows, strict=True):
        assert got_row["step"] == ref_row["step"]
        np.testing.assert_allclose(got_row["dt"], ref_row["dt"], rtol=1e-5, err_msg="dt")
        np.testing.assert_allclose(got_row["courant"], ref_row["courant"], rtol=1e-4,
                                   atol=1e-7, err_msg="courant")
    assert len(sim.step_dts) == len(sim.step_iters) == RUN["n_steps"]
    for name in fields:
        a = np.asarray(getattr(ref_state, name))
        b = getattr(got_state, name)
        assert isinstance(b, torch.Tensor) and b.shape == a.shape, name
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=3e-5 * max(1.0, float(np.abs(a).max())), err_msg=name)
