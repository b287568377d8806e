"""The lagged adaptive controller on the plane-row mesh
(ShardedQuadProjection.make_adaptive through cfd_tpu_torch.adaptive.
run_adaptive) against the port's single-device lagged runs, and the routing
of run_adaptive on a mesh, on the CPU (the plain twins).

* 5 steps on 4 shards, bit-identical to the single-device lagged per-kernel
  run: the cavity as it is, the channel, RB and the step with their source
  sums (and RB's pin sums) in shard order (chip_smoke.shard_order_case); the
  same dt, cycles and Courant numbers every step. The configurations of
  tests/test_adaptive_sharded.py:38-101 and :137-157 (the step at V(1,1)),
  the sharded solves at the cases' tolerances.
* The routing (cfd_tpu/adaptive.py:219-235): the exact controller on a mesh
  raises the reference's ValueError, a 1-shard mesh delegates to the
  single-device controllers (both), make_adaptive on a delegated engine
  raises the reference's ValueError (:1125-1131), and the CLI's --mesh 4
  --adaptive-dt runs the lagged controller and refuses the exact one.
"""

import pytest
import torch

from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                 make_channel_case, make_rayleigh_benard_case)
from cfd_tpu_torch.parallel import ShardedQuadProjection, make_mesh
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

MDY = 4

# the configurations of tests/test_adaptive_sharded.py:38-101 (the step at
# V(1,1), :137-157), and the sharded solves' matching tolerances
CASES = {
    "cavity": (make_cavity_case, dict(n_interior=64, poisson="multigrid",
                                      tolerance_factor=1e-5), {"tol_factor": 1e-5}),
    "channel": (make_channel_case, dict(nx=64, ny=16, poisson="multigrid",
                                        tolerance_factor=1e-5, abs_tol=0.0),
                {"tol_factor": 1e-5}),
    "rb": (make_rayleigh_benard_case, dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5,
                                           abs_tol=1e-7),
           {"tol_factor": 1e-5, "mg_overrides": {"abs_tol": 1e-7}}),
    "step": (make_backwards_step_case, dict(nx=64, ny=16, poisson="multigrid",
                                            tolerance_factor=1e-5, abs_tol=0.0,
                                            mg_overrides={"pre_sweeps": 1, "post_sweeps": 1}),
             {"tol_factor": 1e-5}),
}


def _case(kind, **kw):
    make, case_kw, _ = CASES[kind]
    return make(dtype=torch.float32, device="cpu", **{**case_kw, **kw})


def _lagged(sim, n_steps=5, **kw):
    kw = dict(dict(max_courant=0.5, steps_per_call=1, controller="lagged"), **kw)
    st, rows = run_adaptive(sim, n_steps=n_steps, **kw)
    return st, rows, list(sim.step_iters), list(sim.step_dts)


@pytest.mark.parametrize("kind", list(CASES))
def test_sharded_lagged_run_equals_the_single_device_run_summed_in_shard_order(kind):
    """5 steps on 4 shards against the single-device lagged per-kernel run
    whose source sums (and RB's pin sums) add the shards' own-row partials in
    shard order: the same dt, cycles and fields bit for bit. The cavity sums
    nothing, so it is held to the plain single-device run."""
    from chip_smoke import shard_order_case

    sim = Simulation(_case(kind, print_interval=5), log=lambda m: None,
                     mesh=make_mesh(MDY, device="cpu"), sharded_kwargs=CASES[kind][2])
    got, rows, iters, dts = _lagged(sim)
    ref_case = _case(kind, print_interval=5)
    if kind != "cavity":
        ref_case = shard_order_case(ref_case, sim._engine)
    want, w_rows, w_iters, w_dts = _lagged(Simulation(ref_case, log=lambda m: None))
    assert len(dts) == 5 and dts == w_dts and iters == w_iters, (dts, w_dts, iters, w_iters)
    assert len(set(dts)) > 1  # the controller moved dt
    assert [r["courant"] for r in rows] == [r["courant"] for r in w_rows]
    for name in ("u", "v", "p", "T", "p_prev"):
        a, w = getattr(got, name), getattr(want, name)
        assert (a is None) == (w is None) and (a is None or torch.equal(a, w)), name


def test_exact_on_a_mesh_raises_and_a_one_shard_mesh_delegates():
    sim = Simulation(_case("cavity", print_interval=2), log=lambda m: None,
                     mesh=make_mesh(MDY, device="cpu"))
    with pytest.raises(ValueError, match="sharded adaptive runs the lagged controller"):
        run_adaptive(sim, n_steps=2, controller="exact")
    for controller in ("exact", "lagged"):
        runs = []
        for mesh in (None, make_mesh(1, device="cpu")):
            s = Simulation(_case("cavity", print_interval=2), log=lambda m: None, mesh=mesh)
            runs.append(_lagged(s, n_steps=4, steps_per_call=2, controller=controller))
        assert Simulation(_case("cavity"), mesh=make_mesh(1, device="cpu"))._engine.delegated
        (a, _, a_it, a_dt), (b, _, b_it, b_dt) = runs
        assert a_it == b_it and a_dt == b_dt
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (controller, name)


def test_make_adaptive_on_a_delegated_engine_raises():
    engine = ShardedQuadProjection(_case("rb"), make_mesh(1, device="cpu"))
    assert engine.delegated
    with pytest.raises(ValueError, match="delegates to the single-device"):
        engine.make_adaptive(0.7, 1.2, 1.0, 10)
    step, to_aligned, to_logical = ShardedQuadProjection(
        _case("rb"), make_mesh(2, device="cpu")).make_adaptive(0.7, 1.2, 1.0, 10)
    assert callable(step) and callable(to_aligned) and callable(to_logical)


def test_cli_mesh_adaptive(capsys):
    from cfd_tpu_torch.cli import main

    args = ["--T", "1.0", "--steps", "4", "--device", "cpu", "--precision", "f32",
            "--no-vtk", "--print-interval", "2", "--save-interval", "2",
            "--steps-per-call", "2", "--mesh", "4", "--adaptive-dt", "0.5"]
    assert main(["cavity", "--Nx", "64", "--Ny", "64", "--poisson", "multigrid", *args,
                 "--adaptive-controller", "lagged"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 4x1 plane-row decomposition over cpu" in out
    assert "Step      2 | t=" in out and "Step      4 | t=" in out and "| Co=" in out
    with pytest.raises(SystemExit, match="lagged"):
        main(["cavity", "--Nx", "64", "--Ny", "64", "--poisson", "multigrid", *args])
