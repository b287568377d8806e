"""cfd_tpu_torch's whole-solve (kernels.whole_solve) on the CPU: its plain
twin against cfd_tpu's make_quad_whole_solve in interpret mode on the
channel operator (the port of tests/test_whole_solve.py:26-63: cycle
counts within +-1, p within 50 tol, since the reference's in-VMEM
hierarchy rounds its transfers differently), and against the port's own
per-kernel composition (identical: the twin is that composition's plain
arithmetic). Also the auto rule, the guards and the dispatch. The CUDA
kernel is held to the twin on the card by tests/test_torch_channel_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.kernels import whole_solve as JW
from cfd_tpu.kernels.quad import to_quad as jax_to_quad
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.poisson import multigrid as TM

torch.set_num_threads(1)

NX, NY = 64, 32
SHAPE = (NY + 2, NX + 2)
COARSE = (24, 128)


def _source(seed):
    b = np.zeros(SHAPE, np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(seed).standard_normal((NY, NX))
    return b


def _port(cfg):
    return TW.make_quad_whole_solve(SHAPE, TM.channel_problem(NX, NY, 3.0 / NX, 1.0 / NY),
                                    cfg)


def _per_kernel(cfg):
    prob = TM.channel_problem(NX, NY, 3.0 / NX, 1.0 / NY)
    l0 = (TQ.make_quad_pre_smooth_restrict(SHAPE, prob, cfg.omega, cfg.pre_sweeps, COARSE),
          TQ.make_quad_post_prolong_smooth(SHAPE, prob, cfg.omega, cfg.post_sweeps, COARSE))
    return TM.make_multigrid_poisson(prob, cfg, l0)


def test_twin_matches_jax_whole_solve_channel():
    kw = dict(pre_sweeps=2, post_sweeps=1, tol_factor=1e-4)
    b = _source(5)
    jsolve = JW.make_quad_whole_solve(SHAPE, JM.channel_problem(NX, NY, 3.0 / NX, 1.0 / NY),
                                      JM.MGConfig(**kw), interpret=True)
    jb = jax_to_quad(jnp.asarray(b), SHAPE)
    jp, jit, jres = jsolve(jnp.zeros_like(jb), jb)
    tb = TQ.to_quad(torch.from_numpy(b), SHAPE)
    tp, tit, tres = _port(TM.MGConfig(**kw))(torch.zeros_like(tb), tb)
    tol = 1e-4 * float(np.abs(b).max())
    assert float(jres) <= tol and float(tres) <= tol
    assert abs(tit - int(jit)) <= 1, (tit, int(jit))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=50 * tol)


@pytest.mark.parametrize("kw", [dict(pre_sweeps=1, post_sweeps=2, tol_factor=1e-5),
                                dict(pre_sweeps=2, post_sweeps=1, tol_factor=1e-4,
                                     max_cycles=3)])
def test_twin_equals_per_kernel_composition(kw):
    """Same cycles, residual and iterate, bit for bit, from a warm start."""
    cfg = TM.MGConfig(**kw)
    b = TQ.to_quad(torch.from_numpy(_source(6)), SHAPE)
    p0 = TQ.to_quad(torch.from_numpy(_source(7) * 1e-3), SHAPE)
    got = _port(cfg)(p0, b)
    want = _per_kernel(cfg)(p0, b)
    assert got[1] == want[1] and got[2] == want[2]
    assert torch.equal(got[0], want[0])
    if "max_cycles" in kw:
        assert got[1] == 3


def test_given_max_b_sets_the_tolerance():
    cfg = TM.MGConfig(pre_sweeps=1, post_sweeps=2, tol_factor=1e-3)
    b = TQ.to_quad(torch.from_numpy(_source(8)), SHAPE)
    solve = _port(cfg)
    loose = solve(torch.zeros_like(b), b, torch.tensor(100.0 * float(b.abs().max())))
    tight = solve(torch.zeros_like(b), b)
    assert loose[1] < tight[1]


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    cfg = TM.MGConfig(pre_sweeps=1, post_sweeps=2, tol_factor=1e-4)
    b = TQ.to_quad(torch.from_numpy(_source(9)), SHAPE)
    solve = _port(cfg)
    before = TW.WHOLE_SOLVE.launches
    a, c = solve(torch.zeros_like(b), b), solve.plain(torch.zeros_like(b), b)
    assert torch.equal(a[0], c[0]) and a[1:] == c[1:]
    assert TW.WHOLE_SOLVE.launches == before


def test_bf16_hierarchy_and_shallow_hierarchies_raise():
    """The bf16 hierarchy is ported (tests/test_torch_coarse_bf16.py); any
    other coarse_dtype raises the reference's ValueError."""
    assert _port(TM.MGConfig(coarse_dtype="bfloat16")).mg.store_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        _port(TM.MGConfig(coarse_dtype="float16"))
    with pytest.raises(ValueError, match="3 levels"):
        TW.make_quad_whole_solve((18, 34), TM.channel_problem(32, 16, 0.1, 0.1),
                                 TM.MGConfig(min_coarse=8))


def test_auto_rule_matches_jax():
    """The port's rule is the reference's with "device is cuda" for
    "platform is tpu and not interpret"; no build rejection is swallowed."""
    cases = [None, {"pre_sweeps": 2}, {"whole_solve": False}, {"whole_solve": True},
             {"coarse_dtype": "bfloat16"}, {"tail_from": 1}]
    for ov in cases:
        cfg = dataclasses.replace(TM.MGConfig(), **(ov or {}))
        jcfg = JM.MGConfig(**dataclasses.asdict(cfg))
        for on_cuda in (True, False):
            got = TW.auto_whole_solve(cfg, ov, on_cuda, build=lambda: "whole",
                                      fallback=lambda: "per-kernel")
            want = JW.auto_whole_solve(jcfg, ov, not on_cuda, build=lambda: "whole",
                                       fallback=lambda: "per-kernel")
            assert got[0] == want[0] and got[1].whole_solve == want[1].whole_solve, ov

    def reject():
        raise ValueError("rejected")

    with pytest.raises(ValueError, match="rejected"):
        TW.auto_whole_solve(TM.MGConfig(), None, True, build=reject, fallback=lambda: 0)


def test_cavity_whole_solve_override_equals_per_kernel_default():
    """The cavity takes the whole-solve only when asked for; on the CPU its
    twin steps exactly like the default per-kernel path."""
    from cfd_tpu_torch.cases import make_cavity_case
    from cfd_tpu_torch.solver import Simulation

    kw = dict(n_interior=32, poisson="multigrid", dtype=torch.float32, device="cpu",
              tolerance_factor=1e-5, final_time=1.0)
    runs = []
    for ov in (None, {"whole_solve": True}):
        case = make_cavity_case(mg_overrides=ov, **kw)
        assert isinstance(case.poisson_solve, TW.WholeSolve) == bool(ov)
        sim = Simulation(case, log=lambda m: None)
        state = sim.run(n_steps=3)
        runs.append((sim.step_iters, sim._logical(state)))
    (ia, sa), (ib, sb) = runs
    assert ia == ib
    assert all(torch.equal(getattr(sa, n), getattr(sb, n)) for n in ("u", "v", "p"))
