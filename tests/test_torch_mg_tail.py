"""The fused multigrid coarse tail (cfd_tpu_torch.kernels.mg_tail.MGTail,
MGConfig.tail_from) on the CPU, where it runs its plain twin.

* The tail against cfd_tpu's make_mg_tail(interpret=True): the cavity and
  channel problems at 64^2 and the pure-Neumann (RB) problem at 32^2, from
  global level 1 and level 2, and the step's masked full-2D coarse levels
  at 64x16, within the reference's own band atol = 2e-5 max|e|
  (tests/test_mg_tail.py:91,119): its tail sums the transfers as matmuls,
  in another order.
* The port's per-kernel solve with and without tail_from: bit-identical on
  the CPU (the tail's twin is the same composition).
* 3 steps of each flow with mg_overrides={"tail_from": 1} against the JAX
  case with the same overrides (interpret mode): cycles within max(2, 25%)
  and fields within 1e-4 max(1, max|field|), the reference's tail-trajectory
  band (tests/test_mg_tail.py:148-177).
* The reference's rules: out-of-range values ignored, coarse_dtype with
  tail_from a ValueError, tail_from a manual knob (the per-kernel path) on
  the card, whole_solve superseding it; the CLI's --mg tail_from=1.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step
from cfd_tpu.cases.cavity import make_cavity_case as jax_cavity
from cfd_tpu.cases.channel import make_channel_case as jax_channel
from cfd_tpu.kernels.mg_tail import make_mg_tail
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_rb
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch import cli
from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.kernels import KERNELS
from cfd_tpu_torch.kernels import mg_tail as MT
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level
from cfd_tpu_torch.kernels.whole_solve import WholeSolve, auto_whole_solve
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

CFG = dict(pre_sweeps=2, post_sweeps=1, min_coarse=4)
TAIL = {"tail_from": 1}


def _jax_probs(problem, cfg):
    probs = [problem]
    while (probs[-1].nx % 2 == 0 and probs[-1].ny % 2 == 0
           and probs[-1].nx // 2 >= cfg.min_coarse and probs[-1].ny // 2 >= cfg.min_coarse):
        probs.append(JM.coarsen_problem(probs[-1]))
    return probs


def _noise(level, seed):
    rng = np.random.default_rng(seed)
    b = np.zeros(level.shape, np.float32)
    b[1 : level.ny + 1, 1 : level.nx + 1] = rng.standard_normal((level.ny, level.nx))
    return b


def _port_tail(tprobs, cfg):
    levels = [TM._build_level(p, torch.float32, allow_full=True) for p in tprobs]
    pre = [rb_pairs_for_level(lv, cfg.omega, cfg.pre_sweeps, with_residual_field=True)
           for lv in levels[:-1]]
    post = [rb_pairs_for_level(lv, cfg.omega, cfg.post_sweeps) for lv in levels[:-1]]
    pinv = torch.as_tensor(TM._dense_pinv(tprobs[-1]), dtype=torch.float32)
    return MT.MGTail(levels, pre, post, pinv)


def _assert_tail_band(got, want):
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("start", [1, 2])
@pytest.mark.parametrize("flavor,n", [("cavity_problem", 64), ("channel_problem", 64),
                                      ("neumann_problem", 32)])
def test_tail_matches_jax_tail(flavor, n, start):
    cfg, jcfg = TM.MGConfig(**CFG), JM.MGConfig(**CFG)
    tprobs = TM.build_problems(getattr(TM, flavor)(n, n, 1 / n, 1 / n), cfg)[start:]
    jprobs = _jax_probs(getattr(JM, flavor)(n, n, 1 / n, 1 / n), jcfg)[start:]
    assert len(tprobs) == len(jprobs) >= 2
    tail = _port_tail(tprobs, cfg)
    assert tail.record is MT.MG_TAIL
    b = _noise(tail.levels[0], seed=3)
    jlevels = [JM._build_level(p, jnp.float32, aligned=True) for p in jprobs]
    want = np.asarray(make_mg_tail(jlevels, jcfg.omega, jcfg.pre_sweeps, jcfg.post_sweeps,
                                   JM._dense_pinv(jprobs[-1]), interpret=True)(jnp.asarray(b)))
    before = MT.MG_TAIL.launches
    got = tail(torch.from_numpy(b))
    assert MT.MG_TAIL.launches == before  # the CPU runs the twin
    _assert_tail_band(got.numpy(), want)


def test_tail_matches_jax_tail_masked_full_weights():
    """The backward step's coarse hierarchy (full-2D weights, the solid
    fill), the tail over every coarse level (global tail_from = 1)."""
    cfg, jcfg = TM.MGConfig(**CFG), JM.MGConfig(**CFG)
    port = make_backwards_step_case(nx=64, ny=16, poisson="multigrid", dtype=torch.float32,
                                    device="cpu")
    jcase = jax_step(nx=64, ny=16, poisson="multigrid", dtype=jnp.float32,
                     smoother_mode="off")
    tprobs = TM.build_problems(
        TM.masked_channel_problem(port.grid, port.coeffs.dx, port.coeffs.dy), cfg)[1:]
    jprobs = _jax_probs(JM.masked_channel_problem(jcase.grid, jcase.coeffs.dx,
                                                  jcase.coeffs.dy), jcfg)[1:]
    tail = _port_tail(tprobs, cfg)
    assert tail.record is MT.MG_TAIL_FULL and not tail.levels[0].separable
    b = _noise(tail.levels[0], seed=7)
    jlevels = [JM._build_level(p, jnp.float32, aligned=True, allow_full=True) for p in jprobs]
    want = np.asarray(make_mg_tail(jlevels, jcfg.omega, jcfg.pre_sweeps, jcfg.post_sweeps,
                                   JM._dense_pinv(jprobs[-1]), interpret=True)(jnp.asarray(b)))
    _assert_tail_band(tail(torch.from_numpy(b)).numpy(), want)


def _port_l0(shape, prob, cfg, coarse):
    return (TQ.make_quad_pre_smooth_restrict(shape, prob, cfg.omega, cfg.pre_sweeps, coarse),
            TQ.make_quad_post_prolong_smooth(shape, prob, cfg.omega, cfg.post_sweeps, coarse))


@pytest.mark.parametrize("tail_from", [1, 2, 3])
@pytest.mark.parametrize("flavor", ["cavity_problem", "neumann_problem"])
def test_per_kernel_solve_with_tail_is_bit_identical(flavor, tail_from):
    n = 64
    shape = (n + 2, n + 2)
    prob = getattr(TM, flavor)(n, n, 1 / n, 1 / n)
    coarse = TM._round_up8_128((n // 2 + 2, n // 2 + 2))
    base = TM.MGConfig(pre_sweeps=2, post_sweeps=1, tol_factor=1e-5,
                       pin_mean=flavor == "neumann_problem")
    rng = np.random.default_rng(tail_from)
    b = np.zeros(shape, np.float32)
    b[1 : n + 1, 1 : n + 1] = rng.standard_normal((n, n))
    b[1 : n + 1, 1 : n + 1] -= b[1 : n + 1, 1 : n + 1].mean(dtype=np.float64)
    b4 = TQ.to_quad(torch.from_numpy(b), shape)
    out = []
    for cfg in (base, dataclasses.replace(base, tail_from=tail_from)):
        solve = TM.make_multigrid_poisson(prob, cfg, _port_l0(shape, prob, cfg, coarse))
        out.append(solve(torch.zeros_like(b4), b4))
    assert solve.tail_from == tail_from and len(solve.tail.levels) == len(solve.levels) - tail_from
    (pa, ia, ra), (pb, ib, rb) = out
    assert ia == ib and ra == rb and torch.equal(pa, pb)


def test_masked_per_kernel_solve_with_tail_is_bit_identical():
    port = make_backwards_step_case(nx=64, ny=16, poisson="multigrid", dtype=torch.float32,
                                    device="cpu")
    g = port.grid
    rng = np.random.default_rng(5)
    b = np.where(np.asarray(g.fluid), rng.standard_normal(g.shape), 0.0).astype(np.float32)
    b4 = TQ.to_quad(torch.from_numpy(b), g.shape)
    base = TM.MGConfig(pre_sweeps=1, post_sweeps=2, tol_factor=1e-5)
    out = []
    for tail_from in (None, 1, 2):
        solve = TM.make_masked_quad_multigrid_poisson(
            g, port.coeffs, dataclasses.replace(base, tail_from=tail_from))
        out.append(solve(torch.zeros_like(b4), b4))
    for p, it, res in out[1:]:
        assert it == out[0][1] and res == out[0][2] and torch.equal(p, out[0][0])


# (reference factory, its kwargs, the port's factory, its kwargs, fields):
# the configs of tests/test_mg_tail.py's trajectory tests
FLOWS = {
    "cavity": (jax_cavity,
               dict(n_interior=32, dtype=jnp.float32, poisson="multigrid",
                    tolerance_factor=1e-5, final_time=1.0, step_kernel_mode="interpret",
                    layout="quad"),
               make_cavity_case,
               dict(n_interior=32, poisson="multigrid", tolerance_factor=1e-5, final_time=1.0),
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


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_tail_slice_matches_jax_tail_slice(flow):
    make_jax, jkw, make, kw, names = FLOWS[flow]
    case = make(dtype=torch.float32, device="cpu", mg_overrides=TAIL, **kw)
    assert case.poisson_solve.tail_from == 1 and not case.info["mg"].whole_solve
    jcase = make_jax(mg_overrides=TAIL, **jkw)
    sim, jsim = Simulation(case, log=lambda m: None), JaxSimulation(jcase, log=lambda *a: None)
    s, js = sim.initial_state(), jsim.initial_state()
    for k in range(3):
        s, d = sim._step(s)
        js, jd = jsim._step(js)
        a, b = int(d.poisson_iters), int(jd.poisson_iters)
        assert abs(a - b) <= max(2, round(0.25 * max(a, b))), (k, a, b)
    got, want = sim._logical(s), jsim._logical(js)
    for name in names:
        w = np.asarray(getattr(want, name))
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"{flow} {name}")


@pytest.mark.parametrize("tail_from", [0, 4, 9])
def test_out_of_range_tail_from_is_ignored(tail_from):
    """The separable rule 1 <= tail_from <= levels - 2 (multigrid.py:689-694)
    and the masked 0 <= tail_from - 1 <= coarse levels - 2 (:1104-1111): a
    value outside is silently ignored, as the reference ignores it."""
    cav = make_cavity_case(n_interior=32, poisson="multigrid", dtype=torch.float32,
                           device="cpu", mg_overrides={"tail_from": tail_from})
    assert len(cav.poisson_solve.levels) == 4 and cav.poisson_solve.tail_from is None
    step = make_backwards_step_case(nx=64, ny=16, poisson="multigrid", dtype=torch.float32,
                                    device="cpu", mg_overrides={"tail_from": tail_from})
    assert len(step.poisson_solve.levels) == 2 and step.poisson_solve.tail_from is None


def test_coarse_dtype_with_tail_from_raises():
    """The reference's ValueError (cfd_tpu/poisson/multigrid.py:659-662)."""
    with pytest.raises(ValueError, match="incompatible with the fused coarse tail"):
        make_cavity_case(n_interior=32, poisson="multigrid", dtype=torch.float32,
                         device="cpu", mg_overrides={"tail_from": 1,
                                                     "coarse_dtype": "bfloat16"})


def test_tail_from_is_a_manual_knob():
    """On the card tail_from takes the per-kernel path with the float32 coarse
    hierarchy (auto_whole_solve's manual rule, the cavity's auto bf16 rule
    excludes it); under whole_solve the tail is superseded."""
    cfg = TM.MGConfig(tail_from=1)
    solve, mg = auto_whole_solve(cfg, TAIL, True, build=lambda: "whole",
                                 fallback=lambda: "per-kernel")
    assert solve == "per-kernel" and not mg.whole_solve
    assert not TM.auto_bf16_coarse(True, False, cfg, TAIL)
    ws = make_cavity_case(n_interior=32, poisson="multigrid", dtype=torch.float32,
                          device="cpu", mg_overrides={"tail_from": 1, "whole_solve": True})
    assert isinstance(ws.poisson_solve, WholeSolve) and ws.poisson_solve.mg.tail_from is None


def test_tail_kernels_are_registered():
    names = {k.name: k for k in KERNELS}
    for kern in (MT.MG_TAIL, MT.MG_TAIL_FULL):
        assert names[kern.name] is kern
        assert kern.replaces.startswith("cfd_tpu/kernels/mg_tail.py:329")
        assert kern.source == "cfd_tpu_torch/csrc/mg_tail.cu"


def test_cli_runs_tail_from(capsys):
    assert cli.main(["channel", "--Nx", "64", "--Ny", "32", "--T", "1.0", "--steps", "2",
                     "--poisson", "multigrid", "--device", "cpu", "--print-interval", "2",
                     "--save-interval", "2", "--steps-per-call", "2", "--no-vtk",
                     "--mg", "tail_from=1"]) == 0
    assert "PPE iters" in capsys.readouterr().out
