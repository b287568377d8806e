"""MGConfig.corr_opt, the line-searched level-1 correction of the masked
defect-correction solve, on the CPU, where the kernels run their plain
twins.

* The port's per-kernel masked solve and its masked whole-solve twin with
  corr_opt against cfd_tpu's make_masked_quad_multigrid_poisson and
  make_quad_step_whole_solve (interpret mode) at 64x16: cycles within 1 and
  p within 5e-5 (tests/test_corr_opt.py:54-131; the reference's two
  versions differ from each other by a cycle, so each is held against its
  own counterpart).
* One steplength arithmetic (poisson.multigrid._corr_alpha): the port's
  whole_solve on and off bit-identical with corr_opt, with the bf16
  hierarchy too against its own twin.
* alpha clamped to [1, 1.5], and 1 at a zero denominator.
* The separable ValueError on every path, 3 steps of the step case with
  mg_overrides={"corr_opt": True} against the JAX case, corr_opt not a
  manual knob, and the CLI's --mg corr_opt=true.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step
from cfd_tpu.kernels import whole_solve as JW
from cfd_tpu.kernels.quad import to_quad as jax_to_quad
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
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.kernels import whole_step as TWS
from cfd_tpu_torch.kernels.quad import from_quad, to_quad
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

KW = dict(nx=64, ny=16, poisson="multigrid", tolerance_factor=1e-5)
CORR = dict(tol_factor=1e-5, abs_tol=1e-10, post_sweeps=1, corr_opt=True)


@pytest.fixture(scope="module")
def cases():
    return (make_backwards_step_case(dtype=torch.float32, device="cpu", **KW),
            jax_step(dtype=jnp.float32, smoother_mode="off", **KW))


def _zero_mean_source(grid, seed):
    """tests/test_corr_opt.py _rand_b(zero_mean=True) in float32."""
    rng = np.random.default_rng(seed)
    inter = np.asarray(grid.cell_mask)
    b = np.where(inter, rng.standard_normal(grid.shape), 0).astype(np.float32)
    return np.where(inter, b - b.sum(dtype=np.float32) / grid.n_fluid, 0).astype(np.float32)


def _run(solve, b, shape, to_q, zeros):
    b4 = to_q(b, shape)
    return solve(zeros(b4), b4)


def _port_run(solve, b, shape):
    p, it, res = _run(solve, torch.from_numpy(b), shape, to_quad, torch.zeros_like)
    return from_quad(p, shape).numpy(), int(it), float(res)


def _jax_run(solve, b, shape):
    from cfd_tpu.kernels.quad import from_quad as jax_from_quad

    p, it, res = _run(solve, jnp.asarray(b), shape, jax_to_quad, jnp.zeros_like)
    return np.asarray(jax_from_quad(p, shape)), int(it), float(res)


@pytest.mark.parametrize("path", ["per_kernel", "whole_solve"])
def test_corr_opt_matches_jax(cases, path):
    port, jcase = cases
    shape = port.grid.shape
    b = _zero_mean_source(port.grid, seed=7)
    if path == "per_kernel":
        tsolve = TM.make_masked_quad_multigrid_poisson(port.grid, port.coeffs,
                                                       TM.MGConfig(**CORR))
        jsolve = JM.make_masked_quad_multigrid_poisson(jcase.grid, jcase.coeffs,
                                                       JM.MGConfig(**CORR), interpret=True)
    else:
        tsolve = TW.make_quad_step_whole_solve(port.grid, port.coeffs, TM.MGConfig(**CORR))
        assert tsolve._fine()[5] is TW.STEP_WHOLE_SOLVE_CORR_OPT
        jsolve = JW.make_quad_step_whole_solve(jcase.grid, jcase.coeffs, JM.MGConfig(**CORR),
                                               interpret=True)
    tp, tit, _ = _port_run(tsolve, b, shape)
    jp, jit, _ = _jax_run(jsolve, b, shape)
    assert abs(tit - jit) <= 1, (tit, jit)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-5)


@pytest.mark.parametrize("coarse_dtype", [None, "bfloat16"])
def test_whole_solve_on_and_off_identical(cases, coarse_dtype):
    """The whole-solve's twin is the per-kernel cycle with the same
    steplength: bit-identical with equal cycles (f32), and with the bf16
    hierarchy the kernel's twin equals the composition it names, which reads
    the unrounded rc."""
    port, _ = cases
    cfg = TM.MGConfig(**CORR, coarse_dtype=coarse_dtype)
    b = _zero_mean_source(port.grid, seed=3)
    whole = TW.make_quad_step_whole_solve(port.grid, port.coeffs, cfg)
    if coarse_dtype is None:
        per_kernel = TM.make_masked_quad_multigrid_poisson(port.grid, port.coeffs, cfg)
    else:
        per_kernel = TM.make_masked_quad_multigrid_poisson(
            port.grid, port.coeffs, dataclasses.replace(cfg, coarse_dtype=None),
            store_dtype=torch.bfloat16)
    b4 = to_quad(torch.from_numpy(b), port.grid.shape)
    pa, ia, ra = whole(torch.zeros_like(b4), b4)
    pb, ib, rb = per_kernel(torch.zeros_like(b4), b4)
    assert int(ia) == ib and float(ra) == rb and torch.equal(pa, pb)


def test_bf16_corr_opt_reads_the_unrounded_rc(cases, monkeypatch):
    """With bf16 and corr_opt the steplength takes the float32 rc, not the
    bf16 b[0] the hierarchy stores (whole_solve.py:388-389)."""
    port, _ = cases
    seen = []
    real = TM._corr_alpha
    monkeypatch.setattr(TM, "_corr_alpha",
                        lambda level, rc, ec: seen.append(rc.clone()) or real(level, rc, ec))
    solve = TW.make_quad_step_whole_solve(port.grid, port.coeffs,
                                          TM.MGConfig(**CORR, coarse_dtype="bfloat16"))
    b4 = to_quad(torch.from_numpy(_zero_mean_source(port.grid, seed=5)), port.grid.shape)
    solve(torch.zeros_like(b4), b4)
    assert seen and any(not torch.equal(rc, rc.to(torch.bfloat16).float()) for rc in seen)


def test_alpha_is_clamped(cases):
    port, _ = cases
    level = TM.make_masked_quad_multigrid_poisson(port.grid, port.coeffs,
                                                  TM.MGConfig(**CORR)).levels[0]
    rng = np.random.default_rng(0)
    active = TM.level_masks(level, "cpu")[1]
    ec = torch.where(active, torch.from_numpy(
        rng.standard_normal(level.shape).astype(np.float32)), torch.zeros(level.shape))
    assert 1.0 <= float(TM._corr_alpha(level, ec, ec)) <= 1.5
    assert float(TM._corr_alpha(level, ec, torch.zeros(level.shape))) == 1.0  # den = 0
    # rc = s * A ec gives the raw optimum s, clamped into [1, 1.5]
    w = {k: getattr(level, k) for k in ("wE", "wW", "wN", "wS")}
    roll = lambda a, s, d: torch.roll(a, s, dims=d)
    a = (level.idx2 * (w["wE"] * (roll(ec, -1, 1) - ec) + w["wW"] * (roll(ec, 1, 1) - ec))
         + level.idy2 * (w["wN"] * (roll(ec, -1, 0) - ec) + w["wS"] * (roll(ec, 1, 0) - ec)))
    a = torch.where(active, a, torch.zeros_like(a))
    for s, want in ((0.25, 1.0), (-2.0, 1.0), (1.25, 1.25), (4.0, 1.5)):
        assert float(TM._corr_alpha(level, s * a, ec)) == pytest.approx(want, rel=1e-5), s


@pytest.mark.parametrize("make, kw", [
    (make_cavity_case, dict(n_interior=32, poisson="multigrid")),
    (make_channel_case, dict(nx=64, ny=32, poisson="multigrid")),
    (make_rayleigh_benard_case, dict(nx=48, ny=16)),
    (make_cavity_case, dict(n_interior=32, poisson="multigrid",
                            mg_overrides={"whole_step": True})),
    (make_channel_case, dict(nx=64, ny=32, poisson="multigrid",
                             mg_overrides={"whole_solve": True})),
])
def test_separable_corr_opt_raises(make, kw):
    """The reference's ValueError (multigrid.py:664-667, whole_solve.py:200-203)
    on every separable path."""
    ov = {**kw.get("mg_overrides", {}), "corr_opt": True}
    with pytest.raises(ValueError, match="corr_opt is a masked defect-correction knob"):
        make(dtype=torch.float32, device="cpu", **{**kw, "mg_overrides": ov})


def test_corr_opt_is_not_a_manual_knob():
    """The card keeps the step's whole-solve with alpha in the kernel
    (tests/test_corr_opt.py:134-153); the whole step counts on its own
    corr_opt counter."""
    solve, mg = TW.auto_whole_solve(TM.MGConfig(corr_opt=True), {"corr_opt": True}, True,
                                    build=lambda: "whole", fallback=lambda: "per-kernel")
    assert solve == "whole" and mg.whole_solve
    ws = make_backwards_step_case(dtype=torch.float32, device="cpu",
                                  mg_overrides={"corr_opt": True, "whole_step": True}, **KW)
    assert ws.whole_step_kernel.record is TWS.WHOLE_STEP_STEP_CORR_OPT
    names = {k.name: k for k in KERNELS}
    for kern in (TW.STEP_WHOLE_SOLVE_CORR_OPT, TWS.WHOLE_STEP_STEP_CORR_OPT):
        assert names[kern.name] is kern and kern.replaces.endswith("(corr_opt)")


def test_corr_opt_slice_matches_jax():
    """3 steps of the step case with mg_overrides={"corr_opt": True} against
    the JAX case (its per-kernel quad solve in interpret mode; the port's
    per-kernel solve on the CPU)."""
    ov = {"corr_opt": True}
    case = make_backwards_step_case(dtype=torch.float32, device="cpu", mg_overrides=ov, **KW)
    assert case.info["mg"].corr_opt and isinstance(case.poisson_solve,
                                                   TM.MaskedQuadMultigridPoisson)
    jcase = jax_step(dtype=jnp.float32, layout="quad", smoother_mode="interpret",
                     mg_overrides=ov, **KW)
    sim, jsim = Simulation(case, log=lambda m: None), JaxSimulation(jcase, log=lambda *a: None)
    s, js = sim.initial_state(), jsim.initial_state()
    for k in range(3):
        s, d = sim._step(s)
        js, jd = jsim._step(js)
        assert abs(int(d.poisson_iters) - int(jd.poisson_iters)) <= 1, k
    got, want = sim._logical(s), jsim._logical(js)
    for name in ("u", "v", "p"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=5e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)


def test_cli_runs_corr_opt(capsys):
    assert cli.main(["backwards_step", "--Nx", "64", "--Ny", "16", "--T", "1.0",
                     "--steps", "2", "--poisson", "multigrid", "--device", "cpu",
                     "--print-interval", "2", "--save-interval", "2", "--steps-per-call", "2",
                     "--no-vtk", "--precision", "f32", "--mg", "corr_opt=true"]) == 0
    assert "PPE iters" in capsys.readouterr().out
