"""The whole-solve's and the whole step's bfloat16 coarse hierarchy
(MGConfig.coarse_dtype="bfloat16" with whole_solve or whole_step) on the
CPU, where the kernels run their plain twins.

The reference's bf16 whole-solve (cfd_tpu/kernels/whole_solve.py:178, 297,
mg_tail.run_tail_vcycle(store_dtype)) is not its per-kernel bf16 hierarchy:
float32 levels whose constants are rounded to bf16 once, the sources b[k]
and pre-smoothed iterates ps[k] stored in bf16, float32 arithmetic and a
float32 correction between levels.

* The twin against cfd_tpu's make_quad_whole_solve / make_quad_step_whole_solve
  with coarse_dtype="bfloat16" in interpret mode (the channel problem at
  64^2, the step at 64x16, RB's pin-mean solve at 64x32): cycles within 1,
  p within 80 tol (tests/test_coarse_dtype.py:191,225).
* The twin's stored b[k] and ps[k] exactly bf16-representable, the residual
  taken before the rounding, and its constants equal to the reference's
  build_tail_consts(dtype=bfloat16).
* One whole step a flavor with bf16 against cfd_tpu's
  make_quad_whole_step_* (interpret), within the bands of
  tests/test_torch_whole_step.py; whole step on and off bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step
from cfd_tpu.cases.cavity import make_cavity_case as jax_cavity
from cfd_tpu.cases.channel import make_channel_case as jax_channel
from cfd_tpu.kernels import mg_tail as JMT
from cfd_tpu.kernels import whole_solve as JW
from cfd_tpu.kernels import whole_step as JWS
from cfd_tpu.kernels.quad import to_quad as jax_to_quad
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_rb
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu.state import State as JaxState
from cfd_tpu_torch import cli
from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.convert import state_from_numpy
from cfd_tpu_torch.kernels import KERNELS
from cfd_tpu_torch.kernels import mg_tail as MT
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.kernels import whole_step as TWS
from cfd_tpu_torch.kernels.quad import to_quad
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

BF16 = "bfloat16"
TOL = 1e-4


def _source(shape, mask, seed, zero_mean=False):
    rng = np.random.default_rng(seed)
    b = np.where(mask, rng.standard_normal(shape), 0.0).astype(np.float32)
    if zero_mean:
        b = np.where(mask, b - b.sum(dtype=np.float64) / mask.sum(), 0.0).astype(np.float32)
    return b


def _solve_pair(jsolve, tsolve, b, shape):
    jb, tb = jax_to_quad(jnp.asarray(b), shape), to_quad(torch.from_numpy(b), shape)
    jp, jit, jres = jsolve(jnp.zeros_like(jb), jb)
    tp, tit, tres = tsolve(torch.zeros_like(tb), tb)
    return (np.asarray(jp), int(jit), float(jres)), (tp.numpy(), int(tit), float(tres))


def _assert_bf16_band(want, got, b):
    tol = TOL * float(np.abs(b).max())
    (jp, jit, jres), (tp, tit, tres) = want, got
    assert tres <= tol and jres <= tol, (tres, jres, tol)
    assert abs(tit - jit) <= 1, (tit, jit)
    gap = float(np.abs(tp - jp).max())
    print(f"cycles {tit} (reference {jit}), max|p - p_ref| = {gap / tol:.3e} tol")
    assert gap <= 80 * tol, (gap, tol)


SEPARABLE = {
    "channel": (64, 64, "channel_problem", False),
    "rb": (64, 32, "neumann_problem", True),
}


@pytest.mark.parametrize("flow", sorted(SEPARABLE))
def test_bf16_whole_solve_matches_jax(flow):
    nx, ny, flavor, pin = SEPARABLE[flow]
    shape = (ny + 2, nx + 2)
    dx, dy = 1.0 / nx, 1.0 / ny
    kw = dict(pre_sweeps=2, post_sweeps=1, tol_factor=TOL, coarse_dtype=BF16, pin_mean=pin)
    jsolve = JW.make_quad_whole_solve(shape, getattr(JM, flavor)(nx, ny, dx, dy),
                                      JM.MGConfig(**kw), pin_mean=pin, interpret=True)
    tsolve = TW.make_quad_whole_solve(shape, getattr(TM, flavor)(nx, ny, dx, dy),
                                      TM.MGConfig(**kw), pin_mean=pin)
    assert tsolve.mg.store_dtype == torch.bfloat16
    assert tsolve._fine()[5] is (TW.WHOLE_SOLVE_PIN_MEAN_BF16 if pin else TW.WHOLE_SOLVE_BF16)
    mask = np.zeros(shape, bool)
    mask[1 : ny + 1, 1 : nx + 1] = True
    b = _source(shape, mask, seed=7, zero_mean=pin)
    want, got = _solve_pair(jsolve, tsolve, b, shape)
    _assert_bf16_band(want, got, b)


def test_bf16_masked_whole_solve_matches_jax():
    port = make_backwards_step_case(nx=64, ny=16, poisson="multigrid", dtype=torch.float32,
                                    device="cpu")
    jcase = jax_step(nx=64, ny=16, poisson="multigrid", dtype=jnp.float32,
                     smoother_mode="off")
    kw = dict(pre_sweeps=2, post_sweeps=1, tol_factor=TOL, coarse_dtype=BF16)
    jsolve = JW.make_quad_step_whole_solve(jcase.grid, jcase.coeffs, JM.MGConfig(**kw),
                                           interpret=True)
    tsolve = TW.make_quad_step_whole_solve(port.grid, port.coeffs, TM.MGConfig(**kw))
    assert tsolve._fine()[5] is TW.STEP_WHOLE_SOLVE_BF16
    b = _source(port.grid.shape, np.asarray(port.grid.fluid), seed=11)
    want, got = _solve_pair(jsolve, tsolve, b, port.grid.shape)
    _assert_bf16_band(want, got, b)


def _representable(t: torch.Tensor) -> bool:
    return torch.equal(t, t.to(torch.bfloat16).float())


def test_twin_stores_bf16_values(monkeypatch):
    """run_tail_vcycle(store_dtype=bf16): every level's source b[k] (b0
    included) and the iterate each post-smoothing starts from, the stored
    ps[k], are bf16 values; ps[k] is the rounded pre-smoothed iterate (the
    smoother returns it unrounded, with its residual); the correction it
    returns is float32."""
    n = 64
    shape = (n + 2, n + 2)
    ws = TW.WholeSolve(shape, TM.channel_problem(n, n, 1 / n, 1 / n),
                       TM.MGConfig(pre_sweeps=2, post_sweeps=1, coarse_dtype=BF16))
    mg = ws.mg
    levels = mg.levels[1:]
    seen = {"pre_b": [], "pre_p": [], "post_b": [], "post_p": [], "coarse_b": []}

    class Rec:
        def __init__(self, op, kind):
            self.op, self.kind = op, kind

        def plain(self, p, b):
            seen[f"{self.kind}_b"].append(b)
            out = self.op.plain(p, b)
            if self.kind == "pre":
                seen["pre_p"].append(out[0])
            else:
                seen["post_p"].append(p)
            return out

    def coarse(b):
        seen["coarse_b"].append(b)
        return mg.coarse_solve(b)

    # a zero prolongation leaves the post-smoothers' start at the stored ps[k]
    monkeypatch.setattr(MT, "_prolong", lambda coarse_lv, fine, e: torch.zeros(fine.shape))
    rng = np.random.default_rng(1)
    rc = torch.zeros(levels[0].shape)
    rc[1 : levels[0].ny + 1, 1 : levels[0].nx + 1] = torch.from_numpy(
        rng.standard_normal((levels[0].ny, levels[0].nx)).astype(np.float32))
    e = MT.run_tail_vcycle(levels, rc, [Rec(op, "pre") for op in mg.pre],
                           [Rec(op, "post") for op in mg.post], coarse, plain=True,
                           store_dtype=torch.bfloat16)
    assert len(seen["pre_b"]) == len(levels) - 1 and len(seen["coarse_b"]) == 1
    for b in seen["pre_b"] + seen["post_b"] + seen["coarse_b"]:
        assert b.dtype == torch.float32 and _representable(b)
    assert torch.equal(seen["pre_b"][0], rc.to(torch.bfloat16).float())
    for ps, p_post in zip(seen["pre_p"], reversed(seen["post_p"]), strict=True):
        assert not _representable(ps)  # the smoother's own output is float32
        assert torch.equal(p_post, ps.to(torch.bfloat16).float())
    assert e.dtype == torch.float32 and not _representable(e)


@pytest.mark.parametrize("flow", ["cavity", "step"])
def test_bf16_constants_equal_build_tail_consts(flow):
    """Weights and the coarsest pinv rounded to bf16 once, as
    build_tail_consts(dtype=bfloat16) rounds the reference's float32
    constants (the cavity's edge fix 4/3 -> 1.3359375)."""
    if flow == "cavity":
        n = 64
        shape = (n + 2, n + 2)
        ts = TW.WholeSolve(shape, TM.cavity_problem(n, n, 1 / n, 1 / n),
                           TM.MGConfig(coarse_dtype=BF16))
        tlevels = ts.mg.levels[1:]
        probs = [JM.cavity_problem(n, n, 1 / n, 1 / n)]
        while len(probs) < len(ts.mg.levels):
            probs.append(JM.coarsen_problem(probs[-1]))
        jlevels = [JM._build_level(p, jnp.float32, aligned=True) for p in probs[1:]]
    else:
        port = make_backwards_step_case(nx=64, ny=16, poisson="multigrid",
                                        dtype=torch.float32, device="cpu")
        jcase = jax_step(nx=64, ny=16, poisson="multigrid", dtype=jnp.float32,
                         smoother_mode="off")
        ts = TW.StepWholeSolve(port.grid, port.coeffs, TM.MGConfig(coarse_dtype=BF16))
        tlevels = ts.mg.levels
        probs = [JM.masked_channel_problem(jcase.grid, jcase.coeffs.dx, jcase.coeffs.dy)]
        while len(probs) < len(tlevels) + 1:
            probs.append(JM.coarsen_problem(probs[-1]))
        jlevels = [JM._build_level(p, jnp.float32, aligned=True, allow_full=True)
                   for p in probs[1:]]
    consts, w_idx, _, m_idx = JMT.build_tail_consts(jlevels, JM._dense_pinv(probs[-1]),
                                                    dtype=np.dtype(ml_dtypes.bfloat16))
    for k, lv in enumerate(tlevels):
        assert lv.dtype == torch.float32
        for i, w in enumerate(("wE", "wW", "wN", "wS")):
            np.testing.assert_array_equal(getattr(lv, w).numpy().reshape(-1),
                                          consts[w_idx[k] + i].astype(np.float32).reshape(-1))
    blocks = JMT._pinv_lane_blocks(ts.mg.pinv.numpy(), tlevels[-1])
    for i, blk in enumerate(blocks):
        np.testing.assert_array_equal(blk, consts[m_idx + i].astype(np.float32))
    if flow == "cavity":
        assert float(tlevels[0].wS[1, 0]) == 1.3359375


# (port factory, its kwargs, reference factory, its kwargs): the configs of
# tests/test_torch_whole_step.py
FLOWS = {
    "cavity": (make_cavity_case,
               dict(n_interior=32, poisson="multigrid", tolerance_factor=1e-5,
                    final_time=1.0),
               jax_cavity,
               dict(n_interior=32, dtype=jnp.float32, poisson="multigrid",
                    tolerance_factor=1e-5, final_time=1.0, step_kernel_mode="interpret",
                    layout="quad")),
    "channel": (make_channel_case,
                dict(nx=64, ny=32, poisson="multigrid", tolerance_factor=1e-5),
                jax_channel,
                dict(nx=64, ny=32, dtype=jnp.float32, poisson="multigrid",
                     tolerance_factor=1e-5, layout="quad", step_kernel_mode="interpret")),
    "rb": (make_rayleigh_benard_case,
           dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5, abs_tol=1e-7),
           jax_rb,
           dict(nx=48, ny=16, rayleigh=1e5, dtype=jnp.float32, tolerance_factor=1e-5,
                abs_tol=1e-7, step_kernel_mode="interpret", layout="quad")),
    "step": (make_backwards_step_case,
             dict(nx=64, ny=16, poisson="multigrid", tolerance_factor=1e-5),
             jax_step,
             dict(nx=64, ny=16, dtype=jnp.float32, poisson="multigrid",
                  tolerance_factor=1e-5, layout="quad", smoother_mode="interpret")),
}
WS_BF16 = {"whole_step": True, "coarse_dtype": BF16}
RECORDS = {"cavity": TWS.WHOLE_STEP_CAVITY_BF16, "channel": TWS.WHOLE_STEP_CHANNEL_BF16,
           "rb": TWS.WHOLE_STEP_RB_BF16, "step": TWS.WHOLE_STEP_STEP_BF16}


def _port_case(flow, **ov):
    make, kw, _, _ = FLOWS[flow]
    return make(dtype=torch.float32, device="cpu", **{**kw, **ov})


def _seeded(case, seed):
    sim = Simulation(case, log=lambda m: None)
    st = sim._logical(sim.initial_state())
    rng = np.random.default_rng(seed)
    mask = np.asarray(case.grid.cell_mask, dtype=np.float32)
    f = {k: getattr(st, k).numpy().copy() for k in ("u", "v", "p", "T", "p_prev")
         if getattr(st, k) is not None}
    for k, scale in (("u", 0.05), ("v", 0.05), ("p", 0.01)):
        f[k] = f[k] + (scale * rng.standard_normal(f[k].shape) * mask).astype(np.float32)
    return f


def _jax_whole_step(flow, case, jcase):
    """The reference's whole-step kernel of ``flow`` with the port case's
    own MGConfig (coarse_dtype bfloat16), in interpret mode."""
    cfg = JM.MGConfig(**dataclasses.asdict(case.info["mg"]))
    g, c = jcase.grid, jcase.coeffs
    if flow == "cavity":
        prob = JM.cavity_problem(g.nx, g.ny, g.dx, g.dy)
        return JWS.make_quad_whole_step_cavity(g.shape, prob, c, cfg, interpret=True)
    if flow == "channel":
        prob = JM.channel_problem(g.nx, g.ny, g.dx, g.dy)
        return JWS.make_quad_whole_step_channel(g.shape, prob, c, cfg, g.nx * g.ny,
                                                interpret=True)
    if flow == "rb":
        prob = JM.neumann_problem(g.nx, g.ny, g.dx, g.dy)
        return JWS.make_quad_whole_step_rb(g.shape, prob, c, cfg,
                                           case.whole_step_kernel.carry.kappa, g.nx * g.ny,
                                           interpret=True)
    l0 = case.whole_step_kernel.solver.mg.pre0
    return JWS.make_quad_whole_step_step(g, c, cfg, l0.step_i, l0.inlet_j, interpret=True)


def _carried(flow, s):
    if flow == "rb":
        return (s.u, s.v, s.p, s.T)
    return (s.u, s.v, s.p) if flow == "step" else (s.u, s.v, s.p, s.p_prev)


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_bf16_whole_step_matches_jax(flow):
    case = _port_case(flow, mg_overrides=WS_BF16)
    ws = case.whole_step_kernel
    assert ws.record is RECORDS[flow] and ws.solver.mg.store_dtype == torch.bfloat16
    _, _, make_jax, jkw = FLOWS[flow]
    jcase = make_jax(**jkw)
    f = _seeded(case, seed=13)
    got = ws(*_carried(flow, case.align_state(state_from_numpy(
        f["u"], f["v"], f["p"], f.get("p_prev"), f.get("T")))))
    js = jcase.align_state(JaxState(*(jnp.asarray(f[k]) if k in f else None
                                      for k in ("u", "v", "p", "T", "p_prev"))))
    want = _jax_whole_step(flow, case, jcase)(*_carried(flow, js))
    a, b = int(got[-2]), int(want[-2])
    assert abs(a - b) <= max(2, round(0.25 * max(a, b))), (a, b)
    for g_, w_ in zip(got[:-2], want[:-2], strict=True):
        w_ = np.asarray(w_)
        scale = max(1.0, float(np.abs(w_).max()))
        np.testing.assert_allclose(g_.numpy(), w_, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_bf16_whole_step_equals_bf16_whole_solve(flow):
    """On the CPU the bf16 whole step and the bf16 whole-solve take the same
    steps, bit for bit with equal cycles."""
    on = _port_case(flow, mg_overrides=WS_BF16)
    off = _port_case(flow, mg_overrides={"whole_solve": True, "coarse_dtype": BF16})
    assert isinstance(off.poisson_solve, (TW.WholeSolve, TW.StepWholeSolve))
    out = []
    for case in (on, off):
        sim = Simulation(case, log=lambda m: None)
        s = sim.initial_state()
        iters = []
        for _ in range(3):
            s, d = sim._step(s)
            iters.append(int(d.poisson_iters))
        out.append((iters, sim._logical(s)))
    assert out[0][0] == out[1][0]
    for name in ("u", "v", "p", "T"):
        a, b = getattr(out[0][1], name), getattr(out[1][1], name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), f"{flow} {name}"


def test_bf16_kernels_are_registered():
    names = {k.name: k for k in KERNELS}
    for kern in (TW.WHOLE_SOLVE_BF16, TW.WHOLE_SOLVE_PIN_MEAN_BF16, TW.STEP_WHOLE_SOLVE_BF16,
                 *RECORDS.values()):
        assert names[kern.name] is kern and kern.replaces.endswith("coarse_dtype)")


def test_cli_runs_bf16_whole_solve(capsys):
    assert cli.main(["channel", "--Nx", "64", "--Ny", "32", "--T", "1.0", "--steps", "2",
                     "--poisson", "multigrid", "--device", "cpu", "--print-interval", "2",
                     "--save-interval", "2", "--steps-per-call", "2", "--no-vtk",
                     "--mg", "whole_solve=true,coarse_dtype=bfloat16"]) == 0
    assert "PPE iters" in capsys.readouterr().out
