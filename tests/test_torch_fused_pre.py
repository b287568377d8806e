"""The cavity's fused-pre carry (kernels.quad.QuadCorrPredictorSourceFusedPre,
row 7) and its solve (MultigridPoisson.solve_rc) against cfd_tpu on the
CPU, where the port runs its plain twins and the reference its Pallas
kernels in interpret mode.

* The twin against make_quad_corr_predictor_source_fused_pre(interpret=True)
  at 64^2 on seeded inputs: velocities 2e-6, b 1e-5 of max|b|, p1 and rc
  2e-6 of their scale, max|b| 1e-6 relative (tests/test_quad.py bands).
* 5 steps of make_cavity_case(n_interior=64, fuse_pre=True,
  tolerance_factor=1e-5) against the reference's: equal cycles every step,
  u and v within 5e-6, p within 5e-5 (ROADMAP.md section C's cavity bands);
  fuse_pre on and off bit-identical in the port (tests/test_quad.py:410).
* solve_rc: its first cycle from the fused carry's (p1, rc) equals the
  regular solve from the guess, bit for bit, with the float32 and the bf16
  coarse hierarchy and with the fused tail; pin_mean and the aligned solve
  raise the reference's ValueError (multigrid.py:889-892).
* fuse_pre is ignored under whole_solve and whole_step, and the adaptive
  builders keep the plain carry and the three-argument solve, as in the
  reference (cfd_tpu/cases/cavity.py:246-272)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.cases.cavity import make_cavity_case as jax_case
from cfd_tpu.kernels import quad as JQ
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.cases import make_cavity_case
from cfd_tpu_torch.kernels import KERNELS
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation, make_step

torch.set_num_threads(1)

N = 64
KW = dict(n_interior=N, poisson="multigrid", tolerance_factor=1e-5, print_interval=5)
N_STEPS = 5


def _port(**kw):
    return make_cavity_case(dtype=torch.float32, device="cpu", **{**KW, **kw})


def _np_state(st):
    return {k: np.asarray(getattr(st, k)) for k in ("u", "v", "p")}


@pytest.fixture(scope="module")
def ref():
    """The reference's fused-pre trajectory: per-step cycles and logical
    states."""
    case = jax_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad",
                    fuse_pre=True, **KW)
    assert case.carry_fused_pre
    sim = JaxSimulation(case, log=lambda m: None)
    s = sim.initial_state()
    iters, states = [], []
    for _ in range(N_STEPS):
        s, d = sim._step(s)
        iters.append(int(d.poisson_iters))
        states.append(_np_state(sim._logical(s)))
    return dict(iters=iters, states=states)


def _inputs(seed):
    shape = (N + 2, N + 2)
    rng = np.random.default_rng(seed)
    arrays = []
    for k in range(4):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k >= 2:  # p, p_prev: interior only
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        arrays.append(a)
    return (shape, [TQ.to_quad(torch.from_numpy(a), shape) for a in arrays],
            [JQ.to_quad(jnp.asarray(a), shape) for a in arrays])


def _close(got, want, scale, rel):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=rel * max(1.0, scale))


def test_fused_pre_twin_matches_jax():
    shape, tin, jin = _inputs(7)
    h = 1.0 / N
    coeffs = dict(dx=h, dy=h, dt=0.25 * h, viscosity=1e-3, density=1.0)
    coarse = JM._round_up8_128((N // 2 + 2, N // 2 + 2))
    pre = TQ.make_quad_pre_smooth_restrict(shape, TM.cavity_problem(N, N, h, h), 1.0, 2,
                                           coarse)
    op = TQ.QuadCorrPredictorSourceFusedPre(shape, TCoeffs(**coeffs), pre)
    got = op.plain(*tin)
    want = JQ.make_quad_corr_predictor_source_fused_pre(
        shape, JM.cavity_problem(N, N, h, h), JCoeffs(**coeffs), 1.0, 2, coarse,
        tile_rows=8, interpret=True)(*jin)
    max_b = float(want[5])
    _close(got[0], want[0], 1.0, 2e-6)
    _close(got[1], want[1], 1.0, 2e-6)
    _close(got[2], want[2], max_b, 1e-5)
    for k in (3, 4):
        _close(got[k], want[k], float(np.abs(np.asarray(want[k])).max()), 2e-6)
    assert abs(float(got[5]) - max_b) <= 1e-6 * max_b


def test_fused_pre_slice_matches_jax_every_step(ref):
    case = _port(fuse_pre=True)
    assert case.carry_fused_pre
    assert isinstance(case.step_kernels[0], TQ.QuadCorrPredictorSourceFusedPre)
    sim = Simulation(case, log=lambda m: None)
    s = sim.initial_state()
    for k in range(N_STEPS):
        s, d = sim._step(s)
        assert d.poisson_iters == ref["iters"][k], k
        lg, want = sim._logical(s), ref["states"][k]
        np.testing.assert_allclose(lg.u.numpy(), want["u"], rtol=0, atol=5e-6)
        np.testing.assert_allclose(lg.v.numpy(), want["v"], rtol=0, atol=5e-6)
        np.testing.assert_allclose(lg.p.numpy(), want["p"], rtol=0, atol=5e-5)


@pytest.mark.parametrize("mg", [None, {"tail_from": 1}])
def test_fuse_pre_on_and_off_bit_identical(mg):
    """The reference's test_fused_pre_carry_matches_plain_composition: only
    kernel boundaries move, so fields and cycles are equal bit for bit; the
    fused kernel launches nothing on the CPU."""
    on, off = _port(fuse_pre=True, mg_overrides=mg), _port(mg_overrides=mg)
    assert on.carry_fused_pre and not off.carry_fused_pre
    step_on, step_off = make_step(on), make_step(off)
    s_on = s_off = Simulation(on).initial_state()
    before = TQ.FUSED_PRE.launches
    for k in range(N_STEPS):
        s_on, d_on = step_on(s_on)
        s_off, d_off = step_off(s_off)
        assert d_on.poisson_iters == d_off.poisson_iters, k
        for name in ("u", "v", "p", "p_prev"):
            assert torch.equal(getattr(s_on, name), getattr(s_off, name)), (k, name)
    assert TQ.FUSED_PRE.launches == before


@pytest.mark.parametrize("mg", [{}, {"tail_from": 1}, {"coarse_dtype": "bfloat16"}])
def test_solve_rc_equals_the_solve_from_the_guess(mg):
    """solve_rc(p1, b, rc) after the fused twin takes the solve's own path
    from cycle 1's coarse stage on: the regular solve from the guess, bit
    for bit (the bf16 pad and cast, the tail, the post kernel)."""
    case = _port(mg_overrides=mg)
    shape, tin, _ = _inputs(11)
    solve = case.poisson_solve
    fused = TQ.QuadCorrPredictorSourceFusedPre(shape, case.coeffs, solve.pre0)
    us2, vs2, b, guess, max_b = case.step_kernels[0](*tin)
    _, _, b1, p1, rc, max_b1 = fused(*tin)
    assert torch.equal(b1, b) and torch.equal(max_b1, max_b)
    p, cycles, res = solve(guess, b, max_b)
    p_rc, cycles_rc, res_rc = solve.solve_rc(p1, b, rc, max_b)
    assert cycles_rc == cycles >= 2 and res_rc == res
    assert torch.equal(p_rc, p)


def test_solve_rc_refuses_pin_mean_and_the_aligned_solve():
    n = 32
    prob = TM.neumann_problem(n, n, 1.0 / n, 1.0 / n)
    shape, coarse = (n + 2, n + 2), TM._round_up8_128((n // 2 + 2, n // 2 + 2))
    cfg = TM.MGConfig(pre_sweeps=2, post_sweeps=1, pin_mean=True)
    l0 = (TQ.make_quad_pre_smooth_restrict(shape, prob, 1.0, 2, coarse),
          TQ.make_quad_post_prolong_smooth(shape, prob, 1.0, 1, coarse))
    z = torch.zeros(TQ.quad_shape(shape))
    rc = torch.zeros(coarse)
    with pytest.raises(ValueError, match="quad_first_rc requires quad_level0 and pin_mean"):
        TM.make_multigrid_poisson(prob, cfg, l0).solve_rc(z, z, rc)
    aligned = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1.0 / n, 1.0 / n),
                                        TM.MGConfig(pre_sweeps=2, post_sweeps=1))
    with pytest.raises(ValueError, match="quad_first_rc requires quad_level0"):
        aligned.solve_rc(z, z, rc)


@pytest.mark.parametrize("ov", [{"whole_solve": True}, {"whole_step": True}])
def test_fuse_pre_ignored_under_the_whole_solve_and_the_whole_step(ov):
    """As in the reference, fuse_pre applies to the per-kernel solve only and
    is ignored silently elsewhere."""
    jcase = jax_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad",
                     fuse_pre=True, mg_overrides=dict(ov), **KW)
    case = _port(fuse_pre=True, mg_overrides=ov)
    assert not jcase.carry_fused_pre and not case.carry_fused_pre
    assert type(case.step_kernels[0]) is TQ.QuadCorrPredictorSource
    plain = _port(mg_overrides=ov)
    s_on = s_off = Simulation(case).initial_state()
    s_on, d_on = make_step(case)(s_on)
    s_off, d_off = make_step(plain)(s_off)
    assert int(d_on.poisson_iters) == int(d_off.poisson_iters)
    assert torch.equal(s_on.p, s_off.p) and torch.equal(s_on.u, s_off.u)


@pytest.mark.parametrize("controller", ["exact", "lagged"])
def test_adaptive_builders_keep_the_plain_solve(controller):
    """adaptive_impl and adaptive_impl_carry run the plain carry and the
    three-argument solve on a fuse_pre case: the same 5 steps as without."""
    out = []
    for fuse in (True, False):
        sim = Simulation(_port(fuse_pre=fuse), log=lambda m: None)
        st, _ = run_adaptive(sim, max_courant=0.5, n_steps=N_STEPS, controller=controller,
                             log=lambda m: None)
        out.append((st, list(sim.step_iters), list(sim.step_dts)))
    (a, ia, da), (b, ib, db) = out
    assert ia == ib and da == db
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_new_kernels_are_listed_with_their_tpu_kernels():
    names = {k.name: k for k in KERNELS}
    fused = names["quad_corr_predictor_source_fused_pre"]
    assert fused is TQ.FUSED_PRE and fused.replaces == "cfd_tpu/kernels/quad.py:985"
    assert fused.source == "cfd_tpu_torch/csrc/quad_fused_pre.cu"
    split = names["quad_channel_predictor_source"]
    assert split is TQ.CHANNEL_PREDICTOR_SOURCE
    assert split.replaces == "cfd_tpu/kernels/quad.py:847"
