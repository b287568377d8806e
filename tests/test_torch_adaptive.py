"""The adaptive-stepping kernel instances of cfd_tpu_torch against cfd_tpu's
Pallas kernels in interpret mode (tile_rows=8, the slab path): the traced-dt
non-carry cavity stage (make_quad_predictor_source), the traced-dt
correctors of the cavity, the channel, the step and RB, and their
traced-dt + Courant carries, at small shapes with dt_corr = 0.8 dt and
dt_pred = 1.1 dt, so an instance that ignored the traced dt would fail.
Also the uncorrect_*(dt=) inverses against the reference's and the
adaptive builders' aligned/logical round trips at dt != coeffs.dt.

Bands (tests/test_quad.py, ROADMAP.md section C): velocities, T and the
guess 2e-6; b within 1e-5 of max|b|; max|b| within 1e-5 relative; the source
sum within 1e-6 of sum|b|; the Courant maxima max|u|, max|v| within 1e-6
relative. The CUDA kernels run only on a card (tests/test_torch_adaptive_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.kernels import quad as JQ
from cfd_tpu.kernels import rb_quad as JR
from cfd_tpu.kernels import step_quad as JS
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                 make_channel_case, make_rayleigh_benard_case)
from cfd_tpu_torch.kernels import KERNELS
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.physics.boussinesq import RBParams
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

N = 32
CAVITY_SHAPE = (N + 2, N + 2)
CAVITY = dict(dx=1.0 / N, dy=1.0 / N, dt=0.25 / N, viscosity=1e-3, density=1.3)
NX, NY = 64, 16
SHAPE = (NY + 2, NX + 2)
COEFFS = dict(dx=0.125, dy=0.125, dt=0.01, viscosity=0.02, density=1.3)
STEP_I, INLET_J = 16, 8
KAPPA = 1.2e-2
PARAMS = RBParams(1e5, 0.71)
DT_CORR, DT_PRED = 0.8, 1.1  # times coeffs.dt

# kind -> (shape, coeffs, fields, number of dts, reference factory, port factory)
KINDS = {
    "predictor_source": (CAVITY_SHAPE, CAVITY, ("u", "v"), 1,
                         lambda c: JQ.make_quad_predictor_source(
                             CAVITY_SHAPE, c, 0.9, tile_rows=8, interpret=True,
                             traced_dt=True),
                         lambda c: TQ.make_quad_predictor_source(CAVITY_SHAPE, c, 0.9)),
    "corrector": (CAVITY_SHAPE, CAVITY, ("us", "vs", "p", "p_prev"), 1,
                  lambda c: JQ.make_quad_corrector(CAVITY_SHAPE, c, 0.9, tile_rows=8,
                                                   interpret=True, traced_dt=True),
                  lambda c: TQ.make_quad_corrector(CAVITY_SHAPE, c, 0.9, traced_dt=True)),
    "carry": (CAVITY_SHAPE, CAVITY, ("us", "vs", "p", "p_prev"), 2,
              lambda c: JQ.make_quad_corr_predictor_source(
                  CAVITY_SHAPE, c, 0.9, tile_rows=8, interpret=True, traced_dt=True,
                  emit_courant=True),
              lambda c: TQ.make_quad_corr_predictor_source(CAVITY_SHAPE, c, 0.9,
                                                           adaptive=True)),
    "channel_corrector": (SHAPE, COEFFS, ("us", "vs", "p", "p_prev"), 1,
                          lambda c: JQ.make_quad_channel_corrector(
                              SHAPE, c, 0.7, tile_rows=8, interpret=True, traced_dt=True),
                          lambda c: TQ.make_quad_channel_corrector(SHAPE, c, 0.7,
                                                                   traced_dt=True)),
    "channel_carry": (SHAPE, COEFFS, ("us", "vs", "p", "p_prev"), 2,
                      lambda c: JQ.make_quad_channel_corr_predictor_source(
                          SHAPE, c, 0.7, tile_rows=8, interpret=True, traced_dt=True,
                          emit_courant=True),
                      lambda c: TQ.make_quad_channel_corr_predictor_source(
                          SHAPE, c, 0.7, adaptive=True)),
    "step_corrector": (SHAPE, COEFFS, ("us", "vs", "p"), 1,
                       lambda c: JS.make_quad_step_corrector(
                           SHAPE, c, STEP_I, INLET_J, 0.7, tile_rows=8, interpret=True,
                           traced_dt=True),
                       lambda c: TS.make_quad_step_corrector(SHAPE, c, STEP_I, INLET_J, 0.7,
                                                             traced_dt=True)),
    "step_carry": (SHAPE, COEFFS, ("us", "vs", "p"), 2,
                   lambda c: JS.make_quad_step_corr_predictor_source(
                       SHAPE, c, STEP_I, INLET_J, 0.7, tile_rows=8, interpret=True,
                       traced_dt=True, emit_courant=True),
                   lambda c: TS.make_quad_step_corr_predictor_source(
                       SHAPE, c, STEP_I, INLET_J, 0.7, adaptive=True)),
    "rb_corrector": (SHAPE, COEFFS, ("us", "vs", "p"), 1,
                     lambda c: JR.make_quad_rb_corrector(SHAPE, c, tile_rows=8,
                                                         interpret=True, traced_dt=True),
                     lambda c: TR.make_quad_rb_corrector(SHAPE, c, traced_dt=True)),
    "rb_carry": (SHAPE, COEFFS, ("us", "vs", "p", "T"), 2,
                 lambda c: JR.make_quad_rb_step_kernel(
                     SHAPE, c, KAPPA, PARAMS.t_bottom, PARAMS.t_top, tile_rows=8,
                     interpret=True, traced_dt=True, emit_courant=True),
                 lambda c: TR.make_quad_rb_step_kernel(SHAPE, c, KAPPA, PARAMS,
                                                       adaptive=True)),
}

# output names per kind (the reference's order)
OUTPUTS = {
    "predictor_source": ("us", "vs", "b", "max_b"),
    "corrector": ("u", "v", "guess"),
    "carry": ("us", "vs", "b", "guess", "max_b", "max_u", "max_v"),
    "channel_corrector": ("u", "v", "guess"),
    "channel_carry": ("us", "vs", "b", "guess", "sum_b", "max_u", "max_v"),
    "step_corrector": ("u", "v"),
    "step_carry": ("us", "vs", "b", "sum_b", "max_u", "max_v"),
    "rb_corrector": ("u", "v"),
    "rb_carry": ("us", "vs", "T", "b", "sum_b", "max_u", "max_v"),
}


def _inputs(kind, seed):
    """(port quad tensors, reference quad arrays) of seeded natural fields;
    p and p_prev on the interior, T with the conductive profile."""
    shape, _, names, _, _, _ = KINDS[kind]
    rng = np.random.default_rng(seed)
    tin, jin = [], []
    for name in names:
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if name == "T":
            a += np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
        if name in ("p", "p_prev"):
            a *= 10.0
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        tin.append(TQ.to_quad(torch.from_numpy(a), shape))
        jin.append(JQ.to_quad(jnp.asarray(a), shape))
    return tin, jin


def _dts(kind, scale=(DT_CORR, DT_PRED)):
    """(port dt tensor, reference scalars): a 0-d dt (dt_corr's scale) or the
    carries' (dt_corr, dt_pred) pair."""
    dt = KINDS[kind][1]["dt"]
    vals = [np.float32(s * dt) for s in scale[: KINDS[kind][3]]]
    if len(vals) == 1:
        return torch.tensor(vals[0]), vals[0]
    return torch.tensor(vals), tuple(vals)


def _ops(kind):
    _, coeffs, _, _, jmake, tmake = KINDS[kind]
    return jmake(JCoeffs(**coeffs)), tmake(TCoeffs(**coeffs))


@pytest.mark.parametrize("kind", list(KINDS))
def test_traced_instance_plain_matches_jax(kind):
    jop, top = _ops(kind)
    tin, jin = _inputs(kind, 100 + len(kind))
    tdt, jdt = _dts(kind)
    got, want = top.plain(tdt, *tin), jop(jdt, *jin)
    names = OUTPUTS[kind]
    assert len(got) == len(want) == len(names)
    b = np.asarray(want[names.index("b")]) if "b" in names else None
    for name, g, w in zip(names, got, want, strict=True):
        w = np.asarray(w)
        if name == "b":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
        elif name == "max_b":
            assert abs(float(g) - float(w)) <= 1e-5 * float(w), (float(g), float(w))
        elif name == "sum_b":
            assert abs(float(g) - float(w)) <= 1e-6 * np.abs(b).sum(), (float(g), float(w))
        elif name in ("max_u", "max_v"):
            assert float(w) > 0
            assert abs(float(g) - float(w)) <= 1e-6 * float(w), (name, float(g), float(w))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
def test_traced_dt_reaches_every_output_that_depends_on_it(kind):
    """The same instance at dt = coeffs.dt differs where dt enters: the
    corrected fields (dt_corr), the tentative fields and b (dt_pred), RB's T'
    (dt_corr), so an instance that ignored the traced value would fail the
    JAX comparison. (The guess does not depend on dt; the Courant maxima may
    sit on a boundary value, the channel's inlet.)"""
    _, top = _ops(kind)
    tin, _ = _inputs(kind, 200 + len(kind))
    got = top.plain(_dts(kind)[0], *tin)
    fixed = top.plain(_dts(kind, (1.0, 1.0))[0], *tin)
    for name, a, b in zip(OUTPUTS[kind], got, fixed, strict=True):
        if name not in ("guess", "max_u", "max_v"):
            assert float((a - b).abs().max()) > 1e-5 * float(b.abs().max()), name


@pytest.mark.parametrize("kind", list(KINDS))
def test_cpu_dispatch_runs_plain_and_counts_no_launch(kind):
    _, top = _ops(kind)
    tin, _ = _inputs(kind, 300)
    tdt, _ = _dts(kind)
    before = [k.launches for k in KERNELS]
    for a, b in zip(top(tdt, *tin), top.plain(tdt, *tin), strict=True):
        assert torch.equal(a, b)
    assert before == [k.launches for k in KERNELS]
    wrong = torch.tensor(1e-3) if tdt.dim() else torch.tensor([1e-3, 1e-3])
    with pytest.raises(ValueError, match="shape"):
        top(wrong, *tin)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        top(tdt.to("meta"), *tin)


def test_new_instances_are_listed_with_their_tpu_kernels():
    names = {k.name: k.replaces for k in KERNELS}
    assert names["quad_predictor_source"] == "cfd_tpu/kernels/quad.py:438"
    for name, replaces in (("quad_corrector_traced", "quad.py:488"),
                           ("quad_corr_predictor_source_adaptive", "quad.py:938"),
                           ("quad_channel_corrector_traced", "quad.py:892"),
                           ("quad_channel_corr_predictor_source_adaptive", "quad.py:1126"),
                           ("quad_step_corrector_traced", "step_quad.py:204"),
                           ("quad_step_corr_predictor_source_adaptive", "step_quad.py:100"),
                           ("quad_rb_corrector_traced", "rb_quad.py:225"),
                           ("quad_rb_step_adaptive", "rb_quad.py:81")):
        assert names[name] == f"cfd_tpu/kernels/{replaces}"
    for name, replaces in (("quad_corr_predictor_source_shard_adaptive", "quad.py:938"),
                           ("quad_channel_corr_predictor_source_shard_adaptive",
                            "quad.py:1126"),
                           ("quad_rb_step_shard_adaptive", "rb_quad.py:81"),
                           ("quad_step_corr_predictor_source_shard_adaptive",
                            "step_quad.py:100")):
        assert names[name] == f"cfd_tpu/kernels/{replaces} (shard=, traced_dt)"
    assert len(names) == len(KERNELS) == 62


# ------------------------------------------------------------ uncorrect(dt=)

def _natural_uvp(shape, seed):
    rng = np.random.default_rng(seed)
    u, v, p = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    p[0, :] = p[-1, :] = p[:, 0] = p[:, -1] = 0.0
    return u, v, p


@pytest.mark.parametrize("form", ["cavity", "channel", "step", "rb"])
def test_uncorrect_with_dt_matches_jax(form):
    shape = CAVITY_SHAPE if form == "cavity" else SHAPE
    coeffs = CAVITY if form == "cavity" else COEFFS
    tc, jc = TCoeffs(**coeffs), JCoeffs(**coeffs)
    u, v, p = _natural_uvp(shape, 400)
    tu = [torch.from_numpy(a) for a in (u, v, p)]
    ju = [jnp.asarray(a) for a in (u, v, p)]
    dt = 0.7 * coeffs["dt"]
    if form in ("cavity", "channel"):
        cav = form == "cavity"
        got = TQ.uncorrect_quad(*tu, shape, tc, cavity_form=cav, dt=dt)
        want = JQ.uncorrect_quad(*ju, shape, jc, cavity_form=cav, dt=dt)
        fixed = TQ.uncorrect_quad(*tu, shape, tc, cavity_form=cav)
    elif form == "step":
        got = TS.uncorrect_step_quad(*tu, shape, tc, STEP_I, INLET_J, dt=dt)
        want = JS.uncorrect_step_quad(*ju, shape, jc, STEP_I, INLET_J, dt=dt)
        fixed = TS.uncorrect_step_quad(*tu, shape, tc, STEP_I, INLET_J)
    else:
        got = TR.uncorrect_rb_quad(*tu, shape, tc, dt=dt)
        want = JR.uncorrect_rb_quad(*ju, shape, jc, dt=dt)
        fixed = TR.uncorrect_rb_quad(*tu, shape, tc)
    for a, b, f in zip(got, want, fixed, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not torch.equal(a, f)


def _logical_after_fixed_steps(case):
    sim = Simulation(case, log=lambda m: None)
    st = sim.initial_state()
    for _ in range(3):
        st, _ = sim._step(st)
    return sim._logical(st)


CASES = {
    "cavity": lambda: make_cavity_case(n_interior=N, poisson="multigrid", dtype=torch.float32,
                                       tolerance_factor=1e-5, device="cpu"),
    "channel": lambda: make_channel_case(nx=NX, ny=2 * NY, poisson="multigrid",
                                         dtype=torch.float32, tolerance_factor=1e-4,
                                         device="cpu"),
    "step": lambda: make_backwards_step_case(nx=NX, ny=NY, poisson="multigrid",
                                             dtype=torch.float32, tolerance_factor=1e-4,
                                             device="cpu"),
    "rb": lambda: make_rayleigh_benard_case(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5,
                                            abs_tol=1e-7, device="cpu"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lagged_boundary_round_trip_at_a_traced_dt(name):
    """to_aligned(state, dt) uncorrects with dt and to_logical(aligned, dt)
    re-corrects with the same dt through the traced corrector: the logical
    state comes back within one float32 rounding at dt != coeffs.dt, and a
    re-correction with coeffs.dt does not."""
    case = CASES[name]()
    st = _logical_after_fixed_steps(case)
    _, to_aligned, to_logical = case.adaptive_impl_carry()
    dt = 0.6 * case.dt
    aligned = to_aligned(st, dt)
    back = to_logical(aligned, TQ.scalar_like(dt, aligned.u))
    for field in ("u", "v", "p", "T", "p_prev"):
        a, b = getattr(st, field), getattr(back, field)
        if a is None:
            assert b is None, field
            continue
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-6 * scale, field
    wrong = to_logical(aligned, TQ.scalar_like(case.dt, aligned.u))
    assert float((wrong.u - st.u).abs().max()) > 1e-5 * float(st.u.abs().max())


def test_exact_boundary_round_trip():
    """The cavity's exact-controller boundary: the carried p_prev slot holds
    the guess 2p - p_prev, and to_logical inverts it within one rounding."""
    case = CASES["cavity"]()
    st = _logical_after_fixed_steps(case)
    _, to_aligned, to_logical = case.adaptive_impl()
    aligned = to_aligned(st)
    assert torch.equal(TQ.from_quad(aligned.p_prev, case.grid.shape), 2.0 * st.p - st.p_prev)
    back = to_logical(aligned)
    for field in ("u", "v", "p", "p_prev"):
        a, b = getattr(st, field), getattr(back, field)
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(a.abs().max())), field
