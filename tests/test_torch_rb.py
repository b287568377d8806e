"""The Rayleigh-Benard ops, stage kernels and pin-mean solves of
cfd_tpu_torch against cfd_tpu on the CPU.

- float64 ops to 1e-12: the box no-slip and temperature ghosts, the scalar
  advection-diffusion, the Nusselt diagnostics and the streamfunction;
- the numpy threefry against jax.random.uniform, bit for bit;
- the plain twins of the RB carry (both variants) and corrector against
  cfd_tpu's Pallas kernels in interpret mode at 48x16 (tile_rows=8, so the
  reference runs its slab path), with the bands of tests/test_quad.py:
  velocities and T 2e-6, b 1e-5 of max|b|, the source sum 1e-5 of sum|b|
  (the two packages add in other orders), the guess exact;
- the pin-mean solves at 64x32 on the pure-Neumann operator: the port's
  per-kernel solve against the reference's per-kernel quad solve (equal
  cycles, p within 2e-6 of its scale), and the port's whole-solve twin
  against the port's per-kernel solve (bit for bit).
The CUDA kernels are held to these twins on the card by
tests/test_torch_rb_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.grid import Grid as JGrid
from cfd_tpu.kernels import quad as JQ
from cfd_tpu.kernels import rb_quad as JR
from cfd_tpu.kernels import whole_solve as JW
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu.physics import boussinesq as JB
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu.state import State as JState
from cfd_tpu_torch.grid import Grid as TGrid
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.ops.random import uniform
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.physics import boussinesq as TB
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.state import State as TState

torch.set_num_threads(1)

NX, NY = 48, 16
SHAPE = (NY + 2, NX + 2)
COEFFS = dict(dx=3.0 / NX, dy=1.0 / NY, dt=2.5e-2, viscosity=8e-3)
KAPPA = 1.2e-2
PARAMS = TB.RBParams(1e5, 0.71)  # walls at 1 and 0, the reference's defaults


def _grids():
    return TGrid.regular(NX, NY, 3.0, 1.0), JGrid.regular(NX, NY, 3.0, 1.0)


def _f64(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE) for _ in range(n)]


def _close64(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_box_noslip_bc_matches_jax():
    tg, jg = _grids()
    u, v = _f64(1, 2)
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    got = TB.box_noslip_bc(tg)(ut, vt)
    want = JB.box_noslip_bc(jg)(jnp.asarray(u), jnp.asarray(v))
    for a, b in zip(got, want, strict=True):
        _close64(a, b)
    np.testing.assert_array_equal(ut.numpy(), u)  # inputs untouched


@pytest.mark.parametrize("walls", [(1.0, 0.0), (0.3, -0.7)])
def test_temperature_bc_matches_jax(walls):
    tg, jg = _grids()
    (T,) = _f64(2, 1)
    _close64(TB.temperature_bc(tg, *walls)(torch.from_numpy(T)),
             JB.temperature_bc(jg, *walls)(jnp.asarray(T)))


def test_advect_diffuse_scalar_matches_jax():
    tg, jg = _grids()
    T, u, v = _f64(3, 3)
    got = TB.advect_diffuse_scalar(torch.from_numpy(T), torch.from_numpy(u),
                                   torch.from_numpy(v), TCoeffs(**COEFFS), KAPPA,
                                   torch.from_numpy(tg.cell_mask))
    want = JB.advect_diffuse_scalar(jnp.asarray(T), jnp.asarray(u), jnp.asarray(v),
                                    JCoeffs(**COEFFS), KAPPA, jnp.asarray(jg.cell_mask))
    _close64(got, want)


def test_nusselt_numbers_and_streamfunction_match_jax():
    tg, jg = _grids()
    u, v, p, T = _f64(4, 4)
    params_t, params_j = TB.RBParams(1e5, 0.71), JB.RBParams(1e5, 0.71)
    got = TB.nusselt_numbers(TState(*(torch.from_numpy(a) for a in (u, v, p, T))), tg,
                             params_t, kappa=KAPPA)
    want = JB.nusselt_numbers(JState(*(jnp.asarray(a) for a in (u, v, p, T))), jg,
                              params_j, kappa=KAPPA)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=0, abs=1e-12), k
    _close64(TB.streamfunction(torch.from_numpy(u), tg),
             JB.streamfunction(jnp.asarray(u), jg))


@pytest.mark.parametrize("seed,shape", [(0, (18, 50)), (3, (514, 1538)), (12345, (7, 3, 5))])
def test_uniform_is_jax_random_uniform_bit_for_bit(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         dtype=jnp.float32, minval=-1.0, maxval=1.0))
    got = uniform(seed, shape, -1.0, 1.0)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _stage_inputs(seed):
    """(us, vs, p, T, p_prev) in f32: p and p_prev on the interior, T a
    conductive profile plus noise."""
    rng = np.random.default_rng(seed)
    arrays = []
    for k in range(5):
        a = (rng.standard_normal(SHAPE) * 0.1).astype(np.float32)
        if k == 3:
            a = a + np.linspace(1.0, 0.0, SHAPE[0], dtype=np.float32)[:, None]
        if k in (2, 4):
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        arrays.append(a)
    return ([TQ.to_quad(torch.from_numpy(a), SHAPE) for a in arrays],
            [JQ.to_quad(jnp.asarray(a), SHAPE) for a in arrays])


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("emit_guess", [False, True])
def test_rb_carry_plain_matches_jax(emit_guess):
    tin, jin = _stage_inputs(21)
    n = 5 if emit_guess else 4
    got = TR.make_quad_rb_step_kernel(SHAPE, TCoeffs(**COEFFS), KAPPA, PARAMS,
                                      emit_guess=emit_guess).plain(*tin[:n])
    want = JR.make_quad_rb_step_kernel(SHAPE, JCoeffs(**COEFFS), KAPPA, tile_rows=8,
                                       interpret=True, emit_guess=emit_guess)(*jin[:n])
    assert len(got) == len(want) == n + 1
    for k in range(3):  # us', vs', T'
        _close(got[k], want[k], 2e-6)
    b = np.asarray(want[3])
    _close(got[3], want[3], 1e-5 * np.abs(b).max())
    if emit_guess:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert abs(float(got[-1]) - float(want[-1])) <= 1e-5 * np.abs(b).sum()


def test_rb_corrector_plain_matches_jax():
    tin, jin = _stage_inputs(22)
    got = TR.make_quad_rb_corrector(SHAPE, TCoeffs(**COEFFS)).plain(*tin[:3])
    want = JR.make_quad_rb_corrector(SHAPE, JCoeffs(**COEFFS), tile_rows=8,
                                     interpret=True)(*jin[:3])
    for a, b in zip(got, want, strict=True):
        _close(a, b, 2e-6)


def test_uncorrect_rb_matches_jax_and_inverts_the_corrector():
    rng = np.random.default_rng(23)
    u, v, p = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3))
    p[0, :] = p[-1, :] = p[:, 0] = p[:, -1] = 0.0
    tc = TCoeffs(**COEFFS)
    got = TR.uncorrect_rb_quad(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(p),
                               SHAPE, tc)
    want = JR.uncorrect_rb_quad(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), SHAPE,
                                JCoeffs(**COEFFS))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # on a state whose ghosts are set (twice: the corner ghosts read the side
    # columns before they are zeroed) the corrector undoes it up to one rounding
    tg, _ = _grids()
    bc = TB.box_noslip_bc(tg)
    u0, v0 = bc(*bc(torch.from_numpy(u), torch.from_numpy(v)))
    us, vs = TR.uncorrect_rb_quad(u0, v0, torch.from_numpy(p), SHAPE, tc)
    q = lambda a: TQ.to_quad(a, SHAPE)
    u2, v2 = TR.make_quad_rb_corrector(SHAPE, tc)(q(us), q(vs), q(torch.from_numpy(p)))
    _close(TQ.from_quad(u2, SHAPE), u0.numpy(), 1e-5)
    _close(TQ.from_quad(v2, SHAPE), v0.numpy(), 1e-5)


def test_rb_ghost_order_at_the_corners():
    """u's corner ghosts are minus the side-column values read BEFORE the
    side columns are zeroed, v's ghost columns read the wall rows before
    they are zeroed, and the T corners keep the pre-step value."""
    tin, _ = _stage_inputs(24)
    c = TCoeffs(**COEFFS)
    us, vs, p, T = (TQ.from_quad(a, SHAPE) for a in tin[:4])
    u2, v2 = (TQ.from_quad(a, SHAPE) for a in TR.make_quad_rb_corrector(SHAPE, c).plain(*tin[:3]))
    # the side columns and the wall rows are invalid faces: they keep us/vs
    for j, jw in ((0, 1), (NY + 1, NY)):
        for i in (0, NX):
            assert float(u2[j, i]) == -float(us[jw, i])
            assert float(u2[jw, i]) == 0.0
    for i, iw in ((0, 1), (NX + 1, NX)):
        for j in (0, NY):
            assert float(v2[j, i]) == -float(vs[j, iw])
            assert float(v2[j, iw]) == 0.0
    out = TR.make_quad_rb_step_kernel(SHAPE, c, KAPPA, PARAMS).plain(*tin[:4])
    T2 = TQ.from_quad(out[2], SHAPE)
    for j, i in ((0, 0), (0, NX + 1), (NY + 1, 0), (NY + 1, NX + 1)):
        assert float(T2[j, i]) == float(T[j, i])
    assert torch.equal(T2[1 : NY + 1, 0], T2[1 : NY + 1, 1])
    assert torch.equal(T2[0, 1 : NX + 1], 2.0 - T2[1, 1 : NX + 1])
    assert torch.equal(T2[NY + 1, 1 : NX + 1], -T2[NY, 1 : NX + 1])
    us2 = TQ.from_quad(out[0], SHAPE)
    assert float(us2[1 : NY + 1, 0].abs().max()) == float(us2[1 : NY + 1, NX].abs().max()) == 0


@pytest.mark.parametrize("name", ["carry", "corrector"])
def test_cpu_dispatch_runs_plain_and_counts_no_launch(name):
    tin, _ = _stage_inputs(25)
    c = TCoeffs(**COEFFS)
    op, args = ((TR.make_quad_rb_step_kernel(SHAPE, c, KAPPA, PARAMS, emit_guess=True), tin)
                if name == "carry" else (TR.make_quad_rb_corrector(SHAPE, c), tin[:3]))
    before = (TR.RB_CARRY.launches, TR.RB_CORRECTOR.launches)
    for a, b in zip(op(*args), op.plain(*args), strict=True):
        assert torch.equal(a, b)
    assert before == (TR.RB_CARRY.launches, TR.RB_CORRECTOR.launches)
    with pytest.raises(ValueError, match="p_prev"):
        TR.make_quad_rb_step_kernel(SHAPE, c, KAPPA, PARAMS)(*tin)


# ------------------------------------------------------------ pin-mean solves

SX, SY = 64, 32
SSHAPE = (SY + 2, SX + 2)
SCOARSE = (24, 128)


def _neumann_source(seed):
    b = np.zeros(SSHAPE, np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(seed).standard_normal((SY, SX))
    b[1:-1, 1:-1] -= b[1:-1, 1:-1].mean()
    return b


def _port_per_kernel(cfg):
    prob = TM.neumann_problem(SX, SY, 3.0 / SX, 1.0 / SY)
    l0 = (TQ.make_quad_pre_smooth_restrict(SSHAPE, prob, cfg.omega, cfg.pre_sweeps, SCOARSE),
          TQ.make_quad_post_prolong_smooth(SSHAPE, prob, cfg.omega, cfg.post_sweeps, SCOARSE))
    return TM.make_multigrid_poisson(prob, cfg, l0)


def _port_whole(cfg):
    """The port's whole-solve as RB builds it: pin_mean is its argument, as
    in the reference (cfg.pin_mean is not read)."""
    return TW.make_quad_whole_solve(SSHAPE, TM.neumann_problem(SX, SY, 3.0 / SX, 1.0 / SY),
                                    cfg, pin_mean=True)


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
def test_pin_mean_solve_matches_jax(tol):
    kw = dict(pre_sweeps=2, post_sweeps=1, tol_factor=tol, abs_tol=1e-7, pin_mean=True)
    jprob = JM.neumann_problem(SX, SY, 3.0 / SX, 1.0 / SY)
    jl0 = (JQ.make_quad_pre_smooth_restrict(SSHAPE, jprob, 1.0, 2, SCOARSE, interpret=True),
           JQ.make_quad_post_prolong_smooth(SSHAPE, jprob, 1.0, 1, SCOARSE, interpret=True))
    jsolve = JM.make_multigrid_poisson(jprob, JM.MGConfig(**kw), dtype=jnp.float32,
                                       aligned_io=True, use_pallas=True,
                                       pallas_interpret=True, quad_level0=jl0,
                                       n_interior=SX * SY)
    b = _neumann_source(31)
    p0 = _neumann_source(32) * np.float32(1e-3)
    jp, jit, _ = jsolve(JQ.to_quad(jnp.asarray(p0), SSHAPE), JQ.to_quad(jnp.asarray(b), SSHAPE))
    tq = lambda a: TQ.to_quad(torch.from_numpy(a), SSHAPE)
    tp, tit, _ = _port_per_kernel(TM.MGConfig(**kw))(tq(p0), tq(b))
    assert tit == int(jit) and tit > 1
    want = np.asarray(jp)
    np.testing.assert_allclose(tp.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    cell = TQ.quad_cell_mask(SSHAPE, "cpu")
    assert abs(float(tp[cell].double().mean())) < 1e-6 * float(tp.abs().max())


@pytest.mark.parametrize("kw", [dict(pre_sweeps=2, post_sweeps=1, tol_factor=1e-5),
                                dict(pre_sweeps=1, post_sweeps=2, tol_factor=1e-7,
                                     abs_tol=1e-10, max_cycles=4)])
def test_pin_mean_whole_solve_twin_equals_per_kernel(kw):
    cfg = TM.MGConfig(pin_mean=True, **kw)
    b = TQ.to_quad(torch.from_numpy(_neumann_source(33)), SSHAPE)
    p0 = TQ.to_quad(torch.from_numpy(_neumann_source(34) * np.float32(1e-3)), SSHAPE)
    whole = _port_whole(cfg)
    before = (TW.WHOLE_SOLVE.launches, TW.WHOLE_SOLVE_PIN_MEAN.launches)
    got, want = whole(p0, b), _port_per_kernel(cfg)(p0, b)
    assert before == (TW.WHOLE_SOLVE.launches, TW.WHOLE_SOLVE_PIN_MEAN.launches)
    assert got[1] == want[1] and got[2] == want[2]
    assert torch.equal(got[0], want[0])
    assert whole.partials.numel() == -(-b.numel() // TQ.SUM_BLOCK)
    if "max_cycles" in kw:
        assert got[1] == 4


def _jax_whole_solve(cfg):
    """cfd_tpu's whole-solve in interpret mode; pin_mean is its argument there."""
    kw = {k: v for k, v in cfg.items() if k != "pin_mean"}
    return JW.make_quad_whole_solve(SSHAPE, JM.neumann_problem(SX, SY, 3.0 / SX, 1.0 / SY),
                                    JM.MGConfig(**kw), pin_mean=True, n_interior=SX * SY,
                                    interpret=True)


def test_pin_mean_whole_solve_matches_jax_whole_solve():
    cfg = dict(pre_sweeps=2, post_sweeps=1, tol_factor=1e-4, pin_mean=True)
    b = _neumann_source(35)
    jsolve = _jax_whole_solve(cfg)
    jb = JQ.to_quad(jnp.asarray(b), SSHAPE)
    jp, jit, _ = jsolve(jnp.zeros_like(jb), jb)
    tb = TQ.to_quad(torch.from_numpy(b), SSHAPE)
    tp, tit, _ = _port_whole(TM.MGConfig(**cfg))(torch.zeros_like(tb), tb)
    assert abs(tit - int(jit)) <= 1, (tit, int(jit))
    want = np.asarray(jp)
    np.testing.assert_allclose(tp.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("flavor", ["channel_problem", "cavity_problem"])
def test_pin_mean_needs_a_pure_neumann_problem(flavor):
    """The fused residual stays valid after the shift only when the constant
    is the nullspace; elsewhere the quad solve raises the reference's
    ValueError (cfd_tpu/poisson/multigrid.py:669-673)."""
    prob = getattr(TM, flavor)(SX, SY, 3.0 / SX, 1.0 / SY)
    assert not TM.is_pure_neumann(prob)
    assert TM.is_pure_neumann(TM.neumann_problem(SX, SY, 3.0 / SX, 1.0 / SY))
    cfg = dataclasses.replace(TM.MGConfig(), pin_mean=True)
    l0 = (TQ.make_quad_pre_smooth_restrict(SSHAPE, prob, 1.0, 2, SCOARSE),
          TQ.make_quad_post_prolong_smooth(SSHAPE, prob, 1.0, 2, SCOARSE))
    with pytest.raises(ValueError, match="pin_mean only for pure-Neumann problems"):
        TM.make_multigrid_poisson(prob, cfg, l0)
