"""cfd_tpu_torch multigrid (separable quad path) against cfd_tpu: the
hierarchy (coarsened problems, aligned level weights with their bf16
rounding, the coarsest pinv) and whole tolerance-driven solves with the
quad level 0 (the reference's Pallas kernels in interpret mode).

Bands: equal V-cycle counts and p within 5e-5 for the float32 solve, and
for the bf16 coarse hierarchy against the reference's bf16 hierarchy; the
bf16 coarse hierarchy also within +3 cycles of float32 and at the same
tolerance (tests/test_coarse_dtype.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.kernels import quad as JQ
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.poisson import multigrid as TM

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [32, 128])
def test_coarsened_problems_match_jax(n):
    jp, tp = JM.cavity_problem(n, n, 1 / n, 1 / n), TM.cavity_problem(n, n, 1 / n, 1 / n)
    jprobs = [jp]
    while len(jprobs) < len(TM.build_problems(tp, TM.MGConfig())):
        jprobs.append(JM.coarsen_problem(jprobs[-1]))
    for a, b in zip(TM.build_problems(tp, TM.MGConfig()), jprobs, strict=True):
        assert (a.nx, a.ny, a.dx, a.dy) == (b.nx, b.ny, b.dx, b.dy)
        for w in ("wE", "wW", "wN", "wS"):
            np.testing.assert_array_equal(getattr(a, w), getattr(b, w))
    levels, pinv = JM.build_hierarchy(jp, JM.MGConfig(), jnp.float32)
    assert len(levels) == len(jprobs)
    np.testing.assert_array_equal(
        TM._dense_pinv(TM.build_problems(tp, TM.MGConfig())[-1]).astype(np.float32),
        np.asarray(pinv))


@pytest.mark.parametrize("coarse", ["float32", "bfloat16"])
def test_aligned_levels_match_jax(coarse):
    """Every level's weights equal _build_level(aligned=True), including the
    bf16 rounding of the edge-fix values (4/3 -> 1.3359375)."""
    n = 64
    tdt, jdt = ((torch.float32, jnp.float32) if coarse == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    cfg = TM.MGConfig(coarse_dtype=None if coarse == "float32" else "bfloat16")
    solve = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), cfg,
                                      _port_l0(n, cfg))
    jprobs = [JM.cavity_problem(n, n, 1 / n, 1 / n)]
    while len(jprobs) < len(solve.levels):
        jprobs.append(JM.coarsen_problem(jprobs[-1]))
    for k, (lv, jp) in enumerate(zip(solve.levels, jprobs, strict=True)):
        want = JM._build_level(jp, jnp.float32 if k == 0 else jdt, aligned=True)
        assert lv.shape == want.shape and (lv.ny, lv.nx) == (want.ny, want.nx)
        assert lv.dtype == (torch.float32 if k == 0 else tdt)
        assert (lv.idx2, lv.idy2) == (want.idx2, want.idy2)
        for w in ("wE", "wW", "wN", "wS"):
            np.testing.assert_array_equal(getattr(lv, w).float().numpy(),
                                          np.asarray(getattr(want, w)).astype(np.float32))
    if coarse == "bfloat16":
        assert float(solve.levels[1].wS[1, 0]) == 1.3359375  # bf16(4/3)
    np.testing.assert_array_equal(solve.pinv.numpy(), np.asarray(
        JM.build_hierarchy(jprobs[0], JM.MGConfig(), jnp.float32)[1]))


def _port_l0(n, cfg):
    shape = (n + 2, n + 2)
    prob = TM.cavity_problem(n, n, 1 / n, 1 / n)
    coarse = TM._round_up8_128((n // 2 + 2, n // 2 + 2))
    return (TQ.make_quad_pre_smooth_restrict(shape, prob, cfg.omega, cfg.pre_sweeps, coarse),
            TQ.make_quad_post_prolong_smooth(shape, prob, cfg.omega, cfg.post_sweeps, coarse))


def _jax_solve(n, cfg):
    shape = (n + 2, n + 2)
    prob = JM.cavity_problem(n, n, 1 / n, 1 / n)
    coarse = JM._round_up8_128((n // 2 + 2, n // 2 + 2))
    l0 = (JQ.make_quad_pre_smooth_restrict(shape, prob, cfg.omega, cfg.pre_sweeps, coarse,
                                           interpret=True),
          JQ.make_quad_post_prolong_smooth(shape, prob, cfg.omega, cfg.post_sweeps, coarse,
                                           interpret=True))
    return JM.make_multigrid_poisson(prob, cfg, jnp.float32, aligned_io=True,
                                     use_pallas=True, pallas_interpret=True,
                                     quad_level0=l0)


def _source(n, seed, scale):
    b = np.zeros((n + 2, n + 2), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(seed).standard_normal((n, n)) * scale
    return b


@pytest.mark.parametrize("case", ["noise", "zero_source", "max_cycles"])
def test_quad_solve_matches_jax(case):
    """One tolerance-driven solve: same cycle count (the reference's
    stopping rule: tolerance, max_cycles, stall), p within 5e-5."""
    n = 32
    kw = dict(tol_factor=1e-5, post_sweeps=1)
    if case == "max_cycles":
        kw["max_cycles"] = 2
    jcfg, tcfg = JM.MGConfig(**kw), TM.MGConfig(**kw)
    b = _source(n, 5, 0.0 if case == "zero_source" else 100.0)
    shape = (n + 2, n + 2)
    p0 = np.zeros_like(b)
    jp, jit, jres = _jax_solve(n, jcfg)(JQ.to_quad(jnp.asarray(p0), shape),
                                       JQ.to_quad(jnp.asarray(b), shape))
    solve = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), tcfg,
                                      _port_l0(n, tcfg))
    tp, tit, tres = solve(TQ.to_quad(torch.from_numpy(p0), shape),
                          TQ.to_quad(torch.from_numpy(b), shape))
    assert tit == int(jit)
    if case == "max_cycles":
        assert tit == 2
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=5e-5)
    # a converged residual sits at the f32 roundoff of A p (terms of size
    # 4 idx2 |p|): allow a few ulps of that on top of the kernel band
    floor = 4 * np.finfo(np.float32).eps * 4 * n * n * float(np.abs(np.asarray(jp)).max())
    assert abs(float(tres) - float(jres)) <= 1e-3 * float(jres) + floor


def test_bf16_coarse_solve_within_band():
    n = 64
    shape = (n + 2, n + 2)
    b = _source(n, 7, 100.0)
    jcfg = JM.MGConfig(tol_factor=1e-5, post_sweeps=1)
    jp, jit, _ = _jax_solve(n, jcfg)(JQ.to_quad(jnp.zeros(shape, jnp.float32), shape),
                                    JQ.to_quad(jnp.asarray(b), shape))
    tcfg = TM.MGConfig(tol_factor=1e-5, post_sweeps=1, coarse_dtype="bfloat16")
    solve = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), tcfg,
                                      _port_l0(n, tcfg))
    tp, tit, tres = solve(TQ.to_quad(torch.zeros(shape), shape),
                          TQ.to_quad(torch.from_numpy(b), shape))
    tol = 1e-5 * float(np.abs(b).max())
    assert float(tres) <= tol
    assert tit <= int(jit) + 3, (tit, int(jit))
    scale = max(1.0, float(np.abs(np.asarray(jp)).max()))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=100 * tol * scale)


def test_bf16_coarse_solve_matches_jax_bf16():
    """bf16 level weights, level 1 padded from 8- to 16-row alignment, the
    bf16 pinv product: the same cycle count as the reference's bf16
    hierarchy and p within the float32 band."""
    n = 64
    shape = (n + 2, n + 2)
    b = _source(n, 7, 100.0)
    kw = dict(tol_factor=1e-5, post_sweeps=1, coarse_dtype="bfloat16")
    jcfg, tcfg = JM.MGConfig(**kw), TM.MGConfig(**kw)
    jp, jit, _ = _jax_solve(n, jcfg)(JQ.to_quad(jnp.zeros(shape, jnp.float32), shape),
                                    JQ.to_quad(jnp.asarray(b), shape))
    solve = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), tcfg,
                                      _port_l0(n, tcfg))
    assert solve.levels[1].shape[0] % 16 == 0 != solve.pre0.coarse_shape[0] % 16
    tp, tit, _ = solve(TQ.to_quad(torch.zeros(shape), shape),
                       TQ.to_quad(torch.from_numpy(b), shape))
    assert tit == int(jit)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=5e-5)


@pytest.mark.parametrize("knob", [dict(pin_mean=True),
                                  dict(pin_mean=True, whole_solve=True,
                                       coarse_dtype="bfloat16"),
                                  dict(pin_mean=True, whole_solve=True, coarse_dtype="bf16"),
                                  dict(pin_mean=True, tail_from=1)])
def test_unported_mg_options_raise(knob):
    """pin_mean off a pure-Neumann problem raises the reference's ValueError
    (cfd_tpu/poisson/multigrid.py:669-673), alone and beside the knobs that
    are ported."""
    n = 32
    cfg = dataclasses.replace(TM.MGConfig(), **knob)
    with pytest.raises(ValueError, match="pin_mean only for pure-Neumann problems"):
        TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), cfg,
                                  _port_l0(n, cfg))


@pytest.mark.parametrize("knob", [dict(corr_opt=True)])
def test_separable_corr_opt_raises(knob):
    """The reference's ValueError (cfd_tpu/poisson/multigrid.py:664-667)."""
    n = 32
    cfg = dataclasses.replace(TM.MGConfig(), **knob)
    with pytest.raises(ValueError, match="corr_opt is a masked defect-correction knob"):
        TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), cfg,
                                  _port_l0(n, cfg))


def test_whole_step_cfg_builds_and_solves():
    """MGConfig whole_step=True (refused until the whole step was ported) is
    consumed by the case factories; the per-kernel solve built from it
    solves as the one without it, bit for bit with equal cycles."""
    n = 32
    shape = (n + 2, n + 2)
    b = np.zeros(shape, np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(7).standard_normal((n, n)).astype(np.float32)
    b4 = TQ.to_quad(torch.from_numpy(b), shape)
    out = []
    for ws in (False, True):
        cfg = TM.MGConfig(tol_factor=1e-5, whole_step=ws)
        solve = TM.make_multigrid_poisson(TM.cavity_problem(n, n, 1 / n, 1 / n), cfg,
                                          _port_l0(n, cfg))
        out.append(solve(torch.zeros_like(b4), b4))
    (p0, c0, r0), (p1, c1, r1) = out
    assert c0 == c1 and r0 == r1 and torch.equal(p0, p1)


def test_auto_bf16_rule_matches_jax():
    """The port's rule is the reference's with "device is cuda" for
    "platform is tpu" (interpret mode there = the CPU here)."""
    cases = [(None, TM.MGConfig()), ({"pre_sweeps": 2}, TM.MGConfig()),
             ({"whole_solve": False}, TM.MGConfig()),
             ({"coarse_dtype": "bfloat16"}, TM.MGConfig()),
             (None, TM.MGConfig(tail_from=1)), (None, TM.MGConfig(whole_step=True))]
    for ov, cfg in cases:
        for on_device in (True, False):
            for explicit in (True, False):
                jcfg = JM.MGConfig(**dataclasses.asdict(cfg))
                assert TM.auto_bf16_coarse(on_device, explicit, cfg, ov) == \
                    JM.auto_bf16_coarse(not on_device, explicit, jcfg, ov)
    assert TM.normalize_coarse_dtype_optout({"coarse_dtype": "f32", "a": 1}) == \
        JM.normalize_coarse_dtype_optout({"coarse_dtype": "f32", "a": 1})
