"""cfd_tpu_torch foundation modules against cfd_tpu at float64: grid, BCs,
stencil ops, statistics, parameter checks, and the no-jax import guard.

Same seeded numpy inputs through both packages; f64 results must agree to
1e-12 (grid quantities exactly)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu_torch.bc as TB
import cfd_tpu_torch.grid as TG
import cfd_tpu_torch.ops.reductions as TR
import cfd_tpu_torch.ops.stencil as TS
from cfd_tpu import bc as JB
from cfd_tpu import grid as JG
from cfd_tpu.ops import reductions as JR
from cfd_tpu.ops import stencil as JS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F64 = 1e-12


def _fields(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) * 0.3 for _ in range(n)]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _j(a):
    return jnp.asarray(a, jnp.float64)


def _close(got, want, atol=F64):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("nx,ny,lx,ly", [(63, 63, 1.0, 1.0), (32, 16, 2.0, 1.0),
                                         (2048, 2048, 1.0, 1.0), (93, 31, 3.0, 1.0)])
def test_grid_matches_jax(nx, ny, lx, ly):
    a, b = TG.Grid.regular(nx, ny, lx, ly), JG.Grid.regular(nx, ny, lx, ly)
    assert (a.shape, a.dx, a.dy, a.n_fluid) == (b.shape, b.dx, b.dy, b.n_fluid)
    for m in ("cell_mask", "u_range_mask", "v_range_mask", "u_valid_mask",
              "v_valid_mask"):
        np.testing.assert_array_equal(getattr(a, m), getattr(b, m), err_msg=m)
    # dt and omega bit-identical: total_steps = int(final_time / dt)
    assert TG.cfl_time_step(a.dx, a.dy, 1e-3, 1.0, 0.5) == \
        JG.cfl_time_step(b.dx, b.dy, 1e-3, 1.0, 0.5)
    assert TG.optimal_omega(nx) == JG.optimal_omega(nx)
    assert TG.optimal_omega(nx, ny) == JG.optimal_omega(nx, ny)


@pytest.mark.parametrize("n", [8, 33])
def test_iota_masks_match_jax(n):
    g = JG.Grid.regular(n, n)
    for got, want in zip(TS.iota_masks(TG.Grid.regular(n, n)), JS.iota_masks(g)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lid", [1.0, -0.5])
def test_lid_cavity_bc_matches_jax(lid):
    g = TG.Grid.regular(24, 24)
    u, v, _ = _fields(g.shape, 1)
    ut, vt = _t(u), _t(v)
    got = TB.lid_cavity_bc(g, lid)(ut, vt)
    want = JB.lid_cavity_bc(JG.Grid.regular(24, 24), lid)(_j(u), _j(v))
    for a, b in zip(got, want):
        _close(a, b)
    np.testing.assert_array_equal(ut.numpy(), u)  # inputs untouched


def _coeffs(pkg, g):
    return pkg.StencilCoeffs(dx=g.dx, dy=g.dy, dt=1.3e-3, viscosity=2e-3, density=1.1)


@pytest.mark.parametrize("op", ["predictor", "divergence", "source", "source_mean",
                                "correction", "correction_cavity", "centers"])
def test_stencil_op_matches_jax(op):
    nx, ny = 20, 12
    tg, jg = TG.Grid.regular(nx, ny, 2.0, 1.0), JG.Grid.regular(nx, ny, 2.0, 1.0)
    tc, jc = _coeffs(TS, tg), _coeffs(JS, jg)
    u, v, p = _fields(tg.shape, 2)
    tm, jm = TS.iota_masks(tg), JS.iota_masks(jg)
    if op == "predictor":
        got = TS.predictor(_t(u), _t(v), tc, tm[1], tm[2])
        want = JS.predictor(_j(u), _j(v), jc, jm[1], jm[2])
    elif op == "divergence":
        got = [TS.divergence(_t(u), _t(v), tc, tm[0])]
        want = [JS.divergence(_j(u), _j(v), jc, jm[0])]
    elif op in ("source", "source_mean"):
        rm = op == "source_mean"
        got = [TS.poisson_source(_t(u), _t(v), tc, tm[0], rm, tg.n_fluid)]
        want = [JS.poisson_source(_j(u), _j(v), jc, jm[0], rm, jg.n_fluid)]
    elif op.startswith("correction"):
        cav = op.endswith("cavity")
        got = TS.pressure_correction(_t(u), _t(v), _t(p), tc, tm[1], tm[2],
                                     _t(v), _t(u), cavity_form=cav)
        want = JS.pressure_correction(_j(u), _j(v), _j(p), jc, jm[1], jm[2],
                                      _j(v), _j(u), cavity_form=cav)
    else:
        got = TS.interpolate_to_centers(_t(u), _t(v), tm[0])
        want = JS.interpolate_to_centers(_j(u), _j(v), jm[0])
    for a, b in zip(got, want, strict=True):
        _close(a, b, atol=F64 * max(1.0, float(np.abs(np.asarray(b)).max())))


def test_flow_statistics_matches_jax():
    tg, jg = TG.Grid.regular(30, 30), JG.Grid.regular(30, 30)
    u, v, _ = _fields(tg.shape, 3)
    got = TR.flow_statistics(_t(u), _t(v), _coeffs(TS, tg),
                             torch.as_tensor(tg.cell_mask), 900)
    want = JR.flow_statistics(_j(u), _j(v), _coeffs(JS, jg),
                              jnp.asarray(jg.cell_mask), 900)
    assert set(got) == set(want)
    for k in got:
        assert abs(float(got[k]) - float(want[k])) <= F64 * max(1.0, abs(float(want[k]))), k


@pytest.mark.parametrize("bad", [dict(reynolds_number=-1.0), dict(cfl=0.0),
                                 dict(tolerance_factor=float("nan")),
                                 dict(print_interval=0)])
def test_param_checks_match_jax(bad):
    from cfd_tpu import params as JP
    from cfd_tpu_torch import params as TP

    with pytest.raises(ValueError) as want:
        JP.validate_case_params(**bad)
    with pytest.raises(ValueError) as got:
        TP.validate_case_params(**bad)
    assert str(got.value) == str(want.value)


def test_precision_names():
    from cfd_tpu_torch.precision import as_dtype

    assert as_dtype("f32") is torch.float32 and as_dtype("f64") is torch.float64
    assert as_dtype(torch.float32) is torch.float32
    with pytest.raises(ValueError):
        as_dtype("bf16")


def test_port_imports_no_jax():
    """The port and everything it imports must run where JAX is absent."""
    code = ("import sys\n"
            "import cfd_tpu_torch, cfd_tpu_torch.solver, cfd_tpu_torch.cases.cavity\n"
            "import cfd_tpu_torch.cli, cfd_tpu_torch.convert, cfd_tpu_torch.kernels\n"
            "import cfd_tpu_torch.profile_step, cfd_tpu_torch.cases.channel\n"
            "import cfd_tpu_torch.kernels.whole_solve, cfd_tpu_torch.kernels.mg_tail\n"
            "import cfd_tpu_torch.cases.backwards_step, cfd_tpu_torch.kernels.step_quad\n"
            "import cfd_tpu_torch.physics.boussinesq, cfd_tpu_torch.kernels.rb_quad\n"
            "import cfd_tpu_torch.ops.random, cfd_tpu_torch.adaptive\n"
            "import cfd_tpu_torch.kernels.whole_step\n"
            "import cfd_tpu_torch.parallel, cfd_tpu_torch.parallel.quad_sharded\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'cfd_tpu' or m.startswith('cfd_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(ROOT),
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_profile_trace_summary():
    """The step profiler's busy time is the union of device intervals, its
    idle share is of the same window's wall, and only csrc/ kernels count
    as the port's."""
    from cfd_tpu_torch.profile_step import (busy_us, is_port_kernel, port_kernel_names,
                                            summarize_trace)

    names = port_kernel_names()
    assert {"corrector_kernel", "predictor_source_kernel", "sep_pre_kernel",
            "sep_post_kernel", "pairs_kernel", "whole_solve_kernel"} <= names
    assert is_port_kernel("void (anonymous namespace)::sep_pre_kernel<false>(float const*, int)",
                          names)
    assert is_port_kernel("void (anonymous namespace)::pairs_kernel<float>(int)", names)
    assert not is_port_kernel("void at::native::elementwise_kernel<128, 2>(int)", names)
    assert not is_port_kernel("(anonymous namespace)::sep_pre_kernel_x(int)", names)
    # the step's kernels, whose names contain other kernels' names
    assert {"step_pre_kernel", "step_post_kernel", "step_corrector_kernel",
            "step_carry_kernel", "fold_partials_kernel"} <= names
    # the tile carries and their shared sum launch
    assert {"cavity_carry_kernel", "channel_carry_kernel", "step_carry_kernel",
            "rb_carry_kernel", "source_sum_kernel"} <= names
    assert is_port_kernel("void (anonymous namespace)::source_sum_kernel<true>(float const*)",
                          names)
    assert is_port_kernel("void (anonymous namespace)::whole_solve_kernel<true>(Params)",
                          names)
    assert is_port_kernel("(anonymous namespace)::step_pre_kernel<false>(float const*, StepL0)",
                          names)
    assert is_port_kernel("(anonymous namespace)::step_post_kernel<true>(float const*)", names)
    assert not is_port_kernel("(anonymous namespace)::step_post(float const*)", names)
    assert busy_us([(0, 10), (5, 10), (30, 5), (31, 1)]) == 20
    events = [
        dict(cat="kernel", name="(anonymous namespace)::pairs_kernel<float>(int)", ts=0, dur=10),
        dict(cat="kernel", name="at::native::add(int)", ts=5, dur=10),
        dict(cat="gpu_memset", name="Memset (Device)", ts=40, dur=20),
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=0, dur=100),
    ]
    s = summarize_trace(events, names, n_steps=2, wall_s=100e-6)
    assert s["busy_ms_per_step"] == pytest.approx(0.0175)
    assert s["idle_share"] == pytest.approx(0.65)
    assert (s["port_launches_per_step"], s["other_launches_per_step"]) == (0.5, 1.0)
    assert s["port_ms_per_step"] == pytest.approx(0.005)
    assert [t["name"] for t in s["port"]] == ["(anonymous namespace)::pairs_kernel<float>(int)"]
