"""The Rayleigh-Benard slice's CUDA kernels against their plain PyTorch twins
on the card: the RB carry (both variants) and corrector (csrc/rb_stage.cu)
and the pin-mean whole-solve (csrc/whole_solve.cu), at 48x16 and 192x64 on
seeded inputs, and the slice card against CPU over 10 steps.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_rb_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so fields agree within 1e-5 of their scale
(expected: bit for bit), the source sum and the solve's residual are
equal, and the whole-solve takes the cycles of its twin and of the
per-kernel composition."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.kernels.quad import to_quad
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.physics.boussinesq import RBParams, make_rayleigh_benard_case
from cfd_tpu_torch.solver import Simulation

SIZES = [(48, 16), (192, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(nx, ny, device, seed=0):
    shape = (ny + 2, nx + 2)
    rng = np.random.default_rng(seed)
    out = []
    for k in range(5):  # us, vs, p, T, p_prev
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k == 3:
            a = a + np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
        if k in (2, 4):
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(to_quad(torch.from_numpy(a), shape).to(device))
    return shape, out


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["carry", "carry_guess", "corrector"])
@pytest.mark.parametrize("nx,ny", SIZES)
def test_rb_kernel_matches_plain_on_card(cuda_device, variant, nx, ny):
    shape, args = _inputs(nx, ny, cuda_device, seed=nx + ny)
    coeffs = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=1e-2, viscosity=8e-3)
    if variant == "corrector":
        op, counter, args = TR.make_quad_rb_corrector(shape, coeffs), TR.RB_CORRECTOR, args[:3]
    else:
        guess = variant == "carry_guess"
        op = TR.make_quad_rb_step_kernel(shape, coeffs, 1.2e-2, RBParams(1e6, 0.71),
                                         emit_guess=guess)
        counter, args = TR.RB_CARRY, args if guess else args[:4]
    before = counter.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    if variant != "corrector":  # the fixed-order source sum: equal to the twin's
        assert float(got[-1]) == float(want[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", SIZES)
def test_pin_mean_whole_solve_matches_plain_on_card(cuda_device, nx, ny):
    case = make_rayleigh_benard_case(nx=nx, ny=ny, device=cuda_device)
    solve = case.poisson_solve
    assert isinstance(solve, TW.WholeSolve) and solve.cfg.pin_mean
    shape = case.grid.shape
    b = np.zeros(shape, np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(ny).standard_normal((ny, nx))
    b[1:-1, 1:-1] -= b[1:-1, 1:-1].mean()
    b4 = to_quad(torch.from_numpy(b), shape).to(cuda_device)
    p0 = torch.zeros_like(b4)
    before = (TW.WHOLE_SOLVE.launches, TW.WHOLE_SOLVE_PIN_MEAN.launches)
    pk, ck, rk = solve(p0, b4)
    assert (TW.WHOLE_SOLVE.launches, TW.WHOLE_SOLVE_PIN_MEAN.launches) == (
        before[0], before[1] + 1)
    pp, cp, rp = solve.plain(p0, b4)
    pm, cm, rm = solve.mg(p0, b4)  # the per-kernel composition of the quad kernels
    assert ck == cp == cm and ck > 1
    _close(pk, pp)
    _close(pk, pm)
    assert rk == rp == rm


@pytest.mark.cuda
@pytest.mark.parametrize("whole_solve", [True, False])
def test_rb_slice_card_matches_cpu(cuda_device, whole_solve):
    out = []
    for dev in ("cuda", "cpu"):
        case = make_rayleigh_benard_case(nx=192, ny=64, device=dev, print_interval=10,
                                         mg_overrides={"whole_solve": whole_solve})
        assert isinstance(case.poisson_solve, TW.WholeSolve) == whole_solve
        sim = Simulation(case, log=lambda m: None)
        st = sim._logical(sim.run(n_steps=10))
        out.append((sim.step_iters, st, sim.history[-1]))
    (ig, sg, rg), (ic, sc, rc) = out
    assert ig == ic
    for name in ("u", "v", "p", "T"):
        _close(getattr(sg, name).cpu(), getattr(sc, name), 5e-5)
    for k in ("avg_kinetic_energy", "nusselt_volume"):
        assert abs(rg[k] - rc[k]) <= 1e-6 * abs(rc[k]), (k, rg[k], rc[k])
