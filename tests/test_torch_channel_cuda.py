"""The channel slice's CUDA kernels against their plain PyTorch twins on the
card: the channel carry and corrector (csrc/quad_stage.cu) and the
whole-solve (csrc/whole_solve.cu), at 64x32 and 128x64 on seeded inputs.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_channel_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so fields agree within 1e-5 of their scale
(measured: bit for bit) and the whole-solve's cycle count is equal."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.poisson import multigrid as TM


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(nx, ny, device, seed=0):
    shape = (ny + 2, nx + 2)
    rng = np.random.default_rng(seed)
    out = []
    for k in range(4):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k >= 2:  # p, p_prev: interior only
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(TQ.to_quad(torch.from_numpy(a), shape).to(device))
    return shape, out


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["carry", "corrector"])
@pytest.mark.parametrize("nx,ny", [(64, 32), (128, 64)])
def test_channel_kernel_matches_plain_on_card(cuda_device, name, nx, ny):
    shape, args = _inputs(nx, ny, cuda_device, seed=nx)
    coeffs = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=2e-3, viscosity=1e-2, density=1.3)
    op, counter = ((TQ.make_quad_channel_corr_predictor_source(shape, coeffs, 1.0),
                    TQ.CHANNEL_CARRY) if name == "carry" else
                   (TQ.make_quad_channel_corrector(shape, coeffs, 1.0),
                    TQ.CHANNEL_CORRECTOR))
    before = counter.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    if name == "carry":  # the fixed-order source sum: equal to the twin's
        assert float(got[4]) == float(want[4])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(64, 32), (128, 64)])
def test_whole_solve_kernel_matches_plain_on_card(cuda_device, nx, ny):
    shape = (ny + 2, nx + 2)
    cfg = TM.MGConfig(pre_sweeps=1, post_sweeps=2, tol_factor=1e-5)
    solve = TW.make_quad_whole_solve(shape, TM.channel_problem(nx, ny, 3.0 / nx, 1.0 / ny),
                                     cfg, device=cuda_device)
    b = np.zeros(shape, np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(ny).standard_normal((ny, nx))
    b[1:-1, 1:-1] -= b[1:-1, 1:-1].mean()
    b4 = TQ.to_quad(torch.from_numpy(b), shape).to(cuda_device)
    p0 = torch.zeros_like(b4)
    before = TW.WHOLE_SOLVE.launches
    pk, ck, rk = solve(p0, b4)
    assert TW.WHOLE_SOLVE.launches == before + 1
    pp, cp, rp = solve.plain(p0, b4)
    assert ck == cp and ck > 1
    _close(pk, pp)
    assert rk == rp
    grid = TW.launch_grid()
    assert grid["blocks"] >= 1 and grid["blocks_per_sm"] >= 1
