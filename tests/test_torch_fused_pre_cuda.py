"""The cavity's fused-pre carry (row 7, csrc/quad_fused_pre.cu) and the
channel's non-carry stage (row 8c, csrc/quad_stage.cu) against their plain
PyTorch twins on the card, and the fused-pre cavity's steps against the
per-kernel composition.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_pre_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so outputs agree within 1e-5 of their scale
(measured: bit for bit), and the fused-pre path takes the composition's
cycles with bit-identical fields."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_cavity_case
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation, make_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fields(shape, n, device, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k >= 2:  # p, p_prev: interior only
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(TQ.to_quad(torch.from_numpy(a), shape).to(device))
    return out


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_pairs", [(64, 2), (128, 1)])
def test_fused_pre_matches_plain_on_card(cuda_device, n, n_pairs):
    shape = (n + 2, n + 2)
    h = 1.0 / n
    coarse = TM._round_up8_128((n // 2 + 2, n // 2 + 2))
    pre = TQ.make_quad_pre_smooth_restrict(shape, TM.cavity_problem(n, n, h, h), 1.0, n_pairs,
                                           coarse, device=cuda_device)
    op = TQ.QuadCorrPredictorSourceFusedPre(
        shape, StencilCoeffs(dx=h, dy=h, dt=0.25 * h, viscosity=1e-3, density=1.0), pre)
    args = _fields(shape, 4, cuda_device, seed=n)
    before = TQ.FUSED_PRE.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert TQ.FUSED_PRE.launches == before + 1
    for a, b in zip(got, want, strict=True):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(64, 32), (128, 64)])
def test_channel_predictor_source_matches_plain_on_card(cuda_device, nx, ny):
    shape = (ny + 2, nx + 2)
    coeffs = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=2e-3, viscosity=1e-2, density=1.3)
    op = TQ.make_quad_channel_predictor_source(shape, coeffs, 0.7)
    args = _fields(shape, 2, cuda_device, seed=nx)
    before = TQ.CHANNEL_PREDICTOR_SOURCE.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert TQ.CHANNEL_PREDICTOR_SOURCE.launches == before + 1
    for a, b in zip(got, want, strict=True):
        _close(a, b)


@pytest.mark.cuda
def test_fused_pre_steps_equal_the_per_kernel_steps_on_card(cuda_device):
    kw = dict(n_interior=128, poisson="multigrid", dtype=torch.float32,
              tolerance_factor=1e-5, device=cuda_device, mg_overrides={"whole_solve": False})
    on, off = make_cavity_case(fuse_pre=True, **kw), make_cavity_case(**kw)
    assert on.carry_fused_pre
    step_on, step_off = make_step(on), make_step(off)
    s_on = s_off = Simulation(on).initial_state()
    for k in range(5):
        s_on, d_on = step_on(s_on)
        s_off, d_off = step_off(s_off)
        assert d_on.poisson_iters == d_off.poisson_iters, k
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(s_on, name), getattr(s_off, name)), (k, name)
