"""corr_opt's in-kernel steplength (csrc/whole_solve.cuh corr_alpha_phase)
on the card: the masked whole-solve (with the float32 and the bfloat16
hierarchy) and the step's whole step against their plain twins at a small
and at the full width, and the card against the CPU over 20 steps on all
three solves.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_corr_opt_cuda.py

Limits: the two sums are fixed-order folds in the twin's order and the rest
repeats its float32 operations (--fmad=false): bit-identical fields and
equal cycles; card against CPU, fields within 5e-5 of their scale and equal
cycles."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.convert import state_from_numpy
from cfd_tpu_torch.kernels import whole_solve as WSV
from cfd_tpu_torch.kernels import whole_step as WS
from cfd_tpu_torch.kernels.quad import to_quad
from cfd_tpu_torch.solver import Simulation

SIZES = {"small": (512, 64), "full": (2048, 256)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(size, device, **ov):
    nx, ny = SIZES[size]
    return make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6,
                                    abs_tol=0.0, dtype=torch.float32, device=device,
                                    print_interval=20, mg_overrides={"corr_opt": True, **ov})


@pytest.mark.cuda
@pytest.mark.parametrize("coarse_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("size", ["small", "full"])
def test_corr_opt_whole_solve_kernel_matches_twin(cuda_device, size, coarse_dtype):
    case = _case(size, cuda_device, whole_solve=True, coarse_dtype=coarse_dtype)
    solve = case.poisson_solve
    rng = np.random.default_rng(31)
    mask = np.asarray(case.grid.fluid, bool)
    b = np.where(mask, rng.standard_normal(case.grid.shape), 0.0)
    b = np.where(mask, b - b[mask].mean(), 0.0).astype(np.float32)
    b4 = to_quad(torch.from_numpy(b).to(cuda_device), case.grid.shape)
    before = WSV.STEP_WHOLE_SOLVE_CORR_OPT.launches
    got = solve(torch.zeros_like(b4), b4)
    torch.cuda.synchronize()
    assert WSV.STEP_WHOLE_SOLVE_CORR_OPT.launches == before + 1
    want = solve.plain(torch.zeros_like(b4), b4)
    assert int(got[1]) == int(want[1]) and float(got[2]) == float(want[2])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "full"])
def test_corr_opt_whole_step_kernel_matches_twin(cuda_device, size):
    case = _case(size, cuda_device, whole_step=True)
    ws = case.whole_step_kernel
    assert ws.record is WS.WHOLE_STEP_STEP_CORR_OPT
    sim = Simulation(case, log=lambda m: None)
    st = sim._logical(sim.initial_state())
    rng = np.random.default_rng(37)
    mask = np.asarray(case.grid.cell_mask, dtype=np.float32)
    f = {k: getattr(st, k).cpu().numpy().copy() for k in ("u", "v", "p")}
    for k, scale in (("u", 0.05), ("v", 0.05), ("p", 0.01)):
        f[k] = f[k] + (scale * rng.standard_normal(f[k].shape) * mask).astype(np.float32)
    s = case.align_state(state_from_numpy(f["u"], f["v"], f["p"], device=cuda_device))
    got = ws(s.u, s.v, s.p)
    torch.cuda.synchronize()
    want = ws.plain(s.u, s.v, s.p)
    assert int(got[-2]) == int(want[-2]) and float(got[-1]) == float(want[-1])
    for a, b in zip(got[:-2], want[:-2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("ov", [{}, {"whole_step": True}, {"whole_solve": False}])
def test_corr_opt_card_against_cpu(cuda_device, ov):
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulation(_case("small", dev, **ov), log=lambda m: None)
        st = sim.run(n_steps=20)
        runs.append((sim.step_iters, sim._logical(st)))
    (it_g, s_g), (it_c, s_c) = runs
    assert it_g == it_c
    for name in ("u", "v", "p"):
        a, b = getattr(s_g, name), getattr(s_c, name)
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) <= 5e-5 * scale, name
