"""The bfloat16 hierarchy of the whole-solve and the whole step
(MGConfig.coarse_dtype="bfloat16", csrc/whole_solve.cuh's rounding points)
on the card: the three whole-solve flavors and the four whole steps against
their plain twins at a small and at the full width, and the card against the
CPU over 20 steps.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_coarse_bf16_cuda.py

Limits: the kernels round with __float2bfloat16_rn where the twin calls
.to(torch.bfloat16), both round to nearest even, and every other float32
operation repeats the twin's in order (--fmad=false): bit-identical fields
and equal cycles; card against CPU, fields within 5e-5 of their scale and
equal cycles."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.convert import state_from_numpy
from cfd_tpu_torch.kernels import whole_solve as WSV
from cfd_tpu_torch.kernels import whole_step as WS
from cfd_tpu_torch.kernels.quad import to_quad
from cfd_tpu_torch.solver import Simulation

BF16 = "bfloat16"
FLOWS = {
    "cavity": (make_cavity_case, lambda n: dict(n_interior=n, poisson="multigrid",
                                                tolerance_factor=1e-6),
               {"small": (256,), "full": (2048,)}, WSV.WHOLE_SOLVE_BF16,
               WS.WHOLE_STEP_CAVITY_BF16),
    "channel": (make_channel_case, lambda nx, ny: dict(nx=nx, ny=ny, poisson="multigrid",
                                                       tolerance_factor=1e-6, abs_tol=0.0),
                {"small": (256, 128), "full": (1536, 512)}, WSV.WHOLE_SOLVE_BF16,
                WS.WHOLE_STEP_CHANNEL_BF16),
    "rb": (make_rayleigh_benard_case, lambda nx, ny: dict(nx=nx, ny=ny, rayleigh=1e6),
           {"small": (256, 128), "full": (1536, 512)}, WSV.WHOLE_SOLVE_PIN_MEAN_BF16,
           WS.WHOLE_STEP_RB_BF16),
    "step": (make_backwards_step_case, lambda nx, ny: dict(nx=nx, ny=ny, poisson="multigrid",
                                                           tolerance_factor=1e-6, abs_tol=0.0),
             {"small": (512, 64), "full": (2048, 256)}, WSV.STEP_WHOLE_SOLVE_BF16,
             WS.WHOLE_STEP_STEP_BF16),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(flow, size, device, **ov):
    make, kw, sizes, _, _ = FLOWS[flow]
    return make(dtype=torch.float32, device=device, print_interval=20,
                **kw(*sizes[size]), **ov)


def _source(case, seed):
    """A seeded source on the fluid cells, mean-free (the channel, RB and
    the step solve mean-removed sources)."""
    rng = np.random.default_rng(seed)
    mask = np.asarray(case.grid.cell_mask, bool)
    b = np.where(mask, rng.standard_normal(case.grid.shape), 0.0)
    b = np.where(mask, b - b[mask].mean(), 0.0).astype(np.float32)
    return to_quad(torch.from_numpy(b).to(case.device), case.grid.shape)


def _fields(case, seed):
    sim = Simulation(case, log=lambda m: None)
    st = sim._logical(sim.initial_state())
    rng = np.random.default_rng(seed)
    mask = np.asarray(case.grid.cell_mask, dtype=np.float32)
    f = {k: getattr(st, k).cpu().numpy().copy()
         for k in ("u", "v", "p", "T", "p_prev") if getattr(st, k) is not None}
    for k, scale in (("u", 0.05), ("v", 0.05), ("p", 0.01)):
        f[k] = f[k] + (scale * rng.standard_normal(f[k].shape) * mask).astype(np.float32)
    s = case.align_state(state_from_numpy(f["u"], f["v"], f["p"], f.get("p_prev"),
                                          f.get("T"), device=case.device))
    if case.ordering == "rayleigh_benard":
        return (s.u, s.v, s.p, s.T)
    return (s.u, s.v, s.p) if s.p_prev is None else (s.u, s.v, s.p, s.p_prev)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_bf16_whole_solve_kernel_matches_twin(cuda_device, flow, size):
    case = _case(flow, size, cuda_device,
                 mg_overrides={"whole_solve": True, "coarse_dtype": BF16})
    solve, counter = case.poisson_solve, FLOWS[flow][3]
    b = _source(case, seed=23)
    p0 = torch.zeros_like(b)
    before = counter.launches
    got = solve(p0, b)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = solve.plain(p0, b)
    assert int(got[1]) == int(want[1]) and float(got[2]) == float(want[2])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_bf16_whole_step_kernel_matches_twin(cuda_device, flow, size):
    case = _case(flow, size, cuda_device, mg_overrides={"whole_step": True, "coarse_dtype": BF16})
    ws, counter = case.whole_step_kernel, FLOWS[flow][4]
    assert ws.record is counter
    fields = _fields(case, seed=29)
    before = counter.launches
    got = ws(*fields)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = ws.plain(*fields)
    assert int(got[-2]) == int(want[-2]) and float(got[-1]) == float(want[-1])
    for a, b in zip(got[:-2], want[:-2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["whole_solve", "whole_step"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_bf16_card_against_cpu(cuda_device, flow, path):
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulation(_case(flow, "small", dev,
                               mg_overrides={path: True, "coarse_dtype": BF16}),
                         log=lambda m: None)
        st = sim.run(n_steps=20)
        runs.append((sim.step_iters, sim._logical(st)))
    (it_g, s_g), (it_c, s_c) = runs
    assert it_g == it_c
    for name in ("u", "v", "p", "T"):
        a, b = getattr(s_g, name), getattr(s_c, name)
        if b is not None:
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a.cpu() - b).abs().max()) <= 5e-5 * scale, name
