"""The fused coarse tail (csrc/mg_tail.cu, MGConfig.tail_from) on the card:
the kernel against its plain twin at the four flows' level-1 shapes (small
and full width, and from level 3 on the cavity), the per-kernel solve with
the tail against the one without, and the card against the CPU over 20
steps.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_mg_tail_cuda.py

Limits: the kernel is built with --fmad=false and repeats its twin's
float32 operations in order, so its correction is bit-identical (max error
0, limit 1e-5 of scale); card against CPU, fields within 5e-5 of their
scale and equal cycles (the chip_smoke.py limits)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.kernels import mg_tail as MT
from cfd_tpu_torch.solver import Simulation

FLOWS = {
    "cavity": (make_cavity_case, lambda n: dict(n_interior=n, poisson="multigrid",
                                                tolerance_factor=1e-6),
               {"small": (256,), "full": (2048,)}),
    "channel": (make_channel_case, lambda nx, ny: dict(nx=nx, ny=ny, poisson="multigrid",
                                                       tolerance_factor=1e-6, abs_tol=0.0),
                {"small": (256, 128), "full": (1536, 512)}),
    "rb": (make_rayleigh_benard_case, lambda nx, ny: dict(nx=nx, ny=ny, rayleigh=1e6),
           {"small": (256, 128), "full": (1536, 512)}),
    "step": (make_backwards_step_case, lambda nx, ny: dict(nx=nx, ny=ny, poisson="multigrid",
                                                           tolerance_factor=1e-6, abs_tol=0.0),
             {"small": (512, 64), "full": (2048, 256)}),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(flow, size, device, **ov):
    make, kw, sizes = FLOWS[flow]
    return make(dtype=torch.float32, device=device, print_interval=20,
                **kw(*sizes[size]), **ov)


def _source(level, device, seed):
    rng = np.random.default_rng(seed)
    b = np.zeros(level.shape, np.float32)
    b[1 : level.ny + 1, 1 : level.nx + 1] = rng.standard_normal((level.ny, level.nx))
    return torch.from_numpy(b).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("flow, size, tail_from", [
    *((flow, size, 1) for flow in sorted(FLOWS) for size in ("small", "full")),
    ("cavity", "small", 3), ("cavity", "full", 3)])
def test_tail_kernel_matches_twin(cuda_device, flow, size, tail_from):
    case = _case(flow, size, cuda_device, mg_overrides={"tail_from": tail_from})
    tail = case.poisson_solve.tail
    assert tail.record is (MT.MG_TAIL_FULL if flow == "step" else MT.MG_TAIL)
    b = _source(tail.levels[0], cuda_device, seed=tail_from)
    before = tail.record.launches
    got = tail(b)
    torch.cuda.synchronize()
    assert tail.record.launches == before + 1
    assert torch.equal(got, tail.plain(b))


@pytest.mark.cuda
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_tail_path_against_per_kernel_on_card(cuda_device, flow):
    """20 steps with tail_from=1 against whole_solve=False: equal cycles and
    fields, and no coarse smoother launch on the tail path."""
    runs = []
    for ov in ({"tail_from": 1}, {"whole_solve": False}):
        sim = Simulation(_case(flow, "small", cuda_device, mg_overrides=ov),
                         log=lambda m: None)
        st = sim.run(n_steps=20)
        runs.append((sim.step_iters, sim._logical(st)))
    (it_t, s_t), (it_p, s_p) = runs
    assert it_t == it_p
    for name in ("u", "v", "p", "T"):
        a, b = getattr(s_t, name), getattr(s_p, name)
        if a is not None:
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= 1e-5 * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_tail_card_against_cpu(cuda_device, flow):
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulation(_case(flow, "small", dev, mg_overrides={"tail_from": 1}),
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
