"""The adaptive-stepping CUDA instances against their plain PyTorch twins on
the card: the traced-dt non-carry cavity stage, the traced-dt correctors and
the traced-dt + Courant carries of the cavity, the channel, the step and RB
(csrc/quad_stage.cu, csrc/step_stage.cu, csrc/rb_stage.cu) at two sizes,
with dt_corr = 0.8 dt and dt_pred = 1.1 dt; and run_adaptive card against
CPU over 10 steps.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_adaptive_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so fields agree within 1e-5 of their scale
(expected: bit for bit) and the sums and maxima are equal; card and CPU
runs take the same dt and cycles every step."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                 make_channel_case, make_rayleigh_benard_case)
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.physics.boussinesq import RBParams
from cfd_tpu_torch.solver import Simulation

SIZES = [(64, 16), (192, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ops(kind, nx, ny):
    """(op, its launch counter, field names, number of dts)."""
    shape = (ny + 2, nx + 2)
    c = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=2e-3, viscosity=1e-2, density=1.3)
    rect = (nx // 4, ny // 2)
    return {
        "predictor_source": (TQ.make_quad_predictor_source(shape, c), TQ.PREDICTOR_SOURCE,
                             ("u", "v"), 1),
        "corrector": (TQ.make_quad_corrector(shape, c, traced_dt=True), TQ.CORRECTOR_TRACED,
                      ("us", "vs", "p", "p_prev"), 1),
        "carry": (TQ.make_quad_corr_predictor_source(shape, c, adaptive=True),
                  TQ.CARRY_ADAPTIVE, ("us", "vs", "p", "p_prev"), 2),
        "channel_corrector": (TQ.make_quad_channel_corrector(shape, c, 0.7, traced_dt=True),
                              TQ.CHANNEL_CORRECTOR_TRACED, ("us", "vs", "p", "p_prev"), 1),
        "channel_carry": (TQ.make_quad_channel_corr_predictor_source(shape, c, 0.7,
                                                                     adaptive=True),
                          TQ.CHANNEL_CARRY_ADAPTIVE, ("us", "vs", "p", "p_prev"), 2),
        "step_corrector": (TS.make_quad_step_corrector(shape, c, *rect, traced_dt=True),
                           TS.STEP_CORRECTOR_TRACED, ("us", "vs", "p"), 1),
        "step_carry": (TS.make_quad_step_corr_predictor_source(shape, c, *rect, adaptive=True),
                       TS.STEP_CARRY_ADAPTIVE, ("us", "vs", "p"), 2),
        "rb_corrector": (TR.make_quad_rb_corrector(shape, c, traced_dt=True),
                         TR.RB_CORRECTOR_TRACED, ("us", "vs", "p"), 1),
        "rb_carry": (TR.make_quad_rb_step_kernel(shape, c, 1.2e-2, RBParams(1e6, 0.71),
                                                 adaptive=True),
                     TR.RB_CARRY_ADAPTIVE, ("us", "vs", "p", "T"), 2),
    }[kind], shape, c


def _inputs(names, shape, device, seed):
    rng = np.random.default_rng(seed)
    out = []
    for name in names:
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if name == "T":
            a += np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
        if name in ("p", "p_prev"):
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(TQ.to_quad(torch.from_numpy(a), shape).to(device))
    return out


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["predictor_source", "corrector", "carry",
                                  "channel_corrector", "channel_carry", "step_corrector",
                                  "step_carry", "rb_corrector", "rb_carry"])
@pytest.mark.parametrize("nx,ny", SIZES)
def test_adaptive_kernel_matches_plain_on_card(cuda_device, kind, nx, ny):
    (op, counter, names, n_dt), shape, c = _ops(kind, nx, ny)
    args = _inputs(names, shape, cuda_device, nx + ny)
    vals = [0.8 * c.dt, 1.1 * c.dt] if n_dt == 2 else 1.1 * c.dt
    dts = torch.tensor(vals, dtype=torch.float32, device=cuda_device)
    before = counter.launches
    got, want = op(dts, *args), op.plain(dts, *args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        if a.dim() == 0:  # max|b|, the source sum, the Courant maxima: equal
            assert float(a) == float(b)
        else:
            _close(a, b)


# the cavity pins its coarse hierarchy: the card's default is bf16, the CPU's f32
CAVITY = dict(n_interior=128, poisson="multigrid", dtype=torch.float32,
              tolerance_factor=1e-6, print_interval=10,
              mg_overrides={"coarse_dtype": "bfloat16"})
RUNS = {
    "cavity_exact": (make_cavity_case, CAVITY, "exact", 1),
    "cavity_exact_chunked": (make_cavity_case, CAVITY, "exact", 5),
    "cavity_lagged": (make_cavity_case, CAVITY, "lagged", 5),
    "channel": (make_channel_case, dict(nx=192, ny=64, poisson="multigrid",
                                        dtype=torch.float32, tolerance_factor=1e-6,
                                        print_interval=10), "lagged", 5),
    "step": (make_backwards_step_case, dict(nx=256, ny=32, poisson="multigrid",
                                            dtype=torch.float32, tolerance_factor=1e-6,
                                            print_interval=10), "lagged", 5),
    "rb": (make_rayleigh_benard_case, dict(nx=192, ny=64, print_interval=10), "lagged", 5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("run", list(RUNS))
def test_run_adaptive_card_matches_cpu(cuda_device, run):
    make, kw, controller, spc = RUNS[run]
    out = []
    for dev in ("cuda", "cpu"):
        sim = Simulation(make(device=dev, **kw), log=lambda m: None)
        st, rows = run_adaptive(sim, max_courant=0.7, n_steps=10, steps_per_call=spc,
                                controller=controller, log=lambda m: None)
        out.append((sim.step_iters, sim.step_dts, st, rows))
    (ig, dg, sg, rg), (ic, dc, sc, rc) = out
    assert ig == ic
    assert dg == dc
    for name in ("u", "v", "p", "T"):
        if getattr(sc, name) is not None:
            _close(getattr(sg, name).cpu(), getattr(sc, name), 5e-5)
    assert [r["courant"] for r in rg] == [r["courant"] for r in rc]
