"""The four traced-dt + Courant carries on a shard's local block (rows 16a+,
16d+, 16e+, 16f+: the entry points of rows 1+, 8a+, 10+ and 9a+ in
csrc/quad_stage.cu, csrc/rb_stage.cu and csrc/step_stage.cu told the
block's row_base and halo) against their plain PyTorch twins on the card,
the whole-field instances unchanged beside them, and the sharded lagged
runs on a mesh whose shards all live on one card against the CPU.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_quad_sharded_adaptive_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, the partial sums fold in the twins' order and
the maxima are exact, so every output of every shard is expected bit for
bit, halo rows included; the runs are held to the same dt and cycles every
step and fields within 5e-5 of scale (bit-identical expected)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.adaptive import run_adaptive
from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                 make_channel_case, make_rayleigh_benard_case)
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.kernels import step_quad as TSQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.parallel import make_mesh
from cfd_tpu_torch.physics.boussinesq import RBParams
from cfd_tpu_torch.solver import Simulation

H = TQ.DEV_HALO
MDY = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ops(kind, nx, ny):
    """(shape, P, the shard-adaptive op, the whole-field adaptive op, its
    Kernel, the number of inputs) of ``kind`` at nx x ny on MDY shards."""
    shape = (ny + 2, nx + 2)
    _, P, _ = TQ.quad_shard_dims(shape, MDY)
    if kind == "cavity":
        c = StencilCoeffs(dx=1.0 / nx, dy=1.0 / ny, dt=1e-3, viscosity=1e-2)
        make = lambda **kw: TQ.make_quad_corr_predictor_source(shape, c, 1.0, adaptive=True,
                                                               **kw)
        return shape, P, make(shard=(P, MDY)), make(), TQ.SHARD_CARRY_ADAPTIVE, 4
    if kind == "channel":
        c = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=1e-3, viscosity=1e-2)
        make = lambda **kw: TQ.make_quad_channel_corr_predictor_source(shape, c, 1.0,
                                                                       adaptive=True, **kw)
        return shape, P, make(shard=(P, MDY)), make(), TQ.SHARD_CHANNEL_CARRY_ADAPTIVE, 4
    if kind == "rb":
        c = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=1e-3, viscosity=1e-2)
        make = lambda **kw: TR.make_quad_rb_step_kernel(shape, c, 1.2e-2, RBParams(1e5, 0.71),
                                                        adaptive=True, **kw)
        return shape, P, make(shard=(P, MDY)), make(), TR.SHARD_RB_CARRY_ADAPTIVE, 4
    c = StencilCoeffs(dx=8.0 / nx, dy=2.0 / ny, dt=1e-3, viscosity=1e-2)
    step_i, inlet_j = int(2.0 / c.dx), int(1.0 / c.dy)
    make = lambda **kw: TSQ.make_quad_step_corr_predictor_source(shape, c, step_i, inlet_j,
                                                                 1.0, adaptive=True, **kw)
    return shape, P, make(shard=(P, MDY)), make(), TSQ.SHARD_STEP_CARRY_ADAPTIVE, 3


def _fields(shape, n, device, seed):
    """Seeded whole quad fields (us, vs, p[, p_prev or T]) on ``device``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k >= 2:
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(TQ.to_quad(torch.from_numpy(a), shape).to(device))
    return out


def _blocks(fields, P, jy):
    Hq8s = P * MDY
    return [torch.nn.functional.pad(f, (0, 0, H, Hq8s - f.shape[1] + H))[
        :, jy * P : jy * P + P + 2 * H].contiguous() for f in fields]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,nx,ny", [("cavity", 64, 64), ("channel", 96, 32),
                                        ("rb", 256, 128), ("step", 128, 64)])
def test_shard_adaptive_carries_match_plain_on_card(cuda_device, kind, nx, ny):
    """Every shard bit for bit against the twin, the own rows against the
    whole-field instance's, the maxima over the shards against its mu, mv,
    and halo rows at +-1e3 leaving mu and mv where they were."""
    shape, P, op, whole, kern, n = _ops(kind, nx, ny)
    fields = _fields(shape, n, cuda_device, seed=nx + ny)
    dts = torch.tensor([0.8e-3, 1.1e-3], device=cuda_device)
    single = whole(dts, *fields)
    Hq8 = fields[0].shape[1]
    mus, mvs = [], []
    for jy in range(MDY):
        blocks = _blocks(fields, P, jy)
        before = kern.launches
        got, want = op(jy * P - H, dts, *blocks), op.plain(jy * P - H, dts, *blocks)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for a, w in zip(got, want, strict=True):
            assert torch.equal(a, w), (jy, a.shape)
        lo, hi = jy * P, max(jy * P, min(jy * P + P, Hq8))
        for k in range(len(got) - 3):
            assert torch.equal(got[k][:, H : H + hi - lo], single[k][:, lo:hi]), (jy, k)
        mus.append(float(got[-2]))
        mvs.append(float(got[-1]))
        for t in blocks[:2]:
            t[:, :H] = 1e3
            t[:, H + P :] = -1e3
        poisoned = op(jy * P - H, dts, *blocks)
        assert (float(poisoned[-2]), float(poisoned[-1])) == (mus[-1], mvs[-1]), jy
    assert (max(mus), max(mvs)) == (float(single[-2]), float(single[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("make,kw,sharded_kwargs", [
    (make_cavity_case, dict(n_interior=256, poisson="multigrid", tolerance_factor=1e-6),
     {"tol_factor": 1e-6}),
    (make_channel_case, dict(nx=96, ny=32, poisson="multigrid", tolerance_factor=1e-6,
                             abs_tol=0.0), {"tol_factor": 1e-6}),
    (make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e6),
     {"tol_factor": 1e-7, "mg_overrides": {"abs_tol": 1e-10}}),
    (make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid", tolerance_factor=1e-6,
                                    abs_tol=0.0), {"tol_factor": 1e-6}),
])
def test_sharded_lagged_run_card_matches_cpu(cuda_device, make, kw, sharded_kwargs):
    out = {}
    for dev in ("cuda", "cpu"):
        sim = Simulation(make(dtype=torch.float32, device=dev, print_interval=10, **kw),
                         log=lambda m: None, mesh=make_mesh(MDY, device=dev),
                         sharded_kwargs=sharded_kwargs)
        st, _ = run_adaptive(sim, max_courant=0.7, n_steps=10, steps_per_call=5,
                             controller="lagged")
        out[dev] = (sim.step_iters, sim.step_dts, st)
    (it_g, dt_g, st_g), (it_c, dt_c, st_c) = out["cuda"], out["cpu"]
    assert it_g == it_c and dt_g == dt_c
    for name in ("u", "v", "p", "T"):
        a, w = getattr(st_g, name), getattr(st_c, name)
        if w is None:
            continue
        err = float((a.cpu() - w).abs().max())
        assert err <= 5e-5 * max(1.0, float(w.abs().max())), (name, err)
