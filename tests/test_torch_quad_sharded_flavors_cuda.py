"""The channel's and Rayleigh-Benard's shard carries (rows 16d and 16e: the
entry points of rows 8a and 10 in csrc/quad_stage.cu and csrc/rb_stage.cu
on a local block) against their plain PyTorch twins on the card, and the
sharded channel and RB on a mesh whose shards all live on one card against
the CPU.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_quad_sharded_flavors_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, and the partial sums fold in the twins'
order, so every output of every shard, halo rows included, is expected bit
for bit; the runs are held to equal cycles and fields within 5e-5 of scale
(bit-identical expected)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_channel_case, make_rayleigh_benard_case
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.parallel import ShardedQuadProjection, make_mesh
from cfd_tpu_torch.physics.boussinesq import RBParams

H = TQ.DEV_HALO


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _blocks(shape, mdy, jy, device, seed):
    """Seeded (us, vs, p, p_prev, T) local blocks of shard jy."""
    rng = np.random.default_rng(seed)
    Hq8s, P, _ = TQ.quad_shard_dims(shape, mdy)
    Hq8 = TQ.quad_dims(shape)[2]
    profile = np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
    out = []
    for k in range(5):
        a = (rng.standard_normal(shape) * (0.01 if k == 4 else 0.1)).astype(np.float32)
        if k in (2, 3):
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        if k == 4:
            a += profile
        q = TQ.to_quad(torch.from_numpy(a), shape)
        q = torch.nn.functional.pad(q, (0, 0, H, Hq8s - Hq8 + H))
        out.append(q[:, jy * P : jy * P + P + 2 * H].contiguous().to(device))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(96, 32), (256, 128)])
def test_flavor_shard_carries_match_plain_on_card(cuda_device, nx, ny):
    shape, mdy = (ny + 2, nx + 2), 4
    coeffs = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=1e-3, viscosity=1e-2)
    _, P, _ = TQ.quad_shard_dims(shape, mdy)
    channel = TQ.make_quad_channel_corr_predictor_source(shape, coeffs, 1.0, shard=(P, mdy))
    rb = TR.make_quad_rb_step_kernel(shape, coeffs, 1.2e-2, RBParams(1e5, 0.71),
                                     shard=(P, mdy))
    for jy in range(mdy):
        us, vs, p, pp, T = _blocks(shape, mdy, jy, cuda_device, seed=nx + jy)
        row_base = jy * P - H
        before = [k.launches for k in (TQ.SHARD_CHANNEL_CARRY, TR.SHARD_RB_CARRY)]
        pairs = [(channel(row_base, us, vs, p, pp), channel.plain(row_base, us, vs, p, pp)),
                 (rb(row_base, us, vs, p, T), rb.plain(row_base, us, vs, p, T))]
        torch.cuda.synchronize()
        assert [k.launches for k in (TQ.SHARD_CHANNEL_CARRY, TR.SHARD_RB_CARRY)] == [
            x + 1 for x in before]
        for got, want in pairs:
            for a, w in zip(got, want, strict=True):
                assert torch.equal(a, w), (jy, a.shape)


def _run(sq, steps):
    st, iters = sq.initial_state(), []
    for _ in range(steps):
        st, d = sq.step(st)
        iters.append(int(d["poisson_iters"]))
    return iters, sq.logical(st)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,nx,ny", [("channel", 256, 128), ("channel", 96, 32),
                                          ("rb", 256, 128)])
def test_sharded_flavors_card_vs_cpu(cuda_device, flavor, nx, ny):
    out = {}
    for dev in ("cuda", "cpu"):
        if flavor == "channel":
            case = make_channel_case(nx=nx, ny=ny, poisson="multigrid", dtype=torch.float32,
                                     tolerance_factor=1e-6, abs_tol=0.0, device=dev)
            kw = {"tol_factor": 1e-6}
        else:
            case = make_rayleigh_benard_case(nx=nx, ny=ny, rayleigh=1e6, dtype=torch.float32,
                                             device=dev)
            kw = {"tol_factor": 1e-7, "mg_overrides": {"abs_tol": 1e-10}}
        out[dev] = _run(ShardedQuadProjection(case, make_mesh(4, device=dev), **kw), 5)
    assert out["cuda"][0] == out["cpu"][0]
    for name in ("u", "v", "p", "T"):
        a, w = getattr(out["cuda"][1], name), getattr(out["cpu"][1], name)
        if w is None:
            continue
        a = a.cpu()
        assert float((a - w).abs().max()) <= 5e-5 * max(float(w.abs().max()), 1.0), name
