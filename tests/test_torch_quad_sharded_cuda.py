"""The cavity's shard kernels (rows 16a-16c: the entry points of rows 1, 3
and 4 in csrc/quad_stage.cu and csrc/quad_vcycle.cu on a local block) against
their plain PyTorch twins on the card, and the sharded cavity on a mesh
whose shards all live on one card against the CPU and against the
single-device path.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_quad_sharded_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so every row of a block, halos included, is
expected bit for bit; the runs are held to equal cycles and fields within
5e-5 of scale (bit-identical expected)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_cavity_case
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.parallel import ShardedQuadCavity, make_mesh
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

H = TQ.DEV_HALO


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _blocks(shape, mdy, jy, device, seed):
    """Seeded (us, vs, p, p_prev, b) local blocks of shard jy and its ec."""
    rng = np.random.default_rng(seed)
    Hq8s, P, W = TQ.quad_shard_dims(shape, mdy)
    Hq8 = TQ.quad_dims(shape)[2]
    out = []
    for k, scale in enumerate((0.1, 0.1, 0.1, 0.1, 1e3)):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if k >= 2:
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        q = TQ.to_quad(torch.from_numpy(a), shape)
        q = torch.nn.functional.pad(q, (0, 0, H, Hq8s - Hq8 + H))
        out.append(q[:, jy * P : jy * P + P + 2 * H].contiguous().to(device))
    ny = shape[0] - 2
    ec = torch.zeros(Hq8s + 2 * H, W)
    ec[H + 1 : H + ny // 2 + 1, 1 : ny // 2 + 1] = torch.from_numpy(
        rng.standard_normal((ny // 2, ny // 2)).astype(np.float32) * 0.1)
    return out, ec[jy * P : jy * P + P + 2 * H].contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mdy", [(64, 4), (64, 8), (256, 4)])
def test_shard_kernels_match_plain_on_card(cuda_device, n, mdy):
    shape = (n + 2, n + 2)
    h = 1.0 / n
    coeffs = StencilCoeffs(dx=h, dy=h, dt=0.25 * h, viscosity=1e-3, density=1.0)
    prob = TM.cavity_problem(n, n, h, h)
    _, P, W = TQ.quad_shard_dims(shape, mdy)
    loc, shard = (P + 2 * H, W), (P, mdy)
    carry = TQ.make_quad_corr_predictor_source(shape, coeffs, 1.0, shard=shard)
    pre = TQ.make_quad_pre_smooth_restrict(shape, prob, 1.0, 2, loc, cuda_device, shard)
    post = TQ.make_quad_post_prolong_smooth(shape, prob, 1.0, 1, loc, cuda_device, shard)
    for jy in range(mdy):
        (us, vs, p, pp, b), ec = _blocks(shape, mdy, jy, cuda_device, seed=n + jy)
        rb = jy * P - H
        before = [k.launches for k in (TQ.SHARD_CARRY, TQ.SHARD_PRE, TQ.SHARD_POST)]
        pairs = [(carry(rb, us, vs, p, pp), carry.plain(rb, us, vs, p, pp)),
                 (pre(rb, p, b), pre.plain(rb, p, b)),
                 (post(rb, p, b, ec), post.plain(rb, p, b, ec))]
        torch.cuda.synchronize()
        assert [k.launches for k in (TQ.SHARD_CARRY, TQ.SHARD_PRE, TQ.SHARD_POST)] == [
            x + 1 for x in before]
        for got, want in pairs:
            for a, w in zip(got, want, strict=True):
                assert torch.equal(a, w), (jy, a.shape)


def _run(sim_or_sq, steps):
    if isinstance(sim_or_sq, Simulation):
        st, iters = sim_or_sq.initial_state(), []
        for _ in range(steps):
            st, d = sim_or_sq._step(st)
            iters.append(int(d.poisson_iters))
        return iters, sim_or_sq._logical(st)
    st, iters = sim_or_sq.initial_state(), []
    for _ in range(steps):
        st, d = sim_or_sq.step(st)
        iters.append(int(d["poisson_iters"]))
    return iters, sim_or_sq.logical(st)


def _close(got, want):
    for name in ("u", "v", "p", "p_prev"):
        a, w = getattr(got, name).float().cpu(), getattr(want, name).float().cpu()
        assert float((a - w).abs().max()) <= 5e-5 * max(float(w.abs().max()), 1.0), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,mdy", [(256, 4), (64, 8)])
def test_sharded_cavity_card_vs_cpu(cuda_device, n, mdy):
    out = {}
    for dev in ("cuda", "cpu"):
        case = make_cavity_case(n_interior=n, poisson="multigrid", dtype=torch.float32,
                                tolerance_factor=1e-6, device=dev)
        out[dev] = _run(ShardedQuadCavity(case, make_mesh(mdy, device=dev),
                                          tol_factor=1e-6), 5)
    assert out["cuda"][0] == out["cpu"][0]
    _close(out["cuda"][1], out["cpu"][1])


@pytest.mark.cuda
def test_sharded_cavity_matches_the_single_device_path_on_card(cuda_device):
    kw = dict(n_interior=256, poisson="multigrid", dtype=torch.float32,
              tolerance_factor=1e-6, device=cuda_device)
    single = make_cavity_case(mg_overrides={"whole_solve": False}, **kw)
    assert single.info["mg"].coarse_dtype is None  # the float32 hierarchy
    want = _run(Simulation(single), 10)
    got = _run(ShardedQuadCavity(make_cavity_case(**kw), make_mesh(4), tol_factor=1e-6), 10)
    assert got[0] == want[0]
    _close(got[1], want[1])


@pytest.mark.cuda
def test_one_shard_mesh_delegates_on_card(cuda_device):
    case = make_cavity_case(n_interior=128, poisson="multigrid", dtype=torch.float32,
                            tolerance_factor=1e-6, device=cuda_device)
    counters = (TQ.SHARD_CARRY, TQ.SHARD_PRE, TQ.SHARD_POST, TQ.CARRY)
    before = [k.launches for k in counters]
    sq = ShardedQuadCavity(case, make_mesh(1))
    assert sq.delegated  # the case's own step (solver.make_step)
    iters, got = _run(sq, 3)
    want = _run(Simulation(case), 3)
    after = [k.launches for k in counters]
    assert after[:3] == before[:3] and after[3] == before[3] + 6
    assert iters == want[0]
    _close(got, want[1])
