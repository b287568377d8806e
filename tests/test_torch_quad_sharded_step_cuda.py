"""The step's shard kernels (row 16f: the entry points of rows 9a, 9c and 9d
in csrc/step_stage.cu and csrc/step_vcycle.cu on a local block) against
their plain PyTorch twins on the card, and the sharded step on a mesh whose
shards all live on one card against the CPU.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_quad_sharded_step_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, and the partial sums fold in the twins'
order, so every output of every shard, halo rows included, is expected bit
for bit; the runs are held to equal cycles and fields within 5e-5 of scale
(bit-identical expected). The block instances of the finest-level pre and
post kernels (one launch of shared-memory tiles each) are held bit for
bit on every shard under kernels/plan.py LEVEL0_TILES' tile, under tiles
that do not divide the block, and under one larger than it, with their
device operations a call counted by torch.profiler in a child process."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import step_quad as TSQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.parallel import ShardedQuadProjection, make_mesh
from cfd_tpu_torch.poisson.multigrid import step_rect_params

H = TQ.DEV_HALO
ROOT = Path(__file__).resolve().parent.parent
# (nx, ny, mdy, tile) of the block instances: LEVEL0_TILES' tile at the
# 2048x256 step's 4-shard blocks (the corner row, shard 1's local row 32,
# inside a 7-row tile) and 8-row tiles (the corner row on a tile edge),
# ragged tiles, and one larger than the 32x8 mesh's blocks
LEVEL0_CASES = [(2048, 256, 4, None), (2048, 256, 4, (8, 32)), (2048, 256, 4, (5, 24)),
                (512, 64, 4, (3, 7)), (512, 64, 4, None), (32, 8, 2, (1000, 5000))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _blocks(shape, mdy, jy, device, seed, fluid):
    """Seeded (us, vs, p, b) local blocks of shard jy (p and b 0 off the
    fluid cells) and its level-1 correction block ec."""
    rng = np.random.default_rng(seed)
    Hq8s, P, W = TQ.quad_shard_dims(shape, mdy)
    Hq8 = TQ.quad_dims(shape)[2]
    out = []
    for k in range(4):
        a = (rng.standard_normal(shape) * (1e3 if k == 3 else 0.1)).astype(np.float32)
        if k >= 2:
            a *= fluid
        q = TQ.to_quad(torch.from_numpy(a), shape)
        q = torch.nn.functional.pad(q, (0, 0, H, Hq8s - Hq8 + H))
        out.append(q[:, jy * P : jy * P + P + 2 * H].contiguous().to(device))
    ec = (rng.standard_normal((P + 2 * H, W)) * 0.1).astype(np.float32)
    out.append(torch.from_numpy(ec).to(device))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,mdy", [(128, 64, 4), (2048, 256, 4)])
def test_step_shard_kernels_match_plain_on_card(cuda_device, nx, ny, mdy):
    case = make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid", dtype=torch.float32,
                                    device="cpu")
    shape, g = case.grid.shape, case.grid
    step_i, inlet_j = step_rect_params(g)
    _, P, W = TQ.quad_shard_dims(shape, mdy)
    loc, shard = (P + 2 * H, W), (P, mdy)
    coeffs = StencilCoeffs(dx=g.dx, dy=g.dy, dt=case.coeffs.dt, viscosity=1e-2)
    level0 = (shape, step_i, inlet_j, coeffs.idx2, coeffs.idy2, 1.0, 1, loc)
    carry = TSQ.make_quad_step_corr_predictor_source(shape, coeffs, step_i, inlet_j, 1.0,
                                                     shard=shard)
    pre = TSQ.make_quad_step_pre_smooth_restrict(*level0, device=cuda_device, shard=shard)
    post = TSQ.make_quad_step_post_prolong_smooth(*level0, device=cuda_device, shard=shard)
    kerns = (TSQ.SHARD_STEP_CARRY, TSQ.SHARD_STEP_PRE, TSQ.SHARD_STEP_POST)
    fluid = np.asarray(g.fluid, dtype=np.float32)
    for jy in range(mdy):
        us, vs, p, b, ec = _blocks(shape, mdy, jy, cuda_device, seed=nx + jy, fluid=fluid)
        rb = jy * P - H
        before = [k.launches for k in kerns]
        pairs = [(carry(rb, us, vs, p), carry.plain(rb, us, vs, p)),
                 (pre(rb, p, b), pre.plain(rb, p, b)),
                 (post(rb, p, b, ec), post.plain(rb, p, b, ec))]
        torch.cuda.synchronize()
        assert [k.launches for k in kerns] == [x + 1 for x in before]
        for got, want in pairs:
            for a, w in zip(got, want, strict=True):
                assert torch.equal(a, w), (jy, tuple(a.shape))


def _level0_ops(nx, ny, mdy, device, tile):
    """The step's shard pre and post kernels (V(1,1)) on an mdy-way mesh of
    nx x ny under ``tile`` (None: LEVEL0_TILES'), and the field's shape
    and fluid mask."""
    case = make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid", dtype=torch.float32,
                                    device="cpu")
    shape, g = case.grid.shape, case.grid
    _, P, W = TQ.quad_shard_dims(shape, mdy)
    coeffs = StencilCoeffs(dx=g.dx, dy=g.dy, dt=case.coeffs.dt, viscosity=1e-2)
    level0 = (shape, *step_rect_params(g), coeffs.idx2, coeffs.idy2, 1.0, 1, (P + 2 * H, W))
    pre = TSQ.make_quad_step_pre_smooth_restrict(*level0, device=device, shard=(P, mdy))
    post = TSQ.make_quad_step_post_prolong_smooth(*level0, device=device, shard=(P, mdy))
    if tile is not None:
        pre._tile_plan = PL.level0_plan(pre.qshape, 1, False, masked=True, block=True, tile=tile)
        post._tile_plan = PL.level0_plan(post.qshape, 1, True, masked=True, block=True, tile=tile)
    return pre, post, shape, np.asarray(g.fluid, dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,mdy,tile", LEVEL0_CASES)
def test_step_shard_level0_tiles_match_plain_bit_for_bit(cuda_device, nx, ny, mdy, tile):
    pre, post, shape, fluid = _level0_ops(nx, ny, mdy, cuda_device, tile)
    P = TQ.quad_shard_dims(shape, mdy)[1]
    for jy in range(mdy):
        _, _, p, b, ec = _blocks(shape, mdy, jy, cuda_device, seed=3 * nx + jy, fluid=fluid)
        rb = jy * P - H
        before = (TSQ.SHARD_STEP_PRE.launches, TSQ.SHARD_STEP_POST.launches)
        pairs = [(pre(rb, p, b), pre.plain(rb, p, b)),
                 (post(rb, p, b, ec), post.plain(rb, p, b, ec))]
        torch.cuda.synchronize()
        assert (TSQ.SHARD_STEP_PRE.launches, TSQ.SHARD_STEP_POST.launches) == (
            before[0] + 1, before[1] + 1)
        for got, want in pairs:
            for a, w in zip(got, want, strict=True):
                assert torch.equal(a, w), (jy, tuple(a.shape), float((a - w).abs().max()))
    if tile == (1000, 5000):
        assert (post._tile_plan.grid_x, post._tile_plan.grid_y) == (1, 1)


@pytest.mark.cuda
def test_step_shard_level0_device_operations_a_call(cuda_device):
    # shard 1's block of the 2048x256 step's 4-shard mesh at V(1,1), counted
    # in a fresh process (python -m cfd_tpu_torch.time_level0), as
    # chip_smoke.py counts it: a process's later torch.profiler traces have
    # come back without device events on the H100 machine, its first has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_level0", "cardtest",
                          "--only", "16f-pre,16f-post", "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [r["row"] for r in lines] == ["16f-pre", "16f-post"]
    for r, kernel in zip(lines, ("step_pre_kernel", "step_post_kernel")):
        assert r["launches_a_call"] == 1 and kernel in r["ops"][0], r


def _run(sq, steps):
    st, iters = sq.initial_state(), []
    for _ in range(steps):
        st, d = sq.step(st)
        iters.append(int(d["poisson_iters"]))
    return iters, sq.logical(st)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,mdy", [(512, 64, 4), (32, 8, 2)])
def test_sharded_step_card_vs_cpu(cuda_device, nx, ny, mdy):
    out = {}
    for dev in ("cuda", "cpu"):
        # the per-kernel case: 32x8 has too few levels for the whole-solve,
        # which the sharded engine does not run either
        case = make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid",
                                        dtype=torch.float32, tolerance_factor=1e-6,
                                        abs_tol=0.0, mg_overrides={"whole_solve": False},
                                        device=dev)
        out[dev] = _run(ShardedQuadProjection(case, make_mesh(mdy, device=dev),
                                              tol_factor=1e-6), 5)
    assert out["cuda"][0] == out["cpu"][0]
    for name in ("u", "v", "p"):
        a, w = getattr(out["cuda"][1], name).cpu(), getattr(out["cpu"][1], name)
        assert float((a - w).abs().max()) <= 5e-5 * max(float(w.abs().max()), 1.0), name
