"""The backward step's CUDA kernels against their plain PyTorch twins on the
card: the masked carry and corrector (csrc/step_stage.cu), the masked
finest-level pre and post kernels (csrc/step_vcycle.cu), the full-2D coarse
pairs (csrc/rb_smoother.cu) and the masked whole-solve (csrc/whole_solve.cu),
at 256x64 and at 320x48 (quad planes of 25 logical rows, padded to 32), on
seeded inputs; and the slice's card run against its CPU run on both solve
paths.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_step_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so fields agree within 1e-5 of their scale
(expected: bit for bit), the whole-solve's cycle count equals its twin's
and the per-kernel composition's, and card and CPU take equal cycles. The finest-level pre and post kernels
(one launch of shared-memory tiles each, the post's residual folded by
its last block) are held to their twins bit for bit (torch.equal) under
kernels/plan.py LEVEL0_TILES' tile, under tiles that do not divide the
field and under one larger than it, with their device operations a call
counted by torch.profiler; the masked whole-solve, which runs the same
tile bodies, bit for bit too."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import rb_smoother as TR
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.kernels.mg_tail import level_masks
from cfd_tpu_torch.kernels.quad import to_quad
from cfd_tpu_torch.poisson.multigrid import step_rect_params
from cfd_tpu_torch.profile_step import device_ops_a_call
from cfd_tpu_torch.solver import Simulation

SIZES = [(256, 64), (320, 48)]
# (nx, ny, tile) of the finest-level tile kernels: LEVEL0_TILES' tile,
# tiles that do not divide the field (ragged rows and columns), a large
# one, and one larger than the whole 64x16 field (cut to it: one tile)
LEVEL0_CASES = [(256, 64, None), (256, 64, (5, 24)), (320, 48, (3, 7)),
                (320, 48, (16, 64)), (64, 16, (1000, 5000))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(nx, ny, device, **kw):
    return make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid", dtype=torch.float32,
                                    tolerance_factor=1e-5, abs_tol=0.0, device=device, **kw)


def _quad(case, seed, scale=0.1, fluid_only=False):
    g = case.grid
    a = (np.random.default_rng(seed).standard_normal(g.shape) * scale).astype(np.float32)
    if fluid_only:
        a *= g.fluid
    return to_quad(torch.from_numpy(a), g.shape).to(case.device)


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["carry", "corrector"])
@pytest.mark.parametrize("nx,ny", SIZES)
def test_step_stage_kernel_matches_plain_on_card(cuda_device, name, nx, ny):
    case = _case(nx, ny, cuda_device)
    carry, corr = case.step_kernels
    op, counter = (carry, TS.STEP_CARRY) if name == "carry" else (corr, TS.STEP_CORRECTOR)
    args = [_quad(case, nx), _quad(case, nx + 1), _quad(case, nx + 2, fluid_only=True)]
    before = counter.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b in zip(got, want, strict=True):
        _close(a, b)
    if name == "carry":  # the fixed-order source sum: equal to the twin's
        assert float(got[3]) == float(want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", SIZES)
def test_step_vcycle_kernels_match_plain_on_card(cuda_device, nx, ny):
    case = _case(nx, ny, cuda_device, mg_overrides={"whole_solve": False})
    mg = case.poisson_solve
    p = _quad(case, 1, 1.0, fluid_only=True)
    b = _quad(case, 2, 1e2, fluid_only=True)
    before = (TS.STEP_PRE.launches, TS.STEP_POST.launches)
    got, want = mg.pre0(p, b), mg.pre0.plain(p, b)
    for a, w in zip(got, want, strict=True):
        _close(a, w)
    ec = torch.zeros(mg.pre0.coarse_shape, device=cuda_device)
    ec[1 : ny // 2 + 1, 1 : nx // 2 + 1] = torch.randn(ny // 2, nx // 2, device=cuda_device,
                                                       generator=torch.Generator(
                                                           cuda_device).manual_seed(3))
    got, want = mg.post0(p, b, ec), mg.post0.plain(p, b, ec)
    torch.cuda.synchronize()
    assert (TS.STEP_PRE.launches, TS.STEP_POST.launches) == (before[0] + 1, before[1] + 1)
    for a, w in zip(got, want, strict=True):
        _close(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", SIZES)
def test_full_2d_pairs_match_plain_on_card(cuda_device, nx, ny):
    case = _case(nx, ny, cuda_device, mg_overrides={"whole_solve": False})
    mg = case.poisson_solve
    for k, lv in enumerate(mg.levels[:-1]):
        _, active = level_masks(lv, cuda_device)
        gen = torch.Generator(cuda_device).manual_seed(k)
        pp = torch.randn(lv.shape, device=cuda_device, generator=gen) * 0.1 * active
        bb = torch.randn(lv.shape, device=cuda_device, generator=gen) * 1e2 * active
        for op in (mg.pre[k], mg.post[k]):
            assert op.full
            before = TR.RB_PAIRS_FULL.launches
            got, want = op(pp, bb), op.plain(pp, bb)
            torch.cuda.synchronize()
            assert TR.RB_PAIRS_FULL.launches == before + 1
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, w in zip(got, want, strict=True):
                _close(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", SIZES)
def test_step_whole_solve_matches_plain_on_card(cuda_device, nx, ny):
    case = _case(nx, ny, cuda_device)
    solve = case.poisson_solve
    assert isinstance(solve, TW.StepWholeSolve)
    g = case.grid
    b = np.where(g.fluid, np.random.default_rng(ny).standard_normal(g.shape), 0.0)
    b = np.where(g.fluid, b - b.sum() / g.n_fluid, 0.0).astype(np.float32)
    b4 = to_quad(torch.from_numpy(b), g.shape).to(cuda_device)
    p0 = torch.zeros_like(b4)
    before = TW.STEP_WHOLE_SOLVE.launches
    pk, ck, rk = solve(p0, b4)
    assert TW.STEP_WHOLE_SOLVE.launches == before + 1
    pp, cp, rp = solve.plain(p0, b4)
    pm, cm, rm = solve.mg(p0, b4)  # the per-kernel composition of the step's kernels
    assert ck == cp == cm and ck > 1
    _close(pk, pp)
    _close(pk, pm)
    assert rk == rp == rm
    grid = TW.launch_grid(masked=True)
    assert grid["blocks"] >= 1 and grid["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("whole_solve", [True, False])
def test_step_slice_card_matches_cpu(cuda_device, whole_solve):
    out = []
    for dev in ("cuda", "cpu"):
        case = _case(256, 64, dev, mg_overrides={"whole_solve": whole_solve},
                     print_interval=10)
        assert isinstance(case.poisson_solve, TW.StepWholeSolve) == whole_solve
        sim = Simulation(case, log=lambda m: None)
        st = sim._logical(sim.run(n_steps=10))
        out.append((sim.step_iters, st))
    (ig, sg), (ic, sc) = out
    assert ig == ic
    for name in ("u", "v", "p"):
        _close(getattr(sg, name).cpu(), getattr(sc, name), 5e-5)


def _level0_ops(case, n_pre, n_post, tile):
    """Fresh pre and post kernels of ``case`` at n_pre, n_post pairs, under
    ``tile`` (None: LEVEL0_TILES')."""
    g, mg = case.grid, case.poisson_solve
    consts = (g.shape, *step_rect_params(g), mg.pre0.idx2, mg.pre0.idy2, mg.pre0.omega)
    coarse = mg.pre0.coarse_shape
    pre = TS.make_quad_step_pre_smooth_restrict(*consts, n_pre, coarse, device=case.device)
    post = TS.make_quad_step_post_prolong_smooth(*consts, n_post, coarse, device=case.device)
    if tile is not None:
        pre._tile_plan = PL.level0_plan(pre.qshape, n_pre, False, masked=True, tile=tile)
        post._tile_plan = PL.level0_plan(post.qshape, n_post, True, masked=True, tile=tile)
    return pre, post


@pytest.mark.cuda
@pytest.mark.parametrize("n_post", [1, 2])
@pytest.mark.parametrize("nx,ny,tile", LEVEL0_CASES)
def test_step_level0_tiles_match_plain_bit_for_bit(cuda_device, nx, ny, tile, n_post):
    case = _case(nx, ny, cuda_device, mg_overrides={"whole_solve": False})
    pre, post = _level0_ops(case, 1, n_post, tile)
    p, b = _quad(case, 1, 1.0), _quad(case, 2, 1e2, fluid_only=True)
    ec = torch.randn(pre.coarse_shape, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(nx + n_post))
    before = (TS.STEP_PRE.launches, TS.STEP_POST.launches)
    pairs = [(pre(p, b), pre.plain(p, b)), (post(p, b, ec), post.plain(p, b, ec))]
    torch.cuda.synchronize()
    assert (TS.STEP_PRE.launches, TS.STEP_POST.launches) == (before[0] + 1, before[1] + 1)
    for got, want in pairs:
        for a, w in zip(got, want, strict=True):
            assert torch.equal(a, w), float((a - w).abs().max())
    if tile == (1000, 5000):
        assert (pre._tile_plan.grid_x, pre._tile_plan.grid_y) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_post", [1, 2])
def test_step_level0_device_operations_a_call(cuda_device, n_post):
    case = _case(256, 64, cuda_device, mg_overrides={"whole_solve": False})
    pre, post = _level0_ops(case, 1, n_post, None)
    p, b = _quad(case, 1, 1.0), _quad(case, 2, 1e2, fluid_only=True)
    ec = torch.zeros(pre.coarse_shape, device=cuda_device)
    ops = device_ops_a_call(lambda: pre(p, b))
    assert len(ops) == 1 and "step_pre_kernel" in ops[0], ops
    ops = device_ops_a_call(lambda: post(p, b, ec))
    assert len(ops) == 1 and "step_post_kernel" in ops[0], ops
    # the running max and the count are left at 0 for the next call
    assert post._max_acc[str(p.device)].tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", SIZES)
def test_step_whole_solve_bit_identical_on_card(cuda_device, nx, ny):
    case = _case(nx, ny, cuda_device)
    solve = case.poisson_solve
    b4 = _quad(case, ny + 7, 1e3, fluid_only=True)
    p0 = _quad(case, ny + 8, 0.1, fluid_only=True)
    pk, ck, rk = solve(p0, b4)
    pp, cp, rp = solve.plain(p0, b4)
    assert int(ck) == int(cp) and float(rk) == float(rp)
    assert torch.equal(pk, pp)
