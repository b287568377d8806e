"""The cavity's fused-pre carry (row 7, csrc/quad_fused_pre.cu: one
cooperative launch of the carry's tiles, one grid barrier, the separable
pre tiles; kernels/plan.py fused_pre_plan) against its plain PyTorch twin
(kernels/quad.py QuadCorrPredictorSourceFusedPre.plain, the carry twin
then the pre twin) on the card, bit for bit (torch.equal): at 64^2,
256^2 and the main path's 2048^2 at n_pairs 1-3, under the plan's carry
tile and others (carry_plan's, ragged, one with edges on the last
interior row and column, one of a block an SM); max|b| right on
back-to-back calls with no memset; one device operation a call, counted
by torch.profiler in a child process (python -m
cfd_tpu_torch.time_carries); and 300 steps of the 2048^2 cavity with
``fuse_pre=True`` on the per-kernel solve, equal in cycles and bit for bit
to the per-kernel run.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_pre_tile_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_cavity_case
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.seeded import seeded_fields
from cfd_tpu_torch.solver import Simulation, make_step

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(n, **kw):
    return make_cavity_case(n_interior=n, poisson="multigrid", dtype=torch.float32,
                            tolerance_factor=1e-6, mg_overrides={"whole_solve": False},
                            device="cuda", **kw)


def _equal(op, fields):
    got, want = op(*fields), op.plain(*fields)
    torch.cuda.synchronize()
    for name, g, w in zip(("us'", "vs'", "b", "p1", "rc", "max|b|"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 256, 2048])
def test_fused_pre_bit_identical_under_the_plan(cuda_device, n):
    case = _case(n, fuse_pre=True)
    op = case.step_kernels[0]
    before = TQ.FUSED_PRE.launches
    _equal(op, seeded_fields(case, n))
    assert TQ.FUSED_PRE.launches == before + 1
    (plan, _), = op._ready.values()
    assert plan.blocks >= torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 3])
def test_fused_pre_bit_identical_at_other_pairs(cuda_device, n_pairs):
    case = _case(256, fuse_pre=True)
    op = case.step_kernels[0]
    pre = TQ.QuadPreSmoothRestrict(case.grid.shape, _problem(case), 1.15, n_pairs,
                                   op.pre.coarse_shape, device="cuda")
    _equal(TQ.QuadCorrPredictorSourceFusedPre(case.grid.shape, case.coeffs, pre),
           seeded_fields(case, n_pairs))


def _problem(case):
    from cfd_tpu_torch.poisson.multigrid import cavity_problem

    g = case.grid
    return cavity_problem(g.nx, g.ny, g.dx, g.dy)


# carry tiles: carry_plan's cavity tile (8 x 64, one block an SM), the
# whole step's (16 x 64), ragged ones, and at 64^2 11 x 11, whose tile
# rows and columns end on plane row and column 32, the last interior
# row's and column's
TILE_CASES = [(2048, (8, 64)), (2048, (16, 64)), (2048, (5, 24)), (256, (3, 5)),
              (64, (11, 11)), (64, (40, 20))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile", TILE_CASES)
def test_fused_pre_bit_identical_under_other_tiles(cuda_device, n, tile):
    case = _case(n, fuse_pre=True)
    op = case.step_kernels[0]
    fresh = TQ.QuadCorrPredictorSourceFusedPre(case.grid.shape, case.coeffs, op.pre)
    fresh._tile_plan = PL.fused_pre_plan(op.qshape, op.pre.n_pairs, tile=tile)
    _equal(fresh, seeded_fields(case, 5))


@pytest.mark.cuda
def test_fused_pre_max_b_back_to_back_with_no_memset(cuda_device):
    # three calls on three scalings of the inputs, queued without a
    # synchronisation: each max|b| its own (every block writes its slot
    # before the barrier, block 0 folds them after it)
    case = _case(256, fuse_pre=True)
    op = case.step_kernels[0]
    base = seeded_fields(case, 9)
    inputs = [tuple(f * 10.0 ** k for f in base) for k in range(3)]
    got = [op(*f)[5] for f in inputs]
    torch.cuda.synchronize()
    for f, g in zip(inputs, got):
        assert torch.equal(g, op.plain(*f)[5])
    assert len({float(g) for g in got}) == 3


@pytest.mark.cuda
def test_fused_pre_one_launch_a_call(cuda_device):
    # a fresh process: a process's later torch.profiler traces have come
    # back without device events on the H100 machine, its first has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_carries", "cardtest",
                          "--only", "7", "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    assert [r["launches_a_call"] for r in lines] == [1], lines


@pytest.mark.cuda
def test_fused_pre_300_steps_equal_the_per_kernel_run(cuda_device):
    on, off = _case(2048, fuse_pre=True), _case(2048)
    assert on.carry_fused_pre and not off.carry_fused_pre
    step_on, step_off = make_step(on), make_step(off)
    s_on = s_off = Simulation(on).initial_state()
    for k in range(300):
        s_on, d_on = step_on(s_on)
        s_off, d_off = step_off(s_off)
        assert d_on.poisson_iters == d_off.poisson_iters, k
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(s_on, name), getattr(s_off, name)), name
