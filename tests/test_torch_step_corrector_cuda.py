"""The backward step's corrector on the card (rows 9b and 9b+,
csrc/step_stage.cu step_corrector_kernel: one launch of one thread a plane
cell over all four quads, a test-free path on interior cells, no memset)
against its plain PyTorch twins (kernels/step_quad.py
QuadStepCorrector.plain, QuadStepCorrectorTraced.plain) bit for bit
(torch.equal, equal checksums): at the 2048x256 step, 512x64, 64x16 and an
odd 301x45, fixed and traced dt, under the plan's block and under every
block of the sweep that chose it (kernels/plan.py STEP_CORRECTOR_BLOCK);
one device operation a call, counted by torch.profiler in a child process
(python -m cfd_tpu_torch.time_carries, rows 9b and 9b+); and the step
carry (rows 9a, 9a+), whose arithmetic the corrector shares, still
bit-identical to its twin.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_step_corrector_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.poisson.multigrid import step_rect_params
from cfd_tpu_torch.seeded import seeded_fields

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _op(nx, ny, traced):
    """The step corrector at nx x ny with the case's rectangle (step_i =
    nx/4, inlet_j = ny/2 of the reference's 8 x 2 domain)."""
    dx, dy = 8.0 / nx, 2.0 / ny
    c = StencilCoeffs(dx=dx, dy=dy, dt=0.05 * min(dx, dy), viscosity=0.01, density=1.0)
    make = TS.QuadStepCorrectorTraced if traced else TS.QuadStepCorrector
    return make((ny + 2, nx + 2), c, int(2.0 / dx), int(1.0 / dy), 1.0)


def _args(op, seed, traced):
    """Seeded noise on the card over the whole arrays, their padding
    included (and dt = 0.8 dt for the traced instance)."""
    rng = np.random.default_rng(seed)
    fields = tuple(torch.from_numpy((rng.standard_normal(op.qshape) * 0.1).astype(np.float32))
                   .cuda() for _ in range(3))
    if not traced:
        return fields
    return (torch.tensor(0.8 * op.coeffs.dt, dtype=torch.float32, device="cuda"), *fields)


def _equal(op, args, traced):
    kern = TS.STEP_CORRECTOR_TRACED if traced else TS.STEP_CORRECTOR
    before = kern.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    for name, g, w in zip(("u", "v"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))
        assert float(g.double().sum()) == float(w.double().sum())


SIZES = [(2048, 256), (512, 64), (64, 16), (301, 45)]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("nx,ny", SIZES)
def test_bit_identical_under_the_plan(cuda_device, nx, ny, traced):
    op = _op(nx, ny, traced)
    _equal(op, _args(op, nx + ny, traced), traced)
    assert (op._tile_plan.rows, op._tile_plan.cols) == PL.STEP_CORRECTOR_BLOCK


# the blocks of the sweep (plane rows, plane columns); a ragged one, one
# thread a block and one of 1024 threads
SWEEP = [(1, 96), (1, 128), (1, 192), (1, 256), (1, 288), (1, 384), (1, 576), (2, 64),
         (2, 96), (2, 128), (4, 64), (8, 32), (7, 5), (1, 1), (1, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("nx,ny", [(2048, 256), (301, 45)])
@pytest.mark.parametrize("block", SWEEP)
def test_bit_identical_under_every_block_of_the_sweep(cuda_device, block, nx, ny, traced):
    op = _op(nx, ny, traced)
    op._tile_plan = PL.step_corrector_plan(op.qshape, block)
    _equal(op, _args(op, 3 * nx + ny, traced), traced)


@pytest.mark.cuda
def test_one_launch_a_call(cuda_device):
    # a fresh process: a process's later torch.profiler traces have come
    # back without device events on the H100 machine, its first has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_carries", "cardtest",
                          "--only", "9b,9b+", "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    assert [r["row"] for r in lines] == ["9b", "9b+"]
    assert [r["launches_a_call"] for r in lines] == [1, 1], lines


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("nx,ny", [(512, 64), (2048, 256)])
def test_rows_9a_and_9a_plus_still_bit_identical(cuda_device, nx, ny, adaptive):
    case = make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid", dtype=torch.float32,
                                    tolerance_factor=1e-6, device="cuda")
    g, c = case.grid, case.coeffs
    op = TS.make_quad_step_corr_predictor_source(g.shape, c, *step_rect_params(g),
                                                 adaptive=adaptive)
    fields = seeded_fields(case, nx)[:3]
    args = ((torch.tensor([0.8 * c.dt, 1.1 * c.dt], dtype=torch.float32, device="cuda"),
             *fields) if adaptive else fields)
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want, strict=True)):
        assert torch.equal(a, b), (k, float((a - b).abs().max()))
