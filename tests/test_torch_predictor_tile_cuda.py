"""The cavity's two non-carry predictor + source kernels on the card: row 6
(csrc/quad_stage.cu lid_predictor_source_kernel, the exact adaptive
controller's traced-dt stage on the quad layout) and row 11
(csrc/projection.cu predictor_source_kernel, the natural layout's), each
one launch of shared-memory tiles a call with no memset, against their
plain PyTorch twins (kernels/quad.py QuadPredictorSource.plain,
kernels/projection.py PredictorSource.plain) bit for bit (torch.equal):
at the 2048^2 cavity, at the 142^2 cavity of the auto rule (row 11, the
case's own op and fields), at two odd sizes (63^2 and 201 x 117 with dx !=
dy) and under tiles whose edges fall on the lid row, the ghost columns and
the padding; max|b| right on back-to-back calls; one device operation a
call, counted by torch.profiler in a child process (python -m
cfd_tpu_torch.time_carries, rows 6 and 11); and the cavity carry (rows 1,
1+), whose predictor and source stages row 6's tiles share, still
bit-identical to its twin.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_predictor_tile_cuda.py
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
from cfd_tpu_torch.kernels import projection as TP
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.seeded import seeded_fields

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _coeffs(ny, nx):
    dx, dy = 1.0 / nx, 1.0 / ny
    return StencilCoeffs(dx=dx, dy=dy, dt=0.2 * min(dx, dy), viscosity=1e-3, density=1.0)


def _noise(shape, seed):
    """Seeded noise on the card over the whole array, its padding included."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).cuda()


def _quad(ny, nx, lid=1.0):
    op = TQ.QuadPredictorSource((ny + 2, nx + 2), _coeffs(ny, nx), lid)
    dt = torch.tensor(1.1 * op.coeffs.dt, dtype=torch.float32, device="cuda")
    return op, (dt, *(_noise(op.qshape, [ny, nx, k]) for k in range(2)))


def _natural(ny, nx, lid=1.0):
    op = TP.PredictorSource((ny + 2, nx + 2), _coeffs(ny, nx), lid)
    return op, tuple(_noise(op.shape, [ny, nx, k, 11]) for k in range(2))


def _equal(op, args, kern):
    before = kern.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    for name, g, w in zip(("us", "vs", "b", "max|b|"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))
    return got


SIZES = [(2048, 2048, 1.0), (63, 63, 1.0), (117, 201, 1.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,lid", SIZES)
def test_row6_bit_identical_under_the_plan(cuda_device, ny, nx, lid):
    op, args = _quad(ny, nx, lid)
    _equal(op, args, TQ.PREDICTOR_SOURCE)
    assert (op._tile_plan.rows, op._tile_plan.cols) == tuple(
        min(a, b) for a, b in zip(PL.CARRY_TILES["cavity_predictor"], op.qshape[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,lid", SIZES)
def test_row11_bit_identical_under_the_plan(cuda_device, ny, nx, lid):
    op, args = _natural(ny, nx, lid)
    _equal(op, args, TP.PREDICTOR_SOURCE)


@pytest.mark.cuda
def test_row11_bit_identical_on_the_auto_rule_cavity(cuda_device):
    case = make_cavity_case(n_interior=142, poisson="multigrid", dtype=torch.float32,
                            tolerance_factor=1e-6, device="cuda")
    op = case.step_kernels[0]
    assert isinstance(op, TP.PredictorSource)  # n = 14 mod 16: the natural layout
    _equal(op, seeded_fields(case, 142)[:2], TP.PREDICTOR_SOURCE)


# tiles: at 64^2 (quad plane rows 0..32 and natural rows 0..65 hold the
# logical grid) ones that start or end a tile on the last interior row and
# column, the lid row, the east ghost column and the padding's first row
# and column; ragged ones; one tile over the whole field (row 6 at 30^2,
# row 11 at 64^2); at 2048^2 a tall and a wide one
QUAD_TILES = [(64, (16, 16)), (64, (8, 8)), (64, (11, 11)), (64, (3, 5)), (30, (16, 128)),
              (2048, (16, 64)), (2048, (4, 128))]
NATURAL_TILES = [(64, (13, 13)), (64, (11, 11)), (64, (8, 64)), (30, (4, 31)),
                 (64, (3, 5)), (64, (72, 128)), (2048, (32, 128)), (2048, (8, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile", QUAD_TILES)
def test_row6_bit_identical_under_other_tiles(cuda_device, n, tile):
    op, args = _quad(n, n)
    op._tile_plan = PL.carry_plan("cavity_predictor", op.qshape, tile)
    _equal(op, args, TQ.PREDICTOR_SOURCE)


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile", NATURAL_TILES)
def test_row11_bit_identical_under_other_tiles(cuda_device, n, tile):
    op, args = _natural(n, n)
    op._tile_plan = PL.natural_predictor_plan(op.shape, tile)
    _equal(op, args, TP.PREDICTOR_SOURCE)


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["6", "11"])
def test_max_b_back_to_back_with_no_memset(cuda_device, row):
    # three calls on three scalings of the inputs, queued without a
    # synchronisation: each max|b| its own (the last block moves the
    # running max out and leaves it 0 for the next launch)
    op, args = _quad(256, 256) if row == "6" else _natural(256, 256)
    head = args[:1] if row == "6" else ()
    fields = args[len(head):]
    inputs = [(*head, *(f * 10.0 ** k for f in fields)) for k in range(3)]
    got = [op(*a)[3] for a in inputs]
    torch.cuda.synchronize()
    for a, g in zip(inputs, got):
        assert torch.equal(g, op.plain(*a)[3])
    assert len({float(g) for g in got}) == 3
    assert int(TQ.max_acc(op, fields[0].device).abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["6", "11"])
def test_one_launch_a_call(cuda_device, row):
    # a fresh process: a process's later torch.profiler traces have come
    # back without device events on the H100 machine, its first has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_carries", "cardtest",
                          "--only", row, "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    assert [r["launches_a_call"] for r in lines] == [1], lines


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("adaptive", [False, True])
def test_rows_1_and_1plus_still_bit_identical(cuda_device, n, adaptive):
    case = make_cavity_case(n_interior=n, poisson="multigrid", dtype=torch.float32,
                            tolerance_factor=1e-6, device="cuda")
    g, c = case.grid, case.coeffs
    op = TQ.make_quad_corr_predictor_source(g.shape, c, adaptive=adaptive)
    fields = seeded_fields(case, n)
    args = ((torch.tensor([0.8 * c.dt, 1.1 * c.dt], dtype=torch.float32, device="cuda"),
             *fields) if adaptive else fields)
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want, strict=True)):
        assert torch.equal(a, b), (k, float((a - b).abs().max()))
