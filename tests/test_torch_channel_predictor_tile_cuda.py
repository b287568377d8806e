"""The channel's two non-carry predictor + source kernels on the card: row
8c (csrc/quad_stage.cu channel_predictor_source_kernel, the quad layout's,
split_channel's second stage) and row 11's channel instance
(csrc/projection.cu channel_predictor_source_kernel, the natural layout's),
each one launch of shared-memory tiles and the carries' sum launch a call
with no memset, against their plain PyTorch twins (kernels/quad.py
QuadChannelPredictorSource.plain, kernels/projection.py
ChannelPredictorSource.plain) bit for bit (torch.equal, the sum of b
included): at the 1536x512 channel (quad (4, 264, 896), aligned (520,
1664), the cases' own ops), at 256x128, at an odd 93 x 31 with dx != dy
and under tiles whose edges fall on the inlet column, the outlet columns,
the wall rows and the padding; the sum right on back-to-back calls with the
op's count back at 0; two device operations a call, counted by
torch.profiler in a child process (python -m cfd_tpu_torch.time_carries,
rows 8c and 11-ch); and the channel carry (rows 8a, 8a+), whose arithmetic
(ChannelTile) row 8c's tiles call, still bit-identical to its twin.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_channel_predictor_tile_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import make_channel_case
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
    dx, dy = 4.0 / nx, 1.0 / ny
    return StencilCoeffs(dx=dx, dy=dy, dt=0.2 * min(dx, dy), viscosity=1e-2, density=1.0)


def _noise(shape, seed):
    """Seeded noise on the card over the whole array, its padding included."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).cuda()


def _quad(ny, nx, uin=1.0):
    op = TQ.QuadChannelPredictorSource((ny + 2, nx + 2), _coeffs(ny, nx), uin)
    return op, tuple(_noise(op.qshape, [ny, nx, k]) for k in range(2))


def _natural(ny, nx, uin=1.0):
    op = TP.ChannelPredictorSource((ny + 2, nx + 2), _coeffs(ny, nx), uin)
    return op, tuple(_noise(op.shape, [ny, nx, k, 11]) for k in range(2))


def _equal(op, args, kern):
    before = kern.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    for name, g, w in zip(("us", "vs", "b", "sum b"), got, want, strict=True):
        assert torch.equal(g, w), (name, float((g - w).abs().max()))
    return got


def _case(layout):
    return make_channel_case(nx=1536, ny=512, poisson="multigrid", tolerance_factor=1e-6,
                             abs_tol=0.0, dtype=torch.float32, layout=layout, device="cuda")


@pytest.mark.cuda
def test_row8c_bit_identical_on_the_channel(cuda_device):
    case = _case("quad")
    op = TQ.make_quad_channel_predictor_source(case.grid.shape, case.coeffs,
                                               case.step_kernels[0].uin)
    assert op.qshape == (4, 264, 896)
    _equal(op, seeded_fields(case, 8)[:2], TQ.CHANNEL_PREDICTOR_SOURCE)
    assert (op._tile_plan.rows, op._tile_plan.cols) == PL.CARRY_TILES["channel_predictor"]
    _equal(op, _noise((2, *op.qshape), 88).unbind(0), TQ.CHANNEL_PREDICTOR_SOURCE)


@pytest.mark.cuda
def test_row11_channel_bit_identical_on_the_channel(cuda_device):
    case = _case("aligned")
    op = case.step_kernels[0]
    assert isinstance(op, TP.ChannelPredictorSource) and op.shape == (520, 1664)
    _equal(op, seeded_fields(case, 11)[:2], TP.CHANNEL_PREDICTOR_SOURCE)
    assert (op._tile_plan.rows, op._tile_plan.cols) == PL.NATURAL_CHANNEL_PREDICTOR_TILE
    _equal(op, _noise((2, *op.shape), 111).unbind(0), TP.CHANNEL_PREDICTOR_SOURCE)


SIZES = [(128, 256, 1.0), (31, 93, 1.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,uin", SIZES)
def test_row8c_bit_identical_under_the_plan(cuda_device, ny, nx, uin):
    op, args = _quad(ny, nx, uin)
    _equal(op, args, TQ.CHANNEL_PREDICTOR_SOURCE)


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,uin", SIZES)
def test_row11_channel_bit_identical_under_the_plan(cuda_device, ny, nx, uin):
    op, args = _natural(ny, nx, uin)
    _equal(op, args, TP.CHANNEL_PREDICTOR_SOURCE)


# tiles: at 32 x 64 (quad plane row 16 and column 32 hold the wall row ny
# and the outlet column nx; natural rows 32, 33 and column 64, 65 the wall,
# the ghost row, the outlet columns, 34 and 66 the padding's first) ones
# that start or end a tile there; at 31 x 63 the ghost row and column nx +
# 1 on a tile's start; one (plane) row a tile; ragged ones; one tile over
# the whole field; at 1536x512 a tall and a wide one and the first sweep's
# starting tiles
QUAD_TILES = [(32, 64, (16, 32)), (31, 63, (16, 32)), (32, 64, (8, 8)), (32, 64, (1, 16)),
              (33, 65, (5, 7)), (30, 62, (16, 128)), (512, 1536, (32, 16)),
              (512, 1536, (8, 64)), (512, 1536, (16, 32))]
NATURAL_TILES = [(32, 64, (11, 13)), (32, 64, (8, 64)), (32, 64, (17, 33)), (32, 64, (1, 64)),
                 (30, 64, (3, 5)), (32, 64, (40, 128)), (512, 1536, (32, 128)),
                 (512, 1536, (8, 256)), (512, 1536, (16, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,tile", QUAD_TILES)
def test_row8c_bit_identical_under_other_tiles(cuda_device, ny, nx, tile):
    op, args = _quad(ny, nx)
    op._tile_plan = PL.carry_plan("channel_predictor", op.qshape, tile)
    _equal(op, args, TQ.CHANNEL_PREDICTOR_SOURCE)


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,tile", NATURAL_TILES)
def test_row11_channel_bit_identical_under_other_tiles(cuda_device, ny, nx, tile):
    op, args = _natural(ny, nx)
    op._tile_plan = PL.natural_predictor_plan(op.shape, tile, channel=True)
    _equal(op, args, TP.CHANNEL_PREDICTOR_SOURCE)


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["8c", "11-ch"])
def test_sum_back_to_back_with_no_memset(cuda_device, row):
    # three calls on three scalings of the inputs, queued without a
    # synchronisation: each sum its own (the sum's last block resets the
    # op's count for the next launch)
    op, args = _quad(128, 256) if row == "8c" else _natural(128, 256)
    inputs = [tuple(f * 10.0 ** k for f in args) for k in range(3)]
    got = [op(*a)[3] for a in inputs]
    torch.cuda.synchronize()
    for a, g in zip(inputs, got):
        assert torch.equal(g, op.plain(*a)[3])
    assert len({float(g) for g in got}) == 3
    assert int(TQ.sum_scratch(op, args[0])[1].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["8c", "11-ch"])
def test_a_tile_launch_and_a_sum_launch_a_call(cuda_device, row):
    # a fresh process: a process's later torch.profiler traces have come
    # back without device events on the H100 machine, its first has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_carries", "cardtest",
                          "--only", row, "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    assert [r["launches_a_call"] for r in lines] == [2], lines
    ops = lines[0]["ops"]
    assert any("channel_predictor_source_kernel" in o for o in ops), ops
    assert any("source_sum_kernel" in o for o in ops), ops
    assert not any("emset" in o for o in ops), ops


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(128, 256), (512, 1536)])
@pytest.mark.parametrize("adaptive", [False, True])
def test_rows_8a_and_8a_plus_still_bit_identical(cuda_device, ny, nx, adaptive):
    case = make_channel_case(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6,
                             abs_tol=0.0, dtype=torch.float32, device="cuda")
    g, c = case.grid, case.coeffs
    op = TQ.make_quad_channel_corr_predictor_source(g.shape, c, case.step_kernels[0].uin,
                                                    adaptive=adaptive)
    fields = seeded_fields(case, nx)
    args = ((torch.tensor([0.8 * c.dt, 1.1 * c.dt], dtype=torch.float32, device="cuda"),
             *fields) if adaptive else fields)
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want, strict=True)):
        assert torch.equal(a, b), (k, float((a - b).abs().max()))
