"""The one-launch tile carries of the channel and the backward step (rows
8a, 8a+, 9a, 9a+, 16d, 16d+, 16f, 16f+: csrc/quad_stage.cu
channel_carry_kernel, csrc/step_stage.cu step_carry_kernel and their sum
launch, on csrc/carry_tile.cuh) against their plain PyTorch twins on the
card: at one tile covering the whole grid (a plan of the field's own size,
kernels/plan.py carry_plan's ``tile``), at shapes whose tiles straddle the
inlet column, the outlet columns, the walls and the array's edge, with
tiles that lie wholly in the padding columns (the padding path), with
interior tiles and ragged tiles; the step's corner (i = step_i, j =
inlet_j) on a tile corner, inside a tile, and one cell outside a tile's
corrected box; and on the first, a middle and the last shard's local block
of a 4-shard mesh (the step's corner row on shard 1's first own row).

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_carry_tile_flows_cuda.py

Limits: error 0. The tiles run the per-cell bodies' float32 operations in
order on the same operands (--fmad=false), the maxima are exact and the
source sum folds in the twin's order, so every output is held bit for bit
(torch.equal), halo rows of a shard's block included; the sum's count is
back at 0 after every call."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.ops.stencil import StencilCoeffs

H = TQ.DEV_HALO
MDY = 4
WHOLE = "whole"  # a plan of one tile over the whole field
# (nx, ny, tile): one tile ((4, 8, 128)); CARRY_TILES' tile (16 x 32) with
# every tile on an edge or wholly in the padding columns ((4, 24, 128), a
# ragged tile row); the outlet column inside a tile, interior tiles and
# padding columns ((4, 56, 256)); ragged tiles at 5 x 24
CHANNEL_CASES = [(126, 14, WHOLE), (96, 32, None), (300, 110, None), (300, 110, (5, 24))]
# the step's (nx, ny, tile), step_i = nx / 4, inlet_j = ny / 2 (the factory's
# geometry): one tile; every tile on an edge or in the padding; the corner
# (plane row 16, plane column 64) on a tile corner at CARRY_TILES' 8 x 32,
# with interior tiles; the corner inside a 5 x 24 tile; at 512x66 (inlet_j
# 33) and 8 x 33 tiles, tile column 2's corrected box starts one column
# east of step_i and tile row 1's ends one row below inlet_j; ragged 16 x 32
STEP_CASES = [(126, 14, WHOLE), (96, 32, None), (512, 64, None), (512, 64, (5, 24)),
              (512, 66, (8, 33)), (300, 110, (16, 32))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fields(shape, n, device, seed):
    """Seeded quad fields (us, vs, p[, p_prev]) on ``device``; the
    pressure-like fields zero on the ghost ring."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k >= 2:
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(TQ.to_quad(torch.from_numpy(a), shape).to(device))
    return out


def _set_tile(op, flow, tile):
    """Give ``op`` the plan of ``tile`` (WHOLE: one tile over its field)
    before its first launch."""
    if tile is None:
        return
    _, Hq8, Wqa = op.qshape
    op._tile_plan = PL.carry_plan(flow, op.qshape, tile=(Hq8, Wqa) if tile == WHOLE else tile)
    if tile == WHOLE:
        assert (op._tile_plan.grid_x, op._tile_plan.grid_y) == (1, 1)


def _equal(got, want):
    assert len(got) == len(want)
    for k, (a, w) in enumerate(zip(got, want, strict=True)):
        assert torch.equal(a, w), (k, float((a - w).abs().max()))


def _dts(device):
    return torch.tensor([0.8e-3, 1.1e-3], device=device)


def _channel(shape, adaptive, **kw):
    nx, ny = shape[1] - 2, shape[0] - 2
    c = StencilCoeffs(dx=8.0 / nx, dy=2.0 / ny, dt=1e-3, viscosity=1e-2)
    return TQ.make_quad_channel_corr_predictor_source(shape, c, 1.0, adaptive=adaptive, **kw)


def _step(shape, adaptive, **kw):
    nx, ny = shape[1] - 2, shape[0] - 2
    c = StencilCoeffs(dx=8.0 / nx, dy=2.0 / ny, dt=1e-3, viscosity=1e-2)
    return TS.make_quad_step_corr_predictor_source(shape, c, nx // 4, ny // 2, 1.0,
                                                   adaptive=adaptive, **kw)


def _check_carry(op, kern, args):
    """Two calls against the twin, bit for bit, two launches, the count at
    0."""
    before = kern.launches
    got, want = op(*args), op.plain(*args)
    again = op(*args)  # the sum's count was left at 0: the same sum again
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    _equal(got, want)
    _equal(again, got)
    assert int(op._sum_counts[str(got[0].device)]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("nx,ny,tile", CHANNEL_CASES)
def test_channel_carry_tiles_bit_identical(cuda_device, nx, ny, tile, adaptive):
    shape = (ny + 2, nx + 2)
    op = _channel(shape, adaptive)
    _set_tile(op, "channel", tile)
    fields = _fields(shape, 4, cuda_device, seed=nx + ny)
    kern = TQ.CHANNEL_CARRY_ADAPTIVE if adaptive else TQ.CHANNEL_CARRY
    _check_carry(op, kern, ((_dts(cuda_device),) if adaptive else ()) + tuple(fields))


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("nx,ny,tile", STEP_CASES)
def test_step_carry_tiles_bit_identical(cuda_device, nx, ny, tile, adaptive):
    shape = (ny + 2, nx + 2)
    op = _step(shape, adaptive)
    _set_tile(op, "step", tile)
    fields = _fields(shape, 3, cuda_device, seed=nx + 3 * ny)
    kern = TS.STEP_CARRY_ADAPTIVE if adaptive else TS.STEP_CARRY
    _check_carry(op, kern, ((_dts(cuda_device),) if adaptive else ()) + tuple(fields))


def _blocks(fields, P, jy):
    Hq8s = P * MDY
    return [torch.nn.functional.pad(f, (0, 0, H, Hq8s - f.shape[1] + H))[
        :, jy * P : jy * P + P + 2 * H].contiguous() for f in fields]


@pytest.mark.cuda
@pytest.mark.parametrize("jy", [0, 1, MDY - 1])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("kind", ["channel", "step"])
def test_shard_carry_tiles_bit_identical(cuda_device, kind, adaptive, jy):
    """A shard's block bit for bit against the twin, halo rows included, its
    own rows against the whole-field kernel's, and the sum's count back at
    0 (rows 16d, 16d+ at 256x128; 16f, 16f+ at 512x64, where the corner's
    plane row 16 is shard 1's first own row)."""
    nx, ny = (256, 128) if kind == "channel" else (512, 64)
    shape = (ny + 2, nx + 2)
    _, P, _ = TQ.quad_shard_dims(shape, MDY)
    if kind == "channel":
        make = lambda **kw: _channel(shape, adaptive, **kw)
        kern = TQ.SHARD_CHANNEL_CARRY_ADAPTIVE if adaptive else TQ.SHARD_CHANNEL_CARRY
        fields = _fields(shape, 4, cuda_device, seed=jy)
        n_fields = 4  # us', vs', b, guess
    else:
        assert P == 16 and (ny // 2) // 2 == P  # the corner row on shard 1
        make = lambda **kw: _step(shape, adaptive, **kw)
        kern = TS.SHARD_STEP_CARRY_ADAPTIVE if adaptive else TS.SHARD_STEP_CARRY
        fields = _fields(shape, 3, cuda_device, seed=jy)
        n_fields = 3  # us', vs', b
    op, whole = make(shard=(P, MDY)), make()
    dts = (_dts(cuda_device),) if adaptive else ()
    blocks = _blocks(fields, P, jy)
    before = kern.launches
    got = op(jy * P - H, *dts, *blocks)
    want = op.plain(jy * P - H, *dts, *blocks)
    single = whole(*dts, *fields)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _equal(got, want)
    assert int(op._sum_counts[str(got[0].device)]) == 0
    Hq8 = fields[0].shape[1]
    own = min(P, Hq8 - jy * P)
    for a, w in zip(got[:n_fields], single[:n_fields]):
        if own > 0:
            assert torch.equal(a[:, H : H + own], w[:, jy * P : jy * P + own])
