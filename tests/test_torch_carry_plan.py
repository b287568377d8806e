"""The host-side launch plan of the one-launch carries (kernels/plan.py
carry_plan: the cavity's and Rayleigh-Benard's tile kernels,
csrc/carry_tile.cuh), on the CPU: at the four main shapes, the shard
blocks of the 4-shard meshes, the CPU slice sizes and shapes whose rows or
columns are not a multiple of the tile, every quad cell lies in exactly
one tile's own region, the halo covers the flow's dependency radius, a
block's buffers fit its shared memory and the grid is the tile count."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels.quad import quad_shape

torch.set_num_threads(1)

FLOWS = ["cavity", "rb"]
QSHAPES = {
    "cavity-2048": quad_shape((2050, 2050)),
    "channel-rb-1536x512": quad_shape((514, 1538)),
    "step-2048x256": quad_shape((258, 2050)),
    "shard-cavity-2048": (4, 280, 1152),
    "shard-channel-rb-1536x512": (4, 88, 896),
    "cpu-cavity-32": quad_shape((34, 34)),
    "cpu-rb-48x16": quad_shape((18, 50)),
    "ragged-rows": (4, 20, 128),
    "ragged-both": (4, 37, 200),
    "smaller-than-a-tile": (4, 5, 3),
}


@pytest.mark.parametrize("which", sorted(QSHAPES))
@pytest.mark.parametrize("flow", FLOWS)
def test_carry_plan_covers_every_cell_once(flow, which):
    qshape = QSHAPES[which]
    _, Hq8, Wqa = qshape
    plan = PL.carry_plan(flow, qshape)
    hits = np.zeros((Hq8, Wqa), np.int32)
    tiles = list(PL.carry_tiles(plan, qshape))
    assert len(tiles) == plan.grid_x * plan.grid_y
    for r0, c0, rows, cols in tiles:
        assert 1 <= rows <= plan.rows and 1 <= cols <= plan.cols
        hits[r0 : r0 + rows, c0 : c0 + cols] += 1
    assert (hits == 1).all()  # each quad cell (all four planes) in one own region


@pytest.mark.parametrize("which", sorted(QSHAPES))
@pytest.mark.parametrize("flow", FLOWS)
def test_carry_plan_halo_and_shared_memory(flow, which):
    qshape = QSHAPES[which]
    _, Hq8, Wqa = qshape
    plan = PL.carry_plan(flow, qshape)
    assert 2 * plan.halo >= PL.CARRY_RADIUS[flow]  # logical rows of the chain
    assert plan.halo == -(-PL.CARRY_RADIUS[flow] // 2)
    floats = 4 * (plan.rows + 2 * plan.halo) * (plan.cols + 2 * plan.halo)
    assert plan.smem_bytes == 4 * PL.CARRY_BUFFERS[flow] * floats
    assert plan.smem_bytes <= PL.SMEM_MAX
    assert (plan.grid_x, plan.grid_y) == (-(-Wqa // plan.cols), -(-Hq8 // plan.rows))
    assert (plan.rows, plan.cols) == tuple(min(a, b) for a, b in
                                           zip(PL.CARRY_TILES[flow], (Hq8, Wqa)))
    assert list(plan.c_ints()) == [plan.rows, plan.cols, plan.halo, plan.smem_bytes,
                                   plan.grid_x, plan.grid_y]


@pytest.mark.parametrize("flow", FLOWS)
def test_carry_plan_of_one_tile_and_refusal(flow):
    """A tile of the whole field (the card tests' one-tile plan) covers it
    in one block; a tile whose buffers exceed a block's shared memory is
    refused."""
    qshape = (4, 8, 128)
    plan = PL.carry_plan(flow, qshape, tile=(8, 128))
    assert (plan.grid_x, plan.grid_y) == (1, 1)
    assert plan.smem_bytes <= PL.SMEM_MAX
    with pytest.raises(ValueError, match="shared"):
        PL.carry_plan(flow, (4, 264, 896), tile=(64, 256))
