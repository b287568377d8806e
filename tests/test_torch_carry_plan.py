"""The host-side launch plan of the one-launch carries (kernels/plan.py
carry_plan: the cavity's, the channel's, the step's and Rayleigh-Benard's
tile kernels, csrc/carry_tile.cuh), on the CPU: at the four main shapes,
the shard blocks of the 4-shard meshes, the CPU slice sizes and shapes
whose rows or columns are not a multiple of the tile, every quad cell lies
in exactly one tile's own region, the halo covers the flow's dependency
radius, a block's buffers fit its shared memory and the grid is the tile
count.

The tiles' path rules, mirrored in plain Python and held against a
brute-force scan: the step's interior path (csrc/step_stage.cu
step_carry_kernel: tile::interior and tile::misses_corner on the box of
its corrected fields) at the bench geometry, the CPU slice's and shard
blocks, and the padding path's premise (tile::outside: the channel's and
the step's plain twins give exactly 0 for us', vs' and b outside the
domain's ghost ring)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.kernels.quad import quad_shape
from cfd_tpu_torch.ops.stencil import StencilCoeffs

torch.set_num_threads(1)

FLOWS = ["cavity", "channel", "step", "rb"]
QSHAPES = {
    "cavity-2048": quad_shape((2050, 2050)),
    "channel-rb-1536x512": quad_shape((514, 1538)),
    "step-2048x256": quad_shape((258, 2050)),
    "shard-cavity-2048": (4, 280, 1152),
    "shard-channel-rb-1536x512": (4, 88, 896),
    "shard-step-2048x256": (4, 56, 1152),
    "cpu-cavity-32": quad_shape((34, 34)),
    "cpu-rb-48x16": quad_shape((18, 50)),
    "cpu-channel-64x32": quad_shape((34, 66)),
    "cpu-step-64x16": quad_shape((18, 66)),
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


# ---------------------------------------------------------------- path rules

# the box of the channel's and the step's corrected fields around a tile's
# own region, in logical rows and columns (csrc/quad_stage.cu,
# csrc/step_stage.cu: tile::around(t, 2, 1, 3, 1))
A_SOUTH, A_NORTH, A_WEST, A_EAST = 2, 1, 3, 1


def corrected_box(tile, row0):
    """Global logical rows [j0, j1) and columns [i0, i1) of a tile's box A
    on a block whose plane row 0 is global plane row ``row0``."""
    r0, c0, rows, cols = tile
    return (2 * (r0 + row0) - A_SOUTH, 2 * (r0 + row0 + rows) + A_NORTH,
            2 * c0 - A_WEST, 2 * (c0 + cols) + A_EAST)


def mirror_interior(box, ny, nx, Hq8, row0, step_i, inlet_j):
    """The kernel's test (carry_tile.cuh interior and misses_corner): the
    box inside the domain's rows [1, ny - 1] x columns [1, nx - 1] and the
    block's rows, and off the positions i <= step_i, j >= inlet_j."""
    j0, j1, i0, i1 = box
    inside = j0 >= 1 and j1 - 1 <= ny - 1 and i0 >= 1 and i1 - 1 <= nx - 1
    in_block = j0 - 2 * row0 >= 0 and j1 - 2 * row0 <= 2 * Hq8
    return inside and in_block and (i0 > step_i or j1 - 1 < inlet_j)


def plain_positions(ny, nx, step_i, inlet_j, lo, hi_j, hi_i):
    """[j - lo, i - lo] True where the step's per-cell bodies
    (csrc/step_carry.cuh) apply the formulas with no mask or BC: u and v
    valid, a fluid cell, and no rule of step_u or step_v (inlet and outlet
    columns, wall and ghost rows, interface faces), by brute force over
    logical rows lo..hi_j - 1 and columns lo..hi_i - 1."""
    j, i = np.meshgrid(np.arange(lo, hi_j), np.arange(lo, hi_i), indexing="ij")
    solid_u = (i < step_i) & (j > inlet_j)
    solid = (i <= step_i) & (j > inlet_j)
    u_valid = (j >= 1) & (j <= ny) & (i >= 1) & (i <= nx - 1) & ~solid_u
    v_valid = (j >= 1) & (j <= ny - 1) & (i >= 1) & (i <= nx) & ~solid
    fluid = (j >= 1) & (j <= ny) & (i >= 1) & (i <= nx) & ~solid
    u_rule = (((j == 0) | (j == ny + 1)) & (i <= nx)) | (
        (j >= 1) & (j <= ny) & ((i == 0) | (i == nx))) | (
        (i == step_i) & (j > inlet_j) & (j <= ny))
    v_rule = (((i == 0) | (i == nx + 1)) & (j <= ny)) | (
        ((j == 0) | (j == ny)) & (i >= 1) & (i <= nx)) | (
        (j == inlet_j) & (i >= 1) & (i <= step_i))
    return u_valid & v_valid & fluid & ~u_rule & ~v_rule


# (ny, nx) of the step: the bench geometry and the CPU slice's, with the
# factory's step at a quarter of the length and the inlet half the height
# (cases/backwards_step.py: step_i = nx / 4, inlet_j = ny / 2)
STEP_GEOMETRIES = {"bench-2048x256": (256, 2048), "cpu-64x16": (16, 64),
                   "card-512x64": (64, 512)}


def step_blocks(ny, nx, shards):
    """(qshape, row0) of the whole field and of every shard's local block
    of a ``shards``-way plane-row mesh (P + 16 rows at row0 = jy P - 8)."""
    qshape = quad_shape((ny + 2, nx + 2))
    out = [(qshape, 0)]
    if shards:
        _, P, W = TQ.quad_shard_dims((ny + 2, nx + 2), shards)
        out += [((4, P + 2 * TQ.DEV_HALO, W), jy * P - TQ.DEV_HALO) for jy in range(shards)]
    return out


@pytest.mark.parametrize("tile", [None, (8, 32), (16, 64), (5, 24)])
@pytest.mark.parametrize("which", sorted(STEP_GEOMETRIES))
def test_step_interior_rule_matches_a_brute_force_scan(which, tile):
    """A tile takes the step's unmasked path exactly when every position of
    its corrected box is plain (no mask, no BC) and inside its block: the
    kernel's box test equals the scan at CARRY_TILES' tile and at shapes
    that put the corner (i = step_i, j = inlet_j) on a tile corner, inside a
    tile and off the tile grid, on the whole field and on 4-shard blocks."""
    ny, nx = STEP_GEOMETRIES[which]
    step_i, inlet_j = nx // 4, ny // 2
    lo = -2 * TQ.DEV_HALO - 8
    for qshape, row0 in step_blocks(ny, nx, 4 if which != "cpu-64x16" else 0):
        _, Hq8, Wqa = qshape
        plain = plain_positions(ny, nx, step_i, inlet_j, lo, 2 * (Hq8 + row0) + 8,
                                2 * Wqa + 8)
        plan = PL.carry_plan("step", qshape, tile=tile)
        kinds = {True: 0, False: 0}
        for t in PL.carry_tiles(plan, qshape):
            j0, j1, i0, i1 = corrected_box(t, row0)
            in_block = j0 - 2 * row0 >= 0 and j1 - 2 * row0 <= 2 * Hq8
            scan = in_block and bool(plain[j0 - lo : j1 - lo, i0 - lo : i1 - lo].all())
            mirror = mirror_interior((j0, j1, i0, i1), ny, nx, Hq8, row0, step_i, inlet_j)
            assert mirror == scan, (which, qshape, row0, t)
            kinds[mirror] += 1
        if which == "bench-2048x256" and row0 == 0:
            assert kinds[True] > 0 and kinds[False] > 0


def test_step_corner_lies_on_a_tile_corner_at_the_bench_tile():
    """At 2048x256 the corner (i = 512, j = 128: plane row 64, plane column
    256) is the south-west cell of one tile of CARRY_TILES' 8 x 32, and
    every tile whose corrected box reaches it takes the masked path."""
    ny, nx = STEP_GEOMETRIES["bench-2048x256"]
    step_i, inlet_j = nx // 4, ny // 2
    qshape = quad_shape((ny + 2, nx + 2))
    plan = PL.carry_plan("step", qshape)
    assert (plan.rows, plan.cols) == PL.CARRY_TILES["step"] == (8, 32)
    assert (inlet_j // 2) % plan.rows == 0 and (step_i // 2) % plan.cols == 0
    for t in PL.carry_tiles(plan, qshape):
        j0, j1, i0, i1 = corrected_box(t, 0)
        if j0 <= inlet_j < j1 and i0 <= step_i < i1:
            assert not mirror_interior((j0, j1, i0, i1), ny, nx, qshape[1], 0, step_i,
                                       inlet_j)


def mirror_outside(tile, row0, ny, nx):
    """The kernels' padding test (carry_tile.cuh outside): the tile's own
    cells all lie outside the logical rows [0, ny + 1] or columns [0, nx +
    1]."""
    r0, c0, rows, _ = tile
    j0 = 2 * (r0 + row0)
    return 2 * c0 > nx + 1 or j0 > ny + 1 or j0 + 2 * rows - 1 < 0


def _logical_iota(qshape, row0):
    _, Hq8, Wqa = qshape
    J, I = np.meshgrid(np.arange(Hq8), np.arange(Wqa), indexing="ij")
    j = np.stack([2 * (J + row0) + (q >> 1) for q in range(4)])
    i = np.stack([2 * I + (q & 1) for q in range(4)])
    return j, i


@pytest.mark.parametrize("flow", ["channel", "step"])
@pytest.mark.parametrize("block", [False, True])
def test_padding_path_premise_the_twins_give_zero_outside(flow, block):
    """The padding path writes 0 for us', vs' and b (and the channel's
    guess 2p - p_prev) without loading: the plain twins, on seeded inputs
    nonzero everywhere, give exactly +0 at every quad cell outside the
    domain's ghost ring, and the tiles the kernel skips (mirror_outside at
    CARRY_TILES' tile and at 8 x 32) own only such cells."""
    nx, ny = 64, 16 if flow == "step" else 32
    shape = (ny + 2, nx + 2)
    c = StencilCoeffs(dx=8.0 / nx, dy=2.0 / ny, dt=1e-3, viscosity=1e-2)
    if flow == "channel":
        op = TQ.make_quad_channel_corr_predictor_source(
            shape, c, 1.0, shard=(8, 4) if block else None)
    else:
        op = TS.make_quad_step_corr_predictor_source(
            shape, c, nx // 4, ny // 2, shard=(8, 4) if block else None)
    qshape = op.qshape
    rng = np.random.default_rng(17)
    fields = [torch.from_numpy(rng.standard_normal(qshape).astype(np.float32) + 2.0)
              for _ in range(4 if flow == "channel" else 3)]
    row0 = -TQ.DEV_HALO if block else 0  # shard 0: its halo rows lie below the field
    out = op(row0, *fields) if block else op(*fields)
    j, i = _logical_iota(qshape, row0)
    outside = (j < 0) | (j > ny + 1) | (i > nx + 1)
    assert outside.any() and (~outside).any()
    for t in out[:3]:  # us', vs', b
        a = t.numpy()
        assert (a[outside] == 0).all() and not np.signbit(a[outside]).any()
    if flow == "channel":
        want = 2.0 * fields[2] - fields[3]
        assert torch.equal(out[3], want)
    for tile in [None, (8, 32)]:
        plan = PL.carry_plan(flow, qshape, tile=tile)
        skipped = 0
        for t in PL.carry_tiles(plan, qshape):
            r0, c0, rows, cols = t
            own = outside[:, r0 : r0 + rows, c0 : c0 + cols]
            assert mirror_outside(t, row0, ny, nx) == bool(own.all()), t
            skipped += mirror_outside(t, row0, ny, nx)
        assert skipped > 0
