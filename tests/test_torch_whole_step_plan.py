"""The host-side launch plan of the whole step (kernels/plan.py
whole_step_plan), on the CPU, for the four flavors at their main widths and
at small sizes: the carry's tile and halo, the shared memory (the largest
of the carry's tiles, the source sum's fold and the solve's), the grid-wide
barriers of the carry phases against csrc/whole_step.cu, and a mirror of
the cooperative blocks' walk over the tiles (csrc/carry_tile.cuh
each_tile): every quad cell is owned by exactly one tile."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels._build import CSRC

torch.set_num_threads(1)

# id: (factory, kwargs, the flow)
SHAPES = {
    "cavity-2048": (make_cavity_case, dict(n_interior=2048, poisson="multigrid",
                                           tolerance_factor=1e-6), "cavity"),
    "channel-1536x512": (make_channel_case, dict(nx=1536, ny=512, poisson="multigrid",
                                                 tolerance_factor=1e-6, abs_tol=0.0),
                         "channel"),
    "step-2048x256": (make_backwards_step_case, dict(nx=2048, ny=256, poisson="multigrid",
                                                     tolerance_factor=1e-6, abs_tol=0.0),
                      "step"),
    "rb-1536x512": (make_rayleigh_benard_case, dict(nx=1536, ny=512, rayleigh=1e6), "rb"),
    "cavity-256": (make_cavity_case, dict(n_interior=256, poisson="multigrid",
                                          tolerance_factor=1e-6), "cavity"),
    "channel-256x128": (make_channel_case, dict(nx=256, ny=128, poisson="multigrid",
                                                tolerance_factor=1e-6, abs_tol=0.0),
                        "channel"),
    "step-512x64": (make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid",
                                                   tolerance_factor=1e-6, abs_tol=0.0), "step"),
    "rb-256x128": (make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e5), "rb"),
    "cavity-32": (make_cavity_case, dict(n_interior=32, poisson="multigrid",
                                         tolerance_factor=1e-5), "cavity"),
    "channel-64x32": (make_channel_case, dict(nx=64, ny=32, poisson="multigrid",
                                              tolerance_factor=1e-5), "channel"),
    "step-64x16": (make_backwards_step_case, dict(nx=64, ny=16, poisson="multigrid",
                                                  tolerance_factor=1e-5), "step"),
    "rb-48x16": (make_rayleigh_benard_case, dict(nx=48, ny=16, rayleigh=1e5), "rb"),
}
MAIN = ["cavity-2048", "channel-1536x512", "step-2048x256", "rb-1536x512"]

_CACHE = {}


def _ws(which):
    if which not in _CACHE:
        make, kw, _ = SHAPES[which]
        case = make(device="cpu", dtype=torch.float32, mg_overrides={"whole_step": True}, **kw)
        _CACHE[which] = case.whole_step_kernel
    return _CACHE[which]


def _walk(plan: PL.CarryPlan, qshape, blocks: int) -> np.ndarray:
    """How many times each (4, Hq8, Wqa) cell is written by the tiles that
    ``blocks`` cooperative blocks walk: block k the tiles k, k + blocks, ...
    in row-major order, each tile its own plane cells of all four planes,
    clipped at the field's edge (carry_tile.cuh each_tile, tile_at,
    make_tile)."""
    _, Hq8, Wqa = qshape
    owned = np.zeros(qshape, dtype=np.int32)
    n = plan.grid_x * plan.grid_y
    for block in range(blocks):
        for t in range(block, n, blocks):
            ty, tx = divmod(t, plan.grid_x)
            r0, c0 = ty * plan.rows, tx * plan.cols
            owned[:, r0:min(r0 + plan.rows, Hq8), c0:min(c0 + plan.cols, Wqa)] += 1
    return owned


@pytest.mark.parametrize("which", list(SHAPES))
def test_carry_tile_and_halo(which):
    ws = _ws(which)
    flow = SHAPES[which][2]
    _, Hq8, Wqa = ws.qshape
    c = ws.plan.carry
    rows, cols = PL.WHOLE_STEP_TILES[flow]
    assert (c.rows, c.cols) == (min(rows, Hq8), min(cols, Wqa))
    assert 2 * c.halo >= PL.CARRY_RADIUS[flow]
    assert (c.grid_x, c.grid_y) == (-(-Wqa // c.cols), -(-Hq8 // c.rows))
    # the depth's input sets and the corrected u, v
    n = PL.WHOLE_STEP_INPUT_SETS * PL.CARRY_INPUTS[flow] + PL.WORK_BUFFERS
    assert c.smem_bytes == 4 * n * PL.carry_buffer_floats(c.rows, c.cols, c.halo)


@pytest.mark.parametrize("which", list(SHAPES))
def test_shared_memory_is_the_largest_need(which):
    ws = _ws(which)
    flow, solve = SHAPES[which][2], ws.plan.solve
    _, Hq8, Wqa = ws.qshape
    fold = 0 if flow == "cavity" else 4 * -(-4 * Hq8 * Wqa // PL.SUM_CHUNK)
    assert solve.smem_bytes == max(ws.solver.plan.smem_bytes, ws.plan.carry.smem_bytes, fold)
    assert solve.smem_bytes <= PL.SMEM_MAX
    # the rest of the solve's plan is its own
    assert solve == dataclasses.replace(ws.solver.plan, smem_bytes=solve.smem_bytes)


@pytest.mark.parametrize("which", MAIN)
def test_main_widths_keep_a_buffer_for_every_phase(which):
    """At the main widths the carry's tiles take more shared memory than the
    solve at the cavity and RB, and the channel's fold of 3696 partials
    fits beside either."""
    ws = _ws(which)
    flow, plan = SHAPES[which][2], ws.plan
    if flow in ("cavity", "rb"):
        assert plan.carry.smem_bytes > ws.solver.plan.smem_bytes
    if flow != "cavity":
        assert 4 * -(-4 * ws.qshape[1] * ws.qshape[2] // PL.SUM_CHUNK) < plan.solve.smem_bytes


@pytest.mark.parametrize("blocks", [132, 100])
@pytest.mark.parametrize("which", list(SHAPES))
def test_tile_walk_owns_every_cell_once(which, blocks):
    ws = _ws(which)
    plan = ws.plan.carry
    owned = _walk(plan, ws.qshape, blocks)
    assert (owned == 1).all()
    # the blocks' shares differ by at most one tile
    n = plan.grid_x * plan.grid_y
    shares = [len(range(k, n, blocks)) for k in range(blocks)]
    assert max(shares) - min(shares) <= 1


@pytest.mark.parametrize("which", MAIN)
def test_main_widths_leave_a_partial_round(which):
    """At the main widths the tiles do not divide over 100 blocks, so the
    walk's last round is partial (the case test_tile_walk_owns_every_cell_once
    checks at 100)."""
    plan = _ws(which).plan.carry
    assert (plan.grid_x * plan.grid_y) % 100 != 0


def _carry_syncs() -> dict:
    """The grid.sync() calls of whole_step.cu's kernel before the solve:
    the cavity's branch and the others' (the branch after the tile phase)."""
    src = (CSRC / "whole_step.cu").read_text()
    body = src[src.index("float max_b;"):src.index("cfd::ws::solve_cycles<kMasked>")]
    cavity, others = body.split("} else {", 1)
    return {"cavity": cavity.count("grid.sync()"), "others": others.count("grid.sync()")}


@pytest.mark.parametrize("which", MAIN)
def test_carry_barriers(which):
    ws = _ws(which)
    flow = SHAPES[which][2]
    assert ws.plan.carry_barriers == (1 if flow == "cavity" else 3)
    syncs = _carry_syncs()
    assert ws.plan.carry_barriers == syncs["cavity" if flow == "cavity" else "others"]
    # the V-cycle's barriers are the solve's own
    assert ws.plan.solve.barriers == ws.solver.plan.barriers


def test_the_tile_phase_is_one_loop():
    """The carry's tiles run in tile::each_tile, once in each flavor's
    branch, with the input sets the plan sizes its buffers for, and no
    scratch field carries the corrected u, v."""
    src = (CSRC / "whole_step.cu").read_text()
    tiles = (CSRC / "carry_tile.cuh").read_text()
    assert re.search(r"constexpr int kInputSets = (\d+);", tiles).group(1) == str(
        PL.WHOLE_STEP_INPUT_SETS)
    assert src.count("tile::each_tile(") == 3  # the cavity, RB, the duct flows
    assert "u_scr" not in src and "v_scr" not in src


@pytest.mark.parametrize("which", ["cavity-2048", "channel-1536x512", "cavity-32"])
def test_partials_hold_the_chunks_and_the_blocks(which):
    ws = _ws(which)
    n0 = ws.qshape[0] * ws.qshape[1] * ws.qshape[2]
    assert ws.partials.numel() == max(-(-n0 // PL.SUM_CHUNK), ws.plan.solve.blocks)
    assert not hasattr(ws, "u_scr") and not hasattr(ws, "v_scr")


@pytest.mark.parametrize("tile", [(4, 32), (12, 40), (16, 64)])
def test_tile_override(tile):
    ws = _ws("channel-1536x512")
    plan = PL.whole_step_plan("channel", ws.solver.plan, ws.qshape, tile=tile)
    assert (plan.carry.rows, plan.carry.cols) == tile
    assert plan.solve.smem_bytes >= plan.carry.smem_bytes
    assert (_walk(plan.carry, ws.qshape, 132) == 1).all()


def test_plan_refuses_a_tile_past_shared_memory():
    ws = _ws("rb-1536x512")
    with pytest.raises(ValueError, match="shared memory"):
        PL.whole_step_plan("rb", ws.solver.plan, ws.qshape, tile=(32, 64))
