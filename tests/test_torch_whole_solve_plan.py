"""The host-side launch plan of the whole-solve family (kernels/plan.py), on
the CPU: at the four main shapes and the small card-against-CPU shapes, the
switch to the block, the shared memory a block asks for, the grid-wide
barriers per V-cycle against a walk of the device schedule and against the
grid-phase design it replaced, the tiles' halos and coverage, and the
fixed-order chunks of the pin's and corr_opt's sums, which do not depend
on the block shape."""

import math

import pytest
import torch

from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels.quad import SUM_BLOCK

torch.set_num_threads(1)

# id: (factory, kwargs, mg_overrides, the expected switch level)
SHAPES = {
    "cavity-2048": (make_cavity_case, dict(n_interior=2048, poisson="multigrid",
                                           tolerance_factor=1e-6), {}, 6),
    "channel-1536x512": (make_channel_case, dict(nx=1536, ny=512, poisson="multigrid",
                                                 tolerance_factor=1e-6, abs_tol=0.0), {}, 5),
    "step-2048x256": (make_backwards_step_case, dict(nx=2048, ny=256, poisson="multigrid",
                                                     tolerance_factor=1e-6, abs_tol=0.0), {}, 5),
    "rb-1536x512": (make_rayleigh_benard_case, dict(nx=1536, ny=512, rayleigh=1e6), {}, 5),
    "step-2048x256-corr_opt": (make_backwards_step_case,
                               dict(nx=2048, ny=256, poisson="multigrid", tolerance_factor=1e-6,
                                    abs_tol=0.0), {"corr_opt": True}, 5),
    "cavity-256": (make_cavity_case, dict(n_interior=256, poisson="multigrid",
                                          tolerance_factor=1e-6), {}, 3),
    "channel-256x128": (make_channel_case, dict(nx=256, ny=128, poisson="multigrid",
                                                tolerance_factor=1e-6, abs_tol=0.0), {}, 3),
    "step-512x64": (make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid",
                                                   tolerance_factor=1e-6, abs_tol=0.0), {}, 3),
    "rb-256x128": (make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e5), {}, 3),
    "cavity-64": (make_cavity_case, dict(n_interior=64, poisson="multigrid",
                                         tolerance_factor=1e-6), {}, 1),
    "step-96x32": (make_backwards_step_case, dict(nx=96, ny=32, poisson="multigrid",
                                                  tolerance_factor=1e-6, abs_tol=0.0), {}, 1),
}
# the grid-wide barriers per V-cycle of the design this plan replaced (every
# phase of every level a grid-stride loop and a barrier), as old_barriers
# counts them
MAIN_OLD = {"cavity-2048": 75, "channel-1536x512": 59, "step-2048x256": 59, "rb-1536x512": 61}

_CACHE = {}


def _solve(which):
    if which not in _CACHE:
        make, kw, ov, _ = SHAPES[which]
        case = make(device="cpu", dtype=torch.float32,
                    mg_overrides={"whole_solve": True, **ov}, **kw)
        _CACHE[which] = case.poisson_solve
    return _CACHE[which]


def _coarse(solve):
    return solve.mg.levels if solve.MASKED else solve.mg.levels[1:]


def walk_barriers(plan, pre, post, *, masked, pin_mean, corr_opt):
    """The grid-wide barriers of one V-cycle, counted by walking the device
    schedule (csrc/whole_solve.cuh solve_cycles, coarse_vcycle) phase by
    phase."""
    n = 1  # the pre tiles
    for rows, _ in plan.level_tiles:  # down
        if rows:
            n += 1
        else:
            for _ in range(pre):
                n += 2
            n += 1  # the restriction
    n += 1  # the block's tail
    for rows, _ in reversed(plan.level_tiles):  # up
        if rows:
            n += 1
        else:
            n += 1  # the prolongation
            for _ in range(post):
                n += 2
    if masked:
        n += 3 * corr_opt + 1  # the steplength's three, the level-1 fill
    if pin_mean:
        n += 3  # the tiles' p, the partial sums, the fold
    return n + 1  # the residual's


def old_barriers(solve):
    """The same count for the design this plan replaced: every half-sweep,
    restriction, prolongation and fill of every level a grid-wide phase."""
    cfg, coarse = solve.cfg, _coarse(solve)
    nc, pre, post = len(coarse), cfg.pre_sweeps, cfg.post_sweeps
    fine_pre = 2 * pre + (1 if solve.MASKED else 0) + 1
    down = (nc - 1) * (2 * pre + 1) + 2
    up = sum(int(not lv.separable) + 1 + 2 * post for lv in coarse[1:])
    fine_post = 1 + 2 * post + (1 if solve.MASKED else 0) + 1
    if solve.MASKED:
        fine_post += 3 * int(cfg.corr_opt) + 1
    return fine_pre + down + up + fine_post + (2 if cfg.pin_mean else 0)


@pytest.mark.parametrize("which", list(SHAPES))
def test_switch_level(which):
    solve = _solve(which)
    plan, coarse = solve.plan, _coarse(solve)
    assert plan.block_from == SHAPES[which][3]
    assert 1 <= plan.block_from <= len(coarse)
    # the block takes no level above the switch's size; the coarsest always
    if plan.block_from < len(coarse):
        assert PL.compact_cells(coarse[plan.block_from - 1]) <= PL.BLOCK_TAIL_CELLS
    if plan.block_from > 1:
        assert PL.compact_cells(coarse[plan.block_from - 2]) > PL.BLOCK_TAIL_CELLS
    # the grid levels: tiles below LEVEL_TILE_CELLS, grid-stride phases above
    assert len(plan.level_tiles) == plan.block_from - 1
    for lv, (rows, cols) in zip(coarse, plan.level_tiles):
        tiled = lv.shape[0] * lv.shape[1] <= PL.LEVEL_TILE_CELLS
        assert (rows > 0) == tiled
        if tiled:
            assert rows % 2 == 0 and cols % 2 == 0 and rows >= 2 and cols >= 8


@pytest.mark.parametrize("which", list(SHAPES))
def test_shared_memory_fits(which):
    solve = _solve(which)
    plan, coarse, cfg = solve.plan, _coarse(solve), solve.cfg
    assert plan.smem_bytes <= PL.SMEM_MAX == 232_448
    assert plan.smem_bytes % 4 == 0
    # every phase's arrays fit what the plan asks for
    need = PL.tail_floats(coarse, plan.block_from)
    hl = PL.level_halo(cfg.pre_sweeps, cfg.post_sweeps)
    for lv, (rows, cols) in zip(coarse, plan.level_tiles):
        if rows:
            need = max(need, PL.level_tile_floats(lv, rows, cols, hl))
    arrays = 3 if solve.MASKED else 2
    for h, post in ((plan.halo_pre, False), (plan.halo_post, True)):
        need = max(need, PL.tile_floats(plan.tile_rows, plan.tile_cols, h, arrays,
                                        not solve.MASKED, post))
    assert 4 * (PL.RED_FLOATS + need) == plan.smem_bytes
    if which == "cavity-2048":  # its level 1 (1032 x 1152) cannot be planned into the block
        assert PL.tail_floats(coarse, 1) * 4 > PL.SMEM_MAX
        assert plan.block_from > 1


@pytest.mark.parametrize("which", list(SHAPES))
def test_barriers_walk_the_schedule(which):
    solve = _solve(which)
    cfg = solve.cfg
    walked = walk_barriers(solve.plan, cfg.pre_sweeps, cfg.post_sweeps, masked=solve.MASKED,
                           pin_mean=bool(cfg.pin_mean) and not solve.MASKED,
                           corr_opt=bool(cfg.corr_opt))
    assert solve.plan.barriers == walked
    assert walked < old_barriers(solve)


@pytest.mark.parametrize("which", list(MAIN_OLD))
def test_barriers_at_most_half_the_old_design(which):
    solve = _solve(which)
    assert old_barriers(solve) == MAIN_OLD[which]
    assert 2 * solve.plan.barriers <= MAIN_OLD[which]


@pytest.mark.parametrize("which", list(SHAPES))
def test_tiles_cover_the_finest_level(which):
    solve = _solve(which)
    plan, cfg = solve.plan, solve.cfg
    _, Hq8, Wqa = solve.qshape
    assert (plan.halo_pre, plan.halo_post) == PL.halos(solve.MASKED, cfg.pre_sweeps,
                                                       cfg.post_sweeps)
    # every stage reads the 3 x 3 box: a halo of h plane rows is 2h logical
    # rows, one lost per stage
    ghost = 1 if solve.MASKED else 0
    assert 2 * plan.halo_pre >= 2 * cfg.pre_sweeps + ghost + 2  # the residual, the children
    assert 2 * plan.halo_post >= 2 * cfg.post_sweeps + ghost + 1  # the residual
    assert 1 <= plan.tile_rows <= PL.TILE_ROWS and 8 <= plan.tile_cols <= PL.TILE_COLS
    tiles = math.ceil(Hq8 / plan.tile_rows) * math.ceil(Wqa / plan.tile_cols)
    assert tiles * plan.tile_rows * plan.tile_cols >= Hq8 * Wqa
    assert plan.blocks == PL.H100_SMS and plan.threads == PL.BLOCK_THREADS


def _chunks_covered(n, blocks, threads):
    """The chunk of each kSumChunk-thread group in csrc/whole_solve.cuh
    chunk_sums, walked for every block: {chunk: count}."""
    groups = threads // SUM_BLOCK
    chunks = -(-n // SUM_BLOCK)
    rounds = -(-chunks // groups)
    seen = {}
    for block in range(blocks):
        for r in range(block, rounds, blocks):
            for g in range(groups):
                c = r * groups + g
                if c < chunks:
                    seen[c] = seen.get(c, 0) + 1
    return chunks, seen


@pytest.mark.parametrize("blocks, threads", [(132, 512), (264, 256), (3, 512), (7, 256)])
def test_pin_chunks_independent_of_block_shape(blocks, threads):
    solve = _solve("rb-1536x512")
    n0 = 4 * solve.qshape[1] * solve.qshape[2]
    chunks, seen = _chunks_covered(n0, blocks, threads)
    # one partial per 256-wide flat chunk, each summed exactly once
    assert solve.partials.numel() == chunks == -(-n0 // 256)
    assert seen == {c: 1 for c in range(chunks)}


def test_corr_opt_chunks():
    solve = _solve("step-2048x256-corr_opt")
    H8, W = solve.mg.levels[0].shape
    chunks = -(-H8 * W // SUM_BLOCK)
    assert solve.partials.numel() == 2 * chunks
    for blocks, threads in ((132, 512), (264, 256)):
        assert _chunks_covered(H8 * W, blocks, threads)[1] == {c: 1 for c in range(chunks)}


def test_plan_c_ints():
    solve = _solve("channel-1536x512")
    ints = list(solve.plan.c_ints())
    plan = solve.plan
    assert len(ints) == 8 + 2 * PL.MAX_LEVELS
    assert ints[:8] == [plan.block_from, plan.tile_rows, plan.tile_cols, plan.halo_pre,
                        plan.halo_post, plan.smem_bytes, plan.blocks, plan.threads]
    k = plan.block_from - 1
    assert ints[8:8 + k] == [r for r, _ in plan.level_tiles]
    assert ints[8 + PL.MAX_LEVELS:8 + PL.MAX_LEVELS + k] == [c for _, c in plan.level_tiles]
    assert ints[8 + k:8 + PL.MAX_LEVELS] == [0] * (PL.MAX_LEVELS - k)


def test_tail_plan():
    solve = _solve("cavity-2048")
    coarse = _coarse(solve)
    tail = PL.plan_for(coarse, None, solve.cfg.pre_sweeps, solve.cfg.post_sweeps)
    assert (tail.tile_rows, tail.tile_cols, tail.halo_pre, tail.halo_post) == (0, 0, 0, 0)
    assert tail.block_from == solve.plan.block_from
    # the tail's V-cycle alone: the whole-solve's less its finest-level phases
    assert tail.barriers == solve.plan.barriers - 2


def test_coarsest_must_fit():
    solve = _solve("cavity-64")
    with pytest.raises(ValueError, match="does not fit"):
        PL.block_from_level(_coarse(solve), budget_floats=10)
