"""The launch plans of the tiled kernels: the cooperative solve kernels
(csrc/whole_solve.cuh Plan: the whole-solve, kernels.whole_solve, the whole
step, kernels.whole_step, and the fused tail, kernels.mg_tail), the
one-launch carries (csrc/carry_tile.cuh Plan, carry_plan below), the step
corrector's blocks (step_corrector_plan below), the finest-level tile
kernels, separable and the step's, the coarse smoother, the natural
cavity's and channel's predictor + source and the natural step's masked
pairs (the same Plan, level0_plan, pairs_plan, natural_predictor_plan and
step_pairs_plan below), the whole step's, which joins the solve's and the
carry's (whole_step_plan below), and the fused-pre carry's, which joins the
cavity carry's and the separable pre kernel's (fused_pre_plan below).

Each runs one cooperative grid of one block of BLOCK_THREADS threads on
every SM. The coarse levels from ``block_from`` down run in ONE
block from its shared memory (their compact (ny + 2) x (nx + 2) iterates
and sources), the levels above on the whole grid; the finest level runs in
shared-memory tiles of ``tile_rows`` x ``tile_cols`` plane cells (all four
planes) with halos as deep as the stages each tile phase fuses. The plan is
computed here, on the host, and passed to the C entry points, which check
it and return an error (the wrapper raises) when the solve cannot hold it;
before a module's first launch ``ready_grid`` readies its kernel for the
plan's shared memory and raises when the card cannot hold the grid, so a
launch makes no query. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from cfd_tpu_torch.kernels._build import library

SMEM_MAX = 232_448      # shared memory one block may use on the H100, bytes
H100_SMS = 132          # the plan's SM count where no card is asked (the CPU)
BLOCK_THREADS = 512     # csrc/whole_solve.cuh kBlockThreads
RED_FLOATS = 512        # csrc/whole_solve.cuh kRedFloats: the reduction scratch
MAX_LEVELS = 16         # csrc/whole_solve.cuh kMaxLevels
TILE_ROWS, TILE_COLS = 32, 64  # the most plane rows and columns of a tile
# The switch to the block: the first coarse level of at most this many
# compact cells whose arrays, with every level below, fit one block's
# shared memory. One SM alone runs a level's phase in time that grows with
# its cells, while a grid phase costs a barrier and an L2 round trip
# whatever its size: the block takes the levels of at most 1500 cells (the
# cavity's level 6, the channel's, RB's and the step's level 5), which
# timed faster on an H100 than a switch at 5000 or 17000 cells (PERF.md,
# the whole-solve's findings).
BLOCK_TAIL_CELLS = 1_500
# A grid level of at most this many aligned cells (H8 x W) runs in tiles,
# one barrier each way; a larger one as grid-stride phases, one barrier a
# half-sweep, restriction and prolongation: a tile phase of a large level
# is latency-bound on each SM and costs more than the barriers it saves
# (the channel's level 1, 264 x 896, is faster in phases, its levels 2-4
# in tiles; PERF.md, the whole-solve's findings).
LEVEL_TILE_CELLS = 100_000


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch plan of one solve (csrc/whole_solve.cuh Plan); ``barriers``
    is the grid-wide barriers per V-cycle of its phase schedule."""

    block_from: int
    tile_rows: int
    tile_cols: int
    halo_pre: int
    halo_post: int
    smem_bytes: int
    blocks: int
    threads: int
    barriers: int
    # (rows, cols) of the tiles of grid levels 1.., (0, 0) for grid-stride phases
    level_tiles: tuple[tuple[int, int], ...] = ()

    def c_ints(self):
        """The host array the C entry points take: the eight fields, then
        MAX_LEVELS tile rows and MAX_LEVELS tile columns of the grid levels."""
        rows = [r for r, _ in self.level_tiles] + [0] * (MAX_LEVELS - len(self.level_tiles))
        cols = [c for _, c in self.level_tiles] + [0] * (MAX_LEVELS - len(self.level_tiles))
        return (ctypes.c_int * (8 + 2 * MAX_LEVELS))(
            self.block_from, self.tile_rows, self.tile_cols, self.halo_pre, self.halo_post,
            self.smem_bytes, self.blocks, self.threads, *rows, *cols)


def compact_cells(level) -> int:
    """Cells of a coarse level's compact shared-memory array: the interior
    and its ghost ring."""
    return (level.ny + 2) * (level.nx + 2)


def tail_level_floats(level) -> int:
    """Shared-memory floats of one level in the block: its compact iterate
    and source, and its weights (four compact arrays on a masked level, the
    four (nx + 2) / (ny + 2) vectors on a separable one)."""
    cc = compact_cells(level)
    if not level.separable:
        return 6 * cc
    return 2 * cc + 2 * (level.nx + 2) + 2 * (level.ny + 2)


def tail_floats(coarse, block_from: int) -> int:
    """Shared-memory floats of the block's levels block_from.. (1-based) and
    a row of the coarsest level's n cells per warp for its solve's folds."""
    bottom = coarse[-1]
    return (sum(tail_level_floats(lv) for lv in coarse[block_from - 1:])
            + BLOCK_THREADS // 32 * bottom.ny * bottom.nx)


def tile_floats(rows: int, cols: int, halo: int, arrays: int, weights: bool,
                post: bool) -> int:
    """Shared-memory floats of one finest-level tile: ``arrays`` logical
    buffers of 2 (rows + 2 halo) x 2 (cols + 2 halo), the separable weight
    vectors along them, and on a post phase the level-1 correction's (rows +
    2 halo + 1) x (cols + 2 halo + 1)."""
    lr, lc = 2 * (rows + 2 * halo), 2 * (cols + 2 * halo)
    n = arrays * lr * lc + (2 * (lr + lc) if weights else 0)
    return n + ((rows + 2 * halo + 1) * (cols + 2 * halo + 1) if post else 0)


def halos(masked: bool, pre: int, post: int) -> tuple[int, int]:
    """Plane rows and columns of halo of the pre and post tiles: every
    stage reads the 3 x 3 box around a cell, so each of a phase's stages
    costs one logical cell of halo. Pre: the 2 pre half-sweeps (and the
    masked trailing ghost stage), the residual and the restriction's lower
    children; post: the 2 post half-sweeps (and the ghost stage) and the
    residual."""
    return pre + (2 if masked else 1), post + 1


def level_halo(pre: int, post: int) -> int:
    """Rows and columns of halo of a grid level's tiles: 2 pre + 2 on the
    way down (the pre half-sweeps, the restriction's lower children and
    their residuals), 2 post on the way up; the larger of the two."""
    return max(2 * pre + 2, 2 * post)


def level_tile_floats(level, rows: int, cols: int, halo: int) -> int:
    """Shared-memory floats of a grid level's tile: its iterate and source,
    and its weights (four arrays on a masked level, vectors on a separable
    one; csrc/level_tile.cuh level_buf)."""
    return ltile_floats(rows, cols, halo, not level.separable)


def ltile_floats(rows: int, cols: int, halo: int, full: bool) -> int:
    """level_tile_floats of a level with full-2D (``full``) or separable
    weights."""
    lr, lc = rows + 2 * halo, cols + 2 * halo
    return 2 * lr * lc + (4 * lr * lc if full else 2 * (lr + lc))


def tile_shape(Hq8: int, Wqa: int, halo: int, blocks: int, fits,
               step: int = 1) -> tuple[int, int]:
    """The tile (plane rows, columns) of least estimated time: waves of
    tiles over the blocks times a tile's cells with its halo, among rows
    2..TILE_ROWS (in steps of ``step``) and columns 8..TILE_COLS in steps
    of 8 that ``fits`` (rows, cols) and that the field needs; ties to the
    larger tile."""
    best = None
    for cols in range(8, TILE_COLS + 1, 8):
        for rows in range(2, TILE_ROWS + 1, step):
            if not fits(rows, cols) or (rows > max(Hq8, 2)) or (cols > max(Wqa, 8)):
                continue
            tiles = -(-Hq8 // rows) * -(-Wqa // cols)
            cost = (-(-tiles // blocks) * (rows + 2 * halo) * (cols + 2 * halo), -rows * cols)
            if best is None or cost < best[0]:
                best = (cost, rows, cols)
    if best is None:
        raise ValueError("no finest-level tile fits one block's shared memory")
    return best[1], best[2]


def block_from_level(coarse, budget_floats: int) -> int:
    """The switch (1-based): the first coarse level of at most
    BLOCK_TAIL_CELLS compact cells whose arrays and the levels below fit
    ``budget_floats``; the coarsest always runs in the block."""
    for k in range(1, len(coarse) + 1):
        if ((k == len(coarse) or compact_cells(coarse[k - 1]) <= BLOCK_TAIL_CELLS)
                and tail_floats(coarse, k) <= budget_floats):
            return k
    raise ValueError(f"the coarsest level ({coarse[-1].ny}x{coarse[-1].nx}) does not fit "
                     f"one block's shared memory")


def grid_barriers(level_tiles, pre: int, post: int, *, fine: bool = True,
                  masked: bool = False, pin_mean: bool = False, corr_opt: bool = False) -> int:
    """Grid-wide barriers per V-cycle of the plan's schedule
    (whole_solve.cuh solve_cycles, coarse_vcycle): after the pre tiles; a
    tiled grid level one each way, a level of grid-stride phases 2 pre + 1
    down and 1 + 2 post up; one after the block; the masked level-1 phases
    (corr_opt 3, the fill 1), the last one; the pin 3 more. ``fine`` False:
    the tail's V-cycle alone."""
    n = 1 + sum(2 if rows else 2 * pre + 2 * post + 2 for rows, _ in level_tiles)
    if fine:
        n += 2 + (1 + 3 * int(corr_opt) if masked else 0) + 3 * int(pin_mean)
    return n


def plan_for(coarse, qshape, pre: int, post: int, *, masked: bool = False,
             pin_mean: bool = False, corr_opt: bool = False, sms: int = H100_SMS) -> Plan:
    """The plan of a solve over the coarse levels ``coarse`` (1..n) and the
    quad finest level ``qshape`` (None: the tail alone, no tiles) with V(pre,
    post), on ``sms`` SMs."""
    blocks = sms
    limit = SMEM_MAX // 4 - RED_FLOATS
    k0 = block_from_level(coarse, limit)
    need = tail_floats(coarse, k0)
    hl = level_halo(pre, post)
    level_tiles = []
    for lv, below in zip(coarse[:k0 - 1], coarse[1:k0]):
        if lv.shape[0] * lv.shape[1] > LEVEL_TILE_CELLS:
            level_tiles.append((0, 0))
            continue
        h_ext = max(lv.shape[0], 2 * below.shape[0])
        w_ext = max(lv.shape[1], 2 * below.shape[1])
        fits = lambda r, c, lv=lv: level_tile_floats(lv, r, c, hl) <= limit
        r, c = tile_shape(h_ext, w_ext, hl, blocks, fits, step=2)
        level_tiles.append((r, c))
        need = max(need, level_tile_floats(lv, r, c, hl))
    rows = cols = h_pre = h_post = 0
    if qshape is not None:
        _, Hq8, Wqa = qshape
        h_pre, h_post = halos(masked, pre, post)
        arrays = 3 if masked else 2

        def tiles(r, c):
            return max(tile_floats(r, c, h_pre, arrays, not masked, False),
                       tile_floats(r, c, h_post, arrays, not masked, True))

        rows, cols = tile_shape(Hq8, Wqa, max(h_pre, h_post), blocks,
                                lambda r, c: tiles(r, c) <= limit)
        need = max(need, tiles(rows, cols))
    return Plan(k0, rows, cols, h_pre, h_post, 4 * (RED_FLOATS + need), blocks, BLOCK_THREADS,
                grid_barriers(level_tiles, pre, post, fine=qshape is not None, masked=masked,
                              pin_mean=pin_mean, corr_opt=corr_opt), tuple(level_tiles))


def device_sms(device) -> int:
    """The SM count of ``device``: the card's own, H100_SMS on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def cooperative_grid(symbol: str, *which: int) -> dict:
    """The grid of the kernel chosen by ``which`` (the entry point's
    arguments before the outputs: a flavor and shared memory where it takes
    them) of the C entry point ``symbol`` (cfd_whole_solve_grid,
    cfd_whole_step_grid, cfd_mg_tail_grid, cfd_quad_fused_pre_grid; the
    carries' cfd_quad_carry_grid, cfd_quad_channel_carry_grid,
    cfd_step_carry_grid, cfd_rb_carry_grid; the tile kernels' grids) on
    the current CUDA
    device: blocks (SMs x blocks per SM), blocks per SM and registers per
    thread. Raises when the card refuses the grid."""
    lib = library()
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = getattr(lib, symbol)(*which, *(
        ctypes.cast(ctypes.byref(v), ctypes.c_void_p) for v in vals))
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} "
                           f"({lib.cfd_error_string(err).decode()})")
    return dict(zip(("blocks", "blocks_per_sm", "registers"), (v.value for v in vals)))


def ready_grid(plan: Plan, device, symbol: str, *which: int) -> dict:
    """Ready the kernel of ``symbol`` and ``which`` (a flavor, or nothing)
    on ``device`` for launches at ``plan`` (the grid entry points allow the
    plan's shared memory), and raise unless the card holds all plan.blocks
    blocks at once. The solve modules call it once, before their first
    launch; returns cooperative_grid's dict."""
    with torch.cuda.device(device):
        grid = cooperative_grid(symbol, *which, plan.smem_bytes)
    if grid["blocks"] < plan.blocks:
        raise RuntimeError(f"{symbol}: the card holds {grid['blocks']} blocks at once at "
                           f"{plan.smem_bytes} B of shared memory, the plan launches "
                           f"{plan.blocks}")
    return grid


# ------------------------------------------------------ the one-launch carries

# The tile of each carry, (plane rows, plane columns), chosen on an H100 by
# timing the candidates at the main shapes (PERF.md, the carries'
# findings): blocks of 512 threads (csrc/carry_tile.cuh kThreads), two an
# SM (four for the step's fixed-dt instance, csrc/step_stage.cu). The
# cavity's non-carry predictor + source ("cavity_predictor",
# csrc/quad_stage.cu lid_predictor_source_kernel: the exact adaptive
# controller's first stage) runs on the same tiles, its tile chosen the same
# way at the 2048^2 cavity (PERF.md, the cavity predictor's findings), and
# so does the channel's ("channel_predictor", csrc/quad_stage.cu
# channel_predictor_source_kernel: row 8c), its tile chosen at the 1536x512
# channel (PERF.md, the channel predictors' findings: 20 x 40 puts the
# field's 260 tiles that hold a cell in one wave of two blocks an SM). A
# sweep times a fresh op under another plan (time_carries --tiles); nothing
# overrides these but the card tests' ``tile``.
CARRY_TILES = {"cavity": (8, 64), "channel": (16, 32), "step": (8, 32), "rb": (16, 32),
               "cavity_predictor": (16, 48), "channel_predictor": (20, 40)}
# The logical rows each carry's chain reaches (the cavity: the reference's
# CARRY_RADIUS, cfd_tpu/kernels/quad.py:1021; the channel, the step and RB:
# csrc/quad_stage.cu kChannelRadius, csrc/step_stage.cu kStepRadius,
# csrc/rb_stage.cu kRBRadius; the cavity predictor: the predictor 1 and the
# source 1, csrc/quad_carry.cuh kPredictorRadius; the channel predictor: 3
# logical columns west, the outlet copy of a face one column west of an own
# cell, csrc/quad_carry.cuh kChannelPredictorRadius) and the shared-memory
# buffers a tile stages (csrc/quad_stage.cu kCavityBuffers,
# csrc/carry_tile.cuh kDuctBuffers for the channel and the step,
# csrc/rb_stage.cu kRBBuffers, csrc/quad_stage.cu kPredictorBuffers and
# kChannelPredictorBuffers).
CARRY_RADIUS = {"cavity": 5, "channel": 5, "step": 5, "rb": 7, "cavity_predictor": 2,
                "channel_predictor": 3}
# The fields a tile stages (csrc/quad_carry.cuh kCavityInputs,
# csrc/carry_tile.cuh kDuctInputs, csrc/rb_carry.cuh kRBInputs,
# csrc/quad_carry.cuh kPredictorInputs and kChannelPredictorInputs: u, v)
# and its buffers: those, then the corrected u, v (carry_tile.cuh
# kWorkBuffers; the predictors' u*, v*).
CARRY_INPUTS = {"cavity": 3, "channel": 3, "step": 3, "rb": 4, "cavity_predictor": 2,
                "channel_predictor": 2}
WORK_BUFFERS = 2
CARRY_BUFFERS = {flow: n + WORK_BUFFERS for flow, n in CARRY_INPUTS.items()}


@dataclasses.dataclass(frozen=True)
class CarryPlan:
    """The launch plan of a one-launch carry (csrc/carry_tile.cuh Plan; the
    step's finest-level kernels take the same, level0_plan):
    tiles of ``rows`` x ``cols`` plane cells of all four planes with a halo
    of ``halo`` plane rows and columns, ``smem_bytes`` of dynamic shared
    memory a block, a grid of ``grid_x`` tile columns by ``grid_y`` tile
    rows, one tile a block."""

    rows: int
    cols: int
    halo: int
    smem_bytes: int
    grid_x: int
    grid_y: int

    def c_ints(self):
        """The host array the C entry points take (the six fields)."""
        return (ctypes.c_int * 6)(self.rows, self.cols, self.halo, self.smem_bytes,
                                  self.grid_x, self.grid_y)


def carry_buffer_floats(rows: int, cols: int, halo: int) -> int:
    """Floats of one logical buffer of a tile: 2 (rows + 2 halo) x 2 (cols +
    2 halo) (csrc/carry_tile.cuh buffer_floats)."""
    return 4 * (rows + 2 * halo) * (cols + 2 * halo)


def carry_plan(flow: str, qshape, tile: tuple[int, int] | None = None,
               buffers: int | None = None) -> CarryPlan:
    """The plan of ``flow``'s carry ("cavity", "channel", "step" or "rb";
    "cavity_predictor" and "channel_predictor", the non-carry predictor +
    source kernels, on the same tiles) on a (4, Hq8, Wqa) field or local
    block: CARRY_TILES' tile (the card
    tests pass another ``tile`` to hold the kernels to their twins under
    it), cut to the field where it is larger, a halo of ceil(CARRY_RADIUS /
    2) plane rows, shared memory for CARRY_BUFFERS[flow] buffers (or
    ``buffers``). Raises when a block's buffers do not fit its shared
    memory."""
    _, Hq8, Wqa = qshape
    rows, cols = CARRY_TILES[flow] if tile is None else tile
    rows, cols = min(rows, Hq8), min(cols, Wqa)
    halo = -(-CARRY_RADIUS[flow] // 2)
    smem = 4 * (buffers or CARRY_BUFFERS[flow]) * carry_buffer_floats(rows, cols, halo)
    if smem > SMEM_MAX:
        raise ValueError(f"the {flow} carry's {rows}x{cols} tile takes {smem} B of shared "
                         f"memory, more than a block's {SMEM_MAX}")
    return CarryPlan(rows, cols, halo, smem, -(-Wqa // cols), -(-Hq8 // rows))


def carry_tiles(plan: CarryPlan, qshape):
    """Each tile's own region (plane row, plane column, rows, columns),
    clipped at the field's edge as the kernel clips it (carry_tile.cuh
    make_tile)."""
    _, Hq8, Wqa = qshape
    for ty in range(plan.grid_y):
        for tx in range(plan.grid_x):
            r0, c0 = ty * plan.rows, tx * plan.cols
            yield r0, c0, min(plan.rows, Hq8 - r0), min(plan.cols, Wqa - c0)


def ready_tiles(plan: CarryPlan, device, symbol: str, *which: int) -> dict:
    """Ready the tile kernel of ``symbol`` (the carries' cfd_quad_carry_grid,
    cfd_quad_channel_carry_grid, cfd_step_carry_grid, cfd_rb_carry_grid
    with ``which`` adaptive, block; the finest-level
    cfd_quad_level0_grid and cfd_step_level0_grid with post, block; the
    coarse smoother's cfd_rb_pairs_grid with its storage; the natural
    step's cfd_step_pairs_grid; the non-carry predictors'
    cfd_quad_predictor_source_grid, cfd_predictor_source_grid,
    cfd_quad_channel_predictor_source_grid and
    cfd_channel_predictor_source_grid) on
    ``device`` for the plan's
    shared memory, and raise unless the card holds a block of it. The
    modules call it once a device and instance, before their first launch
    there; returns cooperative_grid's dict."""
    with torch.cuda.device(device):
        grid = cooperative_grid(symbol, *which, plan.smem_bytes)
    if grid["blocks_per_sm"] < 1:
        raise RuntimeError(f"{symbol}: the card holds no block at {plan.smem_bytes} B of "
                           f"shared memory")
    return grid


# The block of the step's corrector (csrc/step_stage.cu
# step_corrector_kernel, rows 9b and 9b+: one thread a plane cell, all four
# quads of it), (plane rows, plane columns). Chosen on an H100 by timing
# candidates at the 2048x256 step's (4, 136, 1152) (PERF.md, the step
# corrector's findings: 1 x 128, nine blocks a plane row, timed fastest or
# within 0.5% of it in both rows). A sweep times a fresh op under another
# block (time_carries --only 9b,9b+ --tiles); nothing overrides it but the
# card tests' ``block``.
STEP_CORRECTOR_BLOCK = (1, 128)


@dataclasses.dataclass(frozen=True)
class CorrectorPlan:
    """The launch of the step corrector: blocks of ``rows`` x ``cols``
    plane cells, one thread each, and the grid of ``grid_rows`` x
    ``grid_cols`` blocks over the field that the C entry points form from
    the block."""

    rows: int
    cols: int
    grid_rows: int
    grid_cols: int


def step_corrector_plan(qshape, block: tuple[int, int] | None = None) -> CorrectorPlan:
    """The step corrector's launch on a (4, Hq8, Wqa) field:
    STEP_CORRECTOR_BLOCK (the card tests and the sweep pass another
    ``block``), its grid the blocks that cover Hq8 plane rows by Wqa plane
    columns. Raises on a block of no thread or of more than 1024."""
    _, Hq8, Wqa = qshape
    rows, cols = STEP_CORRECTOR_BLOCK if block is None else block
    if not (rows >= 1 and cols >= 1 and rows * cols <= 1024):
        raise ValueError(f"the step corrector's block {rows} x {cols} is not 1 to 1024 threads")
    return CorrectorPlan(rows, cols, -(-Hq8 // rows), -(-Wqa // cols))


# ------------------------------------------ the finest-level V-cycle kernels

# The tile of the step's pre and post kernels (csrc/step_vcycle.cu: one
# launch of one tile a block, 512 threads at 64 registers, two blocks an
# SM) on a whole field and on a shard's local block, (plane rows, plane
# columns), chosen on an H100 by timing candidates at the main path's
# instances (PERF.md, the finest-level kernels' findings): the 2048x256
# step's field (4, 136, 1152) and its 4-shard block (4, 56, 1152) both
# split into 8 x 36 tiles, 264 of them off the padding columns, one wave of
# two blocks on each of the 132 SMs. A sweep sets a fresh op's plan
# (time_level0 --tiles); nothing overrides these but the card tests'
# ``tile``.
LEVEL0_TILES = {"field": (17, 32), "block": (7, 32)}
# The logical buffers a masked tile stages (csrc/level0_tile.cuh
# step_tile_floats): the iterate, its second buffer and the source; the
# post kernel's coarse tile follows them. A separable tile stages two (the
# iterate, smoothed in place, and the source; sep_tile_floats) and the
# weight vectors.
LEVEL0_BUFFERS = 3
SEP_LEVEL0_BUFFERS = 2
# The tiles of the separable pre and post kernels (csrc/quad_vcycle.cu:
# the cavity's, the channel's and RB's; one launch of one tile a block,
# 512 threads at 61-64 registers, two blocks an SM). A tile's buffers are
# SEP_LEVEL0_WIDTH plane columns wide, one warp's row of two cells of a
# colour a lane (level0_tile.cuh update2), so its own columns are that
# less twice its halo (58 at n = 2, 60 at n = 1); its rows the most of
# SEP_LEVEL0_ROWS whose grid holds at least SEP_LEVEL0_MIN_TILES tiles,
# else the last: a large field in taller tiles (their halos cost less), a
# small one in enough tiles to keep the SMs busy. Chosen on an H100 by
# timing candidates at the 2048^2 cavity's field (4, 1032, 1152), the
# 1536x512 channel's (4, 264, 896) and their 4-shard blocks (4, 280, 1152)
# and (4, 88, 896) (PERF.md, the separable finest level's findings: 24,
# 24, 16 and 8 rows timed fastest there). A sweep sets a fresh op's plan
# (time_level0 --tiles); nothing overrides these but the card tests'
# ``tile``.
SEP_LEVEL0_WIDTH = 64
SEP_LEVEL0_ROWS = (24, 16, 8)
SEP_LEVEL0_MIN_TILES = 3 * H100_SMS // 2


def sep_level0_tile(qshape, halo: int) -> tuple[int, int]:
    """The separable finest-level tile (plane rows, plane columns) of a
    (4, Hq8, Wqa) field or block at ``halo``: SEP_LEVEL0_WIDTH less twice
    the halo wide, the most of SEP_LEVEL0_ROWS rows whose grid holds at
    least SEP_LEVEL0_MIN_TILES tiles, else the last."""
    _, Hq8, Wqa = qshape
    cols = SEP_LEVEL0_WIDTH - 2 * halo
    for rows in SEP_LEVEL0_ROWS:
        if -(-Hq8 // rows) * -(-Wqa // cols) >= SEP_LEVEL0_MIN_TILES:
            return rows, cols
    return SEP_LEVEL0_ROWS[-1], cols


def level0_plan(qshape, n_pairs: int, post: bool, *, masked: bool, block: bool = False,
                tile: tuple[int, int] | None = None) -> CarryPlan:
    """The plan of a finest-level pre (``post`` False) or post kernel at
    ``n_pairs`` pairs on a (4, Hq8, Wqa) whole field or (``block``) a
    shard's local block: the step's exact masked pairs (``masked``,
    csrc/step_vcycle.cu: LEVEL0_TILES' tile, a halo of n + 2 plane rows and
    columns on pre and n + 1 on post, LEVEL0_BUFFERS buffers) or the
    separable red/black pairs (csrc/quad_vcycle.cu: a halo of n + 1 on
    both, sep_level0_tile's tile, SEP_LEVEL0_BUFFERS buffers and the
    weight vectors); the card tests pass another ``tile``, which is cut to
    the field where it is larger; on post also the level-1 correction's
    tile (tile_floats); one tile a block. Raises when a tile does not fit
    a block's shared memory."""
    _, Hq8, Wqa = qshape
    kind = "post" if post else "pre"
    h_pre, h_post = halos(masked, n_pairs, n_pairs)
    halo = h_post if post else h_pre
    if tile is None:
        tile = (LEVEL0_TILES["block" if block else "field"] if masked
                else sep_level0_tile(qshape, halo))
    rows, cols = min(tile[0], Hq8), min(tile[1], Wqa)
    buffers = LEVEL0_BUFFERS if masked else SEP_LEVEL0_BUFFERS
    smem = 4 * tile_floats(rows, cols, halo, buffers, not masked, post)
    if smem > SMEM_MAX:
        what = "step's" if masked else "separable"
        raise ValueError(f"the {what} {kind} kernel's {rows}x{cols} tile (halo {halo}) takes "
                         f"{smem} B of shared memory, more than a block's {SMEM_MAX}")
    return CarryPlan(rows, cols, halo, smem, -(-Wqa // cols), -(-Hq8 // rows))


# ----------------------------------------------------- the coarse smoother

# The tiles of the coarse red/black smoother (csrc/rb_smoother.cu: one
# launch of one tile a block, 512 threads at 64 registers, two blocks an
# SM). A tile's buffers are PAIRS_TILE_WIDTH columns wide, one warp's row
# of two cells a lane (level0_tile.cuh update2), so its own columns are
# that less twice its halo. Its rows are the most of PAIRS_TILE_ROWS (of
# those whose buffers fit a block) whose grid gives the card two tiles an
# SM, else the most whose grid gives one an SM (PAIRS_MIN_TILES), else
# PAIRS_SMALL_ROWS: a large level in large tiles (their halos cost less), a
# small one in as many tiles as its rows allow (a tile's passes are
# latency-bound, so the card wants blocks). Chosen on an H100 by timing
# candidates at the main path's levels (PERF.md, the coarse smoother's
# findings); a sweep times a fresh op under another plan (time_pairs
# --tiles); nothing overrides these but the card tests' ``tile``.
PAIRS_TILE_WIDTH = 128
PAIRS_TILE_ROWS = (64, 32, 16, 8)
PAIRS_SMALL_ROWS = 4
PAIRS_MIN_TILES = (2 * H100_SMS, H100_SMS)


def pairs_plan(shape, n_pairs: int, residual: bool, full: bool,
               tile: tuple[int, int] | None = None) -> CarryPlan:
    """The plan of the coarse smoother at ``n_pairs`` red/black pairs on an
    aligned (H8, W) level with full-2D (``full``) or separable weights: a
    halo of 2 n_pairs cells (each half-sweep costs one), one more with the
    ``residual`` (its stencil reads the smoothed neighbours); the tile of
    the rule above (the card tests pass another ``tile``), cut to the level
    where it is larger; shared memory for the tile's iterate, source and
    weights (ltile_floats); one tile a block over the whole array, its
    padding included. Raises when a tile does not fit a block's shared
    memory."""
    H8, W = shape
    halo = 2 * n_pairs + int(residual)
    if tile is None:
        cols = PAIRS_TILE_WIDTH - 2 * halo
        fits = [r for r in PAIRS_TILE_ROWS
                if 4 * ltile_floats(r, cols, halo, full) <= SMEM_MAX]
        rows = PAIRS_SMALL_ROWS
        for least in PAIRS_MIN_TILES:
            many = [r for r in fits if -(-H8 // r) * -(-W // cols) >= least]
            if many:
                rows = max(many)
                break
        tile = (rows, cols)
    rows, cols = min(tile[0], H8), min(tile[1], W)
    smem = 4 * ltile_floats(rows, cols, halo, full)
    if smem > SMEM_MAX:
        raise ValueError(f"the coarse smoother's {rows}x{cols} tile (halo {halo}) takes "
                         f"{smem} B of shared memory, more than a block's {SMEM_MAX}")
    return CarryPlan(rows, cols, halo, smem, -(-W // cols), -(-H8 // rows))


# ---------------------------------- the natural cavity's predictor + source

# The tile of the natural cavity's predictor + source (csrc/projection.cu
# predictor_source_kernel: one launch of one tile a block, 512 threads),
# (rows, columns) of the aligned (H8, W) array: its columns a multiple of
# 128, so that a tile row's stores start on a 128-byte line (W is a
# multiple of 128), and its rows chosen on an H100 by timing candidates at
# the 2048^2 cavity's (2056, 2176) (PERF.md, the natural predictor's
# findings). A sweep times a fresh op under another plan (time_carries
# --tiles); nothing overrides it but the card tests' ``tile``.
NATURAL_PREDICTOR_TILE = (24, 128)
# the cells its stages reach around a tile's own (the predictor 1, the
# source 1; csrc/projection.cu kPredictorRadius) and its buffers: u, v,
# then u*, v* (kPredictorBuffers)
NATURAL_PREDICTOR_RADIUS = 2
NATURAL_PREDICTOR_BUFFERS = 4


# The natural channel's predictor + source (csrc/projection.cu
# channel_predictor_source_kernel) on the same tiles: its tile, chosen the
# same way at the 1536x512 channel's (520, 1664) (PERF.md, the channel
# predictors' findings: 10 x 384 puts the 260 tiles that hold a cell in one
# wave of two blocks an SM), and the cells its stages reach (3 columns
# west: the outlet copy of a face one column west of an own cell;
# csrc/projection.cu kChannelPredictorRadius); the same four buffers.
NATURAL_CHANNEL_PREDICTOR_TILE = (10, 384)
NATURAL_CHANNEL_PREDICTOR_RADIUS = 3


def natural_predictor_plan(shape, tile: tuple[int, int] | None = None, *,
                           channel: bool = False) -> CarryPlan:
    """The plan of the natural cavity's predictor + source (``channel``:
    the channel's) on an aligned (H8, W) array: NATURAL_PREDICTOR_TILE
    (NATURAL_CHANNEL_PREDICTOR_TILE; the card tests pass another ``tile``),
    cut to the array where it is larger, a halo of NATURAL_PREDICTOR_RADIUS
    (NATURAL_CHANNEL_PREDICTOR_RADIUS) cells, shared memory for
    NATURAL_PREDICTOR_BUFFERS buffers of (rows + 2 halo) x (cols + 2 halo);
    one tile a block over the whole array, its padding included. Raises when
    a tile does not fit a block's shared memory."""
    H8, W = shape
    default = NATURAL_CHANNEL_PREDICTOR_TILE if channel else NATURAL_PREDICTOR_TILE
    rows, cols = default if tile is None else tile
    rows, cols = min(rows, H8), min(cols, W)
    halo = NATURAL_CHANNEL_PREDICTOR_RADIUS if channel else NATURAL_PREDICTOR_RADIUS
    smem = 4 * NATURAL_PREDICTOR_BUFFERS * (rows + 2 * halo) * (cols + 2 * halo)
    if smem > SMEM_MAX:
        raise ValueError(f"the natural predictor's {rows}x{cols} tile takes {smem} B of "
                         f"shared memory, more than a block's {SMEM_MAX}")
    return CarryPlan(rows, cols, halo, smem, -(-W // cols), -(-H8 // rows))


# ------------------------------------------- the natural step's masked pairs

# The tiles of the natural step's exact masked pairs (csrc/step_smoother.cu:
# one launch of one tile a block, 512 threads). A tile's buffers are
# STEP_PAIRS_TILE_WIDTH columns wide, one warp's row of a pass (two cells a
# lane, level0_tile.cuh update2), so its own columns are that less twice
# its halo; its rows the most of STEP_PAIRS_TILE_ROWS whose grid holds at
# least STEP_PAIRS_MIN_TILES tiles, else the last: the levels are small
# (the natural step's level 0 is 32 x 514), so a call is the latency of its
# 3 n + 1 dependent passes, each shorter the fewer rows a tile's buffers
# have. Chosen on an H100 by timing candidates at the natural step's level
# 0 (PERF.md, the natural step's pairs: 4-row tiles, 96 of them, timed
# fastest there in both residual variants, 32-row bands slowest); a sweep
# times a fresh op under another plan (time_pairs --tiles); nothing
# overrides these but the card tests' ``tile``.
STEP_PAIRS_TILE_WIDTH = 64
STEP_PAIRS_TILE_ROWS = (32, 16, 8, 4)
STEP_PAIRS_MIN_TILES = 96
# the logical buffers a tile stages: the iterate, its second buffer (the
# refresh writes out of place), the source
STEP_PAIRS_BUFFERS = 3


def step_pairs_halo(n_pairs: int, residual: bool) -> int:
    """Cells of halo of the natural step's pairs: each of the 3 n_pairs + 1
    stages (n_pairs x (refresh, red, black) and the trailing refresh) reads
    the 3 x 3 box around a cell, and the residual re-applies the refresh
    before its 5-point stencil: 2 more (cfd_tpu/kernels/step_smoother.py:
    70-75)."""
    return 3 * n_pairs + 1 + 2 * int(residual)


def step_pairs_plan(shape, n_pairs: int, residual: bool,
                    tile: tuple[int, int] | None = None) -> CarryPlan:
    """The plan of the natural step's masked pairs at ``n_pairs`` pairs on a
    logical (ny + 2, nx + 2) level, with a ``residual`` (the field or its
    max) or without: the halo of step_pairs_halo, the tile of the rule above
    (the card tests pass another ``tile``), cut to the level where it is
    larger, shared memory for STEP_PAIRS_BUFFERS buffers; one tile a block
    over the whole array. Raises when a tile does not fit a block's shared
    memory."""
    H, W = shape
    halo = step_pairs_halo(n_pairs, residual)
    if tile is None:
        cols = max(STEP_PAIRS_TILE_WIDTH - 2 * halo, 1)
        rows = STEP_PAIRS_TILE_ROWS[-1]
        for r in STEP_PAIRS_TILE_ROWS:
            if -(-H // r) * -(-W // cols) >= STEP_PAIRS_MIN_TILES:
                rows = r
                break
        tile = (rows, cols)
    rows, cols = min(tile[0], H), min(tile[1], W)
    smem = 4 * STEP_PAIRS_BUFFERS * (rows + 2 * halo) * (cols + 2 * halo)
    if smem > SMEM_MAX:
        raise ValueError(f"the natural step's pairs' {rows}x{cols} tile (halo {halo}) takes "
                         f"{smem} B of shared memory, more than a block's {SMEM_MAX}")
    return CarryPlan(rows, cols, halo, smem, -(-W // cols), -(-H // rows))


# ------------------------------------------------------------- the whole step

# The whole step's carry runs the carries' tiles inside its cooperative
# grid (csrc/whole_step.cu): each block of BLOCK_THREADS threads, one an
# SM, walks the tiles t = block + k blocks in turn with the next tile's
# loads under this tile's stages, so it stages WHOLE_STEP_INPUT_SETS sets
# of a tile's inputs. Its tile (plane rows,
# plane columns) is its own constant, chosen on an H100 by timing the carry
# phases alone (the whole step at max_cycles 0) and the whole call under
# eight candidates a flow (PERF.md, the whole step's findings): a tile's
# shared memory sets the launch's, and the V-cycles ran slower beside the
# larger ones (a smaller L1 beside them fits the readings). A sweep edits
# it in a scratch copy; nothing overrides it.
WHOLE_STEP_TILES = {"cavity": (16, 64), "channel": (40, 24), "step": (24, 32), "rb": (20, 32)}
WHOLE_STEP_INPUT_SETS = 2    # csrc/carry_tile.cuh kInputSets
# Grid-wide barriers of the carry phases (csrc/whole_step.cu): after the
# tiles; the others also after the chunk sums and after the mean removal.
WHOLE_STEP_CARRY_BARRIERS = {"cavity": 1, "channel": 3, "step": 3, "rb": 3}
SUM_CHUNK = 256         # csrc/whole_solve.cuh kSumChunk: the source sum's chunks


@dataclasses.dataclass(frozen=True)
class WholeStepPlan:
    """The launch plan of a whole step: ``solve``, its solve's plan with the
    shared memory raised to the largest need of its phases (the carry's
    tiles, the fold of the source sum's partials, the solve's); ``carry``,
    the carry's tiles; ``carry_barriers``, the grid-wide barriers of the
    carry phases (before the solve's V-cycles, ``solve.barriers`` each)."""

    solve: Plan
    carry: CarryPlan
    carry_barriers: int


def whole_step_plan(flow: str, solve: Plan, qshape,
                    tile: tuple[int, int] | None = None) -> WholeStepPlan:
    """The plan of ``flow``'s whole step on a (4, Hq8, Wqa) field from its
    solve's plan: WHOLE_STEP_TILES' tile (or ``tile``: the card tests hold
    the kernel to its twin under others) with WHOLE_STEP_INPUT_SETS input sets,
    and the larger of the phases' shared memory. Raises when it exceeds a
    block's."""
    _, Hq8, Wqa = qshape
    carry = carry_plan(flow, qshape, WHOLE_STEP_TILES[flow] if tile is None else tile,
                       buffers=WHOLE_STEP_INPUT_SETS * CARRY_INPUTS[flow] + WORK_BUFFERS)
    fold = 0 if flow == "cavity" else 4 * -(-4 * Hq8 * Wqa // SUM_CHUNK)
    smem = max(solve.smem_bytes, carry.smem_bytes, fold)
    if smem > SMEM_MAX:
        raise ValueError(f"the {flow} whole step's phases take {smem} B of shared memory, "
                         f"more than a block's {SMEM_MAX}")
    return WholeStepPlan(dataclasses.replace(solve, smem_bytes=smem), carry,
                         WHOLE_STEP_CARRY_BARRIERS[flow])



# ------------------------------------------------------- the fused-pre carry

# The fused-pre carry (csrc/quad_fused_pre.cu) runs the cavity carry's
# tiles and then the separable pre kernel's in one cooperative launch, one
# grid barrier between them: each block of BLOCK_THREADS threads walks the
# carry's tiles t = block + k blocks in turn with the next tile's loads
# under this tile's stages (FUSED_PRE_INPUT_SETS input sets, as the whole
# step), then the pre tiles the same way. The carry's tile is
# FUSED_PRE_TILE (plane rows, plane columns), the pre's level0_plan's; the
# blocks are as many as co-reside at the larger of the two phases' shared
# memory, at most two an SM (csrc/quad_fused_pre.cu kBlocksPerSM, the
# kernel's launch bounds: 64 registers). Chosen on an H100 by timing candidates at the
# 2048^2 cavity (PERF.md, the fused-pre carry's findings: 8 x 48, two
# blocks an SM, timed fastest of seven, 3% ahead of 16 x 32 and 11% of
# carry_plan's 8 x 64, one block an SM with two input sets); a sweep times
# a fresh op under another plan (time_carries --tiles); nothing overrides
# it but the card tests' ``tile``.
FUSED_PRE_TILE = (8, 48)
FUSED_PRE_INPUT_SETS = 2        # csrc/carry_tile.cuh kInputSets
FUSED_PRE_BARRIERS = 1          # the grid barriers of a launch


@dataclasses.dataclass(frozen=True)
class FusedPrePlan:
    """The launch plan of the fused-pre carry: ``carry``, the cavity carry's
    tiles (phase A, FUSED_PRE_INPUT_SETS input sets); ``pre``, the separable
    pre tiles (phase B); ``smem_bytes``, the larger of their shared memory;
    ``blocks``, the cooperative grid (0 until a module readies it on a card:
    as many as co-reside there, kernels.quad)."""

    carry: CarryPlan
    pre: CarryPlan
    smem_bytes: int
    blocks: int = 0

    def c_ints(self):
        """The host array cfd_quad_fused_pre takes: the carry's six fields,
        the pre's six, the shared memory and the blocks."""
        return (ctypes.c_int * 14)(*dataclasses.astuple(self.carry),
                                   *dataclasses.astuple(self.pre), self.smem_bytes,
                                   self.blocks)


def fused_pre_plan(qshape, n_pairs: int, tile: tuple[int, int] | None = None) -> FusedPrePlan:
    """The plan of the fused-pre carry on a (4, Hq8, Wqa) cavity field at
    ``n_pairs`` pre pairs: carry_plan's cavity plan at FUSED_PRE_TILE (or
    ``tile``: the card tests hold the kernel to its twin under others) with
    FUSED_PRE_INPUT_SETS input sets and the corrected u, v; level0_plan's
    separable pre plan; the larger of their shared memory. Raises when a
    phase's tiles do not fit a block's shared memory."""
    carry = carry_plan("cavity", qshape, FUSED_PRE_TILE if tile is None else tile,
                       buffers=FUSED_PRE_INPUT_SETS * CARRY_INPUTS["cavity"] + WORK_BUFFERS)
    pre = level0_plan(qshape, n_pairs, False, masked=False)
    return FusedPrePlan(carry, pre, max(carry.smem_bytes, pre.smem_bytes))
