#!/usr/bin/env python3
"""Smoke check of the cfd_tpu_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. It imports torch and the port, never jax
or cfd_tpu. Phases (any failure raises and the exit code is non-zero):

1. Device and build: requires a CUDA device, prints the card's name and
   power limit (nvidia-smi), builds the kernels from csrc/ with nvcc (one
   process per source, in parallel), prints the build seconds, the
   whole-solve, whole-step and finest-level tile kernels' (the step's and
   the separable ones) registers, and the cooperative kernels' grids at the most shared
   memory a launch plan may ask (kernels/plan.py).
2. Per-kernel check at the 2048^2 cavity shapes: each hand-written kernel
   of the per-kernel cavity path (mg_overrides whole_solve=False) against
   its plain PyTorch twin on the same seeded inputs on the card. Error = max |kernel - plain| / max |plain| per
   output; limit 1e-5; the redesigned tile carries (rows 1, 1+, 8a,
   8a+, 9a, 9a+, 10, 10+ here and in phases 5, 8, 11 and 14; their shard
   rows in phases 32, 35, 38 and 41 with every shard kernel) error 0, and
   so is the coarse smoother (rows 5, 5b, 5-wr here and in phases 8 and
   25: one launch of shared-memory tiles a call), here at every level of
   the per-kernel cavity's, channel's and RB's hierarchies in float32 and
   bfloat16, 1 and 2 pairs, both variants; its timed instance (the
   cavity's bf16 level 1 pre-smooth) with ``dev_ms`` and its device
   operations a call (a child time_pairs process). The finest-level pre
   and post kernels (rows 3, 4: one launch of shared-memory tiles each,
   csrc/quad_vcycle.cu) error 0 too, here at V(2,1), in phase 5 the
   channel's V(1,2) and in phase 11 RB's V(2,1) instances, with
   ``dev_ms`` and their device operations a call (a child time_level0
   process). Times are CUDA-event medians
   of 20 launches; each carry (rows 1, 8a, 9a, 10 in phases 2, 5, 8, 11,
   their traced-dt instances in phase 14) also has its device time,
   ``dev_ms``: CUDA events around 50 back-to-back calls with the card held
   busy while the host queues them (cfd_tpu_torch.time_whole_solve.dev_ms).
   Then the launch plan of the cavity's f32 whole-solve at 2048^2: its grid
   levels (tiled or grid-stride), the levels in one block, the finest
   level's tile and halos, its shared memory, blocks and block size, and
   its grid-wide barriers per V-cycle beside the earlier grid-phase
   design's (it fails above half of them); phases 5, 8 and 11 print their
   whole-solve's plan the same way, with its ms per V-cycle.
3. The cavity slice: make_cavity_case(n_interior=2048, poisson="multigrid",
   dtype=float32, tolerance_factor=1e-6) on cuda, its default solve (the
   float32 whole-solve), through Simulation.run(n_steps=300,
   steps_per_call=100), then 100 steps with whole_solve=False (the
   per-kernel solve). Launch counters are zeroed just before each run;
   every kernel of the path must have launched. Prints steps/s and
   V-cycles/step over the last 100 steps of each. The per-kernel 100 steps
   again from the same state with the plain twins of rows 3 and 4 in the
   kernels' place: equal cycles every step and bit-identical fields (so
   in phases 6 and 12).
4. Cavity card against CPU: the slice at 256^2 for 20 steps with the
   kernels on the card and the plain twins on the CPU, with the default
   solves (the whole-solve on the card, the per-kernel solve on the CPU),
   and with the f32 and the bf16 coarse hierarchy pinned: per-step V-cycle
   counts equal, fields within 5e-5 relative, avg_KE within 1e-6
   relative.
5. Per-kernel check at the 1536x512 channel shapes: the channel carry
   (error 0) and corrector (1e-5) against their twins, and the whole-solve kernel on a
   seeded source against its twin (the same cycles, p within 1e-5) and
   against the per-kernel composition of the cavity path's kernels
   (cycles within 1, p within 50 tol). Times as in phase 2; the
   whole-solve also per V-cycle. Then the cavity's f32 whole-solve at
   2048^2 against its twin on a seeded source (equal cycles and residual,
   p bit-identical), timed per V-cycle beside its bound.
6. The channel slice: make_channel_case(nx=1536, ny=512,
   poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0, dtype=float32)
   on cuda, 300 steps in chunks of 100, with the launch counters zeroed
   just before; every kernel of the path must have launched. Then 100
   steps of the same case with whole_solve=False (the per-kernel solve).
   Prints steps/s, V-cycles/step and cell-steps/s over the last 100 steps
   of each.
7. Channel card against CPU at 256x128, 20 steps, with the default path
   (the whole-solve on the card) and with whole_solve=False: cycles equal
   every step, fields within 5e-5 relative, avg_KE within 1e-6 relative.
8. Per-kernel check at the 2048x256 backward-step shapes: the masked carry
   and the masked finest-level pre and post kernels (rows 9c, 9d: one
   launch of shared-memory tiles each; error 0), the corrector (row 9b:
   one launch of one thread a plane cell over all four quads; error 0,
   with ``dev_ms`` and its device operations a call from a child
   time_carries), the full-2D coarse pairs (row 5b: one launch of tiles
   a call; error 0) on every level the path smooths (its two instances and
   1-3 pairs in both variants) on seeded inputs with b on the fluid cells,
   timed on level 1's pre-smooth with ``dev_ms`` and its device operations
   a call (time_pairs), and the masked
   whole-solve against its twin and against the per-kernel composition of
   the step's kernels (the same cycles, p within 1e-5). Times as in phase
   2, each with its bound; the pre and post kernels also with ``dev_ms``
   and their device operations a call, counted in a torch.profiler trace
   of one call in a fresh process (python -m cfd_tpu_torch.time_level0):
   one launch each, the post's last block folding its residual.
9. The step slice: make_backwards_step_case(nx=2048, ny=256,
   poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0, dtype=float32,
   print_interval=100, save_interval=100) on cuda, 300 steps in chunks of 100 with the launch
   counters zeroed just before; every kernel of the path must have
   launched. Then 100 steps with whole_solve=False (the per-kernel masked
   solve: the pre/post kernels and the full-2D pairs). Prints steps/s,
   V-cycles/step and cell-steps/s (n_fluid x steps/s) over the last 100
   steps of each.
10. Step card against CPU at 512x64, 20 steps, on both solves: cycles
    equal every step, fields within 5e-5 relative, avg_KE within 1e-6
    relative.
11. Per-kernel check at the 1536x512 Rayleigh-Benard shapes: the RB carry
    (the plain and the warm-start-guess variants) and the RB corrector
    against their twins (1e-5) on seeded inputs, and the pin-mean
    whole-solve on a seeded mean-free source against its twin and against
    the per-kernel composition (the same cycles, p within 1e-5), through
    both exits of its tolerance loop: the slice's configuration stops on
    the stall rule there, a copy with tol_factor 1e-3 on the tolerance.
    Times as in phase 2, each with its bound; the whole-solve also per
    V-cycle.
12. The RB slice: make_rayleigh_benard_case(nx=1536, ny=512, rayleigh=1e6,
    dtype=float32) on cuda (its own tolerances 1e-7 and 1e-10, V(2,1), the
    pin-mean whole-solve), 300 steps in chunks of 100 with the launch
    counters zeroed just before; every kernel of the path must have
    launched and u, v, p and T must stay finite. Then 100 steps with
    whole_solve=False (the per-kernel pin-mean solve). Prints steps/s,
    V-cycles/step and cell-steps/s (nx x ny x steps/s) over the last 100
    steps of each, and the last row's Nusselt numbers.
13. RB card against CPU at 256x128, 20 steps, on both solves: cycles equal
    every step, u, v, p and T within 5e-5 relative, avg_KE and
    nusselt_volume within 1e-6 relative.
14. Per-kernel check of the adaptive-stepping instances at the full shapes
    of phases 2, 5, 8 and 11: the traced-dt non-carry cavity stage, the
    traced-dt correctors and the traced-dt + Courant carries of the four
    flows against their twins (1e-5) with dt_corr = 0.8 dt and dt_pred =
    1.1 dt, each timed beside the fixed-dt instance on the same inputs.
    The non-carry stage (row 6: one launch of shared-memory tiles a call,
    csrc/quad_stage.cu), the step's corrector (row 9b+, csrc/step_stage.cu)
    and the carries error 0, with ``dev_ms``; rows 6 and 9b+ also with
    their device operations a call (a child time_carries process).
15. Adaptive runs through cfd_tpu_torch.adaptive.run_adaptive at the full
    widths, max_courant 0.7 from the case's own dt, the launch counters
    zeroed just before each: the cavity 2048^2 with the exact controller on
    the host loop (200 steps) and the lagged one in chunks of 100 (300
    steps), the channel 1536x512, the step 2048x256 (print_interval 100)
    and RB 1536x512, Ra = 1e6, lagged, 300 steps in chunks of 100. Each must
    launch its kernels, stay finite, print no Courant number above 0.7 *
    1.2 and take no dt above the diffusive ceiling; it prints steps/s and
    V-cycles/step over its last 100 steps, the final dt and its ratio to the
    case's dt, the last Courant number and the simulated time reached.
16. Adaptive card against CPU, 20 steps: the cavity at 256^2 with the bf16
    coarse hierarchy on both (the exact controller on the host loop and in
    chunks of 10, the lagged one), the
    channel at 256x128, the step at 512x64 and RB at 256x128 (lagged): the
    same dt every step, equal cycles, fields within 5e-5 relative.
17. The whole time step in one launch (mg_overrides whole_step=True) at
    the full widths of phases 3, 6, 9 and 12: each flavor's launch plan
    (the carry's tiles, blocks, registers, shared memory, the grid barriers
    of the carry and of a V-cycle), its kernel against its twin (the
    composition carry -> mean removal -> whole-solve twin) on seeded
    fields: bit-identical fields, equal cycles and residual; CUDA-event
    medians of 10 launches (the twin's of 3), the device time (``dev_ms``
    as in phase 2), the bound.
18. 300 steps of each flow with whole_step at the full widths, in chunks
    of 100, the counters zeroed just before: 300 launches of the flavor's
    kernel (the corrector runs only at the stats rows), the cycles of the
    composed whole-solve run of phases 3, 6, 9 and 12 at every step and a
    bit-identical carried state after 300 steps; steps/s, V-cycles/step.
19. Whole-step card against CPU, 20 steps, at 256^2, 256x128, 512x64 and
    256x128: equal cycles every step, fields within 5e-5 relative.
20. The fused coarse tail (mg_overrides tail_from=1): the tail kernel
    against its twin on a seeded source at the four flows' level-1 shapes
    and, on the cavity, from level 3 (bit-identical); times as in phase 2,
    the bound over one V-cycle of the tail's levels.
21. 100 steps of each flow with tail_from=1 from the state the per-kernel
    run of phases 3, 6, 9 and 12 started from, the counters zeroed just
    before: the tail launched once a V-cycle, no coarse smoother launch,
    the cycles of that per-kernel run at every step (within 1 on the
    channel) and its fields within 1e-5 relative; launches a step and
    steps/s beside the per-kernel run's.
22. The bfloat16 hierarchy (coarse_dtype="bfloat16"): the whole-solve
    kernels (separable on the cavity and the channel, pin-mean on RB,
    masked on the step) and the four whole steps against their twins at
    the full widths (bit-identical, equal cycles), then 300 steps of each
    flow on the bf16 whole-solve and on the bf16 whole step: the whole step
    held to the bf16 whole-solve run's cycles and carried state, as phase 18
    holds the float32 ones; V-cycles/step beside the float32 runs'.
23. The step with corr_opt: the masked whole-solve (float32 and bf16
    hierarchy) and the whole step against their twins at 2048x256
    (bit-identical), 300 steps on the whole-solve and on the whole step
    (held to each other as in phase 18), 100 steps of the per-kernel solve;
    V-cycles/step with and without corr_opt.
24. Card against CPU, 5 steps, at the widths of phase 19, for each new
    knob: tail_from=1, the bf16 whole-solve and the bf16 whole step on the
    four flows, corr_opt on the step's three solves: equal cycles every
    step, fields within 5e-5 relative.
25. The natural layout's kernels against their twins on seeded inputs
    (limit 1e-5, bit-identical expected), times as in phase 2: the four
    stage kernels of csrc/projection.cu at the full-width aligned shapes
    (cavity 2056x2176, channel 520x1664; the cavity's predictor + source,
    row 11, one launch of shared-memory tiles a call, and the channel's,
    row 11-ch, a launch of tiles and the sum's: error 0, with ``dev_ms`` and
    their device operations a call from a child time_carries process), the
    with_residual pairs at the
    cavity's aligned level 0 (row 5-wr, error 0, with ``dev_ms`` and its
    device operations a call; the level's pre-smooth error 0 too), the
    step's exact masked pairs (rows 12 and 12-res: one launch of
    shared-memory tiles a call, csrc/step_smoother.cu; three variants,
    error 0, with ``dev_ms`` and their device operations a call from a
    child time_pairs process) at the natural step's level 0 (512x30).
26. The natural slices at full width, counters zeroed before each run and
    every kernel of the path required to launch: the cavity at 2048^2 with
    layout="aligned" (300 steps in chunks of 100), the channel at 1536x512
    with layout="aligned" (300), the cavity by the auto rule at
    n_interior=142 and the step by the auto rule at 512x30 (2 levels; the
    dense pinv of 5041 and 3840 cells is built on the host, which sets
    these sizes), 100 steps each; steps/s, V-cycles/step and cell-steps/s
    over the last 100 steps beside the quad whole-solve runs of phases 3,
    6 and 9.
27. Card against CPU over 20 steps at small natural sizes (the cavity
    aligned at 64^2 and by the auto rule at 46^2, the channel at 128x30,
    the step at 128x14): equal cycles every step, fields within 5e-5,
    avg_KE within 1e-6 relative.
28. The cavity's fused-pre carry (row 7, one cooperative launch of the
    carry's tiles, one grid barrier, the separable pre tiles;
    csrc/quad_fused_pre.cu) at 2048^2 and the channel's non-carry stage
    (row 8c, a launch of shared-memory tiles and the sum's) at 1536x512
    against their twins (error 0, with ``dev_ms`` and their device
    operations a call from a child time_carries process); row 7 timed in
    turns with the composed carry -> pre pair it replaces, wrapper and
    device ms.
29. The fused-pre path: make_cavity_case(fuse_pre=True,
    mg_overrides={"whole_solve": False}) at 2048^2, 300 steps from the
    initial state beside a per-kernel run from the same state, then 100
    steps with tail_from=1 from phase 21's start state beside phase 21's
    tail run: equal cycles every step and bit-identical carried fields;
    one fused launch a step, the pre kernel only on cycles >= 2.
30. Row 8c on a path: the channel 1536x512 with its carry replaced by the
    split ordering corrector -> row 8c (split_channel; make_step removes
    the mean and runs the whole-solve), 300 steps from the initial state
    beside phase 6's carried run: equal cycles every step, fields within
    1e-5 relative (bit-identical expected).
31. Card against CPU over 20 steps: the fused-pre cavity at 256^2 and the
    split channel at 256x128.
32. The shard kernels (rows 16a-16c: the cavity's carry, pre and post on
    one shard's local block: the entry points of rows 1, 3 and 4 told the
    block's row_base and halo) at the 2048^2 shapes of a
    4-shard plane-row mesh (P = 264, local blocks (4, 280, 1152)), for
    shards 0, 1 and 3: bit-identical to their twins on every row, and on
    the own rows equal to the single-device kernels (rows 1, 3, 4) on the
    same global rows; times on shard 1 as in phase 2, the bound of one
    local block; rows 16b and 16c (one launch of tiles each) with
    ``dev_ms`` and their device operations a call (a child time_level0
    process).
33. The sharded cavity: make_cavity_case(n_interior=2048, dtype=float32,
    tolerance_factor=1e-6) on make_mesh(4) (every shard on the card),
    Simulation(mesh=, sharded_kwargs={"tol_factor": 1e-6}), 300 steps in
    chunks of 100 beside the single-device per-kernel run with the float32
    coarse hierarchy (mg_overrides whole_solve=False, fuse_pre=False) from
    the same initial state: cycles within 1 on every step, fields within
    2e-5 of scale (bit-identical expected, and reported); steps/s,
    V-cycles/step, launches/step. Then 100 steps with tail_from=1 beside
    that run's first 100, and a 1-shard mesh with default kwargs, which
    delegates: rows 1, 3 and 4 launch, 16a-16c do not.
34. The sharded cavity card against CPU over 20 steps, at 256^2 on 4
    shards (P = 40) and at 64^2 on 8 (P = 8, the minimum): equal cycles
    every step, fields within 5e-5.
35. The channel's and RB's shard carries (rows 16d, 16e: the entry points
    of rows 8a and 10 told the block's row_base and halo) at the 1536x512
    shapes of a 4-shard mesh (P = 72, local blocks (4, 88, 896)), for
    shards 0, 1 and 3: bit-identical to their twins on every row, the
    own-row sums included, and on the own rows equal to rows 8a and 10 on
    the same global rows; times on shard 1 as in phase 2, the bound of one
    local block.
36. The sharded channel and RB at 1536x512 on make_mesh(4), 200 steps
    each (SHARD_RUN): the channel with tol_factor 1e-6 (make_channel_case(
    tolerance_factor=1e-6, abs_tol=0)), RB with tol_factor 1e-7 and abs_tol
    1e-10 (make_rayleigh_benard_case(rayleigh=1e6)). Held (a) over all 200
    steps to the single-device per-kernel run (mg_overrides
    whole_solve=False) whose source sums and RB's pin sums add the same
    per-shard partials in shard order (shard_order_case): equal cycles and
    bit-identical fields, i.e. the sum order is the only difference; (b)
    over the first 3 steps (the reference test's horizon) to the plain
    single-device per-kernel run at the reference's bands: cycles within 1,
    u and v within 2e-5 of scale, p within 5e-4 (channel: the source sum's
    float32 order) or 2e-5 (RB), T within 2e-5. Over 200 steps that
    float32 difference, amplified by the solves' stall exits, moves cycles
    by up to 2 and the fields past the bands, so the 200-step gap from the
    plain run is printed as a measurement. Also steps/s, V-cycles/step,
    launches/step and RB's last Nusselt numbers beside the single-device
    run's. Then 100 steps of each with tail_from=1 beside the sharded run's
    first 100 (the bands of (b)), and a 1-shard mesh of each with default
    kwargs, which delegates: rows 8a and 10 launch, 16d and 16e do not.
37. The sharded channel and RB card against CPU over 20 steps on 4 shards:
    the channel at 256x128 (P = 24) and 96x32 (P = 8, the minimum), RB at
    256x128: equal cycles every step, fields within 5e-5.
38. The step's shard kernels (row 16f: the carry, pre and post, the entry
    points of rows 9a, 9c and 9d told the block's row_base and halo) at the
    2048x256 shapes of a 4-shard mesh (P = 40, local blocks (4, 56, 1152);
    the first solid row, plane row 64, is shard 1's local row 32), for
    shards 0, 1 and 3: bit-identical to their twins on every row, and on
    the own rows equal to rows 9a, 9c and 9d (the per-kernel V(1,1)
    solve's) on the same global rows; times on shard 1 as in phase 2 (the
    pre and post kernels with ``dev_ms`` and device operations a call as
    in phase 8), the bound of one local block (its fluid cells for the
    operations).
39. The sharded step: make_backwards_step_case(nx=2048, ny=256,
    tolerance_factor=1e-6, abs_tol=0) on make_mesh(4), Simulation(mesh=,
    sharded_kwargs={"tol_factor": 1e-6}), 200 steps (V(1,1), the masked
    defect correction on the shards). Held (a) over all 200 steps to the
    single-device per-kernel V(1,1) run whose source sums add the shards'
    own-row partials in shard order (shard_order_case): equal cycles and
    bit-identical fields; (b) over the first 3 steps to the plain
    single-device per-kernel V(1,1) run at the reference's bands
    (tests/test_quad_sharded.py:233-280): cycles within 1, u and v within
    2e-5 of scale, p within 5e-4 (the reference's band for the source
    mean's float32 rounding, :210-222, as phase 36's channel: at 2048x256
    p's gap measured 2.05e-5 of scale on an H100 at 700 W); the 200-step
    gap printed. Steps/s beside the
    single-device run's, V-cycles/step, launches/step. Then 100 steps with
    tail_from=1 (the fused tail from level 2) bit-identical to the sharded
    run's first 100, and a 1-shard mesh with default kwargs, which
    delegates: rows 9a, 9c, 9d launch, 16f does not.
40. The sharded step card against CPU over 20 steps: 512x64 on 4 shards
    (P = 16, the corner row on shard 1's first own row) and 32x8 on 2 (the
    coarse switch at level 1): equal cycles every step, fields within 5e-5.
41. The four traced-dt + Courant carries on a shard's local block (rows
    16a+, 16d+, 16e+, 16f+: the entry points of rows 1+, 8a+, 10+ and 9a+
    told the block's row_base and halo) at the full widths' 4-shard blocks
    (the cavity (4, 280, 1152), P = 264; the channel and RB (4, 88, 896),
    P = 72; the step (4, 56, 1152), P = 40), dt_corr = 0.8 dt, dt_pred =
    1.1 dt, on shards 0, 1 and 3: bit-identical to their twins on every
    output, max|u| and max|v| included; on the own rows equal to rows 1+,
    8a+, 10+ and 9a+ on the same global rows; the maxima of max|u|, max|v|
    over the 4 shards equal to the whole field's, and unmoved by halo rows
    set to +-1e3; times on shard 1 beside the fixed-dt shard carry (16a,
    16d, 16e, 16f) on the same inputs, the bound of one local block.
42. The sharded lagged runs (ShardedQuadProjection.make_adaptive through
    run_adaptive) at full width on make_mesh(4): max_courant 0.7, growth
    1.2, the case's dt, 200 steps in chunks of 100 (ADAPTIVE_RUN), the
    counters zeroed just before: 4 launches a step of the flavor's row, none
    of the single-device carry's; finite fields, no printed Courant number
    above 0.84, no dt above the diffusive ceiling. Held (a) over all 200
    steps to
    the single-device lagged per-kernel run (the cavity with the float32
    coarse hierarchy; the channel, RB and the step, V(1,1), with their sums
    in shard order, shard_order_case): the same dt and cycles every step,
    bit-identical fields; (b) over 3 steps (a stats row each) to the plain
    single-device lagged run: dt within 1e-5 and Courant within 1e-4
    relative, cycles within 1, u and v within 2e-5 of scale, p within 5e-4
    (the channel, the step) or 2e-5; the 200-step gap from the plain run is
    printed. Steps/s, V-cycles/step, launches a step, the final dt and the
    simulated time. A 1-shard mesh delegates: rows 1+, 8a+, 10+ and 9a+
    launch, the shard instances do not.
43. The sharded lagged runs card against CPU over 20 steps on 4 shards: the
    cavity at 256^2, the channel 256x128, RB 256x128 and the step 512x64:
    the same dt and cycles every step, fields within 5e-5.

The line before the last is a JSON object {"kernels": [...]}: per kernel,
its launches on its path's run, its error against its twin, its time and
its twin's, and its bound: the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and its float32
operations (counted per cell below) over 67 TFLOP/s, the H100 SXM's
spec-sheet peaks. The correctors' bytes count their inputs' logical cells
only, since a corrector needs none of the padding (logical_nbytes); the
other kernels' count every element. The last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_MAIN = 2048
CHANNEL = (1536, 512)
TOL_F32 = 1e-5
PEAK_BYTES_S = 3.35e12  # H100 SXM device memory, spec sheet
PEAK_F32_S = 67e12      # H100 SXM float32 outside the tensor cores, spec sheet
# float32 operations per cell, counted from the kernels' formulas: one
# red/black update (gs_update), one residual b - A p, one prolongation
# value and its add, the restriction sums per coarse cell, the predictor
# (u* and v*) with the source, and a corrector (two faces and the guess)
GS_OPS, RES_OPS, PROLONG_OPS, RESTRICT_OPS = 20, 14, 10, 4
PREDICTOR_SOURCE_OPS, CORRECTOR_OPS = 76, 8
# the step's exact fine level: one (1 - omega)*p + omega*gs update and one
# b - lap residual per fluid cell (step_level0.cuh); the solid fill per
# coarse cell
STEP_GS_OPS, STEP_RES_OPS, FILL_OPS = 10, 10, 8
STEP = (2048, 256)
# the RB carry's temperature update (the two face fluxes, the advection and
# the diffusion, the Euler step) and buoyancy per cell (rb_stage.cu); the
# pin per cell per cycle (the sum and the shift)
TEMPERATURE_OPS, BUOYANCY_OPS, PIN_OPS = 24, 3, 2
# corr_opt per level-1 cell: A e, the two products and sums, the scaling
CORR_OPS = 18
RB_SHAPE = (1536, 512)
# adaptive stepping: the Courant feedback per cell (two |.|, two maxima);
# the controller's target and growth
COURANT_OPS = 4
MAX_CO, GROWTH = 0.7, 1.2
# the natural step's size (phases 25, 26): ny = 14 mod 16 has no quad
# layout, and 512 / 2 * 30 / 2 = 3840 coarsest cells keep the host's dense
# pinv build short
NATURAL_STEP = (512, 30)
# the sharded paths (phases 32-43): shards of the plane-row mesh on the card
SHARDS = 4
# the steps of the sharded per-kernel runs of phases 36 and 39 and of the
# sharded lagged runs of phase 42 (with their steps per call): host-bound
# runs of 30-130 launches a step, cut from 300 to keep the whole check well
# inside its time limit
SHARD_RUN = 200
ADAPTIVE_RUN = (SHARD_RUN, 100)


# the kernels of the one-launch tile carries (csrc/carry_tile.cuh), the
# finest-level tile kernels (csrc/quad_vcycle.cu, csrc/step_vcycle.cu),
# the coarse smoother's (csrc/rb_smoother.cu, every instance), the
# cavity's and the channel's non-carry predictors' (csrc/quad_stage.cu,
# csrc/projection.cu) and the step's corrector (csrc/step_stage.cu), held to
# error 0 against their twins wherever the phases check them: kernel name
# -> row (the shard rows 16a-16f and their + instances through
# check_shard_op, which holds every shard row bit for bit)
REDESIGNED = {"quad_corr_predictor_source": "row 1",
              "quad_corr_predictor_source_adaptive": "row 1+",
              "quad_channel_corr_predictor_source": "row 8a",
              "quad_channel_corr_predictor_source_adaptive": "row 8a+",
              "quad_step_corr_predictor_source": "row 9a",
              "quad_step_corr_predictor_source_adaptive": "row 9a+", "quad_rb_step": "row 10",
              "quad_rb_step_adaptive": "row 10+",
              "quad_step_pre_smooth_restrict": "row 9c",
              "quad_step_post_prolong_smooth": "row 9d",
              "quad_pre_smooth_restrict": "row 3", "quad_post_prolong_smooth": "row 4",
              "quad_pre_smooth_restrict_shard": "row 16b",
              "quad_post_prolong_smooth_shard": "row 16c",
              "rb_pairs": "row 5", "rb_pairs_full": "row 5b", "rb_pairs_residual": "row 5-wr",
              "quad_corr_predictor_source_fused_pre": "row 7",
              "step_masked_pairs": "row 12", "step_masked_pairs_res": "row 12-res",
              "quad_predictor_source": "row 6",
              "projection_predictor_source": "row 11",
              "quad_channel_predictor_source": "row 8c",
              "projection_channel_predictor_source": "row 11-ch",
              "quad_step_corrector": "row 9b", "quad_step_corrector_traced": "row 9b+",
              **{f"quad_whole_step_{flow}{v}": "row 15" for flow in ("cavity", "channel",
                                                                     "rb", "step")
                 for v in ("", "_bf16")}, "quad_whole_step_step_corr_opt": "row 15"}

T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's first line carries the seconds since start."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - T0:.1f} s]"
    print(msg, flush=True)


def import_port():
    sys.path.insert(0, str(ROOT))
    try:
        import cfd_tpu_torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: cfd_tpu_torch not found next to {__file__} "
                         f"({e}); run it from a checkout of the repository")
    if Path(cfd_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: imported {cfd_tpu_torch.__file__}, not the "
                         f"checkout at {ROOT}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(got, want, what: str, tol: float, errs: list) -> float:
    got = torch.as_tensor(got).float()
    want = torch.as_tensor(want).float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    abs_err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    log(f"  {what:46s} max|err|={abs_err:.3e}  rel={rel:.3e}  (limit {tol:.1e})")
    if not rel <= tol:
        raise AssertionError(f"{what}: relative error {rel:.3e} > {tol:.1e}")
    errs.append(abs_err)
    return abs_err


def bit_identical(name: str, errs: list) -> None:
    """Raise unless every output of the redesigned kernel ``name``
    (REDESIGNED) equals its twin's: a redesign keeps the bits (error 0)."""
    what = f"{name} ({REDESIGNED[name]}, redesigned)"
    if max(errs) != 0:
        raise AssertionError(f"{what}: max|err| {max(errs)!r} against its twin, 0 expected")
    log(f"  {what}: bit-identical to its twin (error 0)")


def carry_dev_ms(fn) -> float:
    """A kernel's device ms a call (cfd_tpu_torch.time_whole_solve.dev_ms:
    CUDA events around 50 back-to-back calls, the card busy while the host
    queues them); raises if the host fell behind."""
    from cfd_tpu_torch.time_whole_solve import dev_ms

    ms, ahead = dev_ms(fn)
    if not ahead:
        raise AssertionError("dev_ms: the host did not queue the timed calls ahead of the card")
    return ms


def dev_note(r: dict) -> str:
    """A kernel's device ms (and its device operations a call) beside its
    wrapper's ms in a phase's line."""
    ops = f", {r['launches_a_call']} a call" if "launches_a_call" in r else ""
    return f" (device {r['dev_ms']:.4f} ms{ops})" if "dev_ms" in r else ""


# the rows whose device operations a call a child timer process counts
# (child_launches): every row of the main path's instances a phase holds
CHILD_ROWS = {"time_level0": ("3", "4", "16b", "16c", "9c", "9d", "16f-pre", "16f-post"),
              "time_pairs": ("5", "5b", "5-wr", "12", "12-res"),
              "time_carries": ("7", "6", "11", "8c", "11-ch", "9b", "9b+")}
# the device operations a call of the rows that are not one launch: the
# channel's non-carry stages, a tile launch and the sum's
CHILD_OPS = {"8c": 2, "11-ch": 2}
_CHILD_COUNTS: dict = {}


def _child_counts(rows, module: str) -> dict:
    """{row: device operations a call} of ``rows`` from one run of the
    timer ``module`` in a fresh process."""
    out = subprocess.run(
        [sys.executable, "-m", f"cfd_tpu_torch.{module}", "smoke", "--only", ",".join(rows),
         "--reps", "5"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"{module} exited {out.returncode}:\n{out.stderr[-4000:]}")
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    return {r["row"]: r["launches_a_call"] for r in lines}


def child_launches(rows, module: str) -> dict:
    """{row: device operations a call} of the tile kernels that the timer
    ``module`` times on the main path's instances (time_level0's rows 3,
    4, 16b, 16c, 9c, 9d, 16f-pre, 16f-post: the finest-level kernels;
    time_pairs' rows 5, 5b, 5-wr: the coarse smoother, and 12, 12-res:
    the natural step's pairs; time_carries' rows 7: the fused-pre carry,
    6 and 11: the cavity's non-carry predictors, quad and natural, 8c and
    11-ch: the channel's, 9b and 9b+: the step's corrector), each counted in a
    torch.profiler trace of one call (profile_step.device_ops_a_call). The
    first call counts all of the timer's CHILD_ROWS in one fresh process
    and a row whose trace held no device event again in a process of its
    own: a process's later traces have come back empty on the H100
    machine, its first one has not. A trace may also miss some of a
    call's events, never add one: a row that counted fewer operations than
    it launches (one; the rows of CHILD_OPS: their count) is counted again
    the same way, and keeps the larger count. Raises unless each is one
    launch (the rows of CHILD_OPS: their count)."""
    if module not in _CHILD_COUNTS:
        got = _child_counts(CHILD_ROWS[module], module)
        for row in CHILD_ROWS[module]:
            if (got.get(row) or 0) < CHILD_OPS.get(row, 1):
                again = _child_counts((row,), module).get(row) or 0
                got[row] = max(got.get(row) or 0, again)
        _CHILD_COUNTS[module] = got
    got = {row: _CHILD_COUNTS[module].get(row) for row in rows}
    for row, n in got.items():
        if n != CHILD_OPS.get(row, 1):
            raise AssertionError(f"row {row}: {n} device operations a call, "
                                 f"{CHILD_OPS.get(row, 1)} expected")
    return got


def host(out):
    """A solve's or a step's outputs with (cycles, res) read to the host: the
    whole-solve and whole-step wrappers leave them on the card."""
    *fields, cycles, res = out
    return (*fields, int(cycles), float(res))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def logical_nbytes(shape, *tensors) -> int:
    """The bytes of ``tensors``' cells on the logical grid ``shape`` (ny + 2,
    nx + 2), their padding left out: what a corrector must read of each
    input, quad or natural layout."""
    return sum(shape[0] * shape[1] * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger (ms)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def check_kernels(case, dev) -> dict:
    """Phase 2: every kernel against its plain twin at the case's shapes."""
    from cfd_tpu_torch.kernels.quad import to_quad
    from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level
    from cfd_tpu_torch.poisson.multigrid import _build_level, build_problems

    rng = np.random.default_rng(2048)
    g = case.grid
    shape = g.shape
    inner = np.zeros(shape, np.float32)
    inner[1:-1, 1:-1] = 1.0

    def field(scale=0.1, interior_only=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if interior_only:
            a *= inner
        return to_quad(torch.from_numpy(a).to(dev), shape)

    results = {}
    carry, corr = case.step_kernels
    solve = case.poisson_solve

    # 1. carry stage
    us, vs, p, p_prev = field(), field(), field(interior_only=True), field(interior_only=True)
    errs = []
    got, want = carry.kernel(us, vs, p, p_prev), carry.plain(us, vs, p, p_prev)
    for name, a, b in zip(("us'", "vs'", "b", "guess", "max|b|"), got, want):
        rel_err(a, b, f"quad_corr_predictor_source {name}", TOL_F32, errs)
    bit_identical("quad_corr_predictor_source", errs)
    cells = g.nx * g.ny
    results["quad_corr_predictor_source"] = dict(
        err=max(errs), ms=median_ms(lambda: carry.kernel(us, vs, p, p_prev)),
        dev_ms=carry_dev_ms(lambda: carry.kernel(us, vs, p, p_prev)),
        plain_ms=median_ms(lambda: carry.plain(us, vs, p, p_prev)),
        **bound(nbytes(us, vs, p, p_prev, *got),
                cells * (CORRECTOR_OPS + PREDICTOR_SOURCE_OPS)))

    # 2. corrector
    errs = []
    got, want = corr.kernel(us, vs, p, p_prev), corr.plain(us, vs, p, p_prev)
    for name, a, b in zip(("u", "v", "guess"), got, want):
        rel_err(a, b, f"quad_corrector {name}", TOL_F32, errs)
    results["quad_corrector"] = dict(
        err=max(errs), ms=median_ms(lambda: corr.kernel(us, vs, p, p_prev)),
        plain_ms=median_ms(lambda: corr.plain(us, vs, p, p_prev)),
        **bound(logical_nbytes(shape, us, vs, p, p_prev) + nbytes(*got),
                cells * CORRECTOR_OPS))

    # 3./4. finest-level V-cycle kernels (b on the interior, as the carry
    # emits): one launch of shared-memory tiles each, bit-identical; their
    # device ms, and their device operations a call from time_level0 (the
    # same instances)
    b = field(scale=1e3, interior_only=True)
    pre, post = solve.pre0, solve.post0
    errs = []
    got, want = pre.kernel(p, b), pre.plain(p, b)
    for name, a, w in zip(("p", "rc"), got, want):
        rel_err(a, w, f"quad_pre_smooth_restrict {name}", TOL_F32, errs)
    bit_identical("quad_pre_smooth_restrict", errs)
    ops = child_launches(("3", "4"), "time_level0")
    weights = (pre.wE, pre.wW, pre.wN, pre.wS)
    results["quad_pre_smooth_restrict"] = dict(
        err=max(errs), ms=median_ms(lambda: pre.kernel(p, b)),
        dev_ms=carry_dev_ms(lambda: pre.kernel(p, b)), launches_a_call=ops["3"],
        plain_ms=median_ms(lambda: pre.plain(p, b)),
        **bound(nbytes(p, b, *got, *weights),
                cells * (pre.n_pairs * GS_OPS + RES_OPS) + cells // 4 * RESTRICT_OPS))
    Hc, Wc = pre.coarse_shape
    ec_np = np.zeros((Hc, Wc), np.float32)
    ec_np[1 : g.ny // 2 + 1, 1 : g.nx // 2 + 1] = rng.standard_normal(
        (g.ny // 2, g.nx // 2)).astype(np.float32) * 0.1
    ec = torch.from_numpy(ec_np).to(dev)
    errs = []
    got, want = post.kernel(p, b, ec), post.plain(p, b, ec)
    for name, a, w in zip(("p", "max|r|"), got, want):
        rel_err(a, w, f"quad_post_prolong_smooth {name}", TOL_F32, errs)
    bit_identical("quad_post_prolong_smooth", errs)
    results["quad_post_prolong_smooth"] = dict(
        err=max(errs), ms=median_ms(lambda: post.kernel(p, b, ec)),
        dev_ms=carry_dev_ms(lambda: post.kernel(p, b, ec)), launches_a_call=ops["4"],
        plain_ms=median_ms(lambda: post.plain(p, b, ec)),
        **bound(nbytes(p, b, ec, *got, *weights),
                cells * (PROLONG_OPS + post.n_pairs * GS_OPS + RES_OPS + 1)))

    # 5. coarse smoother (row 5): every level shape the per-kernel cavity,
    # channel and RB solves smooth, float32 and bfloat16, 1 and 2 pairs,
    # both variants, bit-identical; timed at the cavity's bf16 level 1
    # pre-smooth (2 pairs, the residual field), its device time and device
    # operations a call from time_pairs (the same instance)
    from cfd_tpu_torch.poisson.multigrid import channel_problem, neumann_problem

    errs, timing = [], None
    hierarchies = (("cavity", solve_problem(case)),
                   ("channel", channel_problem(*CHANNEL, 3.0 / CHANNEL[0], 1.0 / CHANNEL[1])),
                   ("rb", neumann_problem(*RB_SHAPE, 3.0 / RB_SHAPE[0], 1.0 / RB_SHAPE[1])))
    for flow, problem in hierarchies:
        probs = build_problems(problem, solve.cfg)
        for k, prob in enumerate(probs[1:-1], start=1):
            for dt in (torch.float32, torch.bfloat16):
                lv = _build_level(prob, dt, dev)
                H8, W = lv.shape
                a = np.zeros((H8, W), np.float32)
                a[1 : prob.ny + 1, 1 : prob.nx + 1] = rng.standard_normal((prob.ny, prob.nx))
                bb = torch.from_numpy(a * 1e2).to(dev, dt)
                pp = torch.from_numpy(a * 0.1).to(dev, dt)
                for n_pairs, field_variant in ((2, True), (1, False), (1, True), (2, False)):
                    sm = rb_pairs_for_level(lv, solve.cfg.omega, n_pairs,
                                            with_residual_field=field_variant)
                    got, want = sm.kernel(pp, bb), sm.plain(pp, bb)
                    got = got if field_variant else (got,)
                    want = want if field_variant else (want,)
                    tag = f"rb_pairs {flow} L{k} {tuple(lv.shape)} {str(dt)[6:]} n={n_pairs}"
                    for name, x, y in zip(("p", "r"), got, want):
                        rel_err(x, y, f"{tag} {name}", TOL_F32, errs)
                    if (flow, k, dt, n_pairs, field_variant) == ("cavity", 1, torch.bfloat16,
                                                                solve.cfg.pre_sweeps, True):
                        timing = dict(ms=median_ms(lambda: sm.kernel(pp, bb)),
                                      dev_ms=carry_dev_ms(lambda: sm.kernel(pp, bb)),
                                      plain_ms=median_ms(lambda: sm.plain(pp, bb)),
                                      **bound(nbytes(pp, bb, *got, sm.wE, sm.wW, sm.wN, sm.wS),
                                              prob.nx * prob.ny * (n_pairs * GS_OPS + RES_OPS)))
    bit_identical("rb_pairs", errs)
    timing["launches_a_call"] = child_launches(("5",), "time_pairs")["5"]
    results["rb_pairs"] = dict(err=max(errs), **timing)
    log(f"  rb_pairs (cavity L1 bf16, n=2, residual field): {timing['ms']:.4f} ms"
        f"{dev_note(timing)}, bound {timing['bound_ms']:.4f} ms")
    return results


def check_level0_pair(what: str, pre, post, g, dev, seed: int) -> None:
    """A flow's finest-level pre and post kernels (rows 3, 4 at its V(pre,
    post), the same entry points as the cavity's) against their twins at
    its shapes on seeded inputs (p and b on the interior, ec on the coarse
    interior), bit for bit."""
    from cfd_tpu_torch.kernels.quad import to_quad

    rng = np.random.default_rng(seed)
    shape = g.shape
    inner = np.zeros(shape, np.float32)
    inner[1:-1, 1:-1] = 1.0
    p, b = (to_quad(torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                                     * inner).to(dev), shape) for scale in (0.1, 1e3))
    ec = torch.zeros(pre.coarse_shape, device=dev)
    ec[1 : g.ny // 2 + 1, 1 : g.nx // 2 + 1] = torch.from_numpy(
        (rng.standard_normal((g.ny // 2, g.nx // 2)) * 0.1).astype(np.float32)).to(dev)
    for name, op, args, outs in (("quad_pre_smooth_restrict", pre, (p, b), ("p", "rc")),
                                 ("quad_post_prolong_smooth", post, (p, b, ec),
                                  ("p", "max|r|"))):
        errs = []
        for out, a, w in zip(outs, op.kernel(*args), op.plain(*args), strict=True):
            rel_err(a, w, f"{name} {what} n={op.n_pairs} {out}", TOL_F32, errs)
        bit_identical(name, errs)


def twin_level0_run(case, what: str, start, start_step: int, ref_iters, ref_state) -> None:
    """The per-kernel path of ``case`` again for len(ref_iters) steps from
    the same start, the finest-level pre and post kernels' plain twins in
    their place on the card (every other kernel unchanged), held to the
    kernel run (ref_iters, ref_state): equal cycles every step and
    bit-identical fields, so that rows 3 and 4 keep the path's cycles."""
    solve = case.poisson_solve
    ops = (solve.pre0, solve.post0)
    for op in ops:
        op.kernel = op.plain
    try:
        sim, state = run_slice(case, len(ref_iters), 100, start, start_step)
    finally:
        for op in ops:
            del op.kernel
    hold_run(f"{what} per-kernel vs its run with the level-0 twins", sim.step_iters, state,
             ref_iters, ref_state, exact=True)


def solve_problem(case):
    from cfd_tpu_torch.poisson.multigrid import cavity_problem

    g = case.grid
    return cavity_problem(g.nx, g.ny, g.dx, g.dy)


def run_slice(case, n_steps: int, spc: int, state=None, start_step: int = 0):
    from cfd_tpu_torch.solver import Simulation

    sim = Simulation(case, log=lambda m: log("  " + m))
    state = sim.run(state=state, n_steps=n_steps, start_step=start_step,
                    steps_per_call=spc)
    torch.cuda.synchronize()
    return sim, state


def run_path(case, n_steps: int, path_kernels, what: str, card: str, rate,
             state=None, start_step: int = 0):
    """Drive a main path through Simulation.run in chunks of 100 steps with
    every launch counter zeroed just before and read just after; every
    kernel of ``path_kernels`` must have launched. ``rate`` is (name, cells
    per step as a function of V-cycles/step). Returns (launches, carried
    state, steps/s and V-cycles/step over the last 100 steps)."""
    from cfd_tpu_torch.kernels import KERNELS

    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    sim, state = run_slice(case, n_steps, 100, state, start_step)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    log(f"  launches: {launches}")
    missing = [k.name for k in path_kernels if launches[k.name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {what} path: {missing}")
    st = sim._logical(state)
    for fname in ("u", "v", "p", "T"):
        a = getattr(st, fname)
        if a is not None and not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {fname} after the {what} run")
    ke = sim.history[-1]["avg_kinetic_energy"]
    if not ke > 0:
        raise AssertionError(f"avg_KE={ke} after the {what} run")
    cycles = float(np.mean(sim.step_iters[-100:]))
    walls = [0.0] + [row["wall_seconds"] for row in sim.history]
    steps_s = 100 / (walls[-1] - walls[-2])
    log(f"  {what}: {n_steps} steps in {wall:.2f} s; last 100: {steps_s:.2f} steps/s, "
        f"{cycles:.2f} V-cycles/step, {rate[1](cycles) * steps_s:.4e} {rate[0]}, "
        f"avg_KE={ke:.6f} ({card})")
    return launches, state, dict(steps_s=steps_s, cycles=cycles, row=sim.history[-1],
                                 iters=list(sim.step_iters))


def card_vs_cpu(make, kw: dict, what: str, n_steps: int = 20, shards: int | None = None,
                sharded_kwargs: dict | None = None) -> None:
    """One card-against-CPU comparison: the kernels on the card, the plain
    twins on the CPU, ``n_steps`` steps; with ``shards``, on a mesh of that
    many shards of the device (Simulation(mesh=, sharded_kwargs=))."""
    from cfd_tpu_torch.parallel import make_mesh
    from cfd_tpu_torch.solver import Simulation

    out = {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        mesh = make_mesh(shards, device=dev) if shards else None
        sim = Simulation(make(device=dev, **kw), log=lambda m: None, mesh=mesh,
                         sharded_kwargs=sharded_kwargs)
        st = sim._logical(sim.run(n_steps=n_steps))
        out[where] = (sim.step_iters, st, sim.history[-1])
    (it_g, st_g, row_g), (it_c, st_c, row_c) = out["card"], out["cpu"]
    log(f"  {what}: cycles/step card {it_g}")
    log(f"  {what}: cycles/step cpu  {it_c}")
    if it_g != it_c:
        raise AssertionError(f"{what}: card and CPU cycle counts differ")
    for name in ("u", "v", "p", "T"):
        if getattr(st_c, name) is None:
            continue
        a = getattr(st_g, name).float().cpu()
        b = getattr(st_c, name).float()
        rel_err(a, b, f"{what} card vs cpu {name}", 5e-5, [])
    for key in ("avg_kinetic_energy", "nusselt_volume"):
        if key not in row_c:
            continue
        rel = abs(row_g[key] - row_c[key]) / abs(row_c[key])
        log(f"  {what} {key} card {row_g[key]!r} cpu {row_c[key]!r} rel {rel:.3e} "
            f"(limit 1e-6)")
        if not rel <= 1e-6:
            raise AssertionError(f"{what}: {key} differs by {rel:.3e}")


def check_channel_kernels(case, dev) -> dict:
    """Phase 5: the channel stage kernels and the whole-solve against their
    twins at the channel's shapes."""
    from cfd_tpu_torch.kernels.quad import to_quad

    rng = np.random.default_rng(1536)
    g = case.grid
    shape = g.shape
    cells = g.nx * g.ny
    inner = np.zeros(shape, np.float32)
    inner[1:-1, 1:-1] = 1.0

    def field(scale=0.1, interior_only=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if interior_only:
            a *= inner
        return to_quad(torch.from_numpy(a).to(dev), shape)

    results = {}
    carry, corr = case.step_kernels
    us, vs, p, p_prev = field(), field(), field(interior_only=True), field(interior_only=True)
    errs = []
    got, want = carry.kernel(us, vs, p, p_prev), carry.plain(us, vs, p, p_prev)
    for name, a, b in zip(("us'", "vs'", "b", "guess", "sum b"), got, want):
        rel_err(a, b, f"quad_channel_corr_predictor_source {name}", TOL_F32, errs)
    bit_identical("quad_channel_corr_predictor_source", errs)
    results["quad_channel_corr_predictor_source"] = dict(
        err=max(errs), ms=median_ms(lambda: carry.kernel(us, vs, p, p_prev)),
        dev_ms=carry_dev_ms(lambda: carry.kernel(us, vs, p, p_prev)),
        plain_ms=median_ms(lambda: carry.plain(us, vs, p, p_prev)),
        **bound(nbytes(us, vs, p, p_prev, *got),
                cells * (CORRECTOR_OPS + PREDICTOR_SOURCE_OPS)))
    errs = []
    got, want = corr.kernel(us, vs, p, p_prev), corr.plain(us, vs, p, p_prev)
    for name, a, b in zip(("u", "v", "guess"), got, want):
        rel_err(a, b, f"quad_channel_corrector {name}", TOL_F32, errs)
    results["quad_channel_corrector"] = dict(
        err=max(errs), ms=median_ms(lambda: corr.kernel(us, vs, p, p_prev)),
        plain_ms=median_ms(lambda: corr.plain(us, vs, p, p_prev)),
        **bound(logical_nbytes(shape, us, vs, p, p_prev) + nbytes(*got),
                cells * CORRECTOR_OPS))

    # the whole-solve on a seeded, mean-free source from a zero warm start
    ws = case.poisson_solve
    b = field(scale=1e3, interior_only=True)
    b = torch.where(b != 0, b - b.sum() / cells, b)
    p0 = torch.zeros_like(b)
    pk, ck, rk = host(ws.kernel(p0, b))
    pp, cp, rp = host(ws.plain(p0, b))
    pm, cm, rm = host(ws.mg(p0, b))  # the per-kernel composition of the cavity kernels
    tol = ws.cfg.tol_factor * float(b.abs().max())
    log(f"  quad_whole_solve cycles: kernel {ck}, plain twin {cp}, per-kernel {cm}; "
        f"res {float(rk)!r} / {float(rp)!r} / {float(rm)!r}; tol {tol:.4e}")
    if ck != cp:
        raise AssertionError(f"whole-solve: {ck} cycles, its twin {cp}")
    if abs(ck - cm) > 1:
        raise AssertionError(f"whole-solve: {ck} cycles, the per-kernel path {cm}")
    errs = []
    rel_err(pk, pp, "quad_whole_solve p vs twin", TOL_F32, errs)
    diff = float((pk - pm).abs().max())
    log(f"  quad_whole_solve p vs per-kernel: max|err|={diff:.3e} (limit 50 tol "
        f"{50 * tol:.3e})")
    if not diff <= 50 * tol:
        raise AssertionError(f"whole-solve p differs from the per-kernel path by {diff}")
    ms = median_ms(lambda: ws.kernel(p0, b))
    ops_per_cycle = solve_ops_per_cycle(ws, cells)
    solve_bound = bound(nbytes(p0, b, pk, ws.mg.pinv), ck * ops_per_cycle + cells)
    results["quad_whole_solve"] = dict(
        err=max(errs), ms=ms, plain_ms=median_ms(lambda: ws.plain(p0, b), reps=5),
        cycles=ck, ms_per_cycle=ms / ck,
        bound_bytes_ms=nbytes(p0, b, pk, ws.mg.pinv) / PEAK_BYTES_S * 1e3,
        bound_ops_ms_per_cycle=ops_per_cycle / PEAK_F32_S * 1e3, **solve_bound)
    return results


def check_step_kernels(case, dev) -> dict:
    """Phase 8: the step's kernels against their twins at its shapes."""
    from cfd_tpu_torch.kernels.mg_tail import level_masks
    from cfd_tpu_torch.kernels.quad import to_quad
    from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level

    rng = np.random.default_rng(2056)
    g = case.grid
    shape = g.shape
    fluid = g.fluid.astype(np.float32)
    cells, n_fluid = g.nx * g.ny, g.n_fluid

    def field(scale=0.1, fluid_only=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if fluid_only:
            a *= fluid
        return to_quad(torch.from_numpy(a).to(dev), shape)

    results = {}
    carry, corr = case.step_kernels
    us, vs, p = field(), field(), field(fluid_only=True)
    errs = []
    got, want = carry.kernel(us, vs, p), carry.plain(us, vs, p)
    for name, a, b in zip(("us'", "vs'", "b", "sum b"), got, want):
        rel_err(a, b, f"quad_step_corr_predictor_source {name}", TOL_F32, errs)
    bit_identical("quad_step_corr_predictor_source", errs)
    results["quad_step_corr_predictor_source"] = dict(
        err=max(errs), ms=median_ms(lambda: carry.kernel(us, vs, p)),
        dev_ms=carry_dev_ms(lambda: carry.kernel(us, vs, p)),
        plain_ms=median_ms(lambda: carry.plain(us, vs, p)),
        **bound(nbytes(us, vs, p, *got), cells * (CORRECTOR_OPS + PREDICTOR_SOURCE_OPS)))
    errs = []
    got, want = corr.kernel(us, vs, p), corr.plain(us, vs, p)
    for name, a, b in zip(("u", "v"), got, want):
        rel_err(a, b, f"quad_step_corrector {name}", TOL_F32, errs)
    bit_identical("quad_step_corrector", errs)
    results["quad_step_corrector"] = dict(
        err=max(errs), ms=median_ms(lambda: corr.kernel(us, vs, p)),
        dev_ms=carry_dev_ms(lambda: corr.kernel(us, vs, p)),
        launches_a_call=child_launches(("9b",), "time_carries")["9b"],
        plain_ms=median_ms(lambda: corr.plain(us, vs, p)),
        **bound(logical_nbytes(shape, us, vs, p) + nbytes(*got), cells * CORRECTOR_OPS))

    ws = case.poisson_solve
    mg, cfg = ws.mg, ws.cfg
    pre, post = mg.pre0, mg.post0
    b = field(scale=1e3, fluid_only=True)
    errs = []
    got, want = pre.kernel(p, b), pre.plain(p, b)
    for name, a, w in zip(("p", "rc"), got, want):
        rel_err(a, w, f"quad_step_pre_smooth_restrict {name}", TOL_F32, errs)
    bit_identical("quad_step_pre_smooth_restrict", errs)
    ops = child_launches(("9c", "9d"), "time_level0")
    results["quad_step_pre_smooth_restrict"] = dict(
        err=max(errs), ms=median_ms(lambda: pre.kernel(p, b)),
        dev_ms=carry_dev_ms(lambda: pre.kernel(p, b)), launches_a_call=ops["9c"],
        plain_ms=median_ms(lambda: pre.plain(p, b)),
        **bound(nbytes(p, b, *got),
                n_fluid * (pre.n_pairs * STEP_GS_OPS + STEP_RES_OPS) + cells // 4 * RESTRICT_OPS))
    lv1 = mg.levels[0]
    _, active1 = level_masks(lv1, dev)
    ec = torch.from_numpy(rng.standard_normal(lv1.shape).astype(np.float32) * 0.1).to(dev)
    ec = ec * active1
    errs = []
    got, want = post.kernel(p, b, ec), post.plain(p, b, ec)
    for name, a, w in zip(("p", "max|r|"), got, want):
        rel_err(a, w, f"quad_step_post_prolong_smooth {name}", TOL_F32, errs)
    bit_identical("quad_step_post_prolong_smooth", errs)
    results["quad_step_post_prolong_smooth"] = dict(
        err=max(errs), ms=median_ms(lambda: post.kernel(p, b, ec)),
        dev_ms=carry_dev_ms(lambda: post.kernel(p, b, ec)), launches_a_call=ops["9d"],
        plain_ms=median_ms(lambda: post.plain(p, b, ec)),
        **bound(nbytes(p, b, ec, *got),
                n_fluid * (PROLONG_OPS + post.n_pairs * STEP_GS_OPS + STEP_RES_OPS + 1)))

    # the full-2D pairs (row 5b) on every level the path smooths, the path's
    # two instances and 1-3 pairs in both variants, bit-identical; timed on
    # level 1's pre-smooth, its device time and device operations a call
    # from time_pairs (the same instance)
    errs, timing = [], None
    for k, lv in enumerate(mg.levels[:-1]):
        _, active = level_masks(lv, dev)
        pp = torch.from_numpy(rng.standard_normal(lv.shape).astype(np.float32) * 0.1).to(dev)
        bb = torch.from_numpy(rng.standard_normal(lv.shape).astype(np.float32) * 1e2).to(dev)
        pp, bb = pp * active, bb * active
        others = [rb_pairs_for_level(lv, mg.cfg.omega, n, with_residual_field=f)
                  for n in (1, 2, 3) for f in (True, False)]
        for sm in (mg.pre[k], mg.post[k], *others):
            got, want = sm.kernel(pp, bb), sm.plain(pp, bb)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            tag = f"rb_pairs_full L{k + 1} {tuple(lv.shape)} n={sm.n_pairs}"
            for name, x, y in zip(("p", "r"), got, want):
                rel_err(x, y, f"{tag} {name}", TOL_F32, errs)
            if k == 0 and sm is mg.pre[k]:
                n_act = int(active.sum())
                timing = dict(ms=median_ms(lambda: sm.kernel(pp, bb)),
                              dev_ms=carry_dev_ms(lambda: sm.kernel(pp, bb)),
                              plain_ms=median_ms(lambda: sm.plain(pp, bb)),
                              **bound(nbytes(pp, bb, *got, sm.wE, sm.wW, sm.wN, sm.wS),
                                      n_act * (sm.n_pairs * GS_OPS + RES_OPS)))
    bit_identical("rb_pairs_full", errs)
    timing["launches_a_call"] = child_launches(("5b",), "time_pairs")["5b"]
    results["rb_pairs_full"] = dict(err=max(errs), **timing)
    log(f"  rb_pairs_full (step L1, n={mg.pre[0].n_pairs}, residual field): "
        f"{timing['ms']:.4f} ms{dev_note(timing)}, bound {timing['bound_ms']:.4f} ms")

    # the masked whole-solve on a seeded, fluid-mean-free source
    bn = np.where(g.fluid, rng.standard_normal(shape), 0.0)
    bn = np.where(g.fluid, bn - bn.sum() / n_fluid, 0.0).astype(np.float32) * 1e3
    b = to_quad(torch.from_numpy(bn).to(dev), shape)
    p0 = torch.zeros_like(b)
    pk, ck, rk = host(ws.kernel(p0, b))
    pp_, cp, rp = host(ws.plain(p0, b))
    pm, cm, rm = host(ws.mg(p0, b))  # the per-kernel composition of the step's kernels
    tol = cfg.tol_factor * float(b.abs().max())
    bit = bool(torch.equal(pk, pm)) and bool(torch.equal(pk, pp_))
    log(f"  quad_step_whole_solve cycles: kernel {ck}, plain twin {cp}, per-kernel {cm}; "
        f"res {float(rk)!r} / {float(rp)!r} / {float(rm)!r}; tol {tol:.4e}; "
        f"p bit-identical to both: {bit}")
    if not ck == cp == cm:
        raise AssertionError(f"step whole-solve: {ck} cycles, its twin {cp}, the "
                             f"per-kernel path {cm}")
    errs = []
    rel_err(pk, pp_, "quad_step_whole_solve p vs twin", TOL_F32, errs)
    rel_err(pk, pm, "quad_step_whole_solve p vs per-kernel", TOL_F32, [])
    ms = median_ms(lambda: ws.kernel(p0, b))
    ops_per_cycle = solve_ops_per_cycle(ws, n_fluid)
    results["quad_step_whole_solve"] = dict(
        err=max(errs), ms=ms, plain_ms=median_ms(lambda: ws.plain(p0, b), reps=5),
        cycles=ck, ms_per_cycle=ms / ck,
        bound_bytes_ms=nbytes(p0, b, pk, mg.pinv) / PEAK_BYTES_S * 1e3,
        bound_ops_ms_per_cycle=ops_per_cycle / PEAK_F32_S * 1e3,
        **bound(nbytes(p0, b, pk, mg.pinv), ck * ops_per_cycle + cells))
    return results


def check_rb_kernels(case, dev) -> dict:
    """Phase 11: the RB carry (both variants), the RB corrector and the
    pin-mean whole-solve against their twins at the RB shapes. The solve is
    checked through both of its exits: the slice's own configuration stops
    on the stall rule on a white-noise source (its f32 floor lies above
    tol_factor 1e-7 times max|b|), and a copy with tol_factor 1e-3 stops on
    the tolerance."""
    from cfd_tpu_torch.kernels.quad import to_quad
    from cfd_tpu_torch.kernels.rb_quad import make_quad_rb_step_kernel
    from cfd_tpu_torch.kernels.whole_solve import make_quad_whole_solve
    from cfd_tpu_torch.physics.boussinesq import RBParams
    from cfd_tpu_torch.poisson.multigrid import neumann_problem

    rng = np.random.default_rng(1538)
    g = case.grid
    shape = g.shape
    cells = g.nx * g.ny
    inner = np.zeros(shape, np.float32)
    inner[1:-1, 1:-1] = 1.0

    def field(scale=0.1, interior_only=False, offset=None):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if offset is not None:
            a += offset
        if interior_only:
            a *= inner
        return to_quad(torch.from_numpy(a).to(dev), shape)

    results = {}
    carry, corr = case.step_kernels
    profile = np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
    us, vs, p = field(), field(), field(interior_only=True)
    T, p_prev = field(0.01, offset=profile), field(interior_only=True)
    errs = []
    got, want = carry.kernel(us, vs, p, T), carry.plain(us, vs, p, T)
    for name, a, b in zip(("us'", "vs'", "T'", "b", "sum b"), got, want):
        rel_err(a, b, f"quad_rb_step {name}", TOL_F32, errs)
    guess_op = make_quad_rb_step_kernel(
        shape, case.coeffs, case.info["kappa"],
        RBParams(case.info["rayleigh"], case.info["prandtl"]), emit_guess=True)
    got_g = guess_op.kernel(us, vs, p, T, p_prev)
    want_g = guess_op.plain(us, vs, p, T, p_prev)
    for name, a, b in zip(("us'", "vs'", "T'", "b", "guess", "sum b"), got_g, want_g):
        rel_err(a, b, f"quad_rb_step (emit_guess) {name}", TOL_F32, errs)
    bit_identical("quad_rb_step", errs)  # plain and emit_guess
    results["quad_rb_step"] = dict(
        err=max(errs), ms=median_ms(lambda: carry.kernel(us, vs, p, T)),
        dev_ms=carry_dev_ms(lambda: carry.kernel(us, vs, p, T)),
        plain_ms=median_ms(lambda: carry.plain(us, vs, p, T)),
        **bound(nbytes(us, vs, p, T, *got),
                cells * (CORRECTOR_OPS + TEMPERATURE_OPS + PREDICTOR_SOURCE_OPS
                         + BUOYANCY_OPS)))
    errs = []
    got, want = corr.kernel(us, vs, p), corr.plain(us, vs, p)
    for name, a, b in zip(("u", "v"), got, want):
        rel_err(a, b, f"quad_rb_corrector {name}", TOL_F32, errs)
    results["quad_rb_corrector"] = dict(
        err=max(errs), ms=median_ms(lambda: corr.kernel(us, vs, p)),
        plain_ms=median_ms(lambda: corr.plain(us, vs, p)),
        **bound(logical_nbytes(shape, us, vs, p) + nbytes(*got), cells * CORRECTOR_OPS))

    # the pin-mean whole-solve on a seeded, mean-free source from a zero
    # warm start
    ws = case.poisson_solve
    mg, cfg = ws.mg, ws.cfg
    b = field(scale=1e3, interior_only=True)
    b = torch.where(b != 0, b - b.sum() / cells, b)
    p0 = torch.zeros_like(b)
    loose = make_quad_whole_solve(
        shape, neumann_problem(g.nx, g.ny, g.dx, g.dy),
        dataclasses.replace(cfg, tol_factor=1e-3), device=dev, pin_mean=True)
    errs = []
    for exit_rule, solve in (("stall", ws), ("tolerance", loose)):
        pk, ck, rk = host(solve.kernel(p0, b))
        pp, cp, rp = host(solve.plain(p0, b))
        pm, cm, rm = host(solve.mg(p0, b))  # the per-kernel composition of the quad kernels
        tol = max(solve.cfg.tol_factor * float(b.abs().max()), solve.cfg.abs_tol)
        bit = bool(torch.equal(pk, pm)) and bool(torch.equal(pk, pp))
        log(f"  quad_whole_solve_pin_mean, {exit_rule} exit (tol_factor "
            f"{solve.cfg.tol_factor:g}): cycles kernel {ck}, plain twin {cp}, per-kernel "
            f"{cm}; res {float(rk)!r} / {float(rp)!r} / {float(rm)!r}; tol {tol:.4e}; "
            f"p bit-identical to both: {bit}")
        if not ck == cp == cm:
            raise AssertionError(f"pin-mean whole-solve ({exit_rule} exit): {ck} cycles, "
                                 f"its twin {cp}, the per-kernel path {cm}")
        if (float(rk) <= tol) != (exit_rule == "tolerance") or ck >= solve.cfg.max_cycles:
            raise AssertionError(f"pin-mean whole-solve: expected the {exit_rule} exit, got "
                                 f"res {float(rk)!r} against tol {tol:.4e} after {ck} cycles")
        rel_err(pk, pp, f"quad_whole_solve_pin_mean ({exit_rule}) p vs twin", TOL_F32, errs)
        rel_err(pk, pm, f"quad_whole_solve_pin_mean ({exit_rule}) p vs per-kernel", TOL_F32,
                [])
    pk, ck, _ = host(ws.kernel(p0, b))  # the slice's own solve is the one timed
    ms = median_ms(lambda: ws.kernel(p0, b))
    ops_per_cycle = solve_ops_per_cycle(ws, cells)
    results["quad_whole_solve_pin_mean"] = dict(
        err=max(errs), ms=ms, plain_ms=median_ms(lambda: ws.plain(p0, b), reps=3),
        cycles=ck, ms_per_cycle=ms / ck,
        bound_bytes_ms=nbytes(p0, b, pk, mg.pinv) / PEAK_BYTES_S * 1e3,
        bound_ops_ms_per_cycle=ops_per_cycle / PEAK_F32_S * 1e3,
        **bound(nbytes(p0, b, pk, mg.pinv), ck * ops_per_cycle + cells))
    return results


def check_adaptive_kernels(flows: dict, dev) -> dict:
    """Phase 14: each adaptive-stepping instance against its twin at the
    full shapes, dt_corr = 0.8 dt and dt_pred = 1.1 dt, timed beside the
    fixed-dt instance on the same inputs (for the non-carry cavity stage:
    the fixed carry, whose predictor and source stages its tiles run)."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.kernels.quad import to_quad
    from cfd_tpu_torch.physics.boussinesq import RBParams

    rng = np.random.default_rng(14)
    results = {}
    for flow, (g, c, info) in flows.items():
        shape = g.shape
        cells = g.nx * g.ny
        inner = np.zeros(shape, np.float32)
        inner[1:-1, 1:-1] = 1.0
        if flow == "step":
            inner = g.fluid.astype(np.float32)

        def field(scale=0.1, interior_only=False, offset=0.0):
            a = (rng.standard_normal(shape) * scale).astype(np.float32) + offset
            if interior_only:
                a *= inner
            return to_quad(torch.from_numpy(a).to(dev), shape)

        us, vs, p, p_prev = field(), field(), field(interior_only=True), \
            field(interior_only=True)
        one = lambda s: torch.tensor(s * c.dt, dtype=torch.float32, device=dev)
        pair = torch.tensor([0.8 * c.dt, 1.1 * c.dt], dtype=torch.float32, device=dev)
        stage_ops = cells * (CORRECTOR_OPS + PREDICTOR_SOURCE_OPS + COURANT_OPS)
        courant = ("max|u|", "max|v|")
        if flow == "cavity":
            specs = [
                ("quad_predictor_source", Q.make_quad_predictor_source(shape, c),
                 Q.make_quad_corr_predictor_source(shape, c), one(1.1), (us, vs),
                 (us, vs, p, p_prev), ("us'", "vs'", "b", "max|b|"),
                 cells * PREDICTOR_SOURCE_OPS),
                ("quad_corrector_traced", Q.make_quad_corrector(shape, c, traced_dt=True),
                 Q.make_quad_corrector(shape, c), one(0.8), (us, vs, p, p_prev), None,
                 ("u", "v", "guess"), cells * CORRECTOR_OPS),
                ("quad_corr_predictor_source_adaptive",
                 Q.make_quad_corr_predictor_source(shape, c, adaptive=True),
                 Q.make_quad_corr_predictor_source(shape, c), pair, (us, vs, p, p_prev),
                 None, ("us'", "vs'", "b", "guess", "max|b|") + courant, stage_ops)]
        elif flow == "channel":
            specs = [
                ("quad_channel_corrector_traced",
                 Q.make_quad_channel_corrector(shape, c, traced_dt=True),
                 Q.make_quad_channel_corrector(shape, c), one(0.8), (us, vs, p, p_prev),
                 None, ("u", "v", "guess"), cells * CORRECTOR_OPS),
                ("quad_channel_corr_predictor_source_adaptive",
                 Q.make_quad_channel_corr_predictor_source(shape, c, adaptive=True),
                 Q.make_quad_channel_corr_predictor_source(shape, c), pair,
                 (us, vs, p, p_prev), None, ("us'", "vs'", "b", "guess", "sum b") + courant,
                 stage_ops)]
        elif flow == "step":
            rect = info["rect"]
            specs = [
                ("quad_step_corrector_traced",
                 SQ.make_quad_step_corrector(shape, c, *rect, traced_dt=True),
                 SQ.make_quad_step_corrector(shape, c, *rect), one(0.8), (us, vs, p), None,
                 ("u", "v"), cells * CORRECTOR_OPS),
                ("quad_step_corr_predictor_source_adaptive",
                 SQ.make_quad_step_corr_predictor_source(shape, c, *rect, adaptive=True),
                 SQ.make_quad_step_corr_predictor_source(shape, c, *rect), pair,
                 (us, vs, p), None, ("us'", "vs'", "b", "sum b") + courant, stage_ops)]
        else:
            profile = np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
            T = field(0.01, offset=profile)
            params = RBParams(info["rayleigh"], info["prandtl"])
            specs = [
                ("quad_rb_corrector_traced", RQ.make_quad_rb_corrector(shape, c, traced_dt=True),
                 RQ.make_quad_rb_corrector(shape, c), one(0.8), (us, vs, p), None,
                 ("u", "v"), cells * CORRECTOR_OPS),
                ("quad_rb_step_adaptive",
                 RQ.make_quad_rb_step_kernel(shape, c, info["kappa"], params, adaptive=True),
                 RQ.make_quad_rb_step_kernel(shape, c, info["kappa"], params), pair,
                 (us, vs, p, T), None, ("us'", "vs'", "T'", "b", "sum b") + courant,
                 stage_ops + cells * (TEMPERATURE_OPS + BUOYANCY_OPS))]
        for name, op, fixed, dts, args, fixed_args, outs, ops in specs:
            fixed_args = args if fixed_args is None else fixed_args
            errs = []
            got, want = op.kernel(dts, *args), op.plain(dts, *args)
            for out, a, b in zip(outs, got, want, strict=True):
                rel_err(a, b, f"{name} {out}", TOL_F32, errs)
            # rows 1+, 8a+, 9a+, 10+, row 6 (the exact controller's
            # predictor + source) and row 9b+ (the step's traced-dt
            # corrector): their device ms; rows 6 and 9b+'s device
            # operations a call from a child time_carries (the same
            # instances)
            child = {Q.PREDICTOR_SOURCE.name: "6", SQ.STEP_CORRECTOR_TRACED.name: "9b+"}
            tiled = name.endswith("_adaptive") or name in child
            if name in REDESIGNED:
                bit_identical(name, errs)
            results[name] = dict(
                err=max(errs), ms=median_ms(lambda: op.kernel(dts, *args)),
                **(dict(dev_ms=carry_dev_ms(lambda: op.kernel(dts, *args))) if tiled else {}),
                fixed_ms=median_ms(lambda: fixed.kernel(*fixed_args)),
                plain_ms=median_ms(lambda: op.plain(dts, *args)),
                **bound(nbytes(dts, *got) + (logical_nbytes(shape, *args)
                                             if "corrector" in name else nbytes(*args)), ops))
            if name in child:
                row = child[name]
                results[name]["launches_a_call"] = child_launches((row,), "time_carries")[row]
    return results


def run_adaptive_path(case, n_steps: int, spc: int, controller: str, path_kernels,
                      what: str, card: str, shards: int | None = None,
                      sharded_kwargs: dict | None = None, absent=()) -> tuple[dict, dict]:
    """Phase 15 (and 42, on a mesh of ``shards`` shards of the card with
    ``sharded_kwargs``): one adaptive run through run_adaptive with every
    launch counter zeroed just before and read just after; fails on a kernel
    of ``path_kernels`` that never launched, one of ``absent`` that did, a
    non-finite field, a printed Courant number above MAX_CO * GROWTH or a dt
    above the diffusive ceiling. Returns (launches, steps/s and
    V-cycles/step over the last 100 steps, the final dt, its ratio to the
    case's dt, the last Courant number, the simulated time, the logical
    final state and the Simulation)."""
    from cfd_tpu_torch.adaptive import run_adaptive
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.parallel import make_mesh
    from cfd_tpu_torch.solver import Simulation

    sim = Simulation(case, log=lambda m: log("  " + m),
                     mesh=make_mesh(shards) if shards else None, sharded_kwargs=sharded_kwargs)
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    st, rows = run_adaptive(sim, max_courant=MAX_CO, growth=GROWTH, n_steps=n_steps,
                            steps_per_call=spc, controller=controller)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    log(f"  launches: {launches}")
    missing = [k.name for k in path_kernels if launches[k.name] == 0]
    extra = [k.name for k in absent if launches[k.name]]
    if missing or extra:
        raise AssertionError(f"{what}: kernels never launched {missing}, launched against "
                             f"the path {extra}")
    for fname in ("u", "v", "p", "T"):
        a = getattr(st, fname)
        if a is not None and not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {fname} after the {what} run")
    co_max = max(r["courant"] for r in rows)
    if not co_max <= MAX_CO * GROWTH:
        raise AssertionError(f"{what}: printed Courant number {co_max} > {MAX_CO * GROWTH}")
    c = case.coeffs
    diffusivity = case.adaptive_diffusivity or c.viscosity
    ceiling = 0.25 * min(c.dx, c.dy) ** 2 / diffusivity
    if not max(sim.step_dts) <= ceiling * (1 + 1e-6):
        raise AssertionError(f"{what}: dt {max(sim.step_dts)} above the diffusive ceiling "
                             f"{ceiling}")
    walls = [0.0] + [r["wall_seconds"] for r in rows]
    steps_s = 100 / (walls[-1] - walls[-2])
    out = dict(steps_s=steps_s, cycles=float(np.mean(sim.step_iters[-100:])),
               dt=sim.step_dts[-1], ratio=sim.step_dts[-1] / case.dt, co=rows[-1]["courant"],
               t=rows[-1]["time"], row=rows[-1], state=st, sim=sim)
    log(f"  {what}: {n_steps} steps in {wall:.2f} s; last 100: {steps_s:.2f} steps/s, "
        f"{out['cycles']:.2f} V-cycles/step; final dt {out['dt']:.6e} = "
        f"{out['ratio']:.4f} x the case's dt {case.dt:.6e} (ceiling {ceiling:.6e}); last "
        f"Co {out['co']:.4f} (max printed {co_max:.4f}); t = {out['t']:.6f}  ({card})")
    return launches, out


def adaptive_card_vs_cpu(make, kw: dict, controller: str, spc: int, what: str,
                         shards: int | None = None, sharded_kwargs: dict | None = None) -> None:
    """Phase 16 (and 43, on a mesh of ``shards`` shards): 20 adaptive steps
    with the kernels on the card and the plain twins on the CPU: the same dt
    every step, equal cycles, fields within 5e-5."""
    from cfd_tpu_torch.adaptive import run_adaptive
    from cfd_tpu_torch.parallel import make_mesh
    from cfd_tpu_torch.solver import Simulation

    out = {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        sim = Simulation(make(device=dev, **kw), log=lambda m: None,
                         mesh=make_mesh(shards, device=dev) if shards else None,
                         sharded_kwargs=sharded_kwargs)
        st, _ = run_adaptive(sim, max_courant=MAX_CO, n_steps=20, steps_per_call=spc,
                             controller=controller)
        out[where] = (sim.step_iters, sim.step_dts, st)
    (it_g, dt_g, st_g), (it_c, dt_c, st_c) = out["card"], out["cpu"]
    log(f"  {what}: cycles/step card {it_g}, cpu {it_c}; dt step 20 card {dt_g[-1]!r} "
        f"cpu {dt_c[-1]!r} ({dt_g[-1] / dt_g[0]:.3f} x step 1)")
    if it_g != it_c:
        raise AssertionError(f"{what}: card and CPU cycle counts differ")
    if dt_g != dt_c:
        raise AssertionError(f"{what}: card and CPU dt sequences differ: {dt_g} / {dt_c}")
    for name in ("u", "v", "p", "T"):
        if getattr(st_c, name) is None:
            continue
        rel_err(getattr(st_g, name).float().cpu(), getattr(st_c, name).float(),
                f"{what} card vs cpu {name}", 5e-5, [])


def solve_ops_per_cycle(solver, cells: int) -> int:
    """float32 operations of one V-cycle of a whole-solve (the separable,
    pin-mean or masked flavor) over ``cells`` finest cells (fluid cells on
    the step), counted as in phases 5, 8 and 11."""
    cfg, mg = solver.cfg, solver.mg
    sweeps = cfg.pre_sweeps + cfg.post_sweeps
    if solver.MASKED:
        ops = cells * (sweeps * STEP_GS_OPS + 2 * STEP_RES_OPS + 1 + PROLONG_OPS)
        if cfg.corr_opt:
            ops += mg.levels[0].nx * mg.levels[0].ny * CORR_OPS
        coarse, fill = zip(mg.levels[:-1], mg.levels[1:]), FILL_OPS
    else:
        ops = cells * (sweeps * GS_OPS + 2 * RES_OPS + 1 + PROLONG_OPS
                       + (PIN_OPS if cfg.pin_mean else 0))
        coarse, fill = zip(mg.levels[1:-1], mg.levels[2:]), 0
    for lv, below in coarse:
        ops += (lv.nx * lv.ny * (sweeps * GS_OPS + RES_OPS + PROLONG_OPS + fill)
                + below.nx * below.ny * RESTRICT_OPS)
    return ops + 2 * mg.pinv.numel()


def grid_phase_barriers(solver) -> int:
    """Grid-wide barriers per V-cycle of the whole-solve's earlier design,
    in which every half-sweep, restriction, prolongation and solid fill of
    every level was a grid-stride phase ending in a grid-wide barrier: the
    figure each plan's count is held to (at most half)."""
    cfg = solver.cfg
    coarse = solver.mg.levels if solver.MASKED else solver.mg.levels[1:]
    pre, post, masked = cfg.pre_sweeps, cfg.post_sweeps, int(solver.MASKED)
    down = 2 * pre + masked + 1 + (len(coarse) - 1) * (2 * pre + 1) + 2
    up = sum(int(not lv.separable) + 1 + 2 * post for lv in coarse[1:])
    up += 1 + 2 * post + masked + 1 + (3 * int(cfg.corr_opt) + 1 if masked else 0)
    return down + up + (2 if cfg.pin_mean and not masked else 0)


def log_plan(tag: str, solver, card: str, ms_per_cycle: float | None = None) -> None:
    """Print a whole-solve's launch plan (kernels/plan.py), its grid-wide
    barriers per V-cycle beside the earlier design's and, where measured,
    its ms per V-cycle; fail on a plan that keeps more than half of them."""
    from cfd_tpu_torch.kernels.whole_solve import launch_grid

    pl = solver.plan
    coarse = solver.mg.levels if solver.MASKED else solver.mg.levels[1:]
    grid_lv = ", ".join(f"{k}: {'tiles %dx%d' % t if t[0] else 'grid-stride'}"
                        for k, t in enumerate(pl.level_tiles, start=1)) or "none"
    g = launch_grid(solver.MASKED, pl)
    old = grid_phase_barriers(solver)
    log(f"  {tag} plan: grid levels {{{grid_lv}}}, levels {pl.block_from}..{len(coarse)} in "
        f"one block; finest tiles {pl.tile_rows}x{pl.tile_cols} plane cells, halo "
        f"{pl.halo_pre} (pre) / {pl.halo_post} (post); {pl.smem_bytes} B shared memory; "
        f"{pl.blocks} blocks x {pl.threads} threads ({g['blocks_per_sm']} fit an SM, "
        f"{g['registers']} registers/thread); {pl.barriers} grid barriers per V-cycle "
        f"(grid-phase design: {old})"
        + (f"; {ms_per_cycle:.4f} ms per V-cycle" if ms_per_cycle is not None else "")
        + f"  ({card})")
    if 2 * pl.barriers > old:
        raise AssertionError(f"{tag}: {pl.barriers} grid barriers per V-cycle, more than half "
                             f"of {old}")


def check_cavity_whole_solve(case, dev) -> dict:
    """Phase 5: the float32 cavity whole-solve at 2048^2 (the cavity's cuda
    default) against its twin on a seeded source from a zero warm start:
    equal cycles and residual, p bit-identical; ms per V-cycle; the bound
    as phase 5's channel whole-solve's."""
    from cfd_tpu_torch.seeded import seeded_source

    ws = case.poisson_solve
    b = seeded_source(case, seed=2049)
    p0 = torch.zeros_like(b)
    pk, ck, rk = host(ws.kernel(p0, b))
    pp, cp, rp = host(ws.plain(p0, b))
    bit = bool(torch.equal(pk, pp))
    log(f"  quad_whole_solve (cavity {N_MAIN}^2, f32): cycles kernel {ck}, twin {cp}; res "
        f"{rk!r} / {rp!r}; p bit-identical: {bit}")
    if (ck, rk) != (cp, rp) or not bit:
        raise AssertionError(f"cavity whole-solve: ({ck}, {rk}) against the twin's ({cp}, "
                             f"{rp}), bit-identical {bit}")
    errs = []
    rel_err(pk, pp, "quad_whole_solve (cavity) p vs twin", TOL_F32, errs)
    cells = case.grid.nx * case.grid.ny
    ms = median_ms(lambda: ws.kernel(p0, b))
    n_bytes = nbytes(p0, b, pk, ws.mg.pinv)
    return dict(err=max(errs), ms=ms, plain_ms=median_ms(lambda: ws.plain(p0, b), reps=3),
                cycles=ck, ms_per_cycle=ms / ck,
                bound_ops_ms_per_cycle=solve_ops_per_cycle(ws, cells) / PEAK_F32_S * 1e3,
                **bound(n_bytes, ck * solve_ops_per_cycle(ws, cells) + cells))


def log_whole_step_plan(ws) -> None:
    """Print a whole step's launch plan (kernels/plan.py whole_step_plan):
    the carry's tiles and how many rounds of them the blocks run, the
    blocks, registers and shared memory, and the grid-wide barriers of the
    carry phases and of a V-cycle."""
    from cfd_tpu_torch.kernels.whole_step import launch_grid

    pl = ws.plan
    c, g = pl.carry, launch_grid(ws.FLAVOR, pl.solve)
    tiles = c.grid_x * c.grid_y
    log(f"  {ws.record.name} plan: carry tiles {c.rows}x{c.cols} plane cells, halo {c.halo}, "
        f"{tiles} tiles ({tiles / pl.solve.blocks:.2f} rounds); {pl.solve.blocks} blocks x "
        f"{pl.solve.threads} threads ({g['blocks_per_sm']} fit an SM, {g['registers']} "
        f"registers/thread); {pl.solve.smem_bytes} B shared memory (carry {c.smem_bytes}); "
        f"grid barriers: carry {pl.carry_barriers}, a V-cycle {pl.solve.barriers}")


def check_whole_steps(cases: dict) -> dict:
    """Phase 17: each flavor's whole-step kernel against its twin (the
    composition carry -> mean removal -> whole-solve twin) at the full
    widths on seeded fields: bit-identical fields, equal cycles and
    residual. Times as in phase 2 (the twin over 3 runs); the bound counts
    the carried state read once and written once plus the solve's pinv, and
    the carry's, the mean removal's and the solve's operations."""
    from cfd_tpu_torch.seeded import seeded_fields

    results = {}
    for flow, case in cases.items():
        ws = case.whole_step_kernel
        fields = seeded_fields(case, seed=1700 + len(results))
        got, want = host(ws.kernel(*fields)), host(ws.plain(*fields))
        names = ("us'", "vs'", "T'", "p'") if flow == "rb" else ("us'", "vs'", "p'")
        errs = []
        for name, a, b in zip(names, got[:-2], want[:-2], strict=True):
            rel_err(a, b, f"{ws.record.name} {name}", TOL_F32, errs)
        bit = all(bool(torch.equal(a, b)) for a, b in zip(got[:-2], want[:-2]))
        log(f"  {ws.record.name}: cycles kernel {got[-2]}, twin {want[-2]}; res "
            f"{got[-1]!r} / {want[-1]!r}; fields bit-identical: {bit}")
        if got[-2:] != want[-2:]:
            raise AssertionError(f"{ws.record.name}: (cycles, res) {got[-2:]} against the "
                                 f"twin's {want[-2:]}")
        bit_identical(ws.record.name, errs)
        log_whole_step_plan(ws)
        cells = case.grid.n_fluid
        carry_ops = CORRECTOR_OPS + PREDICTOR_SOURCE_OPS + (
            TEMPERATURE_OPS + BUOYANCY_OPS if flow == "rb" else 0)
        ops = (cells * (carry_ops + (0 if flow == "cavity" else 2))
               + got[-2] * solve_ops_per_cycle(ws.solver, cells))
        n_bytes = nbytes(*fields, *got[:-2], ws.solver.mg.pinv)
        results[ws.record.name] = dict(
            err=max(errs), ms=median_ms(lambda: ws.kernel(*fields), reps=10),
            dev_ms=carry_dev_ms(lambda: ws.kernel(*fields)),
            plain_ms=median_ms(lambda: ws.plain(*fields), reps=3), cycles=got[-2],
            bound_bytes_ms=n_bytes / PEAK_BYTES_S * 1e3,
            bound_ops_ms_per_cycle=solve_ops_per_cycle(ws.solver, cells) / PEAK_F32_S * 1e3,
            **bound(n_bytes, ops))
    return results


def run_whole_steps(full: dict, ws_cases: dict, composed: dict, card: str) -> dict:
    """Phase 18: 300 steps of each whole-step case through run_path; each
    step must be one launch of the flavor's kernel, and the cycles and the
    carried state those of the composed run (``composed[flow]`` = its
    per-step cycles and carried state). Returns the kernels' launches."""
    launches = {}
    for flow, (_, _, record, flow_rate) in full.items():
        case = ws_cases.pop(flow)
        got, state, r = run_path(case, 300, (record,), f"{flow} whole-step", card, flow_rate)
        launches[record.name] = got[record.name]
        others = {k: n for k, n in got.items() if n and k != record.name}
        iters, ref_state = composed.pop(flow)
        same = all(a is None or bool(torch.equal(a, b)) for a, b in zip(state, ref_state))
        log(f"  {flow} whole-step: {got[record.name]} launches of {record.name} in 300 steps "
            f"({sum(got.values()) / 300:.4f} port launches a step, the rest {others} at the "
            f"stats rows); cycles equal to the composed run's at every step: "
            f"{r['iters'] == iters}; carried state bit-identical: {same}  ({card})")
        if got[record.name] != 300:
            raise AssertionError(f"{flow}: {got[record.name]} whole-step launches in 300 steps")
        if r["iters"] != iters or not same:
            raise AssertionError(f"{flow}: the whole step left the composed path's cycles or "
                                 "fields")
        del case
    return launches


def tail_ops(tail) -> int:
    """float32 operations of one V-cycle of a fused tail over its levels,
    counted as solve_ops_per_cycle counts the coarse levels."""
    sweeps = tail.n_pre + tail.n_post
    ops = 2 * tail.pinv.numel()
    for lv, below in zip(tail.levels[:-1], tail.levels[1:]):
        fill = 0 if below.separable else FILL_OPS
        ops += (lv.nx * lv.ny * (sweeps * GS_OPS + RES_OPS + PROLONG_OPS + fill)
                + below.nx * below.ny * RESTRICT_OPS)
    return ops


def check_tail(tail, what: str, seed: int) -> dict:
    """Phase 20: a fused tail's kernel against its twin on a seeded source
    over its first level's active cells; times as in phase 2 (the twin over
    5 runs); the bound: the source, the correction and the levels'
    constants once, and one V-cycle's operations."""
    from cfd_tpu_torch.kernels.mg_tail import level_masks

    lv = tail.levels[0]
    rng = np.random.default_rng(seed)
    active = level_masks(lv, tail.pinv.device)[1]
    b = torch.from_numpy(rng.standard_normal(lv.shape).astype(np.float32) * 1e2)
    b = torch.where(active, b.to(tail.pinv.device), 0.0)
    got, want = tail.kernel(b), tail.plain(b)
    errs = []
    rel_err(got, want, f"{tail.record.name} {what} e", TOL_F32, errs)
    log(f"  {tail.record.name} {what}: {len(tail.levels)} levels from {tuple(lv.shape)}; "
        f"bit-identical: {bool(torch.equal(got, want))}")
    consts = [getattr(level, w) for level in tail.levels for w in ("wE", "wW", "wN", "wS")]
    return dict(err=max(errs), ms=median_ms(lambda: tail.kernel(b)),
                plain_ms=median_ms(lambda: tail.plain(b), reps=5),
                **bound(nbytes(b, got, tail.pinv, *consts), tail_ops(tail)))


def check_solve(solve, b, cells: int) -> dict:
    """Phases 22 and 23: a whole-solve kernel against its twin on the source
    b from a zero warm start: equal cycles and residual, p within 1e-5
    (bit-identical expected). Times and bound as in phase 5, the twin's over
    one run."""
    record = solve._fine()[5]
    p0 = torch.zeros_like(b)
    pk, ck, rk = host(solve.kernel(p0, b))
    pp, cp, rp = host(solve.plain(p0, b))
    log(f"  {record.name}: cycles kernel {ck}, twin {cp}; res {rk!r} / {rp!r}; p "
        f"bit-identical: {bool(torch.equal(pk, pp))}")
    if (ck, rk) != (cp, rp):
        raise AssertionError(f"{record.name}: (cycles, res) ({ck}, {rk}) against the twin's "
                             f"({cp}, {rp})")
    errs = []
    rel_err(pk, pp, f"{record.name} p vs twin", TOL_F32, errs)
    ms = median_ms(lambda: solve.kernel(p0, b))
    ops_per_cycle = solve_ops_per_cycle(solve, cells)
    n_bytes = nbytes(p0, b, pk, solve.mg.pinv)
    return dict(err=max(errs), ms=ms, plain_ms=median_ms(lambda: solve.plain(p0, b), reps=1),
                cycles=ck, ms_per_cycle=ms / ck, **bound(n_bytes, ck * ops_per_cycle + cells))


def run_tail_path(case, what: str, path_kernels, ref, card: str, rate, cycle_slack: int):
    """Phase 21: 100 steps of a tail_from=1 case through run_path from the
    per-kernel run's start state; ``ref`` = (start state, its per-step
    cycles, its end state, its rates). The tail must launch once a V-cycle
    and no coarse smoother at all; cycles within ``cycle_slack`` of the
    per-kernel run's every step and the end state within 1e-5 relative."""
    from cfd_tpu_torch.kernels import rb_smoother as RB

    start, iters, end, pk = ref
    got, state, r = run_path(case, 100, path_kernels, what, card, rate, state=start,
                             start_step=300)
    tail = path_kernels[-1]
    smoother = got[RB.RB_PAIRS.name] + got[RB.RB_PAIRS_FULL.name]
    if got[tail.name] != sum(r["iters"]) or smoother:
        raise AssertionError(f"{what}: {got[tail.name]} tail launches for {sum(r['iters'])} "
                             f"V-cycles, {smoother} coarse smoother launches")
    off = max(abs(a - b) for a, b in zip(r["iters"], iters, strict=True))
    if off > cycle_slack:
        raise AssertionError(f"{what}: cycles differ from the per-kernel run's by {off}")
    for name, a, b in zip(("u", "v", "p", "T", "p_prev"), state, end):
        if a is not None:
            rel_err(a, b, f"{what} vs per-kernel {name}", TOL_F32, [])
    log(f"  {what}: {sum(got.values()) / 100:.2f} port launches a step "
        f"({tail.name} {got[tail.name]}); cycles equal to the per-kernel run's at every "
        f"step: {r['iters'] == iters}; {r['steps_s']:.2f} steps/s at {r['cycles']:.2f} "
        f"V-cycles/step against the per-kernel solve's {pk['steps_s']:.2f} at "
        f"{pk['cycles']:.2f}  ({card})")
    return got, state, r


def step_grid(nx: int, ny: int):
    """The step factory's geometry (backwards_step-01.cpp:387,493,508-520):
    (grid, step_i, inlet_j_max)."""
    from cfd_tpu_torch.grid import Grid
    from cfd_tpu_torch.poisson.multigrid import step_rect_params

    dx, dy = 8.0 / nx, 2.0 / ny
    step_i, inlet = int(2.0 / dx), int(1.0 / dy)
    jj, ii = np.arange(1, ny + 1)[:, None], np.arange(1, nx + 1)[None, :]
    grid = Grid.masked(nx, ny, 8.0, 2.0, np.ascontiguousarray(
        np.broadcast_to(np.where(ii <= step_i, jj <= inlet, True), (ny, nx))))
    assert step_rect_params(grid) == (step_i, inlet)
    return grid, step_i, inlet


def masked_natural_solve_card_vs_cpu(nx: int, ny: int) -> None:
    """The natural masked solve where it has smoothed coarse levels: a grid
    built directly (every natural step size has 2 levels, the dense pinv
    its only coarse one). On the card its coarse levels run RBPairs'
    full-2D kernel, which must launch; card against CPU, equal cycles and
    p within 5e-5 of its scale."""
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.kernels import rb_smoother as RB
    from cfd_tpu_torch.kernels import step_smoother as SS
    from cfd_tpu_torch.ops.stencil import StencilCoeffs
    from cfd_tpu_torch.poisson.multigrid import MGConfig, make_masked_multigrid_poisson

    grid, _, _ = step_grid(nx, ny)
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=1e-3, viscosity=0.01)
    fluid = grid.cell_mask
    rng = np.random.default_rng(nx + ny)
    b = np.where(fluid, rng.standard_normal(grid.shape), 0.0)
    b = torch.from_numpy(np.where(fluid, b - b[fluid].mean(), 0.0).astype(np.float32))
    cfg = MGConfig(tol_factor=1e-6, abs_tol=0.0)
    path = (RB.RB_PAIRS_FULL, SS.STEP_PAIRS, SS.STEP_PAIRS_RES)
    out = {}
    for where in ("cuda", "cpu"):
        solve = make_masked_multigrid_poisson(grid, coeffs, cfg, device=where)
        for kern in KERNELS:
            kern.launches = 0
        p, cycles, res = solve(torch.zeros_like(b).to(where), b.to(where))
        out[where] = (p.cpu(), cycles, res, {k.name: k.launches for k in path})
    (pg, cg, rg, lg), (pc, cc, rc, _) = out["cuda"], out["cpu"]
    what = f"masked natural solve {nx}x{ny} ({len(solve.levels) + 1} levels)"
    log(f"  {what}: cycles card {cg} cpu {cc}, res card {rg!r} cpu {rc!r}, card launches {lg}")
    missing = [name for name, n in lg.items() if n == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched on the card: {missing}")
    if cg != cc:
        raise AssertionError(f"{what}: card and CPU cycle counts differ")
    rel_err(pg, pc, f"{what} card vs cpu p", 5e-5, [])


def check_natural_kernels(dev) -> dict:
    """Phase 25: the natural layout's kernels against their twins at the
    full-width shapes, with their times and bounds."""
    from cfd_tpu_torch.cases import make_cavity_case, make_channel_case
    from cfd_tpu_torch.kernels import projection as P
    from cfd_tpu_torch.kernels.rb_smoother import RB_PAIRS_RES
    from cfd_tpu_torch.kernels import step_smoother as SS
    from cfd_tpu_torch.kernels.step_smoother import fluid_mask, make_step_masked_pairs

    rng = np.random.default_rng(25)
    results = {}

    def aligned_fields(shape, n, scale=0.1):
        H8, W = P.aligned_shape(shape)
        out = []
        for _ in range(n):
            a = np.zeros((H8, W), np.float32)
            a[: shape[0], : shape[1]] = rng.standard_normal(shape) * scale
            out.append(torch.from_numpy(a).to(dev))
        return out

    def timed(name, fn, plain, n_bytes, n_ops, labels):
        errs = []
        got, want = fn(), plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for label, a, b in zip(labels, got, want, strict=True):
            rel_err(a, b, f"{name} {label}", TOL_F32, errs)
        if name in results:  # a second variant of one entry point: the worst error
            errs.append(results[name]["err"])
        results[name] = dict(err=max(errs), ms=median_ms(fn), plain_ms=median_ms(plain),
                             **bound(n_bytes(got), n_ops))

    cav_kw = dict(poisson="multigrid", dtype=torch.float32, tolerance_factor=1e-6,
                  layout="aligned")
    cav = make_cavity_case(n_interior=N_MAIN, device=dev, **cav_kw)
    ch = make_channel_case(nx=CHANNEL[0], ny=CHANNEL[1], poisson="multigrid",
                           tolerance_factor=1e-6, abs_tol=0.0, dtype=torch.float32,
                           layout="aligned", device=dev)
    for case, names, scalar in ((cav, (P.PREDICTOR_SOURCE, P.CORRECTOR), "max|b|"),
                                (ch, (P.CHANNEL_PREDICTOR_SOURCE, P.CHANNEL_CORRECTOR),
                                 "sum b")):
        pred, corr = case.step_kernels
        g = case.grid
        cells = g.nx * g.ny
        log(f"  {case.name}: aligned fields {tuple(pred.shape)}")
        u, v, p, pp = aligned_fields(g.shape, 4)
        timed(names[0].name, lambda: pred.kernel(u, v), lambda: pred.plain(u, v),
              lambda got: nbytes(u, v, *got), cells * PREDICTOR_SOURCE_OPS,
              ("us", "vs", "b", scalar))
        # the predictors + source redesigned (rows 11 and 11-ch): error 0,
        # their device time and device operations a call (time_carries, the
        # same instances)
        row = "11" if names[0] is P.PREDICTOR_SOURCE else "11-ch"
        r = results[names[0].name]
        bit_identical(names[0].name, [r["err"]])
        r.update(dev_ms=carry_dev_ms(lambda: pred.kernel(u, v)),
                 launches_a_call=child_launches((row,), "time_carries")[row])
        timed(names[1].name, lambda: corr.kernel(u, v, p, pp), lambda: corr.plain(u, v, p, pp),
              lambda got: logical_nbytes(g.shape, u, v, p, pp) + nbytes(*got),
              cells * CORRECTOR_OPS,
              ("u2", "v2", "guess"))
    # the with_residual pairs at the cavity's aligned level 0 (its post-smooth)
    solve = cav.poisson_solve
    post = solve.post0
    lv0 = solve.levels[0]
    log(f"  the aligned cavity solve: {len(solve.levels)} levels, level 0 {lv0.shape}, "
        f"post-smooth pairs {post.n_pairs}")
    _, b = aligned_fields(cav.grid.shape, 2, scale=1e2)
    p0 = aligned_fields(cav.grid.shape, 1, scale=1e-2)[0]
    b = torch.where(solve.interior0, b, torch.zeros_like(b))
    p0 = torch.where(solve.interior0, p0, torch.zeros_like(p0))
    timed(RB_PAIRS_RES.name, lambda: post.kernel(p0, b), lambda: post.plain(p0, b),
          lambda got: nbytes(p0, b, *got, post.wE, post.wW, post.wN, post.wS),
          N_MAIN * N_MAIN * (post.n_pairs * GS_OPS + RES_OPS), ("p", "max|r|"))
    # row 5-wr redesigned: error 0, its device time and device operations a
    # call (time_pairs, the same instance); the level's pre-smooth (row 5's
    # entry point, 2 pairs and the residual field) bit-identical too
    errs = [results[RB_PAIRS_RES.name]["err"]]
    for name, x, y in zip(("p", "r"), solve.pre0.kernel(p0, b), solve.pre0.plain(p0, b)):
        rel_err(x, y, f"rb_pairs natural level 0 pre-smooth {name}", TOL_F32, errs)
    bit_identical(RB_PAIRS_RES.name, errs)
    results[RB_PAIRS_RES.name].update(
        dev_ms=carry_dev_ms(lambda: post.kernel(p0, b)),
        launches_a_call=child_launches(("5-wr",), "time_pairs")["5-wr"])
    log(f"  {RB_PAIRS_RES.name}: {results[RB_PAIRS_RES.name]['ms']:.4f} ms"
        f"{dev_note(results[RB_PAIRS_RES.name])}")
    del cav, ch, solve
    # the step's exact masked pairs at the natural step's level 0, three
    # variants, V(2,2); the plain and the field variant share an entry point,
    # whose time is the field variant's (the path's)
    grid, step_i, inlet = step_grid(*NATURAL_STEP)
    dx, dy = grid.dx, grid.dy
    fluid = int(fluid_mask(grid.shape, step_i, inlet, "cpu").sum())
    ps = torch.from_numpy(rng.standard_normal(grid.shape).astype(np.float32)).to(dev)
    bs = torch.from_numpy((rng.standard_normal(grid.shape) * 10).astype(np.float32)).to(dev)
    log(f"  the natural step's level 0: {grid.shape}, {fluid} fluid cells")
    # rows 12 and 12-res redesigned: error 0 in the three variants; the
    # entry points' device time and device operations a call at the path's
    # instances (time_pairs rows 12, the field variant, and 12-res)
    timing = {}
    for kw, labels in (({}, ("p",)), ({"with_residual_field": True}, ("p", "r")),
                       ({"with_residual": True}, ("p", "max|r|"))):
        pairs = make_step_masked_pairs(grid.shape, step_i, inlet, 1 / dx ** 2, 1 / dy ** 2,
                                       1.0, 2, device=dev, **kw)
        n_ops = fluid * (2 * STEP_GS_OPS + (STEP_RES_OPS if kw else 0))
        timed(pairs.record.name, lambda: pairs.kernel(ps, bs), lambda: pairs.plain(ps, bs),
              lambda got: nbytes(ps, bs, *got), n_ops, labels)
        if kw:
            timing[pairs.record.name] = carry_dev_ms(lambda: pairs.kernel(ps, bs))
    ops = child_launches(("12", "12-res"), "time_pairs")
    for name, row in ((SS.STEP_PAIRS.name, "12"), (SS.STEP_PAIRS_RES.name, "12-res")):
        bit_identical(name, [results[name]["err"]])
        results[name].update(dev_ms=timing[name], launches_a_call=ops[row])
        log(f"  {name}: {results[name]['ms']:.4f} ms{dev_note(results[name])}")
    return results


def check_fused_pre_kernels(dev) -> dict:
    """Phase 28: row 7 (the cavity carry with the first pre-smooth and
    restriction) at the 2048^2 shapes, timed beside the composed carry ->
    pre pair, and row 8c (the channel's non-carry stage) at the 1536x512
    shapes, against their twins, with their times and bounds."""
    from cfd_tpu_torch.cases import make_cavity_case, make_channel_case
    from cfd_tpu_torch.kernels import quad as Q

    rng = np.random.default_rng(28)

    def fields(shape, n, interior_only=0):
        """n seeded quad fields, the last ``interior_only`` zero on the ghosts."""
        out = []
        for k in range(n):
            a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
            if k >= n - interior_only:
                a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
            out.append(Q.to_quad(torch.from_numpy(a).to(dev), shape))
        return out

    results = {}
    case = make_cavity_case(n_interior=N_MAIN, poisson="multigrid", dtype=torch.float32,
                            tolerance_factor=1e-6, fuse_pre=True,
                            mg_overrides={"whole_solve": False}, device=dev)
    fused = case.step_kernels[0]
    pre = fused.pre
    carry = Q.make_quad_corr_predictor_source(case.grid.shape, case.coeffs)
    us, vs, p, pp = fields(case.grid.shape, 4, interior_only=2)
    errs = []
    got, want = fused.kernel(us, vs, p, pp), fused.plain(us, vs, p, pp)
    for name, a, b in zip(("us'", "vs'", "b", "p1", "rc", "max|b|"), got, want, strict=True):
        rel_err(a, b, f"{Q.FUSED_PRE.name} {name}", TOL_F32, errs)

    def composed():
        _, _, b, guess, _ = carry.kernel(us, vs, p, pp)
        return pre.kernel(guess, b)

    bit_identical(Q.FUSED_PRE.name, errs)
    run = lambda: fused.kernel(us, vs, p, pp)
    # in turns: fused, composed, composed, fused; wrapper ms, then device ms
    times = [median_ms(run), median_ms(composed), median_ms(composed), median_ms(run)]
    dms = [carry_dev_ms(run), carry_dev_ms(composed), carry_dev_ms(composed), carry_dev_ms(run)]
    cells = case.grid.nx * case.grid.ny
    results[Q.FUSED_PRE.name] = dict(
        err=max(errs), ms=times[0], ms_again=times[3], composed_ms=times[1:3],
        dev_ms=dms[0], dev_ms_again=dms[3], composed_dev_ms=dms[1:3],
        launches_a_call=child_launches(("7",), "time_carries")["7"],
        plain_ms=median_ms(lambda: fused.plain(us, vs, p, pp), reps=5),
        **bound(nbytes(us, vs, p, pp, *got, pre.wE, pre.wW, pre.wN, pre.wS),
                cells * (CORRECTOR_OPS + PREDICTOR_SOURCE_OPS + pre.n_pairs * GS_OPS + RES_OPS)
                + cells // 4 * RESTRICT_OPS))
    del case, fused, carry, got, want
    ch = make_channel_case(nx=CHANNEL[0], ny=CHANNEL[1], poisson="multigrid",
                           tolerance_factor=1e-6, abs_tol=0.0, dtype=torch.float32, device=dev)
    pred = Q.make_quad_channel_predictor_source(ch.grid.shape, ch.coeffs,
                                                ch.step_kernels[0].uin)
    u, v = fields(ch.grid.shape, 2)
    errs = []
    got, want = pred.kernel(u, v), pred.plain(u, v)
    for name, a, b in zip(("us", "vs", "b", "sum b"), got, want, strict=True):
        rel_err(a, b, f"{Q.CHANNEL_PREDICTOR_SOURCE.name} {name}", TOL_F32, errs)
    # row 8c redesigned: error 0, its device time and device operations a
    # call (time_carries row 8c, the same instance)
    bit_identical(Q.CHANNEL_PREDICTOR_SOURCE.name, errs)
    cells = ch.grid.nx * ch.grid.ny
    results[Q.CHANNEL_PREDICTOR_SOURCE.name] = dict(
        err=max(errs), ms=median_ms(lambda: pred.kernel(u, v)),
        dev_ms=carry_dev_ms(lambda: pred.kernel(u, v)),
        launches_a_call=child_launches(("8c",), "time_carries")["8c"],
        plain_ms=median_ms(lambda: pred.plain(u, v)),
        **bound(nbytes(u, v, *got), cells * (PREDICTOR_SOURCE_OPS + 1)))
    return results


def split_channel(case):
    """The channel case with its carry replaced by the split ordering the
    reference holds it to (tests/test_quad.py:371): the corrector (row 8b)
    then the non-carry stage (row 8c), (us, vs, p, p_prev) -> (us', vs', b,
    guess, sum b); make_step then removes the mean and runs the case's
    solve as for the carry. No factory offers this path: it is composed
    here to drive row 8c at full width."""
    from cfd_tpu_torch.kernels import quad as Q

    carry, corr = case.step_kernels
    pred = Q.make_quad_channel_predictor_source(case.grid.shape, case.coeffs, carry.uin)

    def split(us, vs, p, p_prev):
        u, v, guess = corr(us, vs, p, p_prev)
        us2, vs2, b, sum_b = pred(u, v)
        return us2, vs2, b, guess, sum_b

    return dataclasses.replace(case, step_kernels=(split, corr))


def hold_run(what: str, iters, state, ref_iters, ref_state, exact: bool) -> None:
    """A run held to a reference run from the same start: equal cycles on
    every step, the carried fields within 1e-5 relative and, with ``exact``,
    bit-identical."""
    if list(iters) != list(ref_iters):
        raise AssertionError(f"{what}: cycles differ from the reference run's: {iters} "
                             f"against {ref_iters}")
    same = True
    for name, a, b in zip(("u", "v", "p", "T", "p_prev"), state, ref_state, strict=True):
        if a is None:
            continue
        rel_err(a, b, f"{what} {name}", TOL_F32, [])
        same = same and torch.equal(a, b)
    if exact and not same:
        raise AssertionError(f"{what}: fields not bit-identical to the reference run's")
    log(f"  {what}: equal cycles on all {len(iters)} steps, fields "
        f"{'bit-identical' if same else 'within 1e-5 relative, not bit-identical'}")


def check_shard_op(kname: str, op, fields, single, names, n_fields: int, P: int,
                   extra=(), dev=False) -> tuple[list, tuple]:
    """One shard kernel against its twin on shards 0, 1 and 3 of a SHARDS-way
    mesh: ``fields`` are the global quad (or level-1) inputs, sliced to each
    shard's local block; every output bit-identical to the twin's, the
    first ``n_fields`` on the own rows equal to ``single`` (the
    single-device kernel's outputs) on the same global rows. Returns the
    errors and, on shard 1, (kernel ms, plain ms, bytes of one block's
    inputs, outputs and ``extra``, and with ``dev`` its dev_ms)."""
    from cfd_tpu_torch.kernels import quad as Q

    H = Q.DEV_HALO
    Hq8 = fields[0].shape[-2]
    Hq8s = P * SHARDS
    errs, timing = [], None
    for jy in (0, 1, 3):
        rb = jy * P - H
        args = tuple(torch.nn.functional.pad(t, (0, 0, H, Hq8s - Hq8 + H))[
            ..., jy * P : jy * P + P + 2 * H, :].contiguous() for t in fields)
        got, want = op.kernel(rb, *args), op.plain(rb, *args)
        for name, a, w in zip(names, got, want, strict=True):
            rel_err(a, w, f"{kname} shard {jy} {name}", TOL_F32, errs)
            if not torch.equal(a, w):
                raise AssertionError(f"{kname} shard {jy} {name}: not bit-identical to its "
                                     "twin")
        lo = jy * P
        hi = max(lo, min(lo + P, Hq8))  # the shard's global rows inside the field
        for k in range(n_fields):
            if not torch.equal(got[k][..., H : H + hi - lo, :], single[k][..., lo:hi, :]):
                raise AssertionError(f"{kname} shard {jy} {names[k]}: own rows differ from "
                                     "the single-device kernel's")
        if jy == 1:
            timing = (median_ms(lambda: op.kernel(rb, *args)),
                      median_ms(lambda: op.plain(rb, *args), reps=5),
                      nbytes(*args, *got, *extra))
            if dev:
                timing += (carry_dev_ms(lambda: op.kernel(rb, *args)),)
        log(f"  {kname} shard {jy} (row_base {rb}, global rows {lo}..{hi - 1} in the field): "
            "bit-identical to the twin, own rows equal to the single-device kernel's")
    return errs, timing


def check_shard_kernels(case, dev) -> dict:
    """Phase 32: rows 16a-16c against their twins on shards 0, 1 and 3 of a
    SHARDS-way mesh at the per-kernel cavity's shapes, and on the own rows
    against the single-device kernels (rows 1, 3, 4) of ``case``."""
    from cfd_tpu_torch.kernels import quad as Q

    rng = np.random.default_rng(32)
    g = case.grid
    shape = g.shape
    _, P, W = Q.quad_shard_dims(shape, SHARDS)
    Hq8, H = Q.quad_dims(shape)[2], Q.DEV_HALO
    inner = np.zeros(shape, np.float32)
    inner[1:-1, 1:-1] = 1.0

    def field(scale=0.1, interior_only=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return Q.to_quad(torch.from_numpy(a * inner if interior_only else a).to(dev), shape)

    us, vs, p, pp = field(), field(), field(interior_only=True), field(interior_only=True)
    b = field(scale=1e3, interior_only=True)
    ec = torch.zeros(Hq8, W, device=dev)
    ec[1 : g.ny // 2 + 1, 1 : g.nx // 2 + 1] = torch.from_numpy(
        rng.standard_normal((g.ny // 2, g.nx // 2)).astype(np.float32) * 0.1).to(dev)
    carry, solve, mg = case.step_kernels[0], case.poisson_solve, case.info["mg"]
    loc, shard = (P + 2 * H, W), (P, SHARDS)
    prob = solve_problem(case)
    pre = Q.make_quad_pre_smooth_restrict(shape, prob, mg.omega, mg.pre_sweeps, loc,
                                          device=dev, shard=shard)
    post = Q.make_quad_post_prolong_smooth(shape, prob, mg.omega, mg.post_sweeps, loc,
                                           device=dev, shard=shard)
    weights = (pre.wE, pre.wW, pre.wN, pre.wS)
    cells = 2 * (P + 2 * H) * g.nx  # the block's logical cells
    checks = (
        (Q.SHARD_CARRY, Q.make_quad_corr_predictor_source(shape, case.coeffs, carry.lid,
                                                          shard=shard),
         (us, vs, p, pp), carry.kernel(us, vs, p, pp), ("us'", "vs'", "b", "guess", "max|b|"),
         4, (), cells * (CORRECTOR_OPS + PREDICTOR_SOURCE_OPS)),
        (Q.SHARD_PRE, pre, (p, b), solve.pre0.kernel(p, b), ("p", "rc"), 2, weights,
         cells * (mg.pre_sweeps * GS_OPS + RES_OPS) + cells // 4 * RESTRICT_OPS),
        (Q.SHARD_POST, post, (p, b, ec), solve.post0.kernel(p, b, ec), ("p", "max|r|"), 1,
         weights, cells * (PROLONG_OPS + mg.post_sweeps * GS_OPS + RES_OPS + 1)))
    results = {}
    # rows 16b and 16c (one launch of tiles each): their device ms and
    # device operations a call (time_level0, the same instances on shard 1)
    ops = child_launches(("16b", "16c"), "time_level0")
    for kern, op, fields, single, names, n_fields, extra, n_ops in checks:
        tiled = kern is not Q.SHARD_CARRY
        errs, timing = check_shard_op(kern.name, op, fields, single, names, n_fields, P, extra,
                                      dev=tiled)
        results[kern.name] = dict(err=max(errs), ms=timing[0], plain_ms=timing[1],
                                  **bound(timing[2], n_ops))
        if tiled:
            bit_identical(kern.name, errs)
            results[kern.name].update(dev_ms=timing[3],
                                      launches_a_call=ops["16b" if kern is Q.SHARD_PRE
                                                          else "16c"])
    return results


def check_flavor_shard_kernels(cases: dict, dev) -> dict:
    """Phase 35: rows 16d and 16e against their twins on shards 0, 1 and 3
    of a SHARDS-way mesh at the channel's and RB's shapes, and on the own
    rows against the single-device carries (rows 8a, 10) of ``cases``."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.physics.boussinesq import RBParams

    rng = np.random.default_rng(35)
    results = {}
    for flavor, case in cases.items():
        g = case.grid
        shape = g.shape
        _, P, _ = Q.quad_shard_dims(shape, SHARDS)
        inner = np.zeros(shape, np.float32)
        inner[1:-1, 1:-1] = 1.0
        profile = np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]

        def field(scale=0.1, interior_only=False, offset=None):
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            if offset is not None:
                a += offset
            return Q.to_quad(torch.from_numpy(a * inner if interior_only else a).to(dev),
                             shape)

        us, vs, p = field(), field(), field(interior_only=True)
        aux = field(0.01, offset=profile) if flavor == "rb" else field(interior_only=True)
        carry = case.step_kernels[0]
        per_cell = CORRECTOR_OPS + PREDICTOR_SOURCE_OPS
        if flavor == "channel":
            kern = Q.SHARD_CHANNEL_CARRY
            op = Q.make_quad_channel_corr_predictor_source(shape, case.coeffs, carry.uin,
                                                           shard=(P, SHARDS))
            names = ("us'", "vs'", "b", "guess", "sum_own")
        else:
            kern, info = RQ.SHARD_RB_CARRY, case.info
            op = RQ.make_quad_rb_step_kernel(
                shape, case.coeffs, info["kappa"],
                RBParams(info["rayleigh"], info["prandtl"], info["t_bottom"], info["t_top"]),
                shard=(P, SHARDS))
            names = ("us'", "vs'", "T'", "b", "sum_own")
            per_cell += TEMPERATURE_OPS + BUOYANCY_OPS
        fields = (us, vs, p, aux)
        errs, (ms, plain_ms, n_bytes) = check_shard_op(kern.name, op, fields,
                                                       carry.kernel(*fields), names, 4, P)
        cells = 2 * (P + 2 * Q.DEV_HALO) * g.nx  # the block's logical cells
        results[kern.name] = dict(err=max(errs), ms=ms, plain_ms=plain_ms,
                                  **bound(n_bytes, cells * per_cell))
    return results


def run_stages(sim, stops):
    """Simulation.run through the steps in ``stops`` (e.g. (3, 100, 300)),
    one call a stage; returns the logical state at each stop, the carried
    final state and steps/s over the last 100 steps (the rows come every
    100 steps and at each stop)."""
    states, state, k = [], None, 0
    for stop in stops:
        state = sim.run(state=state, n_steps=stop - k, start_step=k)
        states.append(sim._logical(state))
        last, k = stop - k, stop
    torch.cuda.synchronize()
    h = sim.history
    steps_s = min(100, last) / (h[-1]["wall_seconds"] - (h[-2]["wall_seconds"]
                                                        if last > 100 else 0.0))
    return states, state, steps_s


def run_sharded(case, stops, what: str, card: str, sharded_kwargs, path_kernels, absent=()):
    """Drive ``case`` on a SHARDS-shard mesh on the card through run_stages,
    the launch counters zeroed just before and read just after: every
    kernel of ``path_kernels`` must have launched and none of ``absent``.
    Returns (launches, the logical states at ``stops``, steps/s over the
    last 100 steps, the Simulation)."""
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.parallel import make_mesh
    from cfd_tpu_torch.solver import Simulation

    sim = Simulation(case, log=lambda m: None, mesh=make_mesh(SHARDS),
                     sharded_kwargs=sharded_kwargs)
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    states, _, steps_s = run_stages(sim, stops)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    missing = [k.name for k in path_kernels if launches[k.name] == 0]
    extra = [k.name for k in absent if launches[k.name]]
    if missing or extra:
        raise AssertionError(f"{what}: kernels never launched {missing}, launched against "
                             f"the path {extra}")
    for fname in ("u", "v", "p", "T"):
        a = getattr(states[-1], fname)
        if a is not None and not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {fname} after the {what} run")
    n = stops[-1]
    log(f"  {what}: {n} steps in {wall:.2f} s; last {min(100, n)}: {steps_s:.2f} steps/s, "
        f"{np.mean(sim.step_iters[-100:]):.2f} V-cycles/step, "
        f"{sum(launches.values()) / n:.2f} port kernel launches/step "
        f"({', '.join(f'{k} {v / n:.2f}' for k, v in launches.items() if v)})  ({card})")
    return launches, states, steps_s, sim


def hold_sharded(what: str, iters, st, ref_iters, ref_st, p_band: float | None) -> bool:
    """A sharded run against another run from the same start. ``p_band``
    None: equal cycles on every step and bit-identical logical fields.
    Else the reference's bands (tests/test_quad_sharded.py:57-93, :163-225,
    :282-325): cycles within 1 on every step, u, v and T within 2e-5 of
    scale, p and p_prev (the step before's p) within ``p_band`` of scale.
    Prints the maxima; returns whether cycles and fields were
    bit-identical."""
    diff = [abs(a - b) for a, b in zip(iters, ref_iters)]
    if len(iters) != len(ref_iters) or max(diff) > (0 if p_band is None else 1):
        raise AssertionError(f"{what}: cycles {iters} against {ref_iters}")
    same = max(diff) == 0
    for name in ("u", "v", "p", "T", "p_prev"):
        a, w = getattr(st, name), getattr(ref_st, name)
        if w is None:
            continue
        abs_err = float((a - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        band = 0.0 if p_band is None else p_band if name in ("p", "p_prev") else 2e-5
        log(f"  {what} {name}: max|err|={abs_err:.3e} = {abs_err / scale:.3e} of scale "
            f"(limit {band:.0e})")
        if not abs_err <= band * scale:
            raise AssertionError(f"{what}: {name} differs by {abs_err:.3e}")
        same = same and torch.equal(a, w)
    log(f"  {what}: {'equal' if max(diff) == 0 else 'within 1'} cycles on all "
        f"{len(iters)} steps, {'bit-identical' if same else 'not bit-identical'}")
    return same


def drift(what: str, iters, st, ref_iters, ref_st) -> None:
    """Print how far a run drifted from another from the same start: the
    steps whose cycles differ and the fields' largest gap (a measurement,
    no limit)."""
    diff = [abs(a - b) for a, b in zip(iters, ref_iters, strict=True)]
    gaps = []
    for n in ("u", "v", "p", "T"):
        a, w = getattr(st, n), getattr(ref_st, n)
        if w is not None:
            gaps.append(f"{n} {float((a - w).abs().max()) / max(1.0, float(w.abs().max())):.3e}")
    first = next((k + 1 for k, d in enumerate(diff) if d), "-")
    log(f"  {what}: cycles differ on {sum(d > 0 for d in diff)} of {len(diff)} steps (by at "
        f"most {max(diff)}, first at step {first}); the fields' largest gap, of scale: "
        f"{', '.join(gaps)}")


def shard_order_case(case, engine):
    """The single-device per-kernel ``case`` with its float32 sums taken in
    the sharded ``engine``'s order: the carry's source sum and, with the
    pin, the solve's per-cycle sum of p add the shards' own-row partials
    (own_row_sum of the engine's local blocks) in shard order (global_sum).
    Every other operation is the single-device path's, so the sharded run
    equals this one bit for bit when the sum order is the only difference.
    The lagged adaptive step (Case.adaptive_impl_carry) takes its source sum
    in the same order (adaptive_in_shard_order). No factory offers this
    path: it is composed here, as split_channel."""
    from cfd_tpu_torch.kernels.quad import own_row_sum
    from cfd_tpu_torch.parallel import global_sum

    def shard_sum(q):
        return global_sum([own_row_sum(x, engine.P) for x in engine._extend(q)])

    carry, corr = case.step_kernels
    k_b = 3 if case.ordering == "rayleigh_benard" else 2  # (us', vs', T', b) or (us', vs', b)

    def carry_in_shard_order(*fields):
        out = list(carry(*fields))
        out[-1] = shard_sum(out[k_b])
        return tuple(out)

    solve = case.poisson_solve
    if solve.cfg.pin_mean:
        def cycle(p, b, plain=False):
            p, res = solve._vcycle(p, b, plain)
            return torch.where(solve.cell, p - shard_sum(p) / solve.n_int, p), res

        solve.cycle = cycle
    return dataclasses.replace(case, step_kernels=(carry_in_shard_order, corr),
                               adaptive_impl_carry=adaptive_in_shard_order(case, shard_sum))


def adaptive_in_shard_order(case, shard_sum):
    """``case.adaptive_impl_carry`` with the traced-dt + Courant carry's
    source sum replaced by ``shard_sum`` of its b: the channel's, RB's and the
    step's lagged step (cases/channel.py, physics/boussinesq.py,
    cases/backwards_step.py adaptive_impl_carry) composed from the same
    carry, mean removal and solve. The cavity sums nothing: its own."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.physics.boussinesq import RBParams
    from cfd_tpu_torch.solver import remove_mean_quad
    from cfd_tpu_torch.state import State, StepDiagnostics

    if case.ordering == "cavity":
        return case.adaptive_impl_carry
    g, c, info, solve = case.grid, case.coeffs, case.info, case.poisson_solve
    carry = case.step_kernels[0]
    n = torch.tensor(float(g.n_fluid), dtype=torch.float32, device=case.device)
    co = lambda mu, mv: mu * (1.0 / g.dx) + mv * (1.0 / g.dy)
    if case.ordering == "rayleigh_benard":
        params = RBParams(info["rayleigh"], info["prandtl"], info["t_bottom"], info["t_top"])
        fused = RQ.make_quad_rb_step_kernel(g.shape, c, info["kappa"], params, adaptive=True)
        cell = Q.quad_cell_mask(g.shape, case.device)

        def step(st, dts):
            us2, vs2, T2, b, _, mu, mv = fused(dts, st.u, st.v, st.p, st.T)
            p, iters, res = solve(st.p, remove_mean_quad(b, shard_sum(b), n, cell))
            return State(us2, vs2, p, T2, None), StepDiagnostics(iters, res), co(mu, mv)
    elif case.name == "backwards_step":
        fused = SQ.make_quad_step_corr_predictor_source(g.shape, c, carry.step_i,
                                                        carry.inlet_j, carry.uin, adaptive=True)
        cell = SQ.step_cell_mask(g.shape, carry.step_i, carry.inlet_j, case.device)

        def step(st, dts):
            us2, vs2, b, _, mu, mv = fused(dts, st.u, st.v, st.p)
            p, iters, res = solve(st.p, remove_mean_quad(b, shard_sum(b), n, cell))
            return State(us2, vs2, p, st.T, None), StepDiagnostics(iters, res), co(mu, mv)
    else:
        fused = Q.make_quad_channel_corr_predictor_source(g.shape, c, carry.uin, adaptive=True)
        cell = Q.quad_cell_mask(g.shape, case.device)

        def step(st, dts):
            us2, vs2, b, guess, _, mu, mv = fused(dts, st.u, st.v, st.p, st.p_prev)
            p, iters, res = solve(guess, remove_mean_quad(b, shard_sum(b), n, cell))
            return State(us2, vs2, p, st.T, st.p), StepDiagnostics(iters, res), co(mu, mv)

    def impl():
        _, to_aligned, to_logical = case.adaptive_impl_carry()
        return step, to_aligned, to_logical

    return impl


def delegates(case, single_kerns, shard_kerns) -> None:
    """A 1-shard mesh with default kwargs delegates to the case's own
    single-device step: over 20 steps each of ``single_kerns`` launches and
    none of ``shard_kerns`` does."""
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.parallel import make_mesh
    from cfd_tpu_torch.solver import Simulation

    sim = Simulation(case, log=lambda m: None, mesh=make_mesh(1))
    for kern in KERNELS:
        kern.launches = 0
    sim.run(n_steps=20)
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in (*single_kerns, *shard_kerns)}
    if (not sim._engine.delegated or not all(k.launches for k in single_kerns)
            or any(k.launches for k in shard_kerns)):
        raise AssertionError(f"1-shard mesh: delegated={sim._engine.delegated}, launches {got}")
    log(f"  1-shard mesh, default kwargs: delegated, launches over 20 steps {got}")


def sharded_phases(card: str, dev, cav_main: dict) -> tuple[dict, dict]:
    """Phases 32-34: the shard kernels against their twins, the sharded
    cavity against the single-device path at full width, card against CPU.
    Returns the kernels' checks and the 300-step run's launches."""
    from cfd_tpu_torch.cases import make_cavity_case
    from cfd_tpu_torch.kernels import mg_tail as MT
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_smoother as RB
    from cfd_tpu_torch.kernels import whole_solve as WS
    from cfd_tpu_torch.solver import Simulation

    log(f"phase 32: the shard kernels (rows 16a-16c) at the {N_MAIN}^2 shapes of a "
        f"{SHARDS}-shard mesh vs their plain twins and the single-device kernels ({card})")
    pk_case = make_cavity_case(device=dev, mg_overrides={"whole_solve": False}, **cav_main)
    sh_checks = check_shard_kernels(pk_case, dev)
    for k, r in sh_checks.items():
        log(f"  {k:36s} kernel {r['ms']:.4f} ms{dev_note(r)}  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), one local block  ({card})")

    log(f"phase 33: the sharded cavity at {N_MAIN}^2 on {SHARDS} shards of the card, 300 "
        f"steps beside the single-device per-kernel run, then 100 with tail_from=1, then a "
        f"1-shard mesh ({card})")
    pk_case = make_cavity_case(device=dev, fuse_pre=False, mg_overrides={"whole_solve": False},
                               **cav_main)
    if pk_case.info["mg"].coarse_dtype is not None:
        raise AssertionError("the single-device reference run took the bf16 hierarchy")
    ref = Simulation(pk_case, log=lambda m: None)
    (ref_100, ref_st), _, ref_steps_s = run_stages(ref, (100, 300))
    log(f"  single-device per-kernel: last 100 of 300 steps {ref_steps_s:.2f} steps/s, "
        f"{np.mean(ref.step_iters[-100:]):.2f} V-cycles/step  ({card})")
    case = make_cavity_case(device=dev, **cav_main)
    shard_path = (Q.SHARD_CARRY, Q.SHARD_PRE, Q.SHARD_POST, RB.RB_PAIRS)
    shard_launches, (st,), steps_s, sim = run_sharded(
        case, (300,), f"sharded cavity, {SHARDS} shards", card, {"tol_factor": 1e-6},
        shard_path, absent=(Q.CARRY, Q.PRE, Q.POST, WS.WHOLE_SOLVE))
    if sim._engine.delegated or sim._engine.P != 264:
        raise AssertionError(f"sharded engine: delegated={sim._engine.delegated} "
                             f"P={sim._engine.P}")
    same = hold_sharded("sharded vs single-device, 300 steps", sim.step_iters, st,
                        ref.step_iters, ref_st, 2e-5)
    log(f"  sharded cavity: {steps_s:.2f} steps/s against the single-device per-kernel "
        f"{ref_steps_s:.2f}, {np.mean(sim.step_iters[-100:]):.2f} V-cycles/step, "
        f"{'bit-identical' if same else 'not bit-identical'}  ({card})")
    _, (st,), _, tail = run_sharded(
        case, (100,), "sharded cavity tail_from=1", card,
        {"tol_factor": 1e-6, "mg_overrides": {"tail_from": 1}},
        (Q.SHARD_CARRY, Q.SHARD_PRE, Q.SHARD_POST, MT.MG_TAIL), absent=(RB.RB_PAIRS,))
    if tail._engine._solve.tail_at != 2:
        raise AssertionError(f"the sharded tail starts at level {tail._engine._solve.tail_at}")
    hold_sharded("sharded tail_from=1 vs single-device, 100 steps", tail.step_iters, st,
                 ref.step_iters[:100], ref_100, 2e-5)
    del case, ref, sim, tail, st
    delegates(pk_case, (Q.CARRY, Q.PRE, Q.POST), (Q.SHARD_CARRY, Q.SHARD_PRE, Q.SHARD_POST))
    del pk_case

    log("phase 34: the sharded cavity card vs CPU, 20 steps")
    for n, shards in ((256, 4), (64, 8)):
        card_vs_cpu(make_cavity_case, dict(n_interior=n, poisson="multigrid",
                                           dtype=torch.float32, tolerance_factor=1e-6,
                                           print_interval=20),
                    f"sharded cavity {n}^2 on {shards} shards", shards=shards,
                    sharded_kwargs={"tol_factor": 1e-6})

    return sh_checks, shard_launches


def flavor_sharded_phases(card: str, dev) -> tuple[dict, dict]:
    """Phases 35-37: rows 16d and 16e against their twins, the sharded
    channel and RB against the single-device per-kernel path at full width,
    card against CPU. Returns the kernels' checks and the launches of the
    300-step runs."""
    from cfd_tpu_torch.cases import make_channel_case, make_rayleigh_benard_case
    from cfd_tpu_torch.kernels import mg_tail as MT
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.kernels import rb_smoother as RB
    from cfd_tpu_torch.kernels import whole_solve as WS
    from cfd_tpu_torch.solver import Simulation

    nx, ny = CHANNEL
    per_kernel = {"whole_solve": False}
    flows = {
        "channel": (lambda **kw: make_channel_case(
            nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0,
            dtype=torch.float32, device=dev, **kw), {"tol_factor": 1e-6}, 5e-4,
            Q.CHANNEL_CARRY, Q.SHARD_CHANNEL_CARRY),
        "rb": (lambda **kw: make_rayleigh_benard_case(
            nx=RB_SHAPE[0], ny=RB_SHAPE[1], rayleigh=1e6, dtype=torch.float32, device=dev,
            **kw), {"tol_factor": 1e-7, "mg_overrides": {"abs_tol": 1e-10}}, 2e-5,
            RQ.RB_CARRY, RQ.SHARD_RB_CARRY)}

    log(f"phase 35: the shard carries (rows 16d, 16e) at the {nx}x{ny} shapes of a "
        f"{SHARDS}-shard mesh vs their plain twins and the single-device carries ({card})")
    checks = check_flavor_shard_kernels(
        {f: make(mg_overrides=per_kernel) for f, (make, *_) in flows.items()}, dev)
    for k, r in checks.items():
        log(f"  {k:42s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), one local block  ({card})")

    log(f"phase 36: the sharded channel and RB at {nx}x{ny} on {SHARDS} shards of the card, "
        f"{SHARD_RUN} steps each beside the single-device per-kernel runs, then 100 with "
        f"tail_from=1, then a 1-shard mesh ({card})")
    launches = {}
    for flavor, (make, kw, p_band, single_kern, shard_kern) in flows.items():
        what = f"sharded {flavor}, {SHARDS} shards"
        got, (at3, first_100, st), steps_s, sim = run_sharded(
            make(), (3, 100, SHARD_RUN), what, card, kw,
            (shard_kern, Q.SHARD_PRE, Q.SHARD_POST, RB.RB_PAIRS),
            absent=(single_kern, Q.PRE, Q.POST, WS.WHOLE_SOLVE, WS.WHOLE_SOLVE_PIN_MEAN))
        engine = sim._engine
        if engine.delegated or engine.P != 72:
            raise AssertionError(f"{what}: delegated={engine.delegated} P={engine.P}")
        launches[shard_kern.name] = got[shard_kern.name]
        ordered = Simulation(shard_order_case(make(mg_overrides=per_kernel), engine),
                             log=lambda m: None)
        (o_st,), _, _ = run_stages(ordered, (SHARD_RUN,))
        hold_sharded(f"{what}, {SHARD_RUN} steps vs the single-device run summed in shard order",
                     sim.step_iters, st, ordered.step_iters, o_st, None)
        del ordered, o_st
        ref = Simulation(make(mg_overrides=per_kernel), log=lambda m: None)
        (r3, r_st), _, ref_steps_s = run_stages(ref, (3, SHARD_RUN))
        hold_sharded(f"{what}, 3 steps vs single-device", sim.step_iters[:3], at3,
                     ref.step_iters[:3], r3, p_band)
        drift(f"{what}, {SHARD_RUN} steps vs single-device", sim.step_iters, st,
              ref.step_iters, r_st)
        log(f"  {what}: {steps_s:.2f} steps/s against the single-device per-kernel "
            f"{ref_steps_s:.2f} ({np.mean(ref.step_iters[-100:]):.2f} V-cycles/step)  ({card})")
        if flavor == "rb":
            for who, row in (("sharded", sim.history[-1]), ("single-device", ref.history[-1])):
                log(f"  rb {who}, step {row['step']}: Nu bottom {row['nusselt_bottom']:.6f}, "
                    f"top {row['nusselt_top']:.6f}, volume {row['nusselt_volume']:.6f}")
        del ref, r_st
        tail_kw = {**kw, "mg_overrides": {**kw.get("mg_overrides", {}), "tail_from": 1}}
        _, (t_st,), _, tail = run_sharded(
            make(), (100,), f"sharded {flavor} tail_from=1", card, tail_kw,
            (shard_kern, Q.SHARD_PRE, Q.SHARD_POST, MT.MG_TAIL), absent=(RB.RB_PAIRS,))
        if tail._engine._solve.tail_at != 2:
            raise AssertionError(f"the sharded tail starts at level "
                                 f"{tail._engine._solve.tail_at}")
        hold_sharded(f"sharded {flavor} tail_from=1 vs the sharded run's first 100 steps",
                     tail.step_iters, t_st, sim.step_iters[:100], first_100, p_band)
        del sim, tail, t_st, st
        delegates(make(mg_overrides=per_kernel), (single_kern, Q.PRE, Q.POST), (shard_kern,))

    log("phase 37: the sharded channel and RB card vs CPU, 20 steps on 4 shards")
    for cnx, cny in ((256, 128), (96, 32)):
        card_vs_cpu(make_channel_case, dict(nx=cnx, ny=cny, poisson="multigrid",
                                            dtype=torch.float32, tolerance_factor=1e-6,
                                            abs_tol=0.0, print_interval=20),
                    f"sharded channel {cnx}x{cny} on {SHARDS} shards", shards=SHARDS,
                    sharded_kwargs=flows["channel"][1])
    card_vs_cpu(make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e6,
                                                dtype=torch.float32, print_interval=20),
                f"sharded rb 256x128 on {SHARDS} shards", shards=SHARDS,
                sharded_kwargs=flows["rb"][1])
    return checks, launches


def check_step_shard_kernels(case, dev) -> dict:
    """Phase 38: row 16f against its twins on shards 0, 1 and 3 of a
    SHARDS-way mesh at the step's shapes, and on the own rows against the
    single-device kernels (rows 9a, 9c, 9d) of the per-kernel V(1,1)
    ``case``."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.kernels.mg_tail import level_masks
    from cfd_tpu_torch.poisson.multigrid import step_rect_params

    rng = np.random.default_rng(38)
    g = case.grid
    shape = g.shape
    _, P, W = Q.quad_shard_dims(shape, SHARDS)
    H = Q.DEV_HALO
    fluid = g.fluid.astype(np.float32)

    def field(scale=0.1, fluid_only=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return Q.to_quad(torch.from_numpy(a * fluid if fluid_only else a).to(dev), shape)

    us, vs, p = field(), field(), field(fluid_only=True)
    b = field(scale=1e3, fluid_only=True)
    solve = case.poisson_solve
    lv1 = solve.levels[0]
    ec = torch.from_numpy(rng.standard_normal(lv1.shape).astype(np.float32) * 0.1).to(dev)
    ec = ec * level_masks(lv1, dev)[1]
    carry, pre0, post0 = case.step_kernels[0], solve.pre0, solve.post0
    step_i, inlet_j = step_rect_params(g)
    loc, shard = (P + 2 * H, W), (P, SHARDS)
    level0 = (shape, step_i, inlet_j, pre0.idx2, pre0.idy2, pre0.omega, 1, loc)
    pre = SQ.make_quad_step_pre_smooth_restrict(*level0, device=dev, shard=shard)
    post = SQ.make_quad_step_post_prolong_smooth(*level0, device=dev, shard=shard)
    rows = slice(2 * (P - H), 2 * (2 * P + H))  # shard 1's block, in logical rows
    cells = 2 * (P + 2 * H) * g.nx  # the block's logical cells
    n_fluid = int(fluid[rows].sum())  # and its fluid cells
    checks = (
        (SQ.SHARD_STEP_CARRY, SQ.make_quad_step_corr_predictor_source(
            shape, case.coeffs, step_i, inlet_j, carry.uin, shard=shard),
         (us, vs, p), carry.kernel(us, vs, p), ("us'", "vs'", "b", "sum_own"), 3,
         cells * (CORRECTOR_OPS + PREDICTOR_SOURCE_OPS), None),
        (SQ.SHARD_STEP_PRE, pre, (p, b), pre0.kernel(p, b), ("p", "rc"), 2,
         n_fluid * (STEP_GS_OPS + STEP_RES_OPS) + cells // 4 * RESTRICT_OPS, "16f-pre"),
        (SQ.SHARD_STEP_POST, post, (p, b, ec), post0.kernel(p, b, ec), ("p", "max|r|"), 1,
         n_fluid * (PROLONG_OPS + STEP_GS_OPS + STEP_RES_OPS + 1), "16f-post"))
    ops = child_launches(("16f-pre", "16f-post"), "time_level0")
    results = {}
    for kern, op, fields, single, names, n_fields, n_ops, row in checks:
        errs, (ms, plain_ms, n_bytes, *dev) = check_shard_op(
            kern.name, op, fields, single, names, n_fields, P, dev=row is not None)
        results[kern.name] = dict(err=max(errs), ms=ms, plain_ms=plain_ms,
                                  **bound(n_bytes, n_ops))
        if row is not None:
            results[kern.name].update(dev_ms=dev[0], launches_a_call=ops[row])
    return results


def step_sharded_phases(card: str, dev) -> tuple[dict, dict]:
    """Phases 38-40: row 16f against its twins, the sharded step against the
    single-device per-kernel V(1,1) path at full width, card against CPU.
    Returns the kernels' checks and the 300-step run's launches."""
    from cfd_tpu_torch.cases import make_backwards_step_case
    from cfd_tpu_torch.kernels import mg_tail as MT
    from cfd_tpu_torch.kernels import rb_smoother as RB
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.kernels import whole_solve as WS
    from cfd_tpu_torch.solver import Simulation

    nx, ny = STEP
    st_kw = dict(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0,
                 dtype=torch.float32, print_interval=100, save_interval=100)
    v11 = {"whole_solve": False, "pre_sweeps": 1, "post_sweeps": 1}
    make = lambda **kw: make_backwards_step_case(device=dev, **st_kw, **kw)

    log(f"phase 38: the step's shard kernels (row 16f) at the {nx}x{ny} shapes of a "
        f"{SHARDS}-shard mesh vs their plain twins and the single-device kernels ({card})")
    checks = check_step_shard_kernels(make(mg_overrides=v11), dev)
    for k, r in checks.items():
        log(f"  {k:40s} kernel {r['ms']:.4f} ms{dev_note(r)}  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), one local block  ({card})")

    log(f"phase 39: the sharded step at {nx}x{ny} on {SHARDS} shards of the card, {SHARD_RUN} "
        f"steps beside the single-device per-kernel V(1,1) run, then 100 with tail_from=1, "
        f"then a 1-shard mesh ({card})")
    kw = {"tol_factor": 1e-6}
    what = f"sharded step, {SHARDS} shards"
    shard_path = (SQ.SHARD_STEP_CARRY, SQ.SHARD_STEP_PRE, SQ.SHARD_STEP_POST)
    got, (at3, first_100, st), steps_s, sim = run_sharded(
        make(), (3, 100, SHARD_RUN), what, card, kw, (*shard_path, RB.RB_PAIRS_FULL),
        absent=(SQ.STEP_CARRY, SQ.STEP_PRE, SQ.STEP_POST, WS.STEP_WHOLE_SOLVE))
    engine = sim._engine
    if engine.delegated or engine.P != 40 or engine.mg.post_sweeps != 1:
        raise AssertionError(f"{what}: delegated={engine.delegated} P={engine.P}")
    launches = {k.name: got[k.name] for k in shard_path}
    ordered = Simulation(shard_order_case(make(mg_overrides=v11), engine), log=lambda m: None)
    (o_st,), _, _ = run_stages(ordered, (SHARD_RUN,))
    hold_sharded(f"{what}, {SHARD_RUN} steps vs the single-device V(1,1) run summed in shard "
                 f"order",
                 sim.step_iters, st, ordered.step_iters, o_st, None)
    del ordered, o_st
    ref = Simulation(make(mg_overrides=v11), log=lambda m: None)
    (r3, r_st), _, ref_steps_s = run_stages(ref, (3, SHARD_RUN))
    # p: the reference's band for the source mean's float32 rounding
    # (tests/test_quad_sharded.py:210-222), as the channel's in phase 36
    hold_sharded(f"{what}, 3 steps vs single-device V(1,1)", sim.step_iters[:3], at3,
                 ref.step_iters[:3], r3, 5e-4)
    drift(f"{what}, {SHARD_RUN} steps vs single-device V(1,1)", sim.step_iters, st,
          ref.step_iters, r_st)
    log(f"  {what}: {steps_s:.2f} steps/s against the single-device per-kernel V(1,1) "
        f"{ref_steps_s:.2f} ({np.mean(ref.step_iters[-100:]):.2f} V-cycles/step)  ({card})")
    del ref, r_st
    _, (t_st,), _, tail = run_sharded(
        make(), (100,), "sharded step tail_from=1", card,
        {**kw, "mg_overrides": {"tail_from": 1}}, (*shard_path, MT.MG_TAIL_FULL),
        absent=(RB.RB_PAIRS_FULL,))
    if tail._engine._solve.tail_at != 2:
        raise AssertionError(f"the sharded tail starts at level {tail._engine._solve.tail_at}")
    hold_sharded("sharded step tail_from=1 vs the sharded run's first 100 steps",
                 tail.step_iters, t_st, sim.step_iters[:100], first_100, None)
    del sim, tail, t_st, st
    delegates(make(mg_overrides={"whole_solve": False}),
              (SQ.STEP_CARRY, SQ.STEP_PRE, SQ.STEP_POST), shard_path)

    log("phase 40: the sharded step card vs CPU, 20 steps")
    for cnx, cny, shards in ((512, 64, SHARDS), (32, 8, 2)):
        # the per-kernel case: 32x8 has too few levels for the whole-solve,
        # which the sharded engine does not run either
        card_vs_cpu(make_backwards_step_case, dict(nx=cnx, ny=cny, poisson="multigrid",
                                                   dtype=torch.float32, tolerance_factor=1e-6,
                                                   abs_tol=0.0, print_interval=20,
                                                   mg_overrides={"whole_solve": False}),
                    f"sharded step {cnx}x{cny} on {shards} shards", shards=shards,
                    sharded_kwargs=kw)
    return checks, launches


def check_adaptive_shard_kernels(cases: dict, dev) -> dict:
    """Phase 41: rows 16a+, 16d+, 16e+ and 16f+ against their twins on shards
    0, 1 and 3 of a SHARDS-way mesh at the four flows' full widths, with
    dt_corr = 0.8 dt and dt_pred = 1.1 dt: every output bit-identical, the
    own rows equal to the single-device adaptive carries (rows 1+, 8a+, 10+,
    9a+) on the same global rows, the maxima of mu and mv over all the
    shards equal to the whole field's, and mu and mv unmoved by halo rows
    poisoned with +-1e3. Times on shard 1 beside the fixed-dt shard carry
    (rows 16a, 16d, 16e, 16f) on the same inputs."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.physics.boussinesq import RBParams

    H = Q.DEV_HALO
    rng = np.random.default_rng(41)
    results = {}
    for flow, case in cases.items():
        g, c, info = case.grid, case.coeffs, case.info
        shape = g.shape
        _, P, _ = Q.quad_shard_dims(shape, SHARDS)
        shard = (P, SHARDS)
        cells_mask = g.fluid.astype(np.float32) if flow == "step" else np.pad(
            np.ones((g.ny, g.nx), np.float32), 1)
        profile = np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]

        def field(scale=0.1, masked=False, offset=None):
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            if offset is not None:
                a += offset
            return Q.to_quad(torch.from_numpy(a * cells_mask if masked else a).to(dev), shape)

        us, vs, p = field(), field(), field(masked=True)
        per_cell = CORRECTOR_OPS + PREDICTOR_SOURCE_OPS + COURANT_OPS
        carry = case.step_kernels[0]
        if flow == "cavity":
            kern, fixed = Q.SHARD_CARRY_ADAPTIVE, Q.SHARD_CARRY
            make = lambda **kw: Q.make_quad_corr_predictor_source(shape, c, carry.lid, **kw)
            fields, n_fields = (us, vs, p, field(masked=True)), 4
            names = ("us'", "vs'", "b", "guess", "max|b|")
        elif flow == "channel":
            kern, fixed = Q.SHARD_CHANNEL_CARRY_ADAPTIVE, Q.SHARD_CHANNEL_CARRY
            make = lambda **kw: Q.make_quad_channel_corr_predictor_source(shape, c, carry.uin,
                                                                          **kw)
            fields, n_fields = (us, vs, p, field(masked=True)), 4
            names = ("us'", "vs'", "b", "guess", "sum_own")
        elif flow == "rb":
            kern, fixed = RQ.SHARD_RB_CARRY_ADAPTIVE, RQ.SHARD_RB_CARRY
            params = RBParams(info["rayleigh"], info["prandtl"], info["t_bottom"], info["t_top"])
            make = lambda **kw: RQ.make_quad_rb_step_kernel(shape, c, info["kappa"], params,
                                                            **kw)
            fields, n_fields = (us, vs, p, field(0.01, offset=profile)), 4
            names = ("us'", "vs'", "T'", "b", "sum_own")
            per_cell += TEMPERATURE_OPS + BUOYANCY_OPS
        else:
            kern, fixed = SQ.SHARD_STEP_CARRY_ADAPTIVE, SQ.SHARD_STEP_CARRY
            make = lambda **kw: SQ.make_quad_step_corr_predictor_source(
                shape, c, carry.step_i, carry.inlet_j, carry.uin, **kw)
            fields, n_fields = (us, vs, p), 3
            names = ("us'", "vs'", "b", "sum_own")
        names += ("max|u|", "max|v|")
        dts = torch.tensor([0.8 * c.dt, 1.1 * c.dt], dtype=torch.float32, device=dev)
        op, fixed_op = make(adaptive=True, shard=shard), make(shard=shard)
        single = make(adaptive=True).kernel(dts, *fields)
        with_dts = SimpleNamespace(kernel=lambda rb, *a: op.kernel(rb, dts, *a),
                                   plain=lambda rb, *a: op.plain(rb, dts, *a))
        errs, (ms, plain_ms, n_bytes) = check_shard_op(kern.name, with_dts, fields, single,
                                                       names, n_fields, P, extra=(dts,))
        blocks = [[t[..., jy * P : jy * P + P + 2 * H, :].contiguous() for t in (
            torch.nn.functional.pad(f, (0, 0, H, P * SHARDS - f.shape[-2] + H))
            for f in fields)] for jy in range(SHARDS)]
        outs = [op.kernel(jy * P - H, dts, *b) for jy, b in enumerate(blocks)]
        for k in (-2, -1):
            got = max(float(o[k]) for o in outs)
            if got != float(single[k]):
                raise AssertionError(f"{kern.name} {names[k]}: max over the shards {got!r} "
                                     f"!= the whole field's {float(single[k])!r}")
        for jy in (0, 1, SHARDS - 2):
            b = [t.clone() for t in blocks[jy]]
            for t in b[:2]:
                t[:, :H] = 1e3
                t[:, H + P :] = -1e3
            got = op.kernel(jy * P - H, dts, *b)
            if float(got[-2]) != float(outs[jy][-2]) or float(got[-1]) != float(outs[jy][-1]):
                raise AssertionError(f"{kern.name} shard {jy}: poisoned halo rows moved the "
                                     f"Courant maxima to {float(got[-2])}, {float(got[-1])}")
        rb1 = blocks[1]
        fixed_ms = median_ms(lambda: fixed_op.kernel(P - H, *rb1))
        log(f"  {kern.name}: max|u|, max|v| over the shards = the whole field's "
            f"({float(single[-2]):.6e}, {float(single[-1]):.6e}); halo rows at +-1e3 leave "
            "them unmoved")
        cells = 2 * (P + 2 * H) * g.nx  # the block's logical cells
        results[kern.name] = dict(err=max(errs), ms=ms, plain_ms=plain_ms, fixed_ms=fixed_ms,
                                  fixed=fixed.name, **bound(n_bytes, cells * per_cell))
    return results


def adaptive_sharded_phases(card: str, dev) -> tuple[dict, dict]:
    """Phases 41-43: the four shard-adaptive carries against their twins, the
    sharded lagged runs at full width against the single-device lagged runs,
    card against CPU. Returns the kernels' checks and the 300-step runs'
    launches."""
    from cfd_tpu_torch.adaptive import run_adaptive
    from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                     make_channel_case, make_rayleigh_benard_case)
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.parallel import make_mesh
    from cfd_tpu_torch.solver import Simulation

    f32 = dict(dtype=torch.float32, device=dev)
    # flow: (case maker, its per-kernel overrides, the sharded kwargs, p's
    # band over 3 steps, the single-device adaptive carry, the shard one)
    flows = {
        "cavity": (lambda **kw: make_cavity_case(
            n_interior=N_MAIN, poisson="multigrid", tolerance_factor=1e-6, **f32, **kw),
            dict(fuse_pre=False, mg_overrides={"whole_solve": False}), {"tol_factor": 1e-6},
            2e-5, Q.CARRY_ADAPTIVE, Q.SHARD_CARRY_ADAPTIVE),
        "channel": (lambda **kw: make_channel_case(
            nx=CHANNEL[0], ny=CHANNEL[1], poisson="multigrid", tolerance_factor=1e-6,
            abs_tol=0.0, **f32, **kw), dict(mg_overrides={"whole_solve": False}),
            {"tol_factor": 1e-6}, 5e-4, Q.CHANNEL_CARRY_ADAPTIVE,
            Q.SHARD_CHANNEL_CARRY_ADAPTIVE),
        "rb": (lambda **kw: make_rayleigh_benard_case(
            nx=RB_SHAPE[0], ny=RB_SHAPE[1], rayleigh=1e6, **f32, **kw),
            dict(mg_overrides={"whole_solve": False}),
            {"tol_factor": 1e-7, "mg_overrides": {"abs_tol": 1e-10}}, 2e-5,
            RQ.RB_CARRY_ADAPTIVE, RQ.SHARD_RB_CARRY_ADAPTIVE),
        "step": (lambda print_interval=100, **kw: make_backwards_step_case(
            nx=STEP[0], ny=STEP[1], poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0,
            print_interval=print_interval, save_interval=print_interval, **f32, **kw),
            dict(mg_overrides={"whole_solve": False, "pre_sweeps": 1, "post_sweeps": 1}),
            {"tol_factor": 1e-6}, 5e-4, SQ.STEP_CARRY_ADAPTIVE, SQ.SHARD_STEP_CARRY_ADAPTIVE)}

    log(f"phase 41: the shard-adaptive carries (rows 16a+, 16d+, 16e+, 16f+) at the full "
        f"widths' {SHARDS}-shard blocks vs their plain twins and the single-device adaptive "
        f"carries, dt_corr = 0.8 dt, dt_pred = 1.1 dt ({card})")
    checks = check_adaptive_shard_kernels(
        {flow: make(**pk) for flow, (make, pk, *_) in flows.items()}, dev)
    for k, r in checks.items():
        log(f"  {k:48s} kernel {r['ms']:.4f} ms  fixed-dt {r['fixed']} {r['fixed_ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"one local block  ({card})")

    ad = dict(max_courant=MAX_CO, growth=GROWTH, controller="lagged")
    n, spc = ADAPTIVE_RUN
    log(f"phase 42: the sharded lagged runs at full width on {SHARDS} shards of the card, "
        f"max_courant {MAX_CO}, growth {GROWTH}, {n} steps in chunks of {spc}, beside the "
        f"single-device lagged per-kernel runs ({card})")
    launches = {}
    for flow, (make, pk, kw, p_band, single_kern, shard_kern) in flows.items():
        what = f"sharded {flow} lagged, {SHARDS} shards"
        got, r = run_adaptive_path(make(), n, spc, "lagged", (shard_kern,), what, card,
                                   shards=SHARDS, sharded_kwargs=kw, absent=(single_kern,))
        sim, st = r["sim"], r["state"]
        if got[shard_kern.name] != SHARDS * n:
            raise AssertionError(f"{what}: {got[shard_kern.name]} launches of "
                                 f"{shard_kern.name} for {n} steps")
        launches[shard_kern.name] = got[shard_kern.name]
        log(f"  {what}: {sum(got.values()) / n:.2f} port kernel launches/step, "
            f"{got[shard_kern.name] / n:.2f} of {shard_kern.name}")
        ref_case = make(**pk)
        if flow != "cavity":
            ref_case = shard_order_case(ref_case, sim._engine)
        ref = Simulation(ref_case, log=lambda m: None)
        t0 = time.perf_counter()
        ref_st, _ = run_adaptive(ref, n_steps=n, steps_per_call=spc, **ad)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        label = "summed in shard order" if flow != "cavity" else "per-kernel"
        if sim.step_dts != ref.step_dts:
            raise AssertionError(f"{what}: the dt sequence differs from the single-device "
                                 f"lagged run {label}")
        hold_sharded(f"{what}, {n} steps vs the single-device lagged run {label} (dt equal "
                     f"on every step)", sim.step_iters, st, ref.step_iters, ref_st, None)
        del ref, ref_st, ref_case
        if flow == "cavity":
            plain_iters, plain_st = None, None
        else:
            plain = Simulation(make(**pk), log=lambda m: None)
            plain_st, _ = run_adaptive(plain, n_steps=n, steps_per_call=spc, **ad)
            plain_iters, plain_dts = plain.step_iters, plain.step_dts
            del plain
        three = {}
        for where, mesh, case_kw in (("sharded", make_mesh(SHARDS), {}), ("plain", None, pk)):
            s3 = Simulation(make(print_interval=1, **case_kw), log=lambda m: None, mesh=mesh,
                            sharded_kwargs=kw if mesh else None)
            st3, rows3 = run_adaptive(s3, n_steps=3, steps_per_call=1, **ad)
            three[where] = (s3, st3, rows3)
        (s3, st3, rows3), (p3, pst3, prows3) = three["sharded"], three["plain"]
        co, p_co = [x["courant"] for x in rows3], [x["courant"] for x in prows3]
        # the reference test's bands (tests/test_adaptive_sharded.py:21-35)
        if not (all(abs(a - b) <= 1e-5 * b for a, b in zip(s3.step_dts, p3.step_dts,
                                                             strict=True))
                and all(abs(a - b) <= 1e-4 * b + 1e-7 for a, b in zip(co, p_co, strict=True))):
            raise AssertionError(f"{what}: dt {s3.step_dts}, Co {co} over 3 steps against "
                                 f"{p3.step_dts}, {p_co}")
        hold_sharded(f"{what}, 3 steps vs the plain single-device lagged run (dt "
                     f"{s3.step_dts} against {p3.step_dts}, Co {co} against {p_co})",
                     s3.step_iters, st3, p3.step_iters, pst3, p_band)
        del three, s3, st3, p3, pst3
        if plain_st is not None:
            drift(f"{what}, {n} steps vs the plain single-device lagged run", sim.step_iters,
                  st, plain_iters, plain_st)
            log(f"  {what}: final dt {sim.step_dts[-1]!r} against the plain run's "
                f"{plain_dts[-1]!r}")
        log(f"  {what}: {r['steps_s']:.2f} steps/s, {r['cycles']:.2f} V-cycles/step over the "
            f"last 100, final dt {r['dt']:.6e} ({r['ratio']:.4f} x the case's), t = "
            f"{r['t']:.6f}; the single-device lagged run took {ref_wall:.2f} s for {n} steps "
            f"({card})")
        del sim, st, r, plain_st
        case = make(print_interval=20, **pk)
        dsim = Simulation(case, log=lambda m: None, mesh=make_mesh(1))
        for kern in KERNELS:
            kern.launches = 0
        run_adaptive(dsim, n_steps=20, steps_per_call=1, **ad)
        torch.cuda.synchronize()
        if (not dsim._engine.delegated or not single_kern.launches or shard_kern.launches):
            raise AssertionError(f"1-shard mesh, {flow}: delegated={dsim._engine.delegated}, "
                                 f"{single_kern.name} {single_kern.launches}, "
                                 f"{shard_kern.name} {shard_kern.launches}")
        log(f"  1-shard mesh, {flow}: delegated; over 20 adaptive steps {single_kern.name} "
            f"{single_kern.launches}, {shard_kern.name} 0")
        del case, dsim

    log(f"phase 43: the sharded lagged runs card vs CPU, 20 steps on {SHARDS} shards")
    small = {"cavity": (make_cavity_case, dict(n_interior=256, poisson="multigrid",
                                               tolerance_factor=1e-6), "cavity 256^2"),
             "channel": (make_channel_case, dict(nx=256, ny=128, poisson="multigrid",
                                                 tolerance_factor=1e-6, abs_tol=0.0),
                         "channel 256x128"),
             "rb": (make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e6),
                    "rb 256x128"),
             "step": (make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid",
                                                     tolerance_factor=1e-6, abs_tol=0.0),
                      "step 512x64")}
    for flow, (make, kw, what) in small.items():
        adaptive_card_vs_cpu(make, dict(kw, dtype=torch.float32, print_interval=20), "lagged",
                             10, f"sharded {what} lagged on {SHARDS} shards", shards=SHARDS,
                             sharded_kwargs=flows[flow][2])
    return checks, launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check "
                         "needs a CUDA GPU")
    import_port()
    from cfd_tpu_torch.cases import make_cavity_case, make_channel_case
    from cfd_tpu_torch.kernels import KERNELS, _build
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_smoother as RB
    from cfd_tpu_torch.kernels import whole_solve as WS
    from cfd_tpu_torch.kernels import mg_tail as MT
    from cfd_tpu_torch.kernels import whole_step as WST
    from cfd_tpu_torch.seeded import seeded_source

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"phase 1: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    path, build_s = _build.build()
    _build.library()
    log(f"  built {path.relative_to(ROOT)} in {build_s:.1f} s")
    ptxas = path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(ptxas):
        for kname in ("whole_solve_kernel", "whole_step_kernel", "mg_tail_kernel",
                      "fused_pre_kernel", "step_pre_kernel", "step_post_kernel",
                      "sep_pre_kernel", "sep_post_kernel"):
            if "Compiling entry function" in line and kname in line:
                for info in ptxas[i + 1 : i + 4]:
                    if "Function properties" not in info:
                        log(f"  {kname} ptxas: {info.strip()}")
    from cfd_tpu_torch.kernels import plan as PL

    most = PL.Plan(1, 0, 0, 0, 0, PL.SMEM_MAX, 0, PL.BLOCK_THREADS, 0)
    for masked in (False, True):
        grid = WS.launch_grid(masked, most)
        log(f"  whole_solve_kernel<{'masked' if masked else 'separable'}>: "
            f"{grid['registers']} registers/thread; {grid['blocks']} blocks of "
            f"{PL.BLOCK_THREADS} threads ({grid['blocks_per_sm']} per SM) at the most shared "
            f"memory a plan may ask, {PL.SMEM_MAX} B; each flavor's plan in phases 2, 5, 8, 11")
    for flavor, fname in ((WST.CAVITY, "cavity"), (WST.CHANNEL, "channel"),
                          (WST.RB, "rb"), (WST.STEP, "step")):
        grid = WST.launch_grid(flavor, most)
        log(f"  whole_step_kernel<{fname}>: {grid['registers']} registers/thread, "
            f"cooperative grid of {grid['blocks']} blocks ({grid['blocks_per_sm']} "
            f"co-resident per SM) at {PL.SMEM_MAX} B")
    fp_plan = PL.fused_pre_plan(Q.quad_shape((N_MAIN + 2, N_MAIN + 2)), 2)
    grid = PL.ready_grid(fp_plan, dev, "cfd_quad_fused_pre_grid")
    log(f"  fused_pre_kernel: {grid['registers']} registers/thread, cooperative grid of "
        f"{grid['blocks']} blocks ({grid['blocks_per_sm']} co-resident per SM) at the "
        f"{N_MAIN}^2 cavity's plan: {fp_plan.smem_bytes} B, the carry's "
        f"{fp_plan.carry.rows}x{fp_plan.carry.cols} tiles then the pre's "
        f"{fp_plan.pre.rows}x{fp_plan.pre.cols}, {PL.FUSED_PRE_BARRIERS} grid barrier")

    log(f"phase 2: kernels vs plain twins at {N_MAIN}^2 shapes ({card})")
    cav_main = dict(n_interior=N_MAIN, poisson="multigrid", dtype=torch.float32,
                    tolerance_factor=1e-6)
    # the per-kernel cavity, explicitly: the card's default is the whole-solve
    pk_case = make_cavity_case(device=dev, mg_overrides={"whole_solve": False}, **cav_main)
    mg = pk_case.info["mg"]
    log(f"  per-kernel solver config: V({mg.pre_sweeps},{mg.post_sweeps}) coarse_dtype="
        f"{mg.coarse_dtype} levels={len(pk_case.poisson_solve.levels)}")
    checks = check_kernels(pk_case, dev)
    flows = {"cavity": (pk_case.grid, pk_case.coeffs, None)}  # phase 14's shapes
    # the cavity's cuda default, the f32 whole-solve: its plan here, its
    # kernel against its twin in phase 5
    cav_ws_case = make_cavity_case(device=dev, **cav_main)
    log_plan("quad_whole_solve (cavity)", cav_ws_case.poisson_solve, card)

    log(f"phase 3: the cavity at {N_MAIN}^2, its cuda default (the whole-solve) for 300 "
        f"steps in chunks of 100, then the per-kernel solve for 100 steps ({card})")
    case = make_cavity_case(device=dev, **cav_main)
    mg = case.info["mg"]
    log(f"  default solver config: whole_solve={mg.whole_solve} coarse_dtype="
        f"{mg.coarse_dtype}")
    rate = ("cell-updates/s", lambda c: N_MAIN * N_MAIN * (5 + 16 / 3 * c))
    cavity_launches, state, whole = run_path(
        case, 300, (Q.CARRY, Q.CORRECTOR, WS.WHOLE_SOLVE), "cavity whole-solve", card, rate)
    composed = {"cavity": (whole["iters"], state)}  # phase 18 holds the whole step to them
    f32_cycles = {"cavity": whole["cycles"]}  # phase 22 prints the bf16 runs' beside them
    quad_whole = {"cavity": whole}  # phase 26 prints the natural runs beside them
    del case
    pk_launches, pk_state, per_kernel = run_path(
        pk_case, 100, (Q.CARRY, Q.PRE, Q.POST, RB.RB_PAIRS), "cavity per-kernel", card, rate,
        state=state, start_step=300)
    twin_level0_run(pk_case, "cavity", state, 300, per_kernel["iters"], pk_state)
    # phase 21 runs the tail from the same state
    pk_ref = {"cavity": (state, per_kernel["iters"], pk_state, per_kernel)}
    cavity_launches.update({k.name: pk_launches[k.name] for k in (Q.PRE, Q.POST, RB.RB_PAIRS)})
    log(f"  cavity A/B, steps/s: whole-solve {whole['steps_s']:.2f} ({whole['cycles']:.2f} "
        f"V-cycles/step), per-kernel {per_kernel['steps_s']:.2f} "
        f"({per_kernel['cycles']:.2f}); reference parity target 1.0 V-cycles/step  ({card})")
    del pk_case

    log("phase 4: cavity card vs CPU at 256^2, 20 steps")
    for coarse in (None, "float32", "bfloat16"):
        card_vs_cpu(make_cavity_case, dict(n_interior=256, poisson="multigrid",
                                           dtype=torch.float32, tolerance_factor=1e-6,
                                           print_interval=20,
                                           mg_overrides=coarse and {"coarse_dtype": coarse}),
                    f"cavity 256^2 {coarse or 'default'}")

    nx, ny = CHANNEL
    ch_kw = dict(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0,
                 dtype=torch.float32)
    log(f"phase 5: kernels vs plain twins at the {nx}x{ny} channel shapes ({card})")
    case = make_channel_case(device=dev, **ch_kw)
    mg = case.info["mg"]
    log(f"  solver config: V({mg.pre_sweeps},{mg.post_sweeps}) whole_solve="
        f"{mg.whole_solve} levels={len(case.poisson_solve.mg.levels)}")
    checks.update(check_channel_kernels(case, dev))
    solve_mg = case.poisson_solve.mg
    check_level0_pair("channel", solve_mg.pre0, solve_mg.post0, case.grid, dev, 1537)
    flows["channel"] = (case.grid, case.coeffs, None)
    for k, r in checks.items():
        log(f"  {k:36s} kernel {r['ms']:.4f} ms{dev_note(r)}  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
    w = checks["quad_whole_solve"]
    log(f"  quad_whole_solve: {w['cycles']} V-cycles, {w['ms_per_cycle']:.4f} ms per "
        f"V-cycle; bound {w['bound_bytes_ms']:.4f} ms per solve (bytes), "
        f"{w['bound_ops_ms_per_cycle']:.4f} ms per V-cycle (operations)  ({card})")
    log_plan("quad_whole_solve (channel)", case.poisson_solve, card, w["ms_per_cycle"])
    cav_ws = check_cavity_whole_solve(cav_ws_case, dev)
    log(f"  quad_whole_solve (cavity {N_MAIN}^2, f32): kernel {cav_ws['ms']:.4f} ms for "
        f"{cav_ws['cycles']} V-cycles, plain {cav_ws['plain_ms']:.4f} ms, bound "
        f"{cav_ws['bound_ms']:.4f} ms ({cav_ws['bound_by']}), "
        f"{cav_ws['bound_ops_ms_per_cycle']:.4f} ms per V-cycle (operations); launches "
        f"{cavity_launches[WS.WHOLE_SOLVE.name]} on phase 3's path  ({card})")
    log_plan("quad_whole_solve (cavity)", cav_ws_case.poisson_solve, card,
             cav_ws["ms_per_cycle"])
    del cav_ws_case

    log(f"phase 6: the channel slice at {nx}x{ny}, 300 steps in chunks of 100, then the "
        f"per-kernel solve and the whole-solve again for 100 steps each ({card})")
    cells = ("cell-steps/s", lambda c: nx * ny)
    channel_launches, state, whole = run_path(
        case, 300, (Q.CHANNEL_CARRY, Q.CHANNEL_CORRECTOR, WS.WHOLE_SOLVE),
        "channel whole-solve", card, cells)
    composed["channel"] = (whole["iters"], state)
    carried_channel = (whole["iters"], state)  # phase 30 holds the split channel to it
    f32_cycles["channel"] = whole["cycles"]
    quad_whole["channel"] = whole
    per_kernel_case = make_channel_case(device=dev, mg_overrides={"whole_solve": False},
                                        **ch_kw)
    start = state
    _, state, per_kernel = run_path(
        per_kernel_case, 100, (Q.CHANNEL_CARRY, Q.PRE, Q.POST, RB.RB_PAIRS),
        "channel per-kernel", card, cells, state=state, start_step=300)
    pk_ref["channel"] = (start, per_kernel["iters"], state, per_kernel)
    twin_level0_run(per_kernel_case, "channel", start, 300, per_kernel["iters"], state)
    del per_kernel_case
    _, _, whole_again = run_path(
        case, 100, (Q.CHANNEL_CARRY, WS.WHOLE_SOLVE), "channel whole-solve again", card,
        cells, state=state, start_step=400)
    log(f"  channel A/B, steps/s: whole-solve {whole['steps_s']:.2f} "
        f"({whole['cycles']:.2f} V-cycles/step), per-kernel {per_kernel['steps_s']:.2f} "
        f"({per_kernel['cycles']:.2f}), whole-solve again {whole_again['steps_s']:.2f} "
        f"({whole_again['cycles']:.2f}); reference parity target 2.1 V-cycles/step  "
        f"({card})")
    del case

    log("phase 7: channel card vs CPU at 256x128, 20 steps")
    for ov in (None, {"whole_solve": False}):
        card_vs_cpu(make_channel_case, dict(nx=256, ny=128, poisson="multigrid",
                                            dtype=torch.float32, tolerance_factor=1e-6,
                                            abs_tol=0.0, print_interval=20,
                                            mg_overrides=ov),
                    f"channel 256x128 {'per-kernel' if ov else 'default'}")

    from cfd_tpu_torch.cases import make_backwards_step_case
    from cfd_tpu_torch.kernels import step_quad as SQ

    nx, ny = STEP
    st_kw = dict(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0,
                 dtype=torch.float32, print_interval=100, save_interval=100)
    log(f"phase 8: kernels vs plain twins at the {nx}x{ny} backward-step shapes ({card})")
    case = make_backwards_step_case(device=dev, **st_kw)
    mg = case.info["mg"]
    g = case.grid
    log(f"  solver config: V({mg.pre_sweeps},{mg.post_sweeps}) whole_solve="
        f"{mg.whole_solve} coarse levels={len(case.poisson_solve.mg.levels)}; n_fluid="
        f"{g.n_fluid}")
    step_checks = check_step_kernels(case, dev)
    from cfd_tpu_torch.poisson.multigrid import step_rect_params

    flows["step"] = (g, case.coeffs, dict(rect=step_rect_params(g)))
    for k, r in step_checks.items():
        log(f"  {k:36s} kernel {r['ms']:.4f} ms{dev_note(r)}  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
    w = step_checks["quad_step_whole_solve"]
    log_plan("quad_step_whole_solve", case.poisson_solve, card, w["ms_per_cycle"])
    log(f"  quad_step_whole_solve: {w['cycles']} V-cycles, {w['ms_per_cycle']:.4f} ms per "
        f"V-cycle; bound {w['bound_bytes_ms']:.4f} ms per solve (bytes), "
        f"{w['bound_ops_ms_per_cycle']:.4f} ms per V-cycle (operations)  ({card})")
    checks.update(step_checks)

    step_fluid = g.n_fluid
    log(f"phase 9: the step slice at {nx}x{ny}, 300 steps in chunks of 100, then the "
        f"per-kernel solve for 100 steps ({card})")
    cells = ("cell-steps/s", lambda c: g.n_fluid)
    step_launches, state, whole = run_path(
        case, 300, (SQ.STEP_CARRY, SQ.STEP_CORRECTOR, WS.STEP_WHOLE_SOLVE),
        "step whole-solve", card, cells)
    composed["step"] = (whole["iters"], state)
    f32_cycles["step"] = whole["cycles"]
    quad_whole["step"] = whole
    del case
    per_kernel_case = make_backwards_step_case(device=dev, mg_overrides={"whole_solve": False},
                                               **st_kw)
    step_pk_launches, pk_state, per_kernel = run_path(
        per_kernel_case, 100, (SQ.STEP_CARRY, SQ.STEP_PRE, SQ.STEP_POST, RB.RB_PAIRS_FULL),
        "step per-kernel", card, cells, state=state, start_step=300)
    pk_ref["step"] = (state, per_kernel["iters"], pk_state, per_kernel)
    del per_kernel_case
    log(f"  step, steps/s: whole-solve {whole['steps_s']:.2f} ({whole['cycles']:.2f} "
        f"V-cycles/step), per-kernel {per_kernel['steps_s']:.2f} "
        f"({per_kernel['cycles']:.2f}); reference parity target 4.1 V-cycles/step  ({card})")

    log("phase 10: step card vs CPU at 512x64, 20 steps")
    for ov in (None, {"whole_solve": False}):
        card_vs_cpu(make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid",
                                                   dtype=torch.float32, tolerance_factor=1e-6,
                                                   abs_tol=0.0, print_interval=20,
                                                   mg_overrides=ov),
                    f"step 512x64 {'per-kernel' if ov else 'default'}")

    from cfd_tpu_torch.cases import make_rayleigh_benard_case
    from cfd_tpu_torch.kernels import rb_quad as RQ

    nx, ny = RB_SHAPE
    rb_kw = dict(nx=nx, ny=ny, rayleigh=1e6, dtype=torch.float32)
    log(f"phase 11: kernels vs plain twins at the {nx}x{ny} Rayleigh-Benard shapes ({card})")
    case = make_rayleigh_benard_case(device=dev, **rb_kw)
    mg = case.info["mg"]
    log(f"  solver config: V({mg.pre_sweeps},{mg.post_sweeps}) whole_solve={mg.whole_solve} "
        f"pin_mean={mg.pin_mean} tol_factor={mg.tol_factor} abs_tol={mg.abs_tol} "
        f"levels={len(case.poisson_solve.mg.levels)}")
    rb_checks = check_rb_kernels(case, dev)
    solve_mg = case.poisson_solve.mg
    check_level0_pair("rb", solve_mg.pre0, solve_mg.post0, case.grid, dev, 1538)
    flows["rb"] = (case.grid, case.coeffs, case.info)
    for k, r in rb_checks.items():
        log(f"  {k:36s} kernel {r['ms']:.4f} ms{dev_note(r)}  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
    w = rb_checks["quad_whole_solve_pin_mean"]
    log_plan("quad_whole_solve_pin_mean", case.poisson_solve, card, w["ms_per_cycle"])
    log(f"  quad_whole_solve_pin_mean: {w['cycles']} V-cycles, {w['ms_per_cycle']:.4f} ms "
        f"per V-cycle; bound {w['bound_bytes_ms']:.4f} ms per solve (bytes), "
        f"{w['bound_ops_ms_per_cycle']:.4f} ms per V-cycle (operations)  ({card})")
    checks.update(rb_checks)

    log(f"phase 12: the RB slice at {nx}x{ny}, Ra=1e6, 300 steps in chunks of 100, then "
        f"the per-kernel solve for 100 steps ({card})")
    cells = ("cell-steps/s", lambda c: nx * ny)
    rb_launches, state, whole = run_path(
        case, 300, (RQ.RB_CARRY, RQ.RB_CORRECTOR, WS.WHOLE_SOLVE_PIN_MEAN),
        "rb whole-solve", card, cells)
    composed["rb"] = (whole["iters"], state)
    f32_cycles["rb"] = whole["cycles"]
    del case
    per_kernel_case = make_rayleigh_benard_case(device=dev, mg_overrides={"whole_solve": False},
                                                **rb_kw)
    _, pk_state, per_kernel = run_path(
        per_kernel_case, 100, (RQ.RB_CARRY, Q.PRE, Q.POST, RB.RB_PAIRS), "rb per-kernel", card,
        cells, state=state, start_step=300)
    pk_ref["rb"] = (state, per_kernel["iters"], pk_state, per_kernel)
    twin_level0_run(per_kernel_case, "rb", state, 300, per_kernel["iters"], pk_state)
    del per_kernel_case
    for what, r in (("whole-solve", whole), ("per-kernel", per_kernel)):
        row = r["row"]
        log(f"  rb {what}, step {row['step']}: Nu bottom {row['nusselt_bottom']:.6f}, top "
            f"{row['nusselt_top']:.6f}, volume {row['nusselt_volume']:.6f}; T in "
            f"[{row['temperature_min']:.6f}, {row['temperature_max']:.6f}]")
    log(f"  rb, steps/s: whole-solve {whole['steps_s']:.2f} ({whole['cycles']:.2f} "
        f"V-cycles/step, {nx * ny * whole['steps_s']:.4e} cell-steps/s), per-kernel "
        f"{per_kernel['steps_s']:.2f} ({per_kernel['cycles']:.2f}, "
        f"{nx * ny * per_kernel['steps_s']:.4e}); reference parity target 2.1 "
        f"V-cycles/step  ({card})")
    if not whole["cycles"] <= 3.0:
        raise AssertionError(f"rb: {whole['cycles']:.2f} V-cycles/step over steps 201-300 "
                             "(limit 3.0)")

    log("phase 13: RB card vs CPU at 256x128, 20 steps")
    for ov in (None, {"whole_solve": False}):
        card_vs_cpu(make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e6,
                                                    dtype=torch.float32, print_interval=20,
                                                    mg_overrides=ov),
                    f"rb 256x128 {'per-kernel' if ov else 'default'}")

    log(f"phase 14: the adaptive-stepping kernel instances vs plain twins at the full "
        f"shapes, dt_corr = 0.8 dt, dt_pred = 1.1 dt ({card})")
    ad_checks = check_adaptive_kernels(flows, dev)
    for k, r in ad_checks.items():
        log(f"  {k:44s} kernel {r['ms']:.4f} ms{dev_note(r)}  fixed-dt {r['fixed_ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"({card})")
    checks.update(ad_checks)

    log(f"phase 15: adaptive runs at the full widths, max_courant {MAX_CO}, growth "
        f"{GROWTH}, from the case's own dt ({card})")
    ad_launches = {}
    cav_kw = dict(n_interior=N_MAIN, poisson="multigrid", dtype=torch.float32,
                  tolerance_factor=1e-6, device=dev)
    runs = [
        ("cavity exact", make_cavity_case, cav_kw, 200, 1, "exact",
         (Q.PREDICTOR_SOURCE, Q.CORRECTOR_TRACED, WS.WHOLE_SOLVE)),
        ("cavity lagged", make_cavity_case, cav_kw, 300, 100, "lagged",
         (Q.CARRY_ADAPTIVE, Q.CORRECTOR_TRACED, WS.WHOLE_SOLVE)),
        ("channel lagged", make_channel_case, dict(ch_kw, device=dev), 300, 100, "lagged",
         (Q.CHANNEL_CARRY_ADAPTIVE, Q.CHANNEL_CORRECTOR_TRACED, WS.WHOLE_SOLVE)),
        ("step lagged", make_backwards_step_case, dict(st_kw, device=dev), 300, 100, "lagged",
         (SQ.STEP_CARRY_ADAPTIVE, SQ.STEP_CORRECTOR_TRACED, WS.STEP_WHOLE_SOLVE)),
        ("rb lagged", make_rayleigh_benard_case, dict(rb_kw, device=dev), 300, 100, "lagged",
         (RQ.RB_CARRY_ADAPTIVE, RQ.RB_CORRECTOR_TRACED, WS.WHOLE_SOLVE_PIN_MEAN)),
    ]
    for what, make, kw, n, spc, ctl, path in runs:
        case = make(**kw)
        got, r = run_adaptive_path(case, n, spc, ctl, path, what, card)
        for k in path[:2]:
            ad_launches.setdefault(k.name, got[k.name])
        if what == "rb lagged":
            row = r["row"]
            log(f"  rb lagged at step 300: t = {r['t']:.6f} against the fixed dt's "
                f"{300 * case.dt:.6f} (phase 12); Nu bottom {row['nusselt_bottom']:.6f}, "
                f"top {row['nusselt_top']:.6f}, volume {row['nusselt_volume']:.6f}")
        del case

    log("phase 16: adaptive card vs CPU, 20 steps")
    # the card's cavity default, the bf16 coarse hierarchy, pinned on the CPU too
    cav_small = dict(n_interior=256, poisson="multigrid", dtype=torch.float32,
                     tolerance_factor=1e-6, print_interval=20,
                     mg_overrides={"coarse_dtype": "bfloat16"})
    small = [
        (make_cavity_case, cav_small, "exact", 1, "cavity 256^2 exact"),
        (make_cavity_case, cav_small, "exact", 10, "cavity 256^2 exact chunked"),
        (make_cavity_case, cav_small, "lagged", 10, "cavity 256^2 lagged"),
        (make_channel_case, dict(nx=256, ny=128, poisson="multigrid", dtype=torch.float32,
                                 tolerance_factor=1e-6, abs_tol=0.0, print_interval=20),
         "lagged", 10, "channel 256x128 lagged"),
        (make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid",
                                        dtype=torch.float32, tolerance_factor=1e-6,
                                        abs_tol=0.0, print_interval=20), "lagged", 10,
         "step 512x64 lagged"),
        (make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e6, dtype=torch.float32,
                                         print_interval=20), "lagged", 10, "rb 256x128 lagged"),
    ]
    for make, kw, ctl, spc, what in small:
        adaptive_card_vs_cpu(make, kw, ctl, spc, what)

    ws_on = {"whole_step": True}
    full = {"cavity": (make_cavity_case, cav_main, WST.WHOLE_STEP_CAVITY,
                       rate),
            "channel": (make_channel_case, ch_kw, WST.WHOLE_STEP_CHANNEL,
                        ("cell-steps/s", lambda c: CHANNEL[0] * CHANNEL[1])),
            "step": (make_backwards_step_case, st_kw, WST.WHOLE_STEP_STEP,
                     ("cell-steps/s", lambda c, n=step_fluid: n)),
            "rb": (make_rayleigh_benard_case, rb_kw, WST.WHOLE_STEP_RB,
                   ("cell-steps/s", lambda c: RB_SHAPE[0] * RB_SHAPE[1]))}
    log(f"phase 17: the whole-step kernels vs plain twins at the full widths ({card})")
    ws_cases = {flow: make(device=dev, mg_overrides=ws_on, **kw)
                for flow, (make, kw, _, _) in full.items()}
    ws_checks = check_whole_steps(ws_cases)
    for k, r in ws_checks.items():
        log(f"  {k:36s} kernel {r['ms']:.4f} ms{dev_note(r)} ({r['cycles']} V-cycles)  plain "
            f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
            f"{r['bound_bytes_ms']:.4f} ms a step, operations {r['bound_ops_ms_per_cycle']:.4f}"
            f" ms a V-cycle)  ({card})")
    checks.update(ws_checks)

    log(f"phase 18: 300 steps of each flow with whole_step at the full widths in chunks of "
        f"100, against the composed runs of phases 3, 6, 9 and 12 ({card})")
    ws_launches = run_whole_steps(full, ws_cases, composed, card)

    log("phase 19: whole-step card vs CPU, 20 steps")
    for make, kw, what in (
            (make_cavity_case, dict(n_interior=256, poisson="multigrid",
                                    tolerance_factor=1e-6), "cavity 256^2"),
            (make_channel_case, dict(nx=256, ny=128, poisson="multigrid",
                                     tolerance_factor=1e-6, abs_tol=0.0), "channel 256x128"),
            (make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid",
                                            tolerance_factor=1e-6, abs_tol=0.0),
             "step 512x64"),
            (make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e6), "rb 256x128")):
        card_vs_cpu(make, dict(kw, dtype=torch.float32, print_interval=20,
                               mg_overrides=ws_on), f"{what} whole-step")


    tail_on = {"tail_from": 1}
    log(f"phase 20: the fused coarse tail vs its plain twin at the level-1 shapes of the "
        f"full widths ({card})")
    tail_cases = {flow: make(device=dev, mg_overrides=tail_on, **kw)
                  for flow, (make, kw, _, _) in full.items()}
    for seed, (flow, case) in enumerate(tail_cases.items()):
        tail = case.poisson_solve.tail
        r = check_tail(tail, flow, seed=2000 + seed)
        checks.setdefault(tail.record.name, r)  # the cavity's (mg_tail), the step's (full)
        log(f"  {tail.record.name} {flow}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} "
            f"ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
    deep = make_cavity_case(device=dev, mg_overrides={"tail_from": 3}, **cav_main)
    r = check_tail(deep.poisson_solve.tail, "cavity from level 3", seed=2010)
    log(f"  mg_tail cavity from level 3: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} "
        f"ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
    del deep

    log(f"phase 21: 100 steps of each flow with tail_from=1 from the per-kernel runs' start "
        f"states of phases 3, 6, 9 and 12 ({card})")
    tail_paths = {"cavity": (Q.CARRY, Q.PRE, Q.POST, MT.MG_TAIL),
                  "channel": (Q.CHANNEL_CARRY, Q.PRE, Q.POST, MT.MG_TAIL),
                  "step": (SQ.STEP_CARRY, SQ.STEP_PRE, SQ.STEP_POST, MT.MG_TAIL_FULL),
                  "rb": (RQ.RB_CARRY, Q.PRE, Q.POST, MT.MG_TAIL)}
    tail_launches = {}
    for flow, case in list(tail_cases.items()):
        ref = pk_ref.pop(flow)
        got, state, r = run_tail_path(case, f"{flow} tail_from=1", tail_paths[flow], ref,
                                      card, full[flow][3],
                                      cycle_slack=1 if flow == "channel" else 0)
        tail_launches.setdefault(tail_paths[flow][-1].name, got[tail_paths[flow][-1].name])
        if flow == "cavity":  # phase 29 holds the fused-pre tail run to it
            cavity_tail = (ref[0], r["iters"], state)
        del tail_cases[flow], case, state

    bf16 = "bfloat16"
    log(f"phase 22: the bf16 hierarchy's whole-solve and whole-step kernels vs their twins "
        f"at the full widths, then 300 steps of each flow on each ({card})")
    solve_paths = {"cavity": (Q.CARRY, Q.CORRECTOR), "channel": (Q.CHANNEL_CARRY,
                                                                 Q.CHANNEL_CORRECTOR),
                   "step": (SQ.STEP_CARRY, SQ.STEP_CORRECTOR), "rb": (RQ.RB_CARRY,
                                                                      RQ.RB_CORRECTOR)}
    bf16_launches = {}
    for flow, (make, kw, _, flow_rate) in full.items():
        case = make(device=dev, mg_overrides={"whole_solve": True, "coarse_dtype": bf16}, **kw)
        solve = case.poisson_solve
        record = solve._fine()[5]
        r = check_solve(solve, seeded_source(case, seed=2200 + len(bf16_launches)),
                        case.grid.n_fluid)
        checks.setdefault(record.name, r)  # the cavity's for the separable kernel
        log(f"  {record.name} {flow}: kernel {r['ms']:.4f} ms ({r['cycles']} V-cycles, "
            f"{r['ms_per_cycle']:.4f} ms each)  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
        ws_case = make(device=dev, mg_overrides={"whole_step": True, "coarse_dtype": bf16},
                       **kw)
        ws_record = ws_case.whole_step_kernel.record
        r = check_whole_steps({flow: ws_case})[ws_record.name]
        checks[ws_record.name] = r
        log(f"  {ws_record.name}: kernel {r['ms']:.4f} ms{dev_note(r)} ({r['cycles']} "
            f"V-cycles)  plain "
            f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
        got, state, whole = run_path(case, 300, (*solve_paths[flow], record),
                                     f"{flow} bf16 whole-solve", card, flow_rate)
        bf16_launches.setdefault(record.name, got[record.name])
        del case
        bf16_launches.update(run_whole_steps({flow: (make, kw, ws_record, flow_rate)},
                                             {flow: ws_case}, {flow: (whole["iters"], state)},
                                             card))
        log(f"  {flow}: {whole['cycles']:.2f} V-cycles/step over steps 201-300 with the bf16 "
            f"hierarchy, {f32_cycles[flow]:.2f} with the float32 one (phases 3, 6, 9, 12); "
            f"{whole['steps_s']:.2f} steps/s  ({card})")

    log(f"phase 23: the step with corr_opt on its three solves at {STEP[0]}x{STEP[1]} "
        f"({card})")
    corr = {"corr_opt": True}
    case = make_backwards_step_case(device=dev, mg_overrides=corr, **st_kw)
    solve = case.poisson_solve
    if not (case.info["mg"].whole_solve and solve.cfg.corr_opt):
        raise AssertionError("corr_opt took the step off its whole-solve on the card")
    r = check_solve(solve, seeded_source(case, seed=2300), step_fluid)
    checks[WS.STEP_WHOLE_SOLVE_CORR_OPT.name] = r
    log(f"  {WS.STEP_WHOLE_SOLVE_CORR_OPT.name}: kernel {r['ms']:.4f} ms ({r['cycles']} "
        f"V-cycles)  plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})  ({card})")
    both = make_backwards_step_case(device=dev, mg_overrides={**corr, "whole_solve": True,
                                                              "coarse_dtype": bf16}, **st_kw)
    check_solve(both.poisson_solve, seeded_source(both, seed=2301), step_fluid)
    del both
    ws_case = make_backwards_step_case(device=dev, mg_overrides={**corr, "whole_step": True},
                                       **st_kw)
    r = check_whole_steps({"step": ws_case})[WST.WHOLE_STEP_STEP_CORR_OPT.name]
    checks[WST.WHOLE_STEP_STEP_CORR_OPT.name] = r
    log(f"  {WST.WHOLE_STEP_STEP_CORR_OPT.name}: kernel {r['ms']:.4f} ms{dev_note(r)} "
        f"({r['cycles']} "
        f"V-cycles)  plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})  ({card})")
    step_rate = full["step"][3]
    got, state, whole = run_path(case, 300, (SQ.STEP_CARRY, SQ.STEP_CORRECTOR,
                                             WS.STEP_WHOLE_SOLVE_CORR_OPT),
                                 "step corr_opt whole-solve", card, step_rate)
    corr_launches = {WS.STEP_WHOLE_SOLVE_CORR_OPT.name: got[WS.STEP_WHOLE_SOLVE_CORR_OPT.name]}
    del case
    corr_launches.update(run_whole_steps(
        {"step": (make_backwards_step_case, st_kw, WST.WHOLE_STEP_STEP_CORR_OPT, step_rate)},
        {"step": ws_case}, {"step": (whole["iters"], state)}, card))
    pk_case = make_backwards_step_case(device=dev, mg_overrides={**corr, "whole_solve": False},
                                       **st_kw)
    _, _, pk = run_path(pk_case, 100, (SQ.STEP_CARRY, SQ.STEP_PRE, SQ.STEP_POST,
                                       RB.RB_PAIRS_FULL),
                        "step corr_opt per-kernel", card, step_rate, state=state,
                        start_step=300)
    del pk_case
    log(f"  step V-cycles/step over steps 201-300: corr_opt {whole['cycles']:.2f} "
        f"({whole['steps_s']:.2f} steps/s), without {f32_cycles['step']:.2f} (phase 9); "
        f"per-kernel with corr_opt {pk['cycles']:.2f} over steps 301-400 "
        f"({pk['steps_s']:.2f} steps/s)  ({card})")

    log("phase 24: card vs CPU for the new knobs, 5 steps")
    small = {"cavity": (make_cavity_case, dict(n_interior=256, poisson="multigrid",
                                               tolerance_factor=1e-6), "cavity 256^2"),
             "channel": (make_channel_case, dict(nx=256, ny=128, poisson="multigrid",
                                                 tolerance_factor=1e-6, abs_tol=0.0),
                         "channel 256x128"),
             "step": (make_backwards_step_case, dict(nx=512, ny=64, poisson="multigrid",
                                                     tolerance_factor=1e-6, abs_tol=0.0),
                      "step 512x64"),
             "rb": (make_rayleigh_benard_case, dict(nx=256, ny=128, rayleigh=1e6),
                    "rb 256x128")}
    knobs = [tail_on, {"whole_solve": True, "coarse_dtype": bf16},
             {"whole_step": True, "coarse_dtype": bf16}]
    for flow, (make, kw, what) in small.items():
        for ov in knobs + ([corr, {**corr, "whole_step": True},
                            {**corr, "whole_solve": False}] if flow == "step" else []):
            card_vs_cpu(make, dict(kw, dtype=torch.float32, print_interval=5,
                                   mg_overrides=ov), f"{what} {ov}", n_steps=5)

    from cfd_tpu_torch.kernels import projection as PJ
    from cfd_tpu_torch.kernels import step_smoother as SS
    from cfd_tpu_torch.poisson.multigrid import MultigridPoisson

    log(f"phase 25: the natural layout's kernels vs plain twins at the full-width shapes "
        f"({card})")
    nat_checks = check_natural_kernels(dev)
    for k, r in nat_checks.items():
        log(f"  {k:36s} kernel {r['ms']:.4f} ms{dev_note(r)}  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
    checks.update(nat_checks)

    log(f"phase 26: the natural slices at full width, counters zeroed before each run "
        f"({card})")
    snx, sny = NATURAL_STEP
    natural = (
        ("cavity aligned", make_cavity_case, dict(cav_main, layout="aligned"), 300,
         (PJ.PREDICTOR_SOURCE, PJ.CORRECTOR, RB.RB_PAIRS, RB.RB_PAIRS_RES), "cavity"),
        ("channel aligned", make_channel_case, dict(ch_kw, layout="aligned"), 300,
         (PJ.CHANNEL_PREDICTOR_SOURCE, PJ.CHANNEL_CORRECTOR, RB.RB_PAIRS, RB.RB_PAIRS_RES),
         "channel"),
        ("cavity auto 142^2", make_cavity_case, dict(cav_main, n_interior=142), 100,
         (PJ.PREDICTOR_SOURCE, PJ.CORRECTOR, RB.RB_PAIRS, RB.RB_PAIRS_RES), None),
        (f"step auto {snx}x{sny}", make_backwards_step_case, dict(st_kw, nx=snx, ny=sny), 100,
         (SS.STEP_PAIRS, SS.STEP_PAIRS_RES), None),
    )
    nat_launches = {}
    for what, make, kw, n_steps, path_kernels, quad in natural:
        t0 = time.perf_counter()
        case = make(device=dev, **kw)
        mg = case.info["mg"]
        solve = case.poisson_solve
        if case.carry_tentative:
            raise AssertionError(f"{what} did not take the natural layout")
        # the separable solve counts level 0 in its levels, the masked one not
        levels = len(solve.levels) + (0 if isinstance(solve, MultigridPoisson) else 1)
        log(f"  {what}: built in {time.perf_counter() - t0:.1f} s (the dense pinv on the "
            f"host); V({mg.pre_sweeps},{mg.post_sweeps}), {levels} levels")
        got, _, nat = run_path(case, n_steps, path_kernels, f"natural {what}", card,
                               ("cell-steps/s", lambda c, n=case.grid.n_fluid: n))
        for k in path_kernels:
            if k is not RB.RB_PAIRS:  # its count stays the per-kernel cavity's (phase 3)
                nat_launches.setdefault(k.name, got[k.name])
        if quad is not None:
            q = quad_whole[quad]
            log(f"  {what} against the quad whole-solve (phase {3 if quad == 'cavity' else 6}):"
                f" {nat['steps_s']:.2f} against {q['steps_s']:.2f} steps/s, "
                f"{nat['cycles']:.2f} against {q['cycles']:.2f} V-cycles/step  ({card})")
        del case, solve
    log(f"  the quad step whole-solve (phase 9, {STEP[0]}x{STEP[1]}): "
        f"{quad_whole['step']['steps_s']:.2f} steps/s, {quad_whole['step']['cycles']:.2f} "
        f"V-cycles/step  ({card})")

    log("phase 27: the natural layout card vs CPU, 20 steps")
    for make, kw, what in (
            (make_cavity_case, dict(n_interior=64, layout="aligned", poisson="multigrid",
                                    tolerance_factor=1e-6), "cavity aligned 64^2"),
            (make_cavity_case, dict(n_interior=46, poisson="multigrid",
                                    tolerance_factor=1e-6), "cavity auto 46^2"),
            (make_channel_case, dict(nx=128, ny=30, poisson="multigrid", tolerance_factor=1e-6,
                                     abs_tol=0.0), "channel auto 128x30"),
            (make_backwards_step_case, dict(nx=128, ny=14, poisson="multigrid",
                                            tolerance_factor=1e-6, abs_tol=0.0),
             "step auto 128x14")):
        card_vs_cpu(make, dict(kw, dtype=torch.float32, print_interval=20), what)
    masked_natural_solve_card_vs_cpu(512, 64)

    log(f"phase 28: the fused-pre carry (row 7) at {N_MAIN}^2 and the channel's non-carry "
        f"stage (row 8c) at {CHANNEL[0]}x{CHANNEL[1]} vs their plain twins ({card})")
    fp_checks = check_fused_pre_kernels(dev)
    r = fp_checks[Q.FUSED_PRE.name]
    log(f"  {Q.FUSED_PRE.name}: kernel {r['ms']:.4f} / {r['ms_again']:.4f} ms (device "
        f"{r['dev_ms']:.4f} / {r['dev_ms_again']:.4f} ms, {r['launches_a_call']} a call), the "
        f"composed carry -> pre kernels {r['composed_ms'][0]:.4f} / {r['composed_ms'][1]:.4f} "
        f"ms (device {r['composed_dev_ms'][0]:.4f} / {r['composed_dev_ms'][1]:.4f} ms) (in "
        f"turns), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})  ({card})")
    r = fp_checks[Q.CHANNEL_PREDICTOR_SOURCE.name]
    log(f"  {Q.CHANNEL_PREDICTOR_SOURCE.name}: kernel {r['ms']:.4f} ms{dev_note(r)}, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})  ({card})")
    checks.update(fp_checks)

    log(f"phase 29: the fused-pre path at {N_MAIN}^2 (fuse_pre=True, whole_solve=False), "
        f"300 steps from the initial state beside the per-kernel composition, then 100 "
        f"with tail_from=1 from phase 21's start state ({card})")
    fp_kw = dict(cav_main, fuse_pre=True)
    case = make_cavity_case(device=dev, mg_overrides={"whole_solve": False}, **cav_main)
    _, ref_state, ref = run_path(case, 300, (Q.CARRY, Q.PRE, Q.POST, RB.RB_PAIRS),
                                 "cavity per-kernel from the initial state", card, rate)
    del case
    case = make_cavity_case(device=dev, mg_overrides={"whole_solve": False}, **fp_kw)
    if not case.carry_fused_pre:
        raise AssertionError("fuse_pre did not take the fused-pre carry")
    got, state, fp = run_path(case, 300, (Q.FUSED_PRE, Q.POST, RB.RB_PAIRS),
                              "cavity fused-pre", card, rate)
    del case
    hold_run("fused-pre vs per-kernel, 300 steps", fp["iters"], state, ref["iters"],
             ref_state, exact=True)
    fp_launches = {Q.FUSED_PRE.name: got[Q.FUSED_PRE.name]}
    extra = sum(fp["iters"]) - 300
    if got[Q.FUSED_PRE.name] != 300 or got[Q.CARRY.name] or got[Q.PRE.name] != extra:
        raise AssertionError(f"fused-pre launches: {got[Q.FUSED_PRE.name]} fused, "
                             f"{got[Q.CARRY.name]} carry, {got[Q.PRE.name]} pre for {extra} "
                             "cycles after a first")
    log(f"  fused-pre: 1.00 fused launch a step, {got[Q.PRE.name] / 300:.2f} pre launches a "
        f"step ({extra} cycles after a first), {sum(got.values()) / 300:.2f} port launches a "
        f"step; last 100: {fp['steps_s']:.2f} steps/s at {fp['cycles']:.2f} V-cycles/step "
        f"against the per-kernel {ref['steps_s']:.2f} at {ref['cycles']:.2f}  ({card})")
    del state, ref_state
    start, tail_iters, tail_state = cavity_tail
    case = make_cavity_case(device=dev, mg_overrides={"tail_from": 1}, **fp_kw)
    got, state, fpt = run_path(case, 100, (Q.FUSED_PRE, Q.POST, MT.MG_TAIL),
                               "cavity fused-pre tail_from=1", card, rate, state=start,
                               start_step=300)
    del case
    hold_run("fused-pre with the tail vs phase 21's tail run, 100 steps", fpt["iters"], state,
             tail_iters, tail_state, exact=True)
    if got[MT.MG_TAIL.name] != sum(fpt["iters"]) or got[RB.RB_PAIRS.name]:
        raise AssertionError(f"fused-pre tail: {got[MT.MG_TAIL.name]} tail launches for "
                             f"{sum(fpt['iters'])} V-cycles, {got[RB.RB_PAIRS.name]} "
                             "coarse smoother launches")
    log(f"  fused-pre with the tail: {got[Q.FUSED_PRE.name] / 100:.2f} fused, "
        f"{got[Q.PRE.name] / 100:.2f} pre, {got[MT.MG_TAIL.name] / 100:.2f} tail launches a "
        f"step, {sum(got.values()) / 100:.2f} port launches a step; {fpt['steps_s']:.2f} "
        f"steps/s at {fpt['cycles']:.2f} V-cycles/step  ({card})")
    del state, start, tail_state, cavity_tail

    log(f"phase 30: the split channel path at {CHANNEL[0]}x{CHANNEL[1]}: the corrector, the "
        f"non-carry stage (row 8c), remove_mean_quad and the case's whole-solve, 300 steps "
        f"from the initial state beside phase 6's carried run ({card})")
    case = split_channel(make_channel_case(device=dev, **ch_kw))
    got, state, sp = run_path(case, 300, (Q.CHANNEL_CORRECTOR, Q.CHANNEL_PREDICTOR_SOURCE,
                                          WS.WHOLE_SOLVE), "channel split", card,
                              full["channel"][3])
    del case
    if got[Q.CHANNEL_CARRY.name] or got[Q.CHANNEL_PREDICTOR_SOURCE.name] != 300:
        raise AssertionError(f"split channel: {got[Q.CHANNEL_CARRY.name]} carry launches, "
                             f"{got[Q.CHANNEL_PREDICTOR_SOURCE.name]} row 8c launches")
    fp_launches[Q.CHANNEL_PREDICTOR_SOURCE.name] = got[Q.CHANNEL_PREDICTOR_SOURCE.name]
    ref_iters, ref_state = carried_channel
    hold_run("split vs carried channel, 300 steps", sp["iters"], state, ref_iters, ref_state,
             exact=False)
    log(f"  split channel: {sum(got.values()) / 300:.2f} port launches a step; last 100: "
        f"{sp['steps_s']:.2f} steps/s at {sp['cycles']:.2f} V-cycles/step against the "
        f"carried run's {quad_whole['channel']['steps_s']:.2f} at "
        f"{quad_whole['channel']['cycles']:.2f} (phase 6)  ({card})")
    del state, ref_state, carried_channel

    log("phase 31: the fused-pre cavity and the split channel card vs CPU, 20 steps")
    card_vs_cpu(make_cavity_case, dict(n_interior=256, poisson="multigrid",
                                       dtype=torch.float32, tolerance_factor=1e-6,
                                       print_interval=20, fuse_pre=True,
                                       mg_overrides={"whole_solve": False}),
                "cavity 256^2 fused-pre")
    card_vs_cpu(lambda device, **kw: split_channel(make_channel_case(device=device, **kw)),
                dict(nx=256, ny=128, poisson="multigrid", dtype=torch.float32,
                     tolerance_factor=1e-6, abs_tol=0.0, print_interval=20),
                "channel 256x128 split")

    sh_checks, shard_launches = sharded_phases(card, dev, cav_main)
    checks.update(sh_checks)
    fl_checks, flavor_launches = flavor_sharded_phases(card, dev)
    checks.update(fl_checks)
    st_checks, step_shard_launches = step_sharded_phases(card, dev)
    checks.update(st_checks)
    ad_checks, ad_shard_launches = adaptive_sharded_phases(card, dev)
    checks.update(ad_checks)

    launches = {**cavity_launches, **{k: channel_launches[k] for k in (
        Q.CHANNEL_CARRY.name, Q.CHANNEL_CORRECTOR.name, WS.WHOLE_SOLVE.name)},
        **{k: step_launches[k] for k in (SQ.STEP_CARRY.name, SQ.STEP_CORRECTOR.name,
                                          WS.STEP_WHOLE_SOLVE.name)},
        **{k: step_pk_launches[k] for k in (SQ.STEP_PRE.name, SQ.STEP_POST.name,
                                             RB.RB_PAIRS_FULL.name)},
        **{k: rb_launches[k] for k in (RQ.RB_CARRY.name, RQ.RB_CORRECTOR.name,
                                       WS.WHOLE_SOLVE_PIN_MEAN.name)},
        **ad_launches, **ws_launches, **tail_launches, **bf16_launches, **corr_launches,
        **nat_launches, **fp_launches,
        **{k.name: shard_launches[k.name] for k in (Q.SHARD_CARRY, Q.SHARD_PRE, Q.SHARD_POST)},
        **flavor_launches, **step_shard_launches, **ad_shard_launches}
    kernels = []
    for k in KERNELS:
        r = checks[k.name]
        kernels.append(dict(name=k.name, route="cuda", source=k.source,
                            replaces=k.replaces, launches=launches[k.name],
                            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=None,
                            **{k: r[k] for k in ("dev_ms", "launches_a_call") if k in r}))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - T0:.1f} s, the "
        f"build included")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
