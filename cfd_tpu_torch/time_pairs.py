"""Time the coarse red/black smoother (kernels/rb_smoother.py RBPairs, rows
5, 5b and 5-wr) on the card at the main path's instances, on seeded
inputs: row 5, the cavity's level 1 of the 2048^2 per-kernel solve (1040 x
1152 in bfloat16, the pre-smooth: 2 pairs and the residual field; ``5-f32``
the float32 level, 1032 x 1152, ``5-post`` its 1-pair post-smooth, ``5-L4``
the float32 level 4, 136 x 256); row 5b, the step's full-2D level 1 of the
2048x256 per-kernel solve (136 x 1152: the 1-pair pre-smooth with the
residual field; ``5b-post`` the 2-pair post-smooth); row 5-wr, the
natural cavity's level 0 (2056 x 2176, 1 pair and max|r|); and the natural
step's exact masked pairs (kernels/step_smoother.py StepMaskedPairs) at
its level 0 of the 512x30 step (32 x 514, V(2,2)): row 12, the pre-smooth
with the residual field, row 12-res, the post-smooth with max|r|.

    python -m cfd_tpu_torch.time_pairs TAG [--only 5,5b,5-wr,12,12-res] [--reps 50]
                                           [--tiles 32x118,16x54,8,16]

Prints one JSON line per instance, tagged with TAG: ``dev_ms``, the device
time of one call (cfd_tpu_torch.time_whole_solve.dev_ms: CUDA events
around ``--reps`` back-to-back calls after a warm-up, the card held busy
while the host queues them; ``host_ahead`` says whether the host finished
queueing first); ``ms``, the wrapper's time, the median of 20 single calls
between CUDA events; ``launches_a_call``, the device operations (kernels,
memsets, copies) of one call in a torch.profiler trace
(profile_step.device_ops_a_call); ``sum``, a checksum of the outputs. The
ops come from the public factory (kernels.rb_smoother
rb_pairs_for_level), so a copy of this file times an older checkout's
kernels too: run from the root of each checkout in turns on one card
(parent, change, change, parent) for an A/B. ``--tiles`` times each
instance under each tile given (rows x columns, or rows alone for the
plan's width) in turn, each on a fresh
op given the plan of kernels/plan.py pairs_plan(tile=) (rows 12:
step_pairs_plan(tile=)), the card tests' hook: the sweep that chose the
plans' tiles (PAIRS_TILE_WIDTH, PAIRS_TILE_ROWS, PAIRS_MIN_TILES;
STEP_PAIRS_TILE_WIDTH, STEP_PAIRS_TILE_ROWS, STEP_PAIRS_MIN_TILES). Every
field fits the 50 MB L2, so the times are warm-cache. Needs a CUDA card; it raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cfd_tpu_torch.profile_step import device_ops_a_call
from cfd_tpu_torch.time_whole_solve import dev_ms, make, median_ms

ROWS = ("5", "5-f32", "5-post", "5-L4", "5b", "5b-post", "5-wr", "12", "12-res")


def instances(rows):
    """{row: (a function making a fresh op, its arguments)}: the seeded
    instances of ``rows`` (of ROWS); each flow's case is built only when
    one of its rows is asked for."""
    from cfd_tpu_torch import cases
    from cfd_tpu_torch.kernels.mg_tail import level_masks
    from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level
    from cfd_tpu_torch.poisson.multigrid import (_build_level, build_problems,
                                                 cavity_problem)

    rng = np.random.default_rng(41)

    def args(lv, active):
        p, b = (torch.from_numpy((rng.standard_normal(lv.shape) * s).astype(np.float32))
                .to(active.device) for s in (0.1, 1e2))
        return (p * active).to(lv.dtype), (b * active).to(lv.dtype)

    out = {}
    if {"5", "5-f32", "5-post", "5-L4"} & set(rows):
        cav = make("cavity", {"whole_solve": False})
        g, cfg = cav.grid, cav.poisson_solve.cfg
        probs = build_problems(cavity_problem(g.nx, g.ny, g.dx, g.dy), cfg)
        for row, k, dt, n, field in (("5", 1, torch.bfloat16, cfg.pre_sweeps, True),
                                     ("5-f32", 1, torch.float32, cfg.pre_sweeps, True),
                                     ("5-post", 1, torch.float32, cfg.post_sweeps, False),
                                     ("5-L4", 4, torch.float32, cfg.pre_sweeps, True)):
            lv = _build_level(probs[k], dt, "cuda")
            out[row] = (lambda lv=lv, n=n, field=field: rb_pairs_for_level(
                lv, cfg.omega, n, with_residual_field=field),
                args(lv, level_masks(lv, "cuda")[1]))
        del cav
    if {"5b", "5b-post"} & set(rows):
        mg = make("step", {"whole_solve": False}).poisson_solve
        lv = mg.levels[0]
        a = args(lv, level_masks(lv, "cuda")[1])
        out["5b"] = (lambda: rb_pairs_for_level(lv, mg.cfg.omega, mg.cfg.pre_sweeps,
                                                with_residual_field=True), a)
        out["5b-post"] = (lambda: rb_pairs_for_level(lv, mg.cfg.omega, mg.cfg.post_sweeps), a)
    if "5-wr" in rows:
        solve = cases.make_cavity_case(n_interior=2048, poisson="multigrid",
                                       dtype=torch.float32, tolerance_factor=1e-6,
                                       layout="aligned", device="cuda").poisson_solve
        lv0 = solve.levels[0]
        out["5-wr"] = (lambda: rb_pairs_for_level(lv0, solve.cfg.omega, solve.cfg.post_sweeps,
                                                  with_residual=True),
                       args(lv0, solve.interior0))
    if {"12", "12-res"} & set(rows):
        step = cases.make_backwards_step_case(nx=512, ny=30, poisson="multigrid",
                                              dtype=torch.float32, tolerance_factor=1e-6,
                                              abs_tol=0.0, device="cuda")
        solve = step.poisson_solve
        fluid = np.asarray(step.grid.cell_mask, np.float32)
        a = tuple(torch.from_numpy((rng.standard_normal(fluid.shape) * s * fluid)
                                   .astype(np.float32)).to("cuda") for s in (0.1, 1e2))
        out["12"] = (lambda: _fresh(solve.pre0), a)
        out["12-res"] = (lambda: _fresh(solve.post0), a)
    return out


def _fresh(op):
    """A fresh copy of a natural step's pairs op (its plan unset)."""
    from cfd_tpu_torch.kernels.step_smoother import make_step_masked_pairs

    return make_step_masked_pairs(op.shape, op.step_i, op.inlet_j_max, op.idx2, op.idy2,
                                  op.omega, op.n_pairs, with_residual=op.with_residual,
                                  with_residual_field=op.with_residual_field,
                                  device=op.fluid.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--only", default=",".join(ROWS))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tiles", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_pairs needs a CUDA card")
    rows = args.only.split(",")
    ops = instances(rows)
    # a tile "R" is R rows of the plan's width: PAIRS_TILE_WIDTH less twice the halo
    tiles = [None] if args.tiles is None else [
        tuple(int(x) for x in t.split("x")) for t in args.tiles.split(",")]
    for row in rows:
        make_op, fargs = ops[row]
        for tile in tiles:
            op = make_op()
            if tile is not None:  # the tile's plan before the op's first launch
                from cfd_tpu_torch.kernels import plan as PL

                residual = op.with_residual_field or op.with_residual
                natural = row.startswith("12")
                if len(tile) == 1:
                    tile = (tile[0], PL.STEP_PAIRS_TILE_WIDTH
                            - 2 * PL.step_pairs_halo(op.n_pairs, residual) if natural
                            else PL.PAIRS_TILE_WIDTH - 2 * (2 * op.n_pairs + int(residual)))
                try:
                    op._tile_plan = (
                        PL.step_pairs_plan(op.shape, op.n_pairs, residual, tile=tile)
                        if natural else
                        PL.pairs_plan(op.shape, op.n_pairs, residual, op.full, tile=tile))
                except ValueError as e:  # past shared memory: no such instance
                    print(json.dumps(dict(tag=args.tag, row=row, tile=tile, error=str(e))))
                    continue
            call = lambda: op.kernel(*fargs)
            out = call()
            out = out if isinstance(out, tuple) else (out,)
            launched = device_ops_a_call(call)
            d, ahead = dev_ms(call, args.reps)
            plan = getattr(op, "_tile_plan", None)
            print(json.dumps(dict(
                tag=args.tag, row=row, shape=list(op.shape),
                dtype=str(getattr(op, "dtype", torch.float32))[6:],
                n_pairs=op.n_pairs, dev_ms=d, host_ahead=ahead, ms=median_ms(call),
                launches_a_call=len(launched), ops=launched,
                sum=sum(float(t.double().sum()) for t in out),
                plan=dict(vars(plan)) if plan is not None else None)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
