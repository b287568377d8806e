"""Time the backward step's finest-level V-cycle kernels on the card: rows
9c and 9d (the pre kernel at V(1, *) and the post kernel at V(1,2) on the
2048x256 step's whole field, the per-kernel solve's) and their shard rows
16f pre and 16f post (both at V(1,1) on shard 1's local block of the
4-shard plane-row mesh), on seeded inputs.

    python -m cfd_tpu_torch.time_level0 TAG [--only 9c,9d,16f-pre,16f-post]
                                            [--reps 50] [--tiles 8x32,16x32]

Prints one JSON line per instance, tagged with TAG: ``dev_ms``, the device
time of one call (cfd_tpu_torch.time_whole_solve.dev_ms: CUDA events
around ``--reps`` back-to-back calls after a warm-up, the card held busy
while the host queues them; ``host_ahead`` says whether the host finished
queueing first); ``ms``, the wrapper's time, the median of 20 single calls
between CUDA events; ``launches_a_call``, the device operations
(kernels, memsets, copies) of one call in a torch.profiler trace
(profile_step.device_ops_a_call); ``sum``, a checksum of the outputs.
The ops come
from the public factories (kernels.step_quad make_quad_step_*), so a
copy of this file times an older checkout's kernels too: run from the
root of each checkout in turns on one card (parent, change, change,
parent) for an A/B. ``--tiles`` times each instance under each tile given
(plane rows x columns) in turn, each on a fresh op given the plan of
kernels/plan.py level0_plan(tile=), the card tests' hook: the sweep that
chose LEVEL0_TILES. Every field fits the 50 MB L2, so the times are
warm-cache. Needs a CUDA card; it raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cfd_tpu_torch.profile_step import device_ops_a_call
from cfd_tpu_torch.time_whole_solve import dev_ms, make, median_ms

ROWS = ("9c", "9d", "16f-pre", "16f-post")
SHARDS, SHARD = 4, 1  # the mesh and the timed shard (the step's corner row lies on it)


def instances(case):
    """{row: (a function making a fresh op, its arguments)}: the four
    instances on seeded inputs."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.kernels.mg_tail import level_masks
    from cfd_tpu_torch.poisson.multigrid import step_rect_params
    from cfd_tpu_torch.seeded import seeded_fields, seeded_source

    g, mg, dev = case.grid, case.poisson_solve, case.device
    shape = g.shape
    step_i, inlet_j = step_rect_params(g)
    p, b = seeded_fields(case, 23)[2], seeded_source(case, 29)
    lv1 = mg.levels[0]
    rng = np.random.default_rng(31)
    ec = torch.from_numpy((rng.standard_normal(lv1.shape) * 0.1).astype(np.float32)).to(dev)
    ec = ec * level_masks(lv1, dev)[1]
    pre0, post0 = mg.pre0, mg.post0
    whole = (shape, step_i, inlet_j, pre0.idx2, pre0.idy2, pre0.omega)
    Hq8s, P, W = Q.quad_shard_dims(shape, SHARDS)
    H, Hq8 = Q.DEV_HALO, Q.quad_dims(shape)[2]

    def block(t):  # shard SHARD's local block of a quad field or level-1 array
        t = torch.nn.functional.pad(t, (0, 0, H, Hq8s - Hq8 + H))
        return t[..., SHARD * P : SHARD * P + P + 2 * H, :].contiguous()

    rb, shard, loc = SHARD * P - H, (P, SHARDS), (P + 2 * H, W)
    pre, post = SQ.make_quad_step_pre_smooth_restrict, SQ.make_quad_step_post_prolong_smooth
    return {
        "9c": (lambda: pre(*whole, pre0.n_pairs, pre0.coarse_shape, device=dev), (p, b)),
        "9d": (lambda: post(*whole, post0.n_pairs, post0.coarse_shape, device=dev),
               (p, b, ec)),
        "16f-pre": (lambda: pre(*whole, 1, loc, device=dev, shard=shard),
                    (rb, block(p), block(b))),
        "16f-post": (lambda: post(*whole, 1, loc, device=dev, shard=shard),
                     (rb, block(p), block(b), block(ec))),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--only", default=",".join(ROWS))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tiles", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_level0 needs a CUDA card")
    # the per-kernel step at V(1,2): the single-device main path of rows 9c, 9d
    case = make("step", {"whole_solve": False})
    ops = instances(case)
    tiles = [None] if args.tiles is None else [
        tuple(int(x) for x in t.split("x")) for t in args.tiles.split(",")]
    for row in args.only.split(","):
        make_op, fargs = ops[row]
        for tile in tiles:
            op = make_op()
            if tile is not None:  # the tile's plan before the op's first launch
                from cfd_tpu_torch.kernels.plan import level0_plan

                op._tile_plan = level0_plan(op.qshape, op.n_pairs, row in ("9d", "16f-post"),
                                            block=row.startswith("16f"), tile=tile)
            call = lambda: op.kernel(*fargs)
            out = call()
            launched = device_ops_a_call(call)
            d, ahead = dev_ms(call, args.reps)
            plan = getattr(op, "_tile_plan", None)
            print(json.dumps(dict(
                tag=args.tag, row=row, qshape=list(op.qshape), n_pairs=op.n_pairs,
                dev_ms=d, host_ahead=ahead, ms=median_ms(call), launches_a_call=len(launched),
                sum=sum(float(t.double().sum()) for t in out),
                plan=dict(vars(plan)) if plan is not None else None)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
