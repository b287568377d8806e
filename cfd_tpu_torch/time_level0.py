"""Time the finest-level V-cycle kernels on the card, on seeded inputs:

* rows 3 and 4, the separable pre and post kernels on the 2048^2 cavity's
  whole field at V(2,1) (its per-kernel solve's), and ``3-ch``, ``4-ch``
  the same on the 1536x512 channel's at V(1,2); rows 16b and 16c, the
  cavity's at V(2,1) on shard 1's local block of the 4-shard plane-row
  mesh, and ``16b-ch``, ``16c-ch`` the channel's at V(1,2) on its shard 1
  (csrc/quad_vcycle.cu);
* rows 9c and 9d, the backward step's masked pre kernel at V(1, *) and
  post kernel at V(1,2) on the 2048x256 step's whole field (its per-kernel
  solve's), and their shard rows 16f-pre and 16f-post, both at V(1,1) on
  shard 1's local block of its 4-shard mesh (csrc/step_vcycle.cu).

    python -m cfd_tpu_torch.time_level0 TAG [--only 3,4,16b,16c,9c,9d,...]
                                            [--reps 50] [--tiles 8x32,16x32]

Prints one JSON line per instance, tagged with TAG: ``dev_ms``, the device
time of one call (cfd_tpu_torch.time_whole_solve.dev_ms: CUDA events
around ``--reps`` back-to-back calls after a warm-up, the card held busy
while the host queues them; ``host_ahead`` says whether the host finished
queueing first); ``ms``, the wrapper's time, the median of 20 single calls
between CUDA events; ``launches_a_call`` and ``ops``, the device
operations (kernels, memsets, copies) of one call in a torch.profiler
trace (profile_step.device_ops_a_call); ``sum``, a checksum of the
outputs. The ops come from the public factories (kernels.quad
make_quad_pre_smooth_restrict, make_quad_post_prolong_smooth,
kernels.step_quad make_quad_step_*), so a copy of this file times an older
checkout's kernels too: run from the root of each checkout in turns on one
card (parent, change, change, parent) for an A/B. ``--tiles`` times each
instance under each tile given (plane rows x columns) in turn, each on a
fresh op given the plan of kernels/plan.py level0_plan(tile=), the card
tests' hook: the sweep that chose LEVEL0_TILES and sep_level0_tile's
SEP_LEVEL0_ROWS and SEP_LEVEL0_WIDTH. The
2048^2 cavity's fields (19 MB each) overflow the 50 MB L2 together; every
other instance's fit it, so their times are warm-cache. Needs a CUDA card;
it raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cfd_tpu_torch.profile_step import device_ops_a_call
from cfd_tpu_torch.time_whole_solve import dev_ms, make, median_ms

ROWS = ("3", "4", "3-ch", "4-ch", "16b", "16c", "16b-ch", "16c-ch", "9c", "9d", "16f-pre",
        "16f-post")
POST_ROWS = ("4", "4-ch", "16c", "16c-ch", "9d", "16f-post")
SHARDS, SHARD = 4, 1  # the mesh and the timed shard (the step's corner row lies on it)


def _block(t, P: int, Hq8: int):
    """Shard SHARD's local block of a quad field or level-1 array."""
    from cfd_tpu_torch.kernels.quad import DEV_HALO as H

    Hq8s = P * SHARDS
    t = torch.nn.functional.pad(t, (0, 0, H, Hq8s - Hq8 + H))
    return t[..., SHARD * P : SHARD * P + P + 2 * H, :].contiguous()


def step_instances(case):
    """{row: (a function making a fresh op, its arguments)}: the step's
    four instances on seeded inputs."""
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
    _, P, W = Q.quad_shard_dims(shape, SHARDS)
    H, Hq8 = Q.DEV_HALO, Q.quad_dims(shape)[2]
    block = lambda t: _block(t, P, Hq8)
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


def sep_instances(case, problem, suffix: str):
    """{row: (a function making a fresh op, its arguments)}: the separable
    pre and post kernels of ``case`` (its per-kernel solve's V(pre, post))
    on its whole field and on shard SHARD's block, on seeded inputs; rows
    3, 4, 16b, 16c with ``suffix``."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.seeded import seeded_fields, seeded_source

    g, mg, dev = case.grid, case.info["mg"], case.device
    shape = g.shape
    p, b = seeded_fields(case, 23)[2], seeded_source(case, 29)
    _, _, Hq8, W = Q.quad_dims(shape)
    rng = np.random.default_rng(31)
    ec = torch.zeros(Hq8, W, device=dev)
    ec[1 : g.ny // 2 + 1, 1 : g.nx // 2 + 1] = torch.from_numpy(
        (rng.standard_normal((g.ny // 2, g.nx // 2)) * 0.1).astype(np.float32)).to(dev)
    _, P, _ = Q.quad_shard_dims(shape, SHARDS)
    block = lambda t: _block(t, P, Hq8)
    rb, shard, loc = SHARD * P - Q.DEV_HALO, (P, SHARDS), (P + 2 * Q.DEV_HALO, W)
    pre, post = Q.make_quad_pre_smooth_restrict, Q.make_quad_post_prolong_smooth
    args = (shape, problem, mg.omega)
    n_pre, n_post = mg.pre_sweeps, mg.post_sweeps
    return {
        "3" + suffix: (lambda: pre(*args, n_pre, (Hq8, W), device=dev), (p, b)),
        "4" + suffix: (lambda: post(*args, n_post, (Hq8, W), device=dev), (p, b, ec)),
        "16b" + suffix: (lambda: pre(*args, n_pre, loc, device=dev, shard=shard),
                         (rb, block(p), block(b))),
        "16c" + suffix: (lambda: post(*args, n_post, loc, device=dev, shard=shard),
                         (rb, block(p), block(b), block(ec))),
    }


def instances(rows):
    """{row: (a function making a fresh op, its arguments)} of the rows
    asked for, each flow's case built once."""
    from cfd_tpu_torch.poisson.multigrid import cavity_problem, channel_problem

    out = {}
    if any(r in ("3", "4", "16b", "16c") for r in rows):
        case = make("cavity", {"whole_solve": False})
        g = case.grid
        out.update(sep_instances(case, cavity_problem(g.nx, g.ny, g.dx, g.dy), ""))
    if any(r.endswith("-ch") for r in rows):
        case = make("channel", {"whole_solve": False})
        g = case.grid
        out.update(sep_instances(case, channel_problem(g.nx, g.ny, g.dx, g.dy), "-ch"))
    if any(r in ("9c", "9d", "16f-pre", "16f-post") for r in rows):
        # the per-kernel step at V(1,2): the single-device main path of rows 9c, 9d
        out.update(step_instances(make("step", {"whole_solve": False})))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--only", default=",".join(ROWS))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tiles", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_level0 needs a CUDA card")
    rows = args.only.split(",")
    ops = instances(rows)
    tiles = [None] if args.tiles is None else [
        tuple(int(x) for x in t.split("x")) for t in args.tiles.split(",")]
    for row in rows:
        make_op, fargs = ops[row]
        for tile in tiles:
            op = make_op()
            if tile is not None:  # the tile's plan before the op's first launch
                from cfd_tpu_torch.kernels.plan import level0_plan

                masked = row[0] == "9" or row.startswith("16f")
                op._tile_plan = level0_plan(op.qshape, op.n_pairs, row in POST_ROWS,
                                            block=row.startswith("16"), masked=masked,
                                            tile=tile)
            call = lambda: op.kernel(*fargs)
            out = call()
            launched = device_ops_a_call(call)
            d, ahead = dev_ms(call, args.reps)
            plan = getattr(op, "_tile_plan", None)
            print(json.dumps(dict(
                tag=args.tag, row=row, qshape=list(op.qshape), n_pairs=op.n_pairs,
                dev_ms=d, host_ahead=ahead, ms=median_ms(call), launches_a_call=len(launched),
                ops=launched, sum=sum(float(t.double().sum()) for t in out),
                plan=dict(vars(plan)) if plan is not None else None)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
