"""Time the carries on the card: rows 1, 1+ (the cavity 2048^2), 8a, 8a+
(the channel 1536x512), 9a, 9a+ (the step 2048x256) and 10, 10+ (RB
1536x512), the fixed-dt carry of each case's step and its traced-dt +
Courant instance (dt_corr = 0.8 dt, dt_pred = 1.1 dt); row 16a, the
cavity carry on shard 1's local block of the 4-shard plane-row mesh (the
shard rows' block of time_level0); row 7, the
cavity's fused-pre carry (the carry with the first V-cycle's pre-smooth
and restriction, ``fuse_pre=True`` on the per-kernel solve) timed beside
the composed carry -> pre pair it replaces; the cavity's non-carry
predictor + source at 2048^2, row 6 (the quad layout's traced-dt
instance, the exact adaptive controller's first stage, at dt = 1.1 dt)
and row 11 (the natural layout's, ``layout="aligned"``); the channel's at
1536x512, row 8c (the quad layout's, split_channel's second stage) and
11-ch (row 11's channel instance, the natural layout's); and the
correctors at the main shapes: rows 2, 8b, 9b and 10c (RB's), each fixed
and traced-dt (``+``, dt = 0.8 dt), and row 11's 11-corr (the natural
cavity's) and 11-ch-corr (the natural channel's), on seeded inputs.

    python -m cfd_tpu_torch.time_carries TAG [--only 1,1+,6,7,8c,10,10+,11,11-ch,16a,2,8b+]
                                             [--reps 50] [--tiles 16x32,8x64]

Prints one JSON line per carry, tagged with TAG: ``dev_ms``, the device
time of one call (cfd_tpu_torch.time_whole_solve.dev_ms: CUDA events
around ``--reps`` back-to-back calls after a warm-up, divided by the
count, with the card held busy while the host queues them, so the
wrappers' host time is not in it; ``host_ahead`` says whether the host
finished queueing first); ``ms``, the wrapper's time, is the median of 20 single calls
between CUDA events (chip_smoke.py's ``ms``); ``sum`` is a checksum of the
source b. Row 7 adds ``composed_dev_ms`` and ``composed_ms``, the same for
the composed pair on the same inputs (the case's own pre kernel after the
fixed-dt carry), ``launches_a_call``, the device operations of one call
in a torch.profiler trace (profile_step.device_ops_a_call), and
``p1_sum``; ``--tiles`` times it under each carry tile given (plane rows
x columns), each on a fresh op given kernels/plan.py
fused_pre_plan(tile=), the card tests' hook: the sweep that chose
FUSED_PRE_TILE. Rows 6 and 11 print ``launches_a_call`` and ``max_b``
too; ``--tiles`` times them under each tile given (row 6: plane rows x
columns, kernels/plan.py carry_plan("cavity_predictor", tile=); row 11:
rows x columns of the aligned array, natural_predictor_plan(tile=)), each
on a fresh op: the sweeps that chose CARRY_TILES["cavity_predictor"] and
NATURAL_PREDICTOR_TILE. Rows 8c and 11-ch print ``launches_a_call``
(the tile launch and the sum's), ``sum`` and ``sum_b`` (the op's own sum
of b); ``--tiles`` times them the same way (row 8c:
carry_plan("channel_predictor", tile=); 11-ch:
natural_predictor_plan(tile=, channel=True)): the sweeps that chose
CARRY_TILES["channel_predictor"] and NATURAL_CHANNEL_PREDICTOR_TILE. The
correctors' lines print ``launches_a_call``, ``sum`` and ``sum_v``
(checksums of the corrected u and v); ``--tiles`` times rows 9b and 9b+
under each block given (plane rows x columns, kernels/plan.py
step_corrector_plan(block=)), each on a fresh op: the sweep that chose
STEP_CORRECTOR_BLOCK. The inputs are seeded
(cfd_tpu_torch.seeded). Run from the root of a checkout, it times that
checkout's kernels, so two checkouts timed in
turns on one card (parent, change, change, parent) give an A/B. Every
field fits the 50 MB L2 but the cavity's (8 fields of 19 MB; 5 of 19 MB
for row 6, of 17.9 MB for row 11; 7 for rows 2 and 11-corr), so the times
of rows 8a, 8b, 8c, 9a, 9b, 10, 10c and 11-ch are warm-cache. Needs a
CUDA card; it raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from cfd_tpu_torch.time_whole_solve import FLOWS, dev_ms, make, median_ms

ROWS = {"1": ("cavity", False), "1+": ("cavity", True), "8a": ("channel", False),
        "8a+": ("channel", True), "9a": ("step", False), "9a+": ("step", True),
        "10": ("rb", False), "10+": ("rb", True), "7": ("cavity", False),
        "6": ("cavity", True), "11": ("cavity", False), "16a": ("cavity", False)}
# the non-carry predictor + source rows: (flow, natural layout)
PREDICTORS = {"6": ("cavity", False), "11": ("cavity", True), "8c": ("channel", False),
              "11-ch": ("channel", True)}
# the correctors: (flow, natural layout, traced dt)
CORRECTORS = {"2": ("cavity", False, False), "2+": ("cavity", False, True),
              "8b": ("channel", False, False), "8b+": ("channel", False, True),
              "9b": ("step", False, False), "9b+": ("step", False, True),
              "10c": ("rb", False, False), "10c+": ("rb", False, True),
              "11-corr": ("cavity", True, False), "11-ch-corr": ("channel", True, False)}


def carry_of(flow: str, adaptive: bool, case):
    """(the carry op, its arguments) of ``flow``: the case's own carry, or
    its traced-dt + Courant instance with (dt_corr, dt_pred)."""
    from cfd_tpu_torch.seeded import seeded_fields

    fields = seeded_fields(case, 23)
    if not adaptive:
        return case.step_kernels[0], fields
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.kernels import step_quad as SQ

    g, c = case.grid, case.coeffs
    shape = g.shape
    if flow == "cavity":
        op = Q.make_quad_corr_predictor_source(shape, c, adaptive=True)
    elif flow == "channel":
        op = Q.make_quad_channel_corr_predictor_source(shape, c, adaptive=True)
    elif flow == "step":
        from cfd_tpu_torch.poisson.multigrid import step_rect_params

        op = SQ.make_quad_step_corr_predictor_source(shape, c, *step_rect_params(g),
                                                     adaptive=True)
    else:
        from cfd_tpu_torch.physics.boussinesq import RBParams

        op = RQ.make_quad_rb_step_kernel(shape, c, case.info["kappa"],
                                         RBParams(case.info["rayleigh"],
                                                  case.info["prandtl"]), adaptive=True)
    dts = torch.tensor([0.8 * c.dt, 1.1 * c.dt], dtype=torch.float32, device=case.device)
    return op, (dts, *fields)


def shard_carry_of(case):
    """Row 16a: (the cavity carry of shard 1's local block, its arguments:
    the block's row_base and the seeded fields' block)."""
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.seeded import seeded_fields
    from cfd_tpu_torch.time_level0 import SHARD, SHARDS, _block

    shape = case.grid.shape
    _, P, _ = Q.quad_shard_dims(shape, SHARDS)
    Hq8 = Q.quad_dims(shape)[2]
    op = Q.make_quad_corr_predictor_source(shape, case.coeffs, shard=(P, SHARDS))
    return op, (SHARD * P - Q.DEV_HALO, *(_block(t, P, Hq8) for t in seeded_fields(case, 23)))


def fused_pre_rows(tag: str, reps: int, tiles) -> None:
    """Row 7's lines: the fused-pre carry of the 2048^2 cavity on the
    per-kernel solve beside the composed carry -> pre pair, under the
    plan's tile or each of ``tiles``."""
    from cfd_tpu_torch import cases
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.profile_step import device_ops_a_call
    from cfd_tpu_torch.seeded import seeded_fields

    _, kw = FLOWS["cavity"]
    case = cases.make_cavity_case(device="cuda", dtype=torch.float32, fuse_pre=True,
                                  mg_overrides={"whole_solve": False}, **kw)
    fused = case.step_kernels[0]
    carry = Q.make_quad_corr_predictor_source(case.grid.shape, case.coeffs)
    fields = seeded_fields(case, 23)

    def composed():
        _, _, b, guess, _ = carry.kernel(*fields)
        return fused.pre.kernel(guess, b)

    comp = dict(composed_dev_ms=dev_ms(composed, reps)[0], composed_ms=median_ms(composed))
    for tile in tiles:
        op = fused
        if tile is not None:  # a fresh op under the tile's plan before its first launch
            from cfd_tpu_torch.kernels.plan import fused_pre_plan

            op = Q.QuadCorrPredictorSourceFusedPre(case.grid.shape, case.coeffs, fused.pre)
            try:
                op._tile_plan = fused_pre_plan(op.qshape, fused.pre.n_pairs, tile=tile)
            except ValueError as e:  # past shared memory: no such instance
                print(json.dumps(dict(tag=tag, row="7", tile=tile, error=str(e))), flush=True)
                continue
        call = lambda: op.kernel(*fields)
        out = call()
        d, ahead = dev_ms(call, reps)
        launched = device_ops_a_call(call)
        ready = getattr(op, "_ready", {}).get(str(out[0].device))
        print(json.dumps(dict(
            tag=tag, row="7", flow="cavity", shape=list(out[2].shape), dev_ms=d,
            host_ahead=ahead, ms=median_ms(call), **comp, launches_a_call=len(launched),
            ops=launched, sum=float(out[2].double().sum()), p1_sum=float(out[3].double().sum()),
            tile=tile, plan=dataclasses.asdict(ready[0]) if ready else None)), flush=True)


def predictor_case(flow: str, natural: bool):
    """The main shape's case of ``flow`` (the cavity or the channel), on the
    natural layout or the quad one."""
    from cfd_tpu_torch import cases

    name, kw = FLOWS[flow]
    return getattr(cases, name)(device="cuda", dtype=torch.float32,
                                **({"layout": "aligned"} if natural else {}), **kw)


def predictor_rows(tag: str, row: str, reps: int, tiles) -> None:
    """Row 6's, 11's, 8c's or 11-ch's lines: the non-carry predictor +
    source on the quad layout (the cavity's with a traced dt, 1.1 dt, phase
    14's instance; the channel's, phase 28's) or on the natural layout (the
    aligned case's own op), under the plan's tile or each of ``tiles``."""
    from cfd_tpu_torch.kernels import projection as P
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.profile_step import device_ops_a_call
    from cfd_tpu_torch.seeded import seeded_fields

    flow, natural = PREDICTORS[row]
    case = predictor_case(flow, natural)
    g, c = case.grid, case.coeffs
    u, v = seeded_fields(case, 23)[:2]
    args = (u, v)
    if flow == "channel" and natural:
        make = lambda: P.make_channel_predictor_source(g.shape, c, case.step_kernels[0].ghost)
    elif flow == "channel":
        make = lambda: Q.make_quad_channel_predictor_source(g.shape, c,
                                                            case.step_kernels[0].uin)
    elif natural:
        make = lambda: P.make_predictor_source(g.shape, c, case.step_kernels[0].ghost)
    else:
        make = lambda: Q.make_quad_predictor_source(g.shape, c)
        args = (torch.tensor(1.1 * c.dt, dtype=torch.float32, device="cuda"), u, v)
    for tile in tiles:
        op = make()
        if tile is not None:  # a fresh op under the tile's plan before its first launch
            from cfd_tpu_torch.kernels import plan as PL

            try:
                op._tile_plan = (
                    PL.natural_predictor_plan(op.shape, tile, channel=flow == "channel")
                    if natural else PL.carry_plan(f"{flow}_predictor", op.qshape, tile))
            except ValueError as e:  # past shared memory: no such instance
                print(json.dumps(dict(tag=tag, row=row, tile=tile, error=str(e))), flush=True)
                continue
        call = lambda: op.kernel(*args)
        out = call()
        d, ahead = dev_ms(call, reps)
        launched = device_ops_a_call(call)
        scalar = {"max_b" if flow == "cavity" else "sum_b": float(out[3])}
        print(json.dumps(dict(
            tag=tag, row=row, flow=flow, layout="natural" if natural else "quad",
            shape=list(out[2].shape), dev_ms=d, host_ahead=ahead, ms=median_ms(call),
            launches_a_call=len(launched), ops=launched, sum=float(out[2].double().sum()),
            **scalar, tile=tile,
            plan=dict(vars(op._tile_plan)) if getattr(op, "_tile_plan", None) else None)),
            flush=True)


def corrector_rows(tag: str, rows, reps: int, tiles=(None,)) -> None:
    """The correctors' lines (CORRECTORS): each flow's corrector at its main
    shape on the case's seeded fields, fixed or with a traced dt (dt_corr =
    0.8 dt), and the natural layout's two; the step's (rows 9b, 9b+) under
    its plan's block or each of ``tiles``, (plane rows, plane columns)."""
    from cfd_tpu_torch.kernels import projection as P
    from cfd_tpu_torch.kernels import quad as Q
    from cfd_tpu_torch.kernels import rb_quad as RQ
    from cfd_tpu_torch.kernels import step_quad as SQ
    from cfd_tpu_torch.poisson.multigrid import step_rect_params
    from cfd_tpu_torch.profile_step import device_ops_a_call
    from cfd_tpu_torch.seeded import seeded_fields

    cases = {}
    for row in rows:
        flow, natural, traced = CORRECTORS[row]
        if (flow, natural) not in cases:
            case = predictor_case(flow, natural) if natural else make(flow, {})
            cases[flow, natural] = case, seeded_fields(case, 23)
        case, fields = cases[flow, natural]
        g, c = case.grid, case.coeffs
        ghost = getattr(case.step_kernels[0], "ghost", None)
        if flow == "cavity":
            op = (P.make_corrector(g.shape, c, ghost) if natural else
                  Q.make_quad_corrector(g.shape, c, case.step_kernels[0].lid, traced_dt=traced))
        elif flow == "channel":
            op = (P.make_channel_corrector(g.shape, c, ghost) if natural else
                  Q.make_quad_channel_corrector(g.shape, c, case.step_kernels[0].uin,
                                                traced_dt=traced))
        elif flow == "step":
            make_op = lambda: SQ.make_quad_step_corrector(g.shape, c, *step_rect_params(g),
                                                          case.step_kernels[0].uin,
                                                          traced_dt=traced)
        else:
            op = RQ.make_quad_rb_corrector(g.shape, c, traced_dt=traced)
        args = fields[:3] if flow in ("step", "rb") else fields[:4]
        if traced:
            args = (torch.tensor(0.8 * c.dt, dtype=torch.float32, device="cuda"), *args)
        for tile in tiles if flow == "step" else (None,):
            if flow == "step":  # a fresh op under the tile's block before its first call
                op = make_op()
                if tile is not None:
                    from cfd_tpu_torch.kernels.plan import step_corrector_plan

                    op._tile_plan = step_corrector_plan(op.qshape, tile)
            call = lambda: op.kernel(*args)
            out = call()
            d, ahead = dev_ms(call, reps)
            launched = device_ops_a_call(call)
            plan = getattr(op, "_tile_plan", None)
            print(json.dumps(dict(
                tag=tag, row=row, flow=flow, layout="natural" if natural else "quad",
                shape=list(out[0].shape), dev_ms=d, host_ahead=ahead, ms=median_ms(call),
                launches_a_call=len(launched), ops=launched, sum=float(out[0].double().sum()),
                sum_v=float(out[1].double().sum()), tile=tile,
                plan=dataclasses.asdict(plan) if plan else None)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--only", default=",".join([*ROWS, "8c", "11-ch", *CORRECTORS]))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tiles", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_carries needs a CUDA card")
    rows = args.only.split(",")
    tiles = [None] if args.tiles is None else [
        tuple(int(x) for x in t.split("x")) for t in args.tiles.split(",")]
    cases = {}
    correctors = [row for row in rows if row in CORRECTORS]
    if correctors:
        corrector_rows(args.tag, correctors, args.reps, tiles)
    for row in rows:
        if row in CORRECTORS:
            continue
        if row == "7":
            fused_pre_rows(args.tag, args.reps, tiles)
            continue
        if row in PREDICTORS:
            predictor_rows(args.tag, row, args.reps, tiles)
            continue
        flow, adaptive = ROWS[row]
        if flow not in cases:
            cases[flow] = make(flow, {})
        op, fargs = (shard_carry_of(cases[flow]) if row == "16a" else
                     carry_of(flow, adaptive, cases[flow]))
        call = lambda: op.kernel(*fargs)
        out = call()
        b = out[2] if flow in ("cavity", "channel", "step") else out[3]
        d, ahead = dev_ms(call, args.reps)
        print(json.dumps(dict(tag=args.tag, row=row, flow=flow, shape=list(b.shape),
                              dev_ms=d, host_ahead=ahead, ms=median_ms(call),
                              sum=float(b.double().sum()),
                              plan=dict(vars(op._tile_plan)) if getattr(
                                  op, "_tile_plan", None) else None)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
