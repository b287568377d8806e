"""Time the carries on the card: rows 1, 1+ (the cavity 2048^2), 8a, 8a+
(the channel 1536x512), 9a, 9a+ (the step 2048x256) and 10, 10+ (RB
1536x512), the fixed-dt carry of each case's step and its traced-dt +
Courant instance (dt_corr = 0.8 dt, dt_pred = 1.1 dt), on seeded inputs.

    python -m cfd_tpu_torch.time_carries TAG [--only 1,1+,10,10+] [--reps 50]

Prints one JSON line per carry, tagged with TAG: ``dev_ms``, the device
time of one call (cfd_tpu_torch.time_whole_solve.dev_ms: CUDA events
around ``--reps`` back-to-back calls after a warm-up, divided by the
count, with the card held busy while the host queues them, so the
wrappers' host time is not in it; ``host_ahead`` says whether the host
finished queueing first); ``ms``, the wrapper's time, is the median of 20 single calls
between CUDA events (chip_smoke.py's ``ms``); ``sum`` is a checksum of the
source b. The inputs are seeded (cfd_tpu_torch.seeded). Run from the root
of a checkout, it times that checkout's kernels, so two checkouts timed in
turns on one card (parent, change, change, parent) give an A/B. Every
field fits the 50 MB L2 but the cavity's (8 fields of 19 MB), so the
times of rows 8a, 9a and 10 are warm-cache. Needs a CUDA card; it raises
without one.
"""

from __future__ import annotations

import argparse
import json

import torch

from cfd_tpu_torch.time_whole_solve import FLOWS, dev_ms, make, median_ms

ROWS = {"1": ("cavity", False), "1+": ("cavity", True), "8a": ("channel", False),
        "8a+": ("channel", True), "9a": ("step", False), "9a+": ("step", True),
        "10": ("rb", False), "10+": ("rb", True)}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--only", default=",".join(ROWS))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_carries needs a CUDA card")
    rows = args.only.split(",")
    cases = {}
    for row in rows:
        flow, adaptive = ROWS[row]
        if flow not in cases:
            cases[flow] = make(flow, {})
        op, fargs = carry_of(flow, adaptive, cases[flow])
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
