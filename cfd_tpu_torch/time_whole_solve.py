"""Time the whole-solve family on the card: the whole-solve of each flow at
its main width (the cavity 2048^2 in float32 and with the bf16 hierarchy,
the channel 1536x512, the step 2048x256 with and without corr_opt and the
bf16 hierarchy, RB 1536x512 with and without it), the four whole steps and
the four fused tails from level 1, each on seeded inputs.

    python -m cfd_tpu_torch.time_whole_solve TAG [--only solve,step,tail]
                                                 [--flows cavity,channel,step,rb]

Prints one JSON line per measurement (CUDA-event median of 20 launches, 10
for a whole step) with its cycles and ms per V-cycle, the launch plan and a
checksum of the output, tagged with TAG; ``--flows`` keeps the flows named.
A whole-solve and a whole step also have their device time, ``dev_ms``
(dev_ms below: CUDA events around 50 back-to-back calls with the host
ahead of the card, so the wrapper's host time is not in it;
``host_ahead`` says whether it was), and a whole step ``carry_dev_ms``, the device time
of the same call with the solve's max_cycles 0: the carry phases alone
(the tiles, the source sum and mean removal, their barriers). The inputs are seeded
(cfd_tpu_torch.seeded, as chip_smoke.py's). Run from the root of a
checkout, it times that checkout's kernels, so two checkouts timed in
turns on one card (parent, change, change, parent) give an A/B. Needs a
CUDA card; it raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

FLOWS = {
    "cavity": ("make_cavity_case", dict(n_interior=2048, poisson="multigrid",
                                        tolerance_factor=1e-6)),
    "channel": ("make_channel_case", dict(nx=1536, ny=512, poisson="multigrid",
                                          tolerance_factor=1e-6, abs_tol=0.0)),
    "step": ("make_backwards_step_case", dict(nx=2048, ny=256, poisson="multigrid",
                                              tolerance_factor=1e-6, abs_tol=0.0)),
    "rb": ("make_rayleigh_benard_case", dict(nx=1536, ny=512, rayleigh=1e6)),
}
SOLVES = [("cavity", {}), ("channel", {}), ("step", {}), ("rb", {}),
          ("cavity", {"coarse_dtype": "bfloat16"}), ("rb", {"coarse_dtype": "bfloat16"}),
          ("step", {"coarse_dtype": "bfloat16"}), ("step", {"corr_opt": True})]


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


# the card's busy wait while the host queues the timed calls of dev_ms:
# about 50 ms at the H100's 1.98 GHz
SLEEP_CYCLES = 100_000_000


def dev_ms(fn, reps: int = 50) -> tuple[float, bool]:
    """(device ms of one call of ``fn``, whether the host queued all
    ``reps`` calls before the card reached them): CUDA events around the
    calls, queued while the card sleeps (torch.cuda._sleep), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    ev[2].synchronize()
    return ev[1].elapsed_time(ev[2]) / reps, host_ms < ev[0].elapsed_time(ev[1])


def make(flow: str, overrides: dict):
    from cfd_tpu_torch import cases

    name, kw = FLOWS[flow]
    return getattr(cases, name)(device="cuda", dtype=torch.float32, mg_overrides=overrides,
                                **kw)


def plan_of(obj):
    plan = getattr(obj, "plan", None)
    return None if plan is None else dataclasses.asdict(plan)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--only", default="solve,step,tail")
    ap.add_argument("--flows", default=",".join(FLOWS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_whole_solve needs a CUDA card")
    from cfd_tpu_torch.seeded import seeded_fields, seeded_source

    what, flows = set(args.only.split(",")), args.flows.split(",")
    out = lambda **kw: print(json.dumps(dict(tag=args.tag, **kw)), flush=True)

    if "solve" in what:
        for flow, ov in (s for s in SOLVES if s[0] in flows):
            case = make(flow, {"whole_solve": True, **ov})
            solve = case.poisson_solve
            b = seeded_source(case, 11)
            p0 = torch.zeros_like(b)
            p, cycles, res = solve.kernel(p0, b)
            cycles = int(cycles)
            ms = median_ms(lambda: solve.kernel(p0, b))
            d, ahead = dev_ms(lambda: solve.kernel(p0, b))
            out(kind="solve", flow=flow, ov=ov, cycles=cycles, res=float(res), ms=ms,
                ms_per_cycle=ms / cycles, dev_ms=d, host_ahead=ahead,
                p_sum=float(p.double().sum()), plan=plan_of(solve))
            del case, solve
    if "step" in what:
        for flow in flows:
            case = make(flow, {"whole_step": True})
            ws = case.whole_step_kernel
            f = seeded_fields(case, 17)
            cycles = int(ws.kernel(*f)[-2])
            ms = median_ms(lambda: ws.kernel(*f), reps=10)
            d, ahead = dev_ms(lambda: ws.kernel(*f))
            cfg, ws.solver.cfg = ws.solver.cfg, dataclasses.replace(ws.solver.cfg, max_cycles=0)
            carry, carry_ahead = dev_ms(lambda: ws.kernel(*f))
            ws.solver.cfg = cfg
            out(kind="whole_step", flow=flow, cycles=cycles, ms=ms, ms_per_cycle=ms / cycles,
                dev_ms=d, host_ahead=ahead, carry_dev_ms=carry,
                carry_host_ahead=carry_ahead, plan=plan_of(ws))
            del case, ws
    if "tail" in what:
        from cfd_tpu_torch.kernels.mg_tail import level_masks

        for flow in flows:
            case = make(flow, {"tail_from": 1})
            tail = case.poisson_solve.tail
            lv = tail.levels[0]
            rng = np.random.default_rng(5)
            b = torch.from_numpy(rng.standard_normal(lv.shape).astype(np.float32) * 1e2)
            b = torch.where(level_masks(lv, "cuda")[1], b.to("cuda"), 0.0)
            e = tail.kernel(b)
            out(kind="tail", flow=flow, ms=median_ms(lambda: tail.kernel(b)),
                e_sum=float(e.double().sum()), plan=plan_of(tail))
            del case, tail
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
