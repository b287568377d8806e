"""Where the time of one cavity, channel, backward-step or Rayleigh-Benard
step goes on the card.

    python -m cfd_tpu_torch.profile_step [--n 2048] [--warmup 100] [--steps 50]
                                         [--out DIR]
    python -m cfd_tpu_torch.profile_step --case channel [--nx 1536 --ny 512]
                                         [--mg default|whole|per-kernel|whole-step|K=V,...]
    python -m cfd_tpu_torch.profile_step --case step [--nx 2048 --ny 256] [--mg ...] ...
    python -m cfd_tpu_torch.profile_step --case rb [--nx 1536 --ny 512] [--mg ...] ...
    python -m cfd_tpu_torch.profile_step --case cavity --layout aligned
    python -m cfd_tpu_torch.profile_step --case step --nx 512 --ny 30
    python -m cfd_tpu_torch.profile_step --fuse-pre --mg per-kernel
    python -m cfd_tpu_torch.profile_step --mesh 4 [--case cavity|channel|step|rb]
                                         [--mg tail_from=1]
    python -m cfd_tpu_torch.profile_step [--mesh 4] --adaptive-dt 0.7 [--case ...]
    python -m cfd_tpu_torch.profile_step --adaptive-dt 0.7 --adaptive-controller exact

Drives a main path on cuda through Simulation's step function: the cavity,
make_cavity_case(n_interior=n, poisson="multigrid", dtype=float32,
tolerance_factor=1e-6), the channel, make_channel_case(nx, ny,
poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0, dtype=float32)
(default 1536x512), the step, make_backwards_step_case(nx, ny, the same
solver settings) (default 2048x256), or Rayleigh-Benard,
make_rayleigh_benard_case(nx, ny, rayleigh=1e6, dtype=float32) with its own
tolerances (default 1536x512), with the case's default solve or the other
one. ``--mg`` picks the solve: ``default`` is the case's own (the
whole-solve on the card), ``whole`` and ``per-kernel`` force one, and
``whole-step`` runs the whole time step in one kernel (kernels.whole_step);
any other value is MGConfig overrides ``K=V[,K=V...]`` as the CLI's --mg
takes them (e.g. ``tail_from=1``, ``whole_solve=true,coarse_dtype=bfloat16``,
``corr_opt=true``). ``--layout aligned`` (cavity, channel) runs the natural
aligned layout; sizes without a quad layout (e.g. the cavity at n = 142,
the step at 512x30) take the natural layout by the auto rule. ``--fuse-pre``
(cavity) passes fuse_pre=True: on the per-kernel solve (``--mg
per-kernel`` or a manual knob such as ``tail_from=1``) the carry runs the
first cycle's pre-smooth and restriction (kernels.quad
QuadCorrPredictorSourceFusedPre); the whole-solve ignores it. ``--mesh N``
runs the sharded quad path on an N-shard plane-row mesh whose shards all
live on the card (Simulation(mesh=make_mesh(N), sharded_kwargs=...):
tol_factor 1e-6 for the cavity, the channel and the step (V(1,1), its
case built with abs_tol 0), RB's own tolerances 1e-7 and 1e-10); ``--mg``
overrides then go to the sharded solve's own config,
parallel.quad_sharded. ``--adaptive-dt MAX_CO`` steps with the lagged
adaptive controller (cfd_tpu_torch.adaptive.LaggedController, growth 1.2,
from the case's dt): the traced-dt + Courant carry and the controller's
device ops each step, on one device or on the mesh; with
``--adaptive-controller exact`` (the cavity on one device) the exact
controller's host loop (cfd_tpu_torch.adaptive.exact_start: the non-carry
traced-dt predictor + source and corrector, one host read of the Courant
number a step).
The steps' V-cycle counts stay on the card until each window ends, as in
Simulation.run, so no window reads the host between its steps. It runs
three windows:

1. ``--warmup`` steps, untimed;
2. ``--steps`` steps timed with the host clock between two synchronizes,
   with no profiler attached (the unprofiled wall);
3. ``--steps`` more steps under torch.profiler with CUDA activity only,
   again timed with the host clock between two synchronizes. The device
   is busy for the union of the kernel, memcpy and memset intervals of the
   exported trace; busy and idle shares are of THIS window's wall, so both
   come from one traced window. The profiler slows the host, so the traced
   wall is longer than the unprofiled one: both are printed.

Launches are split into the port's own kernels (the ``__global__``
functions of csrc/) and everything else (PyTorch's glue ops); the
wrappers' own launch counters (kernels.KERNELS) give each entry point's
launches a step in the timed windows. The trace is
written to ``DIR/trace.json`` (default build/cfd_tpu_torch/profile). The
last line printed is a JSON summary. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

from cfd_tpu_torch.kernels._build import CSRC

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DEFAULT_OUT = Path(__file__).resolve().parents[1] / "build" / "cfd_tpu_torch" / "profile"


def port_kernel_names() -> set[str]:
    """The ``__global__`` function names of csrc/."""
    names = set()
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", f.read_text()))
    return names


def is_port_kernel(trace_name: str, names: set[str]) -> bool:
    """True when a trace kernel name is one of ``names``: the demangled name
    holds ``<fn>(`` or ``<fn><`` after a ``::`` or at its start."""
    return any(re.search(rf"(^|::|\s){re.escape(n)}[(<]", trace_name) for n in names)


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, duration)`` intervals."""
    total, end = 0.0, float("-inf")
    for start, dur in sorted(intervals):
        stop = start + dur
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def summarize_trace(events: list[dict], names: set[str], n_steps: int,
                    wall_s: float) -> dict:
    """Per-step device numbers of one traced window from its chrome-trace
    events: busy µs (interval union), idle share of ``wall_s``, launches
    of the port's kernels and of the rest, and device µs by kernel name:
    the twelve largest (``top``) and every port kernel (``port``)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    port = other = 0
    port_us = other_us = 0.0
    for e in dev:
        name, dur = e.get("name", "?"), float(e["dur"])
        by_name[name][0] += dur
        by_name[name][1] += 1
        if e["cat"] == "kernel" and is_port_kernel(name, names):
            port, port_us = port + 1, port_us + dur
        else:
            other, other_us = other + 1, other_us + dur
    busy = busy_us([(float(e["ts"]), float(e["dur"])) for e in dev])
    wall_us = wall_s * 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return dict(
        wall_ms_per_step=wall_us / n_steps / 1e3,
        busy_ms_per_step=busy / n_steps / 1e3,
        idle_share=1.0 - busy / wall_us,
        launches_per_step=(port + other) / n_steps,
        port_launches_per_step=port / n_steps,
        other_launches_per_step=other / n_steps,
        port_ms_per_step=port_us / n_steps / 1e3,
        other_ms_per_step=other_us / n_steps / 1e3,
        top=[dict(name=n, us_per_step=us / n_steps, launches_per_step=c / n_steps)
             for n, (us, c) in top[:12]],
        port=[dict(name=n, us_per_step=us / n_steps, launches_per_step=c / n_steps)
              for n, (us, c) in top if is_port_kernel(n, names)],
    )


def device_ops_a_call(fn, attempts: int = 3) -> list[str]:
    """The device operations (kernels, memsets, copies: DEVICE_CATS) of one
    call of ``fn`` after a warm-up call, as "category:name", from
    torch.profiler traces of that call alone: the fullest of ``attempts``
    traces. A trace may miss some or all of the call's device events (a
    process's later traces have come back empty on the H100 machine, and
    traces of a two-kernel call with one of them), never add one; [] if
    every trace is empty."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        ops = [f"{e['cat']}:{e['name']}" for e in events if e.get("cat") in DEVICE_CATS]
        if len(ops) > len(best):
            best = ops
    return best


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_case(args):
    """The profiled case on cuda (see the module docstring)."""
    from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                     make_channel_case, make_rayleigh_benard_case)

    from cfd_tpu_torch.cli import parse_mg

    presets = {"whole": {"whole_solve": True}, "default": None,
               "per-kernel": {"whole_solve": False}, "whole-step": {"whole_step": True}}
    ov = presets[args.mg] if args.mg in presets else parse_mg(args.mg)
    layout = {} if args.layout == "auto" else {"layout": args.layout}
    if args.case == "cavity":
        case = make_cavity_case(n_interior=args.n, poisson="multigrid",
                                dtype=torch.float32, tolerance_factor=1e-6, device="cuda",
                                mg_overrides=ov, fuse_pre=args.fuse_pre, **layout)
        return case, describe(case, f"cavity {args.n}^2")
    if args.fuse_pre:
        raise SystemExit("profile_step: --fuse-pre is a cavity option")
    make, (nx, ny) = {"channel": (make_channel_case, (1536, 512)),
                      "step": (make_backwards_step_case, (2048, 256)),
                      "rb": (make_rayleigh_benard_case, (1536, 512))}[args.case]
    nx, ny = args.nx or nx, args.ny or ny
    if args.case == "rb":
        case = make(nx=nx, ny=ny, rayleigh=1e6, dtype=torch.float32, device="cuda",
                    mg_overrides=ov)
        return case, describe(case, f"rb {nx}x{ny}")
    case = make(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6, abs_tol=0.0,
                dtype=torch.float32, device="cuda", mg_overrides=ov, **layout)
    return case, describe(case, f"{args.case} {nx}x{ny}")


def mesh_case(args):
    """The case of ``--mesh`` on cuda, its name and its sharded solve's
    kwargs (the module docstring)."""
    from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                     make_channel_case, make_rayleigh_benard_case)

    if args.case == "cavity":
        case = make_cavity_case(n_interior=args.n, poisson="multigrid", dtype=torch.float32,
                                tolerance_factor=1e-6, device="cuda")
        return case, f"cavity {args.n}^2", {"tol_factor": 1e-6}
    if args.case == "step":
        nx, ny = args.nx or 2048, args.ny or 256
        case = make_backwards_step_case(nx=nx, ny=ny, poisson="multigrid",
                                        dtype=torch.float32, tolerance_factor=1e-6,
                                        abs_tol=0.0, device="cuda")
        return case, f"step {nx}x{ny}", {"tol_factor": 1e-6}
    nx, ny = args.nx or 1536, args.ny or 512
    if args.case == "rb":
        case = make_rayleigh_benard_case(nx=nx, ny=ny, rayleigh=1e6, dtype=torch.float32,
                                         device="cuda")
        return case, f"rb {nx}x{ny}", {"tol_factor": 1e-7, "mg_overrides": {"abs_tol": 1e-10}}
    case = make_channel_case(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6,
                             abs_tol=0.0, dtype=torch.float32, device="cuda")
    return case, f"channel {nx}x{ny}", {"tol_factor": 1e-6}


def describe(case, what: str) -> str:
    mg = case.info["mg"]
    path = ("whole step" if mg.whole_step else
            "whole solve" if mg.whole_solve else "per-kernel solve")
    knobs = "".join(f", {k}={getattr(mg, k)}" for k in ("tail_from", "corr_opt")
                    if getattr(mg, k))
    knobs += ", the fused-pre carry" if case.carry_fused_pre else ""
    layout = "quad" if case.carry_tentative else "natural"
    return f"{what} ({layout} layout, {path}, coarse {mg.coarse_dtype or 'float32'}{knobs})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cfd_tpu_torch.profile_step",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=["cavity", "channel", "step", "rb"], default="cavity")
    ap.add_argument("--n", type=int, default=2048, help="cavity: interior cells per side")
    ap.add_argument("--nx", type=int, default=None,
                    help="channel/step/rb: interior cells in x (default 1536 / 2048 / "
                         "1536)")
    ap.add_argument("--ny", type=int, default=None,
                    help="channel/step/rb: interior cells in y (default 512 / 256 / 512)")
    ap.add_argument("--mg", default="default",
                    help="the pressure solve: default (the case's own path), whole, "
                         "per-kernel, whole-step (the whole step in one kernel), or "
                         "MGConfig overrides K=V[,K=V...]")
    ap.add_argument("--layout", choices=["auto", "quad", "aligned"], default="auto",
                    help="cavity/channel: the layout (default: the case's auto rule)")
    ap.add_argument("--fuse-pre", action="store_true",
                    help="cavity: fuse_pre=True (taken on the per-kernel solve)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="the sharded quad path on an N-shard plane-row mesh on the card")
    ap.add_argument("--adaptive-dt", type=float, default=None, metavar="MAX_CO",
                    help="adaptive stepping toward this max Courant number")
    ap.add_argument("--adaptive-controller", choices=["lagged", "exact"], default="lagged",
                    help="with --adaptive-dt: the lagged controller (default) or the exact "
                         "one's host loop (the cavity on one device)")
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.solver import Simulation, read_diagnostics

    card = card_line()
    if args.mesh:
        from cfd_tpu_torch.cli import parse_mg
        from cfd_tpu_torch.parallel import make_mesh

        if args.fuse_pre or args.layout != "auto":
            raise SystemExit("profile_step: --mesh runs the quad layout without --fuse-pre")
        case, what, kw = mesh_case(args)
        if args.mg != "default":
            kw["mg_overrides"] = {**kw.get("mg_overrides", {}), **parse_mg(args.mg)}
        sim = Simulation(case, log=lambda m: None, mesh=make_mesh(args.mesh), sharded_kwargs=kw)
        mg = sim._engine.mg if not sim._engine.delegated else case.info["mg"]
        knobs = f", tail_from={mg.tail_from}" if mg.tail_from else ""
        what = (f"{what} on a {args.mesh}-shard plane-row mesh (sharded quad path, "
                f"V({mg.pre_sweeps},{mg.post_sweeps}), tol_factor {mg.tol_factor}{knobs})")
    else:
        case, what = make_case(args)
        sim = Simulation(case, log=lambda m: None)
    if args.adaptive_dt is None:
        state, advance = sim.initial_state(), sim._step
    elif args.adaptive_controller == "exact":
        from cfd_tpu_torch.adaptive import exact_start

        state, advance = exact_start(sim, args.adaptive_dt)
        what += f", the exact adaptive controller toward Co {args.adaptive_dt}"
    else:
        from cfd_tpu_torch.adaptive import lagged_start

        state, step, lag = lagged_start(sim, args.adaptive_dt)
        advance = lambda st: lag.advance(step, st)
        what += f", the lagged adaptive controller toward Co {args.adaptive_dt}"

    cycles: list[int] = []

    def window(n_steps: int):
        """n_steps steps, timed between two synchronizes; their cycles are
        read after the second."""
        nonlocal state
        diags = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, diag = advance(state)
            diags.append(diag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cycles.extend(read_diagnostics(diags)[0])
        return wall

    window(args.warmup)
    del cycles[:]
    for kern in KERNELS:
        kern.launches = 0
    wall_plain = window(args.steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_traced = window(args.steps)
    args.out.mkdir(parents=True, exist_ok=True)
    trace_path = args.out / "trace.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    s = summarize_trace(events, port_kernel_names(), args.steps, wall_traced)
    wrapper = {k.name: k.launches / (2 * args.steps) for k in KERNELS if k.launches}
    if s["busy_ms_per_step"] <= 0:
        raise SystemExit("profile_step: the trace holds no device activity")

    print(f"card: {card}")
    print(f"{what}, {args.warmup} warm-up steps, windows of {args.steps} "
          f"steps, {sum(cycles) / len(cycles):.2f} V-cycles/step")
    print(f"unprofiled wall: {wall_plain / args.steps * 1e3:.4f} ms/step")
    print(f"traced wall:     {s['wall_ms_per_step']:.4f} ms/step")
    print(f"traced device busy: {s['busy_ms_per_step']:.4f} ms/step, "
          f"idle share of the traced wall {s['idle_share']:.4f}")
    print(f"launches/step: {s['launches_per_step']:.2f} "
          f"(port kernels {s['port_launches_per_step']:.2f}, "
          f"other {s['other_launches_per_step']:.2f})")
    print(f"device ms/step: port kernels {s['port_ms_per_step']:.4f}, "
          f"other {s['other_ms_per_step']:.4f}")
    for key in ("top", "port"):
        print("the twelve largest:" if key == "top" else "every port kernel:")
        for t in s[key]:
            print(f"  {t['us_per_step']:9.2f} us/step {t['launches_per_step']:7.2f} "
                  f"launches/step  {t['name'][:90]}")
    print("wrapper launches/step: " + ", ".join(f"{k} {v:.2f}" for k, v in wrapper.items()))
    print(json.dumps(dict(card=card, case=what, steps=args.steps,
                          unprofiled_wall_ms_per_step=wall_plain / args.steps * 1e3,
                          cycles_per_step=sum(cycles) / len(cycles),
                          trace=str(trace_path), wrapper_launches_per_step=wrapper,
                          **{k: v for k, v in s.items() if k not in ("top", "port")})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
