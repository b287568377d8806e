"""Command-line entry point (the port of cfd_tpu.cli: the cavity, channel,
backward-step and Rayleigh-Benard cases).

Usage:
    python -m cfd_tpu_torch.cli cavity --Nx 2048 --Ny 2048 --precision f32 \\
        --no-vtk --steps 300 --steps-per-call 100
    python -m cfd_tpu_torch.cli channel --Nx 1536 --Ny 512 --precision f32 \\
        --no-vtk --steps 300 --steps-per-call 100
    python -m cfd_tpu_torch.cli backwards_step --Nx 2048 --Ny 256 --precision f32 \\
        --no-vtk --steps 300 --steps-per-call 100 --print-interval 100 \\
        --save-interval 100
    python -m cfd_tpu_torch.cli rayleigh_benard --Nx 1536 --Ny 512 --Ra 1e6 \
        --no-vtk --steps 300 --steps-per-call 100
    python -m cfd_tpu_torch.cli cavity --Nx 2048 --Ny 2048 --precision f32 \
        --no-vtk --steps 300 --steps-per-call 100 --adaptive-dt 0.7 \
        --adaptive-controller lagged
    python -m cfd_tpu_torch.cli channel --Nx 1536 --Ny 512 --precision f32 \
        --no-vtk --steps 300 --steps-per-call 100 --mg whole_step=true
    python -m cfd_tpu_torch.cli cavity --Nx 2048 --Ny 2048 --precision f32 \
        --poisson multigrid --no-vtk --steps 300 --steps-per-call 100 --mesh 4
    python -m cfd_tpu_torch.cli backwards_step --Nx 2048 --Ny 256 --precision f32 \
        --poisson multigrid --no-vtk --steps 300 --steps-per-call 100 \
        --print-interval 100 --save-interval 100 --mesh 4
    python -m cfd_tpu_torch.cli cavity --Nx 2048 --Ny 2048 --precision f32 \
        --poisson multigrid --no-vtk --steps 300 --steps-per-call 100 --mesh 4 \
        --adaptive-dt 0.7 --adaptive-controller lagged

The flags are the reference CLI's for the ported paths, with its defaults
per case (cfd_tpu/cli.py:103-106). VTK export is not ported yet, so a run
needs --no-vtk; flags of modules not ported yet (FTLE, SOR, checkpoints,
metrics, meshes) are refused with a message instead of being ignored.
--adaptive-dt MAX_CO runs cfd_tpu_torch.adaptive.run_adaptive with the
--adaptive-controller (exact: the cavity only; lagged: every case).
--mg K=V[,K=V...] overrides MGConfig fields as the reference's flag does
(cfd_tpu/cli.py:84-88, 133-156); --mg whole_step=true runs the whole time
step in one kernel. --mesh N runs any of the four cases on the sharded quad
path over an N-shard plane-row mesh (parallel.quad_sharded; every shard on
the --device's cards, round-robin, so one card holds them all), with the
reference's checks (cfd_tpu/cli.py:221-233); its solve takes the sharded
engine's own config (tol_factor 1e-9; V(2,1), the channel V(1,2), the step
V(1,1)), as the reference's does. With --adaptive-dt a mesh runs the lagged
controller only, as the reference's (the exact one is refused).
--save-interval sets the case's save interval, which
--steps-per-call must divide (no exporter reads it yet). The
Rayleigh-Benard case always solves with multigrid and ignores --poisson and
--Re, as the reference does (cfd_tpu/cli.py:173-181).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cfd_tpu_torch",
        description="Incompressible Navier-Stokes solvers on PyTorch/CUDA (cfd_tpu port)")
    sub = p.add_subparsers(dest="case", required=True)

    def common(sp, nx: int, ny: int, re: float, t_final: float):
        sp.add_argument("--Re", type=float, default=re, help="Reynolds number")
        sp.add_argument("--Nx", type=int, default=nx, help="interior cells in x")
        sp.add_argument("--Ny", type=int, default=ny, help="interior cells in y")
        sp.add_argument("--dt", type=float, default=None,
                        help="time step (default: reference CFL rule)")
        sp.add_argument("--T", type=float, default=t_final, help="final time")
        sp.add_argument("--steps", type=int, default=None,
                        help="run exactly N steps instead of to final time")
        sp.add_argument("--precision", choices=["f32", "f64"], default="f32",
                        help="f32 (the ported multigrid path); f64 is not ported yet")
        sp.add_argument("--print-interval", type=int, default=None)
        sp.add_argument("--save-interval", type=int, default=None,
                        help="save interval in steps (no exporter reads it yet; "
                             "--steps-per-call must divide it)")
        sp.add_argument("--steps-per-call", type=int, default=1,
                        help="steps per chunk; must divide the print and save intervals")
        sp.add_argument("--mg", default=None, metavar="K=V[,K=V...]",
                        help="multigrid overrides (MGConfig fields), e.g. --mg "
                             "pre_sweeps=2 or --mg whole_step=true (the whole time step "
                             "in one kernel)")
        sp.add_argument("--adaptive-dt", type=float, default=None, metavar="MAX_CO",
                        help="Courant-limited adaptive time stepping toward this max "
                             "Courant number (the OpenFOAM adjustTimeStep/maxCo knob)")
        sp.add_argument("--adaptive-controller", choices=["exact", "lagged"],
                        default="exact",
                        help="Courant feedback: 'exact' measures the step just "
                             "produced (the cavity); 'lagged' runs the tentative-carry "
                             "kernel with one-step-stale feedback (every case)")
        sp.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="shard the domain over N shards (1-D plane-row decomposition "
                             "on the quad path, f32 multigrid; one card may hold every "
                             "shard)")
        sp.add_argument("--no-vtk", action="store_true", help="disable VTK export")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda runs the CUDA kernels; cpu runs their plain "
                             "PyTorch twins")
        sp.add_argument("--poisson", choices=["auto", "sor", "multigrid"], default="auto",
                        help="pressure solver (auto: SOR at the reference sizes, which "
                             "is not ported yet; multigrid at scale)")

    common(sub.add_parser("cavity", help="lid-driven cavity (cavity-01.cpp)"),
           63, 63, 1000.0, 20.0)
    common(sub.add_parser("channel", help="channel / Poiseuille start-up (channel-01.cpp)"),
           93, 31, 100.0, 10.0)
    common(sub.add_parser("backwards_step",
                          help="backward-facing step (backwards_step-01.cpp)"),
           256, 32, 100.0, 15.0)
    rb = sub.add_parser("rayleigh_benard", help="Rayleigh-Benard convection")
    common(rb, 192, 64, 0.0, 50.0)
    rb.add_argument("--Ra", type=float, default=1e6, help="Rayleigh number")
    rb.add_argument("--Pr", type=float, default=0.71, help="Prandtl number")
    rb.add_argument("--ftle-window", type=int, default=0,
                    help="backward FTLE over the last N saved frames (not ported yet: "
                         "only 0 is accepted)")
    return p


def parse_mg(text: str) -> dict:
    """--mg K=V[,K=V...] as MGConfig overrides, with the reference's value
    rules (cfd_tpu/cli.py:133-156): true/false, none or empty, a float when
    the value has a '.' or an 'e', else an int, else the string."""
    import dataclasses

    from cfd_tpu_torch.poisson.multigrid import MGConfig

    fields = {f.name for f in dataclasses.fields(MGConfig)}
    ov = {}
    for item in text.split(","):
        k, _, v = item.partition("=")
        k, v = k.strip(), v.strip()
        if k not in fields:
            raise SystemExit(f"--mg: unknown MGConfig field {k!r} "
                             f"(valid: {', '.join(sorted(fields))})")
        if v.lower() in ("true", "false"):
            ov[k] = v.lower() == "true"
        elif v.lower() in ("none", ""):
            ov[k] = None
        else:
            try:
                ov[k] = float(v) if any(c in v for c in ".e") else int(v)
            except ValueError:
                ov[k] = v  # string-valued field (e.g. coarse_dtype)
    return ov


def make_case_from_args(args):
    from cfd_tpu_torch.cases import (make_backwards_step_case, make_cavity_case,
                                     make_channel_case, make_rayleigh_benard_case)
    from cfd_tpu_torch.precision import as_dtype

    kw = dict(final_time=args.T, dtype=as_dtype(args.precision), poisson=args.poisson,
              device=args.device)
    if args.dt is not None:
        kw["dt"] = args.dt
    if args.print_interval is not None:
        kw["print_interval"] = args.print_interval
    if args.save_interval is not None:
        kw["save_interval"] = args.save_interval
    if args.mg:
        kw["mg_overrides"] = parse_mg(args.mg)
    if args.case == "rayleigh_benard":
        if args.ftle_window:
            raise SystemExit("--ftle-window: FTLE (physics/ftle.py) is not ported yet")
        kw.pop("poisson")  # RB always solves with multigrid
        return make_rayleigh_benard_case(nx=args.Nx, ny=args.Ny, rayleigh=args.Ra,
                                         prandtl=args.Pr, **kw)
    if args.case == "channel":
        return make_channel_case(nx=args.Nx, ny=args.Ny, reynolds_number=args.Re, **kw)
    if args.case == "backwards_step":
        return make_backwards_step_case(nx=args.Nx, ny=args.Ny, reynolds_number=args.Re,
                                        **kw)
    if args.Nx != args.Ny:
        raise SystemExit("cavity requires Nx == Ny (square grid)")
    return make_cavity_case(n_interior=args.Nx, reynolds_number=args.Re, **kw)


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    if rest:
        raise SystemExit(f"not ported yet or unknown: {' '.join(rest)}")
    if not args.no_vtk:
        raise SystemExit("VTK export is not ported yet: pass --no-vtk")
    if args.mesh:
        if args.adaptive_dt is not None and args.adaptive_controller != "lagged":
            raise SystemExit("--mesh adaptive runs the lagged controller: "
                             "add --adaptive-controller lagged")
        if args.precision != "f32":
            raise SystemExit("--mesh runs the f32 quad fast path: add --precision f32")
    case = make_case_from_args(args)

    from cfd_tpu_torch.io import console
    from cfd_tpu_torch.solver import Simulation

    console.print_banner(case)
    print(f"device: {case.device}")
    mesh = None
    if args.mesh:
        from cfd_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_devices=args.mesh, shape=(args.mesh, 1), device=args.device)
        print(f"mesh: {args.mesh}x1 plane-row decomposition over {args.device}")
    sim = Simulation(case, mesh=mesh)
    if args.adaptive_dt is not None:
        from cfd_tpu_torch.adaptive import run_adaptive

        run_adaptive(sim, max_courant=args.adaptive_dt, n_steps=args.steps,
                     final_time=None if args.steps else case.final_time,
                     steps_per_call=args.steps_per_call,
                     controller=args.adaptive_controller)
    else:
        sim.run(n_steps=args.steps, steps_per_call=args.steps_per_call)
    return 0


if __name__ == "__main__":
    sys.exit(main())
