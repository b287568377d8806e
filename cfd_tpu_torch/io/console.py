"""Reference-parity console output: the simulation-info banner (the port of
cfd_tpu.io.console). The stats ROWS are emitted by solver.Simulation.run.

printSimulationInfo: cavity-01.cpp:501-518, backwards_step-01.cpp:588-608;
the Rayleigh-Benard line as cfd_tpu/io/console.py:57-60;
the geometry report backwards_step-01.cpp:523-531; ANSI colors
cavity-01.cpp:35-41.
"""

from __future__ import annotations

import sys

RESET = "\033[0m"
CYAN = "\033[36m"
BLUE = "\033[34m"


def use_color() -> bool:
    """Color iff stdout is a tty (the conventional default)."""
    return bool(getattr(sys.stdout, "isatty", lambda: False)())


def paint(text: str, color: str, enabled: bool) -> str:
    return f"{color}{text}{RESET}" if enabled else text


def banner_lines(case) -> list[str]:
    """The reference printSimulationInfo block, from ``case.info`` (fixed
    6-decimal formatting as the reference's ``std::setprecision(6)``)."""
    info = case.info or {}
    g = case.grid
    f = lambda x: f"{float(x):.6f}"
    title = info.get("banner_title", f"{case.name} Simulation")
    lines = [f"=== {title} ===",
             f"Domain: {f(info.get('length', g.nx * g.dx))}x"
             f"{f(info.get('height', g.ny * g.dy))}"]
    if "step_height" in info:  # backwards_step-01.cpp:592-594
        lines.append(f"Step: height={f(info['step_height'])}, "
                     f"location={f(info['step_location'])}")
    if info.get("square_spacing"):  # cavity-01.cpp:505-506
        lines.append(f"Grid: {g.nx}x{g.ny} (spacing={f(g.dx)})")
    else:
        lines.append(f"Grid: {g.nx}x{g.ny} (dx={f(g.dx)}, dy={f(g.dy)})")
    lines.append(f"Time: dt={f(case.dt)}, steps={case.total_steps}, "
                 f"final_time={f(case.final_time)}")
    if "rayleigh" in info:
        lines.append(f"Rayleigh={info['rayleigh']:.6g}, "
                     f"Prandtl={f(info['prandtl'])}, "
                     f"CFL={f(info.get('cfl', 0.0))}")
    else:
        lines.append(f"Reynolds={f(info.get('reynolds', 0.0))}, "
                     f"kinematic viscosity={f(case.coeffs.viscosity)}, "
                     f"CFL={f(info.get('cfl', 0.0))}")
    if "omega" in info:
        lines.append(f"Relaxation factor={f(info['omega'])}")
    lines.append(f"VTK export interval={case.save_interval} steps")
    lines.append("==========================================")
    return lines


def print_banner(case, log=print) -> None:
    en = use_color()
    log(paint("\n".join(banner_lines(case)), CYAN, en))
    g = case.grid
    if g.has_solids:
        log(paint(f"Geometry setup complete. Fluid cells: {g.n_fluid}/{g.nx * g.ny}",
                  BLUE, en))
