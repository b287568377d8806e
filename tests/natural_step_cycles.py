"""The natural backward step's V-cycle counts in cfd_tpu_torch and cfd_tpu
on the CPU, step by step from the same start, and the residual sequence of
every solve whose count differs.

Both time loops record each solve's inputs (the warm start and the source).
For a step whose counts differ, both solvers are run cycle by cycle on
both steps' inputs, so the printout tells a solver that diverges on equal
inputs from inputs that have drifted apart, and names each exit: "tol"
(res <= tol), "stall" (res >= stall_ratio * prev) or "cap" (max_cycles).
The reference runs its Pallas kernels in interpret mode
(smoother_mode="interpret"), the port its plain twins.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/natural_step_cycles.py --nx 512 --ny 30 \\
        --steps 12 --tol 1e-6

tests/test_torch_natural_slice.py records its slices with record_port and
record_reference.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cfd_tpu.bc import step_pressure_ghosts as jax_step_ghosts
from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step_case
from cfd_tpu.poisson.multigrid import MGConfig
from cfd_tpu.poisson.multigrid import make_masked_multigrid_poisson as jax_masked_mg
from cfd_tpu.solver import Simulation as JaxSimulation
from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.solver import Simulation


def step_cases(nx, ny, tol):
    """The natural step in both packages: (port case, reference case)."""
    kw = dict(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=tol, abs_tol=0.0,
              final_time=1.0, print_interval=10 ** 6)
    ref = jax_step_case(dtype=jnp.float32, smoother_mode="interpret", **kw)
    assert ref.step_kernels is None  # the reference's natural path
    return make_backwards_step_case(dtype=torch.float32, device="cpu", **kw), ref


def _fields(lg, as_numpy):
    return {k: None if getattr(lg, k) is None else as_numpy(getattr(lg, k))
            for k in ("u", "v", "p", "p_prev")}


def record_port(case, n_steps):
    """n_steps of the port's case from its initial state: dict(cycles,
    res (each solve's final residual), inputs ((p_warm, b) of each
    solve), states (logical u, v, p, p_prev as numpy), ke (avg_KE), carry
    (the last carried State))."""
    inputs = []

    def solve(p, b, max_b=None):
        inputs.append((p.numpy().copy(), b.numpy().copy()))
        return case.poisson_solve(p, b, max_b)

    sim = Simulation(dataclasses.replace(case, poisson_solve=solve), log=lambda m: None)
    s, out = sim.initial_state(), dict(cycles=[], res=[], inputs=inputs, states=[], ke=[])
    for _ in range(n_steps):
        s, d = sim._step(s)
        out["cycles"].append(int(d.poisson_iters))
        out["res"].append(float(d.poisson_residual))
        out["states"].append(_fields(sim._logical(s), lambda a: a.numpy()))
        out["ke"].append(sim.statistics(s)["avg_kinetic_energy"])
    return dict(out, carry=s)


def record_reference(case, n_steps):
    """record_port's record of the reference's case (no carry)."""
    inputs = []

    def solve(p, b, max_b=None):
        jax.debug.callback(lambda p, b: inputs.append((np.array(p), np.array(b))), p, b)
        return case.poisson_solve(p, b, max_b)

    sim = JaxSimulation(dataclasses.replace(case, poisson_solve=solve), log=lambda m: None)
    s, out = sim.initial_state(), dict(cycles=[], res=[], inputs=inputs, states=[], ke=[])
    for _ in range(n_steps):
        s, d = sim._step(s)
        out["cycles"].append(int(d.poisson_iters))
        out["res"].append(float(d.poisson_residual))
        out["states"].append(_fields(sim._logical(s), np.asarray))
        out["ke"].append(sim.statistics(s)["avg_kinetic_energy"])
    jax.effects_barrier()
    return out


def port_residuals(case, p, b, n):
    """The port's residual after each of n V-cycles from p."""
    solve, p, b, out = case.poisson_solve, torch.from_numpy(p), torch.from_numpy(b), []
    for _ in range(n):
        p, res = solve.cycle(p, b)
        out.append(float(res))
    return out


def reference_one_cycle(jcase, tol):
    """The reference's solve capped at one V-cycle, with the MGConfig its
    natural branch builds (cfd_tpu/cases/backwards_step.py:102-104): its
    loop state is p alone, so calling it again on the p it returns goes on
    with the loop."""
    mg = MGConfig(tol_factor=tol, abs_tol=0.0, max_cycles=1)
    return jax.jit(jax_masked_mg(jcase.grid, jcase.coeffs, mg, jax_step_ghosts(jcase.grid),
                                 dtype=jnp.float32, smoother_mode="interpret"))


def reference_residuals(one_cycle, p, b, n):
    p, b, out = jnp.asarray(p), jnp.asarray(b), []
    for _ in range(n):
        p, _, res = one_cycle(p, b)
        out.append(float(res))
    return out


def exit_of(res, tol, stall_ratio, max_cycles):
    """(cycles, reason) of the tolerance loop over a residual sequence, in
    float32 as both loops compare."""
    f32 = np.float32
    cycles = 0
    prev, cur = np.float32(1e30), np.float32(1e30) / np.float32(2.0)
    for r in res:
        if not (cur > tol and cycles < max_cycles and cur < f32(stall_ratio) * prev):
            break
        prev, cur = cur, f32(r)
        cycles += 1
    if cur <= tol:
        return cycles, "tol"
    if cycles >= max_cycles:
        return cycles, "cap"
    if cur >= f32(stall_ratio) * prev:
        return cycles, "stall"
    return cycles, "open"  # the sequence ended first


def tolerance(b, tol_factor, abs_tol=0.0):
    max_b = np.float32(np.abs(b).max())
    return max(np.float32(tol_factor) * (max_b if max_b > 0 else np.float32(1.0)),
               np.float32(abs_tol))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--ny", type=int, default=30)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--tol", type=float, default=1e-6)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    case, jcase = step_cases(a.nx, a.ny, a.tol)
    port, ref = record_port(case, a.steps), record_reference(jcase, a.steps)
    pc, rc, pin, rin = port["cycles"], ref["cycles"], port["inputs"], ref["inputs"]
    mg = case.info["mg"]
    print(f"natural step {a.nx}x{a.ny}, tol {a.tol:g}, V({mg.pre_sweeps},{mg.post_sweeps}), "
          f"stall_ratio {mg.stall_ratio}, max_cycles {mg.max_cycles}")
    print("step  port  reference  tol  port res  reference res")
    for k, (x, y) in enumerate(zip(pc, rc)):
        print(f"{k + 1:4d}  {x:4d}  {y:4d}  {tolerance(pin[k][1], a.tol):.6g}  "
              f"{port['res'][k]:.6g}  {ref['res'][k]:.6g}{'' if x == y else '  differs'}")
    one = reference_one_cycle(jcase, a.tol)
    for k, (x, y) in enumerate(zip(pc, rc)):
        if x == y:
            continue
        n = max(x, y) + 1
        for who, (p, b) in (("port's inputs", pin[k]), ("reference's inputs", rin[k])):
            tol = tolerance(b, a.tol)
            seqs = {"port": port_residuals(case, p, b, n),
                    "reference": reference_residuals(one, p, b, n)}
            print(f"step {k + 1} on the {who}: tol {tol:.9g}, "
                  f"max|dp_warm| between the runs {np.abs(pin[k][0] - rin[k][0]).max():.3g}, "
                  f"max|db| {np.abs(pin[k][1] - rin[k][1]).max():.3g}")
            for name, seq in seqs.items():
                c, why = exit_of(seq, tol, mg.stall_ratio, mg.max_cycles)
                print(f"  {name:9s} exits after {c} ({why}): "
                      + " ".join(f"{r:.9g}" for r in seq))


if __name__ == "__main__":
    main()
