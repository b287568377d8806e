"""Courant-limited adaptive time stepping (the port of cfd_tpu.adaptive,
run_adaptive; the reference's OpenFOAM adjustTimeStep / maxCo workflow).

The controller is the reference's:

    dt_next = min(dt * min(growth, max_co / Co), ceiling)

with Co = dt * (max|u|/dx + max|v|/dy) and the diffusive ceiling
0.25 h^2 / D (D = Case.adaptive_diffusivity, else the viscosity), which
explicit diffusion never relaxes. dt reaches the kernels as a float32
tensor on the card (their traced_dt instances read it from device memory),
so no kernel ever waits for a host float.

Controllers (``controller``):

* "exact": the Courant number of the state the step just produced feeds
  the next dt (Case.adaptive_impl: the cavity's non-carry traced-dt
  kernels). ``steps_per_call=1`` keeps the controller on the host in
  Python floats, one host read of Co a step; ``steps_per_call > 1`` keeps
  it in 0-d float32 tensors on the device and reads one packed vector a
  chunk. The two reach the same dt schedule to float32 roundoff, not bit
  for bit (cfd_tpu/adaptive.py:186-190).
* "lagged": the tentative-carry kernels with (dt_corr, dt_pred) and the
  Courant maxima fused in (Case.adaptive_impl_carry; all four cases). The
  corrected fields exist only inside the kernel that also feeds them to the
  next predictor, so the feedback is one step stale. The controller state
  (dt_used, dt, t) stays on the device; it is read at print cadence.

Every controller keeps the steps' (cycles, res) where the solve left them
(0-d device tensors on the whole-solve paths) and reads them once per stats
row and at the end (solver.read_diagnostics); only the exact host loop's
read of Co a step remains, because its controller needs it.

Not ported: the multi-chip controller (_run_adaptive_sharded), checkpoint
resume of adaptive runs (the port has no checkpointer yet) and
make_adaptive_step (the reference's fallback for the SOR, f64 and XLA cases
the port does not have).
"""

from __future__ import annotations

import time

import torch

from cfd_tpu_torch.kernels.quad import scalar_like
from cfd_tpu_torch.solver import read_diagnostics


def _ceiling(case) -> float:
    d = case.adaptive_diffusivity if case.adaptive_diffusivity is not None \
        else case.coeffs.viscosity
    return 0.25 * min(case.coeffs.dx, case.coeffs.dy) ** 2 / max(d, 1e-300)


class _DeviceController:
    """dt' = min(dt * min(growth, max_co / max(co, 1e-12)), ceiling) on 0-d
    float32 tensors, in the reference's float32 order (every constant a
    device tensor, so the division is a true division)."""

    def __init__(self, like, max_courant: float, growth: float, ceiling: float):
        self.growth = scalar_like(growth, like)
        self.max_co = scalar_like(max_courant, like)
        self.tiny = scalar_like(1e-12, like)
        self.ceiling = scalar_like(ceiling, like)

    def __call__(self, d, co):
        scale = torch.minimum(self.growth, self.max_co / torch.maximum(co, self.tiny))
        return torch.minimum(d * scale, self.ceiling)


def run_adaptive(sim, max_courant: float = 0.7, n_steps: int | None = None,
                 final_time: float | None = None, dt0: float | None = None,
                 growth: float = 1.2, state=None, log=None, steps_per_call: int = 1,
                 controller: str = "exact"):
    """Advance ``sim.case`` with a Courant-limited dt until ``n_steps`` or
    ``final_time``, from ``state`` (carried or logical; default the case's
    initial state) and ``dt0`` (default the case's dt). Returns (logical
    state, stats rows every print_interval steps). Rows carry step, time,
    dt, courant, poisson_iters, poisson_residual and the wall seconds since
    the start; ``sim.step_iters`` and ``sim.step_dts`` get every step's
    V-cycles and dt."""
    case = sim.case
    log = log if log is not None else sim.log
    if controller not in ("exact", "lagged"):
        raise ValueError(f"unknown controller: {controller!r}")
    if n_steps is None and final_time is None:
        raise ValueError("run_adaptive needs n_steps or final_time")
    lagged = controller == "lagged"
    if lagged:
        if case.adaptive_impl_carry is None:
            raise ValueError("controller='lagged' needs Case.adaptive_impl_carry (the "
                             "f32 quad multigrid path)")
        step, to_aligned, to_logical = case.adaptive_impl_carry()
    elif case.adaptive_impl is not None:
        step, to_aligned, to_logical = case.adaptive_impl()
    elif case.ordering == "rayleigh_benard":
        # the reference's own refusal (cfd_tpu/adaptive.py:256-260)
        raise ValueError(f"case {case.name!r} has a custom step with no exact-controller "
                         "adaptive variant; run it with controller='lagged' (the "
                         "tentative-carry fused kernel)")
    else:
        # the reference falls back to make_adaptive_step here, which fails on
        # the quad layout (ROADMAP.md section C)
        raise ValueError(f"case {case.name!r} has no exact-controller adaptive step on "
                         "the quad path; run it with controller='lagged' (the "
                         "tentative-carry fused kernel)")
    spc = max(1, steps_per_call)
    if case.print_interval % spc:
        raise ValueError(f"steps_per_call={spc} must divide the print interval "
                         f"({case.print_interval})")
    dt = float(dt0 if dt0 is not None else case.dt)
    if state is None:
        state = sim.initial_state()
    if tuple(state.u.shape) != case.grid.shape:
        state = case.unalign_state(state)
    # the lagged carry enters uncorrected with the dt its first step
    # re-corrects with (dt_corr = dt), so the round trip is one f32 rounding
    state = to_aligned(state, dt) if lagged else to_aligned(state)
    run = dict(sim=sim, step=step, to_logical=to_logical, state=state, dt=dt,
               n_steps=n_steps, final_time=final_time, log=log, spc=spc,
               ceiling=_ceiling(case), max_courant=max_courant, growth=growth)
    if lagged:
        return _run_lagged(**run)
    if spc > 1:
        return _run_exact_chunked(**run)
    return _run_exact_host(**run)


def _done(k: int, t: float, n_steps, final_time) -> bool:
    return ((n_steps is not None and k >= n_steps)
            or (final_time is not None and t >= final_time))


class _Pending:
    """The steps' diagnostics since the last read; ``read()`` appends their
    cycles to sim.step_iters with one transfer and returns the last step's
    (cycles, res)."""

    def __init__(self, sim):
        self.sim, self.diags, self.last = sim, [], None

    def append(self, diag) -> None:
        self.diags.append(diag)

    def read(self):
        if self.diags:
            iters, res = read_diagnostics(self.diags)
            self.sim.step_iters.extend(iters)
            self.diags, self.last = [], (iters[-1], res[-1])
        return self.last


def _row(sim, logical, k, t, dt, co, iters, res, t_wall0, log) -> dict:
    now = time.perf_counter()
    row = sim.statistics(logical)
    row.update(step=k, time=t, dt=dt, courant=co, poisson_iters=int(iters),
               poisson_residual=float(res), wall_seconds=now - t_wall0)
    log(f"Step {k:6d} | t={t:8.4f} | dt={dt:.3e} | Co={co:.3f}"
        f" | max(div)={row['max_divergence']:10.2e}"
        f" | avg_KE={row['avg_kinetic_energy']:10.6f}")
    return row


def _run_exact_host(sim, step, to_logical, state, dt, n_steps, final_time, log, spc,
                    ceiling, max_courant, growth):
    """The exact controller in Python floats, one host read a step
    (cfd_tpu/adaptive.py:431-462)."""
    interval = sim.case.print_interval
    pending = _Pending(sim)
    rows, k, t, t0 = [], 0, 0.0, time.perf_counter()
    while not _done(k, t, n_steps, final_time):
        state, diag, co_per_dt = step(state, scalar_like(dt, state.u))
        k += 1
        t += dt
        co = dt * float(co_per_dt)
        pending.append(diag)
        sim.step_dts.append(dt)
        if k % interval == 0:
            rows.append(_row(sim, to_logical(state), k, t, dt, co, *pending.read(), t0,
                             log))
        # approach max_courant from below, never above the diffusive
        # ceiling; shrink at once when over the target
        scale = min(growth, max_courant / max(co, 1e-12))
        dt = min(dt * scale, ceiling)
    pending.read()
    return to_logical(state), rows


def _run_exact_chunked(sim, step, to_logical, state, dt, n_steps, final_time, log, spc,
                       ceiling, max_courant, growth):
    """The exact controller on the device in chunks of ``spc`` steps, one
    packed read a chunk (cfd_tpu/adaptive.py:370-429)."""
    ctl = _DeviceController(state.u, max_courant, growth, ceiling)
    interval = sim.case.print_interval
    d = scalar_like(dt, state.u)
    pending = _Pending(sim)
    rows, k, t, t0 = [], 0, 0.0, time.perf_counter()
    while not _done(k, t, n_steps, final_time):
        dts = []
        for _ in range(spc):
            state, diag, co_per_dt = step(state, d)
            co = d * co_per_dt
            pending.append(diag)
            dts.append(d)
            d = ctl(d, co)
        k += spc
        dts = torch.stack(dts)
        t_inc, co_last, *per_step = torch.cat(
            [torch.stack([dts.sum(), co]), dts]).tolist()
        t += t_inc
        sim.step_dts.extend(per_step)
        if k % interval == 0:
            rows.append(_row(sim, to_logical(state), k, t, per_step[-1], co_last,
                             *pending.read(), t0, log))
    pending.read()
    return to_logical(state), rows


def _run_lagged(sim, step, to_logical, state, dt, n_steps, final_time, log, spc, ceiling,
                max_courant, growth):
    """The lagged controller (cfd_tpu/adaptive.py:295-368): each step runs the
    carry with (dt_used, dt), where dt_used built the carried tentative
    fields; the Courant number it returns belongs to the step it corrected,
    over dt_used. (dt_used, dt, t) stay on the device, read at print
    cadence, at the end, and every chunk when ``final_time`` decides."""
    ctl = _DeviceController(state.u, max_courant, growth, ceiling)
    interval = sim.case.print_interval
    du = scalar_like(dt, state.u)
    d = scalar_like(dt, state.u)
    t_dev = scalar_like(0.0, state.u)
    pending = []  # dts of the steps since the last read
    diags = _Pending(sim)
    rows, k, t, t0 = [], 0, 0.0, time.perf_counter()
    while not _done(k, t, n_steps, final_time):
        for _ in range(spc):
            state, diag, co_per_dt = step(state, torch.stack((du, d)))
            co_prev = du * co_per_dt
            diags.append(diag)
            pending.append(d)
            du, d, t_dev = d, ctl(d, co_prev), t_dev + d
        k += spc
        if (final_time is not None or k % interval == 0
                or (n_steps is not None and k >= n_steps)):
            t, co_last, *per_step = torch.cat(
                [torch.stack([t_dev, co_prev]), torch.stack(pending)]).tolist()
            sim.step_dts.extend(per_step)
            pending = []
        if k % interval == 0:
            rows.append(_row(sim, to_logical(state, du), k, t, per_step[-1], co_last,
                             *diags.read(), t0, log))
    diags.read()
    return to_logical(state, du), rows
