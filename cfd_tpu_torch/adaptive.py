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

A Simulation on a plane-row mesh routes as the reference's
(cfd_tpu/adaptive.py:219-235): a 1-shard mesh that delegates takes the
single-device controllers; a sharded engine runs the lagged controller
only (the exact one raises the reference's ValueError), its step from
ShardedQuadProjection.make_adaptive (the traced-dt + Courant carry on every
shard, the Courant maxima of the shards' own rows) in the same loop, with
(dt_used, dt, t) on shard 0's device: the port of _run_adaptive_sharded.

Not ported: checkpoint resume of adaptive runs (the port has no
checkpointer yet) and make_adaptive_step (the reference's fallback for the
SOR, f64 and XLA cases the port does not have).
"""

from __future__ import annotations

import time

import torch

from cfd_tpu_torch.kernels.quad import scalar_like
from cfd_tpu_torch.solver import read_diagnostics
from cfd_tpu_torch.state import State


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


class LaggedController:
    """The lagged controller's device state and step (cfd_tpu/adaptive.py:
    326-335): ``advance(step, state) -> (state, diag)`` runs the carry with
    (dt_used, dt), where dt_used built the carried tentative fields, sets
    ``co`` to the Courant number of the step it corrected (over dt_used),
    then dt_used = dt and dt from ``co``. Everything stays on ``like``'s
    device."""

    def __init__(self, like, dt: float, max_courant: float, growth: float, ceiling: float):
        self.ctl = _DeviceController(like, max_courant, growth, ceiling)
        self.du = self.d = scalar_like(dt, like)
        self.co = None

    def advance(self, step, state):
        state, diag, co_per_dt = step(state, torch.stack((self.du, self.d)))
        self.co = self.du * co_per_dt
        self.du, self.d = self.d, self.ctl(self.d, self.co)
        return state, diag


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
    spc = max(1, steps_per_call)
    step, to_aligned, to_logical = _resolve(sim, lagged, max_courant, growth, spc)
    if case.print_interval % spc:
        raise ValueError(f"steps_per_call={spc} must divide the print interval "
                         f"({case.print_interval})")
    dt = float(dt0 if dt0 is not None else case.dt)
    state, like = _start(sim, state, to_aligned, dt, lagged)
    run = dict(sim=sim, step=step, to_logical=to_logical, state=state, like=like, dt=dt,
               n_steps=n_steps, final_time=final_time, log=log, spc=spc,
               ceiling=_ceiling(case), max_courant=max_courant, growth=growth)
    if lagged:
        return _run_lagged(**run)
    if spc > 1:
        return _run_exact_chunked(**run)
    return _run_exact_host(**run)


def lagged_start(sim, max_courant: float = 0.7, growth: float = 1.2,
                 dt0: float | None = None):
    """The lagged controller at the start of a run from the case's initial
    state, for a driver that times its steps one by one (profile_step):
    (carried state, step, LaggedController); ``controller.advance(step,
    state)`` runs a step."""
    step, to_aligned, _ = _resolve(sim, True, max_courant, growth, 1)
    dt = float(dt0 if dt0 is not None else sim.case.dt)
    state, like = _start(sim, None, to_aligned, dt, True)
    return state, step, LaggedController(like, dt, max_courant, growth, _ceiling(sim.case))


def exact_start(sim, max_courant: float = 0.7, growth: float = 1.2,
                dt0: float | None = None):
    """The exact controller's host loop at the start of a run from the
    case's initial state, for a driver that times its steps one by one
    (profile_step): (carried state, advance); ``advance(state) -> (state,
    diag)`` runs a step with the current dt and sets the next from its
    Courant number in Python floats, one host read a step (the loop of
    _run_exact_host)."""
    step, to_aligned, _ = _resolve(sim, False, max_courant, growth, 1)
    ceiling = _ceiling(sim.case)
    dt = float(dt0 if dt0 is not None else sim.case.dt)
    state, like = _start(sim, None, to_aligned, dt, False)

    def advance(st):
        nonlocal dt
        st, diag, co_per_dt = step(st, scalar_like(dt, like))
        dt = _next_dt(dt, dt * float(co_per_dt), max_courant, growth, ceiling)
        return st, diag

    return state, advance


def _next_dt(dt: float, co: float, max_courant: float, growth: float, ceiling: float) -> float:
    """The exact host controller's next dt: approach max_courant from below,
    never above the diffusive ceiling; shrink at once when over the
    target."""
    return min(dt * min(growth, max_courant / max(co, 1e-12)), ceiling)


def _resolve(sim, lagged: bool, max_courant: float, growth: float, spc: int):
    """(step, to_aligned, to_logical) of the controller on ``sim``'s engine,
    routed as the reference's (cfd_tpu/adaptive.py:219-262)."""
    case, engine = sim.case, sim._engine
    if not getattr(engine, "delegated", True):  # sharded; a 1-shard mesh delegates
        # the exact controller's non-carry kernels have no sharded story
        if not lagged:
            raise ValueError("sharded adaptive runs the lagged controller: pass "
                             "controller='lagged' (--adaptive-controller lagged)")
        return engine.make_adaptive(max_courant, growth, _ceiling(case), spc)
    if lagged:
        if case.adaptive_impl_carry is None:
            raise ValueError("controller='lagged' needs Case.adaptive_impl_carry (the "
                             "f32 quad multigrid path)")
        return case.adaptive_impl_carry()
    if case.adaptive_impl is not None:
        return case.adaptive_impl()
    if case.ordering == "rayleigh_benard":
        # the reference's own refusal (cfd_tpu/adaptive.py:256-260)
        raise ValueError(f"case {case.name!r} has a custom step with no exact-controller "
                         "adaptive variant; run it with controller='lagged' (the "
                         "tentative-carry fused kernel)")
    # the reference falls back to make_adaptive_step here, which fails on
    # the quad layout (ROADMAP.md section C)
    raise ValueError(f"case {case.name!r} has no exact-controller adaptive step on "
                     "the quad path; run it with controller='lagged' (the "
                     "tentative-carry fused kernel)")


def _start(sim, state, to_aligned, dt: float, lagged: bool):
    """(the carried start state, the controller's device: the fields', shard
    0's on a mesh) from ``state`` (carried or logical; default the case's
    initial state)."""
    engine = sim._engine
    if state is None:
        state = sim.initial_state()
    if not engine.is_logical(state):
        state = engine.logical(state)
    # the lagged carry enters uncorrected with the dt its first step
    # re-corrects with (dt_corr = dt), so the round trip is one f32 rounding
    state = to_aligned(state, dt) if lagged else to_aligned(state)
    return state, (state.u if isinstance(state, State) else state[0][0])


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


def _run_exact_host(sim, step, to_logical, state, like, dt, n_steps, final_time, log, spc,
                    ceiling, max_courant, growth):
    """The exact controller in Python floats, one host read a step
    (cfd_tpu/adaptive.py:431-462)."""
    interval = sim.case.print_interval
    pending = _Pending(sim)
    rows, k, t, t0 = [], 0, 0.0, time.perf_counter()
    while not _done(k, t, n_steps, final_time):
        state, diag, co_per_dt = step(state, scalar_like(dt, like))
        k += 1
        t += dt
        co = dt * float(co_per_dt)
        pending.append(diag)
        sim.step_dts.append(dt)
        if k % interval == 0:
            rows.append(_row(sim, to_logical(state), k, t, dt, co, *pending.read(), t0,
                             log))
        dt = _next_dt(dt, co, max_courant, growth, ceiling)
    pending.read()
    return to_logical(state), rows


def _run_exact_chunked(sim, step, to_logical, state, like, dt, n_steps, final_time, log,
                       spc, ceiling, max_courant, growth):
    """The exact controller on the device in chunks of ``spc`` steps, one
    packed read a chunk (cfd_tpu/adaptive.py:370-429)."""
    ctl = _DeviceController(like, max_courant, growth, ceiling)
    interval = sim.case.print_interval
    d = scalar_like(dt, like)
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


def _run_lagged(sim, step, to_logical, state, like, dt, n_steps, final_time, log, spc,
                ceiling, max_courant, growth):
    """The lagged controller (cfd_tpu/adaptive.py:295-368, and on a mesh
    :83-170): each step runs the carry with (dt_used, dt), where dt_used
    built the carried tentative fields; the Courant number it returns
    belongs to the step it corrected, over dt_used. (dt_used, dt, t) stay on
    ``like``'s device, read at print cadence, at the end, and every chunk
    when ``final_time`` decides."""
    lag = LaggedController(like, dt, max_courant, growth, ceiling)
    interval = sim.case.print_interval
    t_dev = scalar_like(0.0, like)
    pending = []  # dts of the steps since the last read
    diags = _Pending(sim)
    rows, k, t, t0 = [], 0, 0.0, time.perf_counter()
    while not _done(k, t, n_steps, final_time):
        for _ in range(spc):
            pending.append(lag.d)
            t_dev = t_dev + lag.d
            state, diag = lag.advance(step, state)
            diags.append(diag)
        k += spc
        if (final_time is not None or k % interval == 0
                or (n_steps is not None and k >= n_steps)):
            t, co_last, *per_step = torch.cat(
                [torch.stack([t_dev, lag.co]), torch.stack(pending)]).tolist()
            sim.step_dts.extend(per_step)
            pending = []
        if k % interval == 0:
            rows.append(_row(sim, to_logical(state, lag.du), k, t, per_step[-1], co_last,
                             *diags.read(), t0, log))
    diags.read()
    return to_logical(state, lag.du), rows
