"""Projection-method time integration (the port of cfd_tpu.solver).

Ported: the tentative-carry orderings of ``make_step`` for the cavity
(cfd_tpu/solver.py:221-228, and with the fused-pre carry :210-218), for the
channel with the extrapolated warm
start (:230-239) and for the backward step with the plain previous-p warm
start (:241-252) — the state's u/v are the TENTATIVE velocities and one
fused corrector+BC+predictor+source kernel runs at the start of each step,
followed (channel and step) by the source mean removal and then the
pressure solve — the channel ordering with the temperature carried through
the fused kernel (Rayleigh-Benard, in place of the reference's
``custom_step``, cfd_tpu/physics/boussinesq.py:334-353), the per-case
hooks ``extra_stats`` and ``initial_state_fn`` (cfd_tpu/solver.py:139-141),
the adaptive-stepping builders ``adaptive_impl``, ``adaptive_impl_carry``
and ``adaptive_diffusivity`` (:122-134, driven by cfd_tpu_torch.adaptive),
the whole-step ordering (cfd_tpu/solver.py:193-209, and RB's whole-step
``custom_step``, cfd_tpu/physics/boussinesq.py:326-332): one kernel a step
(kernels.whole_step), reached through ``Case.whole_step_kernel``, the
non-carry kernel orderings of the natural aligned layout
(cfd_tpu/solver.py:253-294: the cavity's predictor+source, solve and
corrector, the channel's with the source mean removal between), the
channel ordering of the natural backward step over the stencil ops
(:318-340, float32), and the ``Simulation`` time loop with its stats rows
and NaN/KE-blowup abort. The
JAX package runs a chunk of steps as one device program (lax.scan around
lax.while_loop); PyTorch runs eagerly, so a step here is a sequence of
kernel launches. On the whole-solve and whole-step paths each step's
(cycles, res) stay on the device until a stats row reads them all at once
(the reference's pending_iter_max, cfd_tpu/solver.py:496-499, 536-542);
only the per-kernel solve reads each V-cycle's residual back to the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from cfd_tpu_torch.bc import VelocityBC
from cfd_tpu_torch.convert import natural_converters
from cfd_tpu_torch.grid import Grid
from cfd_tpu_torch.ops.reductions import flow_statistics
from cfd_tpu_torch.ops.stencil import StencilCoeffs, divergence, predictor, pressure_correction
from cfd_tpu_torch.state import State, StepDiagnostics


@dataclasses.dataclass(frozen=True)
class Case:
    """Full static description of a simulation case (cfd_tpu.solver.Case,
    restricted to the fields the ported paths read)."""

    name: str
    grid: Grid
    coeffs: StencilCoeffs
    # "cavity" | "channel" | "rayleigh_benard" (tentative carry only; the
    # step is "channel")
    ordering: str
    velocity_bc: VelocityBC
    poisson_solve: Callable
    remove_source_mean: bool
    ke_divisor: int
    final_time: float
    total_steps: int
    print_interval: int
    save_interval: int
    # (carry stage, corrector) kernels of the quad fast path, where the
    # carried u/v are the TENTATIVE velocities; (predictor+source,
    # corrector) of the natural aligned path; None on the natural step
    step_kernels: Optional[tuple]
    # carried-layout <-> logical-layout converters (init/resume in,
    # stats/export out)
    align_state: Callable
    unalign_state: Callable
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    extrapolate_warm_start: bool = False
    # iteration cap of the pressure solver; a step that hits it logs the
    # reference's non-convergence warning (cavity-01.cpp:681-684)
    poisson_max_iters: Optional[int] = None
    info: Optional[dict] = None
    extra_stats: Optional[Callable] = None  # (logical State) -> dict of 0-d tensors
    initial_state_fn: Optional[Callable] = None  # () -> carried State
    # Adaptive stepping (cfd_tpu_torch.adaptive). The exact controller's
    # builder: () -> (step(state, dt) -> (state, diag, courant_per_dt),
    # to_aligned(logical state), to_logical(state)), dt a 0-d float32 tensor
    # read by the kernels on the card.
    adaptive_impl: Optional[Callable] = None
    # The lagged controller's, on the tentative-carry kernels: () ->
    # (step(state, dts) -> (state, diag, courant_per_dt), to_aligned(logical
    # state, dt), to_logical(state, dt_used)), dts the (2,) tensor (dt_corr,
    # dt_pred), dt a Python float, dt_used a 0-d tensor.
    adaptive_impl_carry: Optional[Callable] = None
    # Diffusivity of the controller's ceiling dt <= 0.25 h^2 / D (default:
    # the viscosity; RB: max(nu, kappa))
    adaptive_diffusivity: Optional[float] = None
    # The whole time step in one kernel (kernels.whole_step), when
    # mg.whole_step is set: (us, vs, p[, p_prev | T]) -> (us', vs'[, T'], p',
    # cycles, res); step_kernels stay for the stats/export boundary and the
    # adaptive builders.
    whole_step_kernel: Optional[Callable] = None
    # The cavity's fused-pre carry (fuse_pre on the per-kernel solve):
    # step_kernels[0] returns (us', vs', b', p1, rc, max|b'|) and
    # poisson_solve is MultigridPoisson.solve_rc(p1, b, rc, max_b)
    carry_fused_pre: bool = False
    # True on the quad paths (the carried u/v are the tentative velocities);
    # False on the natural layout (corrected velocities; the non-carry
    # orderings, cfd_tpu/solver.py:253-340)
    carry_tentative: bool = True

    @property
    def dt(self) -> float:
        return self.coeffs.dt


def natural_adaptive_impl():
    """The exact controller's adaptive_impl on the natural layout: the
    reference falls back to its make_adaptive_step there
    (cfd_tpu/adaptive.py:27-80), which is not ported."""
    raise NotImplementedError("adaptive dt on the natural layout (the reference's "
                              "make_adaptive_step) is not ported yet (ROADMAP.md queue A "
                              "item 6)")


def natural_case(mg, common: dict, info: dict, step_kernels: Optional[tuple],
                 make_solve: Callable[[], Callable]) -> Case:
    """A case on the natural layout, the reference's natural branches
    (cfd_tpu/cases/cavity.py:379-412, channel.py:264-297,
    backwards_step.py:96-108): the corrected velocities are carried; with
    the (predictor+source, corrector) ``step_kernels`` on the aligned carry
    of convert.natural_converters, without them (the step) on the logical
    state itself. whole_solve and whole_step raise the reference's
    ValueError before ``make_solve()`` builds the solve."""
    if mg.whole_solve or mg.whole_step:
        raise ValueError("whole_solve/whole_step require the f32 quad multigrid kernel path")
    if step_kernels is None:
        align_state = unalign_state = lambda st: st
    else:
        align_state, unalign_state = natural_converters(common["grid"].shape)
    return Case(step_kernels=step_kernels, carry_tentative=False, align_state=align_state,
                unalign_state=unalign_state, poisson_solve=make_solve(),
                info=dict(info, mg=mg), adaptive_impl=natural_adaptive_impl, **common)


def remove_mean_quad(b: torch.Tensor, sum_b: torch.Tensor, n_fluid: torch.Tensor,
                     cell: torch.Tensor) -> torch.Tensor:
    """Mean removal over the quad-plane layout (cfd_tpu/solver.py:174-188)
    or the natural one (:276-287): b - sum_b / n_fluid on the cells
    (``cell``: the layout's cell mask, fluid cells only on the step, where b
    is 0 on solid cells and must stay so), b elsewhere. ``n_fluid`` is a 0-d tensor on b's device, so the division is
    a true division on every device (PyTorch turns a Python divisor of a
    CUDA tensor into a reciprocal multiply). Torch glue between the stage
    kernel and the solve."""
    return torch.where(cell, b - sum_b / n_fluid, b)


def read_diagnostics(diags) -> tuple[list[int], list[float]]:
    """Every step's (cycles, res) of ``diags`` (StepDiagnostics) as host
    numbers. The whole-solve and whole-step paths return 0-d tensors; they
    are stacked and read with ONE device-to-host transfer (the residual's
    float32 bits ride beside the int32 cycles). The per-kernel solve's host
    numbers pass through."""
    if not diags:
        return [], []
    if not isinstance(diags[0].poisson_iters, torch.Tensor):
        return ([int(d.poisson_iters) for d in diags],
                [float(d.poisson_residual) for d in diags])
    flat = torch.stack([x for d in diags for x in (
        d.poisson_iters, d.poisson_residual.view(torch.int32))]).cpu().numpy()
    res = np.ascontiguousarray(flat[1::2]).view(np.float32)
    return flat[0::2].tolist(), [float(r) for r in res]


def make_step(case: Case) -> Callable[[State], tuple[State, StepDiagnostics]]:
    """The per-step function of a case: the whole step in one kernel when
    the case has a ``whole_step_kernel``; the natural orderings when it does
    not carry the tentative velocities (_natural_step); else the
    tentative-carry cavity ordering, or the channel ordering with the
    extrapolated warm start (the channel) or with the plain previous-p warm
    start (the step, cfd_tpu/solver.py:241-252); the "rayleigh_benard"
    ordering is the channel's with T carried through the fused kernel, (us,
    vs, p, T[, p_prev]) -> (us', vs', T', b[, guess], sum b). The other
    orderings raise."""
    if case.ordering not in ("cavity", "channel", "rayleigh_benard"):
        raise NotImplementedError(
            f"the {case.ordering!r} ordering is not ported yet "
            "(ROADMAP.md queue A)")
    if case.whole_step_kernel is not None:
        return _whole_step(case)
    if not case.carry_tentative:
        return _natural_step(case)
    fused = case.step_kernels[0]

    if case.ordering == "cavity" and case.carry_fused_pre:

        def step(state: State) -> tuple[State, StepDiagnostics]:
            # the carry and the first cycle's pre-smooth and restriction in
            # one kernel; the solve starts at the coarse stage
            us2, vs2, b, p1, rc, max_b = fused(state.u, state.v, state.p, state.p_prev)
            p, iters, res = case.poisson_solve(p1, b, rc, max_b)
            return State(us2, vs2, p, state.T, state.p), StepDiagnostics(iters, res)

        return step

    if case.ordering == "cavity":

        def step(state: State) -> tuple[State, StepDiagnostics]:
            us2, vs2, b, guess, max_b = fused(state.u, state.v, state.p, state.p_prev)
            p, iters, res = case.poisson_solve(guess, b, max_b)
            return State(us2, vs2, p, state.T, state.p), StepDiagnostics(iters, res)

        return step

    g = case.grid
    if g.has_solids:
        from cfd_tpu_torch.kernels.step_quad import step_cell_mask
        from cfd_tpu_torch.poisson.multigrid import step_rect_params

        cell = step_cell_mask(g.shape, *step_rect_params(g), case.device)
    else:
        from cfd_tpu_torch.kernels.quad import quad_cell_mask

        cell = quad_cell_mask(g.shape, case.device)
    n_fluid = torch.tensor(float(g.n_fluid), dtype=case.dtype, device=case.device)
    with_T = case.ordering == "rayleigh_benard"

    def carry(state: State, *p_prev):
        """(us', vs', T', b, *guess, sum b); T passes through unchanged
        where the case carries no temperature."""
        if with_T:
            return fused(state.u, state.v, state.p, state.T, *p_prev)
        us2, vs2, *rest = fused(state.u, state.v, state.p, *p_prev)
        return (us2, vs2, state.T, *rest)

    if not case.extrapolate_warm_start:

        def step(state: State) -> tuple[State, StepDiagnostics]:
            us2, vs2, T2, b, sum_b = carry(state)
            if case.remove_source_mean:
                b = remove_mean_quad(b, sum_b, n_fluid, cell)
            p, iters, res = case.poisson_solve(state.p, b)
            return State(us2, vs2, p, T2, None), StepDiagnostics(iters, res)

        return step

    def step(state: State) -> tuple[State, StepDiagnostics]:
        us2, vs2, T2, b, guess, sum_b = carry(state, state.p_prev)
        if case.remove_source_mean:
            b = remove_mean_quad(b, sum_b, n_fluid, cell)
        # no max_b: the tolerance base is max|b| after the mean removal
        p, iters, res = case.poisson_solve(guess, b)
        return State(us2, vs2, p, T2, state.p), StepDiagnostics(iters, res)

    return step


def _natural_step(case: Case) -> Callable[[State], tuple[State, StepDiagnostics]]:
    """The orderings of the natural layout, whose carried u/v are the
    corrected velocities.

    * The stage kernels (cfd_tpu/solver.py:253-294), on the aligned carry
      whose p_prev slot holds the next solve's guess 2p - p_prev: the
      cavity's ``pred_src(u, v) -> (us, vs, b, max|b|)``, the solve from
      the guess, ``corr(us, vs, p, p) -> (u2, v2, guess)``; the channel's
      ``pred_src(u, v) -> (us, vs, b, sum b)``, the source mean removal on
      the cells (an iota cell mask and a true division), the solve without
      max_b, the corrector.
    * No stage kernels (the natural step, :318-340): the predictor, the
      velocity ghosts, the source with its fluid mean removed, the solve
      from the previous p (the step's plain warm start), the correction
      with the invalid in-range faces zeroed, the ghosts; torch ops over
      ops.stencil. The source's sum is fixed_order_sum's, so the card and
      the CPU round it alike."""
    from cfd_tpu_torch.kernels.quad import fixed_order_sum

    g, dev = case.grid, case.device
    n_fluid = torch.tensor(float(g.n_fluid), dtype=case.dtype, device=dev)
    if case.step_kernels is not None:
        pred_src, corr = case.step_kernels
        if case.ordering == "cavity":

            def step(state: State) -> tuple[State, StepDiagnostics]:
                us, vs, b, max_b = pred_src(state.u, state.v)
                p, iters, res = case.poisson_solve(state.p_prev, b, max_b)
                u2, v2, guess = corr(us, vs, p, state.p)
                return State(u2, v2, p, state.T, guess), StepDiagnostics(iters, res)

            return step
        H8, W = pred_src.shape
        jj = torch.arange(H8, device=dev)[:, None]
        ii = torch.arange(W, device=dev)[None, :]
        cell = (jj >= 1) & (jj <= g.ny) & (ii >= 1) & (ii <= g.nx)

        def step(state: State) -> tuple[State, StepDiagnostics]:
            us, vs, b, sum_b = pred_src(state.u, state.v)
            if case.remove_source_mean:
                b = remove_mean_quad(b, sum_b, n_fluid, cell)
            p, iters, res = case.poisson_solve(state.p_prev, b)
            u2, v2, guess = corr(us, vs, p, state.p)
            return State(u2, v2, p, state.T, guess), StepDiagnostics(iters, res)

        return step

    if case.ordering != "channel":
        raise NotImplementedError(f"the natural {case.ordering!r} ordering without stage "
                                  "kernels is not ported yet (ROADMAP.md queue A item 6)")
    c, bc = case.coeffs, case.velocity_bc
    t = lambda a: torch.as_tensor(a, device=dev)
    cell, u_valid, v_valid = t(g.cell_mask), t(g.u_valid_mask), t(g.v_valid_mask)
    u_range, v_range = t(g.u_range_mask), t(g.v_range_mask)
    rho_dt = c.density / c.dt

    def step(state: State) -> tuple[State, StepDiagnostics]:
        us, vs = predictor(state.u, state.v, c, u_valid, v_valid)
        us, vs = bc(us, vs)
        b = rho_dt * divergence(us, vs, c, cell)
        if case.remove_source_mean:
            b = remove_mean_quad(b, fixed_order_sum(b), n_fluid, cell)
        p, iters, res = case.poisson_solve(state.p, b)
        z = torch.zeros_like(state.u)
        u2, v2 = pressure_correction(us, vs, p, c, u_valid, v_valid,
                                     u_else=torch.where(u_range, z, state.u),
                                     v_else=torch.where(v_range, z, state.v))
        u2, v2 = bc(u2, v2)
        return State(u2, v2, p, state.T, None), StepDiagnostics(iters, res)

    return step


def _whole_step(case: Case) -> Callable[[State], tuple[State, StepDiagnostics]]:
    """One kernel a step (cfd_tpu/solver.py:193-209): the cavity and the
    channel warm-start from 2p - p_prev computed in the kernel, and the
    p_prev slot keeps carrying the pre-solve p; the step and RB from the
    plain previous p (RB carries T, cfd_tpu/physics/boussinesq.py:326-332)."""
    ws = case.whole_step_kernel
    if case.ordering == "rayleigh_benard":

        def step(state: State) -> tuple[State, StepDiagnostics]:
            us2, vs2, T2, p, iters, res = ws(state.u, state.v, state.p, state.T)
            return State(us2, vs2, p, T2, None), StepDiagnostics(iters, res)

    elif case.ordering == "cavity" or case.extrapolate_warm_start:

        def step(state: State) -> tuple[State, StepDiagnostics]:
            us2, vs2, p, iters, res = ws(state.u, state.v, state.p, state.p_prev)
            return State(us2, vs2, p, state.T, state.p), StepDiagnostics(iters, res)

    else:

        def step(state: State) -> tuple[State, StepDiagnostics]:
            us2, vs2, p, iters, res = ws(state.u, state.v, state.p)
            return State(us2, vs2, p, state.T, None), StepDiagnostics(iters, res)

    return step


class CaseEngine:
    """The case's own single-device step behind the interface Simulation
    drives: ``initial_state``, ``step``, ``is_logical``, ``logical`` and
    ``from_logical``. The sharded engine
    (parallel.quad_sharded.ShardedQuadProjection) is the other one."""

    def __init__(self, case: Case):
        self.case = case
        self.step = make_step(case)

    def initial_state(self) -> State:
        case = self.case
        if case.initial_state_fn is not None:
            return case.initial_state_fn()
        s = State.zeros(case.grid.shape, dtype=case.dtype, device=case.device)
        u, v = case.velocity_bc(s.u, s.v)
        p_prev = s.p if case.extrapolate_warm_start else None
        return case.align_state(State(u, v, s.p, s.T, p_prev))

    def is_logical(self, state: State) -> bool:
        """Whether ``state`` has the logical (ny+2, nx+2) shape; else it is
        the carried one."""
        return tuple(state.u.shape) == self.case.grid.shape

    def logical(self, state: State) -> State:
        return self.case.unalign_state(state)

    def from_logical(self, state: State) -> State:
        return self.case.align_state(state)


class Simulation:
    """Host-side time loop with periodic diagnostics (the reference
    ``run()`` loops, cfd_tpu.solver.Simulation).

    ``mesh`` (a parallel.mesh.Mesh): run the case on the sharded quad path
    (parallel.quad_sharded.ShardedQuadProjection with ``sharded_kwargs``,
    cfd_tpu/solver.py:349-369); the time loop and the stats rows are
    unchanged, the sharded state is gathered to the logical layout at print
    cadence only. The engine's solve takes its own config, with
    tol_factor 1e-9 unless ``sharded_kwargs`` gives one."""

    def __init__(self, case: Case, log=print, mesh=None,
                 sharded_kwargs: Optional[dict] = None):
        self.case = case
        self.log = log
        if mesh is None:
            self._engine = CaseEngine(case)
            self._step = self._engine.step
        else:
            from cfd_tpu_torch.parallel.quad_sharded import ShardedQuadProjection

            engine = self._engine = ShardedQuadProjection(case, mesh,
                                                          **dict(sharded_kwargs or {}))

            def step(state):
                st, d = engine.step(state)
                return st, StepDiagnostics(d["poisson_iters"], d["poisson_residual"])

            self._step = step
        grid = case.grid
        self._cell_mask = torch.as_tensor(grid.cell_mask, device=case.device)
        self.history: list[dict] = []
        # V-cycles of every step run, in order (host ints)
        self.step_iters: list[int] = []
        # dt of every step an adaptive run took (cfd_tpu_torch.adaptive)
        self.step_dts: list[float] = []
        self.blowup_ke_threshold = 1e6

    def initial_state(self) -> State:
        return self._engine.initial_state()

    def _logical(self, state: State) -> State:
        """The carried state in the logical (ny+2, nx+2) layout."""
        return self._engine.logical(state)

    def statistics(self, state: State) -> dict[str, float]:
        """The stats row of a carried state, or of a logical one (the
        adaptive runs hand over their own logical states)."""
        if not self._engine.is_logical(state):
            state = self._engine.logical(state)
        vals = flow_statistics(state.u, state.v, self.case.coeffs, self._cell_mask,
                               self.case.ke_divisor)
        if self.case.extra_stats is not None:
            vals.update(self.case.extra_stats(state))
        keys = list(vals)
        # one device->host transfer for the whole row
        flat = torch.stack([vals[k].to(torch.float32) for k in keys]).cpu()
        return dict(zip(keys, map(float, flat)))

    def run(self, state: Optional[State] = None, n_steps: Optional[int] = None,
            start_step: int = 0, steps_per_call: int = 1) -> State:
        """Advance ``n_steps`` (default: to ``total_steps``), printing a stats
        row every ``print_interval`` steps and at the end. ``steps_per_call``
        keeps the reference's chunk contract (cfd_tpu/solver.py:466-474): it
        must divide the print and the save interval, and rows come at chunk
        ends. Eager PyTorch has no per-dispatch cost to amortize, so it
        changes nothing else. Every step's (cycles, res) waits on the device
        until the next row reads them all with one transfer; that read fills
        ``step_iters`` and drives the non-convergence warning."""
        case = self.case
        for name, iv in (("print", case.print_interval), ("save", case.save_interval)):
            if iv % steps_per_call:
                raise ValueError(f"steps_per_call={steps_per_call} must divide the "
                                 f"{name} interval ({iv})")
        if state is None:
            state = self.initial_state()
        elif self._engine.is_logical(state):
            state = self._engine.from_logical(state)  # resumed in the logical layout
        n = case.total_steps if n_steps is None else start_step + n_steps
        n_cells = case.grid.n_fluid
        t_wall0 = time.perf_counter()
        prev_k, prev_wall = start_step, t_wall0
        cap = case.poisson_max_iters
        pending: list[StepDiagnostics] = []  # the steps since the last row

        def after_step(k: int, state: State) -> None:
            nonlocal prev_k, prev_wall
            t = k * case.dt
            if k % case.print_interval == 0 or k == n:
                iters, residuals = read_diagnostics(pending)
                pending.clear()
                self.step_iters.extend(iters)
                now = time.perf_counter()
                row = self.statistics(state)
                interval_wall = max(now - prev_wall, 1e-12)
                row.update(
                    step=k, time=t,
                    poisson_iters=iters[-1],
                    poisson_residual=residuals[-1],
                    wall_seconds=now - t_wall0,
                    cell_updates_per_sec=n_cells * (k - prev_k) / interval_wall,
                )
                prev_k, prev_wall = k, now
                self.history.append(row)
                ke = row["avg_kinetic_energy"]
                if not (ke == ke) or ke > self.blowup_ke_threshold:  # NaN or blowup
                    raise RuntimeError(
                        f"solver diverged at step {k}: avg_KE={ke} "
                        f"(max_div={row['max_divergence']}, "
                        f"poisson_residual={row['poisson_residual']}); "
                        "reduce dt/CFL or check boundary conditions")
                self.log(
                    f"Step {k:6d}/{case.total_steps} | t={t:8.3f}"
                    f" | max(div)={row['max_divergence']:10.2e}"
                    f" | avg_KE={row['avg_kinetic_energy']:10.6f}"
                    f" | PPE iters={row['poisson_iters']:4d}"
                    f" | res={row['poisson_residual']:10.2e}"
                )
                if cap is not None and max(iters) >= cap:
                    self.log(
                        f"Warning: SOR solver did not converge in {cap} "
                        f"iterations. Final residual: "
                        f"{row['poisson_residual']:.6e}")

        # rows come at chunk ends, then after each step of the tail that
        # the chunk size does not divide (the reference's bookkeeping)
        main_end = start_step + ((n - start_step) // steps_per_call) * steps_per_call
        for k in range(start_step + 1, n + 1):
            state, diag = self._step(state)
            pending.append(diag)
            if k > main_end or (k - start_step) % steps_per_call == 0:
                after_step(k, state)
        return state
