"""Channel (Poiseuille start-up) case (the port of cfd_tpu.cases.channel).

Reference: ChannelSolver (channel-01.cpp:283-770). Defaults reproduce
channel-01.cpp:286-303 with derived quantities per channel-01.cpp:336-344.

Ported: the float32 multigrid branch on the quad layout — the
tentative-carry channel stage kernel with the source mean removal, the
channel corrector at the stats/export boundary, V(1,2) unless the overrides
name the sweeps (cfd_tpu/cases/channel.py:125-127), the extrapolated warm
start, and the reference's auto_whole_solve rule with "device is cuda" in
place of "platform is tpu": the whole solve in one kernel launch
(kernels.whole_solve) on the card, the per-kernel composition on the CPU,
and manual control when mg_overrides names a fusion knob; the whole time
step in one kernel under ``mg_overrides={"whole_step": True}``
(kernels.whole_step, cfd_tpu/cases/channel.py:170-176); the lagged
adaptive controller's ``adaptive_impl_carry`` (cfd_tpu/cases/channel.py:
212-263). The multigrid knobs ``tail_from`` and ``coarse_dtype="bfloat16"``
(with whole_solve or whole_step) are manual; ``corr_opt`` raises the
reference's ValueError.

The natural aligned layout (cfd_tpu/cases/channel.py:264-297), under
``layout="aligned"`` and by the auto rule wherever the quad layout does not
exist (ny or nx = 14 mod 16 and the like, where the aligned level-1 shape
differs from the quad plane shape): the natural channel stage kernels
(kernels.projection), the source mean removal, the aligned solve
(MultigridPoisson without quad_level0) and the non-carry ordering
(solver._natural_step), with the cavity's converters
(convert.natural_converters). whole_solve and whole_step off the quad path
raise the reference's ValueError; adaptive dt raises (the exact controller
NotImplementedError, ROADMAP.md queue A item 6; the lagged one the
reference's ValueError). Everything else raises NotImplementedError rather
than being ignored.
"""

from __future__ import annotations

import dataclasses

import torch

from cfd_tpu_torch.bc import channel_bc
from cfd_tpu_torch.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu_torch.kernels.projection import (
    make_channel_corrector,
    make_channel_predictor_source,
)
from cfd_tpu_torch.kernels.quad import (
    from_quad,
    make_quad_channel_corr_predictor_source,
    make_quad_channel_corrector,
    make_quad_post_prolong_smooth,
    make_quad_pre_smooth_restrict,
    quad_cell_mask,
    quad_dims,
    to_quad,
    uncorrect_quad,
)
from cfd_tpu_torch.kernels.whole_solve import auto_whole_solve, make_quad_whole_solve
from cfd_tpu_torch.kernels.whole_step import make_quad_whole_step_channel
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.params import check_cfl, validate_case_params
from cfd_tpu_torch.poisson.multigrid import (
    MGConfig,
    _round_up8_128,
    channel_problem,
    make_multigrid_poisson,
    mg_compatible,
)
from cfd_tpu_torch.precision import as_dtype
from cfd_tpu_torch.solver import Case, natural_case, remove_mean_quad
from cfd_tpu_torch.state import State, StepDiagnostics


def _not_ported(what: str, where: str):
    return NotImplementedError(f"{what} is not ported yet ({where})")


def make_channel_case(
    nx: int = 93,
    ny: int = 31,
    length: float = 3.0,
    height: float = 1.0,
    reynolds_number: float = 100.0,
    inlet_velocity: float = 1.0,
    density: float = 1.0,
    cfl: float = 0.25,
    final_time: float = 10.0,
    tolerance_factor: float = 1e-7,
    abs_tol: float = 1e-10,
    max_sor_iterations: int = 10000,
    print_interval: int = 100,
    save_interval: int = 100,
    dt: float | None = None,
    poisson: str = "auto",  # "auto" | "multigrid" ("sor" is not ported)
    dtype=torch.float64,
    layout: str = "auto",  # "auto" | "quad" | "aligned"
    mg_overrides: dict | None = None,  # MGConfig field overrides
    device="cuda",  # "cpu" runs the kernels' plain PyTorch twins
) -> Case:
    dtype = as_dtype(dtype)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the kernels' plain PyTorch twins on the CPU")
    validate_case_params(
        reynolds_number=reynolds_number, density=density, cfl=cfl,
        final_time=final_time, tolerance_factor=tolerance_factor, dt=dt,
        max_iterations=max_sor_iterations, print_interval=print_interval,
        save_interval=save_interval, length=length, height=height,
        inlet_velocity=inlet_velocity)
    grid = Grid.regular(nx, ny, length, height)
    # nu = U*H/Re (channel-01.cpp:337)
    viscosity = inlet_velocity * height / reynolds_number
    if dt is None:
        dt = cfl_time_step(grid.dx, grid.dy, viscosity, inlet_velocity, cfl)
    else:
        check_cfl(dt, grid.dx, grid.dy, viscosity, abs(inlet_velocity))
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=viscosity,
                           density=density)
    omega = optimal_omega(nx, ny)
    if poisson == "auto":
        poisson = "multigrid" if mg_compatible(nx, ny) and max(nx, ny) >= 128 else "sor"
    if poisson == "sor":
        raise _not_ported("the SOR pressure solver", "ROADMAP.md queue A item 6")
    if poisson != "multigrid":
        raise ValueError(f"unknown poisson solver: {poisson}")
    if dtype != torch.float32:
        raise _not_ported("the float64 multigrid path", "ROADMAP.md queue A item 3")
    if layout not in ("auto", "quad", "aligned"):
        raise ValueError(f"unknown layout {layout!r} (auto, quad or aligned)")
    coarse_shape = _round_up8_128((ny // 2 + 2, nx // 2 + 2))
    _, _, Hq8, Wqa = quad_dims(grid.shape)
    use_quad = layout in ("auto", "quad") and coarse_shape == (Hq8, Wqa)
    if layout == "quad" and not use_quad:
        raise ValueError(f"quad layout unavailable: coarse shape {coarse_shape} != "
                         f"quad plane shape {(Hq8, Wqa)}")

    mg = MGConfig(tol_factor=tolerance_factor, abs_tol=abs_tol)
    if mg_overrides:
        mg = dataclasses.replace(mg, **mg_overrides)
    # f32 perf path: V(1,2) (cfd_tpu/cases/channel.py:112-127)
    if not (mg_overrides and ("post_sweeps" in mg_overrides
                              or "pre_sweeps" in mg_overrides)):
        mg = dataclasses.replace(mg, pre_sweeps=1, post_sweeps=2)
    problem = channel_problem(nx, ny, grid.dx, grid.dy)
    common = dict(
        name="channel", poisson_max_iters=mg.max_cycles, extrapolate_warm_start=True,
        grid=grid, coeffs=coeffs, ordering="channel",
        velocity_bc=channel_bc(grid, inlet_velocity), remove_source_mean=True,
        ke_divisor=nx * ny, final_time=final_time, total_steps=int(final_time / dt),
        print_interval=print_interval, save_interval=save_interval, dtype=dtype,
        device=device)
    info = dict(banner_title="Channel Flow Simulation", length=length, height=height,
                reynolds=reynolds_number, cfl=cfl, omega=omega,
                inlet_velocity=inlet_velocity, mg=mg)
    if not use_quad:
        return natural_case(mg, common, info,
                            (make_channel_predictor_source(grid.shape, coeffs, inlet_velocity),
                             make_channel_corrector(grid.shape, coeffs, inlet_velocity)),
                            lambda: make_multigrid_poisson(problem, mg, device=device))

    corr = make_quad_channel_corrector(grid.shape, coeffs, inlet_velocity)
    carry = make_quad_channel_corr_predictor_source(grid.shape, coeffs, inlet_velocity)

    def per_kernel():
        quad_l0 = (
            make_quad_pre_smooth_restrict(grid.shape, problem, mg.omega, mg.pre_sweeps,
                                          coarse_shape, device=device),
            make_quad_post_prolong_smooth(grid.shape, problem, mg.omega, mg.post_sweeps,
                                          coarse_shape, device=device),
        )
        return make_multigrid_poisson(problem, mg, quad_l0, device=device)

    solve, mg = auto_whole_solve(
        mg, mg_overrides, device.type == "cuda",
        build=lambda: make_quad_whole_solve(grid.shape, problem, mg, device=device),
        fallback=per_kernel)
    whole_step = (make_quad_whole_step_channel(grid.shape, problem, coeffs, mg, nx * ny,
                                               inlet_velocity, device=device)
                  if mg.whole_step else None)

    # Tentative-state boundary converters (see the cavity factory), with the
    # rho-divided channel correction
    def align_state(state: State) -> State:
        us, vs = uncorrect_quad(state.u, state.v, state.p, grid.shape, coeffs,
                                cavity_form=False)
        t = lambda a: to_quad(a, grid.shape)
        p_prev = state.p if state.p_prev is None else state.p_prev
        return State(t(us), t(vs), t(state.p), state.T, t(p_prev))

    def unalign_state(state: State) -> State:
        u2, v2, _ = corr(state.u, state.v, state.p, state.p)
        f = lambda a: from_quad(a, grid.shape)
        return State(f(u2), f(v2), f(state.p), state.T,
                     None if state.p_prev is None else f(state.p_prev))

    def adaptive_impl_carry():
        """The lagged controller's step: the traced-dt + Courant channel
        carry, the source mean removal, the solve from the guess."""
        fused_a = make_quad_channel_corr_predictor_source(grid.shape, coeffs,
                                                          inlet_velocity, adaptive=True)
        corr_a = make_quad_channel_corrector(grid.shape, coeffs, inlet_velocity,
                                             traced_dt=True)
        idx_, idy_ = 1.0 / grid.dx, 1.0 / grid.dy
        cell = quad_cell_mask(grid.shape, device)
        n_cells = torch.tensor(float(nx * ny), dtype=torch.float32, device=device)

        def step(state: State, dts):
            us2, vs2, b, guess, sum_b, mu, mv = fused_a(dts, state.u, state.v, state.p,
                                                        state.p_prev)
            p, iters, res = solve(guess, remove_mean_quad(b, sum_b, n_cells, cell))
            return (State(us2, vs2, p, state.T, state.p), StepDiagnostics(iters, res),
                    mu * idx_ + mv * idy_)

        def to_aligned(st: State, dt: float) -> State:
            us, vs = uncorrect_quad(st.u, st.v, st.p, grid.shape, coeffs,
                                    cavity_form=False, dt=dt)
            t = lambda a: to_quad(a, grid.shape)
            p_prev = st.p if st.p_prev is None else st.p_prev
            return State(t(us), t(vs), t(st.p), st.T, t(p_prev))

        def to_logical(st: State, dt_used) -> State:
            u2, v2, _ = corr_a(dt_used, st.u, st.v, st.p, st.p)
            f = lambda a: from_quad(a, grid.shape)
            return State(f(u2), f(v2), f(st.p), st.T,
                         None if st.p_prev is None else f(st.p_prev))

        return step, to_aligned, to_logical

    return Case(
        step_kernels=(carry, corr),
        align_state=align_state,
        unalign_state=unalign_state,
        poisson_solve=solve,
        info=dict(info, mg=mg),
        adaptive_impl_carry=adaptive_impl_carry,
        whole_step_kernel=whole_step,
        **common,
    )
