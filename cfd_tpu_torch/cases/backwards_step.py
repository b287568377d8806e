"""Backward-facing step case (the port of cfd_tpu.cases.backwards_step).

Reference: BackwardsStepSolver (backwards_step-01.cpp:316-1061). Geometry:
the solid block {i <= step_i and j > inlet_j_max}
(backwards_step-01.cpp:499-520) on a masked grid.

Ported: the float32 multigrid branch on the quad layout
(cfd_tpu/cases/backwards_step.py:116-276) — the tentative-carry masked
stage kernel with the fluid-only source mean removal, the masked corrector
at the stats/export boundary, V(1,2) unless the overrides name the sweeps,
the plain previous-p warm start, and the reference's auto_whole_solve rule
with "device is cuda" in place of "platform is tpu": the masked
whole-solve (one kernel launch per pressure solve) on the card, the
per-kernel defect-correction solve on the CPU, and manual control when
mg_overrides names a fusion knob; the whole time step in one kernel under
``mg_overrides={"whole_step": True}`` (kernels.whole_step,
cfd_tpu/cases/backwards_step.py:182-190); the lagged adaptive controller's
``adaptive_impl_carry`` (cfd_tpu/cases/backwards_step.py:227-276). The
multigrid knobs: ``tail_from`` (the per-kernel solve's fused coarse tail),
``corr_opt`` (every solve; not a manual knob, so the card keeps its
whole-solve with the steplength in the kernel) and
``coarse_dtype="bfloat16"`` with whole_solve or whole_step (the per-kernel
masked hierarchy refuses it, as the reference's does; under whole_step the
case's own solve is then the bf16 whole-solve).

The natural layout, which the reference takes wherever the quad layout
does not exist (the aligned level-1 shape differs from the quad plane
shape, e.g. ny = 14 or 30: cfd_tpu/cases/backwards_step.py:134-153
falling through to :96-108): the logical (ny+2, nx+2) state, the channel
ordering over the stencil ops (solver._natural_step) and the natural
masked solve (poisson.multigrid.MaskedMultigridPoisson, the exact finest
level of kernels.step_smoother, row 12) with the MGConfig defaults, V(2,2),
as the reference's natural branch keeps them. ``layout="aligned"`` raises
the reference's ValueError (:277-281), whole_solve and whole_step off the
quad path its ValueError (:282-289), adaptive dt NotImplementedError (the
exact controller, the reference's make_adaptive_step, ROADMAP.md queue A
item 6) or the reference's ValueError (the lagged one). Everything else
(SOR, float64) raises NotImplementedError rather than being ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cfd_tpu_torch.bc import step_bc
from cfd_tpu_torch.cases.channel import _not_ported
from cfd_tpu_torch.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu_torch.kernels.quad import from_quad, quad_dims, to_quad
from cfd_tpu_torch.kernels.step_quad import (
    make_quad_step_corr_predictor_source,
    make_quad_step_corrector,
    step_cell_mask,
    uncorrect_step_quad,
)
from cfd_tpu_torch.kernels.whole_solve import auto_whole_solve, make_quad_step_whole_solve
from cfd_tpu_torch.kernels.whole_step import make_quad_whole_step_step
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.params import check_cfl, validate_case_params
from cfd_tpu_torch.poisson.multigrid import (
    MGConfig,
    _round_up8_128,
    make_masked_multigrid_poisson,
    make_masked_quad_multigrid_poisson,
    mg_compatible,
    step_rect_params,
)
from cfd_tpu_torch.precision import as_dtype
from cfd_tpu_torch.solver import Case, natural_case, remove_mean_quad
from cfd_tpu_torch.state import State, StepDiagnostics


def make_backwards_step_case(
    nx: int = 256,
    ny: int = 32,
    length: float = 8.0,
    height_inlet: float = 1.0,
    height_total: float = 2.0,
    step_location: float = 2.0,
    reynolds_number: float = 100.0,
    inlet_velocity: float = 1.0,
    density: float = 1.0,
    cfl: float = 0.2,
    final_time: float = 15.0,
    tolerance_factor: float = 1e-7,
    abs_tol: float = 1e-10,
    max_sor_iterations: int = 10000,
    print_interval: int = 10,
    save_interval: int = 10,
    dt: float | None = None,
    poisson: str = "auto",  # "auto" | "multigrid" ("sor" is not ported)
    dtype=torch.float64,
    layout: str = "auto",  # "auto" | "quad"
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
        save_interval=save_interval, length=length, height_inlet=height_inlet,
        height_total=height_total, step_location=step_location,
        inlet_velocity=inlet_velocity)
    # geometry bounds (backwards_step-01.cpp:455-461)
    if not height_inlet < height_total:
        raise ValueError(f"height_inlet ({height_inlet}) must be < height_total "
                         f"({height_total})")
    if not step_location < length:
        raise ValueError(f"step_location ({step_location}) must be < length ({length})")
    dx = length / nx
    dy = height_total / ny
    step_i = int(step_location / dx)  # backwards_step-01.cpp:387
    inlet_j_max = int(height_inlet / dy)  # backwards_step-01.cpp:493
    # fluid raster (backwards_step-01.cpp:508-520): before the step only the
    # inlet rows are fluid, after it the full height
    jj = np.arange(1, ny + 1)[:, None]
    ii = np.arange(1, nx + 1)[None, :]
    fluid = np.broadcast_to(np.where(ii <= step_i, jj <= inlet_j_max, True), (ny, nx))
    grid = Grid.masked(nx, ny, length, height_total, np.ascontiguousarray(fluid))
    viscosity = inlet_velocity * height_inlet / reynolds_number  # backwards_step-01.cpp:379
    if dt is None:
        dt = cfl_time_step(dx, dy, viscosity, inlet_velocity, cfl)
    else:
        check_cfl(dt, dx, dy, viscosity, abs(inlet_velocity))
    coeffs = StencilCoeffs(dx=dx, dy=dy, dt=dt, viscosity=viscosity, density=density)
    omega = optimal_omega(nx, ny)
    if poisson == "auto":
        poisson = "multigrid" if mg_compatible(nx, ny) and max(nx, ny) >= 128 else "sor"
    if poisson == "sor":
        raise _not_ported("the SOR pressure solver", "ROADMAP.md queue A item 6")
    if poisson != "multigrid":
        raise ValueError(f"unknown poisson solver: {poisson}")
    if dtype != torch.float32:
        raise _not_ported("the float64 masked multigrid path", "ROADMAP.md queue A item 6")
    if layout not in ("auto", "quad"):
        # the reference's refusal (cfd_tpu/cases/backwards_step.py:277-281)
        raise ValueError(f"layout={layout!r} requires the f32 multigrid kernel path "
                         "(dtype=float32, poisson='multigrid', TPU platform or "
                         "smoother_mode='interpret')")
    rect = step_rect_params(grid)
    coarse_shape = _round_up8_128((ny // 2 + 2, nx // 2 + 2))
    _, _, Hq8, Wqa = quad_dims(grid.shape)
    use_quad = rect is not None and coarse_shape == (Hq8, Wqa)
    if layout == "quad" and not use_quad:
        raise ValueError(f"quad layout unavailable: rect={rect}, coarse shape "
                         f"{coarse_shape} vs quad plane shape {(Hq8, Wqa)}")

    mg = MGConfig(tol_factor=tolerance_factor, abs_tol=abs_tol)
    if mg_overrides:
        mg = dataclasses.replace(mg, **mg_overrides)
    common = dict(
        name="backwards_step", poisson_max_iters=mg.max_cycles, extrapolate_warm_start=False,
        grid=grid, coeffs=coeffs, ordering="channel",
        velocity_bc=step_bc(grid, inlet_velocity, inlet_j_max), remove_source_mean=True,
        ke_divisor=grid.n_fluid,  # backwards_step-01.cpp:1055
        final_time=final_time, total_steps=int(final_time / dt),
        print_interval=print_interval, save_interval=save_interval, dtype=dtype,
        device=device)
    info = dict(banner_title="Backwards Step Flow Simulation", length=length,
                height=height_total, step_height=height_total - height_inlet,
                step_location=step_location, reynolds=reynolds_number, cfl=cfl,
                omega=omega, inlet_velocity=inlet_velocity)
    if not use_quad:
        # the natural masked path, with the MGConfig defaults
        # (cfd_tpu/cases/backwards_step.py:96-108)
        return natural_case(mg, common, info, None,
                            lambda: make_masked_multigrid_poisson(grid, coeffs, mg,
                                                                  device=device))
    step_i, inlet_j = rect
    # V(1,2) unless overridden (cfd_tpu/cases/backwards_step.py:162-171)
    if not (mg_overrides and ("post_sweeps" in mg_overrides
                              or "pre_sweeps" in mg_overrides)):
        mg = dataclasses.replace(mg, pre_sweeps=1, post_sweeps=2)

    corr = make_quad_step_corrector(grid.shape, coeffs, step_i, inlet_j, inlet_velocity)
    carry = make_quad_step_corr_predictor_source(grid.shape, coeffs, step_i, inlet_j,
                                                 inlet_velocity)
    def per_kernel():
        if mg.whole_step and mg.coarse_dtype is not None:
            # the per-kernel masked hierarchy takes no bf16: the whole step's
            # own solve serves the paths outside it
            return make_quad_step_whole_solve(grid, coeffs, mg, device=device)
        return make_masked_quad_multigrid_poisson(grid, coeffs, mg, device=device)

    solve, mg = auto_whole_solve(
        mg, mg_overrides, device.type == "cuda",
        build=lambda: make_quad_step_whole_solve(grid, coeffs, mg, device=device),
        fallback=per_kernel)
    whole_step = (make_quad_whole_step_step(grid, coeffs, mg, step_i, inlet_j, inlet_velocity,
                                            device=device) if mg.whole_step else None)

    # Tentative-state boundary converters with the masked, rho-divided
    # correction; no p_prev (the plain previous-p warm start)
    def align_state(state: State) -> State:
        us, vs = uncorrect_step_quad(state.u, state.v, state.p, grid.shape, coeffs,
                                     step_i, inlet_j)
        t = lambda a: to_quad(a, grid.shape)
        return State(t(us), t(vs), t(state.p), state.T, None)

    def unalign_state(state: State) -> State:
        u2, v2 = corr(state.u, state.v, state.p)
        f = lambda a: from_quad(a, grid.shape)
        return State(f(u2), f(v2), f(state.p), state.T, None)

    def adaptive_impl_carry():
        """The lagged controller's step: the traced-dt + Courant masked
        carry, the fluid-only mean removal, the solve from plain p."""
        fused_a = make_quad_step_corr_predictor_source(grid.shape, coeffs, step_i, inlet_j,
                                                       inlet_velocity, adaptive=True)
        corr_a = make_quad_step_corrector(grid.shape, coeffs, step_i, inlet_j,
                                          inlet_velocity, traced_dt=True)
        idx_, idy_ = 1.0 / grid.dx, 1.0 / grid.dy
        cell = step_cell_mask(grid.shape, step_i, inlet_j, device)
        n_fluid = torch.tensor(float(grid.n_fluid), dtype=torch.float32, device=device)

        def step(state: State, dts):
            us2, vs2, b, sum_b, mu, mv = fused_a(dts, state.u, state.v, state.p)
            p, iters, res = solve(state.p, remove_mean_quad(b, sum_b, n_fluid, cell))
            return (State(us2, vs2, p, state.T, None), StepDiagnostics(iters, res),
                    mu * idx_ + mv * idy_)

        def to_aligned(st: State, dt: float) -> State:
            us, vs = uncorrect_step_quad(st.u, st.v, st.p, grid.shape, coeffs, step_i,
                                         inlet_j, dt=dt)
            t = lambda a: to_quad(a, grid.shape)
            return State(t(us), t(vs), t(st.p), st.T, None)

        def to_logical(st: State, dt_used) -> State:
            u2, v2 = corr_a(dt_used, st.u, st.v, st.p)
            f = lambda a: from_quad(a, grid.shape)
            return State(f(u2), f(v2), f(st.p), st.T, None)

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
