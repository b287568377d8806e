"""Rayleigh-Benard convection: Boussinesq momentum + temperature transport
(the port of cfd_tpu.physics.boussinesq).

Free-fall units: lengths by the layer height H, velocity by
U_ff = sqrt(g alpha dT H), time by H/U_ff, so

    du/dt + div(u u) = -grad p + sqrt(Pr/Ra) lap(u)
    dv/dt + div(u v) = -grad p + sqrt(Pr/Ra) lap(v) + T
    dT/dt + div(u T) =           1/sqrt(Ra Pr) lap(T)

with T = 1 at the bottom wall, T = 0 at the top, adiabatic no-slip side
walls, and a pure-Neumann pressure problem: a mean-removed source and the
mean-pinned multigrid solve.

Ported: the float32 quad branch of make_rayleigh_benard_case
(cfd_tpu/physics/boussinesq.py:257-411) — the fused tentative-carry stage
(kernels.rb_quad) with the source mean removal, V(2,1) unless the overrides
name post_sweeps, the plain previous-p warm start (or, with
``extrapolate_warm_start``, 2 p - p_prev from the carry), the RB corrector at
the stats/export boundary, and the reference's auto_whole_solve rule with
"device is cuda" in place of "platform is tpu": the pin-mean whole-solve
(one launch per pressure solve) on the card, the per-kernel pin-mean solve
on the CPU. The stats rows carry the Nusselt numbers. The lagged adaptive
controller's ``adaptive_impl_carry`` and ``adaptive_diffusivity`` =
max(nu, kappa) (cfd_tpu/physics/boussinesq.py:372-411, :498). The whole
time step in one kernel under ``mg_overrides={"whole_step": True}``
(kernels.whole_step; with ``extrapolate_warm_start`` it raises the
reference's ValueError, boussinesq.py:311-316). The multigrid knobs
``tail_from`` (the tail under the per-cycle mean pin) and
``coarse_dtype="bfloat16"`` (with whole_solve or whole_step: the pin-mean
whole-solve's bf16 rounding) are manual; ``corr_opt`` raises the
reference's ValueError. The natural-layout XLA step, float64 and other
layouts raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cfd_tpu_torch.grid import Grid
from cfd_tpu_torch.kernels.quad import (
    from_quad,
    make_quad_post_prolong_smooth,
    make_quad_pre_smooth_restrict,
    quad_cell_mask,
    quad_dims,
    to_quad,
)
from cfd_tpu_torch.kernels.rb_quad import (
    make_quad_rb_corrector,
    make_quad_rb_step_kernel,
    uncorrect_rb_quad,
)
from cfd_tpu_torch.kernels.whole_solve import auto_whole_solve, make_quad_whole_solve
from cfd_tpu_torch.kernels.whole_step import make_quad_whole_step_rb
from cfd_tpu_torch.ops.random import uniform
from cfd_tpu_torch.ops.stencil import StencilCoeffs, _sh
from cfd_tpu_torch.params import validate_case_params
from cfd_tpu_torch.poisson.multigrid import (
    MGConfig,
    _round_up8_128,
    make_multigrid_poisson,
    mg_compatible,
    neumann_problem,
)
from cfd_tpu_torch.precision import as_dtype
from cfd_tpu_torch.solver import Case, remove_mean_quad
from cfd_tpu_torch.state import State, StepDiagnostics


def _not_ported(what: str, where: str):
    return NotImplementedError(f"{what} is not ported yet ({where})")


def box_noslip_bc(grid: Grid):
    """No-slip on all four walls: wall-normal faces stay 0, tangential
    ghosts antisymmetric, in the reference's update order. Returns new
    tensors; the inputs are not modified."""
    nx, ny = grid.nx, grid.ny

    def bc(u, v):
        u, v = u.clone(), v.clone()
        u[0, 0 : nx + 1] = -u[1, 0 : nx + 1]
        u[ny + 1, 0 : nx + 1] = -u[ny, 0 : nx + 1]
        u[1 : ny + 1, 0] = 0.0
        u[1 : ny + 1, nx] = 0.0
        v[0 : ny + 1, 0] = -v[0 : ny + 1, 1]
        v[0 : ny + 1, nx + 1] = -v[0 : ny + 1, nx]
        v[0, 1 : nx + 1] = 0.0
        v[ny, 1 : nx + 1] = 0.0
        return u, v

    return bc


def temperature_bc(grid: Grid, t_bottom: float = 1.0, t_top: float = 0.0):
    """Dirichlet bottom/top via ghost reflection, adiabatic (Neumann) sides;
    the corners keep their value."""
    nx, ny = grid.nx, grid.ny

    def bc(T):
        T = T.clone()
        T[0, 1 : nx + 1] = 2.0 * t_bottom - T[1, 1 : nx + 1]
        T[ny + 1, 1 : nx + 1] = 2.0 * t_top - T[ny, 1 : nx + 1]
        T[1 : ny + 1, 0] = T[1 : ny + 1, 1]
        T[1 : ny + 1, nx + 1] = T[1 : ny + 1, nx]
        return T

    return bc


def advect_diffuse_scalar(T, u, v, c: StencilCoeffs, kappa: float, cell_mask):
    """Flux-form central advection + central diffusion + forward Euler for a
    cell-centred scalar, the momentum scheme's structure applied to T on the
    MAC grid; T unchanged off ``cell_mask``."""
    TE, TW = _sh(T, 0, 1), _sh(T, 0, -1)
    TN, TS = _sh(T, 1, 0), _sh(T, -1, 0)
    # face fluxes: u[j,i] carries 0.5*(T[j,i]+T[j,i+1]) across the east face
    flux_e = u * 0.5 * (T + TE)
    flux_n = v * 0.5 * (T + TN)
    adv = (flux_e - _sh(flux_e, 0, -1)) * c.idx + (flux_n - _sh(flux_n, -1, 0)) * c.idy
    lap = (TE - 2.0 * T + TW) * c.idx2 + (TN - 2.0 * T + TS) * c.idy2
    T_new = T + c.dt * (kappa * lap - adv)
    return torch.where(cell_mask, T_new, T)


@dataclasses.dataclass(frozen=True)
class RBParams:
    rayleigh: float
    prandtl: float
    t_bottom: float = 1.0
    t_top: float = 0.0


def _cell_mask(grid: Grid, device) -> torch.Tensor:
    return torch.as_tensor(grid.cell_mask, device=device)


def nusselt_numbers(state: State, grid: Grid, params: RBParams,
                    kappa: float = 1.0) -> dict:
    """Heat-transport diagnostics as 0-d tensors: the wall Nusselt numbers
    from one-sided gradients (the ghosts encode the wall values), the
    volume-averaged convective Nu = 1 + <v T>/kappa, and the interior
    temperature extremes."""
    T = state.T
    ny, dy = grid.ny, grid.dy
    dT = params.t_bottom - params.t_top
    nu_bottom = -torch.mean((T[1, 1:-1] - T[0, 1:-1]) / dy) / dT
    nu_top = -torch.mean((T[ny + 1, 1:-1] - T[ny, 1:-1]) / dy) / dT
    vc = 0.5 * (state.v + _sh(state.v, -1, 0))
    cell = _cell_mask(grid, T.device)
    vt = torch.sum(torch.where(cell, vc * T, torch.zeros_like(T))) / (grid.nx * ny)
    return {
        "nusselt_bottom": nu_bottom,
        "nusselt_top": nu_top,
        "nusselt_volume": 1.0 + vt / (kappa * dT),
        "temperature_min": torch.min(torch.where(cell, T, torch.full_like(T, params.t_bottom))),
        "temperature_max": torch.max(torch.where(cell, T, torch.full_like(T, params.t_top))),
    }


def streamfunction(u: torch.Tensor, grid: Grid) -> torch.Tensor:
    """psi at cell centres from psi(y) = the integral of u dy per column,
    psi = 0 at the bottom wall (a visualization diagnostic)."""
    ny, nx = grid.ny, grid.nx
    uc = 0.5 * (u + _sh(u, 0, -1))
    interior = uc[1 : ny + 1, 1 : nx + 1]
    psi = torch.cumsum(interior, dim=0) * grid.dy - 0.5 * grid.dy * interior
    out = torch.zeros_like(u)
    out[1 : ny + 1, 1 : nx + 1] = psi
    return out


def make_rayleigh_benard_case(
    nx: int = 192,
    ny: int = 64,
    aspect: float = 3.0,
    rayleigh: float = 1e6,
    prandtl: float = 0.71,
    cfl: float = 0.4,
    final_time: float = 100.0,
    dt: float | None = None,
    tolerance_factor: float = 1e-7,
    abs_tol: float = 1e-10,
    print_interval: int = 100,
    save_interval: int = 100,
    perturbation: float = 1e-2,
    seed: int = 0,
    dtype=torch.float32,
    layout: str = "auto",  # "auto" | "quad"
    mg_overrides: dict | None = None,  # MGConfig field overrides
    extrapolate_warm_start: bool = False,
    device="cuda",  # "cpu" runs the kernels' plain PyTorch twins
) -> Case:
    """Heated-bottom / cooled-top convection at the reference's defaults
    (192x64, Ra = 1e6, Pr = 0.71); ``extrapolate_warm_start`` warm-starts
    each solve from 2 p_n - p_{n-1} instead of plain p_n (the reference
    keeps plain p as its default)."""
    dtype = as_dtype(dtype)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the kernels' plain PyTorch twins on the CPU")
    validate_case_params(
        cfl=cfl, final_time=final_time, tolerance_factor=tolerance_factor,
        dt=dt, print_interval=print_interval, save_interval=save_interval,
        rayleigh=rayleigh, prandtl=prandtl, aspect=aspect)
    grid = Grid.regular(nx, ny, aspect, 1.0)
    params = RBParams(rayleigh=rayleigh, prandtl=prandtl)
    # free-fall-unit transport coefficients
    nu = float(np.sqrt(prandtl / rayleigh))
    kappa = float(1.0 / np.sqrt(rayleigh * prandtl))
    # dt: the diffusive limits of momentum and heat and the advective limit
    # of the O(1) free-fall velocity
    h = min(grid.dx, grid.dy)
    if dt is None:
        dt = cfl * min(0.25 * h * h / max(nu, kappa), h / 1.0)
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=nu)

    if not mg_compatible(nx, ny):
        raise ValueError("rayleigh_benard requires multigrid-compatible nx, ny "
                         "(even, >= 8)")
    mg = MGConfig(tol_factor=tolerance_factor, abs_tol=abs_tol, pin_mean=True)
    if mg_overrides:
        mg = dataclasses.replace(mg, **mg_overrides)
    if dtype != torch.float32:
        raise _not_ported("the float64 Rayleigh-Benard step (the natural XLA path)",
                          "ROADMAP.md queue A item 9")
    if layout not in ("auto", "quad"):
        raise _not_ported(f"layout={layout!r}", "ROADMAP.md queue A item 8")
    coarse_shape = _round_up8_128((ny // 2 + 2, nx // 2 + 2))
    _, _, Hq8, Wqa = quad_dims(grid.shape)
    if coarse_shape != (Hq8, Wqa):
        if layout == "quad":
            raise ValueError(f"quad layout unavailable: coarse shape {coarse_shape} != "
                             f"quad plane shape {(Hq8, Wqa)}")
        raise _not_ported(f"nx={nx}, ny={ny} (coarse shape {coarse_shape} != quad plane "
                          f"shape {(Hq8, Wqa)}: the natural XLA step)",
                          "ROADMAP.md queue A item 9")
    if mg.whole_step and extrapolate_warm_start:
        raise ValueError("extrapolate_warm_start is not supported with whole_step (the "
                         "fused time-step kernel warm-starts from plain p)")
    # V(2,1) on the quad path (cfd_tpu/physics/boussinesq.py:264-265)
    if not (mg_overrides and "post_sweeps" in mg_overrides):
        mg = dataclasses.replace(mg, post_sweeps=1)
    problem = neumann_problem(nx, ny, grid.dx, grid.dy)
    n_cells = nx * ny

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
        build=lambda: make_quad_whole_solve(grid.shape, problem, mg, device=device,
                                            pin_mean=True),
        fallback=per_kernel)
    fused = make_quad_rb_step_kernel(grid.shape, coeffs, kappa, params,
                                     emit_guess=extrapolate_warm_start)
    # the fused RB carry + mean removal + the pure-Neumann pinned solve in
    # one kernel a step (cfd_tpu/physics/boussinesq.py:311-332)
    whole_step = (make_quad_whole_step_rb(grid.shape, problem, coeffs, mg, kappa, n_cells,
                                          params.t_bottom, params.t_top, device=device)
                  if mg.whole_step else None)
    corr = make_quad_rb_corrector(grid.shape, coeffs)
    vel_bc = box_noslip_bc(grid)
    temp_bc = temperature_bc(grid, params.t_bottom, params.t_top)

    # Tentative-state boundary converters with the u_else = us correction
    def align_state(state: State) -> State:
        us, vs = uncorrect_rb_quad(state.u, state.v, state.p, grid.shape, coeffs)
        t = lambda a: to_quad(a, grid.shape)
        p_prev = None
        if extrapolate_warm_start:
            p_prev = t(state.p if state.p_prev is None else state.p_prev)
        return State(t(us), t(vs), t(state.p), t(state.T), p_prev)

    def unalign_state(state: State) -> State:
        u2, v2 = corr(state.u, state.v, state.p)
        f = lambda a: from_quad(a, grid.shape)
        return State(f(u2), f(v2), f(state.p), f(state.T),
                     None if state.p_prev is None else f(state.p_prev))

    def initial_state_fn() -> State:
        """The conductive profile plus the seeded perturbation, equal bit for
        bit to the reference's (boussinesq.py:443-457), aligned."""
        z = torch.zeros(grid.shape, dtype=dtype, device=device)
        y = (torch.arange(grid.shape[0], dtype=dtype, device=device) - 0.5) * grid.dy
        T0 = params.t_bottom + (params.t_top - params.t_bottom) * y[:, None]
        noise = perturbation * torch.from_numpy(uniform(seed, grid.shape, -1.0, 1.0)).to(
            device)
        T = temp_bc(torch.where(_cell_mask(grid, device), T0 + noise, z))
        u, v = vel_bc(z, z)
        return align_state(State(u, v, z, T, z if extrapolate_warm_start else None))

    def adaptive_impl_carry():
        """The lagged controller's step on the traced-dt + Courant RB carry:
        dt_corr completes step n (corrector, T transport), dt_pred advances
        step n+1 (predictor, buoyancy, source); the mean removal and the
        solve from plain p."""
        fused_a = make_quad_rb_step_kernel(grid.shape, coeffs, kappa, params, adaptive=True)
        corr_a = make_quad_rb_corrector(grid.shape, coeffs, traced_dt=True)
        idx_, idy_ = 1.0 / grid.dx, 1.0 / grid.dy
        cell = quad_cell_mask(grid.shape, device)
        n_t = torch.tensor(float(n_cells), dtype=torch.float32, device=device)
        t = lambda a: to_quad(a, grid.shape)
        f = lambda a: from_quad(a, grid.shape)

        def step(state: State, dts):
            us2, vs2, T2, b, sum_b, mu, mv = fused_a(dts, state.u, state.v, state.p,
                                                     state.T)
            p, iters, res = solve(state.p, remove_mean_quad(b, sum_b, n_t, cell))
            return (State(us2, vs2, p, T2, None), StepDiagnostics(iters, res),
                    mu * idx_ + mv * idy_)

        def to_aligned(st: State, dt: float) -> State:
            us, vs = uncorrect_rb_quad(st.u, st.v, st.p, grid.shape, coeffs, dt=dt)
            return State(t(us), t(vs), t(st.p), t(st.T), None)

        def to_logical(st: State, dt_used) -> State:
            u2, v2 = corr_a(dt_used, st.u, st.v, st.p)
            return State(f(u2), f(v2), f(st.p), f(st.T), None)

        return step, to_aligned, to_logical

    return Case(
        name="rayleigh_benard",
        poisson_max_iters=mg.max_cycles,
        step_kernels=(fused, corr),
        align_state=align_state,
        unalign_state=unalign_state,
        extrapolate_warm_start=extrapolate_warm_start,
        grid=grid,
        coeffs=coeffs,
        ordering="rayleigh_benard",
        velocity_bc=vel_bc,
        poisson_solve=solve,
        remove_source_mean=True,
        ke_divisor=n_cells,
        final_time=final_time,
        total_steps=int(final_time / dt),
        print_interval=print_interval,
        save_interval=save_interval,
        dtype=dtype,
        device=device,
        info=dict(banner_title="Rayleigh-Benard Convection Simulation",
                  length=aspect, height=1.0, rayleigh=rayleigh, prandtl=prandtl,
                  cfl=cfl, kappa=kappa, t_bottom=params.t_bottom, t_top=params.t_top,
                  mg=mg),
        extra_stats=lambda state: nusselt_numbers(state, grid, params, kappa=kappa),
        initial_state_fn=initial_state_fn,
        adaptive_impl_carry=adaptive_impl_carry,
        adaptive_diffusivity=max(nu, kappa),
        whole_step_kernel=whole_step,
    )
