"""Lid-driven cavity case (the port of cfd_tpu.cases.cavity).

Reference: CavitySolver (cavity-01.cpp:306-775). Defaults reproduce the
reference's constants and dt rule bit for bit (cavity-01.cpp:309-320,
355-363).

Ported: the float32 multigrid branch on the quad layout — the
tentative-carry stage kernel, the quad finest-level V-cycle kernels and the
coarse red/black smoother, V(2,1), the extrapolated warm start, and the
reference's solve policy (cfd_tpu/cases/cavity.py:207-245) with "device is
cuda" in place of "platform is tpu": auto_whole_solve takes the fused
whole-solve (kernels.whole_solve, float32 hierarchy) on the card, where no
VMEM ceiling rejects it (ROADMAP.md queue A item 13), and the per-kernel
composition on the CPU or under a manual fusion knob in mg_overrides; the
bf16 coarse hierarchy of the auto rule applies to that per-kernel fallback
only, as the reference's mg_fb does. ``mg_overrides={"whole_step": True}``
runs the whole time step in one kernel (kernels.whole_step,
cfd_tpu/cases/cavity.py:191-201). The multigrid knobs ``tail_from`` (the
per-kernel solve's fused coarse tail, with the float32 coarse hierarchy:
the auto bf16 rule excludes it) and ``coarse_dtype="bfloat16"`` with
whole_solve or whole_step (the whole-solve's bf16 rounding) are manual;
``corr_opt`` raises the reference's ValueError (a masked knob).
``fuse_pre=True`` on the per-kernel solve (the CPU's default, on the card
``mg_overrides={"whole_solve": False}``) runs the carry with the first
cycle's finest pre-smooth and restriction folded in
(kernels.quad.QuadCorrPredictorSourceFusedPre) and the solve from the
coarse stage (MultigridPoisson.solve_rc); under the whole-solve or the
whole step it is ignored, as in the reference. Adaptive
stepping: ``adaptive_impl`` (the exact controller: the traced-dt non-carry
stage, the solve, the traced-dt corrector) and ``adaptive_impl_carry`` (the
lagged controller on the traced-dt + Courant carry),
cfd_tpu/cases/cavity.py:296-378.

The natural aligned layout (cfd_tpu/cases/cavity.py:379-412), under
``layout="aligned"`` and by the auto rule wherever the quad layout does not
exist (n = 14 mod 16, where the aligned level-1 shape differs from the quad
plane shape): the natural stage kernels (kernels.projection, the
predictor+source with max|b| and the corrector with the guess), the
aligned solve (MultigridPoisson without quad_level0: the row-5 smoothers
with the fused residuals, ``tail_from`` and ``coarse_dtype`` as the
reference takes them, no auto bf16 and no whole-solve) and the non-carry
ordering (solver._natural_step). The carried state is the (H8, W) aligned
layout whose p_prev slot holds the next guess (convert.natural_converters).
whole_solve and whole_step off the quad path raise the reference's
ValueError, pin_mean its ValueError (the cavity's problem is not pure
Neumann), adaptive dt NotImplementedError (the reference's
make_adaptive_step, ROADMAP.md queue A item 6). Everything else raises
NotImplementedError rather than being ignored.
"""

from __future__ import annotations

import dataclasses

import torch

from cfd_tpu_torch.bc import lid_cavity_bc
from cfd_tpu_torch.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu_torch.kernels.projection import make_corrector, make_predictor_source
from cfd_tpu_torch.kernels.quad import (
    QuadCorrPredictorSourceFusedPre,
    from_quad,
    make_quad_corr_predictor_source,
    make_quad_corrector,
    make_quad_post_prolong_smooth,
    make_quad_pre_smooth_restrict,
    make_quad_predictor_source,
    quad_dims,
    to_quad,
    uncorrect_quad,
)
from cfd_tpu_torch.kernels.whole_solve import auto_whole_solve, make_quad_whole_solve
from cfd_tpu_torch.kernels.whole_step import make_quad_whole_step_cavity
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.params import check_cfl, validate_case_params
from cfd_tpu_torch.poisson.multigrid import (
    MGConfig,
    _round_up8_128,
    auto_bf16_coarse,
    cavity_problem,
    make_multigrid_poisson,
    mg_compatible,
    normalize_coarse_dtype_optout,
)
from cfd_tpu_torch.precision import as_dtype
from cfd_tpu_torch.solver import Case, natural_case
from cfd_tpu_torch.state import State, StepDiagnostics


def _not_ported(what: str, where: str):
    return NotImplementedError(f"{what} is not ported yet ({where})")


def make_cavity_case(
    n_interior: int = 63,
    reynolds_number: float = 1000.0,
    cavity_length: float = 1.0,
    cavity_height: float = 1.0,
    lid_velocity: float = 1.0,
    density: float = 1.0,
    cfl_number: float = 0.5,
    final_time: float = 20.0,
    tolerance_factor: float = 1e-9,
    max_sor_iterations: int = 10000,
    print_interval: int = 100,
    save_interval: int = 100,
    dt: float | None = None,
    poisson: str = "auto",  # "auto" | "multigrid" ("sor" is not ported)
    dtype=torch.float64,
    layout: str = "auto",  # "auto" | "quad" | "aligned"
    mg_overrides: dict | None = None,  # MGConfig field overrides
    forcing: tuple | None = None,
    fuse_pre: bool = False,
    device="cuda",  # "cpu" runs the kernels' plain PyTorch twins
) -> Case:
    dtype = as_dtype(dtype)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the kernels' plain PyTorch twins on the CPU")
    validate_case_params(
        reynolds_number=reynolds_number, density=density, cfl=cfl_number,
        final_time=final_time, tolerance_factor=tolerance_factor, dt=dt,
        max_iterations=max_sor_iterations, print_interval=print_interval,
        save_interval=save_interval, cavity_length=cavity_length,
        cavity_height=cavity_height)
    grid = Grid.regular(n_interior, n_interior, cavity_length, cavity_height)
    viscosity = density * lid_velocity * cavity_length / reynolds_number
    if dt is None:
        dt = cfl_time_step(grid.dx, grid.dy, viscosity, lid_velocity, cfl_number)
    else:
        check_cfl(dt, grid.dx, grid.dy, viscosity, abs(lid_velocity))
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=viscosity,
                           density=density)
    omega = optimal_omega(n_interior)  # square form, cavity-01.cpp:74-78
    if poisson == "auto":
        poisson = ("multigrid" if mg_compatible(n_interior, n_interior)
                   and n_interior >= 128 else "sor")
    if poisson == "sor":
        raise _not_ported("the SOR pressure solver", "ROADMAP.md queue A item 6")
    if poisson != "multigrid":
        raise ValueError(f"unknown poisson solver: {poisson}")
    if dtype != torch.float32:
        raise _not_ported("the float64 multigrid path", "ROADMAP.md queue A item 3")
    if forcing is not None:
        raise _not_ported("body forcing", "ROADMAP.md queue A item 11")
    if layout not in ("auto", "quad", "aligned"):
        raise ValueError(f"unknown layout {layout!r} (auto, quad or aligned)")
    coarse_shape = _round_up8_128((n_interior // 2 + 2, n_interior // 2 + 2))
    _, _, Hq8, Wqa = quad_dims(grid.shape)
    # the quad layout needs the aligned level-1 shape to be the quad plane
    # shape; n = 14 mod 16 takes the natural layout (cavity.py:151-164)
    use_quad = layout in ("auto", "quad") and coarse_shape == (Hq8, Wqa)
    if layout == "quad" and not use_quad:
        raise ValueError(f"quad layout unavailable: coarse shape {coarse_shape} != "
                         f"quad plane shape {(Hq8, Wqa)}")

    explicit_f32_coarse, mg_overrides = normalize_coarse_dtype_optout(mg_overrides)
    mg = MGConfig(tol_factor=tolerance_factor, abs_tol=0.0)
    if mg_overrides:
        mg = dataclasses.replace(mg, **mg_overrides)
    # f32 perf path: V(2,1) (cfd_tpu/cases/cavity.py:139-144)
    if not (mg_overrides and "post_sweeps" in mg_overrides):
        mg = dataclasses.replace(mg, post_sweeps=1)
    problem = cavity_problem(n_interior, n_interior, grid.dx, grid.dy)
    common = dict(
        poisson_max_iters=mg.max_cycles, name="cavity", extrapolate_warm_start=True,
        grid=grid, coeffs=coeffs, ordering="cavity",
        velocity_bc=lid_cavity_bc(grid, lid_velocity), remove_source_mean=False,
        ke_divisor=n_interior * n_interior, final_time=final_time,
        total_steps=int(final_time / dt), print_interval=print_interval,
        save_interval=save_interval, dtype=dtype, device=device)
    info = dict(banner_title="Lid-Driven Cavity Flow Simulation", length=cavity_length,
                height=cavity_height, square_spacing=True, reynolds=reynolds_number,
                cfl=cfl_number, omega=omega, lid_velocity=lid_velocity)
    if not use_quad:
        return natural_case(mg, common, info,
                            (make_predictor_source(grid.shape, coeffs, lid_velocity),
                             make_corrector(grid.shape, coeffs, lid_velocity)),
                            lambda: make_multigrid_poisson(problem, mg, device=device))
    on_cuda = device.type == "cuda"
    # the bf16 coarse hierarchy of the auto rule, for the per-kernel fallback
    # only (the reference's mg_fb, cfd_tpu/cases/cavity.py:219-245)
    mg_fb = (dataclasses.replace(mg, coarse_dtype="bfloat16")
             if auto_bf16_coarse(on_cuda, explicit_f32_coarse, mg, mg_overrides) else mg)

    corr = make_quad_corrector(grid.shape, coeffs, lid_velocity)
    carry = make_quad_corr_predictor_source(grid.shape, coeffs, lid_velocity)

    def per_kernel():
        quad_l0 = (
            make_quad_pre_smooth_restrict(grid.shape, problem, mg_fb.omega,
                                          mg_fb.pre_sweeps, coarse_shape, device=device),
            make_quad_post_prolong_smooth(grid.shape, problem, mg_fb.omega,
                                          mg_fb.post_sweeps, coarse_shape, device=device),
        )
        return make_multigrid_poisson(problem, mg_fb, quad_l0, device=device)

    solve, mg = auto_whole_solve(
        mg, mg_overrides, on_cuda,
        build=lambda: make_quad_whole_solve(grid.shape, problem, mg, device=device),
        fallback=per_kernel)
    if not mg.whole_solve:
        mg = mg_fb  # the fallback's actual config
    whole_step = (make_quad_whole_step_cavity(grid.shape, problem, coeffs, mg, lid_velocity,
                                              device=device) if mg.whole_step else None)
    # fuse_pre on the per-kernel solve only, silently ignored under the
    # whole-solve or the whole step (cfd_tpu/cases/cavity.py:246-272): the
    # carry also runs the first cycle's finest pre-smooth and restriction,
    # and the solve starts that cycle at the coarse stage. The adaptive
    # builders keep the plain carry and the three-argument ``solve``.
    carry_fused_pre = fuse_pre and not mg.whole_solve and not mg.whole_step
    step_kernels, step_solve = (carry, corr), solve
    if carry_fused_pre:
        step_kernels = (QuadCorrPredictorSourceFusedPre(grid.shape, coeffs, solve.pre0,
                                                        lid_velocity), corr)
        step_solve = solve.solve_rc

    # Tentative-state boundary converters: the carried u/v are the
    # TENTATIVE (u*, v*) fields; the logical state applies the corrector
    # (unalign) or its exact inverse (align; one f32 rounding round trip).
    def align_state(state: State) -> State:
        us, vs = uncorrect_quad(state.u, state.v, state.p, grid.shape, coeffs)
        t = lambda a: to_quad(a, grid.shape)
        p_prev = state.p if state.p_prev is None else state.p_prev
        return State(t(us), t(vs), t(state.p), state.T, t(p_prev))

    def unalign_state(state: State) -> State:
        u2, v2, _ = corr(state.u, state.v, state.p, state.p)
        f = lambda a: from_quad(a, grid.shape)
        return State(f(u2), f(v2), f(state.p), state.T,
                     None if state.p_prev is None else f(state.p_prev))

    idx_, idy_ = 1.0 / grid.dx, 1.0 / grid.dy
    t = lambda a: to_quad(a, grid.shape)
    f = lambda a: from_quad(a, grid.shape)

    def adaptive_impl():
        """The exact controller's step on the non-carry quad kernels with a
        traced dt: the carried u, v are the CORRECTED fields and the p_prev
        slot holds the next solve's guess 2p - p_prev."""
        pred_a = make_quad_predictor_source(grid.shape, coeffs, lid_velocity)
        corr_a = make_quad_corrector(grid.shape, coeffs, lid_velocity, traced_dt=True)

        def step(state: State, dt):
            us, vs, b, max_b = pred_a(dt, state.u, state.v)
            p, iters, res = solve(state.p_prev, b, max_b)
            u2, v2, guess = corr_a(dt, us, vs, p, state.p)
            co_per_dt = torch.max(torch.abs(u2)) * idx_ + torch.max(torch.abs(v2)) * idy_
            return State(u2, v2, p, state.T, guess), StepDiagnostics(iters, res), co_per_dt

        def to_aligned(st: State) -> State:
            p_prev = st.p if st.p_prev is None else st.p_prev
            return State(t(st.u), t(st.v), t(st.p), st.T, t(2.0 * st.p - p_prev))

        def to_logical(st: State) -> State:
            p_prev = None if st.p_prev is None else f(2.0 * st.p - st.p_prev)  # guess -> p_prev
            return State(f(st.u), f(st.v), f(st.p), st.T, p_prev)

        return step, to_aligned, to_logical

    def adaptive_impl_carry():
        """The lagged controller's step on the tentative-carry kernel with
        (dt_corr, dt_pred) and the fused Courant maxima; the corrected fields
        exist only inside that kernel, so the feedback is one step stale."""
        fused_a = make_quad_corr_predictor_source(grid.shape, coeffs, lid_velocity,
                                                  adaptive=True)
        corr_a = make_quad_corrector(grid.shape, coeffs, lid_velocity, traced_dt=True)

        def step(state: State, dts):
            us2, vs2, b, guess, max_b, mu, mv = fused_a(dts, state.u, state.v, state.p,
                                                        state.p_prev)
            p, iters, res = solve(guess, b, max_b)
            return (State(us2, vs2, p, state.T, state.p), StepDiagnostics(iters, res),
                    mu * idx_ + mv * idy_)

        def to_aligned(st: State, dt: float) -> State:
            us, vs = uncorrect_quad(st.u, st.v, st.p, grid.shape, coeffs, dt=dt)
            p_prev = st.p if st.p_prev is None else st.p_prev
            return State(t(us), t(vs), t(st.p), st.T, t(p_prev))

        def to_logical(st: State, dt_used) -> State:
            u2, v2, _ = corr_a(dt_used, st.u, st.v, st.p, st.p)
            return State(f(u2), f(v2), f(st.p), st.T,
                         None if st.p_prev is None else f(st.p_prev))

        return step, to_aligned, to_logical

    return Case(
        step_kernels=step_kernels,
        align_state=align_state,
        unalign_state=unalign_state,
        poisson_solve=step_solve,
        info=dict(info, mg=mg),
        adaptive_impl=adaptive_impl,
        adaptive_impl_carry=adaptive_impl_carry,
        whole_step_kernel=whole_step,
        carry_fused_pre=carry_fused_pre,
        **common,
    )
