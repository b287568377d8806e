"""The whole projection time step in one kernel launch (the port of
cfd_tpu.kernels.whole_step): the flavor's tentative-carry stage, the source
mean removal, the tolerance and the whole tolerance-driven multigrid solve.

    ws(us, vs, p, p_prev) -> (us', vs', p', cycles, res)       cavity, channel
    ws(us, vs, p, T)      -> (us', vs', T', p', cycles, res)   Rayleigh-Benard
    ws(us, vs, p)         -> (us', vs', p', cycles, res)       backward step

Fields are float32 in the (4, Hq8, Wqa) quad layout; ``cycles`` (int32) and
``res`` (float32) are 0-d tensors on the input's device, views of a fresh
2-element output of every call (so a later step never overwrites an earlier
one's counts). Warm starts follow the reference (whole_step.py:22-26): the
extrapolated 2p - p_prev for the cavity and the channel, the plain previous
p for the step and RB. The caller carries p_prev = the pre-solve p, as the
composed path does (solver.make_step).

* ``kernel`` — csrc/whole_step.cu: ONE cooperative launch per step, the
  carry on the standalone carries' shared-memory tiles (each block walks
  its tiles in turn), the source sum and mean removal (1 grid-wide barrier
  for the cavity, 3 for the others), then the whole-solve's cycles
  (csrc/whole_solve.cuh). The launch plan (``self.plan``,
  kernels/plan.py whole_step_plan) is the solve's with the carry's tiles.
  b and the per-chunk sums (the cavity: the blocks' max|b|) live in scratch
  allocated once as buffers of this module; the hierarchy's scratch is the
  inner whole-solve's.
* ``plain`` — the port's own composition: the flavor's carry twin, then
  solver.remove_mean_quad (channel, step, RB), then WholeSolve.plain or
  StepWholeSolve.plain. The kernel repeats its arithmetic in order, so the
  two agree bit for bit with equal cycles, and on the CPU ``whole_step`` on
  and off give identical steps.

The solve takes its whole-solve's options: ``cfg.coarse_dtype="bfloat16"``
(all four flavors; launches on the *_BF16 counters) and, on the step,
``cfg.corr_opt`` (on WHOLE_STEP_STEP_CORR_OPT, with bf16 too).

Not carried over: the reference's WHOLE_STEP_MAX_PADDED_CELLS, its VMEM
estimate and CFD_TPU_WHOLE_STEP_NO_CEILING, which are TPU toolchain limits
(ROADMAP.md queue A item 13): the port builds the whole step at every size
its whole-solve takes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import nn

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.quad import (
    SUM_BLOCK,
    QuadChannelCorrPredictorSource,
    QuadCorrPredictorSource,
    _check,
    quad_cell_mask,
)
from cfd_tpu_torch.kernels.plan import Plan, cooperative_grid, ready_grid, whole_step_plan
from cfd_tpu_torch.kernels.rb_quad import QuadRBStep
from cfd_tpu_torch.kernels.step_quad import QuadStepCorrPredictorSource, step_cell_mask
from cfd_tpu_torch.kernels.whole_solve import StepWholeSolve, WholeSolve, split_stats

WHOLE_STEP_CAVITY = Kernel("quad_whole_step_cavity", "cfd_whole_step",
                           "cfd_tpu_torch/csrc/whole_step.cu",
                           "cfd_tpu/kernels/whole_step.py:165")
WHOLE_STEP_CHANNEL = Kernel("quad_whole_step_channel", "cfd_whole_step",
                            "cfd_tpu_torch/csrc/whole_step.cu",
                            "cfd_tpu/kernels/whole_step.py:186")
WHOLE_STEP_RB = Kernel("quad_whole_step_rb", "cfd_whole_step",
                       "cfd_tpu_torch/csrc/whole_step.cu",
                       "cfd_tpu/kernels/whole_step.py:211")
WHOLE_STEP_STEP = Kernel("quad_whole_step_step", "cfd_whole_step",
                         "cfd_tpu_torch/csrc/whole_step.cu",
                         "cfd_tpu/kernels/whole_step.py:239")
WHOLE_STEP_CAVITY_BF16 = Kernel("quad_whole_step_cavity_bf16", "cfd_whole_step",
                                "cfd_tpu_torch/csrc/whole_step.cu",
                                "cfd_tpu/kernels/whole_step.py:165 (coarse_dtype)")
WHOLE_STEP_CHANNEL_BF16 = Kernel("quad_whole_step_channel_bf16", "cfd_whole_step",
                                 "cfd_tpu_torch/csrc/whole_step.cu",
                                 "cfd_tpu/kernels/whole_step.py:186 (coarse_dtype)")
WHOLE_STEP_RB_BF16 = Kernel("quad_whole_step_rb_bf16", "cfd_whole_step",
                            "cfd_tpu_torch/csrc/whole_step.cu",
                            "cfd_tpu/kernels/whole_step.py:211 (coarse_dtype)")
WHOLE_STEP_STEP_BF16 = Kernel("quad_whole_step_step_bf16", "cfd_whole_step",
                              "cfd_tpu_torch/csrc/whole_step.cu",
                              "cfd_tpu/kernels/whole_step.py:239 (coarse_dtype)")
WHOLE_STEP_STEP_CORR_OPT = Kernel("quad_whole_step_step_corr_opt", "cfd_whole_step",
                                  "cfd_tpu_torch/csrc/whole_step.cu",
                                  "cfd_tpu/kernels/whole_step.py:239 (corr_opt)")

# the kernel's flavor argument (csrc/whole_step.cu Flavor)
CAVITY, CHANNEL, RB, STEP = 0, 1, 2, 3


def launch_grid(flavor: int, plan: Plan | None = None) -> dict:
    """The cooperative grid of a flavor's whole-step kernel on the current
    CUDA device at ``plan``'s shared memory (none given: none): blocks,
    blocks per SM, registers per thread."""
    return cooperative_grid("cfd_whole_step_grid", flavor, plan.smem_bytes if plan else 0)


class _Walls(NamedTuple):
    """The wall temperatures the RB carry reads (physics.boussinesq.RBParams'
    t_bottom, t_top)."""

    t_bottom: float
    t_top: float


class _WholeStep(nn.Module):
    """One flavor's whole step: ``carry`` (the flavor's tentative-carry stage
    object), ``solver`` (a WholeSolve or StepWholeSolve), and for the flavors
    with a mean removal the quad mask of the cells it runs over and their
    count. ``RECORD`` counts the launches with the float32 hierarchy,
    ``RECORD_BF16`` with the bfloat16 one; ``record`` is this instance's.
    ``plan`` (kernels/plan.py WholeStepPlan) is read at the first launch
    (the card tests set another before it)."""

    FLAVOR: int
    FLOW: str
    RECORD: Kernel
    RECORD_BF16: Kernel
    N_FIELDS: int = 4

    @property
    def record(self) -> Kernel:
        return self.RECORD_BF16 if self.solver.mg.store_dtype is not None else self.RECORD

    def __init__(self, carry, solver, cell=None, n_fluid: int | None = None):
        super().__init__()
        self.carry = carry
        self.solver = solver
        self.qshape = solver.qshape
        device = solver.ctl.device
        f32 = dict(dtype=torch.float32, device=device)
        self.plan = whole_step_plan(self.FLOW, solver.plan, self.qshape)
        self.register_buffer("b", torch.zeros(self.qshape, **f32), persistent=False)
        # the per-chunk sums of b, or the cavity's max|b| of each block
        n0 = self.qshape[0] * self.qshape[1] * self.qshape[2]
        self.register_buffer("partials", torch.zeros(
            max(-(-n0 // SUM_BLOCK), self.plan.solve.blocks), **f32), persistent=False)
        self.n_fluid = n_fluid
        self._plan_ints = None  # the plan's host arrays, its kernel readied at the first launch
        if cell is not None:
            self.register_buffer("cell", cell, persistent=False)
            self.register_buffer("n_cells", torch.tensor(float(n_fluid), **f32),
                                 persistent=False)

    def forward(self, *fields):
        if len(fields) != self.N_FIELDS:
            raise ValueError(f"{type(self).__name__} takes {self.N_FIELDS} fields, got "
                             f"{len(fields)}")
        _check(self.qshape, *fields)
        if route(*fields) == "cuda":
            return self.kernel(*fields)
        return self.plain(*fields)

    def _remove_mean(self, b, sum_b):
        from cfd_tpu_torch.solver import remove_mean_quad

        return remove_mean_quad(b, sum_b, self.n_cells, self.cell)

    def _coeffs(self) -> tuple:
        """cf of cfd_whole_step: cu, cv, ghost, dt, nu, idx, idy, idx2, idy2,
        rho_dt, kappa, 2 t_bottom, 2 t_top, buoy, n_fluid."""
        k, c = self.carry, self.carry.coeffs
        ghost = 2.0 * k.lid if self.FLAVOR == CAVITY else getattr(k, "uin", 0.0)
        rho_dt = c.density / c.dt
        rb = ((k.kappa, 2.0 * k.t_bottom, 2.0 * k.t_top, k.buoy) if self.FLAVOR == RB
              else (0.0,) * 4)
        return (k.cu, k.cv, ghost, c.dt, c.viscosity, c.idx, c.idy, c.idx2, c.idy2, rho_dt,
                *rb, float(self.n_fluid or 0))

    def _launch_plan(self, device):
        """The plan's host arrays (solve, carry), the kernel readied for the
        plan on ``device`` at the first launch (plan.ready_grid)."""
        if self._plan_ints is None:
            if self.plan.solve.blocks > self.partials.numel():
                raise ValueError(f"the plan launches {self.plan.solve.blocks} blocks, the "
                                 f"partials hold {self.partials.numel()}")
            ready_grid(self.plan.solve, device, "cfd_whole_step_grid", self.FLAVOR)
            self._plan_ints = (self.plan.solve.c_ints(), self.plan.carry.c_ints())
        return self._plan_ints

    def kernel(self, *fields):
        us, vs, p = fields[:3]
        us2, vs2, p_out = (torch.empty_like(us) for _ in range(3))
        T2 = torch.empty_like(us) if self.FLAVOR == RB else None
        stats = torch.empty(2, dtype=torch.int32, device=us.device)
        solve_ints, carry_ints = self._launch_plan(us.device)
        _, masked, scratch, common = self.solver.launch_args(us, solve_ints)
        opt = lambda t: t.data_ptr() if t is not None else None
        io = (ctypes.c_void_p * 9)(
            us.data_ptr(), vs.data_ptr(), p.data_ptr(),
            opt(fields[3] if len(fields) > 3 else None), us2.data_ptr(), vs2.data_ptr(),
            opt(T2), self.b.data_ptr(), self.partials.data_ptr())
        cf = (ctypes.c_float * 15)(*self._coeffs())
        as_ptr = lambda a: ctypes.cast(a, ctypes.c_void_p)
        self.record(us, self.FLAVOR, as_ptr(io), as_ptr(cf), as_ptr(carry_ints), masked,
                    ptr(p_out), *scratch, ptr(self.solver.ctl), ptr(stats), *common)
        cycles, res = split_stats(stats)
        outs = (us2, vs2) + ((T2,) if T2 is not None else ())
        return (*outs, p_out, cycles, res)


class QuadWholeStepCavity(_WholeStep):
    """ws(us, vs, p, p_prev) -> (us', vs', p', cycles, res): the cavity carry
    (kernels.quad make_quad_corr_predictor_source), no mean removal (the
    eps-regularised operator is nonsingular), the solve from the guess 2p -
    p_prev with the carry's max|b|."""

    FLAVOR, FLOW = CAVITY, "cavity"
    RECORD, RECORD_BF16 = WHOLE_STEP_CAVITY, WHOLE_STEP_CAVITY_BF16

    def plain(self, us, vs, p, p_prev):
        us2, vs2, b, guess, max_b = self.carry.plain(us, vs, p, p_prev)
        p2, cycles, res = self.solver.plain(guess, b, max_b)
        return us2, vs2, p2, cycles, res


class QuadWholeStepChannel(_WholeStep):
    """ws(us, vs, p, p_prev) -> (us', vs', p', cycles, res): the channel
    carry, the interior source mean removal (channel-01.cpp:620-628), the
    solve from the guess 2p - p_prev."""

    FLAVOR, FLOW = CHANNEL, "channel"
    RECORD, RECORD_BF16 = WHOLE_STEP_CHANNEL, WHOLE_STEP_CHANNEL_BF16

    def plain(self, us, vs, p, p_prev):
        us2, vs2, b, guess, sum_b = self.carry.plain(us, vs, p, p_prev)
        p2, cycles, res = self.solver.plain(guess, self._remove_mean(b, sum_b))
        return us2, vs2, p2, cycles, res


class QuadWholeStepRB(_WholeStep):
    """ws(us, vs, p, T) -> (us', vs', T', p', cycles, res): the RB carry
    (corrector, temperature, predictor + buoyancy + source), the mean
    removal over the nx * ny cells, the pure-Neumann pinned solve from the
    plain previous p."""

    FLAVOR, FLOW = RB, "rb"
    RECORD, RECORD_BF16 = WHOLE_STEP_RB, WHOLE_STEP_RB_BF16

    def plain(self, us, vs, p, T):
        us2, vs2, T2, b, sum_b = self.carry.plain(us, vs, p, T)
        p2, cycles, res = self.solver.plain(p, self._remove_mean(b, sum_b))
        return us2, vs2, T2, p2, cycles, res


class QuadWholeStepStep(_WholeStep):
    """ws(us, vs, p) -> (us', vs', p', cycles, res): the masked step carry,
    the fluid-only mean removal, the masked solve from the plain previous
    p; with ``cfg.corr_opt`` the launches count on
    WHOLE_STEP_STEP_CORR_OPT."""

    FLAVOR, FLOW, N_FIELDS = STEP, "step", 3
    RECORD, RECORD_BF16 = WHOLE_STEP_STEP, WHOLE_STEP_STEP_BF16

    @property
    def record(self) -> Kernel:
        return WHOLE_STEP_STEP_CORR_OPT if self.solver.cfg.corr_opt else super().record

    def plain(self, us, vs, p):
        us2, vs2, b, sum_b = self.carry.plain(us, vs, p)
        p2, cycles, res = self.solver.plain(p, self._remove_mean(b, sum_b))
        return us2, vs2, p2, cycles, res


def make_quad_whole_step_cavity(shape, problem, coeffs, cfg, lid_velocity: float = 1.0,
                                device="cpu") -> QuadWholeStepCavity:
    carry = QuadCorrPredictorSource(shape, coeffs, lid_velocity)
    return QuadWholeStepCavity(carry, WholeSolve(shape, problem, cfg, device))


def make_quad_whole_step_channel(shape, problem, coeffs, cfg, n_interior: int,
                                 inlet_velocity: float = 1.0,
                                 device="cpu") -> QuadWholeStepChannel:
    carry = QuadChannelCorrPredictorSource(shape, coeffs, inlet_velocity)
    return QuadWholeStepChannel(carry, WholeSolve(shape, problem, cfg, device),
                                quad_cell_mask(shape, device), n_interior)


def make_quad_whole_step_rb(shape, problem, coeffs, cfg, kappa: float, n_interior: int,
                            t_bottom: float = 1.0, t_top: float = 0.0,
                            buoyancy: float = 1.0, device="cpu") -> QuadWholeStepRB:
    """The solve is pinned to zero mean every cycle whatever ``cfg.pin_mean``
    says, as the reference's (separable_vcycle_ctx(pin_mean=True))."""
    if buoyancy != 1.0:
        raise NotImplementedError("the RB carry takes the free-fall buoyancy 1 only "
                                  "(kernels.rb_quad.QuadRBStep)")
    carry = QuadRBStep(shape, coeffs, kappa, _Walls(t_bottom, t_top))
    solver = WholeSolve(shape, problem, cfg, device, pin_mean=True)
    return QuadWholeStepRB(carry, solver, quad_cell_mask(shape, device), n_interior)


def make_quad_whole_step_step(grid, coeffs, cfg, step_i: int, inlet_j: int,
                              inlet_velocity: float = 1.0,
                              device="cpu") -> QuadWholeStepStep:
    solver = StepWholeSolve(grid, coeffs, cfg, device)
    l0 = solver.mg.pre0
    if (l0.step_i, l0.inlet_j) != (step_i, inlet_j):
        raise ValueError(f"step rectangle ({step_i}, {inlet_j}) != the grid's "
                         f"({l0.step_i}, {l0.inlet_j})")
    carry = QuadStepCorrPredictorSource(grid.shape, coeffs, step_i, inlet_j, inlet_velocity)
    return QuadWholeStepStep(carry, solver, step_cell_mask(grid.shape, step_i, inlet_j,
                                                           device), grid.n_fluid)
