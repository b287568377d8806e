"""The whole tolerance-driven multigrid solve in one kernel launch (the port
of cfd_tpu.kernels.whole_solve): the separable flavor (WholeSolve, the
cavity and the channel, and with pin_mean the Rayleigh-Benard case's
pure-Neumann solve) and the masked flavor of the backward step
(StepWholeSolve).

``solve(p4_warm, b4, max_b=None) -> (p4, cycles, res)`` with the contract
of the reference's make_quad_whole_solve (whole_solve.py:121-135, 507): p
and b in the (4, Hq8, Wqa) quad layout, ``cycles`` an int32 and ``res`` the
final max|b - Ap| as a float32, both 0-d tensors on the input's device.
They stay there until the caller reads them: the run loop reads a stats
row's worth at once (solver.Simulation.run), not one per solve.

* ``kernel`` — csrc/whole_solve.cu: ONE cooperative launch runs every
  V-cycle of the solve and the stop rule on the card, laid out by the
  solver's launch plan (``self.plan``, kernels/plan.py: the finest level in
  shared-memory tiles, the large coarse levels on the grid, the smallest in
  one block), with the hierarchy's scratch allocated once as buffers of
  this module. (cycles, res) are written into a fresh 2-element output of
  every call, so a later solve never overwrites an earlier one's counts.
* ``plain`` — the same solve as the tolerance loop over the per-kernel
  composition's PyTorch twins (MultigridPoisson.cycle(plain=True) or
  MaskedQuadMultigridPoisson.cycle(plain=True): the finest-level pre/post
  twins, run_tail_vcycle over the rb_smoother twins, the glue transfers
  and the coarsest pinv product) with the float32 coarse hierarchy. The
  kernel repeats that arithmetic in the same order, so the two agree bit
  for bit, and on the CPU ``whole_solve`` on and off give identical
  results.

The reference's in-VMEM coarse hierarchy runs lane transfers as matmuls
(mg_tail.py), so its rounding differs from the per-kernel path by a few
ulps: its whole-solve and per-kernel cycle counts may differ by one
(tests/test_whole_solve.py). The port's do not differ. ``pin_mean``
(separable only) shifts p to zero interior mean after each cycle's
residual, in the kernel as in the twin (MultigridPoisson.cycle). As in the
reference it is the factory's own argument, not ``cfg.pin_mean``
(whole_solve.py:507-520): only Rayleigh-Benard passes True
(physics/boussinesq.py:286-290), and the other flavors ignore the field.

``cfg.coarse_dtype="bfloat16"`` (whole_solve.py:156, 216-219, 340): the
reference's bfloat16 in-VMEM hierarchy, which is not the per-kernel bf16
levels: float32 levels whose weights and coarsest pinv are rounded to
bfloat16 once, and every level's source b[k] and pre-smoothed iterate
ps[k] rounded to bfloat16 where the reference stores them, with float32
arithmetic and a float32 correction between levels (the twin:
MultigridPoisson or MaskedQuadMultigridPoisson with ``store_dtype``). The
kernel keeps its float32 buffers and rounds at the same points, so it
computes the same function; its launches count on the *_BF16 counters.
``cfg.corr_opt`` (masked only, whole_solve.py:379-398): the level-1
correction scaled by its clamped line-search steplength before the solid
fill, from the UNROUNDED level-1 source, in the kernel as in the twin
(poisson.multigrid._corr_alpha); its launches count on
STEP_WHOLE_SOLVE_CORR_OPT (with bf16 too). ``cfg.tail_from`` is superseded:
the whole-solve runs its whole hierarchy in the one launch anyway.

Not carried over: the reference's VMEM estimates and toolchain ceiling,
which are TPU limits (ROADMAP.md queue A item 13). The whole time step in
one launch (kernels.whole_step) runs this module's solve after its carry
stages.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch import nn

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.mg_tail import level_arrays
from cfd_tpu_torch.kernels.plan import Plan, cooperative_grid, device_sms, plan_for, ready_grid
from cfd_tpu_torch.kernels.quad import (
    SUM_BLOCK,
    _check,
    make_quad_post_prolong_smooth,
    make_quad_pre_smooth_restrict,
    quad_dims,
)
# the module, not its names: poisson.multigrid imports kernels.mg_tail, whose
# package (this one) lists every kernel, this one included
from cfd_tpu_torch.poisson import multigrid as mgp

WHOLE_SOLVE = Kernel("quad_whole_solve", "cfd_whole_solve",
                     "cfd_tpu_torch/csrc/whole_solve.cu",
                     "cfd_tpu/kernels/whole_solve.py:507")
STEP_WHOLE_SOLVE = Kernel("quad_step_whole_solve", "cfd_whole_solve",
                          "cfd_tpu_torch/csrc/whole_solve.cu",
                          "cfd_tpu/kernels/whole_solve.py:569")
WHOLE_SOLVE_PIN_MEAN = Kernel("quad_whole_solve_pin_mean", "cfd_whole_solve",
                              "cfd_tpu_torch/csrc/whole_solve.cu",
                              "cfd_tpu/kernels/whole_solve.py:507 (pin_mean)")
WHOLE_SOLVE_BF16 = Kernel("quad_whole_solve_bf16", "cfd_whole_solve",
                          "cfd_tpu_torch/csrc/whole_solve.cu",
                          "cfd_tpu/kernels/whole_solve.py:178 (coarse_dtype)")
WHOLE_SOLVE_PIN_MEAN_BF16 = Kernel("quad_whole_solve_pin_mean_bf16", "cfd_whole_solve",
                                   "cfd_tpu_torch/csrc/whole_solve.cu",
                                   "cfd_tpu/kernels/whole_solve.py:178 (pin_mean, "
                                   "coarse_dtype)")
STEP_WHOLE_SOLVE_BF16 = Kernel("quad_step_whole_solve_bf16", "cfd_whole_solve",
                               "cfd_tpu_torch/csrc/whole_solve.cu",
                               "cfd_tpu/kernels/whole_solve.py:297 (coarse_dtype)")
STEP_WHOLE_SOLVE_CORR_OPT = Kernel("quad_step_whole_solve_corr_opt", "cfd_whole_solve",
                                   "cfd_tpu_torch/csrc/whole_solve.cu",
                                   "cfd_tpu/kernels/whole_solve.py:379-398 (corr_opt)")


def coarse_store_dtype(cfg) -> torch.dtype | None:
    """The whole-solve's rounding type from ``cfg.coarse_dtype`` (cfd_tpu
    whole_solve._coarse_dt): None or torch.bfloat16."""
    if cfg.coarse_dtype is None:
        return None
    if cfg.coarse_dtype not in ("bfloat16", "bf16"):
        raise ValueError(f"unsupported coarse_dtype {cfg.coarse_dtype!r} (only 'bfloat16')")
    return torch.bfloat16


def hierarchy_cfg(cfg):
    """The per-kernel composition's config under a whole-solve: the bf16
    hierarchy is the whole-solve's own rounding (``store_dtype``), and
    tail_from is superseded."""
    return dataclasses.replace(cfg, coarse_dtype=None, tail_from=None)


def launch_grid(masked: bool = False, plan: Plan | None = None) -> dict:
    """The cooperative grid of the separable (or, with ``masked``, the
    step's) whole-solve kernel at ``plan``'s shared memory (none given:
    none)."""
    return cooperative_grid("cfd_whole_solve_grid", int(masked), plan.smem_bytes if plan else 0)


def stats_tensors(cycles: int, res, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A host (cycles, res) as the kernels return them: an int32 and a
    float32 0-d tensor on ``device``."""
    return (torch.tensor(cycles, dtype=torch.int32, device=device),
            torch.tensor(res, dtype=torch.float32, device=device))


def split_stats(stats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2-int32 output a kernel wrote (cycles, the bits of the float32
    residual) as two 0-d views: no copy, no launch."""
    return stats[0], stats.view(torch.float32)[1]


class _WholeSolveBase(nn.Module):
    """The tolerance loop of ``self.mg`` (a per-kernel composition with a
    ``cycle(p, b, plain)`` and the coarse ``levels`` the kernel walks) as
    one cooperative launch, with the hierarchy's scratch allocated once as
    buffers of this module."""

    MASKED = False

    def _alloc_scratch(self, coarse, device):
        # per coarse level: iterate and source; the (max|b|, residual,
        # residual, sum) slots
        f32 = dict(dtype=torch.float32, device=device)
        for k, lv in enumerate(coarse, start=1):
            self.register_buffer(f"p{k}", torch.zeros(lv.shape, **f32), persistent=False)
            self.register_buffer(f"b{k}", torch.zeros(lv.shape, **f32), persistent=False)
        self.register_buffer("ctl", torch.zeros(4, **f32), persistent=False)
        self.register_buffer("rc32", None, persistent=False)
        # the finest level's second iterate: each tile phase reads one, writes
        # the other
        self.register_buffer("q0", torch.zeros(self.qshape, **f32), persistent=False)
        self.plan = plan_for(coarse, self.qshape, self.cfg.pre_sweeps, self.cfg.post_sweeps,
                             masked=self.MASKED, pin_mean=self.cfg.pin_mean and not self.MASKED,
                             corr_opt=self.cfg.corr_opt, sms=device_sms(device))
        self._plan_ints = self.plan.c_ints()
        self._grid_ready = False  # ready_grid before the first launch
        # the pre-smoothed iterates of the coarse levels the grid runs in tiles
        for k, (lv, (rows, _)) in enumerate(zip(coarse, self.plan.level_tiles), start=1):
            if rows:
                self.register_buffer(f"q{k}", torch.zeros(lv.shape, **f32), persistent=False)

    def forward(self, p_warm: torch.Tensor, b: torch.Tensor, max_b=None):
        _check(self.qshape, p_warm, b)
        if route(p_warm, b) == "cuda":
            return self.kernel(p_warm, b, max_b)
        return self.plain(p_warm, b, max_b)

    def plain(self, p_warm, b, max_b=None):
        p, cycles, res = mgp.tolerance_loop(p_warm, b, max_b, self.cfg,
                                            lambda p, bb: self.mg.cycle(p, bb, plain=True))
        return (p, *stats_tensors(cycles, res, p.device))

    def kernel(self, p_warm, b, max_b=None):
        if max_b is not None and (max_b.device != p_warm.device or max_b.numel() != 1
                                  or max_b.dtype != torch.float32):
            raise ValueError(f"max_b must be one float32 value on {p_warm.device}, got "
                             f"{max_b.dtype} {tuple(max_b.shape)} on {max_b.device}")
        record, masked, scratch, common = self.launch_args(p_warm)
        if not self._grid_ready:
            ready_grid(self.plan, self.ctl.device, "cfd_whole_solve_grid", masked)
            self._grid_ready = True
        p_out = torch.empty_like(p_warm)
        stats = torch.empty(2, dtype=torch.int32, device=p_warm.device)
        opt = lambda t: ptr(t) if t is not None else ctypes.c_void_p(None)
        record(p_warm, masked, ptr(p_warm), ptr(b), ptr(p_out), *scratch, opt(max_b),
               ptr(self.ctl), ptr(stats), *common)
        return (p_out, *split_stats(stats))

    def launch_args(self, like, plan_ints=None):
        """(launch counter, masked, (q0, filled), the C arguments of
        cfd_whole_solve after ``stats``) for a launch on ``like``'s device
        (the casts of the host arrays keep them alive); ``plan_ints``: the
        plan's host array in place of this solve's (the whole step's)."""
        if like.device != self.ctl.device:
            raise ValueError(f"tensor on {like.device}, solver buffers on "
                             f"{self.ctl.device}")
        cfg = self.cfg
        coarse, fine_ptrs, fine_ints, fine_floats, scratch, record, pin = self._fine()
        idims, fdims, ptr_arr = level_arrays(
            coarse, [getattr(self, f"p{k}") for k in range(1, len(coarse) + 1)],
            [getattr(self, f"b{k}") for k in range(1, len(coarse) + 1)],
            [getattr(self, f"q{k}", None) for k in range(1, len(coarse) + 1)])
        opt = lambda t: ptr(t) if t is not None else ctypes.c_void_p(None)
        as_ptr = lambda a: ctypes.cast(a, ctypes.c_void_p)
        common = (ptr(self.mg.pinv), *map(opt, fine_ptrs), self.qshape[1],
                  self.qshape[2], *fine_ints, *fine_floats, len(coarse), as_ptr(idims),
                  as_ptr(fdims), as_ptr(ptr_arr), cfg.omega, cfg.pre_sweeps,
                  cfg.post_sweeps, cfg.max_cycles, cfg.tol_factor, cfg.abs_tol,
                  cfg.stall_ratio, pin[0], opt(pin[1]), pin[2],
                  int(self.mg.store_dtype is not None), int(cfg.corr_opt), opt(self.rc32),
                  as_ptr(self._plan_ints if plan_ints is None else plan_ints))
        return record, int(self.MASKED), tuple(map(opt, scratch)), common


class WholeSolve(_WholeSolveBase):
    """The separable quad-level-0 multigrid solve of ``problem`` on the
    padded grid ``shape``, as one launch. With ``pin_mean`` (a
    pure-Neumann problem; ``cfg.pin_mean`` is not read) every cycle ends
    with the mean pin over the nx * ny cells; with ``cfg.coarse_dtype`` the
    hierarchy rounds to bfloat16 (module docstring). The launches count on
    WHOLE_SOLVE, WHOLE_SOLVE_PIN_MEAN or their _BF16 counterparts.
    ``cfg.corr_opt`` raises ValueError, as the reference's separable
    context does."""

    def __init__(self, shape, problem, cfg: mgp.MGConfig, device="cpu",
                 pin_mean: bool = False):
        super().__init__()
        store = coarse_store_dtype(cfg)
        _, _, Hq8, Wqa = quad_dims(shape)
        coarse = (Hq8, Wqa)
        quad_l0 = (make_quad_pre_smooth_restrict(shape, problem, cfg.omega, cfg.pre_sweeps,
                                                 coarse, device=device),
                   make_quad_post_prolong_smooth(shape, problem, cfg.omega, cfg.post_sweeps,
                                                 coarse, device=device))
        cfg = dataclasses.replace(cfg, pin_mean=pin_mean)
        self.mg = mgp.MultigridPoisson(problem, hierarchy_cfg(cfg), quad_l0, device,
                                       store_dtype=store)
        if self.mg.levels[1].shape != coarse:
            raise ValueError(f"aligned coarse shape {self.mg.levels[1].shape} != quad "
                             f"plane shape {coarse}")
        self.cfg = cfg
        self.qshape = (4, Hq8, Wqa)
        self._alloc_scratch(self.mg.levels[1:], device)
        if cfg.pin_mean:  # the per-chunk partial sums of the pin
            self.register_buffer("partials", torch.zeros(
                -(-4 * Hq8 * Wqa // SUM_BLOCK), dtype=torch.float32, device=device),
                persistent=False)

    def _fine(self):
        """(coarse levels, fine weights, fine ints, fine floats, scratch,
        launch counter, (pin_mean, partials, n_int)) of the launch."""
        l0 = self.mg.pre0
        bf16 = self.mg.store_dtype is not None
        if self.cfg.pin_mean:
            record = WHOLE_SOLVE_PIN_MEAN_BF16 if bf16 else WHOLE_SOLVE_PIN_MEAN
            pin = (1, self.partials, float(self.mg.n_interior))
        else:
            record, pin = WHOLE_SOLVE_BF16 if bf16 else WHOLE_SOLVE, (0, None, 0.0)
        return (self.mg.levels[1:], (l0.wE, l0.wW, l0.wN, l0.wS), (l0.ny, l0.nx, 0, 0),
                (l0.idx2, l0.idy2, 0.0, 0.0), (self.q0, None), record, pin)


class StepWholeSolve(_WholeSolveBase):
    """The masked (backward-step) solve as one launch (cfd_tpu
    make_quad_step_whole_solve, whole_solve.py:569, body masked_vcycle_ctx
    :297-424): the exact masked fine level of kernels.step_quad, the
    full-2D-weight coarse hierarchy with the solid fill before every
    prolongation, and the tolerance loop, with the bfloat16 rounding of
    ``cfg.coarse_dtype`` and the corr_opt steplength on request. ``plain``
    is the tolerance loop over the per-kernel masked composition's twins
    (poisson.multigrid.MaskedQuadMultigridPoisson); the kernel repeats its
    arithmetic in order, so the two agree bit for bit. The launches count
    on STEP_WHOLE_SOLVE, STEP_WHOLE_SOLVE_BF16 or, with corr_opt,
    STEP_WHOLE_SOLVE_CORR_OPT."""

    MASKED = True

    def __init__(self, grid, coeffs, cfg: mgp.MGConfig, device="cpu"):
        super().__init__()
        store = coarse_store_dtype(cfg)
        self.mg = mgp.make_masked_quad_multigrid_poisson(grid, coeffs, hierarchy_cfg(cfg),
                                                         device, store_dtype=store)
        if len(self.mg.levels) < 2:
            raise ValueError("the quad-level-0 hierarchy needs at least 3 levels")
        self.cfg = cfg
        self.qshape = self.mg.pre0.qshape
        self._alloc_scratch(self.mg.levels, device)
        f32 = dict(dtype=torch.float32, device=device)
        # the solid-filled copy of a coarse correction
        lv1 = self.mg.levels[0].shape
        self.register_buffer("filled", torch.zeros(lv1, **f32), persistent=False)
        if cfg.corr_opt:  # the two sums' per-chunk partials; the unrounded rc
            self.register_buffer("partials", torch.zeros(
                2 * -(-lv1[0] * lv1[1] // SUM_BLOCK), **f32), persistent=False)
            if store is not None:
                self.register_buffer("rc32", torch.zeros(lv1, **f32), persistent=False)

    def _fine(self):
        l0 = self.mg.pre0
        if self.cfg.corr_opt:
            record, pin = STEP_WHOLE_SOLVE_CORR_OPT, (0, self.partials, 0.0)
        else:
            bf16 = self.mg.store_dtype is not None
            record, pin = STEP_WHOLE_SOLVE_BF16 if bf16 else STEP_WHOLE_SOLVE, (0, None, 0.0)
        return (self.mg.levels, (None,) * 4, (l0.ny, l0.nx, l0.step_i, l0.inlet_j),
                (l0.idx2, l0.idy2, l0.denom, 1.0 - l0.omega), (self.q0, self.filled),
                record, pin)


def make_quad_whole_solve(shape, problem, cfg: mgp.MGConfig, device="cpu",
                          pin_mean: bool = False) -> WholeSolve:
    return WholeSolve(shape, problem, cfg, device, pin_mean)


def make_quad_step_whole_solve(grid, coeffs, cfg: mgp.MGConfig, device="cpu"
                               ) -> StepWholeSolve:
    return StepWholeSolve(grid, coeffs, cfg, device)


def auto_whole_solve(mg: mgp.MGConfig, mg_overrides, on_cuda: bool, build, fallback):
    """The reference's default policy for the f32 quad factories
    (cfd_tpu.kernels.whole_solve.auto_whole_solve) with "device is cuda" in
    place of "platform is tpu and not interpret": the whole-solve on the
    card, the per-kernel composition on the CPU. An explicit fusion knob in
    mg_overrides (whole_solve, whole_step, tail_from, coarse_dtype) takes
    manual control. Build rejections raise; nothing is swallowed.
    Returns ``(solve, mg)`` with ``mg.whole_solve`` set to the path taken.
    corr_opt is not a manual knob: the masked whole-solve takes it in the
    kernel (tests/test_corr_opt.py:134)."""
    if mg.whole_solve:
        return build(), mg
    manual = bool(mg_overrides) and any(
        k in mg_overrides for k in ("whole_solve", "whole_step", "tail_from", "coarse_dtype"))
    if not on_cuda or manual or mg.whole_step or mg.tail_from is not None:
        return fallback(), mg
    return build(), dataclasses.replace(mg, whole_solve=True)
