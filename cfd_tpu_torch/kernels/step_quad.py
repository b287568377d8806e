"""Quad-layout kernels of the backward-facing step (the port of
cfd_tpu.kernels.step_quad).

The step's solid block is the rectangle {i <= step_i and j > inlet_j}
(backwards_step-01.cpp:499-520), expressed as per-plane conditions on the
global (row, column) iotas:

* fluid    = in-range & ~(c <= step_i & g > inlet_j)
* u_valid  = u-range & ~((c < step_i) & (g > inlet_j))
* v_valid  = v-range & fluid
* u-zero   = (c == step_i) & (inlet_j < g <= ny), v-zero = (g == inlet_j) &
  (1 <= c <= step_i): the solid-interface faces, zeroed last by the BCs
* solid-cell pressure ghosts: the east column c == step_i (< nx) and the
  bottom row g == inlet_j + 1 (> 1) of the block take the mean of their
  fluid neighbours (backwards_step-01.cpp:708-739).

Each kernel has the three faces of kernels.quad: ``plain`` (whole-array
PyTorch, any device), ``kernel`` (csrc/step_stage.cu, csrc/step_vcycle.cu;
CUDA tensors only) and ``__call__``/``forward``, which sends CPU tensors to
``plain`` and CUDA tensors to ``kernel`` and never falls back. The
adaptive-stepping instances (``traced_dt``, and ``emit_courant`` on the
carry) follow kernels.quad's. ``shard=(P, mdy)``: the carry, pre and post
on one shard's local block of a plane-row mesh (row 16f,
parallel.quad_sharded), the kernels.quad *Shard contract, and the carry's
traced-dt + Courant instance there (row 16f+: the sharded lagged
controller).
"""

from __future__ import annotations

import torch
from torch import nn

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.plan import step_corrector_plan
from cfd_tpu_torch.kernels.quad import (
    DEV_HALO,
    _band_maker,
    _bilinear_corr,
    _block_rows,
    _check,
    _courant,
    _crop_rows,
    _pad_rows,
    _predictor_quad,
    _qiota,
    _qshift,
    _restrict_rc,
    _ShardTraced,
    _Traced,
    _where4,
    fixed_order_sum,
    level0_post,
    level0_pre,
    own_row_sum,
    own_rows,
    quad_dims,
    quad_shape,
    rho_over,
    sum_scratch,
    tile_plan_ptr,
)
from cfd_tpu_torch.ops.stencil import StencilCoeffs

STEP_CARRY = Kernel("quad_step_corr_predictor_source", "cfd_step_carry",
                    "cfd_tpu_torch/csrc/step_stage.cu", "cfd_tpu/kernels/step_quad.py:100")
STEP_CORRECTOR = Kernel("quad_step_corrector", "cfd_step_corrector",
                        "cfd_tpu_torch/csrc/step_stage.cu",
                        "cfd_tpu/kernels/step_quad.py:204")
STEP_PRE = Kernel("quad_step_pre_smooth_restrict", "cfd_step_pre_smooth_restrict",
                  "cfd_tpu_torch/csrc/step_vcycle.cu", "cfd_tpu/kernels/step_quad.py:354")
STEP_POST = Kernel("quad_step_post_prolong_smooth", "cfd_step_post_prolong_smooth",
                   "cfd_tpu_torch/csrc/step_vcycle.cu", "cfd_tpu/kernels/step_quad.py:419")
STEP_CORRECTOR_TRACED = Kernel("quad_step_corrector_traced", "cfd_step_corrector_traced",
                               "cfd_tpu_torch/csrc/step_stage.cu",
                               "cfd_tpu/kernels/step_quad.py:204")
STEP_CARRY_ADAPTIVE = Kernel("quad_step_corr_predictor_source_adaptive",
                             "cfd_step_carry_adaptive", "cfd_tpu_torch/csrc/step_stage.cu",
                             "cfd_tpu/kernels/step_quad.py:100")
# the carry, pre and post on one shard's local block of the plane-row mesh
# (parallel.quad_sharded), counted apart
SHARD_STEP_CARRY = Kernel("quad_step_corr_predictor_source_shard", "cfd_step_carry",
                          "cfd_tpu_torch/csrc/step_stage.cu",
                          "cfd_tpu/kernels/step_quad.py:100 (shard=)")
SHARD_STEP_PRE = Kernel("quad_step_pre_smooth_restrict_shard", "cfd_step_pre_smooth_restrict",
                        "cfd_tpu_torch/csrc/step_vcycle.cu",
                        "cfd_tpu/kernels/step_quad.py:354 (shard=)")
SHARD_STEP_POST = Kernel("quad_step_post_prolong_smooth_shard", "cfd_step_post_prolong_smooth",
                         "cfd_tpu_torch/csrc/step_vcycle.cu",
                         "cfd_tpu/kernels/step_quad.py:419 (shard=)")
SHARD_STEP_CARRY_ADAPTIVE = Kernel("quad_step_corr_predictor_source_shard_adaptive",
                                   "cfd_step_carry_adaptive",
                                   "cfd_tpu_torch/csrc/step_stage.cu",
                                   "cfd_tpu/kernels/step_quad.py:100 (shard=, traced_dt)")


def _step_masks(grow, gcol, ny: int, nx: int, step_i: int, inlet_j: int):
    """(fluid, u_valid, v_valid) per plane from the global iotas."""
    fluid, u_valid, v_valid = [], [], []
    for g, c in zip(grow, gcol):
        in_range = (g >= 1) & (g <= ny) & (c >= 1) & (c <= nx)
        fluid.append(in_range & ~((c <= step_i) & (g > inlet_j)))
        u_rng = (g >= 1) & (g <= ny) & (c >= 1) & (c <= nx - 1)
        u_valid.append(u_rng & ~((c < step_i) & (g > inlet_j)))
        v_rng = (g >= 1) & (g <= ny - 1) & (c >= 1) & (c <= nx)
        v_valid.append(v_rng & ~((c <= step_i) & (g > inlet_j)))
    return fluid, u_valid, v_valid


def step_cell_mask(shape, step_i: int, inlet_j: int, device) -> torch.Tensor:
    """(4, Hq8, Wqa) bool: the fluid cells of the padded (H, W) step grid in
    the quad layout (where b lives and the source mean is removed)."""
    _, Hq8, Wqa = quad_shape(shape)
    grow, gcol = _qiota(Hq8, Wqa, device)
    return torch.stack(_step_masks(grow, gcol, shape[0] - 2, shape[1] - 2, step_i,
                                   inlet_j)[0])


def _step_bc_quad(u, v, grow, gcol, ny: int, nx: int, step_i: int, inlet_j: int,
                  uin: float):
    """step_bc in quad form (cfd_tpu/kernels/step_quad.py:60-97): the channel
    BCs with the inlet on rows g <= inlet_j, then the interface zeroing, in
    the reference's update order."""
    gc = list(zip(grow, gcol))
    zeros = lambda planes: [torch.zeros_like(a) for a in planes]
    u = _where4([(c == 0) & (g >= 1) & (g <= inlet_j) for g, c in gc],
                [torch.full_like(a, uin) for a in u], u)
    u = _where4([(c == 0) & (g > inlet_j) & (g <= ny) for g, c in gc], zeros(u), u)
    v = _where4([(c == 0) & (g <= ny) for g, c in gc], zeros(v), v)
    u = _where4([(c == nx) & (g >= 1) & (g <= ny) for g, c in gc], _qshift(u, 0, -1), u)
    v = _where4([(c == nx + 1) & (g <= ny) for g, c in gc], _qshift(v, 0, -1), v)
    v = _where4([(g == 0) & (c >= 1) & (c <= nx) for g, c in gc], zeros(v), v)
    u = _where4([(g == 0) & (c <= nx) for g, c in gc], [-a for a in _qshift(u, 1, 0)], u)
    v = _where4([(g == ny) & (c >= 1) & (c <= nx) for g, c in gc], zeros(v), v)
    u = _where4([(g == ny + 1) & (c <= nx) for g, c in gc],
                [-a for a in _qshift(u, -1, 0)], u)
    u = _where4([(c == step_i) & (g > inlet_j) & (g <= ny) for g, c in gc], zeros(u), u)
    v = _where4([(g == inlet_j) & (c >= 1) & (c <= step_i) for g, c in gc], zeros(v), v)
    return u, v


def uncorrect_step_quad(u, v, p, shape, coeffs: StencilCoeffs, step_i: int,
                        inlet_j: int, dt: float | None = None):
    """Inverse of the masked pressure correction on NATURAL arrays (the
    resume boundary): us = u + c*(pE - p) on valid faces, 0 elsewhere
    (cfd_tpu/kernels/step_quad.py:244). ``dt`` (a Python float) overrides
    coeffs.dt (the adaptive carry's entry)."""
    H, Wp = shape
    ny, nx = H - 2, Wp - 2
    dt = coeffs.dt if dt is None else dt
    cu = dt / (coeffs.density * coeffs.dx)
    cv = dt / (coeffs.density * coeffs.dy)
    jj = torch.arange(H, device=u.device)[:, None]
    ii = torch.arange(Wp, device=u.device)[None, :]
    u_valid = ((jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx - 1)
               & ~((ii < step_i) & (jj > inlet_j)))
    v_valid = ((jj >= 1) & (jj <= ny - 1) & (ii >= 1) & (ii <= nx)
               & ~((ii <= step_i) & (jj > inlet_j)))
    pE = torch.roll(p, -1, dims=1)
    pN = torch.roll(p, -1, dims=0)
    zero = torch.zeros_like(u)
    return (torch.where(u_valid, u + cu * (pE - p), zero),
            torch.where(v_valid, v + cv * (pN - p), zero))


# ------------------------------------------------------------- stage kernels

class _StepStage:
    """Shared geometry of the stage kernels; (us, vs, p) quad fields in."""

    def __init__(self, shape, coeffs: StencilCoeffs, step_i: int, inlet_j: int,
                 inlet_velocity: float = 1.0):
        self.qshape = quad_shape(shape)
        self.ny, self.nx = shape[0] - 2, shape[1] - 2
        self.step_i, self.inlet_j = step_i, inlet_j
        self.uin = inlet_velocity
        self.coeffs = coeffs
        # rho-DIVIDED correction (backwards_step-01.cpp, as the channel)
        self.cu = coeffs.dt / (coeffs.density * coeffs.dx)
        self.cv = coeffs.dt / (coeffs.density * coeffs.dy)

    def __call__(self, us, vs, p):
        _check(self.qshape, us, vs, p)
        if route(us, vs, p) == "cuda":
            return self.kernel(us, vs, p)
        return self.plain(us, vs, p)

    def _geometry(self, device):
        grow, gcol = _qiota(self.qshape[1], self.qshape[2], device)
        masks = _step_masks(grow, gcol, self.ny, self.nx, self.step_i, self.inlet_j)
        return grow, gcol, masks

    def _bc(self, u, v, grow, gcol):
        return _step_bc_quad(u, v, grow, gcol, self.ny, self.nx, self.step_i,
                             self.inlet_j, self.uin)

    def _corrected(self, us, vs, p, grow, gcol, u_valid, v_valid, cu=None, cv=None):
        cu = self.cu if cu is None else cu
        cv = self.cv if cv is None else cv
        pE, pN = _qshift(list(p), 0, 1), _qshift(list(p), 1, 0)
        u, v = [], []
        for q in range(4):
            zero = torch.zeros_like(us[q])
            u.append(torch.where(u_valid[q], us[q] - cu * (pE[q] - p[q]), zero))
            v.append(torch.where(v_valid[q], vs[q] - cv * (pN[q] - p[q]), zero))
        return self._bc(u, v, grow, gcol)

    def _ints(self):
        _, Hq8, Wqa = self.qshape
        return (Hq8, Wqa, self.ny, self.nx, self.step_i, self.inlet_j)


class QuadStepCorrector(_StepStage):
    """(us4, vs4, p4) -> (u4, v4): the rho-divided projection on valid faces
    and the step BCs (cfd_tpu/kernels/step_quad.py:204). Used at the
    stats/export boundary (cases/backwards_step.py unalign_state). On the
    card: one launch of one thread a plane cell over all four quads
    (csrc/step_stage.cu step_corrector_kernel, kernels/plan.py
    step_corrector_plan)."""

    def plain(self, us, vs, p):
        grow, gcol, (_, u_valid, v_valid) = self._geometry(us.device)
        u, v = self._corrected(us, vs, p, grow, gcol, u_valid, v_valid)
        return torch.stack(u), torch.stack(v)

    def kernel(self, us, vs, p):
        u2, v2 = torch.empty_like(us), torch.empty_like(us)
        STEP_CORRECTOR(us, ptr(us), ptr(vs), ptr(p), ptr(u2), ptr(v2), *self._ints(),
                       self.cu, self.cv, self.uin, *self._launch_block())
        return u2, v2

    def _launch_block(self):
        """(rows, cols) of ``self._tile_plan``'s block, the C entry points'
        arguments (unless set before the first launch, kernels/plan.py
        step_corrector_plan on the field; the card tests' and the sweep's
        hook)."""
        if getattr(self, "_tile_plan", None) is None:
            self._tile_plan = step_corrector_plan(self.qshape)
        return self._tile_plan.rows, self._tile_plan.cols


class QuadStepCorrPredictorSource(_StepStage):
    """Tentative-state step stage (cfd_tpu/kernels/step_quad.py:100, math in
    step_carry_compute :144): (us, vs, p) -> (us', vs', b', sum b'). The
    rho-divided correction on valid faces, the step BCs, the MAC predictor
    on valid faces, the step BCs on the tentative fields, b = rho/dt * div
    on FLUID cells and its sum (b is 0 elsewhere), which the caller removes
    over n_fluid. No warm-start output: the step warm-starts from plain p.
    ``sum b'`` is a 0-d float32 tensor summed in fixed_order_sum's order. On
    the card it is one launch over shared-memory tiles (csrc/step_stage.cu
    step_carry_kernel) and one for the sum (carry_tile.cuh source_sum)."""

    def plain(self, us, vs, p):
        return self._stage(us, vs, p)[:4]

    def _stage(self, us, vs, p, cu=None, cv=None, dt=None):
        """(us', vs', b', sum b', u, v): the stage with the corrected fields
        u, v, at the host's coefficients or the traced ones."""
        grow, gcol, masks = self._geometry(us.device)
        u, v = self._corrected(us, vs, p, grow, gcol, *masks[1:], cu, cv)
        us2, vs2, b = self._source(u, v, grow, gcol, masks, dt)
        return us2, vs2, b, fixed_order_sum(b), torch.stack(u), torch.stack(v)

    def _source(self, u, v, grow, gcol, masks, dt=None):
        """(us', vs', b'): the predictor on the valid faces of the corrected
        u, v, the step BCs on the tentative fields, b on the fluid cells."""
        c = self.coeffs
        fluid, u_valid, v_valid = masks
        us_raw, vs_raw = _predictor_quad(u, v, c, dt)
        zero = torch.zeros_like(u[0])
        us2 = [torch.where(u_valid[q], us_raw[q], zero) for q in range(4)]
        vs2 = [torch.where(v_valid[q], vs_raw[q], zero) for q in range(4)]
        us2, vs2 = self._bc(us2, vs2, grow, gcol)
        usW, vsS = _qshift(us2, 0, -1), _qshift(vs2, -1, 0)
        rho_dt = rho_over(c, dt)
        b = []
        for q in range(4):
            div = (us2[q] - usW[q]) * c.idx + (vs2[q] - vsS[q]) * c.idy
            b.append(torch.where(fluid[q], rho_dt * div, torch.zeros_like(div)))
        return torch.stack(us2), torch.stack(vs2), torch.stack(b)

    def kernel(self, us, vs, p):
        return _step_carry(self, STEP_CARRY, (us, vs, p), 0, 0)


def _step_carry(op, kern: Kernel, fields, row_base: int, halo: int):
    """One call of cfd_step_carry through ``kern`` (its counter): (us', vs',
    b', sum b'), the sum over the own rows of a block with a ``halo``-row
    strip."""
    us, vs, p = fields
    us2, vs2, b = (torch.empty_like(us) for _ in range(3))
    partials, count = sum_scratch(op, us)
    sum_b = torch.empty((), dtype=torch.float32, device=us.device)
    c = op.coeffs
    plan = tile_plan_ptr(op, "step", us.device, "cfd_step_carry_grid", False, halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(us2), ptr(vs2), ptr(b), ptr(partials), ptr(count),
         ptr(sum_b), *op._ints(), op.cu, op.cv, op.uin, c.dt, c.viscosity, c.idx, c.idy,
         c.idx2, c.idy2, c.density / c.dt, row_base, halo, plan)
    return us2, vs2, b, sum_b


class QuadStepCorrPredictorSourceShard(QuadStepCorrPredictorSource):
    """The step carry on one shard's local block (row 16f,
    cfd_tpu/kernels/step_quad.py:100 with shard=(P, mdy)): (row_base, us,
    vs, p) -> (us', vs', b', sum_own) on (4, P + 16, Wqa) blocks. row_base =
    jy * P - 8 is the global plane row of local row 0, so the masks, the
    inlet rows and the interface faces keep their global meaning; sum_own
    is the own rows' sum of b (own_row_sum): the shard's partial, which the
    caller adds over the shards.

    The twin is the single-device twin on the block padded with DEV_HALO
    zero rows either side, the corrected u, v zeroed on the padding: the
    kernel (csrc/step_stage.cu) reads 0 outside the block and its tiles hold
    the corrected u, v of the block only. The stages reach 5 rows
    (kStepRadius there), so the own rows equal the single-device carry's.
    On the card: row 9a's two launches, their block instances (the tiles'
    maxima and the sum over the own rows)."""

    def __init__(self, shape, coeffs: StencilCoeffs, step_i: int, inlet_j: int,
                 inlet_velocity: float = 1.0, shard: tuple[int, int] = (8, 1)):
        super().__init__(shape, coeffs, step_i, inlet_j, inlet_velocity)
        P, _ = shard
        if P % 8:
            raise ValueError(f"shard rows must be a multiple of 8, got {P}")
        self.P = P
        self.qshape = (4, P + 2 * DEV_HALO, self.qshape[2])

    def __call__(self, row_base: int, us, vs, p):
        _check(self.qshape, us, vs, p)
        if route(us, vs, p) == "cuda":
            return self.kernel(row_base, us, vs, p)
        return self.plain(row_base, us, vs, p)

    def plain(self, row_base, us, vs, p):
        us2, vs2, b, _, _ = self._block_stage(row_base, us, vs, p)
        return us2, vs2, b, own_row_sum(b, self.P)

    def _block_stage(self, row_base, us, vs, p, cu=None, cv=None, dt=None):
        """(us', vs', b', u, v) on the block, u and v the corrected, BC'd
        fields, at the host's coefficients or the traced ones."""
        z, H = DEV_HALO, self.qshape[1]
        grow, gcol = _qiota(H + 2 * z, self.qshape[2], us.device, row_base - z)
        masks = _step_masks(grow, gcol, self.ny, self.nx, self.step_i, self.inlet_j)
        u, v = self._corrected(*(_pad_rows(t, z) for t in (us, vs, p)), grow, gcol,
                               *masks[1:], cu, cv)
        block = _block_rows(H, z, us.device)
        u = [torch.where(block, a, torch.zeros_like(a)) for a in u]
        v = [torch.where(block, a, torch.zeros_like(a)) for a in v]
        return tuple(_crop_rows(t, z) for t in (*self._source(u, v, grow, gcol, masks, dt),
                                                torch.stack(u), torch.stack(v)))

    def kernel(self, row_base, us, vs, p):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _step_carry(self, SHARD_STEP_CARRY, (us, vs, p), int(row_base), DEV_HALO)


class QuadStepCorrectorTraced(_Traced, QuadStepCorrector):
    """(dt, us4, vs4, p4) -> (u4, v4): the step corrector with a traced dt
    (cfd_tpu/kernels/step_quad.py:204 traced_dt, cu = dt / (rho*dx)): the
    lagged controller's logical boundary."""

    def __init__(self, shape, coeffs: StencilCoeffs, step_i: int, inlet_j: int,
                 inlet_velocity: float = 1.0):
        super().__init__(shape, coeffs, step_i, inlet_j, inlet_velocity)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dt, us, vs, p):
        grow, gcol, (_, u_valid, v_valid) = self._geometry(us.device)
        u, v = self._corrected(us, vs, p, grow, gcol, u_valid, v_valid,
                               *self._coeffs_at(dt))
        return torch.stack(u), torch.stack(v)

    def kernel(self, dt, us, vs, p):
        u2, v2 = torch.empty_like(us), torch.empty_like(us)
        STEP_CORRECTOR_TRACED(us, ptr(us), ptr(vs), ptr(p), ptr(u2), ptr(v2), ptr(dt),
                              *self._ints(), self.cu_f, self.cv_f, self.uin,
                              *self._launch_block())
        return u2, v2


class QuadStepCorrPredictorSourceAdaptive(_Traced, QuadStepCorrPredictorSource):
    """The step carry with traced_dt and emit_courant
    (cfd_tpu/kernels/step_quad.py:100): (dts, us, vs, p) -> (us', vs', b',
    sum b', max|u|, max|v|), dts = (dt_corr, dt_pred) as kernels.quad's
    adaptive carries. On the card: the fixed carry's tile kernel, its
    adaptive instance, after one zeroing of the two maxima, and the sum
    launch."""

    n_dt = 2

    def __init__(self, shape, coeffs: StencilCoeffs, step_i: int, inlet_j: int,
                 inlet_velocity: float = 1.0):
        super().__init__(shape, coeffs, step_i, inlet_j, inlet_velocity)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dts, us, vs, p):
        us2, vs2, b, sum_b, u, v = self._stage(us, vs, p, *self._coeffs_at(dts[0]),
                                               dt=dts[1])
        return us2, vs2, b, sum_b, *_courant(u, v)

    def kernel(self, dts, us, vs, p):
        return _step_carry_adaptive(self, STEP_CARRY_ADAPTIVE, dts, (us, vs, p), 0, 0)


class QuadStepCorrPredictorSourceShardAdaptive(_ShardTraced,
                                               QuadStepCorrPredictorSourceShard):
    """The step carry with traced_dt and emit_courant on one shard's local
    block (row 16f+, cfd_tpu/kernels/step_quad.py:100 with shard=(P, mdy),
    traced_dt=True, emit_courant=True): (row_base, dts, us, vs, p) -> (us',
    vs', b', sum_own, max|u|, max|v|), the fluid-cell sum and the maxima
    over the own rows only. The twin is QuadStepCorrPredictorSourceShard's
    at QuadStepCorrPredictorSourceAdaptive's traced coefficients. On the
    card: row 9a+'s launches, their block instances."""

    def __init__(self, shape, coeffs: StencilCoeffs, step_i: int, inlet_j: int,
                 inlet_velocity: float = 1.0, shard: tuple[int, int] = (8, 1)):
        super().__init__(shape, coeffs, step_i, inlet_j, inlet_velocity, shard)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, row_base, dts, us, vs, p):
        us2, vs2, b, u, v = self._block_stage(row_base, us, vs, p, *self._coeffs_at(dts[0]),
                                              dt=dts[1])
        own = lambda t: own_rows(t, self.P)
        return us2, vs2, b, own_row_sum(b, self.P), *_courant(own(u), own(v))

    def kernel(self, row_base, dts, us, vs, p):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _step_carry_adaptive(self, SHARD_STEP_CARRY_ADAPTIVE, dts, (us, vs, p),
                                        int(row_base), DEV_HALO)


def _step_carry_adaptive(op, kern: Kernel, dts, fields, row_base: int, halo: int):
    """One call of cfd_step_carry_adaptive through ``kern`` (its counter):
    (us', vs', b', sum b', max|u|, max|v|), the reductions over the own rows
    of a block with a ``halo``-row strip."""
    us, vs, p = fields
    us2, vs2, b = (torch.empty_like(us) for _ in range(3))
    partials, count = sum_scratch(op, us)
    scal = torch.empty(3, dtype=torch.float32, device=us.device)  # sum b, max|u|, max|v|
    c = op.coeffs
    plan = tile_plan_ptr(op, "step", us.device, "cfd_step_carry_grid", True, halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(us2), ptr(vs2), ptr(b), ptr(partials), ptr(count),
         ptr(scal), ptr(scal[1:]), ptr(dts), *op._ints(), op.cu_f, op.cv_f, op.uin,
         c.viscosity, c.idx, c.idy, c.idx2, c.idy2, c.density, row_base, halo, plan)
    return us2, vs2, b, scal[0], scal[1], scal[2]


def make_quad_step_corrector(shape, coeffs, step_i: int, inlet_j: int,
                             inlet_velocity: float = 1.0, traced_dt: bool = False
                             ) -> QuadStepCorrector:
    cls = QuadStepCorrectorTraced if traced_dt else QuadStepCorrector
    return cls(shape, coeffs, step_i, inlet_j, inlet_velocity)


def make_quad_step_corr_predictor_source(shape, coeffs, step_i: int, inlet_j: int,
                                         inlet_velocity: float = 1.0, adaptive: bool = False,
                                         shard: tuple[int, int] | None = None
                                         ) -> QuadStepCorrPredictorSource:
    """``adaptive``: the traced_dt + emit_courant instance. ``shard=(P,
    mdy)``: the kernel of one shard's local block
    (QuadStepCorrPredictorSourceShard, with ``adaptive``
    QuadStepCorrPredictorSourceShardAdaptive)."""
    if shard is not None:
        cls = (QuadStepCorrPredictorSourceShardAdaptive if adaptive
               else QuadStepCorrPredictorSourceShard)
        return cls(shape, coeffs, step_i, inlet_j, inlet_velocity, shard)
    cls = QuadStepCorrPredictorSourceAdaptive if adaptive else QuadStepCorrPredictorSource
    return cls(shape, coeffs, step_i, inlet_j, inlet_velocity)


# ------------------------------------------------- the exact masked level 0

def _step_ghosts_quad(p, grow, gcol, ny: int, nx: int, step_i: int, inlet_j: int):
    """The exact pressure ghosts (cfd_tpu/kernels/step_quad.py:270-302):
    the channel domain ghosts from the OLD values (column 0 = column 1,
    column nx+1 = 0, row 0 = row 1, row ny+1 = row ny), then each solid
    cell on the block's east column (c == step_i < nx) or bottom row
    (g == inlet_j + 1 > 1) takes the mean of its east/south fluid neighbour."""
    row_in = [(g >= 1) & (g <= ny) for g in grow]
    col_in = [(c >= 1) & (c <= nx) for c in gcol]
    p = _where4([(c == 0) & r for c, r in zip(gcol, row_in)], _qshift(p, 0, 1), p)
    p = _where4([(c == nx + 1) & r for c, r in zip(gcol, row_in)],
                [torch.zeros_like(a) for a in p], p)
    p = _where4([(g == 0) & ci for g, ci in zip(grow, col_in)], _qshift(p, 1, 0), p)
    p = _where4([(g == ny + 1) & ci for g, ci in zip(grow, col_in)], _qshift(p, -1, 0), p)
    pE, pS = _qshift(p, 0, 1), _qshift(p, -1, 0)
    out = []
    for q in range(4):
        g, c = grow[q], gcol[q]
        solid = row_in[q] & col_in[q] & (c <= step_i) & (g > inlet_j)
        eastw = solid & (c == step_i) & (c < nx)
        southw = solid & (g == inlet_j + 1) & (g > 1)
        cnt = eastw.to(p[q].dtype) + southw.to(p[q].dtype)
        has = cnt > 0
        inv = torch.where(has, 1.0 / torch.where(has, cnt, torch.ones_like(cnt)),
                          torch.zeros_like(cnt))
        zero = torch.zeros_like(p[q])
        avg = (torch.where(eastw, pE[q], zero) + torch.where(southw, pS[q], zero)) * inv
        out.append(torch.where(has, avg, p[q]))
    return out


class _StepLevel0(nn.Module):
    """Shared constants of the exact masked finest-level kernels. The
    Gauss-Seidel update is (1 - omega)*p + omega*gs with gs = (idx2*(E + W)
    + idy2*(N + S) - b) / denom, denom = 2*(idx2 + idy2), the reference's
    unweighted 5-point operator over the ghosts (multigrid.py:995-999).

    ``shard=(P, mdy)``: the kernels of one shard's local block (4, P + 16,
    Wqa) of an mdy-way plane-row mesh, whose level-1 block is (P + 16,
    Wqa)."""

    def __init__(self, shape, step_i: int, inlet_j: int, idx2: float, idy2: float,
                 omega: float, n_pairs: int, coarse_shape, device="cpu",
                 shard: tuple[int, int] | None = None):
        super().__init__()
        _, _, Hq8, Wqa = quad_dims(shape)
        if shard is not None:
            P, _ = shard
            if P % 8:
                raise ValueError(f"shard rows must be a multiple of 8, got {P}")
            Hq8 = P + 2 * DEV_HALO
        if tuple(coarse_shape) != (Hq8, Wqa):
            raise ValueError(f"coarse shape {tuple(coarse_shape)} != quad plane "
                             f"shape {(Hq8, Wqa)}")
        if n_pairs < 1:
            raise ValueError(f"n_pairs must be >= 1, got {n_pairs}")
        self.qshape = (4, Hq8, Wqa)
        self.coarse_shape = (Hq8, Wqa)
        self.ny, self.nx = shape[0] - 2, shape[1] - 2
        self.step_i, self.inlet_j = step_i, inlet_j
        self.idx2, self.idy2 = idx2, idy2
        self.denom = 2.0 * (idx2 + idy2)
        self.omega = omega
        self.n_pairs = n_pairs
        self.device = torch.device(device)

    def _geometry(self, device):
        grow, gcol = _qiota(self.qshape[1], self.qshape[2], device)
        fluid = _step_masks(grow, gcol, self.ny, self.nx, self.step_i, self.inlet_j)[0]
        return grow, gcol, fluid

    def _ghosts(self, p, grow, gcol):
        return _step_ghosts_quad(p, grow, gcol, self.ny, self.nx, self.step_i,
                                 self.inlet_j)

    def _ghost_stage(self, p, grow, gcol, band, k):
        """Ghost stage number k of the ledger: its output on the rows of
        band(k), its input elsewhere (every row without a band)."""
        pg = self._ghosts(p, grow, gcol)
        if band is None:
            return pg
        return [torch.where(band(k), g, x) for g, x in zip(pg, p)]

    def _smooth(self, p, b, grow, gcol, fluid, band=None):
        """n_pairs exact (ghosts, red planes, black planes) iterations, then
        the trailing ghosts (step_quad.py:305-336); on a local block stage k
        of that ledger (from 1) writes the rows of ``band(k)`` only."""
        idx2, idy2, omega = self.idx2, self.idy2, self.omega
        # a device tensor: on CUDA a Python divisor becomes a reciprocal
        # multiply, which the kernel's true division would not match
        denom = torch.tensor(self.denom, dtype=torch.float32, device=b[0].device)

        def half(p, upd, k):
            E, Wm = _qshift(p, 0, 1), _qshift(p, 0, -1)
            N, S = _qshift(p, 1, 0), _qshift(p, -1, 0)
            out = list(p)
            for q in upd:
                gs = (idx2 * (E[q] + Wm[q]) + idy2 * (N[q] + S[q]) - b[q]) / denom
                val = (1.0 - omega) * p[q] + omega * gs
                mask = fluid[q] if band is None else fluid[q] & band(k)
                out[q] = torch.where(mask, val, p[q])
            return out

        k = 0
        for _ in range(self.n_pairs):
            p = self._ghost_stage(p, grow, gcol, band, k + 1)
            p = half(p, (0, 3), k + 2)  # red: parity (r + s) even
            p = half(p, (1, 2), k + 3)
            k += 3
        return self._ghost_stage(p, grow, gcol, band, k + 1)

    def _residual(self, p, b, grow, gcol, fluid, band=None):
        """The exact residual: ghosts re-applied (the ledger's last stage on
        a local block), then where(fluid, b - lap, 0) (step_quad.py:339-351)."""
        pg = self._ghost_stage(p, grow, gcol, band, 3 * self.n_pairs + 2)
        E, Wm = _qshift(pg, 0, 1), _qshift(pg, 0, -1)
        N, S = _qshift(pg, 1, 0), _qshift(pg, -1, 0)
        out = []
        for q in range(4):
            lap = ((E[q] - 2.0 * pg[q] + Wm[q]) * self.idx2
                   + (N[q] - 2.0 * pg[q] + S[q]) * self.idy2)
            out.append(torch.where(fluid[q], b[q] - lap, torch.zeros_like(b[q])))
        return out

    def _kernel_args(self):
        _, Hq8, Wqa = self.qshape
        return (Hq8, Wqa, self.ny, self.nx, self.step_i, self.inlet_j, self.idx2,
                self.idy2, self.denom, self.omega, 1.0 - self.omega, self.n_pairs)

    def _block_geometry(self, row_base: int, device):
        """(grow, gcol, fluid, band) of a local block at ``row_base`` padded
        with DEV_HALO zero rows either side, and its band (_band_maker)."""
        z, H = DEV_HALO, self.qshape[1]
        grow, gcol = _qiota(H + 2 * z, self.qshape[2], device, row_base - z)
        fluid = _step_masks(grow, gcol, self.ny, self.nx, self.step_i, self.inlet_j)[0]
        return grow, gcol, fluid, _band_maker(row_base, H, self.ny, device, pad=z)

    def _check_device(self, t):
        if t.device.type != self.device.type:
            raise ValueError(f"tensor on {t.device}, kernel built for {self.device}")


class QuadStepPreSmoothRestrict(_StepLevel0):
    """(p4, b4) -> (p4, rc): n_pairs exact masked iterations (with the
    trailing ghosts), then the exact residual restricted by full weighting
    into the aligned level-1 source rc (Hq8, Wqa)
    (cfd_tpu/kernels/step_quad.py:354). On the card it is one launch of
    shared-memory tiles (csrc/step_vcycle.cu step_pre_kernel)."""

    def forward(self, p, b):
        _check(self.qshape, p, b)
        self._check_device(p)
        if route(p, b) == "cuda":
            return self.kernel(p, b)
        return self.plain(p, b)

    def plain(self, p, b):
        grow, gcol, fluid = self._geometry(p.device)
        P = self._smooth(list(p), list(b), grow, gcol, fluid)
        r = self._residual(P, list(b), grow, gcol, fluid)
        return torch.stack(P), _restrict_rc(r, self.ny, self.nx)

    def kernel(self, p, b):
        return level0_pre(self, STEP_PRE, p, b, 0, 0, masked=True)


class QuadStepPostProlongSmooth(_StepLevel0):
    """(p4, b4, ec) -> (p4, max|r|): the bilinear 9-3-3-1 prolongation of the
    (solid-filled) level-1 correction ec added on FLUID cells, n_pairs exact
    iterations with the trailing ghosts, and the max of the exact residual
    (cfd_tpu/kernels/step_quad.py:419). The residual is a 0-d float32
    tensor. On the card it is one launch of shared-memory tiles
    (csrc/step_vcycle.cu step_post_kernel)."""

    def forward(self, p, b, ec):
        _check(self.qshape, p, b)
        _check(self.coarse_shape, ec)
        self._check_device(p)
        if route(p, b, ec) == "cuda":
            return self.kernel(p, b, ec)
        return self.plain(p, b, ec)

    def plain(self, p, b, ec):
        grow, gcol, fluid = self._geometry(p.device)
        corr = _bilinear_corr(ec, self.ny, self.nx)
        P = [torch.where(fluid[q], p[q] + corr[q], p[q]) for q in range(4)]
        P = self._smooth(P, list(b), grow, gcol, fluid)
        r = self._residual(P, list(b), grow, gcol, fluid)
        return torch.stack(P), torch.max(torch.abs(torch.stack(r)))

    def kernel(self, p, b, ec):
        return level0_post(self, STEP_POST, p, b, ec, 0, 0, masked=True)


class QuadStepPreSmoothRestrictShard(QuadStepPreSmoothRestrict):
    """The exact masked pre-smooth + residual + restriction on one shard's
    local block (row 16f, cfd_tpu/kernels/step_quad.py:354 with shard=(P,
    mdy)): (row_base, p4, b4) -> (p4, rc) with rc the (P + 16, Wqa) local
    level-1 block. Stage k of the ledger updates the band of quad.py:
    611-627 (_band_maker); the kernel (csrc/step_vcycle.cu) reads 0 outside
    the block and takes the residual there as 0, which the twin does on the
    block padded with zero rows. The own rows equal the single-device
    kernel's."""

    def forward(self, row_base: int, p, b):
        _check(self.qshape, p, b)
        self._check_device(p)
        if route(p, b) == "cuda":
            return self.kernel(row_base, p, b)
        return self.plain(row_base, p, b)

    def plain(self, row_base, p, b):
        z, H = DEV_HALO, self.qshape[1]
        grow, gcol, fluid, band = self._block_geometry(row_base, p.device)
        bp = list(_pad_rows(b, z))
        P = self._smooth(list(_pad_rows(p, z)), bp, grow, gcol, fluid, band)
        block = _block_rows(H, z, p.device)
        r = [torch.where(block, a, torch.zeros_like(a))
             for a in self._residual(P, bp, grow, gcol, fluid, band)]
        rc = _restrict_rc(r, self.ny, self.nx, row_base - z)
        return _crop_rows(torch.stack(P), z), _crop_rows(rc, z)

    def kernel(self, row_base, p, b):
        with torch.cuda.device(p.device):  # the shards may lie on several cards
            return level0_pre(self, SHARD_STEP_PRE, p, b, int(row_base), DEV_HALO,
                              masked=True)


class QuadStepPostProlongSmoothShard(QuadStepPostProlongSmooth):
    """The prolongation + exact masked post-smooth + tolerance residual on
    one shard's local block (row 16f, cfd_tpu/kernels/step_quad.py:419 with
    shard=(P, mdy)): (row_base, p4, b4, ec) -> (p4, res) with ec the (P +
    16, Wqa) local solid-filled level-1 correction, whose row J + 1 wraps
    within the block as the TPU kernel's roll does; the ledger's bands start
    one row further in (:471-474), and res is max|r| over the own rows: the
    shard's partial."""

    def forward(self, row_base: int, p, b, ec):
        _check(self.qshape, p, b)
        _check(self.coarse_shape, ec)
        self._check_device(p)
        if route(p, b, ec) == "cuda":
            return self.kernel(row_base, p, b, ec)
        return self.plain(row_base, p, b, ec)

    def plain(self, row_base, p, b, ec):
        z, H = DEV_HALO, self.qshape[1]
        grow, gcol = _qiota(H, self.qshape[2], p.device, row_base)
        fluid = _step_masks(grow, gcol, self.ny, self.nx, self.step_i, self.inlet_j)[0]
        corr = _bilinear_corr(ec, self.ny, self.nx, row_base)
        P = [_pad_rows(torch.where(fluid[q], p[q] + corr[q], p[q]), z) for q in range(4)]
        grow, gcol, fluid, band = self._block_geometry(row_base, p.device)
        bp = list(_pad_rows(b, z))
        shifted = lambda lo: band(lo + 1)
        P = self._smooth(P, bp, grow, gcol, fluid, shifted)
        r = torch.stack(self._residual(P, bp, grow, gcol, fluid, shifted))
        own = r[:, z + DEV_HALO : z + H - DEV_HALO]
        return _crop_rows(torch.stack(P), z), torch.max(torch.abs(own))

    def kernel(self, row_base, p, b, ec):
        with torch.cuda.device(p.device):
            return level0_post(self, SHARD_STEP_POST, p, b, ec, int(row_base), DEV_HALO,
                               masked=True)


def make_quad_step_pre_smooth_restrict(shape, step_i: int, inlet_j: int, idx2: float,
                                       idy2: float, omega: float, n_pairs: int,
                                       coarse_shape, device="cpu",
                                       shard: tuple[int, int] | None = None
                                       ) -> QuadStepPreSmoothRestrict:
    """``shard=(P, mdy)``: the kernel of one shard's local block
    (QuadStepPreSmoothRestrictShard; coarse_shape is the local (P + 16,
    Wqa)). Its exact smoother's ledger (a ghost stage, red, black per pair,
    the trailing ghost stage, the residual's ghost stage, the restriction)
    consumes a row of the 8-row halo each, so n_pairs must be 1 there
    (step_quad.py:374-380)."""
    if shard is not None and n_pairs > 1:
        raise ValueError(f"sharded masked pre-smoother: n_pairs={n_pairs} consumes "
                         f"{3 * n_pairs + 5} rows > the 8-row device halo (V(1,1) only)")
    cls = QuadStepPreSmoothRestrict if shard is None else QuadStepPreSmoothRestrictShard
    return cls(shape, step_i, inlet_j, idx2, idy2, omega, n_pairs, coarse_shape, device,
               shard)


def make_quad_step_post_prolong_smooth(shape, step_i: int, inlet_j: int, idx2: float,
                                       idy2: float, omega: float, n_pairs: int,
                                       coarse_shape, device="cpu",
                                       shard: tuple[int, int] | None = None
                                       ) -> QuadStepPostProlongSmooth:
    """``shard=(P, mdy)``: the kernel of one shard's local block
    (QuadStepPostProlongSmoothShard; n_pairs 1, as the pre kernel's,
    step_quad.py:437-443)."""
    if shard is not None and n_pairs > 1:
        raise ValueError(f"sharded masked post-smoother: n_pairs={n_pairs} consumes "
                         f"{1 + 3 * n_pairs + 4} rows > the 8-row device halo (V(1,1) only)")
    cls = QuadStepPostProlongSmooth if shard is None else QuadStepPostProlongSmoothShard
    return cls(shape, step_i, inlet_j, idx2, idy2, omega, n_pairs, coarse_shape, device,
               shard)
