"""Quad-layout kernels of the Rayleigh-Benard (Boussinesq) step (the port of
cfd_tpu.kernels.rb_quad).

The carried state at the entry of step n+1 is (us*, vs*, p, T): the
TENTATIVE velocities of step n, its pressure and the temperature T_n. One
stage kernel completes step n and starts step n+1:

    corrector (rho-divided; invalid faces KEEP the tentative value, the
    u_else = us convention of physics.boussinesq) + box no-slip ghosts
      -> T' = flux-form advection + diffusion of T with the corrected
         u2/v2, then the temperature ghosts
      -> MAC predictor of u2/v2, buoyancy dt*T'_face on the valid v faces
         (invalid faces keep u2/v2), box no-slip ghosts
      -> b = rho/dt * div on the cells and its sum (the caller removes the
         mean; the Poisson problem is pure Neumann)

The ghost updates follow the reference's order (cfd_tpu/kernels/
rb_quad.py:40-78), which decides the corners: u's ghost rows read the side
columns BEFORE they are zeroed, v's ghost columns read the wall rows before
they are zeroed, T's ghost rows are written before its ghost columns and
the four T corners keep their pre-step value.

Each kernel has the three faces of kernels.quad: ``plain`` (whole-array
PyTorch, any device), ``kernel`` (csrc/rb_stage.cu; CUDA tensors only) and
``__call__``, which sends CPU tensors to ``plain`` and CUDA tensors to
``kernel`` and never falls back. The adaptive-stepping instances follow
kernels.quad's: the carry with ``traced_dt`` and ``emit_courant`` completes
step n with dt_corr (the corrector AND the temperature transport) and
advances step n+1 with dt_pred (the predictor, the buoyancy and the
source); the corrector with ``traced_dt``. The carry with ``shard=(P,
mdy)`` runs on one shard's local block of the plane-row mesh
(QuadRBStepShard, parallel.quad_sharded), fixed and with traced_dt +
emit_courant (QuadRBStepShardAdaptive: the sharded lagged controller).
On the card every carry instance is two launches: a shared-memory tile
kernel that runs the whole chain on chip and writes the outputs, then the
fixed-order sum of b (csrc/rb_stage.cu, csrc/carry_tile.cuh).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.quad import (
    DEV_HALO,
    _block_rows,
    _check,
    _courant,
    _crop_rows,
    _pad_rows,
    _predictor_quad,
    _qiota,
    _qshift,
    _ShardTraced,
    _Traced,
    _valid_masks,
    _where4,
    fixed_order_sum,
    own_row_sum,
    own_rows,
    quad_shape,
    rho_over,
    sum_scratch,
    tile_plan_ptr,
)
from cfd_tpu_torch.ops.stencil import StencilCoeffs

if TYPE_CHECKING:
    from cfd_tpu_torch.physics.boussinesq import RBParams

RB_CARRY = Kernel("quad_rb_step", "cfd_rb_carry", "cfd_tpu_torch/csrc/rb_stage.cu",
                  "cfd_tpu/kernels/rb_quad.py:81")
RB_CORRECTOR = Kernel("quad_rb_corrector", "cfd_rb_corrector",
                      "cfd_tpu_torch/csrc/rb_stage.cu", "cfd_tpu/kernels/rb_quad.py:225")
RB_CORRECTOR_TRACED = Kernel("quad_rb_corrector_traced", "cfd_rb_corrector_traced",
                             "cfd_tpu_torch/csrc/rb_stage.cu", "cfd_tpu/kernels/rb_quad.py:225")
RB_CARRY_ADAPTIVE = Kernel("quad_rb_step_adaptive", "cfd_rb_carry_adaptive",
                           "cfd_tpu_torch/csrc/rb_stage.cu", "cfd_tpu/kernels/rb_quad.py:81")
# the carry's entry point on one shard's local block (parallel.quad_sharded),
# counted apart
SHARD_RB_CARRY = Kernel("quad_rb_step_shard", "cfd_rb_carry", "cfd_tpu_torch/csrc/rb_stage.cu",
                        "cfd_tpu/kernels/rb_quad.py:81 (shard=)")
# its traced-dt + Courant instance (row 16e+), counted apart
SHARD_RB_CARRY_ADAPTIVE = Kernel("quad_rb_step_shard_adaptive", "cfd_rb_carry_adaptive",
                                 "cfd_tpu_torch/csrc/rb_stage.cu",
                                 "cfd_tpu/kernels/rb_quad.py:81 (shard=, traced_dt)")


def _box_noslip_bc_quad(u, v, grow, gcol, ny: int, nx: int):
    """physics.boussinesq.box_noslip_bc in quad form, the same update order
    (cfd_tpu/kernels/rb_quad.py:40-59)."""
    u = _where4([(g == 0) & (c <= nx) for g, c in zip(grow, gcol)],
                [-a for a in _qshift(u, 1, 0)], u)
    u = _where4([(g == ny + 1) & (c <= nx) for g, c in zip(grow, gcol)],
                [-a for a in _qshift(u, -1, 0)], u)
    zero = [torch.zeros_like(a) for a in u]
    u = _where4([((c == 0) | (c == nx)) & (g >= 1) & (g <= ny)
                 for g, c in zip(grow, gcol)], zero, u)
    v = _where4([(c == 0) & (g <= ny) for g, c in zip(grow, gcol)],
                [-a for a in _qshift(v, 0, 1)], v)
    v = _where4([(c == nx + 1) & (g <= ny) for g, c in zip(grow, gcol)],
                [-a for a in _qshift(v, 0, -1)], v)
    v = _where4([((g == 0) | (g == ny)) & (c >= 1) & (c <= nx)
                 for g, c in zip(grow, gcol)], zero, v)
    return u, v


def _temperature_bc_quad(T, grow, gcol, ny: int, nx: int, t_bottom: float, t_top: float):
    """physics.boussinesq.temperature_bc in quad form: the Dirichlet ghost
    rows by reflection, then the adiabatic ghost columns
    (cfd_tpu/kernels/rb_quad.py:62-78)."""
    T = _where4([(g == 0) & (c >= 1) & (c <= nx) for g, c in zip(grow, gcol)],
                [2.0 * t_bottom - a for a in _qshift(T, 1, 0)], T)
    T = _where4([(g == ny + 1) & (c >= 1) & (c <= nx) for g, c in zip(grow, gcol)],
                [2.0 * t_top - a for a in _qshift(T, -1, 0)], T)
    T = _where4([(c == 0) & (g >= 1) & (g <= ny) for g, c in zip(grow, gcol)],
                _qshift(T, 0, 1), T)
    return _where4([(c == nx + 1) & (g >= 1) & (g <= ny) for g, c in zip(grow, gcol)],
                   _qshift(T, 0, -1), T)


class QuadRBCorrector:
    """(us4, vs4, p4) -> (u4, v4): the rho-divided projection on valid faces,
    the tentative value elsewhere, then the box no-slip ghosts
    (cfd_tpu/kernels/rb_quad.py:225). Used at the stats/export boundary
    (physics/boussinesq.py unalign_state)."""

    def __init__(self, shape, coeffs: StencilCoeffs):
        self.qshape = quad_shape(shape)
        self.ny, self.nx = shape[0] - 2, shape[1] - 2
        self.coeffs = coeffs
        self.cu = coeffs.dt / (coeffs.density * coeffs.dx)
        self.cv = coeffs.dt / (coeffs.density * coeffs.dy)

    def __call__(self, us, vs, p):
        _check(self.qshape, us, vs, p)
        if route(us, vs, p) == "cuda":
            return self.kernel(us, vs, p)
        return self.plain(us, vs, p)

    def _geometry(self, device):
        grow, gcol = _qiota(self.qshape[1], self.qshape[2], device)
        return grow, gcol, _valid_masks(grow, gcol, self.ny, self.nx)

    def _corrected(self, us, vs, p, grow, gcol, u_valid, v_valid, cu=None, cv=None):
        cu = self.cu if cu is None else cu
        cv = self.cv if cv is None else cv
        pE, pN = _qshift(list(p), 0, 1), _qshift(list(p), 1, 0)
        u = [torch.where(u_valid[q], us[q] - cu * (pE[q] - p[q]), us[q])
             for q in range(4)]
        v = [torch.where(v_valid[q], vs[q] - cv * (pN[q] - p[q]), vs[q])
             for q in range(4)]
        return _box_noslip_bc_quad(u, v, grow, gcol, self.ny, self.nx)

    def plain(self, us, vs, p):
        grow, gcol, (u_valid, v_valid, _) = self._geometry(us.device)
        u, v = self._corrected(us, vs, p, grow, gcol, u_valid, v_valid)
        return torch.stack(u), torch.stack(v)

    def _ints(self):
        _, Hq8, Wqa = self.qshape
        return (Hq8, Wqa, self.ny, self.nx)

    def kernel(self, us, vs, p):
        u2, v2 = torch.empty_like(us), torch.empty_like(us)
        RB_CORRECTOR(us, ptr(us), ptr(vs), ptr(p), ptr(u2), ptr(v2), *self._ints(),
                     self.cu, self.cv)
        return u2, v2


class QuadRBStep(QuadRBCorrector):
    """The fused tentative-carry Rayleigh-Benard stage
    (cfd_tpu/kernels/rb_quad.py:81, math in rb_carry_compute :130-222):
    (us, vs, p, T[, p_prev]) -> (us', vs', T', b[, guess], sum b). With
    ``emit_guess`` the call takes p_prev and also returns the extrapolated
    warm start 2 p - p_prev. ``sum b`` is a 0-d float32 tensor summed in
    fixed_order_sum's order. The wall temperatures are ``params``'.

    The buoyancy constant is the reference's ``dt * buoyancy * 0.5`` with
    the free-fall buoyancy 1, formed as a Python double and then multiplied
    as one float32 (rb_quad.py:201); plain and kernel take the same value.

    On the card: one tile kernel (csrc/rb_stage.cu rb_carry_kernel, the
    corrector, T', the predictor and the source in shared memory) and one
    launch of the sum, whose last block folds the partials and leaves its
    count (a persistent int on each device, kernels.quad.sum_scratch) at 0."""

    def __init__(self, shape, coeffs: StencilCoeffs, kappa: float, params: RBParams,
                 emit_guess: bool = False):
        super().__init__(shape, coeffs)
        self.kappa = kappa
        self.t_bottom, self.t_top = params.t_bottom, params.t_top
        self.buoy = coeffs.dt * 0.5
        self.rho_dt = coeffs.density / coeffs.dt
        self.emit_guess = emit_guess

    def __call__(self, us, vs, p, T, p_prev=None):
        fields = (us, vs, p, T) + ((p_prev,) if self.emit_guess else ())
        if (p_prev is not None) != self.emit_guess:
            raise ValueError("p_prev is required with emit_guess and refused without it")
        _check(self.qshape, *fields)
        if route(*fields) == "cuda":
            return self.kernel(*fields)
        return self.plain(*fields)

    def plain(self, us, vs, p, T, p_prev=None):
        outs, _, _ = self._stage(us, vs, p, T, p_prev)
        return (*outs, fixed_order_sum(outs[3]))

    def _stage(self, us, vs, p, T, p_prev=None, cu=None, cv=None, dts=None, row0: int = 0,
               block=None):
        """([us', vs', T', b[, guess]], u2, v2): the stage with the corrected
        fields u2, v2, at the host's coefficients or (``dts`` = (dt_corr,
        dt_pred)) the traced ones. ``row0``: the global plane row of the
        arrays' row 0; ``block``: the (rows, 1) mask of a local block's rows
        in padded arrays, outside which u2, v2 and T' are zeroed, as the
        kernel's scratch reads 0 there."""
        c = self.coeffs
        ny, nx = self.ny, self.nx
        dt_corr, dt_pred = (c.dt, None) if dts is None else (dts[0], dts[1])
        buoy = self.buoy if dts is None else dt_pred * 0.5
        grow, gcol = _qiota(us.shape[1], us.shape[2], us.device, row0)
        u_valid, v_valid, cell = _valid_masks(grow, gcol, ny, nx)
        u2, v2 = self._corrected(us, vs, p, grow, gcol, u_valid, v_valid, cu, cv)
        blank = (lambda a: a) if block is None else (
            lambda a: [torch.where(block, x, torch.zeros_like(x)) for x in a])
        u2, v2 = blank(u2), blank(v2)

        T = list(T)
        TE, TW = _qshift(T, 0, 1), _qshift(T, 0, -1)
        TN, TS = _qshift(T, 1, 0), _qshift(T, -1, 0)
        fe = [u2[q] * 0.5 * (T[q] + TE[q]) for q in range(4)]
        fn = [v2[q] * 0.5 * (T[q] + TN[q]) for q in range(4)]
        feW, fnS = _qshift(fe, 0, -1), _qshift(fn, -1, 0)
        T2 = []
        for q in range(4):
            adv = (fe[q] - feW[q]) * c.idx + (fn[q] - fnS[q]) * c.idy
            lap = ((TE[q] - 2.0 * T[q] + TW[q]) * c.idx2
                   + (TN[q] - 2.0 * T[q] + TS[q]) * c.idy2)
            T2.append(torch.where(cell[q], T[q] + dt_corr * (self.kappa * lap - adv), T[q]))
        T2 = blank(_temperature_bc_quad(T2, grow, gcol, ny, nx, self.t_bottom, self.t_top))

        us_raw, vs_raw = _predictor_quad(u2, v2, c, dt_pred)
        T2N = _qshift(T2, 1, 0)
        us2 = [torch.where(u_valid[q], us_raw[q], u2[q]) for q in range(4)]
        vs2 = [torch.where(v_valid[q], vs_raw[q] + buoy * (T2[q] + T2N[q]), v2[q])
               for q in range(4)]
        us2, vs2 = _box_noslip_bc_quad(us2, vs2, grow, gcol, ny, nx)

        usW, vsS = _qshift(us2, 0, -1), _qshift(vs2, -1, 0)
        rho_dt = self.rho_dt if dts is None else rho_over(c, dt_pred)
        b = []
        for q in range(4):
            div = (us2[q] - usW[q]) * c.idx + (vs2[q] - vsS[q]) * c.idy
            b.append(torch.where(cell[q], rho_dt * div, torch.zeros_like(div)))
        b = torch.stack(b)
        outs = [torch.stack(us2), torch.stack(vs2), torch.stack(T2), b]
        if p_prev is not None:
            outs.append(2.0 * p - p_prev)
        return outs, torch.stack(u2), torch.stack(v2)

    def kernel(self, us, vs, p, T, p_prev=None):
        return _rb_carry(self, RB_CARRY, (us, vs, p, T), p_prev, 0, 0)


def _rb_carry(op, kern: Kernel, fields, p_prev, row_base: int, halo: int):
    """One launch of cfd_rb_carry through ``kern`` (its counter): (us', vs',
    T', b[, guess], sum b), the sum over the own rows of a block with a
    ``halo``-row strip; the guess where p_prev is given."""
    us, vs, p, T = fields
    us2, vs2, T2, b = (torch.empty_like(us) for _ in range(4))
    guess = torch.empty_like(us) if p_prev is not None else None
    partials, count = sum_scratch(op, us)
    sum_b = torch.empty((), dtype=torch.float32, device=us.device)
    c = op.coeffs
    opt = lambda t: ptr(t) if t is not None else None
    plan = tile_plan_ptr(op, "rb", us.device, "cfd_rb_carry_grid", False, halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(T), opt(p_prev), ptr(us2), ptr(vs2), ptr(T2), ptr(b),
         opt(guess), ptr(partials), ptr(count), ptr(sum_b), *op._ints(), op.cu, op.cv, c.dt,
         c.viscosity, c.idx, c.idy, c.idx2, c.idy2, op.rho_dt, op.kappa, 2.0 * op.t_bottom,
         2.0 * op.t_top, op.buoy, row_base, halo, plan)
    outs = [us2, vs2, T2, b] + ([guess] if guess is not None else [])
    return (*outs, sum_b)


class QuadRBStepShard(QuadRBStep):
    """The RB carry on one shard's local block (row 16e,
    cfd_tpu/kernels/rb_quad.py:81 with shard=(P, mdy)): (row_base, us, vs, p,
    T) -> (us', vs', T', b, sum_own) on (4, P + 16, Wqa) blocks. row_base =
    jy * P - 8 is the global plane row of local row 0, so the T ghost rows
    (global j = 0 and ny + 1) and the walls stay global; sum_own is the own
    rows' sum of b (own_row_sum), the shard's partial. No warm-start guess:
    the sharded RB solves from p (cfd_tpu/parallel/quad_sharded.py:861-864).

    The twin is the single-device stage on the block padded with DEV_HALO
    zero rows either side, with the corrected u2, v2 and T' zeroed on the
    padding: the kernel (csrc/rb_stage.cu) holds them on the block only and
    reads 0 outside it. The stages reach 7 rows (kRBRadius there), so the own
    rows equal the single-device carry's. On the card: row 10's two
    launches, their block instances (the tiles' maxima and the sum over the
    own rows)."""

    def __init__(self, shape, coeffs: StencilCoeffs, kappa: float, params: RBParams,
                 shard: tuple[int, int] = (8, 1)):
        super().__init__(shape, coeffs, kappa, params)
        P, _ = shard
        if P % 8:
            raise ValueError(f"shard rows must be a multiple of 8, got {P}")
        self.P = P
        self.qshape = (4, P + 2 * DEV_HALO, self.qshape[2])

    def __call__(self, row_base: int, us, vs, p, T):
        _check(self.qshape, us, vs, p, T)
        if route(us, vs, p, T) == "cuda":
            return self.kernel(row_base, us, vs, p, T)
        return self.plain(row_base, us, vs, p, T)

    def plain(self, row_base, us, vs, p, T):
        us2, vs2, T2, b, _, _ = self._block_stage(row_base, us, vs, p, T)
        return us2, vs2, T2, b, own_row_sum(b, self.P)

    def _block_stage(self, row_base, us, vs, p, T, cu=None, cv=None, dts=None):
        """(us', vs', T', b, u2, v2) on the block, u2 and v2 the corrected,
        ghosted fields, at the host's coefficients or the traced ones."""
        z, H = DEV_HALO, self.qshape[1]
        outs, u2, v2 = self._stage(*(_pad_rows(t, z) for t in (us, vs, p, T)), None, cu, cv,
                                   dts=dts, row0=row_base - z,
                                   block=_block_rows(H, z, us.device))
        return tuple(_crop_rows(a, z) for a in (*outs, u2, v2))

    def kernel(self, row_base, us, vs, p, T):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _rb_carry(self, SHARD_RB_CARRY, (us, vs, p, T), None, int(row_base),
                             DEV_HALO)


class QuadRBCorrectorTraced(_Traced, QuadRBCorrector):
    """(dt, us4, vs4, p4) -> (u4, v4): the RB corrector with a traced dt
    (cfd_tpu/kernels/rb_quad.py:225 traced_dt, cu = dt / (rho*dx)): the
    lagged controller's logical boundary."""

    def __init__(self, shape, coeffs: StencilCoeffs):
        super().__init__(shape, coeffs)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dt, us, vs, p):
        grow, gcol, (u_valid, v_valid, _) = self._geometry(us.device)
        u, v = self._corrected(us, vs, p, grow, gcol, u_valid, v_valid,
                               *self._coeffs_at(dt))
        return torch.stack(u), torch.stack(v)

    def kernel(self, dt, us, vs, p):
        u2, v2 = torch.empty_like(us), torch.empty_like(us)
        RB_CORRECTOR_TRACED(us, ptr(us), ptr(vs), ptr(p), ptr(u2), ptr(v2), ptr(dt),
                            *self._ints(), self.cu_f, self.cv_f)
        return u2, v2


class QuadRBStepAdaptive(_Traced, QuadRBStep):
    """The RB carry with traced_dt and emit_courant
    (cfd_tpu/kernels/rb_quad.py:81): (dts, us, vs, p, T) -> (us', vs', T',
    b, sum b, max|u2|, max|v2|). dts = (dt_corr, dt_pred): dt_corr corrects
    the carried fields and transports T (completing step n), dt_pred drives
    the predictor, the buoyancy dt_pred * 0.5 and the source (step n+1). No
    warm-start guess: the adaptive RB step warm-starts from plain p, as the
    reference's (physics/boussinesq.py:372-411). On the card: the fixed
    carry's two launches, their adaptive instances, after one zeroing of the
    Courant maxima."""

    n_dt = 2

    def __init__(self, shape, coeffs: StencilCoeffs, kappa: float, params: RBParams):
        super().__init__(shape, coeffs, kappa, params)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dts, us, vs, p, T):
        outs, u2, v2 = self._stage(us, vs, p, T, None, *self._coeffs_at(dts[0]), dts=dts)
        return (*outs, fixed_order_sum(outs[3]), *_courant(u2, v2))

    def kernel(self, dts, us, vs, p, T):
        return _rb_carry_adaptive(self, RB_CARRY_ADAPTIVE, dts, (us, vs, p, T), 0, 0)


class QuadRBStepShardAdaptive(_ShardTraced, QuadRBStepShard):
    """The RB carry with traced_dt and emit_courant on one shard's local
    block (row 16e+, cfd_tpu/kernels/rb_quad.py:81 with shard=(P, mdy),
    traced_dt=True, emit_courant=True): (row_base, dts, us, vs, p, T) ->
    (us', vs', T', b, sum_own, max|u2|, max|v2|), the sum and the maxima
    over the own rows only. No p_prev: the sharded RB step solves from p
    (cfd_tpu/parallel/quad_sharded.py:1178-1186). The twin is
    QuadRBStepShard's at QuadRBStepAdaptive's traced coefficients."""

    def __init__(self, shape, coeffs: StencilCoeffs, kappa: float, params: RBParams,
                 shard: tuple[int, int] = (8, 1)):
        super().__init__(shape, coeffs, kappa, params, shard)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, row_base, dts, us, vs, p, T):
        us2, vs2, T2, b, u2, v2 = self._block_stage(row_base, us, vs, p, T,
                                                    *self._coeffs_at(dts[0]), dts=dts)
        own = lambda t: own_rows(t, self.P)
        return us2, vs2, T2, b, own_row_sum(b, self.P), *_courant(own(u2), own(v2))

    def kernel(self, row_base, dts, us, vs, p, T):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _rb_carry_adaptive(self, SHARD_RB_CARRY_ADAPTIVE, dts, (us, vs, p, T),
                                      int(row_base), DEV_HALO)


def _rb_carry_adaptive(op, kern: Kernel, dts, fields, row_base: int, halo: int):
    """One launch of cfd_rb_carry_adaptive through ``kern`` (its counter):
    (us', vs', T', b, sum b, max|u2|, max|v2|), the reductions over the own
    rows of a block with a ``halo``-row strip."""
    us, vs, p, T = fields
    us2, vs2, T2, b = (torch.empty_like(us) for _ in range(4))
    partials, count = sum_scratch(op, us)
    scal = torch.empty(3, dtype=torch.float32, device=us.device)  # sum b, max|u|, max|v|
    c = op.coeffs
    plan = tile_plan_ptr(op, "rb", us.device, "cfd_rb_carry_grid", True, halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(T), ptr(us2), ptr(vs2), ptr(T2), ptr(b),
         ptr(partials), ptr(count), ptr(scal), ptr(scal[1:]), ptr(dts), *op._ints(), op.cu_f,
         op.cv_f, c.viscosity, c.idx, c.idy, c.idx2, c.idy2, c.density, op.kappa,
         2.0 * op.t_bottom, 2.0 * op.t_top, row_base, halo, plan)
    return us2, vs2, T2, b, scal[0], scal[1], scal[2]


def make_quad_rb_step_kernel(shape, coeffs, kappa: float, params: RBParams,
                             emit_guess: bool = False, adaptive: bool = False,
                             shard: tuple[int, int] | None = None) -> QuadRBStep:
    """``adaptive``: the traced_dt + emit_courant instance (no guess).
    ``shard=(P, mdy)``: the carry of one shard's local block
    (QuadRBStepShard, with ``adaptive`` QuadRBStepShardAdaptive; no guess)."""
    if shard is not None:
        if emit_guess:
            raise ValueError("the sharded RB carry takes no p_prev (emit_guess): the "
                             "sharded RB step solves from p")
        if adaptive:
            return QuadRBStepShardAdaptive(shape, coeffs, kappa, params, shard)
        return QuadRBStepShard(shape, coeffs, kappa, params, shard)
    if adaptive:
        if emit_guess:
            raise ValueError("the adaptive RB carry takes no p_prev (emit_guess)")
        return QuadRBStepAdaptive(shape, coeffs, kappa, params)
    return QuadRBStep(shape, coeffs, kappa, params, emit_guess)


def make_quad_rb_corrector(shape, coeffs, traced_dt: bool = False) -> QuadRBCorrector:
    if traced_dt:
        return QuadRBCorrectorTraced(shape, coeffs)
    return QuadRBCorrector(shape, coeffs)


def uncorrect_rb_quad(u, v, p, shape, coeffs: StencilCoeffs, dt: float | None = None):
    """Inverse correction on NATURAL-layout arrays (resume boundary):
    us = u + c*(pE - p) on valid faces and u elsewhere (the u_else = us
    convention's inverse), so corr(uncorrect(u, v, p), p) == (u, v) up to
    one f32 rounding (cfd_tpu/kernels/rb_quad.py:263). ``dt`` (a Python
    float) overrides coeffs.dt (the adaptive carry's entry). Torch glue."""
    H, Wp = shape
    ny, nx = H - 2, Wp - 2
    dt = coeffs.dt if dt is None else dt
    cu = dt / (coeffs.density * coeffs.dx)
    cv = dt / (coeffs.density * coeffs.dy)
    jj = torch.arange(H, device=u.device)[:, None]
    ii = torch.arange(Wp, device=u.device)[None, :]
    u_valid = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx - 1)
    v_valid = (jj >= 1) & (jj <= ny - 1) & (ii >= 1) & (ii <= nx)
    pE = torch.roll(p, -1, dims=1)
    pN = torch.roll(p, -1, dims=0)
    return (torch.where(u_valid, u + cu * (pE - p), u),
            torch.where(v_valid, v + cv * (pN - p), v))
