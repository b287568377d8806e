"""Stage kernels of the non-carry step on the natural aligned layout (the
port of cfd_tpu.kernels.projection with ``aligned_io=True``).

Layout: every field is a row-major (H8, W) = (round_up(ny+2, 8),
round_up(nx+2, 128)) float32 array that is zero beyond the logical
(ny+2, nx+2) grid; every kernel writes each element, the padding included
(cfd_tpu/kernels/projection.py:176-178).

* ``make_predictor_source`` (projection.py:210, ``emit_max_b``): (u, v) ->
  (us, vs, b, max|b|): the lid-cavity ghosts derived from the interior
  (_cavity_bc_slab :193), the MAC predictor, b = rho/dt div(u*) on the
  cells and max|b|.
* ``make_corrector`` (:281, ``emit_guess``): (us, vs, p, p_prev) -> (u2,
  v2, 2p - p_prev): the rho-multiplied projection on valid faces, 0 on the
  others, then the cavity ghosts rebuilt from the corrected interior (the
  slim-ghost convention of its docstring).
* ``make_channel_predictor_source`` (:386): (u, v) -> (us, vs, b_raw, sum
  b): the predictor, the channel ghosts on the tentative fields
  (_channel_bc_slab :336), the raw source and its sum.
* ``make_channel_corrector`` (:423, ``emit_guess``): the rho-divided
  projection with the invalid faces zeroed before the channel ghosts, so
  the v top ghost row and the corners stay 0.

Each stage has three faces, as the quad stages (kernels.quad): ``plain``,
a whole-array PyTorch transliteration of the Pallas ``compute`` (torch.roll
and torch.where); ``kernel``, the CUDA kernel of csrc/projection.cu; and
``__call__``, which sends CPU tensors to ``plain`` and CUDA tensors to
``kernel``, with no fallback. The sums are fixed_order_sum's (per-block
pairwise trees, then one fold): the reference folds per 64-row tile in tile
order, so its sum differs from this one within float32 rounding.
"""

from __future__ import annotations

import torch

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.plan import natural_predictor_plan
from cfd_tpu_torch.kernels.quad import (_check, fixed_order_sum, max_acc, sum_scratch,
                                        tile_plan_ptr)
from cfd_tpu_torch.ops.stencil import StencilCoeffs, _sh, predictor

_SRC = "cfd_tpu_torch/csrc/projection.cu"
PREDICTOR_SOURCE = Kernel("projection_predictor_source", "cfd_predictor_source", _SRC,
                          "cfd_tpu/kernels/projection.py:210")
CORRECTOR = Kernel("projection_corrector", "cfd_corrector", _SRC,
                   "cfd_tpu/kernels/projection.py:281")
CHANNEL_PREDICTOR_SOURCE = Kernel("projection_channel_predictor_source",
                                  "cfd_channel_predictor_source", _SRC,
                                  "cfd_tpu/kernels/projection.py:386")
CHANNEL_CORRECTOR = Kernel("projection_channel_corrector", "cfd_channel_corrector", _SRC,
                           "cfd_tpu/kernels/projection.py:423")


def aligned_shape(shape: tuple[int, int]) -> tuple[int, int]:
    """(H8, W) of the logical padded (ny+2, nx+2) grid: rows to 8, columns
    to 128 (cfd_tpu/kernels/projection.py:69-70)."""
    H, W = shape
    return (-(-H // 8) * 8, -(-W // 128) * 128)


def _masks(H8: int, W: int, ny: int, nx: int, device):
    """(grow, gcol, u_valid, v_valid, cell) from iotas on the aligned array."""
    grow = torch.arange(H8, device=device)[:, None]
    gcol = torch.arange(W, device=device)[None, :]
    u_valid = (grow >= 1) & (grow <= ny) & (gcol >= 1) & (gcol <= nx - 1)
    v_valid = (grow >= 1) & (grow <= ny - 1) & (gcol >= 1) & (gcol <= nx)
    cell = (grow >= 1) & (grow <= ny) & (gcol >= 1) & (gcol <= nx)
    return grow, gcol, u_valid, v_valid, cell


def _cavity_bc(u, v, grow, gcol, ny: int, nx: int, lid: float):
    """The lid-cavity ghosts (projection.py _cavity_bc_slab, :193-208), in
    its order: u's top row over columns 0..nx, u's bottom row, v's west and
    east columns over rows 0..ny."""
    u = torch.where((grow == ny + 1) & (gcol <= nx), 2.0 * lid - _sh(u, -1, 0), u)
    u = torch.where((grow == 0) & (gcol <= nx), -_sh(u, 1, 0), u)
    v = torch.where((gcol == 0) & (grow <= ny), -_sh(v, 0, 1), v)
    v = torch.where((gcol == nx + 1) & (grow <= ny), -_sh(v, 0, -1), v)
    return u, v


def _channel_bc(u, v, grow, gcol, ny: int, nx: int, uin: float):
    """The channel ghosts (projection.py _channel_bc_slab, :336-355), in the
    reference's order: the ghost rows read the updated inlet and outlet
    columns."""
    z = torch.zeros_like(v)
    u = torch.where((gcol == 0) & (grow >= 1) & (grow <= ny), torch.full_like(u, uin), u)
    v = torch.where((gcol == 0) & (grow <= ny), z, v)
    u = torch.where((gcol == nx) & (grow >= 1) & (grow <= ny), _sh(u, 0, -1), u)
    v = torch.where((gcol == nx + 1) & (grow <= ny), _sh(v, 0, -1), v)
    v = torch.where((grow == 0) & (gcol >= 1) & (gcol <= nx), z, v)
    u = torch.where((grow == 0) & (gcol <= nx), -_sh(u, 1, 0), u)
    v = torch.where((grow == ny) & (gcol >= 1) & (gcol <= nx), z, v)
    u = torch.where((grow == ny + 1) & (gcol <= nx), -_sh(u, -1, 0), u)
    return u, v


def _source(us, vs, c: StencilCoeffs, cell):
    """b = rho/dt * div(u*) on the cells, 0 elsewhere."""
    div = (us - _sh(us, 0, -1)) * c.idx + (vs - _sh(vs, -1, 0)) * c.idy
    return torch.where(cell, (c.density / c.dt) * div, torch.zeros_like(div))


def _project(us, vs, p, u_valid, v_valid, cu: float, cv: float):
    """The pressure correction on valid faces, 0 on the others."""
    z = torch.zeros_like(us)
    return (torch.where(u_valid, us - cu * (_sh(p, 0, 1) - p), z),
            torch.where(v_valid, vs - cv * (_sh(p, 1, 0) - p), z))


class _Stage:
    """Dispatch of a stage on aligned fields: CPU tensors go to ``plain``,
    CUDA tensors to ``kernel``."""

    def __init__(self, shape, coeffs: StencilCoeffs, ghost: float):
        self.ny, self.nx = shape[0] - 2, shape[1] - 2
        self.shape = aligned_shape(shape)
        self.coeffs = coeffs
        self.ghost = ghost  # the lid velocity, or the inlet velocity

    def __call__(self, *fields):
        _check(self.shape, *fields)
        if route(*fields) == "cuda":
            return self.kernel(*fields)
        return self.plain(*fields)

    def _masks(self, device):
        return _masks(*self.shape, self.ny, self.nx, device)

    def _pred_args(self):
        c = self.coeffs
        return (c.dt, c.viscosity, c.idx, c.idy, c.idx2, c.idy2, c.density / c.dt)


class PredictorSource(_Stage):
    """(u, v) -> (us, vs, b, max|b|) for the cavity (projection.py:210 with
    emit_max_b); max|b| a 0-d float32 tensor on the fields' device. On the
    card it is one launch over shared-memory tiles of the aligned array
    (csrc/projection.cu predictor_source_kernel, kernels/plan.py
    natural_predictor_plan), whose last block moves max|b| out of the op's
    running max (kernels.quad.max_acc): no zeroing launch."""

    def plain(self, u, v):
        grow, gcol, u_valid, v_valid, cell = self._masks(u.device)
        u, v = _cavity_bc(u, v, grow, gcol, self.ny, self.nx, self.ghost)
        us, vs = predictor(u, v, self.coeffs, u_valid, v_valid)
        b = _source(us, vs, self.coeffs, cell)
        return us, vs, b, torch.max(torch.abs(b))

    def kernel(self, u, v):
        us, vs, b = (torch.empty_like(u) for _ in range(3))
        max_b = torch.empty((), dtype=torch.float32, device=u.device)
        plan = tile_plan_ptr(self, lambda: natural_predictor_plan(self.shape), u.device,
                             "cfd_predictor_source_grid")
        PREDICTOR_SOURCE(u, ptr(u), ptr(v), ptr(us), ptr(vs), ptr(b), ptr(max_b),
                         ptr(max_acc(self, u.device)), *self.shape, self.ny, self.nx,
                         2.0 * self.ghost, *self._pred_args(), plan)
        return us, vs, b, max_b


class Corrector(_Stage):
    """(us, vs, p, p_prev) -> (u2, v2, 2p - p_prev) for the cavity
    (projection.py:281 with emit_guess): the rho-multiplied projection, the
    ghosts rebuilt from the corrected interior."""

    def __init__(self, shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0):
        super().__init__(shape, coeffs, lid_velocity)
        self.cu = coeffs.dt / coeffs.dx * coeffs.density
        self.cv = coeffs.dt / coeffs.dy * coeffs.density

    def plain(self, us, vs, p, p_prev):
        grow, gcol, u_valid, v_valid, _ = self._masks(us.device)
        u2, v2 = _project(us, vs, p, u_valid, v_valid, self.cu, self.cv)
        u2, v2 = _cavity_bc(u2, v2, grow, gcol, self.ny, self.nx, self.ghost)
        return u2, v2, 2.0 * p - p_prev

    def kernel(self, us, vs, p, p_prev):
        u2, v2, guess = (torch.empty_like(us) for _ in range(3))
        CORRECTOR(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(u2), ptr(v2), ptr(guess),
                  *self.shape, self.ny, self.nx, self.cu, self.cv, 2.0 * self.ghost)
        return u2, v2, guess


class ChannelPredictorSource(_Stage):
    """(u, v) -> (us, vs, b_raw, sum b) for the channel (projection.py:386);
    sum b a 0-d float32 tensor in fixed_order_sum's order. On the card it is
    one launch over shared-memory tiles of the aligned array
    (csrc/projection.cu channel_predictor_source_kernel, kernels/plan.py
    natural_predictor_plan(channel=True)) and the carries' sum launch over
    the flat array, whose count the op keeps (kernels.quad.sum_scratch): no
    zeroing launch."""

    def plain(self, u, v):
        grow, gcol, u_valid, v_valid, cell = self._masks(u.device)
        us, vs = predictor(u, v, self.coeffs, u_valid, v_valid)
        us, vs = _channel_bc(us, vs, grow, gcol, self.ny, self.nx, self.ghost)
        b = _source(us, vs, self.coeffs, cell)
        return us, vs, b, fixed_order_sum(b)

    def kernel(self, u, v):
        us, vs, b = (torch.empty_like(u) for _ in range(3))
        partials, count = sum_scratch(self, u)
        sum_b = torch.empty((), dtype=torch.float32, device=u.device)
        plan = tile_plan_ptr(self, lambda: natural_predictor_plan(self.shape, channel=True),
                             u.device, "cfd_channel_predictor_source_grid")
        CHANNEL_PREDICTOR_SOURCE(u, ptr(u), ptr(v), ptr(us), ptr(vs), ptr(b), ptr(partials),
                                 ptr(count), ptr(sum_b), *self.shape, self.ny, self.nx,
                                 self.ghost, *self._pred_args(), plan)
        return us, vs, b, sum_b


class ChannelCorrector(_Stage):
    """(us, vs, p, p_prev) -> (u2, v2, 2p - p_prev) for the channel
    (projection.py:423 with emit_guess): the rho-divided projection, the
    invalid faces zeroed, then the channel ghosts."""

    def __init__(self, shape, coeffs: StencilCoeffs, inlet_velocity: float = 1.0):
        super().__init__(shape, coeffs, inlet_velocity)
        self.cu = coeffs.dt / (coeffs.density * coeffs.dx)
        self.cv = coeffs.dt / (coeffs.density * coeffs.dy)

    def plain(self, us, vs, p, p_prev):
        grow, gcol, u_valid, v_valid, _ = self._masks(us.device)
        u2, v2 = _project(us, vs, p, u_valid, v_valid, self.cu, self.cv)
        u2, v2 = _channel_bc(u2, v2, grow, gcol, self.ny, self.nx, self.ghost)
        return u2, v2, 2.0 * p - p_prev

    def kernel(self, us, vs, p, p_prev):
        u2, v2, guess = (torch.empty_like(us) for _ in range(3))
        CHANNEL_CORRECTOR(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(u2), ptr(v2),
                          ptr(guess), *self.shape, self.ny, self.nx, self.cu, self.cv,
                          self.ghost)
        return u2, v2, guess


def make_predictor_source(shape, coeffs: StencilCoeffs,
                          lid_velocity: float = 1.0) -> PredictorSource:
    return PredictorSource(shape, coeffs, lid_velocity)


def make_corrector(shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0) -> Corrector:
    return Corrector(shape, coeffs, lid_velocity)


def make_channel_predictor_source(shape, coeffs: StencilCoeffs,
                                  inlet_velocity: float = 1.0) -> ChannelPredictorSource:
    return ChannelPredictorSource(shape, coeffs, inlet_velocity)


def make_channel_corrector(shape, coeffs: StencilCoeffs,
                           inlet_velocity: float = 1.0) -> ChannelCorrector:
    return ChannelCorrector(shape, coeffs, inlet_velocity)
