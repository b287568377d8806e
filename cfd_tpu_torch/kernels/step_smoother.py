"""The backward step's exact masked finest-level smoother on the natural
layout (the port of cfd_tpu.kernels.step_smoother).

``pairs(p, b)`` runs ``n_pairs`` exact reference pairs (a pressure-ghost
refresh, then a red and a black half-sweep over the fluid cells) and one
more ghost refresh, the ``smooth0`` composition of
cfd_tpu/poisson/multigrid.py:993-1008, and returns ``p``; with
``with_residual_field`` ``(p, r)``, r = b - lap of the state refreshed once
more, on the fluid cells and 0 elsewhere (``residual0``, :1010-1014); with
``with_residual`` ``(p, max|r|)``, a 0-d float32 tensor on the fields'
device. Arrays are the logical (ny+2, nx+2) float32 grid.

* ``plain`` — smooth0 and residual0 in PyTorch over ``refresh``, the ghost
  refresh in the kernel's rectangle form: the twin of the kernel and the
  natural masked solve's finest level on the CPU. It equals the
  reference's general form (bc.step_pressure_ghosts, the weighted mean
  over the grid's neighbour predicates) up to the sign of a zero.
* ``kernel`` — csrc/step_smoother.cu, one launch of shared-memory tiles a
  call (kernels/plan.py step_pairs_plan), with the masks of the
  reference's solid rectangle {i <= step_i, j > inlet_j_max} from the
  indices (step_smoother.py:45); CUDA tensors only. The with_residual
  variant's last block folds max|r| into its output (kernels.quad
  max_acc's running max and count, left 0), so no call zeroes anything.
* ``__call__`` — CPU tensors to ``plain``, CUDA tensors to ``kernel``; no
  fallback.

The plain and the residual-field variants count their launches on
STEP_PAIRS, the with_residual variant on STEP_PAIRS_RES (as rb_smoother's
RB_PAIRS and RB_PAIRS_RES).
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.plan import step_pairs_plan
from cfd_tpu_torch.kernels.quad import _check, max_acc, scalar_like, tile_plan_ptr

_SRC = "cfd_tpu_torch/csrc/step_smoother.cu"
STEP_PAIRS = Kernel("step_masked_pairs", "cfd_step_pairs", _SRC,
                    "cfd_tpu/kernels/step_smoother.py:45")
STEP_PAIRS_RES = Kernel("step_masked_pairs_res", "cfd_step_pairs", _SRC,
                        "cfd_tpu/kernels/step_smoother.py:45 (with_residual)")


def fluid_mask(shape, step_i: int, inlet_j_max: int, device) -> torch.Tensor:
    """The fluid cells of the step rectangle on the logical grid: the
    interior without {i <= step_i, j > inlet_j_max}."""
    ny, nx = shape[0] - 2, shape[1] - 2
    jj = torch.arange(shape[0], device=device)[:, None]
    ii = torch.arange(shape[1], device=device)[None, :]
    interior = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx)
    return interior & ~((ii <= step_i) & (jj > inlet_j_max))


class StepMaskedPairs(nn.Module):
    """Exact masked pairs on the step rectangle's finest level (see the
    module docstring). Buffers: the fluid mask and its red and black
    halves, and the solid cells the refresh averages (``east``: the solid
    column's east face, ``south``: the solid block's bottom row) with
    1 / their count of fluid neighbours."""

    def __init__(self, shape, step_i: int, inlet_j_max: int, idx2: float, idy2: float,
                 omega: float, n_pairs: int, with_residual: bool = False,
                 with_residual_field: bool = False, device="cpu"):
        super().__init__()
        if with_residual and with_residual_field:
            raise ValueError("with_residual and with_residual_field are exclusive")
        if n_pairs < 1:
            raise ValueError(f"n_pairs must be >= 1, got {n_pairs}")
        self.shape = tuple(shape)
        self.ny, self.nx = shape[0] - 2, shape[1] - 2
        self.step_i, self.inlet_j_max = step_i, inlet_j_max
        self.idx2, self.idy2, self.omega, self.n_pairs = idx2, idy2, omega, n_pairs
        self.denom = 2.0 * (idx2 + idy2)
        self.with_residual, self.with_residual_field = with_residual, with_residual_field
        self.record = STEP_PAIRS_RES if with_residual else STEP_PAIRS
        fluid = fluid_mask(shape, step_i, inlet_j_max, device)
        jj = torch.arange(shape[0], device=device)[:, None]
        ii = torch.arange(shape[1], device=device)[None, :]
        even = ((jj + ii) % 2) == 0
        self.register_buffer("fluid", fluid)
        self.register_buffer("red", fluid & even)
        self.register_buffer("black", fluid & ~even)
        solid = (ii >= 1) & (ii <= step_i) & (jj > inlet_j_max) & (jj <= self.ny)
        east = solid & (ii == step_i) & (ii < self.nx)
        south = solid & (jj == inlet_j_max + 1) & (jj > 1)
        self.register_buffer("east", east)
        self.register_buffer("south", south)
        self.register_buffer("inv_count", 1.0 / torch.clamp(east.float() + south.float(), min=1))

    def forward(self, p, b):
        _check(self.shape, p, b)
        if p.device != self.fluid.device:
            raise ValueError(f"tensor on {p.device}, masks on {self.fluid.device}")
        if route(p, b) == "cuda":
            return self.kernel(p, b)
        return self.plain(p, b)

    def _half(self, p, b, mask, denom):
        roll = lambda s, d: torch.roll(p, s, dims=d)
        gs = (self.idx2 * (roll(-1, 1) + roll(1, 1))
              + self.idy2 * (roll(-1, 0) + roll(1, 0)) - b) / denom
        return torch.where(mask, (1.0 - self.omega) * p + self.omega * gs, p)

    def refresh(self, p):
        """One pressure-ghost refresh, the kernel's form: the channel
        domain ghosts, then each solid cell with a fluid neighbour set to
        (east + south) * (1 / count), the absent neighbour as 0. Every
        output reads the input p. Returns a new tensor."""
        ny, nx = self.ny, self.nx
        q = p.clone()
        q[1 : ny + 1, 0] = p[1 : ny + 1, 1]
        q[1 : ny + 1, nx + 1] = 0.0
        q[0, 1 : nx + 1] = p[1, 1 : nx + 1]
        q[ny + 1, 1 : nx + 1] = p[ny, 1 : nx + 1]
        zero = torch.zeros_like(p)
        mean = (torch.where(self.east, torch.roll(p, -1, dims=1), zero)
                + torch.where(self.south, torch.roll(p, 1, dims=0), zero)) * self.inv_count
        return torch.where(self.east | self.south, mean, q)

    def smooth0(self, p, b):
        """n_pairs of ghosts, red, black, then the trailing ghosts."""
        denom = scalar_like(self.denom, p)  # a true division on every device
        for _ in range(self.n_pairs):
            p = self.refresh(p)
            p = self._half(p, b, self.red, denom)
            p = self._half(p, b, self.black, denom)
        return self.refresh(p)

    def residual0(self, p, b):
        """b - lap of the refreshed p on the fluid cells, 0 elsewhere."""
        p = self.refresh(p)
        roll = lambda s, d: torch.roll(p, s, dims=d)
        lap = ((roll(-1, 1) - 2.0 * p + roll(1, 1)) * self.idx2
               + (roll(-1, 0) - 2.0 * p + roll(1, 0)) * self.idy2)
        return torch.where(self.fluid, b - lap, torch.zeros_like(b))

    def plain(self, p, b):
        p = self.smooth0(p, b)
        if self.with_residual:
            return p, torch.max(torch.abs(self.residual0(p, b)))
        if self.with_residual_field:
            return p, self.residual0(p, b)
        return p

    def kernel(self, p, b):
        """One launch of shared-memory tiles (csrc/step_smoother.cu) under
        the op's plan (kernels/plan.py step_pairs_plan unless set before its
        first launch)."""
        residual = self.with_residual or self.with_residual_field
        plan = tile_plan_ptr(self, lambda: step_pairs_plan(self.shape, self.n_pairs, residual),
                             p.device, "cfd_step_pairs_grid")
        out = torch.empty_like(p)
        r = torch.empty_like(p) if self.with_residual_field else None
        null = ctypes.c_void_p(None)
        res, acc = null, null
        if self.with_residual:
            res = torch.empty((), dtype=torch.float32, device=p.device)
            acc = ptr(max_acc(self, p.device))
        self.record(p, ptr(p), ptr(b), ptr(out), ptr(r) if r is not None else null,
                    ptr(res) if self.with_residual else null, acc, *self.shape, self.ny,
                    self.nx, self.step_i, self.inlet_j_max, self.idx2, self.idy2, self.omega,
                    1.0 - self.omega, self.denom, self.n_pairs, plan)
        if self.with_residual:
            return out, res
        return out if r is None else (out, r)


def make_step_masked_pairs(shape, step_i: int, inlet_j_max: int, idx2: float, idy2: float,
                           omega: float, n_pairs: int, with_residual: bool = False,
                           with_residual_field: bool = False, device="cpu") -> StepMaskedPairs:
    return StepMaskedPairs(shape, step_i, inlet_j_max, idx2, idy2, omega, n_pairs,
                           with_residual=with_residual,
                           with_residual_field=with_residual_field, device=device)
