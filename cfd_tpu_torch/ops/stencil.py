"""MAC-grid stencil operators as whole-array shifted expressions (the port
of cfd_tpu.ops.stencil).

Each operator evaluates the stencil over the full padded array with
``torch.roll`` shifts and selects the written region with masks, in the
same expression order as the JAX package, so float32 results agree to the
last bit wherever PyTorch and XLA round each operation alike. They are the
building blocks of the quad kernels' plain twins (kernels/quad.py) and of
the statistics.

Reference: predictor cavity-01.cpp:548-603, source :622-630, corrector
:695-711, center interpolation :717-733.
"""

from __future__ import annotations

import dataclasses

import torch

from cfd_tpu_torch.grid import Grid


def iota_masks(grid: Grid, device="cpu") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cell, u_valid, v_valid) bool masks of a rectangle (mask-free) grid."""
    ny, nx = grid.ny, grid.nx
    jj = torch.arange(grid.shape[0], device=device)[:, None]
    ii = torch.arange(grid.shape[1], device=device)[None, :]
    cell = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx)
    u_valid = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx - 1)
    v_valid = (jj >= 1) & (jj <= ny - 1) & (ii >= 1) & (ii <= nx)
    return cell, u_valid, v_valid


def _sh(a: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    """shifted[j, i] = a[j + dj, i + di] over the last two axes (wraparound
    never read: all consumers mask to regions where the stencil stays in
    bounds)."""
    return torch.roll(a, shifts=(-dj, -di), dims=(-2, -1))


@dataclasses.dataclass(frozen=True)
class StencilCoeffs:
    """Host-side scalar coefficients shared by the stencil ops."""

    dx: float
    dy: float
    dt: float
    viscosity: float
    density: float = 1.0

    @property
    def idx(self) -> float:
        return 1.0 / self.dx

    @property
    def idy(self) -> float:
        return 1.0 / self.dy

    @property
    def idx2(self) -> float:
        return 1.0 / (self.dx * self.dx)

    @property
    def idy2(self) -> float:
        return 1.0 / (self.dy * self.dy)


def predictor(u, v, c: StencilCoeffs, u_valid, v_valid):
    """Tentative velocities u*, v*: central diffusion plus flux-form central
    convection, Forward-Euler update (cavity-01.cpp:548-603, anisotropic
    spacings per channel-01.cpp:546-603); 0 outside the valid-face masks."""
    nu, dt, idx, idy, idx2, idy2 = c.viscosity, c.dt, c.idx, c.idy, c.idx2, c.idy2

    uE, uW, uN, uS = _sh(u, 0, 1), _sh(u, 0, -1), _sh(u, 1, 0), _sh(u, -1, 0)
    vE, vW, vN, vS = _sh(v, 0, 1), _sh(v, 0, -1), _sh(v, 1, 0), _sh(v, -1, 0)

    lap_u = (uE - 2.0 * u + uW) * idx2 + (uN - 2.0 * u + uS) * idy2
    u_e = 0.5 * (u + uE)
    u_w = 0.5 * (uW + u)
    conv_ux = (u_e * u_e - u_w * u_w) * idx
    v_n = 0.5 * (v + vE)
    v_s = 0.5 * (vS + _sh(v, -1, 1))  # v[j-1,i], v[j-1,i+1]
    u_n = 0.5 * (uN + u)
    u_s = 0.5 * (uS + u)
    conv_uy = (v_n * u_n - v_s * u_s) * idy
    u_star = u + dt * (nu * lap_u - conv_ux - conv_uy)

    lap_v = (vE - 2.0 * v + vW) * idx2 + (vN - 2.0 * v + vS) * idy2
    v_nn = 0.5 * (v + vN)
    v_ss = 0.5 * (vS + v)
    conv_vy = (v_nn * v_nn - v_ss * v_ss) * idy
    u_e2 = 0.5 * (u + uN)  # u[j,i], u[j+1,i]
    u_w2 = 0.5 * (uW + _sh(u, 1, -1))  # u[j,i-1], u[j+1,i-1]
    v_e2 = 0.5 * (v + vE)
    v_w2 = 0.5 * (vW + v)
    conv_vx = (u_e2 * v_e2 - u_w2 * v_w2) * idx
    v_star = v + dt * (nu * lap_v - conv_vy - conv_vx)

    zero = torch.zeros_like(u)
    return torch.where(u_valid, u_star, zero), torch.where(v_valid, v_star, zero)


def divergence(u, v, c: StencilCoeffs, cell_mask):
    """(u[j,i]-u[j,i-1])/dx + (v[j,i]-v[j-1,i])/dy on masked cells
    (cavity-01.cpp:624-627)."""
    div = (u - _sh(u, 0, -1)) * c.idx + (v - _sh(v, -1, 0)) * c.idy
    return torch.where(cell_mask, div, torch.zeros_like(div))


def poisson_source(u_star, v_star, c: StencilCoeffs, cell_mask,
                   remove_mean: bool, n_cells: int):
    """b = (rho/dt) * div(u*), optionally minus its fluid-cell mean
    (channel-01.cpp:608-629)."""
    b = (c.density / c.dt) * divergence(u_star, v_star, c, cell_mask)
    if remove_mean:
        mean = torch.sum(b) / n_cells  # b is 0 outside mask
        b = torch.where(cell_mask, b - mean, b)
    return b


def pressure_correction(u_star, v_star, p, c: StencilCoeffs, u_valid, v_valid,
                        u_else, v_else, cavity_form: bool = False):
    """Projection u = u* - dt/(rho*dx) * (p[j,i+1]-p[j,i]) on valid faces
    (channel-01.cpp:693-702); ``cavity_form`` is the cavity's rho-multiplied
    variant (cavity-01.cpp:701,708). ``u_else``/``v_else``: values outside
    the valid masks."""
    if cavity_form:
        cu = c.dt / c.dx * c.density
        cv = c.dt / c.dy * c.density
    else:
        cu = c.dt / (c.density * c.dx)
        cv = c.dt / (c.density * c.dy)
    u_new = u_star - cu * (_sh(p, 0, 1) - p)
    v_new = v_star - cv * (_sh(p, 1, 0) - p)
    return torch.where(u_valid, u_new, u_else), torch.where(v_valid, v_new, v_else)


def interpolate_to_centers(u, v, cell_mask):
    """Two-point face-to-center averages on masked cells, zero elsewhere
    (cavity-01.cpp:717-733)."""
    uc = 0.5 * (_sh(u, 0, -1) + u)
    vc = 0.5 * (_sh(v, -1, 0) + v)
    zero = torch.zeros_like(u)
    return torch.where(cell_mask, uc, zero), torch.where(cell_mask, vc, zero)
