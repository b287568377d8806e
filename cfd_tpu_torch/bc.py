"""Ghost-cell boundary conditions (the port of cfd_tpu.bc).

Ported: the lid-driven cavity, the channel and the backward-step velocity
families, and the channel and step pressure ghosts of the natural-layout
masked solve (the quad path's live in its kernels, kernels.step_quad).

Reference code: cavity-01.cpp:523-543, channel-01.cpp:513-541,
backwards_step-01.cpp:616-740.
"""

from __future__ import annotations

from typing import Callable

import torch

from cfd_tpu_torch.grid import Grid

VelocityBC = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
PressureBC = Callable[[torch.Tensor], torch.Tensor]


def lid_cavity_bc(grid: Grid, lid_velocity: float) -> VelocityBC:
    """Moving-lid + no-slip ghost BCs (cavity-01.cpp:523-543), in the
    reference's update order.

    North lid u-ghost = 2*U_lid - u_interior; south u-ghost antisymmetric;
    east/west v-ghosts antisymmetric. Returns new tensors; the inputs are
    not modified."""
    nx, ny = grid.nx, grid.ny

    def bc(u: torch.Tensor, v: torch.Tensor):
        u, v = u.clone(), v.clone()
        u[ny + 1, 0 : nx + 1] = 2.0 * lid_velocity - u[ny, 0 : nx + 1]
        u[0, 0 : nx + 1] = -u[1, 0 : nx + 1]
        v[0 : ny + 1, nx + 1] = -v[0 : ny + 1, nx]
        v[0 : ny + 1, 0] = -v[0 : ny + 1, 1]
        return u, v

    return bc


def channel_bc(grid: Grid, inlet_velocity: float) -> VelocityBC:
    """Inflow/outflow channel BCs (channel-01.cpp:513-529), in the
    reference's update order: inlet u/v, outlet u/v (zero-gradient), bottom
    wall v/u, top wall v/u. The wall u-ghost rows read the already-updated
    inlet and outlet columns. Returns new tensors."""
    nx, ny = grid.nx, grid.ny

    def bc(u: torch.Tensor, v: torch.Tensor):
        u, v = u.clone(), v.clone()
        u[1 : ny + 1, 0] = inlet_velocity
        v[0 : ny + 1, 0] = 0.0
        u[1 : ny + 1, nx] = u[1 : ny + 1, nx - 1]
        v[0 : ny + 1, nx + 1] = v[0 : ny + 1, nx]
        v[0, 1 : nx + 1] = 0.0
        u[0, 0 : nx + 1] = -u[1, 0 : nx + 1]
        v[ny, 1 : nx + 1] = 0.0
        u[ny + 1, 0 : nx + 1] = -u[ny, 0 : nx + 1]
        return u, v

    return bc


def step_bc(grid: Grid, inlet_velocity: float, inlet_j_max: int) -> VelocityBC:
    """Channel BCs with the inlet restricted to rows 1..inlet_j_max, then the
    solid-interface face zeroing (backwards_step-01.cpp:616-683), in the
    reference's update order; the interface sweep is the grid's
    u_zero_mask / v_zero_mask, applied last. Returns new tensors."""
    nx, ny = grid.nx, grid.ny
    u_zero = torch.as_tensor(grid.u_zero_mask)
    v_zero = torch.as_tensor(grid.v_zero_mask)

    def bc(u: torch.Tensor, v: torch.Tensor):
        u, v = u.clone(), v.clone()
        u[1 : inlet_j_max + 1, 0] = inlet_velocity
        u[inlet_j_max + 1 : ny + 1, 0] = 0.0
        v[0 : ny + 1, 0] = 0.0
        u[1 : ny + 1, nx] = u[1 : ny + 1, nx - 1]
        v[0 : ny + 1, nx + 1] = v[0 : ny + 1, nx]
        v[0, 1 : nx + 1] = 0.0
        u[0, 0 : nx + 1] = -u[1, 0 : nx + 1]
        v[ny, 1 : nx + 1] = 0.0
        u[ny + 1, 0 : nx + 1] = -u[ny, 0 : nx + 1]
        u = torch.where(u_zero.to(u.device), torch.zeros_like(u), u)
        v = torch.where(v_zero.to(v.device), torch.zeros_like(v), v)
        return u, v

    return bc


def channel_pressure_ghosts(grid: Grid) -> PressureBC:
    """Inlet Neumann, outlet Dirichlet p = 0 in the ghost column, wall
    Neumann (channel-01.cpp:531-541), in the reference's order
    (cfd_tpu/bc.py:91). Returns a new tensor."""
    nx, ny = grid.nx, grid.ny

    def ghosts(p: torch.Tensor) -> torch.Tensor:
        p = p.clone()
        p[1 : ny + 1, 0] = p[1 : ny + 1, 1]
        p[1 : ny + 1, nx + 1] = 0.0
        p[0, 1 : nx + 1] = p[1, 1 : nx + 1]
        p[ny + 1, 1 : nx + 1] = p[ny, 1 : nx + 1]
        return p

    return ghosts


def step_pressure_ghosts(grid: Grid, device="cpu") -> PressureBC:
    """The channel pressure ghosts, then each solid interior cell with a
    fluid neighbour set to the mean of its fluid neighbours (Neumann across
    internal walls, backwards_step-01.cpp:685-740; cfd_tpu/bc.py:106), with
    the reference's neighbour predicates (Grid.solid_neighbor_weights). The
    mean reads fluid cells only, which the refresh does not change, so it
    is order independent. The masks live on ``device``."""
    base = channel_pressure_ghosts(grid)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    wE, wW, wN, wS, count = (t(w) for w in grid.solid_neighbor_weights)
    update = torch.as_tensor(grid.solid_interior_mask, device=device) & (count > 0)
    safe_count = torch.where(count > 0, count, torch.ones_like(count))

    def ghosts(p: torch.Tensor) -> torch.Tensor:
        p = base(p)
        pE = torch.roll(p, -1, dims=1)
        pW = torch.roll(p, 1, dims=1)
        pN = torch.roll(p, -1, dims=0)
        pS = torch.roll(p, 1, dims=0)
        avg = (wE * pE + wW * pW + wN * pN + wS * pS) / safe_count
        return torch.where(update, avg.to(p.dtype), p)

    return ghosts
