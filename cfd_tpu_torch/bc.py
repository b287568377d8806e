"""Ghost-cell boundary conditions (the port of cfd_tpu.bc).

Only the lid-driven cavity family is ported; channel, step and pressure
ghosts follow with their cases (ROADMAP.md queue A items 7-8).

Reference code: cavity-01.cpp:523-543.
"""

from __future__ import annotations

from typing import Callable

import torch

from cfd_tpu_torch.grid import Grid

VelocityBC = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


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
