"""Flow state over torch tensors (the port of cfd_tpu.state)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class State(NamedTuple):
    """Flow fields on the padded staggered grid (see grid.Grid docstring).

    On the quad fast path the tensors are (4, Hq8, Wqa) block-parity planes
    (kernels.quad) and u/v hold the TENTATIVE velocities; the case's
    unalign_state converts to the logical (ny+2, nx+2) layout."""

    u: torch.Tensor  # x-velocity on x-faces, shape (ny+2, nx+2)
    v: torch.Tensor  # y-velocity on y-faces, shape (ny+2, nx+2)
    p: torch.Tensor  # pressure at cell centers, shape (ny+2, nx+2)
    T: Optional[torch.Tensor] = None  # temperature (Boussinesq cases only)
    # previous-step pressure for the extrapolated warm start 2 p - p_prev
    p_prev: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(shape: tuple[int, int], dtype=torch.float32, device="cpu") -> "State":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return State(u=z, v=z.clone(), p=z.clone())


class StepDiagnostics(NamedTuple):
    """Per-step scalars of the stats row (cavity-01.cpp:769-773). The port's
    solve checks convergence on the host, so both are host numbers."""

    poisson_iters: int
    poisson_residual: float
