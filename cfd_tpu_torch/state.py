"""Flow state over torch tensors (the port of cfd_tpu.state)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

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
    """Per-step scalars of the stats row (cavity-01.cpp:769-773): host
    numbers from the per-kernel solve, whose tolerance loop runs on the
    host; 0-d tensors on the fields' device (int32 cycles, float32 residual)
    from the whole-solve and the whole step, read at print cadence
    (solver.read_diagnostics)."""

    poisson_iters: Union[int, torch.Tensor]
    poisson_residual: Union[float, torch.Tensor]
