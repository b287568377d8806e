"""Flow diagnostics (the port of cfd_tpu.ops.reductions).

logStatistics (cavity-01.cpp:741-774): max |div(u)| and total/average
kinetic energy at cell centers, restricted to fluid cells.
"""

from __future__ import annotations

import torch

from cfd_tpu_torch.ops.stencil import StencilCoeffs, divergence, interpolate_to_centers


def flow_statistics(u, v, c: StencilCoeffs, cell_mask, n_cells: int) -> dict[str, torch.Tensor]:
    """Returns {max_divergence, avg_kinetic_energy, total_kinetic_energy}
    as 0-d tensors on the fields' device. ``n_cells``: the reference's KE
    divisor (nx*ny for the cavity, cavity-01.cpp:766)."""
    uc, vc = interpolate_to_centers(u, v, cell_mask)
    ke = 0.5 * torch.sum(uc * uc + vc * vc)  # 0 outside mask already
    div = divergence(u, v, c, cell_mask)
    return {
        "max_divergence": torch.max(torch.abs(div)),
        "total_kinetic_energy": ke,
        "avg_kinetic_energy": ke / n_cells,
    }
