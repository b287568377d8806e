"""Numerics/ops layer: MAC-grid stencils and reductions on torch tensors."""

from cfd_tpu_torch.ops.reductions import flow_statistics
from cfd_tpu_torch.ops.stencil import (
    StencilCoeffs,
    divergence,
    interpolate_to_centers,
    iota_masks,
    poisson_source,
    predictor,
    pressure_correction,
)

__all__ = [
    "StencilCoeffs",
    "iota_masks",
    "predictor",
    "divergence",
    "poisson_source",
    "pressure_correction",
    "interpolate_to_centers",
    "flow_statistics",
]
