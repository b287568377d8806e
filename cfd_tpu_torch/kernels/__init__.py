"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch twins.

``KERNELS`` lists every kernel entry point of the ported paths (the cavity
and the channel), each with its launch counter (kernels._build.Kernel)."""

from cfd_tpu_torch.kernels.quad import (
    CARRY,
    CHANNEL_CARRY,
    CHANNEL_CORRECTOR,
    CORRECTOR,
    POST,
    PRE,
)
from cfd_tpu_torch.kernels.rb_smoother import RB_PAIRS
from cfd_tpu_torch.kernels.whole_solve import WHOLE_SOLVE

KERNELS = (CARRY, CORRECTOR, PRE, POST, RB_PAIRS, CHANNEL_CARRY, CHANNEL_CORRECTOR,
           WHOLE_SOLVE)

__all__ = ["KERNELS"]
