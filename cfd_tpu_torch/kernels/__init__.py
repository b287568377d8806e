"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch twins.

``KERNELS`` lists every kernel entry point on the cavity main path, each
with its launch counter (kernels._build.Kernel)."""

from cfd_tpu_torch.kernels.quad import CARRY, CORRECTOR, POST, PRE
from cfd_tpu_torch.kernels.rb_smoother import RB_PAIRS

KERNELS = (CARRY, CORRECTOR, PRE, POST, RB_PAIRS)

__all__ = ["KERNELS"]
