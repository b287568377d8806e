"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch twins.

``KERNELS`` lists every kernel entry point of the ported paths (the cavity,
the channel, the backward step and Rayleigh-Benard), each with its launch
counter (kernels._build.Kernel)."""

from cfd_tpu_torch.kernels.quad import (
    CARRY,
    CHANNEL_CARRY,
    CHANNEL_CORRECTOR,
    CORRECTOR,
    POST,
    PRE,
)
from cfd_tpu_torch.kernels.rb_quad import RB_CARRY, RB_CORRECTOR
from cfd_tpu_torch.kernels.rb_smoother import RB_PAIRS, RB_PAIRS_FULL
from cfd_tpu_torch.kernels.step_quad import STEP_CARRY, STEP_CORRECTOR, STEP_POST, STEP_PRE
from cfd_tpu_torch.kernels.whole_solve import (
    STEP_WHOLE_SOLVE,
    WHOLE_SOLVE,
    WHOLE_SOLVE_PIN_MEAN,
)

KERNELS = (CARRY, CORRECTOR, PRE, POST, RB_PAIRS, CHANNEL_CARRY, CHANNEL_CORRECTOR,
           WHOLE_SOLVE, STEP_CARRY, STEP_CORRECTOR, STEP_PRE, STEP_POST, RB_PAIRS_FULL,
           STEP_WHOLE_SOLVE, RB_CARRY, RB_CORRECTOR, WHOLE_SOLVE_PIN_MEAN)

__all__ = ["KERNELS"]
