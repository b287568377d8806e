"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch twins.

``KERNELS`` lists every kernel entry point of the ported paths (the cavity,
the channel, the backward step and Rayleigh-Benard at a fixed dt, their
adaptive-stepping instances, their whole time steps in one launch, the
fused coarse tail, the bfloat16 and corr_opt instances of the whole-solve
and the whole step, the natural layout's stage kernels, fused-residual
pairs and exact masked pairs, the cavity carry with the first pre-smooth
folded in, the channel's non-carry stage, the cavity's carry, pre and post,
the channel's and RB's carries and the step's carry, pre and post on one
shard's local block of a plane-row mesh, and the four traced-dt + Courant
carries there), each with its launch counter (kernels._build.Kernel)."""

from cfd_tpu_torch.kernels.mg_tail import MG_TAIL, MG_TAIL_FULL
from cfd_tpu_torch.kernels.projection import (
    CHANNEL_CORRECTOR as NATURAL_CHANNEL_CORRECTOR,
    CHANNEL_PREDICTOR_SOURCE as NATURAL_CHANNEL_PREDICTOR_SOURCE,
    CORRECTOR as NATURAL_CORRECTOR,
    PREDICTOR_SOURCE as NATURAL_PREDICTOR_SOURCE,
)
from cfd_tpu_torch.kernels.quad import (
    CARRY,
    CARRY_ADAPTIVE,
    CHANNEL_CARRY,
    CHANNEL_CARRY_ADAPTIVE,
    CHANNEL_CORRECTOR,
    CHANNEL_CORRECTOR_TRACED,
    CHANNEL_PREDICTOR_SOURCE,
    CORRECTOR,
    CORRECTOR_TRACED,
    FUSED_PRE,
    POST,
    PRE,
    PREDICTOR_SOURCE,
    SHARD_CARRY,
    SHARD_CARRY_ADAPTIVE,
    SHARD_CHANNEL_CARRY,
    SHARD_CHANNEL_CARRY_ADAPTIVE,
    SHARD_POST,
    SHARD_PRE,
)
from cfd_tpu_torch.kernels.rb_quad import (
    RB_CARRY,
    RB_CARRY_ADAPTIVE,
    RB_CORRECTOR,
    RB_CORRECTOR_TRACED,
    SHARD_RB_CARRY,
    SHARD_RB_CARRY_ADAPTIVE,
)
from cfd_tpu_torch.kernels.rb_smoother import RB_PAIRS, RB_PAIRS_FULL, RB_PAIRS_RES
from cfd_tpu_torch.kernels.step_quad import (
    SHARD_STEP_CARRY,
    SHARD_STEP_CARRY_ADAPTIVE,
    SHARD_STEP_POST,
    SHARD_STEP_PRE,
    STEP_CARRY,
    STEP_CARRY_ADAPTIVE,
    STEP_CORRECTOR,
    STEP_CORRECTOR_TRACED,
    STEP_POST,
    STEP_PRE,
)
from cfd_tpu_torch.kernels.step_smoother import STEP_PAIRS, STEP_PAIRS_RES
from cfd_tpu_torch.kernels.whole_solve import (
    STEP_WHOLE_SOLVE,
    STEP_WHOLE_SOLVE_BF16,
    STEP_WHOLE_SOLVE_CORR_OPT,
    WHOLE_SOLVE,
    WHOLE_SOLVE_BF16,
    WHOLE_SOLVE_PIN_MEAN,
    WHOLE_SOLVE_PIN_MEAN_BF16,
)
from cfd_tpu_torch.kernels.whole_step import (
    WHOLE_STEP_CAVITY,
    WHOLE_STEP_CAVITY_BF16,
    WHOLE_STEP_CHANNEL,
    WHOLE_STEP_CHANNEL_BF16,
    WHOLE_STEP_RB,
    WHOLE_STEP_RB_BF16,
    WHOLE_STEP_STEP,
    WHOLE_STEP_STEP_BF16,
    WHOLE_STEP_STEP_CORR_OPT,
)

KERNELS = (CARRY, CORRECTOR, PRE, POST, RB_PAIRS, CHANNEL_CARRY, CHANNEL_CORRECTOR,
           WHOLE_SOLVE, STEP_CARRY, STEP_CORRECTOR, STEP_PRE, STEP_POST, RB_PAIRS_FULL,
           STEP_WHOLE_SOLVE, RB_CARRY, RB_CORRECTOR, WHOLE_SOLVE_PIN_MEAN,
           PREDICTOR_SOURCE, CORRECTOR_TRACED, CARRY_ADAPTIVE, CHANNEL_CORRECTOR_TRACED,
           CHANNEL_CARRY_ADAPTIVE, STEP_CORRECTOR_TRACED, STEP_CARRY_ADAPTIVE,
           RB_CORRECTOR_TRACED, RB_CARRY_ADAPTIVE, WHOLE_STEP_CAVITY, WHOLE_STEP_CHANNEL,
           WHOLE_STEP_RB, WHOLE_STEP_STEP, MG_TAIL, MG_TAIL_FULL, WHOLE_SOLVE_BF16,
           WHOLE_SOLVE_PIN_MEAN_BF16, STEP_WHOLE_SOLVE_BF16, WHOLE_STEP_CAVITY_BF16,
           WHOLE_STEP_CHANNEL_BF16, WHOLE_STEP_RB_BF16, WHOLE_STEP_STEP_BF16,
           STEP_WHOLE_SOLVE_CORR_OPT, WHOLE_STEP_STEP_CORR_OPT, NATURAL_PREDICTOR_SOURCE,
           NATURAL_CORRECTOR, NATURAL_CHANNEL_PREDICTOR_SOURCE, NATURAL_CHANNEL_CORRECTOR,
           RB_PAIRS_RES, STEP_PAIRS, STEP_PAIRS_RES, FUSED_PRE, CHANNEL_PREDICTOR_SOURCE,
           SHARD_CARRY, SHARD_PRE, SHARD_POST, SHARD_CHANNEL_CARRY, SHARD_RB_CARRY,
           SHARD_STEP_CARRY, SHARD_STEP_PRE, SHARD_STEP_POST, SHARD_CARRY_ADAPTIVE,
           SHARD_CHANNEL_CARRY_ADAPTIVE, SHARD_RB_CARRY_ADAPTIVE, SHARD_STEP_CARRY_ADAPTIVE)

__all__ = ["KERNELS"]
