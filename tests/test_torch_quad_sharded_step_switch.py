"""The sharded backward-facing step against cfd_tpu's
ShardedQuadProjection(interpret=True), 3 steps, at the reference test's
second configuration (tests/test_quad_sharded.py:233-280): 32x8 on 2
shards, a grid that coarsens only once, so the solve takes the coarse
switch at level 1 (the shards' level-1 sources gathered, the whole coarse
solve once, solid-filled, sliced back; cfd_tpu/parallel/quad_sharded.py:
678-690). The bands and the comparison are
tests/test_torch_quad_sharded_step_slice.py's."""

import torch

from test_torch_quad_sharded_step_slice import hold_to_the_reference

torch.set_num_threads(1)


def test_sharded_step_matches_the_reference_through_the_coarse_switch():
    hold_to_the_reference(32, 8, 2, l1_on_shards=False)
