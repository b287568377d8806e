"""The channel's lagged adaptive run on the plane-row mesh against the
reference's (tests/test_adaptive_sharded.py:83-101): 64x16 on 4 shards,
the source mean from the shards' own-row sums, the bands of
tests/sharded_adaptive_slice.py."""

import jax.numpy as jnp
import torch

from cfd_tpu.cases import make_channel_case as jax_channel_case
from cfd_tpu_torch.cases import make_channel_case
from sharded_adaptive_slice import hold, port_run, reference_run

torch.set_num_threads(1)

KW = dict(nx=64, ny=16, poisson="multigrid", tolerance_factor=1e-5, print_interval=2)


def test_sharded_adaptive_channel_matches_the_reference():
    ref = reference_run(jax_channel_case(dtype=jnp.float32, step_kernel_mode="interpret",
                                         layout="quad", **KW))
    hold(ref, port_run(make_channel_case(dtype=torch.float32, device="cpu", **KW)))
