"""The cavity's lagged adaptive run on the plane-row mesh against the
reference's (tests/test_adaptive_sharded.py:38-57): 64^2 on 4 shards, the
bands of tests/sharded_adaptive_slice.py."""

import jax.numpy as jnp
import torch

from cfd_tpu.cases import make_cavity_case as jax_cavity_case
from cfd_tpu_torch.cases import make_cavity_case
from sharded_adaptive_slice import hold, port_run, reference_run

torch.set_num_threads(1)

KW = dict(n_interior=64, poisson="multigrid", print_interval=2)


def test_sharded_adaptive_cavity_matches_the_reference():
    ref = reference_run(jax_cavity_case(dtype=jnp.float32, step_kernel_mode="interpret",
                                        layout="quad", **KW))
    hold(ref, port_run(make_cavity_case(dtype=torch.float32, device="cpu", **KW)))
