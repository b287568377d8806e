"""Rayleigh-Benard's lagged adaptive run on the plane-row mesh against the
reference's (tests/test_adaptive_sharded.py:60-80): 48x16 at Ra = 1e5 on 4
shards, the (us*, vs*, p, T) carry, the per-cycle pin, the diffusive
ceiling from max(nu, kappa), the bands of tests/sharded_adaptive_slice.py
with T."""

import jax.numpy as jnp
import torch

from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_rb_case
from cfd_tpu_torch.cases import make_rayleigh_benard_case
from sharded_adaptive_slice import hold, port_run, reference_run

torch.set_num_threads(1)

KW = dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5, abs_tol=1e-7, print_interval=2)


def test_sharded_adaptive_rb_matches_the_reference():
    ref = reference_run(jax_rb_case(dtype=jnp.float32, step_kernel_mode="interpret",
                                    layout="quad", **KW))
    hold(ref, port_run(make_rayleigh_benard_case(dtype=torch.float32, device="cpu", **KW)),
         fields=("u", "v", "p", "T"))
