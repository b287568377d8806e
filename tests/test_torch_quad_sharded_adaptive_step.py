"""The backward step's lagged adaptive run on the plane-row mesh: 64x16 on
4 shards at V(1,1) (tests/test_adaptive_sharded.py:137-157, marked slow
there), the masked carry, the fluid-only mean and the masked defect
correction, held to the reference's single-device lagged run at the bands
of tests/sharded_adaptive_slice.py, as the reference's own test holds its
sharded run. The reference's sharded run takes about 56 s on one core, past
a file's budget; its single-device run about 27 s."""

import jax.numpy as jnp
import torch

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step_case
from cfd_tpu_torch.cases import make_backwards_step_case
from sharded_adaptive_slice import hold, port_run, reference_run

torch.set_num_threads(1)

KW = dict(nx=64, ny=16, poisson="multigrid", tolerance_factor=1e-5,
          mg_overrides={"pre_sweeps": 1, "post_sweeps": 1}, print_interval=2)


def test_sharded_adaptive_step_matches_the_reference_single_device_run():
    ref = reference_run(jax_step_case(dtype=jnp.float32, smoother_mode="interpret",
                                      layout="quad", **KW), mesh=False)
    got = port_run(make_backwards_step_case(dtype=torch.float32, device="cpu", **KW))
    assert got[2]._engine.mg.post_sweeps == 1  # the sharded V(1,1) solve
    hold(ref, got)
