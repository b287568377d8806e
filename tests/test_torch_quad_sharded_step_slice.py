"""The sharded backward-facing step (cfd_tpu_torch.parallel, row 16f)
against cfd_tpu's ShardedQuadProjection(interpret=True) on the host mesh
(tests/conftest.py), 3 steps, at the reference test's first configuration
(tests/test_quad_sharded.py:233-280): 64x16 on 4 shards (P = 8), whose
level 1 band-smooths on the shards' local blocks and whose levels 2 and
below run once. Bands: cycles within 1 on every step, u, v and p within
2e-5 of scale, and the u faces inside the solid block exactly 0. The
coarse-switch branch (a grid that coarsens only once) is in
tests/test_torch_quad_sharded_step_switch.py; the reference's compile
takes most of each file's time."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh as JaxMesh

from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step_case
from cfd_tpu.parallel import quad_sharded as JS
from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.parallel import ShardedQuadProjection, make_mesh
from cfd_tpu_torch.poisson.multigrid import step_rect_params

torch.set_num_threads(1)

SHARDED = dict(tol_factor=1e-5, mg_overrides={"abs_tol": 1e-10})


def _run(sq, steps):
    s = sq.initial_state()
    iters = []
    for _ in range(steps):
        s, d = sq.step(s)
        iters.append(int(d["poisson_iters"]))
    return iters, sq.logical(s)


def hold_to_the_reference(nx: int, ny: int, mdy: int, l1_on_shards: bool) -> None:
    """The port's sharded step against the reference's over 3 steps, both
    from the case at tolerance 1e-5 and V(1,1) (the reference test's)."""
    kw = dict(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-5,
              mg_overrides={"pre_sweeps": 1, "post_sweeps": 1})
    case = make_backwards_step_case(dtype=torch.float32, device="cpu", **kw)
    sq = ShardedQuadProjection(case, make_mesh(mdy, device="cpu"), **SHARDED)
    assert (sq.flavor, sq.n_carry, sq._solve.l1_spmd) == ("backwards_step", 3, l1_on_shards)
    got_iters, got = _run(sq, 3)
    jcase = jax_step_case(dtype=jnp.float32, smoother_mode="interpret", layout="quad", **kw)
    jsq = JS.ShardedQuadProjection(jcase, JaxMesh(np.array(jax.devices("cpu")[:mdy]), ("dy",)),
                                   interpret=True, **SHARDED)
    want_iters, want = _run(jsq, 3)
    assert all(abs(a - b) <= 1 for a, b in zip(got_iters, want_iters, strict=True)), \
        (got_iters, want_iters)
    for name in ("u", "v", "p"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)
    step_i, inlet_j = step_rect_params(case.grid)
    assert not got.u[inlet_j + 1 : -1, 1:step_i].any()  # the solid block's u faces


def test_sharded_step_matches_the_reference_with_level_1_on_the_shards():
    hold_to_the_reference(64, 16, 4, l1_on_shards=True)
