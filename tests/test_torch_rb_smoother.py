"""cfd_tpu_torch coarse red/black smoother (plain twin) against cfd_tpu's
Pallas make_rb_pairs in interpret mode, on aligned cavity levels, float32
and bfloat16 storage, plain and residual-field variants.

Bands: float32 within 2e-6 of the field's max magnitude; bfloat16 within
one bf16 ulp of the field's max (both sides compute in float32 and round
to storage once, so a difference is a rounding-boundary flip at most)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.kernels.rb_smoother import rb_pairs_for_level as j_pairs
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch.kernels.rb_smoother import RB_PAIRS
from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level as t_pairs
from cfd_tpu_torch.poisson import multigrid as TM

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _levels(n, k, dtype):
    """Level k of the aligned cavity hierarchy from n^2, in both packages."""
    jp = JM.cavity_problem(n, n, 1.0 / n, 1.0 / n)
    tp = TM.cavity_problem(n, n, 1.0 / n, 1.0 / n)
    for _ in range(k):
        jp, tp = JM.coarsen_problem(jp), TM.coarsen_problem(tp)
    tdt, jdt = DTYPES[dtype]
    return TM._build_level(tp, tdt), JM._build_level(jp, jdt, aligned=True), tp


def _inputs(level, prob, seed):
    H8, W = level.shape
    rng = np.random.default_rng(seed)
    p = np.zeros((H8, W), np.float32)
    b = np.zeros((H8, W), np.float32)
    p[1 : prob.ny + 1, 1 : prob.nx + 1] = rng.standard_normal((prob.ny, prob.nx))
    b[1 : prob.ny + 1, 1 : prob.nx + 1] = rng.standard_normal((prob.ny, prob.nx)) * 50
    return p, b


def _band(want, dtype):
    scale = float(np.abs(want).max())
    if dtype == "float32":
        return 2e-6 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)  # one bf16 ulp at the max


@pytest.mark.parametrize("variant", ["pairs", "residual_field"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(64, 1), (128, 3)])
def test_rb_pairs_plain_matches_jax(n, k, dtype, variant):
    tlv, jlv, prob = _levels(n, k, dtype)
    assert tlv.shape == jlv.shape
    field = variant == "residual_field"
    n_pairs = 2 if field else 1
    p, b = _inputs(tlv, prob, seed=n + k)
    tdt, jdt = DTYPES[dtype]
    got = t_pairs(tlv, 1.0, n_pairs, with_residual_field=field)(
        torch.from_numpy(p).to(tdt), torch.from_numpy(b).to(tdt))
    want = j_pairs(jlv, 1.0, n_pairs, interpret=True, with_residual_field=field,
                   aligned_io=True, tile_rows=8, dtype=jdt)(
        jnp.asarray(p, jdt), jnp.asarray(b, jdt))
    got = got if field else (got,)
    want = want if field else (want,)
    for a, w in zip(got, want, strict=True):
        assert a.dtype == tdt
        w = np.asarray(w).astype(np.float32)
        np.testing.assert_allclose(a.float().numpy(), w, rtol=0, atol=_band(w, dtype))


def test_rb_pairs_guards():
    tlv, _, prob = _levels(32, 1, "float32")
    sm = t_pairs(tlv, 1.0, 1)
    p, b = (torch.from_numpy(a) for a in _inputs(tlv, prob, 0))
    before = RB_PAIRS.launches
    assert torch.equal(sm(p, b), sm.plain(p, b))  # CPU -> plain twin
    assert RB_PAIRS.launches == before
    with pytest.raises(ValueError, match="bfloat16|float32"):
        sm(p.to(torch.bfloat16), b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="n_pairs"):
        t_pairs(tlv, 1.0, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rb_pairs_kernel_matches_plain_on_card(cuda_device, dtype):
    tlv, _, prob = _levels(256, 1, dtype)
    tlv = tlv.to(cuda_device)
    tdt = DTYPES[dtype][0]
    p, b = (torch.from_numpy(a).to(cuda_device, tdt) for a in _inputs(tlv, prob, 1))
    sm = t_pairs(tlv, 1.0, 2, with_residual_field=True)
    for a, w in zip(sm(p, b), sm.plain(p, b)):
        assert torch.equal(a, w)
