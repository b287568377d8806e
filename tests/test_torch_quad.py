"""cfd_tpu_torch quad layout and the plain twins of the four quad kernels
against cfd_tpu's Pallas kernels in interpret mode (tile_rows=8, so the
reference runs its slab path).

Bands (tests/test_quad.py, ROADMAP.md section C): velocities 2e-6, b at
1e-5 of max|b|, smoothed p 2e-6, the post residual 1e-3 relative. The
kernels themselves run only on a CUDA card; their tests carry the ``cuda``
marker and skip here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.kernels import quad as JQ
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch.kernels import _build
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.poisson import multigrid as TM

torch.set_num_threads(1)


def _coeffs(pkg_coeffs, n):
    h = 1.0 / n
    return pkg_coeffs(dx=h, dy=h, dt=0.25 * h, viscosity=1e-3, density=1.0)


def _natural(n, seed, scale=0.1, interior_only=False):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n + 2, n + 2)) * scale).astype(np.float32)
    if interior_only:
        a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
    return a


def _both_quad(a, shape):
    """(port quad tensor, JAX quad array) of one natural numpy array."""
    return (TQ.to_quad(torch.from_numpy(a), shape),
            JQ.to_quad(jnp.asarray(a, jnp.float32), shape))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(34, 34), (66, 66), (18, 130), (35, 21)])
def test_quad_roundtrip_matches_jax(shape):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    tq, jq = _both_quad(a, shape)
    assert TQ.quad_dims(shape) == JQ.quad_dims(shape)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(TQ.from_quad(tq, shape).numpy(), a)


def test_uncorrect_quad_matches_jax():
    n = 32
    shape = (n + 2, n + 2)
    u, v, p = (_natural(n, s) for s in (1, 2, 3))
    got = TQ.uncorrect_quad(torch.from_numpy(u), torch.from_numpy(v),
                            torch.from_numpy(p), shape, _coeffs(TCoeffs, n))
    want = JQ.uncorrect_quad(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), shape,
                             _coeffs(JCoeffs, n), cavity_form=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _stage_inputs(n, seed):
    shape = (n + 2, n + 2)
    arrays = [_natural(n, seed), _natural(n, seed + 1),
              _natural(n, seed + 2, interior_only=True),
              _natural(n, seed + 3, interior_only=True)]
    pairs = [_both_quad(a, shape) for a in arrays]
    return shape, [t for t, _ in pairs], [j for _, j in pairs]


@pytest.mark.parametrize("n", [32, 64])
def test_carry_plain_matches_jax(n):
    shape, tin, jin = _stage_inputs(n, 10 + n)
    got = TQ.make_quad_corr_predictor_source(shape, _coeffs(TCoeffs, n)).plain(*tin)
    want = JQ.make_quad_corr_predictor_source(shape, _coeffs(JCoeffs, n),
                                              tile_rows=8, interpret=True)(*jin)
    max_b = float(want[4])
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)
    _close(got[2], want[2], 1e-5 * max_b)
    _close(got[3], want[3], 2e-6)
    assert abs(float(got[4]) - max_b) <= 1e-5 * max_b


@pytest.mark.parametrize("n", [32, 64])
def test_corrector_plain_matches_jax(n):
    shape, tin, jin = _stage_inputs(n, 20 + n)
    got = TQ.make_quad_corrector(shape, _coeffs(TCoeffs, n)).plain(*tin)
    want = JQ.make_quad_corrector(shape, _coeffs(JCoeffs, n), tile_rows=8,
                                  interpret=True)(*jin)
    for a, b in zip(got, want, strict=True):
        _close(a, b, 2e-6)


def _poisson_inputs(n, seed):
    shape = (n + 2, n + 2)
    coarse = JM._round_up8_128((n // 2 + 2, n // 2 + 2))
    p = _natural(n, seed, scale=1.0, interior_only=True)
    b = _natural(n, seed + 1, scale=1.0, interior_only=True)
    tp, jp = _both_quad(p, shape)
    tb, jb = _both_quad(b, shape)
    return (shape, coarse, TM.cavity_problem(n, n, 1.0 / n, 1.0 / n),
            JM.cavity_problem(n, n, 1.0 / n, 1.0 / n), tp, tb, jp, jb)


@pytest.mark.parametrize("n", [32, 64])
def test_pre_smooth_restrict_plain_matches_jax(n):
    shape, coarse, tprob, jprob, tp, tb, jp, jb = _poisson_inputs(n, 30 + n)
    got = TQ.make_quad_pre_smooth_restrict(shape, tprob, 1.0, 2, coarse).plain(tp, tb)
    want = JQ.make_quad_pre_smooth_restrict(shape, jprob, 1.0, 2, coarse, tile_rows=8,
                                            interpret=True)(jp, jb)
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 1e-5 * float(np.abs(np.asarray(want[1])).max()))


@pytest.mark.parametrize("n", [32, 64])
def test_post_prolong_smooth_plain_matches_jax(n):
    shape, coarse, tprob, jprob, tp, tb, jp, jb = _poisson_inputs(n, 40 + n)
    ec = np.zeros(coarse, np.float32)
    ec[1 : n // 2 + 1, 1 : n // 2 + 1] = np.random.default_rng(n).standard_normal(
        (n // 2, n // 2))
    got = TQ.make_quad_post_prolong_smooth(shape, tprob, 1.0, 1, coarse).plain(
        tp, tb, torch.from_numpy(ec))
    want = JQ.make_quad_post_prolong_smooth(shape, jprob, 1.0, 1, coarse, tile_rows=8,
                                            interpret=True)(jp, jb, jnp.asarray(ec))
    _close(got[0], want[0], 2e-6)
    assert abs(float(got[1]) - float(want[1])) <= 1e-3 * float(want[1])


def _ops(n, device="cpu"):
    shape, coarse, tprob, *_ = _poisson_inputs(n, 0)
    c = _coeffs(TCoeffs, n)
    return dict(
        carry=TQ.make_quad_corr_predictor_source(shape, c),
        corrector=TQ.make_quad_corrector(shape, c),
        pre=TQ.make_quad_pre_smooth_restrict(shape, tprob, 1.0, 2, coarse, device=device),
        post=TQ.make_quad_post_prolong_smooth(shape, tprob, 1.0, 1, coarse, device=device),
    )


def _op_inputs(name, n, device):
    shape, coarse, _, _, tp, tb, _, _ = _poisson_inputs(n, 50)
    if name in ("carry", "corrector"):
        return [t.to(device) for t in _stage_inputs(n, 60)[1]]
    if name == "pre":
        return [tp.to(device), tb.to(device)]
    ec = torch.from_numpy(_natural(n // 2 - 2, 70)).float()
    ec = torch.nn.functional.pad(ec, (0, coarse[1] - ec.shape[1], 0, coarse[0] - ec.shape[0]))
    return [tp.to(device), tb.to(device), ec.contiguous().to(device)]


@pytest.mark.parametrize("name", ["carry", "corrector", "pre", "post"])
def test_cpu_dispatch_runs_plain_and_counts_no_launch(name):
    op = _ops(32)[name]
    args = _op_inputs(name, 32, "cpu")
    before = {k.name: k.launches for k in (TQ.CARRY, TQ.CORRECTOR, TQ.PRE, TQ.POST)}
    for a, b in zip(op(*args), op.plain(*args), strict=True):
        assert torch.equal(a, b)
    assert before == {k.name: k.launches for k in (TQ.CARRY, TQ.CORRECTOR, TQ.PRE, TQ.POST)}


def test_wrappers_check_shape_dtype_and_device():
    op = _ops(32)["corrector"]
    args = _op_inputs("corrector", 32, "cpu")
    with pytest.raises(ValueError, match="shape"):
        op(args[0][:, :-1].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="float32"):
        op(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        op(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="device"):
        _build.route(torch.zeros(1), torch.zeros(1, device="meta"))


def test_kernel_path_raises_without_nvcc(monkeypatch, tmp_path):
    """No silent fallback: with no compiler the CUDA path raises."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
        op = _ops(32)["corrector"]
        with pytest.raises(RuntimeError, match="nvcc not found"):
            op.kernel(*_op_inputs("corrector", 32, "cpu"))
        assert TQ.CORRECTOR.launches == 0
    finally:
        _build.library.cache_clear()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["carry", "corrector", "pre", "post"])
def test_kernel_matches_plain_on_card(cuda_device, name):
    op = _ops(64, cuda_device)[name]
    args = _op_inputs(name, 64, cuda_device)
    before = getattr(TQ, {"carry": "CARRY", "corrector": "CORRECTOR", "pre": "PRE",
                          "post": "POST"}[name]).launches
    for a, b in zip(op(*args), op.plain(*args), strict=True):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale
    after = getattr(TQ, {"carry": "CARRY", "corrector": "CORRECTOR", "pre": "PRE",
                         "post": "POST"}[name]).launches
    assert after == before + 1
