"""The channel's ops and stage kernels in cfd_tpu_torch against cfd_tpu on
the CPU: the channel ghost BCs and the channel Poisson operators in
float64 (1e-12), and the plain twins of the channel carry and corrector
against cfd_tpu's Pallas kernels in interpret mode at 64x32 (tile_rows=8,
so the reference runs its slab path), and of the non-carry stage (row 8c)
at the 32x16 case of tests/test_quad.py:231, with the split ordering
corrector -> non-carry stage equal to the carry's twin bit for bit.

Bands (tests/test_quad.py, ROADMAP.md section C): u and v 2e-6, b 1e-5 of
max|b|, the source sum 1e-6 of sum|b| (the two packages add in other
orders), the warm-start guess exact. The CUDA kernels themselves are held
to these twins on the card by tests/test_torch_channel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import bc as JB
from cfd_tpu import grid as JG
from cfd_tpu.kernels import quad as JQ
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch import bc as TB
from cfd_tpu_torch import grid as TG
from cfd_tpu_torch.kernels import mg_tail as TT
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.poisson import multigrid as TM

torch.set_num_threads(1)

NX, NY = 64, 32
SHAPE = (NY + 2, NX + 2)
COEFFS = dict(dx=3.0 / NX, dy=1.0 / NY, dt=6.1e-3, viscosity=1e-2, density=1.3)


@pytest.mark.parametrize("uin", [1.0, -0.35])
def test_channel_bc_matches_jax(uin):
    rng = np.random.default_rng(3)
    u, v = rng.standard_normal((2, *SHAPE))
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    got = TB.channel_bc(TG.Grid.regular(NX, NY, 3.0, 1.0), uin)(ut, vt)
    want = JB.channel_bc(JG.Grid.regular(NX, NY, 3.0, 1.0), uin)(jnp.asarray(u),
                                                                  jnp.asarray(v))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ut.numpy(), u)  # inputs untouched


@pytest.mark.parametrize("flavor", ["neumann_problem", "channel_problem"])
def test_channel_problems_and_hierarchy_match_jax(flavor):
    """The operators and every coarsened level's weights (the edge fix
    4w/(2+w) included: the outlet coupling 1 -> 4/3 -> 8/5 ...), in f64."""
    tp = getattr(TM, flavor)(NX, NY, 3.0 / NX, 1.0 / NY)
    jp = getattr(JM, flavor)(NX, NY, 3.0 / NX, 1.0 / NY)
    tprobs = TM.build_problems(tp, TM.MGConfig())
    jprobs = [jp]
    while len(jprobs) < len(tprobs):
        jprobs.append(JM.coarsen_problem(jprobs[-1]))
    assert len(tprobs) == 4
    for a, b in zip(tprobs, jprobs, strict=True):
        assert (a.nx, a.ny, a.dx, a.dy) == (b.nx, b.ny, b.dx, b.dy)
        for w in ("wE", "wW", "wN", "wS"):
            np.testing.assert_allclose(getattr(a, w), getattr(b, w), rtol=0, atol=1e-12)
    if flavor == "channel_problem":
        assert tprobs[1].wE[1, tprobs[1].nx] == pytest.approx(4.0 / 3.0, abs=1e-12)
    np.testing.assert_allclose(TM._dense_pinv(tprobs[-1]), JM._dense_pinv(jprobs[-1]),
                               rtol=0, atol=1e-12)


def _stage_inputs(seed):
    rng = np.random.default_rng(seed)
    arrays = []
    for k in range(4):
        a = (rng.standard_normal(SHAPE) * 0.1).astype(np.float32)
        if k >= 2:  # p, p_prev live on the interior
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        arrays.append(a)
    return ([TQ.to_quad(torch.from_numpy(a), SHAPE) for a in arrays],
            [JQ.to_quad(jnp.asarray(a), SHAPE) for a in arrays])


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_channel_carry_plain_matches_jax():
    uin = 0.7
    tin, jin = _stage_inputs(11)
    got = TQ.make_quad_channel_corr_predictor_source(SHAPE, TCoeffs(**COEFFS), uin).plain(*tin)
    want = JQ.make_quad_channel_corr_predictor_source(SHAPE, JCoeffs(**COEFFS), uin,
                                                      tile_rows=8, interpret=True)(*jin)
    b = np.asarray(want[2])
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)
    _close(got[2], want[2], 1e-5 * np.abs(b).max())
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert abs(float(got[4]) - float(want[4])) <= 1e-6 * np.abs(b).sum()


def test_channel_corrector_plain_matches_jax():
    tin, jin = _stage_inputs(12)
    got = TQ.make_quad_channel_corrector(SHAPE, TCoeffs(**COEFFS), 1.0).plain(*tin)
    want = JQ.make_quad_channel_corrector(SHAPE, JCoeffs(**COEFFS), 1.0, tile_rows=8,
                                          interpret=True)(*jin)
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _case_inputs(seed):
    """The channel of tests/test_quad.py:231 (32x16, the factory's
    coefficients) in both packages, and a seeded (u, v) for each."""
    from cfd_tpu.cases.channel import make_channel_case as jax_channel
    from cfd_tpu_torch.cases import make_channel_case

    jcase = jax_channel(nx=32, ny=16, dtype=jnp.float32, poisson="multigrid",
                        step_kernel_mode="off")
    tcase = make_channel_case(nx=32, ny=16, dtype=torch.float32, poisson="multigrid",
                              device="cpu")
    shape = jcase.grid.shape
    rng = np.random.default_rng(seed)
    u, v = ((rng.standard_normal(shape) * 0.1).astype(np.float32) for _ in range(2))
    return (jcase, tcase, shape, [TQ.to_quad(torch.from_numpy(a), shape) for a in (u, v)],
            [JQ.to_quad(jnp.asarray(a), shape) for a in (u, v)])


def test_channel_predictor_source_plain_matches_jax():
    """Row 8c, the non-carry channel stage, against
    make_quad_channel_predictor_source(interpret=True) (tests/test_quad.py:231)."""
    jcase, tcase, shape, tin, jin = _case_inputs(11)
    got = TQ.make_quad_channel_predictor_source(shape, tcase.coeffs, 1.0).plain(*tin)
    want = JQ.make_quad_channel_predictor_source(shape, jcase.coeffs, 1.0, tile_rows=8,
                                                 interpret=True)(*jin)
    b = np.asarray(want[2])
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)
    _close(got[2], want[2], 1e-5 * np.abs(b).max())
    assert abs(float(got[3]) - float(want[3])) <= 1e-6 * np.abs(b).sum()


def test_split_corrector_then_predictor_source_is_the_carry():
    """8b then 8c equals the channel carry (8a), as the reference holds its
    kernels (tests/test_quad.py:371); here the twins, bit for bit, the sum
    included."""
    _, tcase, shape, (u, v), _ = _case_inputs(12)
    p = TQ.to_quad(torch.from_numpy(np.random.default_rng(13).standard_normal(shape)
                                    .astype(np.float32) * 0.1), shape)
    p_prev = 0.5 * p
    c = tcase.coeffs
    u2, v2, guess = TQ.make_quad_channel_corrector(shape, c).plain(u, v, p, p_prev)
    split = TQ.make_quad_channel_predictor_source(shape, c).plain(u2, v2)
    carry = TQ.make_quad_channel_corr_predictor_source(shape, c).plain(u, v, p, p_prev)
    for a, b in zip((*split[:3], guess, split[3]), carry, strict=True):
        assert torch.equal(a, b)


def test_channel_corner_ghosts():
    """The u ghost rows read the inlet and outlet columns AFTER their
    update: the four corners are minus the inlet value (west) and minus the
    outlet copy of column nx-1 (east); the v outlet column copies nx."""
    tin, _ = _stage_inputs(13)
    u, v, _ = TQ.make_quad_channel_corrector(SHAPE, TCoeffs(**COEFFS), 0.7).plain(*tin)
    u, v = TQ.from_quad(u, SHAPE), TQ.from_quad(v, SHAPE)
    assert float(u[0, 0]) == float(u[NY + 1, 0]) == -np.float32(0.7)
    assert float(u[0, NX]) == -float(u[1, NX - 1])
    assert float(u[NY + 1, NX]) == -float(u[NY, NX - 1])
    assert torch.equal(u[1 : NY + 1, NX], u[1 : NY + 1, NX - 1])
    assert torch.equal(v[: NY + 1, NX + 1], v[: NY + 1, NX])
    assert float(v[:, 0].abs().max()) == 0.0


def test_uncorrect_channel_form_matches_jax():
    rng = np.random.default_rng(14)
    u, v, p = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3))
    got = TQ.uncorrect_quad(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(p),
                            SHAPE, TCoeffs(**COEFFS), cavity_form=False)
    want = JQ.uncorrect_quad(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), SHAPE,
                             JCoeffs(**COEFFS), cavity_form=False)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fixed_order_sum_is_the_kernels_two_level_fold():
    """Blocks of SUM_BLOCK summed by a pairwise tree, then the partials by
    the same fold: the order csrc/quad_stage.cu reproduces."""
    b = torch.from_numpy(np.random.default_rng(15).standard_normal((4, 24, 128))
                         .astype(np.float32))
    rows = b.reshape(-1, TQ.SUM_BLOCK)
    want = rows.clone()
    width = TQ.SUM_BLOCK
    while width > 1:  # the shared-memory tree: s[t] += s[t + stride]
        width //= 2
        want = want[:, :width] + want[:, width : 2 * width]
    parts = want[:, 0]
    assert torch.equal(TQ.fixed_order_sum(b), TT.fold_sum(parts[None, :])[0])
    assert abs(float(TQ.fixed_order_sum(b)) - float(b.double().sum())) < 1e-3


@pytest.mark.parametrize("name", ["carry", "corrector", "predictor_source"])
def test_cpu_dispatch_runs_plain_and_counts_no_launch(name):
    tin, _ = _stage_inputs(16)
    c = TCoeffs(**COEFFS)
    op = {"carry": TQ.make_quad_channel_corr_predictor_source,
          "corrector": TQ.make_quad_channel_corrector,
          "predictor_source": TQ.make_quad_channel_predictor_source}[name](SHAPE, c)
    if name == "predictor_source":
        tin = tin[:2]
    counters = (TQ.CHANNEL_CARRY, TQ.CHANNEL_CORRECTOR, TQ.CHANNEL_PREDICTOR_SOURCE)
    before = [k.launches for k in counters]
    for a, b in zip(op(*tin), op.plain(*tin), strict=True):
        assert torch.equal(a, b)
    assert before == [k.launches for k in counters]
