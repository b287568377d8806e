"""The natural layout's kernels (their plain twins on the CPU) against
cfd_tpu's Pallas kernels in interpret mode, element by element over the
whole aligned array, the padding included:

- the four stage kernels of kernels.projection (cfd_tpu/kernels/
  projection.py:210, 281, 386, 423, aligned_io=True) at 64x64 and 64x32;
- RBPairs(with_residual=True) against make_rb_pairs(with_residual=True,
  aligned_io=True) (rb_smoother.py:37);
- make_step_masked_pairs in its three variants at 64x14 (step_smoother.py:45);
- the channel and step pressure ghosts (cfd_tpu/bc.py:91,106);
- the natural converters against the reference case's align_state and
  unalign_state.

Bands (ROADMAP.md section C, tests/test_kernels.py): velocities within 2e-6;
b within 1e-5 of max|b|; max|b| and the sum of b within the float32 band
(1e-6 relative; the reference folds the sum per 64-row tile in tile order,
the port per 256-element block, so the two differ in rounding); the
guess 2p - p_prev exact; smoothed p within 5e-7 of its scale (XLA may
contract a multiply and an add in the reference's kernels, the port
rounds each); the step's residual field within 1e-6 of the residual's
scale, its max within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.bc import channel_pressure_ghosts as jax_channel_ghosts
from cfd_tpu.bc import step_pressure_ghosts as jax_step_ghosts
from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_step_case
from cfd_tpu.cases.cavity import make_cavity_case as jax_cavity_case
from cfd_tpu.kernels import projection as JP
from cfd_tpu.kernels.rb_smoother import make_rb_pairs
from cfd_tpu.kernels.step_smoother import make_step_masked_pairs as jax_step_pairs
from cfd_tpu.ops.stencil import StencilCoeffs as JaxCoeffs
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu.state import State as JaxState
from cfd_tpu_torch.bc import channel_pressure_ghosts, step_pressure_ghosts
from cfd_tpu_torch.convert import natural_converters
from cfd_tpu_torch.grid import Grid
from cfd_tpu_torch.kernels import projection as P
from cfd_tpu_torch.kernels.rb_smoother import RBPairs
from cfd_tpu_torch.kernels.step_smoother import fluid_mask, make_step_masked_pairs
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.state import State

torch.set_num_threads(1)

SHAPES = [(64, 64), (64, 32)]  # (nx, ny)
COEF = dict(dt=1e-3, viscosity=0.01, density=1.3)


def _coeffs(nx, ny):
    kw = dict(dx=1.0 / nx, dy=0.5 / ny, **COEF)
    return StencilCoeffs(**kw), JaxCoeffs(**kw)


def _fields(nx, ny, n, seed):
    """n aligned (H8, W) float32 fields, seeded noise on the logical grid
    and zeros on the padding."""
    shape = (ny + 2, nx + 2)
    H8, W = P.aligned_shape(shape)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = np.zeros((H8, W), np.float32)
        a[: shape[0], : shape[1]] = rng.standard_normal(shape) * 0.1
        out.append(a)
    return shape, out


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("nx, ny", SHAPES)
def test_predictor_source_matches_jax(nx, ny):
    shape, (u, v) = _fields(nx, ny, 2, seed=nx + ny)
    c, jc = _coeffs(nx, ny)
    ref = JP.make_predictor_source(shape, jc, 1.0, interpret=True, aligned_io=True,
                                   emit_max_b=True)(jnp.asarray(u), jnp.asarray(v))
    us, vs, b, max_b = P.make_predictor_source(shape, c, 1.0)(torch.from_numpy(u),
                                                             torch.from_numpy(v))
    assert us.shape == P.aligned_shape(shape)
    _close(us, ref[0], 2e-6, "us")
    _close(vs, ref[1], 2e-6, "vs")
    scale = float(ref[3])
    _close(b, ref[2], 1e-5 * scale, "b")
    assert abs(float(max_b) - scale) <= 1e-6 * scale


@pytest.mark.parametrize("nx, ny", SHAPES)
def test_corrector_matches_jax(nx, ny):
    """The slim-ghost corrector against the reference kernel (its ghosts are
    rebuilt from the corrected interior, tests/test_kernels.py:171), not
    against ops.stencil's byte layout."""
    shape, (us, vs, p, pp) = _fields(nx, ny, 4, seed=3 * nx + ny)
    c, jc = _coeffs(nx, ny)
    ref = JP.make_corrector(shape, jc, 1.0, interpret=True, aligned_io=True,
                            emit_guess=True)(*map(jnp.asarray, (us, vs, p, pp)))
    got = P.make_corrector(shape, c, 1.0)(*map(torch.from_numpy, (us, vs, p, pp)))
    for name, g, w in zip(("u2", "v2"), got, ref):
        _close(g, w, 2e-6, name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("nx, ny", SHAPES)
def test_channel_predictor_source_matches_jax(nx, ny):
    shape, (u, v) = _fields(nx, ny, 2, seed=5 * nx + ny)
    c, jc = _coeffs(nx, ny)
    ref = JP.make_channel_predictor_source(shape, jc, 1.0, interpret=True,
                                           aligned_io=True)(jnp.asarray(u), jnp.asarray(v))
    us, vs, b, sum_b = P.make_channel_predictor_source(shape, c, 1.0)(
        torch.from_numpy(u), torch.from_numpy(v))
    _close(us, ref[0], 2e-6, "us")
    _close(vs, ref[1], 2e-6, "vs")
    scale = float(np.abs(np.asarray(ref[2])).max())
    _close(b, ref[2], 1e-5 * scale, "b")
    # the sums of |b| ~ 1e5 terms: float32 rounding of the two fold orders
    assert abs(float(sum_b) - float(ref[3])) <= 1e-6 * float(np.abs(np.asarray(ref[2])).sum())


@pytest.mark.parametrize("nx, ny", SHAPES)
def test_channel_corrector_matches_jax(nx, ny):
    """The invalid faces are zeroed before the channel ghosts: the v top
    ghost row and the corners stay 0."""
    shape, (us, vs, p, pp) = _fields(nx, ny, 4, seed=7 * nx + ny)
    c, jc = _coeffs(nx, ny)
    ref = JP.make_channel_corrector(shape, jc, 1.0, interpret=True, aligned_io=True,
                                    emit_guess=True)(*map(jnp.asarray, (us, vs, p, pp)))
    u2, v2, guess = P.make_channel_corrector(shape, c, 1.0)(
        *map(torch.from_numpy, (us, vs, p, pp)))
    _close(u2, ref[0], 2e-6, "u2")
    _close(v2, ref[1], 2e-6, "v2")
    np.testing.assert_array_equal(guess.numpy(), np.asarray(ref[2]))
    assert not v2[ny + 1].any() and v2[0, 0] == 0 and v2[ny + 1, nx + 1] == 0


def test_stage_outputs_keep_the_padding_zero():
    """Every output element is written; beyond the logical grid it is 0,
    the aligned contract the next kernel relies on."""
    nx, ny = 64, 32
    shape, (u, v, p, pp) = _fields(nx, ny, 4, seed=11)
    c, _ = _coeffs(nx, ny)
    t = [torch.from_numpy(a) for a in (u, v, p, pp)]
    outs = (*P.make_predictor_source(shape, c)(t[0], t[1])[:3],
            *P.make_corrector(shape, c)(*t),
            *P.make_channel_predictor_source(shape, c)(t[0], t[1])[:3],
            *P.make_channel_corrector(shape, c)(*t))
    for o in outs:
        assert not o[shape[0]:].any() and not o[:, shape[1]:].any()


def _level0(flavor, n):
    prob = getattr(TM, flavor)(n, n, 1.0 / n, 1.0 / n)
    lv = TM._build_level(prob, torch.float32)
    return prob, lv


@pytest.mark.parametrize("flavor, n_pairs", [("cavity_problem", 1), ("channel_problem", 2),
                                             ("neumann_problem", 2)])
def test_rb_pairs_with_residual_matches_jax(flavor, n_pairs):
    """RBPairs(with_residual=True): the smoothed p and max|b - A p| over the
    interior, against the reference kernel on the aligned level 0."""
    n = 48
    prob, lv = _level0(flavor, n)
    H8, W = lv.shape
    rng = np.random.default_rng(n_pairs)
    p = np.zeros((H8, W), np.float32)
    b = np.zeros((H8, W), np.float32)
    p[1 : n + 1, 1 : n + 1] = rng.standard_normal((n, n)) * 0.01
    b[1 : n + 1, 1 : n + 1] = rng.standard_normal((n, n))
    w = [getattr(lv, k).reshape(-1).numpy() for k in ("wE", "wW", "wN", "wS")]
    jk = make_rb_pairs(lv.shape, *w, lv.idx2, lv.idy2, 1.0, n_pairs, interpret=True,
                       with_residual=True, aligned_io=True, ny=n, nx=n)
    jp, jres = jk(jnp.asarray(p), jnp.asarray(b))
    sm = RBPairs(lv.shape, *w, lv.idx2, lv.idy2, 1.0, n_pairs, n, n, with_residual=True)
    tp, tres = sm(torch.from_numpy(p), torch.from_numpy(b))
    scale = float(np.abs(np.asarray(jp)).max())
    _close(tp, jp, 5e-7 * scale, "p")
    assert tres.dim() == 0 and tres.dtype == torch.float32
    assert abs(float(tres) - float(jres)) <= 1e-5 * float(jres)
    # the max of the twin's own residual field, bit for bit
    _, r = RBPairs(lv.shape, *w, lv.idx2, lv.idy2, 1.0, n_pairs, n, n,
                   with_residual_field=True)(torch.from_numpy(p), torch.from_numpy(b))
    assert float(tres) == float(r.abs().max())


def test_rb_pairs_with_residual_rules():
    _, lv = _level0("cavity_problem", 16)
    w = [getattr(lv, k).reshape(-1) for k in ("wE", "wW", "wN", "wS")]
    with pytest.raises(ValueError, match="exclusive"):
        RBPairs(lv.shape, *w, lv.idx2, lv.idy2, 1.0, 1, 16, 16, with_residual=True,
                with_residual_field=True)
    full = [torch.zeros(lv.shape) for _ in range(4)]
    with pytest.raises(ValueError, match="separable"):
        RBPairs(lv.shape, *full, lv.idx2, lv.idy2, 1.0, 1, 16, 16, with_residual=True)


STEP = (64, 14)  # a natural size: 14 = 14 mod 16


@pytest.fixture(scope="module")
def step_setup():
    nx, ny = STEP
    jcase = jax_step_case(nx=nx, ny=ny, dtype=jnp.float32, poisson="multigrid",
                          smoother_mode="off")
    g = jcase.grid
    tg = Grid.masked(nx, ny, 8.0, 2.0, g.fluid[1:-1, 1:-1].copy())
    rect = TM.step_rect_params(tg)
    rng = np.random.default_rng(14)
    p = rng.standard_normal(g.shape).astype(np.float32)
    b = (rng.standard_normal(g.shape) * 10).astype(np.float32)
    return dict(g=g, tg=tg, rect=rect, p=p, b=b, idx2=jcase.coeffs.idx2,
                idy2=jcase.coeffs.idy2)


@pytest.mark.parametrize("variant", ["plain", "with_residual_field", "with_residual"])
def test_step_masked_pairs_match_jax(step_setup, variant):
    s = step_setup
    kw = {} if variant == "plain" else {variant: True}
    step_i, inlet = s["rect"]
    ref = jax_step_pairs(s["g"].shape, step_i, inlet, s["idx2"], s["idy2"], 1.0, 2,
                         interpret=True, **kw)(jnp.asarray(s["p"]), jnp.asarray(s["b"]))
    got = make_step_masked_pairs(s["g"].shape, step_i, inlet, s["idx2"], s["idy2"], 1.0, 2,
                                 **kw)(
        torch.from_numpy(s["p"]), torch.from_numpy(s["b"]))
    if variant == "plain":
        ref, got = (ref,), (got,)
    scale = float(np.abs(np.asarray(ref[0])).max())
    _close(got[0], ref[0], 5e-7 * scale, "p")
    if variant == "with_residual_field":
        _close(got[1], ref[1], 1e-6 * float(np.abs(np.asarray(ref[1])).max()), "r")
    elif variant == "with_residual":
        assert got[1].dim() == 0
        assert abs(float(got[1]) - float(ref[1])) <= 1e-6 * float(ref[1])


def test_step_fluid_mask_is_the_grids(step_setup):
    s = step_setup
    got = fluid_mask(s["g"].shape, *s["rect"], "cpu").numpy()
    np.testing.assert_array_equal(got, s["tg"].cell_mask)


def test_pressure_ghosts_match_jax(step_setup):
    s = step_setup
    p = s["p"]
    np.testing.assert_array_equal(channel_pressure_ghosts(s["tg"])(torch.from_numpy(p)).numpy(),
                                  np.asarray(jax_channel_ghosts(s["g"])(jnp.asarray(p))))
    got = step_pressure_ghosts(s["tg"])(torch.from_numpy(p)).numpy()
    want = np.asarray(jax_step_ghosts(s["g"])(jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)
    # the solid mean wrote the cells of the solid column's east face
    step_i, inlet = s["rect"]
    assert got[inlet + 2, step_i] == p[inlet + 2, step_i + 1]
    # the smoother's refresh, the kernel's rectangle form, equals the
    # reference's general form (up to the sign of a zero)
    pairs = make_step_masked_pairs(s["g"].shape, step_i, inlet, s["idx2"], s["idy2"], 1.0, 1)
    np.testing.assert_array_equal(pairs.refresh(torch.from_numpy(p)).numpy(), want)


def test_natural_converters_match_jax():
    """align then unalign against the reference case's converters: the
    padded carry with the guess 2p - p_prev in the p_prev slot, and back
    (one float32 rounding each way)."""
    n = 30
    jcase = jax_cavity_case(n_interior=n, dtype=jnp.float32, poisson="multigrid",
                            step_kernel_mode="interpret", layout="aligned")
    shape = (n + 2, n + 2)
    rng = np.random.default_rng(30)
    u, v, p, pp = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    align, unalign = natural_converters(shape)
    got = align(State(*map(torch.from_numpy, (u, v, p)), None, torch.from_numpy(pp)))
    want = jcase.align_state(JaxState(*map(jnp.asarray, (u, v, p)), None, jnp.asarray(pp)))
    for k in ("u", "v", "p", "p_prev"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    back = unalign(got)
    want_back = jcase.unalign_state(want)
    for k in ("u", "v", "p", "p_prev"):
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(want_back, k)), err_msg=k)
    np.testing.assert_allclose(back.p_prev.numpy(), pp, rtol=0, atol=1e-6)
    assert back.T is None and unalign(align(State(*got[:3]))).p_prev is None


def test_aligned_shape_is_the_references():
    for shape in ((34, 34), (32, 66), (2050, 2050), (514, 1538)):
        assert P.aligned_shape(shape) == JM._round_up8_128(shape)


def test_natural_kernels_are_registered():
    """Every natural-layout entry point is listed with its source and the
    TPU kernel it replaces."""
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.kernels import rb_smoother, step_smoother

    names = {k.name: k for k in KERNELS}
    for kern, line in ((P.PREDICTOR_SOURCE, 210), (P.CORRECTOR, 281),
                       (P.CHANNEL_PREDICTOR_SOURCE, 386), (P.CHANNEL_CORRECTOR, 423)):
        assert names[kern.name] is kern
        assert kern.source == "cfd_tpu_torch/csrc/projection.cu"
        assert kern.replaces == f"cfd_tpu/kernels/projection.py:{line}"
    assert names[rb_smoother.RB_PAIRS_RES.name].replaces.startswith(
        "cfd_tpu/kernels/rb_smoother.py:37")
    for kern in (step_smoother.STEP_PAIRS, step_smoother.STEP_PAIRS_RES):
        assert names[kern.name] is kern
        assert kern.source == "cfd_tpu_torch/csrc/step_smoother.cu"
        assert kern.replaces.startswith("cfd_tpu/kernels/step_smoother.py:45")


def test_wrappers_refuse_other_devices_and_shapes():
    """A stage takes only its aligned float32 shape, and routes only CPU or
    CUDA tensors (a CUDA tensor launches the kernel, never the twin)."""
    nx, ny = 64, 32
    shape, (u, v) = _fields(nx, ny, 2, seed=1)
    c, _ = _coeffs(nx, ny)
    pred = P.make_predictor_source(shape, c)
    with pytest.raises(ValueError, match="shape"):
        pred(torch.zeros(shape), torch.zeros(shape))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        pred(torch.from_numpy(u).to("meta"), torch.from_numpy(v).to("meta"))
