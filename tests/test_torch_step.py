"""The backward step's ops, kernels and masked hierarchy in cfd_tpu_torch
against cfd_tpu on the CPU, at 64x16 (step_i 16, inlet_j 8; the reference's
tests/test_step_quad.py size): step_bc and the masked Poisson problems in
float64 (1e-12), the quad masks exactly, and the plain twins of the four
step_quad kernels against cfd_tpu's Pallas kernels in interpret mode
(tile_rows=8, so the reference runs its slab path), the full-2D coarse
pairs, the solid fill and the masked prolongation at float32 roundoff, the
per-kernel masked solve against cfd_tpu's with equal cycles, the
whole-solve twin against the per-kernel composition (identical), and the
masked V(1,2) contraction bound of tests/test_contraction.py:103-120.

Bands (tests/test_quad.py, ROADMAP.md section C): u and v 2e-6, b 1e-5 of
max|b|, the source sum 1e-6 of sum|b| (the two packages add in other
orders), smoothed p 2e-6, rc 1e-5 of max|rc|, the post residual 1e-3
relative; f32 roundoff for the coarse pairs, the fill and the
prolongation: 1e-6 of scale. The CUDA kernels themselves are held to these
twins on the card by tests/test_torch_step_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import bc as JB
from cfd_tpu.cases.backwards_step import make_backwards_step_case as jax_case
from cfd_tpu.kernels import quad as JQ
from cfd_tpu.kernels import rb_smoother as JR
from cfd_tpu.kernels import step_quad as JS
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch import bc as TB
from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.kernels import mg_tail as TT
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_smoother as TR
from cfd_tpu_torch.kernels import step_quad as TS
from cfd_tpu_torch.kernels import whole_solve as TW
from cfd_tpu_torch.poisson import multigrid as TM

torch.set_num_threads(1)

NX, NY = 64, 16
SHAPE = (NY + 2, NX + 2)
STEP_I, INLET_J = 16, 8
COARSE = (16, 128)
CASE_KW = dict(nx=NX, ny=NY, poisson="multigrid", tolerance_factor=1e-4)


@pytest.fixture(scope="module")
def cases():
    """(port case, JAX case) at 64x16, float32."""
    port = make_backwards_step_case(dtype=torch.float32, device="cpu", **CASE_KW)
    ref = jax_case(dtype=jnp.float32, smoother_mode="off", **CASE_KW)
    return port, ref


@pytest.fixture(scope="module")
def hierarchy(cases):
    """Both packages' masked problems, coarsest first excluded."""
    port, ref = cases
    g, c = port.grid, port.coeffs
    tprobs = TM.build_problems(TM.masked_channel_problem(g, c.dx, c.dy), TM.MGConfig())
    jprobs = [JM.masked_channel_problem(ref.grid, c.dx, c.dy)]
    while len(jprobs) < len(tprobs):
        jprobs.append(JM.coarsen_problem(jprobs[-1]))
    return tprobs, jprobs


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("uin", [1.0, -0.35])
def test_step_bc_matches_jax(cases, uin):
    port, ref = cases
    rng = np.random.default_rng(3)
    u, v = rng.standard_normal((2, *SHAPE))
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    got = TB.step_bc(port.grid, uin, INLET_J)(ut, vt)
    want = JB.step_bc(ref.grid, uin, INLET_J)(jnp.asarray(u), jnp.asarray(v))
    for a, b in zip(got, want, strict=True):
        _close(a.numpy(), b, 1e-12)
    np.testing.assert_array_equal(ut.numpy(), u)  # inputs untouched


def test_geometry_and_masks_match_jax(cases):
    """The raster, the rectangle parameters, and the per-plane quad masks."""
    port, ref = cases
    np.testing.assert_array_equal(port.grid.fluid, ref.grid.fluid)
    assert TM.step_rect_params(port.grid) == JM.step_rect_params(ref.grid) == (STEP_I,
                                                                               INLET_J)
    assert TM.step_rect_params(TM_regular()) is None
    tg, tc = TQ._qiota(*COARSE, "cpu")
    jg, jc = JQ._qiota(0, *COARSE)
    for a, b in zip(TS._step_masks(tg, tc, NY, NX, STEP_I, INLET_J),
                    JS._step_masks(jg, jc, NY, NX, STEP_I, INLET_J), strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    cell = TS.step_cell_mask(SHAPE, STEP_I, INLET_J, "cpu")
    want = JQ.to_quad(jnp.asarray(ref.grid.cell_mask.astype(np.float32)), SHAPE)
    np.testing.assert_array_equal(cell.numpy(), np.asarray(want) > 0)


def TM_regular():
    from cfd_tpu_torch.grid import Grid

    return Grid.regular(NX, NY, 8.0, 2.0)


def test_masked_problems_and_levels_match_jax(hierarchy):
    """masked_channel_problem, every coarsening and the full-2D aligned
    levels (multigrid.py:169-182), and the coarsest pinv, in f64."""
    tprobs, jprobs = hierarchy
    assert len(tprobs) == 3
    for a, b in zip(tprobs, jprobs, strict=True):
        assert (a.nx, a.ny, a.dx, a.dy) == (b.nx, b.ny, b.dx, b.dy)
        for w in ("wE", "wW", "wN", "wS"):
            _close(getattr(a, w), getattr(b, w), 1e-12)
    for a, b in zip(tprobs[1:], jprobs[1:], strict=True):
        tl = TM._build_level(a, torch.float32, allow_full=True)
        jl = JM._build_level(b, jnp.float32, aligned=True, allow_full=True)
        assert not tl.separable and not jl.separable and tl.shape == jl.shape
        for w in ("wE", "wW", "wN", "wS"):
            np.testing.assert_array_equal(getattr(tl, w).numpy(), np.asarray(getattr(jl, w)))
    _close(TM._dense_pinv(tprobs[-1]), JM._dense_pinv(jprobs[-1]), 1e-12)
    with pytest.raises(ValueError, match="separable"):
        TM._build_level(tprobs[1], torch.float32)


def _natural(seed, scale=0.1, fluid_only=None):
    a = (np.random.default_rng(seed).standard_normal(SHAPE) * scale).astype(np.float32)
    if fluid_only is not None:
        a *= fluid_only
    return a


def _both(a):
    return TQ.to_quad(torch.from_numpy(a), SHAPE), JQ.to_quad(jnp.asarray(a), SHAPE)


def _stage_inputs(cases, seed):
    fluid = cases[0].grid.fluid.astype(np.float32)
    arrays = [_natural(seed), _natural(seed + 1), _natural(seed + 2, fluid_only=fluid)]
    pairs = [_both(a) for a in arrays]
    return [t for t, _ in pairs], [j for _, j in pairs]


def test_uncorrect_step_matches_jax(cases):
    port, ref = cases
    u, v, p = (_natural(s, 1.0) for s in (4, 5, 6))
    got = TS.uncorrect_step_quad(torch.from_numpy(u), torch.from_numpy(v),
                                 torch.from_numpy(p), SHAPE, port.coeffs, STEP_I, INLET_J)
    want = JS.uncorrect_step_quad(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), SHAPE,
                                  ref.coeffs, STEP_I, INLET_J)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_step_carry_plain_matches_jax(cases):
    port, ref = cases
    tin, jin = _stage_inputs(cases, 11)
    got = TS.make_quad_step_corr_predictor_source(SHAPE, port.coeffs, STEP_I, INLET_J,
                                                  0.7).plain(*tin)
    want = JS.make_quad_step_corr_predictor_source(SHAPE, ref.coeffs, STEP_I, INLET_J, 0.7,
                                                   tile_rows=8, interpret=True)(*jin)
    b = np.asarray(want[2])
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)
    _close(got[2], want[2], 1e-5 * np.abs(b).max())
    assert abs(float(got[3]) - float(want[3])) <= 1e-6 * np.abs(b).sum()
    # b lives on the fluid cells only
    cell = TS.step_cell_mask(SHAPE, STEP_I, INLET_J, "cpu")
    assert float(got[2][~cell].abs().max()) == 0.0


def test_step_corrector_plain_matches_jax(cases):
    port, ref = cases
    tin, jin = _stage_inputs(cases, 12)
    got = TS.make_quad_step_corrector(SHAPE, port.coeffs, STEP_I, INLET_J, 1.0).plain(*tin)
    want = JS.make_quad_step_corrector(SHAPE, ref.coeffs, STEP_I, INLET_J, 1.0,
                                       tile_rows=8, interpret=True)(*jin)
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)


def _poisson_inputs(cases, seed):
    fluid = cases[0].grid.fluid.astype(np.float32)
    p = _natural(seed, 1.0, fluid)
    b = _natural(seed + 1, 1.0, fluid)
    return _both(p), _both(b)


def _level0(make, cases, n_pairs, **kw):
    c = cases[0].coeffs
    return make(SHAPE, STEP_I, INLET_J, c.idx2, c.idy2, 1.0, n_pairs, COARSE, **kw)


@pytest.mark.parametrize("n_pairs", [1, 2])
def test_step_pre_plain_matches_jax(cases, n_pairs):
    (tp, jp), (tb, jb) = _poisson_inputs(cases, 30 + n_pairs)
    got = _level0(TS.make_quad_step_pre_smooth_restrict, cases, n_pairs).plain(tp, tb)
    want = _level0(JS.make_quad_step_pre_smooth_restrict, cases, n_pairs, tile_rows=8,
                   interpret=True)(jp, jb)
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 1e-5 * float(np.abs(np.asarray(want[1])).max()))


@pytest.mark.parametrize("n_pairs", [1, 2])
def test_step_post_plain_matches_jax(cases, n_pairs):
    (tp, jp), (tb, jb) = _poisson_inputs(cases, 40 + n_pairs)
    ec = np.zeros(COARSE, np.float32)
    ec[1 : NY // 2 + 1, 1 : NX // 2 + 1] = np.random.default_rng(n_pairs).standard_normal(
        (NY // 2, NX // 2))
    got = _level0(TS.make_quad_step_post_prolong_smooth, cases, n_pairs).plain(
        tp, tb, torch.from_numpy(ec))
    want = _level0(JS.make_quad_step_post_prolong_smooth, cases, n_pairs, tile_rows=8,
                   interpret=True)(jp, jb, jnp.asarray(ec))
    _close(got[0], want[0], 2e-6)
    assert abs(float(got[1]) - float(want[1])) <= 1e-3 * float(want[1])


def test_ghost_stage_reads_old_values():
    """The column-0 ghost at row inlet_j+1 takes the OLD solid value of
    cell (inlet_j+1, 1), and the row ny+1 ghost at column step_i the OLD
    value of cell (ny, step_i), though the same stage re-averages both."""
    p = torch.from_numpy(_natural(20, 1.0))
    grow, gcol = TQ._qiota(*COARSE, "cpu")
    out = TQ.from_quad(torch.stack(TS._step_ghosts_quad(
        list(TQ.to_quad(p, SHAPE)), grow, gcol, NY, NX, STEP_I, INLET_J)), SHAPE)
    j = INLET_J + 1
    assert float(out[j, 0]) == float(p[j, 1]) != float(out[j, 1])
    assert float(out[NY + 1, STEP_I]) == float(p[NY, STEP_I]) != float(out[NY, STEP_I])
    assert float(out[j, 1]) == float(p[j - 1, 1])  # south weight only
    assert float(out[j, STEP_I]) == float(0.5 * (p[j, STEP_I + 1] + p[j - 1, STEP_I]))


def _levels(hierarchy, k):
    tprobs, jprobs = hierarchy
    return (TM._build_level(tprobs[k], torch.float32, allow_full=True),
            JM._build_level(jprobs[k], jnp.float32, aligned=True, allow_full=True))


def _level_field(level, seed, scale):
    a = np.zeros(level.shape, np.float32)
    a[1 : level.ny + 1, 1 : level.nx + 1] = np.random.default_rng(seed).standard_normal(
        (level.ny, level.nx)) * scale
    return a


@pytest.mark.parametrize("with_residual_field", [False, True])
@pytest.mark.parametrize("n_pairs", [1, 2])
def test_full_2d_pairs_match_jax(hierarchy, with_residual_field, n_pairs):
    """The full-2D weight mode (rb_smoother.py:106-127): solid cells never
    update and keep 0 (the iterate starts at 0 there, as in the V-cycle)."""
    tl, jl = _levels(hierarchy, 1)
    _, active = TT.level_masks(tl, "cpu")
    p = _level_field(tl, 7, 0.1) * active.numpy()
    b = _level_field(tl, 8, 10.0) * active.numpy()
    op = TR.rb_pairs_for_level(tl, 1.0, n_pairs, with_residual_field=with_residual_field)
    assert op.full
    got = op(torch.from_numpy(p), torch.from_numpy(b))
    want = JR.rb_pairs_for_level(jl, 1.0, n_pairs, interpret=True, aligned_io=True,
                                 with_residual_field=with_residual_field)(
        jnp.asarray(p), jnp.asarray(b))
    got = got if with_residual_field else (got,)
    want = want if with_residual_field else (want,)
    for a, w in zip(got, want, strict=True):
        _close(a.numpy(), w, 1e-6 * max(1.0, float(np.abs(np.asarray(w)).max())))
    assert float(got[0][~active].abs().max()) == 0.0


@pytest.mark.parametrize("k", [1, 2])
def test_solid_fill_matches_jax(hierarchy, k):
    tl, jl = _levels(hierarchy, k)
    e = _level_field(tl, 9 + k, 1.0)
    got = TM._solid_fill(tl, torch.from_numpy(e))
    want = JM._solid_fill(jl, jnp.asarray(e))
    _close(got.numpy(), want, 1e-6)
    assert not torch.equal(got, torch.from_numpy(e))  # it filled something


def test_masked_prolong_matches_jax(hierarchy):
    """Level 2 -> 1: the solid fill, then the bilinear transfer, 0 on the
    fine level's solid cells (multigrid.py:350-389)."""
    (t1, j1), (t2, j2) = _levels(hierarchy, 1), _levels(hierarchy, 2)
    e = _level_field(t2, 13, 1.0)
    got = TT._prolong(t2, t1, torch.from_numpy(e))
    want = JM._prolong(j2, j1, jnp.asarray(e))
    _close(got.numpy(), want, 1e-6)


def _source(cases, seed):
    port = cases[0]
    fluid = port.grid.fluid
    b = np.where(fluid, np.random.default_rng(seed).standard_normal(SHAPE), 0.0)
    b = np.where(fluid, b - b.sum() / port.grid.n_fluid, 0.0).astype(np.float32)
    return b


def test_masked_solve_matches_jax(cases):
    """The per-kernel masked solve against cfd_tpu's
    make_masked_quad_multigrid_poisson in interpret mode: equal cycles, p
    within 50 tol, residuals within 10%."""
    port, ref = cases
    cfg = dict(tol_factor=1e-4, abs_tol=0.0, pre_sweeps=1, post_sweeps=2)
    b = _source(cases, 17)
    tb, jb = _both(b)
    solve = TM.make_masked_quad_multigrid_poisson(port.grid, port.coeffs,
                                                  TM.MGConfig(**cfg))
    jsolve = JM.make_masked_quad_multigrid_poisson(ref.grid, ref.coeffs, JM.MGConfig(**cfg),
                                                   interpret=True)
    tp, tit, tres = solve(torch.zeros_like(tb), tb)
    jp, jit, jres = jsolve(jnp.zeros_like(jb), jb)
    tol = 1e-4 * float(np.abs(b).max())
    assert tit == int(jit) and tit > 2, (tit, int(jit))
    assert abs(float(tres) - float(jres)) <= 0.1 * float(jres)
    _close(tp.numpy(), jp, 50 * tol)


@pytest.mark.parametrize("kw", [dict(tol_factor=1e-5),
                                dict(tol_factor=1e-4, max_cycles=2)])
def test_whole_solve_twin_equals_per_kernel(cases, kw):
    """The masked whole-solve's twin is the per-kernel composition's plain
    arithmetic: same cycles, residual and iterate, bit for bit."""
    port = cases[0]
    cfg = TM.MGConfig(pre_sweeps=1, post_sweeps=2, **kw)
    tb, _ = _both(_source(cases, 18))
    p0, _ = _both(_natural(19, 1e-3, port.grid.fluid.astype(np.float32)))
    got = TW.make_quad_step_whole_solve(port.grid, port.coeffs, cfg)(p0, tb)
    want = TM.make_masked_quad_multigrid_poisson(port.grid, port.coeffs, cfg)(p0, tb)
    assert got[1] == want[1] and got[2] == want[2]
    assert torch.equal(got[0], want[0])
    if "max_cycles" in kw:
        assert got[1] == 2


def test_masked_solve_guards(cases):
    port = cases[0]
    g, c = port.grid, port.coeffs
    with pytest.raises(ValueError, match="coarse_dtype"):
        TM.make_masked_quad_multigrid_poisson(g, c, TM.MGConfig(coarse_dtype="bfloat16"))
    # pin_mean is ignored, as the reference's masked solves never read it
    assert TM.make_masked_quad_multigrid_poisson(g, c, TM.MGConfig(pin_mean=True)).cfg.pin_mean
    # corr_opt and tail_from are ported: they build (the fused tail from
    # global level 1, the whole coarse hierarchy)
    assert TM.make_masked_quad_multigrid_poisson(g, c, TM.MGConfig(corr_opt=True)).cfg.corr_opt
    tail = TM.make_masked_quad_multigrid_poisson(g, c, TM.MGConfig(tail_from=1))
    assert tail.tail_from == 1 and len(tail.tail.levels) == len(tail.levels)
    with pytest.raises(ValueError, match="rectangle"):
        TM.make_masked_quad_multigrid_poisson(TM_regular(), c, TM.MGConfig())


def _stage_ops(cases):
    port = cases[0]
    c = port.coeffs
    return dict(
        carry=(TS.make_quad_step_corr_predictor_source(SHAPE, c, STEP_I, INLET_J),
               TS.STEP_CARRY),
        corrector=(TS.make_quad_step_corrector(SHAPE, c, STEP_I, INLET_J),
                   TS.STEP_CORRECTOR),
        pre=(_level0(TS.make_quad_step_pre_smooth_restrict, cases, 1), TS.STEP_PRE),
        post=(_level0(TS.make_quad_step_post_prolong_smooth, cases, 2), TS.STEP_POST),
    )


@pytest.mark.parametrize("name", ["carry", "corrector", "pre", "post"])
def test_cpu_dispatch_runs_plain_and_counts_no_launch(cases, name):
    op, counter = _stage_ops(cases)[name]
    if name in ("carry", "corrector"):
        args = _stage_inputs(cases, 21)[0]
    else:
        (tp, _), (tb, _) = _poisson_inputs(cases, 22)
        args = [tp, tb] + ([torch.zeros(COARSE)] if name == "post" else [])
    before = counter.launches
    for a, b in zip(op(*args), op.plain(*args), strict=True):
        assert torch.equal(a, b)
    assert counter.launches == before


def test_masked_contraction_factor():
    """The port's masked V(1,2) at the reference geometry 256x32 (step at
    i = 64) over 8 cycles, cycle by cycle (max_cycles=1, no stall exit):
    the geometric-mean contraction over cycles 2..8 stays within the
    reference's bound 0.36 (tests/test_contraction.py:103-120; the
    reference measures 0.308 in f64, the port runs float32)."""
    case = make_backwards_step_case(nx=256, ny=32, poisson="multigrid",
                                    dtype=torch.float32, device="cpu")
    g = case.grid
    solve = TM.make_masked_quad_multigrid_poisson(
        g, case.coeffs, TM.MGConfig(tol_factor=0.0, max_cycles=1, pre_sweeps=1,
                                    post_sweeps=2))
    rng = np.random.default_rng(5)
    b = np.where(g.fluid, rng.standard_normal(g.shape), 0.0)
    b = np.where(g.fluid, b - b.sum() / g.n_fluid, 0.0).astype(np.float32)
    b4 = TQ.to_quad(torch.from_numpy(b), g.shape)
    p = torch.zeros_like(b4)
    hist = []
    for _ in range(8):
        p, _, res = solve(p, b4)
        hist.append(float(res))
    logs = [math.log(hist[i + 1] / hist[i]) for i in range(1, len(hist) - 1)]
    factor = math.exp(sum(logs) / len(logs))
    assert factor <= 0.36, (factor, hist)
