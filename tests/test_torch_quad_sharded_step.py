"""The backward-facing step on the sharded quad path (cfd_tpu_torch.parallel,
row 16f) against cfd_tpu on the CPU, where the port runs its plain twins and
the reference its Pallas kernels in interpret mode.

* The three shard twins of row 16f (kernels.step_quad
  QuadStepCorrPredictorSourceShard, QuadStepPreSmoothRestrictShard,
  QuadStepPostProlongSmoothShard) against the reference's shard=(P, mdy)
  kernels called with their row_base, at 128x64 and mdy 4 (P = 16), on
  shards 0, 1 and 2 (the first solid row j = 33 is plane row 16, shard 1's
  first own row; shard 2 holds the top ghost row), on seeded inputs, own
  rows: velocities and p 2e-6, b and rc within 1e-5 of max, the partial
  within 1e-5 of the own rows' sum of |b|, res 1e-6 relative. On every
  shard (3 holds dead rows only) the twins' own rows equal the
  single-device twins' (rows 9a, 9c, 9d) bit for bit.
* _sub_mean_local(step_rect=) against the reference's on every shard.
* The port's sharded run bit-identical to its single-device per-kernel
  V(1,1) run whose source sums add the shards' own-row partials in shard
  order (chip_smoke.shard_order_case), 5 steps at 128x64 on 4 shards;
  tail_from=1 (the tail from level 2) bit-identical to it; a 1-shard mesh
  delegates.
* The refusals (V(1,2), whole_solve, a raster that is not the rectangle,
  two pairs on the shard kernels, the exact adaptive controller on a mesh;
  the traced-dt shard carry and make_adaptive build), Simulation(mesh=)
  rows and the CLI.

The slice against the reference's ShardedQuadProjection is in
tests/test_torch_quad_sharded_step_slice.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.kernels import step_quad as JSQ
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu.parallel import quad_sharded as JS
from cfd_tpu_torch.cases import make_backwards_step_case
from cfd_tpu_torch.grid import Grid
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import step_quad as TSQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.parallel import ShardedQuadProjection, make_mesh
from cfd_tpu_torch.parallel.quad_sharded import (DEV_HALO, ShardedMaskedStepSolve,
                                                 _sub_mean_local)
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

NX, NY, MDY = 128, 64, 4
SHAPE = (NY + 2, NX + 2)
DX, DY = 8.0 / NX, 2.0 / NY  # the case's length 8 and height 2
STEP_I, INLET_J = 32, 32  # int(2 / dx), int(1 / dy)
COEFFS = dict(dx=DX, dy=DY, dt=2e-3, viscosity=1e-2)
CASE_KW = dict(nx=NX, ny=NY, poisson="multigrid", tolerance_factor=1e-5, abs_tol=0.0,
               mg_overrides={"pre_sweeps": 1, "post_sweeps": 1})


def _port_case(**kw):
    return make_backwards_step_case(dtype=torch.float32, device="cpu", **{**CASE_KW, **kw})


def _cpu_mesh(mdy=MDY):
    return make_mesh(mdy, device="cpu")


def _own(a, P):
    return np.asarray(a)[..., DEV_HALO : DEV_HALO + P, :]


# ----------------------------------------------------------- the shard twins

@pytest.fixture(scope="module")
def twins():
    """Seeded global fields on the 4 shards' local blocks, the reference's
    and the port's shard kernels (one reference instance each: row_base is
    a traced argument) and the single-device twins on the whole fields."""
    Hq8s, P, W = TQ.quad_shard_dims(SHAPE, MDY)
    assert (Hq8s, P, W) == (64, 16, 128)
    Hq8 = TQ.quad_dims(SHAPE)[2]
    assert (INLET_J + 1) // 2 == P  # the corner row is shard 1's first own row
    rng = np.random.default_rng(1613)
    jj, ii = np.arange(SHAPE[0])[:, None], np.arange(SHAPE[1])[None, :]
    fluid = ((jj >= 1) & (jj <= NY) & (ii >= 1) & (ii <= NX)
             & ~((ii <= STEP_I) & (jj > INLET_J)))

    def field(scale=0.1, fluid_only=False):
        a = (rng.standard_normal(SHAPE) * scale).astype(np.float32)
        if fluid_only:
            a *= fluid
        q = TQ.to_quad(torch.from_numpy(a), SHAPE).numpy()
        return np.pad(q, ((0, 0), (DEV_HALO, Hq8s - Hq8 + DEV_HALO), (0, 0)))

    fields = dict(us=field(), vs=field(), p=field(fluid_only=True),
                  b=field(1e3, fluid_only=True))
    ec = np.zeros((Hq8s + 2 * DEV_HALO, W), np.float32)
    ec[DEV_HALO + 1 : DEV_HALO + NY // 2 + 1, 1 : NX // 2 + 1] = (
        rng.standard_normal((NY // 2, NX // 2)) * 0.1)
    fields["ec"] = ec
    loc, shard = (P + 2 * DEV_HALO, W), (P, MDY)
    jc, tc = JCoeffs(**COEFFS), TCoeffs(**COEFFS)
    level0 = (STEP_I, INLET_J, 1.0 / DX ** 2, 1.0 / DY ** 2, 1.0, 1)
    ref = dict(
        carry=JSQ.make_quad_step_corr_predictor_source(SHAPE, jc, STEP_I, INLET_J, 1.0,
                                                       shard=shard, interpret=True),
        pre=JSQ.make_quad_step_pre_smooth_restrict(SHAPE, *level0, loc, shard=shard,
                                                   interpret=True),
        post=JSQ.make_quad_step_post_prolong_smooth(SHAPE, *level0, loc, shard=shard,
                                                    interpret=True))
    port = dict(
        carry=TSQ.make_quad_step_corr_predictor_source(SHAPE, tc, STEP_I, INLET_J, 1.0,
                                                       shard=shard),
        pre=TSQ.make_quad_step_pre_smooth_restrict(SHAPE, *level0, loc, shard=shard),
        post=TSQ.make_quad_step_post_prolong_smooth(SHAPE, *level0, loc, shard=shard))
    whole = {k: torch.from_numpy(np.ascontiguousarray(v[..., DEV_HALO : DEV_HALO + Hq8, :]))
             for k, v in fields.items()}
    single = dict(
        carry=TSQ.make_quad_step_corr_predictor_source(SHAPE, tc, STEP_I, INLET_J).plain(
            whole["us"], whole["vs"], whole["p"]),
        pre=TSQ.make_quad_step_pre_smooth_restrict(SHAPE, *level0, (Hq8, W)).plain(
            whole["p"], whole["b"]),
        post=TSQ.make_quad_step_post_prolong_smooth(SHAPE, *level0, (Hq8, W)).plain(
            whole["p"], whole["b"], whole["ec"]))
    return dict(fields=fields, ref=ref, port=port, single=single, P=P, Hq8=Hq8, runs={})


INPUTS = {"carry": ("us", "vs", "p"), "pre": ("p", "b"), "post": ("p", "b", "ec")}


def _block(t, name, jy):
    """Shard jy's local block of the seeded global field ``name``."""
    P = t["P"]
    return np.ascontiguousarray(t["fields"][name][..., jy * P : jy * P + P + 2 * DEV_HALO, :])


def _runs(t, kind, jy):
    """(reference, port) outputs of one kernel on shard jy, run once per
    module."""
    key = (kind, jy)
    if key not in t["runs"]:
        rb = jy * t["P"] - DEV_HALO
        args = [_block(t, k, jy) for k in INPUTS[kind]]
        want = t["ref"][kind](rb, *(jnp.asarray(a) for a in args))
        got = t["port"][kind](rb, *(torch.from_numpy(a) for a in args))
        t["runs"][key] = ([np.asarray(w) for w in want], [g.numpy() for g in got])
    return t["runs"][key]


def _near(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("jy", [0, 1, 2])
def test_carry_shard_twin_matches_the_reference_shard_kernel(twins, jy):
    P = twins["P"]
    (w_us, w_vs, w_b, w_sum), (g_us, g_vs, g_b, g_sum) = _runs(twins, "carry", jy)
    _near(_own(g_us, P), _own(w_us, P), 2e-6)
    _near(_own(g_vs, P), _own(w_vs, P), 2e-6)
    _near(_own(g_b, P), _own(w_b, P), 1e-5 * max(float(np.abs(_own(w_b, P)).max()), 1.0))
    scale = float(np.abs(_own(w_b, P)).sum())
    assert abs(float(g_sum) - float(w_sum)) <= 1e-5 * scale, (float(g_sum), float(w_sum))


@pytest.mark.parametrize("jy", [0, 1, 2])
def test_pre_post_shard_twins_match_the_reference_shard_kernels(twins, jy):
    P = twins["P"]
    (w_p, w_rc), (g_p, g_rc) = _runs(twins, "pre", jy)
    _near(_own(g_p, P), _own(w_p, P), 2e-6)
    _near(_own(g_rc, P), _own(w_rc, P), 1e-5 * max(float(np.abs(_own(w_rc, P)).max()), 1.0))
    (w_p, w_res), (g_p, g_res) = _runs(twins, "post", jy)
    _near(_own(g_p, P), _own(w_p, P), 2e-6)
    assert abs(float(g_res) - float(w_res)) <= 1e-6 * float(w_res)


@pytest.mark.parametrize("kind", ["carry", "pre", "post"])
def test_shard_twins_equal_the_single_device_twins_on_own_rows(twins, kind):
    """Rows 9a, 9c and 9d on the whole field: the own rows of every shard
    bit for bit (the carry's us', vs', b; the pre's p, rc; the post's p),
    and the carry's partials add up to the single-device sum in another
    float32 order."""
    P, Hq8 = twins["P"], twins["Hq8"]
    single = [s.numpy() for s in twins["single"][kind]]
    n_fields = {"carry": 3, "pre": 2, "post": 1}[kind]
    partials = []
    for jy in range(MDY):
        blocks = [torch.from_numpy(_block(twins, k, jy)) for k in INPUTS[kind]]
        got = [g.numpy() for g in twins["port"][kind](jy * P - DEV_HALO, *blocks)]
        lo, hi = jy * P, max(jy * P, min(jy * P + P, Hq8))
        for k in range(n_fields):
            own = got[k][..., DEV_HALO : DEV_HALO + hi - lo, :]
            assert np.array_equal(own, single[k][..., lo:hi, :]), (jy, k)
        if kind != "pre":
            partials.append(float(got[-1]))
    if kind == "carry":
        scale = float(np.abs(single[2]).sum())
        assert abs(sum(partials) - float(single[3])) <= 1e-5 * scale
    if kind == "post":  # the largest own-row residual is the whole field's
        assert max(partials) == float(single[1])


def test_sub_mean_local_with_the_step_rectangle_matches_the_reference():
    """Every shard of 128x64 on 4, halo and dead rows included: b - mean on
    the globally indexed fluid cells only."""
    _, P, W = TQ.quad_shard_dims(SHAPE, MDY)
    rng = np.random.default_rng(7)
    mean = np.float32(0.37)
    for jy in range(MDY):
        b = rng.standard_normal((4, P + 2 * DEV_HALO, W)).astype(np.float32)
        rb = jy * P - DEV_HALO
        want = np.asarray(JS._sub_mean_local(jnp.asarray(b), jnp.float32(mean), rb, NY, NX,
                                             step_rect=(STEP_I, INLET_J)))
        got = _sub_mean_local(torch.from_numpy(b), torch.tensor(mean), rb, NY, NX,
                              (STEP_I, INLET_J)).numpy()
        np.testing.assert_array_equal(got, want)
        plain = _sub_mean_local(torch.from_numpy(b), torch.tensor(mean), rb, NY, NX).numpy()
        # shard 3 holds dead rows only; the others hold solid cells
        assert (got != b).any() == (got != plain).any() == (jy < 3)


# ------------------------------------------------------------------ the slice

def _sharded_run(sq, steps):
    s = sq.initial_state()
    iters = []
    for _ in range(steps):
        s, d = sq.step(s)
        iters.append(int(d["poisson_iters"]))
    return iters, sq.logical(s)


def _single_run(case, steps):
    sim = Simulation(case, log=lambda m: None)
    st = sim.initial_state()
    iters = []
    for _ in range(steps):
        st, d = sim._step(st)
        iters.append(d.poisson_iters)
    return iters, sim._logical(st)


@pytest.fixture(scope="module")
def sharded_5():
    sq = ShardedQuadProjection(_port_case(), _cpu_mesh(), tol_factor=1e-5)
    return sq, _sharded_run(sq, 5)


def test_sharded_step_engine(sharded_5):
    sq, _ = sharded_5
    solve = sq._solve
    assert (sq.flavor, sq.n_carry, sq.P, sq.delegated) == ("backwards_step", 3, 16, False)
    assert isinstance(solve, ShardedMaskedStepSolve) and solve.l1_spmd
    assert (sq.mg.pre_sweeps, sq.mg.post_sweeps, sq.mg.tol_factor) == (1, 1, 1e-5)
    assert sq._step_rect == (STEP_I, INLET_J)
    assert ShardedQuadProjection(_port_case(), _cpu_mesh()).mg.tol_factor == 1e-9


def test_sharded_step_equals_the_single_device_path_summed_in_shard_order(sharded_5):
    """The source sum's order is the only difference: the single-device
    per-kernel V(1,1) path whose source sum adds the shards' own-row
    partials in shard order equals the sharded run bit for bit, cycles
    included."""
    from chip_smoke import shard_order_case

    sq, got = sharded_5
    want = _single_run(shard_order_case(_port_case(), sq), 5)
    assert got[0] == want[0]
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(got[1], name), getattr(want[1], name)), name
    assert got[1].p_prev is None and got[1].T is None


def test_sharded_step_tail_from_1_starts_at_level_2(sharded_5):
    """tail_from=1 clamps to global level 2, the first level below the
    shards' level 1 (:460-466); the fused tail's twin repeats the coarse
    V-cycle's arithmetic, so the run is bit-identical."""
    _, (iters, st) = sharded_5
    sq = ShardedQuadProjection(_port_case(), _cpu_mesh(), tol_factor=1e-5,
                               mg_overrides={"tail_from": 1})
    assert sq._solve.tail_at == 2
    t_iters, t_st = _sharded_run(sq, 5)
    assert t_iters == iters
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(t_st, name), getattr(st, name)), name


def test_one_shard_mesh_delegates_to_the_single_device_step():
    case = _port_case(nx=64, ny=16)
    sq = ShardedQuadProjection(case, _cpu_mesh(1))
    assert sq.delegated
    got = _sharded_run(sq, 2)
    want = _single_run(case, 2)
    assert got[0] == want[0]
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(got[1], name), getattr(want[1], name)), name


# ---------------------------------------------------------------- refusals

def _not_the_rectangle():
    case = _port_case(nx=64, ny=16)
    fluid = case.grid.fluid[1:-1, 1:-1].copy()
    fluid[0, 0] = False  # one more solid cell
    grid = Grid.masked(64, 16, 8.0, 2.0, fluid)
    return dataclasses.replace(case, grid=grid)


@pytest.mark.parametrize("make,kw,exc,match", [
    (_port_case, dict(mg_overrides={"post_sweeps": 2}), ValueError, r"V\(1,1\) only"),
    (_port_case, dict(mg_overrides={"whole_solve": True}), ValueError, "single-device only"),
    (_port_case, dict(mg_overrides={"corr_opt": True}), ValueError, "corr_opt"),
    (_not_the_rectangle, {}, ValueError, "rectangle raster"),
])
def test_sharded_step_refusals(make, kw, exc, match):
    with pytest.raises(exc, match=match):
        ShardedQuadProjection(make(), _cpu_mesh(), tol_factor=1e-5, **kw)


def test_shard_factories_refuse_the_traced_dt_carry_and_two_pairs():
    tc, loc, shard = TCoeffs(**COEFFS), (32, 128), (16, MDY)
    assert isinstance(TSQ.make_quad_step_corr_predictor_source(SHAPE, tc, STEP_I, INLET_J, 1.0,
                                                               adaptive=True, shard=shard),
                      TSQ.QuadStepCorrPredictorSourceShardAdaptive)
    level0 = (STEP_I, INLET_J, 1.0 / DX ** 2, 1.0 / DY ** 2, 1.0, 2)
    with pytest.raises(ValueError, match="pre-smoother: n_pairs=2 consumes 11 rows"):
        TSQ.make_quad_step_pre_smooth_restrict(SHAPE, *level0, loc, shard=shard)
    with pytest.raises(ValueError, match="post-smoother: n_pairs=2 consumes 11 rows"):
        TSQ.make_quad_step_post_prolong_smooth(SHAPE, *level0, loc, shard=shard)
    with pytest.raises(ValueError, match="coarse shape"):
        TSQ.make_quad_step_pre_smooth_restrict(SHAPE, *level0[:-1], 1, (40, 128),
                                               shard=shard)
    from cfd_tpu_torch.adaptive import run_adaptive

    sim = Simulation(_port_case(nx=64, ny=16), log=lambda m: None, mesh=_cpu_mesh(),
                     sharded_kwargs={"tol_factor": 1e-5})
    assert all(callable(f) for f in sim._engine.make_adaptive(0.7, 1.2, 1.0, 10))
    with pytest.raises(ValueError, match="sharded adaptive runs the lagged controller"):
        run_adaptive(sim, n_steps=2, controller="exact")


# ------------------------------------------------- Simulation(mesh=) and CLI

def test_simulation_with_a_mesh_prints_the_step_rows():
    """The stats rows come from the gathered logical state over the fluid
    cells: the single-device V(1,1) rows at printed precision."""
    rows = []
    for mesh in (None, _cpu_mesh()):
        sim = Simulation(_port_case(nx=64, ny=16, print_interval=2), log=lambda m: None,
                         mesh=mesh, sharded_kwargs=mesh and {"tol_factor": 1e-5})
        sim.run(n_steps=4)
        rows.append([(r["step"], r["poisson_iters"], f"{r['max_divergence']:10.2e}",
                      f"{r['avg_kinetic_energy']:10.6f}") for r in sim.history])
    assert rows[0] == rows[1] and len(rows[0]) == 2


def test_cli_backwards_step_mesh(capsys):
    from cfd_tpu_torch.cli import main

    assert main(["backwards_step", "--mesh", "4", "--Nx", "64", "--Ny", "16", "--poisson",
                 "multigrid", "--T", "1.0", "--steps", "2", "--device", "cpu",
                 "--precision", "f32", "--no-vtk", "--print-interval", "2",
                 "--save-interval", "2"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 4x1 plane-row decomposition over cpu" in out and "Step      2" in out
