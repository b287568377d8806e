"""The channel and Rayleigh-Benard on the sharded quad path
(cfd_tpu_torch.parallel) against cfd_tpu on the CPU, where the port runs its
plain twins and the reference its Pallas kernels in interpret mode on the
8-device host mesh (tests/conftest.py).

* The shard twins of rows 16d and 16e (kernels.quad
  QuadChannelCorrPredictorSourceShard, kernels.rb_quad QuadRBStepShard)
  against the reference's shard=(P, mdy) kernels called directly with their
  row_base, at 96x32 and mdy 4 (P = 8, the minimum), on shards 0, 1 and 2
  (2 holds the top ghost row), on seeded inputs, own rows: velocities and T
  2e-6, b within 1e-5 of max|b|, guess equal, the own-row sum within 1e-5
  of the own rows' sum of |b| (the scale of its float32 rounding). Rows
  16b and 16c built with the channel's and the pure-Neumann problem
  against the reference's, in the same way. The shard twins on their own
  rows equal the single-device twins bit for bit.
* _sub_mean_local against the reference's on seeded blocks of every shard,
  halo and dead rows included.
* The slices against cfd_tpu's ShardedQuadProjection(interpret=True) on 4
  host devices, 2 steps, at the reference test's configurations
  (tests/test_quad_sharded.py:163-225, :282-325): the channel at 96x32,
  tol 1e-5 (cycles within 1, u and v within 2e-5 of scale, p within 5e-4
  of scale: the source sum's float32 rounding, :210-222), RB at 48x16,
  Ra 1e5, tol 1e-5, abs_tol 1e-7 (u, v, p and T within 2e-5 of scale).
  Against the port's single-device per-kernel path at mdy 2 and 4 with the
  same bands, and bit-identical to that path with its sums taken in the
  shards' order (chip_smoke.shard_order_case); the per-cycle pin leaves the
  interior mean of p at zero and sums the own rows' ghost cells too.
* Behaviour: RB keeps the (us*, vs*, p, T) carry with
  extrapolate_warm_start, Simulation(mesh=) prints RB's single-device rows
  (max(div), on the float32 floor, within 1e-6),
  the CLI's --mesh runs both flavors, with --adaptive-dt on the lagged
  controller and not the exact one, the shard factories build the
  adaptive instances (rows 16d+, 16e+) and refuse the RB guess.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from cfd_tpu.cases import make_channel_case as jax_channel_case
from cfd_tpu.kernels import quad as JQ
from cfd_tpu.kernels import rb_quad as JR
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu.parallel import quad_sharded as JS
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case as jax_rb_case
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch.cases import make_channel_case, make_rayleigh_benard_case
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.parallel import ShardedQuadProjection, make_mesh
from cfd_tpu_torch.parallel.quad_sharded import (DEV_HALO, ShardedQuadSolve, _refresh,
                                                 _sub_mean_local)
from cfd_tpu_torch.physics.boussinesq import RBParams
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

NX, NY, MDY = 96, 32, 4
SHAPE = (NY + 2, NX + 2)
COEFFS = dict(dx=3.0 / NX, dy=1.0 / NY, dt=2e-3, viscosity=1e-2)
KAPPA = 1.2e-2
PARAMS = RBParams(1e5, 0.71)
CHANNEL_KW = dict(nx=96, ny=32, poisson="multigrid", tolerance_factor=1e-5, abs_tol=0.0)
RB_KW = dict(nx=48, ny=16, rayleigh=1e5, tolerance_factor=1e-5, abs_tol=1e-7)
RB_SHARDED = dict(tol_factor=1e-5, mg_overrides={"abs_tol": 1e-7})


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
    assert (Hq8s, P, W) == JQ.quad_shard_dims(SHAPE, MDY) == (32, 8, 128)
    Hq8 = TQ.quad_dims(SHAPE)[2]
    rng = np.random.default_rng(1612)

    def field(scale=0.1, interior=False, offset=None):
        a = (rng.standard_normal(SHAPE) * scale).astype(np.float32)
        if offset is not None:
            a += offset
        if interior:
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        q = TQ.to_quad(torch.from_numpy(a), SHAPE).numpy()
        return np.pad(q, ((0, 0), (DEV_HALO, Hq8s - Hq8 + DEV_HALO), (0, 0)))

    profile = np.linspace(1.0, 0.0, SHAPE[0], dtype=np.float32)[:, None]
    fields = dict(us=field(), vs=field(), p=field(interior=True), pp=field(interior=True),
                  T=field(0.01, offset=profile), b=field(1e3, interior=True))
    ec = np.zeros((Hq8s + 2 * DEV_HALO, W), np.float32)
    ec[DEV_HALO + 1 : DEV_HALO + NY // 2 + 1, 1 : NX // 2 + 1] = (
        rng.standard_normal((NY // 2, NX // 2)) * 0.1)
    fields["ec"] = ec
    loc, shard = (P + 2 * DEV_HALO, W), (P, MDY)
    jc, tc = JCoeffs(**COEFFS), TCoeffs(**COEFFS)
    args = (NX, NY, COEFFS["dx"], COEFFS["dy"])
    ref, port = {}, {}
    ref["channel"] = JQ.make_quad_channel_corr_predictor_source(SHAPE, jc, 1.0, shard=shard,
                                                                interpret=True)
    port["channel"] = TQ.make_quad_channel_corr_predictor_source(SHAPE, tc, 1.0, shard=shard)
    ref["rb"] = JR.make_quad_rb_step_kernel(SHAPE, jc, KAPPA, buoyancy=1.0, shard=shard,
                                            interpret=True)
    port["rb"] = TR.make_quad_rb_step_kernel(SHAPE, tc, KAPPA, PARAMS, shard=shard)
    for name, mk, (pre, post) in (("channel", "channel_problem", (1, 2)),
                                  ("neumann", "neumann_problem", (2, 1))):
        jp, tp = getattr(JM, mk)(*args), getattr(TM, mk)(*args)
        ref[f"pre_{name}"] = JQ.make_quad_pre_smooth_restrict(SHAPE, jp, 1.0, pre, loc,
                                                               shard=shard, interpret=True)
        ref[f"post_{name}"] = JQ.make_quad_post_prolong_smooth(SHAPE, jp, 1.0, post, loc,
                                                                shard=shard, interpret=True)
        port[f"pre_{name}"] = TQ.make_quad_pre_smooth_restrict(SHAPE, tp, 1.0, pre, loc,
                                                                shard=shard)
        port[f"post_{name}"] = TQ.make_quad_post_prolong_smooth(SHAPE, tp, 1.0, post, loc,
                                                                 shard=shard)
    whole = {k: torch.from_numpy(np.ascontiguousarray(v[..., DEV_HALO : DEV_HALO + Hq8, :]))
             for k, v in fields.items()}
    single = dict(
        channel=TQ.make_quad_channel_corr_predictor_source(SHAPE, tc, 1.0).plain(
            whole["us"], whole["vs"], whole["p"], whole["pp"]),
        rb=TR.make_quad_rb_step_kernel(SHAPE, tc, KAPPA, PARAMS).plain(
            whole["us"], whole["vs"], whole["p"], whole["T"]))
    return dict(fields=fields, ref=ref, port=port, single=single, P=P, Hq8=Hq8, runs={})


INPUTS = {"channel": ("us", "vs", "p", "pp"), "rb": ("us", "vs", "p", "T"),
          "pre": ("p", "b"), "post": ("p", "b", "ec")}


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
        args = [_block(t, k, jy) for k in INPUTS[kind.split("_")[0]]]
        want = t["ref"][kind](rb, *(jnp.asarray(a) for a in args))
        got = t["port"][kind](rb, *(torch.from_numpy(a) for a in args))
        t["runs"][key] = ([np.asarray(w) for w in want], [g.numpy() for g in got])
    return t["runs"][key]


def _hold_carry(want, got, P, n_vel):
    """The own rows of a carry's outputs: the first n_vel fields to 2e-6, b
    within 1e-5 of max|b|, the partial within 1e-5 of the own rows' sum of
    |b|, the rest (the guess) equal."""
    *w_fields, w_sum = want
    *g_fields, g_sum = got
    k_b = 2 if n_vel == 2 else 3  # the channel's (us, vs, b, guess), RB's (us, vs, T, b)
    for k, (w, g) in enumerate(zip(w_fields, g_fields, strict=True)):
        if k < n_vel:
            np.testing.assert_allclose(_own(g, P), _own(w, P), rtol=0, atol=2e-6, err_msg=k)
        elif k == k_b:
            np.testing.assert_allclose(_own(g, P), _own(w, P), rtol=0,
                                       atol=1e-5 * max(float(np.abs(_own(w, P)).max()), 1.0))
        else:
            np.testing.assert_array_equal(_own(g, P), _own(w, P))
    scale = float(np.abs(_own(w_fields[k_b], P)).sum())
    assert abs(float(g_sum) - float(w_sum)) <= 1e-5 * scale, (float(g_sum), float(w_sum))


@pytest.mark.parametrize("jy", [0, 1, 2])
@pytest.mark.parametrize("kind", ["channel", "rb"])
def test_carry_shard_twins_match_the_reference_shard_kernels(twins, kind, jy):
    want, got = _runs(twins, kind, jy)
    assert len(want) == len(got) == 5
    _hold_carry(want, got, twins["P"], 2 if kind == "channel" else 3)


@pytest.mark.parametrize("jy", [0, 1, 2])
@pytest.mark.parametrize("problem", ["channel", "neumann"])
def test_pre_post_shard_twins_with_the_flavor_problems(twins, problem, jy):
    """Rows 16b and 16c take their weights from the problem: the channel's
    Dirichlet outlet and the pure-Neumann box, against the reference's."""
    P = twins["P"]
    (w_p, w_rc), (g_p, g_rc) = _runs(twins, f"pre_{problem}", jy)
    np.testing.assert_allclose(_own(g_p, P), _own(w_p, P), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_own(g_rc, P), _own(w_rc, P), rtol=0,
                               atol=1e-5 * max(float(np.abs(w_rc).max()), 1.0))
    (w_p, w_res), (g_p, g_res) = _runs(twins, f"post_{problem}", jy)
    np.testing.assert_allclose(_own(g_p, P), _own(w_p, P), rtol=0, atol=2e-6)
    assert abs(float(g_res) - float(w_res)) <= 1e-6 * float(w_res)


@pytest.mark.parametrize("kind", ["channel", "rb"])
def test_carry_shard_twins_equal_the_single_device_twins_on_own_rows(twins, kind):
    P, Hq8 = twins["P"], twins["Hq8"]
    single = twins["single"][kind]
    partials = []
    for jy in range(MDY):  # shard 3 holds dead rows only
        blocks = [torch.from_numpy(_block(twins, k, jy)) for k in INPUTS[kind]]
        got = [g.numpy() for g in twins["port"][kind](jy * P - DEV_HALO, *blocks)]
        lo, hi = jy * P, max(jy * P, min(jy * P + P, Hq8))
        for k in range(4):
            want = single[k].numpy()[..., lo:hi, :]
            assert np.array_equal(got[k][..., DEV_HALO : DEV_HALO + hi - lo, :], want), (jy, k)
        partials.append(float(got[4]))
    # the partials add up to the single-device sum, in another float32 order
    k_b = 2 if kind == "channel" else 3
    scale = float(np.abs(single[k_b].numpy()).sum())
    assert abs(sum(partials) - float(single[4])) <= 1e-5 * scale


def test_sub_mean_local_matches_the_reference():
    """Every shard of 96x32 on 4, halo and dead rows included: b - mean on
    the globally indexed interior cells only."""
    Hq8s, P, W = TQ.quad_shard_dims(SHAPE, MDY)
    rng = np.random.default_rng(7)
    mean = np.float32(0.37)
    for jy in range(MDY):
        b = rng.standard_normal((4, P + 2 * DEV_HALO, W)).astype(np.float32)
        rb = jy * P - DEV_HALO
        want = np.asarray(JS._sub_mean_local(jnp.asarray(b), jnp.float32(mean), rb, NY, NX))
        got = _sub_mean_local(torch.from_numpy(b), torch.tensor(mean), rb, NY, NX).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got != b).any() or jy == 3  # shard 3 holds dead rows only


def test_shard_factories_refuse_the_adaptive_instances_and_the_rb_guess():
    """The adaptive instances on a shard's block build (their twins:
    tests/test_torch_quad_sharded_adaptive.py); the RB carry refuses the
    guess with and without them."""
    tc = TCoeffs(**COEFFS)
    assert isinstance(TQ.make_quad_channel_corr_predictor_source(SHAPE, tc, 1.0, adaptive=True,
                                                                 shard=(8, 4)),
                      TQ.QuadChannelCorrPredictorSourceShardAdaptive)
    assert isinstance(TR.make_quad_rb_step_kernel(SHAPE, tc, KAPPA, PARAMS, adaptive=True,
                                                  shard=(8, 4)), TR.QuadRBStepShardAdaptive)
    with pytest.raises(ValueError, match="emit_guess"):
        TR.make_quad_rb_step_kernel(SHAPE, tc, KAPPA, PARAMS, emit_guess=True, adaptive=True,
                                    shard=(8, 4))
    with pytest.raises(ValueError, match="emit_guess"):
        TR.make_quad_rb_step_kernel(SHAPE, tc, KAPPA, PARAMS, emit_guess=True, shard=(8, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        TR.make_quad_rb_step_kernel(SHAPE, tc, KAPPA, PARAMS, shard=(12, 4))
    op = TR.make_quad_rb_step_kernel(SHAPE, tc, KAPPA, PARAMS, shard=(8, 4))
    with pytest.raises(ValueError, match="expected a contiguous"):
        op(-DEV_HALO, *(torch.zeros(4, 8, 128) for _ in range(4)))


# ------------------------------------------------------------------ the slices

def _single_run(case, steps):
    sim = Simulation(case, log=lambda m: None)
    st = sim.initial_state()
    iters = []
    for _ in range(steps):
        st, d = sim._step(st)
        iters.append(d.poisson_iters)
    return iters, sim._logical(st)


def _sharded_run(sq, steps):
    s = sq.initial_state()
    iters = []
    for _ in range(steps):
        s, d = sq.step(s)
        iters.append(int(d["poisson_iters"]))
    return iters, sq.logical(s)


def _hold(got, want, names, p_band):
    (g_it, g), (w_it, w) = got, want
    assert len(g_it) == len(w_it) and all(abs(a - b) <= 1 for a, b in zip(g_it, w_it)), \
        (g_it, w_it)
    for name in names:
        a = np.asarray(getattr(w, name))
        band = p_band if name == "p" else 2e-5
        np.testing.assert_allclose(np.asarray(getattr(g, name)), a, rtol=0,
                                   atol=band * max(1.0, float(np.abs(a).max())), err_msg=name)


def _jax_mesh():
    return JaxMesh(np.array(jax.devices("cpu")[:MDY]), ("dy",))


def _port_channel():
    return make_channel_case(dtype=torch.float32, device="cpu", **CHANNEL_KW)


def _port_rb(**kw):
    return make_rayleigh_benard_case(dtype=torch.float32, device="cpu", **RB_KW, **kw)


def test_sharded_channel_matches_the_reference():
    case = jax_channel_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad",
                            **CHANNEL_KW)
    jsq = JS.ShardedQuadProjection(case, _jax_mesh(), interpret=True, tol_factor=1e-5)
    assert jsq.flavor == "channel"
    sq = ShardedQuadProjection(_port_channel(), _cpu_mesh(), tol_factor=1e-5)
    assert (sq.flavor, sq.mg.pre_sweeps, sq.mg.post_sweeps) == ("channel", 1, 2)
    _hold(_sharded_run(sq, 2), _sharded_run(jsq, 2), "uvp", 5e-4)


def test_sharded_rb_matches_the_reference():
    case = jax_rb_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad", **RB_KW)
    jsq = JS.ShardedQuadProjection(case, _jax_mesh(), interpret=True, **RB_SHARDED)
    assert jsq.flavor == "rayleigh_benard"
    sq = ShardedQuadProjection(_port_rb(), _cpu_mesh(), **RB_SHARDED)
    assert sq._solve.pin_mean and (sq.mg.pre_sweeps, sq.mg.post_sweeps) == (2, 1)
    _hold(_sharded_run(sq, 2), _sharded_run(jsq, 2), "uvpT", 2e-5)


@pytest.mark.parametrize("mdy", [2, 4])
@pytest.mark.parametrize("flavor", ["channel", "rb"])
def test_sharded_flavors_match_the_single_device_path(flavor, mdy):
    if flavor == "channel":
        case, kw, names, p_band = _port_channel(), {"tol_factor": 1e-5}, "uvp", 5e-4
    else:
        case, kw, names, p_band = _port_rb(), RB_SHARDED, "uvpT", 2e-5
    assert not case.info["mg"].whole_solve  # the CPU's per-kernel solve
    _hold(_sharded_run(ShardedQuadProjection(case, _cpu_mesh(mdy), **kw), 3),
          _single_run(case, 3), names, p_band)


@pytest.mark.parametrize("flavor", ["channel", "rb"])
def test_sharded_flavors_equal_the_single_device_path_summed_in_shard_order(flavor):
    """The sum order is the only difference: the single-device per-kernel
    path whose source sums (and RB's pin sums) add the shards' own-row
    partials in shard order (chip_smoke.shard_order_case, the reference run
    of its phase 36) equals the sharded run bit for bit, cycles included."""
    from chip_smoke import shard_order_case

    make, kw = ((_port_channel, {"tol_factor": 1e-5}) if flavor == "channel"
                else (_port_rb, RB_SHARDED))
    sq = ShardedQuadProjection(make(), _cpu_mesh(), **kw)
    got = _sharded_run(sq, 5)
    want = _single_run(shard_order_case(make(), sq), 5)
    assert got[0] == want[0]
    for name in ("u", "v", "p", "T", "p_prev"):
        a, w = getattr(got[1], name), getattr(want[1], name)
        assert (a is None) == (w is None) and (a is None or torch.equal(a, w)), name


def test_the_pin_zeroes_the_interior_mean_and_sums_the_ghost_cells():
    """Each cycle: post, refresh, then p - mean, the mean taken over every
    shard's own rows, ghost cells included (:367-369), over nx * ny. A solve
    with the pin against one without, from a warm start with nonzero ghost
    cells: the difference is that mean on the interior and 0 elsewhere, and
    the interior mean after the pin is 0 to float32 roundoff."""
    case = _port_rb()
    g = case.grid
    sq = ShardedQuadProjection(case, _cpu_mesh(), **RB_SHARDED)
    pinned = sq._solve
    plain = ShardedQuadSolve(TM.neumann_problem(g.nx, g.ny, g.dx, g.dy), sq.mg, g.shape,
                             sq.devices)
    assert pinned.pin_mean and not plain.pin_mean
    rng = np.random.default_rng(3)
    cells = TQ.quad_cell_mask(g.shape, "cpu")
    q = torch.from_numpy(rng.standard_normal(tuple(cells.shape)).astype(np.float32))
    b = torch.where(cells, q * 1e2, torch.zeros_like(q))
    b = torch.where(cells, b - b.sum() / cells.sum(), b)
    p0 = torch.where(cells, q, 5.0 * torch.ones_like(q))  # ghost and padding cells at 5
    p_blocks = _refresh(sq._extend(p0), sq.P)
    b_blocks = _refresh(sq._extend(b), sq.P)
    got, res_pin = pinned.cycle([x.clone() for x in p_blocks], b_blocks)
    free, res_free = plain.cycle([x.clone() for x in p_blocks], b_blocks)
    assert float(res_pin) == float(res_free)  # the residual is taken before the pin
    got, free = sq._collapse(got).double(), sq._collapse(free).double()
    mean = float(free.sum()) / (g.nx * g.ny)  # own rows, every cell
    inner = float(free[:, : cells.shape[1]][cells].sum()) / (g.nx * g.ny)
    assert abs(mean - inner) > 1.0  # the ghost cells weigh in
    shift = (free - got)[:, : cells.shape[1]]
    assert float((shift[cells] - mean).abs().max()) <= 1e-5 * float(free.abs().max())
    assert not shift[~cells].any()
    after = float(got[:, : cells.shape[1]][cells].sum()) / (g.nx * g.ny)
    assert abs(after + (mean - inner)) <= 1e-6 * float(free.abs().max())


# --------------------------------------------------------------- behaviour

def test_rb_keeps_the_temperature_carry_with_extrapolate_warm_start():
    """The reference's sharded RB carries (us*, vs*, p, T) and solves from p
    whatever the case's warm start (:861-864, :902-909)."""
    runs = []
    for ews in (False, True):
        sq = ShardedQuadProjection(_port_rb(extrapolate_warm_start=ews), _cpu_mesh(),
                                   **RB_SHARDED)
        s0 = sq.initial_state()
        T0 = sq._collapse(s0[3])[:, : sq._Hq8]
        assert torch.equal(T0, sq.case.initial_state_fn().T)
        runs.append(sq.run_chunk(s0, 2))
    (a, da), (b, db) = runs
    assert da["poisson_iters"] == db["poisson_iters"]
    for x, y in zip(a, b, strict=True):
        for u, v in zip(x, y, strict=True):
            assert torch.equal(u, v)


def test_simulation_with_a_mesh_prints_the_rb_rows():
    """RB's stats rows, the Nusselt numbers included, come from the gathered
    logical state: the single-device rows at printed precision, but for
    max(div), which sits on the float32 floor (about 4e-6 here) that the
    source sum's and the pin's order move: it is held to 1e-6."""
    rows, divs = [], []
    for mesh in (None, _cpu_mesh()):
        sim = Simulation(_port_rb(print_interval=2), log=lambda m: None, mesh=mesh,
                         sharded_kwargs=mesh and RB_SHARDED)
        sim.run(n_steps=4)
        rows.append([(r["step"], r["poisson_iters"], f"{r['avg_kinetic_energy']:10.6f}",
                      *(f"{r[k]:.6f}" for k in ("nusselt_bottom", "nusselt_top",
                                                "nusselt_volume")))
                     for r in sim.history])
        divs.append([r["max_divergence"] for r in sim.history])
    assert rows[0] == rows[1] and len(rows[0]) == 2
    assert all(abs(a - b) <= 1e-6 for a, b in zip(*divs, strict=True)), divs


def test_cli_mesh_runs_the_channel_and_rb(capsys):
    from cfd_tpu_torch.cli import main

    args = ["--T", "1.0", "--steps", "2", "--device", "cpu", "--precision", "f32",
            "--no-vtk", "--print-interval", "2", "--save-interval", "2"]
    assert main(["channel", "--mesh", "4", "--Nx", "96", "--Ny", "32", "--poisson",
                 "multigrid", *args]) == 0
    assert main(["rayleigh_benard", "--mesh", "4", "--Nx", "48", "--Ny", "16", "--Ra", "1e5",
                 *args]) == 0
    out = capsys.readouterr().out
    assert out.count("mesh: 4x1 plane-row decomposition over cpu") == 2
    assert out.count("Step      2") == 2
    assert main(["channel", "--mesh", "4", "--Nx", "96", "--Ny", "32", "--poisson",
                 "multigrid", "--adaptive-dt", "0.7", "--adaptive-controller", "lagged",
                 *args]) == 0
    assert "| Co=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="lagged"):
        main(["rayleigh_benard", "--mesh", "4", "--Nx", "48", "--Ny", "16", "--adaptive-dt",
              "0.7", *args])
