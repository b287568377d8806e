"""The cavity on the sharded quad path (cfd_tpu_torch.parallel) against
cfd_tpu on the CPU, where the port runs its plain twins and the reference
its Pallas kernels in interpret mode on the 8-device host mesh
(tests/conftest.py).

* The shard twins (rows 16a-16c: kernels.quad *Shard) against the
  reference's shard=(P, mdy) kernels called directly with their row_base,
  at 64^2 and mdy 4 (P = 16), for every shard (jy = 0 the bottom, 1
  interior, 2 holding the top wall, 3 dead padding), on seeded inputs, own
  rows: velocities 2e-6, b and rc within 1e-5 of their scale, smoothed p
  2e-6, the partials (max|b|, max|b - A p|) equal; and bit-identical on the
  own rows to the single-device twins.
* The halo refresh and the extend/collapse converters
  (tests/test_quad_sharded.py:38-50), zeros at the outer edges.
* The slice: ShardedQuadCavity at 64^2, mdy 4, tol 1e-5, 2 steps, against
  the reference's: cycles within 1 (equal expected), fields within 2e-5 of
  scale (tests/test_quad_sharded.py:57-93). Against the port's
  single-device path at mdy 4 and 8 (P = 8, the minimum): bit-identical,
  because each shard's own rows run the same float32 operations; run_chunk
  equals stepping; tail_from=1 equals no tail.
* The refusals (the exact adaptive controller on a mesh, the step's
  V(1,2), the natural layout), the 1-shard delegation, make_mesh,
  Simulation(mesh=) and the CLI's --mesh, with the lagged adaptive
  controller too. The channel and RB flavors:
  tests/test_torch_quad_sharded_flavors.py; the step:
  tests/test_torch_quad_sharded_step*.py; adaptive dt on the mesh:
  tests/test_torch_quad_sharded_adaptive*.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from cfd_tpu.cases import make_cavity_case as jax_case
from cfd_tpu.kernels import quad as JQ
from cfd_tpu.parallel.quad_sharded import ShardedQuadCavity as JaxShardedQuadCavity
from cfd_tpu.poisson import multigrid as JM
from cfd_tpu_torch.cases import make_backwards_step_case, make_cavity_case
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.parallel import (ShardedQuadCavity, ShardedQuadProjection, global_max,
                                    global_sum, make_mesh)
from cfd_tpu_torch.parallel.mesh import factor_2d
from cfd_tpu_torch.parallel.quad_sharded import DEV_HALO, _refresh
from cfd_tpu_torch.poisson import multigrid as TM
from cfd_tpu_torch.solver import Simulation

torch.set_num_threads(1)

N, MDY = 64, 4
KW = dict(n_interior=N, poisson="multigrid", tolerance_factor=1e-5)


def _port(n=N, **kw):
    return make_cavity_case(dtype=torch.float32, device="cpu", **{**KW, "n_interior": n,
                                                                   **kw})


def _cpu_mesh(mdy=MDY):
    return make_mesh(mdy, device="cpu")


# ----------------------------------------------------------- the shard twins

@pytest.fixture(scope="module")
def twins():
    """Seeded global fields, extended to the 4 shards' local blocks, and the
    reference's and the port's shard kernels (one reference instance each:
    row_base is a traced argument)."""
    jc = jax_case(n_interior=N, dtype=jnp.float32, poisson="multigrid",
                  step_kernel_mode="interpret", layout="quad")
    tc = _port()
    shape = tc.grid.shape
    Hq8s, P, W = TQ.quad_shard_dims(shape, MDY)
    assert (Hq8s, P, W) == JQ.quad_shard_dims(shape, MDY) == (64, 16, 128)
    Hq8 = TQ.quad_dims(shape)[2]
    rng = np.random.default_rng(16)

    def field(scale=0.1, interior=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if interior:
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        q = TQ.to_quad(torch.from_numpy(a), shape).numpy()
        return np.pad(q, ((0, 0), (DEV_HALO, Hq8s - Hq8 + DEV_HALO), (0, 0)))

    fields = dict(us=field(), vs=field(), p=field(interior=True), pp=field(interior=True),
                  b=field(1e3, interior=True))
    ec = np.zeros((Hq8s + 2 * DEV_HALO, W), np.float32)
    ec[DEV_HALO + 1 : DEV_HALO + N // 2 + 1, 1 : N // 2 + 1] = (
        rng.standard_normal((N // 2, N // 2)) * 0.1)
    fields["ec"] = ec
    loc = (P + 2 * DEV_HALO, W)
    jprob = JM.cavity_problem(N, N, jc.grid.dx, jc.grid.dy)
    tprob = TM.cavity_problem(N, N, tc.grid.dx, tc.grid.dy)
    ref = dict(
        carry=JQ.make_quad_corr_predictor_source(shape, jc.coeffs, 1.0, shard=(P, MDY),
                                                 interpret=True),
        pre=JQ.make_quad_pre_smooth_restrict(shape, jprob, 1.0, 2, loc, shard=(P, MDY),
                                             interpret=True),
        post=JQ.make_quad_post_prolong_smooth(shape, jprob, 1.0, 1, loc, shard=(P, MDY),
                                              interpret=True))
    port = dict(
        carry=TQ.make_quad_corr_predictor_source(shape, tc.coeffs, 1.0, shard=(P, MDY)),
        pre=TQ.make_quad_pre_smooth_restrict(shape, tprob, 1.0, 2, loc, shard=(P, MDY)),
        post=TQ.make_quad_post_prolong_smooth(shape, tprob, 1.0, 1, loc, shard=(P, MDY)))
    whole = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., DEV_HALO : DEV_HALO + Hq8,
                                                              :]))
    f = {k: whole(v) for k, v in fields.items()}
    single = dict(
        carry=TQ.make_quad_corr_predictor_source(shape, tc.coeffs, 1.0).plain(
            f["us"], f["vs"], f["p"], f["pp"]),
        pre=TQ.make_quad_pre_smooth_restrict(shape, tprob, 1.0, 2, (Hq8, W)).plain(
            f["p"], f["b"]),
        post=TQ.make_quad_post_prolong_smooth(shape, tprob, 1.0, 1, (Hq8, W)).plain(
            f["p"], f["b"], f["ec"]))
    return dict(fields=fields, ref=ref, port=port, single=single, P=P, Hq8=Hq8)


def _local(t, name, jy):
    P = t["P"]
    return np.ascontiguousarray(t["fields"][name][..., jy * P : jy * P + P + 2 * DEV_HALO, :])


def _runs(t, jy):
    """(reference, port) outputs of the three kernels on shard jy, run once
    per module."""
    memo = t.setdefault("runs", {})
    if jy not in memo:
        memo[jy] = _run_kernels(t, jy)
    return memo[jy]


def _run_kernels(t, jy):
    rb = jy * t["P"] - DEV_HALO
    args = {k: _local(t, k, jy) for k in t["fields"]}
    out = {}
    for kind, names in (("carry", ("us", "vs", "p", "pp")), ("pre", ("p", "b")),
                        ("post", ("p", "b", "ec"))):
        want = t["ref"][kind](rb, *(jnp.asarray(args[k]) for k in names))
        got = t["port"][kind](rb, *(torch.from_numpy(args[k]) for k in names))
        out[kind] = ([np.asarray(w) for w in want], [g.numpy() for g in got])
    return out


def _own(a, P):
    return a[..., DEV_HALO : DEV_HALO + P, :]


@pytest.mark.parametrize("jy", [0, 1, 2, 3])
def test_shard_twins_match_the_reference_shard_kernels(twins, jy):
    P = twins["P"]
    out = _runs(twins, jy)
    (w_us, w_vs, w_b, w_g, w_max), (g_us, g_vs, g_b, g_g, g_max) = out["carry"]
    for w, g in ((w_us, g_us), (w_vs, g_vs), (w_g, g_g)):
        np.testing.assert_allclose(_own(g, P), _own(w, P), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_own(g_b, P), _own(w_b, P), rtol=0,
                               atol=1e-5 * max(float(np.abs(w_b).max()), 1.0))
    assert g_max == w_max
    (w_p, w_rc), (g_p, g_rc) = out["pre"]
    np.testing.assert_allclose(_own(g_p, P), _own(w_p, P), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_own(g_rc, P), _own(w_rc, P), rtol=0,
                               atol=1e-5 * max(float(np.abs(w_rc).max()), 1.0))
    (w_p, w_res), (g_p, g_res) = out["post"]
    np.testing.assert_allclose(_own(g_p, P), _own(w_p, P), rtol=0, atol=2e-6)
    assert g_res == w_res


@pytest.mark.parametrize("jy", [0, 1, 2, 3])
def test_shard_twins_equal_the_single_device_twins_on_own_rows(twins, jy):
    P, Hq8 = twins["P"], twins["Hq8"]
    lo = jy * P
    hi = max(lo, min(lo + P, Hq8))  # the shard's global rows inside the field
    out = _runs(twins, jy)
    for kind, n in (("carry", 4), ("pre", 2), ("post", 1)):
        got = out[kind][1]
        for k in range(n):
            want = twins["single"][kind][k].numpy()[..., lo:hi, :]
            assert np.array_equal(got[k][..., DEV_HALO : DEV_HALO + hi - lo, :], want), \
                (kind, k)
            rest = got[k][..., DEV_HALO + hi - lo : DEV_HALO + P, :]
            assert not rest.any()  # own rows beyond the padded grid stay 0
    cmax = float(np.abs(twins["single"]["carry"][2].numpy()).max())
    parts = [_runs(twins, j)["carry"][1][4] for j in range(MDY)]
    assert max(float(x) for x in parts) == cmax  # the partials' max is the global max


def test_shard_kernels_take_a_block_and_a_row_base(twins):
    t = twins["port"]
    with pytest.raises(ValueError, match="expected a contiguous"):
        t["carry"](-DEV_HALO, *(torch.zeros(4, 8, 128) for _ in range(4)))
    with pytest.raises(ValueError, match="multiple of 8"):
        TQ.make_quad_corr_predictor_source((66, 66), _port().coeffs, 1.0, shard=(12, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        TQ.make_quad_corr_predictor_source((66, 66), _port().coeffs, 1.0, adaptive=True,
                                           shard=(12, 4))
    adaptive = TQ.make_quad_corr_predictor_source((66, 66), _port().coeffs, 1.0,
                                                  adaptive=True, shard=(16, 4))
    assert isinstance(adaptive, TQ.QuadCorrPredictorSourceShardAdaptive)
    with pytest.raises(ValueError, match="expected a contiguous"):
        adaptive(-DEV_HALO, torch.zeros(2), *(torch.zeros(4, 8, 128) for _ in range(4)))


# ------------------------------------------------- halos and the converters

def test_extend_collapse_roundtrip_and_the_halo_refresh():
    sq = ShardedQuadCavity(_port(), _cpu_mesh(), tol_factor=1e-5)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(4, sq.Hq8s, sq.W)).astype(np.float32))
    xs = sq._extend(q)
    assert len(xs) == sq.mdy and all(x.shape == (4, sq.P + 2 * DEV_HALO, sq.W) for x in xs)
    assert torch.equal(sq._collapse(xs), q)
    # halo strips hold the neighbour's adjacent global rows
    assert torch.equal(xs[1][:, :DEV_HALO], q[:, sq.P - DEV_HALO : sq.P])
    assert torch.equal(xs[1][:, sq.P + DEV_HALO :], q[:, 2 * sq.P : 2 * sq.P + DEV_HALO])
    # the refresh rebuilds them from the own rows, with zeros at the outer edges
    stale = [x + 1.0 for x in xs]
    own = [x[:, DEV_HALO : DEV_HALO + sq.P].clone() for x in stale]
    _refresh(stale, sq.P)
    assert not stale[0][:, :DEV_HALO].any() and not stale[-1][:, sq.P + DEV_HALO :].any()
    for jy in range(sq.mdy):
        assert torch.equal(stale[jy][:, DEV_HALO : DEV_HALO + sq.P], own[jy])
        if jy > 0:
            assert torch.equal(stale[jy][:, :DEV_HALO], own[jy - 1][:, -DEV_HALO:])
        if jy < sq.mdy - 1:
            assert torch.equal(stale[jy][:, sq.P + DEV_HALO :], own[jy + 1][:, :DEV_HALO])
    rc = [torch.ones(sq.P + 2 * DEV_HALO, sq.W) * (jy + 1) for jy in range(sq.mdy)]
    _refresh(rc, sq.P)  # level-1 blocks: rows are the last-but-one axis too
    assert float(rc[1][0, 0]) == 1.0 and float(rc[1][-1, 0]) == 3.0 and not rc[0][0].any()


# ------------------------------------------------------------------ the slice

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
        iters.append(d["poisson_iters"])
    return iters, s, sq.logical(s)


def test_sharded_cavity_matches_the_references():
    """64^2, mdy 4, tol 1e-5, 2 steps against cfd_tpu's ShardedQuadCavity
    on the host mesh (cycles within 1, fields within 2e-5 of scale)."""
    case = jax_case(dtype=jnp.float32, step_kernel_mode="interpret", layout="quad",
                    fuse_pre=False, **KW)
    jsq = JaxShardedQuadCavity(case, JaxMesh(np.array(jax.devices("cpu")[:MDY]), ("dy",)),
                               interpret=True, tol_factor=1e-5)
    state, want_iters = jsq.initial_state(), []
    for _ in range(2):
        state, d = jsq.step(state)
        want_iters.append(int(d["poisson_iters"]))
    want = jsq.logical(state)
    got_iters, _, got = _sharded_run(ShardedQuadCavity(_port(), _cpu_mesh(), tol_factor=1e-5),
                                     2)
    assert got_iters == want_iters  # equal expected; the reference's band is 1
    for name in ("u", "v", "p"):
        a = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), a, rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(a).max())), err_msg=name)


@pytest.mark.parametrize("mdy", [4, 8])
def test_sharded_cavity_is_bit_identical_to_the_single_device_path(mdy):
    case = _port()
    want_iters, want = _single_run(case, 3)
    got_iters, _, got = _sharded_run(ShardedQuadCavity(case, _cpu_mesh(mdy), tol_factor=1e-5),
                                     3)
    assert got_iters == want_iters
    for name in ("u", "v", "p", "p_prev"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_run_chunk_equals_stepping_and_tail_from_equals_no_tail():
    case = _port()
    sq = ShardedQuadCavity(case, _cpu_mesh(), tol_factor=1e-5)
    iters, stepped, _ = _sharded_run(sq, 3)
    chunked, d = sq.run_chunk(sq.initial_state(), 3)
    assert d["poisson_iters"] == iters and len(d["poisson_residual"]) == 3
    tail = ShardedQuadCavity(case, _cpu_mesh(), tol_factor=1e-5,
                             mg_overrides={"tail_from": 1})
    assert tail._solve.tail_at == 2  # clamped to the first replicated level
    tail_iters, tailed, _ = _sharded_run(tail, 3)
    assert tail_iters == iters
    for a, b, c in zip(stepped, chunked, tailed, strict=True):
        for x, y, z in zip(a, b, c, strict=True):
            assert torch.equal(x, y) and torch.equal(x, z)


# ------------------------------------------------ delegation and refusals

def test_one_shard_mesh_delegates():
    case = _port()
    want_iters, want = _single_run(case, 2)
    sq = ShardedQuadCavity(case, _cpu_mesh(1))
    assert sq.delegated
    got_iters, _, got = _sharded_run(sq, 2)
    forced = ShardedQuadCavity(case, _cpu_mesh(1), force_sharded_path=True, tol_factor=1e-5)
    assert not forced.delegated and not ShardedQuadCavity(case, _cpu_mesh(1),
                                                          tol_factor=1e-5).delegated
    f_iters, _, f = _sharded_run(forced, 2)
    assert got_iters == want_iters == f_iters
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(got, name), getattr(want, name))
        assert torch.equal(getattr(f, name), getattr(want, name))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mg_overrides={"coarse_dtype": "bfloat16"}), ValueError, "coarse_dtype"),
    (dict(mg_overrides={"corr_opt": True}), ValueError, "corr_opt"),
    (dict(mg_overrides={"pre_sweeps": 2, "post_sweeps": 2}), ValueError, "halo rows"),
    (dict(mg_overrides={"whole_solve": True}), ValueError, "single-device only"),
    (dict(mdy=17), ValueError, "validated"),
])
def test_sharded_config_refusals(kw, exc, match):
    kw = dict(kw)
    mdy = kw.pop("mdy", MDY)
    with pytest.raises(exc, match=match):
        ShardedQuadProjection(_port(), _cpu_mesh(mdy), **kw)


@pytest.mark.parametrize("make,kw,item", [
    (make_backwards_step_case, dict(nx=64, ny=16, poisson="multigrid"), r"V\(1,1\) only"),
])
def test_other_flavors_are_refused(make, kw, item):
    """The step flavor builds, and so does its lagged adaptive step; what it
    still refuses is a V-cycle other than V(1,1) (the exact masked
    smoother's halo budget, cfd_tpu/parallel/quad_sharded.py:837-838)."""
    case = make(dtype=torch.float32, device="cpu", **kw)
    sq = ShardedQuadProjection(case, _cpu_mesh())
    assert sq.flavor == "backwards_step"
    assert all(callable(f) for f in sq.make_adaptive(0.7, 1.2, 1.0, 10))
    with pytest.raises(ValueError, match=item):
        ShardedQuadProjection(case, _cpu_mesh(), mg_overrides={"post_sweeps": 2})


def test_adaptive_and_the_natural_layout_are_refused():
    """On a mesh run_adaptive refuses the exact controller (the reference's
    ValueError, cfd_tpu/adaptive.py:227-232) and runs the lagged one."""
    from cfd_tpu_torch.adaptive import run_adaptive

    sq = ShardedQuadProjection(_port(), _cpu_mesh(), tol_factor=1e-5)
    sim = Simulation(_port(print_interval=2), log=lambda m: None, mesh=_cpu_mesh())
    with pytest.raises(ValueError, match="sharded adaptive runs the lagged controller"):
        run_adaptive(sim, n_steps=2, controller="exact")
    _, rows = run_adaptive(sim, n_steps=2, controller="lagged")
    assert [r["step"] for r in rows] == [2] and len(sim.step_dts) == 2
    with pytest.raises(ValueError, match="quad layout"):
        ShardedQuadProjection(_port(layout="aligned"), _cpu_mesh())
    assert sq.mg.tol_factor == 1e-5 and (sq.mg.pre_sweeps, sq.mg.post_sweeps) == (2, 1)
    assert ShardedQuadProjection(_port(), _cpu_mesh()).mg.tol_factor == 1e-9  # :822-823


def test_make_mesh(monkeypatch):
    mesh = make_mesh(4, device="cpu")
    assert mesh.shape == {"dy": 4} and mesh.devices == (torch.device("cpu"),) * 4
    assert factor_2d(8) == (2, 4) and factor_2d(7) == (1, 7)
    with pytest.raises(NotImplementedError, match="plane-row"):
        make_mesh(4, shape=(2, 2), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4, device="cuda")


def test_global_max_and_global_sum_reduce_the_partials_in_shard_order():
    """lax.pmax and lax.psum over the shards' 0-d partials: the sum adds in
    shard order, so it equals the left fold bit for bit."""
    parts = [torch.tensor(x, dtype=torch.float32) for x in (1e8, 1.0, -1e8, 3.5)]
    assert float(global_max(parts)) == 1e8
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(global_sum(parts), want) and float(want) == 3.5
    assert global_sum(parts[:1]) is parts[0]


def test_sharded_solve_ignores_pin_mean():
    """The reference's sharded builder takes the mean pin as its own argument,
    which only Rayleigh-Benard passes (cfd_tpu/parallel/quad_sharded.py:174-177,
    :884-885): the cavity's mg_overrides pin_mean changes nothing."""
    runs = [_sharded_run(ShardedQuadCavity(_port(), _cpu_mesh(), tol_factor=1e-5,
                                           mg_overrides=ov), 1) for ov in ({}, {"pin_mean": True})]
    (it0, _, st0), (it1, _, st1) = runs
    assert it0 == it1
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(st0, name), getattr(st1, name))


# ------------------------------------------------- Simulation(mesh=) and CLI

def test_simulation_with_a_mesh_prints_the_single_device_rows():
    rows = []
    for mesh in (None, _cpu_mesh()):
        case = _port(print_interval=2)
        sim = Simulation(case, log=lambda m: None, mesh=mesh,
                         sharded_kwargs=mesh and {"tol_factor": 1e-5})
        sim.run(n_steps=4)
        rows.append([(r["step"], r["poisson_iters"], f"{r['max_divergence']:10.2e}",
                      f"{r['avg_kinetic_energy']:10.6f}", f"{r['poisson_residual']:10.2e}")
                     for r in sim.history])
        steps = sim.step_iters
    assert rows[0] == rows[1] and len(steps) == 4


def test_simulation_with_a_mesh_resumes_from_a_logical_state():
    """run(state=) on a sharded engine: a logical State is split onto the
    shards, the engine's own state passes as it is, and a single-device
    carried State is refused."""
    case = _port(print_interval=1)
    kw = dict(log=lambda m: None, mesh=_cpu_mesh(), sharded_kwargs={"tol_factor": 1e-5})
    straight = Simulation(case, **kw)
    want = straight._logical(straight.run(n_steps=2))
    sim = Simulation(case, **kw)
    half = sim.run(n_steps=1)
    got = sim._logical(sim.run(state=sim._logical(half), n_steps=1, start_step=1))
    again = sim._logical(Simulation(case, **kw).run(state=half, n_steps=1, start_step=1))
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(got, name), getattr(want, name))
        assert torch.equal(getattr(again, name), getattr(want, name))
    with pytest.raises(ValueError, match="logical"):
        sim.run(state=Simulation(case, log=lambda m: None).initial_state(), n_steps=1)


def test_cli_mesh(capsys):
    from cfd_tpu_torch.cli import main

    args = ["--Nx", "64", "--Ny", "64", "--T", "1.0", "--steps", "2", "--device", "cpu",
            "--precision", "f32", "--poisson", "multigrid", "--no-vtk",
            "--print-interval", "2", "--save-interval", "2"]
    assert main(["cavity", "--mesh", "4", *args]) == 0
    out = capsys.readouterr().out
    assert "mesh: 4x1 plane-row decomposition over cpu" in out and "Step      2" in out
    assert main(["backwards_step", "--mesh", "4", *args[4:], "--Nx", "64", "--Ny", "16",
                 "--adaptive-dt", "0.7", "--adaptive-controller", "lagged"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 4x1 plane-row decomposition over cpu" in out and "| Co=" in out
    with pytest.raises(SystemExit, match="lagged"):
        main(["cavity", "--mesh", "4", "--adaptive-dt", "0.7", *args])
