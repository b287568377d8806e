"""Adaptive dt on the plane-row mesh (cfd_tpu_torch.parallel): the four
traced-dt + Courant carries on one shard's local block (rows 16a+, 16d+,
16e+, 16f+) against cfd_tpu on the CPU, where the port runs its plain twins
and the reference its Pallas kernels in interpret mode.

* The shard-adaptive twins (kernels.quad QuadCorrPredictorSourceShardAdaptive,
  QuadChannelCorrPredictorSourceShardAdaptive, kernels.rb_quad
  QuadRBStepShardAdaptive, kernels.step_quad
  QuadStepCorrPredictorSourceShardAdaptive) against the reference's
  shard=(P, mdy), traced_dt=True, emit_courant=True kernels called as
  fused_a(row_base, (dt_corr, dt_pred), *arrays), with dt_corr = 0.8 dt and
  dt_pred = 1.1 dt: the cavity at 64^2 (P = 16), the channel and RB at
  96x32 (P = 8), the step at 128x64 (P = 16), all on 4 shards, on shards 0,
  1 and 3 (the last), own rows: velocities and T 2e-6, b within 1e-5 of
  max, the guess equal, the partial (the cavity's max|b|, the others' sum
  of b) within 1e-5 of the own rows' max|b| or sum of |b|, max|u| and
  max|v| within 1e-6 relative.
* On every shard the twins' own rows equal the single-device adaptive twins'
  (rows 1+, 8a+, 10+, 9a+) bit for bit, and the maxima of mu and mv over
  the shards equal the whole field's.
* Halo rows poisoned with large velocities leave mu and mv where they were:
  the Courant maxima cover the own rows only, as the reference's every
  scalar of a shard kernel (cfd_tpu/kernels/quad.py:308-312).

The sharded lagged runs and the routing of run_adaptive on a mesh are in
tests/test_torch_quad_sharded_adaptive_runs.py; the slices against the
reference's run_adaptive in
tests/test_torch_quad_sharded_adaptive_{cavity,channel,rb,step}.py, one
reference run a file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.kernels import quad as JQ
from cfd_tpu.kernels import rb_quad as JR
from cfd_tpu.kernels import step_quad as JSQ
from cfd_tpu.ops.stencil import StencilCoeffs as JCoeffs
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.kernels import step_quad as TSQ
from cfd_tpu_torch.ops.stencil import StencilCoeffs as TCoeffs
from cfd_tpu_torch.parallel.quad_sharded import DEV_HALO
from cfd_tpu_torch.physics.boussinesq import RBParams

torch.set_num_threads(1)

MDY = 4
DT_CORR, DT_PRED = 0.8, 1.1  # times the coefficients' dt
KAPPA = 1.2e-2
STEP_I, INLET_J = 32, 32  # the 128x64 step's rectangle: int(2 / dx), int(1 / dy)


def _coeffs(nx, ny, length=1.0, height=1.0):
    return dict(dx=length / nx, dy=height / ny, dt=2e-3, viscosity=1e-2)


# kind: (shape, coefficients, inputs, outputs, reference factory, port
# factory); the factories take (coeffs, shard) and shard=None builds the
# port's single-device adaptive twin
KINDS = {
    "cavity": ((66, 66), _coeffs(64, 64), ("us", "vs", "p", "pp"),
               ("us", "vs", "b", "guess", "max_b", "mu", "mv"),
               lambda c, shard: JQ.make_quad_corr_predictor_source(
                   (66, 66), c, 1.0, shard=shard, interpret=True, traced_dt=True,
                   emit_courant=True),
               lambda c, shard: TQ.make_quad_corr_predictor_source(
                   (66, 66), c, 1.0, adaptive=True, shard=shard)),
    "channel": ((34, 98), _coeffs(96, 32, length=3.0), ("us", "vs", "p", "pp"),
                ("us", "vs", "b", "guess", "sum_b", "mu", "mv"),
                lambda c, shard: JQ.make_quad_channel_corr_predictor_source(
                    (34, 98), c, 1.0, shard=shard, interpret=True, traced_dt=True,
                    emit_courant=True),
                lambda c, shard: TQ.make_quad_channel_corr_predictor_source(
                    (34, 98), c, 1.0, adaptive=True, shard=shard)),
    "rb": ((34, 98), _coeffs(96, 32, length=3.0), ("us", "vs", "p", "T"),
           ("us", "vs", "T", "b", "sum_b", "mu", "mv"),
           lambda c, shard: JR.make_quad_rb_step_kernel(
               (34, 98), c, KAPPA, buoyancy=1.0, shard=shard, interpret=True,
               traced_dt=True, emit_courant=True),
           lambda c, shard: TR.make_quad_rb_step_kernel(
               (34, 98), c, KAPPA, RBParams(1e5, 0.71), adaptive=True, shard=shard)),
    "step": ((66, 130), _coeffs(128, 64, length=8.0, height=2.0), ("us", "vs", "p"),
             ("us", "vs", "b", "sum_b", "mu", "mv"),
             lambda c, shard: JSQ.make_quad_step_corr_predictor_source(
                 (66, 130), c, STEP_I, INLET_J, 1.0, shard=shard, interpret=True,
                 traced_dt=True, emit_courant=True),
             lambda c, shard: TSQ.make_quad_step_corr_predictor_source(
                 (66, 130), c, STEP_I, INLET_J, 1.0, adaptive=True, shard=shard)),
}


def _fields(kind, seed):
    """Seeded global fields of ``kind`` in the quad layout, padded with
    DEV_HALO rows below and up to the mesh's rows plus DEV_HALO above."""
    shape = KINDS[kind][0]
    Hq8s, _, _ = TQ.quad_shard_dims(shape, MDY)
    Hq8 = TQ.quad_dims(shape)[2]
    rng = np.random.default_rng(seed)
    jj, ii = np.arange(shape[0])[:, None], np.arange(shape[1])[None, :]
    cells = (jj >= 1) & (jj <= shape[0] - 2) & (ii >= 1) & (ii <= shape[1] - 2)
    if kind == "step":
        cells &= ~((ii <= STEP_I) & (jj > INLET_J))
    out = {}
    for name in KINDS[kind][2]:
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if name == "T":
            a += np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
        if name in ("p", "pp"):
            a = 10.0 * a * cells
        q = TQ.to_quad(torch.from_numpy(a), shape).numpy()
        out[name] = np.pad(q, ((0, 0), (DEV_HALO, Hq8s - Hq8 + DEV_HALO), (0, 0)))
    return out


def _block(fields, name, jy, P):
    return np.ascontiguousarray(fields[name][..., jy * P : jy * P + P + 2 * DEV_HALO, :])


def _own(a, P):
    return np.asarray(a)[..., DEV_HALO : DEV_HALO + P, :]


@pytest.fixture(scope="module")
def ops():
    """Per kind: the reference's and the port's shard kernels (one reference
    instance each: row_base and the dts are traced arguments), the port's
    single-device adaptive twin, P and the dt pairs."""
    out = {}
    for kind, (shape, coeffs, *_, jmake, tmake) in KINDS.items():
        _, P, _ = TQ.quad_shard_dims(shape, MDY)
        shard = (P, MDY)
        dts = np.float32([DT_CORR * coeffs["dt"], DT_PRED * coeffs["dt"]])
        tc = TCoeffs(**coeffs)
        out[kind] = dict(ref=jmake(JCoeffs(**coeffs), shard), port=tmake(tc, shard),
                         single=tmake(tc, None), P=P, jdts=tuple(dts),
                         tdts=torch.from_numpy(dts))
    return out


def _port_blocks(kind, fields, jy, P):
    return [torch.from_numpy(_block(fields, k, jy, P)) for k in KINDS[kind][2]]


@pytest.mark.parametrize("jy", [0, 1, MDY - 1])
@pytest.mark.parametrize("kind", list(KINDS))
def test_shard_adaptive_twins_match_the_reference_shard_kernels(ops, kind, jy):
    o = ops[kind]
    P, names = o["P"], KINDS[kind][3]
    fields = _fields(kind, 1400 + jy)
    rb = jy * P - DEV_HALO
    want = o["ref"](rb, o["jdts"], *(jnp.asarray(_block(fields, k, jy, P))
                                     for k in KINDS[kind][2]))
    got = o["port"](rb, o["tdts"], *_port_blocks(kind, fields, jy, P))
    assert len(want) == len(got) == len(names)
    w_b = _own(want[names.index("b")], P)
    for name, g, w in zip(names, got, want, strict=True):
        w = np.asarray(w)
        if name in ("us", "vs", "T"):
            np.testing.assert_allclose(_own(g, P), _own(w, P), rtol=0, atol=2e-6, err_msg=name)
        elif name == "b":
            np.testing.assert_allclose(_own(g, P), _own(w, P), rtol=0,
                                       atol=1e-5 * max(float(np.abs(w_b).max()), 1.0))
        elif name == "guess":
            np.testing.assert_array_equal(_own(g, P), _own(w, P))
        elif name == "max_b":
            assert abs(float(g) - float(w)) <= 1e-5 * float(w), (float(g), float(w))
        elif name == "sum_b":
            scale = float(np.abs(w_b).sum())
            assert abs(float(g) - float(w)) <= 1e-5 * scale, (float(g), float(w))
        else:  # mu, mv: 0 on a shard of dead rows
            assert abs(float(g) - float(w)) <= 1e-6 * float(w), (name, float(g), float(w))
    if jy < MDY - 1:
        assert float(got[-2]) > 0 and float(got[-1]) > 0


@pytest.mark.parametrize("kind", list(KINDS))
def test_shard_adaptive_twins_equal_the_single_device_twins_on_own_rows(ops, kind):
    o = ops[kind]
    P, names, shape = o["P"], KINDS[kind][3], KINDS[kind][0]
    Hq8 = TQ.quad_dims(shape)[2]
    fields = _fields(kind, 1500)
    whole = [torch.from_numpy(np.ascontiguousarray(fields[k][..., DEV_HALO : DEV_HALO + Hq8, :]))
             for k in KINDS[kind][2]]
    single = o["single"].plain(o["tdts"], *whole)
    n_fields = len(names) - 3  # the fields, then the partial and (mu, mv)
    parts, mus, mvs = [], [], []
    for jy in range(MDY):  # shard 3 holds dead rows only
        got = o["port"](jy * P - DEV_HALO, o["tdts"], *_port_blocks(kind, fields, jy, P))
        lo, hi = jy * P, max(jy * P, min(jy * P + P, Hq8))
        for k in range(n_fields):
            own = got[k][..., DEV_HALO : DEV_HALO + hi - lo, :]
            assert torch.equal(own, single[k][..., lo:hi, :]), (jy, names[k])
        parts.append(float(got[n_fields]))
        mus.append(float(got[-2]))
        mvs.append(float(got[-1]))
    assert max(mus) == float(single[-2]) and max(mvs) == float(single[-1])
    if kind == "cavity":
        assert max(parts) == float(single[n_fields])
    else:  # the partials add up to the single-device sum, in another float32 order
        scale = float(single[names.index("b")].abs().sum())
        assert abs(sum(parts) - float(single[n_fields])) <= 1e-5 * scale


@pytest.mark.parametrize("kind", list(KINDS))
def test_courant_maxima_ignore_the_halo_rows(ops, kind):
    """us and vs set to 1e3 on a block's halo rows move the outputs near the
    block's edges but not mu and mv: the own rows' corrected velocities read
    us and vs at their own cells only."""
    o = ops[kind]
    P = o["P"]
    fields = _fields(kind, 1600)
    for jy in (0, 1, MDY - 2):
        blocks = _port_blocks(kind, fields, jy, P)
        clean = o["port"](jy * P - DEV_HALO, o["tdts"], *blocks)
        for t in blocks[:2]:
            t[:, :DEV_HALO] = 1e3
            t[:, DEV_HALO + P :] = -1e3
        poisoned = o["port"](jy * P - DEV_HALO, o["tdts"], *blocks)
        assert not torch.equal(poisoned[0], clean[0])
        assert float(poisoned[-2]) == float(clean[-2]) < 1e2, (jy, float(poisoned[-2]))
        assert float(poisoned[-1]) == float(clean[-1]) < 1e2, (jy, float(poisoned[-1]))


def test_the_factories_build_the_shard_adaptive_instances(ops):
    assert isinstance(ops["cavity"]["port"], TQ.QuadCorrPredictorSourceShardAdaptive)
    assert isinstance(ops["channel"]["port"], TQ.QuadChannelCorrPredictorSourceShardAdaptive)
    assert isinstance(ops["rb"]["port"], TR.QuadRBStepShardAdaptive)
    assert isinstance(ops["step"]["port"], TSQ.QuadStepCorrPredictorSourceShardAdaptive)
    tc = TCoeffs(**KINDS["rb"][1])
    with pytest.raises(ValueError, match="emit_guess"):
        TR.make_quad_rb_step_kernel((34, 98), tc, KAPPA, RBParams(1e5, 0.71), emit_guess=True,
                                    adaptive=True, shard=(8, MDY))
    o = ops["cavity"]
    blocks = _port_blocks("cavity", _fields("cavity", 1700), 1, o["P"])
    with pytest.raises(ValueError, match="shape"):
        o["port"](o["P"] - DEV_HALO, o["tdts"][:1], *blocks)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        o["port"](o["P"] - DEV_HALO, o["tdts"].to("meta"), *blocks)
