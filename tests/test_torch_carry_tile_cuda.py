"""The one-launch tile carries of the cavity and Rayleigh-Benard (rows 1, 1+,
10, 10+, 16a, 16a+, 16e, 16e+: csrc/quad_stage.cu cavity_carry_kernel,
csrc/rb_stage.cu rb_carry_kernel and its sum, on csrc/carry_tile.cuh)
against their plain PyTorch twins on the card, at shapes whose tiles
straddle the lid, the walls, the padding and the array's edge, at one
tile covering the whole grid (a plan of the field's own size,
kernels/plan.py carry_plan's ``tile``), at a ragged tile row and at sizes
with interior tiles, and on the first, a middle and the last shard's local
block of a 4-shard mesh.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_carry_tile_cuda.py

Limits: error 0. The tiles run the per-cell bodies' float32 operations in
order on the same operands (--fmad=false), the maxima are exact and the
source sum folds in the twin's order, so every output is held bit for bit
(torch.equal), halo rows of a shard's block included."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.kernels import rb_quad as TR
from cfd_tpu_torch.ops.stencil import StencilCoeffs
from cfd_tpu_torch.physics.boussinesq import RBParams

H = TQ.DEV_HALO
MDY = 4
# the cavity's interior cells a side: one tile with a plan of the field's
# size (16^2 padded: (4, 8, 128)), lid and walls in every tile, a ragged
# last tile row (Hq8 = 152), and tiles that touch no edge beside those that
# do (Wqa = 256)
CAVITY_N = [14, 32, 300, 510]
# RB (nx, ny): one tile ((4, 8, 128)), every tile on an edge, (4, 56, 256)
# and (4, 64, 256) with interior tiles
RB_SIZES = [(126, 14), (48, 16), (300, 110), (510, 126)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fields(shape, n, device, seed, temperature=None):
    """Seeded quad fields (us, vs, p, then p_prev or T) on ``device``; the
    pressure-like fields zero on the ghost ring, T (index ``temperature``)
    a linear profile plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if k == temperature:
            a = a + np.linspace(1.0, 0.0, shape[0], dtype=np.float32)[:, None]
        elif k >= 2:
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
        out.append(TQ.to_quad(torch.from_numpy(a), shape).to(device))
    return out


def _one_tile(op, flow):
    """Give ``op`` the plan of one tile over its whole field."""
    _, Hq8, Wqa = op.qshape
    op._tile_plan = PL.carry_plan(flow, op.qshape, tile=(Hq8, Wqa))
    assert (op._tile_plan.grid_x, op._tile_plan.grid_y) == (1, 1)


def _equal(got, want):
    assert len(got) == len(want)
    for k, (a, w) in enumerate(zip(got, want, strict=True)):
        assert torch.equal(a, w), (k, float((a - w).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("n", CAVITY_N)
def test_cavity_carry_tiles_bit_identical(cuda_device, n, adaptive):
    shape = (n + 2, n + 2)
    c = StencilCoeffs(dx=1.0 / n, dy=1.0 / n, dt=1e-3, viscosity=1e-2)
    op = TQ.make_quad_corr_predictor_source(shape, c, 1.0, adaptive=adaptive)
    if n == CAVITY_N[0]:
        _one_tile(op, "cavity")
    fields = _fields(shape, 4, cuda_device, seed=n)
    kern = TQ.CARRY_ADAPTIVE if adaptive else TQ.CARRY
    args = ((torch.tensor([0.8e-3, 1.1e-3], device=cuda_device),) if adaptive else ()) + tuple(
        fields)
    before = kern.launches
    got, want = op(*args), op.plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["carry", "guess", "adaptive"])
@pytest.mark.parametrize("nx,ny", RB_SIZES)
def test_rb_carry_tiles_bit_identical(cuda_device, nx, ny, variant):
    shape = (ny + 2, nx + 2)
    c = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=1e-3, viscosity=8e-3)
    op = TR.make_quad_rb_step_kernel(shape, c, 1.2e-2, RBParams(1e6, 0.71),
                                     emit_guess=variant == "guess",
                                     adaptive=variant == "adaptive")
    if (nx, ny) == RB_SIZES[0]:
        _one_tile(op, "rb")
    fields = _fields(shape, 5 if variant == "guess" else 4, cuda_device, seed=nx + ny,
                     temperature=3)
    kern = TR.RB_CARRY_ADAPTIVE if variant == "adaptive" else TR.RB_CARRY
    args = ((torch.tensor([0.8e-3, 1.1e-3], device=cuda_device),)
            if variant == "adaptive" else ()) + tuple(fields)
    before = kern.launches
    got, want = op(*args), op.plain(*args)
    again = op(*args)  # the sum's count was left at 0: the same sum again
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    _equal(got, want)
    _equal(again, got)
    assert int(op._sum_counts[str(got[0].device)]) == 0


def _blocks(fields, P, jy):
    Hq8s = P * MDY
    return [torch.nn.functional.pad(f, (0, 0, H, Hq8s - f.shape[1] + H))[
        :, jy * P : jy * P + P + 2 * H].contiguous() for f in fields]


@pytest.mark.cuda
@pytest.mark.parametrize("jy", [0, 1, MDY - 1])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("kind", ["cavity", "rb"])
def test_shard_carry_tiles_bit_identical(cuda_device, kind, adaptive, jy):
    """A shard's block bit for bit against the twin, halo rows included, and
    its own rows against the whole-field kernel's."""
    nx, ny = (256, 256) if kind == "cavity" else (256, 128)
    shape = (ny + 2, nx + 2)
    _, P, _ = TQ.quad_shard_dims(shape, MDY)
    if kind == "cavity":
        c = StencilCoeffs(dx=1.0 / nx, dy=1.0 / ny, dt=1e-3, viscosity=1e-2)
        make = lambda **kw: TQ.make_quad_corr_predictor_source(shape, c, 1.0,
                                                               adaptive=adaptive, **kw)
        kern = TQ.SHARD_CARRY_ADAPTIVE if adaptive else TQ.SHARD_CARRY
        fields = _fields(shape, 4, cuda_device, seed=jy)
        n_fields = 4  # us', vs', b, guess
    else:
        c = StencilCoeffs(dx=3.0 / nx, dy=1.0 / ny, dt=1e-3, viscosity=8e-3)
        make = lambda **kw: TR.make_quad_rb_step_kernel(shape, c, 1.2e-2, RBParams(1e6, 0.71),
                                                        adaptive=adaptive, **kw)
        kern = TR.SHARD_RB_CARRY_ADAPTIVE if adaptive else TR.SHARD_RB_CARRY
        fields = _fields(shape, 4, cuda_device, seed=jy, temperature=3)
        n_fields = 4  # us', vs', T', b
    op, whole = make(shard=(P, MDY)), make()
    dts = (torch.tensor([0.8e-3, 1.1e-3], device=cuda_device),) if adaptive else ()
    blocks = _blocks(fields, P, jy)
    before = kern.launches
    got = op(jy * P - H, *dts, *blocks)
    want = op.plain(jy * P - H, *dts, *blocks)
    single = whole(*dts, *fields)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _equal(got, want)
    Hq8 = fields[0].shape[1]
    own = min(P, Hq8 - jy * P)
    for a, w in zip(got[:n_fields], single[:n_fields]):
        if own > 0:
            assert torch.equal(a[:, H : H + own], w[:, jy * P : jy * P + own])
