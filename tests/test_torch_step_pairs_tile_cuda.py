"""The natural step's exact masked pairs' tile kernel (row 12,
csrc/step_smoother.cu: one launch of shared-memory tiles a call,
kernels/plan.py step_pairs_plan) against its plain PyTorch twin
(kernels/step_smoother.py StepMaskedPairs.plain) on the card, bit for bit
(torch.equal): at the natural step's level 0 (32 x 514, the main path),
phase 27's 512x64 level (66 x 514) and a small step (16 x 66), in the
three variants at n_pairs 1-3; under ragged tiles, tiles whose edges fall
on the solid block's bottom row, the step's corner and the last interior
row and column, and one larger than the small level; the with_residual
variant's running max back at 0 after each call and max|r| right on
back-to-back calls with no memset; and one device operation a call,
counted by torch.profiler in a child process (python -m
cfd_tpu_torch.time_pairs), as chip_smoke.py counts it.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_step_pairs_tile_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import step_smoother as SS

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {"plain": {}, "field": {"with_residual_field": True}, "res": {"with_residual": True}}
# (shape, step_i, inlet_j_max) of the 512x30 (natural, auto rule), 512x64
# and 64x14 steps (poisson.multigrid step_rect_params)
LEVELS = {"512x30": ((32, 514), 128, 15), "512x64": ((66, 514), 128, 32),
          "64x14": ((16, 66), 16, 7)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _op(level, n_pairs, variant, omega=1.0, tile=None):
    shape, step_i, inlet = LEVELS[level]
    nx, ny = shape[1] - 2, shape[0] - 2
    op = SS.make_step_masked_pairs(shape, step_i, inlet, (nx / 8.0) ** 2, (ny / 2.0) ** 2,
                                   omega, n_pairs, device="cuda", **VARIANTS[variant])
    if tile is not None:
        op._tile_plan = PL.step_pairs_plan(shape, n_pairs, variant != "plain", tile=tile)
    return op


def _inputs(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    b = torch.from_numpy((rng.standard_normal(shape) * 10 * scale).astype(np.float32)).cuda()
    return p, b


def _equal(op, p, b):
    got, want = op(p, b), op.plain(p, b)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w), float((g - w).abs().max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("n_pairs", [1, 2, 3])
@pytest.mark.parametrize("level", list(LEVELS))
def test_pairs_bit_identical_under_the_plan(cuda_device, level, n_pairs, variant):
    op = _op(level, n_pairs, variant, omega=1.0 if n_pairs < 3 else 1.15)
    p, b = _inputs(op.shape, [n_pairs, len(variant)])
    kern = op.record
    before = kern.launches
    _equal(op, p, b)
    assert kern.launches == before + 1


# (level, tile): ragged; on the 64x14 step a tile row starting on the
# solid block's bottom row 8 and a tile column on column 17 east of the
# step's corner column 16 (4 x 17), tile rows and columns ending on the
# last interior row 14 and column 64 (5 x 13), a tile corner on the corner
# (8, 16) (8 x 16), one tile over the level (40 x 100); on the natural
# level ragged tiles and a full-height band
TILE_CASES = [("64x14", (3, 5)), ("64x14", (4, 17)), ("64x14", (5, 13)), ("64x14", (8, 16)),
              ("64x14", (40, 100)), ("512x30", (7, 33)), ("512x30", (32, 46)),
              ("512x64", (5, 110))]


@pytest.mark.cuda
@pytest.mark.parametrize("level,tile", TILE_CASES)
def test_pairs_bit_identical_under_other_tiles(cuda_device, level, tile):
    for n_pairs in (1, 2):
        for variant in VARIANTS:
            op = _op(level, n_pairs, variant, tile=tile)
            p, b = _inputs(op.shape, [n_pairs, len(variant), 3])
            _equal(op, p, b)


@pytest.mark.cuda
def test_pairs_with_residual_back_to_back_with_no_memset(cuda_device):
    # three calls on three sources, queued without a synchronisation: each
    # max|r| its own, the running max and the count back at 0 after each
    op = _op("512x30", 2, "res")
    inputs = [_inputs(op.shape, k, scale=10.0 ** k) for k in range(3)]
    got = [op(p, b)[1] for p, b in inputs]
    torch.cuda.synchronize()
    for (p, b), g in zip(inputs, got):
        assert torch.equal(g, op.plain(p, b)[1])
    assert op._max_acc[str(got[0].device)].tolist() == [0, 0]
    assert len({float(g) for g in got}) == 3


@pytest.mark.cuda
def test_pairs_one_launch_a_call(cuda_device):
    # a fresh process: a process's later torch.profiler traces have come
    # back without device events on the H100 machine, its first has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_pairs", "cardtest",
                          "--only", "12,12-res", "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    assert {r["row"]: r["launches_a_call"] for r in lines} == {"12": 1, "12-res": 1}, lines
