"""The separable finest-level tile kernels (csrc/quad_vcycle.cu: rows 3, 4
and their shard rows 16b, 16c, one launch of shared-memory tiles a call,
kernels/plan.py level0_plan with masked=False) against their unedited
plain PyTorch twins (kernels/quad.py QuadPreSmoothRestrict.plain,
QuadPostProlongSmooth.plain and their Shard twins) on the card, bit for
bit (torch.equal): at the whole fields of the 2048^2 cavity, the 1536x512
channel and the 1536x512 Rayleigh-Benard cell and at their 4-shard blocks
(shards 0, 1 and 3), at n_pairs 1 and 2; under tiles whose edges fall on
the interior's last row and column, ragged tiles and one larger than the
field; the post kernel's running max and count back at 0 after each call;
and one device operation a call, counted by torch.profiler in a child
process (python -m cfd_tpu_torch.time_level0), as chip_smoke.py counts it.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_quad_level0_tile_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import quad as TQ
from cfd_tpu_torch.poisson import multigrid as TM

ROOT = Path(__file__).resolve().parent.parent
H = TQ.DEV_HALO
# (flow, nx, ny): the main widths of the three separable flows
FLOWS = [("cavity", 2048, 2048), ("channel", 1536, 512), ("rb", 1536, 512)]
PROBLEMS = {"cavity": TM.cavity_problem, "channel": TM.channel_problem,
            "rb": TM.neumann_problem}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ops(flow, nx, ny, n_pairs, device, mdy=None, tile=None):
    """Fresh pre and post ops of ``flow`` at nx x ny (a whole field, or with
    ``mdy`` one shard's block of an mdy-way mesh) at n_pairs, under
    ``tile`` (None: the plan's own)."""
    shape = (ny + 2, nx + 2)
    prob = PROBLEMS[flow](nx, ny, 1.0 / nx, 1.0 / ny)
    _, _, Hq8, W = TQ.quad_dims(shape)
    shard, coarse = None, (Hq8, W)
    if mdy is not None:
        _, P, _ = TQ.quad_shard_dims(shape, mdy)
        shard, coarse = (P, mdy), (P + 2 * H, W)
    pre = TQ.make_quad_pre_smooth_restrict(shape, prob, 1.0, n_pairs, coarse, device, shard)
    post = TQ.make_quad_post_prolong_smooth(shape, prob, 1.0, n_pairs, coarse, device, shard)
    if tile is not None:
        for op, post_ in ((pre, False), (post, True)):
            op._tile_plan = PL.level0_plan(op.qshape, n_pairs, post_, block=mdy is not None,
                                           masked=False, tile=tile)
    return pre, post, shape


def _fields(shape, seed, device, mdy=None, jy=0):
    """Seeded p, b (b 0 on the ghost ring) and ec (on the coarse interior),
    whole or shard jy's block of an mdy-way mesh."""
    rng = np.random.default_rng(seed)
    ny, nx = shape[0] - 2, shape[1] - 2
    p = TQ.to_quad(torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)),
                   shape)
    a = (rng.standard_normal(shape) * 1e2).astype(np.float32)
    a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
    b = TQ.to_quad(torch.from_numpy(a), shape)
    _, _, Hq8, W = TQ.quad_dims(shape)
    ec = torch.zeros(Hq8, W)
    ec[1 : ny // 2 + 1, 1 : nx // 2 + 1] = torch.from_numpy(
        (rng.standard_normal((ny // 2, nx // 2)) * 0.1).astype(np.float32))
    if mdy is not None:
        Hq8s, P, _ = TQ.quad_shard_dims(shape, mdy)

        def block(t):
            t = torch.nn.functional.pad(t, (0, 0, H, Hq8s - Hq8 + H))
            return t[..., jy * P : jy * P + P + 2 * H, :].contiguous()

        p, b, ec = block(p), block(b), block(ec)
    return p.to(device), b.to(device), ec.to(device)


def _hold(pre, post, p, b, ec, row_base=None):
    """Each op once on the card against its twin, bit for bit, one count a
    call, the post's accumulator back at 0."""
    args = () if row_base is None else (row_base,)
    kerns = (TQ.PRE, TQ.POST) if row_base is None else (TQ.SHARD_PRE, TQ.SHARD_POST)
    before = [k.launches for k in kerns]
    pairs = [(pre(*args, p, b), pre.plain(*args, p, b)),
             (post(*args, p, b, ec), post.plain(*args, p, b, ec))]
    torch.cuda.synchronize()
    assert [k.launches for k in kerns] == [x + 1 for x in before]
    for got, want in pairs:
        for a, w in zip(got, want, strict=True):
            assert torch.equal(a, w), float((a - w).abs().max())
    assert post._max_acc[str(p.device)].tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 2])
@pytest.mark.parametrize("flow,nx,ny", FLOWS)
def test_field_tiles_match_plain_bit_for_bit(cuda_device, flow, nx, ny, n_pairs):
    pre, post, shape = _ops(flow, nx, ny, n_pairs, cuda_device)
    p, b, ec = _fields(shape, nx + n_pairs, cuda_device)
    _hold(pre, post, p, b, ec)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 2])
@pytest.mark.parametrize("flow,nx,ny", FLOWS)
def test_block_tiles_match_plain_bit_for_bit(cuda_device, flow, nx, ny, n_pairs):
    pre, post, shape = _ops(flow, nx, ny, n_pairs, cuda_device, mdy=4)
    P = pre.qshape[1] - 2 * H
    for jy in (0, 1, 3):
        p, b, ec = _fields(shape, 10 * jy + n_pairs, cuda_device, mdy=4, jy=jy)
        _hold(pre, post, p, b, ec, row_base=jy * P - H)


# 64^2 (plane rows 0..39, the last interior row 64 in plane row 32, the
# last interior column in plane column 32): 16 x 32 tiles put a tile edge
# on both; ragged and single-tile plans beside them
SMALL_TILES = [(16, 32), (5, 24), (3, 7), (1000, 5000)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 2])
@pytest.mark.parametrize("tile", SMALL_TILES)
def test_field_tiles_under_other_plans(cuda_device, tile, n_pairs):
    pre, post, shape = _ops("cavity", 64, 64, n_pairs, cuda_device, tile=tile)
    p, b, ec = _fields(shape, 7 + n_pairs, cuda_device)
    _hold(pre, post, p, b, ec)
    if tile == (1000, 5000):
        assert (pre._tile_plan.grid_x, pre._tile_plan.grid_y) == (1, 1)


# 128^2 on 4 shards: P = 24, blocks of 40 plane rows; the last interior
# row (logical 128, plane row 64) is shard 2's local row 24, an edge of
# 8-row tiles, and the last interior column an edge of 32-wide ones
BLOCK_TILES = [(8, 32), (5, 24), (3, 7), (1000, 5000)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", BLOCK_TILES)
def test_block_tiles_under_other_plans(cuda_device, tile):
    pre, post, shape = _ops("cavity", 128, 128, 2, cuda_device, mdy=4, tile=tile)
    P = pre.qshape[1] - 2 * H
    assert P == 24
    for jy in (0, 1, 2, 3):
        p, b, ec = _fields(shape, 30 + jy, cuda_device, mdy=4, jy=jy)
        _hold(pre, post, p, b, ec, row_base=jy * P - H)


@pytest.mark.cuda
def test_post_leaves_its_accumulator_at_zero(cuda_device):
    pre, post, shape = _ops("channel", 1536, 512, 2, cuda_device)
    p, b, ec = _fields(shape, 3, cuda_device)
    for _ in range(3):
        got, want = post(p, b, ec), post.plain(p, b, ec)
        assert torch.equal(got[1], want[1])
        assert post._max_acc[str(p.device)].tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["3", "4", "16b", "16c", "3-ch", "4-ch", "16b-ch", "16c-ch"])
def test_one_launch_a_call(cuda_device, row):
    # a fresh process for each row: a process's later torch.profiler traces
    # have come back without device events on the H100 machine, its first
    # has not
    out = subprocess.run([sys.executable, "-m", "cfd_tpu_torch.time_level0", "cardtest",
                          "--only", row, "--reps", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [r["row"] for r in lines] == [row]
    kernel = "sep_post_kernel" if row.startswith(("4", "16c")) else "sep_pre_kernel"
    assert lines[0]["launches_a_call"] == 1 and kernel in lines[0]["ops"][0], lines[0]
