"""The whole time step in one cooperative launch (csrc/whole_step.cu) on the
card, for the four flavors: each kernel against its plain twin (the port's
own composition carry -> mean removal -> whole-solve twin) at a small and at
the full width, under two carry tiles besides the default at the full width
(kernels/plan.py whole_step_plan's ``tile``; the walk's last round of tiles
partial) and at a size whose every tile touches a wall, whole_step on
against off over 20 steps, the card against the CPU over 20 steps, the
fresh (cycles, res) of every call, and one launch a step.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_whole_step_cuda.py

Limits: the kernel is built with --fmad=false and repeats its twin's
float32 operations in order, so fields are bit-identical and the cycles
equal; card against CPU, fields within 5e-5 of their scale and equal
cycles (the chip_smoke.py limits)."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.convert import state_from_numpy
from cfd_tpu_torch.kernels import KERNELS
from cfd_tpu_torch.kernels import plan as PL
from cfd_tpu_torch.kernels import whole_step as WS
from cfd_tpu_torch.solver import Simulation

FLOWS = {
    "cavity": (make_cavity_case, lambda n: dict(n_interior=n, poisson="multigrid",
                                                tolerance_factor=1e-6),
               {"small": (256,), "full": (2048,)}, WS.WHOLE_STEP_CAVITY),
    "channel": (make_channel_case, lambda nx, ny: dict(nx=nx, ny=ny, poisson="multigrid",
                                                       tolerance_factor=1e-6, abs_tol=0.0),
                {"small": (256, 128), "full": (1536, 512)}, WS.WHOLE_STEP_CHANNEL),
    "rb": (make_rayleigh_benard_case, lambda nx, ny: dict(nx=nx, ny=ny, rayleigh=1e6),
           {"small": (256, 128), "full": (1536, 512)}, WS.WHOLE_STEP_RB),
    "step": (make_backwards_step_case, lambda nx, ny: dict(nx=nx, ny=ny,
                                                           poisson="multigrid",
                                                           tolerance_factor=1e-6,
                                                           abs_tol=0.0),
             {"small": (512, 64), "full": (2048, 256)}, WS.WHOLE_STEP_STEP),
}
# sizes at which every carry tile's staged box reaches a wall, a ghost row
# or column or the array's edge (the tiles' ghost-aware path)
WALLS = {"cavity": (32,), "channel": (64, 32), "rb": (48, 16), "step": (64, 16)}
# carry tiles besides the default (plane rows, columns): ragged at the full
# widths, and their counts leave the blocks' last round partial
TILES = [(6, 24), (12, 40)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(flow, size, device, **ov):
    make, kw, sizes, _ = FLOWS[flow]
    dims = WALLS[flow] if size == "walls" else sizes[size]
    return make(dtype=torch.float32, device=device, print_interval=20, **kw(*dims), **ov)


def _holds_twin(ws, fields):
    """One launch of ``ws`` bit-identical to its twin, equal cycles and res."""
    got = ws.kernel(*fields)
    torch.cuda.synchronize()
    want = ws.plain(*fields)
    assert int(got[-2]) == int(want[-2])
    assert float(got[-1]) == float(want[-1])
    for a, b in zip(got[:-2], want[:-2], strict=True):
        assert torch.equal(a, b)


def _touches_wall(plan: PL.CarryPlan, qshape, ny: int, nx: int) -> bool:
    """Whether every tile's staged box (its own cells and the halo, in
    logical rows and columns) reaches row 0 or ny + 1, column 0 or nx + 1,
    or the array's edge."""
    _, Hq8, Wqa = qshape
    for ty in range(plan.grid_y):
        for tx in range(plan.grid_x):
            r0, r1 = 2 * (ty * plan.rows - plan.halo), 2 * ((ty + 1) * plan.rows + plan.halo)
            c0, c1 = 2 * (tx * plan.cols - plan.halo), 2 * ((tx + 1) * plan.cols + plan.halo)
            inside = r0 >= 1 and r1 - 1 <= ny and c0 >= 1 and c1 - 1 <= nx
            if inside and r1 <= 2 * Hq8 and c1 <= 2 * Wqa:
                return False
    return True


def _fields(case, seed):
    """The case's carried fields from its initial logical state with seeded
    noise on u, v and p over the fluid cells."""
    sim = Simulation(case, log=lambda m: None)
    st = sim._logical(sim.initial_state())
    rng = np.random.default_rng(seed)
    mask = np.asarray(case.grid.cell_mask, dtype=np.float32)
    f = {k: getattr(st, k).cpu().numpy().copy()
         for k in ("u", "v", "p", "T", "p_prev") if getattr(st, k) is not None}
    for k, scale in (("u", 0.05), ("v", 0.05), ("p", 0.01)):
        f[k] = f[k] + (scale * rng.standard_normal(f[k].shape) * mask).astype(np.float32)
    s = case.align_state(state_from_numpy(f["u"], f["v"], f["p"], f.get("p_prev"),
                                          f.get("T"), device=case.device))
    if case.ordering == "rayleigh_benard":
        return (s.u, s.v, s.p, s.T)
    return (s.u, s.v, s.p) if s.p_prev is None else (s.u, s.v, s.p, s.p_prev)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_whole_step_kernel_matches_twin(cuda_device, flow, size):
    case = _case(flow, size, cuda_device, mg_overrides={"whole_step": True})
    ws, counter = case.whole_step_kernel, FLOWS[flow][3]
    fields = _fields(case, seed=17)
    before = counter.launches
    got = ws(*fields)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = ws.plain(*fields)
    assert int(got[-2]) == int(want[-2])
    assert float(got[-1]) == float(want[-1])
    for a, b in zip(got[:-2], want[:-2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_whole_step_carry_tiles_match_twin(cuda_device, flow, tile):
    case = _case(flow, "full", cuda_device, mg_overrides={"whole_step": True})
    ws = case.whole_step_kernel
    ws.plan = PL.whole_step_plan(ws.FLOW, ws.solver.plan, ws.qshape, tile=tile)
    c = ws.plan.carry
    assert (c.rows, c.cols) == tile
    tiles = [PL.whole_step_plan(ws.FLOW, ws.solver.plan, ws.qshape, tile=t).carry
             for t in TILES]
    assert any((p.grid_x * p.grid_y) % ws.plan.solve.blocks for p in tiles)
    _holds_twin(ws, _fields(case, seed=29))


@pytest.mark.cuda
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_whole_step_every_tile_on_a_wall_matches_twin(cuda_device, flow):
    case = _case(flow, "walls", cuda_device, mg_overrides={"whole_step": True})
    ws = case.whole_step_kernel
    assert _touches_wall(ws.plan.carry, ws.qshape, case.grid.ny, case.grid.nx)
    _holds_twin(ws, _fields(case, seed=31))


@pytest.mark.cuda
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_whole_step_on_against_off_on_card(cuda_device, flow):
    runs = []
    for ws in (True, False):
        case = _case(flow, "small", cuda_device, mg_overrides={"whole_step": ws} if ws
                     else None)
        sim = Simulation(case, log=lambda m: None)
        st = sim.run(n_steps=20)
        runs.append((sim.step_iters, sim._logical(st)))
    (it_on, s_on), (it_off, s_off) = runs
    assert it_on == it_off
    for name in ("u", "v", "p", "T"):
        a, b = getattr(s_on, name), getattr(s_off, name)
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_whole_step_card_against_cpu(cuda_device, flow):
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulation(_case(flow, "small", dev, mg_overrides={"whole_step": True}),
                         log=lambda m: None)
        st = sim.run(n_steps=20)
        runs.append((sim.step_iters, sim._logical(st)))
    (it_g, s_g), (it_c, s_c) = runs
    assert it_g == it_c
    for name in ("u", "v", "p", "T"):
        a, b = getattr(s_g, name), getattr(s_c, name)
        if b is not None:
            a = a.cpu()
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= 5e-5 * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_one_launch_a_step_and_fresh_stats(cuda_device, flow):
    case = _case(flow, "small", cuda_device, mg_overrides={"whole_step": True})
    counter = FLOWS[flow][3]
    sim = Simulation(case, log=lambda m: None)
    state = sim.initial_state()
    state, first = sim._step(state)
    torch.cuda.synchronize()
    kept = (int(first.poisson_iters), float(first.poisson_residual))
    before = {k.name: k.launches for k in KERNELS}
    for _ in range(10):
        state, _ = sim._step(state)
    torch.cuda.synchronize()
    after = {k.name: k.launches for k in KERNELS}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {counter.name: 10}
    assert (int(first.poisson_iters), float(first.poisson_residual)) == kept
    grid = WS.launch_grid(case.whole_step_kernel.FLAVOR)
    assert grid["blocks"] >= grid["blocks_per_sm"] >= 1
