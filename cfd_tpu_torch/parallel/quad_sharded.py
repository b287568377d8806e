"""The quad path of the cavity, the channel, Rayleigh-Benard and the
backward-facing step on a plane-row mesh (the port of
cfd_tpu.parallel.quad_sharded).

Decomposition (cfd_tpu/parallel/quad_sharded.py:1-33): 1-D over the quad
PLANE ROWS (kernels.quad.quad_shard_dims). Shard jy owns P plane rows (P a
multiple of 8) and carries them as a local (4, P + 16, Wqa) block between
two DEV_HALO-row strips, refreshed from its neighbours between kernel
calls; the kernels take row_base = jy * P - DEV_HALO, the global plane row
of local row 0, so their masks, bands and weight vectors keep their global
meaning (kernels.quad *Shard, kernels.rb_quad QuadRBStepShard and
kernels.step_quad *Shard: the single-device kernels' entry points in
csrc/quad_stage.cu, csrc/quad_vcycle.cu, csrc/rb_stage.cu,
csrc/step_stage.cu and csrc/step_vcycle.cu, told the block's row_base and
halo). The 8-row halo is the TPU kernels' slab halo, so the band
bookkeeping that absorbs slab-edge staleness absorbs shard-edge staleness.

The mesh is single-controller (parallel.mesh): one process drives every
shard. The halo refresh copies the 8-row strips between neighbouring
shards' tensors (a device copy when they share a card) and fills zeros at
the outer edges, as the reference's ppermute does; the reductions take each
shard's 0-d partial to shard 0's device (parallel.halo): the source mean of
the channel, RB and the step (over the fluid cells) from the carries'
own-row sums, and RB's per-cycle mean pin from the own-row sums of p, each
added in shard order (global_sum).

A V-cycle: the finest level's pre and post kernels on every shard; level 1
as torch glue on the local blocks with the reference's band bookkeeping
(the 8-row halo covers V(2,1)'s 2 * (2 + 1) + 1 = 7 rows with no mid-level
exchange), in the float32 expression of the single-device smoother's twin
(kernels.rb_smoother.RBPairs.plain); then the level-1 residual's own rows
are gathered on shard 0's device, levels 2 and below run ONCE there (the
single-device solve's smoothers, transfers and coarsest pinv, or the fused
tail from ``tail_from``), and every shard takes its slice of the
prolonged correction. The reference runs that tail replicated on every
device; running it once gives the same values. Per cycle: three refreshes
(p, rc, ec), the gather and the max of the residual partials. The
tolerance loop is the single-device solve's (poisson.multigrid
tolerance_loop, one host read of the residual a cycle). The step's masked
defect correction (ShardedMaskedStepSolve) is the same cycle with the
exact masked finest level (V(1,1), the 8-row halo's budget), the level-1
weights as full 2-D blocks, the level-1 correction solid-filled between two
refreshes, and, on a grid that coarsens only once, the whole coarse solve
on shard 0 from the gathered level-1 source.

Every shard's own rows then equal the single-device per-kernel solve's
with the float32 coarse hierarchy, bit for bit where the two run the same
float32 operations: the cavity (tests/test_torch_quad_sharded.py). The
channel's, RB's and the step's source sums, and RB's pin, add per-shard
partials, a different float32 order from the single-device sum: those runs
equal the single-device path with its sums taken in the shards' order
(chip_smoke.shard_order_case) and hold to the reference's bands of the
plain one over the reference test's steps
(tests/test_torch_quad_sharded_flavors.py,
tests/test_torch_quad_sharded_step.py). The same holds for the lagged
adaptive runs (ShardedQuadProjection.make_adaptive, driven by
cfd_tpu_torch.adaptive.run_adaptive), whose dt sequence follows from the
shards' own-row Courant maxima (tests/test_torch_quad_sharded_adaptive*.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cfd_tpu_torch.kernels.mg_tail import (
    MGTail,
    _prolong,
    _restrict,
    _solid_fill,
    run_tail_vcycle,
)
from cfd_tpu_torch.kernels.quad import (
    DEV_HALO,
    from_quad,
    make_quad_channel_corr_predictor_source,
    make_quad_channel_corrector,
    make_quad_corr_predictor_source,
    make_quad_corrector,
    make_quad_post_prolong_smooth,
    make_quad_pre_smooth_restrict,
    own_row_sum,
    quad_dims,
    quad_shard_dims,
    to_quad,
    uncorrect_quad,
)
from cfd_tpu_torch.kernels.rb_quad import make_quad_rb_step_kernel
from cfd_tpu_torch.kernels.step_quad import (
    make_quad_step_corr_predictor_source,
    make_quad_step_corrector,
    make_quad_step_post_prolong_smooth,
    make_quad_step_pre_smooth_restrict,
    uncorrect_step_quad,
)
from cfd_tpu_torch.parallel.halo import global_max, global_sum
from cfd_tpu_torch.poisson import multigrid as M
from cfd_tpu_torch.state import State, StepDiagnostics


def _refresh(xs: list, P: int) -> list:
    """Refresh the DEV_HALO-row halo strips of the shards' local blocks in
    place (rows are the second-to-last axis: (4, P + 16, W) quad and
    (P + 16, W) level-1 blocks): shard jy's bottom strip takes shard jy-1's
    last 8 own rows, its top strip shard jy+1's first 8; the outer strips
    take zeros, as ppermute's fill (cfd_tpu/parallel/quad_sharded.py:93).
    A 1-shard mesh is left as it is."""
    mdy, h = len(xs), DEV_HALO
    if mdy == 1:
        return xs
    for jy, x in enumerate(xs):
        low, high = x[..., :h, :], x[..., P + h :, :]
        if jy > 0:
            low.copy_(xs[jy - 1][..., P : P + h, :])
        else:
            low.zero_()
        if jy < mdy - 1:
            high.copy_(xs[jy + 1][..., h : 2 * h, :])
        else:
            high.zero_()
    return xs


@functools.lru_cache(maxsize=64)
def _local_cells(shape: tuple, rb: int, ny: int, nx: int, device,
                 step_rect: tuple[int, int] | None = None) -> torch.Tensor:
    """The interior cells of a local (4, rows, W) quad block at global plane
    row rb, by global index: jj = 2 (rb + local row) + (q >> 1), ii = 2 col
    + (q & 1) in 1..ny, 1..nx; with ``step_rect`` = (step_i, inlet_j) the
    fluid ones, outside the step's solid rectangle."""
    q = torch.arange(4, device=device)[:, None, None]
    rows = torch.arange(shape[1], device=device)[None, :, None]
    cols = torch.arange(shape[2], device=device)[None, None, :]
    jj = 2 * (rb + rows) + (q >> 1)
    ii = 2 * cols + (q & 1)
    cell = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx)
    if step_rect is not None:
        step_i, inlet_j = step_rect
        cell = cell & ~((ii <= step_i) & (jj > inlet_j))
    return cell


def _sub_mean_local(b: torch.Tensor, mean: torch.Tensor, rb: int, ny: int, nx: int,
                    step_rect: tuple[int, int] | None = None):
    """b - mean on the globally indexed interior cells of a local quad block
    (cfd_tpu/parallel/quad_sharded.py:154-171): halo rows get the treatment
    of their owning shard, so they stay consistent with no extra refresh,
    and the outer shards' dead rows fall outside 1..ny. ``step_rect`` =
    (step_i, inlet_j): the fluid cells only (the step's fluid-only mean,
    backwards_step-01.cpp:843-865)."""
    cells = _local_cells(tuple(b.shape), int(rb), ny, nx, b.device,
                         None if step_rect is None else tuple(step_rect))
    return torch.where(cells, b - mean, b)


def _row_vec_global(w_full: np.ndarray, ny: int, length: int) -> np.ndarray:
    """(length, 1) globally indexed row vector with a DEV_HALO zero prefix:
    v[DEV_HALO + g] = w_full[g, 1] for rows g in 1..ny, 0 elsewhere (:144)."""
    v = np.zeros(length)
    v[DEV_HALO + 1 : DEV_HALO + ny + 1] = w_full[1 : ny + 1, 1]
    return v.reshape(length, 1)


class ShardedQuadSolve:
    """``solve(guess, b, max_b) -> (p, cycles, res)`` over a mesh's shards
    (cfd_tpu/parallel/quad_sharded.py make_sharded_quad_solve, :174-401).
    ``guess`` and ``b`` are lists of the shards' local (4, P + 16, Wqa)
    blocks with fresh halos, ``max_b`` the global max|b| (a 0-d tensor); p
    comes back with fresh halos, cycles an int and res the global max|b -
    A p| as a host float.

    ``pin_mean`` (the reference's builder argument, which only
    Rayleigh-Benard passes; ``cfg.pin_mean`` is not read): after each
    cycle's post-smooth and refresh, p - mean on the globally indexed
    interior cells, the mean being the sum of every shard's own rows (all
    four planes and every column, ghost cells included, :367-369, :391-392;
    own_row_sum's fixed order on each shard) added in shard order and
    divided by nx * ny. ``res`` is the post kernel's, taken before the pin.

    ``levels`` holds the aligned levels by their global index (level 1 the
    quad plane shape), ``mg`` their smoothers (``mg.pre[k]`` and
    ``mg.post[k]`` of level k + 1), pinv and coarse solve, on shard 0's
    device."""

    def __init__(self, problem: M.PoissonProblem, cfg: M.MGConfig, shape, devices,
                 pin_mean: bool = False):
        self._setup(cfg, shape, devices)
        cfg, loc, shard = self.cfg, (self.P + 2 * DEV_HALO, self.W), (self.P, len(devices))
        pre, post = {}, {}
        for d in dict.fromkeys(self.devices):  # one copy of the weights per device
            pre[d] = make_quad_pre_smooth_restrict(shape, problem, cfg.omega, cfg.pre_sweeps,
                                                   loc, device=d, shard=shard)
            post[d] = make_quad_post_prolong_smooth(shape, problem, cfg.omega,
                                                    cfg.post_sweeps, loc, device=d,
                                                    shard=shard)
        self.pre = [pre[d] for d in self.devices]
        self.post = [post[d] for d in self.devices]

        # the hierarchy below the quad level: the single-device solve's
        # aligned levels, smoothers and pinv, on shard 0's device
        probs = M.build_problems(problem, cfg)
        if len(probs) < 3:
            raise ValueError("sharded quad multigrid needs >= 3 levels")
        self.mg = M.MultigridPoisson(problem, dataclasses.replace(cfg, tail_from=None),
                                     quad_level0=(None, None), device=self.devices[0])
        self.levels = list(self.mg.levels)
        self._finish(probs[1])
        self.pin_mean = pin_mean
        self.ny, self.nx = problem.ny, problem.nx
        self._n_int = torch.tensor(float(problem.nx * problem.ny), dtype=torch.float32,
                                   device=self.devices[0])

    def _setup(self, cfg: M.MGConfig, shape, devices) -> None:
        """The config and the mesh geometry: P, Hq8s, W, Hq8 and the shards'
        row_base."""
        if cfg.whole_solve or cfg.whole_step:
            raise ValueError("whole_solve/whole_step are single-device only (the sharded "
                             "path fuses the coarse tail via tail_from instead)")
        self.cfg = dataclasses.replace(cfg, pin_mean=False)
        self.devices = list(devices)
        mdy = len(self.devices)
        Hq8s, P, W = quad_shard_dims(shape, mdy)
        self.P, self.Hq8s, self.W = P, Hq8s, W
        self.Hq8 = quad_dims(shape)[2]
        self.row_base = [jy * P - DEV_HALO for jy in range(mdy)]

    def _finish(self, p1: M.PoissonProblem) -> None:
        """The fused tail and the shards' level-1 constants, once ``levels``
        and ``mg`` exist."""
        levels, cfg = self.levels, self.cfg
        if levels[1].shape != (self.Hq8, self.W):
            raise ValueError(f"aligned level-1 shape {levels[1].shape} != quad plane shape "
                             f"{(self.Hq8, self.W)}")
        # the fused tail from GLOBAL level tail_from, clamped to level 2, the
        # first replicated one (:315-329, :460-466)
        self.tail_at, self.tail = None, None
        if cfg.tail_from is not None:
            g = max(2, cfg.tail_from)
            if g <= len(levels) - 2:
                self.tail_at = g
                self.tail = MGTail(levels[g:], self.mg.pre[g - 1 :], self.mg.post[g - 1 :],
                                   self.mg.pinv)
        self._l1 = [self._l1_geom(jy, p1, levels[1], d) for jy, d in enumerate(self.devices)]

    def _l1_weights(self, jy: int, p1: M.PoissonProblem, L1, device):
        """(wE, wW, wN, wS) of shard jy's local level-1 block: the level's
        column vectors and the global row vectors' slice (:240-265)."""
        H = self.P + 2 * DEV_HALO
        length = self.Hq8s + 2 * DEV_HALO
        sl = lambda w: torch.as_tensor(
            _row_vec_global(w, p1.ny, length)[jy * self.P : jy * self.P + H],
            dtype=torch.float32, device=device)
        return L1.wE.to(device), L1.wW.to(device), sl(p1.wN), sl(p1.wS)

    def _l1_geom(self, jy: int, p1: M.PoissonProblem, L1, device) -> dict:
        """The level-1 constants of shard jy's local (P + 16, W) block: the
        interior and colour masks, the inverse diagonal, the weights and the
        band of each half-sweep count (:240-265); on a masked (full-2D)
        level the interior excludes the decoupled cells, denom == 0
        (:509-531)."""
        P, mdy = self.P, len(self.devices)
        H, W = P + 2 * DEV_HALO, self.W
        lr = torch.arange(H, device=device)[:, None]
        lc = torch.arange(W, device=device)[None, :]
        gj = jy * P - DEV_HALO + lr  # global level-1 row
        geo = (gj >= 1) & (gj <= p1.ny) & (lc >= 1) & (lc <= p1.nx)
        even = ((gj + lc) % 2) == 0
        wE, wW, wN, wS = self._l1_weights(jy, p1, L1, device)
        idx2, idy2 = L1.idx2, L1.idy2
        denom = idx2 * (wE + wW) + idy2 * (wN + wS)
        interior = geo if L1.separable else geo & (denom > 0)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        inv = torch.where(interior, 1.0 / safe, torch.zeros_like(safe))
        n_rows = 2 * (self.cfg.pre_sweeps + self.cfg.post_sweeps) + 1
        bands = {k: (lr >= (0 if jy == 0 else k)) & (lr < (H if jy == mdy - 1 else H - k))
                 for k in range(1, n_rows + 1)}
        return dict(geo=geo, interior=interior, red=interior & even, black=interior & ~even,
                    inv=inv, w=(wE, wW, wN, wS), idx2=idx2, idy2=idy2, band=bands)

    def _l1_half(self, e, r, mask, g):
        """One masked Gauss-Seidel half-sweep, RBPairs.plain's expression."""
        wE, wW, wN, wS = g["w"]
        pE, pW = torch.roll(e, -1, dims=1), torch.roll(e, 1, dims=1)
        pN, pS = torch.roll(e, -1, dims=0), torch.roll(e, 1, dims=0)
        gs = (g["idx2"] * (wE * pE + wW * pW) + g["idy2"] * (wN * pN + wS * pS) - r) * g["inv"]
        return torch.where(mask, e + self.cfg.omega * (gs - e), e)

    def _l1_residual(self, e, r, g, consumed: int):
        wE, wW, wN, wS = g["w"]
        pE, pW = torch.roll(e, -1, dims=1), torch.roll(e, 1, dims=1)
        pN, pS = torch.roll(e, -1, dims=0), torch.roll(e, 1, dims=0)
        ap = (g["idx2"] * (wE * (pE - e) + wW * (pW - e))
              + g["idy2"] * (wN * (pN - e) + wS * (pS - e)))
        return torch.where(g["interior"] & g["band"][consumed + 1], r - ap,
                           torch.zeros_like(r))

    def _l1_pairs(self, e, rc, g, k: int, n_pairs: int):
        for _ in range(n_pairs):
            e = self._l1_half(e, rc, g["red"] & g["band"][k + 1], g)
            e = self._l1_half(e, rc, g["black"] & g["band"][k + 2], g)
            k += 2
        return e, k

    def _coarse(self, b: torch.Tensor, first: int = 2) -> torch.Tensor:
        """The correction on global level ``first`` from its source: the
        single-device coarse V-cycle from there down (run_tail_vcycle),
        with the fused tail solving from ``tail_at``."""
        mg, levels = self.mg, self.levels
        if self.tail is None:
            return run_tail_vcycle(levels[first:], b, mg.pre[first - 1 :],
                                   mg.post[first - 1 :], mg.coarse_solve)
        return run_tail_vcycle(levels[first : self.tail_at + 1], b, mg.pre[first - 1 :],
                               mg.post[first - 1 :], self.tail)

    def _gather(self, xs: list) -> torch.Tensor:
        """The shards' own level-1 rows as the global (Hq8, W) level on shard
        0's device."""
        dev0, P = self.devices[0], self.P
        return torch.cat([x[DEV_HALO : DEV_HALO + P].to(dev0) for x in xs])[: self.Hq8]

    def _slices(self, ef: torch.Tensor) -> list:
        """A global (Hq8, W) level-1 field -> the shards' local blocks, halo
        rows included (every shard slices the same array)."""
        P = self.P
        ef = torch.nn.functional.pad(ef, (0, 0, DEV_HALO, self.Hq8s + DEV_HALO - self.Hq8))
        return [ef[jy * P : jy * P + P + 2 * DEV_HALO].to(d)
                for jy, d in enumerate(self.devices)]

    def level1(self, rc: list) -> list:
        """The level-1 correction of every shard from its fresh-haloed local
        source (:331-362): pre pairs and residual on the local blocks, the
        own rows gathered, levels 2 and below once, the slice of the
        prolonged correction added, post pairs. Own rows exact; the halos
        are stale by the band (the caller refreshes)."""
        cfg, levels = self.cfg, self.levels
        es, r1 = [], []
        for r, g in zip(rc, self._l1, strict=True):
            e, k = self._l1_pairs(torch.zeros_like(r), r, g, 0, cfg.pre_sweeps)
            es.append(e)
            r1.append(self._l1_residual(e, r, g, k))
        e2 = self._coarse(_restrict(levels[1], levels[2], self._gather(r1)))
        out = []
        for e, r, g, ef in zip(es, rc, self._l1, self._slices(_prolong(levels[2], levels[1], e2)),
                               strict=True):
            e, _ = self._l1_pairs(e + ef, r, g, 2 * cfg.pre_sweeps, cfg.post_sweeps)
            out.append(e)
        return out

    def _correction(self, rc: list) -> list:
        """The level-1 correction of every shard, halos fresh, from the pre
        kernels' local sources."""
        return _refresh(self.level1(_refresh(rc, self.P)), self.P)

    def cycle(self, p: list, b: list):
        """One V-cycle from the finest level: (p, b) -> (p, res), p's halos
        fresh, res the global max|b - A p| (a 0-d tensor)."""
        P, rb = self.P, self.row_base
        outs = [pre(r, x, y) for pre, r, x, y in zip(self.pre, rb, p, b, strict=True)]
        p = _refresh([o[0] for o in outs], P)
        ec = self._correction([o[1] for o in outs])
        outs = [post(r, x, y, e) for post, r, x, y, e in zip(self.post, rb, p, b, ec,
                                                             strict=True)]
        p = _refresh([o[0] for o in outs], P)
        res = global_max([o[1] for o in outs])
        if self.pin_mean:
            mean = global_sum([own_row_sum(x, P) for x in p]) / self._n_int
            p = [_sub_mean_local(x, mean.to(x.device), r, self.ny, self.nx)
                 for x, r in zip(p, rb, strict=True)]
        return p, res

    def __call__(self, guess: list, b: list, max_b: torch.Tensor):
        return M.tolerance_loop(guess, b, max_b, self.cfg, self.cycle)


class ShardedMaskedStepSolve(ShardedQuadSolve):
    """The step's defect-correction solve over a mesh's shards
    (cfd_tpu/parallel/quad_sharded.py make_sharded_masked_step_solve,
    :404-696), with ShardedQuadSolve's ``(guess, b, max_b) -> (p, cycles,
    res)`` contract: the exact masked finest level on the local blocks
    (kernels.step_quad *Shard, V(1,1): the exact smoother's ledger fills the
    8-row halo), level 1 band-smoothed on the local blocks with its full
    2-D weights sliced from the padded global arrays (:496-531) in
    RBPairs.plain's full-2D expression, levels 2 and below once on shard
    0's device (the single-device masked hierarchy of
    poisson.multigrid.MaskedQuadMultigridPoisson, or its fused tail from
    global level max(2, tail_from)), and the level-1 correction
    solid-filled on the local blocks between two refreshes (:597-618,
    :675-677). A grid that coarsens only once gathers the level-1 source
    and runs the whole coarse solve on shard 0, solid-filled there
    (:678-690). ``cfg.corr_opt`` and ``cfg.pin_mean`` are not read, as the
    reference's factory takes neither."""

    pin_mean = False

    def __init__(self, grid, coeffs, cfg: M.MGConfig, shape, devices):
        self._setup(cfg, shape, devices)
        rect = M.step_rect_params(grid)
        if rect is None:
            raise ValueError("sharded masked multigrid requires the reference's step "
                             "rectangle raster")
        if cfg.pre_sweeps != 1 or cfg.post_sweeps != 1:
            raise ValueError(
                f"sharded masked step multigrid runs V(1,1) only, got "
                f"V({cfg.pre_sweeps},{cfg.post_sweeps}) (the exact masked smoother "
                "consumes 3 rows/pair of the 8-row device halo)")
        problem = M.masked_channel_problem(grid, coeffs.dx, coeffs.dy)
        probs = M.build_problems(problem, cfg)
        if len(probs) < 2:
            raise ValueError("grid too small for the sharded masked hierarchy")
        cfg, loc, shard = self.cfg, (self.P + 2 * DEV_HALO, self.W), (self.P, len(devices))
        kw = dict(shape=shape, step_i=rect[0], inlet_j=rect[1], idx2=coeffs.idx2,
                  idy2=coeffs.idy2, omega=cfg.omega, coarse_shape=loc, n_pairs=1, shard=shard)
        pre, post = {}, {}
        for d in dict.fromkeys(self.devices):
            pre[d] = make_quad_step_pre_smooth_restrict(device=d, **kw)
            post[d] = make_quad_step_post_prolong_smooth(device=d, **kw)
        self.pre = [pre[d] for d in self.devices]
        self.post = [post[d] for d in self.devices]
        # the single-device masked hierarchy (its own finest-level kernels
        # stay unused): levels 1.. with full 2-D weights, their smoothers,
        # the pinv of the coarsest, on shard 0's device
        self.mg = M.make_masked_quad_multigrid_poisson(
            grid, coeffs, dataclasses.replace(cfg, tail_from=None, corr_opt=False),
            device=self.devices[0])
        self.levels = [None, *self.mg.levels]
        # level 1 band-smooths on the shards when a level 2 exists (:480-483)
        self.l1_spmd = len(self.levels) >= 3
        if self.l1_spmd:
            self._finish(probs[1])
        else:
            self.tail_at, self.tail = None, None
        self.ny, self.nx = problem.ny, problem.nx

    def _l1_weights(self, jy: int, p1: M.PoissonProblem, L1, device):
        """The full 2-D weights of shard jy's block, sliced from the global
        level padded with DEV_HALO rows below and up to Hq8s + DEV_HALO
        above (:496-531)."""
        H = self.P + 2 * DEV_HALO
        pad = lambda w: torch.nn.functional.pad(
            w, (0, 0, DEV_HALO, self.Hq8s + DEV_HALO - w.shape[0]))
        return tuple(pad(getattr(L1, k))[jy * self.P : jy * self.P + H].to(device)
                     for k in ("wE", "wW", "wN", "wS"))

    def _l1_geom(self, jy: int, p1: M.PoissonProblem, L1, device) -> dict:
        """ShardedQuadSolve's constants and the solid fill's: the fluid
        cells as floats, their neighbour count and max(count, 1), and the
        cells the fill writes (geometric interior, not fluid, count > 0)."""
        g = super()._l1_geom(jy, p1, L1, device)
        f = g["interior"].to(torch.float32)
        den = self._neighbour_sum(f)
        g.update(fluid=f, fill=g["geo"] & ~g["interior"] & (den > 0),
                 den_max=torch.maximum(den, torch.ones_like(den)))
        return g

    @staticmethod
    def _neighbour_sum(a: torch.Tensor) -> torch.Tensor:
        """E + W + N + S in multigrid._solid_fill's order (the rows wrap
        within the block: the outermost halo rows)."""
        return (torch.roll(a, -1, dims=1) + torch.roll(a, 1, dims=1)
                + torch.roll(a, -1, dims=0) + torch.roll(a, 1, dims=0))

    def _l1_fill(self, e: torch.Tensor, g: dict) -> torch.Tensor:
        """The local block's solid fill of a fresh-haloed level-1 correction
        (:597-618, kernels.mg_tail._solid_fill on the block): each solid
        cell with a fluid neighbour takes their mean. The outermost halo
        rows read across the block's edge; the caller refreshes them."""
        fill = self._neighbour_sum(e * g["fluid"]) / g["den_max"]
        return torch.where(g["fill"], fill, e)

    def _correction(self, rc: list) -> list:
        P = self.P
        if self.l1_spmd:
            ec = super()._correction(rc)
            return _refresh([self._l1_fill(e, g) for e, g in zip(ec, self._l1, strict=True)],
                            P)
        # the coarse switch at level 1: the own rows of the source gathered,
        # the whole coarse solve once, solid-filled, sliced back (:678-690)
        ec = self._coarse(self._gather(rc), first=1)
        return self._slices(_solid_fill(self.levels[1], ec))


def make_sharded_quad_solve(problem: M.PoissonProblem, cfg: M.MGConfig, shape,
                            mesh, pin_mean: bool = False) -> ShardedQuadSolve:
    """The sharded quad solve over ``mesh``'s shards (ShardedQuadSolve)."""
    return ShardedQuadSolve(problem, cfg, shape, mesh.devices, pin_mean)


class ShardedQuadProjection:
    """The cavity, the channel, Rayleigh-Benard and the backward-facing step
    on the sharded quad path over a plane-row mesh
    (cfd_tpu/parallel/quad_sharded.py:699-1300).

    State: the carry as a tuple of lists, each holding the shards' local
    (4, P + 16, Wqa) blocks on their devices: (us*, vs*, p, p_prev) for the
    cavity and the channel, (us*, vs*, p, T) for RB (whatever the case's
    extrapolate_warm_start, as the reference's), (us*, vs*, p) for the step
    (``n_carry`` 3: its warm start is the plain previous p). ``step`` runs
    one step on every shard (:896-928): the flavor's carry kernel, the
    refresh of its outputs, and the sharded solve. The cavity takes max|b|
    from the carry's own-row partials and solves from the guess; the
    channel, RB and the step first remove the source mean, the shards'
    own-row sums added in shard order over the fluid cell count, on the
    globally indexed (fluid) cells (_sub_mean_local), and take max|b| after
    it; the channel solves from the guess, RB from p with the per-cycle
    mean pin, the step from p with the masked defect correction
    (ShardedMaskedStepSolve). ``logical`` gathers the own rows at print
    cadence and applies the flavor's corrector (RB: the case's
    unalign_state). ``make_adaptive`` gives the lagged adaptive
    controller's step: the same step on the flavor's traced-dt + Courant
    carry, and the Courant number from the shards' own-row maxima.

    The solve's config is the reference's, not the case's: V(2,1), V(1,2)
    for the channel (:814-821), V(1,1) for the step, with ``tol_factor``
    (1e-9 when none is given, :822-823) and abs_tol 0, then
    ``mg_overrides``. coarse_dtype and corr_opt raise its ValueErrors (they
    are single-device knobs), and so does a V(pre, post) whose level-1 solve
    needs more than the 8-row halo (the step's solve has its own V(1,1)
    rule, :837-838). A 1-shard mesh delegates every entry point to the
    case's own single-device engine (solver.CaseEngine: the same program a
    meshless run executes) unless ``force_sharded_path``, ``tol_factor`` or
    ``mg_overrides`` is given (:790-806)."""

    # the mesh size the reference validated and modelled (:740-748)
    MAX_VALIDATED_MESH = 16

    def __init__(self, case, mesh, tol_factor: float | None = None,
                 mg_overrides: dict | None = None, allow_unvalidated_mesh: bool = False,
                 force_sharded_path: bool = False):
        flavor = (case.name if case.name in ("rayleigh_benard", "backwards_step")
                  else case.ordering)
        if flavor not in ("cavity", "channel", "rayleigh_benard", "backwards_step"):
            raise ValueError("ShardedQuadProjection covers the cavity, channel, "
                             "rayleigh_benard and backwards_step flavors")
        if case.grid.has_solids and flavor != "backwards_step":
            raise ValueError("masked geometry is supported only for the backwards_step "
                             "rectangle raster")
        if case.dtype != torch.float32:
            raise ValueError("the quad fast path is float32")
        if not case.carry_tentative:
            raise ValueError(f"the sharded {flavor} flavor needs the quad layout "
                             "(layout='quad', f32 multigrid)")
        self.flavor, self.case, self.mesh = flavor, case, mesh
        mdy = mesh.shape["dy"]
        if mdy > self.MAX_VALIDATED_MESH and not allow_unvalidated_mesh:
            raise ValueError(
                f"{mdy}-way 1-D plane-row decomposition exceeds the validated/modeled "
                f"bound ({self.MAX_VALIDATED_MESH} chips). Pass "
                "allow_unvalidated_mesh=True to proceed anyway.")
        self.mdy = mdy
        self.shape = shape = case.grid.shape
        self.delegated = (mdy == 1 and not force_sharded_path and tol_factor is None
                          and not mg_overrides)
        if self.delegated:
            from cfd_tpu_torch.solver import CaseEngine

            self._sd = CaseEngine(case)
            return
        self.devices = list(mesh.devices)
        self.Hq8s, self.P, self.W = quad_shard_dims(shape, mdy)
        self._Hq8 = quad_dims(shape)[2]
        # V(1,2) for the channel: V(2,1) cannot contract an error mode of the
        # 1536x512 channel problem, V(2,2)'s level-1 block (9 rows) would
        # exceed the halo; V(1,1) for the step: the exact masked smoother's
        # halo budget (:814-821)
        pre, post = {"backwards_step": (1, 1), "channel": (1, 2)}.get(flavor, (2, 1))
        mg = M.MGConfig(tol_factor=1e-9 if tol_factor is None else tol_factor, abs_tol=0.0,
                        pre_sweeps=pre, post_sweeps=post)
        if mg_overrides:
            mg = dataclasses.replace(mg, **mg_overrides)
        if mg.coarse_dtype is not None:
            raise ValueError(
                "coarse_dtype (mixed-precision coarse hierarchy) is a single-device "
                "per-kernel-path knob — the sharded factories keep their own f32 level-1 "
                "block + replicated tail")
        if mg.corr_opt:
            raise ValueError(
                "corr_opt (line-searched coarse correction) is a single-device "
                "per-kernel-path knob — the sharded masked solve does not take it")
        if (flavor != "backwards_step"
                and 2 * (mg.pre_sweeps + mg.post_sweeps) + 1 > DEV_HALO):
            raise ValueError(
                f"V({mg.pre_sweeps},{mg.post_sweeps}) consumes "
                f"{2 * (mg.pre_sweeps + mg.post_sweeps) + 1} halo rows per level-1 solve "
                f"> the {DEV_HALO}-row device halo")
        self.mg = mg
        grid, coeffs, info = case.grid, case.coeffs, case.info or {}
        shard = (self.P, mdy)
        args = (grid.nx, grid.ny, grid.dx, grid.dy)
        self._step_rect, self.n_carry = None, 4
        if flavor == "backwards_step":
            self._step_rect = M.step_rect_params(grid)
            if self._step_rect is None:
                raise ValueError("the sharded backwards_step flavor requires the reference "
                                 "rectangle raster")
            uin = info.get("inlet_velocity", 1.0)
            make_carry = functools.partial(make_quad_step_corr_predictor_source, shape, coeffs,
                                           *self._step_rect, uin, shard=shard)
            self._corr = make_quad_step_corrector(shape, coeffs, *self._step_rect, uin)
            self._solve = ShardedMaskedStepSolve(grid, coeffs, mg, shape, self.devices)
            self.n_carry = 3
        elif flavor == "cavity":
            lid = info.get("lid_velocity", 1.0)
            problem = M.cavity_problem(*args)
            make_carry = functools.partial(make_quad_corr_predictor_source, shape, coeffs, lid,
                                           shard=shard)
            self._corr = make_quad_corrector(shape, coeffs, lid)
        elif flavor == "channel":
            uin = info.get("inlet_velocity", 1.0)
            problem = M.channel_problem(*args)
            make_carry = functools.partial(make_quad_channel_corr_predictor_source, shape,
                                           coeffs, uin, shard=shard)
            self._corr = make_quad_channel_corrector(shape, coeffs, uin)
        else:
            from cfd_tpu_torch.physics.boussinesq import RBParams

            problem = M.neumann_problem(*args)
            params = RBParams(info["rayleigh"], info["prandtl"], info.get("t_bottom", 1.0),
                              info.get("t_top", 0.0))
            make_carry = functools.partial(make_quad_rb_step_kernel, shape, coeffs,
                                           info["kappa"], params, shard=shard)
            self._corr = None  # case.unalign_state is RB's boundary
        # the flavor's carry on a shard's block; adaptive=True: its traced-dt
        # + Courant instance (make_adaptive)
        self._make_carry = make_carry
        self._carry = make_carry()
        if flavor != "backwards_step":
            self._solve = make_sharded_quad_solve(problem, mg, shape, mesh,
                                                  pin_mean=flavor == "rayleigh_benard")
        self._n_fluid = torch.tensor(float(grid.n_fluid), dtype=torch.float32,
                                     device=self.devices[0])
        self._coeffs = coeffs

    # ---------------- layout conversion (print cadence only) ----------------

    def _extend(self, q: torch.Tensor) -> list:
        """(4, Hq8?, W) global quad field -> the shards' local (4, P + 16, W)
        blocks, each on its shard's device (:981)."""
        q = torch.as_tensor(q, dtype=torch.float32)
        qp = torch.nn.functional.pad(q, (0, 0, DEV_HALO, self.Hq8s - q.shape[1] + DEV_HALO))
        P = self.P
        return [qp[:, jy * P : jy * P + P + 2 * DEV_HALO].to(d).contiguous()
                for jy, d in enumerate(self.devices)]

    def _collapse(self, xs: list) -> torch.Tensor:
        """The shards' blocks -> the (4, Hq8s, W) global own rows, on shard
        0's device (:990)."""
        dev0 = self.devices[0]
        return torch.cat([x[:, DEV_HALO : DEV_HALO + self.P].to(dev0) for x in xs], dim=1)

    # ---------------- entry points ----------------

    def initial_state(self):
        """The carried initial state (:1035-1048): the cavity and the channel
        from the logical zero state with the velocity BCs, RB from the case's
        seeded initial_state_fn (aligned); delegated: the case's own."""
        case = self.case
        if self.delegated:
            return self._sd.initial_state()
        if self.flavor == "rayleigh_benard":
            st = case.initial_state_fn()
            return tuple(self._extend(a) for a in (st.u, st.v, st.p, st.T))
        s = State.zeros(self.shape, dtype=torch.float32, device=case.device)
        u, v = case.velocity_bc(s.u, s.v)
        return self.from_logical(State(u, v, s.p, s.T, None))

    def is_logical(self, state) -> bool:
        """Whether ``state`` is a logical padded-layout State; else it is
        this engine's carried state (Simulation's engine interface)."""
        if self.delegated:
            return self._sd.is_logical(state)
        return isinstance(state, State)

    def from_logical(self, st: State):
        """Logical padded-layout State -> the sharded carry (the inverse of
        ``logical``, :1050-1079): RB through the case's align_state, the
        step through uncorrect_step_quad, the cavity and the channel through
        uncorrect_quad in their form; delegated: the case's carry."""
        if self.delegated:
            return self._sd.from_logical(st)
        if tuple(st.u.shape) != self.shape:
            raise ValueError(f"from_logical takes a logical {self.shape} State, got "
                             f"{tuple(st.u.shape)} fields")
        if self.flavor == "rayleigh_benard":
            a = self.case.align_state(st)
            return tuple(self._extend(x) for x in (a.u, a.v, a.p, a.T))
        if self.flavor == "backwards_step":
            us, vs = uncorrect_step_quad(st.u, st.v, st.p, self.shape, self._coeffs,
                                         *self._step_rect)
            return tuple(self._extend(to_quad(a, self.shape)) for a in (us, vs, st.p))
        us, vs = uncorrect_quad(st.u, st.v, st.p, self.shape, self._coeffs,
                                cavity_form=self.flavor == "cavity")
        p_prev = st.p if st.p_prev is None else st.p_prev
        return tuple(self._extend(to_quad(a, self.shape)) for a in (us, vs, st.p, p_prev))

    def _remove_mean(self, b: list, partials: list) -> list:
        """b - mean on every shard's interior (the step: fluid) cells, the
        mean being the shards' own-row sums added in shard order over the
        fluid cells (:905-906, :912-913, :924-925)."""
        mean = global_sum(partials) / self._n_fluid
        g = self.case.grid
        return [_sub_mean_local(x, mean.to(x.device), r, g.ny, g.nx, self._step_rect)
                for x, r in zip(b, self._solve.row_base, strict=True)]

    def step(self, state):
        """One step: (state, {"poisson_iters": int, "poisson_residual":
        float}) (:1081, step_local :896-928)."""
        if self.delegated:
            st, d = self._sd.step(state)
            return st, {"poisson_iters": d.poisson_iters,
                        "poisson_residual": d.poisson_residual}
        return self._finish_step(state, [self._carry(rb, *a) for rb, a in
                                         zip(self._solve.row_base, zip(*state), strict=True)])

    def _finish_step(self, state, outs):
        """The step after the carries' ``outs`` (their leading outputs are the
        fixed and the traced-dt carries' alike): the refresh, the source mean,
        max|b| and the solve (step_local :896-928, astep_local :1171-1207)."""
        if self.flavor == "backwards_step":  # carry, refresh, mean, max_b, solve (:910-916)
            us2, vs2, b = (_refresh([o[k] for o in outs], self.P) for k in range(3))
            b = self._remove_mean(b, [o[3] for o in outs])
            p2, iters, res = self._solve(state[2], b, global_max([x.abs().amax() for x in b]))
            return (us2, vs2, p2), {"poisson_iters": iters, "poisson_residual": res}
        us, vs, p, aux = state
        us2, vs2, f2, f3 = (_refresh([o[k] for o in outs], self.P) for k in range(4))
        parts = [o[4] for o in outs]
        if self.flavor == "rayleigh_benard":  # f2, f3 = T', b
            b = self._remove_mean(f3, parts)
            p2, iters, res = self._solve(p, b, global_max([x.abs().amax() for x in b]))
            new = (us2, vs2, p2, f2)
        else:  # f2, f3 = b, guess
            if self.flavor == "cavity":
                b, max_b = f2, global_max(parts)
            else:
                b = self._remove_mean(f2, parts)
                max_b = global_max([x.abs().amax() for x in b])
            p2, iters, res = self._solve(f3, b, max_b)
            new = (us2, vs2, p2, p)
        return new, {"poisson_iters": iters, "poisson_residual": res}

    def run_chunk(self, state, n_steps: int):
        """``n_steps`` steps: (state, {"poisson_iters": [...],
        "poisson_residual": [...]}), one entry a step (:1090)."""
        iters, res = [], []
        for _ in range(n_steps):
            state, d = self.step(state)
            iters.append(d["poisson_iters"])
            res.append(d["poisson_residual"])
        return state, {"poisson_iters": iters, "poisson_residual": res}

    def make_adaptive(self, max_courant: float, growth: float, dt_ceiling: float,
                      spc: int):
        """Lagged adaptive stepping on the sharded path (:1104-1266): the
        flavor's traced-dt + Courant carry on every shard (rows 16a+, 16d+,
        16e+, 16f+: kernels.quad, rb_quad and step_quad *ShardAdaptive, told
        the shard's row_base), then the fixed-dt step's refresh, source mean,
        max|b| and solve (_finish_step), and co_per_dt = global_max(mu) / dx
        + global_max(mv) / dy over the shards' own-row maxima.

        Returns (step, to_aligned, to_logical), the contract of
        Case.adaptive_impl_carry, so the single-device lagged loop
        (adaptive._run_lagged) drives this engine too:

        * step(state, dts) -> (state, StepDiagnostics(cycles, res),
          co_per_dt), dts = (dt_corr, dt_pred) a (2,) float32 tensor on
          shard 0's device, co_per_dt a 0-d tensor there;
        * to_aligned(logical State, dt) and to_logical(state, dt_used): the
          case's adaptive converters on the gathered global quad arrays
          (:1250-1264).

        The reference scans ``spc`` steps of its controller, dt' =
        min(dt * min(growth, max_courant / Co), dt_ceiling), on the device
        (:1209-1240). The port's loop runs that controller itself, in the
        same float32 operations on shard 0's device, so the step takes no
        controller constants. A delegated engine raises the reference's
        ValueError (:1125-1131): run_adaptive routes it to the
        single-device controllers."""
        if self.delegated:
            raise ValueError(
                "this 1-device engine delegates to the single-device fast path (quad_sharded "
                "mdy==1 delegation) — adaptive runs go through "
                "cfd_tpu_torch.adaptive.run_adaptive, which routes a delegated engine to the "
                "single-device lagged controller")
        case = self.case
        if case.adaptive_impl_carry is None:
            raise ValueError("sharded adaptive needs the quad kernel case "
                             "(Case.adaptive_impl_carry: layout='quad', f32 multigrid)")
        carry = self._make_carry(adaptive=True)
        idx_, idy_ = 1.0 / case.grid.dx, 1.0 / case.grid.dy
        n = self.n_carry  # the carries' leading outputs, then (mu, mv)

        def step(state, dts):
            outs = [carry(rb, dts.to(a[0].device), *a) for rb, a in
                    zip(self._solve.row_base, zip(*state), strict=True)]
            new, d = self._finish_step(state, [o[: n + 1] for o in outs])
            co_per_dt = (global_max([o[n + 1] for o in outs]) * idx_
                         + global_max([o[n + 2] for o in outs]) * idy_)
            return new, StepDiagnostics(d["poisson_iters"], d["poisson_residual"]), co_per_dt

        _, to_aligned_c, to_logical_c = case.adaptive_impl_carry()

        def to_aligned(st: State, dt: float):
            g = to_aligned_c(st, dt)
            return tuple(self._extend(a) for a in self._carried(g))

        def to_logical(state, dt_used) -> State:
            return to_logical_c(self._gathered(state), dt_used)

        return step, to_aligned, to_logical

    def _carried(self, st: State) -> tuple:
        """The carried fields of a global quad State, in the engine's order."""
        if self.flavor == "rayleigh_benard":
            return st.u, st.v, st.p, st.T
        if self.flavor == "backwards_step":
            return st.u, st.v, st.p
        return st.u, st.v, st.p, st.p_prev

    def _gathered(self, state) -> State:
        """The shards' own rows as the global quad State on shard 0's device
        (the inverse of _carried with _extend)."""
        f = [self._collapse(x)[:, : self._Hq8].contiguous() for x in state]
        if self.flavor == "rayleigh_benard":
            return State(f[0], f[1], f[2], f[3], None)
        if self.flavor == "backwards_step":
            return State(f[0], f[1], f[2], None, None)
        return State(f[0], f[1], f[2], None, f[3])

    def logical(self, state) -> State:
        """Gather the own rows and correct to the logical padded (ny+2,
        nx+2) State (:1270-1295); delegated: the case's unalign."""
        if self.delegated:
            return state if self._sd.is_logical(state) else self._sd.logical(state)
        g = self._gathered(state)
        f = lambda a: from_quad(a, self.shape)
        if self.flavor == "rayleigh_benard":
            return self.case.unalign_state(g)
        if self.flavor == "backwards_step":
            u2, v2 = self._corr(g.u, g.v, g.p)
            return State(f(u2), f(v2), f(g.p), None, None)
        u2, v2, _ = self._corr(g.u, g.v, g.p, g.p)
        return State(f(u2), f(v2), f(g.p), None, f(g.p_prev))


# The reference's name from before its channel flavor (:1298-1300)
ShardedQuadCavity = ShardedQuadProjection
