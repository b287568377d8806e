"""The coarse V-cycle below the finest level (the plain twin of the body of
cfd_tpu.kernels.mg_tail.run_tail_vcycle, mg_tail.py:231-308), and the fused
coarse tail that runs it in one kernel launch (MGTail, the port of
make_mg_tail, mg_tail.py:329).

``run_tail_vcycle`` runs one V-cycle over aligned levels (separable, or
masked with full-2D weights) from a zero iterate and returns the
correction on the first of them. It is the
single coarse-hierarchy composition of the port: MultigridPoisson runs it
with each smoother's dispatching wrapper (the CUDA kernel for CUDA
tensors), and the whole-solve's and the tail's plain twins run it with the
smoothers' ``plain`` twins. The inter-level transfers and the coarsest
dense solve below are XLA glue in the reference, outside any kernel; here
they are plain PyTorch ops, shared by every caller. On a masked level the
prolongation first solid-fills the coarse correction and writes only the
fine level's active cells (multigrid.py:350-389). With ``store_dtype`` it
rounds where the reference's whole-solve stores its bfloat16 hierarchy.

``MGTail`` (``tail(b) -> e``, MGConfig.tail_from) runs that V-cycle over
the levels from ``tail_from`` down as ONE cooperative launch of
csrc/mg_tail.cu, the coarse part of the whole-solve kernel's device code
(csrc/whole_solve.cuh); its plain twin is run_tail_vcycle over the
smoothers' twins. Not carried over: the reference's VMEM cap
(mg_tail.py:340-350) and its lane-block pinv limit (coarsest ny <= 12,
mg_tail.py:212-214), which are TPU layout limits (ROADMAP.md queue A item
13). The reference's tail sums its transfers as matmuls in another order,
so its corrections differ from this one's by f32 rounding.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.plan import device_sms, plan_for, ready_grid

MG_TAIL = Kernel("mg_tail", "cfd_mg_tail", "cfd_tpu_torch/csrc/mg_tail.cu",
                 "cfd_tpu/kernels/mg_tail.py:329")
MG_TAIL_FULL = Kernel("mg_tail_full", "cfd_mg_tail", "cfd_tpu_torch/csrc/mg_tail.cu",
                      "cfd_tpu/kernels/mg_tail.py:329 (full-2D weights)")


def _restrict(fine, coarse, r: torch.Tensor) -> torch.Tensor:
    """Full weighting: coarse cell = mean of its 4 fine children, summed in
    float32 in the row-major window order of the reference's reduce_window,
    rounded once to the storage dtype."""
    inner = r[1 : fine.ny + 1, 1 : fine.nx + 1].float()
    rc = ((inner[0::2, 0::2] + inner[0::2, 1::2]) + inner[1::2, 0::2]
          + inner[1::2, 1::2]) * 0.25
    out = torch.zeros(coarse.shape, dtype=r.dtype, device=r.device)
    out[1 : coarse.ny + 1, 1 : coarse.nx + 1] = rc.to(r.dtype)
    return out


def level_masks(level, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(interior, active) bool masks of an aligned level: the rectangle
    j in [1, ny], i in [1, nx], and the cells the smoother updates, which on
    a full-2D (masked) level also need a coupling, denom > 0
    (cfd_tpu multigrid._inline_masks)."""
    H, W = level.shape
    jj = torch.arange(H, device=device)[:, None]
    ii = torch.arange(W, device=device)[None, :]
    interior = (jj >= 1) & (jj <= level.ny) & (ii >= 1) & (ii <= level.nx)
    if level.separable:
        return interior, interior
    denom = (level.idx2 * (level.wE.float() + level.wW.float())
             + level.idy2 * (level.wN.float() + level.wS.float()))
    return interior, interior & (denom > 0)


def _solid_fill(coarse, e: torch.Tensor) -> torch.Tensor:
    """Neumann-extend a coarse correction into the solid cells of a masked
    level before prolongation (cfd_tpu multigrid._solid_fill,
    multigrid.py:317-347): each solid interior cell with a fluid
    4-neighbour takes the mean of its fluid neighbours, num / max(den, 1)."""
    geom, fluid = level_masks(coarse, e.device)
    f = fluid.to(e.dtype)
    ef = e * f
    roll = lambda a, s, d: torch.roll(a, s, dims=d)
    num = roll(ef, -1, 1) + roll(ef, 1, 1) + roll(ef, -1, 0) + roll(ef, 1, 0)
    den = roll(f, -1, 1) + roll(f, 1, 1) + roll(f, -1, 0) + roll(f, 1, 0)
    fill = num / torch.maximum(den, torch.ones_like(den))
    return torch.where(geom & ~fluid & (den > 0), fill.to(e.dtype), e)


def _prolong(coarse, fine, e: torch.Tensor) -> torch.Tensor:
    """Bilinear (cell-centered 9-3-3-1) interpolation of the coarse
    correction with edge-extrapolated ghosts (cfd_tpu multigrid._prolong),
    computed in float32 and rounded once to e's dtype; 0 outside the fine
    level's active cells. A masked (full-2D) coarse level is solid-filled
    first."""
    if not coarse.separable:
        e = _solid_fill(coarse, e)
    ny_c, nx_c = coarse.ny, coarse.nx
    ce = torch.nn.functional.pad(e[1 : ny_c + 1, 1 : nx_c + 1].float()[None, None],
                                 (1, 1, 1, 1), mode="replicate")[0, 0]
    c = ce[1:-1, 1:-1]
    cw, ceast = ce[1:-1, :-2], ce[1:-1, 2:]
    cs, cn = ce[:-2, 1:-1], ce[2:, 1:-1]
    csw, cse = ce[:-2, :-2], ce[:-2, 2:]
    cnw, cne = ce[2:, :-2], ce[2:, 2:]
    k = 1.0 / 16.0
    c00 = k * (9 * c + 3 * cw + 3 * cs + csw)  # child (j-lo, i-lo)
    c01 = k * (9 * c + 3 * ceast + 3 * cs + cse)
    c10 = k * (9 * c + 3 * cw + 3 * cn + cnw)
    c11 = k * (9 * c + 3 * ceast + 3 * cn + cne)
    ef = torch.empty((2 * ny_c, 2 * nx_c), dtype=torch.float32, device=e.device)
    ef[0::2, 0::2], ef[0::2, 1::2] = c00, c01
    ef[1::2, 0::2], ef[1::2, 1::2] = c10, c11
    out = torch.zeros(fine.shape, dtype=e.dtype, device=e.device)
    out[1 : fine.ny + 1, 1 : fine.nx + 1] = ef[: fine.ny, : fine.nx].to(e.dtype)
    if not fine.separable:
        out = torch.where(level_masks(fine, e.device)[1], out, torch.zeros_like(out))
    return out


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums by a fixed pairwise tree of elementwise adds: the same
    rounding on every device (a library reduction's order is its own)."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        head = x[:, :h] + x[:, h : 2 * h]
        x = torch.cat([head, x[:, 2 * h :]], dim=1)
    return x[:, 0]


def dense_coarse_solve(bot, pinv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense pinv product on the coarsest interior, in b's dtype (the pinv
    is rounded to it, as multigrid.py:762-766) with float32 sums in the
    fold_sum order."""
    vec = b[1 : bot.ny + 1, 1 : bot.nx + 1].reshape(-1).float()
    e = fold_sum(pinv.to(b.dtype).float() * vec[None, :]).reshape(bot.ny, bot.nx)
    out = torch.zeros(bot.shape, dtype=b.dtype, device=b.device)
    out[1 : bot.ny + 1, 1 : bot.nx + 1] = e.to(b.dtype)
    return out


def run_tail_vcycle(levels, b0: torch.Tensor, pre, post, coarse_solve,
                    plain: bool = False, store_dtype=None) -> torch.Tensor:
    """One V-cycle over ``levels`` (aligned levels; ``b0`` is the source on
    ``levels[0]``) from a zero iterate; returns the correction on
    ``levels[0]``.

    ``pre[k]`` (pairs + residual field) and ``post[k]`` (pairs) are the
    red/black smoothers of ``levels[k]`` for every level but the last;
    ``coarse_solve(b)`` solves on the last. ``plain`` runs the smoothers'
    plain twins whatever the tensors' device.

    ``store_dtype`` (float32 levels only): the rounding points of the
    reference's whole-solve hierarchy (mg_tail.py run_tail_vcycle with
    store_dtype): every level's source b[k] (b0 included) and its
    pre-smoothed iterate ps[k] are rounded to that type and kept in float32,
    ps[k] after the residual has been taken from its unrounded value; the
    arithmetic and the correction passed up stay float32."""
    def smooth(op, *args):
        return op.plain(*args) if plain else op(*args)

    store = ((lambda x: x) if store_dtype is None
             else (lambda x: x.to(store_dtype).to(x.dtype)))

    def down(k: int, b: torch.Tensor) -> torch.Tensor:
        if k == len(levels) - 1:
            return coarse_solve(b)
        level, below = levels[k], levels[k + 1]
        p = torch.zeros(level.shape, dtype=b.dtype, device=b.device)
        p, r = smooth(pre[k], p, b)
        ec = down(k + 1, store(_restrict(level, below, r)))
        return smooth(post[k], store(p) + _prolong(below, level, ec), b)

    return down(0, store(b0))


def level_arrays(levels, iterates, sources, smoothed):
    """The host arrays that describe aligned levels to the CUDA entry points
    (cfd_whole_solve, cfd_mg_tail): idims (H8, W, ny, nx, full) and fdims
    (idx2, idy2) per level, and ptrs (wE, wW, wN, wS, iterate, source,
    pre-smoothed iterate or None) per level, from the levels' weight
    buffers and the given tensors."""
    idims = (ctypes.c_int * (5 * len(levels)))(
        *(d for lv in levels for d in (*lv.shape, lv.ny, lv.nx, int(not lv.separable))))
    fdims = (ctypes.c_float * (2 * len(levels)))(
        *(d for lv in levels for d in (lv.idx2, lv.idy2)))
    ptrs = []
    for lv, p, b, q in zip(levels, iterates, sources, smoothed, strict=True):
        ptrs += [getattr(lv, w).data_ptr() for w in ("wE", "wW", "wN", "wS")]
        ptrs += [p.data_ptr(), b.data_ptr(), q.data_ptr() if q is not None else None]
    return idims, fdims, (ctypes.c_void_p * len(ptrs))(*ptrs)


class MGTail(nn.Module):
    """``tail(b) -> e``: one V-cycle over ``levels`` (aligned float32
    levels, separable or full-2D, finest first) from zero iterates with the
    dense ``pinv`` solve on the coarsest, the drop-in for the recursion
    below the level ``levels[0]`` (cfd_tpu make_mg_tail). ``pre``/``post``
    are the levels' smoothers (for every level but the last), as
    run_tail_vcycle takes them; the kernel reads their omega and pair
    counts. ``b`` and ``e`` are (H8, W) float32 on levels[0].

    * ``kernel`` — csrc/mg_tail.cu: one cooperative launch, the scratch of
      the levels below the first allocated once as buffers of this module;
      the launches count on MG_TAIL (separable) or MG_TAIL_FULL.
    * ``plain`` — run_tail_vcycle over the smoothers' plain twins and the
      glue; the kernel repeats its arithmetic in order, bit for bit."""

    def __init__(self, levels, pre, post, pinv: torch.Tensor):
        super().__init__()
        if len(levels) < 2:
            raise ValueError("the fused tail needs at least two levels")
        if any(lv.dtype != torch.float32 for lv in levels):
            raise ValueError("the fused tail runs float32 levels")
        self.levels = list(levels)  # owned by the caller's hierarchy
        self.pre, self.post, self.pinv = pre, post, pinv
        self.omega, self.n_pre, self.n_post = pre[0].omega, pre[0].n_pairs, post[0].n_pairs
        self.record = MG_TAIL if levels[0].separable else MG_TAIL_FULL
        f32 = dict(dtype=torch.float32, device=pinv.device)
        for k, lv in enumerate(self.levels[1:], start=2):
            self.register_buffer(f"p{k}", torch.zeros(lv.shape, **f32), persistent=False)
            self.register_buffer(f"b{k}", torch.zeros(lv.shape, **f32), persistent=False)
        self.plan = plan_for(self.levels, None, self.n_pre, self.n_post,
                             sms=device_sms(pinv.device))
        self._plan_ints = self.plan.c_ints()
        self._grid_ready = False  # ready_grid before the first launch
        # the pre-smoothed iterates of the levels the grid runs in tiles
        for k, (lv, (rows, _)) in enumerate(zip(self.levels, self.plan.level_tiles), start=1):
            if rows:
                self.register_buffer(f"q{k}", torch.zeros(lv.shape, **f32), persistent=False)

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        shape = self.levels[0].shape
        if b.dtype != torch.float32 or tuple(b.shape) != shape or not b.is_contiguous():
            raise ValueError(f"expected contiguous float32 {shape}, got {b.dtype} "
                             f"{tuple(b.shape)}")
        if b.device != self.pinv.device:
            raise ValueError(f"tensor on {b.device}, tail buffers on {self.pinv.device}")
        if route(b) == "cuda":
            return self.kernel(b)
        return self.plain(b)

    def plain(self, b: torch.Tensor) -> torch.Tensor:
        return run_tail_vcycle(self.levels, b, self.pre, self.post,
                               lambda bb: dense_coarse_solve(self.levels[-1], self.pinv, bb),
                               plain=True)

    def kernel(self, b: torch.Tensor) -> torch.Tensor:
        if not self._grid_ready:
            ready_grid(self.plan, b.device, "cfd_mg_tail_grid")
            self._grid_ready = True
        e = torch.empty_like(b)
        n = len(self.levels)
        idims, fdims, ptrs = level_arrays(
            self.levels, [e] + [getattr(self, f"p{k}") for k in range(2, n + 1)],
            [b] + [getattr(self, f"b{k}") for k in range(2, n + 1)],
            [getattr(self, f"q{k}", None) for k in range(1, n + 1)])
        as_ptr = lambda a: ctypes.cast(a, ctypes.c_void_p)
        self.record(b, ptr(b), ptr(e), ptr(self.pinv), n,
                    as_ptr(idims), as_ptr(fdims), as_ptr(ptrs), self.omega, self.n_pre,
                    self.n_post, as_ptr(self._plan_ints))
        return e
