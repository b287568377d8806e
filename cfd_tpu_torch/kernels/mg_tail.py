"""The coarse V-cycle below the finest level (the plain twin of the body of
cfd_tpu.kernels.mg_tail.run_tail_vcycle, mg_tail.py:231-308).

``run_tail_vcycle`` runs one V-cycle over aligned levels (separable, or
masked with full-2D weights) from a zero iterate and returns the
correction on the first of them. It is the
single coarse-hierarchy composition of the port: MultigridPoisson runs it
with each smoother's dispatching wrapper (the CUDA kernel for CUDA
tensors), and the whole-solve's plain twin runs it with the smoothers'
``plain`` twins. The inter-level transfers and the coarsest dense solve
below are XLA glue in the reference, outside any kernel; here they are
plain PyTorch ops, shared by both callers. On a masked level the
prolongation first solid-fills the coarse correction and writes only the
fine level's active cells (multigrid.py:350-389).

The reference's make_mg_tail (mg_tail.py:329), the whole coarse cycle as
one kernel launch, is not ported (ROADMAP.md queue B item 13); on the card
the whole-solve kernel (csrc/whole_solve.cu) runs this same arithmetic
inside its one launch.
"""

from __future__ import annotations

import torch


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
                    plain: bool = False) -> torch.Tensor:
    """One V-cycle over ``levels`` (aligned levels; ``b0`` is the source on
    ``levels[0]``) from a zero iterate; returns the correction on
    ``levels[0]``.

    ``pre[k]`` (pairs + residual field) and ``post[k]`` (pairs) are the
    red/black smoothers of ``levels[k]`` for every level but the last;
    ``coarse_solve(b)`` solves on the last. ``plain`` runs the smoothers'
    plain twins whatever the tensors' device."""
    def smooth(op, *args):
        return op.plain(*args) if plain else op(*args)

    def down(k: int, b: torch.Tensor) -> torch.Tensor:
        if k == len(levels) - 1:
            return coarse_solve(b)
        level, below = levels[k], levels[k + 1]
        p = torch.zeros(level.shape, dtype=b.dtype, device=b.device)
        p, r = smooth(pre[k], p, b)
        ec = down(k + 1, _restrict(level, below, r))
        return smooth(post[k], p + _prolong(below, level, ec), b)

    return down(0, b0)
