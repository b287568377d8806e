"""Geometric multigrid pressure-Poisson solver on the quad path (the port
of cfd_tpu.poisson.multigrid).

Ported: the rectangle (separable-weight) hierarchies of the cavity,
channel and Rayleigh-Benard flavors (the last pure Neumann, with the
per-cycle mean pin of ``MGConfig.pin_mean``), solved with the finest
level in the quad layout (kernels.quad pre/post kernels) or on the natural
aligned layout (kernels.rb_smoother: the pre-smooth with the residual
field, the post-smooth with the fused max|b - A p|, multigrid.py:562-900),
and every coarser level on aligned arrays (kernels.rb_smoother, composed
by kernels.mg_tail.run_tail_vcycle), in float32 or with the bfloat16
coarse hierarchy of ``MGConfig.coarse_dtype``;
and the backward step's masked defect-correction hierarchy, the exact
masked finest level over full-2D-weight coarse levels with the solid fill
and the line-searched level-1 correction of ``MGConfig.corr_opt``, float32
only: on the quad layout (MaskedQuadMultigridPoisson, kernels.step_quad)
and on the natural layout (MaskedMultigridPoisson, kernels.step_smoother,
multigrid.py:968-1041). The separable solves and the quad masked solve take
``MGConfig.tail_from``: every level from there down runs as one launch of
the fused coarse tail (kernels.mg_tail.MGTail).
The coarse-level restriction/prolongation and the coarsest dense solve are
XLA glue in the reference, outside any kernel; here they are plain PyTorch
ops (kernels.mg_tail), and so is corr_opt's steplength (_corr_alpha). The
whole solve in one kernel launch is kernels.whole_solve; its twin is this
module's cycle with ``store_dtype`` for the bfloat16 hierarchy.

The tolerance loop runs on the host: every V-cycle reads its residual back
once, where the reference runs a device ``lax.while_loop``. The stopping
rule is the reference's exactly (multigrid.py:836-849,883-885), evaluated
in float32: tol = max(tol_factor * (max_b if max_b > 0 else 1), abs_tol);
stop on res <= tol, on max_cycles, or when res >= stall_ratio * prev, with
the finite sentinels 1e30/2 and 1e30.

pin_mean (multigrid.py:854-866): after each V-cycle the iterate is shifted
by its interior mean, sum(p) / (nx * ny), on the quad cells. The cycle's
fused residual is taken before the shift; it stays valid after it only
when the constant is the operator's nullspace, so the pin is taken for
pure-Neumann problems only. As in the reference it is glue around the
kernels: torch ops, with the sum in fixed_order_sum's order and a true
division by a device scalar.

Unified operator (multigrid.py:13-26):

    A(p) = idx2*(wE*(pE - p) + wW*(pW - p)) + idy2*(wN*(pN - p) + wS*(pS - p))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cfd_tpu_torch.kernels.mg_tail import (
    MGTail,
    _prolong,
    _restrict,
    _solid_fill,
    dense_coarse_solve,
    level_masks,
    run_tail_vcycle,
)
from cfd_tpu_torch.kernels.quad import fixed_order_sum, quad_cell_mask
from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """Host-side spec of one weighted-Poisson level."""

    nx: int
    ny: int
    dx: float
    dy: float
    wE: np.ndarray  # (ny+2, nx+2) float; coupling weights, 0 outside interior
    wW: np.ndarray
    wN: np.ndarray
    wS: np.ndarray

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny + 2, self.nx + 2)


def mg_compatible(nx: int, ny: int, min_coarse: int = 4) -> bool:
    """True when at least one factor-2 coarsening is possible."""
    return nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_coarse and ny // 2 >= min_coarse


def _interior_mask(nx: int, ny: int) -> np.ndarray:
    m = np.zeros((ny + 2, nx + 2), dtype=bool)
    m[1 : ny + 1, 1 : nx + 1] = True
    return m


def cavity_problem(nx: int, ny: int, dx: float, dy: float) -> PoissonProblem:
    """The cavity flavor: Neumann sides except the always-on south coupling
    (cavity-01.cpp:644-647)."""
    jj = np.arange(ny + 2)[:, None]
    ii = np.arange(nx + 2)[None, :]
    interior = _interior_mask(nx, ny)
    wE = ((ii < nx) & interior).astype(np.float64)
    wW = ((ii > 1) & interior).astype(np.float64)
    wN = ((jj < ny) & interior).astype(np.float64)
    wS = interior.astype(np.float64)  # reference quirk: couples j=1 to 0-ghost
    return PoissonProblem(nx, ny, dx, dy, wE, wW, wN, wS)


def neumann_problem(nx: int, ny: int, dx: float, dy: float) -> PoissonProblem:
    """Pure-Neumann box (use with mean-pinning / mean-removed sources)."""
    jj = np.arange(ny + 2)[:, None]
    ii = np.arange(nx + 2)[None, :]
    interior = _interior_mask(nx, ny)
    wE = ((ii < nx) & interior).astype(np.float64)
    wW = ((ii > 1) & interior).astype(np.float64)
    wN = ((jj < ny) & interior).astype(np.float64)
    wS = ((jj > 1) & interior).astype(np.float64)
    return PoissonProblem(nx, ny, dx, dy, wE, wW, wN, wS)


def channel_problem(nx: int, ny: int, dx: float, dy: float) -> PoissonProblem:
    """Channel flavor: inlet/walls Neumann, outlet Dirichlet-0 through the
    ghost column (channel-01.cpp:531-541)."""
    p = neumann_problem(nx, ny, dx, dy)
    wE = p.wE.copy()
    wE[1 : ny + 1, nx] = 1.0  # outlet column couples to the 0-pinned ghost
    return dataclasses.replace(p, wE=wE)


def coarsen_problem(p: PoissonProblem) -> PoissonProblem:
    """Factor-2 coarsening with interface-averaged couplings and the
    domain-edge Dirichlet fix w_c = 4w/(2+w) (1 -> 4/3 -> 8/5 -> ...), see
    cfd_tpu/poisson/multigrid.py:227-270."""
    assert p.nx % 2 == 0 and p.ny % 2 == 0
    nx, ny = p.nx // 2, p.ny // 2

    def block(a: np.ndarray) -> np.ndarray:
        return a[1 : p.ny + 1, 1 : p.nx + 1].reshape(ny, 2, nx, 2)

    def pad(interior: np.ndarray) -> np.ndarray:
        w = np.zeros((ny + 2, nx + 2))
        w[1 : ny + 1, 1 : nx + 1] = interior
        return w

    wE = pad(block(p.wE)[:, :, :, 1].mean(axis=1))
    wW = pad(block(p.wW)[:, :, :, 0].mean(axis=1))
    wN = pad(block(p.wN)[:, 1, :, :].mean(axis=-1))
    wS = pad(block(p.wS)[:, 0, :, :].mean(axis=-1))

    def edge_fix(w):
        return 4.0 * w / (2.0 + w)

    wS[1, 1 : nx + 1] = edge_fix(wS[1, 1 : nx + 1])
    wN[ny, 1 : nx + 1] = edge_fix(wN[ny, 1 : nx + 1])
    wW[1 : ny + 1, 1] = edge_fix(wW[1 : ny + 1, 1])
    wE[1 : ny + 1, nx] = edge_fix(wE[1 : ny + 1, nx])
    return PoissonProblem(nx, ny, p.dx * 2, p.dy * 2, wE, wW, wN, wS)


def _is_separable(p: PoissonProblem) -> bool:
    inter = np.s_[1 : p.ny + 1, 1 : p.nx + 1]

    def rows_equal(w):
        return bool((w[inter] == w[inter][0:1, :]).all())

    def cols_equal(w):
        return bool((w[inter] == w[inter][:, 0:1]).all())

    return (rows_equal(p.wE) and rows_equal(p.wW)
            and cols_equal(p.wN) and cols_equal(p.wS))


def _apply_np(p: PoissonProblem, x: np.ndarray) -> np.ndarray:
    """numpy A(x) for host-side dense-matrix probing."""
    idx2, idy2 = 1.0 / (p.dx * p.dx), 1.0 / (p.dy * p.dy)
    xE = np.roll(x, -1, axis=1)
    xW = np.roll(x, 1, axis=1)
    xN = np.roll(x, -1, axis=0)
    xS = np.roll(x, 1, axis=0)
    a = idx2 * (p.wE * (xE - x) + p.wW * (xW - x)) + idy2 * (p.wN * (xN - x) + p.wS * (xS - x))
    return np.where(_interior_mask(p.nx, p.ny), a, 0.0)


def is_pure_neumann(p: PoissonProblem) -> bool:
    """True when the constant is in the operator's nullspace (A 1 == 0 on
    the interior), the condition for pin_mean (multigrid.py:642-643)."""
    ones = _interior_mask(p.nx, p.ny).astype(np.float64)
    return float(np.abs(_apply_np(p, ones)).max()) == 0.0


def _dense_pinv(p: PoissonProblem) -> np.ndarray:
    """Pseudo-inverse of the coarsest operator over interior cells (the
    near-constant mode makes an iterative coarsest solve slow)."""
    n = p.nx * p.ny
    A = np.zeros((n, n))
    for k in range(n):
        e = np.zeros((p.ny + 2, p.nx + 2))
        e[1 + k // p.nx, 1 + k % p.nx] = 1.0
        A[:, k] = _apply_np(p, e)[1 : p.ny + 1, 1 : p.nx + 1].ravel()
    return np.linalg.pinv(A, rcond=1e-12)


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """The reference's multigrid configuration (cfd_tpu MGConfig). The port
    honours omega, pre/post_sweeps, max_cycles, tol_factor, abs_tol,
    min_coarse, stall_ratio, coarse_dtype (the per-kernel bfloat16 levels,
    or the whole-solve's bfloat16 rounding points), tail_from (the fused
    coarse tail of the per-kernel solves; whole_solve and whole_step
    supersede it), corr_opt (masked hierarchies only), whole_solve (the
    case factories then build kernels.whole_solve), whole_step (the case
    factories consume it and build kernels.whole_step), and pin_mean on
    pure-Neumann separable problems, as the reference: a separable solve of
    any other problem raises its ValueError, and the masked hierarchies and
    the whole-solves ignore the field (the whole-solve factory takes its own
    pin_mean argument). The
    reference's coarse_sweeps is read by nothing there, so it has no field
    here and an override naming it is refused."""

    omega: float = 1.0
    pre_sweeps: int = 2
    post_sweeps: int = 2
    max_cycles: int = 100
    tol_factor: float = 1e-9
    abs_tol: float = 0.0
    min_coarse: int = 4
    pin_mean: bool = False
    stall_ratio: float = 0.9
    tail_from: int | None = None
    whole_solve: bool = False
    whole_step: bool = False
    coarse_dtype: str | None = None
    corr_opt: bool = False


def normalize_coarse_dtype_optout(mg_overrides):
    """``coarse_dtype='float32'/'f32'`` in mg_overrides is the explicit
    opt-out of the auto bf16 coarse hierarchy: strip the key and report it.
    Returns ``(explicit_f32, stripped_overrides)``."""
    explicit_f32 = bool(
        mg_overrides and mg_overrides.get("coarse_dtype") in ("float32", "f32"))
    if explicit_f32:
        mg_overrides = {k: v for k, v in mg_overrides.items() if k != "coarse_dtype"}
    return explicit_f32, mg_overrides


def auto_bf16_coarse(on_cuda: bool, explicit_f32: bool, mg: MGConfig,
                     mg_overrides) -> bool:
    """The fully-auto condition for the bf16 coarse hierarchy
    (cfd_tpu.poisson.multigrid.auto_bf16_coarse with "device is cuda" in
    place of "platform is tpu"): the CPU keeps the f32 ladder, as the
    reference's interpret mode does; any manual fusion/precision knob keeps
    full precision."""
    return (on_cuda and not explicit_f32
            and mg.coarse_dtype is None
            and mg.tail_from is None and not mg.whole_step
            and not (mg_overrides and any(
                k in mg_overrides for k in (
                    "whole_solve", "whole_step", "tail_from", "coarse_dtype"))))


def _round_up8_128(shape: tuple[int, int], dtype=torch.float32) -> tuple[int, int]:
    """Aligned dims of the reference: rows to 8 (float32) or 16 (2-byte
    dtypes), columns to 128."""
    H, W = shape
    g = 16 if dtype.itemsize == 2 else 8
    return (-(-H // g) * g, -(-W // 128) * 128)


class _Level(nn.Module):
    """One aligned level: for a separable problem wE/wW (1, W) and wN/wS
    (H, 1) coupling vectors, for a masked one whole (H, W) weight arrays
    (``separable`` False), in the level's storage dtype (buffers), zero
    outside the interior; shape is the aligned (H, W)."""

    def __init__(self, wE, wW, wN, wS, idx2: float, idy2: float,
                 shape: tuple[int, int], ny: int, nx: int, dtype: torch.dtype,
                 separable: bool = True):
        super().__init__()
        self.register_buffer("wE", wE)
        self.register_buffer("wW", wW)
        self.register_buffer("wN", wN)
        self.register_buffer("wS", wS)
        self.idx2, self.idy2 = idx2, idy2
        self.shape = shape
        self.ny, self.nx = ny, nx
        self.dtype = dtype
        self.separable = separable


def _build_level(p: PoissonProblem, dtype: torch.dtype, device="cpu",
                 allow_full: bool = False, round_to: torch.dtype | None = None,
                 aligned: bool = True) -> _Level:
    """Aligned level (cfd_tpu _build_level(aligned=True)), its weights
    rounded to ``dtype`` (bf16: 4/3 -> 1.3359375), or with ``round_to``
    rounded to that type and kept in ``dtype`` (the whole-solve's bfloat16
    constants, cfd_tpu build_tail_consts(dtype=...)). A non-separable
    (masked) problem needs ``allow_full`` and keeps its whole 2D weights,
    zero-padded to the aligned shape (multigrid.py:169-182), or with
    ``aligned=False`` on the logical (ny+2, nx+2) shape (the natural masked
    solve's finest level)."""
    def t(a):
        w = torch.as_tensor(a, dtype=dtype, device=device)
        return w if round_to is None else w.to(round_to).to(dtype)
    if not _is_separable(p):
        if not allow_full:
            raise ValueError("aligned levels require separable weights")
        H, W = (_round_up8_128((p.ny + 2, p.nx + 2), dtype) if aligned
                else (p.ny + 2, p.nx + 2))
        pad = lambda w: np.pad(w, ((0, H - w.shape[0]), (0, W - w.shape[1])))
        return _Level(t(pad(p.wE)), t(pad(p.wW)), t(pad(p.wN)), t(pad(p.wS)),
                      1.0 / (p.dx * p.dx), 1.0 / (p.dy * p.dy), (H, W), p.ny, p.nx,
                      dtype, separable=False)
    H, W = _round_up8_128((p.ny + 2, p.nx + 2), dtype)
    wE = np.zeros((1, W))
    wE[0, 1 : p.nx + 1] = p.wE[1, 1 : p.nx + 1]
    wW = np.zeros((1, W))
    wW[0, 1 : p.nx + 1] = p.wW[1, 1 : p.nx + 1]
    wN = np.zeros((H, 1))
    wN[1 : p.ny + 1, 0] = p.wN[1 : p.ny + 1, 1]
    wS = np.zeros((H, 1))
    wS[1 : p.ny + 1, 0] = p.wS[1 : p.ny + 1, 1]
    return _Level(t(wE), t(wW), t(wN), t(wS), 1.0 / (p.dx * p.dx),
                  1.0 / (p.dy * p.dy), (H, W), p.ny, p.nx, dtype)


def build_problems(problem: PoissonProblem, cfg: MGConfig) -> list[PoissonProblem]:
    probs = [problem]
    while (probs[-1].nx % 2 == 0 and probs[-1].ny % 2 == 0
           and probs[-1].nx // 2 >= cfg.min_coarse and probs[-1].ny // 2 >= cfg.min_coarse):
        probs.append(coarsen_problem(probs[-1]))
    return probs


def tolerance_loop(p, b, max_b, cfg: MGConfig, cycle):
    """The reference's stopping rule (multigrid.py:836-849,883-885) in
    float32 around ``cycle(p, b) -> (p, res)``: tol = max(tol_factor *
    (max_b if max_b > 0 else 1), abs_tol); stop on res <= tol, on
    max_cycles, or when res >= stall_ratio * prev, with the finite sentinels
    1e30/2 and 1e30. Returns (p, cycles, res)."""
    if max_b is None:
        max_b = torch.max(torch.abs(b))
    max_b = np.float32(max_b.item())
    f32 = np.float32
    tol = max(f32(cfg.tol_factor) * (max_b if max_b > 0 else f32(1.0)),
              f32(cfg.abs_tol))
    stall = f32(cfg.stall_ratio)
    # finite sentinels, as the reference (not finfo.max)
    prev = f32(1e30)
    res = prev / f32(2.0)
    it = 0
    while res > tol and it < cfg.max_cycles and res < stall * prev:
        p, new_res = cycle(p, b)
        prev, res = res, f32(new_res.item())
        it += 1
    return p, it, res


class MultigridPoisson(nn.Module):
    """``solve(p4_warm, b4, max_b=None) -> (p4, cycles, res)`` with the
    quad-level-0 contract of cfd_tpu make_multigrid_poisson(aligned_io=True,
    quad_level0=...): p and b in the (4, Hq8, Wqa) quad layout, ``cycles``
    an int and ``res`` the final max|b - Ap| as a float32 host number.

    With ``quad_level0=None`` the contract of make_multigrid_poisson(
    aligned_io=True, use_pallas=True) without quad_level0 (multigrid.py:
    562-900): p and b on the natural aligned (H8, W) level 0, the warm start
    masked to the interior, a V-cycle of the level-0 pre-smooth with the
    residual field (``pre0``, RBPairs(with_residual_field=True)), the
    restriction, the coarse correction, the prolong-add and the post-smooth
    with the fused residual (``post0``, RBPairs(with_residual=True)); the
    tolerance loop reads that residual. The hierarchy needs 2 levels (the
    natural auto sizes, n = 14 mod 16, have exactly 2: level 1 then goes
    straight to the dense pinv). With ``cfg.coarse_dtype`` the restricted
    residual enters level 1 in bfloat16 and the bf16 correction is promoted
    in the prolong-add (multigrid.py:813-824). pin_mean off a pure-Neumann
    problem raises the reference's ValueError (:669-673), on the quad
    finest level as on the natural one.

    ``cfg.pin_mean`` shifts p to zero mean over its nx * ny cells after
    every cycle (module docstring). ``cfg.tail_from`` (global level index,
    taken when 1 <= tail_from <= levels - 2 and otherwise ignored, as
    multigrid.py:689-694) runs every level from there down as one launch of
    the fused tail (``tail``, kernels.mg_tail.MGTail). ``solve_rc`` is the
    quad_first_rc solve that follows the cavity's fused-pre carry.

    ``store_dtype`` (the whole-solve's twin, kernels.whole_solve, with
    ``cfg.coarse_dtype`` None): float32 levels whose weights and coarsest
    pinv are rounded to that type, and the V-cycle of
    run_tail_vcycle(store_dtype=...), cfd_tpu separable_vcycle_ctx with
    coarse_dtype. Not the per-kernel bfloat16 levels of cfg.coarse_dtype.

    Buffers: every level's coupling vectors (in the level's storage dtype)
    and the coarsest pseudo-inverse; with pin_mean the quad cell mask and
    the cell count ``n_interior`` as a 0-d float32 tensor."""

    def __init__(self, problem: PoissonProblem, cfg: MGConfig, quad_level0=None,
                 device="cpu", store_dtype: torch.dtype | None = None):
        super().__init__()
        coarse_dt = None
        if cfg.coarse_dtype is not None:
            if cfg.coarse_dtype not in ("bfloat16", "bf16"):
                raise ValueError(f"unsupported coarse_dtype {cfg.coarse_dtype!r}"
                                 " (only 'bfloat16')")
            if cfg.tail_from is not None:
                raise ValueError("coarse_dtype is incompatible with the fused coarse tail "
                                 "(tail_from) — the tail keeps its own in-VMEM f32 "
                                 "hierarchy")
            coarse_dt = torch.bfloat16
        if cfg.corr_opt:
            raise ValueError("corr_opt is a masked defect-correction knob — separable "
                             "hierarchies coarsen consistently (coarsen_problem "
                             "edge_fix) and do not take it")
        if cfg.pin_mean and not is_pure_neumann(problem):
            # multigrid.py:669-673, on the quad finest level as on the natural one
            raise ValueError("aligned_io requires the plain Pallas-smoothed separable "
                             "path (pin_mean only for pure-Neumann problems)")
        self.cfg = cfg
        self.coarse_dt = coarse_dt
        self.store_dtype = store_dtype
        probs = build_problems(problem, cfg)
        if quad_level0 is not None and len(probs) < 3:
            raise ValueError("the quad-level-0 hierarchy needs at least 3 levels")
        if len(probs) < 2:
            raise ValueError("the aligned hierarchy needs at least 2 levels (one factor-2 "
                             "coarsening)")
        self.levels = nn.ModuleList(
            _build_level(p, torch.float32 if k == 0 else (coarse_dt or torch.float32),
                         device, round_to=store_dtype if k > 0 else None)
            for k, p in enumerate(probs))
        self.register_buffer("pinv", _pinv_tensor(probs[-1], store_dtype, device))
        self.aligned = quad_level0 is None
        level0 = quad_level0
        if self.aligned:
            lv0 = self.levels[0]
            self.register_buffer("interior0", level_masks(lv0, device)[0])
            level0 = (rb_pairs_for_level(lv0, cfg.omega, cfg.pre_sweeps,
                                         with_residual_field=True),
                      rb_pairs_for_level(lv0, cfg.omega, cfg.post_sweeps, with_residual=True))
        if cfg.pin_mean:  # pure Neumann: the interior is the whole rectangle
            self.n_interior = problem.nx * problem.ny
            self.register_buffer("cell", self.interior0 if self.aligned
                                 else quad_cell_mask(problem.shape, device))
            self.register_buffer("n_int", torch.tensor(float(self.n_interior),
                                                       dtype=torch.float32, device=device))
        self.pre0, self.post0 = level0
        # coarse levels 1..L-2: pre-smooth + residual field, post-smooth
        inner = self.levels[1:-1]
        self.pre = nn.ModuleList(rb_pairs_for_level(lv, cfg.omega, cfg.pre_sweeps,
                                                    with_residual_field=True)
                                 for lv in inner)
        self.post = nn.ModuleList(rb_pairs_for_level(lv, cfg.omega, cfg.post_sweeps)
                                  for lv in inner)
        self.tail_from = None
        if cfg.tail_from is not None and 1 <= cfg.tail_from <= len(self.levels) - 2:
            self.tail_from = k = cfg.tail_from
            self.tail = MGTail(self.levels[k:], self.pre[k - 1 :], self.post[k - 1 :],
                               self.pinv)

    def coarse_solve(self, b: torch.Tensor) -> torch.Tensor:
        return dense_coarse_solve(self.levels[-1], self.pinv, b)

    def cycle(self, p: torch.Tensor, b: torch.Tensor, plain: bool = False):
        """One V-cycle from the finest level: (p, b) -> (p, res), then the
        mean pin when ``cfg.pin_mean`` (res is taken before it). ``plain``
        runs every kernel's plain twin whatever the device."""
        p, res = (self._vcycle_aligned if self.aligned else self._vcycle)(p, b, plain)
        if self.cfg.pin_mean:
            p = torch.where(self.cell, p - fixed_order_sum(p) / self.n_int, p)
        return p, res

    def _vcycle(self, p, b, plain):
        p, rc = self.pre0.plain(p, b) if plain else self.pre0(p, b)
        return self._coarse_and_post(p, b, rc, plain)

    def _coarse_and_post(self, p, b, rc, plain):
        """A V-cycle after the finest pre-smooth and restriction: the coarse
        correction from rc, then the prolongation and post-smooth."""
        rc_shape = rc.shape
        lv1 = self.levels[1]
        if self.coarse_dt is not None:
            # bf16 level 1 is 16-row aligned: pad the 8-aligned rc and cast,
            # then slice ec back and cast to f32 (multigrid.py:781-791)
            rc = torch.nn.functional.pad(
                rc, (0, lv1.shape[1] - rc_shape[1], 0, lv1.shape[0] - rc_shape[0])
            ).to(self.coarse_dt)
        ec = _coarse_correction(self, self.levels[1:], rc, plain)
        if self.coarse_dt is not None:
            ec = ec[: rc_shape[0], : rc_shape[1]].float().contiguous()
        return self.post0.plain(p, b, ec) if plain else self.post0(p, b, ec)

    def _vcycle_aligned(self, p, b, plain):
        """multigrid.py vcycle(0) without quad_level0 (:800-828)."""
        p, r = self.pre0.plain(p, b) if plain else self.pre0(p, b)
        lv0, lv1 = self.levels[0], self.levels[1]
        rc = _restrict(lv0, lv1, r)
        if self.coarse_dt is not None:
            rc = rc.to(self.coarse_dt)  # enter the bf16 correction path
        ec = _coarse_correction(self, self.levels[1:], rc, plain)
        p = p + _prolong(lv1, lv0, ec)  # a bf16 ec is promoted in the add
        return self.post0.plain(p, b) if plain else self.post0(p, b)

    def forward(self, p_warm: torch.Tensor, b: torch.Tensor, max_b=None):
        if self.aligned:  # the warm start masked to the interior (:843-847)
            p_warm = torch.where(self.interior0, p_warm, torch.zeros_like(p_warm))
        return tolerance_loop(p_warm, b, max_b, self.cfg, self.cycle)

    def solve_rc(self, p1: torch.Tensor, b: torch.Tensor, rc0: torch.Tensor, max_b=None):
        """The solve after the fused carry (kernels.quad
        QuadCorrPredictorSourceFusedPre), cfd_tpu make_multigrid_poisson(
        quad_first_rc=True), multigrid.py:888-918: the first cycle's finest
        pre-smooth and restriction are done, so cycle 1 starts at the coarse
        stage with ``rc0`` from the pre-smoothed ``p1``; cycles >= 2 are
        regular V-cycles; the stop rule is tolerance_loop's. Returns (p,
        cycles, res). The quad finest level and no pin_mean only (the
        reference's ValueError)."""
        if self.aligned or self.cfg.pin_mean:
            raise ValueError("quad_first_rc requires quad_level0 and pin_mean=False (the "
                             "fused carry kernel owns the first pre-smooth)")
        first = [rc0]

        def cycle(p, b):
            if first:
                return self._coarse_and_post(p, b, first.pop(), False)
            return self._vcycle(p, b, False)

        return tolerance_loop(p1, b, max_b, self.cfg, cycle)


def _pinv_tensor(p: PoissonProblem, round_to: torch.dtype | None, device) -> torch.Tensor:
    """The coarsest pseudo-inverse in float32, with ``round_to`` rounded to
    that type first (cfd_tpu build_tail_consts(dtype=...))."""
    pinv = torch.as_tensor(_dense_pinv(p), dtype=torch.float32, device=device)
    return pinv if round_to is None else pinv.to(round_to).float()


def _coarse_correction(mg, coarse, rc, plain):
    """The correction on ``coarse[0]`` (global level 1) from its source rc:
    run_tail_vcycle over the coarse levels down to the fused tail's first
    level, which ``mg.tail`` solves in one launch, or down to the coarsest,
    which the dense pinv solves. ``mg.tail_from`` is a global index, and
    coarse[k] is global level k + 1."""
    if mg.tail_from is None:
        return run_tail_vcycle(coarse, rc, mg.pre, mg.post, mg.coarse_solve, plain=plain,
                               store_dtype=mg.store_dtype)
    tail = mg.tail.plain if plain else mg.tail
    return run_tail_vcycle(coarse[: mg.tail_from], rc, mg.pre, mg.post, tail, plain=plain)


def make_multigrid_poisson(problem: PoissonProblem, cfg: MGConfig, quad_level0=None,
                           device="cpu") -> MultigridPoisson:
    """The separable solve: the quad finest level when ``quad_level0`` is
    given, else the natural aligned one (MultigridPoisson)."""
    return MultigridPoisson(problem, cfg, quad_level0, device)


def masked_channel_problem(grid, dx: float, dy: float) -> PoissonProblem:
    """Weighted operator of a masked grid with channel domain BCs
    (cfd_tpu multigrid.py:930-944): fluid-fluid couplings 1, couplings
    through solid cells 0, inlet/wall Neumann, outlet Dirichlet-0. The
    COARSE-hierarchy operator of the step's defect correction."""
    f = grid.fluid.astype(np.float64)
    nx, ny = grid.nx, grid.ny
    wE = f * np.roll(f, -1, axis=1)
    wW = f * np.roll(f, 1, axis=1)
    wN = f * np.roll(f, -1, axis=0)
    wS = f * np.roll(f, 1, axis=0)
    wE[1 : ny + 1, nx] = grid.fluid[1 : ny + 1, nx]  # outlet Dirichlet-0 ghost
    return PoissonProblem(nx, ny, dx, dy, wE, wW, wN, wS)


def step_rect_params(grid) -> tuple[int, int] | None:
    """(step_i, inlet_j_max) when the grid's solid raster is exactly the
    backward-step rectangle {i <= step_i and j > inlet_j_max}
    (backwards_step-01.cpp:499-520, cfd_tpu multigrid.py:947-965), else
    None."""
    nx, ny = grid.nx, grid.ny
    solid = ~grid.fluid[1 : ny + 1, 1 : nx + 1]
    if not solid.any():
        return None
    jj, ii = np.nonzero(solid)
    step_i = int(ii.max()) + 1  # back to 1-based padded indexing
    inlet_j_max = int(jj.min())  # the first solid row is inlet_j_max + 1
    jj1 = np.arange(1, ny + 1)[:, None]
    ii1 = np.arange(1, nx + 1)[None, :]
    if (solid == ((ii1 <= step_i) & (jj1 > inlet_j_max))).all():
        return step_i, inlet_j_max
    return None


class MaskedQuadMultigridPoisson(nn.Module):
    """The step's defect-correction solve (cfd_tpu
    make_masked_quad_multigrid_poisson, multigrid.py:1042-1181) with the
    quad-level-0 contract of MultigridPoisson: the finest level smooths
    and measures the residual with the EXACT operator (kernels.step_quad
    pre/post: ghost refresh with solid-cell averaging), the aligned coarse
    levels 1.. use the weighted masked approximation with full-2D weights
    (kernels.rb_smoother full mode), and the level-1 correction is
    solid-filled before the fine prolongation.

    ``cfg.tail_from`` (global: coarse index tail_from - 1, taken when it is
    a level above the coarsest and otherwise ignored, multigrid.py:1104-1111)
    runs those levels as one launch of the fused tail. ``cfg.corr_opt``
    scales the level-1 correction by _corr_alpha before the solid fill.
    ``cfg.pin_mean`` is ignored, as the reference's masked solves never read
    it. ``store_dtype``: the masked whole-solve's twin with its bfloat16
    rounding points (MultigridPoisson); corr_opt then still reads the
    unrounded rc.

    ``levels`` holds the coarse levels only (levels[0] is global level 1).
    Buffers: their weight arrays and the coarsest pseudo-inverse."""

    def __init__(self, problem: PoissonProblem, cfg: MGConfig, quad_level0,
                 device="cpu", store_dtype: torch.dtype | None = None):
        super().__init__()
        if cfg.coarse_dtype is not None:
            raise ValueError("coarse_dtype is not supported on the masked "
                             "(defect-correction) hierarchy")
        probs = build_problems(problem, cfg)
        if len(probs) < 2:
            raise ValueError("grid too small for the quad masked hierarchy")
        self.cfg = cfg
        self.store_dtype = store_dtype
        self.levels = nn.ModuleList(_build_level(p, torch.float32, device, allow_full=True,
                                                 round_to=store_dtype)
                                    for p in probs[1:])
        self.register_buffer("pinv", _pinv_tensor(probs[-1], store_dtype, device))
        self.pre0, self.post0 = quad_level0
        if self.levels[0].shape != self.pre0.coarse_shape:
            raise ValueError(f"aligned coarse shape {self.levels[0].shape} != quad "
                             f"plane shape {self.pre0.coarse_shape}")
        inner = self.levels[:-1]
        self.pre = nn.ModuleList(rb_pairs_for_level(lv, cfg.omega, cfg.pre_sweeps,
                                                    with_residual_field=True)
                                 for lv in inner)
        self.post = nn.ModuleList(rb_pairs_for_level(lv, cfg.omega, cfg.post_sweeps)
                                  for lv in inner)
        self.tail_from = None
        if cfg.tail_from is not None and 0 <= cfg.tail_from - 1 <= len(self.levels) - 2:
            self.tail_from = cfg.tail_from  # global; levels[k] is global level k + 1
            k = cfg.tail_from - 1
            self.tail = MGTail(self.levels[k:], self.pre[k:], self.post[k:], self.pinv)

    def coarse_solve(self, b: torch.Tensor) -> torch.Tensor:
        return dense_coarse_solve(self.levels[-1], self.pinv, b)

    def cycle(self, p: torch.Tensor, b: torch.Tensor, plain: bool = False):
        """One V-cycle: (p4, b4) -> (p4, res). ``plain`` runs every kernel's
        plain twin whatever the device."""
        p, rc = self.pre0.plain(p, b) if plain else self.pre0(p, b)
        ec = _coarse_correction(self, self.levels, rc, plain)
        if self.cfg.corr_opt:
            ec = _corr_alpha(self.levels[0], rc, ec) * ec
        # the post kernel's 1 -> 0 prolongation is mask-blind: Neumann-extend
        # the correction into the level-1 solid cells first (multigrid.py:1170)
        ec = _solid_fill(self.levels[0], ec)
        return self.post0.plain(p, b, ec) if plain else self.post0(p, b, ec)

    def forward(self, p_warm: torch.Tensor, b: torch.Tensor, max_b=None):
        return tolerance_loop(p_warm, b, max_b, self.cfg, self.cycle)


def _corr_alpha(level, rc: torch.Tensor, ec: torch.Tensor) -> torch.Tensor:
    """corr_opt's clamped steplength of the level-1 correction (cfd_tpu
    multigrid._corr_alpha, :501-519, and the whole-solve's in-kernel twin,
    whole_solve.py:379-398): alpha = clip(<rc, A ec>/<A ec, A ec>, 1, 1.5)
    with A the level's weighted operator on its active cells, and alpha = 1
    where the denominator is 0. Both sums are fixed_order_sum's, so every
    device and the whole-solve kernel round them alike. A 0-d float32
    tensor on ec's device."""
    wE, wW, wN, wS = level.wE, level.wW, level.wN, level.wS
    roll = lambda a, s, d: torch.roll(a, s, dims=d)
    ap = (level.idx2 * (wE * (roll(ec, -1, 1) - ec) + wW * (roll(ec, 1, 1) - ec))
          + level.idy2 * (wN * (roll(ec, -1, 0) - ec) + wS * (roll(ec, 1, 0) - ec)))
    aec = torch.where(level_masks(level, ec.device)[1], ap, torch.zeros_like(ap))
    num = fixed_order_sum(rc * aec)
    den = fixed_order_sum(aec * aec)
    one = torch.ones_like(den)
    raw = torch.where(den > 0, num / torch.where(den > 0, den, one), one)
    return torch.clamp(raw, 1.0, 1.5)


def make_masked_quad_multigrid_poisson(grid, coeffs, cfg: MGConfig, device="cpu",
                                       store_dtype: torch.dtype | None = None
                                       ) -> MaskedQuadMultigridPoisson:
    """The per-kernel masked solve of a step-rectangle grid: the
    kernels.step_quad level-0 pair over masked_channel_problem's hierarchy
    (``store_dtype``: the whole-solve twin's rounding, see
    MaskedQuadMultigridPoisson). Raises ValueError when the raster is not
    the step rectangle or level 1 does not coincide with the quad plane
    shape."""
    from cfd_tpu_torch.kernels.quad import quad_dims
    from cfd_tpu_torch.kernels.step_quad import (
        make_quad_step_post_prolong_smooth,
        make_quad_step_pre_smooth_restrict,
    )

    rect = step_rect_params(grid)
    if rect is None:
        raise ValueError("the quad masked multigrid needs the step rectangle raster")
    _, _, Hq8, Wqa = quad_dims(grid.shape)
    kw = dict(shape=grid.shape, step_i=rect[0], inlet_j=rect[1], idx2=coeffs.idx2,
              idy2=coeffs.idy2, omega=cfg.omega, coarse_shape=(Hq8, Wqa), device=device)
    l0 = (make_quad_step_pre_smooth_restrict(n_pairs=cfg.pre_sweeps, **kw),
          make_quad_step_post_prolong_smooth(n_pairs=cfg.post_sweeps, **kw))
    return MaskedQuadMultigridPoisson(masked_channel_problem(grid, coeffs.dx, coeffs.dy),
                                      cfg, l0, device, store_dtype)


class MaskedMultigridPoisson(nn.Module):
    """The step's defect-correction solve on the natural layout (cfd_tpu
    make_masked_multigrid_poisson, multigrid.py:968-1041): ``solve(p_warm,
    b, max_b=None) -> (p, cycles, res)`` with p and b on the logical
    (ny+2, nx+2) grid.

    The finest level smooths and measures the residual with the EXACT
    operator (kernels.step_smoother: the pre-smooth with the residual field,
    the post-smooth with its max, the reference's exact_level0_fused; their
    plain twin is its smooth0 / residual0), the coarse levels 1.. use the
    weighted masked approximation with full-2D weights, smoothed by
    RBPairs (the full-2D kernel on the card, cfd_rb_pairs_full, whose twin
    is the reference's XLA smoother of these levels: the reference's
    ``use_pallas="auto"`` is False on them, :631-636), with the transfers
    as glue. A natural step size (ny = 14 mod 16 or nx = 254 mod 256)
    makes ny / 2 or nx / 2 odd, so its hierarchy has 2 levels and the dense
    pinv is its only coarse level; grids built here directly may have
    more. ``tail_from`` is ignored (:689-694). The warm start is not masked
    (:846-847). ``cfg.corr_opt`` scales the level-1 correction by
    _corr_alpha. float32 only; ``coarse_dtype`` raises the reference's
    ValueError (it needs the aligned path, :652-654) and pin_mean is
    ignored, as the reference's masked solves never read it.

    ``top`` is the finest level on the logical shape (full 2D weights);
    ``levels`` holds the coarse levels (levels[0] is global level 1)."""

    def __init__(self, grid, coeffs, cfg: MGConfig, device="cpu"):
        super().__init__()
        from cfd_tpu_torch.kernels.step_smoother import make_step_masked_pairs

        if cfg.coarse_dtype is not None:
            raise ValueError("coarse_dtype requires the aligned/quad f32 Pallas path "
                             "(aligned_io=True)")
        rect = step_rect_params(grid)
        if rect is None:
            raise ValueError("the natural masked multigrid needs the step rectangle raster")
        probs = build_problems(masked_channel_problem(grid, coeffs.dx, coeffs.dy), cfg)
        if len(probs) < 2:
            raise ValueError("grid too small for the masked hierarchy")
        self.cfg = cfg
        self.top = _build_level(probs[0], torch.float32, device, allow_full=True,
                                aligned=False)
        self.levels = nn.ModuleList(_build_level(p, torch.float32, device, allow_full=True)
                                    for p in probs[1:])
        self.register_buffer("pinv", _pinv_tensor(probs[-1], None, device))
        kw = dict(shape=grid.shape, step_i=rect[0], inlet_j_max=rect[1], idx2=coeffs.idx2,
                  idy2=coeffs.idy2, omega=cfg.omega, device=device)
        self.pre0 = make_step_masked_pairs(n_pairs=cfg.pre_sweeps, with_residual_field=True,
                                           **kw)
        self.post0 = make_step_masked_pairs(n_pairs=cfg.post_sweeps, with_residual=True,
                                            **kw)
        inner = self.levels[:-1]
        self.pre = nn.ModuleList(rb_pairs_for_level(lv, cfg.omega, cfg.pre_sweeps,
                                                    with_residual_field=True)
                                 for lv in inner)
        self.post = nn.ModuleList(rb_pairs_for_level(lv, cfg.omega, cfg.post_sweeps)
                                  for lv in inner)

    def coarse_solve(self, b: torch.Tensor) -> torch.Tensor:
        return dense_coarse_solve(self.levels[-1], self.pinv, b)

    def cycle(self, p: torch.Tensor, b: torch.Tensor, plain: bool = False):
        """One V-cycle (multigrid.py vcycle(0) with exact_level0_fused,
        :800-828): (p, b) -> (p, res). ``plain`` runs every kernel's plain
        twin whatever the device."""
        p, r = self.pre0.plain(p, b) if plain else self.pre0(p, b)
        rc = _restrict(self.top, self.levels[0], r)
        ec = run_tail_vcycle(self.levels, rc, self.pre, self.post, self.coarse_solve,
                             plain=plain)
        if self.cfg.corr_opt:
            ec = _corr_alpha(self.levels[0], rc, ec) * ec
        p = p + _prolong(self.levels[0], self.top, ec)
        return self.post0.plain(p, b) if plain else self.post0(p, b)

    def forward(self, p_warm: torch.Tensor, b: torch.Tensor, max_b=None):
        return tolerance_loop(p_warm, b, max_b, self.cfg, self.cycle)


def make_masked_multigrid_poisson(grid, coeffs, cfg: MGConfig,
                                  device="cpu") -> MaskedMultigridPoisson:
    """The natural-layout masked solve of a step-rectangle grid
    (MaskedMultigridPoisson)."""
    return MaskedMultigridPoisson(grid, coeffs, cfg, device)
