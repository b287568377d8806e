"""Quad (2x2 block-parity) layout and the quad-layout kernels of the cavity
and channel fast paths (the port of cfd_tpu.kernels.quad).

Layout: four quarter-resolution planes per field, indexed by the (row,
column) parity of the logical cell, ``Q[2r+s][J, I] = a[2J+r, 2I+s]``,
padded to (4, Hq8, Wqa) with ``Hq8 = round_up(ceil(H/2), 8)`` and
``Wqa = round_up(ceil(W/2), 128)``. The port keeps the JAX shapes at every
public function, padding included, so the tests compare element by
element; whether Hopper wants the padding is a later, measured choice.

Each kernel has three faces:

* ``plain(...)`` — a whole-array PyTorch transliteration of the Pallas
  ``compute`` (torch.roll + torch.where; no slabs, no bands), usable on any
  device. The CPU tests hold it against the JAX kernels in interpret mode
  and chip_smoke.py holds the CUDA kernel against it on the card.
* ``kernel(...)`` — the hand-written CUDA kernel (csrc/quad_stage.cu,
  csrc/quad_vcycle.cu, csrc/quad_fused_pre.cu); CUDA tensors only.
* ``__call__`` — dispatch on the tensors' device: the CPU goes to
  ``plain``, CUDA to ``kernel``. No fallback: a failed build or launch
  raises.

Adaptive stepping adds the ``traced_dt`` instances (dt a float32 tensor on
the fields' device, read by the kernel from the card, never a host float):
the correctors take one dt, the carries the pair (dt_corr, dt_pred) and
also return max|u| and max|v| of the corrected fields (``emit_courant``),
and the cavity's non-carry stage ``make_quad_predictor_source`` takes one
dt. Their twins form the dt-derived coefficients in the reference's float32
order: the cavity's dt * (rho/dx), the channel's dt / (rho*dx), rho / dt;
every division is by a device tensor (PyTorch turns a Python divisor of a
CUDA tensor, and a Python dividend, into a reciprocal multiply).

The TPU kernels' slab/halo/band machinery (quad.py:132-417, _band_maker
:611-627) exists for a sequential grid with large VMEM and is not ported
as such; the cavity's and the channel's carry kernels keep its idea, the
whole chain on chip, in shared-memory tiles (csrc/carry_tile.cuh, planned
by kernels/plan.py carry_plan).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
from torch import nn

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.mg_tail import fold_sum
from cfd_tpu_torch.kernels.plan import (carry_plan, fused_pre_plan, level0_plan, ready_grid,
                                        ready_tiles)
from cfd_tpu_torch.ops.stencil import StencilCoeffs

CARRY = Kernel("quad_corr_predictor_source", "cfd_quad_carry",
               "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:938")
CORRECTOR = Kernel("quad_corrector", "cfd_quad_corrector",
                   "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:488")
PRE = Kernel("quad_pre_smooth_restrict", "cfd_quad_pre_smooth_restrict",
             "cfd_tpu_torch/csrc/quad_vcycle.cu", "cfd_tpu/kernels/quad.py:630")
POST = Kernel("quad_post_prolong_smooth", "cfd_quad_post_prolong_smooth",
              "cfd_tpu_torch/csrc/quad_vcycle.cu", "cfd_tpu/kernels/quad.py:700")
CHANNEL_CARRY = Kernel("quad_channel_corr_predictor_source", "cfd_quad_channel_carry",
                       "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:1126")
CHANNEL_CORRECTOR = Kernel("quad_channel_corrector", "cfd_quad_channel_corrector",
                           "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:892")
PREDICTOR_SOURCE = Kernel("quad_predictor_source", "cfd_quad_predictor_source",
                          "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:438")
CORRECTOR_TRACED = Kernel("quad_corrector_traced", "cfd_quad_corrector_traced",
                          "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:488")
CARRY_ADAPTIVE = Kernel("quad_corr_predictor_source_adaptive", "cfd_quad_carry_adaptive",
                        "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:938")
CHANNEL_CORRECTOR_TRACED = Kernel("quad_channel_corrector_traced",
                                  "cfd_quad_channel_corrector_traced",
                                  "cfd_tpu_torch/csrc/quad_stage.cu",
                                  "cfd_tpu/kernels/quad.py:892")
CHANNEL_CARRY_ADAPTIVE = Kernel("quad_channel_corr_predictor_source_adaptive",
                                "cfd_quad_channel_carry_adaptive",
                                "cfd_tpu_torch/csrc/quad_stage.cu",
                                "cfd_tpu/kernels/quad.py:1126")
CHANNEL_PREDICTOR_SOURCE = Kernel("quad_channel_predictor_source",
                                  "cfd_quad_channel_predictor_source",
                                  "cfd_tpu_torch/csrc/quad_stage.cu",
                                  "cfd_tpu/kernels/quad.py:847")
FUSED_PRE = Kernel("quad_corr_predictor_source_fused_pre", "cfd_quad_fused_pre",
                   "cfd_tpu_torch/csrc/quad_fused_pre.cu", "cfd_tpu/kernels/quad.py:985")
# the same entry points on one shard's local block of the plane-row mesh
# (parallel.quad_sharded), counted apart
SHARD_CARRY = Kernel("quad_corr_predictor_source_shard", "cfd_quad_carry",
                     "cfd_tpu_torch/csrc/quad_stage.cu", "cfd_tpu/kernels/quad.py:938 (shard=)")
SHARD_PRE = Kernel("quad_pre_smooth_restrict_shard", "cfd_quad_pre_smooth_restrict",
                   "cfd_tpu_torch/csrc/quad_vcycle.cu", "cfd_tpu/kernels/quad.py:630 (shard=)")
SHARD_POST = Kernel("quad_post_prolong_smooth_shard", "cfd_quad_post_prolong_smooth",
                    "cfd_tpu_torch/csrc/quad_vcycle.cu", "cfd_tpu/kernels/quad.py:700 (shard=)")
SHARD_CHANNEL_CARRY = Kernel("quad_channel_corr_predictor_source_shard",
                             "cfd_quad_channel_carry", "cfd_tpu_torch/csrc/quad_stage.cu",
                             "cfd_tpu/kernels/quad.py:1126 (shard=)")
# the traced-dt + Courant carries on one shard's local block (rows 16a+,
# 16d+: the sharded lagged controller), counted apart
SHARD_CARRY_ADAPTIVE = Kernel("quad_corr_predictor_source_shard_adaptive",
                              "cfd_quad_carry_adaptive", "cfd_tpu_torch/csrc/quad_stage.cu",
                              "cfd_tpu/kernels/quad.py:938 (shard=, traced_dt)")
SHARD_CHANNEL_CARRY_ADAPTIVE = Kernel("quad_channel_corr_predictor_source_shard_adaptive",
                                      "cfd_quad_channel_carry_adaptive",
                                      "cfd_tpu_torch/csrc/quad_stage.cu",
                                      "cfd_tpu/kernels/quad.py:1126 (shard=, traced_dt)")

# threads per block of the stage kernels (cfd::kThreads): the block size of
# the fixed-order source sum
SUM_BLOCK = 256
# the halo strip of a sharded local block, in plane rows
# (cfd_tpu/parallel/quad_sharded.py:68): the TPU kernels' slab halo
DEV_HALO = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def quad_dims(shape: tuple[int, int]) -> tuple[int, int, int, int]:
    """(Hq, Wq, Hq8, Wqa): logical and aligned plane dims for a logical
    padded (H, W) grid."""
    H, W = shape
    Hq, Wq = -(-H // 2), -(-W // 2)
    return Hq, Wq, _round_up(Hq, 8), _round_up(Wq, 128)


def quad_shape(shape: tuple[int, int]) -> tuple[int, int, int]:
    _, _, Hq8, Wqa = quad_dims(shape)
    return (4, Hq8, Wqa)


def to_quad(a: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(H, W) natural -> (4, Hq8, Wqa) quad (boundary-only: init/resume)."""
    H, W = shape
    Hq, Wq, Hq8, Wqa = quad_dims(shape)
    ap = torch.nn.functional.pad(a, (0, 2 * Wq - W, 0, 2 * Hq - H))
    g = ap.reshape(Hq, 2, Wq, 2)
    planes = torch.stack([g[:, 0, :, 0], g[:, 0, :, 1], g[:, 1, :, 0], g[:, 1, :, 1]])
    return torch.nn.functional.pad(planes, (0, Wqa - Wq, 0, Hq8 - Hq)).contiguous()


def from_quad(q: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(4, Hq8, Wqa) quad -> (H, W) natural (inverse of to_quad)."""
    H, W = shape
    Hq, Wq, _, _ = quad_dims(shape)
    p = q[:, :Hq, :Wq]
    g = torch.stack([torch.stack([p[0], p[1]], dim=-1),
                     torch.stack([p[2], p[3]], dim=-1)], dim=1)
    return g.reshape(2 * Hq, 2 * Wq)[:H, :W].contiguous()


def uncorrect_quad(u, v, p, shape, coeffs: StencilCoeffs, cavity_form: bool = True,
                   dt: float | None = None):
    """Inverse of the pressure correction on NATURAL arrays (resume boundary
    only): us = u + c*(pE - p) on valid faces, 0 elsewhere, so
    correct(uncorrect(u, v, p), p) == (u, v) up to one f32 rounding. The
    cavity form multiplies by rho (cavity-01.cpp:701), the channel form
    divides (channel-01.cpp:693-702). ``dt`` (a Python float) overrides
    coeffs.dt: the adaptive carry enters with the dt that its first step
    re-corrects with (cfd_tpu/kernels/quad.py:1225)."""
    H, Wp = shape
    ny, nx = H - 2, Wp - 2
    dt_ = coeffs.dt if dt is None else dt
    if cavity_form:
        cu = dt_ / coeffs.dx * coeffs.density
        cv = dt_ / coeffs.dy * coeffs.density
    else:
        cu = dt_ / (coeffs.density * coeffs.dx)
        cv = dt_ / (coeffs.density * coeffs.dy)
    jj = torch.arange(H, device=u.device)[:, None]
    ii = torch.arange(Wp, device=u.device)[None, :]
    u_valid = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx - 1)
    v_valid = (jj >= 1) & (jj <= ny - 1) & (ii >= 1) & (ii <= nx)
    pE = torch.roll(p, -1, dims=1)
    pN = torch.roll(p, -1, dims=0)
    zero = torch.zeros_like(u)
    return (torch.where(u_valid, u + cu * (pE - p), zero),
            torch.where(v_valid, v + cv * (pN - p), zero))


# ---------------------------------------------------------------- plain math

def _qshift(planes, dj: int, di: int):
    """shifted[q][J, I] = a[2J+r+dj, 2I+s+di] (roll convention: consumers
    mask the wraparound). Only planes whose parity carries need a roll."""
    out = [None] * 4
    for r in range(2):
        for s in range(2):
            rp, cj = (r + dj) % 2, (r + dj) // 2
            sp, ci = (s + di) % 2, (s + di) // 2
            a = planes[2 * rp + sp]
            if cj:
                a = torch.roll(a, -cj, dims=0)
            if ci:
                a = torch.roll(a, -ci, dims=1)
            out[2 * r + s] = a
    return out


def _qiota(Hq8: int, Wqa: int, device, row0: int = 0):
    """Per-plane global (row, col) index arrays: grow[q] = 2J + r,
    gcol[q] = 2I + s, with J = row0 + the array's plane row (row0: a local
    block's global plane row of its row 0)."""
    J = row0 + torch.arange(Hq8, device=device)[:, None]
    I = torch.arange(Wqa, device=device)[None, :]
    return ([2 * J + (q >> 1) for q in range(4)], [2 * I + (q & 1) for q in range(4)])


def quad_cell_mask(shape, device) -> torch.Tensor:
    """(4, Hq8, Wqa) bool: the interior cells of the padded (H, W) grid, in
    the quad layout."""
    _, Hq8, Wqa = quad_shape(shape)
    grow, gcol = _qiota(Hq8, Wqa, device)
    return torch.stack(_valid_masks(grow, gcol, shape[0] - 2, shape[1] - 2)[2])


def _where4(conds, vals, planes):
    return [torch.where(c, v, p) for c, v, p in zip(conds, vals, planes)]


def _cavity_bc_quad(u, v, grow, gcol, ny: int, nx: int, lid: float):
    """Lid-cavity ghosts in quad form, the reference's update order
    (cfd_tpu/kernels/quad.py:420-435)."""
    uS = _qshift(u, -1, 0)
    u = _where4([(g == ny + 1) & (c <= nx) for g, c in zip(grow, gcol)],
                [2.0 * lid - a for a in uS], u)
    uN = _qshift(u, 1, 0)
    u = _where4([(g == 0) & (c <= nx) for g, c in zip(grow, gcol)], [-a for a in uN], u)
    vE = _qshift(v, 0, 1)
    v = _where4([(c == 0) & (g <= ny) for g, c in zip(grow, gcol)], [-a for a in vE], v)
    vW = _qshift(v, 0, -1)
    v = _where4([(c == nx + 1) & (g <= ny) for g, c in zip(grow, gcol)],
                [-a for a in vW], v)
    return u, v


def _channel_bc_quad(u, v, grow, gcol, ny: int, nx: int, uin: float):
    """Channel ghosts in quad form, the reference's update order
    (cfd_tpu/kernels/quad.py:781-805): inlet column, outlet column copied
    from nx-1, bottom-wall v, u ghost row 0 (reading the updated inlet and
    outlet columns), top-wall v, u ghost row ny+1."""
    u = _where4([(c == 0) & (g >= 1) & (g <= ny) for g, c in zip(grow, gcol)],
                [torch.full_like(a, uin) for a in u], u)
    v = _where4([(c == 0) & (g <= ny) for g, c in zip(grow, gcol)],
                [torch.zeros_like(a) for a in v], v)
    uW = _qshift(u, 0, -1)
    u = _where4([(c == nx) & (g >= 1) & (g <= ny) for g, c in zip(grow, gcol)], uW, u)
    vW = _qshift(v, 0, -1)
    v = _where4([(c == nx + 1) & (g <= ny) for g, c in zip(grow, gcol)], vW, v)
    v = _where4([(g == 0) & (c >= 1) & (c <= nx) for g, c in zip(grow, gcol)],
                [torch.zeros_like(a) for a in v], v)
    uN = _qshift(u, 1, 0)
    u = _where4([(g == 0) & (c <= nx) for g, c in zip(grow, gcol)], [-a for a in uN], u)
    v = _where4([(g == ny) & (c >= 1) & (c <= nx) for g, c in zip(grow, gcol)],
                [torch.zeros_like(a) for a in v], v)
    uS = _qshift(u, -1, 0)
    u = _where4([(g == ny + 1) & (c <= nx) for g, c in zip(grow, gcol)],
                [-a for a in uS], u)
    return u, v


def _valid_masks(grow, gcol, ny: int, nx: int):
    u_valid = [(g >= 1) & (g <= ny) & (c >= 1) & (c <= nx - 1) for g, c in zip(grow, gcol)]
    v_valid = [(g >= 1) & (g <= ny - 1) & (c >= 1) & (c <= nx) for g, c in zip(grow, gcol)]
    cell = [(g >= 1) & (g <= ny) & (c >= 1) & (c <= nx) for g, c in zip(grow, gcol)]
    return u_valid, v_valid, cell


def scalar_like(x: float, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-d float32 tensor on ``like``'s device (a divisor or dividend
    that stays a true division on every device)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def traced_coeff(dt: torch.Tensor, factor: float, divided: bool) -> torch.Tensor:
    """A correction coefficient from a traced dt in the reference's float32
    order: dt * f32(rho/dx) (the cavity form) or dt / f32(rho*dx) (the
    channel, step and RB form); csrc/common.cuh cfd::traced_coeff."""
    return dt / scalar_like(factor, dt) if divided else dt * factor


def rho_over(c: StencilCoeffs, dt: torch.Tensor | None):
    """rho/dt of the source: the host's double for the fixed dt, f32(rho) /
    dt for a traced dt (quad.py:457)."""
    return c.density / c.dt if dt is None else scalar_like(c.density, dt) / dt


def _predictor_quad(u, v, c: StencilCoeffs, dt=None):
    """MAC predictor over quad planes (cavity-01.cpp:548-603), the JAX
    package's operation order (cfd_tpu/kernels/quad.py:808-844). ``dt``
    (a 0-d tensor) overrides c.dt: the traced-dt instances."""
    nu = c.viscosity
    dt = c.dt if dt is None else dt
    idx, idy, idx2, idy2 = c.idx, c.idy, c.idx2, c.idy2
    uE, uW = _qshift(u, 0, 1), _qshift(u, 0, -1)
    uN, uS = _qshift(u, 1, 0), _qshift(u, -1, 0)
    vE, vW = _qshift(v, 0, 1), _qshift(v, 0, -1)
    vN, vS = _qshift(v, 1, 0), _qshift(v, -1, 0)
    vSE = _qshift(v, -1, 1)
    uNW = _qshift(u, 1, -1)
    us, vs = [], []
    for q in range(4):
        lap_u = (uE[q] - 2.0 * u[q] + uW[q]) * idx2 + (uN[q] - 2.0 * u[q] + uS[q]) * idy2
        u_e = 0.5 * (u[q] + uE[q])
        u_w = 0.5 * (uW[q] + u[q])
        conv_ux = (u_e * u_e - u_w * u_w) * idx
        v_n = 0.5 * (v[q] + vE[q])
        v_s = 0.5 * (vS[q] + vSE[q])
        u_n = 0.5 * (uN[q] + u[q])
        u_s = 0.5 * (uS[q] + u[q])
        conv_uy = (v_n * u_n - v_s * u_s) * idy
        us.append(u[q] + dt * (nu * lap_u - conv_ux - conv_uy))
        lap_v = (vE[q] - 2.0 * v[q] + vW[q]) * idx2 + (vN[q] - 2.0 * v[q] + vS[q]) * idy2
        v_nn = 0.5 * (v[q] + vN[q])
        v_ss = 0.5 * (vS[q] + v[q])
        conv_vy = (v_nn * v_nn - v_ss * v_ss) * idy
        u_e2 = 0.5 * (u[q] + uN[q])
        u_w2 = 0.5 * (uW[q] + uNW[q])
        v_e2 = 0.5 * (v[q] + vE[q])
        v_w2 = 0.5 * (vW[q] + v[q])
        conv_vx = (u_e2 * v_e2 - u_w2 * v_w2) * idx
        vs.append(v[q] + dt * (nu * lap_v - conv_vy - conv_vx))
    return us, vs


def _project_quad(us, vs, p, p_prev, grow, gcol, ny, nx, cu, cv):
    """The pressure correction on valid faces (0 elsewhere) and the
    extrapolated guess 2p - p_prev; the ghosts are the caller's."""
    u_valid, v_valid, _ = _valid_masks(grow, gcol, ny, nx)
    pE, pN = _qshift(p, 0, 1), _qshift(p, 1, 0)
    u, v, guess = [], [], []
    for q in range(4):
        zero = torch.zeros_like(us[q])
        u.append(torch.where(u_valid[q], us[q] - cu * (pE[q] - p[q]), zero))
        v.append(torch.where(v_valid[q], vs[q] - cv * (pN[q] - p[q]), zero))
        guess.append(2.0 * p[q] - p_prev[q])
    return u, v, guess


def _predictor_source_quad(u, v, c: StencilCoeffs, grow, gcol, ny, nx, bc=None, dt=None):
    """MAC predictor on valid faces (0 elsewhere), the ghost update ``bc`` on
    the tentative fields, and b = rho/dt * div on the cells (``dt``: a
    traced dt, else c.dt)."""
    us_raw, vs_raw = _predictor_quad(u, v, c, dt)
    u_valid, v_valid, cell = _valid_masks(grow, gcol, ny, nx)
    zero = torch.zeros_like(u[0])
    us2 = [torch.where(u_valid[q], us_raw[q], zero) for q in range(4)]
    vs2 = [torch.where(v_valid[q], vs_raw[q], zero) for q in range(4)]
    if bc is not None:
        us2, vs2 = bc(us2, vs2)
    usW = _qshift(us2, 0, -1)
    vsS = _qshift(vs2, -1, 0)
    rho_dt = rho_over(c, dt)
    b = []
    for q in range(4):
        div = (us2[q] - usW[q]) * c.idx + (vs2[q] - vsS[q]) * c.idy
        b.append(torch.where(cell[q], rho_dt * div, torch.zeros_like(div)))
    return torch.stack(us2), torch.stack(vs2), torch.stack(b)


def fixed_order_sum(b: torch.Tensor) -> torch.Tensor:
    """Sum of a quad field in the stage kernels' fixed order: the flat array
    in blocks of SUM_BLOCK, each summed by a pairwise tree, then the block
    partials by the same fold. Every device rounds it alike."""
    flat = b.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % SUM_BLOCK))
    partials = fold_sum(flat.reshape(-1, SUM_BLOCK))
    return fold_sum(partials[None, :])[0]


def _smooth_pairs_quad(p, b, n_pairs, omega, idx2, idy2, wE, wW, wN, wS, masks,
                       band=None):
    """n_pairs red(planes 0,3)+black(planes 1,2) Gauss-Seidel pairs
    (cfd_tpu/kernels/quad.py:569-596). Whole array: every band is full; on
    a sharded local block ``band(lo)`` is the (rows, 1) mask of the rows
    half-sweep ``lo`` (from 1) updates (_band_maker)."""
    inv = []
    for q in range(4):
        r, sp = q >> 1, q & 1
        denom = idx2 * (wE[sp] + wW[sp]) + idy2 * (wN[r] + wS[r])
        denom = torch.broadcast_to(denom, p[q].shape)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        inv.append(torch.where(masks[q], 1.0 / safe, torch.zeros_like(denom)))

    def half(p, upd, lo):
        E, Wm = _qshift(p, 0, 1), _qshift(p, 0, -1)
        N, S = _qshift(p, 1, 0), _qshift(p, -1, 0)
        out = list(p)
        for q in upd:
            r, sp = q >> 1, q & 1
            gs = (idx2 * (wE[sp] * E[q] + wW[sp] * Wm[q])
                  + idy2 * (wN[r] * N[q] + wS[r] * S[q]) - b[q]) * inv[q]
            mask = masks[q] if band is None else masks[q] & band(lo)
            out[q] = torch.where(mask, p[q] + omega * (gs - p[q]), p[q])
        return out

    for k in range(n_pairs):
        p = half(p, (0, 3), 2 * k + 1)
        p = half(p, (1, 2), 2 * k + 2)
    return p


def _residual_quad(p, b, idx2, idy2, wE, wW, wN, wS, masks):
    E, Wm = _qshift(p, 0, 1), _qshift(p, 0, -1)
    N, S = _qshift(p, 1, 0), _qshift(p, -1, 0)
    out = []
    for q in range(4):
        r, sp = q >> 1, q & 1
        ap = (idx2 * (wE[sp] * (E[q] - p[q]) + wW[sp] * (Wm[q] - p[q]))
              + idy2 * (wN[r] * (N[q] - p[q]) + wS[r] * (S[q] - p[q])))
        out.append(torch.where(masks[q], b[q] - ap, torch.zeros_like(b[q])))
    return out


def _restrict_rc(r, ny: int, nx: int, row0: int = 0):
    """Full weighting of the residual planes r straight into the aligned
    level-1 source: coarse cell (Jc, Ic) averages planes (1,1)@(Jc-1,Ic-1),
    (1,0)@(Jc-1,Ic), (0,1)@(Jc,Ic-1), (0,0)@(Jc,Ic), 0 off the coarse
    interior (cfd_tpu/kernels/quad.py:678-687; row0: a local block's global
    row 0)."""
    rc = 0.25 * (r[0]
                 + torch.roll(r[1], 1, dims=1)
                 + torch.roll(r[2], 1, dims=0)
                 + torch.roll(torch.roll(r[3], 1, dims=0), 1, dims=1))
    Hc, Wc = rc.shape
    Jc = row0 + torch.arange(Hc, device=rc.device)[:, None]
    Ic = torch.arange(Wc, device=rc.device)[None, :]
    cmask = (Jc >= 1) & (Jc <= ny // 2) & (Ic >= 1) & (Ic <= nx // 2)
    return torch.where(cmask, rc, torch.zeros_like(rc))


def _bilinear_corr(ec, ny: int, nx: int, row0: int = 0):
    """The bilinear 9-3-3-1 prolongation of the aligned level-1 correction
    ec (Hq8, Wqa) to the four quad planes, with the edge clamps of
    cfd_tpu/kernels/quad.py:741-760 (plane q gets corr[q]); on a local block
    ``row0`` is its global row 0 and row J + 1 wraps within the block."""
    nyc, nxc = ny // 2, nx // 2
    Hc, Wc = ec.shape
    Jc = row0 + torch.arange(Hc, device=ec.device)[:, None]
    Ic = torch.arange(Wc, device=ec.device)[None, :]
    ecJ1 = torch.roll(ec, -1, dims=0)
    ecJ0 = torch.where(Jc == 0, ecJ1, ec)        # clamp J=0 ghost -> row 1
    ecJ1 = torch.where(Jc == nyc, ec, ecJ1)      # clamp J+1 > nyc -> row nyc
    rowmix = [0.75 * ecJ0 + 0.25 * ecJ1,         # r = 0: hi child of Jc
              0.25 * ecJ0 + 0.75 * ecJ1]         # r = 1: lo child of Jc+1
    corr = []
    for r in range(2):
        m1 = torch.roll(rowmix[r], -1, dims=1)
        m0 = torch.where(Ic == 0, m1, rowmix[r])
        m1 = torch.where(Ic == nxc, rowmix[r], m1)
        corr += [0.75 * m0 + 0.25 * m1, 0.25 * m0 + 0.75 * m1]
    return corr


def _courant(u: torch.Tensor, v: torch.Tensor):
    """max|u|, max|v| over every quad cell of the corrected, ghosted fields
    (emit_courant; the region of the reference's scalar_reduce)."""
    return torch.max(torch.abs(u)), torch.max(torch.abs(v))


def _check(shape, *tensors, dtype=torch.float32):
    for t in tensors:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"expected a contiguous {dtype} tensor of shape "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                             f"(contiguous={t.is_contiguous()})")


# ------------------------------------------------------------- stage kernels

class _QuadStage:
    """Dispatch of a stage kernel on the quad fields (us, vs, p, p_prev):
    CPU tensors go to ``plain``, CUDA tensors to ``kernel``."""

    def __init__(self, shape):
        self.qshape = quad_shape(shape)
        self.ny, self.nx = shape[0] - 2, shape[1] - 2

    def __call__(self, us, vs, p, p_prev):
        _check(self.qshape, us, vs, p, p_prev)
        if route(us, vs, p, p_prev) == "cuda":
            return self.kernel(us, vs, p, p_prev)
        return self.plain(us, vs, p, p_prev)

    def _iota(self, device):
        return _qiota(self.qshape[1], self.qshape[2], device)


class QuadCorrector(_QuadStage):
    """(us4, vs4, p4, p_prev4) -> (u4, v4, guess4): rho-multiplied cavity
    projection, ghosts rebuilt from the corrected interior, and the next
    solve's warm start 2p - p_prev (cfd_tpu/kernels/quad.py:488). Used at
    the stats/export boundary (cases/cavity.py unalign_state)."""

    def __init__(self, shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0):
        super().__init__(shape)
        self.cu = coeffs.dt / coeffs.dx * coeffs.density
        self.cv = coeffs.dt / coeffs.dy * coeffs.density
        self.lid = lid_velocity

    def _corrected(self, us, vs, p, p_prev, grow, gcol, cu=None, cv=None):
        cu = self.cu if cu is None else cu
        cv = self.cv if cv is None else cv
        u, v, guess = _project_quad(list(us), list(vs), list(p), list(p_prev), grow,
                                    gcol, self.ny, self.nx, cu, cv)
        u, v = _cavity_bc_quad(u, v, grow, gcol, self.ny, self.nx, self.lid)
        return u, v, guess

    def plain(self, us, vs, p, p_prev):
        u, v, guess = self._corrected(us, vs, p, p_prev, *self._iota(us.device))
        return torch.stack(u), torch.stack(v), torch.stack(guess)

    def kernel(self, us, vs, p, p_prev):
        u2, v2, guess = (torch.empty_like(us) for _ in range(3))
        _, Hq8, Wqa = self.qshape
        CORRECTOR(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(u2), ptr(v2), ptr(guess),
                  Hq8, Wqa, self.ny, self.nx, self.cu, self.cv, 2.0 * self.lid)
        return u2, v2, guess


def tile_plan_ptr(op, flow, device, symbol: str, *which: bool):
    """``op``'s tile plan (``op._tile_plan``: unless set before its first
    launch, kernels/plan.py carry_plan of the carry ``flow`` on op.qshape,
    or ``flow()`` where it is a function) as the C entry points take it,
    its kernel instance ``which`` (the carries' adaptive, block; the step's
    finest-level post, block) readied on ``device`` once (plan.ready_tiles
    through ``symbol``)."""
    if getattr(op, "_tile_ints", None) is None:
        if getattr(op, "_tile_plan", None) is None:
            op._tile_plan = flow() if callable(flow) else carry_plan(flow, op.qshape)
        op._tile_ints, op._tile_ready = op._tile_plan.c_ints(), set()
    key = (str(device), *which)
    if key not in op._tile_ready:
        ready_tiles(op._tile_plan, device, symbol, *(int(w) for w in which))
        op._tile_ready.add(key)
    return ctypes.cast(op._tile_ints, ctypes.c_void_p)


def sum_scratch(op, like):
    """(partials, count) of one launch of the carries' sum of b over
    ``like``'s shape (csrc/carry_tile.cuh source_sum, the channel's, the
    step's and RB's): fresh partials, one a 256-wide chunk, and the count,
    one int32 on ``like``'s device that ``op`` keeps (op._sum_counts),
    zeroed once: every sum leaves it 0."""
    counts = op.__dict__.setdefault("_sum_counts", {})
    if str(like.device) not in counts:
        counts[str(like.device)] = torch.zeros(1, dtype=torch.int32, device=like.device)
    partials = torch.empty(-(-like.numel() // SUM_BLOCK), dtype=torch.float32,
                           device=like.device)
    return partials, counts[str(like.device)]


def max_acc(op, device) -> torch.Tensor:
    """The running max (int bits) and block count of a tile kernel whose
    last block folds a max (the finest-level post kernels, the coarse
    smoother's with_residual instance, the cavity predictors of both
    layouts, the natural step's pairs): two int32 on ``device`` that ``op``
    keeps (op._max_acc), zeroed once: every launch leaves them 0."""
    accs = op.__dict__.setdefault("_max_acc", {})
    if str(device) not in accs:
        accs[str(device)] = torch.zeros(2, dtype=torch.int32, device=device)
    return accs[str(device)]


class QuadCorrPredictorSource(QuadCorrector):
    """Tentative-state cavity stage (cfd_tpu/kernels/quad.py:938):
    (us, vs, p, p_prev) -> (us', vs', b', guess, max|b'|). Corrects the
    carried (u*, v*) with p, rebuilds the lid-cavity ghosts, runs the MAC
    predictor, builds b = rho/dt * div on the cells and reduces max|b|.
    ``max|b'|`` is a 0-d float32 tensor on the fields' device. On the card
    it is one launch over shared-memory tiles (csrc/quad_stage.cu
    cavity_carry_kernel) after the zeroing of max|b'|."""

    def __init__(self, shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0):
        super().__init__(shape, coeffs, lid_velocity)
        self.coeffs = coeffs
        self.rho_dt = coeffs.density / coeffs.dt

    def plain(self, us, vs, p, p_prev):
        grow, gcol = self._iota(us.device)
        u, v, guess = self._corrected(us, vs, p, p_prev, grow, gcol)
        us2, vs2, b = _predictor_source_quad(u, v, self.coeffs, grow, gcol, self.ny,
                                             self.nx)
        return us2, vs2, b, torch.stack(guess), torch.max(torch.abs(b))

    def kernel(self, us, vs, p, p_prev):
        return _cavity_carry(self, CARRY, (us, vs, p, p_prev), 0, 0)


def _cavity_carry(op, kern: Kernel, fields, row_base: int, halo: int):
    """One launch of cfd_quad_carry through ``kern`` (its counter): (us',
    vs', b', guess, max|b'|), max|b'| over the own rows of a block with a
    ``halo``-row strip."""
    us, vs, p, p_prev = fields
    us2, vs2, b, guess = (torch.empty_like(us) for _ in range(4))
    max_b = torch.empty((), dtype=torch.float32, device=us.device)
    _, H, Wqa = op.qshape
    c = op.coeffs
    plan = tile_plan_ptr(op, "cavity", us.device, "cfd_quad_carry_grid", False, halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(us2), ptr(vs2), ptr(b), ptr(guess),
         ptr(max_b), H, Wqa, op.ny, op.nx, op.cu, op.cv, 2.0 * op.lid, c.dt, c.viscosity, c.idx,
         c.idy, c.idx2, c.idy2, op.rho_dt, row_base, halo, plan)
    return us2, vs2, b, guess, max_b


class QuadChannelCorrector(_QuadStage):
    """(us4, vs4, p4, p_prev4) -> (u4, v4, guess4): rho-DIVIDED channel
    projection on valid faces (channel-01.cpp:693-702), the channel ghosts
    on the corrected fields, and the warm start 2p - p_prev
    (cfd_tpu/kernels/quad.py:892). Used at the stats/export boundary
    (cases/channel.py unalign_state)."""

    def __init__(self, shape, coeffs: StencilCoeffs, inlet_velocity: float = 1.0):
        super().__init__(shape)
        self.cu = coeffs.dt / (coeffs.density * coeffs.dx)
        self.cv = coeffs.dt / (coeffs.density * coeffs.dy)
        self.uin = inlet_velocity

    def _bc(self, grow, gcol):
        return lambda u, v: _channel_bc_quad(u, v, grow, gcol, self.ny, self.nx, self.uin)

    def _corrected(self, us, vs, p, p_prev, grow, gcol, cu=None, cv=None):
        cu = self.cu if cu is None else cu
        cv = self.cv if cv is None else cv
        u, v, guess = _project_quad(list(us), list(vs), list(p), list(p_prev), grow,
                                    gcol, self.ny, self.nx, cu, cv)
        u, v = self._bc(grow, gcol)(u, v)
        return u, v, guess

    def plain(self, us, vs, p, p_prev):
        u, v, guess = self._corrected(us, vs, p, p_prev, *self._iota(us.device))
        return torch.stack(u), torch.stack(v), torch.stack(guess)

    def kernel(self, us, vs, p, p_prev):
        u2, v2, guess = (torch.empty_like(us) for _ in range(3))
        _, Hq8, Wqa = self.qshape
        CHANNEL_CORRECTOR(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(u2), ptr(v2),
                          ptr(guess), Hq8, Wqa, self.ny, self.nx, self.cu, self.cv,
                          self.uin)
        return u2, v2, guess


class QuadChannelCorrPredictorSource(QuadChannelCorrector):
    """Tentative-state channel stage (cfd_tpu/kernels/quad.py:1126, math in
    channel_carry_compute :1160): (us, vs, p, p_prev) -> (us', vs', b',
    guess, sum b'). The rho-divided correction, the channel ghosts on the
    corrected fields, the MAC predictor, the channel ghosts again on the
    tentative fields, b = rho/dt * div on the cells, and the interior sum of
    b (the caller removes its mean). ``sum b'`` is a 0-d float32 tensor,
    summed in fixed_order_sum's order. On the card it is one launch over
    shared-memory tiles (csrc/quad_stage.cu channel_carry_kernel) and one
    for the sum (carry_tile.cuh source_sum)."""

    def __init__(self, shape, coeffs: StencilCoeffs, inlet_velocity: float = 1.0):
        super().__init__(shape, coeffs, inlet_velocity)
        self.coeffs = coeffs
        self.rho_dt = coeffs.density / coeffs.dt

    def plain(self, us, vs, p, p_prev):
        grow, gcol = self._iota(us.device)
        u, v, guess = self._corrected(us, vs, p, p_prev, grow, gcol)
        us2, vs2, b = _predictor_source_quad(u, v, self.coeffs, grow, gcol, self.ny,
                                             self.nx, bc=self._bc(grow, gcol))
        return us2, vs2, b, torch.stack(guess), fixed_order_sum(b)

    def kernel(self, us, vs, p, p_prev):
        return _channel_carry(self, CHANNEL_CARRY, (us, vs, p, p_prev), 0, 0)


def _channel_carry(op, kern: Kernel, fields, row_base: int, halo: int):
    """One call of cfd_quad_channel_carry through ``kern`` (its counter):
    (us', vs', b', guess, sum b'), the sum over the own rows of a block with
    a ``halo``-row strip."""
    us, vs, p, p_prev = fields
    us2, vs2, b, guess = (torch.empty_like(us) for _ in range(4))
    partials, count = sum_scratch(op, us)
    sum_b = torch.empty((), dtype=torch.float32, device=us.device)
    _, H, Wqa = op.qshape
    c = op.coeffs
    plan = tile_plan_ptr(op, "channel", us.device, "cfd_quad_channel_carry_grid", False,
                         halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(us2), ptr(vs2), ptr(b), ptr(guess),
         ptr(partials), ptr(count), ptr(sum_b), H, Wqa, op.ny, op.nx, op.cu, op.cv, op.uin,
         c.dt, c.viscosity, c.idx, c.idy, c.idx2, c.idy2, op.rho_dt, row_base, halo, plan)
    return us2, vs2, b, guess, sum_b


class QuadChannelPredictorSource(_QuadStage):
    """(u4, v4) -> (us4, vs4, b4, sum b): the non-carry channel stage
    (cfd_tpu/kernels/quad.py:847): the MAC predictor on (u, v) as given, the
    channel ghosts on the tentative fields, the raw source b = rho/dt * div
    on the cells and its interior sum in fixed_order_sum's order (the caller
    removes the mean). No factory of either package reaches it: the split
    ordering QuadChannelCorrector -> this stage equals the channel carry. On
    the card it is one launch over shared-memory tiles
    (csrc/quad_stage.cu channel_predictor_source_kernel, kernels/plan.py
    carry_plan("channel_predictor")) and the carries' sum launch, whose
    count the op keeps (sum_scratch): no zeroing launch."""

    def __init__(self, shape, coeffs: StencilCoeffs, inlet_velocity: float = 1.0):
        super().__init__(shape)
        self.coeffs = coeffs
        self.uin = inlet_velocity
        self.rho_dt = coeffs.density / coeffs.dt

    def __call__(self, u, v):
        _check(self.qshape, u, v)
        if route(u, v) == "cuda":
            return self.kernel(u, v)
        return self.plain(u, v)

    def plain(self, u, v):
        grow, gcol = self._iota(u.device)
        bc = lambda a, b: _channel_bc_quad(a, b, grow, gcol, self.ny, self.nx, self.uin)
        us2, vs2, b = _predictor_source_quad(list(u), list(v), self.coeffs, grow, gcol,
                                             self.ny, self.nx, bc=bc)
        return us2, vs2, b, fixed_order_sum(b)

    def kernel(self, u, v):
        us2, vs2, b = (torch.empty_like(u) for _ in range(3))
        partials, count = sum_scratch(self, u)
        sum_b = torch.empty((), dtype=torch.float32, device=u.device)
        _, Hq8, Wqa = self.qshape
        c = self.coeffs
        plan = tile_plan_ptr(self, "channel_predictor", u.device,
                             "cfd_quad_channel_predictor_source_grid")
        CHANNEL_PREDICTOR_SOURCE(u, ptr(u), ptr(v), ptr(us2), ptr(vs2), ptr(b), ptr(partials),
                                 ptr(count), ptr(sum_b), Hq8, Wqa, self.ny, self.nx, self.uin,
                                 c.dt, c.viscosity, c.idx, c.idy, c.idx2, c.idy2, self.rho_dt,
                                 plan)
        return us2, vs2, b, sum_b


class _Traced:
    """The traced-dt dispatch shared by the adaptive instances: ``dt`` (one
    0-d float32 tensor, or the carries' (2,) pair (dt_corr, dt_pred)) rides
    with the fields, on the same device. The correction coefficients are
    ``cu_f``, ``cv_f`` (rho/dx, rho/dy multiplied; rho*dx, rho*dy divided)."""

    n_dt = 1
    divided = True

    def _factors(self, coeffs):
        if self.divided:
            return coeffs.density * coeffs.dx, coeffs.density * coeffs.dy
        return coeffs.density / coeffs.dx, coeffs.density / coeffs.dy

    def __call__(self, dt, *fields):
        _check(self.qshape, *fields)
        _check((self.n_dt,) if self.n_dt > 1 else (), dt)
        if route(dt, *fields) == "cuda":
            return self.kernel(dt, *fields)
        return self.plain(dt, *fields)

    def _coeffs_at(self, dt):
        return (traced_coeff(dt, self.cu_f, self.divided),
                traced_coeff(dt, self.cv_f, self.divided))


class QuadCorrectorTraced(_Traced, QuadCorrector):
    """(dt, us4, vs4, p4, p_prev4) -> (u4, v4, guess4): the cavity corrector
    with a traced dt (cfd_tpu/kernels/quad.py:488 traced_dt, cu = dt *
    (rho/dx)): the exact controller's corrector and the lagged one's
    logical boundary."""

    divided = False

    def __init__(self, shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0):
        super().__init__(shape, coeffs, lid_velocity)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dt, us, vs, p, p_prev):
        u, v, guess = self._corrected(us, vs, p, p_prev, *self._iota(us.device),
                                      *self._coeffs_at(dt))
        return torch.stack(u), torch.stack(v), torch.stack(guess)

    def kernel(self, dt, us, vs, p, p_prev):
        u2, v2, guess = (torch.empty_like(us) for _ in range(3))
        _, Hq8, Wqa = self.qshape
        CORRECTOR_TRACED(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(u2), ptr(v2),
                         ptr(guess), ptr(dt), Hq8, Wqa, self.ny, self.nx, self.cu_f,
                         self.cv_f, 2.0 * self.lid)
        return u2, v2, guess


class QuadPredictorSource(_Traced, _QuadStage):
    """(dt, u4, v4) -> (us4, vs4, b4, max|b|): the non-carry cavity stage
    with a traced dt (cfd_tpu/kernels/quad.py:438 traced_dt): the lid
    ghosts on the corrected u, v, the MAC predictor on valid faces, b =
    rho/dt * div on the cells and max|b| (a 0-d tensor). The exact
    controller's first stage. On the card it is one launch over
    shared-memory tiles (csrc/quad_stage.cu lid_predictor_source_kernel,
    kernels/plan.py carry_plan("cavity_predictor")), whose last block
    moves max|b| out of the op's running max (max_acc): no zeroing
    launch."""

    def __init__(self, shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0):
        super().__init__(shape)
        self.coeffs = coeffs
        self.lid = lid_velocity

    def plain(self, dt, u, v):
        grow, gcol = self._iota(u.device)
        u, v = _cavity_bc_quad(list(u), list(v), grow, gcol, self.ny, self.nx, self.lid)
        us2, vs2, b = _predictor_source_quad(u, v, self.coeffs, grow, gcol, self.ny,
                                             self.nx, dt=dt)
        return us2, vs2, b, torch.max(torch.abs(b))

    def kernel(self, dt, u, v):
        us2, vs2, b = (torch.empty_like(u) for _ in range(3))
        max_b = torch.empty((), dtype=torch.float32, device=u.device)
        _, Hq8, Wqa = self.qshape
        c = self.coeffs
        plan = tile_plan_ptr(self, "cavity_predictor", u.device,
                             "cfd_quad_predictor_source_grid")
        PREDICTOR_SOURCE(u, ptr(u), ptr(v), ptr(us2), ptr(vs2), ptr(b), ptr(max_b),
                         ptr(max_acc(self, u.device)), ptr(dt), Hq8, Wqa, self.ny, self.nx,
                         2.0 * self.lid, c.viscosity, c.idx, c.idy, c.idx2, c.idy2,
                         c.density, plan)
        return us2, vs2, b, max_b


class QuadCorrPredictorSourceAdaptive(_Traced, QuadCorrPredictorSource):
    """The cavity carry with traced_dt and emit_courant
    (cfd_tpu/kernels/quad.py:938): (dts, us, vs, p, p_prev) -> (us', vs',
    b', guess, max|b'|, max|u|, max|v|). dts = (dt_corr, dt_pred): dt_corr
    corrects the carried tentative fields (the dt that built them), dt_pred
    drives this step's predictor and source; max|u|, max|v| are of the
    corrected, ghosted fields (the lagged controller's Courant feedback).
    On the card: the fixed carry's tile kernel, its adaptive instance, after
    one zeroing of the three maxima."""

    n_dt = 2
    divided = False

    def __init__(self, shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0):
        super().__init__(shape, coeffs, lid_velocity)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dts, us, vs, p, p_prev):
        grow, gcol = self._iota(us.device)
        u, v, guess = self._corrected(us, vs, p, p_prev, grow, gcol,
                                      *self._coeffs_at(dts[0]))
        us2, vs2, b = _predictor_source_quad(u, v, self.coeffs, grow, gcol, self.ny,
                                             self.nx, dt=dts[1])
        return (us2, vs2, b, torch.stack(guess), torch.max(torch.abs(b)),
                *_courant(torch.stack(u), torch.stack(v)))

    def kernel(self, dts, us, vs, p, p_prev):
        return _cavity_carry_adaptive(self, CARRY_ADAPTIVE, dts, (us, vs, p, p_prev), 0, 0)


def _cavity_carry_adaptive(op, kern: Kernel, dts, fields, row_base: int, halo: int):
    """One launch of cfd_quad_carry_adaptive through ``kern`` (its counter):
    (us', vs', b', guess, max|b'|, max|u|, max|v|), the reductions over the
    own rows of a block with a ``halo``-row strip."""
    us, vs, p, p_prev = fields
    us2, vs2, b, guess = (torch.empty_like(us) for _ in range(4))
    scal = torch.empty(3, dtype=torch.float32, device=us.device)  # max|b|, max|u|, max|v|
    _, H, Wqa = op.qshape
    c = op.coeffs
    plan = tile_plan_ptr(op, "cavity", us.device, "cfd_quad_carry_grid", True, halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(us2), ptr(vs2), ptr(b), ptr(guess),
         ptr(scal), ptr(dts), H, Wqa, op.ny, op.nx, op.cu_f, op.cv_f, 2.0 * op.lid, c.viscosity,
         c.idx, c.idy, c.idx2, c.idy2, c.density, row_base, halo, plan)
    return us2, vs2, b, guess, scal[0], scal[1], scal[2]


class QuadChannelCorrectorTraced(_Traced, QuadChannelCorrector):
    """(dt, us4, vs4, p4, p_prev4) -> (u4, v4, guess4): the channel corrector
    with a traced dt (cfd_tpu/kernels/quad.py:892 traced_dt, cu = dt /
    (rho*dx)): the lagged controller's logical boundary."""

    def __init__(self, shape, coeffs: StencilCoeffs, inlet_velocity: float = 1.0):
        super().__init__(shape, coeffs, inlet_velocity)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dt, us, vs, p, p_prev):
        u, v, guess = self._corrected(us, vs, p, p_prev, *self._iota(us.device),
                                      *self._coeffs_at(dt))
        return torch.stack(u), torch.stack(v), torch.stack(guess)

    def kernel(self, dt, us, vs, p, p_prev):
        u2, v2, guess = (torch.empty_like(us) for _ in range(3))
        _, Hq8, Wqa = self.qshape
        CHANNEL_CORRECTOR_TRACED(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(u2),
                                 ptr(v2), ptr(guess), ptr(dt), Hq8, Wqa, self.ny, self.nx,
                                 self.cu_f, self.cv_f, self.uin)
        return u2, v2, guess


class QuadChannelCorrPredictorSourceAdaptive(_Traced, QuadChannelCorrPredictorSource):
    """The channel carry with traced_dt and emit_courant
    (cfd_tpu/kernels/quad.py:1126): (dts, us, vs, p, p_prev) -> (us', vs',
    b', guess, sum b', max|u|, max|v|), dts = (dt_corr, dt_pred) as the
    cavity's. On the card: the fixed carry's tile kernel, its adaptive
    instance, after one zeroing of the two maxima, and the sum launch."""

    n_dt = 2

    def __init__(self, shape, coeffs: StencilCoeffs, inlet_velocity: float = 1.0):
        super().__init__(shape, coeffs, inlet_velocity)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, dts, us, vs, p, p_prev):
        grow, gcol = self._iota(us.device)
        u, v, guess = self._corrected(us, vs, p, p_prev, grow, gcol,
                                      *self._coeffs_at(dts[0]))
        us2, vs2, b = _predictor_source_quad(u, v, self.coeffs, grow, gcol, self.ny,
                                             self.nx, bc=self._bc(grow, gcol), dt=dts[1])
        return (us2, vs2, b, torch.stack(guess), fixed_order_sum(b),
                *_courant(torch.stack(u), torch.stack(v)))

    def kernel(self, dts, us, vs, p, p_prev):
        return _channel_carry_adaptive(self, CHANNEL_CARRY_ADAPTIVE, dts, (us, vs, p, p_prev),
                                       0, 0)


def _channel_carry_adaptive(op, kern: Kernel, dts, fields, row_base: int, halo: int):
    """One call of cfd_quad_channel_carry_adaptive through ``kern``: (us',
    vs', b', guess, sum b', max|u|, max|v|), the reductions over the own rows
    of a block with a ``halo``-row strip."""
    us, vs, p, p_prev = fields
    us2, vs2, b, guess = (torch.empty_like(us) for _ in range(4))
    partials, count = sum_scratch(op, us)
    scal = torch.empty(3, dtype=torch.float32, device=us.device)  # sum b, max|u|, max|v|
    _, H, Wqa = op.qshape
    c = op.coeffs
    plan = tile_plan_ptr(op, "channel", us.device, "cfd_quad_channel_carry_grid", True,
                         halo > 0)
    kern(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(us2), ptr(vs2), ptr(b), ptr(guess),
         ptr(partials), ptr(count), ptr(scal), ptr(scal[1:]), ptr(dts), H, Wqa, op.ny, op.nx,
         op.cu_f, op.cv_f, op.uin, c.viscosity, c.idx, c.idy, c.idx2, c.idy2, c.density,
         row_base, halo, plan)
    return us2, vs2, b, guess, scal[0], scal[1], scal[2]


def make_quad_corrector(shape, coeffs, lid_velocity: float = 1.0,
                        traced_dt: bool = False) -> QuadCorrector:
    if traced_dt:
        return QuadCorrectorTraced(shape, coeffs, lid_velocity)
    return QuadCorrector(shape, coeffs, lid_velocity)


def make_quad_predictor_source(shape, coeffs, lid_velocity: float = 1.0
                               ) -> QuadPredictorSource:
    """The traced-dt instance only: the fixed-dt non-carry stage is reached
    by no entry point of the port."""
    return QuadPredictorSource(shape, coeffs, lid_velocity)


def make_quad_corr_predictor_source(shape, coeffs, lid_velocity: float = 1.0,
                                    adaptive: bool = False,
                                    shard: tuple[int, int] | None = None
                                    ) -> QuadCorrPredictorSource:
    """``adaptive``: the traced_dt + emit_courant instance. ``shard=(P,
    mdy)``: the kernel of one shard's local block
    (QuadCorrPredictorSourceShard, with ``adaptive``
    QuadCorrPredictorSourceShardAdaptive)."""
    if shard is not None:
        if adaptive:
            return QuadCorrPredictorSourceShardAdaptive(shape, coeffs, lid_velocity, shard)
        return QuadCorrPredictorSourceShard(shape, coeffs, lid_velocity, shard)
    if adaptive:
        return QuadCorrPredictorSourceAdaptive(shape, coeffs, lid_velocity)
    return QuadCorrPredictorSource(shape, coeffs, lid_velocity)


def make_quad_channel_corrector(shape, coeffs, inlet_velocity: float = 1.0,
                                traced_dt: bool = False) -> QuadChannelCorrector:
    if traced_dt:
        return QuadChannelCorrectorTraced(shape, coeffs, inlet_velocity)
    return QuadChannelCorrector(shape, coeffs, inlet_velocity)


def make_quad_channel_predictor_source(shape, coeffs, inlet_velocity: float = 1.0
                                       ) -> QuadChannelPredictorSource:
    return QuadChannelPredictorSource(shape, coeffs, inlet_velocity)


def make_quad_channel_corr_predictor_source(shape, coeffs, inlet_velocity: float = 1.0,
                                            adaptive: bool = False,
                                            shard: tuple[int, int] | None = None
                                            ) -> QuadChannelCorrPredictorSource:
    """``adaptive``: the traced_dt + emit_courant instance. ``shard=(P,
    mdy)``: the kernel of one shard's local block
    (QuadChannelCorrPredictorSourceShard, with ``adaptive``
    QuadChannelCorrPredictorSourceShardAdaptive)."""
    if shard is not None:
        if adaptive:
            return QuadChannelCorrPredictorSourceShardAdaptive(shape, coeffs, inlet_velocity,
                                                               shard)
        return QuadChannelCorrPredictorSourceShard(shape, coeffs, inlet_velocity, shard)
    if adaptive:
        return QuadChannelCorrPredictorSourceAdaptive(shape, coeffs, inlet_velocity)
    return QuadChannelCorrPredictorSource(shape, coeffs, inlet_velocity)


# ------------------------------------------------------- finest V-cycle level

class _QuadLevel0(nn.Module):
    """Shared constants of the finest-level kernels: the separable coupling
    weights of ``problem`` as natural (2*Wqa,) column and (2*Hq8,) row
    vectors, zero outside the interior (buffers on ``device``).

    ``shard=(P, mdy)``: the kernels of one shard's local block (4, P + 16,
    Wqa) of an mdy-way plane-row mesh, whose level-1 block is (P + 16, Wqa);
    the row vectors are then global, 2 * (mdy * P + 16) long with a
    16-row zero prefix (cfd_tpu/kernels/quad.py:531-560 rows_len,
    row_prefix), so that global row j >= -16 reads element j + 16."""

    def __init__(self, shape, problem, omega: float, n_pairs: int, coarse_shape,
                 device="cpu", shard: tuple[int, int] | None = None):
        super().__init__()
        _, _, Hq8, Wqa = quad_dims(shape)
        rows, prefix = Hq8, 0  # plane rows of the row vectors, and their zero prefix
        if shard is not None:
            P, mdy = shard
            if P % 8:
                raise ValueError(f"shard rows must be a multiple of 8, got {P}")
            Hq8 = P + 2 * DEV_HALO
            rows, prefix = mdy * P + 2 * DEV_HALO, DEV_HALO
        self.shard, self.prefix = shard, prefix
        if tuple(coarse_shape) != (Hq8, Wqa):
            raise ValueError(f"coarse shape {tuple(coarse_shape)} != quad plane "
                             f"shape {(Hq8, Wqa)}")
        if n_pairs < 1:
            raise ValueError(f"n_pairs must be >= 1, got {n_pairs}")
        self.qshape = (4, Hq8, Wqa)
        self.coarse_shape = (Hq8, Wqa)
        self.ny, self.nx = problem.ny, problem.nx
        self.idx2 = 1.0 / (problem.dx * problem.dx)
        self.idy2 = 1.0 / (problem.dy * problem.dy)
        self.omega = omega
        self.n_pairs = n_pairs
        nx, ny = problem.nx, problem.ny

        def col(w):
            v = np.zeros(2 * Wqa)
            v[1 : nx + 1] = w[1, 1 : nx + 1]
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        def row(w):
            v = np.zeros(2 * rows)
            v[2 * prefix + 1 : 2 * prefix + ny + 1] = w[1 : ny + 1, 1]
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        self.register_buffer("wE", col(problem.wE))
        self.register_buffer("wW", col(problem.wW))
        self.register_buffer("wN", row(problem.wN))
        self.register_buffer("wS", row(problem.wS))

    def _plane_weights(self, row_base: int = 0, pad: int = 0):
        """Per-parity plane vectors: wE[s] (1, Wqa), wN[r] (Hq8, 1); on a
        shard the rows of the block at ``row_base``, with ``pad`` zero rows
        either side."""
        _, Hq8, Wqa = self.qshape
        lo = row_base + self.prefix
        cols = [[w[s::2].reshape(1, Wqa) for s in range(2)] for w in (self.wE, self.wW)]
        rows = [[_pad_rows(w[r::2][lo : lo + Hq8].reshape(Hq8, 1), pad) for r in range(2)]
                for w in (self.wN, self.wS)]
        return (*cols, *rows)

    def _masks(self, device, row0: int = 0, n_rows: int | None = None):
        grow, gcol = _qiota(self.qshape[1] if n_rows is None else n_rows, self.qshape[2],
                            device, row0)
        return _valid_masks(grow, gcol, self.ny, self.nx)[2]

    def _kernel_args(self):
        _, Hq8, Wqa = self.qshape
        return (ptr(self.wE), ptr(self.wW), ptr(self.wN), ptr(self.wS), Hq8, Wqa,
                self.ny, self.nx, self.idx2, self.idy2, self.omega, self.n_pairs)

    def _check_device(self, t):
        if t.device != self.wE.device:
            raise ValueError(f"tensor on {t.device}, kernel constants on "
                             f"{self.wE.device}")


def _level0_plan(op, device, post: bool, block: bool, masked: bool):
    """``op``'s tile plan (kernels/plan.py level0_plan unless set before its
    first launch) as the C entry points take it, its kernel instance
    readied on ``device`` once: the step's masked kernels
    (cfd_step_level0_grid) or the separable ones (cfd_quad_level0_grid)."""
    symbol = "cfd_step_level0_grid" if masked else "cfd_quad_level0_grid"
    return tile_plan_ptr(
        op, lambda: level0_plan(op.qshape, op.n_pairs, post, block=block, masked=masked),
        device, symbol, post, block)


def level0_pre(op, kern: Kernel, p, b, row_base: int, halo: int, *, masked: bool):
    """One call of a finest-level pre kernel (cfd_quad_pre_smooth_restrict,
    or with ``masked`` the step's cfd_step_pre_smooth_restrict) through
    ``kern`` (its counter): (p_out, rc) of a whole field (halo 0) or a
    local block."""
    p_out = torch.empty_like(p)
    rc = torch.empty(op.coarse_shape, dtype=torch.float32, device=p.device)
    plan = _level0_plan(op, p.device, False, halo > 0, masked)
    kern(p, ptr(p), ptr(b), ptr(p_out), ptr(rc), *op._kernel_args(), row_base, halo, plan)
    return p_out, rc


def level0_post(op, kern: Kernel, p, b, ec, row_base: int, halo: int, *, masked: bool):
    """One call of a finest-level post kernel (cfd_quad_post_prolong_smooth,
    or with ``masked`` the step's) through ``kern``: (p_out, max|r|) of a
    whole field or a local block's own rows, the running max in
    max_acc."""
    p_out = torch.empty_like(p)
    res = torch.empty((), dtype=torch.float32, device=p.device)
    plan = _level0_plan(op, p.device, True, halo > 0, masked)
    kern(p, ptr(p), ptr(b), ptr(ec), ptr(p_out), ptr(res), ptr(max_acc(op, p.device)),
         *op._kernel_args(), row_base, halo, plan)
    return p_out, res


class QuadPreSmoothRestrict(_QuadLevel0):
    """(p4, b4) -> (p4, rc): n_pairs red/black pairs on the finest level,
    then the residual restricted (full weighting) straight into the aligned
    level-1 source rc (Hq8, Wqa) (cfd_tpu/kernels/quad.py:630). On the card
    one launch of shared-memory tiles (csrc/quad_vcycle.cu sep_pre_kernel, the
    whole-solve's separable tile body; kernels/plan.py level0_plan with
    masked=False)."""

    def forward(self, p, b):
        _check(self.qshape, p, b)
        self._check_device(p)
        if route(p, b) == "cuda":
            return self.kernel(p, b)
        return self.plain(p, b)

    def plain(self, p, b):
        wE, wW, wN, wS = self._plane_weights()
        masks = self._masks(p.device)
        P = _smooth_pairs_quad(list(p), list(b), self.n_pairs, self.omega, self.idx2,
                               self.idy2, wE, wW, wN, wS, masks)
        r = _residual_quad(P, list(b), self.idx2, self.idy2, wE, wW, wN, wS, masks)
        return torch.stack(P), _restrict_rc(r, self.ny, self.nx)

    def kernel(self, p, b):
        return level0_pre(self, PRE, p, b, 0, 0, masked=False)


class QuadPostProlongSmooth(_QuadLevel0):
    """(p4, b4, ec) -> (p4, max|b - Ap|): bilinear 9-3-3-1 prolongation of the
    level-1 correction ec (Hq8, Wqa) with edge clamps, added on the interior,
    then n_pairs pairs, then the tolerance residual
    (cfd_tpu/kernels/quad.py:700). The residual is a 0-d float32 tensor. On
    the card one launch of shared-memory tiles (csrc/quad_vcycle.cu
    sep_post_kernel), whose last block moves the running max into it."""

    def forward(self, p, b, ec):
        _check(self.qshape, p, b)
        _check(self.coarse_shape, ec)
        self._check_device(p)
        if route(p, b, ec) == "cuda":
            return self.kernel(p, b, ec)
        return self.plain(p, b, ec)

    def plain(self, p, b, ec):
        wE, wW, wN, wS = self._plane_weights()
        masks = self._masks(p.device)
        corr = _bilinear_corr(ec, self.ny, self.nx)
        P = [torch.where(masks[q], p[q] + corr[q], p[q]) for q in range(4)]
        P = _smooth_pairs_quad(P, list(b), self.n_pairs, self.omega, self.idx2,
                               self.idy2, wE, wW, wN, wS, masks)
        r = _residual_quad(P, list(b), self.idx2, self.idy2, wE, wW, wN, wS, masks)
        return torch.stack(P), torch.max(torch.abs(torch.stack(r)))

    def kernel(self, p, b, ec):
        return level0_post(self, POST, p, b, ec, 0, 0, masked=False)


# ------------------------------------------ one shard of a plane-row mesh

def quad_shard_dims(shape: tuple[int, int], mdy: int) -> tuple[int, int, int]:
    """(Hq8s, P, Wqa) of an mdy-way plane-ROW decomposition of the quad
    layout (cfd_tpu/kernels/quad.py:68): the global plane rows padded up so
    that every shard owns P = Hq8s / mdy rows, P a multiple of 8. Parity
    lives in the plane index, so a row split never flips the red/black
    colouring across shards."""
    Hq, _, _, Wqa = quad_dims(shape)
    Hq8s = _round_up(Hq, 8 * mdy)
    return Hq8s, Hq8s // mdy, Wqa


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (..., H, W) with n zero rows above and below."""
    return torch.nn.functional.pad(t, (0, 0, n, n)) if n else t


def _crop_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t[..., n : t.shape[-2] - n, :].contiguous()


def _block_rows(H: int, pad: int, device) -> torch.Tensor:
    """(H + 2 pad, 1) mask of a block's H rows in an array padded with pad
    zero rows either side."""
    lr = torch.arange(H + 2 * pad, device=device)[:, None] - pad
    return (lr >= 0) & (lr < H)


def own_row_sum(b: torch.Tensor, P: int) -> torch.Tensor:
    """A local block's partial of the source sum: fixed_order_sum of b on
    its own rows (local rows DEV_HALO ... DEV_HALO + P - 1) with zeros
    elsewhere, the order the shard kernels' partials fold in (the
    reference's scalar_reduce="sum" under shard, quad.py:310-316)."""
    rows = torch.arange(b.shape[-2], device=b.device)[:, None]
    own = (rows >= DEV_HALO) & (rows < DEV_HALO + P)
    return fixed_order_sum(torch.where(own, b, torch.zeros_like(b)))


def own_rows(t: torch.Tensor, P: int) -> torch.Tensor:
    """The own rows of a local (4, P + 16, W) block (local rows DEV_HALO
    ... DEV_HALO + P - 1): the region of a shard kernel's reductions."""
    return t[..., DEV_HALO : DEV_HALO + P, :]


class _ShardTraced(_Traced):
    """The dispatch of a traced-dt + Courant carry on one shard's local
    block: (row_base, dts, *fields), dts = (dt_corr, dt_pred) on the
    fields' device."""

    n_dt = 2

    def __call__(self, row_base: int, dts, *fields):
        _check(self.qshape, *fields)
        _check((self.n_dt,), dts)
        if route(dts, *fields) == "cuda":
            return self.kernel(row_base, dts, *fields)
        return self.plain(row_base, dts, *fields)


def _band_maker(row_base: int, H: int, ny: int, device, pad: int = 0):
    """The TPU kernels' valid band (cfd_tpu/kernels/quad.py:611-627) with
    the slab = the local block of H plane rows at ``row_base``: band(lo) is
    the (H + 2 pad, 1) mask of the rows half-sweep lo updates, lo rows in
    from each block edge except at a physical edge: the bottom shard
    (row_base <= 0, whose dead rows end the dependency chain as the ghost
    row does) and the top shard. ``pad``: rows of zero padding either side,
    never in the band."""
    lr = torch.arange(H + 2 * pad, device=device)[:, None] - pad
    at_bottom = row_base <= 0
    at_top = row_base + H >= (ny + 1) // 2 + 1

    def band(lo):
        return (lr >= (0 if at_bottom else lo)) & (lr < (H if at_top else H - lo))

    return band


class _CarryBlock:
    """A cavity or channel carry on one shard's local (4, P + 16, Wqa) block,
    called (row_base, us, vs, p, p_prev). Its twin is the single-device
    twin on the block padded with DEV_HALO zero rows either side, the
    corrected u, v zeroed on the padding: the kernels (csrc/quad_stage.cu)
    read 0 outside the block and their tiles hold the corrected u, v of the
    block only, in shared memory."""

    def __init__(self, shape, coeffs: StencilCoeffs, velocity: float = 1.0,
                 shard: tuple[int, int] = (8, 1)):
        super().__init__(shape, coeffs, velocity)
        P, _ = shard
        if P % 8:
            raise ValueError(f"shard rows must be a multiple of 8, got {P}")
        self.P = P
        self.qshape = (4, P + 2 * DEV_HALO, self.qshape[2])

    def __call__(self, row_base: int, us, vs, p, p_prev):
        _check(self.qshape, us, vs, p, p_prev)
        if route(us, vs, p, p_prev) == "cuda":
            return self.kernel(row_base, us, vs, p, p_prev)
        return self.plain(row_base, us, vs, p, p_prev)

    def _tentative_bc(self, grow, gcol):
        """The ghost update of the tentative fields (the cavity's: none)."""
        return None

    def _block_stage(self, row_base, us, vs, p, p_prev, cu=None, cv=None, dt=None):
        """(us', vs', b', guess, u, v) on the block, u and v the corrected,
        ghosted fields, at the host's coefficients or the traced ones."""
        z, H = DEV_HALO, self.qshape[1]
        grow, gcol = _qiota(H + 2 * z, self.qshape[2], us.device, row_base - z)
        u, v, guess = self._corrected(*(_pad_rows(t, z) for t in (us, vs, p, p_prev)),
                                      grow, gcol, cu, cv)
        block = _block_rows(H, z, us.device)
        u = [torch.where(block, a, torch.zeros_like(a)) for a in u]
        v = [torch.where(block, a, torch.zeros_like(a)) for a in v]
        us2, vs2, b = _predictor_source_quad(u, v, self.coeffs, grow, gcol, self.ny, self.nx,
                                             bc=self._tentative_bc(grow, gcol), dt=dt)
        return tuple(_crop_rows(t, z) for t in (us2, vs2, b, torch.stack(guess),
                                                torch.stack(u), torch.stack(v)))


class QuadCorrPredictorSourceShard(_CarryBlock, QuadCorrPredictorSource):
    """The cavity carry on one shard's local block (row 16a,
    cfd_tpu/kernels/quad.py:938 with shard=(P, mdy)): (row_base, us, vs, p,
    p_prev) -> (us', vs', b', guess, max|b'|) on (4, P + 16, Wqa) blocks.
    row_base = jy * P - 8 is the global plane row of local row 0, so every
    mask and ghost keeps its global meaning; max|b'| covers the own rows
    (local 8 ... P + 7): the shard's partial.

    The twin is _CarryBlock's. The radius of the stages is 5 rows, so the
    own rows equal the single-device carry's. On the card: row 1's tile
    kernel, its block instance (its tiles stage the corrected u, v on the
    block alone and reduce over the own rows)."""

    def plain(self, row_base, us, vs, p, p_prev):
        us2, vs2, b, guess, _, _ = self._block_stage(row_base, us, vs, p, p_prev)
        return us2, vs2, b, guess, torch.max(torch.abs(own_rows(b, self.P)))

    def kernel(self, row_base, us, vs, p, p_prev):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _cavity_carry(self, SHARD_CARRY, (us, vs, p, p_prev), int(row_base),
                                 DEV_HALO)


class QuadChannelCorrPredictorSourceShard(_CarryBlock, QuadChannelCorrPredictorSource):
    """The channel carry on one shard's local block (row 16d,
    cfd_tpu/kernels/quad.py:1126 with shard=(P, mdy)): (row_base, us, vs, p,
    p_prev) -> (us', vs', b', guess, sum_own) on (4, P + 16, Wqa) blocks,
    with row_base the global plane row of local row 0 (so the inlet and
    outlet columns and the wall rows test the global row) and sum_own the
    own rows' sum of b (own_row_sum): the shard's partial, which the caller
    adds over the shards (parallel.halo.global_sum).

    The twin is _CarryBlock's with the channel ghosts on the tentative
    fields. The stages reach 5 rows (kChannelRadius there), so the own rows
    equal the single-device carry's. On the card: row 8a's two launches,
    their block instances (the tiles' maxima and the sum over the own
    rows)."""

    def _tentative_bc(self, grow, gcol):
        return self._bc(grow, gcol)

    def plain(self, row_base, us, vs, p, p_prev):
        us2, vs2, b, guess, _, _ = self._block_stage(row_base, us, vs, p, p_prev)
        return us2, vs2, b, guess, own_row_sum(b, self.P)

    def kernel(self, row_base, us, vs, p, p_prev):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _channel_carry(self, SHARD_CHANNEL_CARRY, (us, vs, p, p_prev),
                                  int(row_base), DEV_HALO)


class QuadCorrPredictorSourceShardAdaptive(_ShardTraced, QuadCorrPredictorSourceShard):
    """The cavity carry with traced_dt and emit_courant on one shard's local
    block (row 16a+, cfd_tpu/kernels/quad.py:938 with shard=(P, mdy),
    traced_dt=True, emit_courant=True, called as fused_a(row_base, (dt_corr,
    dt_pred), *arrays) by cfd_tpu/parallel/quad_sharded.py:1143-1166):
    (row_base, dts, us, vs, p, p_prev) -> (us', vs', b', guess, max|b'|,
    max|u|, max|v|), the maxima over the own rows only: the shard's
    partials (the reference masks every scalar of a shard kernel so,
    quad.py:308-312). The halo rows' corrected u, v read neighbours that the
    block does not hold, so a maximum over them would not be the field's.
    The twin is QuadCorrPredictorSourceShard's at the traced coefficients
    of QuadCorrPredictorSourceAdaptive."""

    divided = False

    def __init__(self, shape, coeffs: StencilCoeffs, lid_velocity: float = 1.0,
                 shard: tuple[int, int] = (8, 1)):
        super().__init__(shape, coeffs, lid_velocity, shard)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, row_base, dts, us, vs, p, p_prev):
        us2, vs2, b, guess, u, v = self._block_stage(row_base, us, vs, p, p_prev,
                                                     *self._coeffs_at(dts[0]), dt=dts[1])
        own = lambda t: own_rows(t, self.P)
        return (us2, vs2, b, guess, torch.max(torch.abs(own(b))), *_courant(own(u), own(v)))

    def kernel(self, row_base, dts, us, vs, p, p_prev):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _cavity_carry_adaptive(self, SHARD_CARRY_ADAPTIVE, dts, (us, vs, p, p_prev),
                                          int(row_base), DEV_HALO)


class QuadChannelCorrPredictorSourceShardAdaptive(_ShardTraced,
                                                  QuadChannelCorrPredictorSourceShard):
    """The channel carry with traced_dt and emit_courant on one shard's local
    block (row 16d+, cfd_tpu/kernels/quad.py:1126 with shard=(P, mdy),
    traced_dt=True, emit_courant=True): (row_base, dts, us, vs, p, p_prev)
    -> (us', vs', b', guess, sum_own, max|u|, max|v|), the sum and the
    maxima over the own rows only, as QuadCorrPredictorSourceShardAdaptive's.
    On the card: row 8a+'s launches, their block instances."""

    def __init__(self, shape, coeffs: StencilCoeffs, inlet_velocity: float = 1.0,
                 shard: tuple[int, int] = (8, 1)):
        super().__init__(shape, coeffs, inlet_velocity, shard)
        self.cu_f, self.cv_f = self._factors(coeffs)

    def plain(self, row_base, dts, us, vs, p, p_prev):
        us2, vs2, b, guess, u, v = self._block_stage(row_base, us, vs, p, p_prev,
                                                     *self._coeffs_at(dts[0]), dt=dts[1])
        own = lambda t: own_rows(t, self.P)
        return us2, vs2, b, guess, own_row_sum(b, self.P), *_courant(own(u), own(v))

    def kernel(self, row_base, dts, us, vs, p, p_prev):
        with torch.cuda.device(us.device):  # the shards may lie on several cards
            return _channel_carry_adaptive(self, SHARD_CHANNEL_CARRY_ADAPTIVE, dts,
                                           (us, vs, p, p_prev), int(row_base), DEV_HALO)


class QuadPreSmoothRestrictShard(QuadPreSmoothRestrict):
    """The finest pre-smooth + residual + restriction on one shard's local
    block (row 16b, cfd_tpu/kernels/quad.py:630 with shard=(P, mdy)):
    (row_base, p4, b4) -> (p4, rc) with rc the (P + 16, Wqa) local level-1
    block. Half-sweep k updates the band of quad.py:611-627 (_band_maker);
    the kernel (csrc/quad_vcycle.cu sep_pre_kernel<true>, one launch of tiles)
    reads 0 outside the block and takes the residual there as 0, which the
    twin does on the block padded with zero rows. The own rows equal the
    single-device kernel's."""

    def forward(self, row_base: int, p, b):
        _check(self.qshape, p, b)
        self._check_device(p)
        if route(p, b) == "cuda":
            return self.kernel(row_base, p, b)
        return self.plain(row_base, p, b)

    def plain(self, row_base, p, b):
        z, H = DEV_HALO, self.qshape[1]
        weights = self._plane_weights(row_base, pad=z)
        masks = self._masks(p.device, row_base - z, H + 2 * z)
        band = _band_maker(row_base, H, self.ny, p.device, pad=z)
        bp = list(_pad_rows(b, z))
        P = _smooth_pairs_quad(list(_pad_rows(p, z)), bp, self.n_pairs, self.omega,
                               self.idx2, self.idy2, *weights, masks, band)
        r = _residual_quad(P, bp, self.idx2, self.idy2, *weights, masks)
        block = _block_rows(H, z, p.device)
        r = [torch.where(block, a, torch.zeros_like(a)) for a in r]
        rc = _restrict_rc(r, self.ny, self.nx, row_base - z)
        return _crop_rows(torch.stack(P), z), _crop_rows(rc, z)

    def kernel(self, row_base, p, b):
        with torch.cuda.device(p.device):  # the shards may lie on several cards
            return level0_pre(self, SHARD_PRE, p, b, int(row_base), DEV_HALO,
                              masked=False)


class QuadPostProlongSmoothShard(QuadPostProlongSmooth):
    """The prolongation + post-smooth + tolerance residual on one shard's
    local block (row 16c, cfd_tpu/kernels/quad.py:700 with shard=(P, mdy)):
    (row_base, p4, b4, ec) -> (p4, res) with ec the (P + 16, Wqa) local
    level-1 correction, whose row J + 1 wraps within the block as the TPU
    kernel's roll does; the sweeps' band starts one row further in
    (quad.py:762-767), and res is max|b - A p| over the own rows: the
    shard's partial. On the card csrc/quad_vcycle.cu sep_post_kernel<true>,
    one launch of tiles."""

    def forward(self, row_base: int, p, b, ec):
        _check(self.qshape, p, b)
        _check(self.coarse_shape, ec)
        self._check_device(p)
        if route(p, b, ec) == "cuda":
            return self.kernel(row_base, p, b, ec)
        return self.plain(row_base, p, b, ec)

    def plain(self, row_base, p, b, ec):
        z, H = DEV_HALO, self.qshape[1]
        masks = self._masks(p.device, row_base)
        corr = _bilinear_corr(ec, self.ny, self.nx, row_base)
        P = [_pad_rows(torch.where(masks[q], p[q] + corr[q], p[q]), z) for q in range(4)]
        weights = self._plane_weights(row_base, pad=z)
        masks = self._masks(p.device, row_base - z, H + 2 * z)
        band = _band_maker(row_base, H, self.ny, p.device, pad=z)
        bp = list(_pad_rows(b, z))
        P = _smooth_pairs_quad(P, bp, self.n_pairs, self.omega, self.idx2, self.idy2,
                               *weights, masks, lambda lo: band(lo + 1))
        r = _residual_quad(P, bp, self.idx2, self.idy2, *weights, masks)
        own = torch.stack(r)[:, z + DEV_HALO : z + H - DEV_HALO]
        return _crop_rows(torch.stack(P), z), torch.max(torch.abs(own))

    def kernel(self, row_base, p, b, ec):
        with torch.cuda.device(p.device):  # the shards may lie on several cards
            return level0_post(self, SHARD_POST, p, b, ec, int(row_base), DEV_HALO,
                               masked=False)


def make_quad_pre_smooth_restrict(shape, problem, omega: float, n_pairs: int,
                                  coarse_shape, device="cpu",
                                  shard: tuple[int, int] | None = None
                                  ) -> QuadPreSmoothRestrict:
    """``shard=(P, mdy)``: the kernel of one shard's local block
    (QuadPreSmoothRestrictShard; coarse_shape is the local (P + 16, Wqa))."""
    if shard is not None:
        return QuadPreSmoothRestrictShard(shape, problem, omega, n_pairs, coarse_shape,
                                          device, shard)
    return QuadPreSmoothRestrict(shape, problem, omega, n_pairs, coarse_shape, device)


def make_quad_post_prolong_smooth(shape, problem, omega: float, n_pairs: int,
                                  coarse_shape, device="cpu",
                                  shard: tuple[int, int] | None = None
                                  ) -> QuadPostProlongSmooth:
    """``shard=(P, mdy)``: the kernel of one shard's local block
    (QuadPostProlongSmoothShard)."""
    if shard is not None:
        return QuadPostProlongSmoothShard(shape, problem, omega, n_pairs, coarse_shape,
                                          device, shard)
    return QuadPostProlongSmooth(shape, problem, omega, n_pairs, coarse_shape, device)


class QuadCorrPredictorSourceFusedPre(QuadCorrPredictorSource):
    """The cavity carry with the first V-cycle's finest-level pre-smooth,
    residual and restriction folded in (cfd_tpu/kernels/quad.py:985):
    (us, vs, p, p_prev) -> (us', vs', b', p1, rc, max|b'|). p1 is the warm
    start 2p - p_prev after ``pre``'s n_pairs red/black pairs on b', rc
    (Hq8, Wqa) the restriction of its residual onto level 1; the solve
    starts its first cycle at the coarse stage with it
    (MultigridPoisson.solve_rc). The twin is the composition carry twin ->
    ``pre`` twin, which the reference holds its kernel bit-equal to
    (tests/test_quad.py:410); the kernel is one cooperative launch of the
    carry's tiles and then the pre's, one grid barrier between them
    (csrc/quad_fused_pre.cu, kernels/plan.py fused_pre_plan). ``pre`` is
    the solve's QuadPreSmoothRestrict, whose constants it shares."""

    def __init__(self, shape, coeffs: StencilCoeffs, pre: QuadPreSmoothRestrict,
                 lid_velocity: float = 1.0):
        super().__init__(shape, coeffs, lid_velocity)
        if pre.qshape != self.qshape:
            raise ValueError(f"pre kernel shape {pre.qshape} != {self.qshape}")
        self.pre = pre

    def __call__(self, us, vs, p, p_prev):
        self.pre._check_device(us)
        return super().__call__(us, vs, p, p_prev)

    def plain(self, us, vs, p, p_prev):
        us2, vs2, b, guess, max_b = super().plain(us, vs, p, p_prev)
        p1, rc = self.pre.plain(guess, b)
        return us2, vs2, b, p1, rc, max_b

    def launch_plan(self, device):
        """The plan (``self._tile_plan``: unless set before the first launch,
        fused_pre_plan on the field at pre's pairs) with its blocks, as
        many as co-reside on ``device``, readied there once
        (cfd_quad_fused_pre_grid), and its host array."""
        if getattr(self, "_tile_plan", None) is None:
            self._tile_plan = fused_pre_plan(self.qshape, self.pre.n_pairs)
        ready = self.__dict__.setdefault("_ready", {})
        if str(device) not in ready:
            grid = ready_grid(self._tile_plan, device, "cfd_quad_fused_pre_grid")
            plan = dataclasses.replace(self._tile_plan, blocks=grid["blocks"])
            ready[str(device)] = (plan, plan.c_ints())
        return ready[str(device)]

    def kernel(self, us, vs, p, p_prev):
        plan, ints = self.launch_plan(us.device)
        us2, vs2, b, guess, p1 = (torch.empty_like(us) for _ in range(5))
        rc = torch.empty(self.pre.coarse_shape, dtype=torch.float32, device=us.device)
        slots = torch.empty(plan.blocks, dtype=torch.float32, device=us.device)
        max_b = torch.empty((), dtype=torch.float32, device=us.device)
        c = self.coeffs
        FUSED_PRE(us, ptr(us), ptr(vs), ptr(p), ptr(p_prev), ptr(us2), ptr(vs2), ptr(b),
                  ptr(guess), ptr(p1), ptr(rc), ptr(slots), ptr(max_b), self.cu, self.cv,
                  2.0 * self.lid, c.dt, c.viscosity, c.idx, c.idy, c.idx2, c.idy2,
                  self.rho_dt, *self.pre._kernel_args(), ctypes.cast(ints, ctypes.c_void_p))
        return us2, vs2, b, p1, rc, max_b
