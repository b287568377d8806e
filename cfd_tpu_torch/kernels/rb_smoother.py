"""Coarse-level red/black smoother on separable or full-2D weights (the
port of cfd_tpu.kernels.rb_smoother).

``pairs(p, b) -> p`` after n red+black Gauss-Seidel pairs, or with
``with_residual_field`` ``-> (p, r)`` with the signed residual b - A p of
the smoothed iterate, masked to the interior, or with ``with_residual``
``-> (p, max|b - A p|)`` over the interior (separable weights only: the
natural finest level's post-smooth and tolerance check,
cfd_tpu/poisson/multigrid.py:715-719), a 0-d float32 tensor on the
fields' device. Arrays are the aligned
(H8, W) levels of the multigrid hierarchy in their storage dtype (float32,
or bfloat16 for the mixed-precision coarse hierarchy); the arithmetic is
always float32 and the iterate is rounded to the storage type once, after
the last half-sweep, as on the TPU (rb_smoother.py:199-200,255).

The kernel is csrc/rb_smoother.cu: every instance one launch of
shared-memory tiles a call (kernels/plan.py pairs_plan), with no memset
and no scratch field. ``plain`` is the whole-array PyTorch twin (no
slabs, no bands); ``forward`` sends CPU tensors to it and CUDA tensors to
the kernel.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from cfd_tpu_torch.kernels._build import Kernel, ptr, route
from cfd_tpu_torch.kernels.plan import pairs_plan
from cfd_tpu_torch.kernels.quad import max_acc, tile_plan_ptr

RB_PAIRS = Kernel("rb_pairs", "cfd_rb_pairs", "cfd_tpu_torch/csrc/rb_smoother.cu",
                  "cfd_tpu/kernels/rb_smoother.py:37")
RB_PAIRS_FULL = Kernel("rb_pairs_full", "cfd_rb_pairs_full",
                       "cfd_tpu_torch/csrc/rb_smoother.cu",
                       "cfd_tpu/kernels/rb_smoother.py:37")
RB_PAIRS_RES = Kernel("rb_pairs_residual", "cfd_rb_pairs", "cfd_tpu_torch/csrc/rb_smoother.cu",
                      "cfd_tpu/kernels/rb_smoother.py:37 (with_residual)")

_STORAGE = {torch.float32: 0, torch.bfloat16: 1}


class RBPairs(nn.Module):
    """Red/black pairs on one aligned level.

    Separable: wE, wW (W,) and wN, wS (H8,) coupling vectors, 0 outside the
    interior (float32 buffers; a bfloat16 level passes its bf16-rounded
    weights, as rb_pairs_for_level reads them back from the bf16 arrays).
    Full-2D (a masked level, rb_smoother.py:106-127): four (H8, W) weight
    arrays, float32 storage only; a cell updates only where its coupling
    sum denom > 0, so solid cells never change (rb_smoother.py:194-197)."""

    def __init__(self, shape, wE, wW, wN, wS, idx2: float, idy2: float, omega: float,
                 n_pairs: int, ny: int, nx: int, dtype=torch.float32,
                 with_residual_field: bool = False, with_residual: bool = False):
        super().__init__()
        if dtype not in _STORAGE:
            raise ValueError(f"storage dtype must be float32 or bfloat16, got {dtype}")
        if n_pairs < 1:
            raise ValueError(f"n_pairs must be >= 1, got {n_pairs}")
        H8, W = shape
        self.shape = (H8, W)
        self.dtype = dtype
        self.idx2, self.idy2, self.omega = idx2, idy2, omega
        self.n_pairs, self.ny, self.nx = n_pairs, ny, nx
        if with_residual and with_residual_field:
            raise ValueError("with_residual and with_residual_field are exclusive")
        self.with_residual_field = with_residual_field
        self.with_residual = with_residual
        self.full = torch.as_tensor(wE).dim() == 2
        if self.full and dtype != torch.float32:
            raise ValueError("full-2D weights are float32 only")
        if self.full and with_residual:
            raise ValueError("with_residual takes separable weights")
        cols, rows = ((H8, W), (H8, W)) if self.full else (W, H8)
        f32 = lambda w, n: torch.as_tensor(w, dtype=torch.float32).reshape(n).clone()
        self.register_buffer("wE", f32(wE, cols))
        self.register_buffer("wW", f32(wW, cols))
        self.register_buffer("wN", f32(wN, rows))
        self.register_buffer("wS", f32(wS, rows))

    def forward(self, p, b):
        for t in (p, b):
            if t.dtype != self.dtype or tuple(t.shape) != self.shape or not t.is_contiguous():
                raise ValueError(f"expected contiguous {self.dtype} {self.shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        if p.device != self.wE.device:
            raise ValueError(f"tensor on {p.device}, kernel constants on {self.wE.device}")
        if route(p, b) == "cuda":
            return self.kernel(p, b)
        return self.plain(p, b)

    def _weights(self):
        if self.full:
            return self.wE, self.wW, self.wN, self.wS
        return (self.wE.reshape(1, -1), self.wW.reshape(1, -1), self.wN.reshape(-1, 1),
                self.wS.reshape(-1, 1))

    def plain(self, p, b):
        we, ww, wn, ws = self._weights()
        idx2, idy2, omega = self.idx2, self.idy2, self.omega
        H8, W = self.shape
        jj = torch.arange(H8, device=p.device)[:, None]
        ii = torch.arange(W, device=p.device)[None, :]
        interior = (jj >= 1) & (jj <= self.ny) & (ii >= 1) & (ii <= self.nx)
        even = ((jj + ii) % 2) == 0
        denom = idx2 * (we + ww) + idy2 * (wn + ws)
        if self.full:
            interior = interior & (denom > 0)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        inv = torch.where(interior, 1.0 / safe, torch.zeros_like(safe))
        b = b.float()
        p = p.float()

        def half(p, mask):
            pE = torch.roll(p, -1, dims=1)
            pW = torch.roll(p, 1, dims=1)
            pN = torch.roll(p, -1, dims=0)
            pS = torch.roll(p, 1, dims=0)
            gs = (idx2 * (we * pE + ww * pW) + idy2 * (wn * pN + ws * pS) - b) * inv
            return torch.where(mask, p + omega * (gs - p), p)

        for _ in range(self.n_pairs):
            p = half(p, interior & even)
            p = half(p, interior & ~even)
        if not (self.with_residual_field or self.with_residual):
            return p.to(self.dtype)
        pE = torch.roll(p, -1, dims=1)
        pW = torch.roll(p, 1, dims=1)
        pN = torch.roll(p, -1, dims=0)
        pS = torch.roll(p, 1, dims=0)
        ap = (idx2 * (we * (pE - p) + ww * (pW - p))
              + idy2 * (wn * (pN - p) + ws * (pS - p)))
        r = torch.where(interior, b - ap, torch.zeros_like(b))
        if self.with_residual:
            return p.to(self.dtype), torch.max(torch.abs(r))
        return p.to(self.dtype), r.to(self.dtype)

    def kernel(self, p, b):
        """One launch of shared-memory tiles (csrc/rb_smoother.cu) under the
        op's plan (kernels/plan.py pairs_plan unless set before its first
        launch). The with_residual variant's running max and block count
        are kernels.quad max_acc's."""
        H8, W = self.shape
        residual = self.with_residual_field or self.with_residual
        storage = _STORAGE[self.dtype]
        plan = tile_plan_ptr(
            self, lambda: pairs_plan(self.shape, self.n_pairs, residual, self.full),
            p.device, "cfd_rb_pairs_grid", storage)
        out = torch.empty_like(p)
        r = torch.empty_like(p) if self.with_residual_field else None
        null = ctypes.c_void_p(None)
        r_ptr = ptr(r) if r is not None else null
        weights = (ptr(self.wE), ptr(self.wW), ptr(self.wN), ptr(self.wS))
        consts = (H8, W, self.ny, self.nx, self.idx2, self.idy2, self.omega, self.n_pairs, plan)
        if self.full:
            RB_PAIRS_FULL(p, ptr(p), ptr(b), ptr(out), r_ptr, *weights, *consts)
            return out if r is None else (out, r)
        res, acc = null, null
        if self.with_residual:
            res = torch.empty((), dtype=torch.float32, device=p.device)
            acc = ptr(max_acc(self, p.device))
        (RB_PAIRS_RES if self.with_residual else RB_PAIRS)(
            p, storage, ptr(p), ptr(b), ptr(out), r_ptr,
            ptr(res) if self.with_residual else null, acc, *weights, *consts)
        if self.with_residual:
            return out, res
        return out if r is None else (out, r)


def rb_pairs_for_level(level, omega: float, n_pairs: int,
                       with_residual_field: bool = False,
                       with_residual: bool = False) -> RBPairs:
    """Adapter from an aligned multigrid level (poisson.multigrid._Level) to
    the smoother, in the level's storage dtype and on the level's device; a
    masked level's (H8, W) weights select the full-2D mode."""
    weights = [getattr(level, w) for w in ("wE", "wW", "wN", "wS")]
    if level.separable:  # (1, W) and (H8, 1) vectors
        weights = [w.reshape(-1) for w in weights]
    return RBPairs(level.shape, *weights, level.idx2, level.idy2, omega, n_pairs, level.ny,
                   level.nx, dtype=level.dtype,
                   with_residual_field=with_residual_field,
                   with_residual=with_residual).to(level.wE.device)
