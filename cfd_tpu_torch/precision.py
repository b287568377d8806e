"""Precision policy: CLI precision names to torch dtypes.

The reference solvers are double-precision C++; validation runs f64 and
performance runs f32 (the same split as cfd_tpu.precision). PyTorch needs
no global flag for float64, so the policy is only the name mapping and the
check that a dtype is one the port computes in.
"""

from __future__ import annotations

import torch

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def as_dtype(precision: str | torch.dtype) -> torch.dtype:
    """``"f32"``/``"f64"`` or a torch float dtype -> that torch dtype."""
    if isinstance(precision, torch.dtype):
        if precision not in DTYPES.values():
            raise ValueError(f"unsupported dtype {precision} (float32 or float64)")
        return precision
    try:
        return DTYPES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r} "
                         f"(one of {sorted(DTYPES)})") from None
