"""Constructor-time parameter validation for the case factories.

A copy of ``cfd_tpu.params`` (pure Python), so the port never imports jax.

The reference validates its compile-time constants at construction
(cavity-01.cpp:417-425: positive dims/Re/dt, CFL sanity;
backwards_step-01.cpp:455-461: geometry bounds) and static_asserts the rest
(cavity-01.cpp:418-421). This module makes those checks systematic for the
runtime-configurable factories: every case factory calls
``validate_case_params`` before deriving anything, so a negative Reynolds
number or a zero tolerance fails fast with the offending name instead of
silently producing NaNs thousands of steps later.
"""

from __future__ import annotations

import warnings


def require_positive(**named) -> None:
    """Raise ValueError naming the first non-positive (or non-finite)
    value. ``None`` entries are skipped (unset optionals)."""
    for name, value in named.items():
        if value is None:
            continue
        v = float(value)
        if not (v > 0.0) or v != v or v == float("inf"):
            raise ValueError(
                f"{name} must be positive and finite, got {value!r}")


def require_positive_int(**named) -> None:
    for name, value in named.items():
        if value is None:
            continue
        if int(value) != value or int(value) <= 0:
            raise ValueError(f"{name} must be a positive integer, got {value!r}")


def check_cfl(dt: float, dx: float, dy: float, viscosity: float,
              velocity_scale: float) -> None:
    """Warn (reference-style sanity check, cavity-01.cpp:423-425) when the
    chosen dt violates the explicit-scheme stability limits:

    * convective Courant number  dt * U * (1/dx + 1/dy) >= 1
    * diffusive number           2 * nu * dt * (1/dx^2 + 1/dy^2) >= 1

    A warning, not an error: the factories derive dt from these limits by
    default (grid.cfl_time_step), so this only fires for an explicit
    user-passed dt — which may be intentional (e.g. the blowup-detection
    test drives the solver past the limit on purpose).
    """
    conv = dt * velocity_scale * (1.0 / dx + 1.0 / dy)
    diff = 2.0 * viscosity * dt * (1.0 / (dx * dx) + 1.0 / (dy * dy))
    if conv >= 1.0 or diff >= 1.0:
        warnings.warn(
            f"dt={dt:g} exceeds the explicit stability limit "
            f"(convective Courant {conv:.3g}, diffusive number {diff:.3g}; "
            "both must stay < 1) — expect divergence",
            stacklevel=3)


def validate_case_params(
    *,
    reynolds_number: float | None = None,
    density: float | None = None,
    cfl: float | None = None,
    final_time: float | None = None,
    tolerance_factor: float | None = None,
    dt: float | None = None,
    max_iterations: int | None = None,
    print_interval: int | None = None,
    save_interval: int | None = None,
    **extra_positive,
) -> None:
    """Shared factory-entry validation. ``extra_positive`` holds additional
    case-specific scalars that must be positive (lengths, velocities,
    Ra/Pr, ...)."""
    require_positive(
        reynolds_number=reynolds_number, density=density, cfl=cfl,
        final_time=final_time, tolerance_factor=tolerance_factor, dt=dt,
        **extra_positive)
    require_positive_int(
        max_iterations=max_iterations, print_interval=print_interval,
        save_interval=save_interval)
    if cfl is not None and float(cfl) >= 1.0:
        warnings.warn(
            f"cfl={cfl:g} >= 1 exceeds the explicit-scheme stability bound",
            stacklevel=3)
