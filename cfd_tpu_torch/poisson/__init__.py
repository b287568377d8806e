"""Pressure-Poisson solvers (multigrid, separable quad path)."""

from cfd_tpu_torch.poisson.multigrid import MGConfig, make_multigrid_poisson

__all__ = ["MGConfig", "make_multigrid_poisson"]
