"""Simulation cases with the reference solvers' constants as defaults."""

from cfd_tpu_torch.cases.cavity import make_cavity_case

__all__ = ["make_cavity_case"]
