"""Simulation cases with the reference solvers' constants as defaults."""

from cfd_tpu_torch.cases.cavity import make_cavity_case
from cfd_tpu_torch.cases.channel import make_channel_case

__all__ = ["make_cavity_case", "make_channel_case"]
