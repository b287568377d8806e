"""Simulation cases with the reference solvers' constants as defaults."""

from cfd_tpu_torch.cases.backwards_step import make_backwards_step_case
from cfd_tpu_torch.cases.cavity import make_cavity_case
from cfd_tpu_torch.cases.channel import make_channel_case
from cfd_tpu_torch.physics.boussinesq import make_rayleigh_benard_case

__all__ = ["make_backwards_step_case", "make_cavity_case", "make_channel_case",
           "make_rayleigh_benard_case"]
