"""Physics modules beyond the incompressible core: Boussinesq convection."""

from cfd_tpu_torch.physics.boussinesq import RBParams, make_rayleigh_benard_case

__all__ = ["RBParams", "make_rayleigh_benard_case"]
