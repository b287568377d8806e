"""cfd_tpu_torch — the PyTorch/CUDA port of cfd_tpu for one NVIDIA H100.

The JAX package ``cfd_tpu`` is the reference; this package follows its
module names so each module's counterpart is easy to find. It imports
torch and never jax. Its Hopper kernels are hand-written CUDA C++ under
``csrc/``, built with nvcc at their first CUDA call (kernels/_build.py); on
the CPU every kernel wrapper runs its plain PyTorch twin instead.

Ported so far: the f32 quad-layout multigrid lid-driven cavity
(cases/cavity.py), channel (cases/channel.py), backward-facing step
(cases/backwards_step.py) and Rayleigh-Benard convection
(physics/boussinesq.py), stepped by solver.Simulation.
"""

from cfd_tpu_torch.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu_torch.state import State

__version__ = "0.1.0"

__all__ = ["Grid", "State", "cfl_time_step", "optimal_omega", "__version__"]
