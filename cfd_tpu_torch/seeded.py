"""Seeded inputs for checking and timing the solve kernels on a case: a
source for a Poisson solve and the carried fields of a whole step. The
same seed gives the same numbers on every device (numpy draws them)."""

from __future__ import annotations

import numpy as np
import torch


def seeded_source(case, seed: int) -> torch.Tensor:
    """A seeded source on the case's fluid cells, scaled by 1e3 and free of
    its mean over them, in the quad layout on the case's device."""
    from cfd_tpu_torch.kernels.quad import to_quad

    rng = np.random.default_rng(seed)
    mask = np.asarray(case.grid.cell_mask, bool)
    bn = np.where(mask, rng.standard_normal(case.grid.shape), 0.0)
    bn = (np.where(mask, bn - bn[mask].mean(), 0.0) * 1e3).astype(np.float32)
    return to_quad(torch.from_numpy(bn).to(case.device), case.grid.shape)


def seeded_fields(case, seed: int) -> tuple[torch.Tensor, ...]:
    """The carried fields of a whole step's call: the case's initial state
    in the logical layout with seeded noise on u, v and p over its fluid
    cells, aligned."""
    from cfd_tpu_torch.convert import state_from_numpy
    from cfd_tpu_torch.solver import Simulation

    sim = Simulation(case, log=lambda m: None)
    st = sim._logical(sim.initial_state())
    rng = np.random.default_rng(seed)
    mask = np.asarray(case.grid.cell_mask, dtype=np.float32)
    f = {k: getattr(st, k).cpu().numpy().copy()
         for k in ("u", "v", "p", "T", "p_prev") if getattr(st, k) is not None}
    for k, scale in (("u", 0.05), ("v", 0.05), ("p", 0.01)):
        f[k] = f[k] + (scale * rng.standard_normal(f[k].shape) * mask).astype(np.float32)
    s = case.align_state(state_from_numpy(f["u"], f["v"], f["p"], f.get("p_prev"),
                                          f.get("T"), device=case.device))
    if case.ordering == "rayleigh_benard":
        return (s.u, s.v, s.p, s.T)
    return (s.u, s.v, s.p) if s.p_prev is None else (s.u, s.v, s.p, s.p_prev)
