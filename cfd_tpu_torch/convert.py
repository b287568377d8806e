"""State hand-over between the JAX package and the port.

Both packages keep the same LOGICAL state: u, v, p, the previous
pressure p_prev and, for the Boussinesq case, the temperature T on the
padded (ny+2, nx+2) grid. These helpers move it as
numpy arrays, so a run that cfd_tpu started can be continued by
cfd_tpu_torch (``Simulation.run(state=...)`` aligns a logical state into
the carried layout itself), and the tests can feed both from one state.
``natural_converters`` are the natural aligned layout's align_state and
unalign_state, the carried layout of the cases' non-carry paths.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cfd_tpu_torch.kernels.projection import aligned_shape
from cfd_tpu_torch.state import State


def state_from_numpy(u, v, p, p_prev=None, T=None, *, device="cpu",
                     dtype=torch.float32) -> State:
    """Logical-layout numpy arrays -> a port State on ``device``."""
    t = lambda a: None if a is None else torch.as_tensor(np.array(a), dtype=dtype,
                                                         device=device)  # a copy
    return State(t(u), t(v), t(p), t(T), t(p_prev))


def state_to_numpy(state: State) -> tuple[np.ndarray, ...]:
    """A port State in the LOGICAL layout -> (u, v, p, p_prev, T) numpy
    arrays (p_prev or T None when the state carries none); inverse of
    state_from_numpy."""
    n = lambda a: None if a is None else a.detach().cpu().numpy()
    return n(state.u), n(state.v), n(state.p), n(state.p_prev), n(state.T)


def load_jax_checkpoint(path, case, device=None) -> tuple[State, int]:
    """(logical State, step) from an npz written by cfd_tpu's
    CheckpointManager (keys u, v, p, [T], [p_prev], step;
    io/checkpoint.py:46-54). A checkpoint without p_prev seeds p_prev = p
    when the case extrapolates its warm start, as cfd_tpu's restore does."""
    device = case.device if device is None else device
    with np.load(Path(path)) as z:
        p_prev = z["p_prev"] if "p_prev" in z.files else None
        if p_prev is None and case.extrapolate_warm_start:
            p_prev = z["p"]
        state = state_from_numpy(z["u"], z["v"], z["p"], p_prev,
                                 z["T"] if "T" in z.files else None, device=device,
                                 dtype=case.dtype)
        return state, int(z["step"])


def natural_converters(shape: tuple[int, int]):
    """(align_state, unalign_state) of the natural aligned carry
    (cfd_tpu/cases/cavity.py:395-412, channel.py:280-297): every field
    padded with zeros from the logical ``shape`` to (H8, W), or sliced
    back, and the p_prev slot swapped: the carry holds the next solve's
    guess 2p - p_prev, the logical state the previous pressure, and
    x -> 2p - x converts in both directions (one float32 rounding each
    way, as the reference's)."""
    H, Wp = shape
    H8, W = aligned_shape(shape)

    def swap_guess(st: State) -> State:
        if st.p_prev is None:
            return st
        return State(st.u, st.v, st.p, st.T, 2.0 * st.p - st.p_prev)

    def pad(a):
        return None if a is None else torch.nn.functional.pad(a, (0, W - Wp, 0, H8 - H))

    def align_state(st: State) -> State:
        return swap_guess(State(*(pad(a) for a in st)))

    def unalign_state(st: State) -> State:
        return swap_guess(State(*(None if a is None else a[:H, :Wp].contiguous()
                                  for a in st)))

    return align_state, unalign_state
