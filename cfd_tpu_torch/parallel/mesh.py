"""The device mesh of the plane-row decomposition (the port of
cfd_tpu.parallel.mesh).

The reference builds a ``jax.sharding.Mesh`` and runs its sharded step as
one SPMD program (shard_map). The port's mesh is single-controller, as
shard_map is from the outside: ONE process holds the ordered list of
devices, one per shard along the axis "dy", and drives every shard's
kernels itself; devices may repeat, so a 4-shard mesh can live on one
card. The halo refresh between shards is then a device copy and the
reductions are taken on shard 0's device (parallel.halo). Not
torch.distributed: NCCL puts no two ranks on one card, and one process
keeps the CPU tests in one process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization (ny_dev, nx_dev) of n devices
    (cfd_tpu/parallel/mesh.py:16)."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along the plane-row axis: ``devices[jy]``
    holds shard jy. ``shape`` maps the axis name to the shard count, as the
    reference's ``Mesh.shape`` does."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("dy",)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None,
              devices=None, device: str = "cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` shards along "dy" (the reference's
    make_mesh, cfd_tpu/parallel/mesh.py:25, with its CLI's shape (N, 1)).

    ``devices``: the list to use as given. Otherwise the shards are placed
    round-robin on the cards of the ``device`` type: "cuda" (every shard on
    cuda:0 with one card) or "cpu". There is no fallback: "cuda" with no
    card raises, where the reference falls back to virtual CPU devices
    (:29-33). ``n_devices`` defaults to the card count (cuda) or 1 (cpu).
    Only the plane-row (N, 1) shape exists; another ``shape`` raises."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(f"need {n_devices} devices, have {len(devs)}")
            devs = devs[:n_devices]
    else:
        kind = torch.device(device).type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh(device='cuda'): no CUDA device is available "
                                   "(pass device='cpu' for a mesh of CPU shards)")
            cards = torch.cuda.device_count()
            n = cards if n_devices is None else n_devices
            devs = [torch.device("cuda", k % cards) for k in range(n)]
        elif kind == "cpu":
            devs = [torch.device("cpu")] * (1 if n_devices is None else n_devices)
        else:
            raise ValueError(f"unsupported device type {kind!r} (cuda or cpu)")
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if shape is not None and tuple(shape) != (len(devs), 1):
        raise NotImplementedError(
            f"mesh shape {tuple(shape)}: only the 1-D plane-row decomposition "
            f"({len(devs)}, 1) is ported (the quad path shards plane rows)")
    return Mesh(tuple(devs))
