"""Reductions over the shards of a single-controller mesh (the port of
cfd_tpu.parallel.halo's global_max and global_sum). Each shard's 0-d
partial is moved to shard 0's device and reduced there, on the card, with
no host read. Callers (parallel.quad_sharded): global_max for max|b| and
the V-cycle residual; global_sum for the channel's and Rayleigh-Benard's
source mean (the carries' own-row sums) and RB's per-cycle mean pin (the
own-row sums of p). ``exchange_halos`` (the XLA paths' one-cell exchange)
is not ported yet (ROADMAP.md queue A item A.12); the quad path's 8-row
refresh is parallel.quad_sharded._refresh."""

from __future__ import annotations

import torch


def global_max(parts) -> torch.Tensor:
    """max over the shards' partials (lax.pmax), on the first one's device."""
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts]).amax()


def global_sum(parts) -> torch.Tensor:
    """sum over the shards' partials (lax.psum), added in shard order on the
    first one's device."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total
