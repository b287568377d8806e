"""Domain decomposition over a mesh of devices (the port of cfd_tpu.parallel):
the cavity, the channel, Rayleigh-Benard and the backward-facing step on
the sharded quad path.

Ported: ``mesh`` (factor_2d, make_mesh: a single-controller Mesh, one
process holding an ordered list of devices, one per shard), ``halo``
(global_max, global_sum over per-shard partials) and ``quad_sharded``
(ShardedQuadProjection, the cavity, channel, rayleigh_benard and
backwards_step flavors, fixed dt and the lagged adaptive controller). Not
ported yet: the XLA paths sharded.py and mg_sharded.py and
halo.exchange_halos."""

from cfd_tpu_torch.parallel.halo import global_max, global_sum
from cfd_tpu_torch.parallel.mesh import Mesh, factor_2d, make_mesh
from cfd_tpu_torch.parallel.quad_sharded import ShardedQuadCavity, ShardedQuadProjection

__all__ = ["Mesh", "factor_2d", "make_mesh", "global_max", "global_sum",
           "ShardedQuadCavity", "ShardedQuadProjection"]
