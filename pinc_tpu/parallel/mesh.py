"""Device-mesh construction — the JAX equivalent of the reference's
Cartesian MPI decomposition (``MpiInfo``, src/core.h:112-138; rank →
subdomain mapping ``getSubdomain``, src/grid.c:149-176).

The deck's ``grid:nSubdomains`` becomes the extents of an N-D
``jax.sharding.Mesh`` with axes named 'x','y','z',... — one device per
subdomain, mesh neighbors where MPI had Sendrecv peers.  Devices are
linearized in the same mixed-radix order the reference uses (last
dimension fastest).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_NAMES = ("x", "y", "z", "w", "v", "u")


@dataclass(frozen=True)
class MeshCtx:
    """Static mesh context threaded through the sharded step."""
    mesh: Mesh
    axes: Tuple[str, ...]          # one name per spatial dim
    n_subdomains: Tuple[int, ...]  # mesh extent per spatial dim
    true_size: Tuple[int, ...]     # local grid nodes per subdomain

    @property
    def n_devices(self) -> int:
        return math.prod(self.n_subdomains)

    @property
    def global_size(self) -> Tuple[int, ...]:
        return tuple(n * t for n, t in zip(self.n_subdomains, self.true_size))

    def field_spec(self, n_values: int = 0) -> P:
        """Sharding of a (*dims[, C]) field: spatial dims over mesh axes."""
        extra = (None,) if n_values else ()
        return P(*(self.axes + extra)) if extra else P(*self.axes)

    def particle_spec(self, with_dim_axis: bool = True) -> P:
        """Sharding of (S, cap[, D]) particle arrays: capacity split over
        ALL mesh axes jointly (each device owns one slab)."""
        if with_dim_axis:
            return P(None, self.axes, None)
        return P(None, self.axes)

    def sharding(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)


def make_mesh(n_subdomains: Sequence[int], true_size: Sequence[int],
              devices: Optional[Sequence[jax.Device]] = None) -> MeshCtx:
    nsub = tuple(int(n) for n in n_subdomains)
    need = math.prod(nsub)
    if devices is None:
        devices = jax.devices()
    if len(devices) < need:
        raise ValueError(f"deck wants {need} devices "
                         f"(grid:nSubdomains={nsub}) but only "
                         f"{len(devices)} available")
    dev_arr = np.asarray(devices[:need]).reshape(nsub)
    axes = AXIS_NAMES[: len(nsub)]
    mesh = Mesh(dev_arr, axes)
    return MeshCtx(mesh=mesh, axes=tuple(axes), n_subdomains=nsub,
                   true_size=tuple(int(t) for t in true_size))


def subdomain_offset(ctx: MeshCtx):
    """Inside shard_map: this device's global node offset per dim
    (mpiInfo->offset; pToGlobalFrame adds it, src/population.c:746-763)."""
    import jax.numpy as jnp
    from jax import lax
    coords = [lax.axis_index(ax) for ax in ctx.axes]
    return jnp.stack([c * t for c, t in zip(coords, ctx.true_size)])
