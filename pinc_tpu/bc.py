"""Boundary conditions beyond periodic.

JAX-native equivalent of the reference's boundary machinery
(``gSetBndSlices``, src/grid.c:608-662; ``gBnd`` →
``gPeriodic``/``gDirichlet``/``gNeumann``, src/grid.c:922-1023):

* PERIODIC  — wrap (plus charge neutralization of phi, gPeriodic).
* DIRICHLET — the first/last *true* node plane along the dimension is
  clamped to the boundary value (the reference sets the slice at
  ghost-inclusive offset 1 / size-2, src/grid.c:941-943).
* NEUMANN   — a ghost plane one node outside satisfies the centered
  derivative across the boundary node:  ghost = phi[inner] - 2*A
  (src/grid.c:1007-1013, same sign convention on both edges).

The reference stores boundary values in per-edge ``bndSlice`` buffers
initialized to the constants 1.0 (Dirichlet) / 2.0 (Neumann)
(src/grid.c:628-649); here they are configurable per edge via
``grid:bndValues`` (2*nDims comma list, lower edges then upper) with the
same defaults.

Instead of baked-in ghost layers, fields are padded on demand:
:func:`pad_bc` produces a (+1 per side) array whose pad planes encode the
BCs, so stencil operators (gradient, Laplacian, multigrid smoothers) stay
dense roll/slice expressions.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .config import PincConfig
from .grid import BndType, GridSpec


@dataclass(frozen=True)
class BCSpec:
    lower: Tuple[BndType, ...]          # per dim
    upper: Tuple[BndType, ...]
    lower_value: Tuple[float, ...]      # Dirichlet value / Neumann derivative
    upper_value: Tuple[float, ...]

    @property
    def n_dims(self) -> int:
        return len(self.lower)

    @property
    def periodic(self) -> bool:
        return all(b is BndType.PERIODIC for b in self.lower + self.upper)

    def homogeneous(self) -> "BCSpec":
        """Same types with zero values — the BCs of multigrid error
        equations on coarse levels."""
        z = (0.0,) * self.n_dims
        return replace(self, lower_value=z, upper_value=z)

    @classmethod
    def from_config(cls, cfg: PincConfig) -> "BCSpec":
        nd = cfg.get_int("grid:ndims")
        names = cfg.get_str_arr("grid:boundaries", 2 * nd)
        bnd = [BndType(b.strip().upper()) for b in names]
        # reference defaults: Dirichlet constant 1.0, Neumann constant 2.0
        # (src/grid.c:628-629), overridable via grid:bndValues
        if "grid:bndvalues" in cfg:
            vals = cfg.get_double_arr("grid:bndvalues", 2 * nd)
        else:
            vals = [1.0 if b is BndType.DIRICHLET else 2.0 for b in bnd]
        return cls(lower=tuple(bnd[:nd]), upper=tuple(bnd[nd:]),
                   lower_value=tuple(vals[:nd]), upper_value=tuple(vals[nd:]))


def clamp_dirichlet(phi: jax.Array, bc: BCSpec) -> jax.Array:
    """Fix Dirichlet node planes to their boundary values (gDirichlet)."""
    nd = bc.n_dims
    for d in range(nd):
        if bc.lower[d] is BndType.DIRICHLET:
            sl = [slice(None)] * phi.ndim
            sl[d] = slice(0, 1)
            phi = phi.at[tuple(sl)].set(bc.lower_value[d])
        if bc.upper[d] is BndType.DIRICHLET:
            sl = [slice(None)] * phi.ndim
            sl[d] = slice(phi.shape[d] - 1, phi.shape[d])
            phi = phi.at[tuple(sl)].set(bc.upper_value[d])
    return phi


def interior_mask(shape: Sequence[int], bc: BCSpec):
    """Boolean mask, False on Dirichlet-clamped planes (smoothers must not
    update them)."""
    import numpy as np
    m = np.ones(tuple(shape), dtype=bool)
    for d in range(bc.n_dims):
        sl = [slice(None)] * len(shape)
        if bc.lower[d] is BndType.DIRICHLET:
            sl[d] = 0
            m[tuple(sl)] = False
        if bc.upper[d] is BndType.DIRICHLET:
            sl = [slice(None)] * len(shape)
            sl[d] = shape[d] - 1
            m[tuple(sl)] = False
    return m


def pad_bc(phi: jax.Array, bc: BCSpec) -> jax.Array:
    """Pad one plane per side per dim, encoding the BCs:

    * PERIODIC:  wrap planes.
    * DIRICHLET: pad = mirror of the inner neighbor through the clamped
      boundary node (2*value - phi[1]); with the node itself clamped this
      keeps the boundary-node stencil consistent (its update returns the
      clamped value) and is never read elsewhere.
    * NEUMANN:   ghost = phi[1] - 2*A (lower) / phi[-2] - 2*A (upper),
      the reference's one-node-outside centered-derivative ghost.
    """
    nd = bc.n_dims
    for d in range(nd):
        n = phi.shape[d]
        first = jax.lax.slice_in_dim(phi, 0, 1, axis=d)
        second = jax.lax.slice_in_dim(phi, 1, 2, axis=d)
        last = jax.lax.slice_in_dim(phi, n - 1, n, axis=d)
        penult = jax.lax.slice_in_dim(phi, n - 2, n - 1, axis=d)

        if bc.lower[d] is BndType.PERIODIC:
            lo = last
        elif bc.lower[d] is BndType.DIRICHLET:
            lo = 2.0 * bc.lower_value[d] - second
        else:  # NEUMANN
            lo = second - 2.0 * bc.lower_value[d]

        if bc.upper[d] is BndType.PERIODIC:
            hi = first
        elif bc.upper[d] is BndType.DIRICHLET:
            hi = 2.0 * bc.upper_value[d] - penult
        else:
            hi = penult - 2.0 * bc.upper_value[d]

        phi = jnp.concatenate([lo, phi, hi], axis=d)
    return phi


def _unpad(x: jax.Array, nd: int) -> jax.Array:
    sl = tuple(slice(1, x.shape[d] - 1) for d in range(nd))
    return x[sl]


def neighbor_sum_bc(phi: jax.Array, bc: BCSpec) -> jax.Array:
    """Sum of the 2*D face neighbors of each node, honoring the BCs."""
    nd = bc.n_dims
    p = pad_bc(phi, bc)
    out = None
    for d in range(nd):
        n = p.shape[d]
        s = (jax.lax.slice_in_dim(p, 2, n, axis=d)
             + jax.lax.slice_in_dim(p, 0, n - 2, axis=d))
        # strip the other dims' pads back to the true extent
        for dd in range(nd):
            if s.shape[dd] != phi.shape[dd]:
                s = jax.lax.slice_in_dim(s, 1, s.shape[dd] - 1, axis=dd)
        out = s if out is None else out + s
    return out


def laplacian_bc(phi: jax.Array, bc: BCSpec) -> jax.Array:
    return neighbor_sum_bc(phi, bc) - (2.0 * bc.n_dims) * phi


def gradient_bc(phi: jax.Array, bc: BCSpec) -> jax.Array:
    """Centered first difference honoring BCs (gFinDiff1st through
    halo/boundary slices)."""
    nd = bc.n_dims
    p = pad_bc(phi, bc)
    comps = []
    for d in range(nd):
        n = p.shape[d]
        g = 0.5 * (jax.lax.slice_in_dim(p, 2, n, axis=d)
                   - jax.lax.slice_in_dim(p, 0, n - 2, axis=d))
        for dd in range(nd):
            if g.shape[dd] != phi.shape[dd]:
                g = jax.lax.slice_in_dim(g, 1, g.shape[dd] - 1, axis=dd)
        comps.append(g)
    return jnp.stack(comps, axis=-1)


def apply_bnd(phi: jax.Array, bc: BCSpec) -> jax.Array:
    """gBnd (src/grid.c:977-1023): neutralize if any periodic dim, clamp
    Dirichlet planes.  (Neumann ghosts are materialized on demand by
    pad_bc; there is no stored ghost layer to update.)"""
    if any(b is BndType.PERIODIC for b in bc.lower + bc.upper):
        phi = phi - jnp.mean(phi)
    return clamp_dirichlet(phi, bc)
