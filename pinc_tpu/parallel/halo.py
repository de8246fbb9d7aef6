"""Halo exchange via collective permutes.

The JAX-native replacement for the reference's ``gHaloOp``/``gHaloOpDim``
(src/grid.c:340-406): where the C extracts a slice, MPI_Sendrecv's it to the
±1 neighbor and sets/adds it into the ghost layer (guarded by an
MPI_Barrier, grid.c:390), here each direction is one ``lax.ppermute`` over a
mesh axis inside ``shard_map`` — XLA's dataflow ordering replaces the
barrier, and the permutes ride the device interconnect.

Two operations, mirroring the reference's TOHALO/FROMHALO modes:

* :func:`pad_plus` (TOHALO / setSlice) — append the + neighbor's first
  plane as a ghost plane so CIC gathers at local index t can read it.
* :func:`fold_plus` (FROMHALO / addSlice) — send the overflow plane of a
  padded deposition block to the + neighbor and add it into their first
  plane.

Both are applied dimension-by-dimension; ordering makes corner
contributions flow exactly like the reference's sequential gHaloOpDim
sweeps.  CIC support is one cell in the + direction only (a particle in
cell i touches nodes i and i+1), so only +1 planes are exchanged.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax


def _perm(n: int, shift: int):
    """Cyclic permutation pairs (src, dst) shifting data by `shift`."""
    return [(i, (i + shift) % n) for i in range(n)]


def pad_plus(block: jax.Array, axes: Sequence[str], n_sub: Sequence[int],
             bounded: Sequence[bool] | None = None) -> jax.Array:
    """Append one ghost plane at the high end of every spatial dim, filled
    with the + neighbor's plane 0.  block: (*t[, C]).  Returns (*t+1[, C]).

    Done sequentially per dim so the sent slice already carries the ghost
    planes of previously-processed dims — corners arrive correctly.

    bounded[d]: non-periodic upper edge along dim d — the global top
    device's ghost plane becomes its OWN last plane, reproducing the
    single-device CIC clamp (ops/cic._corner_indices periodic=False)
    exactly.
    """
    for d, (ax, n) in enumerate(zip(axes, n_sub)):
        first = lax.slice_in_dim(block, 0, 1, axis=d)
        if n > 1:
            # receive plane 0 of the +1 neighbor == send ours to -1
            ghost = lax.ppermute(first, ax, _perm(n, -1))
        else:
            ghost = first                     # self-wrap (periodic)
        if bounded is not None and bounded[d]:
            last = lax.slice_in_dim(block, block.shape[d] - 1,
                                    block.shape[d], axis=d)
            if n > 1:
                is_top = (lax.axis_index(ax) == n - 1)
                ghost = jnp.where(is_top, last, ghost)
            else:
                ghost = last
        block = jnp.concatenate([block, ghost], axis=d)
    return block


def shifted_tiles(x: jax.Array, axis: int, shift: int, mesh_axis: str,
                  n: int) -> jax.Array:
    """Roll a per-tile array one step along a local tile axis, with the
    wrap plane fetched from the neighbor device (periodic globally).

    The single-device tiled layout moves inter-tile data with ``jnp.roll``
    along a tile axis; under a device mesh, the plane that wraps around
    must instead come from the ±1 neighbor along the owning mesh axis.
    ``n == 1`` degenerates to the plain periodic roll.

    shift=+1: data moves to higher tiles; plane 0 receives the -1-device
    neighbor's last plane.  shift=-1: the converse.
    """
    L = x.shape[axis]
    y = jnp.roll(x, shift, axis=axis)
    if n <= 1:
        return y
    if shift == 1:
        plane = lax.slice_in_dim(x, L - 1, L, axis=axis)
        plane = lax.ppermute(plane, mesh_axis, _perm(n, 1))
        rest = lax.slice_in_dim(y, 1, L, axis=axis)
        return jnp.concatenate([plane, rest], axis=axis)
    plane = lax.slice_in_dim(x, 0, 1, axis=axis)
    plane = lax.ppermute(plane, mesh_axis, _perm(n, -1))
    rest = lax.slice_in_dim(y, 0, L - 1, axis=axis)
    return jnp.concatenate([rest, plane], axis=axis)


def fold_plus(block: jax.Array, axes: Sequence[str], n_sub: Sequence[int],
              bounded: Sequence[bool] | None = None) -> jax.Array:
    """Deposition halo-add: block has one overflow plane at the high end of
    every spatial dim (shape *t+1[, C]); fold each overflow plane into the
    + neighbor's plane 0 and drop it.  Returns (*t[, C]).

    bounded[d]: non-periodic upper edge — the global top device folds its
    overflow back into its OWN last plane (the single-device scatter
    clamps node L to L-1), and the global bottom device discards the
    wrapped-in plane."""
    for d, (ax, n) in enumerate(zip(axes, n_sub)):
        t = block.shape[d] - 1
        body = lax.slice_in_dim(block, 0, t, axis=d)
        over_own = lax.slice_in_dim(block, t, t + 1, axis=d)
        over = over_own
        if n > 1:
            over = lax.ppermute(over_own, ax, _perm(n, 1))
        if bounded is not None and bounded[d]:
            if n > 1:
                is_top = (lax.axis_index(ax) == n - 1)
                is_bot = (lax.axis_index(ax) == 0)
                over = jnp.where(is_bot, jnp.zeros_like(over), over)
                add_last = jnp.where(is_top, over_own,
                                     jnp.zeros_like(over_own))
            else:
                over = jnp.zeros_like(over)
                add_last = over_own
            last = lax.slice_in_dim(body, t - 1, t, axis=d) + add_last
            mid = lax.slice_in_dim(body, 1, t - 1, axis=d)
            first = lax.slice_in_dim(body, 0, 1, axis=d) + over
            block = jnp.concatenate([first, mid, last], axis=d)
        else:
            first = lax.slice_in_dim(body, 0, 1, axis=d) + over
            rest = lax.slice_in_dim(body, 1, t, axis=d)
            block = jnp.concatenate([first, rest], axis=d)
    return block
