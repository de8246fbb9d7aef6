"""Gather / scatter interpolation kernels (NGP and CIC).

JAX-native equivalents of the reference's interpolators and distributors
(``puInterp3D1``/``puInterpND1``/``puInterpND0``, src/pusher.c:1089-1178;
``puDistr3D1``/``puDistrND1``/``puDistrND0``, src/pusher.c:512-678).

The C code walks one particle at a time through strided pointers.  Here both
directions are dense vectorized ops over the whole population:

* gather  — 2^D wrapped corner gathers + lerp (a ``jnp.take``-style XLA
  gather).
* scatter — 2^D ``.at[].add`` scatter-adds.  This is the baseline; the
  tiled layout (ops/tiled.py, ops/pallas_tiled.py) buckets particles by
  tile and deposits onto small per-tile node blocks instead.

Positions arrive in split (cell:int32, frac:float) form, so CIC weights
``frac``/``1-frac`` are exact — no catastrophic cancellation at large
coordinates as with a single float position.

The reference's per-species "renormalization trick" (scaling the whole E/rho
grid by q/m around each species loop, src/pusher.c:159-170, 522-568) is an
MPI-era micro-optimization; here the per-particle multiply rides the
scatter and the grid rescale would cost an extra device-memory sweep, so
weights are applied directly.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def _corner_indices(cell: jax.Array, offsets: Tuple[int, ...],
                    L: Sequence[int], periodic) -> Tuple[jax.Array, ...]:
    """Per-dim node indices for one corner offset, with periodic wrap.
    cell: (..., D) int32; periodic: bool or per-dim sequence (mixed decks
    wrap their periodic dims and clamp the bounded ones, like the
    reference's per-edge gBnd).  Returns a D-tuple of index arrays."""
    D = len(offsets)
    per = (periodic,) * D if isinstance(periodic, bool) else tuple(periodic)
    idx = []
    for d, off in enumerate(offsets):
        i = cell[..., d]
        if off:
            i = i + off
            if per[d]:
                i = jnp.where(i >= L[d], i - L[d], i)
            else:
                i = jnp.clip(i, 0, L[d] - 1)
        idx.append(i)
    return tuple(idx)


def _corner_weight(frac: jax.Array, offsets: Tuple[int, ...]) -> jax.Array:
    """CIC weight for one corner: prod_d (frac_d if off_d else 1-frac_d)."""
    w = None
    for d, off in enumerate(offsets):
        wd = frac[..., d] if off else 1.0 - frac[..., d]
        w = wd if w is None else w * wd
    return w


def gather_cic(field: jax.Array, cell: jax.Array, frac: jax.Array,
               periodic=True) -> jax.Array:
    """Trilinear (multi-linear) interpolation of ``field`` at particle
    positions.  field: (*L,) or (*L, C); cell/frac: (..., D).
    Returns (...,) or (..., C).  Matches puInterpND1 exactly."""
    D = cell.shape[-1]
    L = field.shape[:D]
    vector = field.ndim == D + 1
    out = None
    for offsets in itertools.product((0, 1), repeat=D):
        idx = _corner_indices(cell, offsets, L, periodic)
        w = _corner_weight(frac, offsets)
        val = field[idx]                       # XLA gather
        if vector:
            w = w[..., None]
        contrib = w * val
        out = contrib if out is None else out + contrib
    return out


def _wrap_or_clamp_near(near, L, periodic):
    """NGP node indices: wrap periodic dims, clamp bounded ones."""
    D = near.shape[-1]
    per = (periodic,) * D if isinstance(periodic, bool) else tuple(periodic)
    cols = []
    for d in range(D):
        i = near[..., d]
        if per[d]:
            i = jnp.where(i >= L[d], 0, i)
        else:
            i = jnp.clip(i, 0, L[d] - 1)
        cols.append(i)
    return tuple(cols)


def gather_ngp(field: jax.Array, cell: jax.Array, frac: jax.Array,
               periodic=True) -> jax.Array:
    """Nearest-grid-point gather: node = round(pos) (puInterpND0,
    src/pusher.c:1164-1178)."""
    D = cell.shape[-1]
    L = field.shape[:D]
    near = cell + (frac >= 0.5).astype(cell.dtype)
    idx = _wrap_or_clamp_near(near, L, periodic)
    return field[idx]


def scatter_cic(shape: Sequence[int], cell: jax.Array, frac: jax.Array,
                value: jax.Array, periodic=True,
                dtype=jnp.float32) -> jax.Array:
    """CIC charge deposition: rho[corner] += w_corner * value for the 2^D
    corners of each particle's cell (puDistrND1 semantics).  value carries
    charge * alive-mask, so dead slots deposit exactly zero.

    cell/frac: (N, D); value: (N,).  Returns rho of ``shape``.
    """
    D = cell.shape[-1]
    rho = jnp.zeros(tuple(shape), dtype=dtype)
    for offsets in itertools.product((0, 1), repeat=D):
        idx = _corner_indices(cell, offsets, shape, periodic)
        w = _corner_weight(frac, offsets) * value
        rho = rho.at[idx].add(w.astype(dtype))
    return rho


def scatter_ngp(shape: Sequence[int], cell: jax.Array, frac: jax.Array,
                value: jax.Array, periodic=True,
                dtype=jnp.float32) -> jax.Array:
    """NGP deposition: all charge to the nearest node (puDistrND0)."""
    near = cell + (frac >= 0.5).astype(cell.dtype)
    idx = _wrap_or_clamp_near(near, tuple(shape), periodic)
    rho = jnp.zeros(tuple(shape), dtype=dtype)
    return rho.at[idx].add(value.astype(dtype))
