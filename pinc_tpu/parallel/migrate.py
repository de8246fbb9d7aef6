"""Particle migration across the device mesh.

JAX-native replacement for the reference's emigrant machinery
(``puExtractEmigrants3D``/``ND`` + ``puMigrate``, src/pusher.c:782-1035):
the C classifies particles into 3^D-1 neighbor bins, packs them into
dynamically-sized buffers with back-fill deletion, and exchanges counts and
payloads with nonblocking MPI.  None of that shape-dynamism works under
XLA, so the redesign is:

* migration happens **dimension by dimension** (X, then Y, then Z); a
  corner-crossing particle hops two devices in two sub-exchanges — the
  standard static-shape alternative to the 3^D neighborhood, equivalent
  whenever per-step displacement < one subdomain (guaranteed by the same
  velocity limits the reference's thresholds assume);
* emigrants are **compacted by cumsum-rank** into fixed-capacity buffers
  (capacity = ``parallel:migrationCap``), exchanged with one
  ``lax.ppermute`` per direction, and scattered into free slots found by a
  second cumsum — all O(cap) dense ops, no sort;
* buffer overflow is *counted and reported* instead of corrupting memory
  (the reference's documented unsafe spot, src/pusher.c:776,913 and
  doc/todo.txt "SAFE PARTICLE MIGRATION").

Particles carry *global* (unwrapped) cell coordinates during the exchange;
ownership tests use the local frame (cell - offset), and the global
periodic wrap is applied once at the end — this makes the wraparound and
neighbor directions consistent at the domain edges.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..population import Particles
from .mesh import MeshCtx


def _perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def _pack(arrs, mask: jax.Array, K: int):
    """Compact rows of each array in `arrs` where mask is set into the
    first rows of a (K,)-capacity buffer.  Returns (buffers, valid (K,),
    n_overflow)."""
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    idx = jnp.where(mask & (rank < K), rank, K)          # K = drop slot
    bufs = []
    for a in arrs:
        shape = (K + 1,) + a.shape[1:]
        bufs.append(jnp.zeros(shape, a.dtype).at[idx].set(
            jnp.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, 0)))
    valid = jnp.zeros((K + 1,), bool).at[idx].set(mask)
    n_sent = jnp.sum(valid[:K])
    overflow = jnp.sum(mask) - n_sent
    return [b[:K] for b in bufs], valid[:K], overflow


def _unpack(arrs, alive: jax.Array, bufs, valid: jax.Array):
    """Scatter valid buffer rows into free (dead) slots.  Returns updated
    (arrs, alive, n_dropped)."""
    cap = alive.shape[0]
    K = valid.shape[0]
    free = ~alive
    frank = jnp.cumsum(free.astype(jnp.int32)) - 1
    # slot_of_rank[r] = index of the r-th free slot (sentinel cap if none)
    sidx = jnp.where(free & (frank < K), frank, K)
    slot_of_rank = jnp.full((K + 1,), cap, dtype=jnp.int32).at[sidx].set(
        jnp.arange(cap, dtype=jnp.int32))
    tgt = jnp.where(valid, slot_of_rank[:K], cap)         # cap = dropped
    dropped = jnp.sum(valid & (tgt >= cap))
    out = []
    for a, b in zip(arrs, bufs):
        out.append(a.at[tgt].set(b, mode="drop"))
    alive = alive.at[tgt].set(True, mode="drop")
    return out, alive, dropped


def migrate_species(cell: jax.Array, frac: jax.Array, vel: jax.Array,
                    alive: jax.Array, ctx: MeshCtx, offset: jax.Array,
                    K: int) -> Tuple[jax.Array, jax.Array, jax.Array,
                                     jax.Array, jax.Array]:
    """One species' per-dimension exchange.  cell/frac/vel: (cap, D),
    alive: (cap,).  Returns updated arrays + overflow count."""
    lost = jnp.zeros((), jnp.int32)
    for d, (ax, n, t) in enumerate(zip(ctx.axes, ctx.n_subdomains,
                                       ctx.true_size)):
        lc = cell[:, d] - offset[d]
        for shift, mask in ((-1, alive & (lc < 0)),
                            (+1, alive & (lc >= t))):
            bufs, valid, over = _pack([cell, frac, vel], mask, K)
            alive = alive & ~mask
            if n > 1:
                bufs = [lax.ppermute(b, ax, _perm(n, shift)) for b in bufs]
                valid = lax.ppermute(valid, ax, _perm(n, shift))
            (cell, frac, vel), alive, dropped = _unpack(
                [cell, frac, vel], alive, bufs, valid)
            lost = lost + over.astype(jnp.int32) + dropped.astype(jnp.int32)
    # final global periodic wrap (shiftImmigrants, src/pusher.c:941-964)
    L = jnp.asarray(ctx.global_size, dtype=cell.dtype)
    cell = jnp.where(alive[:, None], jnp.mod(cell, L), cell)
    return cell, frac, vel, alive, lost


def migrate(p: Particles, ctx: MeshCtx, offset: jax.Array,
            K: int) -> Tuple[Particles, jax.Array]:
    """All-species migration (puMigrate, src/pusher.c:1030-1035).  Runs
    inside shard_map; returns (particles, lost-count psum'd over mesh)."""
    S = p.cell.shape[0]
    cells, fracs, vels, alives = [], [], [], []
    lost = jnp.zeros((), jnp.int32)
    for s in range(S):
        c, f, v, a, l = migrate_species(p.cell[s], p.frac[s], p.vel[s],
                                        p.alive[s], ctx, offset, K)
        cells.append(c); fracs.append(f); vels.append(v); alives.append(a)
        lost = lost + l
    p = Particles(cell=jnp.stack(cells), frac=jnp.stack(fracs),
                  vel=jnp.stack(vels), alive=jnp.stack(alives))
    for ax in ctx.axes:
        lost = lax.psum(lost, ax)
    return p, lost
