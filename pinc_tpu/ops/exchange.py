"""Exchange re-bucketing: move tile leavers to the neighbouring tile.

Between re-buckets a particle wanders at most the margin M < T past its
tile, so re-homing it is a +-1-tile move.  Per dimension d, in order:

1. **extract** — live particles with x_d < 0 (minus face) or x_d >= T
   (plus face) are ranked per tile by a cumulative sum; the first K of
   each face are copied into a (NT, 2K) face buffer, every leaver is
   killed in its old slot (leavers past K are dropped);
2. **move** — the minus buffers roll one tile down along d and the plus
   buffers one tile up (``roll_fns`` substitute a neighbour-device fetch
   on a mesh), with the frame shift x_d += T / -= T;
3. **merge** — arrivals take the tile's free slots in rank order
   (arrivals past the free count are dropped).

Corner movers ride several sweeps, like the reference's per-dimension
migration.  Drops are counted by alive-count conservation and returned.

Reference parity: the communication step of puExtractEmigrants3D /
puMigrate (src/pusher.c:782-1035) for the tiled layout — per-dimension
neighbour transfer with frame shift, fixed-capacity buffers,
append-at-free-slots.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def _exchange_dim(planes, alive, ntiles, d: int, T: int, K: int, roll):
    NT, B = alive.shape
    rows = jnp.arange(NT, dtype=jnp.int32)[:, None]
    slots = jnp.arange(B, dtype=jnp.int32)[None, :]
    live = alive > 0.5
    x = planes[d]
    lm = live & (x < 0.0)
    lp = live & (x >= float(T))
    rm = jnp.cumsum(lm, axis=1, dtype=jnp.int32) - 1
    rp = jnp.cumsum(lp, axis=1, dtype=jnp.int32) - 1
    # face-buffer position of each leaver: [0, K) minus, [K, 2K) plus
    pos = jnp.where(lm & (rm < K), rm,
                    jnp.where(lp & (rp < K), K + rp, 2 * K))
    src = jnp.full((NT, 2 * K), B, jnp.int32).at[rows, pos].set(
        jnp.broadcast_to(slots, (NT, B)), mode="drop")
    valid = src < B
    srcc = jnp.minimum(src, B - 1)
    bufs = [jnp.take_along_axis(p, srcc, axis=1) for p in planes]
    alive = jnp.where(lm | lp, 0.0, alive)

    # roll the faces to the neighbours (tile axes leading) and shift the
    # frame: minus-goers enter at the top of the lower tile, plus-goers
    # at the bottom of the upper one
    def move(a, sign):
        a = a.reshape(tuple(ntiles) + a.shape[1:])
        return roll(a, sign, d).reshape((NT,) + a.shape[len(ntiles):])

    inc = []
    for p in bufs + [valid.astype(jnp.float32)]:
        inc.append(jnp.concatenate([move(p[:, :K], -1), move(p[:, K:], 1)],
                                   axis=1))
    shift = jnp.concatenate([jnp.full((K,), float(T), jnp.float32),
                             jnp.full((K,), -float(T), jnp.float32)])
    # x + T of a tiny negative x rounds up to T: keep arrivals in [0, T)
    inc[d] = jnp.minimum(inc[d] + shift[None, :],
                         jnp.nextafter(jnp.float32(T), jnp.float32(0)))
    arrive = inc[-1] > 0.5

    # free-slot table: fslot[t, r] = slot of the r-th free slot (B if none)
    free = alive < 0.5
    frank = jnp.cumsum(free, axis=1, dtype=jnp.int32) - 1
    fslot = jnp.full((NT, 2 * K), B, jnp.int32).at[
        rows, jnp.where(free & (frank < 2 * K), frank, 2 * K)].set(
        jnp.broadcast_to(slots, (NT, B)), mode="drop")
    arank = jnp.cumsum(arrive, axis=1, dtype=jnp.int32) - 1
    dest = jnp.where(arrive, jnp.take_along_axis(
        fslot, jnp.clip(arank, 0, 2 * K - 1), axis=1), B)
    planes = tuple(p.at[rows, dest].set(v, mode="drop")
                   for p, v in zip(planes, inc[:-1]))
    alive = alive.at[rows, dest].set(1.0, mode="drop")
    return planes, alive


def rebucket_exchange(planes: Tuple[jax.Array, ...], alive: jax.Array,
                      ntiles: Sequence[int], T: int, K: int,
                      roll_fns=None):
    """Re-bucket one species by +-1-tile exchange on component planes.

    planes: (x_0..x_{D-1}, v_0..v_{D-1}), each (NT, B) f32 with tile-local
    coordinates first; alive: (NT, B) f32 0/1; ntiles: the (local) tile
    grid, D = len(ntiles); K: per-face transfer capacity.  roll_fns:
    optional per-dimension ``roll(a, shift, axis)`` overrides for the
    buffer wrap (neighbour-device fetches on a mesh; default periodic
    ``jnp.roll``).  Returns (planes', alive', n_dropped)."""
    n0 = jnp.sum(alive > 0.5, dtype=jnp.int32)
    planes = tuple(planes)
    for d in range(len(ntiles)):
        roll = ((roll_fns[d] if roll_fns else None)
                or (lambda a, s, ax: jnp.roll(a, s, axis=ax)))
        planes, alive = _exchange_dim(planes, alive, ntiles, d, T, K, roll)
    return planes, alive, n0 - jnp.sum(alive > 0.5, dtype=jnp.int32)
