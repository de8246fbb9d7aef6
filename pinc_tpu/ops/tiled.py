"""Tiled (bucketed) particle layout and its XLA route.

The irregular-memory heart of PIC is charge deposition — the reference
walks particles one at a time scattering into 8 nodes (puDistr3D1,
src/pusher.c:512-572).  This module keeps particles bucketed by tile so
that deposit and gather touch only a tile's small padded node block:

* The grid is split into tiles of ``T^D`` cells; particles live in
  fixed-capacity per-tile buckets, positions stored *tile-local*.
* CIC deposition onto a tile's padded node block becomes a **separable
  dense contraction**:  with per-dim hat weights ``w_d[p, a] =
  max(0, 1 - |x_d(p) - a|)`` over the P = T+1+2M padded node positions,

      rho_tile[a,b,c] = sum_p q_p wx[p,a] wy[p,b] wz[p,c]

  i.e. one (B x P) x (B x P^2) matmul per tile (the XLA route here; the
  fused Triton kernel of ops.pallas_tiled scatters the 8 corners with
  atomics instead).  Out-of-support positions get weight 0, so dead
  slots and recent tile-leavers are safe.
* The padded tile blocks are folded into the global grid with roll/concat
  overlap-adds (same sequential-dimension corner flow as the halo ops).
* The margin M lets particles wander M cells past their tile before their
  weights would clamp, so re-bucketing (ops.exchange, or the sort in
  bucket()) only runs every ``floor(M / v_max)`` steps.

Field gather reads the padded tile blocks with exact tile-local weights.
The contractions run at HIGHEST precision: a default-precision f32
product may run in TF32 on the GPU, which breaks charge conservation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class TileSpec:
    grid: Tuple[int, ...]       # global nodes per dim
    T: int                      # tile edge (cells)
    M: int                      # wander margin (cells)
    B: int                      # bucket capacity (slots per tile)
    chunk: int = 32             # tiles per deposition chunk (memory knob)

    @property
    def n_dims(self) -> int:
        return len(self.grid)

    @property
    def ntiles(self) -> Tuple[int, ...]:
        return tuple(g // self.T for g in self.grid)

    @property
    def NT(self) -> int:
        return math.prod(self.ntiles)

    @property
    def P(self) -> int:
        return self.T + 1 + 2 * self.M

    def validate(self):
        for g in self.grid:
            if g % self.T != 0:
                raise ValueError(f"grid extent {g} not divisible by tile {self.T}")


def tile_origins(ts: TileSpec) -> jax.Array:
    """(NT, D) global node coordinate of each tile's origin."""
    axes = [np.arange(n) * ts.T for n in ts.ntiles]
    mesh = np.meshgrid(*axes, indexing="ij")
    return jnp.asarray(np.stack([m.ravel() for m in mesh], axis=-1),
                       dtype=jnp.float32)


# ---------------------------------------------------------------------------
# Bucketing: global positions -> per-tile slots (sort + gather, no scatter)
# ---------------------------------------------------------------------------

_SLOT_ORDER_CACHE: dict = {}


def _slot_order(B: int) -> np.ndarray:
    """Within-tile slot assignment order: a FIXED pseudo-random
    permutation when B % 8 == 0, so live particles — and free slots —
    spread evenly over the bucket, and slot order is decorrelated from
    position (the lattice IC sweeps x fastest, so in input order
    neighbouring slots would share deposit nodes)."""
    if B % 8:
        return np.arange(B)
    order = _SLOT_ORDER_CACHE.get(B)
    if order is None:
        order = np.random.default_rng(0x5107 ^ B).permutation(B)
        _SLOT_ORDER_CACHE[B] = order
    return order


def bucket(pos: jax.Array, vel: jax.Array, alive: jax.Array,
           ts: TileSpec) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """pos (N, D) float global, vel (N, D), alive (N,).
    Returns (lpos (NT,B,D), vel (NT,B,D), alive (NT,B), n_dropped)."""
    D = ts.n_dims
    nt = ts.ntiles
    tcoord = jnp.floor(pos / ts.T).astype(jnp.int32)
    tcoord = jnp.clip(tcoord, 0, jnp.asarray([n - 1 for n in nt]))
    tid = tcoord[:, 0]
    for d in range(1, D):
        tid = tid * nt[d] + tcoord[:, d]
    tid = jnp.where(alive, tid, ts.NT)            # dead last

    # multi-operand stable sorts carry the payloads through the sort
    # instead of argsort + payload gathers.  TWO sorts with the same key
    # (stable => identical permutation) instead of one 7-operand sort:
    # the transient operand buffers are the setup-time memory peak at
    # 100M+ particle populations
    ops = jax.lax.sort(
        (tid,) + tuple(pos[:, d] for d in range(D)),
        dimension=0, num_keys=1, is_stable=True)
    tid_s = ops[0]
    pos_s = jnp.stack(ops[1:1 + D], axis=-1)
    ops_v = jax.lax.sort(
        (tid,) + tuple(vel[:, d] for d in range(D)),
        dimension=0, num_keys=1, is_stable=True)
    vel_s = jnp.stack(ops_v[1:1 + D], axis=-1)

    # segment starts via searchsorted; slot (t, j) <- sorted index
    # start[t] + order[j] (row-cyclic, see _slot_order)
    starts = jnp.searchsorted(tid_s, jnp.arange(ts.NT, dtype=tid_s.dtype))
    counts = jnp.diff(jnp.concatenate(
        [starts, jnp.searchsorted(tid_s, jnp.asarray([ts.NT],
                                                     dtype=tid_s.dtype))]))
    order = jnp.asarray(_slot_order(ts.B))
    src = starts[:, None] + order[None, :]                     # (NT, B)
    valid = order[None, :] < counts[:, None]
    src_c = jnp.clip(src, 0, pos.shape[0] - 1)
    lpos = pos_s[src_c] - tile_origins(ts)[:, None, :]
    lvel = vel_s[src_c]
    lpos = jnp.where(valid[..., None], lpos, -2.0 * ts.M - 2.0)
    lvel = jnp.where(valid[..., None], lvel, 0.0)
    dropped = jnp.sum(jnp.maximum(counts - ts.B, 0))
    return lpos.astype(jnp.float32), lvel.astype(jnp.float32), valid, dropped


def _tile_ids(pos: jax.Array, alive: jax.Array, ts: TileSpec) -> jax.Array:
    D = ts.n_dims
    nt = ts.ntiles
    tcoord = jnp.floor(pos / ts.T).astype(jnp.int32)
    tcoord = jnp.clip(tcoord, 0, jnp.asarray([n - 1 for n in nt]))
    tid = tcoord[:, 0]
    for d in range(1, D):
        tid = tid * nt[d] + tcoord[:, d]
    return jnp.where(alive, tid, ts.NT)       # dead last


def _slot_map(tid_s: jax.Array, ts: TileSpec):
    """sorted tile ids -> (src (NT,B) sorted-index per slot, valid mask,
    dropped count).  Slot assignment is row-cyclic (_slot_order)."""
    starts = jnp.searchsorted(tid_s, jnp.arange(ts.NT, dtype=tid_s.dtype))
    counts = jnp.diff(jnp.concatenate(
        [starts, jnp.searchsorted(tid_s, jnp.asarray([ts.NT],
                                                     dtype=tid_s.dtype))]))
    order = jnp.asarray(_slot_order(ts.B))
    src = starts[:, None] + order[None, :]
    valid = order[None, :] < counts[:, None]
    dropped = jnp.sum(jnp.maximum(counts - ts.B, 0))
    return jnp.clip(src, 0, tid_s.shape[0] - 1), valid, dropped


def bucket_positions(pos: jax.Array, alive: jax.Array, ts: TileSpec):
    """Phase A of two-phase bucketing: positions only.
    Returns (lpos (NT,B,D), valid (NT,B), tid (N,) UNSORTED, dropped) —
    phase B re-sorts any payload with the same (stable) tid key and
    lands on the identical permutation."""
    D = ts.n_dims
    tid = _tile_ids(pos, alive, ts)
    ops = jax.lax.sort((tid,) + tuple(pos[:, d] for d in range(D)),
                       dimension=0, num_keys=1, is_stable=True)
    tid_s = ops[0]
    pos_s = jnp.stack(ops[1:1 + D], axis=-1)
    src, valid, dropped = _slot_map(tid_s, ts)
    lpos = pos_s[src] - tile_origins(ts)[:, None, :]
    lpos = jnp.where(valid[..., None], lpos, -2.0 * ts.M - 2.0)
    return lpos.astype(jnp.float32), valid, tid, dropped


def bucket_payload(tid: jax.Array, payload: jax.Array, ts: TileSpec):
    """Phase B: route any (N, D) payload through the same stable-sort
    permutation as bucket_positions (identical tid key)."""
    D = payload.shape[-1]
    ops = jax.lax.sort((tid,) + tuple(payload[:, d] for d in range(D)),
                       dimension=0, num_keys=1, is_stable=True)
    tid_s = ops[0]
    pay_s = jnp.stack(ops[1:1 + D], axis=-1)
    src, valid, _ = _slot_map(tid_s, ts)
    out = pay_s[src]
    return jnp.where(valid[..., None], out, 0.0).astype(jnp.float32)


def global_positions(lpos: jax.Array, ts: TileSpec) -> jax.Array:
    """(NT, B, D) local -> global float positions (periodic wrap)."""
    g = lpos + tile_origins(ts)[:, None, :]
    return jnp.mod(g, jnp.asarray(ts.grid, dtype=g.dtype))


# ---------------------------------------------------------------------------
# Deposition: separable contraction + overlap-add fold
# ---------------------------------------------------------------------------

def _hat_weights(x: jax.Array, ts: TileSpec, order: int = 1) -> jax.Array:
    """x (..., ) local coords -> (..., P) weights over padded nodes
    [-M .. T+M].  order=1: CIC hat weights; order=0: NGP indicator
    (nearest node by round-half-up, matching the reference's
    ``(int)(pos+0.5)``, src/pusher.c:1164-1178).  Out-of-support
    positions (dead slots parked at -2M-2, margin leavers) get weight 0
    in both orders."""
    a = jnp.arange(-ts.M, ts.T + ts.M + 1, dtype=x.dtype)
    d = x[..., None] - a
    if order == 0:
        return ((d >= -0.5) & (d < 0.5)).astype(x.dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(d))


def _deposit_tiles(lpos: jax.Array, value: jax.Array, ts: TileSpec,
                   order: int = 1) -> jax.Array:
    """lpos (NT, B, D), value (NT, B) -> padded tile densities
    (NT, P, ..., P).  Chunked over tiles to bound the wyz intermediate."""
    D = ts.n_dims
    P = ts.P

    def chunk_fn(args):
        lp, val = args                      # (C, B, D), (C, B)
        ws = [_hat_weights(lp[..., d], ts, order)
              for d in range(D)]            # D x (C,B,P)
        ws[0] = ws[0] * val[..., None]
        if D == 1:
            return jnp.sum(ws[0], axis=1)
        if D == 2:
            return jnp.einsum("cbx,cby->cxy", ws[0], ws[1],
                              precision=_HIGHEST)
        wyz = (ws[1][..., :, None] * ws[2][..., None, :]).reshape(
            lp.shape[0], lp.shape[1], P * P)
        out = jnp.einsum("cbx,cbk->cxk", ws[0], wyz, precision=_HIGHEST,
                         preferred_element_type=jnp.float32)
        return out.reshape(lp.shape[0], P, P, P)

    NT = ts.NT
    C = min(ts.chunk, NT)
    if NT % C != 0:
        C = math.gcd(NT, C) or 1
    lp = lpos.reshape(NT // C, C, ts.B, D)
    val = value.reshape(NT // C, C, ts.B)
    out = jax.lax.map(chunk_fn, (lp, val))
    return out.reshape((NT,) + (P,) * D)


def _fold_axis(x: jax.Array, tile_ax: int, node_ax: int, ts: TileSpec,
               roll_fn=None) -> jax.Array:
    """Overlap-add one dimension: node range [-M, T+M] -> [0, T) with the
    M low planes rolled to the previous tile and the M+1 high planes rolled
    to the next (periodic tile wrap).

    roll_fn(x, shift, axis) overrides the tile-axis wrap — the sharded
    path substitutes a neighbor-device fetch (parallel.halo.shifted_tiles)
    for the plain periodic jnp.roll."""
    roll = roll_fn or (lambda a, s, ax: jnp.roll(a, s, axis=ax))
    M, T = ts.M, ts.T
    # concat-based overlap-add: zero-padded margin contributions summed
    # with the core in one fusible elementwise pass (an at[].add
    # formulation lowers to dynamic-update-slice copies of the body)
    sl = lambda a, b: jax.lax.slice_in_dim(x, a, b, axis=node_ax)
    core = sl(M, M + T)                                # offsets 0..T-1
    zeros_like_n = lambda n: jnp.zeros(
        core.shape[:node_ax] + (n,) + core.shape[node_ax + 1:], x.dtype)
    out = core
    if M > 0:
        # low planes (offsets -M..-1) land at the previous tile's T-M..T-1
        low = roll(sl(0, M), -1, tile_ax)
        out = out + jnp.concatenate([zeros_like_n(T - M), low],
                                    axis=node_ax)
    # high planes (offsets T..T+M) land at the next tile's 0..M
    high = roll(sl(T + M, 2 * M + T + 1), 1, tile_ax)
    out = out + jnp.concatenate([high, zeros_like_n(T - M - 1)],
                                axis=node_ax)
    return out


def fold_to_global(tiles: jax.Array, ts: TileSpec, roll_fns=None) -> jax.Array:
    """(NT, P..P) padded tile blocks -> (X, Y, ...) global grid.
    roll_fns: optional per-dim tile-wrap overrides (sharded halos)."""
    D = ts.n_dims
    nt = ts.ntiles
    x = tiles.reshape(nt + (ts.P,) * D)
    for d in range(D):
        x = _fold_axis(x, tile_ax=d, node_ax=D + d, ts=ts,
                       roll_fn=roll_fns[d] if roll_fns else None)
    # interleave (n0, n1, .., T, T, ..) -> (n0, T, n1, T, ...)
    perm = []
    for d in range(D):
        perm += [d, D + d]
    x = jnp.transpose(x, perm)
    return x.reshape(ts.grid)


def deposit_tiled(lpos: jax.Array, alive: jax.Array, charge,
                  ts: TileSpec, order: int = 1) -> jax.Array:
    """Full tiled CIC/NGP deposition for one species: (NT,B,D) local
    positions -> (grid) charge density."""
    value = jnp.where(alive, jnp.asarray(charge, jnp.float32), 0.0)
    tiles = _deposit_tiles(lpos, value, ts, order)
    return fold_to_global(tiles, ts)


# ---------------------------------------------------------------------------
# Gather: padded tile blocks + per-particle XLA gather (exact local weights)
# ---------------------------------------------------------------------------

def pad_tiles(field: jax.Array, ts: TileSpec, roll_fns=None) -> jax.Array:
    """Global (grid..., C) or (grid...) -> (NT, P.., [C]) padded blocks
    (periodic).  Sequential per-dim so corners are correct.
    roll_fns: optional per-dim tile-wrap overrides (sharded halos)."""
    D = ts.n_dims
    nt = ts.ntiles
    vec = field.ndim == D + 1
    C = field.shape[-1] if vec else None
    shape = []
    for d in range(D):
        shape += [nt[d], ts.T]
    if vec:
        shape.append(C)
    x = field.reshape(shape)
    # bring tile axes first: (n0, n1, .., T0, T1, .. [,C])
    perm = [2 * d for d in range(D)] + [2 * d + 1 for d in range(D)]
    if vec:
        perm.append(2 * D)
    x = jnp.transpose(x, perm)
    for d in range(D):
        roll = ((roll_fns[d] if roll_fns else None)
                or (lambda a, s, ax: jnp.roll(a, s, axis=ax)))
        node_ax = D + d
        lo = jax.lax.slice_in_dim(x, x.shape[node_ax] - ts.M,
                                  x.shape[node_ax], axis=node_ax)
        lo = roll(lo, 1, d)
        hi = jax.lax.slice_in_dim(x, 0, ts.M + 1, axis=node_ax)
        hi = roll(hi, -1, d)
        x = jnp.concatenate([lo, x, hi], axis=node_ax)
    x = x.reshape((ts.NT,) + (ts.P,) * D + ((C,) if vec else ()))
    return x


def gather_tiled_dense(field_pad: jax.Array, lpos: jax.Array,
                     ts: TileSpec, chunk: int = 4,
                     order: int = 1) -> jax.Array:
    """Dense-contraction gather — the transpose of the deposition
    contraction: the field at each particle is

        E_p = sum_abc wx[p,a] wy[p,b] wz[p,c] F[a,b,c]

    evaluated dimension by dimension (the adjoint of the deposit, with the
    same hat weights).  Chunked over tiles to bound the (B, P^2, C)
    intermediate."""
    D = ts.n_dims
    P = ts.P
    C = field_pad.shape[-1]
    NT = ts.NT

    def chunk_fn(args):
        lp, F = args                        # (c,B,D), (c,P..P,C)
        ws = [_hat_weights(lp[..., d], ts, order) for d in range(D)]
        if D == 1:
            return jnp.einsum("cbx,cxv->cbv", ws[0], F, precision=_HIGHEST,
                              preferred_element_type=jnp.float32)
        if D == 2:
            t = jnp.einsum("cbx,cxyv->cbyv", ws[0], F, precision=_HIGHEST,
                           preferred_element_type=jnp.float32)
            return jnp.sum(ws[1][..., None] * t, axis=2)
        Ff = F.reshape(F.shape[0], P, P * P * C)
        t1 = jnp.einsum("cbx,cxk->cbk", ws[0], Ff, precision=_HIGHEST,
                        preferred_element_type=jnp.float32)
        t1 = t1.reshape(t1.shape[0], t1.shape[1], P, P * C)
        t2 = jnp.sum(ws[1][..., None] * t1, axis=2)
        t2 = t2.reshape(t2.shape[0], t2.shape[1], P, C)
        return jnp.sum(ws[2][..., None] * t2, axis=2)

    c = min(chunk, NT)
    if NT % c != 0:
        c = math.gcd(NT, c) or 1
    lp = lpos.reshape(NT // c, c, ts.B, D)
    F = field_pad.reshape((NT // c, c) + (P,) * D + (C,))
    out = jax.lax.map(chunk_fn, (lp, F))
    return out.reshape(NT, ts.B, C)


def gather_tiled(field_pad: jax.Array, lpos: jax.Array,
                 ts: TileSpec, order: int = 1) -> jax.Array:
    """field_pad (NT, P.., C); lpos (NT, B, D) -> (NT, B, C).
    Standard 2^D-corner CIC gather with tile-local indices (idx = floor
    (lpos) + M, in [0, P-1]); order=0 reads the nearest node instead
    (puInterpND0, src/pusher.c:1164-1178)."""
    import itertools
    D = ts.n_dims
    rows = jnp.arange(ts.NT, dtype=jnp.int32)[:, None]
    if order == 0:
        near = jnp.floor(lpos + 0.5).astype(jnp.int32) + ts.M
        near = jnp.clip(near, 0, ts.P - 1)
        idx = tuple(near[..., d] for d in range(D))
        return field_pad[(rows,) + idx]
    base = jnp.floor(lpos).astype(jnp.int32) + ts.M        # (NT,B,D)
    frac = lpos - jnp.floor(lpos)
    base = jnp.clip(base, 0, ts.P - 2)
    out = None
    for offs in itertools.product((0, 1), repeat=D):
        idx = tuple(base[..., d] + offs[d] for d in range(D))
        w = None
        for d, o in enumerate(offs):
            wd = frac[..., d] if o else 1.0 - frac[..., d]
            w = wd if w is None else w * wd
        val = field_pad[(rows,) + idx]                     # (NT,B,C)
        contrib = w[..., None] * val
        out = contrib if out is None else out + contrib
    return out


# ---------------------------------------------------------------------------
# One particle step on the XLA route (contract of ops.pallas_tiled)
# ---------------------------------------------------------------------------

def particle_pass(lpos, vel, alive, ts: TileSpec, *, charge, qm=None,
                  field=None, kick=False, drift=False, deposit=False,
                  order_acc=1, order_distr=1, e_ext=None, boris_T=None,
                  boris_S=None, gather="dense"):
    """The chosen parts of one particle step (kick, drift, deposit) for
    all species, with the contract of ops.pallas_tiled.particle_pass in
    any D.  It is the XLA route of the tiled layout and the plain
    reference the kernel is checked against.

    lpos, vel: (S, D, NT, B); alive (S, NT, B) f32 0/1; field: (NT, P..,
    D) padded tiles (pad_tiles).  gather: "dense" for the dense contraction
    (hat weights, the exact adjoint of the deposit), anything else for
    the per-corner gather.  Returns (tiles (NT, P..) or None, lpos', vel',
    vdot (S,), n_out (S,))."""
    S, D = lpos.shape[:2]
    lo, hi = -float(ts.M), float(ts.T + ts.M)
    g_fn = gather_tiled_dense if gather == "dense" else gather_tiled
    tiles = None
    lposs, vels = [], []
    vdots, nouts = [], []
    for s in range(S):
        x, v = lpos[s], vel[s]
        live = alive[s] > 0.5
        if kick:
            Ep = jnp.moveaxis(g_fn(field, jnp.moveaxis(x, 0, -1), ts,
                                   order=order_acc), -1, 0)   # (D, NT, B)
            if e_ext is not None:
                Ep = Ep + jnp.asarray(e_ext, Ep.dtype)[:, None, None]
            if boris_T is not None:
                halfk = 0.5 * qm[s] * Ep
                v_minus = v + halfk
                Tv = jnp.asarray(boris_T[s], jnp.float32)[:, None, None]
                Sv = jnp.asarray(boris_S[s], jnp.float32)[:, None, None]
                v_prime = v_minus + jnp.cross(v_minus, Tv, axis=0)
                v_plus = v_minus + jnp.cross(v_prime, Sv, axis=0)
                v_new = v_plus + halfk
                # reference KE convention: 0.5 m |v_plus|^2
                # (puBoris3D1KE, src/pusher.c:465-471)
                v_dot = jnp.sum(v_plus * v_plus, axis=0)
            else:
                v_new = v + qm[s] * Ep
                v_dot = jnp.sum(v * v_new, axis=0)
            vdots.append(jnp.sum(jnp.where(live, v_dot, 0.0)))
            v = jnp.where(live[None], v_new, v)
        if drift:
            x = x + v
            out = jnp.any((x < lo) | (x >= hi), axis=0)
            nouts.append(jnp.sum(live & out).astype(jnp.float32))
        if deposit:
            value = jnp.where(live, jnp.float32(charge[s]), 0.0)
            t = _deposit_tiles(jnp.moveaxis(x, 0, -1), value, ts,
                               order_distr)
            tiles = t if tiles is None else tiles + t
        lposs.append(x)
        vels.append(v)
    zeros = jnp.zeros((S,), jnp.float32)
    return (tiles,
            jnp.stack(lposs) if drift else lpos,
            jnp.stack(vels) if kick else vel,
            jnp.stack(vdots) if kick else zeros,
            jnp.stack(nouts) if drift else zeros)
