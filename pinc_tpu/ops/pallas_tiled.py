"""Fused particle kernel for the tiled layout (Pallas, Triton route).

The XLA route of ops/tiled.py builds the deposit and gather from dense
per-tile contractions, which write (chunk, B, P) and (chunk, B, P^2)
weight tensors to device memory — about half a kilobyte per particle slot
at P = 11.  This kernel touches each particle once per step instead: it
reads x, v and the alive flag, writes x and v back, and keeps every
intermediate in registers.

One program handles one tile's chunk of ``BC`` slots (a power of two) for
every species:

* **kick** — gather E at the particle from the tile's padded
  ``(P, P, P, 3)`` field block (CIC: 8 corners, NGP: 1), add the uniform
  external field, then the leapfrog kick or the Boris rotation, and sum
  the kinetic-energy term per program;
* **drift** — x += v, and count live particles beyond the wander margin;
* **deposit** — scatter q * weight onto the tile's padded ``P^3`` charge
  block with atomic adds (8 corners for CIC, 1 for NGP).

Static flags choose the parts: the scan step runs all three, the object
and bounded-wall decks run drift and deposit apart (their absorption and
reflection sit between them), the initial half kick runs the gather alone.

Corner nodes outside the padded block get weight 0 — the same support as
the hat weights of ops.tiled, so a particle beyond the margin deposits
and gathers only the part of its stencil that is inside the block, and
dead slots (parked far outside) touch nothing.

Reference parity: gather + kick == puAcc3D1KE / puBoris3D1KE
(src/pusher.c:147-214, 437-482), drift == puMove (src/pusher.c:86-119),
deposit == puDistr3D1 / puDistr3D0 (src/pusher.c:512-572).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .tiled import TileSpec

# Largest slot chunk one program handles; bucket capacities are rounded
# to slot_quantum() so that a power-of-two chunk divides them.
SLOT_CHUNK = 512
NUM_WARPS = 4


def slot_quantum(slots: float) -> int:
    """Bucket-capacity quantum for ``slots`` wanted slots: the smallest
    power of two covering them, at most SLOT_CHUNK."""
    q = 1
    while q < min(slots, SLOT_CHUNK):
        q *= 2
    return q


def _chunk(B: int) -> int:
    """Largest power of two dividing B, at most SLOT_CHUNK."""
    c = SLOT_CHUNK
    while B % c:
        c //= 2
    return c


def _stencil(x, M: int, P: int, order: int):
    """Per-dimension (node index, weight) pairs of one coordinate row:
    CIC two nodes with hat weights, NGP the nearest node (round half up,
    the reference's ``(int)(pos+0.5)``).  Nodes outside [0, P) get
    weight 0 and a clamped index."""
    if order == 0:
        i = jnp.floor(x + 0.5).astype(jnp.int32) + M
        pairs = [(i, jnp.ones_like(x))]
    else:
        f = jnp.floor(x)
        i = f.astype(jnp.int32) + M
        w1 = x - f
        pairs = [(i, 1.0 - w1), (i + 1, w1)]
    return [(jnp.clip(i, 0, P - 1),
             jnp.where((i >= 0) & (i < P), w, 0.0)) for i, w in pairs]


def _corners(xyz, M: int, P: int, order: int):
    """(flat node index within the tile block, weight) per stencil
    corner."""
    sx, sy, sz = (_stencil(c, M, P, order) for c in xyz)
    out = []
    for ix, wx in sx:
        for iy, wy in sy:
            for iz, wz in sz:
                out.append(((ix * P + iy) * P + iz, wx * wy * wz))
    return out


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _kick(v, E, qm: float, boris):
    """Leapfrog kick (vdot = v.(v+dv)) or the Boris rotation (vdot =
    |v_plus|^2), matching the KE conventions of puAcc3D1KE and
    puBoris3D1KE (src/pusher.c:197-210, 465-471)."""
    if boris is None:
        vn = [v[c] + qm * E[c] for c in range(3)]
        return vn, v[0] * vn[0] + v[1] * vn[1] + v[2] * vn[2]
    T, S = boris
    half = [0.5 * qm * E[c] for c in range(3)]
    vm = [v[c] + half[c] for c in range(3)]
    cr = _cross(vm, T)
    vpr = [vm[c] + cr[c] for c in range(3)]
    cr2 = _cross(vpr, S)
    vpl = [vm[c] + cr2[c] for c in range(3)]
    vn = [vpl[c] + half[c] for c in range(3)]
    return vn, vpl[0] * vpl[0] + vpl[1] * vpl[1] + vpl[2] * vpl[2]


def _kernel(*refs, S, NC, BC, T, M, P, charge, qm, kick, drift, deposit,
            order_acc, order_distr, e_ext, boris, interpret):
    refs = list(refs)
    lpos_ref, vel_ref, alive_ref = refs[:3]
    i = 3
    e_ref = None
    if kick:
        e_ref = refs[i]
        i += 1
    if deposit:
        i += 1                                  # zeros aliased to rho_ref
    outs = refs[i:]
    rho_ref = outs.pop(0) if deposit else None
    pos_out = outs.pop(0) if drift else None
    vel_out = outs.pop(0) if kick else None
    ke_ref = outs.pop(0) if kick else None
    nout_ref = outs.pop(0) if drift else None

    pid = pl.program_id(0)
    t = pid // NC
    c = pid % NC
    sl = pl.ds(c * BC, BC)
    P3 = P * P * P
    lo, hi = -float(M), float(T + M)
    for s in range(S):
        a = alive_ref[s, t, sl]
        live = a > 0.5
        x = [lpos_ref[s, d, t, sl] for d in range(3)]
        v = [vel_ref[s, d, t, sl] for d in range(3)]
        if kick:
            E = [jnp.zeros_like(a) + e_ext[d] for d in range(3)]
            for idx, w in _corners(x, M, P, order_acc):
                for d in range(3):
                    E[d] = E[d] + w * e_ref[(t * P3 + idx) * 3 + d]
            b = None if boris is None else boris[s]
            vn, vdot = _kick(v, E, qm[s], b)
            v = [jnp.where(live, vn[d], v[d]) for d in range(3)]
            for d in range(3):
                vel_out[s, d, t, sl] = v[d]
            ke_ref[s, t, c] = jnp.sum(jnp.where(live, vdot, 0.0))
        if drift:
            x = [x[d] + v[d] for d in range(3)]
            out = jnp.zeros(a.shape, jnp.bool_)
            for d in range(3):
                pos_out[s, d, t, sl] = x[d]
                out = out | (x[d] < lo) | (x[d] >= hi)
            nout_ref[s, t, c] = jnp.sum(jnp.where(live & out, 1.0, 0.0))
        if deposit:
            qa = jnp.where(live, charge[s], 0.0)
            for idx, w in _corners(x, M, P, order_distr):
                val = qa * w
                if interpret:
                    # the interpreter's atomic_add drops repeated indices
                    # within one vector; a functional scatter-add sums them
                    rho_ref[...] = rho_ref[...].at[t * P3 + idx].add(val)
                else:
                    plgpu.atomic_add(rho_ref, (t * P3 + idx,), val,
                                     mask=val != 0.0)


def particle_pass(lpos, vel, alive, ts: TileSpec, *, charge, qm=None,
                  field=None, kick=False, drift=False, deposit=False,
                  order_acc=1, order_distr=1, e_ext=None, boris_T=None,
                  boris_S=None, interpret=False):
    """Run the chosen parts of one particle step for all species.

    lpos, vel: (S, 3, NT, B) tile-local planes; alive: (S, NT, B) f32 0/1;
    B must be a multiple of a power-of-two chunk (slot_quantum).
    charge, qm: per-species deposit weights and kick factors (q/m * dt),
    Python floats.  field: (NT, P, P, P, 3) padded E tiles (ops.tiled.
    pad_tiles; kick only — a half kick passes the field and e_ext already
    halved).  boris_T /
    boris_S: optional (S, 3) rotation vectors (puGet3DRotationParameters,
    src/pusher.c:483-505).

    Returns (rho tiles (NT, P, P, P) or None, lpos', vel', vdot (S,),
    n_out (S,)): vdot is the per-species sum over live particles of the
    kick's KE term (zeros without kick), n_out the live particles beyond
    the wander margin after the drift (zeros without drift)."""
    assert ts.n_dims == 3, "the particle kernel is 3-D (ops.tiled for ND)"
    S, D, NT, B = lpos.shape
    P = ts.P
    BC = _chunk(B)
    NC = B // BC
    f32 = jnp.float32
    charge = tuple(float(q) for q in charge)
    qm = tuple(float(q) for q in qm) if qm is not None else (0.0,) * S
    e_ext = (0.0, 0.0, 0.0) if e_ext is None else tuple(
        float(e) for e in e_ext)
    boris = None
    if boris_T is not None:
        boris = tuple((tuple(float(u) for u in boris_T[s]),
                       tuple(float(u) for u in boris_S[s]))
                      for s in range(S))

    args = [lpos, vel, alive]
    out_shape = []
    aliases = {}
    if kick:
        args.append(field.reshape(-1).astype(f32))
    if deposit:
        aliases[len(args)] = 0
        args.append(jnp.zeros((NT * P ** 3,), f32))
        out_shape.append(jax.ShapeDtypeStruct((NT * P ** 3,), f32))
    if drift:
        aliases[0] = len(out_shape)
        out_shape.append(jax.ShapeDtypeStruct(lpos.shape, f32))
    if kick:
        aliases[1] = len(out_shape)
        out_shape.append(jax.ShapeDtypeStruct(vel.shape, f32))
        out_shape.append(jax.ShapeDtypeStruct((S, NT, NC), f32))
    if drift:
        out_shape.append(jax.ShapeDtypeStruct((S, NT, NC), f32))
    assert out_shape, "particle_pass needs at least one of kick/drift/deposit"

    res = list(pl.pallas_call(
        partial(_kernel, S=S, NC=NC, BC=BC, T=ts.T, M=ts.M, P=P,
                charge=charge, qm=qm, kick=kick, drift=drift,
                deposit=deposit, order_acc=order_acc,
                order_distr=order_distr, e_ext=e_ext, boris=boris,
                interpret=interpret),
        out_shape=tuple(out_shape),
        grid=(NT * NC,),
        in_specs=[pl.BlockSpec()] * len(args),
        out_specs=tuple(pl.BlockSpec() for _ in out_shape),
        input_output_aliases=aliases,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="pic_particles",
    )(*args))
    tiles = res.pop(0).reshape(NT, P, P, P) if deposit else None
    new_lpos = res.pop(0) if drift else lpos
    new_vel = vel
    vdot = jnp.zeros((S,), f32)
    if kick:
        new_vel = res.pop(0)
        vdot = jnp.sum(res.pop(0), axis=(1, 2))
    n_out = (jnp.sum(res.pop(0), axis=(1, 2)) if drift
             else jnp.zeros((S,), f32))
    return tiles, new_lpos, new_vel, vdot, n_out
