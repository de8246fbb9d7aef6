"""Particle movers and accelerators (leapfrog / Boris), plus deposition
bindings to the method registry.

JAX-native equivalents of the reference's pusher module
(``src/pusher.c``): ``puMove`` (pos += vel, src/pusher.c:86-119),
``puAcc3D1[KE]``/``puAccND1[KE]`` (CIC gather + kick,
src/pusher.c:147-308), ``puAccND0[KE]`` (NGP, src/pusher.c:314-391) and
``puBoris3D1[KE]`` (src/pusher.c:394-505).  Everything is vectorized over
the whole (nSpecies, cap) population and differentiable/jittable.

Simulation units have dt = dx = 1 (see units.py), so the kick is
``v += (q/m) E`` and the drift is ``x += v`` with no step factors, exactly
like the C.

The KE variants accumulate the *time-centered* kinetic energy
``0.5 m sum(v_old . v_new)`` of the leapfrog scheme, matching
puAcc3D1KE (src/pusher.c:197-210) so energy histories are comparable.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import PincConfig
from ..population import Particles, SpeciesParams
from ..registry import ACCELERATORS, DISTRIBUTORS, MIGRATORS
from . import cic


# ---------------------------------------------------------------------------
# Mover
# ---------------------------------------------------------------------------

def move(p: Particles, L: Sequence[int], periodic: bool = True) -> Particles:
    """Leapfrog drift x += v with periodic wrap, in split (cell, frac)
    arithmetic (puMove + puPeriodic, src/pusher.c:86-141).

    The carry (floor of the updated fraction) moves between cells exactly;
    velocities may exceed one cell/step.
    """
    frac = p.frac + p.vel
    carry = jnp.floor(frac)
    frac = frac - carry
    cell = p.cell + carry.astype(p.cell.dtype)
    if periodic:
        Larr = jnp.asarray(L, dtype=cell.dtype)
        cell = jnp.mod(cell, Larr)
    return Particles(cell=cell, frac=frac, vel=p.vel, alive=p.alive)


def reflect(p: Particles, L: Sequence[int],
            bounded: Sequence[bool] | None = None) -> Particles:
    """Elastic specular reflection at non-periodic walls: the physical
    domain is [0, L-1] (node extent); positions fold back and the normal
    velocity flips.  (The reference declares pReflect but leaves it
    unimplemented, src/population.c:468-495 — bounded runs there rely on
    objects absorbing everything; reflection is the sane default for
    plain Dirichlet/Neumann walls.)

    bounded: per-dim mask (default: all).  Mixed decks reflect only at
    their non-periodic walls; periodic dims wrap instead."""
    hi = jnp.asarray([l - 1 for l in L], dtype=p.frac.dtype)
    pos = p.cell.astype(p.frac.dtype) + p.frac
    # fold into [0, 2*hi) then reflect the upper half — handles multiple
    # bounces in one step
    period = 2.0 * hi
    pos_m = jnp.mod(pos, period)
    over = pos_m > hi
    pos_r = jnp.where(over, period - pos_m, pos_m)
    # velocity flips when the total reflection count is odd
    n_folds = jnp.floor(pos / hi).astype(jnp.int32)
    flip = (n_folds % 2) != 0
    vel = jnp.where(flip, -p.vel, p.vel)
    if bounded is not None and not all(bounded):
        bmask = jnp.asarray(list(bounded))
        Lf = jnp.asarray(L, dtype=p.frac.dtype)
        pos_r = jnp.where(bmask, pos_r, jnp.mod(pos, Lf))
        vel = jnp.where(bmask, vel, p.vel)
    cell = jnp.floor(pos_r).astype(p.cell.dtype)
    frac = pos_r - cell.astype(p.frac.dtype)
    if bounded is None or all(bounded):
        cell = jnp.clip(cell, 0,
                        jnp.asarray([l - 2 for l in L], dtype=p.cell.dtype))
        frac = jnp.where(cell.astype(p.frac.dtype) + frac > hi, 1.0, frac)
    else:
        bmask_i = jnp.asarray(list(bounded))
        cmax = jnp.where(jnp.asarray(list(bounded)),
                         jnp.asarray([l - 2 for l in L], dtype=p.cell.dtype),
                         jnp.asarray([l - 1 for l in L], dtype=p.cell.dtype))
        cell = jnp.clip(cell, 0, cmax)
        at_wall = bmask_i & (cell.astype(p.frac.dtype) + frac > hi)
        frac = jnp.where(at_wall, 1.0, frac)
    return Particles(cell=cell, frac=frac, vel=vel, alive=p.alive)


# ---------------------------------------------------------------------------
# Accelerators
# ---------------------------------------------------------------------------

def _pad_chunks(arr: jax.Array, n: int, chunk: int) -> jax.Array:
    """(n, ...) -> (nc, chunk, ...) with zero padding of the tail."""
    nc = -(-n // chunk)
    pad = nc * chunk - n
    if pad:
        arr = jnp.pad(arr, ((0, pad),) + ((0, 0),) * (arr.ndim - 1))
    return arr.reshape((nc, chunk) + arr.shape[1:])


def _gathered_field(E: jax.Array, p: Particles, order: int,
                    periodic: bool, chunk: int = 0) -> jax.Array:
    gather = cic.gather_cic if order == 1 else cic.gather_ngp
    S, cap, D = p.cell.shape
    n = S * cap
    if chunk and n > chunk:
        # chunked sweep: the 2^D corner-gather intermediates peak at
        # ~chunk slots instead of the whole population — reference-
        # semantics decks past the flat single-shot memory peak still run
        # (the C reference streams one particle at a time and has no
        # such peak, langmuirCold.ini:38 runs 64 ppc at any size)
        cell = _pad_chunks(p.cell.reshape(n, D), n, chunk)
        frac = _pad_chunks(p.frac.reshape(n, D), n, chunk)
        out = jax.lax.map(
            lambda xs: gather(E, xs[0], xs[1], periodic=periodic),
            (cell, frac))
        out = out.reshape((-1,) + out.shape[2:])[:n]
        return out.reshape((S, cap) + out.shape[1:])
    return gather(E, p.cell, p.frac, periodic=periodic)


def _kick(p: Particles, params: SpeciesParams, Ep: jax.Array,
          compute_ke: bool) -> Tuple[Particles, jax.Array]:
    """v += (q/m) Ep; optionally the time-centered KE per species."""
    qm = (params.charge / params.mass)[:, None, None]     # (S,1,1)
    dv = qm * Ep
    if compute_ke:
        v_dot = jnp.sum(p.vel * (p.vel + dv), axis=-1)     # (S, cap)
        v_dot = jnp.where(p.alive, v_dot, 0.0)
        ke = 0.5 * params.mass * jnp.sum(v_dot, axis=1)    # (S,)
    else:
        ke = jnp.zeros((p.n_species,), dtype=p.vel.dtype)
    vel = p.vel + jnp.where(p.alive[..., None], dv, 0.0)
    return Particles(cell=p.cell, frac=p.frac, vel=vel, alive=p.alive), ke


def acc_leapfrog(p: Particles, params: SpeciesParams, E: jax.Array,
                 order: int = 1, compute_ke: bool = True,
                 periodic: bool = True,
                 E_ext: Optional[jax.Array] = None,
                 e_scale: float = 1.0,
                 chunk: int = 0) -> Tuple[Particles, jax.Array]:
    """CIC/NGP gather + electrostatic kick (puAccND1KE / puAccND0KE).

    e_scale: kick-strength factor for the initialization half kick
    (src/main.c:184-186 scales the whole E grid by 0.5; the external
    field must scale with it, so it is applied here rather than folded
    into the caller's E).  chunk: see _gathered_field."""
    Ep = _gathered_field(E, p, order, periodic, chunk=chunk)
    if E_ext is not None:
        Ep = Ep + e_scale * E_ext
    return _kick(p, params, Ep, compute_ke)


def acc_boris(p: Particles, params: SpeciesParams, E: jax.Array,
              B_ext: jax.Array, order: int = 1, compute_ke: bool = True,
              periodic: bool = True,
              E_ext: Optional[jax.Array] = None,
              e_scale: float = 1.0,
              chunk: int = 0) -> Tuple[Particles, jax.Array]:
    """Boris rotation with a uniform external B (puBoris3D1[KE],
    src/pusher.c:394-505): half electric kick, magnetic rotation through
    the per-species precomputed T = (q/m) B/2 and S = 2T/(1+T^2), half
    electric kick."""
    Ep = _gathered_field(E, p, order, periodic, chunk=chunk)
    if E_ext is not None:
        Ep = Ep + e_scale * E_ext
    qm = (params.charge / params.mass)[:, None, None]
    half = 0.5 * qm * Ep

    v_minus = p.vel + half
    T = qm * 0.5 * B_ext                                   # (S,1,3)
    t2 = jnp.sum(T * T, axis=-1, keepdims=True)
    S = 2.0 * T / (1.0 + t2)
    v_prime = v_minus + jnp.cross(v_minus, T)
    v_plus = v_minus + jnp.cross(v_prime, S)
    vel_new = v_plus + half

    if compute_ke:
        # the reference's convention (src/pusher.c:465-471): KE between
        # the rotation and the second half kick, 0.5 m |v_plus|^2
        # (== |v_minus|^2 — the rotation is norm-preserving)
        v2 = jnp.sum(v_plus * v_plus, axis=-1)
        v2 = jnp.where(p.alive, v2, 0.0)
        ke = 0.5 * params.mass * jnp.sum(v2, axis=1)
    else:
        ke = jnp.zeros((p.n_species,), dtype=p.vel.dtype)

    vel = jnp.where(p.alive[..., None], vel_new, p.vel)
    return Particles(cell=p.cell, frac=p.frac, vel=vel, alive=p.alive), ke


# ---------------------------------------------------------------------------
# Deposition driver
# ---------------------------------------------------------------------------

def deposit(p: Particles, params: SpeciesParams, shape: Sequence[int],
            order: int = 1, periodic: bool = True,
            dtype=jnp.float32, chunk: int = 0) -> jax.Array:
    """Charge density from all species (puDistr3D1/ND1/ND0 semantics):
    every alive superparticle deposits its charge onto 2^D (CIC) or 1 (NGP)
    nodes.  Species are flattened into one scatter for a single fused pass.

    chunk > 0: scan the scatter over fixed-size particle chunks,
    accumulating into one rho grid — peak intermediate memory becomes
    O(chunk * 2^D) instead of O(S*cap * 2^D), so reference-semantics
    decks beyond the flat single-shot memory peak still run (the padded
    tail deposits value 0, i.e. exactly nothing).
    """
    S, cap, D = p.cell.shape
    q = jnp.broadcast_to(params.charge[:, None], (S, cap))
    value = jnp.where(p.alive, q, 0.0).reshape(S * cap)
    cell = p.cell.reshape(S * cap, D)
    frac = p.frac.reshape(S * cap, D)
    scatter = cic.scatter_cic if order == 1 else cic.scatter_ngp
    n = S * cap
    if chunk and n > chunk:
        xs = (_pad_chunks(cell, n, chunk), _pad_chunks(frac, n, chunk),
              _pad_chunks(value, n, chunk))

        def body(rho, x):
            c_, f_, v_ = x
            return rho + scatter(shape, c_, f_, v_, periodic, dtype), None

        rho0 = jnp.zeros(tuple(shape), dtype=dtype)
        rho, _ = jax.lax.scan(body, rho0, xs)
        return rho
    return scatter(shape, cell, frac, value, periodic, dtype)


# ---------------------------------------------------------------------------
# Registry bindings: the reference deck names (methods:acc / distr / migrate)
# map here, so existing ini files select the same algorithms
# (select() calls in src/main.c:55-79).
# ---------------------------------------------------------------------------

def _sanity(name: str, dims: int, order: int):
    """puSanity (src/pusher.c:1047-1087): tie method choice to nDims."""
    def check(cfg: PincConfig):
        nd = cfg.get_int("grid:ndims")
        if dims != 0 and nd != dims:
            raise ValueError(f"{name} only works with grid:nDims={dims}")
    return check


def _sweep_chunk(cfg: PincConfig) -> int:
    """population:sweepChunk — flat-layout particle-sweep chunk size in
    slots (0 = single shot).  Default: auto-chunk at 8M slots once the
    population exceeds 16M slots, keeping the corner-expansion working
    set bounded while leaving small decks on the fused single pass."""
    if "population:sweepchunk" in cfg:
        return cfg.get_int("population:sweepchunk")
    from ..population import capacity_of
    slots = capacity_of(cfg) * cfg.get_int("population:nspecies")
    return 8_388_608 if slots > 16_777_216 else 0


def _make_acc(order: int, compute_ke: bool, boris: bool):
    def factory(cfg: PincConfig):
        nd = cfg.get_int("grid:ndims")
        chunk = _sweep_chunk(cfg)
        B = jnp.asarray(cfg.get_double_arr("fields:bext", nd)
                        if "fields:bext" in cfg else [0.0] * nd)
        E_ext_arr = (jnp.asarray(cfg.get_double_arr("fields:eext", nd))
                     if "fields:eext" in cfg else None)
        if E_ext_arr is not None and not jnp.any(E_ext_arr != 0.0):
            E_ext_arr = None
        if boris:
            B3 = B.reshape(1, 1, -1)
            def acc(p, params, E, periodic=True, e_scale=1.0):
                return acc_boris(p, params, E, B3, order=order,
                                 compute_ke=compute_ke, periodic=periodic,
                                 E_ext=E_ext_arr, e_scale=e_scale,
                                 chunk=chunk)
        else:
            def acc(p, params, E, periodic=True, e_scale=1.0):
                return acc_leapfrog(p, params, E, order=order,
                                    compute_ke=compute_ke, periodic=periodic,
                                    E_ext=E_ext_arr, e_scale=e_scale,
                                    chunk=chunk)
        acc.order = order
        acc.boris = boris
        acc.E_ext = E_ext_arr
        return acc
    return factory


for _name, _dims, _order, _ke, _boris in [
    ("puAcc3D1", 3, 1, False, False), ("puAcc3D1KE", 3, 1, True, False),
    ("puAccND1", 0, 1, False, False), ("puAccND1KE", 0, 1, True, False),
    ("puAccND0", 0, 0, False, False), ("puAccND0KE", 0, 0, True, False),
    ("puBoris3D1", 3, 1, False, True), ("puBoris3D1KE", 3, 1, True, True),
]:
    ACCELERATORS.register(_name, _sanity(_name, _dims, _order))(
        _make_acc(_order, _ke, _boris))


def _make_distr(order: int):
    def factory(cfg: PincConfig):
        chunk = _sweep_chunk(cfg)
        def distr(p, params, shape, periodic=True, dtype=jnp.float32):
            return deposit(p, params, shape, order=order,
                           periodic=periodic, dtype=dtype, chunk=chunk)
        distr.order = order
        return distr
    return factory


DISTRIBUTORS.register("puDistr3D1", _sanity("puDistr3D1", 3, 1))(_make_distr(1))
DISTRIBUTORS.register("puDistrND1")(_make_distr(1))
DISTRIBUTORS.register("puDistrND0")(_make_distr(0))
DISTRIBUTORS.register("puDistr3D1split", _sanity("puDistr3D1split", 3, 1))(_make_distr(1))


def _make_migrate():
    """On a single block, migration is subsumed by the periodic wrap inside
    move(); across shards it is the halo/permute exchange implemented in
    parallel.migrate.  The registry keeps the reference names valid."""
    def factory(cfg: PincConfig):
        def migrate(p, mesh_ctx=None):
            return p
        return migrate
    return factory


MIGRATORS.register("puExtractEmigrants3D", _sanity("puExtractEmigrants3D", 3, 1))(_make_migrate())
MIGRATORS.register("puExtractEmigrantsND")(_make_migrate())
