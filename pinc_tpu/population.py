"""Particle population: storage, initial conditions, bookkeeping.

JAX-native redesign of the reference's ``Population`` (``src/core.h:72-86``,
``src/population.c``).  The C code keeps one flat SoA array with per-species
``iStart/iStop`` ranges and deletes particles by back-filling; both are
shape-dynamic and hostile to XLA.  Here each species owns a *fixed-capacity*
slab of a stacked array:

    cell : int32  (nSpecies, cap, nDims)   integer cell index
    frac : float  (nSpecies, cap, nDims)   offset within the cell, in [0,1)
    vel  : float  (nSpecies, cap, nDims)   velocity, cells/step
    alive: bool   (nSpecies, cap)          slot occupancy mask

Positions are stored in fixed-point split form (cell + frac) rather than one
float: CIC weights are then exact at any domain size and float32 never loses
resolution at large coordinates — the JAX answer to the C code's double
positions.  Dead slots simply carry zero weight everywhere (deposition,
energy), replacing ``pNew``/``pCut`` back-fill (src/population.c:430-466)
with mask discipline.

Initial conditions reproduce the reference's generators (lattice, uniform,
sinusoidal perturbation, Maxwellian — src/population.c:110-428) on the host
in float64, then split into (cell, frac).  RNG is numpy's MT19937 seeded per
deck; the reference's GSL stream is not bit-reproducible from Python, which
only affects statistically-equivalent random ICs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import PincConfig, global_size
from .grid import GridSpec


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SpeciesParams:
    """Per-superparticle charge/mass in simulation units, post-normalization
    (what pAlloc reads after uNormalize, src/population.c:42-92)."""
    charge: jax.Array  # (S,)
    mass: jax.Array    # (S,)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Particles:
    cell: jax.Array   # (S, cap, D) int32
    frac: jax.Array   # (S, cap, D) float
    vel: jax.Array    # (S, cap, D) float
    alive: jax.Array  # (S, cap) bool

    @property
    def n_species(self) -> int:
        return self.cell.shape[0]

    @property
    def capacity(self) -> int:
        return self.cell.shape[1]

    @property
    def n_dims(self) -> int:
        return self.cell.shape[2]

    def pos(self) -> jax.Array:
        """Float positions (for IO/diagnostics only)."""
        return self.cell.astype(self.frac.dtype) + self.frac

    def counts(self) -> jax.Array:
        return jnp.sum(self.alive, axis=1)


# ---------------------------------------------------------------------------
# Host-side initial conditions
# ---------------------------------------------------------------------------

def _split_pos(pos: np.ndarray, L: np.ndarray, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Wrap periodically and split float64 positions into (cell, frac)."""
    pos = np.mod(pos, L)
    cell = np.floor(pos).astype(np.int64)
    frac = pos - cell
    # guard against frac == 1.0 from rounding
    bump = frac >= 1.0
    cell = cell + bump
    frac = np.where(bump, 0.0, frac)
    cell = np.mod(cell, L.astype(np.int64))
    return cell.astype(np.int32), frac.astype(dtype)


def _lattice_positions(n: int, L: np.ndarray) -> np.ndarray:
    """Evenly spaced lattice: particle i at mixed-radix unfolding of i*l
    where l = (V/N)^(1/D) (pPosLattice, src/population.c:172-240)."""
    nd = len(L)
    V = float(np.prod(L))
    l = (V / n) ** (1.0 / nd)
    linear = l * np.arange(n, dtype=np.float64)
    pos = np.empty((n, nd), dtype=np.float64)
    for d in range(nd):
        pos[:, d] = np.mod(linear, L[d])
        linear = linear / L[d]
    return pos


def _uniform_positions(n: int, L: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Uniform over the global domain (pPosUniform, src/population.c:110-170)."""
    return rng.uniform(0.0, 1.0, size=(n, len(L))) * L


def _perturb(pos: np.ndarray, amplitude: np.ndarray, mode: np.ndarray,
             L: np.ndarray) -> np.ndarray:
    """x_d += A_d * cos(2 pi m_d x_d / L_d)  (pPosPerturb,
    src/population.c:242-276)."""
    theta = 2.0 * np.pi * mode * pos / L
    return pos + amplitude * np.cos(theta)


def initialize(cfg: PincConfig, spec: GridSpec, seed: int = 1) -> Tuple[Particles, SpeciesParams]:
    """Build the initial population per the deck.

    Follows the reference's regular() IC sequence (src/main.c:141-160):
    positions from ``population:icPositions`` (default ``lattice``, matching
    main.c's pPosLattice), velocities Maxwellian if thermalVelocity/drift is
    nonzero else zero, then the sinusoidal position perturbation whenever
    ``perturbAmplitude`` is nonzero.  (Current reference main.c has the
    perturbation call commented out; decks carry the keys and the Langmuir
    verification runs require it, so it is honored here.)
    """
    nd = spec.n_dims
    ns = cfg.get_int("population:nspecies")
    n_particles = [int(v) for v in cfg.get_double_arr("population:nparticles", ns)]
    n_alloc_key = "population:nalloc" if "population:nalloc" in cfg else "population:nparticles"
    n_alloc = [int(v) for v in cfg.get_double_arr(n_alloc_key, ns)]
    cap = max(max(n_alloc), max(n_particles))

    charge = np.asarray(cfg.get_double_arr("population:charge", ns))
    mass = np.asarray(cfg.get_double_arr("population:mass", ns))

    vth = np.asarray(cfg.get_double_arr("population:thermalvelocity", ns)
                     if "population:thermalvelocity" in cfg else [0.0] * ns)
    drift = np.asarray(cfg.get_double_arr("population:drift", ns)
                       if "population:drift" in cfg else [0.0] * ns)

    pert_amp = np.zeros((ns, nd))
    pert_mode = np.zeros((ns, nd))
    if "population:perturbamplitude" in cfg:
        pert_amp = np.asarray(
            cfg.get_double_arr("population:perturbamplitude", ns * nd)).reshape(ns, nd)
    if "population:perturbmode" in cfg:
        pert_mode = np.asarray(
            cfg.get_double_arr("population:perturbmode", ns * nd)).reshape(ns, nd)

    L = np.asarray(spec.global_size, dtype=np.float64)
    rng = np.random.default_rng(seed)
    ic_pos = cfg.get_str("population:icpositions", "lattice").lower()
    dtype = np.dtype(spec.dtype)

    cells = np.zeros((ns, cap, nd), dtype=np.int32)
    fracs = np.zeros((ns, cap, nd), dtype=dtype)
    vels = np.zeros((ns, cap, nd), dtype=dtype)
    alive = np.zeros((ns, cap), dtype=bool)

    for s in range(ns):
        n = n_particles[s]
        if n > cap:
            raise ValueError(f"species {s}: nParticles {n} exceeds capacity {cap}")
        if ic_pos == "lattice":
            pos = _lattice_positions(n, L)
        elif ic_pos == "uniform":
            pos = _uniform_positions(n, L, rng)
        else:
            raise ValueError(f"unknown icPositions '{ic_pos}'")
        if np.any(pert_amp[s] != 0.0):
            pos = _perturb(pos, pert_amp[s], pert_mode[s], L)
        cell, frac = _split_pos(pos, L, dtype)
        cells[s, :n] = cell
        fracs[s, :n] = frac
        if vth[s] != 0.0:
            vels[s, :n] = rng.normal(drift[s], vth[s], size=(n, nd))
        elif drift[s] != 0.0:
            vels[s, :n] = drift[s]
        alive[s, :n] = True

    particles = Particles(cell=jnp.asarray(cells), frac=jnp.asarray(fracs),
                          vel=jnp.asarray(vels), alive=jnp.asarray(alive))
    params = SpeciesParams(charge=jnp.asarray(charge, dtype=spec.dtype),
                           mass=jnp.asarray(mass, dtype=spec.dtype))
    return particles, params


# ---------------------------------------------------------------------------
# Device-side initial conditions — for productions-scale populations the
# host path above (numpy + host->device transfer of multi-GB arrays) is the
# setup bottleneck; this builds the same statistical ICs entirely on device.
# ---------------------------------------------------------------------------

def initialize_device(cfg: PincConfig, spec: GridSpec,
                      seed: int = 1) -> Tuple[Particles, SpeciesParams]:
    """On-device initialization: exactly nParticles/V particles per cell on
    a per-cell sub-lattice (an equivalent uniform lattice to pPosLattice,
    exact in integer arithmetic at any population size), Maxwellian
    velocities via jax.random, optional sinusoidal perturbation.

    Selected automatically by ``initialize_auto`` for large populations or
    explicitly with ``population:icDevice = true``.
    """
    nd = spec.n_dims
    ns = cfg.get_int("population:nspecies")
    n_particles = [int(v) for v in cfg.get_double_arr("population:nparticles", ns)]
    n_alloc_key = "population:nalloc" if "population:nalloc" in cfg else "population:nparticles"
    n_alloc = [int(v) for v in cfg.get_double_arr(n_alloc_key, ns)]
    cap = max(max(n_alloc), max(n_particles))

    charge = cfg.get_double_arr("population:charge", ns)
    mass = cfg.get_double_arr("population:mass", ns)
    vth = (cfg.get_double_arr("population:thermalvelocity", ns)
           if "population:thermalvelocity" in cfg else [0.0] * ns)
    drift = (cfg.get_double_arr("population:drift", ns)
             if "population:drift" in cfg else [0.0] * ns)
    pert_amp = np.zeros((ns, nd))
    pert_mode = np.zeros((ns, nd))
    if "population:perturbamplitude" in cfg:
        pert_amp = np.asarray(cfg.get_double_arr(
            "population:perturbamplitude", ns * nd)).reshape(ns, nd)
    if "population:perturbmode" in cfg:
        pert_mode = np.asarray(cfg.get_double_arr(
            "population:perturbmode", ns * nd)).reshape(ns, nd)

    L = spec.global_size
    V = spec.global_volume
    dtype = spec.dtype

    cells, fracs, vels, alives = [], [], [], []
    for s in range(ns):
        cell, frac, vel, alive = device_species(cfg, spec, seed, s)
        cells.append(cell)
        fracs.append(frac)
        vels.append(vel)
        alives.append(alive)

    particles = Particles(cell=jnp.stack(cells), frac=jnp.stack(fracs),
                          vel=jnp.stack(vels), alive=jnp.stack(alives))
    params = SpeciesParams(charge=jnp.asarray(charge, dtype=dtype),
                           mass=jnp.asarray(mass, dtype=dtype))
    return particles, params


def device_species(cfg: PincConfig, spec: GridSpec, seed: int, s: int,
                   parts: str = "all"):
    """On-device ICs for ONE species: (cell, frac, vel, alive), each
    (cap, D)/(cap,).  Same key split-chain as the stacked initializer, so
    a per-species consumer (e.g. the tiled bucketer at 100M+ populations,
    which frees each species before generating the next) reproduces
    initialize_device exactly.  parts='pos' skips the velocity array,
    'vel' skips positions (two-phase bucketing keeps only one of the two
    multi-GB payloads live at a time); skipped outputs are None."""
    nd = spec.n_dims
    ns = cfg.get_int("population:nspecies")
    n_particles = [int(v) for v in
                   cfg.get_double_arr("population:nparticles", ns)]
    n_alloc_key = ("population:nalloc" if "population:nalloc" in cfg
                   else "population:nparticles")
    n_alloc = [int(v) for v in cfg.get_double_arr(n_alloc_key, ns)]
    cap = max(max(n_alloc), max(n_particles))
    vth = (cfg.get_double_arr("population:thermalvelocity", ns)
           if "population:thermalvelocity" in cfg else [0.0] * ns)
    drift = (cfg.get_double_arr("population:drift", ns)
             if "population:drift" in cfg else [0.0] * ns)
    pert_amp = np.zeros((ns, nd))
    pert_mode = np.zeros((ns, nd))
    if "population:perturbamplitude" in cfg:
        pert_amp = np.asarray(cfg.get_double_arr(
            "population:perturbamplitude", ns * nd)).reshape(ns, nd)
    if "population:perturbmode" in cfg:
        pert_mode = np.asarray(cfg.get_double_arr(
            "population:perturbmode", ns * nd)).reshape(ns, nd)
    L = spec.global_size
    V = spec.global_volume
    dtype = spec.dtype
    key = jax.random.PRNGKey(seed)
    sub = None
    for _ in range(s + 1):
        key, sub = jax.random.split(key)

    n = n_particles[s]
    if n % V != 0:
        raise ValueError(
            f"device init needs nParticles per species divisible by the "
            f"cell count (got {n} over {V} cells); use 'pc' units")
    ppc = n // V
    alive = jnp.arange(cap) < n
    if parts == "vel":
        key2 = sub
        if vth[s] != 0.0:
            vel = (drift[s] + vth[s]
                   * jax.random.normal(key2, (cap, nd), dtype=dtype))
        else:
            vel = jnp.full((cap, nd), float(drift[s]), dtype=dtype)
        vel = jnp.where(alive[:, None], vel, 0.0)
        return None, None, vel, alive
    idx = jnp.arange(cap, dtype=jnp.int32)
    cell_lin = idx // ppc                 # exact integer cell index
    slot = idx % ppc
    # unravel cell_lin -> (cap, D), last dim fastest (C order)
    cell = []
    rem = cell_lin
    for d in range(nd - 1, -1, -1):
        cell.append(rem % L[d])
        rem = rem // L[d]
    cell = jnp.stack(cell[::-1], axis=-1)
    # sub-lattice offsets within the cell: golden-ratio sequence per
    # dim — low-discrepancy, deterministic, species-shifted
    slotf = slot.astype(dtype) + 0.5 + 0.1 * s
    golden = [0.6180339887, 0.7548776662, 0.8191725134][:nd]
    frac = jnp.stack([jnp.mod(slotf * g, 1.0).astype(dtype)
                      for g in golden], axis=-1)
    if np.any(pert_amp[s] != 0.0):
        pos = cell.astype(dtype) + frac
        theta = (2.0 * np.pi) * jnp.asarray(pert_mode[s], dtype) * pos \
            / jnp.asarray(L, dtype)
        pos = pos + jnp.asarray(pert_amp[s], dtype) * jnp.cos(theta)
        pos = jnp.mod(pos, jnp.asarray(L, dtype))
        cellf = jnp.floor(pos)
        frac = (pos - cellf).astype(dtype)
        cell = cellf.astype(jnp.int32)
    if parts == "pos":
        return cell.astype(jnp.int32), frac, None, alive
    if vth[s] != 0.0:
        vel = (drift[s] + vth[s]
               * jax.random.normal(sub, (cap, nd), dtype=dtype))
    else:
        vel = jnp.full((cap, nd), float(drift[s]), dtype=dtype)
    vel = jnp.where(alive[:, None], vel, 0.0)
    return cell.astype(jnp.int32), frac, vel, alive


DEVICE_INIT_THRESHOLD = 4_000_000


def species_params_of(cfg: PincConfig, spec: GridSpec) -> SpeciesParams:
    """Just the per-species charge/mass table (no particle arrays)."""
    ns = cfg.get_int("population:nspecies")
    charge = cfg.get_double_arr("population:charge", ns)
    mass = cfg.get_double_arr("population:mass", ns)
    return SpeciesParams(charge=jnp.asarray(charge, dtype=spec.dtype),
                         mass=jnp.asarray(mass, dtype=spec.dtype))


def wants_device_init(cfg: PincConfig) -> bool:
    """True when initialize_auto would take the on-device path."""
    ns = cfg.get_int("population:nspecies")
    n_alloc_key = ("population:nalloc" if "population:nalloc" in cfg
                   else "population:nparticles")
    cap = max(int(v) for v in cfg.get_double_arr(n_alloc_key, ns))
    if cfg.get_bool("population:icdevice", False):
        return True
    return ("population:icdevice" not in cfg
            and cap > DEVICE_INIT_THRESHOLD
            and cfg.get_str("population:icpositions", "lattice") == "lattice")


def capacity_of(cfg: PincConfig) -> int:
    """Largest per-species slot capacity the deck asks for.  Suffix-aware:
    callable both before normalization (raw '128 pc' strings — e.g.
    make_simulation's layout auto-selection) and after (parse_indirect_input
    has already multiplied the values in place)."""
    from .config import global_volume
    ns = cfg.get_int("population:nspecies")
    n_alloc_key = ("population:nalloc" if "population:nalloc" in cfg
                   else "population:nparticles")

    def expanded(key):
        vals = cfg.get_double_arr(key, ns)
        if "pc" in cfg.get_str(key):
            V = global_volume(cfg)
            return [v * V for v in vals]
        return vals

    n_alloc = [int(v) for v in expanded(n_alloc_key)]
    n_part = [int(v) for v in expanded("population:nparticles")]
    return max(max(n_alloc), max(n_part))


def initialize_auto(cfg: PincConfig, spec: GridSpec,
                    seed: int = 1) -> Tuple[Particles, SpeciesParams]:
    """Host init (exact reference lattice semantics) for small populations;
    device init beyond DEVICE_INIT_THRESHOLD particles or when
    ``population:icDevice`` is set."""
    ns = cfg.get_int("population:nspecies")
    n_alloc_key = "population:nalloc" if "population:nalloc" in cfg else "population:nparticles"
    cap = max(int(v) for v in cfg.get_double_arr(n_alloc_key, ns))
    forced = cfg.get_bool("population:icdevice", False)
    if forced or ("population:icdevice" not in cfg
                  and cap > DEVICE_INIT_THRESHOLD
                  and cfg.get_str("population:icpositions", "lattice") == "lattice"):
        try:
            return initialize_device(cfg, spec, seed)
        except ValueError:
            pass
    return initialize(cfg, spec, seed)


# ---------------------------------------------------------------------------
# Energy bookkeeping helpers (pSumKinEnergy / pSumPotEnergy,
# src/population.c:700-720 — totals are just sums over species here).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Object-collision handlers.  The reference declares four responses but
# every one emits a "not yet implemented" warning (pFindCollisionType/
# pBackscatter/pSecondaryElectron/pReflect/pAdhere,
# src/population.c:468-495).  Here all four are REAL: reflect/backscatter
# in objects.collide_segments, adhere + secondary-electron emission in
# objects.collect_charge/emit_secondaries, selected per species via
# objects:collisionType.  ``spawn`` below is the working pNew
# (src/population.c:430-443): the reference appends at iStop and silently
# drops when full; here free slots are rank-matched under the alive mask
# and the overflow count is returned.
# ---------------------------------------------------------------------------

def spawn(p: Particles, s: int, pos: jax.Array, vel: jax.Array,
          mask: jax.Array) -> Tuple[Particles, jax.Array, jax.Array]:
    """Insert new particles into species ``s``'s free (dead) slots.

    pos/vel: (N, D) candidate states; mask: (N,) which candidates are
    real.  Candidate k (k-th True in mask) lands in the k-th free slot.
    Returns (particles', n_spawned, n_overflow); overflowing candidates
    (more than free slots) are dropped and counted."""
    cap = p.capacity
    alive_s = p.alive[s]
    free = ~alive_s
    # slot_for_rank[r] = index of the r-th free slot (cap = dump bucket)
    frank = jnp.cumsum(free.astype(jnp.int32)) - 1
    slot_for_rank = jnp.full((cap + 1,), cap, jnp.int32).at[
        jnp.where(free, frank, cap)].set(jnp.arange(cap, dtype=jnp.int32))
    n_free = jnp.sum(free.astype(jnp.int32))
    erank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    ok = mask & (erank < n_free)
    tgt = jnp.where(ok, slot_for_rank[jnp.clip(erank, 0, cap)], cap)
    cell_new = jnp.floor(pos).astype(p.cell.dtype)
    frac_new = (pos - cell_new).astype(p.frac.dtype)
    pad = lambda a: jnp.concatenate([a, a[-1:]], axis=0)  # dump row
    cell_s = pad(p.cell[s]).at[tgt].set(
        jnp.where(ok[:, None], cell_new, pad(p.cell[s])[tgt]))[:cap]
    frac_s = pad(p.frac[s]).at[tgt].set(
        jnp.where(ok[:, None], frac_new.astype(p.frac.dtype),
                  pad(p.frac[s])[tgt]))[:cap]
    vel_s = pad(p.vel[s]).at[tgt].set(
        jnp.where(ok[:, None], vel.astype(p.vel.dtype),
                  pad(p.vel[s])[tgt]))[:cap]
    alive_s2 = jnp.concatenate(
        [alive_s, jnp.zeros((1,), alive_s.dtype)]).at[tgt].set(
        jnp.where(ok, True, jnp.concatenate(
            [alive_s, jnp.zeros((1,), alive_s.dtype)])[tgt]))[:cap]
    n_spawned = jnp.sum(ok.astype(jnp.int32))
    n_over = jnp.sum((mask & ~ok).astype(jnp.int32))
    return (Particles(cell=p.cell.at[s].set(cell_s),
                      frac=p.frac.at[s].set(frac_s),
                      vel=p.vel.at[s].set(vel_s),
                      alive=p.alive.at[s].set(alive_s2)),
            n_spawned, n_over)


def kinetic_energy(p: Particles, params: SpeciesParams) -> jax.Array:
    """Instantaneous KE per species: 0.5*m*sum(v^2) over alive particles.
    The production path instead uses the time-centered KE computed inside
    the accelerator (ops.pusher), matching puAcc*KE (src/pusher.c:197-210)."""
    v2 = jnp.sum(p.vel * p.vel, axis=-1)          # (S, cap)
    v2 = jnp.where(p.alive, v2, 0.0)
    return 0.5 * params.mass * jnp.sum(v2, axis=1)
