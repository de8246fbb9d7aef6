"""The sharded PIC step: domain decomposition over a device mesh.

This is the JAX-native equivalent of everything MPI in the reference
(SURVEY.md §2 'Parallelism strategies'): the deck's ``grid:nSubdomains``
Cartesian decomposition becomes a ``jax.sharding.Mesh``; grid halo
exchanges become ``lax.ppermute`` pairs (parallel.halo); particle
migration becomes fixed-capacity neighbor permutes (parallel.migrate);
``MPI_Allreduce`` energy sums become ``lax.psum``.

Step structure (one jitted function, mirrors src/main.c:197-274):

    shard_map:  move (unwrapped) -> migrate -> local CIC deposit into a
                (+1)-padded block -> fold_plus halo-add        [particle ops]
    global:     solve(rho) -> E = -grad(phi)        [XLA partitions the FFT
                / stencil collectives automatically from the shardings]
    shard_map:  pad_plus ghost fetch -> CIC gather -> kick -> psum(KE)

Particles live in per-device capacity slabs of the global (S, cap, D)
arrays, capacity axis sharded over all mesh axes jointly.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

try:
    from jax import shard_map  # jax >= 0.7 stable API
    def _shard_map(f, mesh, in_specs, out_specs):
        # check_vma=False: pallas_call outputs carry no varying-mesh-axes
        # metadata, and the tiled kernels run inside these regions
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _sm

    def _shard_map(f, mesh, in_specs, out_specs):
        return _sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=False)

from ..config import PincConfig
from ..grid import gradient, potential_energy
from ..ops import cic
from ..ops import pusher as pu
from ..population import Particles, SpeciesParams
from ..simulation import Diagnostics, Simulation, StepOutput
from ..utils.logging import STATUS, WARNING, msg
from .halo import fold_plus, pad_plus
from .mesh import MeshCtx, make_mesh, subdomain_offset
from .migrate import migrate


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ShardedSimulation(Simulation):
    """Simulation over a device mesh.  Same deck, same physics — the
    single-block Simulation is the nSubdomains=1 special case."""

    def __init__(self, cfg: PincConfig, seed: int = 1, devices=None):
        # Build the single-device setup first (methods, units, global ICs).
        super().__init__(cfg, seed=seed)
        nd = self.spec.n_dims
        self.ctx = make_mesh(self.spec.n_subdomains, self.spec.true_size,
                             devices=devices)
        ndev = self.ctx.n_devices
        cap_global = self.particles.capacity
        self.cap_local = _round_up(math.ceil(cap_global / ndev), 8)
        K_default = max(64, self.cap_local // 8)
        self.migration_cap = min(
            cfg.get_int("parallel:migrationcap", K_default), self.cap_local)
        from ..grid import BndType
        self._bounded = tuple(b is not BndType.PERIODIC
                              for b in self.bc.upper)
        self.particles = self._distribute(self.particles)
        from .pencil_fft import make_sharded_solver
        self._solve = make_sharded_solver(self.solver, self.ctx, cfg,
                                          self.spec.dtype)
        self._step_jit = jax.jit(self._sharded_step, donate_argnums=(0,))
        self._half_kick_jit = jax.jit(self._sharded_half_kick,
                                      donate_argnums=(0,))

    # ------------------------------------------------------------ placement
    def _distribute(self, p: Particles) -> Particles:
        """Host-side: partition the globally-initialized population into
        per-device slabs ordered by mesh linearization (the reference's
        subdomain filtering in pPosUniform/pPosLattice,
        src/population.c:139-160)."""
        ctx = self.ctx
        ndev = ctx.n_devices
        S, cap, D = p.cell.shape
        capL = self.cap_local
        cell = np.asarray(p.cell)
        frac = np.asarray(p.frac)
        vel = np.asarray(p.vel)
        alive = np.asarray(p.alive)

        t = np.asarray(ctx.true_size)
        nsub = np.asarray(ctx.n_subdomains)
        # device linear index per particle (mixed radix, last dim fastest
        # in mesh order: index = ((cx*n1)+cy)*n2+cz)
        coords = cell // t            # (S, cap, D)
        lin = np.zeros((S, cap), dtype=np.int64)
        for d in range(D):
            lin = lin * nsub[d] + coords[..., d]

        out_cell = np.zeros((S, ndev * capL, D), cell.dtype)
        out_frac = np.zeros((S, ndev * capL, D), frac.dtype)
        out_vel = np.zeros((S, ndev * capL, D), vel.dtype)
        out_alive = np.zeros((S, ndev * capL), bool)
        for s in range(S):
            for dev in range(ndev):
                sel = alive[s] & (lin[s] == dev)
                n = int(sel.sum())
                if n > capL:
                    raise ValueError(
                        f"species {s}: {n} particles for device {dev} exceed "
                        f"local capacity {capL}; raise population:nAlloc")
                base = dev * capL
                out_cell[s, base:base + n] = cell[s][sel]
                out_frac[s, base:base + n] = frac[s][sel]
                out_vel[s, base:base + n] = vel[s][sel]
                out_alive[s, base:base + n] = True

        sh3 = self.ctx.sharding(self.ctx.particle_spec(True))
        sh2 = self.ctx.sharding(self.ctx.particle_spec(False))
        return Particles(
            cell=jax.device_put(jnp.asarray(out_cell), sh3),
            frac=jax.device_put(jnp.asarray(out_frac), sh3),
            vel=jax.device_put(jnp.asarray(out_vel), sh3),
            alive=jax.device_put(jnp.asarray(out_alive), sh2))

    # ---------------------------------------------------------- local parts
    def _local_absorb(self, p: Particles):
        """Per-device object absorption (the particle half of
        oCollectObjectCharge, src/object.c:460-515): cut particles whose
        floor node is object interior; psum per-object absorbed charge.
        interior_id is a replicated constant; p.cell is global-frame."""
        S, capL, D = p.cell.shape
        node = tuple(p.cell[..., d] for d in range(D))
        oid = self.objects.interior_id[node]                # (S, capL)
        absorbed = p.alive & (oid > 0)
        q = jnp.broadcast_to(self.params.charge[:, None], (S, capL))
        flat_oid = jnp.where(absorbed, oid, 0).reshape(-1)
        flat_q = jnp.where(absorbed, q, 0.0).reshape(-1)
        counter = jax.ops.segment_sum(
            flat_q, flat_oid, num_segments=self.objects.n_objects + 1)
        for ax in self.ctx.axes:
            counter = lax.psum(counter, ax)
        p = Particles(cell=p.cell, frac=p.frac, vel=p.vel,
                      alive=p.alive & ~absorbed)
        return p, counter

    def _local_deposit(self, p: Particles):
        """Per-device: move (unwrapped), migrate, absorb, deposit with
        halo fold."""
        ctx = self.ctx
        offset = subdomain_offset(ctx)
        p = pu.move(p, ctx.global_size, periodic=False)     # unwrapped
        if not self.spec.periodic:
            # bounded walls reflect BEFORE migration (so no charge or
            # particle ever reaches the wrap planes of the periodic
            # halo/migration rings at those edges); periodic dims of a
            # mixed deck wrap instead
            p = pu.reflect(p, ctx.global_size, bounded=self._bounded)
        p, lost = migrate(p, ctx, offset, self.migration_cap)
        if self.objects is not None:
            p, counter = self._local_absorb(p)
        else:
            counter = jnp.zeros((1,), jnp.float32)
        S, capL, D = p.cell.shape
        lcell = (p.cell - offset).reshape(S * capL, D)
        frac = p.frac.reshape(S * capL, D)
        q = jnp.broadcast_to(self.params.charge[:, None], (S, capL))
        value = jnp.where(p.alive, q, 0.0).reshape(S * capL)
        padded = tuple(t + 1 for t in ctx.true_size)
        rho_pad = cic.scatter_cic(padded, lcell, frac, value,
                                  periodic=False, dtype=self.spec.dtype)
        rho = fold_plus(rho_pad, ctx.axes, ctx.n_subdomains,
                        bounded=self._bounded)
        return p, rho, lost, counter

    def _local_kick(self, p: Particles, E_local: jax.Array,
                    half: bool) -> Tuple[Particles, jax.Array]:
        ctx = self.ctx
        offset = subdomain_offset(ctx)
        E_pad = pad_plus(E_local, ctx.axes, ctx.n_subdomains,
                         bounded=self._bounded)
        if half:
            E_pad = 0.5 * E_pad
        lp = Particles(cell=p.cell - offset, frac=p.frac, vel=p.vel,
                       alive=p.alive)
        lp2, ke = self.acc(lp, self.params, E_pad, periodic=False)
        for ax in ctx.axes:
            ke = lax.psum(ke, ax)
        out = Particles(cell=p.cell, frac=p.frac, vel=lp2.vel, alive=p.alive)
        return out, ke

    # ------------------------------------------------------------ the step
    # _solve is bound in __init__ via parallel.pencil_fft.make_sharded_solver

    def _sharded_pipeline(self, particles: Particles, do_move: bool,
                          half: bool, rho_obj=None) -> StepOutput:
        ctx = self.ctx
        p3, p2 = ctx.particle_spec(True), ctx.particle_spec(False)
        pspec = Particles(cell=p3, frac=p3, vel=p3, alive=p2)
        fspec = ctx.field_spec()

        if do_move:
            deposit = _shard_map(self._local_deposit, ctx.mesh,
                                 in_specs=(pspec,),
                                 out_specs=(pspec, fspec, P(), P()))
        else:
            def no_move(p):
                ctx_ = self.ctx
                offset = subdomain_offset(ctx_)
                if self.objects is not None:
                    # initialization cull: particles inside objects are
                    # removed with their charge discarded (the reference's
                    # oCollectObjectCharge on a zeroed rhoObj,
                    # src/main.c:161-166; Simulation._half_kick does the
                    # same)
                    p, _ = self._local_absorb(p)
                S, capL, D = p.cell.shape
                lcell = (p.cell - offset).reshape(S * capL, D)
                frac = p.frac.reshape(S * capL, D)
                q = jnp.broadcast_to(self.params.charge[:, None], (S, capL))
                value = jnp.where(p.alive, q, 0.0).reshape(S * capL)
                padded = tuple(t + 1 for t in ctx_.true_size)
                rho_pad = cic.scatter_cic(padded, lcell, frac, value,
                                          periodic=False,
                                          dtype=self.spec.dtype)
                rho = fold_plus(rho_pad, ctx_.axes, ctx_.n_subdomains,
                                bounded=self._bounded)
                nobj = (self.objects.n_objects
                        if self.objects is not None else 0)
                return (p, rho, jnp.zeros((), jnp.int32),
                        jnp.zeros((nobj + 1,), jnp.float32))
            deposit = _shard_map(no_move, ctx.mesh, in_specs=(pspec,),
                                 out_specs=(pspec, fspec, P(), P()))

        particles, rho, lost, counter = deposit(particles)

        obj_phi = None
        if self.objects is not None and rho_obj is None:
            rho_obj = jnp.zeros(self.objects.shape, self.spec.dtype)
        if self.objects is not None and do_move:
            # the surface-spread + capacitance correction run on the
            # globally-sharded fields (oCollectObjectCharge's grid half +
            # oApplyCapacitanceMatrix, src/object.c:301-515; the per-step
            # sequence collect -> solve -> correct -> solve of
            # src/main.c:222-240)
            obj = self.objects
            rho_obj_flat = rho_obj.ravel()
            for a in range(obj.n_objects):
                share = counter[a + 1] / float(len(obj.surface_idx[a]))
                rho_obj_flat = rho_obj_flat.at[
                    jnp.asarray(obj.surface_idx[a])].add(
                        share.astype(rho_obj.dtype))
            rho_obj = rho_obj_flat.reshape(obj.shape)
            rho_obj = lax.with_sharding_constraint(rho_obj,
                                                   ctx.sharding(fspec))
            rho = rho + rho_obj
            phi = self._solve(rho)
            rho, obj_phi = self.objects.apply_capacitance(rho, phi)
            phi = self._solve(rho)          # 2nd solve (src/main.c:240)
        else:
            phi = self._solve(rho)
        if self.spec.periodic:
            E = -gradient(phi)
        else:
            from ..bc import gradient_bc
            E = -gradient_bc(phi, self.bc)

        kick = _shard_map(partial(self._local_kick, half=half), ctx.mesh,
                          in_specs=(pspec, ctx.field_spec(n_values=1)),
                          out_specs=(pspec, P()))
        particles, ke = kick(particles, E)
        pe = potential_energy(rho, phi)
        return StepOutput(particles, rho, phi, E,
                          Diagnostics(kin_energy=ke, pot_energy=pe,
                                      n_lost=lost),
                          rho_obj=rho_obj, obj_potential=obj_phi)

    def _sharded_half_kick(self, particles: Particles) -> StepOutput:
        # like Simulation._half_kick: no absorption/capacitance before the
        # first field solve; rho_obj passes through as zeros
        return self._sharded_pipeline(particles, do_move=False, half=True)

    def _sharded_step(self, particles: Particles,
                      rho_obj=None) -> StepOutput:
        return self._sharded_pipeline(particles, do_move=True, half=False,
                                      rho_obj=rho_obj)

    def make_scan_steps(self, n: int):
        def body(carry, _):
            particles, rho_obj = carry
            out = self._sharded_step(particles, rho_obj)
            return ((out.particles, out.rho_obj),
                    (out.diag.kin_energy, out.diag.pot_energy))

        @jax.jit
        def run_n(particles, rho_obj=None):
            return jax.lax.scan(body, (particles, rho_obj), None, length=n)
        return run_n


# Device bytes per particle slot (capacity x species) of the flat
# layout's compiled step (arguments + outputs + temporaries; the 8-corner
# CIC index/weight expansions dominate): 142.3 measured on an H100 at
# 64^3 x 2 x 32 per cell (16.8M slots).
FLAT_BYTES_PER_SLOT = 143


def auto_tiled_slots() -> int:
    """Slot count above which the flat layout's working set cannot fit
    the device, so single-device decks that do not pin methods:layout
    take the tiled layout: 3/4 of the device's memory over the flat
    step's peak bytes per slot (the rest is headroom for fields and IO
    staging)."""
    from .. import backend
    return int(0.75 * backend.memory_bytes()) // FLAT_BYTES_PER_SLOT


def make_simulation(cfg: PincConfig, seed: int = 1, devices=None) -> Simulation:
    """Factory: sharded when the deck asks for >1 subdomain and devices
    allow (the mpinc.sh np decision, mpinc.sh:20-29); tiled layout when
    methods:layout = tiled, or automatically for single-device decks too
    big for the flat working set; plain single-block otherwise."""
    from ..config import required_np
    from ..population import capacity_of
    np_needed = required_np(cfg)
    layout = cfg.get_str("methods:layout", "").lower()
    tiled = layout == "tiled"
    if np_needed > 1:
        if tiled:
            from .tiled_pic import ShardedTiledSimulation
            return ShardedTiledSimulation(cfg, seed=seed, devices=devices)
        return ShardedSimulation(cfg, seed=seed, devices=devices)
    if not layout and (capacity_of(cfg)
                       * cfg.get_int("population:nspecies")
                       > auto_tiled_slots()):
        msg(STATUS, "auto-selected methods:layout=tiled (%d particle "
            "slots exceed the flat layout's single-chip working set); "
            "pin methods:layout=flat to override",
            capacity_of(cfg) * cfg.get_int("population:nspecies"))
        tiled = True
    if tiled:
        from ..tiled_sim import TiledSimulation
        return TiledSimulation(cfg, seed=seed)
    return Simulation(cfg, seed=seed)
