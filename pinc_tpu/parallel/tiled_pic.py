"""Sharded x tiled: the production performance path over a device mesh.

Composes the two scaling mechanisms of the framework:

* the **tiled particle layout** (ops/tiled.py, ops/pallas_tiled.py) —
  deposit and gather confined to each tile's padded node block; and
* the **domain decomposition** (parallel/mesh.py) — the JAX replacement
  for the reference's MPI Cartesian decomposition.

The composition is natural because tiles are already a spatial
decomposition: the device mesh partitions the *tile grid* (state arrays
keep the tile axes unflattened, sharded over the 'x','y','z' mesh axes),
and every inter-tile wrap that the single-chip path expresses as a
periodic ``jnp.roll`` along a tile axis becomes, at a device boundary, a
one-plane ``lax.ppermute`` fetch (parallel.halo.shifted_tiles):

* deposition overlap-add fold   → fold_to_global(roll_fns=...)
* field tile padding for gather → pad_tiles(roll_fns=...)
* re-bucket neighbor transfers  → ops.exchange.rebucket_exchange(
  roll_fns=...)

This mirrors the reference's communication structure exactly — gHaloOp's
per-dimension Sendrecv sweeps (src/grid.c:340-406) and puMigrate's
neighbor payload exchange (src/pusher.c:914-1035) — but every transfer
is a collective inside one jitted step, with XLA dataflow replacing the
reference's MPI_Barrier ordering hack (src/grid.c:386-390).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P



from ..config import PincConfig
from ..grid import gradient, potential_energy
from ..ops import tiled as tl
from ..simulation import Diagnostics
from ..tiled_sim import TiledSimulation, TiledState
from ..utils.logging import STATUS, msg
from .halo import shifted_tiles
from .mesh import make_mesh
from .pic import _shard_map


class ShardedTiledSimulation(TiledSimulation):
    """Tiled layout over a grid:nSubdomains device mesh."""

    def __init__(self, cfg: PincConfig, seed: int = 1, devices=None):
        super().__init__(cfg, seed=seed)
        self.ctx = make_mesh(self.spec.n_subdomains, self.spec.true_size,
                             devices=devices)
        ctx = self.ctx
        for t, n in zip(ctx.true_size, ctx.n_subdomains):
            if n > 1 and t % self.ts.T != 0:
                raise ValueError(
                    f"local grid extent {t} not divisible by tile "
                    f"{self.ts.T}")
        self.ts_local = tl.TileSpec(
            grid=ctx.true_size, T=self.ts.T, M=self.ts.M, B=self.ts.B,
            chunk=self.ts.chunk)
        self._state_spec = TiledState(
            lpos=P(None, None, *ctx.axes, None),
            vel=P(None, None, *ctx.axes, None),
            alive=P(None, *ctx.axes, None))
        self.state = self._shard_state(self.state)
        from .pencil_fft import make_sharded_solver
        self._solve = make_sharded_solver(self.solver, ctx, cfg,
                                          self.spec.dtype)
        self._tstep_jit = jax.jit(self._sharded_tiled_step,
                                  donate_argnums=(0,))
        self._thalf_jit = jax.jit(self._sharded_tiled_half_kick,
                                  donate_argnums=(0,))
        self._rebucket_jit = jax.jit(self._sharded_rebucket,
                                     donate_argnums=(0,),
                                     static_argnames=("species",))
        if self.objects is not None:
            # per-device static near-object tile subsets (the single-chip
            # dilated mask, cut per mesh block and padded to the max count
            # so every shard runs the same program); -1 rows are inert
            # (clamped to tile 0, absorbed-mask forced false, idempotent
            # set-writeback)
            interior = np.asarray(self.objects.interior_id) > 0
            T = self.ts.T
            gnt = self.ts.ntiles
            tview = interior.reshape(gnt[0], T, gnt[1], T, gnt[2], T)
            tmask = tview.any(axis=(1, 3, 5))
            for ax3 in range(3):
                tmask = (tmask | np.roll(tmask, 1, axis=ax3)
                         | np.roll(tmask, -1, axis=ax3))
            lnt = self.ts_local.ntiles
            nsub = ctx.n_subdomains
            ids = []
            for i in range(nsub[0]):
                for j in range(nsub[1]):
                    for k in range(nsub[2]):
                        blk = tmask[i * lnt[0]:(i + 1) * lnt[0],
                                    j * lnt[1]:(j + 1) * lnt[1],
                                    k * lnt[2]:(k + 1) * lnt[2]]
                        ids.append(np.flatnonzero(blk.ravel()))
            nto = max(max((len(a) for a in ids), default=1), 1)
            pad = np.full((nsub[0], nsub[1], nsub[2], nto), -1, np.int32)
            q = 0
            for i in range(nsub[0]):
                for j in range(nsub[1]):
                    for k in range(nsub[2]):
                        a = ids[q]; q += 1
                        pad[i, j, k, :len(a)] = a
            self._obj_tiles_sharded = jax.device_put(
                jnp.asarray(pad), ctx.sharding(P(*ctx.axes, None)))
            self._tstep_obj_jit = jax.jit(self._tiled_step_obj,
                                          donate_argnums=(0,))
            self._thalf_obj_jit = jax.jit(self._tiled_half_kick_obj,
                                          donate_argnums=(0,))
        msg(STATUS, "sharded tiled layout: %s device mesh over %s tiles",
            ctx.n_subdomains, self.ts.ntiles)

    # ---------------------------------------------------------- placement
    def _shard_state(self, st: TiledState) -> TiledState:
        """(S, D, NT, B) flat state -> tile-grid axes, device_put onto the
        mesh (tile linearization is x-major, so the reshape is free and
        contiguous mesh blocks own contiguous tile cuboids)."""
        S, D, NT, B = st.lpos.shape
        nt = self.ts.ntiles
        lpos = st.lpos.reshape((S, D) + nt + (B,))
        vel = st.vel.reshape((S, D) + nt + (B,))
        alive = st.alive.reshape((S,) + nt + (B,))
        put = lambda a, spec: jax.device_put(
            a, self.ctx.sharding(spec))
        return TiledState(
            lpos=put(lpos, self._state_spec.lpos),
            vel=put(vel, self._state_spec.vel),
            alive=put(alive, self._state_spec.alive))

    def _roll_fns(self):
        """Per-dim tile-axis wrap: ppermute across device boundaries."""
        ctx = self.ctx
        return [(lambda a, s, ax, d=d: shifted_tiles(
                    a, ax, s, ctx.axes[d], ctx.n_subdomains[d]))
                for d in range(len(ctx.axes))]

    # -------------------------------------------------------- local parts
    def _local_planes(self, st):
        """Per-shard state -> (S, D, NTl, B) planes for a particle pass."""
        ln = self.ts_local
        S, D = st.lpos.shape[:2]
        return (st.lpos.reshape(S, D, ln.NT, ln.B),
                st.vel.reshape(S, D, ln.NT, ln.B),
                st.alive.reshape(S, ln.NT, ln.B))

    def _local_fields(self, st):
        """Per-device: deposit local tiles (all species into one tile
        set), fold ONCE with ppermute halos."""
        tiles = self._particles(*self._local_planes(st), self.ts_local,
                                deposit=True)[0]
        rho = tl.fold_to_global(tiles, self.ts_local,
                                roll_fns=self._roll_fns())
        return rho.astype(self.spec.dtype)

    def _local_kick(self, st, E_local, half: bool):
        """Per-shard velocity kick with the full method routing
        (CIC/NGP order, external E, Boris rotation) — mirrors
        TiledSimulation._kick with psum'd KE."""
        e_scale = 0.5 if half else 1.0
        E_pad = e_scale * tl.pad_tiles(E_local, self.ts_local,
                                       roll_fns=self._roll_fns())
        _, _, vel, vdot, _ = self._particles(
            *self._local_planes(st), self.ts_local, field=E_pad,
            e_scale=e_scale, kick=True)
        ke = 0.5 * jnp.asarray(self.params.mass, jnp.float32) * vdot
        for ax in self.ctx.axes:
            ke = lax.psum(ke, ax)
        return (TiledState(lpos=st.lpos, vel=vel.reshape(st.vel.shape),
                           alive=st.alive), ke)

    def _local_reflect(self, stl):
        """Specular reflection at non-periodic global walls, per shard:
        the single-chip tile-local reflection (TiledSimulation.
        _reflect_walls) with the device's global origin offset added.
        Reflection keeps every position in [0, L-1], and CIC hat weights
        vanish one cell out, so the periodic tile wraps (fold, pad,
        exchange buffers) only ever carry zeros at bounded walls — no
        other sharded machinery changes."""
        ln = self.ts_local
        D = ln.n_dims
        NTl, B = ln.NT, ln.B
        origins = tl.tile_origins(ln)                 # (NTl, D) local
        S = stl.lpos.shape[0]
        lp = stl.lpos.reshape(S, D, NTl, B)
        vl = stl.vel.reshape(S, D, NTl, B)
        for d, bounded in enumerate(self._bounded_dims):
            if not bounded:
                continue
            hi = float(self.ts.grid[d] - 1)
            off = (lax.axis_index(self.ctx.axes[d])
                   * self.ctx.true_size[d]).astype(jnp.float32)
            org = origins[:, d][None, :, None] + off  # (1, NTl, 1)
            g = lp[:, d] + org
            period = 2.0 * hi
            g_m = jnp.mod(g, period)
            g_r = jnp.where(g_m > hi, period - g_m, g_m)
            flip = (jnp.floor(g / hi).astype(jnp.int32) % 2) != 0
            lp = lp.at[:, d].set(g_r - org)
            vl = vl.at[:, d].set(jnp.where(flip, -vl[:, d], vl[:, d]))
        return TiledState(lpos=lp.reshape(stl.lpos.shape),
                          vel=vl.reshape(stl.vel.shape), alive=stl.alive)

    def _local_rebucket(self, st, species=None):
        ln = self.ts_local
        D = ln.n_dims
        NTl, B = ln.NT, ln.B
        # the exchange works on the local tile grid; only the buffer wrap
        # crosses devices
        lnt = ln.ntiles
        from ..ops.exchange import rebucket_exchange
        S = st.lpos.shape[0]
        species = tuple(range(S)) if species is None else tuple(species)
        lpos, vel, alive = st.lpos, st.vel, st.alive
        dropped = jnp.zeros((), jnp.int32)
        for s in species:
            planes = tuple(lpos[s, d].reshape(NTl, B) for d in range(D)) \
                + tuple(vel[s, d].reshape(NTl, B) for d in range(D))
            planes, al, d_n = rebucket_exchange(
                planes, alive[s].reshape(NTl, B), lnt, ln.T,
                K=self._exchange_cap, roll_fns=self._roll_fns())
            lpos = lpos.at[s].set(
                jnp.stack(planes[:D]).reshape(lpos[s].shape))
            vel = vel.at[s].set(
                jnp.stack(planes[D:]).reshape(vel[s].shape))
            alive = alive.at[s].set(al.reshape(alive[s].shape))
            dropped = dropped + d_n
        for ax in self.ctx.axes:
            dropped = lax.psum(dropped, ax)
        return TiledState(lpos=lpos, vel=vel, alive=alive), dropped

    def _local_absorb_tiled(self, stl: TiledState, obj_idx,
                            collide: bool = True):
        """Per-shard object absorption on the local near-object tile
        subset (particle half of oCollectObjectCharge,
        src/object.c:460-515); psum'd per-object charge counter and
        localized adhere charge (flat (V,), or a (1,) zero stub when no
        species adheres).  collide=False is the init-time cull — no
        collision responses, matching the single-chip _absorb."""
        from jax import lax as _lax
        obj = self.objects
        ln = self.ts_local
        D, NTl, B = ln.n_dims, ln.NT, ln.B
        idx = obj_idx.reshape(-1)
        valid = idx >= 0
        idxc = jnp.maximum(idx, 0)
        # writeback index: pad rows go OUT OF BOUNDS (dropped by scatter
        # semantics) — clamping them to tile 0 would race a genuine tile-0
        # row in the duplicate-index scatter below
        widx = jnp.where(valid, idx, NTl)
        origins = tl.tile_origins(ln)[idxc]              # (NTo, D) local
        off = jnp.stack([
            (_lax.axis_index(self.ctx.axes[d])
             * self.ctx.true_size[d]).astype(jnp.float32)
            for d in range(D)])                          # (D,)
        Lf = jnp.asarray(self.ts.grid, jnp.float32)
        Li = jnp.asarray(self.ts.grid, jnp.int32)
        S = stl.lpos.shape[0]
        counter = jnp.zeros((obj.n_objects + 1,), jnp.float32)
        lpos, vel, alive = stl.lpos, stl.vel, stl.alive
        ash = alive[0].shape
        psh = lpos[0].shape
        rho_add = (jnp.zeros((int(np.prod(obj.shape)),), jnp.float32)
                   if self._has_adhere() else
                   jnp.zeros((1,), jnp.float32))
        origins_g = origins.astype(jnp.float32) + off[None, :]
        for s in range(S):
            lp = lpos[s].reshape(D, NTl, B)[:, idxc, :]
            al = alive[s].reshape(NTl, B)[idxc]          # (NTo, B)
            m = self._collision_type(s) if collide else "absorb"
            if m in ("reflect", "backscatter"):
                vl = vel[s].reshape(D, NTl, B)[:, idxc, :]
                lp, vl = self._collide_tile_planes(
                    lp, vl, al, origins_g, m, valid=valid[:, None])
                lpos = lpos.at[s].set(lpos[s].reshape(D, NTl, B)
                                      .at[:, widx].set(lp).reshape(psh))
                vel = vel.at[s].set(vel[s].reshape(D, NTl, B)
                                    .at[:, widx].set(vl).reshape(psh))
            elif m == "adhere":
                vl = vel[s].reshape(D, NTl, B)[:, idxc, :]
                al, rho_add = self._adhere_tiles(
                    s, lp, vl, al, origins_g, rho_add,
                    valid=valid[:, None])
            elif m == "secondary":
                tgt = obj.see_species
                vl = vel[s].reshape(D, NTl, B)[:, idxc, :]
                lp_t, vl_t, al_t, n_emit = self._emit_secondaries_tiles(
                    s, lp, vl, al,
                    lpos[tgt].reshape(D, NTl, B)[:, idxc, :],
                    vel[tgt].reshape(D, NTl, B)[:, idxc, :],
                    alive[tgt].reshape(NTl, B)[idxc], origins_g,
                    valid=valid[:, None])
                lpos = lpos.at[tgt].set(lpos[tgt].reshape(D, NTl, B)
                                        .at[:, widx].set(lp_t).reshape(psh))
                vel = vel.at[tgt].set(vel[tgt].reshape(D, NTl, B)
                                      .at[:, widx].set(vl_t).reshape(psh))
                alive = alive.at[tgt].set(alive[tgt].reshape(NTl, B)
                                          .at[widx].set(al_t).reshape(ash))
                q_t = float(np.asarray(self.params.charge)[tgt])
                counter = counter - q_t * n_emit
                if tgt == s:
                    lp = lpos[s].reshape(D, NTl, B)[:, idxc, :]
                    al = alive[s].reshape(NTl, B)[idxc]
            g = jnp.mod(lp + origins.T[:, :, None] + off[:, None, None],
                        Lf[:, None, None])
            cell = jnp.clip(jnp.floor(g).astype(jnp.int32), 0,
                            Li[:, None, None] - 1)
            oid = obj.interior_id[cell[0], cell[1], cell[2]]
            absorbed = (al > 0.5) & (oid > 0) & valid[:, None]
            q = float(np.asarray(self.params.charge)[s])
            counter = counter + jax.ops.segment_sum(
                jnp.where(absorbed, q, 0.0).ravel(),
                jnp.where(absorbed, oid, 0).ravel(),
                num_segments=obj.n_objects + 1)
            new_al = jnp.where(absorbed, 0.0, al)
            alive = alive.at[s].set(
                alive[s].reshape(NTl, B).at[widx].set(new_al).reshape(ash))
        for ax in self.ctx.axes:
            counter = _lax.psum(counter, ax)
            rho_add = _lax.psum(rho_add, ax)
        return TiledState(lpos=lpos, vel=vel, alive=alive), counter, rho_add

    def _tiled_step_obj(self, st: TiledState, rho_obj):
        """Sharded-tiled object step: same sequence as the single-chip
        _tiled_step_obj (src/main.c:222-240), with the absorb inside the
        per-shard deposit map and the capacitance/surface work on the
        globally-sharded fields."""
        return self._pipeline_obj(st, rho_obj, half=False, cull_only=False)

    def _tiled_half_kick_obj(self, st: TiledState):
        st, rho, phi, E, diag, _, _ = self._pipeline_obj(
            st, self.spec.zeros(), half=True, cull_only=True)
        return st, rho, phi, E, diag

    def _pipeline_obj(self, st: TiledState, rho_obj, half: bool,
                      cull_only: bool):
        ctx = self.ctx
        sspec = self._state_spec
        fspec = ctx.field_spec()
        ospec = P(*ctx.axes, None)

        def dep(stl, obj_idx):
            if not cull_only:
                stl = TiledState(lpos=stl.lpos + stl.vel, vel=stl.vel,
                                 alive=stl.alive)
                if not self.spec.periodic:
                    stl = self._local_reflect(stl)
            n_out = self._out_of_margin(stl)
            stl, counter, rho_add = self._local_absorb_tiled(
                stl, obj_idx, collide=not cull_only)
            rho = self._local_fields(stl)
            for ax in ctx.axes:
                n_out = lax.psum(n_out, ax)
            return stl, rho, n_out, counter, rho_add

        st, rho, n_out, counter, rho_add = _shard_map(
            dep, ctx.mesh, in_specs=(sspec, ospec),
            out_specs=(sspec, fspec, P(), P(), P()))(
                st, self._obj_tiles_sharded)

        obj = self.objects
        obj_phi = None
        if cull_only:
            phi = self._solve(rho)
        else:
            rho_obj_flat = rho_obj.ravel()
            for a in range(obj.n_objects):
                share = counter[a + 1] / float(len(obj.surface_idx[a]))
                rho_obj_flat = rho_obj_flat.at[
                    jnp.asarray(obj.surface_idx[a])].add(
                        share.astype(rho_obj.dtype))
            if self._has_adhere():
                rho_obj_flat = rho_obj_flat + rho_add
            rho_obj = rho_obj_flat.reshape(obj.shape)
            rho_obj = lax.with_sharding_constraint(rho_obj,
                                                   ctx.sharding(fspec))
            rho = rho + rho_obj
            phi = self._solve(rho)
            rho, obj_phi = obj.apply_capacitance(rho, phi)
            phi = self._solve(rho)          # 2nd solve (src/main.c:240)
        if self.spec.periodic:
            E = -gradient(phi)
        else:
            from ..bc import gradient_bc
            E = -gradient_bc(phi, self.bc)
        st, ke = _shard_map(
            partial(self._local_kick, half=half), ctx.mesh,
            in_specs=(sspec, ctx.field_spec(n_values=1)),
            out_specs=(sspec, P()))(st, E)
        pe = potential_energy(rho, phi)
        return (st, rho, phi, E,
                Diagnostics(kin_energy=ke, pot_energy=pe, n_lost=n_out),
                rho_obj, obj_phi)

    # ------------------------------------------------------------ the step
    # _solve is bound in __init__ via parallel.pencil_fft.make_sharded_solver

    def _pipeline(self, st: TiledState, do_move: bool, half: bool):
        ctx = self.ctx
        sspec = self._state_spec
        fspec = ctx.field_spec()

        def dep(stl):
            if do_move:
                stl = TiledState(lpos=stl.lpos + stl.vel, vel=stl.vel,
                                 alive=stl.alive)
                if not self.spec.periodic:
                    stl = self._local_reflect(stl)
            rho = self._local_fields(stl)
            n_out = self._out_of_margin(stl)
            for ax in ctx.axes:
                n_out = lax.psum(n_out, ax)
            return stl, rho, n_out

        st, rho, n_out = _shard_map(
            dep, ctx.mesh, in_specs=(sspec,),
            out_specs=(sspec, fspec, P()))(st)
        phi = self._solve(rho)
        if self.spec.periodic:
            E = -gradient(phi)
        else:
            from ..bc import gradient_bc
            E = -gradient_bc(phi, self.bc)
        st, ke = _shard_map(
            partial(self._local_kick, half=half), ctx.mesh,
            in_specs=(sspec, ctx.field_spec(n_values=1)),
            out_specs=(sspec, P()))(st, E)
        pe = potential_energy(rho, phi)
        return st, rho, phi, E, Diagnostics(kin_energy=ke, pot_energy=pe,
                                            n_lost=n_out)

    def _sharded_tiled_half_kick(self, st: TiledState):
        return self._pipeline(st, do_move=False, half=True)

    def _sharded_tiled_step(self, st: TiledState):
        return self._pipeline(st, do_move=True, half=False)

    def _sharded_rebucket(self, st: TiledState, species=None):
        return _shard_map(partial(self._local_rebucket, species=species),
                          self.ctx.mesh, in_specs=(self._state_spec,),
                          out_specs=(self._state_spec, P()))(st)

    # run()/make_scan_steps reuse TiledSimulation's drivers through the
    # _step_for_scan/_rebucket hooks:
    def _step_for_scan(self, st: TiledState):
        return self._sharded_tiled_step(st)

    def _rebucket(self, st: TiledState, species=None):
        return self._sharded_rebucket(st, species=species)

    def _make_scan_steps_mega(self, n: int, donate: bool = False):
        """Sharded fused scan: the single-device body per shard (kick with
        the previous field, drift, deposit — one particle pass for all
        species), with the padded field tiles riding the carry as a
        tile-grid-sharded array and every tile wrap on ppermute."""
        ctx = self.ctx
        sspec = self._state_spec
        fspec = ctx.field_spec()
        ln = self.ts_local
        lnt = ln.ntiles
        espec = P(*ctx.axes, None, None, None, None)
        mass_j = jnp.asarray(np.asarray(self.params.mass), jnp.float32)

        def particles_part(stl, e_pad):
            tiles, lpos, vel, vdot, _ = self._particles(
                *self._local_planes(stl), ln,
                field=e_pad.reshape((ln.NT,) + e_pad.shape[3:]),
                kick=True, drift=True, deposit=True)
            rho = tl.fold_to_global(
                tiles, ln, roll_fns=self._roll_fns()).astype(self.spec.dtype)
            ke = 0.5 * mass_j * vdot
            for ax in ctx.axes:
                ke = lax.psum(ke, ax)
            st2 = TiledState(lpos=lpos.reshape(stl.lpos.shape),
                             vel=vel.reshape(stl.vel.shape),
                             alive=stl.alive)
            return st2, rho, ke

        def pad_part(El):
            e_pad = tl.pad_tiles(El, ln, roll_fns=self._roll_fns())
            return e_pad.reshape(lnt + e_pad.shape[1:])

        pmap_particles = _shard_map(
            particles_part, ctx.mesh, in_specs=(sspec, espec),
            out_specs=(sspec, fspec, P()))
        pmap_pad = _shard_map(pad_part, ctx.mesh,
                              in_specs=(ctx.field_spec(n_values=1),),
                              out_specs=espec)

        def e_field(phi):
            if self.spec.periodic:
                return -gradient(phi)
            from ..bc import gradient_bc
            return -gradient_bc(phi, self.bc)

        def body(carry, _):
            st, e_pad, pe_prev = carry
            st, rho, ke = pmap_particles(st, e_pad)
            phi = self._solve(rho)
            pe = potential_energy(rho, phi)
            return (st, pmap_pad(e_field(phi)), pe), (ke, pe_prev)

        def run_n(st, rho_obj=None):
            rho0 = _shard_map(self._local_fields, ctx.mesh,
                              in_specs=(sspec,), out_specs=fspec)(st)
            phi0 = self._solve(rho0)
            carry = (st, pmap_pad(e_field(phi0)),
                     potential_energy(rho0, phi0))
            carry, (ke, pe), dropped = self._scan_with_rebuckets(
                body, carry, n)
            return carry[0], (ke, pe, dropped)

        from ..tiled_sim import _jit_maybe_donate
        return _jit_maybe_donate(run_n, donate)
