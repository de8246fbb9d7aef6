"""Tiled-layout simulation: the production single-chip performance path.

Same physics as :class:`Simulation`, but particles live in per-tile buckets
(ops/tiled.py) so deposit and gather touch only a tile's small padded node
block: the fused Triton kernel (ops/pallas_tiled.py) on the GPU, the XLA
contraction route elsewhere.  Selected with ``methods:layout = tiled`` (or
automatically for large decks, parallel.pic.make_simulation).  Deck
knobs, section ``[tiles]``:

* ``tileSize``       — tile edge in cells (default 8)
* ``margin``         — wander margin M in cells (default 1 or 2, from the
                       initial velocity scale)
* ``slack``          — bucket capacity head-room factor (default 1.25)
* ``rebucketEvery``  — steps between exchange re-buckets (ops/exchange.py;
                       default per species: margin / 99.9th-percentile
                       speed, at least 1)
* ``backend``        — ``pallas`` (Triton particle kernel) or ``xla``;
                       default from pinc_tpu/backend.py

Out-of-margin particles deposit nothing until the next re-bucket; the step
counts them (``n_out``) and run() warns — the same safety-by-accounting
stance as migration overflow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import backend
from .config import PincConfig
from .grid import gradient, potential_energy
from .ops import tiled as tl
from .population import Particles
from .simulation import Diagnostics, Simulation, StepOutput
from .utils.logging import STATUS, WARNING, msg


def _jit_maybe_donate(fn, donate):
    """Scan drivers optionally donate their input state (the bench path:
    the caller must treat the passed state as consumed)."""
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TiledState:
    """Component-plane layout: coordinates are stored as D contiguous
    (NT, B) planes rather than an (NT, B, D) array, so the particle
    kernel's per-component slot loads are contiguous."""
    lpos: jax.Array    # (S, D, NT, B) tile-local positions
    vel: jax.Array     # (S, D, NT, B)
    alive: jax.Array   # (S, NT, B) f32 0/1 (kernel-ready; compare >0.5
                       # where a boolean mask is needed)


class TiledSimulation(Simulation):
    _DEFER_PARTICLES = True    # rebucket from per-species regeneration at
                               # giant populations (see Simulation.__init__)
    _TILED_CKPT = True         # resumes tiled-layout checkpoints verbatim

    def __init__(self, cfg: PincConfig, seed: int = 1):
        super().__init__(cfg, seed=seed)
        from .grid import BndType
        self._bounded_dims = tuple(b is not BndType.PERIODIC
                                   for b in self.bc.upper)

        nd = self.spec.n_dims
        # physics-method routing: the tiled kernels honor the SAME deck
        # selections as the flat path (methods:acc / methods:distr /
        # fields:EExt / fields:BExt) — the registry closures expose their
        # static attributes for kernel specialization.  Anything the
        # kernels cannot express must raise, never silently downgrade.
        self._acc_order = getattr(self.acc, "order", None)
        self._acc_boris = getattr(self.acc, "boris", None)
        self._distr_order = getattr(self.distr, "order", None)
        if None in (self._acc_order, self._acc_boris, self._distr_order):
            raise ValueError(
                "methods:layout=tiled requires a registry accelerator/"
                "distributor (puAcc*/puBoris*/puDistr*) — got "
                f"{cfg.get_str('methods:acc')}/{cfg.get_str('methods:distr')}")
        eext = getattr(self.acc, "E_ext", None)
        self._e_ext = (None if eext is None else
                       tuple(float(v) for v in np.asarray(eext).ravel()))
        if self._acc_boris:
            if nd != 3:
                raise ValueError("puBoris3D1* requires grid:nDims=3")
            # puGet3DRotationParameters (src/pusher.c:483-505):
            # T = 0.5 (q/m) B_ext, S = 2T / (1 + |T|^2), per species
            bext = np.asarray(cfg.get_double_arr("fields:bext", nd)
                              if "fields:bext" in cfg else [0.0] * nd)
            qm_np = (np.asarray(self.params.charge)
                     / np.asarray(self.params.mass))
            T_s = 0.5 * qm_np[:, None] * bext[None, :]          # (S, 3)
            S_s = 2.0 * T_s / (1.0 + np.sum(T_s * T_s, axis=1,
                                            keepdims=True))
            self._boris_T = T_s
            self._boris_S = S_s
        else:
            self._boris_T = self._boris_S = None
        T = cfg.get_int("tiles:tilesize", 8)
        # margin default 1 when the velocity scale allows a re-bucket
        # cadence >= 4: the padded blocks that the fold and the field
        # padding move shrink from (T+5)^3 to (T+3)^3 nodes per tile, and
        # the out-of-margin counter triggers early re-buckets when the
        # estimate is beaten.  One host pass computes the per-species
        # velocity scales used for both the margin default and the
        # per-species re-bucket cadences, from a strided device-side
        # sample (~500k slots) rather than the full (S, N, D) velocity
        # array; the 99.9th percentile of a 500k sample is stable
        ns = cfg.get_int("population:nspecies")
        # floor the per-species velocity scale by the deck's (normalized)
        # thermalVelocity: cold-start decks (pVelZero, langmuirCold) have
        # zero SAMPLED velocities, but the Langmuir oscillation develops
        # thermal-scale velocities within an oscillation period — a
        # cadence sized from the zero sample never re-buckets and sheds
        # particles once the wave grows
        vth_cfg = (cfg.get_double_arr("population:thermalvelocity", ns)
                   if "population:thermalvelocity" in cfg else [0.0] * ns)
        dr_cfg = (cfg.get_double_arr("population:drift", ns)
                  if "population:drift" in cfg else [0.0] * ns)
        floor_s = [(3.29 * abs(vth_cfg[s]) + abs(dr_cfg[s])) * 1.5
                   for s in range(ns)]
        if self.particles is not None:
            N_cap = self.particles.vel.shape[1]
            stride = max(1, N_cap // 500_000)
            vel_np = np.abs(np.asarray(self.particles.vel[:, ::stride]))
            alive_np = np.asarray(self.particles.alive[:, ::stride])
            vmax_s = []
            for s in range(ns):
                vs = vel_np[s][alive_np[s]]
                measured = (float(np.percentile(vs, 99.9)) * 1.5
                            if vs.size else 0.0)
                vmax_s.append(max(measured, floor_s[s], 1e-3))
        else:
            # deferred flat init: the same 99.9th-percentile * 1.5
            # statistic analytically (3.29 sigma for a Maxwellian)
            vth = (cfg.get_double_arr("population:thermalvelocity", ns)
                   if "population:thermalvelocity" in cfg else [0.0] * ns)
            dr = (cfg.get_double_arr("population:drift", ns)
                  if "population:drift" in cfg else [0.0] * ns)
            vmax_s = [max((3.29 * abs(vth[s]) + abs(dr[s])) * 1.5, 1e-3)
                      for s in range(ns)]
        vmax_est = max(vmax_s)
        M = cfg.get_int("tiles:margin", 1 if 1.0 / vmax_est >= 4 else 2)
        # design envelope: a particle must stay inside the wander margin
        # for at least one step (cadence >= 1), i.e. per-step displacement
        # <= M cells.  Beyond that the +-1-tile exchange can never catch
        # up with the drift and physics silently degrades (weight-0
        # deposits, stranded particles) — raise instead, like the
        # reference's pVelAssertMax guard (src/population.c:316-340), and
        # point at the flat layout / a coarser stepSize.
        if vmax_est > max(M, 2):
            raise ValueError(
                f"tiled layout: estimated per-step particle displacement "
                f"({vmax_est:.2f} cells) exceeds the wander margin "
                f"(tiles:margin={M}); this deck is outside the tiled "
                f"layout's envelope — use methods:layout=flat or a "
                f"coarser grid:stepSize (velocities are normalized by "
                f"the cell size)")
        # particle work scales with the SLOT count NT*B, not the live
        # count, so head-room is paid for every step: 1.25 default, with
        # overflow counted and re-bucketing cheap enough to trigger
        # early.  At ppt=8192 the Poisson occupancy sigma is ~90, so even
        # 1.0625 slack (+512) leaves >5 sigma of bucket head room
        slack = cfg.get_double("tiles:slack", 1.25)
        # per-species particles per tile
        from .population import capacity_of
        from .ops.pallas_tiled import slot_quantum
        cap_all = (self.particles.capacity if self.particles is not None
                   else capacity_of(cfg))
        ppt = cap_all * (T ** nd) / self.spec.global_volume
        # B rounds to the particle kernel's slot chunk (a power of two)
        quantum = slot_quantum(ppt * slack)
        B = int(math.ceil(ppt * slack / quantum)) * quantum
        self.ts = tl.TileSpec(grid=self.spec.global_size, T=T, M=M, B=B,
                              chunk=cfg.get_int("tiles:chunk", 32))
        self.ts.validate()

        # re-bucket cadence: default from the actual velocity scale (99.9th
        # percentile of the initial speeds + drift head-room) rather than
        # the conservative population:maxVel bound — the out-of-margin
        # counter triggers an early re-bucket if the estimate is beaten.
        # PER SPECIES: ions (mass ratio ~2000) drift ~40x slower than
        # electrons, so their buckets stay valid ~40x longer — scheduling
        # them independently nearly halves the re-bucket bill
        if "tiles:rebucketevery" in cfg:
            self.rebucket_every = cfg.get_int("tiles:rebucketevery")
            self.rebucket_every_s = [self.rebucket_every] * len(vmax_s)
        else:
            R_s = [max(1, min(int(M / v), 200)) for v in vmax_s]
            # nested cadences (slow snapped down to a multiple of the
            # fastest) let the scan nest its re-bucket windows (see
            # _scan_with_rebuckets); snapping down just re-buckets early
            Re = min(R_s)
            self.rebucket_every_s = [
                R if R == Re else max(Re, R // Re * Re) for R in R_s]
            self.rebucket_every = min(self.rebucket_every_s)
        self._gather_mode = cfg.get_str("tiles:gather", "dense").lower()
        self._backend = cfg.get_str("tiles:backend",
                                    backend.tiles_backend(nd)).lower()
        if self._backend not in ("pallas", "xla"):
            raise ValueError(f"tiles:backend must be pallas or xla, got "
                             f"{self._backend!r}")
        if self._backend == "pallas" and nd != 3:
            raise ValueError("tiles:backend=pallas requires grid:nDims=3")
        # per-face transfer capacity: mean leavers per face over one
        # cadence is ppt * E[drift+]/T ~= 0.12 ppt*M/T (the cadence puts
        # the 99.9th-percentile drift at M, so sigma ~= M/3.3); the cap
        # takes 4x that mean, which also absorbs lattice initial
        # conditions with particles on tile-face planes; overflow is
        # counted and dropped loudly, and retune() escalates the cap
        self._exchange_cap = cfg.get_int("tiles:exchangecap",
                                         self._face_cap(ppt, float(max(M, 1))))

        if self.objects is not None:
            # static subset of tiles that can contain absorbable particles:
            # tiles with interior nodes, dilated by one tile (margin wander
            # M < T keeps any particle's floor cell within +-1 tile of its
            # bucket).  The exact interior lookup then runs on ~NTo*B slots
            # instead of all NT*B.
            interior = np.asarray(self.objects.interior_id) > 0
            ntiles = self.ts.ntiles
            tview = interior.reshape(ntiles[0], T, ntiles[1], T,
                                     ntiles[2], T)
            tmask = tview.any(axis=(1, 3, 5))
            for ax in range(3):
                tmask = tmask | np.roll(tmask, 1, axis=ax) \
                    | np.roll(tmask, -1, axis=ax)
            self._obj_tiles = jnp.asarray(
                np.flatnonzero(tmask.ravel()).astype(np.int32))
            msg(STATUS, "tiled objects: %d/%d tiles near object surfaces",
                int(self._obj_tiles.shape[0]), self.ts.NT)

        self._capacity = cap_all
        if self._pending_tiled_resume:
            # restore the tile planes verbatim (checkpoint.save_tiled):
            # slot assignment included, so the resumed trajectory is
            # bit-identical to the uninterrupted one
            from . import checkpoint as _ckpt
            step, st, rho_obj = _ckpt.load_tiled(
                cfg, expect_shape=(len(vmax_s), nd, self.ts.NT, self.ts.B))
            self.state = st
            if rho_obj is not None:
                self.rho_obj = jnp.asarray(rho_obj)
            self.start_step = step
            self._resumed = True
            self.particles = None
        elif self.particles is None:
            # deferred flat init (see Simulation.__init__): regenerate
            # each species on device right before bucketing it — the
            # flat (S, cap, D) arrays never coexist with the tiled state.
            # to_particles(state) reconstructs a flat view on demand
            # (run() and the writers already use it).
            self.state = self._bucket_all_generate(seed)
        else:
            self.state = self._bucket_all(self.particles)
            # drop the flat copy (int32 cells, f32 fractions and
            # velocities, bool alive per slot) once it would take more
            # than 1/16 of the device's memory beside the tiled state
            flat_bytes = cap_all * ns * (12 * nd + 1)
            if flat_bytes * 16 > backend.memory_bytes():
                self.particles = None
        self._tstep_jit = jax.jit(self._tiled_step, donate_argnums=(0,))
        self._thalf_jit = jax.jit(self._tiled_half_kick,
                                  donate_argnums=(0,))
        if self.objects is not None:
            self._tstep_obj_jit = jax.jit(self._tiled_step_obj,
                                          donate_argnums=(0,))
            self._thalf_obj_jit = jax.jit(self._tiled_half_kick_obj,
                                          donate_argnums=(0,))
        self._rebucket_jit = jax.jit(self._rebucket, donate_argnums=(0,),
                                     static_argnames=("species",))
        msg(STATUS, "tiled layout: %s tiles of %d^%d cells, bucket=%d, "
            "margin=%d, rebucket every %d steps",
            self.ts.ntiles, T, nd, B, M, self.rebucket_every)

    # ------------------------------------------------------------- layout
    def _face_cap(self, ppt: float, drift: float) -> int:
        """Exchange face capacity for ``drift`` cells of wander per
        cadence: ppt*drift/(2T) rounded up to 128, clamped to [128, B]
        (the face buffers are small next to the bucket planes, so head
        room is cheap)."""
        cap = int(math.ceil(max(ppt, 128) * drift / (2.0 * self.ts.T)
                            / 128.0)) * 128
        return min(max(128, cap), self.ts.B)

    def retune(self, st: Optional["TiledState"] = None,
               drops: int = 0) -> bool:
        """Re-estimate the per-species velocity scales from the CURRENT
        state and refresh the re-bucket cadences and the exchange face
        cap.  For long runs whose temperature evolves (grid heating, beam
        relaxation): a fixed schedule sized from the initial velocities
        eventually overflows the transfer caps as the tail grows (drops
        are counted, but a drop imbalance between species charges the
        domain).  Called automatically by run() after any drop/margin
        warning and by bench/driver code between scan windows; scan
        functions built after the call pick up the new schedule/cap.

        drops: observed re-bucket drop count since the last retune — any
        nonzero count escalates the exchange face cap 1.5x, so repeated
        windows converge to drop-free even when the velocity statistics
        alone underestimate the tail.
        Returns True if anything changed (callers then rebuild scan
        functions; the re-bucket jit is refreshed here)."""
        st = self.state if st is None else st
        S, D = st.vel.shape[:2]
        B = st.vel.shape[-1]
        NT = int(np.prod(st.vel.shape[2:-1]))
        stride = max(1, NT // 64)
        vel_np = np.abs(np.asarray(
            st.vel.reshape(S, D, NT, B)[:, :, ::stride]))
        alive_np = np.asarray(
            st.alive.reshape(S, NT, B)[:, ::stride]) > 0.5
        changed = False
        M = self.ts.M
        v_s = [0.0] * S
        R_s = list(self.rebucket_every_s)
        for s in range(S):
            vs = vel_np[s].reshape(D, -1)[:, alive_np[s].reshape(-1)]
            if not vs.size:
                continue
            v_s[s] = max(float(np.percentile(vs, 99.9)) * 1.5, 1e-3)
            R_s[s] = max(1, min(int(M / v_s[s]), 200))
        # snap slow cadences DOWN to a multiple of the fastest (re-bucket
        # a touch early — always safe): nested cadences keep the scan's
        # re-bucket windows nestable
        Re = min(R_s)
        R_s = [R if R == Re else max(Re, R // Re * Re) for R in R_s]
        for s in range(S):
            if R_s[s] != self.rebucket_every_s[s]:
                msg(STATUS, "retune: species %d re-bucket cadence %d -> %d",
                    s, self.rebucket_every_s[s], R_s[s])
                self.rebucket_every_s[s] = R_s[s]
                changed = True
        self.rebucket_every = min(self.rebucket_every_s)
        if self.rebucket_every < 2:
            msg(WARNING, "retune: cadence hit %d — the velocity scale has "
                "outgrown margin M=%d (raise tiles:margin)",
                self.rebucket_every, M)
        # face cap: scale with the hottest species' measured drift per
        # cadence (cad*v ~= M by construction, but the cadence clamps at
        # 1 leave drift > M for violently heating decks), plus a 1.5x
        # escalation per drop report
        ppt = self._capacity * (self.ts.T ** self.ts.n_dims) \
            / self.spec.global_volume
        drift = max(max(R * v for R, v in zip(self.rebucket_every_s, v_s)),
                    float(max(M, 1)))
        scale = self._cap_escalation = (
            getattr(self, "_cap_escalation", 1.0) * (1.5 if drops else 1.0))
        cap = self._face_cap(ppt, drift * scale)
        if ("tiles:exchangecap" not in self.cfg
                and cap != self._exchange_cap):
            msg(STATUS, "retune: exchange face cap %d -> %d%s",
                self._exchange_cap, cap,
                " (after drops)" if drops else "")
            self._exchange_cap = cap
            changed = True
        if changed:
            self._rebucket_jit = jax.jit(self._rebucket,
                                         donate_argnums=(0,),
                                         static_argnames=("species",))
        return changed

    def _bucket_all(self, p: Particles) -> TiledState:
        """Initial bucketing, assembled INCREMENTALLY into preallocated
        state arrays with donated updates — jnp.stack over per-species
        pieces held live simultaneously was the setup memory peak at
        100M+ particle populations (flat arrays + pieces + stack copies
        exceeded device memory)."""
        from functools import partial as _partial
        S = p.n_species
        D, NT, B = self.ts.n_dims, self.ts.NT, self.ts.B

        bucket_jit = jax.jit(tl.bucket, static_argnums=(3,))

        @_partial(jax.jit, static_argnums=(1,), donate_argnums=(0, 2))
        def set_vec(big, s, small):
            return big.at[s].set(jnp.moveaxis(small, -1, 0))

        @_partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
        def set_row(big, s, small):
            return big.at[s].set(small.astype(jnp.float32))

        lpos = jnp.zeros((S, D, NT, B), jnp.float32)
        vel = jnp.zeros((S, D, NT, B), jnp.float32)
        alive = jnp.zeros((S, NT, B), jnp.float32)
        for s in range(S):
            pos = p.cell[s].astype(jnp.float32) + p.frac[s]
            lp, lv, la, dropped = bucket_jit(pos, p.vel[s], p.alive[s],
                                             self.ts)
            del pos
            lpos = set_vec(lpos, s, lp)
            del lp
            vel = set_vec(vel, s, lv)
            del lv
            alive = set_row(alive, s, la)
            del la
        return TiledState(lpos=lpos, vel=vel, alive=alive)

    def _bucket_all_generate(self, seed: int) -> TiledState:
        """Per-species generate -> bucket -> free: never holds the flat
        (S, cap, D) arrays and the tiled state simultaneously."""
        from functools import partial as _partial
        from .population import device_species
        S = self.params.charge.shape[0]
        D, NT, B = self.ts.n_dims, self.ts.NT, self.ts.B
        @_partial(jax.jit, static_argnums=(1,), donate_argnums=(0, 2))
        def set_vec(big, s, small):
            return big.at[s].set(jnp.moveaxis(small, -1, 0))

        @_partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
        def set_row(big, s, small):
            return big.at[s].set(small.astype(jnp.float32))

        bucket_pos_jit = jax.jit(tl.bucket_positions, static_argnums=(2,),
                                 donate_argnums=(0,))
        bucket_pay_jit = jax.jit(tl.bucket_payload, static_argnums=(2,),
                                 donate_argnums=(1,))
        lpos = jnp.zeros((S, D, NT, B), jnp.float32)
        vel = jnp.zeros((S, D, NT, B), jnp.float32)
        alive = jnp.zeros((S, NT, B), jnp.float32)
        for s in range(S):
            # two-phase: positions bucketed and freed before velocities
            # are even generated — only one multi-GB payload set is ever
            # live next to the growing state
            cell, frac, _, al = device_species(self.cfg, self.spec,
                                               seed, s, parts="pos")
            pos = cell.astype(jnp.float32) + frac
            del cell, frac
            lp, la, tid, dropped = bucket_pos_jit(pos, al, self.ts)
            del pos, al
            lpos = set_vec(lpos, s, lp)
            del lp
            alive = set_row(alive, s, la)
            del la
            _, _, v, _ = device_species(self.cfg, self.spec, seed, s,
                                        parts="vel")
            lv = bucket_pay_jit(tid, v, self.ts)
            del v, tid
            vel = set_vec(vel, s, lv)
            del lv
        return TiledState(lpos=lpos, vel=vel, alive=alive)

    def _rebucket_one(self, lpos_s, vel_s, alive_s):
        """Re-bucket a single species: (D,NT,B)x2 + (NT,B) -> same +
        dropped count."""
        D = self.ts.n_dims
        from .ops.exchange import rebucket_exchange
        planes = tuple(lpos_s[d] for d in range(D)) + tuple(
            vel_s[d] for d in range(D))
        planes, al, d_n = rebucket_exchange(
            planes, alive_s, self.ts.ntiles, self.ts.T,
            K=self._exchange_cap)
        return (jnp.stack(planes[:D]), jnp.stack(planes[D:]), al,
                d_n.astype(jnp.int32))

    def _rebucket(self, st: TiledState,
                  species=None) -> Tuple[TiledState, jax.Array]:
        """Re-bucket the given species tuple (default: all)."""
        S = st.lpos.shape[0]
        species = tuple(range(S)) if species is None else tuple(species)
        lpos, vel, alive = st.lpos, st.vel, st.alive
        dropped = jnp.zeros((), jnp.int32)
        for s in species:
            lp, lv, la, d_n = self._rebucket_one(lpos[s], vel[s], alive[s])
            lpos = lpos.at[s].set(lp)
            vel = vel.at[s].set(lv)
            alive = alive.at[s].set(la)
            dropped = dropped + d_n
        return TiledState(lpos=lpos, vel=vel, alive=alive), dropped

    def to_particles(self, st: TiledState) -> Particles:
        """Convert back to the (cell, frac) layout for IO/diagnostics.
        Accepts flat (S, D, NT, B) or tile-grid (S, D, *nt, B) states
        (the sharded subclass keeps tile axes unflattened)."""
        S, D = st.lpos.shape[:2]
        st = TiledState(lpos=st.lpos.reshape(S, D, -1, st.lpos.shape[-1]),
                        vel=st.vel.reshape(S, D, -1, st.vel.shape[-1]),
                        alive=st.alive.reshape(S, -1, st.alive.shape[-1]))
        lp = jnp.moveaxis(st.lpos, 1, -1)          # (S, NT, B, D)
        gpos = jax.vmap(lambda a: tl.global_positions(a, self.ts))(lp)
        S = gpos.shape[0]
        N = self.ts.NT * self.ts.B
        gp = gpos.reshape(S, N, self.ts.n_dims)
        cell = jnp.floor(gp).astype(jnp.int32)
        frac = gp - jnp.floor(gp)
        L = jnp.asarray(self.ts.grid, jnp.int32)
        cell = jnp.mod(cell, L)
        vel = jnp.moveaxis(st.vel, 1, -1).reshape(S, N, self.ts.n_dims)
        return Particles(cell=cell, frac=frac, vel=vel,
                         alive=st.alive.reshape(S, N) > 0.5)

    # --------------------------------------------------------------- step
    def _collision_type(self, s: int) -> str:
        ct = self.objects.collision_types
        return ct[s] if s < len(ct) else "absorb"

    def _has_adhere(self) -> bool:
        return (self.objects is not None
                and "adhere" in self.objects.collision_types)

    def _collide_tile_planes(self, lp, vl, al, origins, method, valid=None):
        """Collision response on near-object tile planes: lp/vl (D, NTo,
        B) tile-local, origins (NTo, D) global tile origins (device
        offset included on the sharded path).  Positions move by the
        WRAPPED displacement so tile-local coordinates stay near their
        bucket even when the global position wrapped."""
        from .objects import collide_segments
        obj = self.objects
        Lf = jnp.asarray(self.ts.grid, jnp.float32)
        Li = jnp.asarray(self.ts.grid, jnp.int32)
        g = jnp.mod(lp + origins.T[:, :, None], Lf[:, None, None])
        pos = jnp.moveaxis(g, 0, -1)                      # (NTo, B, D)
        vel = jnp.moveaxis(vl, 0, -1)
        cell = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, Li - 1)
        oid = obj.interior_id[cell[..., 0], cell[..., 1], cell[..., 2]]
        hit = (al > 0.5) & (oid > 0)
        if valid is not None:
            hit = hit & valid
        pos2, vel2, _ = collide_segments(pos, vel, hit, obj.interior_id,
                                         obj.normals, self.ts.grid, method)
        delta = jnp.mod(pos2 - pos + 0.5 * Lf, Lf) - 0.5 * Lf
        return lp + jnp.moveaxis(delta, -1, 0), jnp.moveaxis(vel2, -1, 0)

    def _hits_tile_planes(self, lp, vl, al, origins_f, valid=None):
        """Shared hit classification on near-object tile planes: returns
        (pos (NTo,B,D) global wrapped, vel, oid, hit, tunneled) where
        ``tunneled`` marks hits whose segment start was also interior
        (no crossing to bisect — same failure class as the flat path)."""
        obj = self.objects
        Lf = jnp.asarray(self.ts.grid, jnp.float32)
        Li = jnp.asarray(self.ts.grid, jnp.int32)
        g = jnp.mod(lp + origins_f.T[:, :, None], Lf[:, None, None])
        pos = jnp.moveaxis(g, 0, -1)                      # (NTo, B, D)
        vel = jnp.moveaxis(vl, 0, -1)
        cell = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, Li - 1)
        oid = obj.interior_id[cell[..., 0], cell[..., 1], cell[..., 2]]
        hit = (al > 0.5) & (oid > 0)
        if valid is not None:
            hit = hit & valid
        tunneled = hit & obj._interior_at(pos - vel)
        return pos, vel, oid, hit, tunneled

    def _adhere_tiles(self, s, lp, vl, al, origins_f, rho_add, valid=None):
        """Tiled pAdhere: kill impactors at their trajectory-surface
        crossing and deposit their charge on the nearest surface node
        (flat _adhere semantics on the near-object tile planes).
        Tunneled hits stay alive for the caller's uniform-spread absorb.
        Returns (alive', rho_add' flat (V,) localized charge)."""
        from .objects import intersect_segments
        obj = self.objects
        pos, vel, _, hit, tunneled = self._hits_tile_planes(
            lp, vl, al, origins_f, valid)
        ok = hit & ~tunneled
        _, x_int, _ = intersect_segments(pos, vel, obj.interior_id,
                                         obj.normals, self.ts.grid)
        flat_idx = obj._nearest_surface_flat(x_int)
        q = float(np.asarray(self.params.charge)[s])
        rho_add = rho_add.at[flat_idx.ravel()].add(
            jnp.where(ok, q, 0.0).ravel())
        return jnp.where(ok, 0.0, al), rho_add

    def _emit_secondaries_tiles(self, s, lp, vl, al, lp_t, vl_t, al_t,
                                origins_f, valid=None):
        """Tiled pSecondaryElectron: emit see_yield cosine-distributed
        secondaries per impact into free (dead) slots of the TARGET
        species' bucket of the SAME tile — the merge-kernel discipline
        (append at free slots, overflow dropped).  The impactor is left
        interior for the caller's absorb.  Emission points sit within
        one cell of the impactor, so tile-local coords stay inside the
        wander-margin envelope (the out-of-margin guard catches the
        rare overshoot and forces an early re-bucket).  Returns
        (lp_t', vl_t', al_t', per-object emission counts (n_obj+1,))."""
        from .objects import (intersect_segments, cosine_directions,
                              _hash_uniform)
        obj = self.objects
        D = self.ts.n_dims
        Lf = jnp.asarray(self.ts.grid, jnp.float32)
        pos, vel, oid, hit, tunneled = self._hits_tile_planes(
            lp, vl, al, origins_f, valid)
        hit = hit & ~tunneled
        _, x_int, nrm = intersect_segments(pos, vel, obj.interior_id,
                                           obj.normals, self.ts.grid)
        x_emit = x_int + 0.01 * nrm
        x_emit = (jnp.mod(x_emit, Lf) if obj.periodic
                  else jnp.clip(x_emit, 0.0, Lf - 1e-3))
        # tile-local emission coords: impactor lp + wrapped displacement
        delta = jnp.mod(x_emit - pos + 0.5 * Lf, Lf) - 0.5 * Lf
        lpe = lp + jnp.moveaxis(delta, -1, 0)             # (D, NTo, B)
        NTo, B = al.shape
        rows = jnp.arange(NTo)[:, None]
        order = jnp.argsort(al_t, axis=-1)                # dead-first
        n_dead = jnp.sum(al_t < 0.5, axis=-1,
                         keepdims=True).astype(jnp.int32)
        rank = (jnp.cumsum(hit, axis=-1) - 1).astype(jnp.int32)
        bits = (jnp.arange(NTo * B, dtype=jnp.uint32).reshape(NTo, B)
                ^ jax.lax.bitcast_convert_type(vl[0], jnp.uint32))
        n_emit = jnp.zeros((obj.n_objects + 1,), jnp.float32)
        for k in range(obj.see_yield):
            u1 = _hash_uniform(bits + jnp.uint32(2 * k + 1))
            u2 = _hash_uniform(bits * jnp.uint32(0x9E3779B1)
                               + jnp.uint32(k))
            v_e = obj.see_vth * cosine_directions(nrm, u1, u2)
            grank = rank * obj.see_yield + k
            ok = hit & (grank >= 0) & (grank < n_dead)
            slot = jnp.where(
                ok, jnp.take_along_axis(order, jnp.clip(grank, 0, B - 1),
                                        axis=-1), B)
            al_t = al_t.at[rows, slot].set(1.0, mode="drop")
            for d in range(D):
                lp_t = lp_t.at[d, rows, slot].set(lpe[d], mode="drop")
                vl_t = vl_t.at[d, rows, slot].set(
                    v_e[..., d].astype(vl_t.dtype), mode="drop")
            n_emit = n_emit + jax.ops.segment_sum(
                jnp.where(ok, 1.0, 0.0).ravel(),
                jnp.where(ok, oid, 0).ravel(),
                num_segments=obj.n_objects + 1)
        return lp_t, vl_t, al_t, n_emit

    def _absorb(self, st: TiledState, collide: bool = True):
        """Object absorption on the static near-object tile subset (the
        particle half of oCollectObjectCharge, src/object.c:460-515),
        preceded by the per-species reflect/backscatter responses where
        the deck selects them (objects:collisionType).  collide=False is
        the init-time cull (src/main.c:161-166): interior particles are
        removed outright, no response.  Returns (state with absorbed
        particles dead, per-object absorbed charge counter, localized
        adhere charge — flat (V,) or None)."""
        obj = self.objects
        idx = self._obj_tiles
        origins = tl.tile_origins(self.ts)[idx]           # (NTo, D)
        origins_f = origins.astype(jnp.float32)
        Lf = jnp.asarray(self.ts.grid, jnp.float32)
        Li = jnp.asarray(self.ts.grid, jnp.int32)
        counter = jnp.zeros((obj.n_objects + 1,), jnp.float32)
        rho_add = (jnp.zeros((int(np.prod(obj.shape)),), jnp.float32)
                   if collide and self._has_adhere() else None)
        lpos, vel, alive = st.lpos, st.vel, st.alive
        for s in range(st.lpos.shape[0]):
            lp = lpos[s][:, idx, :]                       # (D, NTo, B)
            al = alive[s][idx]                            # (NTo, B) f32
            m = self._collision_type(s) if collide else "absorb"
            if m in ("reflect", "backscatter"):
                lp, vl = self._collide_tile_planes(
                    lp, vel[s][:, idx, :], al, origins_f, m)
                lpos = lpos.at[s].set(lpos[s].at[:, idx].set(lp))
                vel = vel.at[s].set(vel[s].at[:, idx].set(vl))
            elif m == "adhere":
                al, rho_add = self._adhere_tiles(
                    s, lp, vel[s][:, idx, :], al, origins_f, rho_add)
            elif m == "secondary":
                tgt = obj.see_species
                lp_t, vl_t, al_t, n_emit = self._emit_secondaries_tiles(
                    s, lp, vel[s][:, idx, :], al,
                    lpos[tgt][:, idx, :], vel[tgt][:, idx, :],
                    alive[tgt][idx], origins_f)
                lpos = lpos.at[tgt].set(lpos[tgt].at[:, idx].set(lp_t))
                vel = vel.at[tgt].set(vel[tgt].at[:, idx].set(vl_t))
                alive = alive.at[tgt, idx].set(al_t)
                # emitted charge debited from the impacted surface
                # (uniform spread, mirroring the flat path)
                q_t = float(np.asarray(self.params.charge)[tgt])
                counter = counter - q_t * n_emit
                if tgt == s:        # emission altered this species' planes
                    lp, al = lpos[s][:, idx, :], alive[s][idx]
            g = jnp.mod(lp + origins.T[:, :, None], Lf[:, None, None])
            cell = jnp.clip(jnp.floor(g).astype(jnp.int32), 0,
                            Li[:, None, None] - 1)
            oid = obj.interior_id[cell[0], cell[1], cell[2]]
            absorbed = (al > 0.5) & (oid > 0)
            q = float(np.asarray(self.params.charge)[s])
            counter = counter + jax.ops.segment_sum(
                jnp.where(absorbed, q, 0.0).ravel(),
                jnp.where(absorbed, oid, 0).ravel(),
                num_segments=obj.n_objects + 1)
            alive = alive.at[s, idx].set(
                jnp.where(absorbed, 0.0, al))
        return (TiledState(lpos=lpos, vel=vel, alive=alive), counter,
                rho_add)

    def _spread_obj_charge(self, rho_obj, counter):
        """Spread per-object absorbed charge over surface nodes (the grid
        half of oCollectObjectCharge)."""
        obj = self.objects
        flat = rho_obj.ravel()
        for a in range(obj.n_objects):
            share = counter[a + 1] / float(len(obj.surface_idx[a]))
            flat = flat.at[jnp.asarray(obj.surface_idx[a])].add(
                share.astype(rho_obj.dtype))
        return flat.reshape(obj.shape)

    def _tiled_step_obj(self, st: TiledState, rho_obj: jax.Array):
        """Full step with the object feedback sequence (collect ->
        deposit -> rho+=rhoObj -> solve -> capacitance -> solve,
        src/main.c:222-240) on the tiled layout."""
        st = TiledState(lpos=st.lpos + st.vel, vel=st.vel, alive=st.alive)
        if not self.spec.periodic:
            st = self._reflect_walls(st)
        n_out = self._out_of_margin(st)
        st, counter, rho_add = self._absorb(st)
        rho_obj = self._spread_obj_charge(rho_obj, counter)
        if rho_add is not None:
            rho_obj = rho_obj + rho_add.reshape(self.objects.shape)
        rho = self._deposit_rho(st) + rho_obj
        phi = self.solver(rho)
        rho, obj_phi = self.objects.apply_capacitance(rho, phi)
        phi = self.solver(rho)              # 2nd solve (src/main.c:240)
        if self.spec.periodic:
            E = -gradient(phi)
        else:
            from .bc import gradient_bc
            E = -gradient_bc(phi, self.bc)
        st, ke = self._kick(st, E, half=False)
        pe = potential_energy(rho, phi)
        return (st, rho, phi, E,
                Diagnostics(kin_energy=ke, pot_energy=pe, n_lost=n_out),
                rho_obj, obj_phi)

    def _tiled_half_kick_obj(self, st: TiledState):
        """Initialization with objects: cull interior particles (charge
        discarded, src/main.c:161-166), then the ordinary half kick."""
        st, _, _ = self._absorb(st, collide=False)
        st, rho, phi, E, diag = self._tiled_half_kick(st)
        return st, rho, phi, E, diag

    def _particles(self, lpos, vel, alive, ts, field=None, e_scale=1.0,
                   **parts):
        """One particle pass (kick / drift / deposit, see
        ops.pallas_tiled.particle_pass) on the deck's route: the Triton
        kernel for tiles:backend=pallas, the XLA contraction route for
        xla.  lpos, vel (S, D, NT, B) and alive (S, NT, B) on tile spec
        ``ts``; field: padded E tiles (pad_tiles), already scaled by
        e_scale (0.5 for the initial half kick, which also halves the
        external field but not the magnetic rotation angle)."""
        e_ext = (None if self._e_ext is None
                 else tuple(e_scale * e for e in self._e_ext))
        charge = np.asarray(self.params.charge)
        kw = dict(charge=tuple(float(q) for q in charge),
                  qm=tuple(float(q) for q in
                           charge / np.asarray(self.params.mass)),
                  field=field, order_acc=self._acc_order,
                  order_distr=self._distr_order, e_ext=e_ext,
                  boris_T=self._boris_T, boris_S=self._boris_S, **parts)
        if self._backend == "pallas":
            from .ops import pallas_tiled as ptl
            return ptl.particle_pass(lpos, vel, alive, ts,
                                     interpret=backend.interpret(), **kw)
        return tl.particle_pass(lpos, vel, alive, ts,
                                gather=self._gather_mode, **kw)

    def _deposit_rho(self, st: TiledState) -> jax.Array:
        # all species deposit into one padded tile set, folded ONCE
        tiles = self._particles(st.lpos, st.vel, st.alive, self.ts,
                                deposit=True)[0]
        return tl.fold_to_global(tiles, self.ts).astype(self.spec.dtype)

    def _fields(self, st: TiledState):
        rho = self._deposit_rho(st)
        phi = self.solver(rho)
        if self.spec.periodic:
            E = -gradient(phi)
        else:
            from .bc import gradient_bc
            E = -gradient_bc(phi, self.bc)
        return rho, phi, E

    def _kick(self, st: TiledState, E: jax.Array, half: bool):
        """Velocity kick on the tile planes: gather E(x), add any external
        E, then either the electrostatic kick or the Boris rotation —
        same method routing as the flat path (puAcc*/puBoris3D1[KE],
        src/pusher.c:147-505).  half=True is the initialization half kick
        (src/main.c:184-186): the E *kick* halves (external E included)
        but the magnetic rotation angle does not."""
        e_scale = 0.5 if half else 1.0
        E_pad = e_scale * tl.pad_tiles(E, self.ts)
        _, _, vel, vdot, _ = self._particles(
            st.lpos, st.vel, st.alive, self.ts, field=E_pad,
            e_scale=e_scale, kick=True)
        ke = 0.5 * jnp.asarray(self.params.mass, jnp.float32) * vdot
        return TiledState(lpos=st.lpos, vel=vel, alive=st.alive), ke

    def _out_of_margin(self, st: TiledState) -> jax.Array:
        lo, hi = -float(self.ts.M), float(self.ts.T + self.ts.M)
        bad = (jnp.any((st.lpos < lo) | (st.lpos >= hi), axis=1)
               & (st.alive > 0.5))
        return jnp.sum(bad).astype(jnp.int32)

    def _tiled_half_kick(self, st: TiledState):
        rho, phi, E = self._fields(st)
        st, ke = self._kick(st, E, half=True)
        pe = potential_energy(rho, phi)
        return st, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=pe, n_lost=jnp.zeros((), jnp.int32))

    def _step_for_scan(self, st: TiledState):
        """Hook for make_scan_steps (the sharded subclass substitutes its
        sharded step)."""
        return self._tiled_step(st)

    def _reflect_walls(self, st: TiledState) -> TiledState:
        """Specular reflection at non-periodic global walls, on tile-local
        planes.  Deposits and gathers never cross a bounded wall (hat
        weights vanish one cell out, and reflection keeps every position
        in [0, L-1]), so the periodic tile machinery needs no other
        change: the wrap planes at bounded edges only ever carry zeros."""
        origins = tl.tile_origins(self.ts)            # (NT, D)
        lpos, vel = st.lpos, st.vel
        for d, bounded in enumerate(self._bounded_dims):
            if not bounded:
                continue
            hi = float(self.ts.grid[d] - 1)
            org = origins[:, d][None, :, None]        # (1, NT, 1)
            g = lpos[:, d] + org                      # (S, NT, B)
            period = 2.0 * hi
            g_m = jnp.mod(g, period)
            g_r = jnp.where(g_m > hi, period - g_m, g_m)
            flip = (jnp.floor(g / hi).astype(jnp.int32) % 2) != 0
            lpos = lpos.at[:, d].set(g_r - org)
            vel = vel.at[:, d].set(jnp.where(flip, -vel[:, d], vel[:, d]))
        return TiledState(lpos=lpos, vel=vel, alive=st.alive)

    def _tiled_step(self, st: TiledState):
        st = TiledState(lpos=st.lpos + st.vel, vel=st.vel, alive=st.alive)
        if not self.spec.periodic:
            st = self._reflect_walls(st)
        n_out = self._out_of_margin(st)
        rho, phi, E = self._fields(st)
        st, ke = self._kick(st, E, half=False)
        pe = potential_energy(rho, phi)
        return st, rho, phi, E, Diagnostics(kin_energy=ke, pot_energy=pe,
                                            n_lost=n_out)

    @property
    def _use_mega(self) -> bool:
        """Fused scan body (one particle pass per step: kick with the
        previous step's field, drift, deposit) for periodic decks without
        objects — bounded walls and object absorption hook in between
        move and deposit.  Scan path only: the kick uses the previous
        step's field (x-lagging leapfrog), so the per-step run() keeps
        the reference's in-step kick ordering."""
        return (self.spec.periodic and self.objects is None
                and self.cfg.get_bool("tiles:mega", True))

    def _flat_state(self, st: TiledState) -> TiledState:
        """Normalize to flat (S, D, NT, B) axes (the sharded subclass
        keeps tile-grid axes unflattened)."""
        S, D = st.lpos.shape[:2]
        B = st.lpos.shape[-1]
        return TiledState(lpos=st.lpos.reshape(S, D, -1, B),
                          vel=st.vel.reshape(S, D, -1, B),
                          alive=st.alive.reshape(S, -1, B))

    def _assert_invariants_tiled(self, st: TiledState, rho, n: int,
                                 max_vel: float) -> None:
        """methods:debug guards on the tiled state — the same invariants
        as Simulation._assert_invariants (pVelAssertMax /
        pPosAssertInLocalFrame / gAssertNeutralGrid,
        src/population.c:316-365, src/grid.c:862-869) without converting
        to the flat layout."""
        from .utils.logging import ERROR
        stf = self._flat_state(st)
        alive = np.asarray(stf.alive) > 0.5              # (S, NT, B)
        if max_vel > 0.0:
            vel = np.abs(np.asarray(stf.vel))            # (S, D, NT, B)
            vmax = float(vel.max(axis=1)[alive].max()) if alive.any() else 0.0
            if vmax > max_vel:
                msg(ERROR, "step %d: particle speed %g exceeds "
                    "population:maxVel=%g", n, vmax, max_vel)
        lo, hi = -float(self.ts.M), float(self.ts.T + self.ts.M)
        lpos = np.asarray(stf.lpos)
        bad = ((lpos < lo) | (lpos >= hi)).any(axis=1) & alive
        if bad.any():
            msg(ERROR, "step %d: %d particle(s) outside the tile margin "
                "[%g, %g)", n, int(bad.sum()), lo, hi)
        if self.spec.periodic and self.objects is None:
            rho_np = np.asarray(rho)
            mean = float(rho_np.mean())
            counts = alive.sum(axis=(1, 2))
            gross = float(np.sum(np.abs(np.asarray(self.params.charge))
                                 * counts)) / self.spec.global_volume + 1e-30
            if abs(mean) > 1e-4 * gross:
                msg(ERROR, "step %d: grid not charge-neutral (mean %g vs "
                    "gross charge density %g)", n, mean, gross)

    # ---------------------------------------------------------------- run
    def run(self, writer=None, progress_every: int = 10):
        import time
        t_start = time.monotonic()
        objects = self.objects is not None
        debug = self.cfg.get_bool("methods:debug", False)
        max_vel = self.cfg.get_double("population:maxvel", 0.0)
        obj_phi = None
        ke_hist, pe_hist = [], []
        if self._resumed:
            # velocities already staggered a half step behind positions in
            # the checkpoint; do not re-kick (mirrors Simulation.run)
            st = self.state
            rho_obj = (jnp.asarray(self.rho_obj) if objects else None)
        else:
            rho_obj = self.spec.zeros() if objects else None
            if objects:
                st, rho, phi, E, diag = self._thalf_obj_jit(self.state)
            else:
                st, rho, phi, E, diag = self._thalf_jit(self.state)
            ke_hist.append(np.asarray(diag.kin_energy))
            pe_hist.append(float(diag.pot_energy))
            if writer is not None:
                out = StepOutput(self.to_particles(st), rho, phi, E, diag,
                                 rho_obj=rho_obj)
                writer.write_step(0, out)
                writer.write_energy(0, ke_hist[0], pe_hist[0])
        for n in range(self.start_step + 1, self.n_time_steps + 1):
            if objects:
                (st, rho, phi, E, diag, rho_obj,
                 obj_phi) = self._tstep_obj_jit(st, rho_obj)
            else:
                st, rho, phi, E, diag = self._tstep_jit(st)
            # scheduled per-species re-bucket, or adaptive early one when
            # particles hit the margin (charge withheld for that one step)
            due = tuple(s for s, R in enumerate(self.rebucket_every_s)
                        if n % R == 0)
            if int(diag.n_lost):
                msg(WARNING, "step %d: %d particle(s) reached the tile "
                    "margin; re-bucketing early", n, int(diag.n_lost))
                due = tuple(range(st.lpos.shape[0]))
            if due:
                st, dropped = self._rebucket_jit(st, species=due)
                if int(dropped):
                    msg(WARNING, "step %d: %d particle(s) dropped by bucket "
                        "overflow (raise tiles:slack)", n, int(dropped))
                # adaptive protection for heating decks: any drop or
                # margin hit re-estimates the cadences/caps from the
                # CURRENT velocities so the schedule tracks the tail
                if int(dropped) or int(diag.n_lost):
                    self.retune(st, drops=int(dropped))
            ke = np.asarray(diag.kin_energy)
            pe = float(diag.pot_energy)
            ke_hist.append(ke)
            pe_hist.append(pe)
            if writer is not None:
                out = StepOutput(self.to_particles(st), rho, phi, E, diag,
                                 rho_obj=rho_obj, obj_potential=obj_phi)
                writer.write_step(n, out)
                writer.write_energy(n, ke, pe)
            if debug:
                self._assert_invariants_tiled(st, rho, n, max_vel)
            if self.checkpoint_every and n % self.checkpoint_every == 0:
                from . import checkpoint as _ckpt
                _ckpt.save_tiled(self.cfg, n, self._flat_state(st), rho_obj)
            if progress_every and n % progress_every == 0:
                msg(STATUS, "Computing time-step %i (KE=%g PE=%g)",
                    n, ke.sum(), pe)
        jax.block_until_ready(st.lpos)
        wall = time.monotonic() - t_start
        from .utils.logging import TIMER
        msg(TIMER, "Time spent: %f s (%d steps)", wall, self.n_time_steps)
        self.state = st
        self.particles = self.to_particles(st)
        if objects:
            self.last_rho_obj = rho_obj
            self.last_obj_potential = obj_phi
        if self.checkpoint_every:
            from . import checkpoint as _ckpt
            _ckpt.save_tiled(self.cfg, self.n_time_steps,
                             self._flat_state(st), rho_obj)
        ke_arr = (np.stack(ke_hist) if ke_hist
                  else np.zeros((0, st.lpos.shape[0])))
        return {"kinetic": ke_arr, "potential": np.asarray(pe_hist),
                "wall_time": wall}

    def _rebucket_schedule(self, n: int):
        """step -> species due, from the per-species cadences."""
        events = {}
        for s, R in enumerate(self.rebucket_every_s):
            for k in range(R, n + 1, R):
                events.setdefault(k, []).append(s)
        return events

    def _scan_with_rebuckets(self, body, carry, n: int):
        """Run ``n`` scan steps of ``body`` (tuple carry whose first leaf
        is the TiledState) with the per-species re-bucket schedule applied
        between segments — always STATIC, never a lax.cond copying the
        GB-sized state.

        When the cadences are uniform or nested (the slow cadence a
        multiple of the fast one — the electron/ion case), the segments
        roll into nested lax.scans so the compiled program holds O(1)
        copies of the step instead of O(n / cadence): at n=500 steps of
        the bench deck this is 3 step instantiations instead of 52."""
        tree = jax.tree_util
        Rs = list(self.rebucket_every_s)
        dropped = jnp.zeros((), jnp.int32)
        outs = []

        def reb(carry, species):
            st2, d = self._rebucket(carry[0], species=tuple(species))
            return (st2,) + tuple(carry[1:]), d

        distinct = sorted(set(Rs))
        fast = [s for s, R in enumerate(Rs) if R == distinct[0]]
        slow = [s for s, R in enumerate(Rs) if R != distinct[0]]
        Re = distinct[0]
        Ri = distinct[-1]
        nested = (len(distinct) <= 2 and Ri % Re == 0 and n >= 2 * Re)
        done = 0
        if nested:
            def mid_body(c, _):
                c, out = jax.lax.scan(body, c, None, length=Re)
                c, d = reb(c, fast)
                return c, (out, d)

            def outer_body(c, _):
                c, (out, d) = jax.lax.scan(mid_body, c, None,
                                           length=Ri // Re)
                dd = jnp.sum(d)
                if slow:
                    c, d2 = reb(c, slow)
                    dd = dd + d2
                return c, (out, dd)

            n_outer = n // Ri if slow else 0
            if n_outer:
                carry, (out, d) = jax.lax.scan(outer_body, carry, None,
                                               length=n_outer)
                outs.append(tree.tree_map(
                    lambda a: a.reshape((n_outer * Ri,) + a.shape[3:]),
                    out))
                dropped = dropped + jnp.sum(d)
                done = n_outer * Ri
            n_mid = (n - done) // Re
            if n_mid:
                carry, (out, d) = jax.lax.scan(mid_body, carry, None,
                                               length=n_mid)
                outs.append(tree.tree_map(
                    lambda a: a.reshape((n_mid * Re,) + a.shape[2:]), out))
                dropped = dropped + jnp.sum(d)
                done += n_mid * Re
        # flat tail, and the general non-nested case
        events = {k: v for k, v in self._rebucket_schedule(n).items()
                  if k > done}
        if not nested and len(events) > 64:    # bound program size
            events = {k: list(range(len(Rs)))
                      for k in range(self.rebucket_every, n + 1,
                                     self.rebucket_every) if k > done}
        prev = done
        for k in sorted(set(events) | {n}):
            if k > n:
                break
            if k > prev:
                carry, out = jax.lax.scan(body, carry, None,
                                          length=k - prev)
                outs.append(out)
                prev = k
            for sp in events.get(k, []):
                carry, d = reb(carry, (sp,))
                dropped = dropped + d
        out = tree.tree_map(lambda *xs: jnp.concatenate(xs), *outs)
        return carry, out, dropped

    def make_scan_steps(self, n: int, donate: bool = False):
        """n steps with in-loop per-species rebucketing (see
        _scan_with_rebuckets for the segment/nesting structure).
        donate=True consumes the state argument (for GB-scale states
        whose caller will not reuse them, e.g. bench.py)."""
        if self.objects is not None:
            return self._make_scan_steps_obj(n, donate)
        if self._use_mega:
            return self._make_scan_steps_mega(n, donate)

        def body(carry, _):
            st, rho, phi, E, diag = self._step_for_scan(carry[0])
            return (st,), (diag.kin_energy, diag.pot_energy)

        def run_n(st, rho_obj=None):
            carry, (ke, pe), dropped = self._scan_with_rebuckets(
                body, (st,), n)
            return carry[0], (ke, pe, dropped)
        return _jit_maybe_donate(run_n, donate)

    def _make_scan_steps_obj(self, n: int, donate: bool = False):
        """Scan driver for tiled object decks: the full object feedback
        sequence (absorb -> deposit+rho_obj -> solve -> capacitance ->
        solve, src/main.c:222-240) per scan slot, with the absorbed
        object charge density riding the carry.  Removes the per-step
        host dispatch of run() for long spacecraft-charging runs."""
        def body(carry, _):
            st, rho_obj = carry
            (st, rho, phi, E, diag, rho_obj,
             obj_phi) = self._tiled_step_obj(st, rho_obj)
            return (st, rho_obj), (diag.kin_energy, diag.pot_energy,
                                   obj_phi)

        def run_n(st, rho_obj=None):
            if rho_obj is None:
                rho_obj = self.spec.zeros()
            carry, (ke, pe, obj_phi), dropped = self._scan_with_rebuckets(
                body, (st, rho_obj), n)
            return carry, (ke, pe, dropped, obj_phi)

        return _jit_maybe_donate(run_n, donate)

    def _make_scan_steps_mega(self, n: int, donate: bool = False):
        """Scan driver over the fused step: kick v with the PREVIOUS
        step's field, drift, deposit — one particle pass + one field
        solve per step; the padded field tiles ride the scan carry.
        Both orderings are the same leapfrog trajectory; here the (ke, pe)
        pair emitted at scan slot k is centered on step k-1, with the
        window-start solve supplying the first pe."""
        ts = self.ts
        mass_j = jnp.asarray(np.asarray(self.params.mass), jnp.float32)

        def body(carry, _):
            st, e_pad, pe_prev = carry
            tiles, lpos, vel, vdot, _ = self._particles(
                st.lpos, st.vel, st.alive, ts, field=e_pad, kick=True,
                drift=True, deposit=True)
            rho = tl.fold_to_global(tiles, ts).astype(self.spec.dtype)
            phi = self.solver(rho)
            pe = potential_energy(rho, phi)
            st2 = TiledState(lpos=lpos, vel=vel, alive=st.alive)
            return ((st2, tl.pad_tiles(-gradient(phi), ts), pe),
                    (0.5 * mass_j * vdot, pe_prev))

        def run_n(st, rho_obj=None):
            rho0, phi0, E0 = self._fields(st)
            carry = (st, tl.pad_tiles(E0, ts), potential_energy(rho0, phi0))
            carry, (ke, pe), dropped = self._scan_with_rebuckets(
                body, carry, n)
            return carry[0], (ke, pe, dropped)

        return _jit_maybe_donate(run_n, donate)
