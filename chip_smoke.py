"""Smoke test of the PIC main path on NVIDIA GPUs.

Run from the root of the repository, one process for all cards:

    python chip_smoke.py               # one GPU: phases 1-6
    python chip_smoke.py --multichip   # four GPUs: the sharded decks only

Phases on one GPU:

1. platform  — JAX sees a GPU; there is no CPU fallback.
2. kernels   — the Triton particle kernel against the XLA route at HIGHEST
               precision on the bench deck's bucketed state (128^3, 2 x 32
               particles per cell, T = 8), for the full step pass, a
               deposit-only NGP pass and a Boris + external-E kick pass.
3. exchange  — the exchange re-bucket against the sort re-bucket on the
               same drifted state: the same particles, no drops.
4. main      — the bench deck (input/bench_maxwellian.ini) through
               parallel.pic.make_simulation, one scan window long enough
               to re-bucket every species: finite energies, no drops,
               alive count conserved, bounded energy drift.
5. layouts   — flat and tiled layouts on the same 64^3 deck agree.
6. cli       — ``python -m pinc_tpu input/maxwellian.ini`` in-process on
               one device (flat layout, multigrid), and the FFT and MG
               solvers on the sine fixture (FFT at 128^3 against the
               analytic solution, MG V-cycles at 128^3 and 32^3).

With --multichip: ShardedSimulation on input/langmuirCold.ini (halo,
migration, sharded multigrid) and ShardedTiledSimulation on
input/bench_scaleout.ini at 128^3 per card, each against the same deck on
one device of the same process.

Every check raises on failure, so the exit code is nonzero and the result
line is not printed.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent
EPS = 2.0 ** -23          # f32 unit roundoff (ulp of 1)


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def compile_timed(name, jitted, *args):
    """Compile ``jitted`` for ``args``; log and return (compiled, seconds)."""
    t0 = time.monotonic()
    compiled = jitted.lower(*args).compile()
    dt = time.monotonic() - t0
    log(f"  [{name}] compile {dt:.2f} s")
    return compiled, dt


def run_timed(name, fn, *args, reps=1):
    """Run ``fn`` ``reps`` times; log the fastest wall time, return the
    last output."""
    import jax
    best = math.inf
    out = None
    for _ in range(reps):
        t0 = time.monotonic()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.monotonic() - t0)
    log(f"  [{name}] run {best * 1e3:.3f} ms (best of {reps})")
    return out, best


def load_deck(path, overrides=()):
    from pinc_tpu.config import PincConfig
    return PincConfig.from_file(str(REPO / path), list(overrides))


# --------------------------------------------------------------- phase 1
def phase_platform(expect="gpu"):
    import jax
    devs = jax.devices()
    check(devs[0].platform == expect,
          f"JAX platform is {devs[0].platform!r}, expected {expect!r}")
    return devs


def print_environment(devs):
    import jax
    import jaxlib
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    log(f"device_kind {devs[0].device_kind!r} count {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")


# --------------------------------------------------------------- phase 2
def _pass_fns(ts, interpret, **kw):
    import jax
    from pinc_tpu.ops import pallas_tiled as ptl
    from pinc_tpu.ops import tiled as tl
    kern = jax.jit(partial(ptl.particle_pass, ts=ts, interpret=interpret,
                           **kw))
    ref = jax.jit(partial(tl.particle_pass, ts=ts, **kw))
    return kern, ref


def phase_kernels(sim, interpret=False, reps=3):
    """Kernel vs XLA route on the same bucketed state.  Tolerances:

    * deposit, per node of the padded tiles: |drho| <= n eps (sum|q w| +
      max|q|) with n = 1024 — the worst-case error of a reordered f32 sum
      of n terms (atomics add in a run-dependent order; a node collects
      from the particles of its 8 neighbouring cells, ~512 at 2 x 32 per
      cell), plus the weights' own rounding, which is absolute (the
      reference's hat weight 1 - (1 - f) carries an error of eps, not
      eps * f);
    * total charge: the kernel's and the reference's node sums agree with
      each other and with sum(q * alive) to 1e-6 of sum|q| * alive;
    * positions and velocities: 8 ulps of the plane's largest magnitude
      (the gathered field differs only in the order of 8 corner terms);
    * vdot per species: 1e-5 relative (a 67M-term sum in two orders);
    * out-of-margin counts: equal up to max(2, 1e-6 N) particles whose
      position sits within an ulp of the margin."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pinc_tpu.ops import tiled as tl

    ts, st = sim.ts, sim.state
    S = st.lpos.shape[0]
    charge = tuple(float(q) for q in np.asarray(sim.params.charge))
    qm = tuple(float(c / m) for c, m in
               zip(charge, np.asarray(sim.params.mass)))
    _, _, E = jax.jit(sim._fields)(st)
    field = tl.pad_tiles(E, ts)
    n_alive = np.asarray(jnp.sum(st.alive > 0.5, axis=(1, 2)), np.float64)
    q_gross = float(np.sum(np.abs(charge) * n_alive))
    q_net = float(np.sum(np.asarray(charge) * n_alive))
    bT = 0.5 * np.asarray(qm)[:, None] * np.asarray([0.05, 0.02, 0.1])
    bS = 2.0 * bT / (1.0 + np.sum(bT * bT, axis=1, keepdims=True))
    variants = {
        "step": dict(kick=True, drift=True, deposit=True),
        "deposit_ngp": dict(deposit=True, order_distr=0),
        "kick_boris_eext": dict(kick=True, e_ext=(1e-3, -2e-3, 5e-4),
                                boris_T=bT, boris_S=bS),
    }
    times = {}
    failures = []

    def verify(cond, what):
        if not cond:
            failures.append(what)
            log(f"  FAILED: {what}")

    for name, flags in variants.items():
        kern, ref = _pass_fns(ts, interpret, charge=charge, qm=qm,
                              field=field, **flags)
        ck, _ = compile_timed(f"kernel {name}", kern, st.lpos, st.vel,
                              st.alive)
        cr, _ = compile_timed(f"xla {name}", ref, st.lpos, st.vel,
                              st.alive)
        out_k, tk = run_timed(f"kernel {name}", ck, st.lpos, st.vel,
                              st.alive, reps=reps)
        out_r, tr = run_timed(f"xla {name}", cr, st.lpos, st.vel, st.alive,
                              reps=reps)
        times[name] = (tk, tr)
        tiles_k, lp_k, v_k, vd_k, no_k = out_k
        tiles_r, lp_r, v_r, vd_r, no_r = out_r
        if flags.get("deposit"):
            gross = jax.jit(partial(
                tl.particle_pass, ts=ts, deposit=True,
                charge=tuple(abs(q) for q in charge),
                order_distr=flags.get("order_distr", 1)))(
                    lp_r, st.vel, st.alive)[0]          # deposit positions
            qmax = max(abs(q) for q in charge)
            ratio = float(jnp.max(jnp.abs(tiles_k - tiles_r)
                                  / (EPS * (gross + qmax))))
            log(f"  {name}: max |drho| = {ratio:.1f} eps (sum|qw| + max|q|)"
                f" (limit 1024)")
            verify(ratio <= 1024.0, f"{name}: deposit mismatch {ratio}")
            sk = float(np.sum(np.asarray(tiles_k, np.float64)))
            sr = float(np.sum(np.asarray(tiles_r, np.float64)))
            log(f"  {name}: total charge kernel {sk:.6e} xla {sr:.6e} "
                f"exact {q_net:.6e} (gross {q_gross:.6e})")
            verify(abs(sk - sr) <= 1e-6 * q_gross
                   and abs(sk - q_net) <= 1e-6 * q_gross,
                   f"{name}: total charge mismatch")
        for label, a, b, on in (("x", lp_k, lp_r, flags.get("drift")),
                                ("v", v_k, v_r, flags.get("kick"))):
            if not on:
                continue
            live = (st.alive > 0.5)[:, None]
            scale = float(jnp.max(jnp.where(live, jnp.abs(b), 0.0)))
            ulps = float(jnp.max(jnp.where(live, jnp.abs(a - b), 0.0))
                         ) / (EPS * scale)
            log(f"  {name}: max |d{label}| = {ulps:.2f} ulp of "
                f"max|{label}| = {scale:.4g} (limit 8)")
            verify(ulps <= 8.0, f"{name}: {label} mismatch {ulps} ulp")
        if flags.get("kick"):
            rel = np.abs(np.asarray(vd_k) - np.asarray(vd_r)) / np.abs(
                np.asarray(vd_r))
            log(f"  {name}: vdot kernel {np.asarray(vd_k)} xla "
                f"{np.asarray(vd_r)} (max rel {rel.max():.2e}, limit 1e-5)")
            verify(rel.max() <= 1e-5, f"{name}: vdot mismatch")
        if flags.get("drift"):
            dn = np.abs(np.asarray(no_k) - np.asarray(no_r))
            lim = max(2.0, 1e-6 * float(n_alive.sum()))
            log(f"  {name}: n_out kernel {np.asarray(no_k)} xla "
                f"{np.asarray(no_r)}")
            verify(dn.max() <= lim, f"{name}: n_out mismatch")
        del out_k, out_r
    for name, (tk, tr) in times.items():
        log(f"  {name}: kernel {tk * 1e3:.3f} ms, xla {tr * 1e3:.3f} ms "
            f"({S} species, {ts.NT} tiles x {ts.B} slots)")
    check(not failures, "; ".join(failures))
    return times


# --------------------------------------------------------------- phase 3
def phase_exchange(sim, steps=None, reps=3):
    """Exchange vs sort re-bucket of every species after ``steps`` drift
    steps (default: the fastest species' cadence).  Velocities pass
    through both unchanged, so the sorted velocity triples of the live
    particles must agree bitwise; positions, paired through that sort,
    agree to 4 ulps of the grid extent (frame shifts round differently)."""
    import jax
    import jax.numpy as jnp
    from pinc_tpu.ops import tiled as tl
    from pinc_tpu.ops.exchange import rebucket_exchange

    ts = sim.ts
    D = ts.n_dims
    steps = steps or min(sim.rebucket_every_s)
    st = sim.state
    lpos = st.lpos + steps * st.vel * (st.alive[:, None] > 0.5)
    L = jnp.asarray(ts.grid, jnp.float32)

    def exchange(lp, v, al):
        planes = tuple(lp[d] for d in range(D)) + tuple(v[d]
                                                        for d in range(D))
        planes, al, dropped = rebucket_exchange(
            planes, al, ts.ntiles, ts.T, K=sim._exchange_cap)
        return jnp.stack(planes[:D]), jnp.stack(planes[D:]), al, dropped

    def sort(lp, v, al):
        g = tl.global_positions(jnp.moveaxis(lp, 0, -1), ts).reshape(-1, D)
        lp2, v2, al2, dropped = tl.bucket(g, v.reshape(D, -1).T,
                                          al.reshape(-1) > 0.5, ts)
        return (jnp.moveaxis(lp2, -1, 0), jnp.moveaxis(v2, -1, 0),
                al2.astype(jnp.float32), dropped)

    def canon(lp, v, al):
        """Live particles sorted by velocity triple: (v (N,D), g (N,D)),
        dead slots last."""
        g = jnp.moveaxis(tl.global_positions(jnp.moveaxis(lp, 0, -1), ts),
                         -1, 0).reshape(D, -1)
        live = al.reshape(-1) > 0.5
        big = jnp.float32(jnp.inf)
        keys = tuple(jnp.where(live, v[d].reshape(-1), big)
                     for d in range(D))
        out = jax.lax.sort(keys + tuple(g), num_keys=D)
        return jnp.stack(out[:D]), jnp.stack(out[D:])

    @jax.jit
    def compare(a, b):
        va, ga = canon(*a[:3])
        vb, gb = canon(*b[:3])
        n = jnp.sum(a[2] > 0.5)
        same_v = jnp.all(va == vb)
        dg = jnp.abs(ga - gb)
        dg = jnp.minimum(dg, L[:, None] - dg)      # periodic distance
        dg = jnp.where(jnp.isfinite(va[:1]), dg, 0.0)
        return n, jnp.sum(b[2] > 0.5), same_v, jnp.max(dg)

    ex = jax.jit(exchange)
    so = jax.jit(sort)
    times = {}
    for s in range(st.lpos.shape[0]):
        args = (lpos[s], st.vel[s], st.alive[s])
        ce, _ = compile_timed(f"exchange species {s}", ex, *args)
        cs, _ = compile_timed(f"sort species {s}", so, *args)
        a, te = run_timed(f"exchange species {s}", ce, *args, reps=reps)
        b, tsrt = run_timed(f"sort species {s}", cs, *args, reps=reps)
        times[s] = (te, tsrt)
        n_a, n_b, same_v, dg = (x.item() for x in compare(a, b))
        n0 = int(jnp.sum(args[2] > 0.5))
        log(f"  species {s}: alive {n0} -> exchange {n_a} sort {n_b}, "
            f"dropped {int(a[3])}/{int(b[3])}, velocities equal {same_v}, "
            f"max |dx| {dg:.3g} (limit {4 * EPS * max(ts.grid):.3g})")
        check(int(a[3]) == 0 and int(b[3]) == 0, "re-bucket dropped")
        check(n_a == n_b == n0, "re-bucket lost particles")
        check(bool(same_v), "exchange and sort disagree on velocities")
        check(dg <= 4 * EPS * max(ts.grid), "exchange and sort disagree "
              "on positions")
        lp_x = a[0]
        live = a[2] > 0.5
        check(bool(jnp.all(jnp.where(live[None], (lp_x >= 0)
                                     & (lp_x < ts.T), True))),
              "exchange left a particle outside its tile")
        del a, b
    for s, (te, tsrt) in times.items():
        log(f"  species {s}: exchange {te * 1e3:.3f} ms, sort "
            f"{tsrt * 1e3:.3f} ms")
    return times


# --------------------------------------------------------------- phase 4
def phase_main(sim, steps=None, drift_limit=1e-2):
    """One scan window of the bench deck long enough to re-bucket every
    species (the slowest cadence).  Energy drift: |E_end - E_0| / E_0
    over the window (E = KE + PE per emitted step)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    steps = steps or max(sim.rebucket_every_s)
    log(f"  window {steps} steps, cadences {sim.rebucket_every_s}, "
        f"bucket {sim.ts.B}, margin {sim.ts.M}, route {sim._backend}")
    st = sim.state
    sim.state = None
    n0 = int(jnp.sum(st.alive > 0.5))
    run_n = sim.make_scan_steps(steps, donate=True)
    compiled, _ = compile_timed("scan window", run_n, st)
    mem = compiled.memory_analysis()
    if mem is not None:
        log(f"  memory_analysis: argument {mem.argument_size_in_bytes} "
            f"output {mem.output_size_in_bytes} temp "
            f"{mem.temp_size_in_bytes} bytes")
    (st, (ke, pe, dropped)), wall = run_timed("scan window", compiled, st)
    ke = np.asarray(ke, np.float64)
    pe = np.asarray(pe, np.float64)
    n1 = int(jnp.sum(st.alive > 0.5))
    tot = ke.sum(axis=1) + pe
    drift = abs(tot[-1] - tot[0]) / abs(tot[0])
    log(f"  {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.3f} ms/step,"
        f" {n0 * steps / wall:.4e} particle-steps/s")
    log(f"  particles {n0} -> {n1}, dropped {int(dropped)}, "
        f"E0 {tot[0]:.6e} E_end {tot[-1]:.6e} drift {drift:.3e} "
        f"(limit {drift_limit:g})")
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        log(f"  peak_bytes_in_use {stats['peak_bytes_in_use']}")
    check(np.isfinite(ke).all() and np.isfinite(pe).all(),
          "non-finite energies")
    check(int(dropped) == 0, f"{int(dropped)} particles dropped")
    check(n1 == n0, f"alive count changed {n0} -> {n1}")
    check(drift <= drift_limit, f"energy drift {drift:.3e}")
    sim.state = st
    return wall / steps


def bench_sim(overrides=()):
    from pinc_tpu.parallel.pic import make_simulation
    t0 = time.monotonic()
    sim = make_simulation(load_deck("input/bench_maxwellian.ini",
                                    overrides), seed=1)
    log(f"  setup {type(sim).__name__}: {int(sim.state.alive.sum())} "
        f"particles, {sim.ts.NT} tiles x {sim.ts.B} slots "
        f"({time.monotonic() - t0:.1f} s)")
    return sim


# --------------------------------------------------------------- phase 5
def phase_layouts(grid_n=64, ppc=16, steps=10, ke_tol=1e-3, pe_tol=1e-2):
    """Flat vs tiled run() of the same deck.  Tolerances: KE to ke_tol of
    its largest value, PE to pe_tol of its largest value (float order
    differs between the scatter-add and the tiled deposit; PE is the
    small, noise-dominated part of a warm plasma's energy)."""
    import numpy as np
    from pinc_tpu.parallel.pic import make_simulation
    base = [f"grid:trueSize={grid_n},{grid_n},{grid_n}",
            f"population:nParticles={ppc} pc",
            f"population:nAlloc={ppc} pc", f"time:nTimeSteps={steps}"]
    hist = {}
    for layout in ("flat", "tiled"):
        sim = make_simulation(load_deck("input/bench_maxwellian.ini",
                                        base + [f"methods:layout={layout}"]),
                              seed=3)
        t0 = time.monotonic()
        hist[layout] = sim.run(progress_every=0)
        counts = np.asarray(sim.particles.counts())
        log(f"  {layout}: {type(sim).__name__} {steps} steps "
            f"{time.monotonic() - t0:.2f} s, counts {counts.tolist()}")
        hist[layout]["counts"] = counts
    f, t = hist["flat"], hist["tiled"]
    ke_f, ke_t = f["kinetic"].sum(axis=1), t["kinetic"].sum(axis=1)
    dke = np.abs(ke_f - ke_t).max() / np.abs(ke_f).max()
    dpe = np.abs(f["potential"] - t["potential"]).max() / np.abs(
        f["potential"]).max()
    log(f"  max dKE {dke:.2e} (limit {ke_tol:g}), max dPE {dpe:.2e} "
        f"(limit {pe_tol:g})")
    check(np.isfinite(ke_t).all(), "tiled energies not finite")
    check((f["counts"] == t["counts"]).all(), "particle counts differ")
    check(dke <= ke_tol and dpe <= pe_tol, "flat and tiled disagree")
    return dke, dpe


# --------------------------------------------------------------- phase 6
def phase_cli(steps=15):
    """The CLI in-process on input/maxwellian.ini on one device (flat
    layout, multigrid), without HDF5 output."""
    import numpy as np
    import tempfile
    from pinc_tpu.__main__ import main as cli_main

    text = (REPO / "input/maxwellian.ini").read_text()
    text = re.sub(r"(?m)^output\s*=.*$", "", text)   # no h5py needed
    with tempfile.TemporaryDirectory() as tmp:
        deck = Path(tmp) / "maxwellian.ini"
        deck.write_text(text)
        err = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stderr(err):
            rc = cli_main([str(deck), "grid:nSubdomains=1,1,1",
                           f"time:nTimeSteps={steps}"])
        dt = time.monotonic() - t0
    lines = err.getvalue().splitlines()
    energies = [tuple(map(float, m.groups())) for m in
                (re.search(r"KE=(\S+) PE=(\S+)\)", ln) for ln in lines)
                if m]
    log(f"  cli rc {rc} in {dt:.2f} s; last: {lines[-1] if lines else ''}")
    log(f"  progress energies {energies}")
    check(rc == 0, f"CLI returned {rc}")
    check(energies and np.isfinite(energies).all(),
          "CLI printed no finite energies")
    return energies


def phase_solvers(grid_n=128, mg_n=32, reps=5):
    """FFT (spectral, continuum Laplacian) at grid_n^3 against the
    analytic solution of fill_sin to 1e-4 rms relative.  Multigrid
    (5 levels, 3+3 red-black sweeps, 15 V-cycles): against the FD
    spectral solution to 5e-3 at mg_n^3, where it converges; at grid_n^3
    the time of one V-cycle, and the error must fall from 1 to 15 cycles
    (the lowest sine mode converges slowly there — see PERF.md)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pinc_tpu.grid import BndType, GridSpec, fill_sin
    from pinc_tpu.solvers.multigrid import MultigridSolver
    from pinc_tpu.solvers.spectral import SpectralSolver

    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))

    def problem(n):
        spec = GridSpec(n_dims=3, true_size=(n,) * 3,
                        n_subdomains=(1, 1, 1),
                        boundaries=(BndType.PERIODIC,) * 6)
        rho_np, phi_exact = fill_sin(spec)
        fd = np.asarray(jax.jit(SpectralSolver(spec.global_size, fd=True))(
            jnp.asarray(rho_np, jnp.float32)))
        return spec, jnp.asarray(rho_np, jnp.float32), phi_exact, fd

    def mg(spec, cycles):
        return jax.jit(MultigridSolver(spec.global_size, n_levels=5,
                                       n_pre=3, n_post=3, n_coarse=8,
                                       max_cycles=cycles, tol=0.0))

    def mg_err(spec, rho, fd, cycles):
        phi = np.asarray(mg(spec, cycles)(rho))
        return rms(phi - phi.mean() - fd) / rms(fd)

    spec, rho, phi_exact, fd = problem(grid_n)
    fft, _ = compile_timed("fft", jax.jit(SpectralSolver(
        spec.global_size, fd=False)), rho)
    phi, t_fft = run_timed("fft", fft, rho, reps=reps)
    err = rms(np.asarray(phi) - phi_exact) / rms(phi_exact)
    log(f"  fft {grid_n}^3: {t_fft * 1e3:.3f} ms, rms error {err:.2e} "
        f"(limit 1e-4)")
    check(err < 1e-4, "FFT solve inaccurate")
    vcycle, _ = compile_timed("mg v-cycle", mg(spec, 1), rho)
    _, t_v = run_timed("mg v-cycle", vcycle, rho, reps=reps)
    e1, e15 = mg_err(spec, rho, fd, 1), mg_err(spec, rho, fd, 15)
    log(f"  mg {grid_n}^3: one V-cycle {t_v * 1e3:.3f} ms; error vs FD "
        f"after 1 cycle {e1:.3e}, after 15 {e15:.3e}")
    check(np.isfinite(e15) and e15 < e1, "MG does not converge")
    spec, rho, _, fd = problem(mg_n)
    e = mg_err(spec, rho, fd, 15)
    log(f"  mg {mg_n}^3: error vs FD after 15 cycles {e:.2e} (limit 5e-3)")
    check(e < 5e-3, "MG solve inaccurate")
    return t_fft, t_v


# ------------------------------------------------------------ multichip
def _energy_match(h1, hN, what, ke_tol, pe_tol):
    import numpy as np
    ke1, keN = h1["kinetic"].sum(axis=1), hN["kinetic"].sum(axis=1)
    dke = np.abs(ke1 - keN).max() / np.abs(ke1).max()
    dpe = np.abs(h1["potential"] - hN["potential"]).max() / max(
        np.abs(h1["potential"]).max(), 1e-30)
    log(f"  {what}: max dKE {dke:.2e} (limit {ke_tol:g}), max dPE "
        f"{dpe:.2e} (limit {pe_tol:g})")
    check(np.isfinite(keN).all(), f"{what}: non-finite energies")
    check(dke <= ke_tol and dpe <= pe_tol, f"{what}: energies disagree")


def phase_sharded_flat(devices, steps=10, overrides=()):
    """ShardedSimulation on langmuirCold.ini vs the same deck on one
    device: energies to 1e-3 (KE) / 1e-2 (PE, relative to its largest
    value) and identical particle counts."""
    import numpy as np
    from pinc_tpu.parallel.pic import ShardedSimulation, make_simulation
    from pinc_tpu.simulation import Simulation

    common = [f"time:nTimeSteps={steps}"] + list(overrides)
    cfgN = load_deck("input/langmuirCold.ini", common)
    simN = make_simulation(cfgN, seed=1, devices=devices)
    check(isinstance(simN, ShardedSimulation), "expected ShardedSimulation")
    sub = ",".join("1" for _ in cfgN.get_int_arr("grid:nsubdomains", 3))
    true_n = [t * n for t, n in zip(cfgN.get_int_arr("grid:truesize", 3),
                                    cfgN.get_int_arr("grid:nsubdomains", 3))]
    cfg1 = load_deck("input/langmuirCold.ini", common + [
        f"grid:nSubdomains={sub}",
        "grid:trueSize=" + ",".join(map(str, true_n))])
    sim1 = Simulation(cfg1, seed=1)
    t0 = time.monotonic()
    hN = simN.run(progress_every=0)
    tN = time.monotonic() - t0
    t0 = time.monotonic()
    h1 = sim1.run(progress_every=0)
    t1 = time.monotonic() - t0
    cN = np.asarray(simN.particles.counts()).sum()
    c1 = np.asarray(sim1.particles.counts()).sum()
    log(f"  langmuirCold: {len(devices)} devices {tN:.2f} s, one device "
        f"{t1:.2f} s, particles {cN} vs {c1}")
    check(cN == c1, "particle counts differ")
    _energy_match(h1, hN, "langmuirCold", 1e-3, 1e-2)


def phase_sharded_tiled(devices, local=128, ppc=32, steps=None,
                        overrides=()):
    """ShardedTiledSimulation on bench_scaleout.ini at ``local``^3 per
    device (exchange re-bucket across devices) vs the same global deck on
    one device: scan energies to 1e-3 (KE) / 1e-2 (PE), no drops, equal
    particle counts."""
    import jax.numpy as jnp
    import numpy as np
    from pinc_tpu.parallel.tiled_pic import ShardedTiledSimulation
    from pinc_tpu.tiled_sim import TiledSimulation

    n = len(devices)
    nsub = (1, 2, 2) if n == 4 else (1, 1, n)
    common = [f"population:nParticles={ppc} pc",
              f"population:nAlloc={ppc} pc"] + list(overrides)
    cfgN = load_deck("input/bench_scaleout.ini", common + [
        "grid:nSubdomains=" + ",".join(map(str, nsub)),
        f"grid:trueSize={local},{local},{local}"])
    cfg1 = load_deck("input/bench_scaleout.ini", common + [
        "grid:nSubdomains=1,1,1",
        "grid:trueSize=" + ",".join(str(local * k) for k in nsub)])
    results = {}
    for label, make in (
            ("sharded", lambda: ShardedTiledSimulation(cfgN, seed=1,
                                                       devices=devices)),
            ("one device", lambda: TiledSimulation(cfg1, seed=1))):
        t0 = time.monotonic()
        sim = make()
        st = sim.state
        sim.state = None
        n0 = int(jnp.sum(st.alive > 0.5))
        w = steps or 2 * min(sim.rebucket_every_s)
        log(f"  {label}: setup {time.monotonic() - t0:.1f} s, {n0} "
            f"particles, window {w} steps, cadences {sim.rebucket_every_s}")
        run_n = sim.make_scan_steps(w, donate=True)
        compiled, _ = compile_timed(f"{label} scan", run_n, st)
        (st, (ke, pe, dropped)), wall = run_timed(f"{label} scan",
                                                  compiled, st)
        n1 = int(jnp.sum(st.alive > 0.5))
        log(f"  {label}: {wall / w * 1e3:.3f} ms/step, "
            f"{n0 * w / wall:.4e} particle-steps/s, particles {n0} -> {n1},"
            f" dropped {int(dropped)}")
        check(int(dropped) == 0 and n1 == n0, f"{label}: particles lost")
        results[label] = {"kinetic": np.asarray(ke, np.float64),
                          "potential": np.asarray(pe, np.float64),
                          "n": n0}
        del st, sim
    check(results["sharded"]["n"] == results["one device"]["n"],
          "particle counts differ")
    _energy_match(results["one device"], results["sharded"],
                  "bench_scaleout", 1e-3, 1e-2)


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run the sharded phases on four GPUs")
    ap.add_argument("--phase", action="append", default=None,
                    help="run only these single-GPU phases (repeatable)")
    args = ap.parse_args(argv)

    from pinc_tpu.utils.jaxconfig import enable_compilation_cache
    cache = enable_compilation_cache()
    devs = phase_platform("gpu")
    print_environment(devs)
    log(f"compile cache {cache}")

    def phase(name, fn, *a, **kw):
        log(f"phase {name}")
        t0 = time.monotonic()
        out = fn(*a, **kw)
        log(f"phase {name}: ok ({time.monotonic() - t0:.1f} s)")
        return out

    if args.multichip:
        check(len(devs) >= 4, f"--multichip needs 4 GPUs, JAX sees "
              f"{len(devs)}")
        devices = devs[:4]
        phase("sharded_flat", phase_sharded_flat, devices)
        phase("sharded_tiled", phase_sharded_tiled, devices)
    else:
        want = set(args.phase or ("kernels", "exchange", "main", "layouts",
                                  "cli"))
        if want & {"kernels", "exchange", "main"}:
            sim = phase("setup", bench_sim)
            if "kernels" in want:
                phase("kernels", phase_kernels, sim)
            if "exchange" in want:
                phase("exchange", phase_exchange, sim)
            if "main" in want:
                phase("main", phase_main, sim)
            del sim
        if "layouts" in want:
            phase("layouts", phase_layouts)
        if "cli" in want:
            phase("cli", phase_cli)
            phase("solvers", phase_solvers)
    log("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
