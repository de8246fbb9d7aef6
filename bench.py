"""Headline benchmark: particle-steps/s on the bench deck
(input/bench_maxwellian.ini: 128^3 Debye-resolved warm Maxwellian, 2
species x 32 particles per cell, tiled layout), with the FFT and
multigrid solve times at 128^3 as auxiliary numbers.

Needs an NVIDIA GPU.  ``JAX_PLATFORMS=cpu python bench.py`` is a
rehearsal at CPU sizes; every result then names the cpu device.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "device": {...}, "aux": {...}}
Progress goes to stderr.  A failed phase fails the run.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from pinc_tpu.utils.jaxconfig import enable_compilation_cache

enable_compilation_cache()

BENCH_DECK = "input/bench_maxwellian.ini"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The device every result is measured on.  Exits unless JAX sees a
    GPU, or the CPU under an explicit JAX_PLATFORMS=cpu rehearsal."""
    devs = jax.devices()
    p = devs[0].platform
    if p != "gpu" and not (p == "cpu"
                           and os.environ.get("JAX_PLATFORMS") == "cpu"):
        sys.exit(f"bench.py needs an NVIDIA GPU, JAX sees {p!r} "
                 f"(JAX_PLATFORMS=cpu runs a CPU rehearsal)")
    return {"platform": p, "kind": devs[0].device_kind, "count": len(devs)}


def _window(sim, steps):
    """Round the window to the slow species' re-bucket cadence, so every
    species is freshly re-bucketed at window boundaries and each window
    carries all of its own re-bucket cost."""
    Rs = sim.rebucket_every_s
    Ri, Re = max(Rs), min(Rs)
    if Ri % Re == 0 and Ri <= 400:
        steps = Ri * max(1, round(steps / Ri))
    return steps


def bench_pic(grid_n=128, ppc=32, steps=20, vth="0.1,0.0023",
              rebucket=None):
    from pinc_tpu.config import PincConfig
    from pinc_tpu.tiled_sim import TiledSimulation

    over = [f"grid:trueSize={grid_n},{grid_n},{grid_n}",
            f"population:nParticles={ppc} pc",
            f"population:nAlloc={ppc} pc",
            f"population:thermalVelocity={vth}",
            f"time:nTimeSteps={steps}"]
    if rebucket:
        # pin a uniform re-bucket cadence (the under-resolved deck)
        over.append(f"tiles:rebucketEvery={rebucket}")
    cfg = PincConfig.from_file(BENCH_DECK, over)
    t0 = time.monotonic()
    sim = TiledSimulation(cfg, seed=1)
    carry = sim.state
    n_particles = int(jax.device_get(jnp.sum(sim.state.alive > 0.5)))
    sim.state = None      # release so run_n's donation can take effect
    log(f"setup: {grid_n}^3 grid, {n_particles:,} particles "
        f"({time.monotonic()-t0:.1f}s)")
    steps = _window(sim, steps)
    log(f"window: {steps} steps (cadences {sim.rebucket_every_s})")

    run_n = sim.make_scan_steps(steps, donate=True)
    t0 = time.monotonic()
    carry, (_, _, dropped0) = run_n(carry)
    jax.block_until_ready(carry.lpos)
    log(f"compile+first run: {time.monotonic() - t0:.1f}s "
        f"(dropped={int(dropped0)})")

    # adaptive retune between windows (heating decks outgrow the initial
    # cadence/cap estimates); rebuild the scan fn when the schedule
    # changed so the timed window runs drop-free
    if int(dropped0) and sim.retune(carry, drops=int(dropped0)):
        steps = _window(sim, steps)
        run_n = sim.make_scan_steps(steps, donate=True)
        carry, _ = run_n(carry)
        jax.block_until_ready(carry.lpos)
        log(f"retuned schedule: cadences={sim.rebucket_every_s}, "
            f"cap={sim._exchange_cap}")

    # timed window, re-run retuned if it dropped particles: a number that
    # lost particles is not a clean number.  Each retry pays a recompile,
    # so bound the attempts.
    for attempt in range(3):
        t0 = time.monotonic()
        carry, (ke, pe, dropped) = run_n(carry)
        jax.block_until_ready(carry.lpos)
        wall = time.monotonic() - t0
        psteps = n_particles * steps / wall
        log(f"{steps} steps in {wall:.3f}s -> {psteps:.3e} "
            f"particle-steps/s (KE[-1]={float(ke[-1].sum()):.4g}, "
            f"dropped={int(dropped)})")
        if not int(dropped) or attempt == 2:
            break
        if not sim.retune(carry, drops=int(dropped)):
            break
        steps = _window(sim, steps)
        run_n = sim.make_scan_steps(steps, donate=True)
        carry, _ = run_n(carry)
        jax.block_until_ready(carry.lpos)
        log(f"timed window dropped particles -> retuned "
            f"(cadences={sim.rebucket_every_s}, cap={sim._exchange_cap}); "
            f"re-running")
    if int(dropped):
        log(f"WARNING: {int(dropped)} particle(s) dropped by re-bucket "
            f"overflow during the timed window (raise tiles:slack / "
            f"tiles:exchangeCap)")
    return psteps, int(dropped)


def bench_solver(grid_n=128, reps=10):
    from pinc_tpu.solvers.spectral import SpectralSolver
    from pinc_tpu.solvers.multigrid import MultigridSolver

    rng = np.random.default_rng(0)
    rho = jnp.asarray(rng.normal(size=(grid_n,) * 3).astype(np.float32))
    out = {}
    for name, solver in [
        ("fft", jax.jit(SpectralSolver((grid_n,) * 3))),
        ("mg_vcycle", jax.jit(MultigridSolver(
            (grid_n,) * 3, n_levels=5, n_pre=3, n_post=3, n_coarse=8,
            max_cycles=1, tol=0.0))),
    ]:
        phi = solver(rho)
        jax.block_until_ready(phi)
        t0 = time.monotonic()
        for _ in range(reps):
            phi = solver(rho)
        jax.block_until_ready(phi)
        ms = (time.monotonic() - t0) / reps * 1e3
        out[name] = ms
        log(f"{name} @ {grid_n}^3: {ms:.2f} ms")
    return out


def bench_multichip(device, steps=None):
    """Weak-scaling scale-out bench (input/bench_scaleout.ini): the
    single-device per-device workload sharded over ALL visible devices.
    CPU meshes (JAX_PLATFORMS=cpu) rehearse the sharding at tiny
    shapes."""
    from __graft_entry__ import _factor_mesh
    from pinc_tpu.config import PincConfig
    from pinc_tpu.parallel.tiled_pic import ShardedTiledSimulation

    devices = jax.devices()
    n = len(devices)
    on_gpu = device["platform"] == "gpu"
    nsub = _factor_mesh(n)
    local = 128 if on_gpu else 16
    ppc = 32 if on_gpu else 2
    steps = steps or (40 if on_gpu else 2)
    over = [f"grid:nSubdomains={','.join(map(str, nsub))}",
            f"grid:trueSize={local},{local},{local}",
            f"population:nParticles={ppc} pc",
            f"population:nAlloc={ppc} pc",
            f"time:nTimeSteps={steps}"]
    cfg = PincConfig.from_file("input/bench_scaleout.ini", over)
    t0 = time.monotonic()
    sim = ShardedTiledSimulation(cfg, seed=1, devices=devices)
    n_particles = int(jax.device_get(jnp.sum(sim.state.alive > 0.5)))
    carry = sim.state
    sim.state = None
    log(f"setup: {nsub} mesh x {local}^3 local, {n_particles:,} particles "
        f"({time.monotonic()-t0:.1f}s)")
    run_n = sim.make_scan_steps(steps, donate=True)
    t0 = time.monotonic()
    carry, _ = run_n(carry)
    jax.block_until_ready(carry.lpos)
    log(f"compile+first window: {time.monotonic()-t0:.1f}s")
    t0 = time.monotonic()
    carry, (ke, pe, dropped) = run_n(carry)
    jax.block_until_ready(carry.lpos)
    wall = time.monotonic() - t0
    psteps = n_particles * steps / wall
    log(f"{steps} steps on {n} device(s): {psteps:.3e} particle-steps/s "
        f"({psteps / n:.3e}/device), dropped={int(dropped)}")
    print(json.dumps({
        "metric": "particle_steps_per_sec_multichip",
        "value": psteps, "unit": "particle-steps/s", "device": device,
        "aux": {"devices": n, "mesh": list(nsub), "per_device": psteps / n,
                "dropped_in_window": int(dropped)}}))
    return psteps


def main():
    device = device_info()
    log(f"device: {device}")
    if "--multichip" in sys.argv:
        steps = None
        if "--steps" in sys.argv:
            steps = int(sys.argv[sys.argv.index("--steps") + 1])
        bench_multichip(device, steps=steps)
        return
    t_start = time.monotonic()
    on_gpu = device["platform"] == "gpu"
    grid_n = 128 if on_gpu else 32
    ppc = int(os.environ.get("BENCH_PPC", "32" if on_gpu else "4"))
    steps = 40 if on_gpu else 5

    solver_ms = bench_solver(grid_n=grid_n, reps=10 if on_gpu else 2)
    # HEADLINE: the Debye-resolved warm Maxwellian (lambda_D = 0.5 dx)
    psteps, dropped = bench_pic(grid_n=grid_n, ppc=ppc, steps=steps)
    aux = {f"poisson_{k}_ms_{grid_n}3": v for k, v in solver_ms.items()}
    aux["dropped_in_window"] = dropped
    budget = float(os.environ.get("BENCH_BUDGET_S", "420"))
    if (on_gpu and "--skip-underresolved" not in sys.argv
            and time.monotonic() - t_start < budget):
        # the under-resolved deck (lambda_D = 0.1 dx, violent CIC grid
        # heating, margin 1) as an auxiliary number
        psteps_u, dropped_u = bench_pic(grid_n=grid_n, ppc=ppc,
                                        steps=steps, vth="0.02,0.0005",
                                        rebucket=10)
        aux["underresolved_psteps"] = psteps_u
        aux["underresolved_dropped"] = dropped_u

    # kernel-floor regression gate: the FFT/MG/pic numbers must sit inside
    # the envelope recorded for this platform (script/bench_floors.json)
    sys.path.insert(0, "script")
    import bench_floors
    envs = (json.loads(bench_floors.ENVELOPE_FILE.read_text())
            if bench_floors.ENVELOPE_FILE.exists() else {})
    env = envs.get(device["platform"])
    if env is None:
        log(f"floors: no envelope recorded for {device['platform']!r} — "
            f"run script/bench_floors.py --record")
        aux["floors"] = "no-envelope"
    else:
        checks = {"fft_ms": solver_ms.get("fft"),
                  "mg_vcycle_ms": solver_ms.get("mg_vcycle")}
        checks.update(bench_floors.measure_pic_step(
            grid_n=64 if on_gpu else 16, ppc=32 if on_gpu else 4))
        fails = []
        for k, v in checks.items():
            lim = env.get(k)
            if lim is None or v is None:
                continue
            ok = v <= lim * bench_floors.TOLERANCE
            log(f"floors {'PASS' if ok else 'FAIL'} {k}: {v:.4g} "
                f"(envelope {lim:.4g}, limit "
                f"{lim * bench_floors.TOLERANCE:.4g})")
            if not ok:
                fails.append(k)
        aux["floors"] = "ok" if not fails else f"FAIL:{','.join(fails)}"

    print(json.dumps({
        "metric": "particle_steps_per_sec_per_chip",
        "value": psteps,
        "unit": "particle-steps/s",
        "device": device,
        "aux": aux,
    }))


if __name__ == "__main__":
    main()
