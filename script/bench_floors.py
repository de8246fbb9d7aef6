"""Kernel-floor regression check (VERDICT r2 item 7).

Measures the hot-path floors with proper warmup and compares them against
recorded per-platform envelopes with a generous tolerance, so inter-round
drift (e.g. the r01->r02 FFT 2.78 -> 4.13 ms) is caught and explainable
instead of silent:

* ``fft_ms``       — spectral Poisson solve at 128^3 (ms)
* ``mg_vcycle_ms`` — one multigrid V-cycle at 128^3 (ms)
* ``pic_step_ns``  — tiled pic step, ns per particle slot (64^3 deck,
                     margin 1; particle pass + field work, no re-bucket)

Usage:
    python script/bench_floors.py            # compare, print PASS/FAIL
    python script/bench_floors.py --record   # (re)record envelopes

Envelopes live in ``script/bench_floors.json`` keyed by platform; the
default tolerance is 1.5x the recorded value.  Only the cpu envelope is
recorded so far (a CPU harness check, not a device number); record the
gpu one on the card with --record.  Exit code 1 on any FAIL.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pinc_tpu.utils.jaxconfig import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

ENVELOPE_FILE = Path(__file__).with_suffix(".json")
TOLERANCE = 1.5
WARMUP = 3
REPS = 10


def _time_ms(fn, *args) -> float:
    out = None
    for _ in range(WARMUP):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.monotonic()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.monotonic() - t0) / REPS * 1e3


def measure_solvers(grid_n: int = 128) -> dict:
    from pinc_tpu.solvers.multigrid import MultigridSolver
    from pinc_tpu.solvers.spectral import SpectralSolver

    rho = jnp.asarray(np.random.default_rng(0).normal(
        size=(grid_n,) * 3).astype(np.float32))
    fft = jax.jit(SpectralSolver((grid_n,) * 3))
    mg = jax.jit(MultigridSolver((grid_n,) * 3, n_levels=5, n_pre=3,
                                 n_post=3, n_coarse=8, max_cycles=1,
                                 tol=0.0))
    return {"fft_ms": _time_ms(fft, rho), "mg_vcycle_ms": _time_ms(mg, rho)}


def measure_pic_step(grid_n: int = 64, ppc: int = 32, steps: int = 8) -> dict:
    """ns per particle slot of the tiled step (windows sized under the
    re-bucket cadence: kernel + field glue only)."""
    from pinc_tpu.config import PincConfig
    from pinc_tpu.tiled_sim import TiledSimulation

    deck = f"""
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = {grid_n},{grid_n},{grid_n}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = {ppc} pc
nAlloc = {ppc} pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.02,0.0005
drift = 0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
[tiles]
tileSize = 8
rebucketEvery = {steps + 2}
"""
    sim = TiledSimulation(PincConfig.from_string(deck), seed=1)
    carry = sim.state
    n_slots = int(np.prod(carry.lpos.shape)) // carry.lpos.shape[0]
    run_n = sim.make_scan_steps(steps)
    carry, _ = run_n(carry)
    jax.block_until_ready(carry.lpos)
    t0 = time.monotonic()
    carry, _ = run_n(carry)
    jax.block_until_ready(carry.lpos)
    wall = time.monotonic() - t0
    return {"pic_step_ns": wall / steps / n_slots * 1e9}


def main() -> int:
    record = "--record" in sys.argv
    platform = jax.devices()[0].platform
    on_gpu = platform == "gpu"
    # CPU runs only validate the harness; the envelopes that matter are
    # the GPU ones
    measured = measure_solvers(grid_n=128 if on_gpu else 32)
    measured.update(measure_pic_step(grid_n=64 if on_gpu else 16,
                                     ppc=32 if on_gpu else 4))
    envs = (json.loads(ENVELOPE_FILE.read_text())
            if ENVELOPE_FILE.exists() else {})
    if record:
        envs[platform] = {k: round(v, 4) for k, v in measured.items()}
        ENVELOPE_FILE.write_text(json.dumps(envs, indent=2) + "\n")
        print(f"recorded envelopes for {platform!r}: {envs[platform]}")
        return 0
    env = envs.get(platform)
    if env is None:
        for k, v in measured.items():
            print(f"RECORD-NEEDED {k}: {v:.4g} (no envelope for "
                  f"{platform!r}; run with --record)")
        return 0
    failed = False
    for k, v in measured.items():
        lim = env.get(k)
        if lim is None:
            print(f"RECORD-NEEDED {k}: {v:.4g}")
            continue
        ok = v <= lim * TOLERANCE
        print(f"{'PASS' if ok else 'FAIL'} {k}: {v:.4g} "
              f"(envelope {lim:.4g}, limit {lim * TOLERANCE:.4g})")
        failed |= not ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
