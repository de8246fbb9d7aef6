#!/usr/bin/env python3
"""pinc_tpu energy-drift curve on the C reference's langmuirCold deck
(input/langmuirCold.ini at 32^3, 2 x 64 ppc, 10k steps) — the overlay
for BASELINE.md's protocol step 4.  Writes results/pinc_drift_curve.npy
(2, 10001): row 0 = step, row 1 = total energy (simulation units).
Prints the device it ran on.  Run from the repository root:
python cbaseline/pinc_drift.py"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import numpy as np
import jax

from pinc_tpu.utils.jaxconfig import enable_compilation_cache
enable_compilation_cache()
from pinc_tpu.config import PincConfig
from pinc_tpu.tiled_sim import TiledSimulation

STEPS = int(os.environ.get("DRIFT_STEPS", "10000"))
CH = int(os.environ.get("DRIFT_CHUNK", "500"))

# Overlay of the C THERMAL run (cbaseline patch opt-in
# PINC_VEL_MAXWELL=1): the SAME unmodified deck (stepSize=0.005 m,
# lambda_D = 1.38 dx — well resolved) with Maxwellian velocities at the
# deck's thermalVelocity.  The reference's hardcoded cold lattice IC
# (pPosLattice + pVelZero, src/main.c:144-148) is degenerate for a
# drift comparison: both species deposit identically, rho is
# analytically zero, and the C run "heats" purely from f64 roundoff
# noise — pinc_tpu's deterministic deposit keeps rho EXACTLY zero and
# the plasma stays frozen (verified: E = 0.0 for 2500+ steps).
cfg = PincConfig.from_file(
    os.path.join(os.path.dirname(HERE), "input", "langmuirCold.ini"),
    [f"time:nTimeSteps={STEPS}",
     "grid:nSubdomains=1,1,1",
     "grid:trueSize=32,32,32",
     "population:perturbAmplitude=0,0,0,0,0,0",
     "methods:layout=tiled"])
t0 = time.monotonic()
sim = TiledSimulation(cfg, seed=1)
n0 = int(jax.device_get(sim.state.alive.sum()))
dev = jax.devices()[0]
print(f"device {dev.platform} {dev.device_kind}; "
      f"setup {time.monotonic()-t0:.0f}s n={n0:,} "
      f"cadences={sim.rebucket_every_s}", flush=True)

st = sim.state
kes, pes, drops = [], [], 0
run_ch = sim.make_scan_steps(CH)
for c in range(STEPS // CH):
    st, (ke, pe, dropped) = run_ch(st)
    ke = np.asarray(ke)
    kes.append(ke)
    pes.append(np.asarray(pe))
    drops += int(dropped)
    tot = ke.sum(axis=1) + pes[-1]
    print(f"chunk {c:3d}: E={tot[-1]:.6e} drops_cum={drops}", flush=True)
    # incremental save: a long run killed mid-flight keeps its curve
    done = np.concatenate(kes).sum(axis=1) + np.concatenate(pes)
    np.save(os.path.join(HERE, "results", "pinc_drift_curve.npy"),
            np.stack([np.arange(1, len(done) + 1, dtype=np.float64),
                      done]))
    if sim.retune(st):
        run_ch = sim.make_scan_steps(CH)
ke = np.concatenate(kes).sum(axis=1)
pe = np.concatenate(pes)
tot = ke + pe
steps = np.arange(1, len(tot) + 1, dtype=np.float64)
np.save(os.path.join(HERE, "results", "pinc_drift_curve.npy"),
        np.stack([steps, tot]))
n1 = int(jax.device_get(st.alive.sum()))
half = len(tot) // 2
m = tot[half:].mean()
per1k = (tot[-1] - tot[half]) / m / ((len(tot) - half) / 1000.0)
print(f"E[0]={tot[0]:.4e} E[-1]={tot[-1]:.4e}; plateau-relative drift "
      f"{per1k*100:.1f}%/1k-steps over the last {len(tot)-half} steps")
print(f"particles {n0:,} -> {n1:,} dropped={drops}")
