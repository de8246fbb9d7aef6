"""End-to-end physics tests — the JAX equivalents of the reference's
verification strategy (SURVEY.md §4): cold-Langmuir oscillation frequency
and energy conservation (verification/sweep.py semantics)."""

import numpy as np
import pytest

from pinc_tpu.config import PincConfig
from pinc_tpu.simulation import Simulation

COLD_1D = """
[time]
nTimeSteps = 150
timeStep = 0.2
[grid]
nDims = 1
nSubdomains = 1
trueSize = 32
stepSize = 6.28 tot
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 64 pc
nAlloc = 96 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
temperature = 0
drift = 0
perturbAmplitude = 0.001,0
perturbMode = 1,0
[methods]
mode = regular
poisson = sSolve
acc = puAccND1KE
distr = puDistrND1
migrate = puExtractEmigrantsND
"""


@pytest.fixture(scope="module")
def cold_history():
    cfg = PincConfig.from_string(COLD_1D)
    sim = Simulation(cfg)
    return sim.run(progress_every=0)


def test_langmuir_frequency(cold_history):
    """KE of a cold Langmuir oscillation oscillates at 2*omega_pe; with
    timeStep = omega_pe*dt = 0.2 the expected KE frequency is
    0.4/(2 pi) cycles/step.  (Leapfrog adds an O(dt^2) frequency shift.)"""
    ke = cold_history["kinetic"].sum(axis=1)[1:]
    sp = np.abs(np.fft.rfft(ke - ke.mean()))
    k = int(sp.argmax())
    freq = k / len(ke)
    expected = 2 * 0.2 / (2 * np.pi)
    df = 1.0 / len(ke)  # one FFT bin
    assert abs(freq - expected) <= df + 1e-9, (freq, expected)


def test_energy_conservation(cold_history):
    """Total energy drift over the run, the sweep.py criterion
    (verification/sweep.py:69-82)."""
    ke = cold_history["kinetic"].sum(axis=1)
    pe = cold_history["potential"]
    tot = (ke + pe)[1:]
    drift = (tot.max() - tot.min()) / abs(tot.mean())
    assert drift < 0.05, drift


def test_ke_pe_exchange(cold_history):
    """Cold start: KE begins at ~0, PE at max; they trade places a quarter
    period later."""
    ke = cold_history["kinetic"].sum(axis=1)
    pe = cold_history["potential"]
    assert ke[0] == pytest.approx(0.0, abs=1e-12)
    assert pe[1] > 0
    # electrons dominate the KE (ions are 1836x heavier)
    ke_species = cold_history["kinetic"]
    assert ke_species[:, 0].max() > 100 * ke_species[:, 1].max()


def test_multigrid_step_matches_spectral():
    """Same deck solved with multigrid must track the spectral run."""
    cfg_a = PincConfig.from_string(COLD_1D)
    deck_mg = (COLD_1D
               .replace("poisson = sSolve", "poisson = mgSolve")
               + "\n[multigrid]\nmgLevels = 3\nmgCycles = 25\n"
                 "nPreSmooth = 4\nnPostSmooth = 4\nnCoarseSolve = 20\n"
                 "tol = 1e-9\n")
    deck_mg = deck_mg.replace("nTimeSteps = 150", "nTimeSteps = 30")
    cfg_a = PincConfig.from_string(COLD_1D.replace("nTimeSteps = 150",
                                                   "nTimeSteps = 30"))
    cfg_b = PincConfig.from_string(deck_mg)
    hist_a = Simulation(cfg_a).run(progress_every=0)
    hist_b = Simulation(cfg_b).run(progress_every=0)
    ke_a = hist_a["kinetic"].sum(axis=1)
    ke_b = hist_b["kinetic"].sum(axis=1)
    scale = max(abs(ke_a).max(), 1e-30)
    assert np.allclose(ke_a, ke_b, atol=0.05 * scale), (
        np.abs(ke_a - ke_b).max() / scale)


def test_3d_smoke():
    """A small 3D deck runs and conserves energy roughly."""
    deck = """
[time]
nTimeSteps = 20
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 8 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.02,0.001
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrants3D
"""
    cfg = PincConfig.from_string(deck)
    sim = Simulation(cfg, seed=7)
    hist = sim.run(progress_every=0)
    tot = (hist["kinetic"].sum(axis=1) + hist["potential"])[1:]
    assert np.isfinite(tot).all()
    drift = (tot.max() - tot.min()) / abs(tot.mean())
    assert drift < 0.1, drift
