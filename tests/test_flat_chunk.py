"""Chunked flat-layout particle sweeps (population:sweepChunk).

The flat layout's gather/scatter expand 2^D corner intermediates over the
whole population in one shot; past the single-device memory peak those decks
previously could only run by auto-routing to the tiled layout.  The
chunked sweeps bound the working set while producing numerically
identical results (scatter adds associate per chunk in the same corner
order; gather is elementwise per particle).

Reference parity: the C reference streams particles one at a time
(src/pusher.c:512-678) and has no working-set peak at all; chunking is
the JAX-native equivalent discipline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.config import PincConfig
from pinc_tpu.ops import pusher
from pinc_tpu.population import Particles, SpeciesParams


def _mk_pop(seed=0, S=2, cap=1000, L=(8, 8, 8)):
    rng = np.random.default_rng(seed)
    D = len(L)
    cell = rng.integers(0, np.asarray(L), size=(S, cap, D)).astype(np.int32)
    frac = rng.uniform(size=(S, cap, D)).astype(np.float32)
    vel = rng.normal(0, 0.1, size=(S, cap, D)).astype(np.float32)
    alive = (rng.uniform(size=(S, cap)) < 0.9)
    p = Particles(cell=jnp.asarray(cell), frac=jnp.asarray(frac),
                  vel=jnp.asarray(vel), alive=jnp.asarray(alive))
    params = SpeciesParams(charge=jnp.asarray([-1.0, 1.0][:S]),
                           mass=jnp.asarray([1.0, 1836.0][:S]))
    return p, params


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("chunk", [128, 300, 999, 2048])
def test_deposit_chunked_matches(order, chunk):
    L = (8, 7, 6)
    p, params = _mk_pop(L=L)
    ref = pusher.deposit(p, params, L, order=order)
    out = pusher.deposit(p, params, L, order=order, chunk=chunk)
    # scatter-add association differs only in chunk grouping; f32 adds of
    # the same corner stream agree to tight tolerance (exact when the
    # per-node add order is preserved, which chunked scan does)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("chunk", [128, 999])
def test_gather_chunked_matches(order, chunk):
    L = (8, 7, 6)
    p, params = _mk_pop(L=L)
    rng = np.random.default_rng(3)
    E = jnp.asarray(rng.normal(size=L + (3,)).astype(np.float32))
    ref = pusher._gathered_field(E, p, order, True)
    out = pusher._gathered_field(E, p, order, True, chunk=chunk)
    # lax.map changes XLA's fusion/FMA contraction -> last-ulp drift
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


def test_acc_chunked_matches():
    L = (8, 8, 8)
    p, params = _mk_pop(L=L)
    rng = np.random.default_rng(4)
    E = jnp.asarray(rng.normal(size=L + (3,)).astype(np.float32))
    p_ref, ke_ref = pusher.acc_leapfrog(p, params, E)
    p_out, ke_out = pusher.acc_leapfrog(p, params, E, chunk=256)
    np.testing.assert_allclose(np.asarray(p_out.vel),
                                np.asarray(p_ref.vel),
                                rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ke_out), np.asarray(ke_ref),
                               rtol=1e-6)


def test_sweepchunk_deck_roundtrip():
    """A flat deck with population:sweepChunk pinned runs end-to-end and
    conserves particles; the registry factories thread the knob."""
    deck = """
[time]
nTimeSteps = 3
timeStep = 0.1
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 8,8,8
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 2 pc
nAlloc = 2 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.05,0.001
drift = 0
sweepChunk = 512
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
"""
    from pinc_tpu.simulation import Simulation
    cfg = PincConfig.from_string(deck)
    sim = Simulation(cfg, seed=1)
    cfg2 = PincConfig.from_string(deck.replace("sweepChunk = 512", ""))
    sim2 = Simulation(cfg2, seed=1)
    out = sim.run()
    out2 = sim2.run()
    np.testing.assert_allclose(np.asarray(out["kinetic"]),
                               np.asarray(out2["kinetic"]),
                               rtol=1e-5, atol=1e-6)
