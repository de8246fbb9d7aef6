"""Multi-device tests on the virtual 8-CPU mesh: halo exchange, particle
migration, and sharded-vs-single-block equivalence — the distributed
coverage the reference never had (SURVEY.md §4: 'multi-rank halo exchange
is explicitly not unit-tested')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pinc_tpu.config import PincConfig
from pinc_tpu.parallel.halo import fold_plus, pad_plus
from pinc_tpu.parallel.mesh import make_mesh
from pinc_tpu.parallel.pic import ShardedSimulation, make_simulation
from pinc_tpu.simulation import Simulation

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


pytestmark = pytest.mark.usefixtures("cpu_devices")


def test_pad_plus_fetches_neighbor_plane(cpu_devices):
    ctx = make_mesh((4,), (4,), devices=cpu_devices)
    # global ramp 0..15 sharded into 4 blocks of 4
    x = jax.device_put(jnp.arange(16, dtype=jnp.float32),
                       ctx.sharding(P("x")))

    def body(b):
        return pad_plus(b, ctx.axes, ctx.n_subdomains)

    out = shard_map(body, mesh=ctx.mesh, in_specs=P("x"),
                    out_specs=P("x"))(x)
    out = np.asarray(out).reshape(4, 5)
    # each block: its 4 values + the next block's first value (wrap at end)
    assert np.allclose(out[0], [0, 1, 2, 3, 4])
    assert np.allclose(out[3], [12, 13, 14, 15, 0])


def test_fold_plus_adds_overflow_to_neighbor(cpu_devices):
    ctx = make_mesh((4,), (4,), devices=cpu_devices)
    # each block deposits 1.0 into its overflow plane only
    blocks = np.zeros((4, 5), np.float32)
    blocks[:, 4] = 7.0
    x = jax.device_put(jnp.asarray(blocks.reshape(20)),
                       ctx.sharding(P("x")))

    def body(b):
        return fold_plus(b, ctx.axes, ctx.n_subdomains)

    out = shard_map(body, mesh=ctx.mesh, in_specs=P("x"),
                    out_specs=P("x"))(x)
    out = np.asarray(out).reshape(4, 4)
    # every block's first node received the left neighbor's overflow
    assert np.allclose(out[:, 0], 7.0)
    assert np.allclose(out[:, 1:], 0.0)


DECK_3D = """
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {ts}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 16 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.1,0.01
drift = 0.3
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
poisson = {solver}
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrants3D
[multigrid]
mgLevels = 2
mgCycles = 15
nPreSmooth = 3
nPostSmooth = 3
nCoarseSolve = 10
"""


@pytest.mark.parametrize("solver", ["sSolve", "mgSolve"])
def test_sharded_matches_single_device(cpu_devices, solver):
    """(2,2,2) mesh with a drifting warm plasma (real migration traffic
    every step) must track the single-block run."""
    cfg1 = PincConfig.from_string(
        DECK_3D.format(steps=10, nsub="1,1,1", ts="16,16,16", solver=solver))
    cfg2 = PincConfig.from_string(
        DECK_3D.format(steps=10, nsub="2,2,2", ts="8,8,8", solver=solver))
    h1 = Simulation(cfg1, seed=3).run(progress_every=0)
    sim2 = ShardedSimulation(cfg2, seed=3, devices=cpu_devices)
    h2 = sim2.run(progress_every=0)

    ke1 = h1["kinetic"].sum(axis=1)
    ke2 = h2["kinetic"].sum(axis=1)
    assert np.abs(ke1 - ke2).max() / ke1.max() < 1e-4
    pe1, pe2 = h1["potential"], h2["potential"]
    assert np.abs(pe1 - pe2).max() / np.abs(pe1).max() < 1e-3
    # no particles lost across 10 steps of migration
    assert np.asarray(sim2.particles.counts()).tolist() == [8 * 16 ** 3] * 2


def test_migration_preserves_particles_1d(cpu_devices):
    """Fast drift across subdomain boundaries for many steps: population
    count is invariant and positions stay consistent."""
    deck = """
[time]
nTimeSteps = 30
timeStep = 0.2
[grid]
nDims = 1
nSubdomains = 8
trueSize = 8
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 1
nParticles = 16 pc
nAlloc = 32 pc
charge = -1
mass = 1
multiplicity = auto
thermalVelocity = 0.5
drift = 1.7
[methods]
poisson = sSolve
acc = puAccND1KE
distr = puDistrND1
migrate = puExtractEmigrantsND
"""
    cfg = PincConfig.from_string(deck)
    sim = ShardedSimulation(cfg, seed=11, devices=cpu_devices)
    n0 = int(np.asarray(sim.particles.counts())[0])
    sim.run(progress_every=0)
    assert int(np.asarray(sim.particles.counts())[0]) == n0
    pos = np.asarray(sim.particles.pos())
    alive = np.asarray(sim.particles.alive)
    assert pos[alive].min() >= 0.0 and pos[alive].max() < 64.0


def test_make_simulation_dispatch(cpu_devices):
    cfg1 = PincConfig.from_string(
        DECK_3D.format(steps=1, nsub="1,1,1", ts="8,8,8", solver="sSolve"))
    assert type(make_simulation(cfg1)) is Simulation
    cfg2 = PincConfig.from_string(
        DECK_3D.format(steps=1, nsub="2,1,1", ts="8,8,8", solver="sSolve"))
    assert isinstance(make_simulation(cfg2, devices=cpu_devices),
                      ShardedSimulation)


def test_make_simulation_auto_tiled(monkeypatch):
    """Single-device decks whose slot count exceeds the flat working set
    auto-select the tiled layout unless methods:layout pins it."""
    from pinc_tpu.parallel import pic
    from pinc_tpu.tiled_sim import TiledSimulation
    monkeypatch.setattr(pic, "FLAT_BYTES_PER_SLOT", 10 ** 15)
    cfg = PincConfig.from_string(
        DECK_3D.format(steps=1, nsub="1,1,1", ts="8,8,8", solver="sSolve"))
    assert isinstance(pic.make_simulation(cfg), TiledSimulation)
    cfg2 = PincConfig.from_string(
        DECK_3D.format(steps=1, nsub="1,1,1", ts="8,8,8", solver="sSolve"))
    cfg2.set_str("methods:layout", "flat")
    assert type(pic.make_simulation(cfg2)) is Simulation
