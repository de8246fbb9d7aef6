"""Tiled deposition layout: exactness vs the scatter
path, fold/pad overlap-add fixtures, bucketing, and end-to-end physics
equivalence."""

import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.config import PincConfig
from pinc_tpu.ops import cic
from pinc_tpu.ops.tiled import (TileSpec, bucket, deposit_tiled,
                                fold_to_global, gather_tiled,
                                global_positions, pad_tiles)
from pinc_tpu.simulation import Simulation
from pinc_tpu.tiled_sim import TiledSimulation, TiledState


@pytest.fixture
def ts():
    return TileSpec(grid=(16, 16, 16), T=4, M=1, B=64, chunk=8)


def random_bucketed(ts, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 16, (n, 3))
    vel = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::17] = False
    lp, lv, la, dropped = bucket(jnp.asarray(pos, jnp.float32),
                                 jnp.asarray(vel), jnp.asarray(alive), ts)
    return pos, alive, lp, lv, la, dropped


def test_bucket_conserves_particles(ts):
    pos, alive, lp, lv, la, dropped = random_bucketed(ts)
    assert int(dropped) == 0
    assert int(la.sum()) == alive.sum()
    gp = np.asarray(global_positions(lp, ts))[np.asarray(la)]
    assert gp.min() >= 0 and gp.max() < 16


def test_tiled_deposit_matches_scatter(ts):
    pos, alive, lp, lv, la, _ = random_bucketed(ts)
    cell = np.floor(pos).astype(np.int32)
    frac = (pos - cell).astype(np.float32)
    val = jnp.asarray(np.where(alive, 1.7, 0.0).astype(np.float32))
    rho_ref = np.asarray(cic.scatter_cic((16,) * 3, jnp.asarray(cell),
                                         jnp.asarray(frac), val))
    rho_tiled = np.asarray(deposit_tiled(lp, la, 1.7, ts))
    assert np.abs(rho_ref - rho_tiled).max() < 1e-5 * max(
        1.0, np.abs(rho_ref).max())
    assert rho_tiled.sum() == pytest.approx(1.7 * alive.sum(), rel=1e-5)


def test_tiled_deposit_wandering_particles(ts):
    """Particles that drifted up to M cells outside their tile still
    deposit exactly (the margin that amortizes re-bucketing)."""
    rng = np.random.default_rng(1)
    pos, alive, lp, lv, la, _ = random_bucketed(ts, seed=1)
    drift = jnp.asarray(rng.uniform(-0.95, 0.95, lp.shape), jnp.float32)
    lp2 = lp + drift * la[..., None]
    gp = np.asarray(global_positions(lp2, ts))
    mask = np.asarray(la)
    c2 = (np.floor(gp).astype(np.int64) % 16).astype(np.int32)
    f2 = (gp - np.floor(gp)).astype(np.float32)
    val = jnp.asarray(np.where(mask, 1.0, 0.0).reshape(-1).astype(np.float32))
    rho_ref = np.asarray(cic.scatter_cic((16,) * 3,
                                         jnp.asarray(c2.reshape(-1, 3)),
                                         jnp.asarray(f2.reshape(-1, 3)), val))
    rho_tiled = np.asarray(deposit_tiled(lp2, la, 1.0, ts))
    assert np.abs(rho_ref - rho_tiled).max() < 1e-5


def test_tiled_gather_matches_cic(ts):
    rng = np.random.default_rng(2)
    pos, alive, lp, lv, la, _ = random_bucketed(ts, seed=2)
    E = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    Epad = pad_tiles(jnp.asarray(E), ts)
    g_tiled = np.asarray(gather_tiled(Epad, lp, ts))
    gp = np.asarray(global_positions(lp, ts))
    cell = (np.floor(gp).astype(np.int64) % 16).astype(np.int32)
    frac = (gp - np.floor(gp)).astype(np.float32)
    g_ref = np.asarray(cic.gather_cic(
        jnp.asarray(E), jnp.asarray(cell.reshape(-1, 3)),
        jnp.asarray(frac.reshape(-1, 3)))).reshape(g_tiled.shape)
    mask = np.asarray(la)
    assert np.abs(g_tiled - g_ref)[mask].max() < 1e-5


def test_bucket_overflow_counted():
    ts = TileSpec(grid=(8, 8, 8), T=4, M=1, B=8, chunk=8)
    # 100 particles all in one tile, capacity 8
    pos = jnp.asarray(np.full((100, 3), 1.5, np.float32))
    vel = jnp.zeros((100, 3), jnp.float32)
    alive = jnp.ones(100, bool)
    lp, lv, la, dropped = bucket(pos, vel, alive, ts)
    assert int(dropped) == 92
    assert int(la.sum()) == 8


DECK = """
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
thermalVelocity = 0.1,0.01
drift = 0.05
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[tiles]
tileSize = 4
margin = 2
rebucketEvery = 5
"""


def test_tiled_simulation_matches_reference_path():
    cfg1 = PincConfig.from_string(DECK.replace("layout = tiled", ""))
    h1 = Simulation(cfg1, seed=3).run(progress_every=0)
    sim2 = TiledSimulation(PincConfig.from_string(DECK), seed=3)
    h2 = sim2.run(progress_every=0)
    ke1 = h1["kinetic"].sum(axis=1)
    ke2 = h2["kinetic"].sum(axis=1)
    assert np.abs(ke1 - ke2).max() / ke1.max() < 1e-4
    assert np.asarray(sim2.particles.counts()).tolist() == [8 * 16 ** 3] * 2


def test_tiled_scan_with_rebucket():
    sim = TiledSimulation(PincConfig.from_string(DECK), seed=3)
    run_n = sim.make_scan_steps(12)
    st, (ke, pe, dropped) = run_n(sim.state)
    assert int(dropped) == 0
    assert np.isfinite(np.asarray(ke)).all()
    assert int(np.asarray(st.alive).sum()) == 2 * 8 * 16 ** 3


def test_layout_dispatch():
    from pinc_tpu.parallel.pic import make_simulation
    sim = make_simulation(PincConfig.from_string(DECK))
    assert isinstance(sim, TiledSimulation)


def test_fused_step_matches_unfused():
    """The step on the Triton particle kernel (interpret mode on CPU)
    reproduces the step on the XLA tiled route."""
    deck = DECK + "backend = pallas\n"
    sim_f = TiledSimulation(PincConfig.from_string(deck), seed=3)
    assert sim_f._backend == "pallas"
    sim_u = TiledSimulation(PincConfig.from_string(
        DECK + "backend = xla\n"), seed=3)
    st_f, st_u = sim_f.state, sim_u.state
    for _ in range(3):
        st_f, rho_f, phi_f, _, d_f = sim_f._tiled_step(st_f)
        st_u, rho_u, phi_u, _, d_u = sim_u._tiled_step(st_u)
    np.testing.assert_allclose(np.asarray(st_f.lpos),
                               np.asarray(st_u.lpos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_f.vel),
                               np.asarray(st_u.vel), atol=1e-5)
    np.testing.assert_allclose(np.asarray(d_f.kin_energy),
                               np.asarray(d_u.kin_energy), rtol=1e-5)
    assert int(d_f.n_lost) == int(d_u.n_lost)


def test_mega_scan_runs_and_conserves():
    """The fused scan driver (one kernel pass per step, interpret mode on
    CPU) runs, conserves the particle count, and produces energies on the
    same scale as the unfused scan (the kick ordering differs by the
    leapfrog half-step convention, so trajectories are not elementwise
    comparable)."""
    deck = DECK + "backend = pallas\n"
    sim = TiledSimulation(PincConfig.from_string(deck), seed=3)
    assert sim._use_mega
    run_n = sim.make_scan_steps(4)
    st, (ke, pe, dropped) = run_n(sim.state)
    assert int(dropped) == 0
    assert int(np.asarray(st.alive).sum()) == 2 * 8 * 16 ** 3
    ke = np.asarray(ke)
    assert ke.shape == (4, 2) and np.isfinite(ke).all()

    sim_u = TiledSimulation(PincConfig.from_string(
        DECK + "backend = pallas\nmega = false\n"), seed=3)
    assert not sim_u._use_mega
    _, (ke_u, pe_u, _) = sim_u.make_scan_steps(4)(sim_u.state)
    np.testing.assert_allclose(ke[0], np.asarray(ke_u)[0], rtol=0.2)


def test_fold_overlap_add_m2():
    """Concat-based fold matches a brute-force numpy overlap-add at M=2
    (margins wider than one plane)."""
    ts2 = TileSpec(grid=(8, 8, 8), T=4, M=2, B=32, chunk=8)
    rng = np.random.default_rng(7)
    tiles = rng.normal(size=(ts2.NT,) + (ts2.P,) * 3).astype(np.float32)
    out = np.asarray(fold_to_global(jnp.asarray(tiles), ts2))
    ref = np.zeros(ts2.grid, np.float32)
    nt = ts2.ntiles
    t5 = tiles.reshape(nt + (ts2.P,) * 3)
    for i in range(nt[0]):
        for j in range(nt[1]):
            for k in range(nt[2]):
                for a in range(ts2.P):
                    ga = (i * ts2.T + a - ts2.M) % ts2.grid[0]
                    for b in range(ts2.P):
                        gb = (j * ts2.T + b - ts2.M) % ts2.grid[1]
                        for c in range(ts2.P):
                            gc = (k * ts2.T + c - ts2.M) % ts2.grid[2]
                            ref[ga, gb, gc] += t5[i, j, k, a, b, c]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_retune_updates_cadence():
    """retune() re-estimates cadences from the current (hotter) state."""
    sim = TiledSimulation(PincConfig.from_string(DECK), seed=3)
    r0 = list(sim.rebucket_every_s)
    hot = TiledState(lpos=sim.state.lpos, vel=sim.state.vel * 4.0,
                     alive=sim.state.alive)
    assert sim.retune(hot)
    assert sim.rebucket_every_s[0] < r0[0]


def test_generate_bucketing_matches_flat():
    """The deferred per-species generate->bucket path (used at 100M+
    populations) produces the identical state to bucketing the flat
    arrays."""
    deck = DECK + "\n[population]\nicDevice = true\n" \
        if "[population]" not in DECK else DECK
    cfg = PincConfig.from_string(DECK.replace(
        "[methods]", "[methods]\n").replace(
        "nSpecies = 2", "nSpecies = 2\nicDevice = true"))
    sim = TiledSimulation(cfg, seed=3)
    st_flat = sim.state
    st_gen = sim._bucket_all_generate(3)
    np.testing.assert_array_equal(np.asarray(st_flat.lpos),
                                  np.asarray(st_gen.lpos))
    np.testing.assert_array_equal(np.asarray(st_flat.vel),
                                  np.asarray(st_gen.vel))
    np.testing.assert_array_equal(np.asarray(st_flat.alive),
                                  np.asarray(st_gen.alive))
