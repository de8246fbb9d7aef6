"""Sharded x tiled composition: the tiled layout over an 8-device mesh
must reproduce the single-device tiled path (same deck, same seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.config import PincConfig
from pinc_tpu.parallel.pic import make_simulation
from pinc_tpu.parallel.tiled_pic import ShardedTiledSimulation
from pinc_tpu.tiled_sim import TiledSimulation


def _deck(nsub, true):
    return f"""
[time]
nTimeSteps = 4
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {','.join(map(str, nsub))}
trueSize = {','.join(map(str, true))}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 4 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.08,0.002
drift = 0.05
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[tiles]
tileSize = 4
margin = 1
rebucketEvery = 2
"""


@pytest.fixture(scope="module")
def pair(cpu_devices):
    single = TiledSimulation(
        PincConfig.from_string(_deck((1, 1, 1), (16, 16, 16))), seed=7)
    sharded = ShardedTiledSimulation(
        PincConfig.from_string(_deck((2, 2, 2), (8, 8, 8))), seed=7,
        devices=cpu_devices[:8])
    return single, sharded


def test_factory_routes_to_sharded_tiled(cpu_devices):
    sim = make_simulation(
        PincConfig.from_string(_deck((2, 2, 2), (8, 8, 8))), seed=1,
        devices=cpu_devices[:8])
    assert isinstance(sim, ShardedTiledSimulation)


def test_sharded_tiled_matches_single(pair):
    single, sharded = pair
    # identical global ICs (same seed, same global grid)
    assert int(np.asarray(single.state.alive).sum()) == \
        int(np.asarray(sharded.state.alive).sum())

    n = 4
    run1 = single.make_scan_steps(n)
    runN = sharded.make_scan_steps(n)
    _, (ke1, pe1, d1) = run1(single.state)
    _, (keN, peN, dN) = runN(sharded.state)
    assert int(d1) == int(dN) == 0
    ke1, keN = np.asarray(ke1), np.asarray(keN)
    pe1, peN = np.asarray(pe1), np.asarray(peN)
    assert np.allclose(ke1, keN, rtol=1e-4, atol=1e-7), (ke1, keN)
    assert np.allclose(pe1, peN, rtol=1e-3, atol=1e-9), (pe1, peN)


def test_sharded_rebucket_conserves_across_devices(pair):
    _, sharded = pair
    st = sharded.state
    n_before = int(np.asarray(st.alive).sum())
    rng = np.random.default_rng(0)
    drift = jnp.asarray(rng.uniform(-0.9, 0.9, st.lpos.shape)
                        .astype(np.float32))
    # _rebucket_jit donates its argument: hand it copies so the
    # module-scoped fixture state survives
    st2 = type(st)(lpos=st.lpos + drift * st.alive[:, None].astype(
        jnp.float32), vel=jnp.copy(st.vel), alive=jnp.copy(st.alive))
    st3, dropped = sharded._rebucket_jit(st2)
    assert int(dropped) == 0
    assert int(np.asarray(st3.alive).sum()) == n_before
    lp = np.asarray(st3.lpos)
    la = np.asarray(st3.alive) > 0.5
    for s in range(lp.shape[0]):
        for d in range(3):
            vals = lp[s, d][la[s]]
            assert vals.min() >= 0.0 and vals.max() < sharded.ts.T


def test_sharded_tiled_run_writes_energy(pair):
    _, sharded = pair
    hist = sharded.run(progress_every=0)
    ke = hist["kinetic"].sum(axis=1)
    pe = hist["potential"]
    tot = ke + pe
    assert np.all(np.isfinite(tot))
    # short warm run: total energy moves by < a few percent
    assert abs(tot[-1] - tot[0]) / abs(tot[0]) < 0.05


def test_sharded_pallas_fused_matches_xla(cpu_devices):
    """The sharded step on the Triton particle kernel (pallas backend,
    interpret mode on CPU) reproduces the XLA sharded step."""
    deck = _deck((2, 2, 2), (8, 8, 8))
    s_xla = ShardedTiledSimulation(
        PincConfig.from_string(deck + "backend = xla\n"), seed=7,
        devices=cpu_devices[:8])
    s_pl = ShardedTiledSimulation(
        PincConfig.from_string(deck + "backend = pallas\n"),
        seed=7, devices=cpu_devices[:8])
    st_x, st_p = s_xla.state, s_pl.state
    for _ in range(2):
        st_x, _, _, _, d_x = s_xla._sharded_tiled_step(st_x)
        st_p, _, _, _, d_p = s_pl._sharded_tiled_step(st_p)
    np.testing.assert_allclose(np.asarray(st_p.lpos), np.asarray(st_x.lpos),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_p.vel), np.asarray(st_x.vel),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(d_p.kin_energy),
                               np.asarray(d_x.kin_energy), rtol=1e-5)


def _deck_bounded(nsub, true):
    return _deck(nsub, true).replace(
        "boundaries = PERIODIC",
        "boundaries = DIRICHLET,DIRICHLET,PERIODIC,"
        "DIRICHLET,DIRICHLET,PERIODIC").replace(
        "poisson = sSolve", "poisson = mgSolve").replace(
        "drift = 0.05", "drift = 0") + "\n[multigrid]\nmgLevels = 2\n"


def test_sharded_tiled_bounded_matches_single(cpu_devices):
    """Bounded walls on the sharded tiled path: same energies as the
    single-device tiled path (reflection in the global frame, MG solve
    partitioned over the mesh)."""
    single = TiledSimulation(
        PincConfig.from_string(_deck_bounded((1, 1, 1), (16, 16, 16))),
        seed=7)
    sharded = ShardedTiledSimulation(
        PincConfig.from_string(_deck_bounded((2, 2, 2), (8, 8, 8))),
        seed=7, devices=cpu_devices[:8])
    n = 4
    _, (ke1, pe1, d1) = single.make_scan_steps(n)(single.state)
    _, (keN, peN, dN) = sharded.make_scan_steps(n)(sharded.state)
    assert int(d1) == int(dN) == 0
    np.testing.assert_allclose(np.asarray(ke1), np.asarray(keN),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(pe1), np.asarray(peN),
                               rtol=1e-3, atol=1e-8)


def test_sharded_tiled_objects_matches_single(cpu_devices, tmp_path):
    """Objects on the sharded tiled path: energies and object potential
    match the single-device tiled object run."""
    from pinc_tpu.objects import make_sphere, save_domain
    dom = make_sphere((16,) * 3, (8, 8, 8), 2.5)
    path = str(tmp_path / "sphere.grid.h5")
    save_domain(path, dom)
    obj_deck = "[objects]\nobjects = " + path + "\n"

    single = TiledSimulation(
        PincConfig.from_string(obj_deck + _deck((1, 1, 1), (16, 16, 16))),
        seed=7)
    sharded = ShardedTiledSimulation(
        PincConfig.from_string(obj_deck + _deck((2, 2, 2), (8, 8, 8))),
        seed=7, devices=cpu_devices[:8])
    assert sharded.objects is not None
    h1 = single.run(progress_every=0)
    hN = sharded.run(progress_every=0)
    ke1 = h1["kinetic"].sum(axis=1)
    keN = hN["kinetic"].sum(axis=1)
    np.testing.assert_allclose(ke1, keN, rtol=1e-4)
    np.testing.assert_allclose(h1["potential"], hN["potential"],
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(single.last_obj_potential),
        np.asarray(sharded.last_obj_potential), rtol=1e-3, atol=1e-6)


def test_sharded_mega_scan_runs(cpu_devices):
    """The sharded fused scan (per-shard particle pass, field tiles in the
    carry) runs on the CPU mesh, conserves particles, and its energies
    stay on the same scale as the pair-kernel sharded scan."""
    deck = _deck((2, 2, 2), (8, 8, 8))
    s_m = ShardedTiledSimulation(
        PincConfig.from_string(deck + "backend = pallas\n"),
        seed=7, devices=cpu_devices[:8])
    assert s_m._use_mega
    n0 = int(np.asarray(s_m.state.alive).sum())
    st, (ke, pe, dropped) = s_m.make_scan_steps(4)(s_m.state)
    assert int(dropped) == 0
    assert int(np.asarray(st.alive).sum()) == n0
    ke = np.asarray(ke)
    assert ke.shape == (4, 2) and np.isfinite(ke).all()

    s_p = ShardedTiledSimulation(
        PincConfig.from_string(deck + "backend = pallas\n"
                               "mega = false\n"),
        seed=7, devices=cpu_devices[:8])
    _, (ke_p, _, _) = s_p.make_scan_steps(4)(s_p.state)
    np.testing.assert_allclose(ke[0], np.asarray(ke_p)[0], rtol=0.2)
