"""Physics-method coverage on the tiled production path: Boris rotation
with external B, NGP weighting, and external E must produce the same
physics as the flat path (which is itself fixture-tested against the
reference's puBoris3D1KE / puAccND0KE / puDistrND0 semantics,
src/pusher.c:314-505, 644-678)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.config import PincConfig
from pinc_tpu.simulation import Simulation
from pinc_tpu.tiled_sim import TiledSimulation

BASE = """
[time]
nTimeSteps = 12
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
[fields]
BExt = 0,0,0
EExt = 0,0,0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
[tiles]
tileSize = 4
margin = 2
rebucketEvery = 5
"""


def _deck(acc="puAcc3D1KE", distr="puDistr3D1", bext=None, eext=None,
          tiled=True, extra=""):
    d = BASE.replace("acc = puAcc3D1KE", f"acc = {acc}")
    d = d.replace("distr = puDistr3D1", f"distr = {distr}")
    if bext is not None:
        d = d.replace("BExt = 0,0,0", f"BExt = {bext}")
    if eext is not None:
        d = d.replace("EExt = 0,0,0", f"EExt = {eext}")
    if tiled:
        d = d.replace("[tiles]", "layout = tiled\n[tiles]")
    return PincConfig.from_string(d + extra)


def _compare_histories(h_flat, h_tiled, rtol=1e-4):
    ke1 = h_flat["kinetic"].sum(axis=1)
    ke2 = h_tiled["kinetic"].sum(axis=1)
    assert np.abs(ke1 - ke2).max() / np.abs(ke1).max() < rtol
    np.testing.assert_allclose(h_flat["potential"], h_tiled["potential"],
                               rtol=1e-3, atol=1e-6 * np.abs(
                                   h_flat["potential"]).max())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_boris_tiled_matches_flat(backend):
    """A magnetized warm deck runs layout=tiled and matches the flat
    puBoris3D1KE path (VERDICT item 1 acceptance)."""
    bext = "0.05,0.02,0.1"
    h_flat = Simulation(_deck(acc="puBoris3D1KE", bext=bext, tiled=False),
                        seed=3).run(progress_every=0)
    sim_t = TiledSimulation(
        _deck(acc="puBoris3D1KE", bext=bext,
              extra=f"backend = {backend}\n"), seed=3)
    assert sim_t._acc_boris
    h_tiled = sim_t.run(progress_every=0)
    _compare_histories(h_flat, h_tiled)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_ngp_tiled_matches_flat(backend):
    h_flat = Simulation(_deck(acc="puAccND0KE", distr="puDistrND0",
                              tiled=False), seed=3).run(progress_every=0)
    sim_t = TiledSimulation(
        _deck(acc="puAccND0KE", distr="puDistrND0",
              extra=f"backend = {backend}\n"), seed=3)
    assert sim_t._acc_order == 0 and sim_t._distr_order == 0
    h_tiled = sim_t.run(progress_every=0)
    _compare_histories(h_flat, h_tiled)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_eext_tiled_matches_flat(backend):
    eext = "0.002,0,0.001"
    h_flat = Simulation(_deck(eext=eext, tiled=False),
                        seed=3).run(progress_every=0)
    sim_t = TiledSimulation(
        _deck(eext=eext, extra=f"backend = {backend}\n"),
        seed=3)
    assert sim_t._e_ext is not None
    h_tiled = sim_t.run(progress_every=0)
    _compare_histories(h_flat, h_tiled)


def test_boris_mega_scan_consistent():
    """The fused scan (one particle pass per step) with Boris+EExt
    conserves the particle count and tracks the unfused scan's energies
    (the kick uses the previous step's field, so only scale agreement is
    expected)."""
    bext = "0.05,0.02,0.1"
    extra = "backend = pallas\n"
    sim_m = TiledSimulation(_deck(acc="puBoris3D1KE", bext=bext,
                                  eext="0.001,0,0",
                                  extra=extra), seed=3)
    assert sim_m._use_mega
    st, (ke, pe, dropped) = sim_m.make_scan_steps(4)(sim_m.state)
    assert int(dropped) == 0
    assert int(np.asarray(st.alive).sum()) == 2 * 8 * 16 ** 3
    ke = np.asarray(ke)
    assert np.isfinite(ke).all()

    sim_u = TiledSimulation(_deck(acc="puBoris3D1KE", bext=bext,
                                  eext="0.001,0,0",
                                  extra=extra + "mega = false\n"), seed=3)
    assert not sim_u._use_mega
    _, (ke_u, _, _) = sim_u.make_scan_steps(4)(sim_u.state)
    np.testing.assert_allclose(ke[0], np.asarray(ke_u)[0], rtol=0.2)


def test_gather_kick_boris_unit():
    """Kernel-level check: the kick pass with a Boris rotation and an
    external field reproduces the flat acc_boris arithmetic on the
    gathered field."""
    from pinc_tpu.ops import pallas_tiled as ptl
    from pinc_tpu.ops.tiled import TileSpec, bucket, gather_tiled, pad_tiles

    ts = TileSpec(grid=(8, 8, 8), T=4, M=1, B=128, chunk=8)
    rng = np.random.default_rng(11)
    n = 500
    pos = jnp.asarray(rng.uniform(0, 8, (n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 0.2, (n, 3)), jnp.float32)
    alive = jnp.ones(n, bool)
    lp, lv, la, _ = bucket(pos, vel, alive, ts)
    lpos = jnp.moveaxis(lp, -1, 0)
    lvel = jnp.moveaxis(lv, -1, 0)
    E = jnp.asarray(rng.normal(0, 0.05, (8, 8, 8, 3)), jnp.float32)
    ep5 = pad_tiles(E, ts)
    qm = -0.5
    Tv = 0.5 * qm * np.asarray([0.1, 0.0, 0.3])
    Sv = 2.0 * Tv / (1.0 + np.sum(Tv * Tv))
    eext = (0.01, -0.02, 0.0)

    _, _, nv, vdot, _ = ptl.particle_pass(
        lpos[None], lvel[None], la.astype(jnp.float32)[None], ts,
        charge=(-1.0,), qm=(qm,), field=ep5, kick=True, e_ext=eext,
        boris_T=[Tv], boris_S=[Sv], interpret=True)
    nv, vdot = nv[0], vdot[0]

    # reference arithmetic on the gathered field
    Ep = gather_tiled(ep5, lp, ts) + jnp.asarray(eext)       # (NT,B,3)
    half = 0.5 * qm * Ep
    v = jnp.moveaxis(lvel, 0, -1)
    v_minus = v + half
    v_prime = v_minus + jnp.cross(v_minus, jnp.asarray(Tv))
    v_plus = v_minus + jnp.cross(v_prime, jnp.asarray(Sv))
    v_new = v_plus + half
    mask = np.asarray(la)
    np.testing.assert_allclose(
        np.asarray(jnp.moveaxis(nv, 0, -1))[mask],
        np.asarray(v_new)[mask], rtol=1e-5, atol=1e-6)
    vdot_ref = float(jnp.sum(jnp.where(
        la, jnp.sum(v_plus * v_plus, axis=-1), 0.0)))
    assert float(vdot) == pytest.approx(vdot_ref, rel=1e-5)
    # norm preservation of the rotation legs at E=0: |v_plus| == |v_minus|
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(v_plus)[mask], axis=-1),
        np.linalg.norm(np.asarray(v_minus)[mask], axis=-1), rtol=1e-5)


def test_tiled_rejects_non_registry_methods():
    """The guard: a hand-monkeypatched accelerator without routing
    attributes must raise instead of silently downgrading."""
    cfg = _deck()
    sim_ok = TiledSimulation(cfg, seed=3)
    assert sim_ok._acc_order == 1

    class Bad(Simulation):
        def __init__(self, cfg, seed=1):
            super().__init__(cfg, seed=seed)

    import pinc_tpu.registry as reg

    @reg.ACCELERATORS.register("customacc")
    def _custom(cfg):
        def acc(p, params, E, periodic=True, e_scale=1.0):
            raise NotImplementedError
        return acc

    bad_cfg = _deck(acc="customAcc")
    with pytest.raises(ValueError, match="registry accelerator"):
        TiledSimulation(bad_cfg, seed=3)
