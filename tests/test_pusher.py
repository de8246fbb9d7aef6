"""Mover/accelerator tests: the JAX port of the reference's constant-E
leapfrog fixture (testConstE, test/pusher.test.c:18-77) plus Boris-rotation
invariants."""

import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.ops import pusher
from pinc_tpu.population import Particles, SpeciesParams


def make_particles(pos, vel, cap=None):
    pos = np.asarray(pos, dtype=np.float64)   # (S, N, D)
    vel = np.asarray(vel, dtype=np.float64)
    S, N, D = pos.shape
    cap = cap or N
    cell = np.zeros((S, cap, D), np.int32)
    frac = np.zeros((S, cap, D), np.float32)
    v = np.zeros((S, cap, D), np.float32)
    alive = np.zeros((S, cap), bool)
    c = np.floor(pos).astype(np.int32)
    cell[:, :N] = c
    frac[:, :N] = (pos - c).astype(np.float32)
    v[:, :N] = vel
    alive[:, :N] = True
    return Particles(cell=jnp.asarray(cell), frac=jnp.asarray(frac),
                     vel=jnp.asarray(v), alive=jnp.asarray(alive))


def test_move_wraps_periodically():
    p = make_particles([[[7.5]]], [[[1.2]]])
    p = pusher.move(p, (8,))
    pos = float(np.asarray(p.pos())[0, 0, 0])
    assert pos == pytest.approx((7.5 + 1.2) % 8.0, abs=1e-6)
    assert 0 <= int(p.cell[0, 0, 0]) < 8
    assert 0.0 <= float(p.frac[0, 0, 0]) < 1.0


def test_move_negative_velocity_wrap():
    p = make_particles([[[0.25]]], [[[-0.5]]])
    p = pusher.move(p, (8,))
    assert float(np.asarray(p.pos())[0, 0, 0]) == pytest.approx(7.75, abs=1e-6)


def test_const_e_leapfrog_trajectory():
    """3 species with distinct q/m under a uniform E: with the standard
    half-kick initialization, discrete leapfrog positions land exactly on
    x0 + v0 n + a n^2 / 2 (the reference's testConstE)."""
    E0 = 0.01
    L = 64
    field = jnp.full((L, 1), E0, dtype=jnp.float32)
    charge = jnp.asarray([-1.0, 1.0, 2.0])
    mass = jnp.asarray([1.0, 1836.0, 4.0])
    params = SpeciesParams(charge=charge, mass=mass)

    x0, v0 = 10.0, 0.05
    p = make_particles([[[x0]]] * 3, [[[v0]]] * 3)

    # half-kick (src/main.c:184-186)
    p, _ = pusher.acc_leapfrog(p, params, 0.5 * field)
    n_steps = 20
    for _ in range(n_steps):
        p = pusher.move(p, (L,))
        p, _ = pusher.acc_leapfrog(p, params, field)

    pos = np.asarray(p.pos())[:, 0, 0]
    a = np.asarray(charge / mass) * E0
    expect = (x0 + v0 * n_steps + 0.5 * a * n_steps ** 2) % L
    assert pos == pytest.approx(expect, abs=5e-4)


def test_ke_is_time_centered():
    """KE returned by the accelerator is 0.5*m*v_old.(v_old+dv)
    (puAcc3D1KE, src/pusher.c:197-210)."""
    field = jnp.full((8, 1), 0.5, dtype=jnp.float32)
    params = SpeciesParams(charge=jnp.asarray([2.0]), mass=jnp.asarray([4.0]))
    p = make_particles([[[3.0]]], [[[1.0]]])
    _, ke = pusher.acc_leapfrog(p, params, field)
    dv = 2.0 / 4.0 * 0.5
    assert float(ke[0]) == pytest.approx(0.5 * 4.0 * 1.0 * (1.0 + dv), rel=1e-6)


def test_dead_particles_inert():
    field = jnp.full((8, 1), 1.0, dtype=jnp.float32)
    params = SpeciesParams(charge=jnp.asarray([1.0]), mass=jnp.asarray([1.0]))
    p = make_particles([[[2.0]]], [[[0.0]]], cap=4)
    p2, ke = pusher.acc_leapfrog(p, params, field)
    assert np.all(np.asarray(p2.vel)[0, 1:] == 0.0)
    rho_shape = (8,)
    rho = pusher.deposit(p2, params, rho_shape)
    assert float(jnp.sum(rho)) == pytest.approx(1.0, rel=1e-5)


def test_boris_gyration_conserves_speed():
    """Pure magnetic field: |v| must be exactly conserved and the rotation
    angle per step is 2*atan(|q B / 2 m|)."""
    B = jnp.asarray([0.0, 0.0, 0.2]).reshape(1, 1, 3)
    field = jnp.zeros((8, 8, 8, 3), dtype=jnp.float32)
    params = SpeciesParams(charge=jnp.asarray([1.0]), mass=jnp.asarray([1.0]))
    p = make_particles([[[4.0, 4.0, 4.0]]], [[[0.3, 0.0, 0.0]]])
    speeds = [float(jnp.linalg.norm(p.vel[0, 0]))]
    angles = []
    for _ in range(5):
        v_before = np.asarray(p.vel)[0, 0, :2]
        p, _ = pusher.acc_boris(p, params, field, B)
        v_after = np.asarray(p.vel)[0, 0, :2]
        speeds.append(float(jnp.linalg.norm(p.vel[0, 0])))
        cosang = np.dot(v_before, v_after) / (
            np.linalg.norm(v_before) * np.linalg.norm(v_after))
        angles.append(np.arccos(np.clip(cosang, -1, 1)))
    assert np.allclose(speeds, speeds[0], rtol=1e-5)
    expect = 2.0 * np.arctan(0.5 * 0.2)
    assert np.allclose(angles, expect, rtol=1e-4)


def test_boris_reduces_to_leapfrog_without_b():
    B = jnp.zeros((1, 1, 3))
    field = jnp.full((8, 8, 8, 3), 0.25, dtype=jnp.float32)
    params = SpeciesParams(charge=jnp.asarray([-1.0]), mass=jnp.asarray([2.0]))
    p0 = make_particles([[[3.3, 4.4, 5.5]]], [[[0.1, 0.2, 0.3]]])
    pa, kea = pusher.acc_boris(p0, params, field, B)
    pb, keb = pusher.acc_leapfrog(p0, params, field)
    assert np.allclose(np.asarray(pa.vel), np.asarray(pb.vel), atol=1e-6)


def test_reflect_mixed_bounded_dims():
    """Mixed decks reflect only at bounded walls; periodic dims wrap."""
    import jax.numpy as jnp
    from pinc_tpu.ops.pusher import reflect
    from pinc_tpu.population import Particles

    L = (8, 8, 8)
    # one particle past the upper edge in x and z, below 0 in y
    cell = jnp.asarray([[[7, 0, 7]]], jnp.int32)
    frac = jnp.asarray([[[0.9, 0.2, 0.9]]], jnp.float32)
    vel = jnp.asarray([[[0.5, -0.5, 0.5]]], jnp.float32)
    p = Particles(cell=cell, frac=frac,
                  vel=vel, alive=jnp.asarray([[True]]))
    p2 = Particles(cell=cell, frac=frac + jnp.asarray([0.5, -0.5, 0.5]),
                   vel=vel, alive=p.alive)
    out = reflect(p2, L, bounded=(False, False, True))
    pos = np.asarray(out.cell[0, 0]).astype(float) + np.asarray(
        out.frac[0, 0])
    v = np.asarray(out.vel[0, 0])
    # x periodic: 8.4 wraps to 0.4, velocity unchanged
    assert np.isclose(pos[0], 0.4, atol=1e-5) and v[0] == 0.5
    # y periodic: -0.3 wraps to 7.7, velocity unchanged
    assert np.isclose(pos[1], 7.7, atol=1e-5) and v[1] == -0.5
    # z bounded: 8.4 reflects about hi=7 to 5.6, velocity flips
    assert np.isclose(pos[2], 5.6, atol=1e-5) and v[2] == -0.5
