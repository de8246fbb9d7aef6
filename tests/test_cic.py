"""Gather/scatter unit tests with hand-computed values — the JAX port of the
reference's pusher fixtures (testPuAcc3D1 / testPuDistr3D1,
test/pusher.test.c:82-258) plus conservation/adjointness property tests the
reference never had."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.ops import cic


def split(pos):
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.floor(pos).astype(np.int32)
    frac = (pos - cell).astype(np.float32)
    return jnp.asarray(cell), jnp.asarray(frac)


def test_gather_at_node():
    field = jnp.arange(5 * 4 * 3, dtype=jnp.float32).reshape(5, 4, 3)
    cell, frac = split([[2.0, 1.0, 2.0]])
    out = cic.gather_cic(field, cell, frac)
    assert out[0] == pytest.approx(float(field[2, 1, 2]))


def test_gather_cell_center_is_corner_average():
    """Trilinear value at a cell center equals the mean of the 8 corners
    (the reference's testPuAcc3D1 center fixture)."""
    rng = np.random.default_rng(0)
    field = jnp.asarray(rng.normal(size=(5, 4, 3)).astype(np.float32))
    cell, frac = split([[1.5, 1.5, 0.5]])
    out = cic.gather_cic(field, cell, frac)
    corners = [field[1 + i, 1 + j, 0 + k]
               for i, j, k in itertools.product((0, 1), repeat=3)]
    assert out[0] == pytest.approx(float(np.mean(corners)), rel=1e-5)


def test_gather_hand_computed_offcenter():
    field = jnp.zeros((4, 4, 4), dtype=jnp.float32).at[1, 2, 3].set(1.0)
    # particle at (0.75, 1.5, 2.25): weight on node (1,2,3) is
    # x*y*... = 0.75 * 0.5 * 0.25? offsets: node (1,2,3) is corner (1,1,1)
    # of cell (0,1,2) with frac (0.75,0.5,0.25) -> w = 0.75*0.5*0.25
    cell, frac = split([[0.75, 1.5, 2.25]])
    out = cic.gather_cic(field, cell, frac)
    assert out[0] == pytest.approx(0.75 * 0.5 * 0.25, rel=1e-6)


def test_gather_vector_field():
    field = jnp.stack([jnp.full((4, 4), 2.0), jnp.full((4, 4), 3.0)], axis=-1)
    cell, frac = split([[1.3, 2.7]])
    out = cic.gather_cic(field, cell, frac)
    assert np.allclose(np.asarray(out), [2.0, 3.0], atol=1e-6)


def test_scatter_hand_computed_weights():
    """CIC deposit weights of a single particle (testPuDistr3D1 semantics)."""
    cell, frac = split([[0.1, 0.2, 0.3]])
    q = jnp.asarray([2.0])
    rho = np.asarray(cic.scatter_cic((4, 4, 4), cell, frac, q))
    x, y, z = 0.1, 0.2, 0.3
    expect = {
        (0, 0, 0): (1 - x) * (1 - y) * (1 - z),
        (1, 0, 0): x * (1 - y) * (1 - z),
        (0, 1, 0): (1 - x) * y * (1 - z),
        (1, 1, 0): x * y * (1 - z),
        (0, 0, 1): (1 - x) * (1 - y) * z,
        (1, 0, 1): x * (1 - y) * z,
        (0, 1, 1): (1 - x) * y * z,
        (1, 1, 1): x * y * z,
    }
    for idx, w in expect.items():
        assert rho[idx] == pytest.approx(2.0 * w, rel=1e-5), idx
    assert rho.sum() == pytest.approx(2.0, rel=1e-5)


def test_scatter_periodic_wrap():
    """A particle in the last cell deposits onto node 0 across the wrap."""
    cell, frac = split([[3.5]])
    rho = np.asarray(cic.scatter_cic((4,), cell, frac, jnp.asarray([1.0])))
    assert rho[3] == pytest.approx(0.5, rel=1e-6)
    assert rho[0] == pytest.approx(0.5, rel=1e-6)


def test_charge_conservation_random():
    rng = np.random.default_rng(42)
    pos = rng.uniform(0, [8, 6, 4], size=(1000, 3))
    cell, frac = split(pos)
    q = jnp.asarray(rng.choice([-1.0, 1.0], size=1000).astype(np.float32))
    rho = np.asarray(cic.scatter_cic((8, 6, 4), cell, frac, q))
    assert rho.sum() == pytest.approx(float(np.sum(np.asarray(q))), abs=1e-3)


def test_gather_scatter_adjoint():
    """<scatter(q), field> == sum_p q_p * gather(field)_p — gather and
    scatter must be exact adjoints for momentum conservation."""
    rng = np.random.default_rng(3)
    field = jnp.asarray(rng.normal(size=(8, 8)).astype(np.float32))
    pos = rng.uniform(0, 8, size=(500, 2))
    cell, frac = split(pos)
    q = jnp.asarray(rng.normal(size=500).astype(np.float32))
    rho = cic.scatter_cic((8, 8), cell, frac, q)
    lhs = float(jnp.sum(rho * field))
    rhs = float(jnp.sum(q * cic.gather_cic(field, cell, frac)))
    assert lhs == pytest.approx(rhs, rel=1e-4)


def test_ngp_rounding():
    field = jnp.arange(6, dtype=jnp.float32)
    cell, frac = split([[2.4], [2.6], [5.7]])
    out = np.asarray(cic.gather_ngp(field, cell, frac))
    assert out[0] == 2.0      # rounds down
    assert out[1] == 3.0      # rounds up
    assert out[2] == 0.0      # 5.7 -> node 6 -> wraps to 0

    rho = np.asarray(cic.scatter_ngp((6,), cell, frac,
                                     jnp.asarray([1.0, 1.0, 1.0])))
    assert rho[2] == 1.0 and rho[3] == 1.0 and rho[0] == 1.0
