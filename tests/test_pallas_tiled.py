"""The Triton particle kernel (ops/pallas_tiled.py) in interpret mode on
CPU against the XLA route of ops/tiled.py, and its CUDA lowering.

Interpret mode accumulates the deposit with a functional scatter-add (the
interpreter's atomic_add drops repeated indices within one vector), so
these tests deposit colliding corners freely; the compiled atomics are
checked against the same reference on the GPU by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.ops import pallas_tiled as pt
from pinc_tpu.ops import tiled as tl
from pinc_tpu.ops.tiled import (TileSpec, bucket, deposit_tiled,
                                gather_tiled_dense, pad_tiles)

CHARGE = (-1.0, 1.5)
QM = (-0.5, 0.25)
EEXT = (0.01, -0.02, 0.005)


def _boris(qm, b=(0.05, 0.02, 0.1)):
    T = 0.5 * np.asarray(qm)[:, None] * np.asarray(b)
    S = 2.0 * T / (1.0 + np.sum(T * T, axis=1, keepdims=True))
    return T, S


@pytest.fixture(scope="module")
def setup():
    """Two species bucketed on a 16^3 grid (T=4, M=1): planes
    (S, 3, NT, B), alive (S, NT, B), a random padded E field."""
    ts = TileSpec(grid=(16, 16, 16), T=4, M=1, B=128, chunk=8)
    rng = np.random.default_rng(0)
    n = 3000
    lps, lvs, las = [], [], []
    for s in range(2):
        pos = rng.uniform(0, 16, (n, 3)).astype(np.float32)
        vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
        alive = np.ones(n, bool)
        alive[s::13] = False
        lp, lv, la, _ = bucket(jnp.asarray(pos), jnp.asarray(vel),
                               jnp.asarray(alive), ts)
        lps.append(jnp.moveaxis(lp, -1, 0))
        lvs.append(jnp.moveaxis(lv, -1, 0))
        las.append(la.astype(jnp.float32))
    E = jnp.asarray(rng.normal(size=(16, 16, 16, 3)).astype(np.float32))
    return (ts, jnp.stack(lps), jnp.stack(lvs), jnp.stack(las),
            pad_tiles(E, ts))


def _both(setup, **kw):
    ts, lpos, vel, alive, field = setup
    kw.setdefault("charge", CHARGE)
    kw.setdefault("qm", QM)
    if kw.get("kick"):
        kw.setdefault("field", field)
    k = pt.particle_pass(lpos, vel, alive, ts, interpret=True, **kw)
    r = tl.particle_pass(lpos, vel, alive, ts, **kw)
    return k, r


@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
def test_pallas_deposit_matches_xla(setup, order):
    ts, lpos, _, alive, _ = setup
    (tk, *_), (tr, *_) = _both(setup, deposit=True, order_distr=order)
    assert tk.shape == (ts.NT,) + (ts.P,) * 3
    np.testing.assert_allclose(np.asarray(tk), np.asarray(tr), atol=2e-6)
    # folded onto the grid it is the one-species deposit summed
    rho = tl.fold_to_global(tk, ts)
    ref = sum(deposit_tiled(jnp.moveaxis(lpos[s], 0, -1), alive[s] > 0.5,
                            CHARGE[s], ts, order=order) for s in range(2))
    np.testing.assert_allclose(np.asarray(rho), np.asarray(ref), atol=2e-6)
    # total charge = sum of live charges, to f32 summation round-off
    q = sum(CHARGE[s] * float(alive[s].sum()) for s in range(2))
    gross = sum(abs(CHARGE[s]) * float(alive[s].sum()) for s in range(2))
    assert float(jnp.sum(rho)) == pytest.approx(q, abs=1e-6 * gross)


@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
@pytest.mark.parametrize("eext", [None, EEXT], ids=["no_eext", "eext"])
def test_pallas_gather_matches_xla(setup, order, eext):
    """A kick from rest with qm=1 returns the gathered field (+ E_ext)."""
    ts, lpos, vel, alive, field = setup
    zero = jnp.zeros_like(vel)
    _, _, v, _, _ = pt.particle_pass(
        lpos, zero, alive, ts, charge=CHARGE, qm=(1.0, 1.0), field=field,
        kick=True, order_acc=order, e_ext=eext, interpret=True)
    live = np.asarray(alive) > 0.5
    for s in range(2):
        ref = np.asarray(gather_tiled_dense(field, jnp.moveaxis(lpos[s], 0,
                                                              -1), ts,
                                          order=order))
        if eext is not None:
            ref = ref + np.asarray(eext, np.float32)
        got = np.moveaxis(np.asarray(v[s]), 0, -1)
        np.testing.assert_allclose(got[live[s]], ref[live[s]], atol=2e-5)
        assert (got[~live[s]] == 0).all()


@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
def test_fused_deposit_move(setup, order):
    """drift + deposit == the XLA route, plus the margin count."""
    ts, lpos, vel, alive, _ = setup
    (tk, lk, vk, dk, nk), (tr, lr, vr, dr, nr) = _both(
        setup, drift=True, deposit=True, order_distr=order)
    np.testing.assert_array_equal(np.asarray(lk), np.asarray(lr))
    assert vk is vel and float(jnp.abs(dk).sum()) == 0.0
    np.testing.assert_allclose(np.asarray(tk), np.asarray(tr), atol=2e-6)
    moved = np.asarray(lpos + vel)
    lo, hi = -float(ts.M), float(ts.T + ts.M)
    bad = ((moved < lo) | (moved >= hi)).any(axis=1) & (np.asarray(alive)
                                                        > 0.5)
    np.testing.assert_array_equal(np.asarray(nk), bad.sum(axis=(1, 2)))
    np.testing.assert_array_equal(np.asarray(nk), np.asarray(nr))


@pytest.mark.parametrize("boris", [False, True], ids=["leapfrog", "boris"])
def test_fused_gather_kick(setup, boris):
    """kick == the XLA route's gather + kick, and the KE term per
    species; dead slots keep their velocity."""
    bT, bS = _boris(QM) if boris else (None, None)
    (_, lk, vk, dk, _), (_, lr, vr, dr, _) = _both(
        setup, kick=True, e_ext=EEXT, boris_T=bT, boris_S=bS)
    ts, lpos, vel, alive, _ = setup
    assert lk is lpos
    np.testing.assert_allclose(np.asarray(vk), np.asarray(vr), atol=1e-6)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(dr), rtol=1e-5)
    dead = np.asarray(alive)[:, None] < 0.5
    np.testing.assert_array_equal(np.asarray(vk)[np.broadcast_to(
        dead, vk.shape)], np.asarray(vel)[np.broadcast_to(dead, vk.shape)])


@pytest.mark.parametrize("order_acc,order_distr", [(1, 1), (0, 1), (1, 0)],
                         ids=["cic", "ngp_acc", "ngp_distr"])
def test_pic_step_matches_kernel_pair(setup, order_acc, order_distr):
    """The full step pass == kick pass, then drift + deposit pass; and it
    matches the XLA route."""
    ts, lpos, vel, alive, field = setup
    kw = dict(charge=CHARGE, qm=QM, order_acc=order_acc,
              order_distr=order_distr, e_ext=EEXT, interpret=True)
    full = pt.particle_pass(lpos, vel, alive, ts, field=field, kick=True,
                            drift=True, deposit=True, **kw)
    _, _, v1, vd1, _ = pt.particle_pass(lpos, vel, alive, ts, field=field,
                                        kick=True, **kw)
    t2, l2, _, _, n2 = pt.particle_pass(lpos, v1, alive, ts, drift=True,
                                        deposit=True, **kw)
    for a, b in zip(full, (t2, l2, v1, vd1, n2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    kw.pop("interpret")
    ref = tl.particle_pass(lpos, vel, alive, ts, field=field, kick=True,
                           drift=True, deposit=True, **kw)
    for a, b, tol in zip(full, ref, (2e-6, 1e-6, 1e-6, 1e-3, 0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)


def test_lane_chunked_kernels_match_unchunked(setup, monkeypatch):
    """The slot chunk (programs per tile) is numerically invisible: a
    64-slot chunk (2 programs per tile) gives the 128-slot results."""
    kw = dict(kick=True, drift=True, deposit=True, e_ext=EEXT)
    base, _ = _both(setup, **kw)
    monkeypatch.setattr(pt, "SLOT_CHUNK", 64)
    assert pt._chunk(setup[0].B) == 64
    chnk, _ = _both(setup, **kw)
    for a, b in zip(chnk, base):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("slots,quantum", [(1, 1), (40, 64), (300, 512),
                                           (17408, 512)])
def test_slot_quantum(slots, quantum):
    """Bucket capacities round to a power of two up to the slot chunk, so
    the kernel's chunk always divides B."""
    assert pt.slot_quantum(slots) == quantum
    B = -(-slots // quantum) * quantum
    assert B % pt._chunk(B) == 0 and pt._chunk(B) == quantum


@pytest.mark.parametrize("parts", [
    dict(kick=True, drift=True, deposit=True),
    dict(deposit=True, order_distr=0),
    dict(kick=True, boris=True),
], ids=["step", "deposit_ngp", "kick_boris"])
def test_kernel_lowers_for_cuda(setup, parts):
    """Compiled mode (interpret=False) lowers to a Triton kernel call for
    the CUDA platform; compiling it needs the GPU."""
    ts, lpos, vel, alive, field = setup
    parts = dict(parts)
    bT, bS = _boris(QM) if parts.pop("boris", False) else (None, None)

    def f(lp, v, al):
        return pt.particle_pass(lp, v, al, ts, charge=CHARGE, qm=QM,
                                field=field, boris_T=bT, boris_S=bS,
                                e_ext=EEXT, interpret=False, **parts)

    text = jax.jit(f).trace(lpos, vel, alive).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "pic_particles" in text


def test_kernel_rejects_empty_pass(setup):
    ts, lpos, vel, alive, _ = setup
    with pytest.raises(AssertionError):
        pt.particle_pass(lpos, vel, alive, ts, charge=CHARGE,
                         interpret=True)


@pytest.mark.gpu
def test_kernel_compiled_matches_xla(gpu_device, setup):
    """On the GPU: the compiled kernel (atomic deposit, colliding corners
    included) against the XLA route at HIGHEST precision."""
    ts, lpos, vel, alive, field = setup
    kw = dict(charge=CHARGE, qm=QM, field=field, kick=True, drift=True,
              deposit=True, e_ext=EEXT)
    k = jax.jit(lambda *a: pt.particle_pass(*a, ts, interpret=False,
                                            **kw))(lpos, vel, alive)
    r = tl.particle_pass(lpos, vel, alive, ts, **kw)
    for a, b, tol in zip(k, r, (1e-5, 1e-6, 1e-6, 1e-3, 0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)
