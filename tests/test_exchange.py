"""Exchange re-bucketing (ops/exchange.py): conservation, counted
overflow, agreement with the sort re-bucket, corner flow, other
dimensionalities, and cross-device rolls on the 8-CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.ops.exchange import rebucket_exchange
from pinc_tpu.ops.tiled import TileSpec, bucket, global_positions


def _planes(lp, lv):
    D = lp.shape[-1]
    return (tuple(lp[..., d] for d in range(D))
            + tuple(lv[..., d] for d in range(D)))


def _unplanes(planes, alive):
    D = len(planes) // 2
    return (jnp.stack(planes[:D], -1), jnp.stack(planes[D:], -1),
            alive > 0.5)


def _setup(grid, T, B, n, drift_scale, seed=0):
    ts = TileSpec(grid=grid, T=T, M=1, B=B, chunk=8)
    rng = np.random.default_rng(seed)
    D = len(grid)
    pos = rng.uniform(0, grid[0], (n, D)).astype(np.float32)
    vel = rng.normal(0, 0.2, (n, D)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::11] = False
    lp, lv, la, _ = bucket(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(alive), ts)
    drift = jnp.asarray(
        rng.uniform(-drift_scale, drift_scale, lp.shape).astype(np.float32))
    return ts, lp + drift * la[..., None], lv, la


def _multiset(lp, lv, la, ts):
    gp = np.asarray(global_positions(lp, ts))[np.asarray(la)]
    v = np.asarray(lv)[np.asarray(la)]
    w = np.arange(1, gp.shape[1] + 1) * 1.7
    return np.sort((gp * w).sum(1) + (v * 13.3 * w).sum(1))


def _run(ts, lp, lv, la, K, roll_fns=None):
    planes, al, dropped = rebucket_exchange(
        _planes(lp, lv), la.astype(jnp.float32), ts.ntiles, ts.T, K=K,
        roll_fns=roll_fns)
    return _unplanes(planes, al) + (int(dropped),)


@pytest.mark.parametrize("drift", [0.9, 1.5], ids=["faces", "corners"])
def test_exchange_conserves(drift):
    """Every particle lands in the tile that owns it, none is lost or
    duplicated, payloads travel with their particle."""
    ts, lp, lv, la = _setup((16, 16, 16), 4, 128, 3000, drift)
    lp3, lv3, la3, dropped = _run(ts, lp, lv, la, K=64)
    assert dropped == 0
    assert int(la3.sum()) == int(la.sum())
    l3 = np.asarray(lp3)[np.asarray(la3)]
    assert l3.min() >= 0.0 and l3.max() < ts.T
    np.testing.assert_allclose(_multiset(lp, lv, la, ts),
                               _multiset(lp3, lv3, la3, ts), atol=1e-3)
    # velocities are never touched: bitwise the same multiset
    v0 = np.sort(np.asarray(lv)[np.asarray(la)].view(np.uint32), axis=0)
    v1 = np.sort(np.asarray(lv3)[np.asarray(la3)].view(np.uint32), axis=0)
    np.testing.assert_array_equal(np.sort(v0, axis=None),
                                  np.sort(v1, axis=None))


@pytest.mark.parametrize("K,B", [(8, 128), (128, 64)],
                         ids=["face_cap", "free_slots"])
def test_exchange_overflow_counted(K, B):
    """Face-cap overflow (K) and bucket overflow (too few free slots) drop
    particles loudly: alive + dropped is conserved."""
    ts = TileSpec(grid=(8, 8, 8), T=4, M=1, B=B, chunk=8)
    rng = np.random.default_rng(2)
    n = 3000 if B == 64 else 1000
    pos = rng.uniform(0, 8, (n, 3)).astype(np.float32)
    lp, lv, la, d0 = bucket(jnp.asarray(pos),
                            jnp.zeros((n, 3), jnp.float32),
                            jnp.ones(n, bool), ts)
    if B == 64:
        # crowd one tile column: everything in x-tile 0 moves up one tile
        shift = np.zeros(lp.shape, np.float32)
        shift[: ts.NT // 2, :, 0] = 3.9
        lp2 = lp + jnp.asarray(shift) * la[..., None]
    else:
        lp2 = lp + 0.9 * la[..., None]
    lp3, lv3, la3, dropped = _run(ts, lp2, lv, la, K=K)
    assert dropped > 0
    assert int(la3.sum()) + dropped == int(la.sum())
    l3 = np.asarray(lp3)[np.asarray(la3)]
    assert l3.min() >= 0.0 and l3.max() < ts.T


@pytest.mark.parametrize("seed", [3, 4])
def test_exchange_matches_sort_rebucket(seed):
    """The exchange path and a full sort re-bucket agree on the particle
    multiset (positions in the global frame + paired velocities)."""
    ts, lp2, lv, la = _setup((8, 8, 8), 4, 512, 2000, 0.9, seed=seed)
    gpos = global_positions(lp2, ts).reshape(-1, 3)
    lp_s, lv_s, la_s, d1 = bucket(gpos, lv.reshape(-1, 3),
                                  la.reshape(-1), ts)
    lp_x, lv_x, la_x, d2 = _run(ts, lp2, lv, la, K=64)
    assert int(d1) == d2 == 0
    assert int(la_s.sum()) == int(la_x.sum())
    np.testing.assert_allclose(_multiset(lp_s, lv_s, la_s, ts),
                               _multiset(lp_x, lv_x, la_x, ts), atol=1e-3)


@pytest.mark.parametrize("start,local,dest,expect", [
    ((1, 2, 3), (-0.5, 4.25, -0.75), (0, 3, 2), (3.5, 0.25, 3.25)),
    ((0, 0, 0), (-0.25, -0.5, -0.75), (3, 3, 3), (3.75, 3.5, 3.25)),
    ((3, 3, 3), (4.5, 4.0, 5.0), (0, 0, 0), (0.5, 0.0, 1.0)),
], ids=["diagonal", "wrap_low", "wrap_high"])
def test_exchange_corner_flow(start, local, dest, expect):
    """A hand-placed corner mover lands in the diagonal-neighbour tile
    (periodic wrap included) with every frame shift applied."""
    ts = TileSpec(grid=(16, 16, 16), T=4, M=1, B=64, chunk=8)
    lp = np.zeros((ts.NT, 64, 3), np.float32)
    lv = np.zeros((ts.NT, 64, 3), np.float32)
    la = np.zeros((ts.NT, 64), bool)
    tid = (start[0] * 4 + start[1]) * 4 + start[2]
    la[tid, 5] = True
    lp[tid, 5] = local
    lv[tid, 5] = [1.0, 2.0, 3.0]
    lp3, lv3, la3, dropped = _run(ts, jnp.asarray(lp), jnp.asarray(lv),
                                  jnp.asarray(la), K=8)
    assert dropped == 0
    al = np.asarray(la3)
    assert al.sum() == 1
    dst = int(np.flatnonzero(al.any(axis=1))[0])
    assert dst == (dest[0] * 4 + dest[1]) * 4 + dest[2]
    slot = int(np.flatnonzero(al[dst])[0])
    np.testing.assert_allclose(np.asarray(lp3)[dst, slot], expect,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(lv3)[dst, slot], [1, 2, 3])


@pytest.mark.parametrize("grid", [(32,), (16, 16)], ids=["1d", "2d"])
def test_exchange_nd(grid):
    """The exchange is dimension-generic: 1-D and 2-D tile grids agree
    with the sort re-bucket too."""
    ts, lp2, lv, la = _setup(grid, 4, 256, 1500, 0.9, seed=5)
    D = len(grid)
    gpos = global_positions(lp2, ts).reshape(-1, D)
    lp_s, lv_s, la_s, d1 = bucket(gpos, lv.reshape(-1, D),
                                  la.reshape(-1), ts)
    lp_x, lv_x, la_x, d2 = _run(ts, lp2, lv, la, K=128)
    assert int(d1) == d2 == 0
    np.testing.assert_allclose(_multiset(lp_s, lv_s, la_s, ts),
                               _multiset(lp_x, lv_x, la_x, ts), atol=1e-3)


@pytest.mark.parametrize("nsub", [(2, 2, 2), (1, 2, 4)])
def test_exchange_cross_device_rolls(cpu_devices, nsub):
    """Under shard_map on the 8-CPU mesh, with neighbour-device rolls
    (parallel.halo.shifted_tiles), the exchange re-homes particles across
    device boundaries exactly like the single-device exchange."""
    from jax.sharding import Mesh, PartitionSpec as P
    from pinc_tpu.parallel.halo import shifted_tiles
    from pinc_tpu.parallel.pic import _shard_map

    ts, lp, lv, la = _setup((16, 16, 16), 4, 128, 3000, 0.9, seed=7)
    ref = _run(ts, lp, lv, la, K=64)
    nt = ts.ntiles
    ln = tuple(n // k for n, k in zip(nt, nsub))
    axes = ("x", "y", "z")
    mesh = Mesh(np.asarray(cpu_devices[:8]).reshape(nsub), axes)
    rolls = [(lambda a, s, ax, d=d: shifted_tiles(a, ax, s, axes[d],
                                                  nsub[d]))
             for d in range(3)]

    def local(planes, al):
        B = al.shape[-1]
        flat = tuple(p.reshape(-1, B) for p in planes)
        out, al2, dropped = rebucket_exchange(flat, al.reshape(-1, B), ln,
                                              ts.T, K=64, roll_fns=rolls)
        for ax in axes:
            dropped = jax.lax.psum(dropped, ax)
        return (tuple(p.reshape(planes[0].shape) for p in out),
                al2.reshape(al.shape), dropped)

    spec = P(*axes, None)
    grid_planes = tuple(p.reshape(nt + (ts.B,)) for p in _planes(lp, lv))
    out, al, dropped = jax.jit(_shard_map(
        local, mesh, in_specs=((spec,) * 6, spec),
        out_specs=((spec,) * 6, spec, P())))(
            grid_planes, la.astype(jnp.float32).reshape(nt + (ts.B,)))
    planes = tuple(p.reshape(ts.NT, ts.B) for p in out)
    lp3, lv3, la3 = _unplanes(planes, al.reshape(ts.NT, ts.B))
    assert int(dropped) == ref[3] == 0
    assert int(la3.sum()) == int(ref[2].sum())
    np.testing.assert_allclose(_multiset(*ref[:3], ts),
                               _multiset(lp3, lv3, la3, ts), atol=1e-3)
