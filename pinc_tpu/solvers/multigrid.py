"""Geometric multigrid Poisson solver.

JAX-native rebuild of the reference's ``src/multigrid.c``: solve
``grad^2 phi = -rho`` with a hierarchy of 2x-coarsened grids, red-black
Gauss-Seidel (or damped Jacobi) smoothing, half-weighting restriction and
multilinear prolongation, driven to an RMS-residual tolerance
(``mgSolveRaw``, src/multigrid.c:1688-1724, tol 1e-10).

Design notes versus the C:

* The C smoother sweeps pointers serially with per-color halo exchanges
  after every half-sweep (mgGS3D, src/multigrid.c:683-767 — 2 MPI
  exchanges x nDims per iteration).  Here one color update is a dense
  masked stencil over the whole block — a handful of ``jnp.roll``s that XLA
  fuses into one VPU pass; on the sharded path a single halo permute per
  half-sweep replaces the Sendrecv storm.
* Restriction (mgHalfRestrict3D, src/multigrid.c:844-911) = stencil pass +
  stride-2 slice.  Prolongation (mgBilinProl3D, src/multigrid.c:1127-1238)
  = zero-stuff + per-dimension linear fill; its three internal halo
  exchanges disappear on a periodic block.
* Cycles (V regular/recursive, FMG, W — src/multigrid.c:1496-1683) are
  Python recursion over a *static* level list, unrolled at trace time; the
  tolerance loop is a ``lax.while_loop`` so the whole solve stays on
  device.
* Boundary conditions follow gBnd (src/grid.c:922-1023) via bc.py:
  Dirichlet planes are clamped and masked out of the smoother; Neumann
  ghosts are materialized by pad_bc.  Coarse levels solve the error
  equation with homogeneous versions of the same BCs.
* Levels with no Dirichlet edge have a nullspace (the mean); the rhs is
  re-neutralized at every level exactly like the gNeutralizeGrid calls in
  mgVRegular (src/multigrid.c:1586-1626).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bc import (BCSpec, clamp_dirichlet, interior_mask, laplacian_bc,
                  neighbor_sum_bc)
from ..config import PincConfig
from ..grid import BndType
from ..registry import SOLVERS


# ---------------------------------------------------------------------------
# Stencil primitives
# ---------------------------------------------------------------------------

def _neighbor_sum_periodic(phi: jax.Array) -> jax.Array:
    out = None
    for d in range(phi.ndim):
        s = jnp.roll(phi, 1, axis=d) + jnp.roll(phi, -1, axis=d)
        out = s if out is None else out + s
    return out


def _checkerboard(shape: Sequence[int]) -> np.ndarray:
    """Red mask: (i+j+k+...) % 2 == 0.  Requires even extents per dim for a
    consistent periodic coloring (true for all power-of-two MG levels)."""
    acc = np.zeros(shape, dtype=np.int64)
    for d, L in enumerate(shape):
        sh = [1] * len(shape)
        sh[d] = L
        acc = acc + np.arange(L).reshape(sh)
    return (acc % 2) == 0


def _level_ops(shape, bc: Optional[BCSpec]):
    """(neighbor_sum, update_mask, laplacian) for one level."""
    if bc is None or bc.periodic:
        nsum = _neighbor_sum_periodic
        mask = None
        lap = lambda phi: nsum(phi) - 2.0 * phi.ndim * phi
    else:
        nsum = partial(neighbor_sum_bc, bc=bc)
        m = interior_mask(shape, bc)
        mask = None if m.all() else jnp.asarray(m)
        lap = partial(laplacian_bc, bc=bc)
    return nsum, mask, lap


# ---------------------------------------------------------------------------
# Smoothers.  All solve grad^2 phi = -rho: pointwise update is
# phi_i = (sum(neighbors) + rho_i) / (2*D).
# ---------------------------------------------------------------------------

def make_gauss_seidel_rb(shape: Sequence[int], n_iter: int,
                         bc: Optional[BCSpec] = None) -> Callable:
    """Red-black Gauss-Seidel (mgGS2D/3D/ND, src/multigrid.c:584-837):
    update red sites from black neighbors, then black from updated red."""
    red = jnp.asarray(_checkerboard(shape))
    nsum, mask, _ = _level_ops(shape, bc)
    red_upd = red if mask is None else (red & mask)
    blk_upd = ~red if mask is None else (~red & mask)

    def smooth(phi: jax.Array, rho: jax.Array) -> jax.Array:
        inv2d = 1.0 / (2.0 * phi.ndim)

        def one_iter(_, phi):
            upd = (nsum(phi) + rho) * inv2d
            phi = jnp.where(red_upd, upd, phi)
            upd = (nsum(phi) + rho) * inv2d
            phi = jnp.where(blk_upd, upd, phi)
            return phi
        return jax.lax.fori_loop(0, n_iter, one_iter, phi)
    return smooth


def make_jacobi(shape: Sequence[int], n_iter: int,
                bc: Optional[BCSpec] = None,
                omega: float = 2.0 / 3.0) -> Callable:
    """Damped Jacobi (mgJacobi1D/3D/ND, src/multigrid.c:413-552; damping
    added — plain Jacobi does not damp the highest mode)."""
    nsum, mask, _ = _level_ops(shape, bc)

    def smooth(phi: jax.Array, rho: jax.Array) -> jax.Array:
        inv2d = 1.0 / (2.0 * phi.ndim)

        def one_iter(_, phi):
            upd = (nsum(phi) + rho) * inv2d
            new = phi + omega * (upd - phi)
            return new if mask is None else jnp.where(mask, new, phi)
        return jax.lax.fori_loop(0, n_iter, one_iter, phi)
    return smooth


SMOOTHERS = {
    "gaussseidelrb": make_gauss_seidel_rb,
    "gaussseidelrbnd": make_gauss_seidel_rb,
    "gaussseidel": make_gauss_seidel_rb,
    "jacobi": make_jacobi,
    "jacobind": make_jacobi,
}


# ---------------------------------------------------------------------------
# Transfer operators
# ---------------------------------------------------------------------------

def _pad_zero_or_wrap(x: jax.Array, periodic_dims: Sequence[bool]) -> jax.Array:
    """Pad one plane per side: wrap on periodic dims, zeros elsewhere
    (defects vanish at clamped boundaries)."""
    for d in range(x.ndim):
        n = x.shape[d]
        if periodic_dims[d]:
            lo = jax.lax.slice_in_dim(x, n - 1, n, axis=d)
            hi = jax.lax.slice_in_dim(x, 0, 1, axis=d)
        else:
            shape = list(x.shape)
            shape[d] = 1
            lo = jnp.zeros(shape, x.dtype)
            hi = lo
        x = jnp.concatenate([lo, x, hi], axis=d)
    return x


def _periodic_dims(bc: Optional[BCSpec], nd: int) -> List[bool]:
    if bc is None:
        return [True] * nd
    return [bc.lower[d] is BndType.PERIODIC and bc.upper[d] is BndType.PERIODIC
            for d in range(nd)]


def restrict_half_weight(fine: jax.Array,
                         bc: Optional[BCSpec] = None) -> jax.Array:
    """Half-weighting restriction (mgHalfRestrict3D/ND,
    src/multigrid.c:844-1022): coarse = 1/2 center + 1/(4D) face neighbors,
    sampled at even fine nodes."""
    D = fine.ndim
    pdims = _periodic_dims(bc, D)
    p = _pad_zero_or_wrap(fine, pdims)
    nsum = None
    for d in range(D):
        n = p.shape[d]
        s = (jax.lax.slice_in_dim(p, 2, n, axis=d)
             + jax.lax.slice_in_dim(p, 0, n - 2, axis=d))
        for dd in range(D):
            if s.shape[dd] != fine.shape[dd]:
                s = jax.lax.slice_in_dim(s, 1, s.shape[dd] - 1, axis=dd)
        nsum = s if nsum is None else nsum + s
    stencil = 0.5 * fine + (0.25 / D) * nsum
    slicer = tuple(slice(None, None, 2) for _ in range(D))
    return stencil[slicer]


def prolong_multilinear(coarse: jax.Array,
                        bc: Optional[BCSpec] = None) -> jax.Array:
    """Multilinear prolongation (mgBilinProl3D/ND, src/multigrid.c:1096-1238):
    zero-stuff even nodes then fill odd nodes dimension by dimension with
    averages of already-filled neighbors (periodic wrap or edge clamp)."""
    D = coarse.ndim
    pdims = _periodic_dims(bc, D)
    fine_shape = tuple(2 * s for s in coarse.shape)
    fine = jnp.zeros(fine_shape, dtype=coarse.dtype)
    slicer = tuple(slice(None, None, 2) for _ in range(D))
    fine = fine.at[slicer].set(coarse)
    for d in range(D):
        nxt = jnp.roll(fine, -2, axis=d)
        if not pdims[d]:
            # edge clamp: the last odd plane averages with the last even one
            n = fine.shape[d]
            nxt = jax.lax.concatenate(
                [jax.lax.slice_in_dim(fine, 2, n, axis=d),
                 jax.lax.slice_in_dim(fine, n - 2, n - 1, axis=d),
                 jax.lax.slice_in_dim(fine, n - 1, n, axis=d)], dimension=d)
        avg = 0.5 * (fine + nxt)
        odd = [slice(None)] * D
        odd[d] = slice(1, None, 2)
        src = [slice(None)] * D
        src[d] = slice(0, None, 2)
        fine = fine.at[tuple(odd)].set(avg[tuple(src)])
    return fine


RESTRICTORS = {
    "halfweight": restrict_half_weight,
    "halfweightnd": restrict_half_weight,
}
PROLONGATORS = {
    "bilinear": prolong_multilinear,
    "bilinearnd": prolong_multilinear,
}


# ---------------------------------------------------------------------------
# Cycles + tolerance driver
# ---------------------------------------------------------------------------

def _neutral(x: jax.Array) -> jax.Array:
    return x - jnp.mean(x)


class MultigridSolver:
    """Callable phi = solve(rho).  All level geometry is static; the cycle
    is unrolled at trace time and the outer tolerance loop is a
    lax.while_loop (mgSolveRaw semantics, src/multigrid.c:1688-1724)."""

    def __init__(self, shape: Sequence[int], n_levels: int = 4,
                 n_pre: int = 10, n_post: int = 10, n_coarse: int = 10,
                 cycle: str = "mgvrecursive", smoother: str = "gaussseidelrb",
                 max_cycles: int = 15, tol: float = 1e-10,
                 bc: Optional[BCSpec] = None, dtype=jnp.float32):
        shape = tuple(shape)
        for s in shape:
            if s % (1 << (n_levels - 1)) != 0:
                raise ValueError(
                    f"grid extent {s} not divisible by 2^{n_levels-1} "
                    f"(mgAllocSubGrids check, src/multigrid.c:317-329)")
        self.shape = shape
        self.n_levels = n_levels
        self.cycle = cycle.lower()
        self.max_cycles = max_cycles
        self.tol = tol
        self.dtype = dtype
        if bc is not None and bc.periodic:
            bc = None
        self.bc = bc
        # the mean is only fixed when some Dirichlet plane pins phi
        self._has_nullspace = bc is None or not any(
            b is BndType.DIRICHLET for b in bc.lower + bc.upper)

        self._shapes: List[Tuple[int, ...]] = [
            tuple(s >> l for s in shape) for l in range(n_levels)]
        self._bcs: List[Optional[BCSpec]] = [
            bc if l == 0 else (None if bc is None else bc.homogeneous())
            for l in range(n_levels)]
        mk = SMOOTHERS[smoother.lower()]
        self._pre = [mk(s, n_pre, b) for s, b in zip(self._shapes, self._bcs)]
        self._post = [mk(s, n_post, b) for s, b in zip(self._shapes, self._bcs)]
        self._coarse = mk(self._shapes[-1], n_coarse, self._bcs[-1])
        self._laps = [_level_ops(s, b)[2]
                      for s, b in zip(self._shapes, self._bcs)]

    def _maybe_neutral(self, x: jax.Array, level: int) -> jax.Array:
        return _neutral(x) if self._has_nullspace else x

    # ------------------------------------------------------------- v-cycle
    def _vcycle(self, level: int, phi: jax.Array, rho: jax.Array) -> jax.Array:
        if level == self.n_levels - 1:
            return self._coarse(phi, rho)
        phi = self._pre[level](phi, rho)
        defect = rho + self._laps[level](phi)          # mgResidual, mc:1385
        defect = self._maybe_neutral(defect, level)
        rhs_c = restrict_half_weight(defect, self._bcs[level])
        err_c = jnp.zeros(self._shapes[level + 1], dtype=phi.dtype)
        err_c = self._vcycle(level + 1, err_c, rhs_c)
        if self.cycle in ("mgw", "w"):                 # W-cycle: recurse twice
            err_c = self._vcycle(level + 1, err_c, rhs_c)
        phi = phi + prolong_multilinear(err_c, self._bcs[level])
        if self._bcs[level] is not None:
            phi = clamp_dirichlet(phi, self._bcs[level])
        phi = self._post[level](phi, rho)
        return phi

    def _fmg(self, rho: jax.Array) -> jax.Array:
        """Full multigrid (mgFMG, src/multigrid.c:1652-1673): solve coarsest
        first, prolong up, V-cycle at each level."""
        rhs = [rho]
        for l in range(1, self.n_levels):
            rhs.append(restrict_half_weight(rhs[-1], self._bcs[l - 1]))
        phi = jnp.zeros(self._shapes[-1], dtype=rho.dtype)
        phi = self._coarse(phi, rhs[-1])
        for l in range(self.n_levels - 2, -1, -1):
            phi = prolong_multilinear(phi, self._bcs[l])
            phi = self._vcycle(l, phi, rhs[l])
        return phi

    # --------------------------------------------------------------- solve
    def __call__(self, rho: jax.Array, phi0: jax.Array | None = None) -> jax.Array:
        return self.solve_with_stats(rho, phi0)[0]

    def solve_with_stats(self, rho: jax.Array, phi0: jax.Array | None = None
                         ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """-> (phi, n_cycles, rms_residual): the measured V-cycle count to
        tolerance (what the reference's mgMode persists to timer.xy.h5,
        src/multigrid.c:1998-2004) and the final RMS residual."""
        rho = rho.astype(self.dtype)
        if self._has_nullspace:
            rho = _neutral(rho)
        if phi0 is None:
            phi0 = jnp.zeros(self.shape, dtype=self.dtype)
        if self.bc is not None:
            phi0 = clamp_dirichlet(phi0, self.bc)
        if self.cycle in ("mgfmg", "fmg"):
            phi0 = self._fmg(rho)

        tol2 = jnp.asarray(self.tol ** 2, dtype=jnp.float32)
        lap0 = self._laps[0]
        if self.bc is not None:
            resid_mask = jnp.asarray(interior_mask(self.shape, self.bc))
        else:
            resid_mask = None

        def rms2(phi):
            r = rho + lap0(phi)
            if resid_mask is not None:
                r = jnp.where(resid_mask, r, 0.0)
            return jnp.mean(jnp.square(r.astype(jnp.float32)))

        def cond(carry):
            phi, i, r2 = carry
            return jnp.logical_and(i < self.max_cycles, r2 > tol2)

        def body(carry):
            phi, i, _ = carry
            phi = self._vcycle(0, phi, rho)
            return (phi, i + 1, rms2(phi))

        phi, n_cycles, r2 = jax.lax.while_loop(
            cond, body, (phi0, jnp.asarray(0), rms2(phi0)))
        if self._has_nullspace:
            phi = _neutral(phi)
        if self.bc is not None:
            phi = clamp_dirichlet(phi, self.bc)
        return phi, n_cycles, jnp.sqrt(r2)


# ---------------------------------------------------------------------------
# Registry binding — reads the [multigrid] ini section
# (mgSetSolver/getMgAlgo, src/multigrid.c:28-125)
# ---------------------------------------------------------------------------

def make_from_config(cfg: PincConfig) -> MultigridSolver:
    from ..grid import GridSpec
    spec = GridSpec.from_config(cfg)
    dtype = spec.dtype
    default_tol = 1e-10 if dtype == jnp.float64 else 5e-6
    bc = BCSpec.from_config(cfg)
    return MultigridSolver(
        shape=spec.global_size,
        n_levels=cfg.get_int("multigrid:mglevels", 4),
        n_pre=cfg.get_int("multigrid:npresmooth", 10),
        n_post=cfg.get_int("multigrid:npostsmooth", 10),
        n_coarse=cfg.get_int("multigrid:ncoarsesolve", 10),
        cycle=cfg.get_str("multigrid:cycle", "mgVRecursive"),
        smoother=cfg.get_str("multigrid:presmooth", "gaussSeidelRB"),
        max_cycles=cfg.get_int("multigrid:mgcycles", 15),
        tol=cfg.get_double("multigrid:tol", default_tol),
        bc=None if bc.periodic else bc,
        dtype=dtype,
    )


SOLVERS.register("mgSolve")(make_from_config)
SOLVERS.register("mgSolver")(make_from_config)
SOLVERS.register("multigrid")(make_from_config)
