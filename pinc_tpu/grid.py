"""Grid representation and whole-grid field operations.

JAX-native redesign of the reference's ``Grid`` (``src/core.h:261-277``,
``src/grid.c``).  The C code stores one flat lexicographic array with ghost
layers baked in and walks it with recursive strided pointer arithmetic; here
a field is simply a ``jnp.ndarray`` of shape ``(*dims, nValues)`` (vector
fields) or ``(*dims,)`` (scalars) holding only *true* grid nodes.  Ghost
layers never exist on the single-device path (periodic shifts via
``jnp.roll`` compile to cheap XLA slices/concats); on the sharded path they
are materialized transiently inside ``shard_map`` by ``parallel.halo``.

Static metadata lives in :class:`GridSpec`; field data is functional (ops
return new arrays), which is what XLA wants — no in-place mutation, full
fusion freedom.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from .config import PincConfig


class BndType(Enum):
    """Boundary types per edge (reference bndType enum, src/core.h:145-150)."""
    PERIODIC = "PERIODIC"
    DIRICHLET = "DIRICHLET"
    NEUMANN = "NEUMANN"


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (replaces Grid's size/trueSize/sizeProd/bnd
    bookkeeping, ``gAlloc``, src/grid.c:413-500)."""

    n_dims: int
    true_size: Tuple[int, ...]          # local nodes per subdomain, per dim
    n_subdomains: Tuple[int, ...]       # device-mesh extent per dim
    boundaries: Tuple[BndType, ...]     # lower+upper per dim, len 2*n_dims
    dtype: jnp.dtype = jnp.float32

    @property
    def global_size(self) -> Tuple[int, ...]:
        return tuple(t * n for t, n in zip(self.true_size, self.n_subdomains))

    @property
    def global_volume(self) -> int:
        return math.prod(self.global_size)

    @property
    def periodic(self) -> bool:
        return all(b is BndType.PERIODIC for b in self.boundaries)

    @classmethod
    def from_config(cls, cfg: PincConfig, dtype=None) -> "GridSpec":
        nd = cfg.get_int("grid:ndims")
        true_size = tuple(cfg.get_int_arr("grid:truesize", nd))
        nsub = tuple(cfg.get_int_arr("grid:nsubdomains", nd))
        bnd_names = cfg.get_str_arr("grid:boundaries", 2 * nd)
        bnd = tuple(BndType(b.strip().upper()) for b in bnd_names)
        if dtype is None:
            prec = cfg.get_str("methods:precision", "single").lower()
            dtype = jnp.float64 if prec == "double" else jnp.float32
        return cls(n_dims=nd, true_size=true_size, n_subdomains=nsub,
                   boundaries=bnd, dtype=dtype)

    # ------------------------------------------------------------- factories
    def zeros(self, n_values: int = 0) -> jnp.ndarray:
        shape = self.global_size if n_values == 0 else (*self.global_size, n_values)
        return jnp.zeros(shape, dtype=self.dtype)

    def local_zeros(self, n_values: int = 0) -> jnp.ndarray:
        shape = self.true_size if n_values == 0 else (*self.true_size, n_values)
        return jnp.zeros(shape, dtype=self.dtype)


# ---------------------------------------------------------------------------
# Differential operators (periodic single-block versions).
# Reference: gFinDiff1st (src/grid.c:226-261), gFinDiff2nd3D/ND
# (src/grid.c:264-334).  jnp.roll on a periodic block == reading through the
# wrap-around ghost layer.
# ---------------------------------------------------------------------------

def gradient(phi: jnp.ndarray) -> jnp.ndarray:
    """Centered first difference, one vector component per spatial dim:
    out[..., d] = 0.5*(phi[i+1] - phi[i-1]) along d (gFinDiff1st).  The
    caller negates for E = -grad(phi) exactly like main.c:178-180."""
    nd = phi.ndim
    comps = [0.5 * (jnp.roll(phi, -1, axis=d) - jnp.roll(phi, 1, axis=d))
             for d in range(nd)]
    return jnp.stack(comps, axis=-1)


def laplacian(phi: jnp.ndarray) -> jnp.ndarray:
    """Second-order stencil sum_d (phi[i-1] - 2 phi[i] + phi[i+1])
    (gFinDiff2ndND, src/grid.c:264-294), periodic."""
    nd = phi.ndim
    out = -2.0 * nd * phi
    for d in range(nd):
        out = out + jnp.roll(phi, -1, axis=d) + jnp.roll(phi, 1, axis=d)
    return out


def neutralize(rho: jnp.ndarray) -> jnp.ndarray:
    """Remove the mean charge (gNeutralizeGrid, src/grid.c:730-752); on the
    sharded path the mean is a psum — here a plain global mean."""
    return rho - jnp.mean(rho)


def potential_energy(rho: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
    """Total field energy 0.5*sum(rho*phi) over true nodes
    (gPotEnergy, src/grid.c:1276-1321)."""
    return 0.5 * jnp.sum(rho.astype(jnp.float32) * phi.astype(jnp.float32))


# ---------------------------------------------------------------------------
# Analytic field fillers for solver tests
# (gFillSin/gFillPolynomial & friends, src/grid.c:1350-1744).
# ---------------------------------------------------------------------------

def fill_sin(spec: GridSpec, modes: List[int] | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (rho, phi_exact) for rho = prod_d sin(2 pi m_d x_d / L_d),
    with phi the exact continuum solution of grad^2 phi = -rho."""
    L = spec.global_size
    nd = spec.n_dims
    modes = modes or [1] * nd
    axes = [np.arange(l, dtype=np.float64) for l in L]
    mesh = np.meshgrid(*axes, indexing="ij")
    rho = np.ones(L, dtype=np.float64)
    k2 = 0.0
    for d in range(nd):
        k = 2.0 * np.pi * modes[d] / L[d]
        rho = rho * np.sin(k * mesh[d])
        k2 += k * k
    phi = rho / k2
    return rho, phi


def fill_sin_dirichlet(spec: GridSpec,
                       modes: List[int] | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Dirichlet-compatible sinusoid fixture: phi = prod_d sin(pi m_d x_d
    / (L_d - 1)) vanishes on every wall, rho = k^2 phi solves
    grad^2 phi = -rho with phi=0 Dirichlet BCs (the BC-aware counterpart
    of gFillSin for bounded decks — the reference's error-scaling study
    was periodic-only, src/multigrid.c:1734-1851)."""
    L = spec.global_size
    nd = spec.n_dims
    modes = modes or [1] * nd
    axes = [np.arange(l, dtype=np.float64) for l in L]
    mesh = np.meshgrid(*axes, indexing="ij")
    phi = np.ones(L, dtype=np.float64)
    k2 = 0.0
    for d in range(nd):
        k = np.pi * modes[d] / (L[d] - 1)
        phi = phi * np.sin(k * mesh[d])
        k2 += k * k
    return k2 * phi, phi


def fill_heavi(spec: GridSpec, d: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Square-wave fixture along dim ``d`` (gFillHeavi/gFillHeaviSol,
    src/grid.c:1350-1475): rho = +1 on the first half, -1 on the second,
    0 at the two transition planes; phi_exact is the piecewise parabola
    0.5*(L/2 - x)*x mirrored, the 1D solution of phi'' = -rho (constant
    along the other dims)."""
    L = spec.global_size
    n = L[d]
    half = n // 2
    x = np.arange(n, dtype=np.float64)
    rho1 = np.where(x < half, 1.0, -1.0)
    rho1[0] = 0.0
    rho1[half] = 0.0
    sol1 = np.where(x < half, 0.5 * (half - x) * x,
                    -0.5 * (half - (x - half)) * (x - half))
    shape = [1] * spec.n_dims
    shape[d] = n
    rho = np.broadcast_to(rho1.reshape(shape), L).copy()
    phi = np.broadcast_to(sol1.reshape(shape), L).copy()
    return rho, phi


def fill_point(spec: GridSpec,
               value: float = -1e2) -> Tuple[np.ndarray, np.ndarray]:
    """Point charge at the grid center (gFillPoint/gFillPointSol,
    src/grid.c:1496-1560): rho = value at the center node, phi_exact the
    vacuum Green's function 1/r (the reference's qualitative fixture —
    unnormalized, 0 at the singular node)."""
    L = spec.global_size
    center = tuple(l // 2 for l in L)
    rho = np.zeros(L, dtype=np.float64)
    rho[center] = value
    axes = [np.arange(l, dtype=np.float64) - c for l, c in zip(L, center)]
    mesh = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(sum(m * m for m in mesh))
    with np.errstate(divide="ignore"):
        phi = np.where(r > 1e-5, 1.0 / np.maximum(r, 1e-5), 0.0)
    return rho, phi


def fill_exp(spec: GridSpec) -> np.ndarray:
    """Gaussian bump exp(-10 |x - L/2|^2 / L^2) (gFillExp,
    src/grid.c:1686-1716); no closed-form solution in the reference."""
    L = spec.global_size
    axes = [np.arange(l, dtype=np.float64) for l in L]
    mesh = np.meshgrid(*axes, indexing="ij")
    half = L[0] / 2
    norm = 1.0 / (L[0] * L[0])
    r2 = sum((m - half) ** 2 * norm for m in mesh)
    return np.exp(-10.0 * r2)


def fill_rng(spec: GridSpec, seed: int = 0) -> np.ndarray:
    """Unit-gaussian noise field (gFillRng, src/grid.c:1718-1727)."""
    return np.random.default_rng(seed).standard_normal(spec.global_size)


def fill_cst(spec: GridSpec, value: float = 1.0) -> np.ndarray:
    """Constant field (gFillCst, src/grid.c:1729-1739)."""
    return np.full(spec.global_size, value, dtype=np.float64)


def fill_polynomial(spec: GridSpec) -> Tuple[np.ndarray, np.ndarray]:
    """x^2 along the first dim (gFillPolynomial, src/grid.c:1477-1494),
    paired with its exact FD laplacian (constant 2) for transfer-operator
    tests."""
    L = spec.global_size
    shape = [1] * spec.n_dims
    shape[0] = L[0]
    x2 = (np.arange(L[0], dtype=np.float64) ** 2).reshape(shape)
    phi = np.broadcast_to(x2, L).copy()
    lap = np.full(L, 2.0)
    return phi, lap


#: fixture registry for mgModeErrorScaling — name -> (rho, phi_exact)
#: builder; names match the reference's gFill* family
FILL_FIXTURES = {
    "sin": fill_sin,
    "sindirichlet": fill_sin_dirichlet,
    "heavi": fill_heavi,
    "point": fill_point,
}
