"""Spectral (FFT) Poisson solver.

JAX-native generalization of the reference's 1D FFTW solver
(``sSolve``, src/spectral.c:92-115): solve grad^2 phi = -rho on a fully
periodic grid by dividing the charge spectrum by k^2 and zeroing the DC mode
(which simultaneously enforces charge neutrality, like the explicit
``spectrum[0]=0`` at src/spectral.c:105 and gNeutralizeGrid elsewhere).

The reference supports 1D single-subdomain only (enforced at
src/spectral.c:80-90); XLA's batched FFTs make the ND case free, so this
solver works in any dimension — the natural default for all-periodic decks.

Two spectra are offered:

* ``continuum`` — k_d = 2 pi n_d / L_d, matching the reference's
  (N/2 pi n)^2 factor exactly in 1D.
* ``finite-difference`` — k_d -> 2 sin(pi n_d / L_d), the exact inverse of
  the 2nd-order 7-point Laplacian (gFinDiff2nd), so residuals vanish to
  machine precision against grid.laplacian; useful for multigrid
  cross-checks.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PincConfig
from ..registry import SOLVERS


def _inv_k2(shape: Sequence[int], fd: bool, dtype) -> np.ndarray:
    """Precomputed 1/k^2 over the rfftn spectrum layout (last axis halved),
    with the DC entry set to 0."""
    nd = len(shape)
    k2 = np.zeros([s if d < nd - 1 else s // 2 + 1
                   for d, s in enumerate(shape)], dtype=np.float64)
    for d, L in enumerate(shape):
        n = np.fft.fftfreq(L) * L          # integer mode numbers
        if d == nd - 1:
            n = n[: L // 2 + 1]
            n[-1] = L // 2                  # rfft Nyquist bin
        if fd:
            kd2 = (2.0 * np.sin(np.pi * n / L)) ** 2
        else:
            kd2 = (2.0 * np.pi * n / L) ** 2
        sh = [1] * nd
        sh[d] = len(n)
        k2 = k2 + kd2.reshape(sh)
    inv = np.zeros_like(k2)
    nz = k2 != 0.0
    inv[nz] = 1.0 / k2[nz]
    return inv.astype(dtype)


class SpectralSolver:
    """Callable solver: phi = solve(rho).  The 1/k^2 table is baked in as a
    constant so the jitted step embeds it once."""

    def __init__(self, shape: Sequence[int], fd: bool = False,
                 dtype=jnp.float32):
        self.shape = tuple(shape)
        self.fd = fd          # exposed so distributed variants match it
        self._inv_k2 = jnp.asarray(_inv_k2(self.shape, fd, np.float32))
        self.dtype = dtype

    def __call__(self, rho: jax.Array) -> jax.Array:
        spec = jnp.fft.rfftn(rho.astype(jnp.float32))
        spec = spec * self._inv_k2
        phi = jnp.fft.irfftn(spec, s=self.shape)
        return phi.astype(self.dtype)


def _validate_periodic(cfg: PincConfig):
    nd = cfg.get_int("grid:ndims")
    bnds = cfg.get_str_arr("grid:boundaries", 2 * nd)
    if any(b.strip().upper() != "PERIODIC" for b in bnds):
        raise ValueError("spectral solver requires all-PERIODIC boundaries "
                         "(reference: sSolver_set, src/spectral.c:80-90)")


def _make_spectral(fd: bool):
    def factory(cfg: PincConfig):
        from ..grid import GridSpec
        spec = GridSpec.from_config(cfg)
        return SpectralSolver(spec.global_size, fd=fd, dtype=spec.dtype)
    return factory


SOLVERS.register("sSolve", _validate_periodic)(_make_spectral(False))
SOLVERS.register("sSolver", _validate_periodic)(_make_spectral(False))
SOLVERS.register("spectral", _validate_periodic)(_make_spectral(False))
SOLVERS.register("spectralFD", _validate_periodic)(_make_spectral(True))
