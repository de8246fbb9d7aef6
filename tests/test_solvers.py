"""Poisson solver tests: analytic sinusoid fixtures (the JAX equivalent of
mgModeErrorScaling, src/multigrid.c:1734-1851) and cross-solver
consistency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.grid import GridSpec, BndType, fill_sin, laplacian
from pinc_tpu.solvers.multigrid import MultigridSolver
from pinc_tpu.solvers.spectral import SpectralSolver


def spec3d(n):
    return GridSpec(n_dims=3, true_size=(n, n, n), n_subdomains=(1, 1, 1),
                    boundaries=(BndType.PERIODIC,) * 6)


def rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, dtype=np.float64)))))


def test_spectral_fd_exact_inverse():
    """The finite-difference spectrum must invert grid.laplacian to
    round-off: lap(phi) + rho == 0."""
    spec = spec3d(16)
    rho_np, _ = fill_sin(spec)
    solver = SpectralSolver(spec.global_size, fd=True)
    phi = solver(jnp.asarray(rho_np, dtype=jnp.float32))
    resid = laplacian(phi) + jnp.asarray(rho_np, dtype=jnp.float32)
    assert rms(resid) < 1e-5


def test_spectral_continuum_matches_analytic():
    spec = spec3d(32)
    rho_np, phi_exact = fill_sin(spec)
    solver = SpectralSolver(spec.global_size, fd=False)
    phi = np.asarray(solver(jnp.asarray(rho_np, dtype=jnp.float32)))
    err = rms(phi - phi_exact) / rms(phi_exact)
    assert err < 1e-4


def test_spectral_1d_reference_factor():
    """1D: the continuum spectrum is the reference's (N/2 pi n)^2 factor
    (src/spectral.c:105-109)."""
    N = 32
    solver = SpectralSolver((N,), fd=False)
    rho = jnp.asarray(np.sin(2 * np.pi * np.arange(N) / N), dtype=jnp.float32)
    phi = np.asarray(solver(rho))
    expect = np.asarray(rho) * (N / (2 * np.pi)) ** 2
    assert np.allclose(phi, expect, rtol=1e-4, atol=1e-4)


def test_multigrid_matches_fd_spectral():
    """MG solves the same discrete system as the FD spectral solver; on a
    neutral random rhs they must agree."""
    spec = spec3d(32)
    rng = np.random.default_rng(0)
    rho_np = rng.normal(size=spec.global_size).astype(np.float32)
    rho_np -= rho_np.mean()
    rho = jnp.asarray(rho_np)

    fd = SpectralSolver(spec.global_size, fd=True)
    mg = MultigridSolver(spec.global_size, n_levels=4, n_pre=3, n_post=3,
                         n_coarse=20, max_cycles=30, tol=1e-6)
    phi_fd = np.asarray(fd(rho))
    phi_mg = np.asarray(mg(rho))
    phi_fd = phi_fd - phi_fd.mean()
    phi_mg = phi_mg - phi_mg.mean()
    # float32 smoothing floor on a pure-noise rhs: ~1e-3 relative
    assert rms(phi_fd - phi_mg) / max(rms(phi_fd), 1e-12) < 5e-3


def test_multigrid_residual_convergence():
    spec = spec3d(32)
    rho_np, _ = fill_sin(spec)
    rho = jnp.asarray(rho_np, dtype=jnp.float32)
    mg = MultigridSolver(spec.global_size, n_levels=4, n_pre=3, n_post=3,
                         n_coarse=20, max_cycles=20, tol=1e-7)
    phi = mg(rho)
    resid = laplacian(phi) + rho
    # |phi| ~ (L/2pi k)^2 * |rho| >> |rho|, so the f32 rounding floor of the
    # residual is ~eps*2D*|phi| ~ 3e-4 relative to rho
    assert rms(resid) / rms(rho_np) < 1e-3


def test_multigrid_error_scaling_order2():
    """Discretization error vs the continuum solution halves twice when the
    resolution doubles (measured order ~2, mgErrorScaling harness)."""
    errs = []
    for n in (16, 32):
        spec = spec3d(n)
        rho_np, phi_exact = fill_sin(spec)
        mg = MultigridSolver(spec.global_size, n_levels=3, n_pre=3, n_post=3,
                             n_coarse=30, max_cycles=30, tol=1e-7)
        phi = np.asarray(mg(jnp.asarray(rho_np, dtype=jnp.float32)))
        phi = phi - phi.mean()
        pe = phi_exact - phi_exact.mean()
        # the analytic phi has continuum normalization; scale-free error:
        errs.append(rms(phi - pe) / rms(pe))
    order = np.log2(errs[0] / errs[1])
    assert order > 1.5, (errs, order)


def test_multigrid_w_cycle_and_fmg():
    spec = spec3d(16)
    rho_np, _ = fill_sin(spec)
    rho = jnp.asarray(rho_np, dtype=jnp.float32)
    for cycle in ("mgW", "mgFMG"):
        mg = MultigridSolver(spec.global_size, n_levels=3, n_pre=2, n_post=2,
                             n_coarse=10, cycle=cycle, max_cycles=20, tol=1e-6)
        phi = mg(rho)
        assert rms(laplacian(phi) + rho) < 1e-4


def test_multigrid_divisibility_check():
    with pytest.raises(ValueError):
        MultigridSolver((12, 12, 12), n_levels=4)


def test_solvers_jit_compatible():
    spec = spec3d(16)
    rho_np, _ = fill_sin(spec)
    rho = jnp.asarray(rho_np, dtype=jnp.float32)
    mg = MultigridSolver(spec.global_size, n_levels=3, n_pre=2, n_post=2,
                         n_coarse=10, max_cycles=5, tol=1e-6)
    sp = SpectralSolver(spec.global_size)
    phi1 = jax.jit(mg)(rho)
    phi2 = jax.jit(sp)(rho)
    assert np.isfinite(np.asarray(phi1)).all()
    assert np.isfinite(np.asarray(phi2)).all()


# ---------------------------------------------------------------------------
# gFill fixture family (gFillSin/Heavi/Point/Exp/... + exact solutions,
# src/grid.c:1350-1744) and BC-aware error scaling (VERDICT item 7)
# ---------------------------------------------------------------------------

def _dirichlet_bc(nd=3, value=0.0):
    from pinc_tpu.bc import BCSpec
    return BCSpec(lower=(BndType.DIRICHLET,) * nd,
                  upper=(BndType.DIRICHLET,) * nd,
                  lower_value=(value,) * nd, upper_value=(value,) * nd)


def test_fill_heavi_fd_exact():
    """The Heaviside fixture's parabola solution inverts the FD laplacian
    EXACTLY (piecewise quadratic): lap(phi_exact) == -rho everywhere,
    including the transition planes (gFillHeavi/gFillHeaviSol,
    src/grid.c:1350-1475)."""
    from pinc_tpu.grid import fill_heavi
    spec = spec3d(16)
    rho, phi = fill_heavi(spec, d=0)
    lap = np.asarray(laplacian(jnp.asarray(phi)))
    assert np.abs(lap + rho).max() < 1e-10


def test_fill_sin_dirichlet_consistent():
    """fill_sin_dirichlet: phi vanishes on every wall and its continuum
    laplacian is -rho (discretization error O(h^2))."""
    from pinc_tpu.bc import laplacian_bc
    from pinc_tpu.grid import fill_sin_dirichlet
    spec = spec3d(32)
    rho, phi = fill_sin_dirichlet(spec)
    for d in range(3):
        sl = [slice(None)] * 3
        for edge in (0, -1):
            sl[d] = edge
            assert np.abs(phi[tuple(sl)]).max() < 1e-12
    bc = _dirichlet_bc()
    lap = np.asarray(laplacian_bc(jnp.asarray(phi), bc=bc.homogeneous()))
    interior = np.abs(lap + rho)[1:-1, 1:-1, 1:-1]
    assert interior.max() < np.abs(rho).max() * 0.02


def test_multigrid_heavi_solve():
    """MG solve of the square wave reproduces the parabola to solver
    tolerance (FD-exact fixture, so the residual IS the error)."""
    from pinc_tpu.grid import fill_heavi
    spec = spec3d(32)
    rho, phi_exact = fill_heavi(spec, d=0)
    mg = MultigridSolver(spec.global_size, n_levels=4, n_pre=3, n_post=3,
                         n_coarse=30, max_cycles=40, tol=1e-6)
    phi = np.asarray(mg(jnp.asarray(rho, dtype=jnp.float32)))
    pe = phi_exact - phi_exact.mean()
    assert rms(phi - phi.mean() - pe) / rms(pe) < 1e-3


def test_error_scaling_dirichlet_order2():
    """Convergence order ~2 against the Dirichlet-compatible sinusoid,
    with the solver built with the deck BCs (VERDICT weak #7: the study
    was periodic-only)."""
    from pinc_tpu.grid import fill_sin_dirichlet
    bc = _dirichlet_bc(value=0.0)
    errs = []
    for n in (16, 32):
        spec = spec3d(n)
        rho_np, phi_exact = fill_sin_dirichlet(spec)
        mg = MultigridSolver(spec.global_size, n_levels=3, n_pre=4, n_post=4,
                             n_coarse=40, max_cycles=40, tol=1e-8, bc=bc)
        phi = np.asarray(mg(jnp.asarray(rho_np, dtype=jnp.float32)))
        errs.append(rms(phi - phi_exact) / rms(phi_exact))
    order = np.log2(errs[0] / errs[1])
    assert order > 1.5, (errs, order)


def test_fill_point_and_misc_fixtures():
    """Point/exp/rng/cst fixtures have the reference's shapes and values
    (gFillPoint -1e2 at center, gFillCst ones, gFillExp peak 1 at
    center)."""
    from pinc_tpu.grid import fill_cst, fill_exp, fill_point, fill_rng
    spec = spec3d(16)
    rho, phi = fill_point(spec)
    assert rho[8, 8, 8] == -1e2 and np.count_nonzero(rho) == 1
    assert phi[8, 8, 8] == 0.0
    assert phi[9, 8, 8] == pytest.approx(1.0)
    e = fill_exp(spec)
    assert e[8, 8, 8] == pytest.approx(1.0)
    assert fill_cst(spec).min() == 1.0
    r = fill_rng(spec, seed=1)
    assert abs(r.mean()) < 0.1 and 0.8 < r.std() < 1.2


def test_solve_with_stats_reports_measured_cycles():
    """solve_with_stats returns the measured V-cycle count (< the cap when
    the tolerance is reached first) and the final residual."""
    spec = spec3d(16)
    rho_np, _ = fill_sin(spec)
    mg = MultigridSolver(spec.global_size, n_levels=3, n_pre=4, n_post=4,
                         n_coarse=20, max_cycles=50, tol=1e-5)
    phi, n_cycles, resid = mg.solve_with_stats(
        jnp.asarray(rho_np, dtype=jnp.float32))
    n_cycles = int(n_cycles)
    assert 0 < n_cycles < 50
    assert float(resid) <= 1e-5
    assert rms(laplacian(phi) + rho_np) < 1e-4
