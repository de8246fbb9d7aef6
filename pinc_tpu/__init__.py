"""pinc_tpu — an electrostatic Particle-in-Cell framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
C/MPI code PINC (see SURVEY.md): multi-species leapfrog/Boris particle push
with NGP/CIC gather-scatter, spectral (ND FFT) and geometric multigrid
Poisson solvers, domain decomposition via ``jax.sharding`` meshes with
collective halo exchange, embedded conducting objects via the
capacitance-matrix method, PINC-compatible ini decks and HDF5 output.
"""

__version__ = "0.1.0"

from .config import PincConfig, required_np
from .grid import BndType, GridSpec
from .population import Particles, SpeciesParams, initialize
from .simulation import Simulation
from .units import Units, alloc_and_normalize

__all__ = [
    "PincConfig", "required_np", "GridSpec", "BndType", "Particles",
    "SpeciesParams", "initialize", "Simulation", "Units",
    "alloc_and_normalize",
]
