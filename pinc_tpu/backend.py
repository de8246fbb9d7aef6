"""What runs on this device.

The one place that maps the JAX platform onto the program's choices:

* ``gpu`` — the hand kernels (Pallas through Triton) compiled for the
  card;
* ``cpu`` — the tests: the same kernels in Pallas interpret mode;
* anything else is an error, never a silent fallback.
"""

from __future__ import annotations

import os

import jax

SUPPORTED = ("gpu", "cpu")


def platform() -> str:
    """The platform of the default device, checked against SUPPORTED."""
    p = jax.devices()[0].platform
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: pinc_tpu runs on an NVIDIA "
            f"GPU ('gpu'), or on the CPU for tests")
    return p


def interpret() -> bool:
    """Pallas kernels run in interpret mode on the CPU, and only there."""
    return platform() == "cpu"


def tiles_backend(n_dims: int) -> str:
    """Default particle route of the tiled layout: the Triton particle
    kernel ('pallas') for 3-D decks on the GPU, the XLA contraction route
    ('xla') elsewhere (the kernel is 3-D only, and interpret mode is for
    tests, not runs)."""
    return "pallas" if n_dims == 3 and platform() == "gpu" else "xla"


def memory_bytes() -> int:
    """Memory the default device offers the program: the allocator's
    ``bytes_limit`` on the GPU, physical memory on the CPU (whose device
    reports no limit)."""
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
