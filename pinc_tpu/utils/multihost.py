"""Multi-host (pod) IO discipline.

The reference writes grid and population snapshots collectively from
every rank via MPI-IO (H5Pset_dxpl_mpio, src/grid.c:1161-1180;
src/population.c:538-651).  h5py here is serial, so the JAX-native
equivalent (SURVEY.md §2) is:

* replicated/small outputs (history.xy.h5, timer.xy.h5, grid fields)
  are written by process 0 only;
* fields that are sharded across hosts are all-gathered to the host
  before process 0 writes (they are small next to particle state);
* particle snapshots are written PER HOST from each process's
  addressable shards into a per-process file
  (``<prefix>_pop.p<idx>.pop.h5``); a reader concatenates.

On a single-process run (the common case, incl. every test here) all
of this degrades to the exact reference file layout.
"""

from __future__ import annotations

import numpy as np

import jax


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    """True on the process that owns single-file outputs."""
    return jax.process_index() == 0


def fetch_global(arr) -> np.ndarray:
    """Materialize a (possibly host-sharded) device array on every host.
    Single-process: a plain device fetch.  Multi-process: an allgather
    of the addressable shards (jax.experimental.multihost_utils)."""
    if jax.process_count() == 1 or isinstance(arr, np.ndarray):
        return np.asarray(arr)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def fetch_local(arr) -> np.ndarray:
    """This process's addressable rows of a device array, concatenated
    along axis 0 in shard order.  Single-process: the full array."""
    if jax.process_count() == 1 or isinstance(arr, np.ndarray):
        return np.asarray(arr)
    shards = sorted(arr.addressable_shards, key=lambda s: s.index)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
