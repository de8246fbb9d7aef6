"""HDF5 output with the reference's file conventions.

Reproduces PINC's output layout so the reference's verification and plotting
scripts work unchanged:

* File naming ``<prefix><sep><name>.<kind>.h5`` where sep is '/' if the
  prefix is '.', '_' if the prefix does not end in '/'
  (``openH5File``, src/io.c:566-604).
* Grid files (``gOpenH5``/``gWriteH5``, src/grid.c:1161-1270): one dataset
  ``/n=<t>.1f`` per step, dims *reversed* relative to (x,y,...) ordering
  with a trailing values dimension, plus the "Axis/Quantity denormalization
  factor" attributes.
* Population files (``pOpenH5``/``pWriteH5``, src/population.c:497-651):
  ``/pos/specie i/n=<t>.1f`` and ``/vel/specie i/n=<t-0.5>.1f`` datasets of
  shape (nParticles, nDims), global frame.
* Time-series ``.xy.h5`` files (``xyCreateDataset``/``xyWrite``,
  src/io.c:666-736): unlimited (T,2) float64 datasets of (x, y) rows; the
  canonical one is ``history.xy.h5:/energy/...``
  (``pCreateEnergyDatasets``, src/population.c:658-698).

The reference writes every field and the whole population every step via
collective MPI-IO; here writes happen from host after fetching device
snapshots, with an optional cadence (``files:writeFrequency``, default 1 =
reference behavior) since per-step full-population IO is rarely what an accelerator
run wants.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .config import PincConfig

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def h5_path(cfg: PincConfig, name: str, kind: str) -> Path:
    prefix = cfg.get_str("files:output", "")
    sep = ""
    if prefix == ".":
        sep = "/"
    elif prefix and not prefix.endswith("/"):
        sep = "_"
    return Path(f"{prefix}{sep}{name}.{kind}.h5")


def _open(path: Path) -> "h5py.File":
    if h5py is None:
        raise RuntimeError("h5py is required for HDF5 output")
    path.parent.mkdir(parents=True, exist_ok=True)
    return h5py.File(path, "a")


def _grid_to_file_layout(arr: np.ndarray, n_dims: int) -> np.ndarray:
    """(x, y, ..., [C]) -> reversed spatial dims + trailing values dim
    (the 'HDF5 indices needs to be reversed' convention, grid.c:1243-1248)."""
    if arr.ndim == n_dims:           # scalar: add nValues=1 axis
        arr = arr[..., None]
    perm = tuple(range(n_dims - 1, -1, -1)) + (n_dims,)
    return np.ascontiguousarray(np.transpose(arr, perm).astype(np.float64))


class GridFile:
    def __init__(self, cfg: PincConfig, name: str, n_dims: int,
                 axis_denorm: float = 1.0, denorm: float = 1.0):
        self.n_dims = n_dims
        self.f = _open(h5_path(cfg, name, "grid"))
        self.f.attrs["Axis denormalization factor"] = np.float64(axis_denorm)
        self.f.attrs["Quantity denormalization factor"] = np.float64(denorm)

    def write(self, n: float, arr: np.ndarray) -> None:
        ds = f"n={float(n):.1f}"
        if ds in self.f:
            del self.f[ds]
        self.f.create_dataset(ds, data=_grid_to_file_layout(arr, self.n_dims))

    def read(self, n: float) -> np.ndarray:
        """Inverse of write: file layout -> (x, y, ..., C) (gReadH5)."""
        data = np.asarray(self.f[f"n={float(n):.1f}"])
        nd = self.n_dims
        perm = tuple(range(nd - 1, -1, -1)) + (nd,)
        out = np.transpose(data, perm)
        return out[..., 0] if out.shape[-1] == 1 else out

    def close(self):
        self.f.close()


class PopFile:
    def __init__(self, cfg: PincConfig, name: str, n_species: int,
                 pos_denorm: float = 1.0, vel_denorm: float = 1.0):
        self.f = _open(h5_path(cfg, name, "pop"))
        self.f.attrs["Position denormalization factor"] = np.float64(pos_denorm)
        self.f.attrs["Velocity denormalization factor"] = np.float64(vel_denorm)
        for s in range(n_species):
            self.f.require_group(f"pos/specie {s}")
            self.f.require_group(f"vel/specie {s}")

    def write(self, pos_n: float, vel_n: float, pos: np.ndarray,
              vel: np.ndarray, alive: np.ndarray) -> None:
        """pos/vel: (S, cap, D); only alive rows are stored (the reference
        stores exactly iStop-iStart rows per species)."""
        S = pos.shape[0]
        for s in range(S):
            m = alive[s]
            for grp, n, data in (("pos", pos_n, pos[s][m]),
                                 ("vel", vel_n, vel[s][m])):
                ds = f"{grp}/specie {s}/n={float(n):.1f}"
                if ds in self.f:
                    del self.f[ds]
                self.f.create_dataset(ds, data=data.astype(np.float64))

    def close(self):
        self.f.close()


class XYFile:
    """Extendable (x,y) time-series file (.xy.h5)."""

    def __init__(self, cfg: PincConfig, name: str):
        self.f = _open(h5_path(cfg, name, "xy"))

    def create(self, name: str) -> None:
        if name not in self.f:
            self.f.create_dataset(name, shape=(0, 2), maxshape=(None, 2),
                                  chunks=(1, 2), dtype=np.float64)

    def append(self, name: str, x: float, y: float) -> None:
        ds = self.f[name]
        n = ds.shape[0]
        ds.resize((n + 1, 2))
        ds[n] = (x, y)

    def close(self):
        self.f.close()


class OutputWriter:
    """Facade used by Simulation.run: owns the rho/phi/E grid files, the pop
    file and history.xy.h5 (the file set opened at src/main.c:121-131)."""

    def __init__(self, cfg: PincConfig, sim) -> None:
        from .utils import multihost as mh
        self.cfg = cfg
        self.n_dims = sim.spec.n_dims
        self.every = cfg.get_int("files:writefrequency", 1)
        self.write_fields = cfg.get_bool("files:writefields", True)
        self.write_pop = cfg.get_bool("files:writepop", True)
        # multi-host discipline (the reference's collective MPI-IO,
        # src/grid.c:1161-1180, rebuilt as process-0 single-file writes
        # for replicated/small data + per-host shard files for particles)
        self.primary = mh.is_primary()
        self.pidx = mh.process_index()
        self.nproc = mh.process_count()
        self._fetch_global = mh.fetch_global
        u = sim.units
        self.units = u

        # async mode: snapshots go to the native background spooler and are
        # converted to the standard .h5 layout at close (files:async=true)
        self.spool = None
        if cfg.get_bool("files:async", False):
            try:
                from .spool import SpoolWriter
                p = h5_path(cfg, "snapshots", "spool")
                self.spool_path = p.with_name(p.name.replace(".spool.h5",
                                                             ".spool"))
                self.spool = SpoolWriter(self.spool_path)
            except Exception as e:  # no compiler: fall back to sync writes
                from .utils.logging import WARNING, msg
                msg(WARNING, "files:async requested but native spooler "
                    "unavailable (%s); writing synchronously", e)

        self.grids = {}
        if self.write_fields and self.spool is None and self.primary:
            for name in ("rho", "phi", "E"):
                self.grids[name] = GridFile(cfg, name, self.n_dims,
                                            axis_denorm=u.length, denorm=1.0)
        self.pop: Optional[PopFile] = None
        if self.write_pop and self.spool is None:
            ns = sim.params.charge.shape[0]
            # per-host shard file on pods: pop.p<idx>.pop.h5; the single-
            # process name matches the reference exactly
            pname = "pop" if self.nproc == 1 else f"pop.p{self.pidx}"
            self.pop = PopFile(cfg, pname, ns, pos_denorm=u.length,
                               vel_denorm=u.velocity)
        self.history = XYFile(cfg, "history") if self.primary else None
        ns = sim.params.charge.shape[0]
        self.n_species = ns
        if self.history is not None:
            for kind in ("potential", "kinetic"):
                self.history.create(f"/energy/{kind}/total")
                for s in range(ns):
                    self.history.create(f"/energy/{kind}/specie {s}")

    def _owned_rows(self, arr, axis: int = 1):
        """This process's OWNED slice of a device array along ``axis``
        (replica 0 of each shard — no row is written twice across the
        pod).  Single-process: the whole array.  Returns None when this
        process owns nothing."""
        if self.nproc == 1 or isinstance(arr, np.ndarray):
            return np.asarray(arr)
        parts = [(s.index[axis].start or 0, np.asarray(s.data))
                 for s in arr.addressable_shards if s.replica_id == 0]
        if not parts:
            return None
        parts.sort(key=lambda t: t[0])
        return np.concatenate([p for _, p in parts], axis=axis)

    def write_step(self, n: int, out) -> None:
        if self.every and n % self.every != 0:
            return
        if self.spool is not None:
            if self.write_fields and self.primary:
                self.spool.write("rho", n, self._fetch_global(out.rho))
                self.spool.write("phi", n, self._fetch_global(out.phi))
                self.spool.write("E", n, self._fetch_global(out.E))
            if self.write_pop:
                p = out.particles
                pos = self._owned_rows(p.pos())
                vel = self._owned_rows(p.vel)
                alive = self._owned_rows(p.alive)
                if pos is not None:
                    for s in range(pos.shape[0]):
                        m = alive[s]
                        self.spool.write(f"pop/pos/{s}", n, pos[s][m])
                        self.spool.write(f"pop/vel/{s}", n - 0.5,
                                         vel[s][m])
            return
        if self.write_fields and self.primary:
            self.grids["rho"].write(n, self._fetch_global(out.rho))
            self.grids["phi"].write(n, self._fetch_global(out.phi))
            self.grids["E"].write(n, self._fetch_global(out.E))
        if self.pop is not None:
            p = out.particles
            pos = self._owned_rows(p.pos())
            if pos is not None:
                self.pop.write(n, n - 0.5, pos,
                               self._owned_rows(p.vel),
                               self._owned_rows(p.alive))

    def write_energy(self, n: int, ke: np.ndarray, pe: float) -> None:
        if self.history is None:
            return
        self.history.append("/energy/kinetic/total", n, float(ke.sum()))
        self.history.append("/energy/potential/total", n, float(pe))
        for s in range(self.n_species):
            self.history.append(f"/energy/kinetic/specie {s}", n, float(ke[s]))
            # per-species PE mirrors the reference: gPotEnergy fills only the
            # total slot (src/grid.c:1276-1293), species entries stay 0.
            self.history.append(f"/energy/potential/specie {s}", n, 0.0)

    def close(self):
        for g in self.grids.values():
            g.close()
        if self.pop is not None:
            self.pop.close()
        if self.history is not None:
            self.history.close()
        if self.spool is not None:
            from .spool import convert
            n = self.spool.close()
            from .utils.logging import STATUS, msg
            msg(STATUS, "spool closed (%d records); converting to .h5", n)
            convert(self.spool_path, self.cfg, self.n_dims, self.units)
