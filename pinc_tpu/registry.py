"""Method registry — the JAX-native equivalent of PINC's ``select()`` macro.

The reference binds ini strings (``methods:acc = puAcc3D1KE`` etc.) to
validated function pointers via ``select()``/``selectInner``
(``src/io.h:105-119``, ``src/io.c:115-168``), each method shipping a
``*_set()`` sanity-checker (e.g. ``puSanity``, ``src/pusher.c:1047-1087``).

Here the same ini names map to *jittable implementations*: a registry entry
is ``(validator, factory)`` where the validator raises on an invalid config
(dimensionality, ghost layout...) and the factory returns the callable to be
closed over by the jitted step.  Existing reference decks therefore keep
working unmodified.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from .config import PincConfig


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Tuple[Callable, Callable]] = {}

    def register(self, name: str, validator: Callable[[PincConfig], None] | None = None):
        """Decorator: register `factory(cfg) -> impl` under `name`."""
        def deco(factory):
            self._entries[name.lower()] = (validator or (lambda cfg: None), factory)
            return factory
        return deco

    def names(self):
        return sorted(self._entries)

    def select(self, cfg: PincConfig, key: str, default: str | None = None):
        """Reference ``select(ini, key, candidates...)``: look up the ini
        value, validate, return the bound implementation."""
        value = cfg.get_str(key, default) if default else cfg.get_str(key)
        entry = self._entries.get(value.strip().lower())
        if entry is None:
            valid = " ".join(self.names())
            raise ValueError(f"{key}={value} invalid. Valid arguments: {valid}.")
        validator, factory = entry
        validator(cfg)
        return factory(cfg)


# The framework-wide registries, mirroring the selects in
# src/main.c:55-79 (acc, distr, extractEmigrants, solver) and
# src/main.c:32-36 (run mode).
ACCELERATORS = Registry("acc")
DISTRIBUTORS = Registry("distr")
MIGRATORS = Registry("migrate")
SOLVERS = Registry("poisson")
RUN_MODES = Registry("mode")
