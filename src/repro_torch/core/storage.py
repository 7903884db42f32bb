"""Tier-3 storage backends (the port's copy of the query-path half of
``repro.core.storage``, DESIGN.md §6).

Tier 3 is host memory in both packages: a backend serves ``(k, d)``
float32 rows as NumPy arrays, and the tiered store uploads the rows a
load phase needs to the device. The protocol surface:

- ``fetch(ids) -> (k, d) float32``   one bulk read ("one transaction")
- ``n_items`` / ``dim``              payload geometry
- ``access_cost(n) -> float``        modeled seconds for an n-item read

:class:`InMemoryBackend` holds the payload as a NumPy array;
:class:`LatencyModel` adds the paper's analytic cost model
``t_access = t_setup + n · t_per_item`` on top of any backend. Sharded
files, delta appends and shard I/O come with the persistence slice.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class StorageBackend(Protocol):
    """The tier-3 seam: what a storage medium must provide."""

    @property
    def n_items(self) -> int: ...

    @property
    def dim(self) -> int: ...

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """One bulk read of ``ids`` (assumed valid, no -1 padding)."""
        ...

    def access_cost(self, n: int) -> float:
        """Modeled seconds for one n-item access (0.0 = unmodeled)."""
        ...


class InMemoryBackend:
    """Tier 3 as a host NumPy array."""

    def __init__(self, vectors: np.ndarray):
        self._vectors = np.asarray(vectors, dtype=np.float32)

    @property
    def n_items(self) -> int:
        return int(self._vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self._vectors.shape[1])

    @property
    def vectors(self) -> np.ndarray:
        return self._vectors

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        return self._vectors[np.asarray(ids)]

    def access_cost(self, n: int) -> float:
        return 0.0


class LatencyModel:
    """Composable access-cost model over any backend (paper Fig. 3b).

    ``access_cost(n) = inner.access_cost(n) + t_setup + n · t_per_item``.
    With ``simulate=True`` each fetch actually sleeps its own modeled
    share; by default the cost is accounted analytically (by
    ExternalStore) so tests stay fast and deterministic.
    """

    def __init__(
        self,
        inner: StorageBackend,
        t_setup: float = 1.0e-3,
        t_per_item: float = 2.0e-6,
        simulate: bool = False,
    ):
        self.inner = inner
        self.t_setup = float(t_setup)
        self.t_per_item = float(t_per_item)
        self.simulate = bool(simulate)

    @property
    def n_items(self) -> int:
        return self.inner.n_items

    @property
    def dim(self) -> int:
        return self.inner.dim

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        out = self.inner.fetch(ids)
        if self.simulate:
            time.sleep(self.t_setup + len(np.asarray(ids)) * self.t_per_item)
        return out

    def access_cost(self, n: int) -> float:
        return self.inner.access_cost(n) + self.t_setup + n * self.t_per_item


def unwrap_backend(backend: StorageBackend) -> StorageBackend:
    """Strip LatencyModel wrappers down to the storage medium itself."""
    while isinstance(backend, LatencyModel):
        backend = backend.inner
    return backend
