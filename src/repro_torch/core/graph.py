"""Flat, padded HNSW graph arrays (NumPy; the port's copy of
``repro.core.graph``).

The index is stored as dense, statically-shaped arrays so the online query
path can index it on the device:

- ``neighbors``: ``(n_layers, N, max_degree) int32``; entry ``-1`` = padding.
  Layer 0 allows up to ``2*M`` links (HNSW convention), upper layers ``M``;
  all layers are padded to ``max_degree = 2*M``.
- ``levels``: ``(N,) int32`` — highest layer each node appears in.
- ``entry_point`` / ``max_level``: search entry state.

Construction is host-side NumPy in both packages, so the graph arrays are
bit-identical between them for the same seed. Persistence (``save`` /
``load``) comes with the persistence slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PAD = -1  # sentinel for absent neighbor slots


@dataclasses.dataclass
class HNSWGraph:
    """Immutable flat HNSW graph (construction output, query input)."""

    neighbors: np.ndarray  # (n_layers, N, max_degree) int32, PAD-padded
    levels: np.ndarray  # (N,) int32
    entry_point: int
    max_level: int
    M: int  # construction connectivity parameter
    metric: str = "l2"  # 'l2' | 'ip' | 'cos'

    @property
    def n_layers(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def size(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def max_degree(self) -> int:
        return int(self.neighbors.shape[2])

    def degree(self, layer: int, node: int) -> int:
        row = self.neighbors[layer, node]
        return int((row != PAD).sum())

    def validate(self) -> None:
        """Cheap structural invariants; raises ``ValueError`` on a breach."""
        L, N, _ = self.neighbors.shape
        checks = [
            (self.levels.shape == (N,), "levels shape"),
            (0 <= self.entry_point < N, "entry point out of range"),
            (self.max_level == int(self.levels.max()), "max_level"),
            (L == self.max_level + 1, "layer count"),
            (int(self.levels[self.entry_point]) == self.max_level,
             "entry point not on the top layer"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"invalid HNSW graph: {what}")
        for l in range(L):
            nb = self.neighbors[l]
            if not ((nb == PAD) | ((nb >= 0) & (nb < N))).all():
                raise ValueError(f"layer {l}: neighbor id out of range")
            absent = np.nonzero(self.levels < l)[0]
            if absent.size and not (nb[absent] == PAD).all():
                raise ValueError(f"layer {l}: node below layer has links")


def empty_graph(n: int, max_level: int, M: int, metric: str = "l2") -> HNSWGraph:
    return HNSWGraph(
        neighbors=np.full((max_level + 1, n, 2 * M), PAD, dtype=np.int32),
        levels=np.zeros(n, dtype=np.int32),
        entry_point=0,
        max_level=max_level,
        M=M,
        metric=metric,
    )


def random_levels(n: int, M: int, rng: np.random.Generator) -> np.ndarray:
    """HNSW level assignment: P(level >= l) = exp(-l / mL), mL = 1/ln(M)."""
    m_l = 1.0 / np.log(M)
    u = rng.random(n)
    lv = np.floor(-np.log(u) * m_l).astype(np.int32)
    return lv
