"""Carry an index across from the JAX package: its arrays in, the port's
graph and table out.

An HNSW index is plain arrays (the vectors, the padded neighbor lists,
the levels and the entry state), so the two packages exchange it as
NumPy arrays and nothing of ``repro`` is imported here. The parity tests
build a graph once with the reference and feed the same arrays to both
engines.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import HNSWGraph


def from_reference(
    vectors: np.ndarray,  # (N, d)
    neighbors: np.ndarray,  # (n_layers, N, max_degree), -1 padded
    levels: np.ndarray,  # (N,)
    entry_point: int,
    max_level: int,
    M: int,
    metric: str = "l2",
) -> Tuple[HNSWGraph, np.ndarray]:
    """The port's ``(HNSWGraph, table)`` for a reference index.

    Arrays are copied into the port's dtypes (float32 table, int32
    graph); ``ValueError`` if their shapes disagree.
    """
    table = np.array(vectors, dtype=np.float32, copy=True)
    nb = np.array(neighbors, dtype=np.int32, copy=True)
    lv = np.array(levels, dtype=np.int32, copy=True)
    if table.ndim != 2 or nb.ndim != 3:
        raise ValueError(
            f"vectors must be (N, d) and neighbors (L, N, deg), got "
            f"{table.shape} and {nb.shape}"
        )
    if nb.shape[1] != table.shape[0] or lv.shape != (table.shape[0],):
        raise ValueError(
            f"{table.shape[0]} vectors, but neighbors cover {nb.shape[1]} "
            f"ids and levels {lv.shape}"
        )
    graph = HNSWGraph(
        neighbors=nb, levels=lv, entry_point=int(entry_point),
        max_level=int(max_level), M=int(M), metric=metric,
    )
    graph.validate()
    return graph, table
