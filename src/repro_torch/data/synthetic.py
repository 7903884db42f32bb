"""Synthetic corpora (NumPy; the port's copy of ``corpus_embeddings`` from
``repro.data.synthetic``, so both packages draw the same data from a seed)."""

from __future__ import annotations

import numpy as np


def corpus_embeddings(
    n: int, dim: int, n_clusters: int = 64, seed: int = 0,
    spread: float = 0.35,
) -> np.ndarray:
    """Clustered embeddings — the workload regime where HNSW shines."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    # zipf-ish cluster weights (popular topics dominate, like real corpora)
    w = 1.0 / np.arange(1, n_clusters + 1)
    w = w / w.sum()
    assign = rng.choice(n_clusters, size=n, p=w)
    X = centers[assign] + spread * rng.standard_normal((n, dim)).astype(
        np.float32
    )
    return X.astype(np.float32)
