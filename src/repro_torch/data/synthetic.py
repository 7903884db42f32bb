"""Synthetic data (NumPy; the port's copies of ``corpus_embeddings`` and
``click_batches`` from ``repro.data.synthetic``, so both packages draw
the same data from a seed)."""

from __future__ import annotations

from typing import Dict, Iterator

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


def click_batches(
    cfg, batch: int, n_batches: int, seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Recsys click logs matching a RecsysConfig's input contract."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        out = {
            "dense": rng.standard_normal((batch, cfg.n_dense)).astype(
                np.float32
            ),
            "sparse": rng.integers(
                0, cfg.vocab, (batch, cfg.n_sparse)
            ).astype(np.int32),
            "label": rng.integers(0, 2, (batch,)).astype(np.int32),
        }
        if cfg.seq_len:
            hist = rng.integers(-1, cfg.vocab, (batch, cfg.seq_len))
            out["hist"] = hist.astype(np.int32)
            out["target"] = rng.integers(0, cfg.vocab, (batch,)).astype(
                np.int32
            )
        else:
            out["hist"] = np.zeros((batch, 1), np.int32)
            out["target"] = np.zeros((batch,), np.int32)
        yield out
