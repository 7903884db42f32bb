"""Accuracy evaluation helpers (NumPy; the port's copy of
``repro.core.eval``): the exact baseline and recall@k."""

from __future__ import annotations

import numpy as np


def brute_force_topk(
    X: np.ndarray, Q: np.ndarray, k: int, metric: str = "l2"
) -> np.ndarray:
    """Exact top-k ids (B, k) of each query against the full corpus."""
    X = np.asarray(X, np.float32)
    Q = np.atleast_2d(np.asarray(Q, np.float32))
    G = Q @ X.T
    if metric == "l2":
        D = (Q * Q).sum(-1)[:, None] + (X * X).sum(-1)[None, :] - 2.0 * G
    elif metric == "ip":
        D = -G
    elif metric == "cos":
        qn = np.linalg.norm(Q, axis=-1) + 1e-30
        xn = np.linalg.norm(X, axis=-1) + 1e-30
        D = -G / (qn[:, None] * xn[None, :])
    else:
        raise ValueError(metric)
    part = np.argpartition(D, k - 1, axis=1)[:, :k]
    order = np.take_along_axis(D, part, 1).argsort(axis=1, kind="stable")
    return np.take_along_axis(part, order, 1)


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean fraction of exact top-k recovered, over the query batch."""
    pred_ids = np.atleast_2d(np.asarray(pred_ids))
    true_ids = np.atleast_2d(np.asarray(true_ids))
    hits = sum(
        len(set(p.tolist()) & set(t.tolist()))
        for p, t in zip(pred_ids, true_ids)
    )
    return hits / float(true_ids.size)
