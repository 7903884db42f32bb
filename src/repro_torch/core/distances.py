"""Distance computations of the port (PyTorch twin of
``repro.core.distances``).

The query path's per-hop and load-phase distances go through the fused
gather-distance kernel (:mod:`repro_torch.kernels.ops`); these plain
functions serve bulk scoring and the exact oracle.
"""

from __future__ import annotations

from typing import Tuple

import torch


def point_distance(x: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """Distance between batched points ``x`` (..., d) and query ``q`` (d,)."""
    if metric == "l2":
        diff = x - q
        return (diff * diff).sum(-1)
    if metric == "ip":
        return -(x * q).sum(-1)
    if metric == "cos":
        xn = torch.linalg.vector_norm(x, dim=-1) + 1e-30
        qn = torch.linalg.vector_norm(q) + 1e-30
        return -(x * q).sum(-1) / (xn * qn)
    raise ValueError(f"unknown metric {metric!r}")


def distance_matrix(Q: torch.Tensor, X: torch.Tensor, metric: str) -> torch.Tensor:
    """(nq, d) x (n, d) -> (nq, n) distances in matmul form (full float32:
    a float32 matmul on the card does not use TF32 unless asked)."""
    G = Q @ X.T
    if metric == "l2":
        qn = (Q * Q).sum(-1)
        xn = (X * X).sum(-1)
        return torch.clamp_min(qn[:, None] + xn[None, :] - 2.0 * G, 0.0)
    if metric == "ip":
        return -G
    if metric == "cos":
        qn = torch.linalg.vector_norm(Q, dim=-1) + 1e-30
        xn = torch.linalg.vector_norm(X, dim=-1) + 1e-30
        return -G / (qn[:, None] * xn[None, :])
    raise ValueError(f"unknown metric {metric!r}")


def exact_topk(
    Q: torch.Tensor, X: torch.Tensor, k: int, metric: str = "l2"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k oracle: (dists (nq, k), ids (nq, k)), ties to the lower
    id (a stable sort, ``lax.top_k``'s order)."""
    D = distance_matrix(Q, X, metric)
    dists, ids = torch.sort(D, dim=-1, stable=True)
    return dists[:, :k], ids[:, :k].int()
