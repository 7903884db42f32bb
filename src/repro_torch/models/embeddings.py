"""Embedding substrate for recsys: the embedding bag and its relatives.

The port of ``repro.models.embeddings``. The padded multi-hot bag
(``embedding_bag_padded``) runs the hand-written kernel B.7 on the card
(:func:`repro_torch.kernels.ops.embedding_bag`); the ragged bag, the hash
lookup and the one-id-per-field lookup are plain gathers, as they are in
the reference (its four recsys models use the last one, not the bag).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.models.layers import init_normal

_HASH = 2654435761  # Knuth's multiplicative hash, as in the reference


def init_embedding_table(
    vocab: int, dim: int, generator: torch.Generator,
    device: DeviceLike = None, scale: float = 0.01,
) -> Dict[str, torch.Tensor]:
    """``{"table": (vocab, dim)}`` of normal draws times ``scale``."""
    return {"table": init_normal((vocab, dim), scale, generator, device)}


def embedding_bag_padded(
    table: torch.Tensor,  # (V, d)
    idx: torch.Tensor,  # (B, S) int, -1 padded
    weights: Optional[torch.Tensor] = None,  # (B, S)
    combiner: str = "sum",
) -> torch.Tensor:
    """Padded multi-hot bag → (B, d) float32: kernel B.7 on the card."""
    return ops.embedding_bag(table, idx, weights, combiner)


def embedding_bag_ragged(
    table: torch.Tensor,  # (V, d)
    indices: torch.Tensor,  # (L,) int, flat indices
    segment_ids: torch.Tensor,  # (L,) int, the bag of each index
    n_bags: int,
    combiner: str = "sum",
) -> torch.Tensor:
    """Ragged bag: a gather, then ``index_add_`` for the reference's
    ``segment_sum`` (segment ids outside [0, n_bags) are dropped, as
    there); ``mean`` divides by the valid count floored at 1."""
    idx = indices.long()
    seg = segment_ids.long()
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    valid = idx >= 0
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    keep = (seg >= 0) & (seg < n_bags)
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                      device=table.device)
    out.index_add_(0, seg[keep], rows[keep])
    if combiner == "mean":
        cnt = torch.zeros((n_bags,), dtype=torch.float32, device=table.device)
        cnt.index_add_(0, seg[keep], valid[keep].float())
        out = out / cnt.clamp_min(1.0)[:, None]
    return out


def hashed_embedding_lookup(
    table: torch.Tensor,  # (buckets, d)
    ids: torch.Tensor,  # any int ids (unbounded vocabulary)
) -> torch.Tensor:
    """Hash-trick lookup: row ``(uint32(id) · 2654435761 mod 2³²) mod
    buckets``. The product is split at 16 bits so it never overflows
    int64: ``u·C ≡ u·C_lo + ((u·C_hi) mod 2¹⁶)·2¹⁶ (mod 2³²)``."""
    u = ids.long() & 0xFFFFFFFF  # the reference's astype(uint32)
    lo, hi = _HASH & 0xFFFF, _HASH >> 16
    h = (u * lo + ((u * hi) & 0xFFFF) * 65536) & 0xFFFFFFFF
    return table[h % table.shape[0]]


def multi_field_lookup(
    tables: torch.Tensor,  # (F, V, d), stacked per-field tables
    ids: torch.Tensor,  # (B, F) int
) -> torch.Tensor:
    """One id per field → (B, F, d); ids clipped to [0, V − 1]."""
    F = tables.shape[0]
    safe = ids.long().clamp(0, tables.shape[1] - 1)
    return tables[torch.arange(F, device=tables.device)[None, :], safe]
