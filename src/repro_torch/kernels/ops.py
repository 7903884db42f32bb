"""Dispatch of the port's kernels on the tensor's device.

A CUDA tensor launches the hand-written kernel, and a failed launch
raises. A CPU tensor runs the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. There is no fallback from one to the
other: the device of the inputs alone decides.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import adc_gather_distance as _adc
from repro_torch.kernels import dequant_gather_distance as _dq
from repro_torch.kernels import gather_distance as _gd
from repro_torch.kernels import ref
from repro_torch.kernels import topk as _topk


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def gather_distance_batch(
    table: torch.Tensor, ids: torch.Tensor, Q: torch.Tensor,
    metric: str = "l2",
) -> torch.Tensor:
    """(B, K) ids × (B, d) queries → (B, K) distances to ``table`` rows,
    +inf for ids < 0."""
    if _on_cuda(table):
        return _gd.gather_distance_batch_cuda(table, ids, Q, metric)
    return ref.gather_distance_batch_ref(table, ids, Q, metric)


def gather_distance(
    table: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
    metric: str = "l2",
) -> torch.Tensor:
    """(K,) ids × one (d,) query → (K,) distances: the batched kernel
    launched at one query, so both forms give the same bits."""
    if _on_cuda(table):
        return _gd.gather_distance_cuda(table, ids, q, metric)
    return ref.gather_distance_ref(table, ids, q, metric)


def dequant_gather_distance_batch(
    table: torch.Tensor, scales: Optional[torch.Tensor], ids: torch.Tensor,
    Q: torch.Tensor, metric: str = "l2",
) -> torch.Tensor:
    """(B, K) ids × (B, d) queries → (B, K) distances to the dequantized
    rows of an int8 (with ``scales``) or float16 (``scales=None``)
    ``table``, +inf for ids < 0."""
    if _on_cuda(table):
        return _dq.dequant_gather_distance_batch_cuda(
            table, scales, ids, Q, metric)
    return ref.dequant_gather_distance_batch_ref(table, scales, ids, Q, metric)


def dequant_gather_distance(
    table: torch.Tensor, scales: Optional[torch.Tensor], ids: torch.Tensor,
    q: torch.Tensor, metric: str = "l2",
) -> torch.Tensor:
    """(K,) ids × one (d,) query → (K,) distances: the batched kernel
    launched at one query, so both forms give the same bits."""
    if _on_cuda(table):
        return _dq.dequant_gather_distance_cuda(table, scales, ids, q, metric)
    return ref.dequant_gather_distance_ref(table, scales, ids, q, metric)


def adc_gather_distance_batch(
    codes: torch.Tensor, luts: torch.Tensor, ids: torch.Tensor,
    metric: str = "l2",
) -> torch.Tensor:
    """(B, K) ids × (B, L, M, 256) per-query ADC tables → (B, K)
    distances to the PQ-coded rows of ``codes``, +inf for ids < 0
    (DESIGN.md §12)."""
    if _on_cuda(codes):
        return _adc.adc_gather_distance_batch_cuda(codes, luts, ids, metric)
    return ref.adc_gather_distance_batch_ref(codes, luts, ids, metric)


def adc_gather_distance(
    codes: torch.Tensor, lut: torch.Tensor, ids: torch.Tensor,
    metric: str = "l2",
) -> torch.Tensor:
    """(K,) ids × one (L, M, 256) table → (K,) distances: the batched
    kernel launched at one query, so both forms give the same bits."""
    if _on_cuda(codes):
        return _adc.adc_gather_distance_cuda(codes, lut, ids, metric)
    return ref.adc_gather_distance_ref(codes, lut, ids, metric)


def merge_topk(
    dists: torch.Tensor, ids: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k smallest (dist, id) candidates of each (B, M) row as
    ``(dists, ids, src)``: sentinels (id < 0, non-finite dist) never win,
    a duplicate id keeps its best copy, ties go to the lower position."""
    if _on_cuda(dists):
        return _topk.merge_topk_cuda(dists, ids, k)
    return ref.merge_topk_ref(dists, ids, k)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {**_gd.launches, **_dq.launches, **_adc.launches,
            "merge_topk": _topk.launches}


def reset_launch_counts() -> None:
    for counts in (_gd.launches, _dq.launches, _adc.launches):
        for form in counts:
            counts[form] = 0
    _topk.launches = 0
