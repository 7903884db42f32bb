"""Dispatch of the port's kernels on the tensor's device.

A CUDA tensor launches the hand-written kernel, and a failed launch
raises. A CPU tensor runs the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. There is no fallback from one to the
other: the device of the inputs alone decides. The hop-step kernel B.8
is the exception that shapes decide too (:func:`hop_step_takes`); its
plain version is ``search.batch_hop_step_plain``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import adc_gather_distance as _adc
from repro_torch.kernels import dequant_gather_distance as _dq
from repro_torch.kernels import distance as _dm
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import gather_distance as _gd
from repro_torch.kernels import hop_step as _hs
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


def distance_matrix(
    Q: torch.Tensor, X: torch.Tensor, metric: str = "l2",
) -> torch.Tensor:
    """(B, d) × (N, d) → (B, N) float32 distances in the reference's GEMM
    form (l2 clamped at 0, ip, cos)."""
    if _on_cuda(Q):
        return _dm.distance_matrix_cuda(Q, X, metric)
    return ref.distance_matrix_ref(Q, X, metric)


def distance_topk_ready(
    Q: torch.Tensor, X: torch.Tensor, metric: str = "l2",
) -> torch.Tensor:
    """The distance matrix shaped for a follow-up top-k (the distributed
    scan's hook), as in the reference: :func:`distance_matrix`."""
    return distance_matrix(Q, X, metric)


def topk(D: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of a (B, N) matrix as ``(dists, ids)``;
    ties go to the lower column, ids are distinct. ``ValueError`` for k
    above ``TOPK_MAX_K`` or N on either device."""
    if _on_cuda(D):
        return _topk.topk_cuda(D, k)
    _topk.check_topk_args(D.shape[1], k)
    return ref.topk_ref(D, k)


def distance_topk(
    Q: torch.Tensor, X: torch.Tensor, k: int, metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat scan: :func:`distance_matrix`, then :func:`topk`."""
    return topk(distance_matrix(Q, X, metric), k)


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor,
    weights: Optional[torch.Tensor] = None, combiner: str = "sum",
) -> torch.Tensor:
    """(B, S) ids, -1 padded, over a (V, d) table → (B, d) float32 bags:
    the sum (or ``"mean"``) of the valid slots' rows, each times its
    weight where ``weights`` are given; ids at or above V read row V − 1.
    A weighted bag runs the kernel too."""
    if _on_cuda(table):
        return _eb.embedding_bag_cuda(table, idx, weights, combiner)
    return ref.embedding_bag_ref(table, idx, weights, combiner)


def hop_step_takes(table: torch.Tensor, ef: int, deg: int) -> bool:
    """Whether a hop step over the tier-2 ``table`` runs as the hop-step
    kernel B.8: a CUDA table of float32, int8 or float16, and a merge row
    ``ef + deg`` of at most ``hop_step.MAX_ROW`` (256). Decided from the
    device, dtype and shapes alone, before any launch. Otherwise the step
    is ``search.batch_hop_step_plain``: on the CPU the plain version, on
    the card the per-op step of hand-written kernels (a pq tier 2, wider
    rows)."""
    return (_on_cuda(table) and table.dtype in _hs.ELEM_CODES
            and ef + deg <= _hs.MAX_ROW)


def hop_step(
    Q: torch.Tensor, neighbors: torch.Tensor, beam_ids: torch.Tensor,
    beam_dists: torch.Tensor, explored: torch.Tensor, visited: torch.Tensor,
    miss_ids: torch.Tensor, miss_count: torch.Tensor, n_hops: torch.Tensor,
    n_dist: torch.Tensor, table: torch.Tensor,
    scales: Optional[torch.Tensor], slot_of: Optional[torch.Tensor],
    id_of: Optional[torch.Tensor], metric: str, trigger: int, max_hops: int,
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One hop step of B queries as the kernel B.8, for a step that
    :func:`hop_step_takes`: the eight new state tensors and ``active``.
    A failed build or launch raises."""
    return _hs.hop_step_cuda(Q, neighbors, beam_ids, beam_dists, explored,
                             visited, miss_ids, miss_count, n_hops, n_dist,
                             table, scales, slot_of, id_of, metric, trigger,
                             max_hops, gate)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {**_gd.launches, **_dq.launches, **_adc.launches,
            **_topk.launches, **_hs.launches,
            "distance_matrix": _dm.launches,
            "embedding_bag": _eb.launches}


def reset_launch_counts() -> None:
    for counts in (_gd.launches, _dq.launches, _adc.launches,
                   _topk.launches, _hs.launches):
        for form in counts:
            counts[form] = 0
    _dm.launches = 0
    _eb.launches = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name → launches, as :func:`launch_counts`
    names them) to the counters. A CUDA graph replays launches its
    capture counted once (``repro_torch.core.step_graph``): it adds them
    at every replay, and takes back the capture's own count, since a
    capture runs nothing."""
    for name, n in counts.items():
        for mod in (_gd, _dq, _adc, _topk, _hs):
            if name in mod.launches:
                mod.launches[name] += n
                break
        else:
            if name == "distance_matrix":
                _dm.launches += n
            elif name == "embedding_bag":
                _eb.launches += n
            else:
                raise KeyError(f"no launch counter named {name!r}")
