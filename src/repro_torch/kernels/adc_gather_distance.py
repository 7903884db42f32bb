"""Fused PQ code-gather + lookup-table accumulate (ADC) on the card
(``csrc/adc_gather_distance.cu``).

Replaces ``src/repro/kernels/adc_gather_distance.py`` ::
``adc_gather_distance_pallas`` and ``adc_gather_distance_batch_pallas``.
The table is a uint8 code slab or payload, one row of M codes a vector;
the caller has built each query's (L, M, 256) lookup table
(``repro_torch.core.pq.build_lut``). One warp takes one (query, id)
slot: its lanes read the id's code row and gather the M table entries
it selects straight from global memory, where ``build_lut`` has just
left the table in L2, and one lane sums them left to right in float32,
so the output equals ``pq.adc_distance_np`` bit for bit and no decoded
vector or staged table is made. Bound: bytes (the selected entries and
the distinct code rows), in practice two dependent round trips a slot;
see the source.

Its plain PyTorch version is ``ref.adc_gather_distance_batch_ref``; the
dispatch on the tensor's device is :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_distance import METRIC_CODES, _check

N_CENTROIDS = 256

# kernel launches since the last ops.reset_launch_counts(), by entry point:
# the single-query form (the loop and fused drivers') and the batched form
launches = {"adc_gather_distance": 0, "adc_gather_distance_batch": 0}


def _entry():
    fn = _build.library("adc_gather_distance").adc_gather_distance
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(
    codes: torch.Tensor, luts: torch.Tensor, ids: torch.Tensor, metric: str,
    form: str,
) -> torch.Tensor:
    """Check the inputs, launch the kernel, count the launch under
    ``form``: (B, K) distances, +inf for padded ids."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(
            f"adc_gather_distance kernel needs CUDA tensors, got {dev}")
    _check(codes, "codes", torch.uint8, 2, dev)
    _check(luts, "luts", torch.float32, 4, dev)
    _check(ids, "ids", torch.int32, 2, dev)
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    N, M = codes.shape
    B, K = ids.shape
    L = 2 if metric == "cos" else 1
    if tuple(luts.shape) != (B, L, M, N_CENTROIDS):
        raise ValueError(
            f"luts has shape {tuple(luts.shape)}, expected "
            f"{(B, L, M, N_CENTROIDS)} for {metric}")
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B * K == 0:
        return out
    if N == 0:
        return out.fill_(float("inf"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(
            codes.data_ptr(), N, M, luts.data_ptr(), ids.data_ptr(), B, K,
            METRIC_CODES[metric], out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"adc_gather_distance launch failed: CUDA error {err}")
    launches[form] += 1
    return out


def adc_gather_distance_batch_cuda(
    codes: torch.Tensor,  # (N, M) uint8, CUDA
    luts: torch.Tensor,  # (B, L, M, 256) float32
    ids: torch.Tensor,  # (B, K) int32, -1 padded
    metric: str = "l2",
) -> torch.Tensor:
    """Launch the kernel for B queries: (B, K) distances."""
    return _launch(codes, luts, ids, metric, "adc_gather_distance_batch")


def adc_gather_distance_cuda(
    codes: torch.Tensor,  # (N, M) uint8, CUDA
    lut: torch.Tensor,  # (L, M, 256) float32
    ids: torch.Tensor,  # (K,) int32, -1 padded
    metric: str = "l2",
) -> torch.Tensor:
    """Launch the kernel for one query (the batched launch at B = 1, so
    both forms give the same bits): (K,) distances."""
    if ids.dim() != 1 or lut.dim() != 3:
        raise ValueError(
            f"single form takes (K,) ids and an (L, M, 256) table, got "
            f"{tuple(ids.shape)} and {tuple(lut.shape)}"
        )
    return _launch(codes, lut[None], ids[None], metric,
                   "adc_gather_distance")[0]
