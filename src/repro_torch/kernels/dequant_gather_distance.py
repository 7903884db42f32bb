"""Fused dequant + gather + distance on the card
(``csrc/dequant_gather_distance.cu``).

Replaces ``src/repro/kernels/dequant_gather_distance.py`` ::
``dequant_gather_distance_pallas`` and
``dequant_gather_distance_batch_pallas``. The table is the quantized
payload itself (int8 rows with one float32 scale each, or float16 rows
with none); one warp per output reads the id's quantized row with 16-byte
loads, dequantizes it in registers and reduces with warp shuffles, so no
float32 copy of the table or of the gathered rows is made. Bound: bytes
(each distinct row's ``d + 4`` int8 or ``2·d`` float16 bytes at
3.35 TB/s); see the source for what the design does about it.

Its plain PyTorch version is ``ref.dequant_gather_distance_batch_ref``;
the dispatch on the tensor's device is :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_distance import METRIC_CODES, _check

ELEM_CODES = {torch.int8: 0, torch.float16: 1}

# kernel launches since the last ops.reset_launch_counts(), by entry point:
# the single-query form (the loop and fused drivers') and the batched form
launches = {"dequant_gather_distance": 0, "dequant_gather_distance_batch": 0}


def _entry():
    fn = _build.library("dequant_gather_distance").dequant_gather_distance
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, i, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(
    table: torch.Tensor, scales: Optional[torch.Tensor], ids: torch.Tensor,
    Q: torch.Tensor, metric: str, form: str,
) -> torch.Tensor:
    """Check the inputs, launch the kernel, count the launch under
    ``form``: (B, K) distances, +inf for padded ids."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(
            f"dequant_gather_distance kernel needs CUDA tensors, got {dev}")
    if table.dtype not in ELEM_CODES or table.dim() != 2:
        raise ValueError(
            f"table: expected a 2-D int8 or float16 tensor, got "
            f"{table.dim()}-D {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    N, d = table.shape
    if table.dtype == torch.int8:
        if scales is None:
            raise ValueError("an int8 table needs its (N,) float32 scales")
        _check(scales, "scales", torch.float32, 1, dev)
        if scales.shape[0] != N:
            raise ValueError(f"{scales.shape[0]} scales for {N} rows")
    elif scales is not None:
        raise ValueError("a float16 table carries no scales")
    _check(ids, "ids", torch.int32, 2, dev)
    _check(Q, "Q", torch.float32, 2, dev)
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    B, K = ids.shape
    if Q.shape != (B, d):
        raise ValueError(f"Q has shape {tuple(Q.shape)}, expected {(B, d)}")
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B * K == 0:
        return out
    if N == 0:
        return out.fill_(float("inf"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(
            table.data_ptr(), ELEM_CODES[table.dtype],
            None if scales is None else scales.data_ptr(), N, d,
            ids.data_ptr(), Q.data_ptr(), B, K, METRIC_CODES[metric],
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dequant_gather_distance launch failed: CUDA error {err}")
    launches[form] += 1
    return out


def dequant_gather_distance_batch_cuda(
    table: torch.Tensor,  # (N, d) int8 or float16, CUDA
    scales: Optional[torch.Tensor],  # (N,) float32 for int8, None for f16
    ids: torch.Tensor,  # (B, K) int32, -1 padded
    Q: torch.Tensor,  # (B, d) float32
    metric: str = "l2",
) -> torch.Tensor:
    """Launch the kernel for B queries: (B, K) distances."""
    return _launch(table, scales, ids, Q, metric,
                   "dequant_gather_distance_batch")


def dequant_gather_distance_cuda(
    table: torch.Tensor,  # (N, d) int8 or float16, CUDA
    scales: Optional[torch.Tensor],  # (N,) float32 for int8, None for f16
    ids: torch.Tensor,  # (K,) int32, -1 padded
    q: torch.Tensor,  # (d,) float32
    metric: str = "l2",
) -> torch.Tensor:
    """Launch the kernel for one query (the batched launch at B = 1, so
    both forms give the same bits): (K,) distances."""
    if ids.dim() != 1 or q.dim() != 1:
        raise ValueError(
            f"single form takes (K,) ids and a (d,) query, got "
            f"{tuple(ids.shape)} and {tuple(q.shape)}"
        )
    return _launch(table, scales, ids[None], q[None], metric,
                   "dequant_gather_distance")[0]
