"""Fused gather + distance on the card (``csrc/gather_distance.cu``).

Replaces ``src/repro/kernels/gather_distance.py`` ::
``gather_distance_pallas`` and ``gather_distance_batch_pallas``. The
kernel maps one warp to each output, streams the id's row and the query
with float4 loads and reduces with warp shuffles; the row never
round-trips through device memory. Bound: bytes (``B·K·d·4`` read at
3.35 TB/s); see the source for what the design does about it.

Its plain PyTorch version is ``ref.gather_distance_batch_ref``; the
dispatch on the tensor's device is :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

METRIC_CODES = {"l2": 0, "ip": 1, "cos": 2}

# kernel launches since the last ops.reset_launch_counts(), by entry point:
# the single-query form (the loop driver's) and the batched form
launches = {"gather_distance": 0, "gather_distance_batch": 0}


def _entry():
    fn = _build.library("gather_distance").gather_distance_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-D {dtype} tensor on {device}, got "
            f"{t.dim()}-D {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(
    table: torch.Tensor, ids: torch.Tensor, Q: torch.Tensor, metric: str,
    form: str,
) -> torch.Tensor:
    """Check the inputs, launch the kernel, count the launch under
    ``form``: (B, K) distances, +inf for padded ids."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"gather_distance kernel needs CUDA tensors, got {dev}")
    _check(table, "table", torch.float32, 2, dev)
    _check(ids, "ids", torch.int32, 2, dev)
    _check(Q, "Q", torch.float32, 2, dev)
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    N, d = table.shape
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
            table.data_ptr(), N, d, ids.data_ptr(), Q.data_ptr(), B, K,
            METRIC_CODES[metric], out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_distance launch failed: CUDA error {err}")
    launches[form] += 1
    return out


def gather_distance_batch_cuda(
    table: torch.Tensor,  # (N, d) float32, CUDA
    ids: torch.Tensor,  # (B, K) int32, -1 padded
    Q: torch.Tensor,  # (B, d) float32
    metric: str = "l2",
) -> torch.Tensor:
    """Launch the kernel for B queries: (B, K) distances."""
    return _launch(table, ids, Q, metric, "gather_distance_batch")


def gather_distance_cuda(
    table: torch.Tensor,  # (N, d) float32, CUDA
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
    return _launch(table, ids[None], q[None], metric, "gather_distance")[0]
