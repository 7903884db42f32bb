"""Padded multi-hot embedding bag on the card (``csrc/embedding_bag.cu``).

Replaces ``src/repro/kernels/embedding_bag.py`` :: ``embedding_bag_pallas``:
a (V, d) table (float32, float16 or bfloat16) and (B, S) ids padded with
-1 give (B, d) float32 bags, the sum or the mean over the valid slots. It
also takes the optional (B, S) float32 weights that the reference's
dispatch sends to its plain oracle, so a weighted bag runs the kernel too.
Each column is summed in slot order with IEEE operations, so the kernel
equals its plain version ``ref.embedding_bag_ref`` bit for bit. Bound:
bytes, each distinct row read once; see the source.

The dispatch on the tensor's device is :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
COMBINERS = {"sum": 0, "mean": 1}
_MAX_INT32 = 2**31 - 1

# kernel launches since the last ops.reset_launch_counts()
launches = 0


def _entry():
    fn = _build.library("embedding_bag").embedding_bag
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, i, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def embedding_bag_cuda(
    table: torch.Tensor,  # (V, d) float32 / float16 / bfloat16, CUDA
    idx: torch.Tensor,  # (B, S) int32 or int64, -1 padded
    weights: Optional[torch.Tensor] = None,  # (B, S) float32
    combiner: str = "sum",
) -> torch.Tensor:
    """Launch the kernel: (B, d) float32 bags."""
    global launches
    dev = table.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(
            f"embedding_bag kernel needs CUDA tensors on one device, got "
            f"{dev} and {idx.device}"
        )
    if table.dim() != 2 or table.dtype not in DTYPE_CODES:
        raise ValueError(
            f"table: expected a 2-D float32, float16 or bfloat16 tensor, got "
            f"{table.dim()}-D {table.dtype}"
        )
    if idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"idx: expected a 2-D int32 or int64 tensor, got {idx.dim()}-D "
            f"{idx.dtype}"
        )
    if weights is not None and (
            weights.dtype != torch.float32 or weights.shape != idx.shape
            or weights.device != dev):
        raise ValueError(
            f"weights: expected float32 {tuple(idx.shape)} on {dev}, got "
            f"{weights.dtype} {tuple(weights.shape)} on {weights.device}"
        )
    for name, t in (("table", table), ("idx", idx), ("weights", weights)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    (V, d), (B, S) = table.shape, idx.shape
    if not 0 < V <= _MAX_INT32 or B > _MAX_INT32 or d > _MAX_INT32:
        raise ValueError(f"embedding_bag: table {tuple(table.shape)}, "
                         f"idx {tuple(idx.shape)} out of the kernel's range")
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    if B * d == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(
            table.data_ptr(), DTYPE_CODES[table.dtype], V, d, idx.data_ptr(),
            int(idx.dtype == torch.int64),
            None if weights is None else weights.data_ptr(), B, S,
            COMBINERS[combiner], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    launches += 1
    return out
