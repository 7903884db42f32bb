"""Distance matrix on the card (``csrc/distance_matrix.cu``).

Replaces ``src/repro/kernels/distance.py`` :: ``distance_matrix_pallas``:
(B, d) × (N, d) → (B, N) float32 in the reference's GEMM form, as the
flat scan's local step and recsys' candidate retrieval. The kernel
streams the table through a ring of ``cp.async`` stages and takes the
products on the tensor cores in 3×TF32: each element is split into two
TF32 parts (rounded, not truncated) and three ``mma.sync`` products
(lo·hi, hi·lo, hi·hi) go into float32 accumulators, which keeps the
distances to about float32 accuracy where plain TF32 would not. The row
norms are summed in float32 from the staged tiles, the metric is applied
in the epilogue (cos divides by the norms there, instead of normalising
the table) and the ragged edges are masked in the kernel, so no padded
copy of the table is made. Bound: bytes, the table read once; see the
source.

Its plain PyTorch version is ``ref.distance_matrix_ref``; the dispatch on
the tensor's device is :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

METRIC_CODES = {"l2": 0, "ip": 1, "cos": 2}

# kernel launches since the last ops.reset_launch_counts()
launches = 0


def _entry():
    fn = _build.library("distance_matrix").distance_matrix_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def distance_matrix_cuda(
    Q: torch.Tensor,  # (B, d) float32, CUDA
    X: torch.Tensor,  # (N, d) float32, same device
    metric: str = "l2",
) -> torch.Tensor:
    """Launch the kernel: (B, N) float32 distances."""
    global launches
    dev = Q.device
    if dev.type != "cuda" or X.device != dev:
        raise ValueError(
            f"distance_matrix kernel needs CUDA tensors on one device, got "
            f"{dev} and {X.device}"
        )
    for name, t in (("Q", Q), ("X", X)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(
                f"{name}: expected a 2-D float32 tensor, got {t.dim()}-D "
                f"{t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    (B, d), (N, dx) = Q.shape, X.shape
    if d != dx:
        raise ValueError(f"Q has width {d}, X has width {dx}")
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B * N == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(Q.data_ptr(), X.data_ptr(), B, N, d,
                       METRIC_CODES[metric], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"distance_matrix launch failed: CUDA error {err}")
    launches += 1
    return out
