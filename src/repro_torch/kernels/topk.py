"""Top-k merge of (dist, id) candidates on the card (``csrc/merge_topk.cu``).

Replaces ``src/repro/kernels/topk.py`` :: ``merge_topk_pallas``, and
serves as the beam merge of the lazy search: its ``src`` output carries
the beam's ``explored`` flags through the merge. One block per row with
the row staged in shared memory; k rounds of block-wide argmin on
(dist, position). Bound: bytes, but at the query path's shapes
(M ≤ 161, k = 64) the latency of the k rounds is what it pays; see the
source.

Its plain PyTorch version is ``ref.merge_topk_ref``; the dispatch on the
tensor's device is :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# widest row the kernel stages: 48 KB of shared memory less 256 bytes
# for its static arrays, 8 bytes a candidate (csrc/merge_topk.cu); the
# query path's rows are at most ef + miss_cap = 161 wide
MAX_CANDIDATES = (48 * 1024 - 256) // 8

# kernel launches since the last ops.reset_launch_counts()
launches = 0


def _entry():
    fn = _build.library("merge_topk").merge_topk_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def merge_topk_cuda(
    dists: torch.Tensor,  # (B, M) float32, CUDA
    ids: torch.Tensor,  # (B, M) int32, -1 sentinel padded
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(dists, ids, src)``, each (B, k)."""
    global launches
    dev = dists.device
    if dev.type != "cuda" or ids.device != dev:
        raise ValueError(
            f"merge_topk kernel needs CUDA tensors, got {dev} and {ids.device}"
        )
    if dists.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(
            f"merge_topk takes float32 dists and int32 ids, got {dists.dtype} "
            f"and {ids.dtype}"
        )
    if dists.dim() != 2 or dists.shape != ids.shape:
        raise ValueError(
            f"dists {tuple(dists.shape)} and ids {tuple(ids.shape)} must be "
            "the same (B, M) shape"
        )
    if not (dists.is_contiguous() and ids.is_contiguous()):
        raise ValueError("merge_topk inputs must be contiguous")
    B, M = dists.shape
    if k < 0 or M > MAX_CANDIDATES:
        raise ValueError(f"merge_topk: k={k}, M={M} (at most {MAX_CANDIDATES})")
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B * k == 0:
        return out_d, out_i, out_s
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(
            dists.data_ptr(), ids.data_ptr(), B, M, k, out_d.data_ptr(),
            out_i.data_ptr(), out_s.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"merge_topk launch failed: CUDA error {err}")
    launches += 1
    return out_d, out_i, out_s
