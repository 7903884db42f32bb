"""Top-k selection on the card: the merge of (dist, id) candidates
(``csrc/merge_topk.cu``) and the row-wise k smallest of a distance matrix
(``csrc/topk.cu``).

``merge_topk_cuda`` replaces ``src/repro/kernels/topk.py`` ::
``merge_topk_pallas`` and serves as the beam merge of the lazy search:
its ``src`` output carries the beam's ``explored`` flags through the
merge. One block per row with the row staged in shared memory; k rounds
of block-wide argmin on (dist, position). Bound: bytes, but at the query
path's shapes (M ≤ 161, k = 64) the latency of the k rounds is what it
pays; see the source.

``topk_cuda`` replaces ``src/repro/kernels/topk.py`` :: ``topk_pallas``
and serves the flat scan's local top-k and the substrate's global
reduce. Split-K in two passes (one warp per 1024-column tile, then one
block per row over the tiles' survivors) on 64-bit (value, column) keys,
under ``lax.top_k``'s contract: ties go to the lower column and ids are
distinct, where ``topk_pallas`` can repeat one. Bound: bytes, the matrix
read once; see the source.

Their plain PyTorch versions are ``ref.merge_topk_ref`` and
``ref.topk_ref``; the dispatch on the tensor's device is
:mod:`repro_torch.kernels.ops`.
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

# the largest k the top-k kernel takes (kMaxK in csrc/topk.cu): twice the
# reference's 64, where its first pass still shrinks a row eightfold
TOPK_MAX_K = 128

# kernel launches since the last ops.reset_launch_counts(), by kernel; a
# top-k launch is its two passes
launches = {"merge_topk": 0, "topk": 0}


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
    launches["merge_topk"] += 1
    return out_d, out_i, out_s


def _topk_lib():
    lib = _build.library("topk")
    if lib.topk_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_f32.argtypes = [p, i, i, i, p, p, p, p]
        lib.topk_f32.restype = ctypes.c_int
        lib.topk_scratch_keys.argtypes = [i, i, i]
        lib.topk_scratch_keys.restype = ctypes.c_longlong
        lib.topk_max_k.argtypes = []
        lib.topk_max_k.restype = ctypes.c_int
    return lib


def check_topk_args(N: int, k: int) -> None:
    """``ValueError`` unless 0 ≤ k ≤ min(N, TOPK_MAX_K)."""
    if not 0 <= k <= TOPK_MAX_K:
        raise ValueError(f"topk: k={k}, at most {TOPK_MAX_K}")
    if k > N:
        raise ValueError(f"topk: k={k} exceeds the row width N={N}")


def topk_cuda(
    D: torch.Tensor,  # (B, N) float32, CUDA
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(dists (B, k) float32, ids (B, k) int32)``."""
    dev = D.device
    if dev.type != "cuda":
        raise ValueError(f"topk kernel needs a CUDA tensor, got {dev}")
    if D.dtype != torch.float32 or D.dim() != 2:
        raise ValueError(
            f"topk takes a 2-D float32 matrix, got {D.dim()}-D {D.dtype}")
    if not D.is_contiguous():
        raise ValueError("topk input must be contiguous")
    B, N = D.shape
    check_topk_args(N, k)
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B * k == 0:
        return out_d, out_i
    lib = _topk_lib()
    # the first pass's survivors: (B, ceil(N / 1024), k) 64-bit keys
    scratch = torch.empty((int(lib.topk_scratch_keys(B, N, k)),),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.topk_f32(D.data_ptr(), B, N, k, scratch.data_ptr(),
                           out_d.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk launch failed: CUDA error {err}")
    launches["topk"] += 1
    return out_d, out_i
