"""Top-k selection on the card: the merge of (dist, id) candidates
(``csrc/merge_topk.cu``) and the row-wise k smallest of a distance matrix
(``csrc/topk.cu``).

``merge_topk_cuda`` replaces ``src/repro/kernels/topk.py`` ::
``merge_topk_pallas`` and serves as the beam merge of the lazy search:
its ``src`` output carries the beam's ``explored`` flags through the
merge. Rows of at most 256 candidates (kSortMax in the source; every
row an unfiltered search sends) go one warp a row through a bitonic sort
of (dist, position) keys in registers; the dedup sorts (id, rank) keys of
the first k ranks only, and of every valid rank only where those hold a
repeated id. Wider rows, which a filter's widened beam sends (a hop step
at ef 256, load phases at ef 208 and 256), go one block a row: each warp
sorts a run of 256 keys the same way, every key finds its rank in the
row by a binary search of each run in shared memory, and the dedup keeps
each id's least rank in a hash table there (``atomicMin``, so the same
whatever the order); no step is taken once per output entry. Bound:
bytes, but at the query path's shapes (M ≤ 545, k ≤ 256) what it pays
is the sorts' dependent steps; see the source. It launches with no host
sync and allocates nothing beyond its three outputs, so a CUDA graph can
capture it.

``topk_cuda`` replaces ``src/repro/kernels/topk.py`` :: ``topk_pallas``
and serves the flat scan's local top-k, the substrate's global reduce
and the recsys retrieval. Split-K on 64-bit (value, column) keys: one
warp per 1024-column tile emits the tile's k survivors in order (k
rounds of a warp minimum), then a tree of merge levels (``topk_levels``,
32 sorted lists a block, each pair merged in a warp's registers) leaves
one list a row, under
``lax.top_k``'s contract: ties go to the lower column and ids are
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

# widest row the merge takes. A row wider than 256 needs runs_smem(M) =
# 2,048·ceil(M / 256) + 24·M bytes of shared memory (csrc/merge_topk.cu):
# 195,840 at this width. Each wide launch raises the kernel's
# shared-memory limit to its row's need, which the H100 grants up to
# 232,448 bytes a block (M up to about 7,200). The query path's rows are
# at most 2·256 + 32 + 1 = 545 wide (a filter's load phase at ef 256)
MAX_CANDIDATES = 6_112

# the largest k the top-k kernel takes (kMaxK in csrc/topk.cu): twice the
# reference's 64, where its first pass still shrinks a row eightfold
TOPK_MAX_K = 128

# kernel launches since the last ops.reset_launch_counts(), by kernel; a
# top-k launch is its first pass and its merge levels
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
        lib.topk_levels.argtypes = [i]
        lib.topk_levels.restype = ctypes.c_int
    return lib


def topk_levels(N: int) -> int:
    """Merge levels the top-k kernel runs after its first pass at row
    width N (from the built kernel; needs the card's toolchain)."""
    return int(_topk_lib().topk_levels(N))


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
    # the first pass's survivors, (B, ceil(N / 1024), k) 64-bit keys, and
    # the first merge level's, (B, ceil(N / 32768), k)
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
