"""One hop step of the lazy search on the card (``csrc/hop_step.cu``): B.8.

Replaces no TPU kernel: the reference's hop step is the body of a
``lax.while_loop`` that XLA fuses into one program
(``src/repro/core/search.py:240-268``). The port ran it as ~90 small
launches; this kernel is the whole step, one block a query, with the
distance stage of B.1 and B.3 (``csrc/row_distance.cuh``) and the warp
merge of B.2 (``csrc/warp_merge.cuh``) inside it, so it gives the bits
of the per-op step. Bound: bytes (the visited rows in and out, the beam,
the neighbour row, the tier-2 lookups and the usable rows, at
3.35 TB/s); see the source for what the design does about it.

Its plain version is ``repro_torch.core.search.batch_hop_step_plain``
(the step as PyTorch ops and the gather and merge kernels); which of the
two a step takes is :func:`repro_torch.kernels.ops.hop_step_takes`.

For measuring the step only, never on the engine's path:
:func:`hop_step_stamps_cuda` runs the float32 kernel's timing
instantiation, which stamps the SM clock at its stage boundaries;
:func:`launch_floor_cuda` launches an empty kernel on the step's grid;
:func:`sm_cycles_per_ns` reads the SM clock against the global timer.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_distance import METRIC_CODES, _check

# the widest beam-and-neighbour row, ef + deg, the kernel merges
# (kSortMax in csrc/warp_merge.cuh)
MAX_ROW = 256

ELEM_CODES = {torch.float32: 0, torch.int8: 1, torch.float16: 2}

# kernel launches since the last ops.reset_launch_counts()
launches = {"hop_step": 0}

# the stage boundaries a timed step stamps (kStamps in csrc/hop_step.cu),
# each the SM cycle at which the stage ends, 0 the block's start
STAMPS = ("start", "step0", "steps1_3", "steps4_6", "step7", "step8")


def _entry(name: str = "hop_step"):
    fn = getattr(_build.library("hop_step"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        args = [p, i, p, i, i,  # Q, d, neighbors, n_nodes, deg
                p, p, p, i, p,  # beam ids, dists, explored, ef, visited
                p, i, p, p, p,  # miss ids, cap, miss_count, n_hops, n_dist
                p, i, p, i, p,  # table, elem, scales, n_rows, slot_of
                i, p, p, i,  # n_slot_of, id_of, gate, gate_stride
                ll, ll, i, i,  # trigger, max_hops, metric, B
                p, p, p, p, p, p, p, p, p]  # the nine outputs
        if name == "hop_step_stamps":
            args.append(p)  # the (B, 6) stamps
        fn.argtypes = args + [p]  # stream
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def hop_step_cuda(
    Q: torch.Tensor,  # (B, d) float32
    neighbors: torch.Tensor,  # (N, deg) int32, PAD padded
    beam_ids: torch.Tensor,  # (B, ef) int32
    beam_dists: torch.Tensor,  # (B, ef) float32
    explored: torch.Tensor,  # (B, ef) bool
    visited: torch.Tensor,  # (B, N + 1) bool
    miss_ids: torch.Tensor,  # (B, cap) int32
    miss_count: torch.Tensor,  # (B,) int64
    n_hops: torch.Tensor,  # (B,) int64
    n_dist: torch.Tensor,  # (B,) int64
    table: torch.Tensor,  # (R, d) float32, int8 or float16
    scales: Optional[torch.Tensor],  # (R,) float32 for int8
    slot_of: Optional[torch.Tensor],  # (N,) int32, with id_of: a cache
    id_of: Optional[torch.Tensor],  # (R,) int32
    metric: str,
    trigger: int,
    max_hops: int,
    gate: Optional[torch.Tensor] = None,  # () or (B,) bool
) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel: the new state as ``(beam_ids, beam_dists,
    explored, visited, miss_ids, miss_count, n_hops, n_dist)`` and the
    (B,) bool ``active``, all new tensors."""
    return _launch("hop_step", Q, neighbors, beam_ids, beam_dists, explored,
                   visited, miss_ids, miss_count, n_hops, n_dist, table,
                   scales, slot_of, id_of, metric, trigger, max_hops, gate)


def hop_step_stamps_cuda(*args, **kwargs) -> Tuple[torch.Tensor, ...]:
    """:func:`hop_step_cuda`'s step (same arguments, a float32 table) by
    the kernel's timing instantiation: its nine outputs and a (B, 6) int64
    tensor of the SM cycle at which each stage ends (:data:`STAMPS`; an
    inactive query's later stages are 0). Not counted as a launch."""
    return _launch("hop_step_stamps", *args, **kwargs)


def launch_floor_cuda(B: int, device: torch.device) -> None:
    """An empty kernel on the step's grid: B blocks of 256 threads."""
    with torch.cuda.device(device):
        err = _build.library("hop_step").hop_step_floor(
            ctypes.c_int(B),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"hop_step_floor launch failed: CUDA error {err}")


def sm_cycles_per_ns(device: torch.device, cycles: int = 20_000_000) -> float:
    """The SM clock in cycles a nanosecond: one thread spins ``cycles``
    cycles between two reads of the global timer (synchronises)."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _build.library("hop_step").hop_step_clock(
            ctypes.c_longlong(cycles), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"hop_step_clock launch failed: CUDA error {err}")
    c, ns = out.tolist()
    return c / ns


def _launch(entry, Q, neighbors, beam_ids, beam_dists, explored, visited,
            miss_ids, miss_count, n_hops, n_dist, table, scales, slot_of,
            id_of, metric, trigger, max_hops, gate=None):
    dev = Q.device
    if dev.type != "cuda":
        raise ValueError(f"hop_step kernel needs CUDA tensors, got {dev}")
    B, d = Q.shape
    N, deg = neighbors.shape
    ef = beam_ids.shape[-1]
    cap = miss_ids.shape[-1]
    _check(Q, "Q", torch.float32, 2, dev)
    _check(neighbors, "neighbors", torch.int32, 2, dev)
    for t, name, dtype, shape in (
            (beam_ids, "beam_ids", torch.int32, (B, ef)),
            (beam_dists, "beam_dists", torch.float32, (B, ef)),
            (explored, "explored", torch.bool, (B, ef)),
            (visited, "visited", torch.bool, (B, N + 1)),
            (miss_ids, "miss_ids", torch.int32, (B, cap)),
            (miss_count, "miss_count", torch.int64, (B,)),
            (n_hops, "n_hops", torch.int64, (B,)),
            (n_dist, "n_dist", torch.int64, (B,))):
        _check(t, name, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if table.dtype not in ELEM_CODES:
        raise ValueError(f"hop_step takes a float32, int8 or float16 tier 2, "
                         f"got {table.dtype}")
    _check(table, "table", table.dtype, 2, dev)
    R = table.shape[0]
    if table.shape[1] != d:
        raise ValueError(f"table rows are {table.shape[1]} wide, Q {d}")
    if table.dtype == torch.int8:
        if scales is None:
            raise ValueError("an int8 table needs its (R,) float32 scales")
        _check(scales, "scales", torch.float32, 1, dev)
        if scales.shape[0] != R:
            raise ValueError(f"{scales.shape[0]} scales for {R} rows")
    elif scales is not None:
        raise ValueError("only an int8 table carries scales")
    if (slot_of is None) != (id_of is None):
        raise ValueError("a cache passes both slot_of and id_of")
    if slot_of is not None:
        _check(slot_of, "slot_of", torch.int32, 1, dev)
        _check(id_of, "id_of", torch.int32, 1, dev)
        if id_of.shape[0] != R:
            raise ValueError(f"id_of has {id_of.shape[0]} slots for {R} rows")
    gate_stride = 0
    if gate is not None:
        if gate.dtype != torch.bool or gate.device != dev or (
                gate.shape not in ((), (B,))):
            raise ValueError(f"gate: a () or ({B},) bool on {dev}, got "
                             f"{tuple(gate.shape)} {gate.dtype}")
        gate = gate.contiguous()
        gate_stride = 1 if gate.dim() else 0
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    if ef < 1 or ef + deg > MAX_ROW or N < 1 or R < 1:
        raise ValueError(f"hop_step: ef={ef}, deg={deg} (ef + deg at most "
                         f"{MAX_ROW}), {N} nodes, {R} tier-2 rows")
    out = (torch.empty_like(beam_ids), torch.empty_like(beam_dists),
           torch.empty_like(explored), torch.empty_like(visited),
           torch.empty_like(miss_ids), torch.empty_like(miss_count),
           torch.empty_like(n_hops), torch.empty_like(n_dist),
           torch.empty((B,), dtype=torch.bool, device=dev))
    extra = []
    if entry == "hop_step_stamps":
        if table.dtype != torch.float32:
            raise ValueError("the timed step takes a float32 table")
        out += (torch.zeros((B, len(STAMPS)), dtype=torch.int64,
                            device=dev),)
        extra = [out[-1].data_ptr()]
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(entry)(
            Q.data_ptr(), d, neighbors.data_ptr(), N, deg,
            beam_ids.data_ptr(), beam_dists.data_ptr(), explored.data_ptr(),
            ef, visited.data_ptr(),
            miss_ids.data_ptr(), cap, miss_count.data_ptr(),
            n_hops.data_ptr(), n_dist.data_ptr(),
            table.data_ptr(), ELEM_CODES[table.dtype], _ptr(scales), R,
            _ptr(slot_of), 0 if slot_of is None else slot_of.shape[0],
            _ptr(id_of), _ptr(gate), gate_stride,
            int(trigger), int(max_hops), METRIC_CODES[metric], B,
            *(t.data_ptr() for t in out[:9]), *extra, stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    if entry == "hop_step":  # the engine's kernel; the timed one is not
        launches["hop_step"] += 1
    return out
