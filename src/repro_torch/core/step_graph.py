"""Fixed-shape step loops on the device: run eagerly, or replayed from
CUDA graphs.

The reference runs a search phase as one device program, a
``lax.while_loop`` (``src/repro/core/search.py:270``), and the fused
driver's phases as one jitted program (``:506``). The port carries that
structure over as a *step*: a function ``step(carry, consts) -> (carry,
more)`` of fixed-shape tensors that does no host sync, where ``carry``
is the loop's state, ``consts`` its per-call inputs and ``more`` says
(any element true) that another step would do work. A step after the
loop's end must change nothing (every update masked), so a loop may
overrun it: both runners below take ``steps`` steps between two host
checks of ``more``, and take exactly the same steps.

- :func:`run_eager` calls the step from Python (the CPU's loop; on the
  card, the loop a graph is held to).
- :func:`run_graph` captures ``steps`` unrolled steps once in a
  ``torch.cuda.CUDAGraph`` whose static buffers it feeds back (the
  graph copies the last step's carry into its input buffers), and
  replays it: one host launch and one sync for ``steps`` steps.

A capture is keyed by everything that fixes its shapes and pointers:
the caller's ``params``, the shapes of ``carry`` and ``consts``, and the
address, shape and strides of each tensor the step reads from outside
(``baked``: graph rows, the tier-2 slab and maps, a payload). It is
reused across calls and searches, and dropped once any of those
tensors is gone, so a replaced tier 2 (``TieredStore.resize``) is
captured anew, never read through the old pointers. At most
:data:`MAX_CAPTURES` are kept, the least recently used dropped first.

Launch counts stay true: the kernel wrappers count when they are called,
which a graph does only at capture, so a capture takes its own count
back (it launched nothing) and every replay adds the launches it holds
(``ops.add_launch_counts``). The same loop counts the same launches,
replayed or eager.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import ops

Tensors = List[torch.Tensor]
Step = Callable[[Tensors, Tensors], Tuple[Tensors, torch.Tensor]]

# captures kept at once (each holds its graph and its memory pool): room
# for a few engines' layers at a few batch shapes (chip_smoke.py serves
# twelve engines of four layers in turn)
MAX_CAPTURES = 128

# since the last reset_stats(): host checks of a loop's flag, graphs
# captured, graph replays
stats = {"syncs": 0, "captures": 0, "replays": 0}


def reset_stats() -> None:
    for name in stats:
        stats[name] = 0


@dataclasses.dataclass
class _Capture:
    graph: torch.cuda.CUDAGraph
    carry: Tensors  # static input buffers, rewritten by every replay
    consts: Tensors
    more: torch.Tensor  # () bool: the last step's flag, reduced
    launches: Dict[str, int]  # kernel launches one replay makes
    bases: List[weakref.ref]  # the baked tensors' storage owners


_captures: "collections.OrderedDict[tuple, _Capture]" = (
    collections.OrderedDict())


def n_captures() -> int:
    return len(_captures)


def _check(flag: torch.Tensor) -> bool:
    """The loop's one host sync."""
    stats["syncs"] += 1
    return bool(flag)


def _block(step: Step, carry: Tensors, consts: Tensors,
           steps: int) -> Tuple[Tensors, torch.Tensor]:
    more = None
    for _ in range(steps):
        carry, more = step(carry, consts)
    return carry, more.any()


def run_eager(step: Step, carry: Sequence[torch.Tensor],
              consts: Sequence[torch.Tensor], steps: int) -> Tensors:
    """Run ``step`` from Python until a host check, made every ``steps``
    steps, finds that the last step's ``more`` holds nowhere."""
    carry, consts = list(carry), list(consts)
    while True:
        carry, more = _block(step, carry, consts, steps)
        if not _check(more):
            return carry


def _base(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def _sig(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, str(t.device))


def _key(carry, consts, baked, params, steps) -> tuple:
    return (params, steps, tuple(map(_sig, carry)), tuple(map(_sig, consts)),
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in baked))


def _alive(cap: _Capture, baked: Sequence[torch.Tensor]) -> bool:
    return all(ref() is _base(t) for ref, t in zip(cap.bases, baked))


def _lookup(key: tuple, baked: Sequence[torch.Tensor]):
    cap = _captures.get(key)
    if cap is not None and not _alive(cap, baked):
        del _captures[key]  # a tensor it read is gone: never replay it
        cap = None
    if cap is not None:
        _captures.move_to_end(key)
    return cap


def _store(key: tuple, cap: _Capture) -> _Capture:
    for old in [k for k, c in _captures.items()
                if any(ref() is None for ref in c.bases)]:
        del _captures[old]
    _captures[key] = cap
    while len(_captures) > MAX_CAPTURES:
        _captures.popitem(last=False)
    return cap


def _warm(step: Step, carry: Tensors, consts: Tensors,
          steps: int) -> Tuple[Tensors, torch.Tensor]:
    """The first block of a loop with no capture yet, run eagerly on a
    side stream (what a capture needs first: the kernels built and
    loaded, PyTorch's lazy state set up). These are real steps of the
    loop, counted as such."""
    main = torch.cuda.current_stream(carry[0].device)
    side = torch.cuda.Stream(carry[0].device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        carry, more = _block(step, carry, consts, steps)
    main.wait_stream(side)
    for t in carry + [more]:
        t.record_stream(main)  # freed later, after the main stream's use
    return carry, more


def _capture(step: Step, carry: Tensors, consts: Tensors,
             baked: Sequence[torch.Tensor], steps: int) -> _Capture:
    """Capture ``steps`` unrolled steps reading static buffers shaped as
    ``carry`` and ``consts``. A capture that fails raises."""
    s_carry = [torch.empty_like(t) for t in carry]
    s_consts = [torch.empty_like(t) for t in consts]
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    with torch.cuda.graph(graph):
        out, more = _block(step, s_carry, s_consts, steps)
        for dst, src in zip(s_carry, out):
            dst.copy_(src)
    after = ops.launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    ops.add_launch_counts({k: -n for k, n in launches.items()})
    stats["captures"] += 1
    return _Capture(graph, s_carry, s_consts, more, launches,
                    [weakref.ref(_base(t)) for t in baked])


def run_graph(step: Step, carry: Sequence[torch.Tensor],
              consts: Sequence[torch.Tensor],
              baked: Sequence[torch.Tensor], params: tuple,
              steps: int) -> Tensors:
    """:func:`run_eager`'s loop on CUDA tensors, ``steps`` steps a graph
    replay. ``baked`` lists every tensor the step reads other than
    ``carry`` and ``consts``; ``params`` every Python value it closes
    over that shapes its work. Returns a fresh copy of the final carry."""
    carry, consts = list(carry), list(consts)
    key = _key(carry, consts, baked, params, steps)
    cap = _lookup(key, baked)
    if cap is None:
        # captured even where this first block ends the loop: the next
        # call with this key replays
        carry, more = _warm(step, carry, consts, steps)
        cap = _store(key, _capture(step, carry, consts, baked, steps))
        if not _check(more):
            return carry
    for dst, src in zip(cap.carry + cap.consts, carry + consts):
        dst.copy_(src)
    while True:
        cap.graph.replay()
        ops.add_launch_counts(cap.launches)
        stats["replays"] += 1
        if not _check(cap.more):
            return [t.clone() for t in cap.carry]
