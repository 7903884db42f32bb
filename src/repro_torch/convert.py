"""Carry state across from the JAX package: its arrays in, the port's
objects out (and the tier-2 cache back out as arrays).

An HNSW index is plain arrays (the vectors, the padded neighbor lists,
the levels and the entry state), and so are a tier-2 cache (the slab at
its precision, the int8 scales, the id↔slot maps, the clock, the LRU
stamps and a pq slab's codebook) and a PQ codebook, so the two packages
exchange them as NumPy arrays and nothing of ``repro`` is imported here.
So is the distributed substrate's stacked index (``ShardedIndex``), a
recsys model's parameter tree (``recsys_from_reference``), and a
metadata predicate tree (``filter_from_reference``: a ``Filter`` is a
frozen dataclass of plain values).
The parity tests build a graph once with the reference and feed the same
arrays to both engines, start both from one tier 2, and give both one
codebook. A quantized tier-3 payload is never carried across: the port
quantizes (or encodes) the float32 table with its own codec.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.distributed import ShardedIndex
from repro_torch.core.graph import HNSWGraph
from repro_torch.core.metadata import Filter
from repro_torch.core.pq import PQCodebook
from repro_torch.core.store import CacheState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys import RecsysConfig, init_recsys


def from_reference(
    vectors: np.ndarray,  # (N, d)
    neighbors: np.ndarray,  # (n_layers, N, max_degree), -1 padded
    levels: np.ndarray,  # (N,)
    entry_point: int,
    max_level: int,
    M: int,
    metric: str = "l2",
) -> Tuple[HNSWGraph, np.ndarray]:
    """The port's ``(HNSWGraph, table)`` for a reference index.

    Arrays are copied into the port's dtypes (float32 table, int32
    graph); ``ValueError`` if their shapes disagree.
    """
    table = np.array(vectors, dtype=np.float32, copy=True)
    nb = np.array(neighbors, dtype=np.int32, copy=True)
    lv = np.array(levels, dtype=np.int32, copy=True)
    if table.ndim != 2 or nb.ndim != 3:
        raise ValueError(
            f"vectors must be (N, d) and neighbors (L, N, deg), got "
            f"{table.shape} and {nb.shape}"
        )
    if nb.shape[1] != table.shape[0] or lv.shape != (table.shape[0],):
        raise ValueError(
            f"{table.shape[0]} vectors, but neighbors cover {nb.shape[1]} "
            f"ids and levels {lv.shape}"
        )
    graph = HNSWGraph(
        neighbors=nb, levels=lv, entry_point=int(entry_point),
        max_level=int(max_level), M=int(M), metric=metric,
    )
    graph.validate()
    return graph, table


def codebook_from_reference(ref_engine) -> PQCodebook:
    """The port's :class:`PQCodebook` holding a reference engine's frozen
    centroids (its ``pq_codebook``), bit for bit; ``ValueError`` if that
    engine has none."""
    cb = getattr(ref_engine, "pq_codebook", None)
    if cb is None:
        raise ValueError("the reference engine holds no PQ codebook")
    cent = np.array(cb.centroids, dtype=np.float32, copy=True)
    if cent.ndim != 3:
        raise ValueError(f"centroids must be (M, K, dsub), got {cent.shape}")
    return PQCodebook(centroids=cent)


def filter_from_reference(f) -> Filter:
    """The port's :class:`Filter` with the tree of a reference ``Filter``
    (any object with ``op``, ``column``, ``value`` and ``children``),
    node for node, so one predicate goes to both engines."""
    return Filter(op=f.op, column=f.column, value=f.value,
                  children=tuple(filter_from_reference(c)
                                 for c in f.children))


CACHE_FIELDS = ("slab", "scales", "slot_of", "id_of", "clock", "last_used",
                "codebook")


def cache_from_reference(
    slab: np.ndarray,  # (capacity, d) f32 / f16 / int8, or (capacity, M) u8
    scales: np.ndarray,  # (capacity,) float32 for int8, (0,) otherwise
    slot_of: np.ndarray,  # (N,) int32
    id_of: np.ndarray,  # (capacity,) int32
    clock,  # () insertion cursor / LRU tick
    last_used: np.ndarray,  # (capacity,) int32
    codebook: Optional[np.ndarray] = None,  # (M, 256, dsub): pq slab
    device: DeviceLike = None,
) -> CacheState:
    """The port's :class:`CacheState` holding a reference cache's arrays
    (as NumPy, in :data:`CACHE_FIELDS` order), bit for bit, on
    ``device``; ``ValueError`` if their shapes or the slab dtype
    disagree."""
    dev = resolve_device(device)
    slab = np.asarray(slab)
    precision = quant.precision_of(torch.from_numpy(slab[:0].copy()).dtype)
    cap = slab.shape[0]
    scales = np.asarray(scales, np.float32)
    want_scales = (cap,) if precision == "int8" else (0,)
    if slab.ndim != 2 or scales.shape != want_scales:
        raise ValueError(
            f"a {precision} slab {slab.shape} takes scales {want_scales}, "
            f"got {scales.shape}"
        )
    codebook = np.zeros((0, 0, 0), np.float32) if codebook is None \
        else np.asarray(codebook, np.float32)
    if precision == "pq":
        if codebook.ndim != 3 or codebook.shape[0] != slab.shape[1]:
            raise ValueError(
                f"a pq slab {slab.shape} takes an (M, 256, dsub) codebook "
                f"with M = {slab.shape[1]}, got {codebook.shape}"
            )
    elif codebook.size:
        raise ValueError(f"a {precision} slab carries no codebook")
    id_of = np.asarray(id_of, np.int32)
    last_used = np.asarray(last_used, np.int32)
    if id_of.shape != (cap,) or last_used.shape != (cap,):
        raise ValueError(
            f"capacity {cap}, but id_of {id_of.shape} and last_used "
            f"{last_used.shape}"
        )

    def up(a):
        return torch.as_tensor(np.array(a, copy=True), device=dev)

    return CacheState(
        slab=up(slab), scales=up(scales),
        slot_of=up(np.asarray(slot_of, np.int32)), id_of=up(id_of),
        clock=torch.tensor(int(np.asarray(clock)), dtype=torch.int64,
                           device=dev),
        last_used=up(last_used),
        codebook=up(codebook),
    )


def cache_to_numpy(cache: CacheState) -> Dict[str, np.ndarray]:
    """A copy of the port cache's arrays by :data:`CACHE_FIELDS` name, on
    the host (the reference's dtypes: the clock as an int32 scalar). The
    cache ops update in place, so the copy is what keeps a snapshot."""
    out = {name: getattr(cache, name).cpu().numpy().copy()
           for name in CACHE_FIELDS}
    out["clock"] = np.int32(out["clock"])
    return out


SHARDED_FIELDS = ("vectors", "neighbors", "levels", "entry", "max_level",
                  "row_valid", "base_ids")
_SHARDED_DTYPES = (np.float32, np.int32, np.int32, np.int32, np.int32, bool,
                   np.int32)


def sharded_index_from_reference(ref_index) -> ShardedIndex:
    """The port's :class:`ShardedIndex` (host tensors) holding a reference
    ``ShardedIndex``'s arrays bit for bit (any object with the
    :data:`SHARDED_FIELDS` arrays and a ``metric``); ``ValueError`` if
    their leading shard axes or row counts disagree."""
    arrs = {
        name: np.array(np.asarray(getattr(ref_index, name)), dtype=dt,
                       copy=True)
        for name, dt in zip(SHARDED_FIELDS, _SHARDED_DTYPES)
    }
    S, rows = arrs["vectors"].shape[:2]
    want = {"neighbors": (S, None, rows, None), "levels": (S, rows),
            "entry": (S,), "max_level": (S,), "row_valid": (S, rows),
            "base_ids": (S,)}
    for name, shape in want.items():
        got = arrs[name].shape
        if len(got) != len(shape) or any(
                w is not None and w != g for w, g in zip(shape, got)):
            raise ValueError(
                f"{name} has shape {got}, expected {shape} for {S} shards "
                f"of {rows} rows")
    return ShardedIndex(**{name: torch.from_numpy(a)
                           for name, a in arrs.items()},
                        metric=str(getattr(ref_index, "metric", "l2")))


# parameter groups the reference stacks along a leading axis (AutoInt's
# W → W layers, which it scans; BST's blocks, which it indexes)
_STACKED = ("layers", "blocks")


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def recsys_from_reference(
    cfg: RecsysConfig, params: Dict[str, Any], device: DeviceLike = None,
):
    """The port's recsys model holding a reference parameter tree (its
    ``init_recsys`` output, leaves as NumPy arrays), bit for bit, on
    ``device``.

    The weight layout is kept as it is: a projection is ``x @ w`` with
    ``w`` of shape (d_in, d_out) in both packages, nothing transposed.
    The stacked groups (AutoInt's ``layers``, BST's ``blocks``) are
    unstacked along their leading axis into ``layers.<i>.<name>``.
    ``ValueError`` if the tree's names or shapes differ from the model's.
    """
    flat: Dict[str, np.ndarray] = {}
    for name, leaf in _flatten(params):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        group, _, rest = name.partition(".")
        if group in _STACKED:
            for i in range(arr.shape[0]):
                flat[f"{group}.{i}.{rest}"] = arr[i]
        else:
            flat[name] = arr
    # shapes only, then uninitialised storage on the device, filled below
    model = init_recsys(cfg, torch.Generator(), "meta").to_empty(
        device=resolve_device(device))
    own = dict(model.named_parameters())
    if set(own) != set(flat):
        raise ValueError(
            f"parameter names differ: only in the reference "
            f"{sorted(set(flat) - set(own))}, only in the port "
            f"{sorted(set(own) - set(flat))}")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(p.shape) != flat[name].shape:
                raise ValueError(f"{name}: the reference's shape "
                                 f"{flat[name].shape}, the port's "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(flat[name])))
    return model
