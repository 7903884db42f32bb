"""Distributed WebANNS on ``torch.distributed``: the shard-parallel search
substrate (the port of the first half of ``repro.core.distributed``).

The corpus is row-sharded; shard s is held by rank s of a process group
(:mod:`repro_torch.launch.mesh`), one process per shard, and each shard
owns a local HNSW sub-index over its rows. A query batch arrives split
over the ranks; the search of one batch is one program on every rank
with exactly two collectives:

1. all-gather the rank-local queries (rank-major), so every shard scores
   the whole batch;
2. search the shard: the flat scan (``mode="flat"``: the distance-matrix
   kernel, invalid rows masked to +inf, the top-k kernel) or the local
   HNSW (``mode="hnsw"``: greedy descent and one beam search a query);
3. map local ids to global ids;
4. all-gather every shard's (dist, id) candidates, laid out shard-major
   along each query's row, so a tie goes to the lower shard, which holds
   the lower global ids;
5. take the global top-k of the (B, S·k) candidates with the top-k
   kernel;
6. return this rank's slice of the batch.

``distributed_brute_force`` is the flat-scan variant: the exactness
oracle and the recsys ``retrieval_cand`` path. Its local scan needs only
the vectors, so ``build_sharded_index(..., hnsw=False)`` skips the graphs.

How the reference's mesh maps here:

- ``index_shardings``, a PartitionSpec pytree placing the stacked index
  over the mesh, has no counterpart: :meth:`ShardedIndex.shard` places one
  rank's shard on that rank's device, and each rank holds only its own;
- a ("pod", "data") composite axis is one flat group of S = |pod|·|data|
  ranks, shard ``pod·|data| + data``; the reference's "model" axis, over
  which its output is replicated, has no ranks of its own;
- the engine-facing sharded driver of the reference (``ShardedEngineState``,
  ``sharded_layer_program``, one global graph row-sharded over a 1-D mesh)
  is not ported here (ROADMAP.md, queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import search as S
from repro_torch.core.graph import HNSWGraph
from repro_torch.core.hnsw import build_hnsw
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ShardGroup

INF = float("inf")
# the vector of a padding row, as the reference pads: l2 distances to it
# overflow (inf, or NaN in the GEMM form), and row_valid masks them
PAD_VALUE = np.float32(3.4e38)
MODES = ("hnsw", "flat")


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard HNSW sub-indices in stacked, statically-shaped tensors
    with a leading shard axis (on the host), every shard padded to the same
    (rows, layers, degree)."""

    vectors: torch.Tensor  # (S, rows, d) float32, padded with 3.4e38 rows
    neighbors: torch.Tensor  # (S, L, rows, deg) int32, -1 padded
    levels: torch.Tensor  # (S, rows) int32
    entry: torch.Tensor  # (S,) int32
    max_level: torch.Tensor  # (S,) int32
    row_valid: torch.Tensor  # (S, rows) bool
    base_ids: torch.Tensor  # (S,) int32: global id of shard row 0
    metric: str = "l2"

    @property
    def n_shards(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def rows(self) -> int:
        return int(self.vectors.shape[1])

    def shard(self, s: int, device: DeviceLike = None) -> "LocalShard":
        """Shard ``s``, placed on ``device``: what rank ``s`` holds."""
        dev = resolve_device(device)
        return LocalShard(
            vectors=self.vectors[s].to(dev).contiguous(),
            neighbors=self.neighbors[s].to(dev).contiguous(),
            levels=self.levels[s].to(dev),
            entry=int(self.entry[s]),
            max_level=int(self.max_level[s]),
            row_valid=self.row_valid[s].to(dev),
            base=int(self.base_ids[s]),
            metric=self.metric,
        )


@dataclasses.dataclass
class LocalShard:
    """One shard of a :class:`ShardedIndex` on its rank's device."""

    vectors: torch.Tensor  # (rows, d) float32
    neighbors: torch.Tensor  # (L, rows, deg) int32
    levels: torch.Tensor  # (rows,) int32
    entry: int
    max_level: int
    row_valid: torch.Tensor  # (rows,) bool
    base: int  # global id of row 0
    metric: str = "l2"

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def build_sharded_index(
    X: np.ndarray,
    n_shards: int,
    M: int = 16,
    ef_construction: int = 100,
    metric: str = "l2",
    seed: int = 0,
    hnsw: bool = True,
) -> ShardedIndex:
    """Row-shard X and build one HNSW sub-index per shard (offline), as the
    reference does: shard s holds rows ``[s·rows, (s+1)·rows)`` with
    ``rows = ceil(n / S)``, its graph built with seed ``seed + s``; an empty
    tail shard is built over ``X[:1]`` and marked invalid; padding rows are
    3.4e38 and invalid; ``base_ids[s] = min(s·rows, n − 1)``.

    ``hnsw=False`` builds no graphs (empty neighbor lists, every entry 0),
    for the flat scan, which needs only the vectors.
    """
    X = np.asarray(X, np.float32)
    n, d = X.shape
    rows = (n + n_shards - 1) // n_shards
    graphs: List[HNSWGraph] = []
    shards: List[np.ndarray] = []
    for s in range(n_shards):
        lo, hi = s * rows, min(n, (s + 1) * rows)
        Xs = X[lo:hi]
        if Xs.shape[0] == 0:
            Xs = X[:1]  # degenerate tail shard: single row, masked out
        if hnsw:
            graphs.append(build_hnsw(Xs, M=M, ef_construction=ef_construction,
                                     metric=metric, seed=seed + s))
        shards.append(Xs)
    L = max(g.n_layers for g in graphs) if hnsw else 0
    deg = max(g.max_degree for g in graphs) if hnsw else 0
    vec = np.full((n_shards, rows, d), PAD_VALUE, np.float32)
    nbr = np.full((n_shards, L, rows, deg), -1, np.int32)
    lev = np.zeros((n_shards, rows), np.int32)
    ent = np.zeros((n_shards,), np.int32)
    mxl = np.zeros((n_shards,), np.int32)
    valid = np.zeros((n_shards, rows), bool)
    base = np.zeros((n_shards,), np.int32)
    for s, Xs in enumerate(shards):
        r = Xs.shape[0]
        vec[s, :r] = Xs
        if hnsw:
            g = graphs[s]
            nbr[s, : g.n_layers, :r, : g.max_degree] = g.neighbors
            lev[s, :r] = g.levels
            ent[s] = g.entry_point
            mxl[s] = g.max_level
        lo = s * rows
        valid[s, : min(r, max(0, n - lo))] = True
        base[s] = min(lo, n - 1)
    return ShardedIndex(
        vectors=torch.from_numpy(vec),
        neighbors=torch.from_numpy(nbr),
        levels=torch.from_numpy(lev),
        entry=torch.from_numpy(ent),
        max_level=torch.from_numpy(mxl),
        row_valid=torch.from_numpy(valid),
        base_ids=torch.from_numpy(base),
        metric=metric,
    )


# -------------------------------------------------------------- local path


def _local_knn(
    Q: torch.Tensor,  # (B, d): the whole batch
    shard: LocalShard,
    k: int,
    ef: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-shard HNSW search: (dists (B, k), local ids (B, k)).

    Each query descends the upper layers greedily from the shard's entry
    point; then layer 0 is one beam search of width ``ef`` for the whole
    batch, every row of which evolves as the query's own search would
    (the batched phase leaves a finished query untouched, as the
    reference's vmapped loop does)."""
    if shard.neighbors.shape[0] == 0:
        raise ValueError("mode='hnsw' needs the shards' graphs: build the "
                         "index with hnsw=True")
    B = Q.shape[0]
    dev = Q.device
    entries = [shard.entry] * B
    if shard.max_level > 0:
        entries = [
            S.greedy_descend_inmem(Q[b], shard.vectors, shard.neighbors[1:],
                                   shard.entry, shard.max_level, metric)
            for b in range(B)
        ]
    entry_ids = torch.tensor(entries, dtype=torch.int32, device=dev)[:, None]
    tier2 = S.resident_tier2(shard.vectors)
    state = S.batch_make_state(B, ef, 1, shard.vectors.shape[0], dev)
    state = S.batch_seed_state(state, Q, entry_ids, tier2, metric)
    # ef_trigger 2 > any miss count: tier 2 is the whole shard
    state = S.batch_search_phase(Q, shard.neighbors[0], state, tier2, metric,
                                 ef_trigger=2)
    return state.beam.dists[:, :k], state.beam.ids[:, :k]


def _local_scan(
    Q: torch.Tensor, vectors: torch.Tensor, k: int, metric: str,
    row_valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force scan of one shard: the distance-matrix kernel, invalid
    (padding) rows to +inf, the top-k kernel: (dists (B, k), ids (B, k))."""
    D = ops.distance_topk_ready(Q, vectors, metric)
    D = torch.where(row_valid[None, :], D, INF)
    return ops.topk(D, k)


def _all_gather(t: torch.Tensor, n: int) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts)


# ------------------------------------------------------------ the program


def make_distributed_search(
    group: ShardGroup,
    metric: str = "l2",
    k: int = 10,
    ef: int = 64,
    mode: str = "hnsw",  # 'hnsw' | 'flat'
) -> Callable[[torch.Tensor, LocalShard], Tuple[torch.Tensor, torch.Tensor]]:
    """The search program of one rank: ``search(Q, shard)``.

    ``Q`` is the whole (B, d) batch, the same on every rank (what the
    reference's program takes); B must be divisible by the shard count,
    and this rank's queries are rows ``[rank·B/S, (rank+1)·B/S)``.
    ``shard`` is this rank's :class:`LocalShard` on ``group.device``
    (``index.shard(group.rank, group.device)``). Returns this rank's
    slice of the results, ``(dists (B/S, k), global ids (B/S, k))``; every
    rank must call it with the same B.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {MODES}")
    device = resolve_device(group.device)
    n_shards, rank = group.n_shards, group.rank

    def search(Q: torch.Tensor, shard: LocalShard):
        B = Q.shape[0]
        if B % n_shards:
            raise ValueError(
                f"a batch of {B} queries does not split over {n_shards} "
                "shards: B must be divisible by the shard count"
            )
        if shard.device != device:
            raise ValueError(
                f"the shard lies on {shard.device}, the group on {device}")
        bsz = B // n_shards
        Q_local = torch.as_tensor(Q[rank * bsz:(rank + 1) * bsz],
                                  dtype=torch.float32).to(device)
        # 1st collective: replicate the query batch across the shards
        Qa = _all_gather(Q_local, n_shards).reshape(B, -1)
        if mode == "flat":
            d_loc, i_loc = _local_scan(Qa, shard.vectors, k, metric,
                                       shard.row_valid)
        else:
            d_loc, i_loc = _local_knn(Qa, shard, k, ef, metric)
            rows = shard.row_valid.shape[0]
            invalid = ~shard.row_valid[i_loc.long().clamp(0, rows - 1)]
            d_loc = torch.where((i_loc < 0) | invalid, INF, d_loc)
        # as the reference: +inf entries of a short shard keep i_loc + base
        g_ids = torch.where(i_loc >= 0, i_loc + shard.base, -1).int()
        # 2nd collective: every shard's candidates, (S, B, k) → (B, S·k)
        # shard-major, so the reduce breaks ties toward the lower shard
        d_all = _all_gather(d_loc, n_shards).permute(1, 0, 2).reshape(B, -1)
        i_all = _all_gather(g_ids, n_shards).permute(1, 0, 2).reshape(B, -1)
        dists, sel = ops.topk(d_all.contiguous(), k)
        ids = i_all.gather(1, sel.long())
        lo = rank * bsz
        return dists[lo:lo + bsz], ids[lo:lo + bsz]

    return search


def distributed_brute_force(
    group: ShardGroup, metric: str = "l2", k: int = 10,
) -> Callable[[torch.Tensor, LocalShard], Tuple[torch.Tensor, torch.Tensor]]:
    """Flat-scan variant (exact; retrieval_cand path)."""
    return make_distributed_search(group, metric=metric, k=k, mode="flat")
