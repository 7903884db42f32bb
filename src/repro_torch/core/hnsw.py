"""Offline HNSW index construction (NumPy; the port's copy of
``repro.core.hnsw``).

Construction is a faithful NumPy implementation of Malkov & Yashunin's
algorithms 1/3/4/5 (INSERT, SEARCH-LAYER, SELECT-NEIGHBORS-HEURISTIC,
KNN-SEARCH) and runs on the host in both packages; only the online query
path runs on the device (:mod:`repro_torch.core.search`). The code is the
reference's, line for line, so the same seed gives ``array_equal``
neighbors, levels and entry point. Incremental insertion
(:func:`insert_hnsw`, the engine's ``add``) runs the same per-point
loop, so a graph grown by inserts equals the offline build over the
concatenated corpus.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import PAD, HNSWGraph, empty_graph, random_levels


# --------------------------------------------------------------- distances


def pairwise_distance(
    X: np.ndarray, q: np.ndarray, metric: str = "l2"
) -> np.ndarray:
    """Distance from query ``q`` (d,) to each row of ``X`` (k, d).

    'l2'  : squared euclidean (monotonic in euclidean; HNSW only compares)
    'ip'  : negative inner product (so smaller = more similar)
    'cos' : negative cosine similarity
    """
    if X.ndim == 1:
        X = X[None, :]
    if metric == "l2":
        diff = X - q[None, :]
        return np.einsum("kd,kd->k", diff, diff)
    if metric == "ip":
        return -(X @ q)
    if metric == "cos":
        xn = np.linalg.norm(X, axis=-1) + 1e-30
        qn = np.linalg.norm(q) + 1e-30
        return -(X @ q) / (xn * qn)
    raise ValueError(f"unknown metric {metric!r}")


class _VisitedPool:
    """Reusable visited-set with O(1) reset via version stamping."""

    def __init__(self, n: int):
        self.stamp = np.zeros(n, dtype=np.int64)
        self.version = 0

    def fresh(self) -> "_VisitedPool":
        self.version += 1
        return self

    def visit(self, ids) -> None:
        self.stamp[ids] = self.version

    def seen(self, ids) -> np.ndarray:
        return self.stamp[ids] == self.version


# ---------------------------------------------------------- layer search


def search_layer_np(
    X: np.ndarray,
    neighbors_l: np.ndarray,
    q: np.ndarray,
    eps: Sequence[int],
    ef: int,
    metric: str,
    visited: Optional[_VisitedPool] = None,
) -> List[Tuple[float, int]]:
    """SEARCH-LAYER (HNSW Alg. 2): returns up to ``ef`` nearest (dist, id),
    sorted ascending by distance. Reference implementation, fully in-memory
    (no cache model) — also the oracle for the lazy JAX search.
    """
    if visited is None:
        visited = _VisitedPool(X.shape[0])
    visited = visited.fresh()
    eps = list(dict.fromkeys(int(e) for e in eps))
    d0 = pairwise_distance(X[eps], q, metric)
    visited.visit(eps)
    # C: min-heap of candidates; W: max-heap (negated) of current best ef
    C = [(float(d), int(e)) for d, e in zip(d0, eps)]
    heapq.heapify(C)
    W = [(-float(d), int(e)) for d, e in zip(d0, eps)]
    heapq.heapify(W)
    while len(W) > ef:
        heapq.heappop(W)
    while C:
        dc, c = heapq.heappop(C)
        df = -W[0][0]
        if dc > df and len(W) >= ef:
            break  # all elements in W evaluated
        nbrs = neighbors_l[c]
        nbrs = nbrs[nbrs != PAD]
        if nbrs.size == 0:
            continue
        new = nbrs[~visited.seen(nbrs)]
        if new.size == 0:
            continue
        visited.visit(new)
        dn = pairwise_distance(X[new], q, metric)
        df = -W[0][0]
        for d, e in zip(dn, new):
            d = float(d)
            if len(W) < ef or d < df:
                heapq.heappush(C, (d, int(e)))
                heapq.heappush(W, (-d, int(e)))
                if len(W) > ef:
                    heapq.heappop(W)
                df = -W[0][0]
    out = sorted((-d, i) for d, i in W)
    return [(d, i) for d, i in out]


def greedy_closest_np(
    X: np.ndarray,
    neighbors_l: np.ndarray,
    q: np.ndarray,
    ep: int,
    metric: str,
) -> int:
    """Greedy ef=1 descent step used on upper layers."""
    cur = int(ep)
    cur_d = float(pairwise_distance(X[cur], q, metric)[0])
    while True:
        nbrs = neighbors_l[cur]
        nbrs = nbrs[nbrs != PAD]
        if nbrs.size == 0:
            return cur
        dn = pairwise_distance(X[nbrs], q, metric)
        j = int(np.argmin(dn))
        if dn[j] < cur_d:
            cur, cur_d = int(nbrs[j]), float(dn[j])
        else:
            return cur


# ------------------------------------------------------ neighbor selection


def _dist_matrix(V: np.ndarray, metric: str) -> np.ndarray:
    """All-pairs distances among rows of V (k, d) under ``metric``."""
    G = V @ V.T
    if metric == "l2":
        n2 = np.einsum("kd,kd->k", V, V)
        D = n2[:, None] + n2[None, :] - 2.0 * G
        return np.maximum(D, 0.0)
    if metric == "ip":
        return -G
    if metric == "cos":
        nv = np.linalg.norm(V, axis=-1) + 1e-30
        return -G / (nv[:, None] * nv[None, :])
    raise ValueError(f"unknown metric {metric!r}")


def select_neighbors_heuristic(
    X: np.ndarray,
    q: np.ndarray,
    candidates: List[Tuple[float, int]],
    M: int,
    metric: str,
) -> List[int]:
    """SELECT-NEIGHBORS-HEURISTIC (HNSW Alg. 4), keepPruned=True.

    Keeps a diverse neighbor set: candidate e is accepted only if it is
    closer to q than to every already-selected neighbor. Candidate-to-
    candidate distances are computed once as a matrix (one BLAS call)
    instead of per-pair — same semantics, ~10x faster construction.
    """
    cand = sorted(candidates)
    if len(cand) <= 1 or M >= len(cand):
        return [e for _, e in cand[:M]]
    ids = [e for _, e in cand]
    d_q = [d for d, _ in cand]
    D = _dist_matrix(X[ids], metric)
    selected: List[int] = []
    pruned: List[int] = []
    for i in range(len(ids)):
        if len(selected) >= M:
            break
        if not selected or d_q[i] < D[i, selected].min():
            selected.append(i)
        else:
            pruned.append(i)
    for i in pruned:  # keepPrunedConnections: fill with closest pruned
        if len(selected) >= M:
            break
        selected.append(i)
    return [ids[i] for i in selected]


def select_neighbors_simple(
    candidates: List[Tuple[float, int]], M: int
) -> List[int]:
    return [e for _, e in sorted(candidates)[:M]]


# ------------------------------------------------------------ construction


def _add_link(
    X: np.ndarray,
    nb: np.ndarray,
    deg: np.ndarray,
    l: int,
    a: int,
    b: int,
    m_max: int,
    metric: str,
    heuristic: bool,
    dirty: Optional[set] = None,
) -> None:
    """Append link a->b; shrink with the selection rule if over m_max.

    ``dirty`` (when given) collects every node whose neighbor list this
    call mutates — the delta-persistence witness for incremental inserts.
    """
    if dirty is not None:
        dirty.add(int(a))
    da = deg[l, a]
    if da < m_max:
        nb[l, a, da] = b
        deg[l, a] = da + 1
        return
    cur = nb[l, a, :da]
    cand_ids = np.concatenate([cur, [b]])
    dists = pairwise_distance(X[cand_ids], X[a], metric)
    cand = list(zip(dists.tolist(), cand_ids.tolist()))
    if heuristic:
        keep = select_neighbors_heuristic(X, X[a], cand, m_max, metric)
    else:
        keep = select_neighbors_simple(cand, m_max)
    nb[l, a, : len(keep)] = keep
    nb[l, a, len(keep) :] = PAD
    deg[l, a] = len(keep)


def _insert_point(
    X: np.ndarray,
    nb: np.ndarray,  # (L, N, 2M) int32, mutated in place
    deg: np.ndarray,  # (L, N) int32, mutated in place
    levels: np.ndarray,
    i: int,
    entry: int,
    max_level: int,
    M: int,
    ef_construction: int,
    metric: str,
    heuristic: bool,
    visited: _VisitedPool,
    exclude: Optional[np.ndarray] = None,  # (N,) bool — never LINK to these
    dirty: Optional[set] = None,
) -> Tuple[int, int]:
    """INSERT (HNSW Alg. 1) of one point against the current graph.

    The reference shares this loop between offline construction and
    incremental insertion — sharing it is what makes grow-by-add
    reproduce the offline build bit-for-bit. ``exclude`` masks tombstoned
    nodes out of *link
    selection* (a live corpus never links new nodes to deleted ones)
    while still letting the construction search navigate through them.
    Returns the possibly-updated ``(entry, max_level)``.
    """
    l_i = int(levels[i])
    ep = entry
    # greedy descent through layers above l_i
    for lc in range(max_level, l_i, -1):
        ep = greedy_closest_np(X, nb[lc], X[i], ep, metric)
    eps = [ep]
    for lc in range(min(l_i, max_level), -1, -1):
        W = search_layer_np(
            X, nb[lc], X[i], eps, ef_construction, metric, visited
        )
        cand = (
            W if exclude is None
            else [(d, e) for d, e in W if not exclude[e]]
        )
        m_max = 2 * M if lc == 0 else M
        if heuristic:
            sel = select_neighbors_heuristic(X, X[i], cand, M, metric)
        else:
            sel = select_neighbors_simple(cand, M)
        for e in sel:
            _add_link(X, nb, deg, lc, i, e, m_max, metric, heuristic, dirty)
            _add_link(X, nb, deg, lc, e, i, m_max, metric, heuristic, dirty)
        eps = [e for _, e in W]
    if l_i > max_level:
        return i, l_i
    return entry, max_level


def build_hnsw(
    X: np.ndarray,
    M: int = 16,
    ef_construction: int = 200,
    metric: str = "l2",
    seed: int = 0,
    heuristic: bool = True,
    levels: Optional[np.ndarray] = None,
) -> HNSWGraph:
    """Construct an HNSW graph over ``X`` (N, d). Faithful insert loop."""
    X = np.asarray(X, dtype=np.float32)
    N = X.shape[0]
    if N == 0:
        raise ValueError("empty dataset")
    rng = np.random.default_rng(seed)
    if levels is None:
        levels = random_levels(N, M, rng)
    levels = levels.astype(np.int32)
    g = empty_graph(N, int(levels.max()), M, metric)
    g.levels = levels
    nb = g.neighbors  # (L, N, 2M) int32 view, mutated in place
    deg = np.zeros((g.n_layers, N), dtype=np.int32)
    visited = _VisitedPool(N)

    entry, max_level = 0, int(levels[0])
    for i in range(1, N):
        entry, max_level = _insert_point(
            X, nb, deg, levels, i, entry, max_level, M, ef_construction,
            metric, heuristic, visited,
        )
    g.entry_point, g.max_level = entry, max_level
    return g


def insert_hnsw(
    g: HNSWGraph,
    X: np.ndarray,  # (N_total, d) — full payload INCLUDING the new rows
    new_ids: Sequence[int],  # contiguous range [g.size, N_total)
    levels_new: np.ndarray,  # (len(new_ids),) int32 — pre-sampled levels
    ef_construction: int = 200,
    heuristic: bool = True,
    exclude: Optional[np.ndarray] = None,  # (N_total,) bool — tombstoned
    restart_entry: bool = False,
) -> Tuple[HNSWGraph, set]:
    """Incremental INSERT of new points into an existing graph.

    Runs exactly the per-point insert loop of :func:`build_hnsw`
    (level sampling is the caller's job — the engine continues the
    build-time level stream), so growing an index one ``add()`` at a
    time reproduces the full offline build bit-for-bit when no deletes
    intervene (tested in ``tests/test_mutation.py``). Bidirectional
    link repair is the same ``_add_link`` shrink rule construction uses.

    Returns ``(grown_graph, dirty)`` where ``dirty`` is the set of
    PRE-EXISTING node ids whose neighbor lists changed — the rows a
    delta save must rewrite (new rows land in appended shards).
    The input graph's arrays are not aliased by the result.

    ``restart_entry`` handles the fully-tombstoned graph: the first new
    point becomes the entry (exactly how :func:`build_hnsw` seeds node
    0 — inserted without a search, since there is nothing live to link
    to) and the remaining points insert against it. Without it, inserts
    into a dead graph would come out as disconnected singletons.
    """
    new_ids = np.asarray(new_ids, dtype=np.int64)
    if new_ids.size == 0:
        return g, set()
    X = np.asarray(X, dtype=np.float32)
    if int(new_ids[0]) != g.size or not np.all(np.diff(new_ids) == 1):
        raise ValueError(
            f"new_ids must be the contiguous range [{g.size}, "
            f"{g.size + len(new_ids)}), got {new_ids[:4]}…"
        )
    n_total = g.size + len(new_ids)
    if X.shape[0] != n_total:
        raise ValueError(
            f"X must hold all {n_total} rows (old + new), got {X.shape[0]}"
        )
    levels_new = np.asarray(levels_new, dtype=np.int32)
    n_layers = max(g.n_layers, int(levels_new.max()) + 1)
    neighbors = np.full(
        (n_layers, n_total, g.max_degree), PAD, dtype=np.int32
    )
    neighbors[: g.n_layers, : g.size] = g.neighbors
    levels = np.concatenate([g.levels, levels_new])
    deg = (neighbors != PAD).sum(axis=2, dtype=np.int32)
    visited = _VisitedPool(n_total)
    dirty: set = set()
    entry, max_level = int(g.entry_point), int(g.max_level)
    start = 0
    if restart_entry:
        # dead graph: the first new point IS the new entry; max_level
        # restarts at its level, so searches skip the dead top layers
        entry, max_level = int(new_ids[0]), int(levels_new[0])
        start = 1
    for i in new_ids[start:]:
        entry, max_level = _insert_point(
            X, neighbors, deg, levels, int(i), entry, max_level, g.M,
            ef_construction, g.metric, heuristic, visited,
            exclude=exclude, dirty=dirty,
        )
    g2 = HNSWGraph(
        neighbors=neighbors, levels=levels, entry_point=entry,
        max_level=max_level, M=g.M, metric=g.metric,
    )
    dirty.difference_update(int(i) for i in new_ids)
    return g2, dirty


# ------------------------------------------------------------ knn search


def knn_search_np(
    X: np.ndarray,
    g: HNSWGraph,
    q: np.ndarray,
    k: int,
    ef: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """KNN-SEARCH (HNSW Alg. 5) — in-memory reference query path."""
    ep = g.entry_point
    for lc in range(g.max_level, 0, -1):
        ep = greedy_closest_np(X, g.neighbors[lc], q, ep, g.metric)
    W = search_layer_np(X, g.neighbors[0], q, [ep], max(ef, k), g.metric)
    W = W[:k]
    ids = np.array([i for _, i in W], dtype=np.int32)
    dists = np.array([d for d, _ in W], dtype=np.float32)
    return ids, dists


def exact_search(
    X: np.ndarray, q: np.ndarray, k: int, metric: str = "l2"
) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force oracle."""
    d = pairwise_distance(X, q, metric)
    ids = np.argsort(d, kind="stable")[:k].astype(np.int32)
    return ids, d[ids].astype(np.float32)
