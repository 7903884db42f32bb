"""Mememo baseline (SIGIR '24) — the paper's SOTA comparison point, for
the port (a copy of ``repro.core.mememo``; nothing of ``repro`` is
imported).

Reimplements the behaviors the paper measures (§2.1.2, §2.2):

- **Interpreted compute**: distance evaluations in a plain Python loop
  (``compute='interpreted'``) modeling JavaScript's cost profile, or a
  NumPy path (``compute='numpy'``) as a *conservative* stand-in when the
  interpreted path would make large benchmarks impractical (this favors
  the baseline).
- **Heuristic neighbor prefetch**: on a cache miss for vector ``e`` while
  searching layer ``lc``, Mememo prefetches up to ``p`` vectors by BFS
  over the *current layer* starting from ``e`` (p = the predefined cache
  size) in one IndexedDB access. The redundancy of this strategy (Eq. 1)
  is what WebANNS's lazy loading eliminates.
- **Eager fetching**: the search blocks on every miss event (one external
  access per miss), unlike WebANNS's phase-batched loads.
- **Fixed cache size**: no adaptation (the paper's third limitation).

The baseline stays on the host in both packages: it models the browser's
interpreted engine, so it takes no device argument and launches no
kernel. Putting it on the card would change what it measures. It shares
the port's :class:`~repro_torch.core.engine.QueryStats`,
:class:`~repro_torch.core.graph.HNSWGraph` and
:class:`~repro_torch.core.store.ExternalStore` (tier 3 and its counters),
so its counts compare with the port's engine's directly.
"""

from __future__ import annotations

import heapq
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import QueryStats
from repro_torch.core.graph import PAD, HNSWGraph
from repro_torch.core.store import ExternalStore


def _dist_interpreted(a: np.ndarray, b: np.ndarray, metric: str) -> float:
    """Scalar Python-loop distance — the 'interpreted JavaScript' model."""
    if metric == "l2":
        s = 0.0
        for x, y in zip(a.tolist(), b.tolist()):
            d = x - y
            s += d * d
        return s
    if metric == "ip":
        s = 0.0
        for x, y in zip(a.tolist(), b.tolist()):
            s += x * y
        return -s
    if metric == "cos":
        s = na = nb = 0.0
        for x, y in zip(a.tolist(), b.tolist()):
            s += x * y
            na += x * x
            nb += y * y
        return -s / ((na**0.5) * (nb**0.5) + 1e-30)
    raise ValueError(metric)


def _dist_numpy(a: np.ndarray, b: np.ndarray, metric: str) -> float:
    if metric == "l2":
        d = a - b
        return float(d @ d)
    if metric == "ip":
        return float(-(a @ b))
    if metric == "cos":
        return float(-(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    raise ValueError(metric)


class _FIFOCache:
    """Fixed-size id→vector FIFO cache (Mememo's predefined cache)."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self.data: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def __contains__(self, i: int) -> bool:
        return i in self.data

    def get(self, i: int) -> np.ndarray:
        return self.data[i]

    def put(self, i: int, v: np.ndarray) -> None:
        if i in self.data:
            return
        while len(self.data) >= self.capacity:
            self.data.popitem(last=False)
        self.data[i] = v

    def __len__(self) -> int:
        return len(self.data)


class MememoEngine:
    """The baseline engine: interpreted compute + heuristic prefetch."""

    def __init__(
        self,
        vectors: np.ndarray,
        graph: HNSWGraph,
        cache_capacity: Optional[int] = None,
        prefetch_size: Optional[int] = None,
        compute: str = "numpy",  # 'interpreted' | 'numpy'
        t_setup: float = 1.0e-3,
        t_per_item: float = 2.0e-6,
    ):
        self.graph = graph
        self.n, self.dim = vectors.shape
        self.external = ExternalStore(
            vectors, t_setup=t_setup, t_per_item=t_per_item
        )
        cap = cache_capacity or self.n
        self.cache = _FIFOCache(cap)
        # Mememo: prefetch size = the predefined cache size p (§2.1.2)
        self.prefetch_size = prefetch_size or cap
        self.compute = compute
        self._dist = (
            _dist_interpreted if compute == "interpreted" else _dist_numpy
        )

    # ------------------------------------------------------------- fetch

    def _prefetch_bfs(self, start: int, layer: int) -> List[int]:
        """BFS over the current layer from the missed node, collecting up
        to ``prefetch_size`` ids not already cached."""
        want: List[int] = []
        seen = {start}
        frontier = [start]
        nb = self.graph.neighbors[layer]
        while frontier and len(want) < self.prefetch_size:
            nxt: List[int] = []
            for u in frontier:
                if u not in self.cache and len(want) < self.prefetch_size:
                    want.append(u)
                for v in nb[u]:
                    v = int(v)
                    if v != PAD and v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        return want

    def _get_vector(self, i: int, layer: int, stats: QueryStats) -> np.ndarray:
        """Cache lookup with Mememo's eager prefetch-on-miss."""
        self.external.mark_used_ids([i])  # demanded (counts once per item)
        if i in self.cache:
            return self.cache.get(i)
        ids = self._prefetch_bfs(i, layer)
        if i not in ids:
            ids = [i] + ids[: max(0, self.prefetch_size - 1)]
        db0 = self.external.stats.n_db
        vecs = self.external.fetch(np.asarray(ids, np.int64))
        self.external.mark_used_ids([i])
        stats.n_db += self.external.stats.n_db - db0
        stats.items_fetched += len(ids)
        for j, v in zip(ids, vecs):
            self.cache.put(int(j), v)
        if i in self.cache:
            return self.cache.get(i)
        return vecs[0]

    # ------------------------------------------------------------- query

    def _search_layer(
        self, q: np.ndarray, ep: List[int], ef: int, layer: int,
        stats: QueryStats,
    ) -> List[Tuple[float, int]]:
        visited = set(ep)
        C: List[Tuple[float, int]] = []
        W: List[Tuple[float, int]] = []
        for e in ep:
            v = self._get_vector(e, layer, stats)
            d = self._dist(q, v, self.graph.metric)
            stats.n_dist += 1
            heapq.heappush(C, (d, e))
            heapq.heappush(W, (-d, e))
        while len(W) > ef:
            heapq.heappop(W)
        nb = self.graph.neighbors[layer]
        while C:
            dc, c = heapq.heappop(C)
            if len(W) >= ef and dc > -W[0][0]:
                break
            stats.n_hops += 1
            for e in nb[c]:
                e = int(e)
                if e == PAD or e in visited:
                    continue
                visited.add(e)
                v = self._get_vector(e, layer, stats)
                d = self._dist(q, v, self.graph.metric)
                stats.n_dist += 1
                if len(W) < ef or d < -W[0][0]:
                    heapq.heappush(C, (d, e))
                    heapq.heappush(W, (-d, e))
                    if len(W) > ef:
                        heapq.heappop(W)
        out = sorted((-d, i) for d, i in W)
        return out

    def query(
        self, q: np.ndarray, k: int = 10, ef: int = 64
    ) -> Tuple[np.ndarray, np.ndarray, QueryStats]:
        stats = QueryStats()
        t0 = time.perf_counter()
        db_t0 = self.external.stats.modeled_time
        ep = [self.graph.entry_point]
        for lc in range(self.graph.max_level, 0, -1):
            W = self._search_layer(q, ep, 1, lc, stats)
            ep = [W[0][1]]
        W = self._search_layer(q, ep, max(ef, k), 0, stats)[:k]
        stats.t_db = self.external.stats.modeled_time - db_t0
        stats.t_in_mem = time.perf_counter() - t0 - stats.t_db * (
            1 if self.external.simulate_latency else 0
        )
        stats.n_visited = stats.n_dist
        ids = np.array([i for _, i in W], np.int32)
        dists = np.array([d for d, _ in W], np.float32)
        return ids, dists, stats
