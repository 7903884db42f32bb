"""WebANNS engine on PyTorch: public API + the host-driven phased-lazy
query drivers (the port of ``repro.core.engine``, float32 slice).

The split is the paper's (§3.2, Fig. 5): the search phases run on the
device (:mod:`repro_torch.core.search`, through the hand-written
kernels), while fetches from tier 3 are host calls made by this driver
between phases. Two drivers serve a batch (DESIGN.md §5):

- ``batch_mode="loop"`` runs the single-query driver once per query;
- ``batch_mode="batched"`` advances all B queries one phase at a time
  against one tier-2 snapshot, unions and deduplicates their miss lists,
  and satisfies them with ONE tier-3 access per phase for the batch.

Engine modes (paper §4.2 baselines): ``webanns`` (phased lazy loading)
and ``webanns-base`` (eager: every expansion's misses fetched at once).

The engine runs on the card unless ``EngineConfig.device`` says
``"cpu"``; without CUDA the default raises. Quantized precisions, the
fused driver, sharding, metadata filters, mutation and persistence come
with later slices of the port and raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import search as S
from repro_torch.core.graph import HNSWGraph
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.storage import StorageBackend
from repro_torch.core.store import (
    EVICT_LRU,
    AccessStats,
    ExternalStore,
    TieredStore,
    cache_touch,
)
from repro_torch.device import resolve_device, synchronize


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md queue A, '{item}'"
    )


@dataclasses.dataclass
class QueryStats:
    """Per-query decomposition behind Eq. 2: T = |Q|·t_in_mem + n_db·t_db."""

    n_visited: int = 0  # |Q|: unique items visited on the search path
    n_dist: int = 0  # distance evaluations
    n_hops: int = 0  # beam expansions
    n_db: int = 0  # external accesses during this query
    items_fetched: int = 0
    t_in_mem: float = 0.0  # host+device compute wall time
    t_db: float = 0.0  # modeled external-access time

    @property
    def t_query(self) -> float:
        return self.t_in_mem + self.t_db


@dataclasses.dataclass
class BatchStats:
    """Whole-batch accounting for the batched query driver (DESIGN.md §5):
    ``n_db`` counts the batch's actual tier-3 transactions, ONE per phase
    with any miss."""

    batch_size: int = 0
    n_db: int = 0  # tier-3 accesses for the WHOLE batch
    items_fetched: int = 0  # deduplicated items pulled from tier 3
    n_phases: int = 0  # load phases driven (across layers)
    t_in_mem: float = 0.0
    t_db: float = 0.0

    @property
    def n_db_per_query(self) -> float:
        return self.n_db / max(1, self.batch_size)

    @property
    def t_batch(self) -> float:
        return self.t_in_mem + self.t_db


ENGINE_MODES = ("webanns", "webanns-base")


@dataclasses.dataclass
class EngineConfig:
    mode: str = "webanns"  # one of ENGINE_MODES
    metric: str = "l2"
    ef_search: int = 64
    ef_upper: int = 1  # beam width on upper layers (HNSW standard: 1)
    cache_capacity: Optional[int] = None  # items; None = dataset size
    eviction: str = "fifo"
    # external-store cost model (see store.ExternalStore)
    t_setup: float = 1.0e-3
    t_per_item: float = 2.0e-6
    simulate_latency: bool = False
    max_phases: int = 10000  # safety bound on lazy phase loop
    # None means "cuda" and raises without CUDA; "cpu" runs the plain path
    device: Optional[str] = None
    # not in this slice: must keep their defaults
    precision: str = "float32"
    fused: bool = False
    n_shards: int = 1

    def __post_init__(self) -> None:
        if self.mode not in ENGINE_MODES:
            raise ValueError(
                f"unknown engine mode {self.mode!r}: expected one of "
                f"{ENGINE_MODES}"
            )
        if self.precision != "float32":
            raise _not_in_slice(f"precision={self.precision!r}",
                                "Quantized precisions")
        if self.fused:
            raise _not_in_slice("the fused driver (fused=True)",
                                "Fused driver")
        if self.n_shards != 1:
            raise _not_in_slice(f"n_shards={self.n_shards}", "Sharded driver")


@dataclasses.dataclass
class SearchRequest:
    """One search call: a single ``(d,)`` query or a ``(B, d)`` batch.
    ``ef=None`` falls back to ``EngineConfig.ef_search``; ``batch_mode``
    ('batched' | 'loop') applies to batches only."""

    query: np.ndarray
    k: int = 10
    ef: Optional[int] = None
    batch_mode: str = "batched"
    filter: None = None  # metadata filters: a later slice


@dataclasses.dataclass
class SearchResult:
    """Typed result: ids/dists (host NumPy) plus the latency decomposition
    (one QueryStats, or a per-query list and ``batch_stats`` for a batch)."""

    ids: np.ndarray  # (k,) or (B, k) int32
    dists: np.ndarray  # (k,) or (B, k) float32
    stats: Union[QueryStats, List[QueryStats]]
    batch_stats: Optional[BatchStats] = None


class WebANNSEngine:
    """The query session over a graph and a tier-3 source.

    ``source`` is a raw ``(N, d)`` float32 array or any
    :class:`StorageBackend`; tier 3 stays on the host, tier 2 and the
    graph live on ``config.device``.
    """

    def __init__(
        self,
        source: Union[np.ndarray, StorageBackend],
        graph: HNSWGraph,
        config: Optional[EngineConfig] = None,
    ):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self.graph = graph
        self.external = ExternalStore(
            source,
            t_setup=self.config.t_setup,
            t_per_item=self.config.t_per_item,
            simulate_latency=self.config.simulate_latency,
        )
        self.n, self.dim = self.external.n_items, self.external.dim
        if graph.size != self.n:
            raise ValueError(
                f"graph covers {graph.size} ids, tier 3 holds {self.n}"
            )
        cap = self.config.cache_capacity or self.n
        self.store = TieredStore(
            self.external, cap, self.config.eviction, device=self.device
        )
        self.neighbors = torch.as_tensor(
            np.asarray(graph.neighbors, np.int32), device=self.device
        )
        self.last_batch_stats: Optional[BatchStats] = None

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        M: int = 16,
        ef_construction: int = 200,
        config: Optional[EngineConfig] = None,
        seed: int = 0,
    ) -> "WebANNSEngine":
        """Build the HNSW graph on the host, then open an engine on it."""
        config = config or EngineConfig()
        resolve_device(config.device)  # raise before the (long) build
        g = build_hnsw(
            vectors, M=M, ef_construction=ef_construction,
            metric=config.metric, seed=seed,
        )
        return cls(vectors, g, config)

    @classmethod
    def open(cls, path: str, *args, **kwargs) -> "WebANNSEngine":
        raise _not_in_slice("reopening a saved index", "Persistence")

    def save(self, path: str, *args, **kwargs) -> dict:
        raise _not_in_slice("saving an index", "Persistence")

    def add(self, vectors, *args, **kwargs):
        raise _not_in_slice("add", "Mutation and filters")

    def delete(self, ids):
        raise _not_in_slice("delete", "Mutation and filters")

    def upsert(self, ids, vectors, *args, **kwargs):
        raise _not_in_slice("upsert", "Mutation and filters")

    # ------------------------------------------------------------ sizing

    def resize_cache(self, capacity: int, warm: bool = False) -> None:
        """Re-initialize tier 2 at ``capacity`` items; ``warm=True``
        re-populates it at once (uncounted init-stage load)."""
        self.store.resize(int(capacity))
        if warm:
            self.warm_cache()

    @property
    def access_stats(self) -> AccessStats:
        """The live tier-3 counters."""
        return self.external.stats

    def warm_cache(self, ids: Optional[np.ndarray] = None) -> None:
        if ids is None:
            ids = np.arange(min(self.store.capacity, self.n))
        ids = np.asarray(ids)
        if len(ids):
            self.store.warm(ids)

    def cache_bytes(self) -> int:
        """Resident tier-2 bytes."""
        return self.store.cache_bytes()

    # ------------------------------------------------------------- query

    def _clock(self) -> float:
        """Host time after the queued device work has finished."""
        synchronize(self.device)
        return time.perf_counter()

    def _lazy_layer(
        self, q: torch.Tensor, layer: int, entry_ids: np.ndarray, ef: int,
        stats: QueryStats, eager: bool,
    ) -> S.SearchState:
        """Run one layer with phased lazy loading (or eager fetches)."""
        cfg = self.config
        miss_cap = ef + self.graph.max_degree + 1
        entry_np = np.full(max(len(entry_ids), 1), -1, np.int32)
        entry_np[: len(entry_ids)] = entry_ids
        state = S.make_state(ef, miss_cap, self.n, self.device)
        state = S.seed_state(
            state, q, torch.as_tensor(entry_np, device=self.device),
            S.cache_tier2(self.store.cache), cfg.metric,
        )
        # eager mode (webanns-base): trigger=1 → flush L after every miss
        trigger = 1 if eager else ef
        slots = torch.arange(miss_cap, dtype=torch.int32, device=self.device)
        for _ in range(cfg.max_phases):
            t0 = self._clock()
            state = S.search_phase(
                q, self.neighbors[layer], state,
                S.cache_tier2(self.store.cache), cfg.metric, trigger,
            )
            mc = int(state.miss_count)
            if self.store.eviction == EVICT_LRU:
                # phase-boundary touch: the beam approximates the
                # recently-used set (in-phase hits are not touched)
                self.store.cache = cache_touch(
                    self.store.cache, state.beam.ids
                )
            stats.t_in_mem += self._clock() - t0
            if mc == 0:
                break
            # ONE tier-3 access for the whole lazy list (Alg. 1 line 24)
            miss_ids = state.miss_ids[:mc].cpu().numpy()
            db0 = self.external.stats.n_db
            rows = self.store.gather(miss_ids)
            stats.n_db += self.external.stats.n_db - db0
            stats.items_fetched += mc
            t0 = self._clock()
            # L is filled from its front, so entry i of L is row i
            state = S.load_phase(
                q, state, state.miss_ids, rows,
                torch.where(state.miss_ids >= 0, slots, -1), cfg.metric,
            )
            stats.t_in_mem += self._clock() - t0
        return state

    def _batched_lazy_layer(
        self, Q: torch.Tensor, layer: int, entry_ids: np.ndarray, ef: int,
        per_stats: List[QueryStats], bstats: BatchStats, eager: bool,
    ) -> S.SearchState:
        """One layer of the batched phased-lazy driver (DESIGN.md §5)."""
        cfg = self.config
        miss_cap = ef + self.graph.max_degree + 1
        trigger = 1 if eager else ef
        t0 = self._clock()
        states = S.batch_make_state(
            Q.shape[0], ef, miss_cap, self.n, self.device
        )
        states = S.batch_seed_state(
            states, Q, torch.as_tensor(entry_ids, device=self.device),
            S.cache_tier2(self.store.cache), cfg.metric,
        )
        bstats.t_in_mem += self._clock() - t0
        for _ in range(cfg.max_phases):
            t0 = self._clock()
            states = S.batch_search_phase(
                Q, self.neighbors[layer], states,
                S.cache_tier2(self.store.cache), cfg.metric, trigger,
            )
            mc = states.miss_count.cpu().numpy()
            if self.store.eviction == EVICT_LRU:
                self.store.cache = cache_touch(
                    self.store.cache, states.beam.ids.reshape(-1)
                )
            bstats.t_in_mem += self._clock() - t0
            if int(mc.sum()) == 0:
                break
            # ONE tier-3 access for the union of all B miss lists
            db0 = self.external.stats.n_db
            fetched0 = self.external.stats.items_fetched
            rows, pos = self.store.gather_batch(states.miss_ids.cpu().numpy())
            bstats.n_db += self.external.stats.n_db - db0
            bstats.items_fetched += (
                self.external.stats.items_fetched - fetched0
            )
            bstats.n_phases += 1
            # per-query demand: which queries needed this shared access
            for b in np.nonzero(mc > 0)[0]:
                per_stats[b].n_db += 1
                per_stats[b].items_fetched += int(mc[b])
            t0 = self._clock()
            states = S.batch_load_phase(
                Q, states, states.miss_ids, rows, pos, cfg.metric
            )
            bstats.t_in_mem += self._clock() - t0
        return states

    def _search_one(
        self, q: np.ndarray, k: int, ef: Optional[int],
    ) -> Tuple[np.ndarray, np.ndarray, QueryStats]:
        """Single-query driver body. Returns (ids, dists, stats)."""
        cfg = self.config
        ef = ef or cfg.ef_search
        eager = cfg.mode == "webanns-base"
        stats = QueryStats()
        qt = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        t_db0 = self.external.stats.modeled_time
        entry = np.array([self.graph.entry_point], np.int32)
        # upper layers: beam of ef_upper (greedy for 1), lazily loaded too
        for lc in range(self.graph.max_level, 0, -1):
            st = self._lazy_layer(qt, lc, entry, cfg.ef_upper, stats, eager)
            best = st.beam.ids[: cfg.ef_upper].cpu().numpy()
            entry = best[best >= 0][:1] if (best >= 0).any() else entry
            stats.n_hops += int(st.n_hops)
            stats.n_dist += int(st.n_dist)
        st = self._lazy_layer(qt, 0, entry, max(ef, k), stats, eager)
        stats.n_hops += int(st.n_hops)
        stats.n_dist += int(st.n_dist)
        stats.n_visited = stats.n_dist  # every visited id gets a distance
        ids = st.beam.ids[:k].cpu().numpy()
        dists = st.beam.dists[:k].cpu().numpy()
        stats.t_db = self.external.stats.modeled_time - t_db0
        return ids, dists, stats

    def _search_many(
        self, Q: np.ndarray, k: int, ef: Optional[int], batch_mode: str,
    ) -> Tuple[np.ndarray, np.ndarray, List[QueryStats]]:
        """Batch driver body (DESIGN.md §5). Both modes return identical
        (ids, dists); per-query ``QueryStats.n_db`` records each query's
        demand, ``self.last_batch_stats`` the batch's actual accesses."""
        cfg = self.config
        ef = ef or cfg.ef_search
        Q = np.asarray(Q, dtype=np.float32)
        B = len(Q)
        if batch_mode == "loop":
            out_i, out_d, out_s = [], [], []
            for q in Q:
                i, d, s = self._search_one(q, k, ef)
                out_i.append(i)
                out_d.append(d)
                out_s.append(s)
            self.last_batch_stats = BatchStats(
                batch_size=B,
                n_db=sum(s.n_db for s in out_s),
                items_fetched=sum(s.items_fetched for s in out_s),
                t_in_mem=sum(s.t_in_mem for s in out_s),
                t_db=sum(s.t_db for s in out_s),
            )
            return np.stack(out_i), np.stack(out_d), out_s
        if batch_mode != "batched":
            raise ValueError(
                f"batch_mode must be 'batched' or 'loop', got {batch_mode!r}"
            )
        eager = cfg.mode == "webanns-base"
        bstats = BatchStats(batch_size=B)
        per_stats = [QueryStats() for _ in range(B)]
        Qt = torch.as_tensor(Q, device=self.device)
        t_db0 = self.external.stats.modeled_time
        entry = np.full((B, 1), self.graph.entry_point, np.int32)
        for lc in range(self.graph.max_level, 0, -1):
            st = self._batched_lazy_layer(
                Qt, lc, entry, cfg.ef_upper, per_stats, bstats, eager
            )
            best = st.beam.ids[:, : cfg.ef_upper].cpu().numpy()
            hops = st.n_hops.cpu().numpy()
            ndist = st.n_dist.cpu().numpy()
            for b in range(B):
                row = best[b][best[b] >= 0]
                if len(row):
                    entry[b, 0] = row[0]
                per_stats[b].n_hops += int(hops[b])
                per_stats[b].n_dist += int(ndist[b])
        st = self._batched_lazy_layer(
            Qt, 0, entry, max(ef, k), per_stats, bstats, eager
        )
        hops = st.n_hops.cpu().numpy()
        ndist = st.n_dist.cpu().numpy()
        ids = st.beam.ids[:, :k].cpu().numpy()
        dists = st.beam.dists[:, :k].cpu().numpy()
        bstats.t_db = self.external.stats.modeled_time - t_db0
        for b in range(B):
            per_stats[b].n_hops += int(hops[b])
            per_stats[b].n_dist += int(ndist[b])
            per_stats[b].n_visited = per_stats[b].n_dist
            # amortized per-query share of the batch's wall/model time
            per_stats[b].t_in_mem = bstats.t_in_mem / B
            per_stats[b].t_db = bstats.t_db / B
        self.last_batch_stats = bstats
        return ids, dists, per_stats

    def search(self, request: SearchRequest) -> SearchResult:
        """Serve one :class:`SearchRequest` — the canonical entry point."""
        if request.filter is not None:
            raise _not_in_slice("SearchRequest.filter", "Mutation and filters")
        q = np.asarray(request.query, dtype=np.float32)
        if q.ndim == 1:
            ids, dists, stats = self._search_one(q, request.k, request.ef)
            return SearchResult(ids=ids, dists=dists, stats=stats)
        if q.ndim != 2:
            raise ValueError(
                f"SearchRequest.query must be (d,) or (B, d), got {q.shape}"
            )
        ids, dists, stats = self._search_many(
            q, request.k, request.ef, request.batch_mode,
        )
        return SearchResult(
            ids=ids, dists=dists, stats=stats,
            batch_stats=self.last_batch_stats,
        )
