"""WebANNS engine on PyTorch: public API + the phased-lazy query drivers
(the port of ``repro.core.engine``).

The split is the paper's (§3.2, Fig. 5): the search phases run on the
device (:mod:`repro_torch.core.search`, through the hand-written
kernels), while fetches from tier 3 are host calls made by this driver
between phases. Two drivers serve a batch (DESIGN.md §5):

- ``batch_mode="loop"`` runs the single-query driver once per query;
- ``batch_mode="batched"`` advances all B queries one phase at a time
  against one tier-2 snapshot, unions and deduplicates their miss lists,
  and satisfies them with ONE tier-3 access per phase for the batch.

With ``fused=True`` (``webanns`` mode only) a single query runs the
fused driver (:func:`repro_torch.core.search.lazy_knn_search_fused`):
the tier-3 payload sits on the device at the session's precision and
the load phases read it there; the tier-3 cost model is applied
analytically. A batched request on a fused engine runs it once a query.

Engine modes (paper §4.2 baselines): ``webanns`` (phased lazy loading)
and ``webanns-base`` (eager: every expansion's misses fetched at once).

``precision`` sets the tier-2 slab (float32, float16, int8 with a
per-row scale, DESIGN.md §7, or ``"pq"``: M uint8 product-quantization
codes a row, DESIGN.md §12). A quantized search is followed by the
exact rerank: the top ``k·rerank_alpha`` of the beam are re-fetched from
tier 3 in ONE counted access (one a batch) and re-scored on the host in
numpy, as the reference does. A pq session adopts the codebook its
storage backend carries (a ``codebook`` attribute) or trains one at
construction, and freezes it; a search builds its queries' ADC lookup
tables once and the hops read the code slab through the ADC kernel.

The session API (DESIGN.md §6): ``WebANNSEngine.open(path)`` reopens a
saved :class:`~repro_torch.core.index.Index` (one bulk load of the graph,
the vector payload left on disk behind a ``ShardedFileBackend`` and read
lazily as tier 3); ``engine.save(path)`` persists the artifact in the
reference's format, so either package opens what the other saved. An
artifact's tombstones (DESIGN.md §8) are honoured on open: every driver
pre-marks them visited, so a deleted id is never seeded, expanded,
fetched or returned, and the entry point moves to a live node.

Searches are filterable (DESIGN.md §9): ``SearchRequest.filter`` takes
a :class:`~repro_torch.core.metadata.Filter` (or one per query of a
batch), compiled on the host against the engine's metadata into a deny
mask that is route-but-don't-return: a denied id still routes the
search and is dropped only at extraction (``search.finalize_topk``,
through ``ops.merge_topk``) and from a rerank pool, so a filter changes
which ids return, never the tier-3 accesses at a given ef. The layer-0
beam widens with the filter's live selectivity
(``EngineConfig.filter_ef_cap``), snapped to ``EF_SNAP_GRAIN``.

The index is mutable (DESIGN.md §8): ``add`` grows it by incremental
HNSW insertion on the host (the offline build's level stream
continued, so the grown graph equals a fresh build's), ``delete``
tombstones rows (evicted from tier 2 in place) and ``upsert`` composes
the two under fresh ids; each returns a :class:`MutationResult`. After
an ``add`` the graph, the id→slot map and the fused payload are new
tensors, so step graphs captured over the old ones are never replayed.
Texts live apart from the vectors (paper §4.1, :class:`DocStore`).

The engine runs on the card unless ``EngineConfig.device`` says
``"cpu"``; without CUDA the default raises. The sharded driver
(``n_shards > 1``) comes with a later slice of the port and raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import uuid as uuid_mod
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import pq, quant
from repro_torch.core import search as S
from repro_torch.core.graph import HNSWGraph, random_levels
from repro_torch.core.hnsw import build_hnsw, insert_hnsw
from repro_torch.core.index import Index
from repro_torch.core.metadata import Filter, MetadataStore
from repro_torch.core.storage import StorageBackend
from repro_torch.core.store import (
    EVICT_LRU,
    AccessStats,
    ExternalStore,
    TieredStore,
    cache_touch,
)
from repro_torch.device import resolve_device, synchronize

# a filter's boosted ef is snapped up to this grain, as the reference
# does (its phases are compiled per beam width): a bounded set of widths
# keeps the number of captured step graphs bounded too
EF_SNAP_GRAIN = 8


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md queue A, '{item}'"
    )


def _np_point_distance(
    X: np.ndarray, q: np.ndarray, metric: str
) -> np.ndarray:
    """Host-side exact distances for the rerank pass (a copy of the
    reference's numpy, so reranked distances equal its bits)."""
    X = np.asarray(X, np.float32)
    q = np.asarray(q, np.float32)
    if metric == "l2":
        diff = X - q[None, :]
        return np.sum(diff * diff, axis=-1)
    if metric == "ip":
        return -(X @ q)
    if metric == "cos":
        xn = np.linalg.norm(X, axis=-1) + 1e-30
        qn = np.linalg.norm(q) + 1e-30
        return -(X @ q) / (xn * qn)
    raise ValueError(metric)


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
    # fused=True runs single queries with the tier-3 payload on the device
    # (webanns mode only)
    fused: bool = False
    # tier-2 slab precision: 'float32' | 'float16' | 'int8' | 'pq'
    # (aliases through quant.canonical_precision). Quantized modes rerank
    # the top k·rerank_alpha exactly against tier 3; rerank_alpha <= 0
    # disables the rerank (quantized distances returned as they are)
    precision: str = "float32"
    rerank_alpha: float = 2.0
    # PQ geometry (precision='pq' only): M subspaces, M code bytes a row;
    # must divide the vector dimension. An adopted codebook's M wins.
    pq_subspaces: int = 8
    # selectivity-adaptive ef boost of a filtered search (DESIGN.md §9):
    # with a filter of live selectivity s the layer-0 beam widens to
    # ef * min(filter_ef_cap, sqrt(1/s)); 1.0 disables the boost
    filter_ef_cap: float = 4.0
    # not in this slice: must keep its default
    n_shards: int = 1

    def __post_init__(self) -> None:
        if self.mode not in ENGINE_MODES:
            raise ValueError(
                f"unknown engine mode {self.mode!r}: expected one of "
                f"{ENGINE_MODES}"
            )
        self.precision = quant.canonical_precision(self.precision)
        if self.precision == "pq":
            if self.pq_subspaces < 1:
                raise ValueError(
                    f"pq_subspaces must be >= 1, got {self.pq_subspaces}")
            if self.n_shards > 1:
                raise ValueError(
                    "precision='pq' is served by the loop/batched/fused "
                    "drivers; the sharded driver (n_shards > 1) carries no "
                    "PQ code slabs, as in the reference"
                )
        if self.n_shards != 1:
            raise _not_in_slice(f"n_shards={self.n_shards}",
                                "Engine sharded driver")


@dataclasses.dataclass
class SearchRequest:
    """One search call: a single ``(d,)`` query or a ``(B, d)`` batch.
    ``ef=None`` falls back to ``EngineConfig.ef_search``; ``batch_mode``
    ('batched' | 'loop') applies to batches only. ``filter`` restricts
    the results to metadata-matching ids (DESIGN.md §9): one
    :class:`Filter`, applied to every query, or for a batch a length-B
    sequence of ``Optional[Filter]``."""

    query: np.ndarray
    k: int = 10
    ef: Optional[int] = None
    batch_mode: str = "batched"
    filter: Optional[Union[Filter, Sequence[Optional[Filter]]]] = None


@dataclasses.dataclass
class MutationResult:
    """Result of ``add`` / ``delete`` / ``upsert`` (DESIGN.md §8). Ids
    are assigned monotonically and never reused: a deleted id stays
    tombstoned, an upsert's replacements come back under fresh ids.
    ``n_total`` is the size of the id space, ``n_live`` the rows a
    search can still return."""

    ids: np.ndarray  # ids given to the added rows ((k,) int64)
    deleted: np.ndarray  # ids this call newly tombstoned
    n_live: int
    n_total: int


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

    ``source`` is a raw ``(N, d)`` float32 array, any
    :class:`StorageBackend` (the mmap'd shards of a saved index among
    them), or an :class:`Index` (then ``graph`` is omitted: the index
    brings it, with its tombstones, lineage and metadata); tier 3 stays
    on the host, tier 2 and the graph live on ``config.device``.
    """

    def __init__(
        self,
        source: Union[np.ndarray, StorageBackend, Index],
        graph: Optional[HNSWGraph] = None,
        config: Optional[EngineConfig] = None,
        texts: Optional[List[str]] = None,
        metadata: Optional[Union[MetadataStore, Dict]] = None,
    ):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        tombstones = None
        level_state = None
        insert_params = None
        codebook = None
        self._uuid: Optional[str] = None
        self._last_save_path: Optional[str] = None
        if isinstance(source, Index):
            if graph is not None:
                raise ValueError(
                    "pass either an Index or (vectors, graph), not both"
                )
            graph = source.graph
            tombstones = source.tombstones
            level_state = source.level_state
            insert_params = source.insert_params
            codebook = source.codebook
            if metadata is None:
                metadata = source.metadata
            self._uuid = source.uuid
            self._last_save_path = (
                os.path.realpath(source.path)
                if source.path is not None else None
            )
            source = source.backend
        if graph is None:
            raise ValueError("an HNSWGraph is required (or pass an Index)")
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
        # PQ codebook lifecycle (DESIGN.md §12): adopt the index's or the
        # storage backend's frozen codebook, else train one here (seed
        # 0); frozen thereafter. An adopted codebook's M overrides the
        # config's.
        self.pq_codebook: Optional[pq.PQCodebook] = None
        if self.config.precision == "pq":
            cb = codebook
            if cb is None:
                cb = getattr(self.external.base_backend, "codebook", None)
            if cb is None:
                cb = pq.train_pq(
                    self.external.base_backend.fetch(np.arange(self.n)),
                    n_subspaces=self.config.pq_subspaces, seed=0,
                    device=self.device,
                )
            cb = pq.PQCodebook(np.asarray(
                getattr(cb, "centroids", cb), np.float32))
            self.pq_codebook = cb
            if cb.n_subspaces != self.config.pq_subspaces:
                self.config = dataclasses.replace(
                    self.config, pq_subspaces=cb.n_subspaces)
        cap = self.config.cache_capacity or self.n
        self.store = TieredStore(
            self.external, cap, self.config.eviction, device=self.device,
            precision=self.config.precision, codebook=self.pq_codebook,
        )
        self.neighbors = torch.as_tensor(
            np.asarray(graph.neighbors, np.int32), device=self.device
        )
        self.last_batch_stats: Optional[BatchStats] = None
        # the fused driver's device-resident tier-3 payload and its int8
        # scales, made at its first query
        self._payload: Optional[Tuple[torch.Tensor,
                                      Optional[torch.Tensor]]] = None
        # texts live apart from the vectors and are never read by a
        # search (paper §4.1)
        self.doc_store = DocStore(texts) if texts is not None else None
        # per-id metadata columns (host-resident, DESIGN.md §9), carried
        # with the artifact and read only when a filter compiles
        if metadata is not None and not isinstance(metadata, MetadataStore):
            metadata = MetadataStore(metadata, n_rows=self.n)
        self.metadata: Optional[MetadataStore] = metadata
        if self.metadata is not None and self.metadata.n_rows != self.n:
            raise ValueError(
                f"metadata covers {self.metadata.n_rows} ids, backend "
                f"holds {self.n}"
            )
        # ----- index lifecycle state (DESIGN.md §8) -----
        # tombstones: (N,) bool, deleted ids; every driver pre-marks them
        # visited, so none is seeded, expanded, fetched or returned
        self.tombstones = (
            np.array(tombstones, dtype=bool, copy=True)
            if tombstones is not None else np.zeros(self.n, dtype=bool)
        )
        if self.tombstones.shape != (self.n,):
            raise ValueError(
                f"tombstone mask covers {self.tombstones.shape[0]} ids, "
                f"backend holds {self.n}"
            )
        # the mask on the device, or None where nothing is tombstoned
        self._tombs_dev: Optional[torch.Tensor] = None
        self._upload_tombstones()
        # the HNSW level stream: (seed, draws) continue the offline
        # build's levels on insertion (exact for build() and an Index,
        # (0, n) for a bare graph, as in the reference)
        self._level_seed, self._levels_drawn = level_state or (0, self.n)
        self._uuid = self._uuid or uuid_mod.uuid4().hex
        # pre-existing graph rows whose links changed since the last save
        # (the rows a delta save rewrites); empty until insertion lands
        self._dirty_nodes: set = set()
        self.insert_ef_construction, self.insert_heuristic = (
            insert_params or (200, True)
        )
        if self.tombstones[self.graph.entry_point]:
            self._repair_entry()

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        M: int = 16,
        ef_construction: int = 200,
        config: Optional[EngineConfig] = None,
        texts: Optional[List[str]] = None,
        seed: int = 0,
        metadata: Optional[Union[MetadataStore, Dict]] = None,
    ) -> "WebANNSEngine":
        """Build the HNSW graph on the host, then open an engine on it."""
        config = config or EngineConfig()
        resolve_device(config.device)  # raise before the (long) build
        g = build_hnsw(
            vectors, M=M, ef_construction=ef_construction,
            metric=config.metric, seed=seed,
        )
        eng = cls(vectors, g, config, texts, metadata=metadata)
        # the exact level stream and insertion knobs, as the reference's
        # build records them (they persist in the manifest)
        eng._level_seed, eng._levels_drawn = seed, len(vectors)
        eng.insert_ef_construction = ef_construction
        return eng

    @classmethod
    def from_index(
        cls, index: Index, config: Optional[EngineConfig] = None,
        texts: Optional[List[str]] = None,
    ) -> "WebANNSEngine":
        """Session over an index artifact. The index's metric is
        authoritative: a differing ``config.metric`` is overridden."""
        config = config or EngineConfig(metric=index.metric)
        if config.metric != index.metric:
            config = dataclasses.replace(config, metric=index.metric)
        return cls(index, config=config, texts=texts)

    @classmethod
    def open(
        cls, path: str, config: Optional[EngineConfig] = None,
        texts: Optional[List[str]] = None, mmap: bool = True,
    ) -> "WebANNSEngine":
        """Reopen a saved index (either package's): the paper's
        initialization-stage bulk load, one access per shard, the graph
        materialized on ``config.device`` and the vector payload left on
        disk behind a ``ShardedFileBackend`` (``mmap=False`` stages the
        shards through host memory). No HNSW rebuild; a pq artifact's
        codebook is adopted, never retrained."""
        resolve_device(config.device if config is not None else None)
        return cls.from_index(Index.load(path, mmap=mmap), config, texts)

    def save(
        self,
        path: str,
        shard_bytes: int = 64 * 1024 * 1024,
        precision: Optional[str] = None,
    ) -> dict:
        """Persist this session's index (graph, vectors, tombstones,
        metadata) in the reference's format.

        When ``path`` is the directory this session was opened from (or
        last saved to), only what changed since is written (a delta
        save, DESIGN.md §8); any other target gets a full save. Returns
        ``{"mode", "bytes_written", "epoch"}``. ``precision=None``
        follows the session's precision: an int8 session writes int8
        shards, and a session reopened over them serves the dequantized
        payload as tier 3, so its exact rerank is exact with respect to
        that payload. Pass ``"float32"`` to keep tier 3 full precision.
        """
        idx = self.index
        # real paths: another spelling of the session's own directory
        # stays in its lineage
        if os.path.realpath(path) != self._last_save_path:
            idx.uuid = None  # a new lineage for a new target directory
        info = idx.save(path, shard_bytes=shard_bytes,
                        precision=precision or self.config.precision,
                        dirty_nodes=self._dirty_nodes)
        self._uuid = idx.uuid
        self._last_save_path = os.path.realpath(path)
        self._dirty_nodes = set()
        return info

    @property
    def index(self) -> Index:
        """The session's index artifact (graph, storage, tombstones)."""
        return Index(
            graph=self.graph,
            backend=self.external.base_backend,
            path=self._last_save_path,
            tombstones=self.tombstones,
            uuid=self._uuid,
            level_state=(self._level_seed, self._levels_drawn),
            insert_params=(
                self.insert_ef_construction, self.insert_heuristic
            ),
            metadata=self.metadata,
            codebook=self.pq_codebook,
        )

    @property
    def n_live(self) -> int:
        """Rows a search can still return (total minus tombstoned)."""
        return self.n - int(self.tombstones.sum())

    def _repair_entry(self) -> None:
        """Move the HNSW entry point to a live node (the highest-level
        one, as the offline build would pick)."""
        live = np.nonzero(~self.tombstones)[0]
        if live.size == 0:
            return  # empty engine: searches short-circuit to -1 results
        self.graph.entry_point = int(live[np.argmax(self.graph.levels[live])])

    def _upload_tombstones(self) -> None:
        """The tombstone mask on the device (None while nothing is
        tombstoned), made anew after every mutation: a delete sets bits,
        an add lengthens it."""
        self._tombs_dev = (
            torch.as_tensor(self.tombstones, device=self.device)
            if self.tombstones.any() else None
        )

    # ------------------------------------------------------ filtered search

    def _compile_filter(self, filt: Filter) -> Tuple[np.ndarray, float]:
        """One predicate to (deny mask, live selectivity), on the host:
        the allow-bitmap reads the metadata columns, never tier 3, so a
        filter costs no access. Selectivity is over the live ids: it
        drives the ef boost and the empty-result return."""
        if not isinstance(filt, Filter):
            raise TypeError(
                f"SearchRequest.filter must be a Filter (or a sequence "
                f"of them for a batch), got {type(filt).__name__}"
            )
        allow = np.asarray(filt.mask(self.metadata), bool)
        if allow.shape != (self.n,):
            raise ValueError(
                f"filter mask covers {allow.shape[0]} ids, index holds "
                f"{self.n}"
            )
        live_allowed = int((allow & ~self.tombstones).sum())
        sel = live_allowed / max(1, self.n_live)
        return ~allow, sel

    def _boost_ef(self, ef: int, sel: float) -> int:
        """Selectivity-adaptive beam width: ef * min(cap, sqrt(1/sel)),
        snapped up to ``EF_SNAP_GRAIN`` and at most the id space
        (DESIGN.md §9)."""
        if sel >= 1.0:
            return ef
        boost = min(self.config.filter_ef_cap,
                    math.sqrt(1.0 / max(sel, 1e-9)))
        eff = int(math.ceil(ef * max(1.0, boost)))
        eff += (-eff) % EF_SNAP_GRAIN  # snap up: a wider beam only helps
        return min(self.n, eff)

    def _normalize_filters(
        self, filt, B: int
    ) -> Optional[List[Optional[Filter]]]:
        """Request-level filter → per-query list (length B) or None."""
        if filt is None:
            return None
        if isinstance(filt, Filter):
            return [filt] * B
        filters = list(filt)
        if len(filters) != B:
            raise ValueError(
                f"{len(filters)} filters for a batch of {B} queries — "
                "pass one Filter (broadcast) or exactly one per query"
            )
        if all(f is None for f in filters):
            return None
        return filters

    # --------------------------------------------------- mutation lifecycle

    def _encode_payload(
        self, X: np.ndarray
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Rows as the fused driver's device payload holds them: pq codes
        of the frozen codebook, or the port's quantization at the
        session's precision (int8 with its scales). Both codecs work row
        by row, so rows encoded alone equal the same rows encoded in the
        whole table."""
        if self.pq_codebook is not None:
            codes = pq.encode_np(X, self.pq_codebook.centroids)
            return torch.as_tensor(codes, device=self.device), None
        payload, scales = quant.quantize_np(X, self.config.precision)
        return (torch.as_tensor(payload, device=self.device),
                torch.as_tensor(scales, device=self.device)
                if payload.dtype == np.int8 else None)

    def add(
        self,
        vectors: np.ndarray,
        texts: Optional[List[str]] = None,
        metadata: Optional[Dict] = None,
    ) -> MutationResult:
        """Insert vectors into the live index, no rebuild (DESIGN.md §8).

        Levels continue the offline build's RNG stream and the insertion
        is ``build_hnsw``'s own loop on the host, so a graph grown by
        ``add`` equals a fresh build over the concatenated corpus when no
        delete intervenes. New ids continue from ``n_total`` (deleted ids
        are never reused); tombstoned nodes are excluded from link
        selection; the changed rows are kept for a delta save. Then the
        per-id state grows: the tombstone mask, tier 2's id→slot map,
        the device graph, and a fused payload (the new rows encoded at
        the session's precision). ``metadata`` maps column → one value a
        new row, validated before anything is mutated."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if vectors.shape[0] == 0:
            return MutationResult(ids=np.empty(0, np.int64),
                                  deleted=np.empty(0, np.int64),
                                  n_live=self.n_live, n_total=self.n)
        if vectors.shape[1] != self.dim:
            raise ValueError(
                f"added vectors have dim {vectors.shape[1]}, index holds "
                f"dim {self.dim}"
            )
        if texts is not None and len(texts) != vectors.shape[0]:
            raise ValueError(
                f"{len(texts)} texts for {vectors.shape[0]} vectors"
            )
        if metadata is not None and self.metadata is None:
            self.metadata = MetadataStore(n_rows=self.n)
        if self.metadata is not None:
            # a bad metadata dict must fail before anything is committed
            self.metadata.validate_extend(vectors.shape[0], metadata)
        n_new = vectors.shape[0]
        restart = self.n_live == 0  # dead graph: re-seed the entry point
        new_ids = self.external.append(vectors)
        # continue the build-time level stream: PCG64.advance lands where
        # drawing (and dropping) the earlier draws would
        bitgen = np.random.PCG64(self._level_seed)
        if self._levels_drawn:
            bitgen.advance(self._levels_drawn)
        levels_new = random_levels(n_new, self.graph.M,
                                   np.random.Generator(bitgen))
        self._levels_drawn += n_new
        exclude = None
        if self.tombstones.any():
            exclude = np.concatenate(
                [self.tombstones, np.zeros(n_new, dtype=bool)])
        self.graph, dirty = insert_hnsw(
            self.graph, self.external.vectors, new_ids, levels_new,
            ef_construction=self.insert_ef_construction,
            heuristic=self.insert_heuristic, exclude=exclude,
            restart_entry=restart,
        )
        self._dirty_nodes |= dirty
        self.tombstones = np.concatenate(
            [self.tombstones, np.zeros(n_new, dtype=bool)])
        self.n = self.external.n_items
        self.neighbors = torch.as_tensor(
            np.asarray(self.graph.neighbors, np.int32), device=self.device)
        self.store.grow(self.n)
        if self._payload is not None:
            rows, scales = self._encode_payload(vectors)
            old_rows, old_scales = self._payload
            self._payload = (
                torch.cat([old_rows, rows]),
                None if scales is None else torch.cat([old_scales, scales]),
            )
        if texts is not None and self.doc_store is None:
            self.doc_store = DocStore([None] * (self.n - n_new))
        if self.doc_store is not None:
            self.doc_store.extend(
                texts if texts is not None else [None] * n_new)
        if self.metadata is not None:
            self.metadata.extend(n_new, metadata)  # validated above
        self._upload_tombstones()
        if self.tombstones[self.graph.entry_point]:
            self._repair_entry()
        return MutationResult(
            ids=new_ids, deleted=np.empty(0, np.int64),
            n_live=self.n_live, n_total=self.n,
        )

    def delete(self, ids: Union[int, Sequence[int]]) -> MutationResult:
        """Tombstone ``ids``: they leave tier 2 at once (in place) and
        every driver's search (pre-visited: never seeded, expanded,
        fetched or returned). The graph keeps its links and the rows
        their payload (ids are never reused). Deleting a tombstoned id
        is a no-op."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise ValueError(
                f"delete ids out of range [0, {self.n}): "
                f"{ids[(ids < 0) | (ids >= self.n)][:4]}…"
            )
        fresh = np.unique(ids[~self.tombstones[ids]])
        self.tombstones[fresh] = True
        if fresh.size:
            self.store.invalidate(fresh)
            self._upload_tombstones()
            if self.tombstones[self.graph.entry_point]:
                self._repair_entry()
        return MutationResult(
            ids=np.empty(0, np.int64), deleted=fresh,
            n_live=self.n_live, n_total=self.n,
        )

    def upsert(
        self,
        ids: Union[int, Sequence[int]],
        vectors: np.ndarray,
        texts: Optional[List[str]] = None,
        metadata: Optional[Dict] = None,
    ) -> MutationResult:
        """Replace rows: tombstone ``ids`` and add ``vectors`` under fresh
        ids (``result.ids``, aligned with ``vectors``; ``result.deleted``
        the retired ones). Everything ``add`` would reject is checked
        before the delete; with no ``metadata`` the replacements inherit
        the retired rows'."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if len(ids) != vectors.shape[0]:
            raise ValueError(
                f"upsert replaces {len(ids)} ids with "
                f"{vectors.shape[0]} vectors — counts must match"
            )
        if vectors.shape[1] != self.dim:
            raise ValueError(
                f"upserted vectors have dim {vectors.shape[1]}, index "
                f"holds dim {self.dim}"
            )
        if texts is not None and len(texts) != vectors.shape[0]:
            raise ValueError(
                f"{len(texts)} texts for {vectors.shape[0]} vectors"
            )
        if metadata is None and self.metadata is not None:
            metadata = {
                name: col[ids]
                for name, col in self.metadata.to_columns().items()
            }
        if metadata is not None:
            (self.metadata or MetadataStore(n_rows=self.n)) \
                .validate_extend(vectors.shape[0], metadata)
        deleted = self.delete(ids).deleted
        added = self.add(vectors, texts=texts, metadata=metadata)
        return MutationResult(
            ids=added.ids, deleted=deleted,
            n_live=self.n_live, n_total=self.n,
        )

    def get_texts(self, ids: np.ndarray) -> List[Optional[str]]:
        """Texts for ``ids``; None for unknown, padded (-1) and
        tombstoned ids (deleted content never comes back by id)."""
        if self.doc_store is None:
            return [None] * len(ids)
        return self.doc_store.get(ids, tombstones=self.tombstones)

    # ------------------------------------------------------------ sizing

    def resize_cache(self, capacity: int, warm: bool = False) -> None:
        """Re-initialize tier 2 at ``capacity`` items; ``warm=True``
        re-populates it at once (uncounted init-stage load)."""
        self.store.resize(int(capacity))
        if warm:
            self.warm_cache()

    def resize_cache_bytes(self, budget_bytes: int, warm: bool = False) -> int:
        """Resize tier 2 to the largest capacity fitting ``budget_bytes``
        at the session's precision (DESIGN.md §7). Returns the item
        capacity applied."""
        cap = quant.capacity_for_budget(
            int(budget_bytes), self.dim, self.config.precision,
            n_subspaces=(self.pq_codebook.n_subspaces
                         if self.pq_codebook is not None else None))
        cap = min(cap, self.n)
        self.resize_cache(cap, warm=warm)
        return cap

    @property
    def access_stats(self) -> AccessStats:
        """The live tier-3 counters."""
        return self.external.stats

    def warm_cache(self, ids: Optional[np.ndarray] = None) -> None:
        if ids is None:
            ids = np.arange(min(self.store.capacity, self.n))
        ids = np.asarray(ids)
        ids = ids[~self.tombstones[ids]]  # never stage tombstoned rows
        if len(ids):
            self.store.warm(ids)

    def cache_bytes(self) -> int:
        """Resident tier-2 bytes at the configured precision."""
        return self.store.cache_bytes()

    # -------------------------------------------------------- exact rerank

    def _rerank_active(self) -> bool:
        cfg = self.config
        return cfg.precision != "float32" and cfg.rerank_alpha > 0

    def _rerank_exact(
        self, q: np.ndarray, ids: np.ndarray, dists: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact rerank (DESIGN.md §7): re-fetch the candidate pool from
        tier 3 in ONE counted access, bypassing the quantized cache, and
        re-score it exactly; a stable sort keeps ties in pool order."""
        ids = np.asarray(ids)
        dists = np.asarray(dists)
        valid = ids >= 0
        if not valid.any():
            return ids[:k], dists[:k]
        fetched = self.external.fetch(ids[valid])
        self.external.mark_used_ids(ids[valid])
        exact = np.full(ids.shape, np.inf, np.float32)
        exact[valid] = _np_point_distance(fetched, q, self.config.metric)
        order = np.argsort(exact, kind="stable")
        return ids[order][:k], exact[order][:k]

    def _rerank_exact_batch(
        self, Q: np.ndarray, ids: np.ndarray, dists: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched exact rerank: the B pools are unioned and deduplicated
        so the whole batch pays ONE tier-3 access (DESIGN.md §5)."""
        ids = np.asarray(ids)
        dists = np.asarray(dists)
        B, m = ids.shape
        valid = ids >= 0
        if not valid.any():
            return ids[:, :k], dists[:, :k]
        union = np.unique(ids[valid])  # sorted — searchsorted below
        fetched = self.external.fetch(union)
        self.external.mark_used_ids(union)
        exact = np.full((B, m), np.inf, np.float32)
        # rows/qidx are in ids[valid]'s row-major order, so per-row
        # distances scatter back through one flat buffer
        rows = fetched[np.searchsorted(union, ids[valid])]
        qidx = np.broadcast_to(np.arange(B)[:, None], (B, m))[valid]
        flat = np.empty(rows.shape[0], np.float32)
        for b in range(B):
            sel = qidx == b
            if sel.any():
                flat[sel] = _np_point_distance(
                    rows[sel], Q[b], self.config.metric
                )
        exact[valid] = flat
        order = np.argsort(exact, axis=1, kind="stable")
        return (np.take_along_axis(ids, order, 1)[:, :k],
                np.take_along_axis(exact, order, 1)[:, :k])

    # ------------------------------------------------------------- query

    def _clock(self) -> float:
        """Host time after the queued device work has finished."""
        synchronize(self.device)
        return time.perf_counter()

    def _luts(self, Q: torch.Tensor) -> Optional[torch.Tensor]:
        """The (B, L, M, 256) ADC lookup tables of a pq search's (B, d)
        queries, built once a search; None at the other precisions."""
        if self.pq_codebook is None:
            return None
        return pq.build_lut(Q, self.store.cache.codebook, self.config.metric)

    def _lazy_layer(
        self, q: torch.Tensor, layer: int, entry_ids: np.ndarray, ef: int,
        stats: QueryStats, eager: bool, luts: Optional[torch.Tensor] = None,
    ) -> S.SearchState:
        """Run one layer with phased lazy loading (or eager fetches);
        ``luts`` (1, L, M, 256) for a pq tier 2."""
        cfg = self.config
        miss_cap = ef + self.graph.max_degree + 1
        entry_np = np.full(max(len(entry_ids), 1), -1, np.int32)
        entry_np[: len(entry_ids)] = entry_ids
        state = S.make_state(ef, miss_cap, self.n, self.device,
                             self._tombs_dev)
        state = S.seed_state(
            state, q, torch.as_tensor(entry_np, device=self.device),
            S.cache_tier2(self.store.cache, luts), cfg.metric,
        )
        # eager mode (webanns-base): trigger=1 → flush L after every miss
        trigger = 1 if eager else ef
        slots = torch.arange(miss_cap, dtype=torch.int32, device=self.device)
        for _ in range(cfg.max_phases):
            t0 = self._clock()
            state = S.search_phase(
                q, self.neighbors[layer], state,
                S.cache_tier2(self.store.cache, luts), cfg.metric, trigger,
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
        luts: Optional[torch.Tensor] = None,
    ) -> S.SearchState:
        """One layer of the batched phased-lazy driver (DESIGN.md §5);
        ``luts`` (B, L, M, 256) for a pq tier 2."""
        cfg = self.config
        miss_cap = ef + self.graph.max_degree + 1
        trigger = 1 if eager else ef
        t0 = self._clock()
        states = S.batch_make_state(
            Q.shape[0], ef, miss_cap, self.n, self.device, self._tombs_dev
        )
        states = S.batch_seed_state(
            states, Q, torch.as_tensor(entry_ids, device=self.device),
            S.cache_tier2(self.store.cache, luts), cfg.metric,
        )
        bstats.t_in_mem += self._clock() - t0
        for _ in range(cfg.max_phases):
            t0 = self._clock()
            states = S.batch_search_phase(
                Q, self.neighbors[layer], states,
                S.cache_tier2(self.store.cache, luts), cfg.metric, trigger,
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

    def _fused_payload(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The tier-3 payload on the device at the session's precision
        (quantized by the port's own codec; int8 with its scales; at pq
        the (N, M) uint8 codes alone, whose codebook is tier 2's), read
        from the storage medium once, uncounted, as an init-stage load;
        ``add`` appends the new rows' encoding."""
        if self._payload is None:
            self._payload = self._encode_payload(
                self.external.base_backend.fetch(np.arange(self.n)))
        return self._payload

    def _query_fused(
        self, q: np.ndarray, k: int, ef: int,
        banned: Optional[torch.Tensor] = None,
    ) -> Tuple[np.ndarray, np.ndarray, QueryStats]:
        """Fused driver body: the whole query on the device-resident
        payload, the tier-3 cost model applied analytically, then the
        exact rerank of a quantized session from tier 3 on the host.
        ``banned`` ((N,) bool) drops denied ids at the extraction, so the
        rerank pool holds allowed ids only."""
        cfg = self.config
        stats = QueryStats()
        payload, scales = self._fused_payload()
        # quantized modes: run the search for the rerank POOL so the
        # host-side exact pass has k·α candidates to re-score
        k_run = k
        if self._rerank_active():
            k_run = min(max(ef, k), quant.rerank_pool(k, cfg.rerank_alpha))
        t0 = self._clock()
        dists, ids, (n_db, n_fetch), cache = S.lazy_knn_search_fused(
            torch.as_tensor(np.asarray(q, np.float32), device=self.device),
            payload, scales, self.neighbors, self.graph.entry_point,
            self.store.cache, k=k_run, ef=ef, metric=cfg.metric,
            eviction=self.store.eviction, tombstones=self._tombs_dev,
            banned=banned,
        )
        # the search's only reads on the host: its result and counters
        n_db, n_fetch = (int(c) for c in torch.stack([n_db, n_fetch]).cpu())
        ids_np, dists_np = ids.cpu().numpy(), dists.cpu().numpy()
        stats.t_in_mem = time.perf_counter() - t0
        self.store.cache = cache
        stats.n_db = n_db
        stats.items_fetched = n_fetch
        stats.t_db = n_db * cfg.t_setup + n_fetch * cfg.t_per_item
        ext = self.external.stats
        ext.n_db += n_db
        ext.items_fetched += n_fetch
        ext.items_used += n_fetch  # lazy loading fetches only demanded ids
        ext.modeled_time += stats.t_db
        stats.n_visited = n_fetch  # a lower bound: hits are not counted
        if self._rerank_active():
            db0, f0, m0 = ext.n_db, ext.items_fetched, ext.modeled_time
            ids_np, dists_np = self._rerank_exact(q, ids_np, dists_np, k)
            stats.n_db += ext.n_db - db0
            stats.items_fetched += ext.items_fetched - f0
            stats.t_db += ext.modeled_time - m0
        return ids_np, dists_np, stats

    def _search_one(
        self, q: np.ndarray, k: int, ef: Optional[int],
        filt: Optional[Filter] = None, boost: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, QueryStats]:
        """Single-query driver body. Returns (ids, dists, stats).

        ``filt`` is route-but-don't-return (DESIGN.md §9): the search is
        the unfiltered one at the same effective ef, and denied ids are
        dropped only at extraction and from the rerank pool. The
        effective ef widens with the filter's live selectivity
        (``_boost_ef``) unless the caller already widened it
        (``boost=False``, the loop driver's shared batch ef)."""
        cfg = self.config
        ef = ef or cfg.ef_search
        empty = (np.full(k, -1, np.int32), np.full(k, np.inf, np.float32),
                 QueryStats())
        if self.n_live == 0:  # fully-tombstoned index: nothing to return
            return empty
        banned = None
        if filt is not None:
            banned_np, sel = self._compile_filter(filt)
            if sel <= 0.0:  # nothing can match: no search
                return empty
            if boost:
                ef = self._boost_ef(ef, sel)
            banned = torch.as_tensor(banned_np, device=self.device)
        if cfg.fused and cfg.mode == "webanns":
            return self._query_fused(q, k, ef, banned)
        eager = cfg.mode == "webanns-base"
        stats = QueryStats()
        qt = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        t_db0 = self.external.stats.modeled_time
        luts = self._luts(qt[None])
        entry = np.array([self.graph.entry_point], np.int32)
        # upper layers: beam of ef_upper (greedy for 1), lazily loaded too
        for lc in range(self.graph.max_level, 0, -1):
            st = self._lazy_layer(qt, lc, entry, cfg.ef_upper, stats, eager,
                                  luts)
            best = st.beam.ids[: cfg.ef_upper].cpu().numpy()
            entry = best[best >= 0][:1] if (best >= 0).any() else entry
            stats.n_hops += int(st.n_hops)
            stats.n_dist += int(st.n_dist)
        st = self._lazy_layer(qt, 0, entry, max(ef, k), stats, eager, luts)
        stats.n_hops += int(st.n_hops)
        stats.n_dist += int(st.n_dist)
        stats.n_visited = stats.n_dist  # every visited id gets a distance
        if self._rerank_active():
            pool = min(st.beam.ef, quant.rerank_pool(k, cfg.rerank_alpha))
            # a filtered pool holds allowed ids only: a denied id never
            # reaches the rerank fetch
            p_dists, p_ids = self._extract(st, pool, banned)
            db0 = self.external.stats.n_db
            f0 = self.external.stats.items_fetched
            ids, dists = self._rerank_exact(
                q, p_ids.cpu().numpy(), p_dists.cpu().numpy(), k,
            )
            stats.n_db += self.external.stats.n_db - db0
            stats.items_fetched += self.external.stats.items_fetched - f0
        else:
            dists, ids = (t.cpu().numpy()
                          for t in self._extract(st, k, banned))
        stats.t_db = self.external.stats.modeled_time - t_db0
        return ids, dists, stats

    @staticmethod
    def _extract(st: S.SearchState, k: int,
                 banned: Optional[torch.Tensor]):
        """The first k of a layer-0 beam as (dists, ids); with a deny
        mask the top k of its allowed entries (``finalize_topk``)."""
        if banned is None:
            return st.beam.dists[..., :k], st.beam.ids[..., :k]
        return S.finalize_topk(st, k, banned)

    def _search_many(
        self, Q: np.ndarray, k: int, ef: Optional[int], batch_mode: str,
        filt=None,
    ) -> Tuple[np.ndarray, np.ndarray, List[QueryStats]]:
        """Batch driver body (DESIGN.md §5). Both modes return identical
        (ids, dists); per-query ``QueryStats.n_db`` records each query's
        demand, ``self.last_batch_stats`` the batch's actual accesses.

        Filters compile to one (N,) deny mask (a broadcast ``Filter``) or
        a (B, N) matrix (one per query). The batch shares one effective
        ef, the widest boost of its filters, in both modes, so the loop
        and the batched drivers stay equal (DESIGN.md §9)."""
        cfg = self.config
        ef = ef or cfg.ef_search
        Q = np.asarray(Q, dtype=np.float32)
        B = len(Q)
        if self.n_live == 0:  # fully-tombstoned index: nothing to return
            self.last_batch_stats = BatchStats(batch_size=B)
            return (np.full((B, k), -1, np.int32),
                    np.full((B, k), np.inf, np.float32),
                    [QueryStats() for _ in range(B)])
        filters = self._normalize_filters(filt, B)
        banned_rows: Optional[List[Optional[np.ndarray]]] = None
        shared_banned: Optional[np.ndarray] = None
        if filters is not None:
            if isinstance(filt, Filter):  # broadcast: compiled once
                shared_banned, sel = self._compile_filter(filt)
                banned_rows = [shared_banned] * B
                if sel > 0.0:
                    ef = max(ef, self._boost_ef(ef, sel))
            else:
                banned_rows = []
                ef_eff = ef
                for f in filters:
                    if f is None:
                        banned_rows.append(None)
                        continue
                    banned_np, sel = self._compile_filter(f)
                    banned_rows.append(banned_np)
                    if sel > 0.0:
                        ef_eff = max(ef_eff, self._boost_ef(ef, sel))
                ef = ef_eff
        # a fused engine runs its batch once a query (there is no fused
        # batch driver), as the reference does
        if cfg.fused and cfg.mode == "webanns" and batch_mode == "batched":
            batch_mode = "loop"
        if batch_mode == "loop":
            out_i, out_d, out_s = [], [], []
            for b, q in enumerate(Q):
                i, d, s = self._search_one(
                    q, k, ef, filt=None if filters is None else filters[b],
                    boost=False)
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
        banned = None
        if shared_banned is not None:
            banned = torch.as_tensor(shared_banned, device=self.device)
        elif banned_rows is not None:
            banned_np = np.zeros((B, self.n), bool)
            for b, row in enumerate(banned_rows):
                if row is not None:
                    banned_np[b] = row
            banned = torch.as_tensor(banned_np, device=self.device)
        t_db0 = self.external.stats.modeled_time
        luts = self._luts(Qt)
        entry = np.full((B, 1), self.graph.entry_point, np.int32)
        for lc in range(self.graph.max_level, 0, -1):
            st = self._batched_lazy_layer(
                Qt, lc, entry, cfg.ef_upper, per_stats, bstats, eager, luts
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
            Qt, 0, entry, max(ef, k), per_stats, bstats, eager, luts
        )
        hops = st.n_hops.cpu().numpy()
        ndist = st.n_dist.cpu().numpy()
        if self._rerank_active():
            # ONE shared tier-3 access reranks the whole batch; filtered
            # pools hold allowed ids only
            pool = min(st.beam.ef, quant.rerank_pool(k, cfg.rerank_alpha))
            p_dists, p_ids = self._extract(st, pool, banned)
            db0 = self.external.stats.n_db
            f0 = self.external.stats.items_fetched
            ids, dists = self._rerank_exact_batch(
                Q, p_ids.cpu().numpy(), p_dists.cpu().numpy(), k,
            )
            bstats.n_db += self.external.stats.n_db - db0
            bstats.items_fetched += self.external.stats.items_fetched - f0
            for b in range(B):  # every query demanded the shared rerank
                per_stats[b].n_db += 1
        else:
            dists, ids = (t.cpu().numpy()
                          for t in self._extract(st, k, banned))
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
        q = np.asarray(request.query, dtype=np.float32)
        if q.ndim == 1:
            filt = request.filter
            if filt is not None and not isinstance(filt, Filter):
                raise ValueError(
                    "a single-query request takes a single Filter, not "
                    f"{type(filt).__name__}"
                )
            ids, dists, stats = self._search_one(q, request.k, request.ef,
                                                 filt=filt)
            return SearchResult(ids=ids, dists=dists, stats=stats)
        if q.ndim != 2:
            raise ValueError(
                f"SearchRequest.query must be (d,) or (B, d), got {q.shape}"
            )
        ids, dists, stats = self._search_many(
            q, request.k, request.ef, request.batch_mode,
            filt=request.filter,
        )
        return SearchResult(
            ids=ids, dists=dists, stats=stats,
            batch_stats=self.last_batch_stats,
        )


class DocStore:
    """Id → text store, kept apart from the embeddings (paper §4.1)."""

    def __init__(self, texts: List[Optional[str]]):
        self._texts = list(texts)

    def extend(self, texts: List[Optional[str]]) -> None:
        """Append texts for newly added ids (DESIGN.md §8)."""
        self._texts.extend(texts)

    def get(self, ids, tombstones=None) -> List[Optional[str]]:
        """Texts by id; out-of-range ids come back None, and so do the
        ids that ``tombstones`` ((N,) bool) marks deleted."""
        out = []
        for i in np.asarray(ids).tolist():
            i = int(i)
            dead = (tombstones is not None and 0 <= i < len(tombstones)
                    and bool(tombstones[i]))
            out.append(self._texts[i]
                       if 0 <= i < len(self._texts) and not dead else None)
        return out
