"""Three-tier data management (paper §3.2) on the port's device.

Tier 2 is :class:`CacheState`: a fixed-capacity slab on the engine's
device plus an id→slot map, with FIFO (the paper's prototype) or LRU
eviction. The slab holds float32, float16 or int8 rows with one float32
scale each (the ``precision`` knob, DESIGN.md §7): inserts quantize
through :mod:`repro_torch.core.quant`, lookups dequantize. At ``"pq"``
(DESIGN.md §12) the slab holds M uint8 codes a row and the state
carries the frozen codebook: inserts encode through
:func:`repro_torch.core.pq.encode`, lookups decode. The lazy search
computes tier-2 distances straight from the slab — :func:`cache_slots`
maps ids to slots and the fused (dequant- or ADC-) gather-distance
kernel reads the rows there — so a cached row never leaves the slab
during a search.

Tier 3 is :class:`ExternalStore`: exact access counters and the cost
model ``t_access = t_setup + n_items * t_per_item`` (paper Fig. 3b) over
a host-side :class:`~repro_torch.core.storage.StorageBackend`: a
NumPy array, or the mmap'd shards of a saved index
(``ShardedFileBackend``), which a reopened engine reads lazily.
:class:`TieredStore` composes the two: one tier-3 access per bulk load.

Differences from the JAX reference (``repro.core.store``), all
behaviour-preserving:

- the cache ops update the state's tensors in place, the clock too, and
  return the same object (the slab is the largest tensor of the query
  path; the reference's functional updates would copy it on every
  insert, and a CUDA graph that captured an insert replays it on the
  same tensors);
- id batches are not padded to power-of-two buckets (those exist for
  jit shape reuse); the access counters are unchanged by this;
- :meth:`TieredStore.gather` returns device rows, and
  :meth:`TieredStore.gather_batch` returns the deduplicated union rows
  and per-query positions into them instead of a (B, k, d) copy.

The mutation lifecycle (DESIGN.md §8) adds :func:`cache_evict` (a
delete unmaps its ids, in place, so the tier-2 tensors and the step
graphs captured over them stay valid), :func:`cache_grow` (an ``add``
lengthens the id→slot map: a new tensor, so captures over the old one
are dropped) and :meth:`ExternalStore.append` (rows appended behind a
``DeltaBackend``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import pq, quant
from repro_torch.core.storage import (
    DeltaBackend,
    InMemoryBackend,
    LatencyModel,
    StorageBackend,
    unwrap_backend,
)
from repro_torch.device import DeviceLike, resolve_device

EVICT_FIFO = 0
EVICT_LRU = 1

_EVICTION_NAMES = {"fifo": EVICT_FIFO, "lru": EVICT_LRU}


@dataclasses.dataclass
class CacheState:
    """Tier-2 cache: slab + id→slot map, all on one device.

    ``slab`` holds the rows at the cache's precision (its dtype); an int8
    slab carries one float32 dequantization scale a row in ``scales``,
    the other precisions a (0,) tensor; a pq slab is (capacity, M) uint8
    codes and carries the (M, 256, dsub) ``codebook``, the others a
    (0, 0, 0) tensor — as the reference does."""

    slab: torch.Tensor  # (capacity, d) f32 / f16 / int8 — or (capacity, M) u8
    scales: torch.Tensor  # (capacity,) float32 if int8, else (0,)
    slot_of: torch.Tensor  # (N,) int32 — slot of id, -1 if absent
    id_of: torch.Tensor  # (capacity,) int32 — id in slot, -1 if empty
    clock: torch.Tensor  # () int64 — insertion cursor (FIFO) / tick (LRU)
    last_used: torch.Tensor  # (capacity,) int32 — LRU timestamps
    codebook: torch.Tensor  # (M, 256, dsub) float32 if pq, else (0, 0, 0)

    @property
    def capacity(self) -> int:
        return int(self.slab.shape[0])

    @property
    def precision(self) -> str:
        return quant.precision_of(self.slab.dtype)

    def nbytes(self) -> int:
        """Resident tier-2 payload bytes (slab + scales when int8). A pq
        row is its M code bytes: the shared codebook is not charged per
        row (``quant.bytes_per_vector``)."""
        cap, width = self.slab.shape  # a pq row's width is its M
        return int(cap) * quant.bytes_per_vector(
            int(width), self.precision, n_subspaces=int(width))

    def row_scales(self):
        """The scales a distance kernel takes: ``scales`` for int8, None
        for the float precisions."""
        return self.scales if self.slab.dtype == torch.int8 else None


def cache_init(
    n_items: int, capacity: int, dim: int, device: DeviceLike = None,
    precision: str = "float32", codebook: Optional[pq.PQCodebook] = None,
) -> CacheState:
    """An empty tier 2. A ``"pq"`` cache needs its trained
    :class:`~repro_torch.core.pq.PQCodebook` and raises ``ValueError``
    without one."""
    precision = quant.canonical_precision(precision)
    dev = resolve_device(device)
    if precision != "pq":
        cent = torch.zeros((0, 0, 0), dtype=torch.float32, device=dev)
        return _empty_cache(n_items, capacity, dim, precision, cent)
    if codebook is None:
        raise ValueError(
            "a pq cache needs its trained codebook — pass a PQCodebook "
            "(see repro_torch.core.pq.train_pq)"
        )
    if codebook.dim != int(dim):
        raise ValueError(
            f"codebook {codebook.centroids.shape} does not cover dim {dim}"
        )
    cent = torch.as_tensor(codebook.centroids, dtype=torch.float32,
                           device=dev)
    return _empty_cache(n_items, capacity, codebook.n_subspaces, precision,
                        cent)


def _empty_cache(n_items: int, capacity: int, width: int, precision: str,
                 codebook: torch.Tensor) -> CacheState:
    """An empty slab of ``width`` elements a row (M codes at pq) on the
    codebook tensor's device, carrying that tensor."""
    capacity = int(max(1, capacity))
    dev = codebook.device
    n_scales = capacity if precision == "int8" else 0
    return CacheState(
        slab=torch.zeros((capacity, width), dtype=quant.slab_dtype(precision),
                         device=dev),
        scales=torch.ones((n_scales,), dtype=torch.float32, device=dev),
        slot_of=torch.full((n_items,), -1, dtype=torch.int32, device=dev),
        id_of=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        clock=torch.zeros((), dtype=torch.int64, device=dev),
        last_used=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        codebook=codebook,
    )


def cache_slots(
    cache: CacheState, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership of any-shaped ``ids`` (-1 padded): ``(present, slot)``,
    with ``slot`` (int64) a valid slab row everywhere (garbage where
    absent). The id_of cross-check guards against stale mappings after a
    ring wrap."""
    safe_ids = ids.long().clamp(0, cache.slot_of.shape[0] - 1)
    slots = cache.slot_of[safe_ids]
    safe_slots = slots.long().clamp(0, cache.capacity - 1)
    present = (slots >= 0) & (ids >= 0) & (cache.id_of[safe_slots] == ids)
    return present, safe_slots


def cache_lookup(
    cache: CacheState, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership + gather: (present, float32 vectors (..., d) — garbage
    rows where absent). int8 rows are dequantized against their scale,
    float16 rows widened, pq codes decoded through the codebook."""
    present, slots = cache_slots(cache, ids)
    vecs = cache.slab[slots]
    if vecs.dtype == torch.int8:
        return present, quant.dequantize(vecs, cache.scales[slots])
    if vecs.dtype == torch.uint8:
        return present, pq.decode(vecs, cache.codebook)
    return present, vecs.to(torch.float32)


def cache_lookup_batch(
    cache: CacheState, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, k) form of :func:`cache_lookup` (the ops are elementwise)."""
    return cache_lookup(cache, ids)


def cache_touch(cache: CacheState, ids: torch.Tensor) -> CacheState:
    """LRU bookkeeping for a batch of accessed ids (no-op rows for -1).
    Bumps the clock once per call, as the reference does."""
    ids = ids.reshape(-1)
    safe_ids = ids.long().clamp(0, cache.slot_of.shape[0] - 1)
    slots = cache.slot_of[safe_ids].long()
    ok = (slots >= 0) & (ids >= 0)
    tick = cache.clock + 1
    cache.last_used.scatter_reduce_(
        0, torch.where(ok, slots, 0),
        torch.where(ok, tick, 0).to(torch.int32), reduce="amax",
    )
    cache.clock.copy_(tick)
    return cache


def _write_plan(idx: torch.Tensor, mask: torch.Tensor):
    """Rows of a masked write ``dst[idx[r]] = val[r]`` (rows ``r`` where
    ``mask`` holds) at a fixed shape and with no host sync: ``(src, tgt,
    some)``. Row ``r`` writes ``val[src[r]]`` to ``tgt[r]``: a masked row
    its own; every other row repeats the first masked row's write, or,
    where no row is masked (``some`` false), writes index 0's own value
    back. So rows that share an index always write the same value, and
    the order of a duplicate-index write, which CUDA leaves undefined,
    cannot matter."""
    # a (1,) index: a 0-dim tensor index would be read on the host
    first = torch.argmax(mask.to(torch.uint8), dim=0, keepdim=True)
    rows = torch.arange(mask.shape[0], device=mask.device)
    src = torch.where(mask, rows, first)
    some = mask[first]
    return src, torch.where(some, idx[src], 0), some


def _put(dst: torch.Tensor, plan, val: torch.Tensor) -> None:
    """Carry out a :func:`_write_plan` on ``dst`` in place."""
    src, tgt, some = plan
    keep = some.reshape(1, *([1] * (dst.dim() - 1)))
    dst.index_put_((tgt,), torch.where(keep, val[src], dst[tgt]))


def cache_insert(
    cache: CacheState,
    ids: torch.Tensor,  # (k,) int32, -1 padded
    vecs: torch.Tensor,  # (k, d) float32
    policy: int = EVICT_FIFO,
    enable: Optional[torch.Tensor] = None,  # () bool: False makes a no-op
) -> CacheState:
    """Insert a fetched batch, evicting per ``policy``; updates ``cache``
    in place and returns it. ``vecs`` arrive float32 and are quantized to
    the slab's precision on the way in (encoded through the codebook at
    pq: re-encoding a decoded row keeps its reconstruction).

    FIFO: slots are a ring buffer advanced by the insert cursor. LRU:
    each insert claims the least-recently-used slot (a stable ascending
    sort of the timestamps, ties to the lower slot — ``lax.top_k``'s
    order in the reference). Overflow contract: when one batch exceeds
    capacity, rows recycle slots and all but the LAST row targeting a
    slot are dropped ("keep-newest"), chosen by a scatter-max so the
    result never depends on scatter order; an int8 row's scale is written
    through the same winner as its payload. Ids are assumed unique
    within a batch.

    The insert is the reference's drop-mode one at a fixed shape: every
    row is quantized (or encoded) and every write goes through a mask
    (:func:`_write_plan`), so it needs no host sync and a CUDA graph can
    capture it. ``enable`` (a device bool) gates the whole insert, the
    LRU clock's tick included: the fused driver inserts at every step and
    enables it at a phase boundary only.
    """
    ids = ids.reshape(-1).to(torch.int32)
    k = ids.shape[0]
    cap = cache.capacity
    dev = cache.slab.device
    tick = 1 if enable is None else enable.long()
    if k == 0:
        if policy != EVICT_FIFO:
            cache.clock.add_(tick)
        return cache
    present, _ = cache_slots(cache, ids)
    need = (ids >= 0) & ~present
    if enable is not None:
        need = need & enable
    offsets = torch.cumsum(need.long(), 0) - 1
    if policy == EVICT_FIFO:
        slots = (cache.clock + torch.where(need, offsets, 0)) % cap
        new_clock = cache.clock + need.long().sum()
    else:
        m = min(k, cap)
        lru_slots = torch.sort(cache.last_used, stable=True).indices[:m]
        slots = lru_slots[offsets.clamp(0, k - 1) % m]
        new_clock = cache.clock + tick
    slots = torch.where(need, slots, cap)  # cap = the spare "drop" column
    order = torch.arange(k, device=dev)
    winner = torch.full((cap + 1,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, slots, torch.where(need, order, -1), "amax")
    need = need & (winner[slots] == order)  # inserting rows: unique slots
    slots = slots.clamp(max=cap - 1)
    evicted = cache.id_of[slots]
    # 1) unmap evicted ids, 2) map the new ones (the reference's order)
    _put(cache.slot_of, _write_plan(evicted.long(), need & (evicted >= 0)),
         torch.full_like(evicted, -1))
    _put(cache.slot_of, _write_plan(ids.long(), need), slots.to(torch.int32))
    plan = _write_plan(slots, need)  # the slot-indexed writes
    if cache.slab.dtype == torch.uint8:
        _put(cache.slab, plan, pq.encode(vecs, cache.codebook))
    else:
        payload, row_scales = quant.quantize(vecs, cache.precision)
        _put(cache.slab, plan, payload)
        if cache.slab.dtype == torch.int8:
            _put(cache.scales, plan, row_scales)
    _put(cache.id_of, plan, ids)
    _put(cache.last_used, plan, new_clock.to(torch.int32).expand(k))
    cache.clock.copy_(new_clock)
    return cache


def cache_evict(cache: CacheState, ids: torch.Tensor) -> CacheState:
    """Drop ``ids`` ((k,) int32, -1 padded) from tier 2 for a delete or an
    upsert, in place, and return ``cache``.

    Both directions of the id↔slot map are cleared, so no lookup serves a
    tombstoned row again; a freed slot gets LRU stamp 0 (the stalest, so
    it is reclaimed first). The slab row stays as garbage, unreachable
    once unmapped, as after a ring wrap. A slot is freed only where its
    mapping is current (the ``id_of`` cross-check of
    :func:`cache_slots`); ids out of range and -1 are no-ops. The
    reference's drop-mode scatters become masked writes
    (:func:`_write_plan`)."""
    ids = ids.reshape(-1).to(torch.int32)
    if ids.numel() == 0:
        return cache
    n, cap = cache.slot_of.shape[0], cache.capacity
    in_range = (ids >= 0) & (ids < n)
    safe_ids = ids.long().clamp(0, n - 1)
    slots = cache.slot_of[safe_ids]
    safe_slots = slots.long().clamp(0, cap - 1)
    current = in_range & (slots >= 0) & (cache.id_of[safe_slots] == ids)
    plan = _write_plan(safe_slots, current)
    _put(cache.id_of, plan, torch.full_like(ids, -1))
    _put(cache.last_used, plan, torch.zeros_like(ids))
    _put(cache.slot_of, _write_plan(safe_ids, in_range),
         torch.full_like(ids, -1))
    return cache


def cache_grow(cache: CacheState, n_items: int) -> CacheState:
    """``cache`` with its id→slot map extended to ``n_items`` ids, the new
    ones absent; slab and capacity unchanged (adding corpus rows does not
    resize tier 2). The map is a new tensor, so a step graph captured
    over the old one is never replayed (``core/step_graph.py``)."""
    extra = int(n_items) - cache.slot_of.shape[0]
    if extra < 0:
        raise ValueError("cache id space cannot shrink")
    if extra == 0:
        return cache
    pad = torch.full((extra,), -1, dtype=torch.int32,
                     device=cache.slot_of.device)
    return dataclasses.replace(
        cache, slot_of=torch.cat([cache.slot_of, pad]))


def cache_insert_batch(
    cache: CacheState,
    ids: torch.Tensor,  # (B, k) int32, -1 padded
    vecs: torch.Tensor,  # (B, k, d) float32
    policy: int = EVICT_FIFO,
) -> CacheState:
    """Insert a (B, k) fetched batch as one flattened (B*k,) insert."""
    B, k = ids.shape
    return cache_insert(
        cache, ids.reshape(B * k), vecs.reshape(B * k, -1), policy=policy
    )


# --------------------------------------------------------------- tier 3


@dataclasses.dataclass
class AccessStats:
    """Counters behind Eq. 1 (redundancy) and Eq. 2 (latency model)."""

    n_db: int = 0  # number of external accesses (transactions)
    items_fetched: int = 0  # total items pulled from tier 3
    items_used: int = 0  # items that were actually needed (#hit in Eq. 1)
    modeled_time: float = 0.0  # sum of modeled t_db per access
    wall_time: float = 0.0  # measured host time in fetch calls

    def redundancy(self) -> float:
        """Eq. 1: R = 1 - hits / (n_db * prefetch_size)."""
        if self.items_fetched == 0:
            return 0.0
        return 1.0 - self.items_used / self.items_fetched

    def reset(self) -> None:
        self.n_db = 0
        self.items_fetched = 0
        self.items_used = 0
        self.modeled_time = 0.0
        self.wall_time = 0.0


class ExternalStore:
    """Tier 3: accounting shell (counters + cost model) over a host-side
    backend. ``source`` is a raw ``(N, d)`` array (wrapped in
    :class:`InMemoryBackend`) or any :class:`StorageBackend`; a
    :class:`LatencyModel` is composed on unless the backend has one."""

    def __init__(
        self,
        source: Union[np.ndarray, StorageBackend],
        t_setup: float = 1.0e-3,
        t_per_item: float = 2.0e-6,
        simulate_latency: bool = False,
    ):
        backend = source if hasattr(source, "fetch") else InMemoryBackend(source)
        if not isinstance(backend, LatencyModel):
            backend = LatencyModel(
                backend, t_setup, t_per_item, simulate_latency
            )
        self.backend: StorageBackend = backend
        self.stats = AccessStats()
        self._pending: set = set()  # fetched ids not yet demanded

    @property
    def base_backend(self) -> StorageBackend:
        """The storage medium itself, LatencyModel wrappers stripped."""
        return unwrap_backend(self.backend)

    @property
    def vectors(self) -> np.ndarray:
        """Full payload, materialized (init-stage all-in-one load): the
        array of an :class:`InMemoryBackend`, the dequantized (or
        decoded) shards of a ``ShardedFileBackend``, base and appended
        rows of a ``DeltaBackend``."""
        return self.backend.vectors

    @property
    def simulate_latency(self) -> bool:
        """Whether fetches sleep their modeled cost (the LatencyModel's
        ``simulate``) rather than only accounting it."""
        b = self.backend
        return b.simulate if isinstance(b, LatencyModel) else False

    @property
    def n_items(self) -> int:
        return self.backend.n_items

    @property
    def dim(self) -> int:
        return self.backend.dim

    def access_cost(self, n: int) -> float:
        return self.backend.access_cost(n)

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """ONE external access (one 'transaction') for a batch of ids."""
        t0 = time.perf_counter()
        ids = np.asarray(ids)
        ids = ids[ids >= 0]
        out = self.backend.fetch(ids)
        cost = self.access_cost(len(ids))
        self.stats.n_db += 1
        self.stats.items_fetched += len(ids)
        self.stats.modeled_time += cost
        self.stats.wall_time += time.perf_counter() - t0
        self._pending.update(int(i) for i in ids)
        return out

    def fetch_sequential(self, ids: np.ndarray) -> np.ndarray:
        """n separate accesses for n items (paper Fig. 3b's slow path)."""
        ids = np.asarray(ids)
        ids = ids[ids >= 0]
        out = np.empty((len(ids), self.dim), np.float32)
        for j, i in enumerate(ids):
            out[j] = self.fetch(np.array([i]))
        return out

    def append(self, rows: np.ndarray) -> np.ndarray:
        """Append payload rows for the mutation lifecycle (DESIGN.md §8)
        and return their ids. On first use the storage medium is wrapped
        in a :class:`DeltaBackend` inside any LatencyModel chain, so the
        cost model keeps covering every fetch while the medium stays
        frozen. An append is not a query-time access: no counter moves."""
        base = self.base_backend
        if not isinstance(base, DeltaBackend):
            delta = DeltaBackend(base)
            b = self.backend
            if isinstance(b, LatencyModel):
                while isinstance(b.inner, LatencyModel):
                    b = b.inner
                b.inner = delta
            else:
                self.backend = delta
            base = delta
        return base.append(rows)

    def mark_used(self, n: int) -> None:
        self.stats.items_used += int(n)

    def mark_used_ids(self, ids) -> None:
        """Eq. 1 hit accounting, per fetch event: each fetched copy of an
        item counts as 'used' when first demanded after that fetch."""
        for i in np.atleast_1d(np.asarray(ids)).tolist():
            i = int(i)
            if i in self._pending:
                self._pending.discard(i)
                self.stats.items_used += 1


class TieredStore:
    """Tier 2 (device slab) + tier 3 (host backend) used by the engine.

    ``gather(ids)``: look up tier 2; fetch only the misses from tier 3 in
    ONE access; insert them into tier 2 (quantized at ``precision``, or
    encoded through ``codebook`` at ``"pq"``); return all rows on the
    device as float32. This is the bulk phase-2 load of the lazy search
    (Algorithm 1 line 24).
    """

    def __init__(
        self,
        external: ExternalStore,
        capacity: int,
        eviction: str = "fifo",
        device: DeviceLike = None,
        precision: str = "float32",
        codebook: Optional[pq.PQCodebook] = None,  # pq only
    ):
        self.external = external
        self.eviction = _EVICTION_NAMES[eviction]
        self.device = resolve_device(device)
        self.precision = quant.canonical_precision(precision)
        self.cache = cache_init(
            external.n_items, capacity, external.dim, self.device,
            self.precision, codebook=codebook,
        )
        self.hits = 0
        self.misses = 0

    @property
    def capacity(self) -> int:
        return self.cache.capacity

    def cache_bytes(self) -> int:
        """Resident tier-2 payload bytes at the current precision."""
        return self.cache.nbytes()

    def resize(self, capacity: int) -> None:
        """Re-initialize tier 2 with a new capacity (cache-size optimizer).
        The precision and the codebook survive: the codebook is frozen
        corpus state, not cache contents."""
        self.cache = _empty_cache(
            self.external.n_items, capacity, int(self.cache.slab.shape[1]),
            self.precision, self.cache.codebook,
        )
        self.hits = 0
        self.misses = 0

    def lookup(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return cache_lookup(self.cache, ids)

    def invalidate(self, ids: np.ndarray) -> None:
        """Evict ``ids`` from tier 2 (delete/upsert invalidation), in
        place."""
        self.cache = cache_evict(
            self.cache, self._upload(np.asarray(ids, dtype=np.int32)))

    def grow(self, n_items: int) -> None:
        """Extend the cache's id space after corpus rows were appended."""
        self.cache = cache_grow(self.cache, n_items)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def gather(self, ids: np.ndarray) -> torch.Tensor:
        """Bulk gather with single-access miss fill: ``(k, d)`` float32
        device rows of ``ids`` ((k,), no padding). A hit is its
        dequantized (or decoded) slab row, a miss the full-precision
        fetched row (the reference's rows, ``store.py:586-615``)."""
        ids = np.asarray(ids, dtype=np.int32)
        ids_t = self._upload(ids)
        # read (and dequantize) the hits before the insert below can
        # evict their slots
        present, rows = cache_lookup(self.cache, ids_t)
        present_np = present.cpu().numpy()
        n_miss = int((~present_np).sum())
        self.hits += int(present_np.sum())
        self.misses += n_miss
        if n_miss:
            miss_ids = ids[~present_np]
            fetched = self._upload(
                np.asarray(self.external.fetch(miss_ids), np.float32)
            )
            self.cache = cache_insert(
                self.cache, self._upload(miss_ids), fetched,
                policy=self.eviction,
            )
            rows[self._upload(np.nonzero(~present_np)[0])] = fetched
        self.external.mark_used_ids(ids)  # every gathered id is demanded
        if self.eviction == EVICT_LRU:
            self.cache = cache_touch(self.cache, ids_t)
        return rows

    def gather_batch(self, ids: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-query amortized bulk gather (DESIGN.md §5).

        ``ids`` is a (B, k) matrix of -1-padded per-query miss lists. The
        rows are unioned and deduplicated (sorted), the union's tier-2
        misses are fetched from tier 3 in ONE access via :meth:`gather`,
        and the result comes back as ``(rows (U, d), pos (B, k) int32)``:
        the union's rows on the device and each entry's position in them
        (-1 for padding), so nothing is materialised at (B, k, d).
        """
        ids = np.asarray(ids, dtype=np.int32)
        valid = ids >= 0
        pos = np.full(ids.shape, -1, np.int32)
        if not valid.any():
            rows = torch.zeros(
                (0, self.external.dim), dtype=torch.float32, device=self.device
            )
            return rows, self._upload(pos)
        union = np.unique(ids[valid])  # sorted — searchsorted below
        rows = self.gather(union)
        pos[valid] = np.searchsorted(union, ids[valid])
        return rows, self._upload(pos)

    def warm(self, ids: np.ndarray) -> None:
        """Pre-populate tier 2 (initialization-stage index loading),
        reading the storage medium directly: init-stage loading is not a
        query-time access, so it is neither counted nor simulated."""
        ids = np.asarray(ids, dtype=np.int32)
        vecs = np.asarray(self.external.base_backend.fetch(ids), np.float32)
        self.cache = cache_insert(
            self.cache, self._upload(ids), self._upload(vecs),
            policy=self.eviction,
        )
