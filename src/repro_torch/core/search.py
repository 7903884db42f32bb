"""Phased lazy-loading HNSW search (paper §3.3, Algorithm 1) in PyTorch.

The port of ``repro.core.search``. One layer's search is a beam search
over fixed-shape tensors: the candidate heap and the result list are one
sorted beam of ``ef`` entries. Lazy loading appears as phases:

- an **in-memory phase** (:func:`batch_search_phase`) expands beam
  candidates against tier 2 only; a neighbor missing from tier 2 goes to
  the bounded miss list ``L`` (Algorithm 1 lines 14–16). It ends when
  the beam is exhausted or ``|L| >= ef`` (lines 22–23);
- a **load phase** (:func:`batch_load_phase`) merges the rows the driver
  bulk-loaded for ``L`` into the beam as unexplored candidates (lines
  24–31).

Every function works on a batch: each state tensor has a leading query
axis B. The single-query forms (:func:`seed_state`, :func:`search_phase`,
:func:`load_phase`) run the batched code at B = 1, so the loop and the
batched drivers give identical bits (DESIGN.md §5). Where the reference
vmaps a ``lax.while_loop``, a phase is a loop of fixed-shape hop steps
(:func:`batch_hop_step`) that leaves a finished query's state untouched,
counters included — what vmap's masking does. So a step taken after
every query has stopped changes nothing, and the loop checks on the
host only once every :data:`STEPS_PER_SYNC` steps whether any query is
still active. On CUDA tensors those steps replay from a CUDA graph
(:mod:`repro_torch.core.step_graph`); on the CPU the same loop runs
eagerly (:func:`batch_search_phase_eager`, which also runs on the card).

The kernels of the path carry the work: the distances of every hop and
of every load phase come from ``ops.gather_distance(_batch)`` over the
rows where they already live (the tier-2 slab during a phase, the
fetched rows during a load) — or from ``ops.dequant_gather_distance
(_batch)`` where those rows are an int8 or float16 slab or payload, or
from ``ops.adc_gather_distance(_batch)`` over the per-query lookup tables
where they are PQ codes (DESIGN.md §12) — and the beam merge is
``ops.merge_topk``, whose ``src`` output carries the ``explored`` flags
through the merge. On the card a hop step over a float32, int8 or
float16 tier 2 is one launch of the hop-step kernel B.8
(``ops.hop_step``), which holds the same distance stage and merge and
gives the bits of those ops (:func:`batch_hop_step_plain`).

The fused driver (:func:`lazy_knn_search_fused`) runs the same phases
with the tier-3 payload resident on the device: a load phase reads its
rows from that payload through the kernels instead of a host fetch. As
in the reference's one program, its phase loop is one masked step (a
hop step, then the phase boundary's gather, tier-2 insert and load
phase, each masked by "boundary reached"), with its access counters on
the device: it syncs every :data:`STEPS_PER_SYNC` steps and once a
search, never once a phase.
Tombstones (deleted ids, DESIGN.md §8) enter as pre-marked ``visited``
bits (:func:`batch_make_state`): a tombstoned id is never seeded,
expanded, fetched or returned, and every step, the kernel's included,
reads ``visited`` as state. A metadata filter's deny mask (``banned``,
DESIGN.md §9) is route-but-don't-return: it never enters the state, a
hop step or B.8, and is read only at extraction
(:func:`finalize_topk`), where denied ids become sentinels before the
merge, so a filtered search takes the unfiltered search's steps and
tier-3 accesses at the same ef.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.core import pq, quant, step_graph
from repro_torch.core.graph import PAD
from repro_torch.core.store import CacheState, cache_insert, cache_slots
from repro_torch.kernels import ops

INF = float("inf")

# hop steps between two host checks of whether a loop goes on: one sync
# every K steps, at the cost of up to K - 1 steps that change nothing at
# a loop's end. A step costs the card more than a check costs the host,
# so K is small (chip_smoke.py sweeps K = 1, 2, 4, 8, 16 on the card)
STEPS_PER_SYNC = 2


@dataclasses.dataclass
class Beam:
    """Sorted candidate/result beam (C == W in the fixed-shape variant)."""

    ids: torch.Tensor  # (..., ef) int32, -1 padded
    dists: torch.Tensor  # (..., ef) float32, +inf padded
    explored: torch.Tensor  # (..., ef) bool

    @property
    def ef(self) -> int:
        return int(self.ids.shape[-1])


@dataclasses.dataclass
class SearchState:
    """Per-query state threaded through the phases of one layer search
    (leading query axis in the batched forms)."""

    beam: Beam
    # (..., N + 1) bool; the last column is a spare that masked-out rows
    # scatter into (their own False), so a padded row never writes to a
    # real node and the spare stays False
    visited: torch.Tensor
    miss_ids: torch.Tensor  # (..., miss_cap) int32, -1 padded
    miss_count: torch.Tensor  # (...) int64
    n_hops: torch.Tensor  # (...) int64 — beam expansions done
    n_dist: torch.Tensor  # (...) int64 — distance evaluations done


@dataclasses.dataclass
class Tier2:
    """Where a search reads resident rows: ``table`` rows, addressed by
    :meth:`slots`; an int8 ``table`` carries its per-row ``scales``, a
    uint8 PQ code table the searching queries' lookup tables ``luts``.
    With a ``cache`` the rows are its slab, found through its id→slot
    map; without one the table is the whole corpus."""

    table: torch.Tensor  # (R, d) float32 / float16 / int8, or (R, M) uint8
    scales: Optional[torch.Tensor] = None  # (R,) float32 for int8
    luts: Optional[torch.Tensor] = None  # (B, L, M, 256) float32 for pq
    cache: Optional[CacheState] = None

    def slots(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(present, slot)`` of any-shaped ``ids`` (-1 padded)."""
        if self.cache is None:
            return ids >= 0, ids.long().clamp(0, self.table.shape[0] - 1)
        return cache_slots(self.cache, ids)

    def tensors(self) -> List[torch.Tensor]:
        """The tensors a search step reads through this tier 2, the
        queries' ``luts`` aside."""
        out = [self.table] + ([] if self.scales is None else [self.scales])
        if self.cache is not None:
            out += [self.cache.slot_of, self.cache.id_of]
        return out


def cache_tier2(cache: CacheState,
                luts: Optional[torch.Tensor] = None) -> Tier2:
    """Tier 2 as the cache slab: a present id's row is its slot. A pq
    slab is read through ``luts``, the (B, L, M, 256) tables of the
    searching queries (``pq.build_lut``, built once a search)."""
    return Tier2(cache.slab, cache.row_scales(), luts, cache)


def resident_tier2(vectors: torch.Tensor) -> Tier2:
    """Tier 2 as the whole table (memory-data ratio 100%)."""
    return Tier2(vectors)


def _distances(
    table: torch.Tensor, ids: torch.Tensor, Q: torch.Tensor, metric: str,
    scales: Optional[torch.Tensor] = None,
    luts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, K) distances of ``table[ids[b]]`` to ``Q[b]``, +inf for ids < 0.

    A float32 table goes to the gather-distance kernel, an int8 (with its
    ``scales``) or float16 one to the dequant-gather-distance kernel, a
    uint8 PQ code table to the ADC kernel over the queries' ``luts``
    (which stand for ``Q``: the distance to the decoded row, DESIGN.md
    §12). One query (the loop and fused drivers) goes through the
    single-query form of the kernel, a batch through the batched form;
    the two are one kernel, so they give identical bits."""
    if table.dtype == torch.float32:
        if Q.shape[0] == 1:
            return ops.gather_distance(table, ids[0], Q[0], metric)[None]
        return ops.gather_distance_batch(table, ids, Q, metric)
    if table.dtype == torch.uint8:
        if luts is None:
            raise ValueError("a PQ code table is read through the queries' "
                             "lookup tables: pass luts")
        if Q.shape[0] == 1:
            return ops.adc_gather_distance(table, luts[0], ids[0],
                                           metric)[None]
        return ops.adc_gather_distance_batch(table, luts, ids, metric)
    if Q.shape[0] == 1:
        return ops.dequant_gather_distance(
            table, scales, ids[0], Q[0], metric)[None]
    return ops.dequant_gather_distance_batch(table, scales, ids, Q, metric)


def beam_init(ef: int, device: torch.device) -> Beam:
    return Beam(
        ids=torch.full((ef,), -1, dtype=torch.int32, device=device),
        dists=torch.full((ef,), INF, dtype=torch.float32, device=device),
        explored=torch.zeros((ef,), dtype=torch.bool, device=device),
    )


def beam_merge(
    beam: Beam,
    new_ids: torch.Tensor,
    new_dists: torch.Tensor,
    new_valid: torch.Tensor,
) -> Beam:
    """Merge (id, dist) entries into the beam, keep the ef best in stable
    order, through ``ops.merge_topk``.

    New entries arrive unexplored; invalid ones become sentinels. The
    merge's tie rule (lower input position first) is ``lax.top_k`` on
    negated distances, the reference's rule, and its ``src`` output picks
    each survivor's ``explored`` flag. Its id dedup is a no-op here: new
    entries are never in the beam (they were unvisited) and a neighbor
    row holds no id twice.
    """
    ef = beam.ef
    ids = torch.cat(
        [beam.ids, torch.where(new_valid, new_ids.to(torch.int32), -1)], -1
    )
    dists = torch.cat(
        [beam.dists, torch.where(new_valid, new_dists, INF)], -1
    )
    expl = torch.cat([beam.explored, torch.zeros_like(new_valid)], -1)
    lead = ids.shape[:-1]
    m = ids.shape[-1]
    d, i, src = ops.merge_topk(
        dists.reshape(-1, m).contiguous(), ids.reshape(-1, m).contiguous(), ef
    )
    flags = expl.reshape(-1, m).gather(1, src.long().clamp(min=0)) & (src >= 0)
    return Beam(
        ids=i.reshape(*lead, ef),
        dists=d.reshape(*lead, ef),
        explored=flags.reshape(*lead, ef),
    )


def _where_rows(active: torch.Tensor, new: Beam, old: Beam) -> Beam:
    a = active[:, None]
    return Beam(
        ids=torch.where(a, new.ids, old.ids),
        dists=torch.where(a, new.dists, old.dists),
        explored=torch.where(a, new.explored, old.explored),
    )


def batch_make_state(
    batch: int, ef: int, miss_cap: int, n: int, device: torch.device,
    tombstones: Optional[torch.Tensor] = None,
) -> SearchState:
    """Fresh state for ``batch`` queries of one layer search.
    ``tombstones`` ((n,) bool on ``device``) pre-marks deleted ids as
    visited in every query's row, the spare column left False."""
    one = beam_init(ef, device)
    visited = torch.zeros((batch, n + 1), dtype=torch.bool, device=device)
    if tombstones is not None:
        visited[:, :n] = tombstones
    return SearchState(
        beam=Beam(*(t.repeat(batch, 1)
                    for t in (one.ids, one.dists, one.explored))),
        visited=visited,
        miss_ids=torch.full((batch, miss_cap), -1, dtype=torch.int32,
                            device=device),
        miss_count=torch.zeros((batch,), dtype=torch.int64, device=device),
        n_hops=torch.zeros((batch,), dtype=torch.int64, device=device),
        n_dist=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def _push_misses(
    state: SearchState, ids: torch.Tensor, missing: torch.Tensor
) -> SearchState:
    """Append each row's ``ids[missing]`` to its bounded miss list
    (Alg. 1 line 15); overflow past the cap is dropped (the trigger fires
    first)."""
    cap = state.miss_ids.shape[-1]
    offs = torch.cumsum(missing.long(), -1) - 1
    pos = state.miss_count[:, None] + torch.where(missing, offs, cap)
    pos = torch.where(pos < cap, pos, cap)  # cap = spare "drop" column
    spare = torch.full_like(state.miss_ids[:, :1], -1)
    miss_ids = torch.cat([state.miss_ids, spare], -1).scatter(
        1, pos, ids.to(torch.int32)
    )[:, :cap]
    miss_count = torch.clamp(
        state.miss_count + missing.long().sum(-1), max=cap
    )
    return dataclasses.replace(state, miss_ids=miss_ids, miss_count=miss_count)


def batch_seed_state(
    states: SearchState,
    Q: torch.Tensor,  # (B, d)
    entry_ids: torch.Tensor,  # (B, k) int32, -1 padded
    tier2: Tier2,
    metric: str,
) -> SearchState:
    """Enter a layer: probe entry points, merging hits into the beam and
    misses into L (entry points must be resolved before the phase loop —
    the paper's inter-layer correctness requirement)."""
    n = states.visited.shape[-1] - 1
    entry_ids = entry_ids.to(torch.int32)
    valid = entry_ids >= 0
    valid = valid & ~states.visited.gather(1, entry_ids.long().clamp(0, n - 1))
    present, slots = tier2.slots(entry_ids)
    usable = valid & present
    dists = _distances(
        tier2.table, torch.where(usable, slots, -1).to(torch.int32), Q,
        metric, tier2.scales, tier2.luts,
    )
    beam = beam_merge(states.beam, entry_ids, dists, usable)
    visited = states.visited.scatter(
        1, torch.where(valid, entry_ids.long(), n), valid
    )
    states = dataclasses.replace(states, beam=beam, visited=visited)
    return _push_misses(states, entry_ids, valid & ~present)


def batch_hop_step(
    Q: torch.Tensor,  # (B, d)
    neighbors_l: torch.Tensor,  # (N, deg) int32, PAD padded
    s: SearchState,
    tier2: Tier2,
    metric: str,
    trigger: int,
    max_hops: int = 100000,
    gate: Optional[torch.Tensor] = None,  # (B,) or () bool
) -> Tuple[SearchState, torch.Tensor]:
    """One hop step of Algorithm 1 (lines 6–21) for B queries, at a fixed
    shape and with no host sync: ``(state, active)``.

    Every still-active query expands its nearest unexplored candidate
    against tier 2; misses go to L. A query is active while its beam
    holds an unexplored candidate, ``|L| < trigger`` and it has made
    fewer than ``max_hops`` hops (and where ``gate`` holds). Every update
    is masked by ``active``, and a query that stops never becomes active
    again, so a step after every query has stopped leaves every state
    tensor as it was (``tests/test_torch_search_loop.py``).

    Where ``ops.hop_step_takes`` (a CUDA float32, int8 or float16 tier 2
    and ``ef + deg`` ≤ 256) the step is one launch of the hop-step kernel
    B.8, which gives the bits of :func:`batch_hop_step_plain`; everywhere
    else (the CPU, a pq tier 2, wider rows) it is
    :func:`batch_hop_step_plain`. The rule looks at device, dtype and
    shapes only, before any launch."""
    if not ops.hop_step_takes(tier2.table, s.beam.ef, neighbors_l.shape[1]):
        return batch_hop_step_plain(Q, neighbors_l, s, tier2, metric,
                                    trigger, max_hops, gate)
    cache = tier2.cache
    # L comes out of _push_misses as a view of a wider tensor
    out = ops.hop_step(
        Q, neighbors_l, *(t.contiguous() for t in _state_tensors(s)),
        tier2.table, tier2.scales,
        None if cache is None else cache.slot_of,
        None if cache is None else cache.id_of, metric, trigger, max_hops,
        gate)
    return _state_of(list(out[:8])), out[8]


def batch_hop_step_plain(
    Q: torch.Tensor,  # (B, d)
    neighbors_l: torch.Tensor,  # (N, deg) int32, PAD padded
    s: SearchState,
    tier2: Tier2,
    metric: str,
    trigger: int,
    max_hops: int = 100000,
    gate: Optional[torch.Tensor] = None,  # (B,) or () bool
) -> Tuple[SearchState, torch.Tensor]:
    """:func:`batch_hop_step` as PyTorch ops around the distance and merge
    kernels, on either device: the CPU's step (the ops' plain versions),
    and on the card the per-op step of hand-written kernels (B.1, B.3 or
    B.4, then B.2) that the hop-step kernel B.8 is held to bit for bit."""
    n = neighbors_l.shape[0]
    unexplored = (s.beam.ids >= 0) & ~s.beam.explored
    active = (
        unexplored.any(-1) & (s.miss_count < trigger)
        & (s.n_hops < max_hops)
    )
    if gate is not None:
        active = active & gate
    j = torch.argmin(torch.where(unexplored, s.beam.dists, INF), -1)
    c = s.beam.ids.gather(1, j[:, None])[:, 0]
    explored = s.beam.explored.scatter(
        1, j[:, None],
        s.beam.explored.gather(1, j[:, None]) | active[:, None],
    )
    beam = dataclasses.replace(s.beam, explored=explored)
    nbrs = neighbors_l[c.long().clamp(0, n - 1)]  # (B, deg)
    valid = (nbrs != PAD) & active[:, None]
    safe = torch.where(valid, nbrs, 0).long()
    fresh = valid & ~s.visited.gather(1, safe)
    visited = s.visited.scatter(
        1, torch.where(fresh, nbrs.long(), n), fresh
    )
    present, slots = tier2.slots(torch.where(fresh, nbrs, -1))
    usable = fresh & present
    dists = _distances(
        tier2.table, torch.where(usable, slots, -1).to(torch.int32),
        Q, metric, tier2.scales, tier2.luts,
    )
    merged = beam_merge(beam, nbrs, dists, usable)
    s = dataclasses.replace(
        s,
        beam=_where_rows(active, merged, beam),
        visited=visited,
        n_hops=s.n_hops + active.long(),
        n_dist=s.n_dist + usable.long().sum(-1),
    )
    return _push_misses(s, nbrs, fresh & ~present), active


def _state_tensors(s: SearchState) -> List[torch.Tensor]:
    return [s.beam.ids, s.beam.dists, s.beam.explored, s.visited,
            s.miss_ids, s.miss_count, s.n_hops, s.n_dist]


def _state_of(ts: List[torch.Tensor]) -> SearchState:
    return SearchState(Beam(*ts[:3]), *ts[3:8])


def _consts(Q: torch.Tensor, luts: Optional[torch.Tensor]) -> List[torch.Tensor]:
    return [Q] if luts is None else [Q, luts]


def _run_loop(step, carry, consts, baked, params, eager: bool):
    """A step loop, checked on the host every :data:`STEPS_PER_SYNC`
    steps: replayed from CUDA graphs on the card, eager on the CPU or
    where ``eager`` asks for it."""
    if eager or carry[0].device.type != "cuda":
        return step_graph.run_eager(step, carry, consts, STEPS_PER_SYNC)
    return step_graph.run_graph(step, carry, consts, baked, params,
                                STEPS_PER_SYNC)


def _phase(Q, neighbors_l, states, tier2, metric, ef_trigger, max_hops,
           eager: bool) -> SearchState:
    trigger = states.beam.ef if ef_trigger is None else ef_trigger

    def step(carry, consts):
        t2 = dataclasses.replace(tier2, luts=consts[1] if len(consts) > 1
                                 else None)
        s, active = batch_hop_step(consts[0], neighbors_l, _state_of(carry),
                                   t2, metric, trigger, max_hops)
        return _state_tensors(s), active

    return _state_of(_run_loop(
        step, _state_tensors(states), _consts(Q, tier2.luts),
        [neighbors_l] + tier2.tensors(), ("hop", metric, trigger, max_hops),
        eager))


def batch_search_phase(
    Q: torch.Tensor,  # (B, d)
    neighbors_l: torch.Tensor,  # (N, deg) int32, PAD padded
    states: SearchState,
    tier2: Tier2,
    metric: str,
    ef_trigger: Optional[int] = None,
    max_hops: int = 100000,
) -> SearchState:
    """One in-memory phase of Algorithm 1 (lines 6–22) for B queries.

    Hop steps (:func:`batch_hop_step`) until no query is active: a query
    stops when its beam is exhausted or ``|L| >= ef_trigger``. On CUDA
    tensors the steps replay from a CUDA graph, :data:`STEPS_PER_SYNC` a
    replay and one host sync a replay; on the CPU this is
    :func:`batch_search_phase_eager`. Both take the same steps and give
    the same bits.
    """
    return _phase(Q, neighbors_l, states, tier2, metric, ef_trigger,
                  max_hops, eager=False)


def batch_search_phase_eager(
    Q: torch.Tensor,
    neighbors_l: torch.Tensor,
    states: SearchState,
    tier2: Tier2,
    metric: str,
    ef_trigger: Optional[int] = None,
    max_hops: int = 100000,
) -> SearchState:
    """:func:`batch_search_phase` with its hop steps called from Python
    on either device, one host sync every :data:`STEPS_PER_SYNC` steps:
    the CPU's phase, and on the card the loop a replayed graph is held
    to."""
    return _phase(Q, neighbors_l, states, tier2, metric, ef_trigger,
                  max_hops, eager=True)


def batch_load_phase(
    Q: torch.Tensor,  # (B, d)
    states: SearchState,
    loaded_ids: torch.Tensor,  # (B, miss_cap) int32, -1 padded
    table: torch.Tensor,  # (R, d) — the bulk-loaded rows
    rows: torch.Tensor,  # (B, miss_cap) int32 — row of each id, -1 padded
    metric: str,
    scales: Optional[torch.Tensor] = None,  # (R,) for an int8 table
    luts: Optional[torch.Tensor] = None,  # (B, L, M, 256) for a pq table
) -> SearchState:
    """Merge bulk-loaded rows into each beam (Alg. 1 lines 25–31) and
    clear L. The driver has already inserted them into tier 2. A query
    that missed nothing passes all -1 rows and is left unchanged.
    ``table`` is the fetched float32 rows (host drivers) or the device-
    resident tier-3 payload at any precision (fused driver)."""
    valid = loaded_ids >= 0
    dists = _distances(
        table, torch.where(valid, rows, -1).to(torch.int32), Q, metric,
        scales, luts,
    )
    beam = beam_merge(states.beam, loaded_ids, dists, valid)
    return dataclasses.replace(
        states,
        beam=beam,
        miss_ids=torch.full_like(states.miss_ids, -1),
        miss_count=torch.zeros_like(states.miss_count),
        n_dist=states.n_dist + valid.long().sum(-1),
    )


def finalize_topk(
    state: SearchState, k: int, banned: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k extraction of a (B, ef) or (ef,) beam through
    ``ops.merge_topk``: (dists, ids), each (B, k) or (k,), -1/+inf padded
    when fewer than k entries survive.

    ``banned`` ((n,) or (B, n) bool, the filter's deny mask) is where
    route-but-don't-return acts, and the only place: the beam held
    denied ids so they could route the traversal; here they become (+inf,
    -1) sentinels and the top-k of the allowed beam is taken, as the
    reference's ``finalize_topk`` does."""
    ids, dists = state.beam.ids, state.beam.dists
    one = ids.dim() == 1
    if one:
        ids, dists = ids[None], dists[None]
    bad = ids < 0
    if banned is not None:
        n = banned.shape[-1]
        rows = banned.reshape(-1, n).expand(ids.shape[0], n)
        bad = bad | rows.gather(1, ids.long().clamp(0, n - 1))
    d, i, _ = ops.merge_topk(
        torch.where(bad, INF, dists).contiguous(),
        torch.where(bad, -1, ids).contiguous(), k,
    )
    return (d[0], i[0]) if one else (d, i)


# ------------------------------------------------------ single-query forms
#
# The B = 1 case of the batched functions: the loop driver runs exactly
# the batched code, so both drivers give identical bits.


def _map_state(state: SearchState, fn) -> SearchState:
    return SearchState(
        beam=Beam(fn(state.beam.ids), fn(state.beam.dists),
                  fn(state.beam.explored)),
        visited=fn(state.visited),
        miss_ids=fn(state.miss_ids),
        miss_count=fn(state.miss_count),
        n_hops=fn(state.n_hops),
        n_dist=fn(state.n_dist),
    )


def _one(state: SearchState) -> SearchState:
    return _map_state(state, lambda t: t[None])


def _first(state: SearchState) -> SearchState:
    return _map_state(state, lambda t: t[0])


def make_state(ef: int, miss_cap: int, n: int, device: torch.device,
               tombstones: Optional[torch.Tensor] = None) -> SearchState:
    return _first(batch_make_state(1, ef, miss_cap, n, device, tombstones))


def seed_state(
    state: SearchState, q: torch.Tensor, entry_ids: torch.Tensor,
    tier2: Tier2, metric: str,
) -> SearchState:
    return _first(batch_seed_state(
        _one(state), q[None], entry_ids[None], tier2, metric
    ))


def search_phase(
    q: torch.Tensor, neighbors_l: torch.Tensor, state: SearchState,
    tier2: Tier2, metric: str, ef_trigger: Optional[int] = None,
    max_hops: int = 100000,
) -> SearchState:
    return _first(batch_search_phase(
        q[None], neighbors_l, _one(state), tier2, metric,
        ef_trigger=ef_trigger, max_hops=max_hops,
    ))


def load_phase(
    q: torch.Tensor, state: SearchState, loaded_ids: torch.Tensor,
    table: torch.Tensor, rows: torch.Tensor, metric: str,
    scales: Optional[torch.Tensor] = None,
    luts: Optional[torch.Tensor] = None,
) -> SearchState:
    return _first(batch_load_phase(
        q[None], _one(state), loaded_ids[None], table, rows[None], metric,
        scales, luts,
    ))


# ------------------------------------------------------ fused lazy search


def _where_state(m: torch.Tensor, new: SearchState,
                 old: SearchState) -> SearchState:
    """Field by field ``new`` where the () bool ``m`` holds, else ``old``
    (a field the two share is kept as it is)."""
    return _state_of([a if a is b else torch.where(m, a, b) for a, b in
                      zip(_state_tensors(new), _state_tensors(old))])


def _fused_layer(
    q, neighbors_l, payload, payload_scales, cache, entry_ids, ef, metric,
    eviction, max_phases, luts, tombstones, eager: bool,
) -> Tuple[SearchState, CacheState, torch.Tensor, torch.Tensor]:
    n = neighbors_l.shape[0]
    dev = q.device
    Q = q[None]
    miss_cap = ef + neighbors_l.shape[1] + 1
    state = batch_make_state(1, ef, miss_cap, n, dev, tombstones)
    state = batch_seed_state(state, Q, entry_ids[None],
                             cache_tier2(cache, luts), metric)

    def step(carry, consts):
        s = _state_of(carry[:8])
        n_db, n_fetch, phase, done = carry[8:]
        Qs, lt = consts[0], (consts[1] if len(consts) > 1 else None)
        s, active = batch_hop_step(Qs, neighbors_l, s, cache_tier2(cache, lt),
                                   metric, ef, gate=~done)
        # the phase boundary: no hop this step, and the layer not done
        boundary = ~active[0] & ~done
        ids = torch.where(boundary, s.miss_ids[0], -1)  # L, or nothing
        mc = torch.where(boundary, s.miss_count[0], 0)
        # ONE bulk load of L from the payload (Alg. 1 line 24)
        safe = ids.long().clamp(0, n - 1)
        if payload.dtype == torch.uint8:
            rows = pq.decode(payload[safe], cache.codebook)
        else:
            rows = quant.dequantize(
                payload[safe],
                None if payload_scales is None else payload_scales[safe])
        # the insert runs at every boundary, an empty one too (it moves
        # the LRU clock, as the reference's does)
        cache_insert(cache, ids, rows, policy=eviction, enable=boundary)
        # the miss ids are the payload's rows
        loaded = batch_load_phase(Qs, s, ids[None], payload, ids[None],
                                  metric, payload_scales, lt)
        s = _where_state(boundary, loaded, s)
        n_db = n_db + (mc > 0).long()
        n_fetch = n_fetch + mc
        phase = phase + boundary.long()
        done = done | (boundary & ((mc == 0) | (phase >= max_phases)))
        return _state_tensors(s) + [n_db, n_fetch, phase, done], ~done

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    carry = _state_tensors(state) + [zero, zero, zero,
                                     torch.zeros((), dtype=torch.bool,
                                                 device=dev)]
    baked = [neighbors_l, payload, cache.slab, cache.slot_of, cache.id_of,
             cache.clock, cache.last_used, cache.codebook]
    baked += [t for t in (payload_scales, cache.row_scales())
              if t is not None]
    out = _run_loop(step, carry, _consts(Q, luts), baked,
                    ("fused", metric, ef, eviction, max_phases), eager)
    return _first(_state_of(out[:8])), cache, out[8], out[9]


def search_layer_lazy_fused(
    q: torch.Tensor,  # (d,) float32
    neighbors_l: torch.Tensor,  # (N, deg) int32, PAD padded
    payload: torch.Tensor,  # (N, d) tier-3 payload, or (N, M) uint8 codes
    payload_scales: Optional[torch.Tensor],  # (N,) for an int8 payload
    cache: CacheState,
    entry_ids: torch.Tensor,  # (k,) int32, -1 padded
    ef: int,
    metric: str,
    eviction: int = 0,
    max_phases: int = 256,
    luts: Optional[torch.Tensor] = None,  # (1, L, M, 256): pq search
    tombstones: Optional[torch.Tensor] = None,  # (N,) bool: deleted ids
) -> Tuple[SearchState, CacheState, torch.Tensor, torch.Tensor]:
    """One layer of Algorithm 1 with the tier-3 payload on the device
    (the port of ``repro.core.search.search_layer_lazy_fused``).

    Phases alternate as in the host driver, but a load phase reads the
    miss list ``L`` from ``payload`` instead of fetching it: its
    distances come from the kernel over the payload with the miss ids as
    rows (``gather_distance`` at float32, ``dequant_gather_distance`` at
    float16 and int8, ``adc_gather_distance`` over the query's ``luts``
    at pq), and the dequantized (or decoded, through tier 2's frozen
    codebook, the payload's too) rows go into tier 2, which re-encodes a
    pq row as the reference's insert does. The insert runs after every
    phase, an empty one too (it moves the LRU clock, as the reference's
    does), and nothing is touched: the reference's fused program has no
    LRU touch.

    As the reference's ``lax.while_loop`` over phases, the whole loop is
    one masked step: a hop step while the phase is active, then, at the
    phase boundary, the payload gather, the tier-2 insert and the load
    phase, each masked by "boundary reached". On CUDA tensors the steps
    replay from a CUDA graph with one host sync every
    :data:`STEPS_PER_SYNC` steps; on the CPU this is
    :func:`search_layer_lazy_fused_eager`. ``tombstones`` pre-marks
    deleted ids as visited (:func:`batch_make_state`). Returns ``(state,
    cache, n_db, n_fetched)``, the counts as () int64 device tensors: one
    access for each phase that missed.
    """
    return _fused_layer(q, neighbors_l, payload, payload_scales, cache,
                        entry_ids, ef, metric, eviction, max_phases, luts,
                        tombstones, eager=False)


def search_layer_lazy_fused_eager(
    q: torch.Tensor,
    neighbors_l: torch.Tensor,
    payload: torch.Tensor,
    payload_scales: Optional[torch.Tensor],
    cache: CacheState,
    entry_ids: torch.Tensor,
    ef: int,
    metric: str,
    eviction: int = 0,
    max_phases: int = 256,
    luts: Optional[torch.Tensor] = None,
    tombstones: Optional[torch.Tensor] = None,
) -> Tuple[SearchState, CacheState, torch.Tensor, torch.Tensor]:
    """:func:`search_layer_lazy_fused` with its steps called from Python
    on either device: the CPU's layer, and on the card the loop a
    replayed graph is held to."""
    return _fused_layer(q, neighbors_l, payload, payload_scales, cache,
                        entry_ids, ef, metric, eviction, max_phases, luts,
                        tombstones, eager=True)


def lazy_knn_search_fused(
    q: torch.Tensor,  # (d,) float32
    payload: torch.Tensor,  # (N, d) tier-3 payload (quantized if scaled)
    payload_scales: Optional[torch.Tensor],
    neighbors: torch.Tensor,  # (L, N, deg)
    entry: int,
    cache: CacheState,
    k: int,
    ef: int,
    metric: str = "l2",
    eviction: int = 0,
    tombstones: Optional[torch.Tensor] = None,  # (N,) bool: deleted ids
    banned: Optional[torch.Tensor] = None,  # (N,) bool: filter deny mask
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
           CacheState]:
    """Whole lazy KNN query, all layers, on the device-resident payload:
    ``(dists (k,), ids (k,), (n_db, n_fetched), cache)``, the counts as
    () int64 device tensors. Upper layers descend greedily (ef = 1), as
    the reference's fused program does, and chain on the device: each
    layer's entry is the last one's best id, never read on the host. A
    pq payload ((N, M) uint8 codes of tier 2's codebook) is read through
    the query's lookup tables, built once here for the whole search.
    ``tombstones`` masks deleted ids out of every layer (pre-visited);
    the caller passes a live ``entry``. ``banned`` leaves the search as
    it is and drops denied ids at the last layer's extraction
    (:func:`finalize_topk`)."""
    luts = None
    if payload.dtype == torch.uint8:
        luts = pq.build_lut(q, cache.codebook, metric)[None]
    entry_ids = torch.full((1,), int(entry), dtype=torch.int32,
                           device=q.device)
    n_db = n_fetch = torch.zeros((), dtype=torch.int64, device=q.device)
    for lc in range(neighbors.shape[0] - 1, 0, -1):
        st, cache, db, fc = search_layer_lazy_fused(
            q, neighbors[lc], payload, payload_scales, cache, entry_ids, 1,
            metric, eviction=eviction, luts=luts, tombstones=tombstones,
        )
        n_db, n_fetch = n_db + db, n_fetch + fc
        entry_ids = st.beam.ids[:1]
    st, cache, db, fc = search_layer_lazy_fused(
        q, neighbors[0], payload, payload_scales, cache, entry_ids,
        max(ef, k), metric, eviction=eviction, luts=luts,
        tombstones=tombstones,
    )
    if banned is not None:
        dists, ids = finalize_topk(st, k, banned)
    else:
        dists, ids = st.beam.dists[:k], st.beam.ids[:k]
    return dists, ids, (n_db + db, n_fetch + fc), cache


# ------------------------------------------------------- in-memory oracle


def search_layer_inmem(
    q: torch.Tensor,
    vectors: torch.Tensor,  # (N, d) — the whole table resident
    neighbors_l: torch.Tensor,
    entry_ids: torch.Tensor,
    ef: int,
    metric: str = "l2",
    max_hops: int = 100000,
) -> SearchState:
    """Single-phase search with the whole table in memory (memory-data
    ratio 100%): L stays empty. The oracle the lazy search must match."""
    tier2 = resident_tier2(vectors)
    state = make_state(ef, 1, vectors.shape[0], vectors.device)
    state = seed_state(state, q, entry_ids, tier2, metric)
    return search_phase(
        q, neighbors_l, state, tier2, metric, ef_trigger=2, max_hops=max_hops
    )


def greedy_descend_inmem(
    q: torch.Tensor,
    vectors: torch.Tensor,
    neighbors_upper: torch.Tensor,  # (L-1, N, deg) layers 1..max stacked
    entry: int,
    max_level: int,
    metric: str = "l2",
    max_hops: int = 10000,
) -> int:
    """Greedy ef=1 descent through layers max_level..1 (in-memory)."""
    cur = int(entry)
    cur_d = float(ops.gather_distance(
        vectors, torch.tensor([cur], dtype=torch.int32, device=q.device),
        q, metric,
    )[0])
    hops = 0
    for lc in range(int(max_level), 0, -1):
        moved = True
        while moved and hops < max_hops:
            nbrs = neighbors_upper[lc - 1, cur]
            dn = ops.gather_distance(
                vectors, torch.where(nbrs != PAD, nbrs, -1).to(torch.int32),
                q, metric,
            )
            jbest = int(torch.argmin(dn))
            moved = float(dn[jbest]) < cur_d
            if moved:
                cur, cur_d = int(nbrs[jbest]), float(dn[jbest])
            hops += 1
    return cur


def knn_search_inmem(
    q: torch.Tensor,
    vectors: torch.Tensor,
    neighbors: torch.Tensor,  # (L, N, deg)
    entry: int,
    max_level: int,
    k: int,
    ef: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full in-memory KNN query: (dists (k,), ids (k,))."""
    ep = entry
    if neighbors.shape[0] > 1:
        ep = greedy_descend_inmem(
            q, vectors, neighbors[1:], entry, max_level, metric
        )
    entry_ids = torch.tensor([ep], dtype=torch.int32, device=q.device)
    st = search_layer_inmem(q, vectors, neighbors[0], entry_ids, ef, metric)
    return st.beam.dists[:k], st.beam.ids[:k]
