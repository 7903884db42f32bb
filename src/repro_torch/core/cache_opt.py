"""Heuristic cache-size optimization (paper §3.4, Algorithm 2) + rollback,
for the port (a copy of ``repro.core.cache_opt``; nothing of ``repro`` is
imported).

The optimizer treats the query process as a black box. Starting from the
maximum memory size ``C0`` it runs a query test, computes the access
budget θ from the latency model (Eq. 2), and picks the next candidate size
by intersecting the secant from the measured point ``X_i = (C_i, n_db)``
through the extreme point ``A = (1, n_Q)`` with the line ``y = θ``. The
real fetch curve is bracketed between the random-fetch line (Eq. 3) and
the optimal-fetch hyperbola (Eq. 4), so the secant underestimates how far
the cache can shrink — each step is safe, and steps shrink geometrically
(the paper's two convergence observations).

θ setting (both of the paper's methods, combined by min):
    θ_pct = p · T_query / t_db         (external time ≤ p of total)
    θ_abs = T_θ / t_db                 (external time ≤ T_θ seconds)

Rollback: the optimizer records the (C_i, θ_i) ladder; if a live query at
C_i exceeds θ_i the manager rolls back to C_{i-1}, repeating up to C_0.

Everything here is host Python over numbers a ``query_test`` callback
returns, so the same inputs give the same values as the reference. The
callback drives the engine (``WebANNSEngine.resize_cache``,
``warm_cache``, ``search``): on the card a resized tier 2 is a new slab,
whose first search captures its step loops anew
(:mod:`repro_torch.core.step_graph`), so a timed probe set should follow
one untimed search.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import quant


@dataclasses.dataclass
class QueryTestStats:
    """Aggregates from one QUERY_TEST run at a candidate cache size."""

    n_db: float  # mean external accesses per query
    n_q: float  # mean query-path length |Q| per query
    t_query: float  # mean total query time (s)
    t_db: float  # mean time of a single external access (s)


@dataclasses.dataclass
class CacheOptStep:
    c: int
    theta: float
    stats: QueryTestStats
    accepted: bool


@dataclasses.dataclass
class CacheOptResult:
    c_best: int
    c0: int
    steps: List[CacheOptStep]
    # bytes one cached item occupies (set by the bytes-aware entry
    # point): lets callers compare optimized RESIDENT FOOTPRINTS across
    # precisions, not just item counts (DESIGN.md §7)
    bytes_per_item: Optional[int] = None

    @property
    def ladder(self) -> List[Tuple[int, float]]:
        """(C_i, θ_i) pairs of accepted sizes, descending C."""
        return [(s.c, s.theta) for s in self.steps if s.accepted]

    def saved_fraction(self) -> float:
        return 1.0 - self.c_best / max(self.c0, 1)

    @property
    def c_best_bytes(self) -> Optional[int]:
        if self.bytes_per_item is None:
            return None
        return self.c_best * self.bytes_per_item


def get_theta(
    p: float, t_theta: float, t_query: float, t_db: float
) -> float:
    """θ = min(p·T_query/t_db, T_θ/t_db) — both of the paper's methods."""
    if t_db <= 0:
        return float("inf")
    theta_pct = p * t_query / t_db
    theta_abs = t_theta / t_db
    return min(theta_pct, theta_abs)


def optimize_memory_size(
    query_test: Callable[[int], QueryTestStats],
    c0: int,
    p: float = 0.8,
    t_theta: float = 0.1,
    max_iters: int = 32,
) -> CacheOptResult:
    """Algorithm 2: OPTIMIZE_MEMORY_SIZE.

    ``query_test(C)`` must resize the cache to C items, run the probe
    query set, and return the aggregate stats.
    """
    c_best = c0
    c_test = c0
    steps: List[CacheOptStep] = []
    for _ in range(max_iters):
        if not (0 < c_test <= c0):
            break
        stats = query_test(c_test)
        theta = get_theta(p, t_theta, stats.t_query, stats.t_db)
        if stats.n_db > theta:
            steps.append(CacheOptStep(c_test, theta, stats, accepted=False))
            break  # over the threshold → C_best stands
        c_best = c_test
        steps.append(CacheOptStep(c_test, theta, stats, accepted=True))
        # secant through A = (1, n_Q): k = (n_Q - n_db) / (1 - C_test)
        denom = 1.0 - c_test
        if denom == 0:
            break
        k = (stats.n_q - stats.n_db) / denom
        if k >= 0:
            # curve is flat or rising toward small C measured as non-
            # increasing accesses — no constraint from θ; stop.
            break
        c_next = math.ceil((theta - stats.n_q) / k + 1)
        c_next = min(c_next, c_test - 1)  # guarantee progress
        if c_next < 1:
            c_next = 1
            if c_test == 1:
                break
        c_test = c_next
    return CacheOptResult(c_best=c_best, c0=c0, steps=steps)


def optimize_memory_bytes(
    query_test: Callable[[int], QueryTestStats],
    budget_bytes: int,
    dim: int,
    precision: str = "float32",
    p: float = 0.8,
    t_theta: float = 0.1,
    max_iters: int = 32,
    n_subspaces: Optional[int] = None,
) -> CacheOptResult:
    """Byte-budgeted Algorithm 2: precision is part of the cost model.

    The paper's optimizer counts ITEMS; at a fixed byte budget the item
    ceiling depends on bytes-per-vector, so quantization directly
    multiplies the search space the optimizer can exploit: ``C0 =
    budget_bytes / bytes_per_vector(dim, precision)`` (~4× more int8
    candidates than float32 under the same budget, dim/M × more for
    precision='pq' with M-byte codes). ``query_test`` still takes an
    item count — the returned result carries ``bytes_per_item`` so
    ladders from different precisions compare in bytes
    (``c_best_bytes``). ``n_subspaces`` only matters for
    precision='pq' (bytes/item = M).
    """
    bpi = quant.bytes_per_vector(dim, precision, n_subspaces=n_subspaces)
    c0 = quant.capacity_for_budget(
        budget_bytes, dim, precision, n_subspaces=n_subspaces
    )
    res = optimize_memory_size(
        query_test, c0, p=p, t_theta=t_theta, max_iters=max_iters
    )
    res.bytes_per_item = bpi
    return res


# ------------------------------------------- cross-tenant byte allocator
# (DESIGN.md §11) optimize_memory_bytes extended across tenants: each
# tenant's probe run yields its standalone optimum (the smallest cache
# meeting its θ) plus its (C, θ) ladder; a shared budget smaller than the
# sum of optima is then split by water-filling on the tenants' traffic
# weights, every allocation clamped to [floor, optimum].


@dataclasses.dataclass
class TenantDemand:
    """One tenant's input to the cross-tenant allocator.

    ``query_test(C)`` must resize THAT tenant's cache to C items, run
    its probe queries, and return aggregate :class:`QueryTestStats` —
    the same contract as :func:`optimize_memory_size`. ``traffic`` is
    the tenant's load estimate (QPS share, or observed query counts when
    re-running on live :class:`~repro_torch.core.store.AccessStats`); it sets
    the tenant's water-filling weight, NOT its θ — latency targets stay
    per-tenant, traffic only decides who wins contested bytes.
    """

    tenant: str
    query_test: Callable[[int], QueryTestStats]
    dim: int
    n_items: int
    precision: str = "float32"
    traffic: float = 1.0
    min_items: int = 1  # allocation floor (items)
    # PQ subspace count M (bytes/item = M when precision='pq'); ignored
    # for other precisions. None → quant.DEFAULT_PQ_SUBSPACES.
    n_subspaces: Optional[int] = None


@dataclasses.dataclass
class TenantAllocation:
    tenant: str
    c_items: int  # allocated cache capacity (items)
    alloc_bytes: int
    c_opt: int  # standalone optimum from the tenant's own probe run
    opt_bytes: int
    bytes_per_item: int
    traffic: float
    ladder: List[Tuple[int, float]]  # (C, θ) rollback ladder, desc. C
    satisfied: bool = True  # alloc >= standalone optimum


@dataclasses.dataclass
class CrossTenantAllocation:
    budget_bytes: int
    reserve_bytes: int  # withheld headroom the rollback path spends
    allocations: Dict[str, TenantAllocation]

    @property
    def total_alloc_bytes(self) -> int:
        return sum(a.alloc_bytes for a in self.allocations.values())

    @property
    def sum_opt_bytes(self) -> int:
        return sum(a.opt_bytes for a in self.allocations.values())

    @property
    def contended(self) -> bool:
        """True when the budget could not satisfy every tenant's
        standalone optimum — the regime water-filling exists for."""
        return any(not a.satisfied for a in self.allocations.values())

    def items(self) -> Dict[str, int]:
        return {t: a.c_items for t, a in self.allocations.items()}


def _round_to(c: int, grain: int) -> int:
    """Round an item count UP to the shape grain (bounded below by it).

    On the card every distinct cache capacity is a distinct set of CUDA
    graph captures of the step loops, keyed by the tier-2 slab's shape
    and pointer (:mod:`repro_torch.core.step_graph`), each with its own
    memory pool; snapping allocations to multiples of ``grain`` keeps
    the capacities a fleet moves through few, as the reference does for
    its jit traces. The uncontended branch of :func:`allocate_memory_bytes`
    rounds each share UP, as the reference does, so its total can pass
    the usable budget by up to ``grain`` items a tenant."""
    if grain <= 1:
        return max(1, c)
    return max(grain, int(math.ceil(c / grain)) * grain)


def _water_fill(
    demands: List[TenantDemand],
    opt_items: Dict[str, int],
    usable_bytes: int,
    grain: int,
) -> Dict[str, int]:
    """Split ``usable_bytes`` across tenants: alloc_t = clip(λ·w_t,
    floor_t, opt_t) in bytes, λ solved by bisection so the total fills
    the budget. Weights are traffic shares; floors and optima are per
    tenant. Returns item allocations."""
    bpi = {
        d.tenant: quant.bytes_per_vector(
            d.dim, d.precision, n_subspaces=d.n_subspaces
        )
        for d in demands
    }
    floor_b = {
        d.tenant: _round_to(d.min_items, grain) * bpi[d.tenant]
        for d in demands
    }
    opt_b = {
        d.tenant: _round_to(opt_items[d.tenant], grain) * bpi[d.tenant]
        for d in demands
    }
    w = {d.tenant: max(d.traffic, 1e-12) for d in demands}

    def total(lam: float) -> float:
        return sum(
            min(max(lam * w[d.tenant], floor_b[d.tenant]), opt_b[d.tenant])
            for d in demands
        )

    lo, hi = 0.0, 1.0
    while total(hi) < usable_bytes and hi < 1e18:
        hi *= 2.0
    for _ in range(80):  # bisection to byte precision
        mid = 0.5 * (lo + hi)
        if total(mid) < usable_bytes:
            lo = mid
        else:
            hi = mid
    lam = lo
    out: Dict[str, int] = {}
    for d in demands:
        b = min(max(lam * w[d.tenant], floor_b[d.tenant]), opt_b[d.tenant])
        # snap DOWN to the grain (floors already rounded up): rounding
        # up here could overshoot the budget by up to grain·bpi per
        # tenant whenever the water level lands mid-grain
        floor_c = _round_to(d.min_items, grain)
        c = int(b // bpi[d.tenant])
        if grain > 1:
            c = (c // grain) * grain
        out[d.tenant] = min(max(floor_c, c), d.n_items)
    return out


def allocate_memory_bytes(
    demands: List[TenantDemand],
    budget_bytes: int,
    p: float = 0.8,
    t_theta: float = 0.1,
    max_iters: int = 8,
    reserve_frac: float = 0.1,
    shape_grain: int = 64,
) -> CrossTenantAllocation:
    """Cross-tenant ``optimize_memory_bytes``: one shared byte budget,
    many tenants, water-filling on traffic (DESIGN.md §11).

    Per tenant, Algorithm 2 runs against its OWN probe set (capped at
    the whole budget's capacity for its precision) yielding the
    standalone optimum ``c_opt`` and a (C, θ) ladder. Then:

    - budget ≥ Σ optima: every tenant gets its optimum; the surplus
      (minus the rollback reserve) is granted proportionally to traffic,
      capped at each tenant's corpus size.
    - budget < Σ optima (the contended regime): water-filling — alloc_t
      = clip(λ·traffic_t, floor_t, opt_t), λ solved so allocations fill
      ``(1 - reserve_frac) · budget``.

    ``reserve_frac`` of the budget is withheld as rollback headroom: a
    tenant whose live n_db regresses past its ladder's θ climbs back
    toward a bigger size by SPENDING reserve, never by evicting a
    peer below its floor (the isolation contract tests assert).

    Each tenant's ladder is re-anchored at its allocation: rungs from
    its probe run above the allocated size survive (they are the sizes
    rollback may climb to), and the allocation itself becomes the
    bottom rung, inheriting θ from the nearest probed size below it.
    """
    if budget_bytes <= 0:
        raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
    names = [d.tenant for d in demands]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenants in demands: {names}")

    reserve = int(budget_bytes * reserve_frac)
    usable = budget_bytes - reserve

    probe: Dict[str, CacheOptResult] = {}
    for d in demands:
        c0 = min(
            d.n_items,
            max(
                1,
                quant.capacity_for_budget(
                    usable, d.dim, d.precision, n_subspaces=d.n_subspaces
                ),
            ),
        )
        probe[d.tenant] = optimize_memory_bytes(
            d.query_test,
            c0
            * quant.bytes_per_vector(
                d.dim, d.precision, n_subspaces=d.n_subspaces
            ),
            d.dim,
            precision=d.precision,
            p=p,
            t_theta=t_theta,
            max_iters=max_iters,
            n_subspaces=d.n_subspaces,
        )
    opt_items = {t: r.c_best for t, r in probe.items()}
    bpi = {
        d.tenant: quant.bytes_per_vector(
            d.dim, d.precision, n_subspaces=d.n_subspaces
        )
        for d in demands
    }
    sum_opt = sum(
        _round_to(opt_items[d.tenant], shape_grain) * bpi[d.tenant]
        for d in demands
    )

    if sum_opt <= usable:
        # uncontended: optima + traffic-proportional surplus
        surplus = usable - sum_opt
        w_tot = sum(max(d.traffic, 1e-12) for d in demands)
        alloc_items: Dict[str, int] = {}
        for d in demands:
            extra_b = surplus * (max(d.traffic, 1e-12) / w_tot)
            c = _round_to(opt_items[d.tenant], shape_grain) + int(
                extra_b // bpi[d.tenant]
            )
            alloc_items[d.tenant] = min(
                _round_to(c, shape_grain), d.n_items
            )
    else:
        alloc_items = _water_fill(demands, opt_items, usable, shape_grain)

    allocations: Dict[str, TenantAllocation] = {}
    for d in demands:
        c_alloc = alloc_items[d.tenant]
        res = probe[d.tenant]
        # rollback ladder: probed rungs strictly above the allocation,
        # then the allocation itself as the operating rung. θ for the
        # bottom rung comes from the deepest probe at or below c_alloc
        # (pessimistic: the nearest measured θ), falling back to the
        # last accepted step.
        accepted = res.ladder  # (C, θ) descending C
        rungs = [(c, th) for c, th in accepted if c > c_alloc]
        theta_alloc = accepted[-1][1] if accepted else float("inf")
        for c, th in accepted:
            if c <= c_alloc:
                theta_alloc = th
                break
        rungs.append((c_alloc, theta_alloc))
        allocations[d.tenant] = TenantAllocation(
            tenant=d.tenant,
            c_items=c_alloc,
            alloc_bytes=c_alloc * bpi[d.tenant],
            c_opt=opt_items[d.tenant],
            opt_bytes=opt_items[d.tenant] * bpi[d.tenant],
            bytes_per_item=bpi[d.tenant],
            traffic=d.traffic,
            ladder=rungs,
            satisfied=c_alloc >= opt_items[d.tenant],
        )
    return CrossTenantAllocation(
        budget_bytes=budget_bytes,
        reserve_bytes=reserve,
        allocations=allocations,
    )


class RollbackManager:
    """Paper §3.4 'Rollback of memory size'.

    Tracks the accepted ladder {(C_0, θ_0), (C_1, θ_1), ...} (descending
    C). ``observe`` is called with each live query's n_db; if it exceeds
    the current θ, memory rolls back one rung (toward C_0).
    """

    def __init__(
        self, ladder: List[Tuple[int, float]], resize: Callable[[int], None]
    ):
        if not ladder:
            raise ValueError("empty ladder")
        self.ladder = list(ladder)  # index 0 = C_0 (largest)
        self.resize = resize
        self.idx = len(self.ladder) - 1  # start at the optimized size

    @property
    def current(self) -> Tuple[int, float]:
        return self.ladder[self.idx]

    def observe(self, n_db: float) -> bool:
        """Returns True if a rollback happened."""
        _, theta = self.current
        if n_db > theta and self.idx > 0:
            self.idx -= 1
            self.resize(self.ladder[self.idx][0])
            return True
        return False


# ----------------------------------------------------- closed-form curves


def n_db_random(n_mem: float, n_q: float, n: float) -> float:
    """Eq. 3: random fetching — n_db linear in n_mem."""
    if n_mem >= n:
        return 1.0
    return (1.0 - n_q) / (n - 1.0) * n_mem + (n * n_q - 1.0) / (n - 1.0)


def n_db_optimal(n_mem: float, n_q: float) -> float:
    """Eq. 4: optimal fetching — n_db = ceil(|Q| / n_mem)."""
    if n_mem >= n_q:
        return 1.0
    return float(math.ceil(n_q / n_mem))


def simulate_n_db(
    path: np.ndarray,
    n_items: int,
    n_mem: int,
    strategy: str = "random",
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Simulate external accesses along a query path under a fetch strategy.

    'random'  — the proof model behind Eq. 3: on a miss of D_i, one access
                loads D_i plus (n_mem - 1) uniformly random items, replacing
                the cache contents wholesale.
    'optimal' — the proof model behind Eq. 4: on a miss at position i, one
                access loads the next n_mem items of the path.
    'lazy'    — WebANNS per-phase batching upper bound for a linear path:
                misses accumulate to at most ``ef`` before one access; here
                approximated as optimal (the engine itself is measured in
                the integration tests, not simulated).
    """
    rng = rng or np.random.default_rng(0)
    path = np.asarray(path)
    if n_mem >= n_items and strategy == "random":
        return 1
    n_db = 0
    if strategy == "random":
        cache: set = set()
        for x in path:
            if int(x) not in cache:
                n_db += 1
                fill = rng.choice(n_items, size=min(n_mem, n_items) - 1,
                                  replace=False)
                cache = set(fill.tolist())
                cache.add(int(x))
        return n_db
    if strategy in ("optimal", "lazy"):
        i = 0
        cache = set()
        while i < len(path):
            if int(path[i]) in cache:
                i += 1
                continue
            n_db += 1
            cache = set(int(v) for v in path[i : i + n_mem])
            i += 1
        return n_db
    raise ValueError(strategy)
