"""The port's cache-size optimizer against ``repro.core.cache_opt``.

Every function of the module is host Python or NumPy over the numbers a
``query_test`` callback returns, so the same inputs must give the same
values in both packages, compared exactly:

- the Eq. 3–4 curves and ``simulate_n_db`` (the same seeded draws);
- ``get_theta`` and Algorithm 2 (``optimize_memory_size``) on synthetic
  fetch curves, with the reference tests' own assertions held on the
  port too, and the hypothesis property over both;
- ``optimize_memory_bytes`` at float32, float16, int8 and pq;
- the cross-tenant allocator (``_round_to``, ``_water_fill``,
  ``allocate_memory_bytes``) in the uncontended and contended regimes;
- ``RollbackManager``;
- end to end: Algorithm 2 driving the port's ``WebANNSEngine`` on the
  CPU and the reference's engine on one graph, through a ``query_test``
  whose ``t_query`` is computed from the search's counts alone. No test
  here reads a clock: a timed ``t_query`` moves θ and so the ladder.
"""

import dataclasses

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cache_opt as R  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cache_opt as P  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core import quant  # noqa: E402

PACKAGES = (R, P)


def _as_tuple(res):
    """A CacheOptResult as plain values (the two packages' dataclasses
    are different classes)."""
    return (res.c_best, res.c0, res.bytes_per_item, res.c_best_bytes,
            res.saved_fraction(), res.ladder,
            [(s.c, s.theta, s.accepted, dataclasses.astuple(s.stats))
             for s in res.steps])


def _synthetic(mod, n, n_q, t_in=1e-4, t_db=1e-2, mix=0.5, probed=None):
    """A query_test of ``mod``'s QueryTestStats on a fetch curve ``mix``
    of the way from Eq. 4's hyperbola to Eq. 3's line."""

    def query_test(c):
        if probed is not None:
            probed.append(c)
        ndb = ((1 - mix) * mod.n_db_optimal(c, n_q)
               + mix * mod.n_db_random(c, n_q, n))
        return mod.QueryTestStats(n_db=ndb, n_q=n_q,
                                  t_query=n_q * t_in + ndb * t_db, t_db=t_db)

    return query_test


# ------------------------------------------------------- Eq. 3–4 curves


@pytest.mark.parametrize("n_mem", [1, 50, 150, 300, 450, 499, 500, 800])
def test_eq3_eq4_curves_equal(n_mem):
    n, n_q = 500, 80
    assert P.n_db_random(n_mem, n_q, n) == R.n_db_random(n_mem, n_q, n)
    assert P.n_db_optimal(n_mem, n_q) == R.n_db_optimal(n_mem, n_q)


def test_eq3_random_fetch_closed_form():
    """Empirical n_db under the random-fetch model ≈ Eq. 3 (±7%), the
    same draws in both packages."""
    rng = np.random.default_rng(0)
    n, n_q = 500, 80
    path = rng.choice(n, n_q, replace=False)
    for n_mem in (50, 150, 300, 450):
        trials = {}
        for mod in PACKAGES:
            trials[mod] = [
                mod.simulate_n_db(path, n, n_mem, "random",
                                  np.random.default_rng(s))
                for s in range(30)
            ]
        assert trials[P] == trials[R]
        emp = float(np.mean(trials[P]))
        pred = P.n_db_random(n_mem, n_q, n)
        assert abs(emp - pred) / pred < 0.07, (n_mem, emp, pred)


def test_eq4_optimal_fetch_closed_form():
    """Optimal prefetch matches Eq. 4 exactly for a distinct-item path."""
    n, n_q = 500, 96
    path = np.arange(n_q)
    for n_mem in (7, 16, 32, 48, 96, 200):
        emp = P.simulate_n_db(path, n, n_mem, "optimal")
        assert emp == R.simulate_n_db(path, n, n_mem, "optimal")
        assert emp == P.n_db_optimal(n_mem, n_q), (n_mem, emp)


@pytest.mark.parametrize("strategy", ["random", "optimal", "lazy"])
@pytest.mark.parametrize("n_mem", [1, 50, 200, 1000])
def test_simulate_n_db_equal(strategy, n_mem):
    rng = np.random.default_rng(3)
    path = rng.choice(1000, 120)  # repeats included
    got = P.simulate_n_db(path, 1000, n_mem, strategy,
                          np.random.default_rng(9))
    want = R.simulate_n_db(path, 1000, n_mem, strategy,
                           np.random.default_rng(9))
    assert got == want


def test_simulate_n_db_rejects_unknown_strategy():
    for mod in PACKAGES:
        with pytest.raises(ValueError):
            mod.simulate_n_db(np.arange(4), 10, 2, "belady")


def test_random_worse_than_optimal():
    rng = np.random.default_rng(1)
    path = rng.choice(1000, 100, replace=False)
    for n_mem in (50, 200, 500):
        r = P.simulate_n_db(path, 1000, n_mem, "random")
        o = P.simulate_n_db(path, 1000, n_mem, "optimal")
        assert (r, o) == (R.simulate_n_db(path, 1000, n_mem, "random"),
                          R.simulate_n_db(path, 1000, n_mem, "optimal"))
        assert o <= r


# ------------------------------------------------------------ Algorithm 2


@pytest.mark.parametrize("args", [(0.5, 10.0, 1.0, 0.01),
                                  (0.9, 0.05, 1.0, 0.01),
                                  (0.8, 0.1, 0.033, 1.128e-3),
                                  (0.8, 0.1, 1.0, 0.0),
                                  (0.8, 0.1, 1.0, -1.0)])
def test_get_theta_equal(args):
    assert P.get_theta(*args) == R.get_theta(*args)


def test_get_theta_combines_both_methods():
    # percentage binds
    assert P.get_theta(0.5, 10.0, 1.0, 0.01) == pytest.approx(50.0)
    # absolute binds
    assert P.get_theta(0.9, 0.05, 1.0, 0.01) == pytest.approx(5.0)


@pytest.mark.parametrize("mix", [0.0, 0.25, 0.5, 0.75, 1.0])
def test_algorithm2_on_synthetic_curve(mix):
    """Algorithm 2 against a synthetic fetch curve between the random
    line and the optimal hyperbola: both packages probe the same sizes
    and return the same result; it stops at a C where n_db <= θ, and the
    probes strictly decrease."""
    n, n_q = 1000, 120
    out = {}
    for mod in PACKAGES:
        probed = []
        res = mod.optimize_memory_size(
            _synthetic(mod, n, n_q, mix=mix, probed=probed), c0=n, p=0.8,
            t_theta=0.5)
        out[mod] = (_as_tuple(res), probed, res)
    assert out[P][:2] == out[R][:2]
    res, probed = out[P][2], out[P][1]
    assert res.c_best < n  # it did shrink
    best = [s for s in res.steps if s.c == res.c_best][0]
    assert best.stats.n_db <= best.theta
    assert all(a > b for a, b in zip(probed, probed[1:]))


def test_algorithm2_keeps_c0_when_already_over():
    out = []
    for mod in PACKAGES:
        res = mod.optimize_memory_size(
            lambda c, mod=mod: mod.QueryTestStats(n_db=1000.0, n_q=10,
                                                  t_query=1.0, t_db=0.01),
            c0=100, p=0.1, t_theta=0.01)
        out.append(_as_tuple(res))
        assert res.c_best == 100
        assert len(res.ladder) == 0 or res.ladder[0][0] == 100
    assert out[0] == out[1]


@pytest.mark.parametrize("max_iters", [1, 2, 5])
def test_algorithm2_max_iters_equal(max_iters):
    got, want = (_as_tuple(mod.optimize_memory_size(
        _synthetic(mod, 600, 90, t_in=1e-3), c0=600, max_iters=max_iters))
        for mod in (P, R))
    assert got == want
    assert len(got[-1]) <= max_iters


def test_algorithm2_flat_curve_stops():
    """A curve that does not rise as C shrinks (k >= 0) stops after the
    first step in both packages."""
    out = [_as_tuple(mod.optimize_memory_size(
        lambda c, mod=mod: mod.QueryTestStats(n_db=5.0, n_q=5.0,
                                              t_query=1.0, t_db=0.01),
        c0=50)) for mod in PACKAGES]
    assert out[0] == out[1]
    assert len(out[0][-1]) == 1


@settings(max_examples=20, deadline=None)
@given(
    n=st.integers(200, 2000),
    n_q=st.integers(10, 150),
    p=st.floats(0.1, 0.95),
)
def test_property_algorithm2_always_terminates_and_safe(n, n_q, p):
    n_q = min(n_q, n)
    out = {}
    for mod in PACKAGES:
        res = mod.optimize_memory_size(
            _synthetic(mod, n, n_q, t_in=1e-4, t_db=1e-2, mix=1.0),
            c0=n, p=p, t_theta=0.2)
        out[mod] = (_as_tuple(res), res)
    assert out[P][0] == out[R][0]
    res = out[P][1]
    assert 1 <= res.c_best <= n
    for step in res.steps:  # accepted sizes satisfy their own θ
        if step.accepted:
            assert step.stats.n_db <= step.theta + 1e-9


# ------------------------------------------------ byte-budgeted Algorithm 2


@pytest.mark.parametrize("precision,n_subspaces", [
    ("float32", None), ("float16", None), ("int8", None), ("pq", None),
    ("pq", 192), ("fp16", None)])
def test_optimize_memory_bytes_equal(precision, n_subspaces):
    """The byte-budgeted entry: C0 from the budget at the precision's
    bytes a row, the same ladder, and ``c_best_bytes`` in bytes."""
    dim, budget = 96, 600_000
    out = {}
    for mod in PACKAGES:
        res = mod.optimize_memory_bytes(
            _synthetic(mod, 20_000, 150, t_in=1e-3), budget, dim,
            precision=precision, n_subspaces=n_subspaces)
        out[mod] = _as_tuple(res)
        assert res.c0 == quant.capacity_for_budget(
            budget, dim, precision, n_subspaces=n_subspaces)
        bpi = quant.bytes_per_vector(dim, precision, n_subspaces=n_subspaces)
        assert res.bytes_per_item == bpi
        assert res.c_best_bytes == res.c_best * bpi
    assert out[P] == out[R]


def test_optimize_memory_bytes_int8_holds_more_than_float32():
    """At one budget int8's item ceiling is ~4× float32's (d + 4 bytes a
    row against 4d)."""
    c0 = {p: P.optimize_memory_bytes(
        _synthetic(P, 50_000, 100), 1_000_000, 768, precision=p,
        max_iters=1).c0 for p in ("float32", "int8")}
    assert c0 == {"float32": 1_000_000 // 3072, "int8": 1_000_000 // 772}


# ------------------------------------------------- cross-tenant allocator


@pytest.mark.parametrize("c,grain", [(0, 64), (1, 64), (63, 64), (64, 64),
                                     (65, 64), (1000, 1), (0, 1), (7, 0)])
def test_round_to_equal(c, grain):
    assert P._round_to(c, grain) == R._round_to(c, grain)


def _demands(mod, specs):
    """TenantDemands of ``mod`` over deterministic synthetic curves:
    ``specs`` rows are (tenant, precision, n_items, traffic, dim)."""
    return [mod.TenantDemand(
        tenant=name, query_test=_synthetic(mod, n, 150, t_in=1e-3,
                                           mix=0.3 + 0.1 * i),
        dim=dim, n_items=n, precision=prec, traffic=traffic,
        n_subspaces=16 if prec == "pq" else None)
        for i, (name, prec, n, traffic, dim) in enumerate(specs)]


SPECS = [("a", "float32", 4000, 1.0, 64), ("b", "int8", 6000, 3.0, 64),
         ("c", "pq", 9000, 0.5, 64)]


def _alloc_tuple(alloc):
    return (alloc.budget_bytes, alloc.reserve_bytes, alloc.total_alloc_bytes,
            alloc.sum_opt_bytes, alloc.contended, alloc.items(),
            {t: dataclasses.asdict(a) for t, a in alloc.allocations.items()})


@pytest.mark.parametrize("budget,contended", [(200_000_000, False),
                                              (2_000_000, False),
                                              (600_000, True),
                                              (150_000, True)])
def test_allocate_memory_bytes_equal(budget, contended):
    """Both regimes: with room for every optimum each tenant gets its
    optimum and a traffic share of the surplus; below the sum of optima
    the water-filling split, each tenant within [floor, optimum] (the
    optimum rounded up to the grain, as the allocator clamps it) and the
    total within the usable budget."""
    out = {mod: mod.allocate_memory_bytes(_demands(mod, SPECS), budget)
           for mod in PACKAGES}
    assert _alloc_tuple(out[P]) == _alloc_tuple(out[R])
    alloc = out[P]
    assert alloc.contended == contended
    usable = budget - alloc.reserve_bytes
    for a in alloc.allocations.values():
        assert P._round_to(1, 64) <= a.c_items
        if contended:
            assert a.c_items <= P._round_to(a.c_opt, 64)
        else:
            assert a.c_items >= a.c_opt
        assert a.ladder[-1][0] == a.c_items
    if contended:
        assert alloc.total_alloc_bytes <= usable


def test_water_fill_equal():
    demands = {mod: _demands(mod, SPECS) for mod in PACKAGES}
    opt = {"a": 3000, "b": 5000, "c": 7000}
    for usable in (10_000, 300_000, 700_000):
        for grain in (1, 64):
            assert (P._water_fill(demands[P], opt, usable, grain)
                    == R._water_fill(demands[R], opt, usable, grain))


@pytest.mark.parametrize("bad", ["budget", "duplicate"])
def test_allocate_memory_bytes_rejects_bad_input(bad):
    for mod in PACKAGES:
        specs = SPECS[:1] * 2 if bad == "duplicate" else SPECS
        budget = 0 if bad == "budget" else 1_000_000
        with pytest.raises(ValueError):
            mod.allocate_memory_bytes(_demands(mod, specs), budget)


# ---------------------------------------------------------------- rollback


def test_rollback_manager():
    ladder = [(100, 50.0), (60, 40.0), (30, 20.0)]
    trace = {}
    for mod in PACKAGES:
        sizes = []
        rm = mod.RollbackManager(ladder, resize=sizes.append)
        seen = [rm.current]
        assert rm.current == (30, 20.0)
        for n_db in (10.0, 25.0, 45.0, 1e9):
            seen.append((rm.observe(n_db), rm.current))
        trace[mod] = (seen, sizes)
        assert sizes == [60, 100]
    assert trace[P] == trace[R]
    assert trace[P][0][1:] == [(False, (30, 20.0)), (True, (60, 40.0)),
                               (True, (100, 50.0)), (False, (100, 50.0))]


def test_rollback_manager_rejects_empty_ladder():
    for mod in PACKAGES:
        with pytest.raises(ValueError):
            mod.RollbackManager([], resize=lambda c: None)


# ------------------------------------------------------------- end to end

# the count-only latency model of the probes: T_IN seconds an item visited
# plus the modeled tier-3 time (Eq. 2), so θ depends on counts, not clocks
T_IN = 1e-4
K, EF, N_PROBES = 10, 48, 4


def count_query_test(eng, request, Q, t_db):
    """Resize and warm ``eng``, serve ``Q`` one query at a time, and
    return the means Algorithm 2 reads, ``t_query`` from the counts. Also
    records each step's per-query ids and ``n_db``."""
    mod = P if isinstance(eng, PE.WebANNSEngine) else R
    seen = []

    def query_test(c):
        eng.resize_cache(c)
        eng.warm_cache()
        res = [eng.search(request(query=q, k=K, ef=EF)) for q in Q]
        seen.append((c, [r.ids.tolist() for r in res],
                     [r.stats.n_db for r in res]))
        n_db = float(np.mean([r.stats.n_db for r in res]))
        n_q = float(np.mean([r.stats.n_visited for r in res]))
        return mod.QueryTestStats(n_db=n_db, n_q=n_q,
                                  t_query=n_q * T_IN + n_db * t_db, t_db=t_db)

    return query_test, seen


@pytest.mark.parametrize("mode,t_theta,max_iters", [
    ("webanns", 0.1, 3), ("webanns-base", 0.03, 32)])
def test_algorithm2_end_to_end_on_engine(small_dataset, small_graph, mode,
                                         t_theta, max_iters):
    """Algorithm 2 shrinks both engines' tier 2 on the same graph and
    probes: the same ladder (C, n_db, n_q, θ, accepted), the same c_best
    and the same ids at every step. The lazy engine's accesses stay far
    under θ, so its ladder is cut at three steps; the eager one
    (webanns-base) meets θ within a few."""
    X, Q = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    kw = dict(mode=mode, cache_capacity=len(X))
    engines = {R: RE.WebANNSEngine(X, g, RE.EngineConfig(**kw)),
               P: PE.WebANNSEngine(table, graph,
                                   PE.EngineConfig(device="cpu", **kw))}
    requests = {R: RE.SearchRequest, P: PE.SearchRequest}
    out = {}
    for mod, eng in engines.items():
        t_db = eng.external.access_cost(16)
        qt, seen = count_query_test(eng, requests[mod], Q[:N_PROBES], t_db)
        res = mod.optimize_memory_size(qt, c0=len(X), p=0.8,
                                       t_theta=t_theta, max_iters=max_iters)
        out[mod] = (_as_tuple(res), seen, res)
    assert out[P][0] == out[R][0]
    assert out[P][1] == out[R][1]
    res = out[P][2]
    assert 1 <= res.c_best < len(X)  # a warm full tier 2 needs no access
    assert res.steps[0].stats.n_db == 0
    assert len(res.steps) >= 2
    for step in res.steps:
        assert step.accepted == (step.stats.n_db <= step.theta)
    if mode == "webanns-base":
        assert not res.steps[-1].accepted  # it met θ


def test_engine_resize_hooks_match_reference(small_dataset, small_graph):
    """``resize_cache`` (with and without ``warm``), ``resize_cache_bytes``
    and ``warm_cache`` leave the port's engine in the reference's state:
    the same capacity, tier 2 and bytes, and the same ``n_db`` on the next
    search."""
    X, Q = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    for precision in ("float32", "int8"):
        kw = dict(cache_capacity=len(X), precision=precision)
        ref = RE.WebANNSEngine(X, g, RE.EngineConfig(**kw))
        port = PE.WebANNSEngine(table, graph,
                                PE.EngineConfig(device="cpu", **kw))
        for step in ("resize", "resize_warm", "bytes", "bytes_warm"):
            if step.startswith("resize"):
                for eng in (ref, port):
                    eng.resize_cache(300, warm=step.endswith("warm"))
            else:
                caps = [eng.resize_cache_bytes(200 * 4 * X.shape[1],
                                               warm=step.endswith("warm"))
                        for eng in (ref, port)]
                assert caps[0] == caps[1]
            assert ref.store.capacity == port.store.capacity
            assert ref.cache_bytes() == port.cache_bytes()
            want = np.asarray(ref.store.cache.id_of)
            assert np.array_equal(
                convert.cache_to_numpy(port.store.cache)["id_of"], want)
            a = ref.search(RE.SearchRequest(query=Q[0], k=K, ef=EF))
            b = port.search(PE.SearchRequest(query=Q[0], k=K, ef=EF))
            assert a.stats.n_db == b.stats.n_db
            assert np.array_equal(a.ids, b.ids)
