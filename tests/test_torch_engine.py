"""Port engine against the JAX engine on the same graph and queries.

The graph is built once by the reference (the ``small_graph`` fixture,
N = 800, d = 24) and carried across with ``convert.from_reference``. For
each engine mode and eviction policy both engines serve the same
requests from a cold 25% tier 2 (``cache_capacity = N // 4``, l2):

- ids equal and distances within rtol 1e-5 (the two packages sum in
  another order);
- per-query ``n_db``, ``items_fetched``, ``n_hops``, ``n_dist`` equal,
  the ``BatchStats`` equal, and the tier-3 counters and final tier-2
  maps equal (the access accounting is integer and must be exact);
- within the port, the loop and the batched drivers give identical bits.
"""

import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro_torch import convert
from repro_torch.core import engine as P

MODES = ["webanns", "webanns-base"]
EVICTIONS = ["fifo", "lru"]
COMBOS = [(m, e) for m in MODES for e in EVICTIONS]
K, EF = 10, 32
STAT_FIELDS = ("n_db", "items_fetched", "n_hops", "n_dist", "n_visited")
BATCH_FIELDS = ("batch_size", "n_db", "items_fetched", "n_phases")


def _queries(small_dataset):
    X, Q = small_dataset
    rng = np.random.default_rng(5)
    near = X[rng.choice(len(X), 3)] + 0.05 * rng.standard_normal(
        (3, X.shape[1])).astype(np.float32)
    return np.concatenate([Q[:5], near]).astype(np.float32)  # (8, d)


def _engines(small_dataset, small_graph, mode, eviction):
    X, _ = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    kw = dict(mode=mode, eviction=eviction, cache_capacity=len(X) // 4,
              metric="l2")
    return (R.WebANNSEngine(X, g, R.EngineConfig(**kw)),
            P.WebANNSEngine(table, graph, P.EngineConfig(device="cpu", **kw)))


def _run(eng, requests):
    req = P.SearchRequest if isinstance(eng, P.WebANNSEngine) else \
        R.SearchRequest
    return [eng.search(req(query=q, k=K, ef=EF, batch_mode=mode))
            for q, mode in requests]


@pytest.fixture(scope="module")
def results(small_dataset, small_graph):
    """Both engines' results for one combination, computed once each.

    Engine A serves a batch in ``batched`` mode, then a single query on
    the warm cache; engine B serves the same batch in ``loop`` mode."""
    Q = _queries(small_dataset)
    done = {}

    def get(mode, eviction):
        if (mode, eviction) not in done:
            out = {}
            for name, requests in (
                ("batched", [(Q, "batched"), (Q[2] + 0.01, "batched")]),
                ("loop", [(Q, "loop")]),
            ):
                ref, port = _engines(small_dataset, small_graph, mode,
                                     eviction)
                out[name] = (_run(ref, requests), _run(port, requests),
                             ref, port)
            # a cold 25% tier 2: the runs really load from tier 3
            assert out["loop"][2].access_stats.n_db > 0
            done[(mode, eviction)] = out
        return done[(mode, eviction)]

    return get


def _stats_list(res):
    return res.stats if isinstance(res.stats, list) else [res.stats]


@pytest.mark.parametrize("driver", ["batched", "loop"])
@pytest.mark.parametrize("mode,eviction", COMBOS)
def test_results_match_reference(results, mode, eviction, driver):
    want, got, _, _ = results(mode, eviction)[driver]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        np.testing.assert_allclose(g.dists, np.asarray(w.dists), rtol=1e-5)
        assert g.ids.shape == np.asarray(w.ids).shape


@pytest.mark.parametrize("driver", ["batched", "loop"])
@pytest.mark.parametrize("mode,eviction", COMBOS)
def test_access_counts_match_reference(results, mode, eviction, driver):
    want, got, ref, port = results(mode, eviction)[driver]
    for w, g in zip(want, got):
        for ws, gs in zip(_stats_list(w), _stats_list(g)):
            for f in STAT_FIELDS:
                assert getattr(gs, f) == getattr(ws, f), f
        if w.batch_stats is not None:
            for f in BATCH_FIELDS:
                assert getattr(g.batch_stats, f) == \
                    getattr(w.batch_stats, f), f
    for f in ("n_db", "items_fetched", "items_used"):
        assert getattr(port.access_stats, f) == getattr(ref.access_stats, f)
    # tier 2 ended in the same state: the LRU clock and stamps did not drift
    for name in ("slot_of", "id_of", "last_used"):
        np.testing.assert_array_equal(
            getattr(port.store.cache, name).numpy(),
            np.asarray(getattr(ref.store.cache, name)), err_msg=name)
    assert int(port.store.cache.clock) == int(ref.store.cache.clock)


@pytest.mark.parametrize("mode,eviction", COMBOS)
def test_port_loop_equals_port_batched(results, mode, eviction):
    res = results(mode, eviction)
    batched, loop = res["batched"][1][0], res["loop"][1][0]
    np.testing.assert_array_equal(loop.ids, batched.ids)
    np.testing.assert_array_equal(loop.dists, batched.dists)
    # the batched driver shares its tier-3 accesses
    assert batched.batch_stats.n_db <= loop.batch_stats.n_db


def test_warm_cache_and_resize(small_dataset, small_graph):
    ref, port = _engines(small_dataset, small_graph, "webanns", "fifo")
    for eng in (ref, port):
        eng.warm_cache()
    assert port.cache_bytes() == ref.cache_bytes()
    Q = _queries(small_dataset)
    w = ref.search(R.SearchRequest(query=Q[0], k=K, ef=EF))
    g = port.search(P.SearchRequest(query=Q[0], k=K, ef=EF))
    np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
    assert g.stats.n_db == w.stats.n_db
    for eng in (ref, port):
        eng.resize_cache(100, warm=True)
    assert port.cache_bytes() == ref.cache_bytes() == 100 * 24 * 4
    assert port.access_stats.n_db == ref.access_stats.n_db


def test_in_memory_oracle_matches_lazy(small_dataset, small_graph):
    """The full-cache search (memory-data ratio 100%) returns what the
    lazy engine returns from a cold cache."""
    from repro_torch.core import search as S

    X, _ = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    port = P.WebANNSEngine(table, graph, P.EngineConfig(
        device="cpu", cache_capacity=len(X) // 4))
    for q in _queries(small_dataset)[:4]:
        d, i = S.knn_search_inmem(
            torch.from_numpy(q), torch.from_numpy(table),
            torch.from_numpy(graph.neighbors), graph.entry_point,
            graph.max_level, K, EF)
        res = port.search(P.SearchRequest(query=q, k=K, ef=EF))
        np.testing.assert_array_equal(res.ids, i.numpy())
        np.testing.assert_array_equal(res.dists, d.numpy())


def test_unported_features_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.EngineConfig(device="cpu", precision="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.EngineConfig(device="cpu", fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.EngineConfig(device="cpu", n_shards=2)
