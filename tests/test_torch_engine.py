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
from repro_torch.core import quant

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
    # pq is ported (tests/test_torch_pq.py); with shards it is refused
    # as the reference refuses it. Persistence, mutation and filters are
    # ported (tests/test_torch_persistence*.py, test_torch_mutation.py,
    # test_torch_filtered_search.py); the sharded driver is not
    assert P.EngineConfig(device="cpu", precision="pq8").precision == "pq"
    with pytest.raises(ValueError):
        P.EngineConfig(device="cpu", precision="pq", n_shards=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.EngineConfig(device="cpu", n_shards=2)


# ----------------------------------------------- quantized tier 2 + rerank
#
# Both engines start from ONE quantized tier 2: the reference's, partly
# warmed and carried across with convert.cache_from_reference. After each
# search the whole tier-2 state (slab and scales included) must be equal
# bit for bit, the access counts exact, and the returned distances equal:
# both packages rerank on the host in the same numpy.

QUANT = ["float16", "int8"]
DRIVERS = ["single", "loop", "batched"]


def _qpair(small_dataset, small_graph, precision, eviction, **extra):
    X, _ = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    kw = dict(eviction=eviction, cache_capacity=len(X) // 4, metric="l2",
              precision=precision)
    kw.update(extra)
    ref = R.WebANNSEngine(X, g, R.EngineConfig(**kw))
    port = P.WebANNSEngine(table, graph, P.EngineConfig(device="cpu", **kw))
    ref.warm_cache(np.arange(0, len(X), 9)[: len(X) // 8])
    c = ref.store.cache
    port.store.cache = convert.cache_from_reference(
        *(np.asarray(getattr(c, f)) for f in convert.CACHE_FIELDS),
        device="cpu")
    return ref, port


def _tier2(eng):
    if isinstance(eng, P.WebANNSEngine):
        return convert.cache_to_numpy(eng.store.cache)
    return {f: np.asarray(getattr(eng.store.cache, f))
            for f in convert.CACHE_FIELDS}


def _serve(ref, port, requests):
    """Both engines serve ``requests``; after each, the results and the
    two tier-2 states."""
    out = []
    for q, mode in requests:
        w = ref.search(R.SearchRequest(query=q, k=K, ef=EF, batch_mode=mode))
        g = port.search(P.SearchRequest(query=q, k=K, ef=EF,
                                        batch_mode=mode))
        out.append((w, g, _tier2(ref), _tier2(port)))
    return out


def _driver_requests(Q, driver):
    if driver == "single":
        return [(q, "batched") for q in Q[:4]]
    if driver == "loop":
        return [(Q, "loop")]
    return [(Q, "batched"), (Q[2:6] + 0.01, "batched")]


@pytest.fixture(scope="module")
def quant_results(small_dataset, small_graph):
    done = {}

    def get(precision, eviction, driver):
        key = (precision, eviction, driver)
        if key not in done:
            ref, port = _qpair(small_dataset, small_graph, precision,
                               eviction)
            served = _serve(ref, port, _driver_requests(
                _queries(small_dataset), driver))
            assert ref.access_stats.n_db > 1  # loads and reranks happened
            done[key] = (served, ref, port)
        return done[key]

    return get


def _assert_same_tier2(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


QCOMBOS = [(p, e, d) for p in QUANT for e in EVICTIONS for d in DRIVERS]


@pytest.mark.parametrize("precision,eviction,driver", QCOMBOS)
def test_quantized_results_match_reference(quant_results, precision,
                                           eviction, driver):
    served, _, _ = quant_results(precision, eviction, driver)
    for w, g, _, _ in served:
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        # the rerank is the same numpy on the same tier-3 rows: exact
        np.testing.assert_array_equal(g.dists, np.asarray(w.dists))


@pytest.mark.parametrize("precision,eviction,driver", QCOMBOS)
def test_quantized_access_counts_match_reference(quant_results, precision,
                                                 eviction, driver):
    served, ref, port = quant_results(precision, eviction, driver)
    for w, g, _, _ in served:
        for ws, gs in zip(_stats_list(w), _stats_list(g)):
            for f in STAT_FIELDS:
                assert getattr(gs, f) == getattr(ws, f), f
        if w.batch_stats is not None:
            for f in BATCH_FIELDS:
                assert getattr(g.batch_stats, f) == \
                    getattr(w.batch_stats, f), f
    for f in ("n_db", "items_fetched", "items_used"):
        assert getattr(port.access_stats, f) == getattr(ref.access_stats, f)


@pytest.mark.parametrize("precision,eviction,driver", QCOMBOS)
def test_quantized_tier2_matches_reference(quant_results, precision,
                                           eviction, driver):
    served, _, port = quant_results(precision, eviction, driver)
    for _, _, want, got in served:
        _assert_same_tier2(got, want)
    assert port.store.cache.slab.dtype == quant.slab_dtype(precision)


@pytest.mark.parametrize("precision", QUANT)
def test_rerank_costs_one_access(small_dataset, small_graph, precision):
    """A warm tier 2: the rerank is the only tier-3 access, one for a
    single query and one for a whole batch."""
    X, _ = small_dataset
    Q = _queries(small_dataset)
    _, port = _qpair(small_dataset, small_graph, precision, "fifo",
                     cache_capacity=len(X))
    port.warm_cache()
    single = port.search(P.SearchRequest(query=Q[0], k=K, ef=EF))
    assert single.stats.n_db == 1 and port.access_stats.n_db == 1
    batch = port.search(P.SearchRequest(query=Q, k=K, ef=EF))
    assert batch.batch_stats.n_db == 1 and port.access_stats.n_db == 2
    assert [s.n_db for s in batch.stats] == [1] * len(Q)


def test_rerank_disabled_matches_reference(small_dataset, small_graph):
    """rerank_alpha=0 returns the quantized beam as it is: no rerank
    access, distances to float32 rounding of the reference's."""
    ref, port = _qpair(small_dataset, small_graph, "int8", "fifo",
                       rerank_alpha=0.0)
    for w, g, want, got in _serve(ref, port, [
            (_queries(small_dataset), "batched")]):
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        np.testing.assert_allclose(g.dists, np.asarray(w.dists), rtol=1e-5)
        assert g.batch_stats.n_db == w.batch_stats.n_db
        _assert_same_tier2(got, want)


@pytest.mark.parametrize("precision", ["float32"] + QUANT)
def test_cache_bytes_and_resize_at_precision(small_dataset, small_graph,
                                             precision):
    ref, port = _qpair(small_dataset, small_graph, precision, "fifo")
    assert port.cache_bytes() == ref.cache_bytes()
    budget = 50_000
    assert port.resize_cache_bytes(budget, warm=True) == \
        ref.resize_cache_bytes(budget, warm=True)
    assert port.cache_bytes() == ref.cache_bytes() <= budget
    _assert_same_tier2(_tier2(port), _tier2(ref))


# ------------------------------------------------------------ fused driver

PRECISIONS = ["float32"] + QUANT


@pytest.fixture(scope="module")
def fused_results(small_dataset, small_graph):
    done = {}

    def get(precision, eviction):
        if (precision, eviction) not in done:
            ref, port = _qpair(small_dataset, small_graph, precision,
                               eviction, fused=True)
            Q = _queries(small_dataset)
            served = _serve(ref, port, [(q, "batched") for q in Q[:4]]
                            + [(Q[4:7], "batched")])
            assert ref.access_stats.n_db > 1
            done[(precision, eviction)] = (served, ref, port)
        return done[(precision, eviction)]

    return get


@pytest.mark.parametrize("eviction", EVICTIONS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_matches_reference(fused_results, precision, eviction):
    """The fused driver against the reference's fused driver: equal ids,
    exact access counts and tier-2 state; distances exact after a
    quantized session's rerank, to float32 rounding at float32."""
    served, ref, port = fused_results(precision, eviction)
    for w, g, want, got in served:
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        if precision == "float32":
            np.testing.assert_allclose(g.dists, np.asarray(w.dists),
                                       rtol=1e-5)
        else:
            np.testing.assert_array_equal(g.dists, np.asarray(w.dists))
        for ws, gs in zip(_stats_list(w), _stats_list(g)):
            for f in ("n_db", "items_fetched", "n_visited"):
                assert getattr(gs, f) == getattr(ws, f), f
            assert gs.t_db == pytest.approx(ws.t_db, rel=1e-9)
        _assert_same_tier2(got, want)
    for f in ("n_db", "items_fetched", "items_used"):
        assert getattr(port.access_stats, f) == getattr(ref.access_stats, f)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_payload_is_the_reference_payload(fused_results, precision):
    """The device-resident tier-3 payload is the port's own quantization
    of the float32 table, equal to the reference's; int8 carries its
    scales and takes under a third of the float32 bytes."""
    _, ref, port = fused_results(precision, "fifo")
    payload, scales = port._payload
    np.testing.assert_array_equal(payload.numpy(), np.asarray(ref._table_dev))
    assert payload.dtype == quant.slab_dtype(precision)
    if precision == "int8":
        np.testing.assert_array_equal(scales.numpy(),
                                      np.asarray(ref._tscales_dev))
        X = np.asarray(ref.external.vectors)
        assert payload.numel() + 4 * scales.numel() < X.nbytes / 3
    else:
        assert scales is None and ref._tscales_dev is None


def test_fused_float32_equals_port_loop(small_dataset, small_graph):
    """Fused float32 gives the host loop driver's bits: the same kernel
    over the same rows, one access for each phase that missed."""
    X, _ = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)

    def engine(fused):
        return P.WebANNSEngine(table, graph, P.EngineConfig(
            device="cpu", cache_capacity=len(X) // 4, fused=fused))

    host, fused = engine(False), engine(True)
    for q in _queries(small_dataset):
        h = host.search(P.SearchRequest(query=q, k=K, ef=EF))
        f = fused.search(P.SearchRequest(query=q, k=K, ef=EF))
        np.testing.assert_array_equal(f.ids, h.ids)
        np.testing.assert_array_equal(f.dists, h.dists)
        assert f.stats.n_db == h.stats.n_db
        assert f.stats.items_fetched == h.stats.items_fetched


def test_fused_runs_only_in_webanns_mode(small_dataset, small_graph):
    """fused=True with the eager baseline runs the host driver, as the
    reference's rule does; a batched request on a fused engine runs one
    fused query at a time."""
    ref, port = _qpair(small_dataset, small_graph, "int8", "fifo",
                       fused=True, mode="webanns-base")
    Q = _queries(small_dataset)
    for w, g, want, got in _serve(ref, port, [(Q[0], "batched")]):
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        assert g.stats.n_hops == w.stats.n_hops > 0  # the host driver
        _assert_same_tier2(got, want)
    assert port._payload is None
    _, port = _qpair(small_dataset, small_graph, "int8", "fifo", fused=True)
    res = port.search(P.SearchRequest(query=Q[:3], k=K, ef=EF))
    assert res.batch_stats.n_db == sum(s.n_db for s in res.stats)
    assert port._payload is not None
