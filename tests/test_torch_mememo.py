"""The port's Mememo baseline against ``repro.core.mememo``, and the
pathologies the paper measures on it, against the port's engine.

The baseline is host Python and NumPy in both packages, so on the same
vectors, graph and queries the two give the same bits: ids and distances
under ``array_equal``, and every count (``n_db``, ``items_fetched``,
``n_dist``, ``n_hops``, the tier-3 counters and Eq. 1's redundancy)
exactly, in both ``compute`` modes. The graph is built once by the
reference (``small_graph``) and carried across with
``convert.from_reference``. The rest mirrors
``tests/test_mememo_baseline.py`` with the port's engine on the CPU.
"""

import numpy as np
import pytest

from repro.core import mememo as R
from repro_torch import convert
from repro_torch.core import engine as PE
from repro_torch.core import mememo as P
from repro_torch.core.hnsw import exact_search

STAT_FIELDS = ("n_visited", "n_dist", "n_hops", "n_db", "items_fetched")
ACCESS_FIELDS = ("n_db", "items_fetched", "items_used", "modeled_time")


def _port_graph(small_dataset, small_graph):
    X, _ = small_dataset
    g = small_graph
    return convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_distances_equal_reference(metric):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    assert P._dist_interpreted(a, b, metric) == R._dist_interpreted(
        a, b, metric)
    assert P._dist_numpy(a, b, metric) == R._dist_numpy(a, b, metric)


@pytest.mark.parametrize("fn", ["_dist_interpreted", "_dist_numpy"])
def test_distance_rejects_unknown_metric(fn):
    for mod in (R, P):
        with pytest.raises(ValueError):
            getattr(mod, fn)(np.ones(2), np.ones(2), "hamming")


def test_fifo_cache_equal_reference():
    caches = [mod._FIFOCache(3) for mod in (R, P)]
    for i in (5, 1, 5, 7, 2, 1, 9):
        for c in caches:
            c.put(i, np.full(2, i, np.float32))
    assert list(caches[0].data) == list(caches[1].data)
    assert len(caches[1]) == 3 and 9 in caches[1] and 5 not in caches[1]
    assert P._FIFOCache(0).capacity == 1


@pytest.mark.parametrize("compute", ["numpy", "interpreted"])
@pytest.mark.parametrize("cap,prefetch", [(None, None), (160, 64),
                                          (40, 8)])
def test_mememo_equals_reference(small_dataset, small_graph, compute, cap,
                                 prefetch):
    """The same vectors, graph and queries through both baselines: the
    same ids and distances bit for bit, and the same counts a query and
    in tier 3, from a cold cache through a warm one."""
    X, Q = small_dataset
    graph, table = _port_graph(small_dataset, small_graph)
    ref = R.MememoEngine(X, small_graph, cache_capacity=cap,
                         prefetch_size=prefetch, compute=compute)
    port = P.MememoEngine(table, graph, cache_capacity=cap,
                          prefetch_size=prefetch, compute=compute)
    for q in Q[:5]:
        ri, rd, rs = ref.query(q, k=10, ef=32)
        pi, pd, ps = port.query(q, k=10, ef=32)
        assert pi.dtype == ri.dtype and np.array_equal(pi, ri)
        assert pd.dtype == rd.dtype and np.array_equal(pd, rd)
        for f in STAT_FIELDS:
            assert getattr(ps, f) == getattr(rs, f), f
        assert ps.t_db == rs.t_db
    for f in ACCESS_FIELDS:
        assert (getattr(port.external.stats, f)
                == getattr(ref.external.stats, f)), f
    assert port.external.stats.redundancy() == ref.external.stats.redundancy()
    assert list(port.cache.data) == list(ref.cache.data)
    assert port.external.stats.n_db > 0


def test_mememo_stays_on_the_host(small_dataset, small_graph):
    """The baseline models the browser's interpreted engine: it takes no
    device and holds its cache as host NumPy rows."""
    graph, table = _port_graph(small_dataset, small_graph)
    with pytest.raises(TypeError):
        P.MememoEngine(table, graph, device="cpu")
    eng = P.MememoEngine(table, graph, cache_capacity=50)
    eng.query(small_dataset[1][0], k=5, ef=16)
    assert all(isinstance(v, np.ndarray) for v in eng.cache.data.values())


# ------------------------------------ tests/test_mememo_baseline.py's five


def _web(small_dataset, small_graph, cap):
    graph, table = _port_graph(small_dataset, small_graph)
    return PE.WebANNSEngine(table, graph, PE.EngineConfig(
        cache_capacity=cap, device="cpu"))


def _web_query(eng, q, k=10, ef=64):
    res = eng.search(PE.SearchRequest(query=q, k=k, ef=ef))
    return res.ids, res.dists, res.stats


def test_interpreted_distance_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    for metric in ("l2", "ip", "cos"):
        x = P._dist_interpreted(a, b, metric)
        y = P._dist_numpy(a, b, metric)
        assert abs(x - y) < 1e-4


def test_mememo_recall_parity(small_dataset, small_graph):
    """Mememo is slow, not wrong — recall must match the graph's."""
    X, Q = small_dataset
    graph, table = _port_graph(small_dataset, small_graph)
    mem = P.MememoEngine(table, graph, cache_capacity=len(X))
    hits = 0
    for q in Q[:6]:
        ids, _, _ = mem.query(q, k=10, ef=64)
        ex, _ = exact_search(X, q, 10)
        hits += len(set(ids.tolist()) & set(ex.tolist()))
    assert hits / 60 > 0.85


def test_mememo_redundancy_exceeds_webanns(small_dataset, small_graph):
    """Fig. 3a: heuristic prefetch wastes most fetched vectors; lazy
    loading fetches only what it needs."""
    X, Q = small_dataset
    cap = len(X) // 5
    graph, table = _port_graph(small_dataset, small_graph)
    mem = P.MememoEngine(table, graph, cache_capacity=cap, prefetch_size=64)
    web = _web(small_dataset, small_graph, cap)
    for q in Q[:5]:
        mem.query(q, k=10, ef=64)
        _web_query(web, q)
    assert mem.external.stats.redundancy() > 0.5
    assert web.external.stats.redundancy() == 0.0


def test_mememo_more_db_accesses_than_webanns(small_dataset, small_graph):
    X, Q = small_dataset
    cap = len(X) // 5
    graph, table = _port_graph(small_dataset, small_graph)
    mem = P.MememoEngine(table, graph, cache_capacity=cap, prefetch_size=64)
    web = _web(small_dataset, small_graph, cap)
    n_mem = n_web = 0
    for q in Q[:5]:
        _, _, sm = mem.query(q, k=10, ef=64)
        _, _, sw = _web_query(web, q)
        n_mem += sm.n_db
        n_web += sw.n_db
    assert n_web < n_mem


def test_mememo_full_memory_no_access_after_warm(small_dataset, small_graph):
    X, Q = small_dataset
    graph, table = _port_graph(small_dataset, small_graph)
    mem = P.MememoEngine(table, graph, cache_capacity=len(X))
    mem.query(Q[0], k=10, ef=64)  # warm-up (paper protocol)
    n0 = mem.external.stats.n_db
    mem.query(Q[0], k=10, ef=64)
    assert mem.external.stats.n_db == n0
