"""Metadata-filtered search (DESIGN.md §9) in the port against the JAX
package.

On the CPU, at ``tests/test_filtered_search.py``'s sizes (600 x 24,
M = 8, ef_construction = 48, graph seed 3; ``user`` = id mod 10, ``ts``
= id, ``source`` a five-value cycle), inputs made with numpy from a
seed. One predicate tree goes to both engines
(``convert.filter_from_reference``), and both engines start from one
graph (the reference's build, carried across):

- ``Filter.mask`` equals the reference's (``array_equal``), the DSL's
  errors are the reference's;
- filtered searches in the single, ``loop``, ``batched`` and fused
  drivers at float32 and int8: ids, ``n_db`` and ``items_fetched``
  exactly the reference's, distances within rtol 1e-5 at float32
  (``tests/test_torch_engine.py``'s tolerance) and exact after int8's
  rerank; no denied id returned; recall@10 >= 0.95 against the filtered
  brute force at selectivity 0.5 and 0.1 (the reference's acceptance);
- route-but-don't-return: at the same effective ef a filtered search
  makes exactly the unfiltered search's tier-3 accesses;
- ``_boost_ef`` gives the reference's widths; per-query filters in one
  batch, filters over tombstones and empty filters behave as the
  reference's; metadata grows, validates and persists as the
  reference's.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro.core import index as RI
from repro.core import storage as RSt
from repro.core.hnsw import build_hnsw as ref_build_hnsw
from repro.core.metadata import Filter as RF
from repro.core.metadata import MetadataStore as RMS
from repro_torch import convert
from repro_torch.core import engine as P
from repro_torch.core import index as PI
from repro_torch.core import storage as PSt
from repro_torch.core.eval import brute_force_topk, recall_at_k
from repro_torch.core.metadata import Filter, MetadataStore

N, D = 600, 24
M, EFC, SEED, CAP = 8, 48, 3, 128
K, EF = 10, 64
DRIVERS = ["single", "loop", "batched", "fused"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one torch thread runs them about as fast and does
    not crowd the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Q = rng.standard_normal((8, D)).astype(np.float32)
    meta = {
        "user": np.arange(N) % 10,
        "ts": np.arange(N, dtype=np.float64),
        "source": np.array(["web", "pdf", "web", "doc", "web"] * (N // 5)),
    }
    g = ref_build_hnsw(X, M=M, ef_construction=EFC, seed=SEED)
    return X, Q, meta, g


def _pair(corpus, **kw):
    """The JAX engine and the port engine on one graph, corpus and
    metadata (each its own copy), as ``build`` leaves them."""
    X, _, meta, g = corpus
    kw.setdefault("cache_capacity", CAP)
    ref = R.WebANNSEngine(RI.Index(
        graph=copy.deepcopy(g), backend=RSt.InMemoryBackend(X),
        level_state=(SEED, N), insert_params=(EFC, True),
        metadata=RMS(meta)), config=R.EngineConfig(**kw))
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    port = P.WebANNSEngine(PI.Index(
        graph=graph, backend=PSt.InMemoryBackend(table),
        level_state=(SEED, N), insert_params=(EFC, True),
        metadata=MetadataStore(meta)),
        config=P.EngineConfig(device="cpu", **kw))
    return ref, port


def _port(corpus, **kw):
    return _pair(corpus, **kw)[1]


def _request(mod, Q, driver, filt, k=K, ef=EF):
    """The first query alone, or the first four as a batch (a fused
    engine serves a batch one fused query at a time)."""
    if driver == "single":
        return mod.SearchRequest(query=Q[0], k=k, ef=ef, filter=filt)
    mode = "loop" if driver == "loop" else "batched"
    return mod.SearchRequest(query=Q[:4], k=k, ef=ef, batch_mode=mode,
                             filter=filt)


def _queries(Q, driver):
    return Q[:1] if driver == "single" else Q[:4]


def _oracle(X, Q, k, allow):
    ids = np.nonzero(allow)[0]
    return ids[brute_force_topk(X[ids], Q, k)]


def _stats(res):
    return res.stats if isinstance(res.stats, list) else [res.stats]


def _assert_same(want, got, precision):
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    if precision == "float32":
        np.testing.assert_allclose(got.dists, np.asarray(want.dists),
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.dists, np.asarray(want.dists))
    for ws, gs in zip(_stats(want), _stats(got)):
        assert (gs.n_db, gs.items_fetched) == (ws.n_db, ws.items_fetched)


# the reference's predicate trees, carried across node for node
FILTERS = [
    RF.eq("user", 3), RF.in_("source", ["web", "doc"]),
    RF.range("ts", lo=100, hi=199), RF.range("ts", hi=49),
    RF.and_(RF.eq("source", "web"), RF.not_(RF.eq("user", 0))),
    (RF.eq("source", "web") & ~RF.eq("user", 0)) | RF.eq("user", 5),
    RF.in_("user", []), RF.eq("user", 999),
]


# ------------------------------------------------------------- DSL units


@pytest.mark.parametrize("i", range(len(FILTERS)))
def test_filter_masks_match_reference(corpus, i):
    _, _, meta, _ = corpus
    f = FILTERS[i]
    port_f = convert.filter_from_reference(f)
    assert port_f == convert.filter_from_reference(f)  # frozen, comparable
    np.testing.assert_array_equal(port_f.mask(MetadataStore(meta)),
                                  f.mask(RMS(meta)))


def test_filter_operators_build_the_same_tree(corpus):
    _, _, meta, _ = corpus
    store = MetadataStore(meta)
    sugar = (Filter.eq("source", "web") & ~Filter.eq("user", 0)) \
        | Filter.eq("user", 5)
    assert sugar == convert.filter_from_reference(FILTERS[5])
    u, src = np.asarray(meta["user"]), np.asarray(meta["source"])
    np.testing.assert_array_equal(
        sugar.mask(store), ((src == "web") & (u != 0)) | (u == 5))


def test_filter_errors(corpus):
    _, Q, meta, _ = corpus
    store = MetadataStore(meta)
    with pytest.raises(KeyError, match="unknown metadata column"):
        Filter.eq("nope", 1).mask(store)
    with pytest.raises(ValueError, match="at least one bound"):
        Filter.range("ts")
    with pytest.raises(ValueError, match="no metadata"):
        Filter.eq("user", 1).mask(None)
    bare = _port(corpus)
    bare.metadata = None
    with pytest.raises(ValueError, match="no metadata"):
        bare.search(P.SearchRequest(query=Q[0], k=5,
                                    filter=Filter.eq("user", 1)))
    eng = _port(corpus)
    with pytest.raises(TypeError, match="must be a Filter"):
        eng.search(P.SearchRequest(query=Q[:2], k=5, filter=[object(), None]))
    with pytest.raises(ValueError, match="single Filter"):
        eng.search(P.SearchRequest(query=Q[0], k=5,
                                   filter=[Filter.eq("user", 1)]))
    with pytest.raises(ValueError, match="one per query"):
        eng.search(P.SearchRequest(query=Q[:4], k=5,
                                   filter=[Filter.eq("user", 1)] * 2))


# ------------------------------------------- parity, all drivers


@pytest.fixture(scope="module")
def filtered(corpus):
    """Both engines' filtered results for one (driver, precision): the
    selectivity-0.1 filter (ef boosted 64 → 208) through the reference
    and the port on one cold pair, then the selectivity-0.5 filter (ef
    96) through the port."""
    done = {}

    def get(driver, precision):
        key = (driver, precision)
        if key not in done:
            _, Q, _, _ = corpus
            ref, port = _pair(corpus, precision=precision,
                              fused=driver == "fused")
            tight = RF.eq("user", 7)
            want = ref.search(_request(R, Q, driver, tight))
            got = port.search(_request(
                P, Q, driver, convert.filter_from_reference(tight)))
            wide = port.search(_request(
                P, Q, driver, Filter.in_("user", range(5))))
            done[key] = (want, got, wide)
        return done[key]

    return get


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_filtered_search_matches_reference(filtered, precision, driver):
    want, got, _ = filtered(driver, precision)
    _assert_same(want, got, precision)


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_filtered_recall_against_oracle(corpus, filtered, precision,
                                        driver):
    """Recall@10 >= 0.95 against the brute force over the allowed rows
    at selectivity 0.1 and 0.5, and only allowed ids returned."""
    X, Q, meta, _ = corpus
    _, tight, wide = filtered(driver, precision)
    store = MetadataStore(meta)
    Qd = _queries(Q, driver)
    for res, filt, sel in ((tight, Filter.eq("user", 7), 0.1),
                           (wide, Filter.in_("user", range(5)), 0.5)):
        allow = filt.mask(store)
        assert abs(allow.mean() - sel) < 0.01
        ids = np.atleast_2d(res.ids)
        assert (ids >= 0).all() and allow[ids].all()
        rec = recall_at_k(ids, _oracle(X, Qd, K, allow))
        assert rec >= 0.95, f"{driver}/{precision} sel={sel}: recall {rec}"


def test_loop_batched_parity_with_filters(corpus, filtered):
    """Both host drivers share one effective ef a batch, so they give
    the same bits under a filter."""
    for i in (1, 2):
        loop, batched = (filtered(d, "float32")[i] for d in ("loop",
                                                             "batched"))
        np.testing.assert_array_equal(loop.ids, batched.ids)
        np.testing.assert_array_equal(loop.dists, batched.dists)


def test_per_query_filters_in_one_batch(corpus):
    """One filter a query ((B, N) deny matrix), None entries unfiltered;
    the batch takes the widest boost, as the reference's does."""
    _, Q, meta, _ = corpus
    ref, port = _pair(corpus)
    rf = [RF.eq("user", 1), None, RF.eq("user", 2),
          RF.range("ts", lo=300)]
    want = ref.search(R.SearchRequest(query=Q[:4], k=K, ef=EF, filter=rf))
    got = port.search(P.SearchRequest(query=Q[:4], k=K, ef=EF, filter=[
        None if f is None else convert.filter_from_reference(f)
        for f in rf]))
    _assert_same(want, got, "float32")
    u = np.asarray(meta["user"])
    assert set(u[got.ids[0]]) == {1} and set(u[got.ids[2]]) == {2}
    assert (got.ids[3] >= 300).all() and (got.ids[1] >= 0).all()


@pytest.mark.parametrize("driver", ["loop", "batched", "fused"])
def test_filter_and_tombstone_composition(corpus, driver):
    """A filtered search's own top hits tombstoned: neither a tombstoned
    nor a denied id returns, the results are the reference's, and the
    live-allowed recall stays high."""
    X, Q, meta, _ = corpus
    ref, port = _pair(corpus, fused=driver == "fused")
    tight = RF.eq("user", 7)
    pf = convert.filter_from_reference(tight)
    top = np.atleast_2d(port.search(_request(P, Q, driver, pf)).ids)[0]
    ref.search(_request(R, Q, driver, tight))
    for e in (ref, port):
        e.delete(top[:5])
    want = ref.search(_request(R, Q, driver, tight))
    got = port.search(_request(P, Q, driver, pf))
    _assert_same(want, got, "float32")
    ids = np.atleast_2d(got.ids)
    allow_live = pf.mask(MetadataStore(meta)) & ~port.tombstones
    assert allow_live[ids[ids >= 0]].all()
    assert recall_at_k(ids, _oracle(X, _queries(Q, driver), K,
                                    allow_live)) >= 0.9


@pytest.mark.parametrize("driver", DRIVERS)
def test_empty_filter_returns_all_padding(corpus, driver):
    _, Q, _, _ = corpus
    eng = _port(corpus, fused=driver == "fused")
    res = eng.search(_request(P, Q, driver, Filter.eq("user", 999), k=5))
    assert (np.asarray(res.ids) == -1).all()
    assert np.isinf(res.dists).all()


# --------------------------------------- the zero-extra-accesses invariant


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_filtering_adds_zero_tier3_accesses(corpus, precision, driver):
    """At the same effective ef (filter_ef_cap = 1.0 pins it), a filtered
    search makes exactly the unfiltered search's accesses; at float32
    (no rerank) it fetches the same items too."""

    def run(filt):
        eng = _port(corpus, cache_capacity=64, fused=driver == "fused",
                    precision=precision, filter_ef_cap=1.0)
        _, Q, _, _ = corpus
        eng.search(_request(P, Q, driver, filt))
        return eng.external.stats.n_db, eng.external.stats.items_fetched

    base_db, base_items = run(None)
    filt_db, filt_items = run(Filter.in_("user", [2, 3]))
    assert base_db > 0
    assert filt_db == base_db
    if precision == "float32":
        assert filt_items == base_items


# ------------------------------------------------- selectivity-adaptive ef


def test_ef_boost_matches_reference(corpus):
    ref, port = _pair(corpus)
    cases = [(64, 1.0), (64, 0.5), (64, 0.25), (64, 0.1), (64, 0.02),
             (64, 0.01), (64, 1e-12), (48, 0.3), (10, 0.7), (300, 0.1),
             (64, 0.0625)]
    assert [port._boost_ef(e, s) for e, s in cases] == \
        [ref._boost_ef(e, s) for e, s in cases]
    assert [port._boost_ef(64, s) for s in (1.0, 0.25, 0.01, 1e-12)] == \
        [64, 128, 256, 256]
    assert [port._boost_ef(64, s) for s in (0.5, 0.1, 0.02)] == [96, 208, 256]
    assert port._boost_ef(300, 0.1) == N  # at most the id space
    for e in (ref, port):
        e.config.filter_ef_cap = 1.0
    assert port._boost_ef(64, 0.01) == ref._boost_ef(64, 0.01) == 64


def test_tight_filter_recall_needs_boost(corpus):
    X, Q, meta, _ = corpus
    filt = Filter.eq("user", 7)
    truth = _oracle(X, _queries(Q, "batched"), K,
                    filt.mask(MetadataStore(meta)))
    rec = {}
    for cap in (4.0, 1.0):
        eng = _port(corpus, filter_ef_cap=cap)
        rec[cap] = recall_at_k(eng.search(_request(
            P, Q, "batched", filt, ef=32)).ids, truth)
    assert rec[4.0] >= rec[1.0] and rec[4.0] >= 0.95


# ------------------------------------------------------- mutation + meta


def test_add_and_upsert_extend_metadata_like_reference(corpus):
    """add() appends the new rows' metadata (missing columns filled),
    upsert() carries it over or takes new values; the columns equal the
    reference's, and filters reach the new rows."""
    X = corpus[0]
    rng = np.random.default_rng(5)
    X2 = rng.standard_normal((20, D)).astype(np.float32)
    ref, port = _pair(corpus)
    for e in (ref, port):
        res = e.add(X2, metadata={"user": [77] * 20, "source": ["new"] * 20,
                                  "ts": [1e6] * 20})
        e.add(np.zeros((3, D), np.float32))  # no metadata: fills
        e.upsert([int(res.ids[0])], X2[:1] * 0.5,
                 metadata={"user": [88], "source": ["upd"], "ts": [2e6]})
        e.upsert([37], X[37:38] * 1.5)  # carries row 37's values over
    assert port.metadata.n_rows == port.n == ref.n
    for name in ("user", "ts", "source"):
        np.testing.assert_array_equal(port.metadata.column(name),
                                      ref.metadata.column(name))
        assert port.metadata.column(name).dtype == \
            ref.metadata.column(name).dtype
    ids = port.search(P.SearchRequest(query=X2[3], k=5, ef=48,
                                      filter=Filter.eq("user", 77))).ids
    assert set(ids.tolist()) <= set(range(N, N + 20))
    got = port.search(P.SearchRequest(query=X2[0] * 0.5, k=1, ef=48,
                                      filter=Filter.eq("user", 88))).ids
    assert got.tolist() == [port.n - 2]
    new_37 = port.n - 1
    assert port.metadata.column("user")[new_37] == 7
    hit = port.search(P.SearchRequest(query=X[37] * 1.5, k=1, ef=48,
                                      filter=Filter.eq("user", 7))).ids
    assert hit.tolist() == [new_37]


def test_bad_metadata_fails_before_mutation(corpus):
    """A kind-mismatched metadata dict raises before the vectors, the
    graph or the tombstones change, in add and in upsert, with the
    reference's error."""
    X, Q, _, _ = corpus
    ref, port = _pair(corpus)
    for e in (ref, port):
        with pytest.raises(TypeError, match="holds int values"):
            e.add(np.zeros((2, D), np.float32),
                  metadata={"user": ["alice", "bob"]})
        with pytest.raises(TypeError, match="holds int values"):
            e.upsert([4], X[:1], metadata={"user": ["oops"]})
    assert port.n == N and port.metadata.n_rows == N
    assert not port.tombstones.any()
    ids = port.search(P.SearchRequest(query=Q[0], k=5, ef=48,
                                      filter=Filter.eq("user", 1))).ids
    assert (ids >= 0).all()


def test_metadata_persists_through_full_and_delta_saves(tmp_path, corpus):
    _, Q, _, _ = corpus
    path = str(tmp_path / "idx")
    eng = _port(corpus)
    assert eng.save(path)["mode"] == "full"
    re = P.WebANNSEngine.open(path, P.EngineConfig(device="cpu",
                                                   cache_capacity=CAP))
    filt = Filter.eq("user", 4) & Filter.range("ts", hi=400)
    req = P.SearchRequest(query=Q, k=8, ef=48, filter=filt)
    np.testing.assert_array_equal(eng.search(req).ids, re.search(req).ids)
    assert re.metadata.column("user").dtype == np.int64
    X2 = np.random.default_rng(6).standard_normal((10, D)).astype(np.float32)
    eng.add(X2, metadata={"user": [55] * 10, "ts": [9e5] * 10,
                          "source": ["delta"] * 10})
    assert eng.save(path)["mode"] == "delta"
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert {c["name"] for c in manifest["metadata_columns"]} == \
        {"user", "ts", "source"}
    re = P.WebANNSEngine.open(path, P.EngineConfig(device="cpu",
                                                   cache_capacity=CAP))
    np.testing.assert_array_equal(re.metadata.column("source")[-10:],
                                  ["delta"] * 10)
    got = re.search(P.SearchRequest(query=X2[2], k=3, ef=48,
                                    filter=Filter.eq("user", 55))).ids
    assert (got >= N).all()
