"""Mutation (DESIGN.md §8) in the port against the JAX package.

On the CPU, at ``tests/test_mutation.py``'s sizes (500 + 80 rows, d =
24, M = 8, ef_construction = 48, seed 7), inputs made with numpy from a
seed. Both engines start from one graph (the reference's build, carried
across with ``convert.from_reference``) with the same level stream and
insertion knobs, and go through the same ``add``, ``delete`` (the
search's top hits and the entry point) and ``upsert``:

- ``insert_hnsw`` and ``engine.add``: the grown graph's arrays and the
  dirty set equal the reference's and a fresh build's over the
  concatenated corpus (``array_equal``);
- ``MutationResult`` fields, tombstones, the entry point and the tier-2
  state after a delete (``convert.cache_to_numpy``) equal the
  reference's bit for bit;
- after the mutations, the single, ``loop``, ``batched`` and fused
  drivers at float32 and int8: ids, ``n_db`` and ``items_fetched``
  exactly the reference's; distances within rtol 1e-5 at float32
  (``tests/test_torch_engine.py``'s tolerance: the packages sum in
  another order) and exactly equal after int8's rerank (the same numpy
  on the same rows). At float16 and pq (whose tier-2 state after the
  mutations is held to the reference's bit for bit) the four drivers are
  held to what a search must give: live ids only, and reranked
  distances equal to numpy's over the returned rows;
- the reference's behaviour rules: no tombstoned id returned, the entry
  point repaired, ids never reused, a fully tombstoned engine returning
  -1 rows, validation before any mutation, texts of deleted ids hidden.
"""

import copy
import os

import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro.core import index as RI
from repro.core import storage as RSt
from repro.core.graph import random_levels as ref_random_levels
from repro.core.hnsw import build_hnsw as ref_build_hnsw
from repro.core.hnsw import insert_hnsw as ref_insert_hnsw
from repro_torch import convert
from repro_torch.core import engine as P
from repro_torch.core import index as PI
from repro_torch.core import storage as PSt
from repro_torch.core.graph import random_levels
from repro_torch.core.hnsw import build_hnsw, insert_hnsw
from repro_torch.core.store import cache_lookup

M, EFC, SEED, CAP = 8, 48, 7, 128
K, EF = 6, 48
PRECISIONS = ["float32", "int8", "float16", "pq"]
# the precisions whose served results are held to the reference's (each
# of its engine configurations costs the JAX package a set of compiles)
EXACT = ("float32", "int8")
DRIVERS = ["single", "loop", "batched", "fused"]
STAT_FIELDS = ("n_db", "items_fetched")


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
    rng = np.random.default_rng(42)
    X = rng.standard_normal((500, 24)).astype(np.float32)
    X2 = rng.standard_normal((80, 24)).astype(np.float32)
    Q = rng.standard_normal((8, 24)).astype(np.float32)
    g = ref_build_hnsw(X, M=M, ef_construction=EFC, seed=SEED)
    return X, X2, Q, g


@pytest.fixture(scope="module")
def fresh(corpus):
    """The reference's offline build over the concatenated corpus, with
    the same seed: what an add of X2 must reproduce."""
    X, X2, _, _ = corpus
    return ref_build_hnsw(np.concatenate([X, X2]), M=M, ef_construction=EFC,
                          seed=SEED)


@pytest.fixture(scope="module")
def victims(corpus):
    """What the mutations delete: the top hits of the first query (the
    hardest ids to keep out) and the entry point."""
    _, _, Q, g = corpus
    _, eng = _pair(corpus)
    top = eng.search(P.SearchRequest(query=Q[0], k=K, ef=EF)).ids
    return np.concatenate([top[:3], [g.entry_point]])


def _kw(precision="float32", **kw):
    kw.setdefault("cache_capacity", CAP)
    if precision == "pq":
        kw.update(pq_subspaces=8, rerank_alpha=4.0)
    return dict(precision=precision, **kw)


def _pair(corpus, texts=None, **kw):
    """The JAX engine and the port engine on one graph and corpus, each
    continuing the build's level stream (seed 7, 500 draws) with its
    insertion knobs, as ``WebANNSEngine.build`` leaves them; a pq port
    engine adopts the reference's codebook."""
    X, _, _, g = corpus
    kw = _kw(**kw)
    ref = R.WebANNSEngine(RI.Index(
        graph=copy.deepcopy(g), backend=RSt.InMemoryBackend(X),
        level_state=(SEED, len(X)), insert_params=(EFC, True)),
        config=R.EngineConfig(**kw), texts=texts)
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    codebook = (convert.codebook_from_reference(ref)
                if kw["precision"] == "pq" else None)
    port = P.WebANNSEngine(PI.Index(
        graph=graph, backend=PSt.InMemoryBackend(table),
        level_state=(SEED, len(X)), insert_params=(EFC, True),
        codebook=codebook), config=P.EngineConfig(device="cpu", **kw),
        texts=texts)
    return ref, port


def _request(mod, Q, driver):
    if driver == "single":
        return mod.SearchRequest(query=Q[0], k=K, ef=EF)
    if driver == "fused":
        return mod.SearchRequest(query=Q[:4], k=K, ef=EF)
    return mod.SearchRequest(query=Q, k=K, ef=EF, batch_mode=driver)


def _stats(res):
    return res.stats if isinstance(res.stats, list) else [res.stats]


def _assert_same(want, got, precision):
    """Ids and access counts exact; distances within rtol 1e-5 at
    float32 (another summation order), exact after a rerank."""
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    if precision == "float32":
        np.testing.assert_allclose(got.dists, np.asarray(want.dists),
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.dists, np.asarray(want.dists))
    for ws, gs in zip(_stats(want), _stats(got)):
        for f in STAT_FIELDS:
            assert getattr(gs, f) == getattr(ws, f), f


def _tier2(eng):
    if isinstance(eng, P.WebANNSEngine):
        return convert.cache_to_numpy(eng.store.cache)
    return {f: np.asarray(getattr(eng.store.cache, f))
            for f in convert.CACHE_FIELDS}


def _assert_same_tier2(got, want):
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _result_fields(res):
    return (np.asarray(res.ids).tolist(), np.asarray(res.deleted).tolist(),
            res.n_live, res.n_total)


def _warm_both(ref, port, ids):
    """Warm the reference's tier 2 and carry it across to the port."""
    ref.warm_cache(ids)
    c = ref.store.cache
    port.store.cache = convert.cache_from_reference(
        *(np.asarray(getattr(c, f)) for f in convert.CACHE_FIELDS),
        device="cpu")


def _mutate(ref, port, X2, victims):
    """The same add, delete and upsert on both engines; returns what each
    step gave both."""
    out = {"add": [e.add(X2) for e in (ref, port)], "victims": victims}
    out["delete"] = [e.delete(victims) for e in (ref, port)]
    out["tier2_after_delete"] = [_tier2(e) for e in (ref, port)]
    out["upsert"] = [e.upsert([5, 11], X2[:2] * 0.5) for e in (ref, port)]
    return out


@pytest.fixture(scope="module")
def mutated(corpus, victims):
    """For each (precision, fused): a mutated pair, what the mutations
    returned, and each driver's request served by both afterwards (the
    host drivers in turn on one pair)."""
    done = {}

    def get(precision, fused):
        key = (precision, fused)
        if key not in done:
            _, X2, Q, _ = corpus
            ref, port = _pair(corpus, precision=precision, fused=fused)
            # a warm tier 2 holding some victims: the delete evicts them
            _warm_both(ref, port, np.arange(0, 500, 4)[:CAP // 2])
            out = _mutate(ref, port, X2, victims)
            drivers = ["fused"] if fused else ["single", "loop", "batched"]
            out["served"] = {
                d: (ref.search(_request(R, Q, d))
                    if precision in EXACT else None,
                    port.search(_request(P, Q, d))) for d in drivers}
            done[key] = (ref, port, out)
        return done[key]

    return get


# --------------------------------------------- incremental insert parity


def test_level_stream_continues_like_the_reference():
    """random_levels over a continued stream is one long draw, and
    PCG64.advance(k) lands where drawing k doubles would: the property
    ``add`` relies on, in the port's copy and equal to the reference's."""
    full = random_levels(120, 8, np.random.default_rng(7))
    np.testing.assert_array_equal(
        full, ref_random_levels(120, 8, np.random.default_rng(7)))
    rng = np.random.default_rng(7)
    head, tail = random_levels(90, 8, rng), random_levels(30, 8, rng)
    np.testing.assert_array_equal(full, np.concatenate([head, tail]))
    bg = np.random.PCG64(7)
    bg.advance(90)
    np.testing.assert_array_equal(
        random_levels(30, 8, np.random.Generator(bg)), tail)


def test_insert_hnsw_matches_reference_and_offline_build(corpus, fresh):
    """The corpus graph was built from the first 500 levels of seed 7's
    stream; inserting X2 at the next 80 gives the reference's graph and
    dirty set, and the offline build's over all 580 rows."""
    X, X2, _, g = corpus
    Xall = np.concatenate([X, X2])
    levels = random_levels(len(Xall), M, np.random.default_rng(SEED))
    np.testing.assert_array_equal(levels[:len(X)], g.levels)
    g0, _ = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    g1, dirty = insert_hnsw(g0, Xall, np.arange(len(X), len(Xall)),
                            levels[len(X):], ef_construction=EFC)
    r1, rdirty = ref_insert_hnsw(g, Xall, np.arange(len(X), len(Xall)),
                                 levels[len(X):], ef_construction=EFC)
    for want in (r1, fresh):
        np.testing.assert_array_equal(g1.neighbors, want.neighbors)
        np.testing.assert_array_equal(g1.levels, want.levels)
        assert (g1.entry_point, g1.max_level) == \
            (want.entry_point, want.max_level)
    assert dirty == rdirty and dirty and all(d < len(X) for d in dirty)
    assert g0.size == len(X)  # the input graph was not grown in place
    # and the port's own offline build is the reference's
    np.testing.assert_array_equal(
        build_hnsw(Xall, M=M, ef_construction=EFC, levels=levels).neighbors,
        fresh.neighbors)


def test_insert_hnsw_rejects_non_contiguous_ids(corpus):
    X, X2, _, g = corpus
    graph, _ = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    with pytest.raises(ValueError, match="contiguous"):
        insert_hnsw(graph, np.concatenate([X, X2]), [len(X) + 1],
                    np.zeros(1, np.int32))


def test_engine_add_matches_fresh_build(corpus, fresh):
    """The grown engine's graph is a fresh build's over the concatenated
    corpus and the reference engine's after the same add, and its ids
    continue from the id space's end."""
    X, X2, _, _ = corpus
    ref, port = _pair(corpus)
    want, got = ref.add(X2), port.add(X2)
    assert isinstance(got, P.MutationResult)
    np.testing.assert_array_equal(got.ids, np.arange(len(X), len(X) + 80))
    assert _result_fields(got) == _result_fields(want)
    for g in (ref.graph, fresh):
        np.testing.assert_array_equal(port.graph.neighbors, g.neighbors)
        assert port.graph.entry_point == g.entry_point
    np.testing.assert_array_equal(port.neighbors.numpy(), fresh.neighbors)
    assert port._dirty_nodes == ref._dirty_nodes
    assert port.store.cache.slot_of.shape == (len(X) + 80,)


# ------------------------------------------- the mutated engines, served


@pytest.mark.parametrize("precision", PRECISIONS)
def test_mutation_results_match_reference(mutated, precision):
    ref, port, out = mutated(precision, False)
    for step in ("add", "delete", "upsert"):
        want, got = out[step]
        assert _result_fields(got) == _result_fields(want), step
    np.testing.assert_array_equal(port.tombstones, ref.tombstones)
    assert port.graph.entry_point == ref.graph.entry_point
    assert not port.tombstones[port.graph.entry_point]
    np.testing.assert_array_equal(port.graph.neighbors, ref.graph.neighbors)
    assert (port.n, port.n_live) == (ref.n, ref.n_live)
    assert port._levels_drawn == ref._levels_drawn == 582


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tier2_after_delete_matches_reference(mutated, precision):
    """The delete evicted the same slots: every tier-2 array equal bit
    for bit (slot_of and id_of cleared, LRU stamps zeroed)."""
    _, _, out = mutated(precision, False)
    want, got = out["tier2_after_delete"]
    _assert_same_tier2(got, want)
    victims = out["victims"]
    assert (got["slot_of"][victims] == -1).all()


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_mutated_engine_serves_like_reference(corpus, mutated, precision,
                                              driver):
    _, port, out = mutated(precision, driver == "fused")
    want, got = out["served"][driver]
    dead = set(np.nonzero(port.tombstones)[0].tolist())
    assert dead and not dead & set(np.ravel(got.ids).tolist())
    if want is not None:
        _assert_same(want, got, precision)
        return
    # the reranked top k: live ids, in order, at numpy's exact distances
    # to the rows tier 3 holds
    ids, dists = np.atleast_2d(got.ids), np.atleast_2d(got.dists)
    Q = corpus[2]
    assert ((ids >= 0) & (ids < port.n)).all()
    rows = port.external.vectors
    for q, i, d in zip(Q, ids, dists):
        np.testing.assert_array_equal(
            d, np.sum((rows[i] - q) ** 2, axis=-1, dtype=np.float32))
        assert (np.diff(d) >= 0).all()


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
def test_delete_evicts_warm_rows_like_reference(corpus, eviction):
    """A full warm tier 2 (the reference's, carried across), then a
    delete of cached and uncached ids: the port's in-place eviction
    leaves the reference's arrays, and no lookup serves a tombstoned
    row again, not even after re-warming."""
    X, _, _, _ = corpus
    ref, port = _pair(corpus, eviction=eviction)
    _warm_both(ref, port, np.arange(0, len(X), 3)[:CAP])
    victims = np.array([0, 3, 4, 9, 10, 499])
    cached = np.asarray(ref.store.cache.slot_of)[victims] >= 0
    assert cached.any() and not cached.all()
    slab = port.store.cache.slab
    for e in (ref, port):
        e.delete(victims)
    _assert_same_tier2(_tier2(port), _tier2(ref))
    assert port.store.cache.slab is slab  # evicted in place
    port.warm_cache()
    present, _ = cache_lookup(port.store.cache,
                              torch.as_tensor(victims, dtype=torch.int32))
    assert not present.any()


@pytest.mark.parametrize("precision", ["int8", "float16"])
def test_deleted_ids_never_returned_under_rerank(corpus, precision):
    """The rerank pool comes from the masked beam, so the exact rerank
    never brings a tombstoned id back, in the single, batched and fused
    drivers."""
    _, _, Q, _ = corpus
    for fused in (False, True):
        _, eng = _pair(corpus, precision=precision, fused=fused)
        top = eng.search(P.SearchRequest(query=Q[0], k=10, ef=64)).ids
        victims = set(top[:4].tolist())
        eng.delete(np.array(sorted(victims)))
        single = np.concatenate([
            eng.search(P.SearchRequest(query=q, k=10, ef=64)).ids
            for q in Q[:4]])
        assert not victims & set(single.tolist())
        if not fused:
            batched = eng.search(P.SearchRequest(query=Q, k=10, ef=64)).ids
            assert not victims & set(np.ravel(batched).tolist())


def test_delete_keeps_live_results_sane(corpus):
    """Post-delete recall over the live set stays high: the masked
    search routes around tombstones."""
    from repro_torch.core.eval import brute_force_topk, recall_at_k

    X, _, Q, _ = corpus
    _, eng = _pair(corpus)
    dead = np.random.default_rng(3).choice(len(X), 50, replace=False)
    eng.delete(dead)
    live = np.setdiff1d(np.arange(len(X)), dead)
    truth = live[brute_force_topk(X[live], Q, 10)]
    preds = eng.search(P.SearchRequest(query=Q, k=10, ef=64)).ids
    assert recall_at_k(preds, truth) > 0.8


def test_delete_entry_point_repairs_like_reference(corpus):
    _, _, Q, _ = corpus
    ref, port = _pair(corpus)
    old = port.graph.entry_point
    for e in (ref, port):
        e.delete([old])
    assert port.graph.entry_point == ref.graph.entry_point != old
    assert not port.tombstones[port.graph.entry_point]
    r = port.search(P.SearchRequest(query=Q[0], k=5, ef=48))
    assert (r.ids >= 0).all() and old not in r.ids.tolist()


@pytest.mark.parametrize("driver", DRIVERS)
def test_delete_all_then_revive(corpus, driver):
    """A fully tombstoned engine returns -1 rows in every driver; an add
    re-seeds the entry point and serves only the new rows, as the
    reference's does."""
    X, X2, Q, _ = corpus
    ref, port = _pair(corpus, fused=driver == "fused")
    for e in (ref, port):
        e.delete(np.arange(len(X)))
    assert port.n_live == 0
    dead = port.search(_request(P, Q, driver))
    assert (np.asarray(dead.ids) == -1).all()
    assert np.isinf(dead.dists).all()
    want, got = ref.add(X2[:6]), port.add(X2[:6])
    assert _result_fields(got) == _result_fields(want)
    assert port.graph.entry_point == ref.graph.entry_point == len(X)
    np.testing.assert_array_equal(port.graph.neighbors, ref.graph.neighbors)
    g = port.search(P.SearchRequest(query=Q[0], k=3, ef=16))
    assert (g.ids >= 0).all() and set(g.ids.tolist()) <= set(got.ids.tolist())


# ------------------------------------------------------- id-reuse rules


def test_add_delete_add_never_reuses_ids(corpus):
    X, X2, _, _ = corpus
    _, eng = _pair(corpus)
    first = eng.add(X2[:10])
    np.testing.assert_array_equal(first.ids, np.arange(len(X), len(X) + 10))
    eng.delete(first.ids[:5])
    second = eng.add(X2[10:20])
    np.testing.assert_array_equal(second.ids,
                                  np.arange(len(X) + 10, len(X) + 20))
    assert second.n_total == len(X) + 20
    assert second.n_live == len(X) + 15
    assert eng.tombstones[first.ids[:5]].all()


def test_upsert_returns_fresh_ids_and_moves_vector(corpus):
    X, _, Q, _ = corpus
    _, eng = _pair(corpus)
    target = int(eng.search(P.SearchRequest(query=Q[1], k=1, ef=48)).ids[0])
    far = X[target] + 100.0
    res = eng.upsert([target], far[None])
    assert res.deleted.tolist() == [target]
    assert res.ids.tolist() == [len(X)]
    assert res.n_total == len(X) + 1 and res.n_live == len(X)
    ids = eng.search(P.SearchRequest(query=Q[1], k=10, ef=64)).ids
    assert target not in ids.tolist()
    hit = eng.search(P.SearchRequest(query=far, k=1, ef=48)).ids
    assert hit.tolist() == [len(X)]


@pytest.mark.parametrize("case", ["upsert_counts", "add_dim", "delete_range",
                                  "upsert_dim"])
def test_bad_mutations_raise_before_mutating(corpus, case):
    X, _, _, _ = corpus
    _, eng = _pair(corpus)
    call, match = {
        "upsert_counts": (lambda: eng.upsert([1, 2], X[:3]),
                          "counts must match"),
        "add_dim": (lambda: eng.add(np.zeros((2, 7), np.float32)), "dim"),
        "delete_range": (lambda: eng.delete([len(X)]), "out of range"),
        "upsert_dim": (lambda: eng.upsert([1], np.zeros((1, 7), np.float32)),
                       "dim"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()
    assert eng.n == eng.n_live == len(X)
    assert not eng.tombstones.any()


# ---------------------------------------------------------- pq mutation


def test_pq_mutation_through_frozen_codebook(corpus):
    """add/delete/upsert on a live pq engine (the reference's codebook)
    encode through that codebook, which never changes, and search keeps
    serving (the reference's ``test_pq_mutation_roundtrip_through_frozen_
    codebook``; parity with the reference after mutations is
    ``test_mutated_engine_serves_like_reference[...pq]``); a fused
    payload made before the add gets the new rows' codes appended, equal
    to a whole-table encoding (the codec works row by row)."""
    _, _, Q, _ = corpus
    rng = np.random.default_rng(8)
    new = rng.standard_normal((5, 24)).astype(np.float32)
    repl = rng.standard_normal((2, 24)).astype(np.float32)
    for fused in (False, True):
        _, port = _pair(corpus, precision="pq", fused=fused)
        frozen = port.pq_codebook.centroids.copy()
        if fused:
            port.search(P.SearchRequest(query=Q[0], k=5, ef=64))
        res = port.add(new)
        port.delete(res.ids[:2])
        res2 = port.upsert(res.ids[2:4], repl)
        got = port.search(P.SearchRequest(query=repl[0], k=5, ef=64))
        assert res2.ids[0] in got.ids
        assert not set(res.ids[:2].tolist()) & set(got.ids.tolist())
        assert np.array_equal(port.pq_codebook.centroids, frozen)
        if fused:
            codes = port._payload[0].numpy()
            whole = port._encode_payload(
                port.external.base_backend.fetch(np.arange(port.n)))[0]
            np.testing.assert_array_equal(codes, whole.numpy())
            assert codes.shape == (port.n, 8)


# ------------------------------------------- port-side persistence after mutation


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_delta_save_reopens_identically(tmp_path, corpus, precision):
    """A saved index mutated by the port and saved again as a delta
    (base vector shards untouched) reopens with the live engine's
    tombstones, graph and results."""
    X, X2, Q, _ = corpus
    path = str(tmp_path / "idx")
    _, eng = _pair(corpus, precision=precision)
    assert eng.save(path, shard_bytes=1 << 14)["mode"] == "full"
    base = {f: os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path) if f.startswith("vectors_s")}
    eng.add(X2)
    eng.delete(eng.search(P.SearchRequest(query=Q[0], k=6, ef=64)).ids[:3])
    eng.upsert([5, 11], X2[:2] * 0.5)
    info = eng.save(path, shard_bytes=1 << 14)
    assert info["mode"] == "delta" and info["epoch"] == 1
    for f, size in base.items():
        assert os.path.getsize(os.path.join(path, f)) == size, f
    disk = P.WebANNSEngine.open(path, P.EngineConfig(
        device="cpu", **_kw(precision)))
    np.testing.assert_array_equal(disk.tombstones, eng.tombstones)
    np.testing.assert_array_equal(disk.graph.neighbors, eng.graph.neighbors)
    assert disk.graph.entry_point == eng.graph.entry_point
    if precision == "float32":
        mem = P.WebANNSEngine(eng.index, config=P.EngineConfig(
            device="cpu", **_kw(precision)))
        req = P.SearchRequest(query=Q, k=K, ef=EF)
        a, b = mem.search(req), disk.search(req)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    dead = set(np.nonzero(eng.tombstones)[0].tolist())
    got = disk.search(P.SearchRequest(query=Q, k=K, ef=EF)).ids
    assert not dead & set(np.ravel(got).tolist())


def test_save_to_new_path_is_full_save(tmp_path, corpus):
    X, X2, _, _ = corpus
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    _, eng = _pair(corpus)
    assert eng.save(p1)["mode"] == "full"
    eng.add(X2[:5])
    assert eng.save(p2)["mode"] == "full"  # another directory: a new lineage
    assert eng.save(p2)["mode"] == "delta"  # now it is the lineage's


def test_delta_save_smaller_than_full_save(tmp_path, corpus):
    """What the lifecycle exists for: persisting a small mutation writes
    far fewer bytes than saving the index again."""
    X, X2, _, _ = corpus
    path = str(tmp_path / "idx")
    _, eng = _pair(corpus)
    full = eng.save(path, shard_bytes=1 << 14)
    eng.add(X2[:8])
    eng.delete([2, 3])
    delta = eng.save(path, shard_bytes=1 << 14)
    assert delta["mode"] == "delta"
    assert delta["bytes_written"] < 0.5 * full["bytes_written"]


def test_reopened_engine_continues_level_stream(tmp_path, corpus, fresh):
    """add() after save → open still matches the offline build: the
    level stream and the insertion knobs survive the manifest."""
    X, X2, _, _ = corpus
    path = str(tmp_path / "idx")
    _, eng = _pair(corpus)
    eng.save(path)
    re = P.WebANNSEngine.open(path, P.EngineConfig(device="cpu",
                                                   cache_capacity=CAP))
    assert re.insert_ef_construction == EFC
    re.add(X2)
    np.testing.assert_array_equal(re.graph.neighbors, fresh.neighbors)


# ------------------------------------------------- tombstone-aware texts


def test_get_texts_hides_deleted_and_upserted_ids(corpus):
    X, _, _, _ = corpus
    texts = [f"doc {i}" for i in range(len(X))]
    ref, port = _pair(corpus, texts=texts)
    assert port.get_texts(np.array([3, 4])) == ["doc 3", "doc 4"]
    for e in (ref, port):
        e.delete([3])
        e.upsert([7], X[7:8] * 2.0, texts=["doc 7 v2"])
    probe = np.array([3, 4, 7, len(X), -1, len(X) + 5])
    assert port.get_texts(probe) == ref.get_texts(probe) == \
        [None, "doc 4", None, "doc 7 v2", None, None]
    _, bare = _pair(corpus)
    assert bare.get_texts(np.array([0, 1])) == [None, None]
    bare.add(X[:1], texts=["late"])
    assert bare.get_texts(np.array([0, len(X)])) == [None, "late"]
