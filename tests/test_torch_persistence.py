"""Index persistence in the port (DESIGN.md §6, §8): the JAX package's
own persistence tests, run on the port.

On the CPU, at small sizes (a few hundred rows, d <= 32), with inputs
made with numpy from a seed: ``test_index_persistence.py``, the sharded
cases of ``test_storage_backends.py`` (and a ``DeltaBackend`` under the
engine), ``test_engine_api.py``'s open/save contract, ``test_hnsw.py``'s
graph round trip (its files crossing the packages), and the shard cases
of ``test_quant.py`` and ``test_pq.py``. Across the packages (equal
saves, each package's artifacts in the other, delta artifacts,
tombstones, metadata): ``tests/test_torch_persistence_cross.py``.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro.core import graph as RG
from repro.data.synthetic import corpus_embeddings
from repro_torch import convert
from repro_torch.core import engine as P
from repro_torch.core import pq as PP
from repro_torch.core import quant as PQ
from repro_torch.core.graph import HNSWGraph
from repro_torch.core.index import Index
from repro_torch.core.storage import (
    DeltaBackend,
    LatencyModel,
    ShardedFileBackend,
    StorageBackend,
    save_vector_shards,
    update_manifest,
)
from repro_torch.core.store import ExternalStore, TieredStore

K, EF = 8, 48
CAP = 125
PQ_M = 8


def _recall10(X, ids, Q):
    d = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1)[:, :10]
    return float(np.mean([len(set(a.tolist()) & set(t.tolist())) / 10
                          for a, t in zip(np.asarray(ids), truth)]))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one torch thread runs them about as fast and does
    not crowd the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the port's own artifact


@pytest.fixture(scope="module")
def built(small_dataset):
    X, _ = small_dataset
    return X, Index.build(X[:400], M=8, ef_construction=40, seed=3)


def test_round_trip_graph_and_vectors(tmp_path, built):
    _, idx = built
    X = idx.backend.vectors
    path = str(tmp_path / "idx")
    idx.save(path, shard_bytes=1 << 14)  # several shards each
    idx2 = Index.load(path)
    assert isinstance(idx2.backend, ShardedFileBackend)
    assert len(idx2.backend._shards) > 1
    np.testing.assert_array_equal(idx2.graph.neighbors, idx.graph.neighbors)
    np.testing.assert_array_equal(idx2.graph.levels, idx.graph.levels)
    assert idx2.graph.entry_point == idx.graph.entry_point
    assert idx2.graph.max_level == idx.graph.max_level
    assert (idx2.metric, idx2.n_items, idx2.dim) == ("l2", len(X), X.shape[1])
    np.testing.assert_array_equal(idx2.backend.fetch(np.arange(len(X))), X)
    assert idx2.level_state == (3, len(X))
    assert idx2.insert_params == (40, True)
    assert not idx2.tombstones.any() and idx2.n_live == len(X)


def test_manifest_is_graph_format_superset(tmp_path, built):
    _, idx = built
    path = str(tmp_path / "idx")
    idx.save(path)
    g = HNSWGraph.load(path)
    np.testing.assert_array_equal(g.neighbors, idx.graph.neighbors)
    assert g.M == idx.graph.M and g.metric == idx.graph.metric


def test_graph_resave_preserves_vector_shards(tmp_path, built):
    """Re-persisting the graph alone merges into the manifest: its
    vector_shards section survives."""
    _, idx = built
    path = str(tmp_path / "idx")
    idx.save(path)
    Index.load(path).graph.save(path)
    again = Index.load(path)
    np.testing.assert_array_equal(again.backend.fetch(np.arange(idx.n_items)),
                                  idx.backend.vectors)


def test_resave_from_disk_backend(tmp_path, built):
    _, idx = built
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    idx.save(p1)
    Index.load(p1).save(p2)  # the write path reads the sharded backend
    np.testing.assert_array_equal(
        Index.load(p2).backend.fetch(np.arange(idx.n_items)),
        idx.backend.vectors)


def test_load_missing_manifest_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        Index.load(str(tmp_path / "nope"))


def test_save_load_query_bit_identical_on_both_backends(
        tmp_path, built, small_dataset):
    _, idx = built
    _, Q = small_dataset
    path = str(tmp_path / "idx")
    idx.save(path, shard_bytes=1 << 14)
    cfg = P.EngineConfig(device="cpu", cache_capacity=64)
    engines = {
        "in-memory": P.WebANNSEngine.from_index(idx, cfg),
        "sharded": P.WebANNSEngine.open(path, config=cfg),
        "sharded-no-mmap": P.WebANNSEngine.from_index(
            Index.load(path, mmap=False), cfg),
    }
    results = {name: eng.search(P.SearchRequest(query=Q[:4], k=8, ef=48))
               for name, eng in engines.items()}
    for name, res in results.items():
        np.testing.assert_array_equal(results["in-memory"].ids, res.ids,
                                      err_msg=name)
        np.testing.assert_array_equal(results["in-memory"].dists, res.dists,
                                      err_msg=name)
    assert engines["sharded"].external.base_backend.shard_reads > 0
    assert engines["sharded"].external.stats.n_db > 0


def test_open_raises_without_cuda(tmp_path, built, monkeypatch):
    """``open`` with no config puts the engine on the card: without CUDA
    it raises, as ``build`` does."""
    _, idx = built
    path = str(tmp_path / "idx")
    idx.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        P.WebANNSEngine.open(path)
    with pytest.raises(RuntimeError, match="is_available"):
        P.WebANNSEngine.from_index(Index.load(path))


# ---------------------------------------------------------- the backends


@pytest.fixture()
def payload():
    return np.random.default_rng(0).standard_normal((50, 8)).astype(
        np.float32)


@pytest.fixture()
def sharded(tmp_path, payload):
    # 8 floats * 4 bytes * 20 rows per shard: 3 shards for 50 rows
    save_vector_shards(str(tmp_path), payload, shard_bytes=8 * 4 * 20)
    return ShardedFileBackend(str(tmp_path))


def test_sharded_backend_fetch_parity(payload, sharded):
    assert isinstance(sharded, StorageBackend)
    assert sharded.n_items == 50 and sharded.dim == 8
    ids = np.array([0, 19, 20, 39, 40, 49, 5])  # spans all 3 shards
    np.testing.assert_array_equal(sharded.fetch(ids), payload[ids])
    assert sharded.shard_reads == 3  # one read per shard touched
    sharded.fetch(np.array([1]))
    assert sharded.shard_reads == 4
    np.testing.assert_array_equal(sharded.vectors, payload)
    np.testing.assert_array_equal(sharded.fetch_range(15, 45),
                                  payload[15:45])


def test_sharded_backend_no_mmap(tmp_path, payload):
    save_vector_shards(str(tmp_path), payload, shard_bytes=1 << 20)
    b = ShardedFileBackend(str(tmp_path), mmap=False)
    np.testing.assert_array_equal(b.fetch(np.arange(50)), payload)


def test_sharded_backend_rejects_graph_only_dir(tmp_path):
    update_manifest(str(tmp_path), {"N": 10, "shards": []})
    with pytest.raises(ValueError, match="vector_shards"):
        ShardedFileBackend(str(tmp_path))


def test_external_store_over_sharded_backend(payload, sharded):
    ext = ExternalStore(sharded, t_setup=2e-3, t_per_item=1e-6)
    np.testing.assert_array_equal(ext.fetch(np.array([0, 25, 49])),
                                  payload[[0, 25, 49]])
    assert ext.stats.n_db == 1
    assert abs(ext.access_cost(5) - (2e-3 + 5e-6)) < 1e-12
    assert ext.base_backend is sharded
    assert sharded.shard_reads > 0
    np.testing.assert_array_equal(ext.vectors, payload)


def test_tiered_store_over_sharded_backend(payload, sharded):
    ts = TieredStore(ExternalStore(sharded), capacity=16, device="cpu")
    ids = np.array([1, 21, 41], np.int32)
    np.testing.assert_array_equal(ts.gather(ids).numpy(), payload[ids])
    assert ts.external.stats.n_db == 1
    ts.warm(np.array([7, 8], np.int32))
    present, _ = ts.lookup(torch.tensor([7, 8], dtype=torch.int32))
    assert bool(present.all())
    assert ts.external.stats.n_db == 1  # the init-stage load is uncounted


def test_delta_backend_spans_base_and_delta(payload, sharded):
    """A frozen base (here the mmap'd shards) and appended host rows:
    fetches split by id range, ``vectors`` concatenates, and the engine
    serves from it with a LatencyModel around it."""
    d = DeltaBackend(sharded)
    ids = d.append(np.full((2, 8), 99.0, np.float32))
    np.testing.assert_array_equal(ids, [50, 51])
    out = d.fetch(np.array([0, 50, 49, 51]))
    np.testing.assert_array_equal(out[[0, 2]], payload[[0, 49]])
    assert (out[[1, 3]] == 99.0).all()
    assert d.n_items == 52 and d.vectors.shape == (52, 8)
    ext = ExternalStore(LatencyModel(d, t_setup=1e-3))
    assert ext.base_backend is d
    np.testing.assert_array_equal(ext.vectors[:50], payload)


def test_engine_serves_from_a_delta_backend(tmp_path, small_dataset,
                                            small_graph):
    """The engine over a DeltaBackend (base shards + appended rows) and
    over the same rows in memory: the same bits in every driver, the
    fused driver's one bulk read included."""
    X, Q = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    save_vector_shards(str(tmp_path), table[:700], shard_bytes=1 << 14)
    delta = DeltaBackend(ShardedFileBackend(str(tmp_path)))
    delta.append(table[700:])
    for fused in (False, True):
        cfg = P.EngineConfig(device="cpu", cache_capacity=200, fused=fused)
        for mode in ("loop", "batched"):
            req = P.SearchRequest(query=Q[:4], k=K, ef=EF, batch_mode=mode)
            a = P.WebANNSEngine(table, graph, cfg).search(req)
            b = P.WebANNSEngine(delta, graph, cfg).search(req)
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.dists, b.dists)
            assert a.batch_stats.n_db == b.batch_stats.n_db


# ------------------------------------------- the engine's open/save contract


@pytest.mark.parametrize("mode", ["loop", "batched", "fused"])
def test_open_is_bit_identical_and_disk_served(tmp_path, small_dataset,
                                               small_graph, mode):
    X, Q = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    path = str(tmp_path / "idx")
    cfg = P.EngineConfig(device="cpu", cache_capacity=96,
                         fused=mode == "fused")
    mem = P.WebANNSEngine(table, graph, cfg)
    mem.save(path, shard_bytes=1 << 14)
    disk = P.WebANNSEngine.open(path, config=cfg)
    assert isinstance(disk.external.base_backend, ShardedFileBackend)
    if mode == "fused":
        for q in Q[:4]:
            a = mem.search(P.SearchRequest(query=q, k=6, ef=48))
            b = disk.search(P.SearchRequest(query=q, k=6, ef=48))
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.dists, b.dists)
    else:
        req = P.SearchRequest(query=Q[:6], k=6, ef=48, batch_mode=mode)
        a, b = mem.search(req), disk.search(req)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    assert disk.external.stats.n_db > 0
    assert disk.external.stats.items_fetched > 0
    assert disk.external.base_backend.shard_reads > 0


def test_save_open_save_round_trip(tmp_path, small_dataset, small_graph):
    X, Q = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    cfg = P.EngineConfig(device="cpu", cache_capacity=96)
    mem = P.WebANNSEngine(table, graph, cfg)
    mem.save(p1)
    disk = P.WebANNSEngine.open(p1, config=cfg)
    disk.save(p2)  # re-save through the sharded backend
    again = P.WebANNSEngine.open(p2, config=cfg)
    req = P.SearchRequest(query=Q[:3], k=5, ef=48)
    np.testing.assert_array_equal(mem.search(req).ids,
                                  again.search(req).ids)


def test_graph_save_load_roundtrip(tmp_path, small_graph):
    """The port's graph round trip, and the graph files crossing the
    packages both ways."""
    g = small_graph
    graph, _ = convert.from_reference(
        np.zeros((g.size, 1), np.float32), g.neighbors, g.levels,
        g.entry_point, g.max_level, g.M, g.metric)
    graph.save(str(tmp_path / "p"))
    g.save(str(tmp_path / "r"))
    for loaded in (HNSWGraph.load(str(tmp_path / "p")),
                   HNSWGraph.load(str(tmp_path / "r")),
                   RG.HNSWGraph.load(str(tmp_path / "p"))):
        np.testing.assert_array_equal(loaded.neighbors, g.neighbors)
        np.testing.assert_array_equal(loaded.levels, g.levels)
        assert (loaded.entry_point, loaded.max_level, loaded.M,
                loaded.metric) == (g.entry_point, g.max_level, g.M, g.metric)
    assert filecmp.cmp(str(tmp_path / "p" / "neighbors_l0_s0.npy"),
                       str(tmp_path / "r" / "neighbors_l0_s0.npy"),
                       shallow=False)


# ----------------------------------------------------- quantized artifacts


@pytest.fixture(scope="module")
def small_index():
    """``tests/test_pq.py``'s fixture: a clustered 500 x 32 corpus, the
    reference's graph (M = 10), noisy corpus rows as queries."""
    X = corpus_embeddings(500, 32, n_clusters=8, seed=3)
    eng = R.WebANNSEngine.build(X, M=10, ef_construction=60,
                                config=R.EngineConfig(cache_capacity=CAP))
    rng = np.random.default_rng(5)
    Q = X[rng.choice(500, 10)] + 0.1 * rng.standard_normal(
        (10, 32)).astype(np.float32)
    g = eng.graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    return X, g, Q, graph, table


@pytest.mark.parametrize("mmap", [True, False])
def test_int8_shards_save_load_query(tmp_path, small_index, mmap):
    X, _, Q, graph, table = small_index
    cfg = P.EngineConfig(device="cpu", cache_capacity=CAP, precision="int8")
    mem = P.WebANNSEngine(table, graph, cfg)
    path = str(tmp_path / "idx")
    mem.save(path)  # int8 shards: the session's precision
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["vector_dtype"] == "int8"
    assert all("scales_file" in s for s in man["vector_shards"])
    reopened = P.WebANNSEngine.open(path, config=cfg, mmap=mmap)
    r_mem = mem.search(P.SearchRequest(query=Q[0], k=10, ef=64))
    r_re = reopened.search(P.SearchRequest(query=Q[0], k=10, ef=64))
    # tier 3 now serves the dequantized int8 payload: recall at parity
    # with the float32-tier-3 session, at most one neighbour of 10 lost
    assert _recall10(X, r_re.ids[None], Q[:1]) >= \
        _recall10(X, r_mem.ids[None], Q[:1]) - 0.11
    assert isinstance(reopened.external.base_backend, ShardedFileBackend)
    assert reopened.external.base_backend.precision == "int8"


def _payload_bytes(path, prefix):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.startswith(prefix))


def test_int8_shards_are_smaller(tmp_path, small_index):
    X = small_index[0]
    save_vector_shards(str(tmp_path / "q"), X, precision="int8")
    save_vector_shards(str(tmp_path / "f"), X, precision="float32")
    assert _payload_bytes(str(tmp_path / "q"), "vectors_s") < \
        _payload_bytes(str(tmp_path / "f"), "vectors_s") / 3


def test_sharded_backend_dequant_fetch_matches_codec(tmp_path):
    X = np.random.default_rng(1).standard_normal((100, 16)).astype(np.float32)
    save_vector_shards(str(tmp_path), X, shard_bytes=16 * 30,
                       precision="int8")
    be = ShardedFileBackend(str(tmp_path))
    assert len(be._shards) > 1
    ids = np.array([0, 31, 64, 99])
    q, s = PQ.quantize_np(X[ids], "int8")
    np.testing.assert_allclose(be.fetch(ids), PQ.dequantize_np(q, s),
                               rtol=1e-6)
    np.testing.assert_allclose(
        be.vectors, PQ.dequantize_np(*PQ.quantize_np(X, "int8")), rtol=1e-6)


def test_pq_codebook_save_load_roundtrip(tmp_path):
    X = np.random.default_rng(2).standard_normal((200, 16)).astype(np.float32)
    cb = PP.train_pq(X, n_subspaces=4, n_iters=5, device="cpu")
    p = str(tmp_path / "cb.npz")
    cb.save(p)
    cb2 = PP.PQCodebook.load(p)
    assert np.array_equal(cb.centroids, cb2.centroids)
    assert cb2.n_subspaces == 4 and cb2.dim == 16


def _pq_cfg(**kw):
    kw.setdefault("pq_subspaces", PQ_M)
    return P.EngineConfig(device="cpu", cache_capacity=CAP, precision="pq",
                          rerank_alpha=4.0, **kw)


def test_pq_engine_adopts_artifact_subspace_count(tmp_path, small_index):
    """A reopened pq artifact's codebook is authoritative over the
    config's M, and it is adopted, not retrained."""
    _, _, _, graph, table = small_index
    eng = P.WebANNSEngine(table, graph, _pq_cfg(pq_subspaces=16))
    path = str(tmp_path / "idx16")
    eng.save(path)
    reopened = P.WebANNSEngine.open(path, config=_pq_cfg(pq_subspaces=8))
    assert reopened.pq_codebook.n_subspaces == 16
    assert reopened.config.pq_subspaces == 16
    np.testing.assert_array_equal(reopened.pq_codebook.centroids,
                                  eng.pq_codebook.centroids)


def test_pq_shards_save_load_query_all_drivers(tmp_path, small_index):
    """build, save, reopen: loop = batched, the fused driver's ids the
    loop's as sets, and recall against the DECODED corpus (what the
    artifact stores) at 0.9 or more."""
    X, _, Q, graph, table = small_index
    mem = P.WebANNSEngine(table, graph, _pq_cfg())
    path = str(tmp_path / "idx")
    mem.save(path)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["vector_dtype"] == "pq"
    assert man["codebook_file"] == "codebook.npz"
    assert any(f.startswith("codes_s") for f in os.listdir(path))
    loop = P.WebANNSEngine.open(path, config=_pq_cfg())
    batched = P.WebANNSEngine.open(path, config=_pq_cfg())
    fused = P.WebANNSEngine.open(path, config=_pq_cfg(fused=True))
    be = loop.external.base_backend
    assert isinstance(be, ShardedFileBackend) and be.precision == "pq"
    assert np.array_equal(be.codebook.centroids, mem.pq_codebook.centroids)
    rl = loop.search(P.SearchRequest(query=Q, k=10, ef=64, batch_mode="loop"))
    rb = batched.search(P.SearchRequest(query=Q, k=10, ef=64))
    assert np.array_equal(rl.ids, rb.ids)
    for i, q in enumerate(Q):
        rf = fused.search(P.SearchRequest(query=q, k=10, ef=64))
        assert np.array_equal(np.sort(rl.ids[i]), np.sort(rf.ids))
    cent = mem.pq_codebook.centroids
    dec = PP.decode_np(PP.encode_np(X, cent), cent)
    assert _recall10(dec, rl.ids, Q) >= 0.9


def test_pq_shards_are_much_smaller(tmp_path, small_index):
    X = small_index[0]
    cb = PP.train_pq(X, n_subspaces=8, n_iters=8, device="cpu")
    save_vector_shards(str(tmp_path / "p"), X, precision="pq", codebook=cb)
    save_vector_shards(str(tmp_path / "f"), X, precision="float32")
    assert _payload_bytes(str(tmp_path / "p"), "codes_s") < \
        _payload_bytes(str(tmp_path / "f"), "vectors_s") / 8


def test_pq_save_requires_codebook(tmp_path):
    X = np.random.default_rng(3).standard_normal((20, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="codebook"):
        save_vector_shards(str(tmp_path), X, precision="pq")


def test_pq_sharded_backend_fetch_decodes(tmp_path):
    X = np.random.default_rng(4).standard_normal((100, 16)).astype(np.float32)
    cb = PP.train_pq(X, n_subspaces=4, n_iters=8, device="cpu")
    save_vector_shards(str(tmp_path), X, shard_bytes=4 * 30,
                       precision="pq", codebook=cb)
    be = ShardedFileBackend(str(tmp_path))
    assert len(be._shards) > 1
    ids = np.array([0, 31, 64, 99])
    want = PP.decode_np(PP.encode_np(X[ids], cb.centroids), cb.centroids)
    np.testing.assert_allclose(be.fetch(ids), want, rtol=1e-5, atol=1e-6)
