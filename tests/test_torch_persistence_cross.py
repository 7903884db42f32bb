"""Index persistence across the port and the JAX package (DESIGN.md §6,
§8).

On the CPU, at small sizes (500 x 32 and 400 x 24 corpora), with inputs
made with numpy from a seed:

- a full save of the same graph and vectors at float32, float16, int8
  and pq (one codebook) writes the same shard files byte for byte and
  the same ``manifest.json`` but for ``index_uuid``; an artifact saved by
  either package opens in the other, and the two engines on it agree in
  the single, ``loop``, ``batched`` and fused drivers: ids equal,
  distances within rtol 1e-5 (the packages sum in another order; the
  reranked distances of the quantized precisions come from the same
  numpy), ``n_db`` and ``items_fetched`` exact;
- delta artifacts the JAX package writes after ``add``, ``delete`` and
  ``upsert`` open in the port with the JAX engine's results and no
  tombstoned id in any driver; tombstones marked on disk (the entry
  point among them) move the entry point to the same live node in both;
- a port engine opened on the same full save and put through the same
  ``add``, ``delete`` and ``upsert`` writes the JAX engine's delta byte
  for byte, and its artifact opens in the JAX package with the port's
  results in every driver;
- a grown graph's and index's delta saves write the reference's files;
- metadata columns and their dtypes round-trip in both directions.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro.core import graph as RG
from repro.core import index as RI
from repro.core import metadata as RM
from repro.core import storage as RSt
from repro.core.hnsw import insert_hnsw
from repro.data.synthetic import corpus_embeddings
from repro_torch import convert
from repro_torch.core import engine as P
from repro_torch.core import metadata as PM
from repro_torch.core import pq as PP
from repro_torch.core import search as S
from repro_torch.core.index import Index
from repro_torch.core.storage import (
    DeltaBackend,
    InMemoryBackend,
    ShardedFileBackend,
    load_metadata,
    save_tombstones,
    update_manifest,
)

CPU = torch.device("cpu")
PRECISIONS = ["float32", "float16", "int8", "pq"]
DRIVERS = ["single", "loop", "batched", "fused"]
K, EF = 8, 48
CAP = 125
PQ_M = 8
N_QUERIES = 4  # a batch, and the queries the loop and fused drivers serve


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one torch thread runs them about as fast and does
    not crowd the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(res):
    return res.stats if isinstance(res.stats, list) else [res.stats]


def _assert_same(want, got):
    """Ids equal, distances within rtol 1e-5, access counts exact."""
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.dists, np.asarray(want.dists), rtol=1e-5)
    for ws, gs in zip(_stats(want), _stats(got)):
        assert (gs.n_db, gs.items_fetched) == (ws.n_db, ws.items_fetched)
    if want.batch_stats is not None:
        for f in ("batch_size", "n_db", "items_fetched", "n_phases"):
            assert getattr(got.batch_stats, f) == \
                getattr(want.batch_stats, f), f


def _request(mod, Q, driver):
    if driver == "single":
        return mod.SearchRequest(query=Q[0], k=K, ef=EF)
    mode = "batched" if driver == "batched" else "loop"
    return mod.SearchRequest(query=Q[:N_QUERIES], k=K, ef=EF,
                             batch_mode=mode)


def _configs(precision, driver="batched"):
    kw = dict(cache_capacity=CAP, precision=precision,
              fused=driver == "fused")
    if precision == "pq":
        kw.update(pq_subspaces=PQ_M, rerank_alpha=4.0)
    return R.EngineConfig(**kw), P.EngineConfig(device="cpu", **kw)


def _open_both(path, precision, driver):
    rc, pc = _configs(precision, driver)
    return R.WebANNSEngine.open(path, config=rc), \
        P.WebANNSEngine.open(path, config=pc)


def _artifact_files(path):
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    files = {"levels.npy", man["tombstones_file"]}
    for layer in man["shards"]:
        files |= {sh["file"] for sh in layer}
    for sh in man["vector_shards"]:
        files |= {sh["file"]} | ({sh["scales_file"]}
                                 if "scales_file" in sh else set())
    return man, files


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


# ------------------------------------------------------- across packages


@pytest.fixture(scope="module")
def artifacts(small_index, tmp_path_factory):
    """For each precision, a full save of one graph and corpus by each
    package (pq: the JAX engine's codebook, adopted by the port's):
    ``{precision: (jax_dir, torch_dir)}``."""
    X, g, _, graph, table = small_index
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for precision in PRECISIONS:
        rc, pc = _configs(precision)
        ref = R.WebANNSEngine(X, g, rc)
        source = table
        if precision == "pq":
            source = InMemoryBackend(table)
            source.codebook = convert.codebook_from_reference(ref)
        port = P.WebANNSEngine(source, graph, pc)
        dirs = (str(root / f"jax_{precision}"), str(root / f"torch_{precision}"))
        assert ref.save(dirs[0])["mode"] == "full"
        assert port.save(dirs[1])["mode"] == "full"
        out[precision] = dirs
    return out


@pytest.mark.parametrize("precision", PRECISIONS)
def test_full_saves_write_equal_shards(artifacts, precision):
    """Every graph, level, tombstone and vector (or code, or scale) shard
    byte for byte; the codebook's centroids bit for bit."""
    jax_dir, torch_dir = artifacts[precision]
    man_j, files_j = _artifact_files(jax_dir)
    man_t, files_t = _artifact_files(torch_dir)
    assert files_j == files_t
    for f in sorted(files_j):
        assert filecmp.cmp(os.path.join(jax_dir, f),
                           os.path.join(torch_dir, f), shallow=False), f
    if precision == "pq":
        cb = [PP.PQCodebook.load(os.path.join(d, "codebook.npz"))
              for d in (jax_dir, torch_dir)]
        np.testing.assert_array_equal(cb[0].centroids, cb[1].centroids)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_full_save_manifests_equal_but_for_uuid(artifacts, precision):
    mans = [_artifact_files(d)[0] for d in artifacts[precision]]
    assert mans[0].pop("index_uuid") != mans[1].pop("index_uuid")
    assert mans[0] == mans[1]
    assert mans[0]["format_version"] == 2
    assert mans[0]["vector_dtype"] == precision


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("saved_by", ["jax", "torch"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_artifact_opens_in_the_other_package(artifacts, small_index,
                                             precision, saved_by, driver):
    """Both packages open one directory and serve the same request from a
    cold tier 2: ids, distances and access counts agree."""
    Q = small_index[2]
    path = artifacts[precision][saved_by == "torch"]
    ref, port = _open_both(path, precision, driver)
    assert isinstance(port.external.base_backend, ShardedFileBackend)
    assert port.graph.entry_point == ref.graph.entry_point
    if precision == "pq":
        np.testing.assert_array_equal(port.pq_codebook.centroids,
                                      np.asarray(ref.pq_codebook.centroids))
    want = ref.search(_request(R, Q, driver))
    got = port.search(_request(P, Q, driver))
    _assert_same(want, got)
    assert port.external.base_backend.shard_reads > 0
    assert port.access_stats.n_db == ref.access_stats.n_db > 0


# ------------------------------------------------ delta artifacts and tombstones


@pytest.fixture(scope="module")
def mutated(tmp_path_factory):
    """An index the JAX package saved in full, then mutated (add, a delete
    of the top hits and the entry point, an upsert) and saved again as a
    delta, at float32 and int8: ``{precision: (path, engine)}``."""
    rng = np.random.default_rng(42)
    X = rng.standard_normal((400, 24)).astype(np.float32)
    X2 = rng.standard_normal((60, 24)).astype(np.float32)
    Q = rng.standard_normal((8, 24)).astype(np.float32)
    out = {"Q": Q}
    for precision in ("float32", "int8"):
        path = str(tmp_path_factory.mktemp("delta") / precision)
        eng = R.WebANNSEngine.build(
            X, M=8, ef_construction=48, seed=7,
            config=R.EngineConfig(cache_capacity=CAP, precision=precision))
        assert eng.save(path, shard_bytes=1 << 13)["mode"] == "full"
        eng.add(X2)
        victims = eng.search(R.SearchRequest(query=Q[0], k=6, ef=EF)).ids[:3]
        eng.delete(np.concatenate([victims, [eng.graph.entry_point]]))
        eng.upsert([5, 11], X2[:2] * 0.5)
        info = eng.save(path, shard_bytes=1 << 13)
        assert info["mode"] == "delta" and info["epoch"] == 1
        out[precision] = (path, eng)
    return out


@pytest.fixture(scope="module")
def mutated_by_both(mutated, tmp_path_factory):
    """For float32 and int8: one full save by the JAX package, copied
    twice; a JAX engine and a port engine each opened on a copy, put
    through ``mutated``'s add, delete (the same ids) and upsert, and
    delta-saved into it: ``{precision: (jax_dir, torch_dir)}``."""
    rng = np.random.default_rng(42)
    X = rng.standard_normal((400, 24)).astype(np.float32)
    X2 = rng.standard_normal((60, 24)).astype(np.float32)
    out = {}
    for precision in ("float32", "int8"):
        root = tmp_path_factory.mktemp("both_" + precision)
        eng = R.WebANNSEngine.build(
            X, M=8, ef_construction=48, seed=7,
            config=R.EngineConfig(cache_capacity=CAP, precision=precision))
        eng.save(str(root / "jax"), shard_bytes=1 << 13)
        shutil.copytree(root / "jax", root / "torch")
        _, live = mutated[precision]
        victims = np.flatnonzero(live.tombstones[:400])  # the same ids
        dirs = (str(root / "jax"), str(root / "torch"))
        for path, mod, cfg in zip(dirs, (R, P), _configs(precision)):
            engine = mod.WebANNSEngine.open(path, config=cfg)
            engine.add(X2)
            engine.delete(victims[~np.isin(victims, [5, 11])])
            engine.upsert([5, 11], X2[:2] * 0.5)
            assert engine.save(path, shard_bytes=1 << 13)["mode"] == "delta"
        out[precision] = dirs
    return out


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_port_mutation_writes_the_references_delta(mutated_by_both,
                                                   precision):
    """The port's add/delete/upsert and delta save on a reopened artifact
    write the JAX engine's files (appended vector shards, dirtied graph
    shards, levels, tombstones) byte for byte, and the same manifest."""
    jax_dir, torch_dir = mutated_by_both[precision]
    man_j, files_j = _artifact_files(jax_dir)
    man_t, files_t = _artifact_files(torch_dir)
    assert man_j == man_t and man_t["mutation_epoch"] == 1
    assert files_j == files_t
    for f in sorted(files_j):
        assert filecmp.cmp(os.path.join(jax_dir, f),
                           os.path.join(torch_dir, f), shallow=False), f


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_port_mutated_artifact_opens_in_reference(mutated, mutated_by_both,
                                                  precision, driver):
    """The JAX package opens the port's delta artifact and serves the
    port's results on it; no tombstoned id comes back."""
    path = mutated_by_both[precision][1]
    ref, port = _open_both(path, precision, driver)
    assert ref.n == port.n == 462 and ref.n_live == port.n_live
    np.testing.assert_array_equal(np.asarray(ref.tombstones),
                                  port.tombstones)
    Q = mutated["Q"]
    want = ref.search(_request(R, Q, driver))
    got = port.search(_request(P, Q, driver))
    _assert_same(want, got)
    dead = set(np.flatnonzero(port.tombstones).tolist())
    assert dead and not dead & set(np.asarray(want.ids).ravel().tolist())


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_delta_artifact_from_reference_opens_in_port(mutated, precision,
                                                     driver):
    """The JAX package's delta artifact (appended vector shards, dirtied
    graph shards, the tombstone list) opens in the port with the JAX
    engine's results on the same directory, and no tombstoned id comes
    back."""
    path, live = mutated[precision]
    Q = mutated["Q"]
    ref, port = _open_both(path, precision, driver)
    assert port.n == live.n and port.n_live == live.n_live
    np.testing.assert_array_equal(port.tombstones, live.tombstones)
    assert port.graph.entry_point == ref.graph.entry_point
    assert not port.tombstones[port.graph.entry_point]
    assert (port._level_seed, port._levels_drawn) == (7, live.n)
    assert port.insert_ef_construction == 48
    want = ref.search(_request(R, Q, driver))
    got = port.search(_request(P, Q, driver))
    _assert_same(want, got)
    dead = set(np.nonzero(live.tombstones)[0].tolist())
    assert dead and not dead & set(np.asarray(got.ids).ravel().tolist())


def test_port_resave_into_its_lineage_is_a_delta(mutated, tmp_path):
    """A port engine opened on an artifact re-saves into that directory as
    a delta of its lineage (nothing appended, nothing dirtied): a far
    smaller write, the epoch bumped, and the JAX package still opens it
    with the same results."""
    src, _ = mutated["float32"]
    path = str(tmp_path / "idx")
    shutil.copytree(src, path)
    port = P.WebANNSEngine.open(path, P.EngineConfig(device="cpu",
                                                     cache_capacity=CAP))
    info = port.save(path, shard_bytes=1 << 13)
    assert info["mode"] == "delta" and info["epoch"] == 2
    full = port.save(str(tmp_path / "full"), shard_bytes=1 << 13)
    assert full["mode"] == "full"
    assert info["bytes_written"] < 0.5 * full["bytes_written"]
    assert port.save(str(tmp_path / "full"))["mode"] == "delta"
    Q = mutated["Q"]
    ref, again = _open_both(path, "float32", "batched")
    _assert_same(ref.search(_request(R, Q, "batched")),
                 again.search(_request(P, Q, "batched")))


@pytest.mark.parametrize("driver", DRIVERS)
def test_tombstones_written_on_disk_are_honoured(artifacts, small_index,
                                                 tmp_path, driver):
    """Tombstones marked through the port's own ``save_tombstones`` and
    ``update_manifest``, the entry point among them: both packages move
    the entry point to the same live node and agree, and no driver
    returns a tombstoned id."""
    X, _, Q, _, _ = small_index
    path = str(tmp_path / "idx")
    shutil.copytree(artifacts["float32"][1], path)
    entry = json.load(open(os.path.join(path, "manifest.json")))[
        "entry_point"]
    rng = np.random.default_rng(11)
    mask = np.zeros(len(X), bool)
    mask[rng.choice(len(X), len(X) // 20, replace=False)] = True
    mask[entry] = True
    save_tombstones(path, mask)
    update_manifest(path, {"mutation_epoch": 1})
    ref, port = _open_both(path, "float32", driver)
    assert port.n_live == len(X) - mask.sum()
    assert port.graph.entry_point == ref.graph.entry_point != entry
    assert not mask[port.graph.entry_point]
    want = ref.search(_request(R, Q, driver))
    got = port.search(_request(P, Q, driver))
    _assert_same(want, got)
    assert not mask[np.asarray(got.ids)[np.asarray(got.ids) >= 0]].any()
    port.warm_cache()  # never stages a tombstoned row
    present, _ = port.store.lookup(torch.as_tensor(np.flatnonzero(mask),
                                                   dtype=torch.int32))
    assert not bool(present.any())


def test_fully_tombstoned_index_returns_nothing(artifacts, tmp_path):
    path = str(tmp_path / "idx")
    shutil.copytree(artifacts["float32"][1], path)
    save_tombstones(path, np.ones(500, bool))
    port = P.WebANNSEngine.open(path, P.EngineConfig(device="cpu"))
    assert port.n_live == 0
    one = port.search(P.SearchRequest(query=np.zeros(32, np.float32), k=4))
    many = port.search(P.SearchRequest(query=np.zeros((2, 32), np.float32),
                                       k=4))
    assert (one.ids == -1).all() and np.isinf(one.dists).all()
    assert (many.ids == -1).all() and many.batch_stats.n_db == 0


def test_make_state_premarks_tombstones():
    tomb = torch.tensor([True, False, True, False])
    st = S.batch_make_state(3, 4, 5, 4, CPU, tomb)
    assert torch.equal(st.visited[:, :4], tomb.expand(3, 4))
    assert not bool(st.visited[:, 4].any())  # the spare column
    assert torch.equal(S.make_state(4, 5, 4, CPU, tomb).visited,
                       st.visited[0])
    assert not bool(S.make_state(4, 5, 4, CPU).visited.any())


# ------------------------------------------------ grown graphs, metadata


def test_delta_saves_write_the_references_files(tmp_path, small_index):
    """A graph grown by insertion and its vectors appended through a
    DeltaBackend: the port's ``Index.save`` into its lineage writes the
    reference's delta (appended vector shards, the dirtied neighbour
    shards, levels, tombstones) byte for byte."""
    X, g, _, graph, table = small_index
    rng = np.random.default_rng(6)
    X2 = rng.standard_normal((30, 32)).astype(np.float32)
    grown, dirty = insert_hnsw(
        RG.HNSWGraph(neighbors=g.neighbors.copy(), levels=g.levels.copy(),
                     entry_point=g.entry_point, max_level=g.max_level,
                     M=g.M, metric=g.metric),
        np.concatenate([X, X2]), np.arange(500, 530),
        RG.random_levels(30, g.M, rng), ef_construction=60)
    pg, _ = convert.from_reference(
        np.concatenate([X, X2]), grown.neighbors, grown.levels,
        grown.entry_point, grown.max_level, grown.M, grown.metric)
    tomb = np.zeros(530, bool)
    tomb[[3, 77, 512]] = True
    dirs = {}
    for name, Ix, G, G2, be, Delta in (
            ("jax", RI.Index, g, grown, RSt.InMemoryBackend,
             RSt.DeltaBackend),
            ("torch", Index, graph, pg, InMemoryBackend, DeltaBackend)):
        path = str(tmp_path / name)
        Ix(graph=G, backend=be(X), uuid="lineage").save(
            path, shard_bytes=1 << 13)
        delta = Delta(be(X))
        delta.append(X2)
        big = Ix(graph=G2, backend=delta, tombstones=tomb, uuid="lineage")
        info = big.save(path, shard_bytes=1 << 13, dirty_nodes=dirty)
        assert info["mode"] == "delta" and info["epoch"] == 1
        dirs[name] = path
    man_j, files_j = _artifact_files(dirs["jax"])
    man_t, files_t = _artifact_files(dirs["torch"])
    assert man_j == man_t and files_j == files_t
    for f in sorted(files_j):
        assert filecmp.cmp(os.path.join(dirs["jax"], f),
                           os.path.join(dirs["torch"], f), shallow=False), f
    loaded = Index.load(dirs["jax"])
    np.testing.assert_array_equal(loaded.graph.neighbors, grown.neighbors)
    np.testing.assert_array_equal(loaded.tombstones, tomb)
    np.testing.assert_array_equal(loaded.backend.vectors,
                                  np.concatenate([X, X2]))


def _meta(n, rng):
    return {"user": rng.integers(0, 10, n),
            "ts": rng.uniform(0, 1e3, n),
            "source": np.array(["web", "mail", "chat"])[rng.integers(0, 3, n)]}


def test_metadata_round_trips_from_the_reference(tmp_path):
    """Columns the JAX package saved, before and after a delta that
    appended rows with their own values, open in the port with the same
    values and dtypes; the port's full save opens in the JAX package the
    same way."""
    rng = np.random.default_rng(6)
    X = rng.standard_normal((200, 16)).astype(np.float32)
    path = str(tmp_path / "idx")
    eng = R.WebANNSEngine.build(X, M=6, ef_construction=32,
                                config=R.EngineConfig(cache_capacity=64),
                                metadata=_meta(200, rng))
    eng.save(path)
    X2 = rng.standard_normal((10, 16)).astype(np.float32)
    eng.add(X2, metadata={"user": [55] * 10, "ts": [9e5] * 10,
                          "source": ["delta"] * 10})
    assert eng.save(path)["mode"] == "delta"
    port = P.WebANNSEngine.open(path, P.EngineConfig(device="cpu"))
    assert port.metadata.n_rows == eng.n == port.n
    for name in ("user", "ts", "source"):
        want = eng.metadata.column(name)
        got = port.metadata.column(name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
    back = str(tmp_path / "back")
    port.save(back)
    again = R.WebANNSEngine.open(back, config=R.EngineConfig())
    for name in ("user", "ts", "source"):
        assert again.metadata.column(name).dtype == \
            eng.metadata.column(name).dtype
        np.testing.assert_array_equal(again.metadata.column(name),
                                      eng.metadata.column(name))


def test_metadata_saved_by_the_port_keeps_dtypes(tmp_path):
    """An index the port builds with metadata: its columns are stored at
    the canonical dtypes (int64, float64, unicode) and a column saved
    before rows were appended is fill-extended on load, as in the
    reference."""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((120, 8)).astype(np.float32)
    meta = _meta(120, rng)
    idx = Index.build(X, M=4, ef_construction=16, metadata=meta)
    path = str(tmp_path / "idx")
    idx.save(path)
    for pkg in (Index, RI.Index):
        store = pkg.load(path).metadata
        assert store.column("user").dtype == np.int64
        assert store.column("ts").dtype == np.float64
        assert store.column("source").dtype.kind == "U"
        np.testing.assert_array_equal(store.column("source"), meta["source"])
    man = json.load(open(os.path.join(path, "manifest.json")))
    padded = load_metadata(path, man, 125)
    assert padded.n_rows == 125
    assert (padded.column("user")[-5:] == 0).all()
    assert np.isnan(padded.column("ts")[-5:]).all()
    assert (padded.column("source")[-5:] == "").all()


@pytest.mark.parametrize("case", ["extend", "assign", "errors"])
def test_metadata_store_matches_reference(case):
    """The port's MetadataStore is the reference's: extend with and
    without values, assign with unicode widening, and the same errors."""
    cols = {"user": [1, 2, 3], "src": ["a", "bb", "c"]}
    stores = [mod.MetadataStore(cols) for mod in (RM, PM)]
    if case == "extend":
        for s in stores:
            s.extend(2, {"user": [7, 8], "score": [0.5, 1.5]})
            s.extend(1)
    elif case == "assign":
        for s in stores:
            s.assign("src", [0, 2], ["longer", "x"])
            s.assign("__tenant__", [1], [4], allow_reserved=True)
    else:
        for mod in (RM, PM):
            with pytest.raises(ValueError, match="reserved"):
                mod.MetadataStore({"__x__": [1]})
            with pytest.raises(ValueError, match="invalid column name"):
                mod.MetadataStore({"a b": [1]})
            with pytest.raises(TypeError, match="holds int"):
                mod.MetadataStore(cols).extend(1, {"user": ["s"]})
            with pytest.raises(ValueError, match="mismatched"):
                mod.MetadataStore({"a": [1], "b": [1, 2]})
    want, got = (s.to_columns() for s in stores)
    assert stores[1].n_rows == stores[0].n_rows and set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name])
