"""Port product quantization against the JAX package (DESIGN.md §12).

On the CPU, at small sizes, with inputs made with numpy from a seed:

- the codec: the port's torch ``encode``/``decode`` equal the reference's
  jnp (jitted, as its cache insert runs it) and numpy twins under
  ``array_equal``, decoded rows re-encoded included; ``build_lut`` equals
  ``build_lut_jnp`` within rtol 1e-5, atol 1e-6 (the bound
  ``test_lut_np_jnp_twins_agree`` holds the reference's twins to: another
  summation order over a subspace); the numpy half is the reference's;
- both ADC plain versions equal ``pq.adc_distance_np`` and
  ``adc_distance_batch_np`` (and the Pallas kernels in interpret mode)
  under ``array_equal``, for l2, ip and cos, all-padded rows included;
- the pq cache: the reference's semantics (``tests/test_pq.py``), and
  the whole tier-2 state of both packages bit-equal after every insert;
- the port's ``train_pq``: deterministic for a seed, a residual below
  the signal, more subspaces reconstruct better;
- the engine on ``tests/test_pq.py``'s ``small_index`` fixture against
  the JAX engine with the reference's codebook carried across, in the
  single, ``loop``, ``batched`` and fused drivers: ids and reranked
  distances exact, ``n_db`` and ``items_fetched`` exact, the tier-2
  state bit-equal after each search, and ``loop`` = ``batched``. The
  fused driver is held to the reference's FUSED driver: the reference's
  host drivers load a miss at full precision and its fused driver
  decodes it, so the two traverse different distances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro.core import pq as RP
from repro.core import quant as RQ
from repro.core import store as RS
from repro.data.synthetic import corpus_embeddings
from repro.kernels.adc_gather_distance import (
    adc_gather_distance_batch_pallas,
    adc_gather_distance_pallas,
)
from repro_torch import convert
from repro_torch.core import engine as P
from repro_torch.core import pq as PP
from repro_torch.core import quant as PQ
from repro_torch.core import store as PS
from repro_torch.core.storage import InMemoryBackend
from repro_torch.kernels import ops, ref

CPU = torch.device("cpu")
METRICS = ["l2", "ip", "cos"]
_ENCODE_JIT = jax.jit(RP.encode_jnp)


def _data(n=200, d=16, m=4, seed=0):
    rng = np.random.default_rng(100 + seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, RP.train_pq(X, n_subspaces=m, n_iters=8, seed=seed)


# ------------------------------------------------------------- the codec


@pytest.mark.parametrize("n,d,m", [(200, 16, 4), (300, 32, 8), (300, 48, 24),
                                   (120, 64, 2)])
def test_encode_decode_equal_reference_twins(n, d, m, monkeypatch):
    X, cb = _data(n, d, m)
    cent = torch.from_numpy(cb.centroids)
    got = PP.encode(torch.from_numpy(X), cent).numpy()
    assert got.dtype == np.uint8 and got.shape == (n, m)
    # rows go in chunks of bounded scratch; the chunking changes nothing
    with monkeypatch.context() as mp:
        mp.setattr(PP, "ENCODE_SCRATCH_FLOATS", 1)
        np.testing.assert_array_equal(
            PP.encode(torch.from_numpy(X), cent).numpy(), got)
    np.testing.assert_array_equal(got, RP.encode_np(X, cb.centroids))
    np.testing.assert_array_equal(
        got, np.asarray(_ENCODE_JIT(jnp.asarray(X),
                                    jnp.asarray(cb.centroids))))
    dec = PP.decode(torch.from_numpy(got), cent).numpy()
    np.testing.assert_array_equal(dec, RP.decode_np(got, cb.centroids))
    np.testing.assert_array_equal(dec, np.asarray(RP.decode_jnp(
        jnp.asarray(got), jnp.asarray(cb.centroids))))
    # a decoded row re-encodes as the reference re-encodes it (the fused
    # driver's inserts), which keeps the reconstruction
    again = PP.encode(torch.from_numpy(dec), cent).numpy()
    np.testing.assert_array_equal(again, np.asarray(_ENCODE_JIT(
        jnp.asarray(dec), jnp.asarray(cb.centroids))))
    np.testing.assert_array_equal(PP.decode_np(again, cb.centroids), dec)


@pytest.mark.parametrize("n,d,m,seed", [(150, 24, 24, 0), (400, 32, 32, 1)])
def test_encode_at_one_dim_subspaces_differs_from_jit_on_near_ties(n, d, m,
                                                                   seed):
    """At dsub = 1 the reference's own codecs disagree: its jitted
    ``encode_jnp`` (XLA fuses the one-term product into ``d2``) and its
    ``encode_np`` pick different codes on a few near ties. The port
    follows ``encode_np`` exactly, and every code where it differs from
    the jitted form is a near tie: the two centroids' exact distances
    differ by no more than the float32 rounding of ``x2 − 2·xc + c2``."""
    X, cb = _data(n, d, m, seed)
    cent = cb.centroids
    got = PP.encode(torch.from_numpy(X), torch.from_numpy(cent)).numpy()
    np.testing.assert_array_equal(got, RP.encode_np(X, cent))
    jit = np.asarray(_ENCODE_JIT(jnp.asarray(X), jnp.asarray(cent)))
    differ = got != jit
    assert differ.any()  # the reference's two codecs disagree here
    np.testing.assert_array_equal(differ, RP.encode_np(X, cent) != jit)
    rows, subs = np.nonzero(differ)
    x = X.reshape(n, m).astype(np.float64)[rows, subs]
    ca = cent[subs, got[rows, subs], 0].astype(np.float64)
    cb_ = cent[subs, jit[rows, subs], 0].astype(np.float64)
    gap = np.abs((x - ca) ** 2 - (x - cb_) ** 2)
    scale = x * x + 2 * np.abs(x) * np.maximum(np.abs(ca), np.abs(cb_)) \
        + np.maximum(ca * ca, cb_ * cb_)
    assert (gap <= 8 * np.finfo(np.float32).eps * scale).all()


def test_encode_ties_go_to_the_lowest_centroid():
    """Duplicate centroids (k-means leaves them when clusters empty):
    every copy ties, and the lowest index wins, as ``argmin`` does in
    the reference."""
    rng = np.random.default_rng(3)
    cent = rng.standard_normal((2, 256, 3)).astype(np.float32)
    cent[:, 200] = cent[:, 7]
    cent[:, 9] = cent[:, 7]
    x = cent[:, 7].reshape(1, 6)
    got = PP.encode(torch.from_numpy(x), torch.from_numpy(cent)).numpy()
    np.testing.assert_array_equal(got, [[7, 7]])
    np.testing.assert_array_equal(got, RP.encode_np(x, cent))


@pytest.mark.parametrize("metric", METRICS)
def test_build_lut_matches_jnp_twin(metric):
    X, cb = _data()
    cent = torch.from_numpy(cb.centroids)
    luts = PP.build_lut(torch.from_numpy(X[:5]), cent, metric).numpy()
    assert luts.shape == (5, PP.lut_tables(metric), 4, 256)
    for b in range(5):
        want = np.asarray(RP.build_lut_jnp(
            jnp.asarray(X[b]), jnp.asarray(cb.centroids), metric))
        np.testing.assert_allclose(luts[b], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            luts[b], RP.build_lut_np(X[b], cb.centroids, metric),
            rtol=1e-5, atol=1e-6)
        # the batched build is the single one, bit for bit
        one = PP.build_lut(torch.from_numpy(X[b]), cent, metric).numpy()
        np.testing.assert_array_equal(luts[b], one)


@pytest.mark.parametrize("metric", METRICS)
def test_numpy_half_is_the_references(metric, tmp_path):
    X, cb = _data(seed=1)
    codes = RP.encode_np(X, cb.centroids)
    np.testing.assert_array_equal(PP.encode_np(X, cb.centroids), codes)
    np.testing.assert_array_equal(PP.decode_np(codes, cb.centroids),
                                  RP.decode_np(codes, cb.centroids))
    np.testing.assert_array_equal(
        PP.build_lut_np(X[3], cb.centroids, metric),
        RP.build_lut_np(X[3], cb.centroids, metric))
    pcb = PP.PQCodebook(cb.centroids)
    np.testing.assert_array_equal(PP.residual_energy(X, pcb),
                                  RP.residual_energy(X, cb))
    # one .npz artifact, read by either package
    path = str(tmp_path / "cb.npz")
    pcb.save(path)
    np.testing.assert_array_equal(RP.PQCodebook.load(path).centroids,
                                  cb.centroids)
    back = PP.PQCodebook.load(path)
    assert (back.n_subspaces, back.n_centroids, back.dsub, back.dim) == \
        (4, 256, 4, 16)
    assert back.nbytes() == cb.nbytes()


def test_dim_not_divisible_raises():
    X = np.zeros((4, 10), np.float32)
    with pytest.raises(ValueError):
        PP.encode(torch.from_numpy(X), torch.zeros((3, 256, 3)))
    with pytest.raises(ValueError):
        PP.train_pq(X, n_subspaces=3, device="cpu")


# ------------------------------------------------- ADC plain versions


def _adc_case(metric, m=4, n=60, d=16, seed=0):
    X, cb = _data(n=n, d=d, m=m, seed=seed)
    codes = RP.encode_np(X, cb.centroids)
    Q = X[:3]
    luts = np.stack([RP.build_lut_np(q, cb.centroids, metric) for q in Q])
    ids = np.array([[0, 5, -1, n - 1, n + 3], [1, 2, 3, -1, 4],
                    [-1, -1, -1, -1, -1]], np.int32)  # a past-the-end id,
    return codes, luts, ids                           # an all-padded row


@pytest.mark.parametrize("m,d", [(4, 16), (8, 64), (32, 64)])
@pytest.mark.parametrize("metric", METRICS)
def test_adc_plain_versions_equal_numpy_oracle(metric, m, d):
    codes, luts, ids = _adc_case(metric, m=m, d=d)
    C, T, I = (torch.from_numpy(a) for a in (codes, luts, ids))
    got = ref.adc_gather_distance_batch_ref(C, T, I, metric).numpy()
    np.testing.assert_array_equal(
        got, RP.adc_distance_batch_np(codes, luts, ids, metric))
    np.testing.assert_array_equal(
        got, PP.adc_distance_batch_np(codes, luts, ids, metric))
    assert np.isinf(got[2]).all() and np.isinf(got[0, 2])
    for b in range(3):
        one = ref.adc_gather_distance_ref(C, T[b], I[b], metric).numpy()
        np.testing.assert_array_equal(
            one, RP.adc_distance_np(codes, luts[b], ids[b], metric))
        np.testing.assert_array_equal(one, got[b])


@pytest.mark.parametrize("metric", METRICS)
def test_adc_plain_versions_equal_pallas_kernels(metric):
    """The reference's Pallas kernels (interpret mode) give the same
    bits as the port's plain versions; the ops dispatch of a CPU tensor
    runs the plain version."""
    codes, luts, ids = _adc_case(metric)
    C, T, I = (torch.from_numpy(a) for a in (codes, luts, ids))
    ids_in = np.clip(ids, -1, codes.shape[0] - 1)  # the kernels' range
    want = np.asarray(adc_gather_distance_batch_pallas(
        jnp.asarray(codes), jnp.asarray(luts), jnp.asarray(ids_in),
        metric=metric, interpret=True))
    got = ops.adc_gather_distance_batch(C, T, torch.from_numpy(ids_in),
                                        metric).numpy()
    np.testing.assert_array_equal(got, want)
    one = np.asarray(adc_gather_distance_pallas(
        jnp.asarray(codes), jnp.asarray(luts[0]), jnp.asarray(ids_in[0]),
        metric=metric, interpret=True))
    np.testing.assert_array_equal(
        ops.adc_gather_distance(C, T[0], torch.from_numpy(ids_in[0]),
                                metric).numpy(), one)


@pytest.mark.parametrize("metric", METRICS)
def test_adc_equals_distance_to_decoded(metric):
    """Decode≡ADC: the ADC distance is the distance to the decoded row,
    to float32 rounding (the reference's own bound, rtol 1e-3)."""
    codes, luts, ids = _adc_case(metric)
    X, cb = _data(n=60)
    dec = torch.from_numpy(PP.decode_np(codes, cb.centroids))
    got = ops.adc_gather_distance_batch(
        torch.from_numpy(codes), torch.from_numpy(luts),
        torch.from_numpy(np.clip(ids, -1, 59)), metric)
    want = ops.gather_distance_batch(dec, torch.from_numpy(
        np.clip(ids, -1, 59)), torch.from_numpy(X[:3]), metric)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)


# ------------------------------------------------------ pq precision


@pytest.mark.parametrize("m", [8, 16, 32])
def test_pq_bytes_and_budget_accounting(m):
    dim = 64
    assert PQ.bytes_per_vector(dim, "pq", n_subspaces=m) == m == \
        RQ.bytes_per_vector(dim, "pq", n_subspaces=m)
    for budget in (0, 1, 999, 256_000):
        assert PQ.capacity_for_budget(budget, dim, "pq", n_subspaces=m) == \
            RQ.capacity_for_budget(budget, dim, "pq", n_subspaces=m)
    assert PQ.bytes_per_vector(dim, "pq") == RQ.bytes_per_vector(dim, "pq")
    with pytest.raises(ValueError):
        PQ.bytes_per_vector(dim, "pq", n_subspaces=0)


def test_pq_slab_dtype_and_scalar_codecs_refuse():
    assert PQ.slab_dtype("pq8") == torch.uint8
    assert PQ.precision_of(torch.uint8) == "pq"
    X = np.zeros((4, 8), np.float32)
    with pytest.raises(ValueError):
        PQ.quantize_np(X, "pq")
    with pytest.raises(ValueError):
        PQ.quantize(torch.from_numpy(X), "product")


# ------------------------------------------------------- pq cache


class PqPair:
    """One pq cache in each package over one codebook, driven by the same
    calls; ``check`` compares the whole state bit for bit."""

    def __init__(self, n, cap, d=16, m=4):
        X, self.cb = _data(n=max(n, 60), d=d, m=m)
        self.X = X
        self.r = RS.cache_init(n, cap, d, precision="pq", codebook=self.cb)
        self.p = PS.cache_init(n, cap, d, device=CPU, precision="pq",
                               codebook=PP.PQCodebook(self.cb.centroids))

    def insert(self, ids, policy, vecs=None):
        ids = np.asarray(ids, np.int32)
        vecs = self.X[np.maximum(ids, 0)] if vecs is None else vecs
        self.r = RS.cache_insert(self.r, jnp.asarray(ids), jnp.asarray(vecs),
                                 policy=policy)
        self.p = PS.cache_insert(self.p, torch.from_numpy(ids),
                                 torch.from_numpy(vecs), policy=policy)
        self.check()

    def check(self):
        got = convert.cache_to_numpy(self.p)
        for name in convert.CACHE_FIELDS:
            want = np.asarray(getattr(self.r, name))
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_pq_cache_insert_lookup_decodes():
    pair = PqPair(100, 50)
    c = pair.p
    assert c.slab.dtype == torch.uint8 and tuple(c.slab.shape) == (50, 4)
    assert c.nbytes() == 50 * 4 == pair.r.nbytes()
    assert c.precision == "pq"
    pair.insert([3, 7, 11], PS.EVICT_FIFO)
    present, out = PS.cache_lookup(c, torch.tensor([3, 7, 11, 5],
                                                   dtype=torch.int32))
    assert present.tolist() == [True, True, True, False]
    assert out.dtype == torch.float32
    want = RP.decode_np(RP.encode_np(pair.X[[3, 7, 11]], pair.cb.centroids),
                        pair.cb.centroids)
    np.testing.assert_array_equal(out[:3].numpy(), want)


def test_pq_cache_requires_a_codebook_that_covers_dim():
    with pytest.raises(ValueError, match="codebook"):
        PS.cache_init(50, 8, 16, device=CPU, precision="pq")
    with pytest.raises(ValueError, match="dim"):
        PS.cache_init(50, 8, 12, device=CPU, precision="pq",
                      codebook=PP.PQCodebook(np.zeros((4, 256, 4),
                                                      np.float32)))


@pytest.mark.parametrize("policy", [PS.EVICT_FIFO, PS.EVICT_LRU])
def test_pq_cache_eviction_matches_float32(policy):
    """Eviction bookkeeping is precision-independent."""
    _, cb = _data(n=50, d=16, m=4)
    cpq = PS.cache_init(50, 3, 16, device=CPU, precision="pq",
                        codebook=PP.PQCodebook(cb.centroids))
    c32 = PS.cache_init(50, 3, 16, device=CPU)
    for i in (1, 2, 3, 4, 9):
        v = torch.full((1, 16), float(i) + 0.25)
        ids = torch.tensor([i], dtype=torch.int32)
        PS.cache_insert(cpq, ids, v, policy=policy)
        PS.cache_insert(c32, ids, v, policy=policy)
    probe = torch.arange(12, dtype=torch.int32)
    assert torch.equal(PS.cache_lookup(cpq, probe)[0],
                       PS.cache_lookup(c32, probe)[0])


@pytest.mark.parametrize("policy", [PS.EVICT_FIFO, PS.EVICT_LRU])
@pytest.mark.parametrize("seed", [0, 1])
def test_pq_cache_state_matches_reference(policy, seed):
    """Random insert sequences, overflowing batches and padding rows
    included: the codes, the maps, the clock and the stamps equal the
    reference's after every step."""
    rng = np.random.default_rng(seed)
    pair = PqPair(60, 8)
    for _ in range(6):
        k = int(rng.integers(1, 12))
        ids = rng.choice(60, k, replace=False).astype(np.int32)
        ids[rng.random(k) < 0.2] = -1
        pair.insert(ids, policy)
    # decoded rows re-enter through the encoder (the fused driver's path)
    ids = np.arange(40, 48, dtype=np.int32)
    dec = RP.decode_np(RP.encode_np(pair.X[ids], pair.cb.centroids),
                       pair.cb.centroids)
    pair.insert(ids, policy, vecs=dec)


def test_pq_cache_round_trips_through_convert():
    pair = PqPair(60, 8)
    pair.insert(np.arange(10, dtype=np.int32), PS.EVICT_FIFO)
    c = pair.r
    back = convert.cache_from_reference(
        *(np.asarray(getattr(c, f)) for f in convert.CACHE_FIELDS),
        device="cpu")
    pair.p = back
    pair.check()
    with pytest.raises(ValueError, match="codebook"):
        convert.cache_from_reference(
            *(np.asarray(getattr(c, f)) for f in convert.CACHE_FIELDS[:-1]),
            device="cpu")


def test_tiered_store_pq_gather_bytes_and_resize():
    X, cb = _data(n=40, d=16, m=4)
    ts = PS.TieredStore(PS.ExternalStore(X), 8, device=CPU, precision="pq",
                        codebook=PP.PQCodebook(cb.centroids))
    rts = RS.TieredStore(RS.ExternalStore(X), 8, precision="pq", codebook=cb)
    ids = np.array([1, 3, 5], np.int32)
    # misses come back at full precision, hits decoded — the reference's
    np.testing.assert_array_equal(ts.gather(ids).numpy(), rts.gather(ids))
    np.testing.assert_array_equal(ts.gather(ids).numpy(), rts.gather(ids))
    assert ts.external.stats.n_db == rts.external.stats.n_db == 1
    rows, pos = ts.gather_batch(np.array([[1, 7, -1], [7, 9, 3]], np.int32))
    want = rts.gather_batch(np.array([[1, 7, -1], [7, 9, 3]], np.int32))
    valid = pos.numpy() >= 0
    np.testing.assert_array_equal(rows.numpy()[pos.numpy()[valid]],
                                  want[valid])
    assert ts.cache_bytes() == rts.cache_bytes() == 8 * 4
    ts.warm(np.arange(20, 28))
    rts.warm(np.arange(20, 28))
    assert np.array_equal(ts.cache.slab.numpy(), np.asarray(rts.cache.slab))
    ts.resize(4)
    assert ts.cache.slab.dtype == torch.uint8
    np.testing.assert_array_equal(ts.cache.codebook.numpy(), cb.centroids)


# ------------------------------------------------------- training


def test_train_pq_is_deterministic_for_a_seed():
    X, _ = _data(n=150, d=8)
    a = PP.train_pq(X, n_subspaces=2, n_iters=5, seed=7, device="cpu")
    b = PP.train_pq(X, n_subspaces=2, n_iters=5, seed=7, device="cpu")
    c = PP.train_pq(X, n_subspaces=2, n_iters=5, seed=8, device="cpu")
    np.testing.assert_array_equal(a.centroids, b.centroids)
    assert not np.array_equal(a.centroids, c.centroids)
    assert a.centroids.dtype == np.float32 and a.centroids.shape == (2, 256,
                                                                     4)


def test_train_pq_compresses_and_more_subspaces_help():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((300, 32)).astype(np.float32)
    errs = []
    for m in (2, 8):
        cb = PP.train_pq(X, n_subspaces=m, n_iters=8, seed=0, device="cpu")
        res = PP.residual_energy(X, cb)
        assert res.mean() < (X ** 2).sum(-1).mean()
        errs.append(res.mean())
    assert errs[1] < errs[0]
    # about as good as the reference's k-means on the same data
    ref_err = RP.residual_energy(
        X, RP.train_pq(X, n_subspaces=8, n_iters=8, seed=0)).mean()
    assert errs[1] < 1.25 * ref_err


def test_train_pq_groups_subspaces_without_changing_the_result(monkeypatch):
    """The Lloyd step's scratch limit only groups subspaces: a tiny limit
    (one subspace a group) gives the same centroids."""
    X, _ = _data(n=120, d=12, m=3)
    Xs = torch.from_numpy(np.ascontiguousarray(
        X.reshape(120, 3, 4).transpose(1, 0, 2)))
    cent = Xs[torch.arange(3)[:, None], torch.arange(256)[None, :] % 120]
    whole = PP._lloyd_step(Xs, cent).numpy()
    monkeypatch.setattr(PP, "LLOYD_SCRATCH_FLOATS", 1)
    np.testing.assert_array_equal(PP._lloyd_step(Xs, cent).numpy(), whole)


# ------------------------------------------------- engine vs the JAX engine


@pytest.fixture(scope="module")
def small_index():
    X = corpus_embeddings(500, 32, n_clusters=8, seed=3)
    eng = R.WebANNSEngine.build(
        X, M=10, ef_construction=60,
        config=R.EngineConfig(cache_capacity=125))
    rng = np.random.default_rng(5)
    Q = X[rng.choice(500, 10)] + 0.1 * rng.standard_normal(
        (10, 32)).astype(np.float32)
    return X, eng.graph, Q


K, EF = 10, 64


def _cfg(**kw):
    kw.setdefault("cache_capacity", 125)
    kw.setdefault("precision", "pq")
    kw.setdefault("pq_subspaces", 8)
    kw.setdefault("rerank_alpha", 4.0)
    return kw


def _pair(small_index, warm=True, **kw):
    """The JAX engine (its own codebook) and the port engine adopting
    that codebook through its storage backend, started from one tier 2:
    the reference's, partly warmed and carried across."""
    X, g, _ = small_index
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    ref_eng = R.WebANNSEngine(X, g, R.EngineConfig(**_cfg(**kw)))
    backend = InMemoryBackend(table)
    backend.codebook = convert.codebook_from_reference(ref_eng)
    port = P.WebANNSEngine(backend, graph,
                           P.EngineConfig(device="cpu", **_cfg(**kw)))
    if warm:
        ref_eng.warm_cache(np.arange(0, 500, 11)[:40])
        c = ref_eng.store.cache
        port.store.cache = convert.cache_from_reference(
            *(np.asarray(getattr(c, f)) for f in convert.CACHE_FIELDS),
            device="cpu")
    return ref_eng, port


def _tier2(eng):
    if isinstance(eng, P.WebANNSEngine):
        return convert.cache_to_numpy(eng.store.cache)
    return {f: np.asarray(getattr(eng.store.cache, f))
            for f in convert.CACHE_FIELDS}


def _requests(Q, driver):
    if driver in ("single", "fused"):
        return [(q, "batched") for q in Q[:4]]
    if driver == "loop":
        return [(Q, "loop")]
    return [(Q, "batched"), (Q[2:6] + 0.01, "batched")]


def _serve(ref_eng, port, requests):
    out = []
    for q, mode in requests:
        w = ref_eng.search(R.SearchRequest(query=q, k=K, ef=EF,
                                           batch_mode=mode))
        g = port.search(P.SearchRequest(query=q, k=K, ef=EF,
                                        batch_mode=mode))
        out.append((w, g, _tier2(ref_eng), _tier2(port)))
    return out


@pytest.fixture(scope="module")
def pq_results(small_index):
    done = {}

    def get(driver, eviction):
        if (driver, eviction) not in done:
            ref_eng, port = _pair(small_index, eviction=eviction,
                                  fused=driver == "fused")
            served = _serve(ref_eng, port, _requests(small_index[2], driver))
            assert ref_eng.access_stats.n_db > 1  # loads and reranks ran
            done[(driver, eviction)] = (served, ref_eng, port)
        return done[(driver, eviction)]

    return get


DRIVERS = ["single", "loop", "batched", "fused"]
COMBOS = [(d, e) for d in DRIVERS for e in ("fifo", "lru")]


def _stats(res):
    return res.stats if isinstance(res.stats, list) else [res.stats]


@pytest.mark.parametrize("driver,eviction", COMBOS)
def test_pq_engine_matches_reference(pq_results, driver, eviction):
    """Ids and reranked distances exact (both rerank in the same numpy),
    access counts exact, and the tier-2 state after each search equal to
    the reference's bit for bit; the fused driver against the fused."""
    served, ref_eng, port = pq_results(driver, eviction)
    for w, g, want, got in served:
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        np.testing.assert_array_equal(g.dists, np.asarray(w.dists))
        for ws, gs in zip(_stats(w), _stats(g)):
            for f in ("n_db", "items_fetched", "n_visited"):
                assert getattr(gs, f) == getattr(ws, f), f
        if w.batch_stats is not None:
            for f in ("batch_size", "n_db", "items_fetched", "n_phases"):
                assert getattr(g.batch_stats, f) == \
                    getattr(w.batch_stats, f), f
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    for f in ("n_db", "items_fetched", "items_used"):
        assert getattr(port.access_stats, f) == \
            getattr(ref_eng.access_stats, f)
    assert port.store.cache.slab.dtype == torch.uint8


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
def test_pq_loop_equals_batched(pq_results, eviction):
    loop = pq_results("loop", eviction)[0][0][1]
    batched = pq_results("batched", eviction)[0][0][1]
    np.testing.assert_array_equal(loop.ids, batched.ids)
    np.testing.assert_array_equal(loop.dists, batched.dists)
    assert batched.batch_stats.n_db < loop.batch_stats.n_db


@pytest.mark.parametrize("driver", ["single", "batched", "fused"])
def test_pq_without_rerank_matches_reference(small_index, driver):
    """rerank_alpha = 0 returns the ADC beam as it is: ids exact, the
    distances (ADC against the reference's decoded-row distances) to
    rtol 1e-5, atol 1e-5 — the two sum in another order."""
    ref_eng, port = _pair(small_index, rerank_alpha=0.0,
                          fused=driver == "fused")
    Q = small_index[2]
    for w, g, want, got in _serve(ref_eng, port, _requests(Q, driver)[:2]):
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        np.testing.assert_allclose(g.dists, np.asarray(w.dists), rtol=1e-5,
                                   atol=1e-5)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


def test_fused_pq_payload_is_codes(small_index):
    """The fused driver's device payload is the (N, M) uint8 codes of the
    reference's own encoder, with no float32 or int8 table; the codebook
    is tier 2's."""
    ref_eng, port = _pair(small_index, fused=True)
    _serve(ref_eng, port, [(small_index[2][0], "batched")])
    payload, scales = port._payload
    assert payload.dtype == torch.uint8 and tuple(payload.shape) == (500, 8)
    assert scales is None
    np.testing.assert_array_equal(payload.numpy(),
                                  np.asarray(ref_eng._table_dev))
    np.testing.assert_array_equal(port.store.cache.codebook.numpy(),
                                  np.asarray(ref_eng._tcodebook_dev))
    assert payload.numel() < small_index[0].nbytes / 8


def test_pq_rerank_costs_one_access(small_index):
    """A warm full tier 2: the rerank is the only tier-3 access, one for
    a single query and one for a batch."""
    _, port = _pair(small_index, warm=False, cache_capacity=500)
    port.warm_cache()
    Q = small_index[2]
    one = port.search(P.SearchRequest(query=Q[0], k=K, ef=EF))
    assert one.stats.n_db == 1 and port.access_stats.n_db == 1
    many = port.search(P.SearchRequest(query=Q, k=K, ef=EF))
    assert many.batch_stats.n_db == 1 and port.access_stats.n_db == 2


def test_pq_cache_bytes_and_resize_match_reference(small_index):
    ref_eng, port = _pair(small_index, warm=False)
    assert port.cache_bytes() == ref_eng.cache_bytes() == 125 * 8
    assert port.resize_cache_bytes(2_000, warm=True) == \
        ref_eng.resize_cache_bytes(2_000, warm=True) == 250
    assert port.cache_bytes() == ref_eng.cache_bytes()
    want, got = _tier2(ref_eng), _tier2(port)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_pq_engine_adopts_the_backends_codebook(small_index):
    """An adopted codebook is authoritative: its M overrides the
    config's; without one the engine trains its own, seeded."""
    X, g, Q = small_index
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    backend = InMemoryBackend(table)
    backend.codebook = PP.train_pq(table, n_subspaces=4, n_iters=3,
                                   device="cpu")
    eng = P.WebANNSEngine(backend, graph, P.EngineConfig(
        device="cpu", **_cfg(pq_subspaces=16)))
    assert eng.config.pq_subspaces == 4 == eng.pq_codebook.n_subspaces
    assert tuple(eng.store.cache.slab.shape) == (125, 4)
    trained = [P.WebANNSEngine(table, graph, P.EngineConfig(
        device="cpu", **_cfg())).pq_codebook for _ in range(2)]
    np.testing.assert_array_equal(trained[0].centroids, trained[1].centroids)
    res = P.WebANNSEngine(table, graph, P.EngineConfig(
        device="cpu", **_cfg(fused=True))).search(
            P.SearchRequest(query=Q[0], k=K, ef=EF))
    assert res.ids.shape == (K,) and np.isfinite(res.dists).all()


def test_pq_config_is_validated_as_the_reference():
    with pytest.raises(ValueError):
        P.EngineConfig(device="cpu", precision="pq", n_shards=2)
    with pytest.raises(ValueError):
        R.EngineConfig(precision="pq", n_shards=2)
    with pytest.raises(ValueError):
        P.EngineConfig(device="cpu", precision="pq", pq_subspaces=0)
    with pytest.raises(ValueError):
        convert.codebook_from_reference(
            R.WebANNSEngine.__new__(R.WebANNSEngine))
