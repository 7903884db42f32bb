"""Port tier-2/tier-3 store against the JAX package's, case for case.

Replays the float32 FIFO/LRU cases of ``test_store.py`` and
``test_store_edge.py`` on both packages and compares the whole cache
state after each step (slab, both maps, clock, LRU stamps), plus the
tier-3 counters of ``TieredStore.gather`` / ``gather_batch`` / ``warm``.
The quantized cases (float16, int8 with its per-row scales) compare the
slab and the scales the same way. The store only moves, selects and
quantizes values with one IEEE operation a step, so every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import store as R
from repro_torch.core import quant as PQ
from repro_torch.core import store as P

CPU = torch.device("cpu")
POLICIES = [R.EVICT_FIFO, R.EVICT_LRU]


def _vec(i, d=4):
    return np.full((d,), float(i), np.float32)


def _vecs(ids, d=4):
    return np.stack([_vec(max(int(i), 0), d) for i in ids])


class Pair:
    """One cache in each package, driven by the same calls."""

    def __init__(self, n, cap, d=4):
        self.r = R.cache_init(n, cap, d)
        self.p = P.cache_init(n, cap, d, device=CPU)
        self.d = d

    def insert(self, ids, policy=R.EVICT_FIFO, vecs=None):
        ids = np.asarray(ids, np.int32)
        vecs = _vecs(ids, self.d) if vecs is None else vecs
        self.r = R.cache_insert(self.r, jnp.asarray(ids), jnp.asarray(vecs),
                                policy=policy)
        self.p = P.cache_insert(self.p, torch.from_numpy(ids),
                                torch.from_numpy(vecs), policy=policy)
        self.check()

    def touch(self, ids):
        ids = np.asarray(ids, np.int32)
        self.r = R.cache_touch(self.r, jnp.asarray(ids))
        self.p = P.cache_touch(self.p, torch.from_numpy(ids))
        self.check()

    def lookup(self, ids):
        ids = np.asarray(ids, np.int32)
        rp, rv = R.cache_lookup(self.r, jnp.asarray(ids))
        pp, pv = P.cache_lookup(self.p, torch.from_numpy(ids))
        np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
        present = np.asarray(rp)
        np.testing.assert_array_equal(pv.numpy()[present],
                                      np.asarray(rv)[present])
        return present, pv.numpy()

    def check(self):
        assert_same_cache(self.p, self.r)


def assert_same_cache(p, r):
    for name in ("slot_of", "id_of", "last_used"):
        np.testing.assert_array_equal(
            getattr(p, name).numpy(), np.asarray(getattr(r, name)),
            err_msg=name,
        )
    assert int(p.clock) == int(r.clock)
    live = np.asarray(r.id_of) >= 0  # empty slots hold garbage in both
    np.testing.assert_array_equal(p.slab.numpy()[live],
                                  np.asarray(r.slab)[live])


# ------------------------------------------------------ cache primitives


def test_insert_then_lookup():
    c = Pair(100, 8)
    c.insert([3, 7, 11])
    present, out = c.lookup([3, 7, 11, 5])
    assert present.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(out[0], _vec(3))


@pytest.mark.parametrize("policy", POLICIES)
def test_padding_ids_ignored(policy):
    c = Pair(100, 8)
    c.insert([-1, 5, -1], policy)
    assert c.lookup([5, -1])[0].tolist() == [True, False]
    assert int((c.p.id_of >= 0).sum()) == 1


def test_fifo_eviction_order():
    c = Pair(100, 3)
    for i in (1, 2, 3, 4):
        c.insert([i])
    assert c.lookup([1, 2, 3, 4])[0].tolist() == [False, True, True, True]


def test_lru_eviction_respects_touch():
    c = Pair(100, 3)
    for i in (1, 2, 3):
        c.insert([i], R.EVICT_LRU)
    c.touch([1])
    c.insert([4], R.EVICT_LRU)
    p = c.lookup([1, 2, 3, 4])[0]
    assert p[0] and p[3] and not all(p[1:3])


def test_lru_victims_tie_to_lower_slot():
    """Equal stamps: the stalest slots are taken lowest slot first
    (``lax.top_k``'s order, a stable ascending sort in the port)."""
    c = Pair(100, 6)
    c.insert([10, 11, 12, 13, 14, 15], R.EVICT_LRU)  # one stamp for all
    c.touch([12, 14])
    c.insert([20, 21], R.EVICT_LRU)
    c.insert([22, 23, 24], R.EVICT_LRU)


@pytest.mark.parametrize("policy", POLICIES)
def test_reinsert_is_noop(policy):
    c = Pair(100, 4)
    c.insert([5], policy)
    c.insert([5], policy, vecs=_vec(9)[None])
    np.testing.assert_array_equal(c.lookup([5])[1][0], _vec(5))


def test_cache_wrap_consistency():
    c = Pair(50, 4, d=2)
    c.insert(np.arange(10))
    present, out = c.lookup(np.arange(10))
    assert present.sum() <= 4
    for i in np.nonzero(present)[0]:
        np.testing.assert_array_equal(out[i], _vec(i, 2))


@pytest.mark.parametrize("policy", POLICIES)
def test_overflowing_insert_keeps_newest(policy):
    cap, k = 4, 11
    c = Pair(50, cap, d=2)
    c.insert(np.arange(k), policy)
    present, out = c.lookup(np.arange(k))
    assert present.tolist() == [False] * (k - cap) + [True] * cap
    for i in range(k - cap, k):
        np.testing.assert_array_equal(out[i], _vec(i, 2))


@pytest.mark.parametrize("policy", POLICIES)
def test_overflowing_insert_with_padding_rows(policy):
    c = Pair(50, 3, d=2)
    c.insert([5, -1, 6, 7, -1, 8, 9], policy)
    assert c.lookup([5, 6, 7, 8, 9])[0].tolist() == [
        False, False, True, True, True]


def test_insert_batch_roundtrip():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((3, 4, 8)).astype(np.float32)
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    ids[1, 2] = -1
    r = R.cache_insert_batch(R.cache_init(64, 16, 8), jnp.asarray(ids),
                             jnp.asarray(vecs))
    p = P.cache_insert_batch(P.cache_init(64, 16, 8, device=CPU),
                             torch.from_numpy(ids), torch.from_numpy(vecs))
    assert_same_cache(p, r)
    present, got = P.cache_lookup_batch(p, torch.from_numpy(ids))
    np.testing.assert_array_equal(present.numpy(), ids >= 0)
    np.testing.assert_array_equal(got.numpy()[ids >= 0], vecs[ids >= 0])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_insert_touch_sequences(policy, seed):
    """Seeded random sequences of padded, sometimes overflowing batches
    and touches: the two caches agree after every step."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 9))
    c = Pair(30, cap, d=2)
    for _ in range(25):
        if policy == R.EVICT_LRU and rng.random() < 0.3:
            c.touch(rng.integers(-1, 30, int(rng.integers(1, 6))))
            continue
        ids = rng.choice(30, int(rng.integers(1, 2 * cap + 3)), replace=False)
        ids = np.where(rng.random(len(ids)) < 0.2, -1, ids)
        c.insert(ids, policy, vecs=_vecs(ids, 2))


# ------------------------------------------------------ quantized tier 2

QUANT = ["float16", "int8"]


def _qvecs(ids, d=6, seed=0):
    """Rows of distinct magnitudes, so every int8 row has its own scale."""
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((len(ids), d)).astype(np.float32)
    return out * (1.0 + np.arange(len(ids), dtype=np.float32))[:, None]


class QPair(Pair):
    """A quantized cache in each package; ``check`` compares the whole
    state, the slab and the scales included, bit for bit."""

    def __init__(self, n, cap, precision, d=6):
        self.r = R.cache_init(n, cap, d, precision=precision)
        self.p = P.cache_init(n, cap, d, device=CPU, precision=precision)
        self.d = d

    def insert(self, ids, policy=R.EVICT_FIFO, vecs=None):
        ids = np.asarray(ids, np.int32)
        super().insert(ids, policy,
                       _qvecs(ids, self.d) if vecs is None else vecs)

    def check(self):
        assert_same_cache(self.p, self.r)
        assert self.p.slab.dtype == PQ.slab_dtype(self.r.precision)
        np.testing.assert_array_equal(self.p.slab.numpy(),
                                      np.asarray(self.r.slab))
        np.testing.assert_array_equal(self.p.scales.numpy(),
                                      np.asarray(self.r.scales))


@pytest.mark.parametrize("precision", QUANT)
def test_quantized_insert_lookup_dequantizes(precision):
    c = QPair(100, 8, precision)
    c.insert([3, 7, 11, -1])
    present, out = c.lookup([3, 7, 11, 5])  # float32 rows, equal to ref's
    assert present.tolist() == [True, True, True, False]
    assert out.dtype == np.float32
    want = _qvecs(np.array([3, 7, 11, -1], np.int32), 6)[:3]
    err = np.abs(out[:3] - want)
    bound = PQ.max_abs_error(np.abs(want).max(-1), precision)
    assert (err <= bound[:, None] + 1e-6).all() and err.max() > 0
    assert c.p.precision == precision
    assert c.p.nbytes() == 8 * PQ.bytes_per_vector(6, precision)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("precision", QUANT)
def test_quantized_eviction_matches_reference(precision, policy):
    c = QPair(60, 5, precision)
    rng = np.random.default_rng(3)
    for step in range(12):
        if policy == R.EVICT_LRU and step % 3 == 2:
            c.touch(rng.integers(-1, 60, 4))
            continue
        ids = rng.choice(60, int(rng.integers(1, 9)), replace=False)
        ids = np.where(rng.random(len(ids)) < 0.2, -1, ids)
        c.insert(ids, policy, vecs=_qvecs(ids, 6, seed=step))
        c.lookup(rng.integers(-1, 60, 10))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("precision", QUANT)
def test_quantized_overflow_keeps_newest_row_with_its_scale(precision,
                                                            policy):
    """An insert wider than the cache, with duplicate ids in it: rows
    that recycle a slot keep the newest, and an int8 slot's scale comes
    from the same row as its payload."""
    cap = 4
    c = QPair(50, cap, precision)
    ids = np.array([5, 6, 7, 5, 8, 9, 6, 10, 11, 12, 7], np.int32)
    vecs = _qvecs(ids, 6, seed=9)
    c.insert(ids, policy, vecs=vecs)
    live = c.p.id_of.numpy()
    assert sorted(live.tolist()) == sorted(set(ids[-cap:].tolist()))
    # each live slot holds the quantization of the row that won it: the
    # last row of the batch with that id
    payload, scales = PQ.quantize_np(vecs, precision)
    for slot, i in enumerate(live):
        row = np.nonzero(ids == i)[0][-1]
        np.testing.assert_array_equal(c.p.slab.numpy()[slot], payload[row])
        if precision == "int8":
            assert c.p.scales.numpy()[slot] == scales[row]


def test_cache_insert_batch_quantized():
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    ids[1, 2] = -1
    vecs = _qvecs(ids.reshape(-1), 8).reshape(3, 4, 8)
    r = R.cache_insert_batch(R.cache_init(64, 16, 8, precision="int8"),
                             jnp.asarray(ids), jnp.asarray(vecs))
    p = P.cache_insert_batch(
        P.cache_init(64, 16, 8, device=CPU, precision="int8"),
        torch.from_numpy(ids), torch.from_numpy(vecs))
    assert_same_cache(p, r)
    np.testing.assert_array_equal(p.slab.numpy(), np.asarray(r.slab))
    np.testing.assert_array_equal(p.scales.numpy(), np.asarray(r.scales))
    present, got = P.cache_lookup_batch(p, torch.from_numpy(ids))
    _, want = R.cache_lookup_batch(r, jnp.asarray(ids))
    valid = ids >= 0
    np.testing.assert_array_equal(present.numpy(), valid)
    np.testing.assert_array_equal(got.numpy()[valid], np.asarray(want)[valid])


def test_float_slabs_carry_no_scales():
    for precision in ("float32", "float16"):
        c = P.cache_init(10, 4, 3, device=CPU, precision=precision)
        assert tuple(c.scales.shape) == (0,) and c.row_scales() is None
    c = P.cache_init(10, 4, 3, device=CPU, precision="int8")
    assert c.row_scales() is c.scales and tuple(c.scales.shape) == (4,)
    # a pq slab needs its codebook (tests/test_torch_pq.py), as in the
    # reference
    with pytest.raises(ValueError, match="codebook"):
        P.cache_init(10, 4, 3, device=CPU, precision="pq")


def _qstores(precision, n=30, d=6, cap=8, eviction="fifo"):
    X = _qvecs(np.arange(n), d, seed=4)
    return (X, R.TieredStore(R.ExternalStore(X), cap, eviction,
                             precision=precision),
            P.TieredStore(P.ExternalStore(X), cap, eviction, device=CPU,
                          precision=precision))


def _same_qstate(rs, ps):
    _same_stats(rs, ps)
    np.testing.assert_array_equal(ps.cache.slab.numpy(),
                                  np.asarray(rs.cache.slab))
    np.testing.assert_array_equal(ps.cache.scales.numpy(),
                                  np.asarray(rs.cache.scales))


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
@pytest.mark.parametrize("precision", QUANT)
def test_quantized_gather_rows_and_state(precision, eviction):
    """A hit comes back as its dequantized slab row and a miss as the
    full-precision fetched row, as in the reference; the cache holds the
    quantized rows."""
    X, rs, ps = _qstores(precision, cap=5, eviction=eviction)
    for ids in ([1, 3, 5], [1, 3, 5], [2, 3, 9, 11], [4, 6, 8, 10, 12, 14],
                [1, 2, 14]):
        ids = np.asarray(ids, np.int32)
        hits = P.cache_slots(ps.cache, torch.from_numpy(ids))[0].numpy()
        want = rs.gather(ids)
        got = ps.gather(ids).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[~hits], X[ids[~hits]])
        if hits.any():  # a dequantized row differs from the original
            assert not np.array_equal(got[hits], X[ids[hits]])
        _same_qstate(rs, ps)


@pytest.mark.parametrize("precision", QUANT)
def test_quantized_gather_batch_warm_resize(precision):
    X, rs, ps = _qstores(precision, cap=6, eviction="lru")
    ids = np.array([[1, 2, 7, -1], [2, 1, 3, -1], [7, 3, 1, 2]], np.int32)
    for store in (rs, ps):
        store.warm(np.array([2, 3], np.int32))
    want = rs.gather_batch(ids)
    rows, pos = ps.gather_batch(ids)
    valid = ids >= 0
    np.testing.assert_array_equal(rows.numpy()[pos.numpy()[valid]],
                                  want[valid])
    _same_qstate(rs, ps)
    assert ps.cache_bytes() == rs.cache_bytes() == \
        6 * PQ.bytes_per_vector(6, precision)
    for store in (rs, ps):
        store.resize(3)
    _same_qstate(rs, ps)
    assert ps.cache.slab.dtype == PQ.slab_dtype(precision)


# --------------------------------------------------------------- tier 3


def test_external_store_counters_and_cost():
    X = np.arange(40, dtype=np.float32).reshape(10, 4)
    ext = P.ExternalStore(X, t_setup=1e-3, t_per_item=1e-5)
    np.testing.assert_array_equal(ext.fetch(np.array([2, 5, -1])), X[[2, 5]])
    assert (ext.stats.n_db, ext.stats.items_fetched) == (1, 2)
    assert abs(ext.stats.modeled_time - (1e-3 + 2e-5)) < 1e-9


def test_allinone_cheaper_than_sequential():
    X = np.zeros((100, 4), np.float32)
    a, b = P.ExternalStore(X), P.ExternalStore(X)
    a.fetch(np.arange(50))
    b.fetch_sequential(np.arange(50))
    assert a.stats.modeled_time < b.stats.modeled_time / 10
    assert (a.stats.n_db, b.stats.n_db) == (1, 50)


def _stores(n=30, d=4, cap=8, eviction="fifo"):
    X = np.arange(n * d, dtype=np.float32).reshape(n, d)
    return (X, R.TieredStore(R.ExternalStore(X), cap, eviction),
            P.TieredStore(P.ExternalStore(X), cap, eviction, device=CPU))


def _same_stats(rs, ps):
    for f in ("n_db", "items_fetched", "items_used"):
        assert getattr(ps.external.stats, f) == getattr(rs.external.stats, f), f
    assert (ps.hits, ps.misses) == (rs.hits, rs.misses)
    assert_same_cache(ps.cache, rs.cache)


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
def test_gather_counts_and_rows(eviction):
    X, rs, ps = _stores(cap=5, eviction=eviction)
    for ids in ([1, 3, 5], [1, 3, 5], [2, 3, 9, 11], [4, 6, 8, 10, 12, 14],
                [1, 2]):
        ids = np.asarray(ids, np.int32)
        want = rs.gather(ids)
        got = ps.gather(ids).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, X[ids])
        _same_stats(rs, ps)


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
def test_gather_batch_counts_and_rows(eviction):
    X, rs, ps = _stores(cap=6, eviction=eviction)
    batches = [
        np.full((3, 5), -1, np.int32),  # all padding: no access at all
        np.array([[1, 2, 7, -1], [2, 1, 3, -1], [7, 3, 1, 2]], np.int32),
        np.arange(12, dtype=np.int32).reshape(3, 4),  # union > capacity
    ]
    for ids in batches:
        want = rs.gather_batch(ids)
        rows, pos = ps.gather_batch(ids)
        pos = pos.numpy()
        valid = ids >= 0
        np.testing.assert_array_equal(pos < 0, ~valid)
        np.testing.assert_array_equal(rows.numpy()[pos[valid]], want[valid])
        np.testing.assert_array_equal(want[valid], X[ids[valid]])
        _same_stats(rs, ps)
    assert ps.external.stats.n_db == 2  # one access per non-empty batch
    assert ps.external.stats.items_fetched == 4 + 8  # union minus hits


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
def test_warm_is_uncounted(eviction):
    X, rs, ps = _stores(cap=8, eviction=eviction)
    for ids in (np.arange(8), np.array([], np.int32), np.arange(5, 15)):
        rs.warm(ids)
        ps.warm(ids)
        _same_stats(rs, ps)
    assert ps.external.stats.n_db == 0
    # warmed rows are hits for the next gather
    np.testing.assert_array_equal(ps.gather(np.arange(7, 15)).numpy(),
                                  X[7:15])
    assert ps.external.stats.n_db == 0


def test_resize_resets():
    X, rs, ps = _stores()
    ps.gather(np.array([1, 2, 3], np.int32))
    ps.resize(4)
    assert ps.capacity == 4 and ps.cache_bytes() == 4 * 4 * 4
    assert not bool(ps.lookup(torch.tensor([1], dtype=torch.int32))[0][0])
