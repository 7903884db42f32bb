"""The device-resident search loop and the fixed-shape tier-2 insert, on
the CPU.

A phase of the port is a loop of fixed-shape hop steps
(``search.batch_hop_step``) that the host checks once every
``search.STEPS_PER_SYNC`` steps; the fused driver's phases are one
masked step. On the card those steps replay from CUDA graphs
(``core/step_graph.py``, held to the eager loop in
``tests/test_torch_cuda.py``); here the same loop runs eagerly. Checked
here, all bit for bit:

- the K-step loop equals the loop that checks before every step (the
  port's loop before it had K) for K in {1, 2, 3, 8, 64}, on every state
  tensor after every phase and on tier 2, at B = 1 and B = 32, at
  float32 and int8; the fused driver's layer too, at every precision;
- steps taken after every query has stopped change no state tensor
  (hypothesis);
- the host checks once every K steps;
- ``store.cache_insert`` equals the JAX package's ``cache_insert`` on
  random inserts with padding, repeats and overflow past capacity, FIFO
  and LRU, at float32, float16, int8 and pq, and an insert that is not
  enabled changes nothing;
- the fused driver's device counters equal the JAX package's ``n_db``
  and ``n_fetch``;
- every beam that the seed, a hop step, a load phase, the fused driver's
  masked step or a short search of each driver leaves is sorted by
  (dist, position), sentinels last.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core import engine as R
from repro.core import store as RS
from repro_torch import convert
from repro_torch.core import engine as P
from repro_torch.core import pq as PPQ
from repro_torch.core import quant
from repro_torch.core import search as S
from repro_torch.core import step_graph
from repro_torch.core import store as PS
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.storage import InMemoryBackend

CPU = torch.device("cpu")
KS = [1, 2, 3, 8, 64]
EF = 16
N, D = 400, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The steps here are many small ops: one torch thread runs them
    faster than several, and does not crowd the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((N, D)).astype(np.float32)
    g = build_hnsw(X, M=6, ef_construction=40, seed=4)
    nbrs = torch.from_numpy(np.asarray(g.neighbors, np.int32))
    Q = (X[rng.choice(N, 32)]
         + 0.3 * rng.standard_normal((32, D))).astype(np.float32)
    return X, g, nbrs, torch.from_numpy(Q)


def _tensors(state):
    return S._state_tensors(state)


def _assert_same_state(got, want):
    names = ("ids", "dists", "explored", "visited", "miss_ids", "miss_count",
             "n_hops", "n_dist")
    for name, g, w in zip(names, _tensors(got), _tensors(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def _old_phase(Q, nbrs_l, s, tier2, trigger):
    """The phase as the port ran it before the K-step loop: check on the
    host before every step, stop before the first step with no active
    query."""
    while True:
        nxt, active = S.batch_hop_step(Q, nbrs_l, s, tier2, "l2", trigger)
        if not bool(active.any()):
            return s
        s = nxt


def _store(X, precision):
    store = PS.TieredStore(PS.ExternalStore(X), capacity=N // 4,
                           device=CPU, precision=precision)
    store.warm(np.arange(0, N, 7)[: N // 8])
    return store


def _layer_trace(index, B, precision, phase):
    """One layer-0 search of B queries by the batched host driver's
    steps, from a partly warm 25% tier 2: the state after every phase and
    load, and tier 2 at the end."""
    X, g, nbrs, Q = index
    store = _store(X, precision)
    Qt = Q[:B]
    miss_cap = EF + nbrs.shape[2] + 1
    states = S.batch_make_state(B, EF, miss_cap, N, CPU)
    entry = torch.full((B, 1), int(g.entry_point), dtype=torch.int32)
    states = S.batch_seed_state(states, Qt, entry,
                                S.cache_tier2(store.cache), "l2")
    trace = [states]
    for _ in range(100):
        states = phase(Qt, nbrs[0], states, S.cache_tier2(store.cache), EF)
        trace.append(states)
        if int(states.miss_count.sum()) == 0:
            break
        rows, pos = store.gather_batch(states.miss_ids.numpy())
        states = S.batch_load_phase(Qt, states, states.miss_ids, rows, pos,
                                    "l2")
        trace.append(states)
    return trace, convert.cache_to_numpy(store.cache)


@pytest.fixture(scope="module")
def old_traces(index):
    done = {}

    def get(B, precision):
        if (B, precision) not in done:
            done[(B, precision)] = _layer_trace(index, B, precision,
                                                _old_phase)
        return done[(B, precision)]

    return get


def _k_phase(Q, nbrs_l, s, tier2, trigger):
    return S.batch_search_phase(Q, nbrs_l, s, tier2, "l2", trigger)


@pytest.mark.parametrize("precision", ["float32", "int8"])
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("K", KS)
def test_k_step_loop_equals_checking_every_step(index, old_traces,
                                                monkeypatch, K, B,
                                                precision):
    monkeypatch.setattr(S, "STEPS_PER_SYNC", K)
    want, want_cache = old_traces(B, precision)
    got, got_cache = _layer_trace(index, B, precision, _k_phase)
    assert len(want) > 4  # several phases, with loads from tier 3
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_state(g, w)
    for name in convert.CACHE_FIELDS:
        np.testing.assert_array_equal(got_cache[name], want_cache[name],
                                      err_msg=name)


@pytest.mark.parametrize("K", [1, 3, 8])
def test_the_loop_checks_once_every_k_steps(index, monkeypatch, K):
    """A phase whose queries stay active for T steps (the largest hop
    count it adds) ends at the first check after a block whose last
    step had none active: T // K + 1 checks."""
    X, g, nbrs, Q = index
    tier2 = S.resident_tier2(torch.from_numpy(X))  # one long phase
    B = 32
    states = S.batch_make_state(B, EF, 1, N, CPU)
    states = S.batch_seed_state(
        states, Q, torch.full((B, 1), int(g.entry_point), dtype=torch.int32),
        tier2, "l2")
    monkeypatch.setattr(S, "STEPS_PER_SYNC", K)
    step_graph.reset_stats()
    out = S.batch_search_phase(Q, nbrs[0], states, tier2, "l2", 2)
    T = int((out.n_hops - states.n_hops).max())
    assert T > 8
    assert step_graph.stats["syncs"] == T // K + 1
    assert step_graph.stats["replays"] == 0  # no graph on the CPU


# ------------------------------------- steps after the end change nothing


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 10_000), B=st.integers(1, 6),
       ef=st.sampled_from([1, 4, 8]), eager=st.booleans(),
       precision=st.sampled_from(["float32", "float16", "int8"]),
       extra=st.integers(1, 4), cap=st.integers(1, N))
def test_steps_after_every_query_stops_change_nothing(index, seed, B, ef,
                                                      eager, precision,
                                                      extra, cap):
    X, g, nbrs, _ = index
    rng = np.random.default_rng(seed)
    Q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    store = PS.TieredStore(PS.ExternalStore(X), capacity=cap, device=CPU,
                           precision=precision)
    store.warm(rng.choice(N, min(cap, N), replace=False))
    tier2 = S.cache_tier2(store.cache)
    trigger = 1 if eager else ef
    states = S.batch_make_state(B, ef, ef + nbrs.shape[2] + 1, N, CPU)
    entry = torch.from_numpy(rng.integers(0, N, (B, 2)).astype(np.int32))
    states = S.batch_seed_state(states, Q, entry, tier2, "l2")
    done = S.batch_search_phase(Q, nbrs[0], states, tier2, "l2", trigger)
    s = done
    for _ in range(extra):
        s, active = S.batch_hop_step(Q, nbrs[0], s, tier2, "l2", trigger)
        assert not bool(active.any())
        _assert_same_state(s, done)


# ------------------------------------------------------ the fused layer


def _fused_setup(index, precision, eviction):
    X, g, nbrs, Q = index
    codebook = None
    if precision == "pq":
        rng = np.random.default_rng(3)
        codebook = PPQ.PQCodebook(
            rng.standard_normal((4, 256, D // 4)).astype(np.float32))
    store = PS.TieredStore(PS.ExternalStore(X), capacity=N // 4, device=CPU,
                           precision=precision, eviction=eviction,
                           codebook=codebook)
    store.warm(np.arange(0, N, 7)[: N // 8])
    if precision == "pq":
        payload = torch.from_numpy(PPQ.encode_np(X, codebook.centroids))
        scales = None
    else:
        p, sc = quant.quantize_np(X, precision)
        payload = torch.from_numpy(p)
        scales = torch.from_numpy(sc) if p.dtype == np.int8 else None
    return store, payload, scales


def _old_fused_layer(q, nbrs_l, payload, scales, cache, entry_ids, ef,
                     eviction, luts, max_phases=256):
    """The fused layer as the port ran it before its phases became one
    masked step: a host loop over phases, a sync on the miss count of
    each."""
    n = nbrs_l.shape[0]
    miss_cap = ef + nbrs_l.shape[1] + 1
    state = S.make_state(ef, miss_cap, n, CPU)
    state = S.seed_state(state, q, entry_ids, S.cache_tier2(cache, luts),
                         "l2")
    n_db = n_fetch = 0
    for _ in range(max_phases):
        state = S._first(_old_phase(q[None], nbrs_l, S._one(state),
                                    S.cache_tier2(cache, luts), ef))
        mc = int(state.miss_count)
        ids = state.miss_ids
        safe = ids.long().clamp(0, n - 1)
        if payload.dtype == torch.uint8:
            rows = PPQ.decode(payload[safe], cache.codebook)
        else:
            rows = quant.dequantize(
                payload[safe], None if scales is None else scales[safe])
        PS.cache_insert(cache, ids, rows, policy=eviction)
        state = S.load_phase(q, state, ids, payload, ids, "l2", scales, luts)
        n_db += int(mc > 0)
        n_fetch += mc
        if mc == 0:
            break
    return state, n_db, n_fetch


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
@pytest.mark.parametrize("precision", ["float32", "float16", "int8", "pq"])
@pytest.mark.parametrize("K", KS)
def test_fused_layer_equals_the_phase_loop(index, monkeypatch, K, precision,
                                           eviction):
    """The fused layer's masked step, K steps a check, against the host
    phase loop it replaces: every state tensor, the counters, tier 2."""
    monkeypatch.setattr(S, "STEPS_PER_SYNC", K)
    X, g, nbrs, Q = index
    runs = []
    for fn in ("old", "new"):
        store, payload, scales = _fused_setup(index, precision, eviction)
        cache = store.cache
        out = []
        entry = torch.tensor([int(g.entry_point)], dtype=torch.int32)
        for q in Q[:3]:
            luts = (PPQ.build_lut(q, cache.codebook, "l2")[None]
                    if precision == "pq" else None)
            if fn == "old":
                st_, db, fc = _old_fused_layer(
                    q, nbrs[0], payload, scales, cache, entry, EF,
                    store.eviction, luts)
            else:
                st_, cache, db, fc = S.search_layer_lazy_fused(
                    q, nbrs[0], payload, scales, cache, entry, EF, "l2",
                    eviction=store.eviction, luts=luts)
                assert db.dtype == fc.dtype == torch.int64 and db.dim() == 0
                db, fc = int(db), int(fc)
            out.append((st_, db, fc, convert.cache_to_numpy(cache)))
        runs.append(out)
    assert sum(db for _, db, _, _ in runs[0]) > 1
    for (sw, dw, fw, cw), (sg, dg, fg, cg) in zip(*runs):
        _assert_same_state(sg, sw)
        assert (dg, fg) == (dw, fw)
        for name in convert.CACHE_FIELDS:
            np.testing.assert_array_equal(cg[name], cw[name], err_msg=name)


# ------------------------------------------------- the fixed-shape insert


def _pq_centroids(D_, M=4):
    rng = np.random.default_rng(17)
    return rng.standard_normal((M, 256, D_ // M)).astype(np.float32)


def _cache_pair(n, cap, d, precision):
    if precision == "pq":
        cent = _pq_centroids(d)
        return (RS.cache_init(n, cap, d, precision="pq", codebook=cent),
                PS.cache_init(n, cap, d, device=CPU, precision="pq",
                              codebook=PPQ.PQCodebook(cent)))
    return (RS.cache_init(n, cap, d, precision=precision),
            PS.cache_init(n, cap, d, device=CPU, precision=precision))


def _assert_same_cache(port, ref):
    got = convert.cache_to_numpy(port)
    for name in convert.CACHE_FIELDS:
        want = np.asarray(getattr(ref, name))
        if name == "slab":  # empty slots hold garbage in both
            live = np.asarray(ref.id_of) >= 0
            got_, want = got[name][live], want[live]
        else:
            got_ = got[name]
        assert got_.dtype == want.dtype, name
        np.testing.assert_array_equal(got_, want, err_msg=name)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", [RS.EVICT_FIFO, RS.EVICT_LRU])
@pytest.mark.parametrize("precision", ["float32", "float16", "int8", "pq"])
def test_cache_insert_equals_reference(precision, policy, seed):
    """Random batches of unique ids with -1 padding, ids already cached
    and batches past capacity (keep-newest), LRU touches between them:
    the whole tier-2 state equal to the reference's after every call."""
    rng = np.random.default_rng(seed)
    n, cap, d = 60, 8, 8
    k = 2 * cap + 2  # one shape, so the reference compiles once
    ref, port = _cache_pair(n, cap, d, precision)
    for _ in range(14):
        ids = rng.choice(n, k, replace=False).astype(np.int32)
        # from all padding to no padding: batches below and past capacity
        ids[rng.random(k) < rng.random()] = -1
        vecs = rng.standard_normal((k, d)).astype(np.float32)
        ref = RS.cache_insert(ref, jnp.asarray(ids), jnp.asarray(vecs),
                              policy=policy)
        port = PS.cache_insert(port, torch.from_numpy(ids),
                               torch.from_numpy(vecs), policy=policy)
        _assert_same_cache(port, ref)
        if policy == RS.EVICT_LRU and rng.random() < 0.5:
            touch = rng.choice(n, 5, replace=False).astype(np.int32)
            ref = RS.cache_touch(ref, jnp.asarray(touch))
            port = PS.cache_touch(port, torch.from_numpy(touch))
            _assert_same_cache(port, ref)


@pytest.mark.parametrize("policy", [PS.EVICT_FIFO, PS.EVICT_LRU])
@pytest.mark.parametrize("precision", ["float32", "float16", "int8", "pq"])
def test_cache_insert_gated_off_changes_nothing(precision, policy):
    """``enable`` False: no tensor changes, the clock included; True: the
    same bits as an insert without ``enable``."""
    rng = np.random.default_rng(1)
    n, cap, d = 40, 6, 8
    _, a = _cache_pair(n, cap, d, precision)
    PS.cache_insert(a, torch.arange(0, 5, dtype=torch.int32),
                    torch.from_numpy(rng.standard_normal((5, d))
                                     .astype(np.float32)), policy)
    b = dataclasses.replace(a, **{f: getattr(a, f).clone()
                                  for f in convert.CACHE_FIELDS})
    ids = torch.tensor([3, 9, -1, 12, 20, 21, 22, 23], dtype=torch.int32)
    vecs = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))
    before = convert.cache_to_numpy(a)
    PS.cache_insert(a, ids, vecs, policy, enable=torch.tensor(False))
    after = convert.cache_to_numpy(a)
    for name in convert.CACHE_FIELDS:
        np.testing.assert_array_equal(after[name], before[name],
                                      err_msg=name)
    PS.cache_insert(a, ids, vecs, policy, enable=torch.tensor(True))
    PS.cache_insert(b, ids, vecs, policy)
    got, want = convert.cache_to_numpy(a), convert.cache_to_numpy(b)
    for name in convert.CACHE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_cache_clock_is_updated_in_place():
    """A CUDA graph that captured an insert reads and writes the clock
    tensor it was given: the cache ops never rebind it."""
    for policy in (PS.EVICT_FIFO, PS.EVICT_LRU):
        c = PS.cache_init(20, 4, 3, device=CPU)
        clock = c.clock
        PS.cache_insert(c, torch.tensor([1, 2], dtype=torch.int32),
                        torch.ones((2, 3)), policy)
        PS.cache_insert(c, torch.zeros((0,), dtype=torch.int32),
                        torch.ones((0, 3)), policy)
        PS.cache_touch(c, torch.tensor([1], dtype=torch.int32))
        assert c.clock is clock and int(clock) == 3


# ------------------------------------------ the fused driver's counters


@pytest.mark.parametrize("eviction", ["fifo", "lru"])
@pytest.mark.parametrize("precision", ["float32", "float16", "int8", "pq"])
def test_fused_device_counters_equal_reference(small_dataset, small_graph,
                                               precision, eviction):
    """``lazy_knn_search_fused`` keeps ``n_db`` and ``n_fetch`` as device
    tensors; read after each query they equal the counts of the JAX
    package's fused driver (no rerank, so its counts are the search's),
    and tier 2 equals the reference's after each query."""
    X, Qs = small_dataset
    g = small_graph
    graph, table = convert.from_reference(
        X, g.neighbors, g.levels, g.entry_point, g.max_level, g.M, g.metric)
    kw = dict(eviction=eviction, cache_capacity=len(X) // 4, metric="l2",
              precision=precision, fused=True, rerank_alpha=0.0)
    source = table
    if precision == "pq":
        kw["pq_subspaces"] = 8
    ref = R.WebANNSEngine(X, g, R.EngineConfig(**kw))
    if precision == "pq":
        source = InMemoryBackend(table)
        source.codebook = convert.codebook_from_reference(ref)
    port = P.WebANNSEngine(source, graph, P.EngineConfig(device="cpu", **kw))
    ref.warm_cache(np.arange(0, len(X), 9)[: len(X) // 8])
    c = ref.store.cache
    port.store.cache = convert.cache_from_reference(
        *(np.asarray(getattr(c, f)) for f in convert.CACHE_FIELDS),
        device="cpu")
    payload, scales = port._fused_payload()
    for q in Qs[:4]:
        w = ref.search(R.SearchRequest(query=q, k=10, ef=EF))
        dists, ids, (n_db, n_fetch), cache = S.lazy_knn_search_fused(
            torch.from_numpy(q), payload, scales, port.neighbors,
            port.graph.entry_point, port.store.cache, k=10, ef=EF,
            eviction=port.store.eviction)
        for t in (n_db, n_fetch):
            assert t.dtype == torch.int64 and t.dim() == 0
        assert (int(n_db), int(n_fetch)) == (w.stats.n_db,
                                             w.stats.items_fetched)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(w.ids))
        _assert_same_cache(cache, ref.store.cache)
    assert ref.access_stats.n_db > 1


def test_inactive_queries_are_left_untouched(index):
    """Queries with unexplored candidates but held inactive (here by a
    trigger of 0): a step writes nothing of theirs, not ``visited``
    (padded and inactive slots scatter into its spare column), not the
    beam, L or the counters."""
    X, g, nbrs, Q = index
    store = _store(X, "float32")
    tier2 = S.cache_tier2(store.cache)
    s = S.batch_make_state(4, EF, EF + nbrs.shape[2] + 1, N, CPU)
    s = S.batch_seed_state(
        s, Q[:4], torch.full((4, 1), int(g.entry_point), dtype=torch.int32),
        tier2, "l2")
    assert bool(((s.beam.ids >= 0) & ~s.beam.explored).any())
    nxt, active = S.batch_hop_step(Q[:4], nbrs[0], s, tier2, "l2", 0)
    assert not bool(active.any())
    _assert_same_state(nxt, s)


# ---------------------------------------- the order every beam is kept in

INF = float("inf")


def _assert_sorted_beams(beam):
    """Each beam sorted by (dist, position): its valid entries (id >= 0,
    finite dist) first, their dists ascending, then sentinels (-1, +inf)
    only: the order merge_row gives every beam it writes, which a merge
    of the beam with a step's new entries may start from (B.8's merge
    ranks every entry by counting, so it is also held to the per-op step
    on beams out of this order, in the card tests)."""
    ef = beam.ids.shape[-1]
    ids, d = beam.ids.reshape(-1, ef), beam.dists.reshape(-1, ef)
    valid = (ids >= 0) & torch.isfinite(d)
    n_valid = valid.sum(-1, keepdim=True)
    assert torch.equal(valid, torch.arange(ef) < n_valid)
    assert bool(((ids == -1) & (d == INF))[~valid].all())
    dv = torch.where(valid, d, INF)
    assert bool((dv[:, 1:] >= dv[:, :-1]).all())


def _watch(monkeypatch, names, seen):
    """Wrap each search function in ``names`` so that every state it
    returns has its beams checked; ``seen`` counts the checks."""
    for name in names:
        fn = getattr(S, name)

        def checked(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            state = out[0] if isinstance(out, tuple) else out
            _assert_sorted_beams(state.beam)
            seen[_name] = seen.get(_name, 0) + 1
            return out

        monkeypatch.setattr(S, name, checked)


BEAM_ORDER_CASES = [
    "seed_state", "hop_step_plain", "load_phase",
    "fused_step_float32", "fused_step_int8", "fused_step_float16",
    "driver_loop", "driver_batched", "driver_fused",
]


@pytest.mark.parametrize("case", BEAM_ORDER_CASES)
def test_every_beam_stays_sorted_by_key(index, monkeypatch, case):
    """After ``batch_seed_state``, ``batch_hop_step_plain`` and
    ``batch_load_phase``, after the fused driver's masked step at
    float32, int8 and float16, and through a short search of each driver,
    every beam is sorted by (dist, position) with sentinels (-1, +inf)
    only at its tail, on the CPU plain path."""
    X, g, nbrs, Q = index
    seen = {}
    if case in ("seed_state", "hop_step_plain", "load_phase"):
        name = {"seed_state": "batch_seed_state",
                "hop_step_plain": "batch_hop_step_plain",
                "load_phase": "batch_load_phase"}[case]
        _watch(monkeypatch, [name], seen)
        for B in (1, 32):
            _layer_trace(index, B, "float32", _k_phase)
    elif case.startswith("fused_step_"):
        _watch(monkeypatch, ["_where_state"], seen)
        store, payload, scales = _fused_setup(index, case[len("fused_step_"):],
                                              "fifo")
        entry = torch.tensor([int(g.entry_point)], dtype=torch.int32)
        cache = store.cache
        for q in Q[:4]:
            _, cache, _, _ = S.search_layer_lazy_fused_eager(
                q, nbrs[0], payload, scales, cache, entry, EF, "l2",
                eviction=store.eviction)
    else:
        mode = case[len("driver_"):]
        watched = ["batch_seed_state", "batch_hop_step_plain",
                   "batch_load_phase"] + (["_where_state"] if mode == "fused"
                                          else [])
        _watch(monkeypatch, watched, seen)
        eng = P.WebANNSEngine(X, g, P.EngineConfig(
            device="cpu", cache_capacity=N // 4, ef_search=EF,
            fused=mode == "fused"))
        Qn = Q[:8].numpy()
        if mode == "batched":
            eng.search(P.SearchRequest(query=Qn, k=5, batch_mode="batched"))
        else:
            eng.search(P.SearchRequest(query=Qn, k=5, batch_mode="loop"))
    assert seen and all(n > 0 for n in seen.values()), seen
    if case.startswith("driver_"):
        assert set(seen) == set(watched), seen
