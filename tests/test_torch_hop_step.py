"""The hop step and the rule that sends it to the hop-step kernel B.8, on
the CPU.

``search.batch_hop_step`` is one launch of B.8 (``csrc/hop_step.cu``)
where ``ops.hop_step_takes`` says so (a CUDA float32, int8 or float16
tier 2, ``ef + deg`` ≤ 256), and ``search.batch_hop_step_plain``
everywhere else: on the CPU its plain version, on the card the per-op
step of hand-written kernels that B.8 is held to bit for bit
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3). Checked here:

- the dispatched step equals the plain body bit for bit on the CPU, over
  float32/int8/float16 tier 2, l2/ip/cos, B ∈ {1, 32}, with and without
  a gate, ef ∈ {1, 10, 64}, degree ∈ {16, 32}, with and without a cache;
- the dispatch rule, with the device predicate patched to say CUDA: a
  pq tier 2 and ``ef + deg`` > 256 take the per-op step, the rest B.8,
  which gets the cache's maps where there is a cache;
- a step taken when no query is active changes no state tensor
  (hypothesis);
- one step equals one step of the JAX package's ``search_phase`` (its
  ``max_hops`` one past the state's hop count), the distances within
  float32 rounding;
- a kernel library's name follows the bytes of the shared headers.

The states are ``chip_smoke.hop_state``'s: mid-search beams, visited
sets, miss lists and counters, some queries inactive.
"""

import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core import search as R
from repro_torch.core import quant
from repro_torch.core import search as S
from repro_torch.core import store as PS
from repro_torch.kernels import _build, ops
from repro_torch.kernels import hop_step as HS

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the states and tier 2s)

CPU = torch.device("cpu")
N, D = 300, 16
PORT = {"search": S, "store": PS, "quant": quant}
PRECISIONS = ["float32", "int8", "float16"]
METRICS = ["l2", "ip", "cos"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one torch thread runs them faster than several."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Q = cs.make_queries(X, 32, seed=3)
    nbrs = {deg: cs.hop_neighbors(rng, N, deg) for deg in (16, 32, 256)}
    return X, Q, nbrs


@pytest.fixture(scope="module")
def tier2s(data):
    made = {}

    def get(precision, cached):
        if (precision, cached) not in made:
            made[(precision, cached)] = cs.hop_tier2(
                PORT, data[0], precision, cached, np.random.default_rng(1),
                N // 3, CPU)
        return made[(precision, cached)]

    return get


def _case(data, B, ef, deg, metric, seed, gate):
    X, Q, nbrs = data
    rng = np.random.default_rng(seed)
    state = cs.hop_state(S, rng, X, Q[:B], nbrs[deg], ef, ef + deg + 1, ef,
                         100_000, metric, CPU)
    g = None
    if gate:
        g = (torch.tensor(True) if B == 1
             else torch.from_numpy(rng.random(B) < 0.7))
    return (torch.from_numpy(Q[:B]), torch.from_numpy(nbrs[deg]), state, g)


def _assert_same(got, want):
    for g, w in zip(cs.hop_step_args(S, *got), cs.hop_step_args(S, *want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("deg", [16, 32])
@pytest.mark.parametrize("ef", [1, 10, 64])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_dispatched_step_equals_plain_body(data, tier2s, precision, metric,
                                           B, gate, ef, deg, cached):
    Q, nbrs, state, g = _case(data, B, ef, deg, metric, ef * 100 + deg, gate)
    tier2 = tier2s(precision, cached)
    before = ops.launch_counts()["hop_step"]
    got = S.batch_hop_step(Q, nbrs, state, tier2, metric, ef, gate=g)
    want = S.batch_hop_step_plain(Q, nbrs, state, tier2, metric, ef, gate=g)
    assert ops.launch_counts()["hop_step"] == before  # no kernel here
    _assert_same(got, want)
    assert got[0].n_hops.sum() - state.n_hops.sum() == got[1].sum()


class _Taken(Exception):
    pass


@pytest.mark.parametrize("precision,ef,deg,route", [
    ("float32", 64, 32, "kernel"), ("int8", 64, 32, "kernel"),
    ("float16", 64, 32, "kernel"), ("float32", 1, 16, "kernel"),
    ("float32", 224, 32, "kernel"),  # ef + deg = 256: the merge's limit
    ("float16", 225, 32, "per_op"),  # 257
    ("int8", 1, 256, "per_op"),
    ("pq", 64, 32, "per_op"),
])
@pytest.mark.parametrize("cached", [False, True])
def test_dispatch_rule(data, tier2s, monkeypatch, precision, ef, deg, route,
                       cached):
    """With the device predicate saying CUDA, the step goes to B.8 or to
    the per-op step by dtype and shape, before anything launches; B.8
    gets the cache's maps (or none) and the step's own arguments."""
    Q, nbrs, state, _ = _case(data, 4, ef, deg, "l2", 1, False)
    if precision == "pq":
        tier2 = S.Tier2(torch.zeros((N, 4), dtype=torch.uint8),
                        luts=torch.zeros((4, 1, 4, 256)))
    else:
        tier2 = tier2s(precision, cached)
    taken = []

    def kernel(*args):
        taken.append(("kernel", args))
        raise _Taken

    def per_op(*args):
        taken.append(("per_op", args))
        raise _Taken

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(HS, "hop_step_cuda", kernel)
    monkeypatch.setattr(S, "batch_hop_step_plain", per_op)
    with pytest.raises(_Taken):
        S.batch_hop_step(Q, nbrs, state, tier2, "ip", 7, 9)
    assert [t[0] for t in taken] == [route]
    args = taken[0][1]
    if route == "kernel":
        cache = tier2.cache
        assert args[10] is tier2.table and args[11] is tier2.scales
        assert args[12] is (None if cache is None else cache.slot_of)
        assert args[13] is (None if cache is None else cache.id_of)
        assert args[14:] == ("ip", 7, 9, None)
    else:
        assert args[3] is tier2 and args[4:] == ("ip", 7, 9, None)


def test_cpu_tensors_never_take_the_kernel(tier2s):
    for precision in PRECISIONS:
        assert not ops.hop_step_takes(tier2s(precision, True).table, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        HS.hop_step_cuda(*([torch.zeros(1, 1)] * 14), "l2", 1, 1)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 10_000), B=st.integers(1, 6),
       ef=st.sampled_from([1, 4, 10]), deg=st.sampled_from([16, 32]),
       precision=st.sampled_from(PRECISIONS), cached=st.booleans(),
       why=st.sampled_from(["gate", "hops", "misses", "explored", "mixed"]))
def test_a_step_with_no_active_query_changes_nothing(data, tier2s, seed, B,
                                                     ef, deg, precision,
                                                     cached, why):
    """Every query held inactive (the gate off, the hop cap reached,
    ``|L|`` at the trigger, or its beam all explored, or each query by
    one of these): the step writes none of its state, ``visited``'s spare
    column included."""
    Q, nbrs, state, _ = _case(data, B, ef, deg, "l2", seed, False)
    rng = np.random.default_rng(seed)
    kinds = (rng.choice(["gate", "hops", "misses", "explored"], B)
             if why == "mixed" else [why] * B)
    gate = torch.ones(B, dtype=torch.bool)
    max_hops = int(state.n_hops.max()) + 1
    trigger = ef
    for b, kind in enumerate(kinds):
        if kind == "gate":
            gate[b] = False
        elif kind == "hops":
            state.n_hops[b] = max_hops
        elif kind == "misses":
            state.miss_count[b] = trigger
        else:
            state.beam.explored[b] = True
    out, active = S.batch_hop_step(Q, nbrs, state, tier2s(precision, cached),
                                   "l2", trigger, max_hops, gate)
    assert not bool(active.any())
    for g, w in zip(S._state_tensors(out), S._state_tensors(state)):
        assert torch.equal(g, w)


def _reference_lookup(tier2):
    """The reference's tier-2 probe over the port's tier 2: (present,
    float32 rows) of ids, through slot_of and the id_of cross-check."""
    table = tier2.table
    rows = quant.dequantize(table, tier2.scales) if table.dtype == \
        torch.int8 else table.to(torch.float32)
    rows = jnp.asarray(rows.numpy())
    R_ = rows.shape[0]
    if tier2.cache is None:
        return lambda ids: (ids >= 0, rows[jnp.clip(ids, 0, R_ - 1)])
    slot_of = jnp.asarray(tier2.cache.slot_of.numpy())
    id_of = jnp.asarray(tier2.cache.id_of.numpy())

    def lookup(ids):
        slots = slot_of[jnp.clip(ids, 0, slot_of.shape[0] - 1)]
        safe = jnp.clip(slots, 0, R_ - 1)
        return (slots >= 0) & (ids >= 0) & (id_of[safe] == ids), rows[safe]

    return lookup


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_one_step_equals_reference_search_phase(data, tier2s, precision,
                                                metric, cached):
    """Each query's step against the JAX package's ``search_phase`` run
    for one hop (``max_hops`` one past its count): beam ids, explored
    flags, visited (less the spare column), L and the counters equal;
    the beam's distances to float32 rounding (XLA and torch sum in
    other orders)."""
    X, _, nbrs_np = data
    B, ef, deg = 6, 10, 32
    Q, nbrs, state, _ = _case(data, B, ef, deg, metric, 11, False)
    tier2 = tier2s(precision, cached)
    out, active = S.batch_hop_step(Q, nbrs, state, tier2, metric, ef)
    assert bool(active.any())
    lookup = _reference_lookup(tier2)
    t = [x.numpy() for x in S._state_tensors(state)]
    o = [x.numpy() for x in S._state_tensors(out)]
    for b in range(B):
        ref_in = R.SearchState(
            beam=R.Beam(jnp.asarray(t[0][b]), jnp.asarray(t[1][b]),
                        jnp.asarray(t[2][b])),
            visited=jnp.asarray(t[3][b, :N]),
            banned=jnp.zeros((N,), bool), miss_ids=jnp.asarray(t[4][b]),
            miss_count=jnp.int32(t[5][b]), n_hops=jnp.int32(t[6][b]),
            n_dist=jnp.int32(t[7][b]))
        ref = R.search_phase(jnp.asarray(Q[b].numpy()),
                             jnp.asarray(nbrs_np[deg]), ref_in, lookup,
                             metric, ef_trigger=ef,
                             max_hops=int(t[6][b]) + 1)
        np.testing.assert_array_equal(o[0][b], np.asarray(ref.beam.ids))
        np.testing.assert_array_equal(o[2][b],
                                      np.asarray(ref.beam.explored))
        np.testing.assert_allclose(o[1][b], np.asarray(ref.beam.dists),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(o[3][b, :N], np.asarray(ref.visited))
        np.testing.assert_array_equal(o[4][b], np.asarray(ref.miss_ids))
        assert (o[5][b], o[6][b], o[7][b]) == (
            int(ref.miss_count), int(ref.n_hops), int(ref.n_dist))
        assert bool(active[b]) == (int(ref.n_hops) == t[6][b] + 1)


def test_library_name_follows_the_shared_headers(tmp_path):
    """A source's library is named by a hash that covers every header
    beside it, so an edited header never loads a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "hop_step.cu"
    first = _build._library_path(src)
    assert _build._library_path(src) == first
    assert first.name.startswith("libhop_step-")
    for header in ("row_distance.cuh", "warp_merge.cuh"):
        path = csrc / header
        path.write_bytes(path.read_bytes() + b"\n")
        changed = _build._library_path(src)
        assert changed != first
        first = changed
    assert {p.name for p in csrc.glob("*.cuh")} == {"row_distance.cuh",
                                                     "warp_merge.cuh"}
