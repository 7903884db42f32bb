"""Port kernels: plain PyTorch versions against the JAX package, and the
Hopper kernels against their plain versions on the card.

On the CPU the port's ops run their plain versions, which must match the
reference's Pallas kernels (interpret mode) and its jnp oracles: the
gather-distance and the dequant-gather-distance within float32 tolerance
(rtol 1e-5, atol 1e-5: a different summation order; for cos the Pallas
kernel also normalises the query first, another rounding), the merge
exactly (it only selects). The kernels
against their plain versions are in ``test_torch_cuda.py``: they need
the card, where JAX is not installed. The distance-matrix kernel's
3×TF32 arithmetic is emulated here in numpy and held to the card's
tolerance against float64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as RD
from repro.core import search as RS
from repro.core import quant as RQ
from repro.kernels import ref as jref
from repro.kernels.dequant_gather_distance import (
    dequant_gather_distance_batch_pallas,
    dequant_gather_distance_pallas,
)
from repro.kernels.gather_distance import (
    gather_distance_batch_pallas,
    gather_distance_pallas,
)
from repro.kernels.topk import merge_topk_pallas
from repro_torch.core import distances as PD
from repro_torch.core import search as PS
from repro_torch.data.synthetic import corpus_embeddings
from repro_torch.kernels import ops

METRICS = ["l2", "ip", "cos"]


def _gd_inputs(seed, n=40, d=20, B=6, K=9):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    ids = rng.integers(-1, n, (B, K)).astype(np.int32)
    ids[:, -1] = -1  # every row has padding
    return table, ids, Q


# ---------------------------------------------------------- distances


@pytest.mark.parametrize("metric", METRICS)
def test_distances_match_reference(metric):
    rng = np.random.default_rng(9)
    X = rng.standard_normal((50, 16)).astype(np.float32)
    Q = rng.standard_normal((4, 16)).astype(np.float32)
    Xt, Qt = torch.from_numpy(X), torch.from_numpy(Q)
    np.testing.assert_allclose(
        PD.point_distance(Xt, Qt[0], metric).numpy(),
        np.asarray(RD.point_distance(jnp.asarray(X), jnp.asarray(Q[0]),
                                     metric)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        PD.distance_matrix(Qt, Xt, metric).numpy(),
        np.asarray(RD.distance_matrix(jnp.asarray(Q), jnp.asarray(X),
                                      metric)), rtol=1e-5, atol=1e-4)
    d, i = PD.exact_topk(Qt, Xt, 5, metric)
    rd, ri = RD.exact_topk(jnp.asarray(Q), jnp.asarray(X), 5, metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------- gather-distance


@pytest.mark.parametrize("metric", METRICS)
def test_gather_distance_batch_plain_matches_reference(metric):
    table, ids, Q = _gd_inputs(1)
    got = ops.gather_distance_batch(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(Q),
        metric,
    ).numpy()
    pallas = np.asarray(gather_distance_batch_pallas(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(Q), metric=metric,
        interpret=True,
    ))
    oracle = np.asarray(jref.gather_distance_batch_ref(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(Q), metric
    ))
    assert np.isinf(got[ids < 0]).all()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_gather_distance_single_plain_matches_reference(metric):
    table, ids, Q = _gd_inputs(2)
    row, q = ids[0], Q[0]
    got = ops.gather_distance(
        torch.from_numpy(table), torch.from_numpy(row), torch.from_numpy(q),
        metric,
    ).numpy()
    pallas = np.asarray(gather_distance_pallas(
        jnp.asarray(table), jnp.asarray(row), jnp.asarray(q), metric=metric,
        interpret=True,
    ))
    oracle = np.asarray(jref.gather_distance_ref(
        jnp.asarray(table), jnp.asarray(row), jnp.asarray(q), metric
    ))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    # the single form is the batched form at one query: identical bits
    batched = ops.gather_distance_batch(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(Q),
        metric,
    ).numpy()
    np.testing.assert_array_equal(got, batched[0])


# -------------------------------------------------- dequant-gather-distance

QUANT = ["int8", "float16"]


def _dq_inputs(seed, precision, n=40, d=24, B=5, K=9):
    """A quantized table (by the reference's codec), its scales as the
    reference passes them (ones for float16) and as the port does (None
    for float16), -1 padded ids and queries."""
    table, ids, Q = _gd_inputs(seed, n=n, d=d, B=B, K=K)
    table = table * np.float32(3.0)
    payload, scales = RQ.quantize_np(table, precision)
    port_scales = torch.from_numpy(scales) if precision == "int8" else None
    return payload, scales, port_scales, ids, Q


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_dequant_gather_distance_batch_plain_matches_reference(
        precision, metric):
    payload, scales, port_scales, ids, Q = _dq_inputs(6, precision)
    got = ops.dequant_gather_distance_batch(
        torch.from_numpy(payload), port_scales, torch.from_numpy(ids),
        torch.from_numpy(Q), metric,
    ).numpy()
    args = (jnp.asarray(payload), jnp.asarray(scales), jnp.asarray(ids),
            jnp.asarray(Q))
    pallas = np.asarray(dequant_gather_distance_batch_pallas(
        *args, metric=metric, interpret=True))
    oracle = np.asarray(jref.dequant_gather_distance_batch_ref(
        *args, metric))
    assert np.isinf(got[ids < 0]).all()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    # the plain version is the float32 gather over the dequantized table
    dq = torch.from_numpy(RQ.dequantize_np(payload, scales))
    np.testing.assert_array_equal(got, ops.gather_distance_batch(
        dq, torch.from_numpy(ids), torch.from_numpy(Q), metric).numpy())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_dequant_gather_distance_single_plain_matches_reference(
        precision, metric):
    payload, scales, port_scales, ids, Q = _dq_inputs(7, precision)
    row, q = ids[1], Q[1]
    got = ops.dequant_gather_distance(
        torch.from_numpy(payload), port_scales, torch.from_numpy(row),
        torch.from_numpy(q), metric,
    ).numpy()
    args = (jnp.asarray(payload), jnp.asarray(scales), jnp.asarray(row),
            jnp.asarray(q))
    pallas = np.asarray(dequant_gather_distance_pallas(
        *args, metric=metric, interpret=True))
    oracle = np.asarray(jref.dequant_gather_distance_ref(*args, metric))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    batched = ops.dequant_gather_distance_batch(
        torch.from_numpy(payload), port_scales, torch.from_numpy(ids),
        torch.from_numpy(Q), metric,
    ).numpy()
    np.testing.assert_array_equal(got, batched[1])


def test_dequant_plain_version_takes_no_float16_scales():
    payload, scales, _, ids, Q = _dq_inputs(8, "float16")
    with pytest.raises(ValueError, match="no scales"):
        ops.dequant_gather_distance_batch(
            torch.from_numpy(payload), torch.from_numpy(scales),
            torch.from_numpy(ids), torch.from_numpy(Q))


# --------------------------------------------------------------- merge-topk


def _merge_all(d, i, k):
    """(dists, ids, src) from the port's plain merge, the reference's
    Pallas kernel (interpret mode) and its jnp oracle."""
    got = [t.numpy() for t in ops.merge_topk(
        torch.from_numpy(d), torch.from_numpy(i), k
    )]
    pallas = [np.asarray(t) for t in merge_topk_pallas(
        jnp.asarray(d), jnp.asarray(i), k, interpret=True
    )]
    oracle = [np.asarray(t) for t in jref.merge_topk_ref(
        jnp.asarray(d), jnp.asarray(i), k
    )]
    return got, pallas, oracle


def _check_merge(d, i, k):
    d = np.asarray(d, np.float32)
    i = np.asarray(i, np.int32)
    got, pallas, oracle = _merge_all(d, i, k)
    for name, want in (("pallas", pallas), ("oracle", oracle)):
        for g, w, what in zip(got, want, ("dists", "ids", "src")):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {what}")
    return got


MERGE_CASES = {
    # all-equal distances: output order is input order
    "ties": ([[0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], [[10, 11, 12, 13, 14, 15]], 6),
    # nan / ±inf distances and id -1 are sentinels
    "sentinels": ([[np.nan, 0.5, -np.inf, np.inf, 1.5, 0.25]],
                  [[1, 2, 3, 4, -1, 6]], 4),
    # a duplicated id keeps its best (dist, position) copy
    "duplicates": ([[5.0, 2.0, 2.0, 7.0, 2.0]], [[3, 9, 9, 3, 4]], 4),
    # duplicates in one row must not leak into another row
    "cross_row_duplicates": ([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]],
                             [[7, 7, 8], [7, 8, 8]], 3),
    "k_exceeds_m": ([[3.0, 1.0]], [[5, 8]], 5),
    "all_sentinel_row": ([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
                         [[-1, -1, -1], [-1, 7, -1]], 2),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_topk_plain_hand_cases(case):
    d, i, k = MERGE_CASES[case]
    _check_merge(d, i, k)


@pytest.mark.parametrize(
    "B,M,k",
    [(1, 1, 1), (3, 7, 3), (8, 44, 11), (5, 130, 16), (2, 3, 9),
     (4, 97 + 64, 64),
     # both sides of the card kernel's warp-sort limit (M <= 256)
     (2, 255, 64), (2, 256, 64), (2, 257, 64)],
)
def test_merge_topk_plain_random(B, M, k):
    rng = np.random.default_rng(B * 1000 + M + k)
    d = rng.standard_normal((B, M)).astype(np.float32) ** 2
    i = rng.integers(0, max(2, M // 2), (B, M)).astype(np.int32)
    i = np.where(rng.random((B, M)) < 0.2, -1, i)
    d = np.where(rng.random((B, M)) < 0.1,
                 rng.choice([np.nan, np.inf, -np.inf], (B, M)), d)
    d[:, : M // 3] = np.round(d[:, : M // 3], 1)  # ties
    _check_merge(d.astype(np.float32), i, k)


@pytest.mark.parametrize("B,M", [(32, 96), (32, 161), (1, 96)])
def test_merge_topk_plain_path_rows(B, M):
    """Rows as the beam merge sends them at ef = 64 (a hop's ef + degree,
    a load phase's ef + miss_cap, the loop driver's B = 1): the sorted
    beam, then new entries; ids distinct, every entry valid."""
    rng = np.random.default_rng(B * 1000 + M)
    d = np.concatenate([np.sort(rng.random((B, 64)), 1),
                        rng.random((B, M - 64))], 1).astype(np.float32)
    i = np.stack([rng.choice(10**6, M, replace=False)
                  for _ in range(B)]).astype(np.int32)
    got = _check_merge(d, i, 64)
    assert (got[2] >= 0).all()  # 64 winners a row, none a sentinel


# the rows a filter's widened beam sends past 256 entries: the per-op hop
# step at ef 256 (ef + degree 32) and the load phases at ef 256 and 208
# (2·ef + 33), batched and single
FILTER_ROWS = [(32, 288, 256), (1, 288, 256), (32, 545, 256),
               (1, 545, 256), (32, 449, 208)]


@pytest.mark.parametrize("kind", ["path", "ties", "repeated"])
@pytest.mark.parametrize("B,M,k", FILTER_ROWS)
def test_merge_topk_plain_filter_rows(B, M, k, kind):
    """The filter rows in three forms: as the beam merge sends them (a
    k-wide sorted beam, then new entries, ids distinct, all valid);
    tie-heavy (distances rounded to 0.01; ids -1, NaN, +inf and -inf
    distances); and with ids repeated across the row (every id of the
    first half again in the second, the copies 256 or more apart in the
    longer rows, some at equal distance)."""
    rng = np.random.default_rng(B * 1000 + M + k)
    ids = np.stack([rng.choice(10**6, M, replace=False)
                    for _ in range(B)]).astype(np.int32)
    if kind == "path":
        d = np.concatenate([np.sort(rng.random((B, k)), 1),
                            rng.random((B, M - k))], 1)
    elif kind == "ties":
        d = np.round(rng.random((B, M)), 2)
        ids[rng.random((B, M)) < 0.1] = -1
        d[rng.random((B, M)) < 0.05] = np.nan
        d[rng.random((B, M)) < 0.03] = np.inf
        d[rng.random((B, M)) < 0.03] = -np.inf
    else:
        h = M // 2
        ids[:, M - h:] = ids[:, :h]
        d = np.round(rng.random((B, M)), 1)
    got = _check_merge(d.astype(np.float32), ids, k)
    if kind == "path":
        assert (got[2] >= 0).all()  # k winners a row, none a sentinel


@pytest.mark.parametrize("best", ["first", "second"])
def test_merge_topk_plain_duplicate_order(best):
    """Every id twice: its best copy in the first half of the row (the
    second copy equal or worse) or only in the second half."""
    rng = np.random.default_rng(17)
    B, h = 8, 80
    ids = np.stack([rng.choice(10**6, h, replace=False)
                    for _ in range(B)]).astype(np.int32)
    low = np.round(rng.random((B, h)), 2)
    if best == "first":
        first, second = low, low + rng.choice([0.0, 0.5], (B, h))
    else:
        first, second = low + 0.5, low
    d = np.concatenate([first, second], 1).astype(np.float32)
    got = _check_merge(d, np.concatenate([ids, ids], 1), 64)
    in_first = got[2] < h
    assert in_first.all() if best == "first" else not in_first.any()


# ------------------------------------------------------------- beam merge


def _beam_case(seed, ef=8, deg=6):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(50)[:ef].astype(np.int32)
    dists = np.sort(np.round(rng.random(ef), 1)).astype(np.float32)
    ids[-2:] = -1
    dists[-2:] = np.inf
    explored = rng.random(ef) < 0.5
    explored[-2:] = False
    new_ids = (50 + rng.permutation(20)[:deg]).astype(np.int32)
    new_dists = np.round(rng.random(deg), 1).astype(np.float32)  # ties
    new_valid = rng.random(deg) < 0.7
    return ids, dists, explored, new_ids, new_dists, new_valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_beam_merge_matches_reference(seed):
    ids, dists, explored, new_ids, new_dists, new_valid = _beam_case(seed)
    want = RS.beam_merge(
        RS.Beam(jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(explored)),
        jnp.asarray(new_ids), jnp.asarray(new_dists), jnp.asarray(new_valid),
    )
    got = PS.beam_merge(
        PS.Beam(torch.from_numpy(ids), torch.from_numpy(dists),
                torch.from_numpy(explored)),
        torch.from_numpy(new_ids), torch.from_numpy(new_dists),
        torch.from_numpy(new_valid),
    )
    for f in dataclasses.fields(PS.Beam):
        np.testing.assert_array_equal(
            getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
            err_msg=f.name,
        )


def test_finalize_topk_matches_reference():
    ids, dists, explored, *_ = _beam_case(5)
    k = 5
    want_d, want_i = RS.finalize_topk(
        dataclasses.replace(
            RS.make_state(len(ids), 4, 64),
            beam=RS.Beam(jnp.asarray(ids), jnp.asarray(dists),
                         jnp.asarray(explored)),
        ), k,
    )
    state = PS.batch_make_state(1, len(ids), 4, 64, torch.device("cpu"))
    state = dataclasses.replace(state, beam=PS.Beam(
        torch.from_numpy(ids)[None], torch.from_numpy(dists)[None],
        torch.from_numpy(explored)[None],
    ))
    got_d, got_i = PS.finalize_topk(state, k)
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(want_d))


def test_ops_run_plain_versions_on_cpu_tensors():
    """A CPU tensor never reaches a kernel: no build, no launch counted."""
    ops.reset_launch_counts()
    table, ids, Q = _gd_inputs(4)
    ops.gather_distance_batch(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(Q))
    ops.merge_topk(torch.zeros(2, 5), torch.zeros(2, 5, dtype=torch.int32), 3)
    ops.dequant_gather_distance_batch(
        torch.from_numpy(table).to(torch.float16), None,
        torch.from_numpy(ids), torch.from_numpy(Q))
    ops.adc_gather_distance_batch(
        torch.zeros((40, 4), dtype=torch.uint8),
        torch.zeros((ids.shape[0], 1, 4, 256)), torch.from_numpy(ids))
    ops.distance_topk(torch.from_numpy(Q), torch.from_numpy(table), 3)
    ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    assert ops.launch_counts() == {
        "gather_distance": 0, "gather_distance_batch": 0,
        "dequant_gather_distance": 0, "dequant_gather_distance_batch": 0,
        "adc_gather_distance": 0, "adc_gather_distance_batch": 0,
        "merge_topk": 0, "topk": 0, "hop_step": 0, "distance_matrix": 0,
        "embedding_bag": 0}


# ------------------------------------------------ distance matrix, 3×TF32

# the distance-matrix kernel's tolerance on the card, of the metric's
# scale: |q|² + |x|² for l2, |q|·|x| for ip, 1 for cos
DM_TOL = 1e-5


def _tf32(v):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: the magnitude bits
    plus half of the dropped 13 bits' unit, then the 13 bits cleared."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_gemm(Q, X):
    """q·x for every pair as ``csrc/distance_matrix.cu`` sums it, and with
    the hi·hi product alone (plain TF32): ``(three, plain)``, (B, N)
    float32. Each element splits into hi = tf32(v) and lo = tf32(v - hi);
    each k-step of 8 adds its x_lo·q_hi, x_hi·q_lo and x_hi·q_hi sums, in
    that order, to a float32 accumulator. The products of TF32 values and
    their 8-term sums are exact in float64; each add to the accumulator
    rounds once to float32."""
    (B, d), N = Q.shape, X.shape[0]
    S = d // 8
    qh, xh = _tf32(Q), _tf32(X)
    ql, xl = _tf32(Q - qh), _tf32(X - xh)

    def steps(x, q):  # (S, B, N): each k-step's exact sum
        x = np.ascontiguousarray(
            x.astype(np.float64).reshape(N, S, 8).transpose(1, 2, 0))
        q = np.ascontiguousarray(
            q.astype(np.float64).reshape(B, S, 8).transpose(1, 0, 2))
        return np.matmul(q, x)

    lh, hl, hh = steps(xl, qh), steps(xh, ql), steps(xh, qh)
    three = np.zeros((B, N), np.float32)
    plain = np.zeros((B, N), np.float32)
    for s in range(S):
        for part in (lh[s], hl[s], hh[s]):
            three = (three + part).astype(np.float32)
        plain = (plain + hh[s]).astype(np.float32)
    return three, plain


def _metric_error(g, Q, X, metric):
    """The kernel's epilogue on ``g`` (float32, with float32 norms), its
    largest error against float64 in units of the metric's scale."""
    qn = (Q * Q).sum(1, dtype=np.float32)[:, None]
    xn = (X * X).sum(1, dtype=np.float32)[None, :]
    Q64, X64 = Q.astype(np.float64), X.astype(np.float64)
    g64 = Q64 @ X64.T
    qn64 = (Q64 ** 2).sum(1)[:, None]
    xn64 = (X64 ** 2).sum(1)[None, :]
    if metric == "l2":
        got = np.maximum(qn + xn - np.float32(2) * g, np.float32(0))
        want, scale = np.maximum(qn64 + xn64 - 2 * g64, 0), qn64 + xn64
    elif metric == "ip":
        got, want, scale = -g, -g64, np.sqrt(qn64 * xn64)
    else:
        eps = np.float32(1e-30)
        got = -g / ((np.sqrt(qn) + eps) * (np.sqrt(xn) + eps))
        want, scale = -g64 / np.sqrt(qn64 * xn64), 1.0
    return float((np.abs(got.astype(np.float64) - want) / scale).max())


@pytest.fixture(scope="module")
def tf32_cases():
    """Two inputs and their emulated products: Gaussian at the card
    tests' (32, 4,097, 768), and 32 noisy corpus rows against 2,048
    corpus rows (|x|² ~ 860, the flat scan's data)."""
    rng = np.random.default_rng(17)
    Q = rng.standard_normal((32, 768)).astype(np.float32)
    X = rng.standard_normal((4_097, 768)).astype(np.float32)
    C = corpus_embeddings(2_048, 768, seed=13)
    Qc = (C[rng.integers(0, len(C), 32)]
          + 0.05 * rng.standard_normal((32, 768))).astype(np.float32)
    return {name: (q, x, *_tf32_gemm(q, x))
            for name, (q, x) in (("gauss", (Q, X)), ("corpus", (Qc, C)))}


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit at 1
    v = np.array([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                  -(one + ulp / 2), one + ulp + ulp / 2], np.float32)
    np.testing.assert_array_equal(
        _tf32(v), np.array([one, one + ulp, one + ulp, -(one + ulp),
                            one + 2 * ulp], np.float32))
    rng = np.random.default_rng(3)
    x = rng.standard_normal(10_000).astype(np.float32) * 1e3
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    # hi + lo holds x to about 2^-22 of its size, hi alone to 2^-11
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21
    assert (np.abs(hi.astype(np.float64) - x) / np.abs(x)).max() <= 2.0 ** -11


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["gauss", "corpus"])
def test_distance_matrix_3xtf32_within_tolerance(tf32_cases, case, metric):
    """The kernel's 3×TF32 sums stay within DM_TOL of float64 at every
    metric; plain TF32 (hi·hi alone) does not, which is why it stays
    ruled out."""
    Q, X, three, plain = tf32_cases[case]
    assert _metric_error(three, Q, X, metric) <= DM_TOL
    assert _metric_error(plain, Q, X, metric) > DM_TOL
