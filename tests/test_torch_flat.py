"""The port's flat scan (kernels B.5 and B.6) against the JAX package, on
the CPU.

On a CPU tensor the port's ops run their plain versions, so these tests
hold the plain versions to the reference: ``distance_matrix_ref`` to
``distance_matrix_pallas`` (interpret mode, small tiles, so several tiles
and d-blocks run) and to the reference's jnp oracle, at the reference's
own tolerance (rtol = atol = 2e-4, ``tests/test_kernels.py``);
``topk_ref`` to the reference's ``topk_ref`` (``lax.top_k``) bit for bit,
and to ``topk_pallas`` wherever each row has at least k finite entries.
The card side (the kernels against these plain versions) is in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.distance import distance_matrix_pallas
from repro.kernels.topk import topk_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.topk import TOPK_MAX_K

METRICS = ["l2", "ip", "cos"]
TOL = 2e-4  # the reference's own kernel tolerance (tests/test_kernels.py)


def _qx(seed, B, N, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, d)).astype(np.float32),
            rng.standard_normal((N, d)).astype(np.float32))


def _d64(Q, X, metric):
    """Float64 distances (B, N): the referee of near ties."""
    Q, X = Q.astype(np.float64), X.astype(np.float64)
    G = Q @ X.T
    if metric == "l2":
        return (Q * Q).sum(1)[:, None] + (X * X).sum(1)[None] - 2 * G
    if metric == "ip":
        return -G
    return -G / (np.linalg.norm(Q, axis=1)[:, None]
                 * np.linalg.norm(X, axis=1)[None])


def assert_ids_equal_but_near_ties(ids_a, ids_b, D64, tol):
    """Equal id positions, or, where they differ, two ids whose exact
    distances lie within ``tol`` of each other (a near tie that float32
    rounding may order either way)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    rows, cols = np.nonzero(ids_a != ids_b)
    for r, c in zip(rows, cols):
        gap = abs(D64[r, ids_a[r, c]] - D64[r, ids_b[r, c]])
        assert gap <= tol, (r, c, ids_a[r, c], ids_b[r, c], gap)


# ------------------------------------------------------- distance matrix


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("B,N,d", [(5, 37, 70), (9, 50, 33)])
def test_distance_matrix_plain_matches_reference(metric, B, N, d):
    """B, N and d are no multiples of the tiles (8, 16, 32), so the Pallas
    kernel runs several ragged tiles and d-blocks."""
    Q, X = _qx(1, B, N, d)
    got = ref.distance_matrix_ref(torch.from_numpy(Q), torch.from_numpy(X),
                                  metric)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, N)
    pallas = distance_matrix_pallas(jnp.asarray(Q), jnp.asarray(X),
                                    metric=metric, tq=8, tn=16, td=32)
    oracle = rref.distance_matrix_ref(jnp.asarray(Q), jnp.asarray(X), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_distance_matrix_plain_at_one_element(metric):
    Q, X = _qx(2, 1, 1, 1)
    got = ref.distance_matrix_ref(torch.from_numpy(Q), torch.from_numpy(X),
                                  metric)
    want = rref.distance_matrix_ref(jnp.asarray(Q), jnp.asarray(X), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_l2_padding_rows_overflow_as_in_the_reference():
    """The substrate pads a shard with 3.4e38 rows; in the GEMM form their
    l2 distance is inf or NaN in both packages, which is why the scan
    masks them with ``row_valid``."""
    Q, X = _qx(3, 4, 6, 8)
    X[4:] = np.float32(3.4e38)
    got = ref.distance_matrix_ref(torch.from_numpy(Q), torch.from_numpy(X),
                                  "l2").numpy()
    want = np.asarray(rref.distance_matrix_ref(jnp.asarray(Q), jnp.asarray(X),
                                               "l2"))
    assert not np.isfinite(got[:, 4:]).any()
    assert not np.isfinite(want[:, 4:]).any()
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ top-k


def _topk_case(name):
    rng = np.random.default_rng(7)
    if name == "ties_within_and_across_tiles":
        D, k = np.round(rng.random((6, 100)), 1), 12
    elif name == "inf_entries":
        D, k = rng.random((5, 70)), 8
        D[rng.random(D.shape) < 0.4] = np.inf
        D[0, :] = np.inf  # an all-inf row
        D[1, 5:] = np.inf  # fewer than k finite entries
    elif name == "negative_and_equal":
        D, k = np.round(rng.standard_normal((4, 65)), 0), 10
        D[2] = 0.5
    elif name == "one_column":
        D, k = rng.random((3, 1)), 1
    else:
        D, k = rng.standard_normal((7, 129)), 1
    return D.astype(np.float32), k


TOPK_CASES = ["ties_within_and_across_tiles", "inf_entries",
              "negative_and_equal", "one_column", "k_one"]


@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_plain_equals_reference_topk(case):
    D, k = _topk_case(case)
    dd, ii = ref.topk_ref(torch.from_numpy(D), k)
    rd, ri = rref.topk_ref(jnp.asarray(D), k)
    assert ii.dtype == torch.int32 and tuple(ii.shape) == (D.shape[0], k)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(dd.numpy(), np.asarray(rd))
    for row in ii.numpy():  # distinct and in range, even on all-inf rows
        assert len(set(row.tolist())) == k and row.max() < D.shape[1]


@pytest.mark.parametrize("case", ["ties_within_and_across_tiles",
                                  "negative_and_equal", "k_one"])
def test_topk_plain_equals_pallas_where_rows_have_k_finite(case):
    D, k = _topk_case(case)
    dd, ii = ref.topk_ref(torch.from_numpy(D), k)
    pd, pi = topk_pallas(jnp.asarray(D), k=k, tb=8, tn=32)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(dd.numpy(), np.asarray(pd))


def test_topk_pallas_repeats_an_id_where_the_port_does_not():
    """A row with fewer than k finite entries: ``topk_pallas`` fills the
    rest from an all-inf tile whose argmin picks column 0 every round, so
    id 0 comes twice; ``lax.top_k`` (the reference's ``topk_ref``) and the
    port give distinct ids. The port follows ``topk_ref``."""
    D = np.full((2, 600), np.inf, np.float32)
    D[0, 100], D[0, 3], D[0, 550] = 0.1, 0.2, 0.3
    D[1] = np.arange(600, dtype=np.float32)
    pd, pi = topk_pallas(jnp.asarray(D), k=5, tb=8, tn=512)
    rd, ri = rref.topk_ref(jnp.asarray(D), 5)
    dd, ii = ops.topk(torch.from_numpy(D), 5)
    assert np.asarray(pi)[0].tolist() == [100, 3, 550, 0, 0]
    assert np.asarray(ri)[0].tolist() == [100, 3, 550, 0, 1]
    np.testing.assert_array_equal(ii.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(dd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(np.asarray(pi)[1], np.asarray(ri)[1])


def test_topk_nan_sorts_after_inf():
    D = torch.tensor([[np.nan, np.inf, 1.0, np.nan, -np.inf]])
    dd, ii = ops.topk(D, 5)
    assert ii.tolist() == [[4, 2, 1, 0, 3]]


def test_topk_k_cap():
    D = torch.from_numpy(np.random.default_rng(4).random(
        (3, 300)).astype(np.float32))
    dd, ii = ops.topk(D, TOPK_MAX_K)
    want = rref.topk_ref(jnp.asarray(D.numpy()), TOPK_MAX_K)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(want[1]))
    with pytest.raises(ValueError, match="at most"):
        ops.topk(D, TOPK_MAX_K + 1)
    with pytest.raises(ValueError, match="row width"):
        ops.topk(D[:, :5], 6)


# ---------------------------------------------------------- the flat scan


@pytest.mark.parametrize("metric", METRICS)
def test_distance_topk_matches_reference(metric):
    Q, X = _qx(5, 6, 300, 24)
    k = 10
    dd, ii = ops.distance_topk(torch.from_numpy(Q), torch.from_numpy(X), k,
                               metric)
    rd, ri = rops.distance_topk(jnp.asarray(Q), jnp.asarray(X), k, metric)
    assert_ids_equal_but_near_ties(ii.numpy(), np.asarray(ri),
                                   _d64(Q, X, metric), TOL)
    np.testing.assert_allclose(dd.numpy(), np.asarray(rd), rtol=TOL,
                               atol=TOL)


def test_ops_run_plain_versions_on_cpu_tensors():
    Q, X = (torch.from_numpy(a) for a in _qx(6, 3, 40, 8))
    ops.reset_launch_counts()
    D = ops.distance_matrix(Q, X, "l2")
    assert torch.equal(D, ref.distance_matrix_ref(Q, X, "l2"))
    assert torch.equal(ops.distance_topk_ready(Q, X, "ip"),
                       ref.distance_matrix_ref(Q, X, "ip"))
    for got, want in zip(ops.topk(D, 4), ref.topk_ref(D, 4)):
        assert torch.equal(got, want)
    for got, want in zip(ops.distance_topk(Q, X, 4, "cos"),
                         ref.distance_topk_ref(Q, X, 4, "cos")):
        assert torch.equal(got, want)
    counts = ops.launch_counts()
    assert counts["distance_matrix"] == 0 and counts["topk"] == 0
