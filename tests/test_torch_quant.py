"""Port codec (``repro_torch.core.quant``) against ``repro.core.quant``.

The two packages must quantize to the same bits: the tier-2 slab and
scales of both engines are compared with ``array_equal`` after every
search (``test_torch_engine.py``), and the fused driver's payload is
the port's own quantization of the float32 table. The reference has two
int8 codecs that differ in the last bit of some scales: ``quantize_np``
divides ``max|x|`` by 127, while ``quantize_jnp`` runs jitted in the
reference's cache insert, where XLA multiplies by ``fl32(1/127)``. The
port's numpy codec equals the first, its torch codec the second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as R
from repro_torch.core import quant as P

FLOAT_PRECISIONS = ["float32", "float16", "int8"]


def _rows(seed, n=400, d=24):
    """Rows at many magnitudes, with a zero row, ties at ±amax and
    values that land on .5 steps after scaling."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) * rng.uniform(1e-3, 50, (n, 1)))
    X = X.astype(np.float32)
    X[0] = 0.0
    X[1, :3] = [2.0, -2.0, 0.5]  # amax at both signs
    X[1, 3:] = 0.0
    X[2] = np.arange(d, dtype=np.float32) - d / 2  # integer steps
    return X


_jit_quantize = jax.jit(R.quantize_jnp, static_argnums=1)


@pytest.mark.parametrize("precision", FLOAT_PRECISIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_codec_equals_reference(precision, seed):
    X = _rows(seed)
    q, s = P.quantize_np(X, precision)
    rq, rs = R.quantize_np(X, precision)
    assert q.dtype == rq.dtype and s.dtype == rs.dtype
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(P.dequantize_np(q, s),
                                  R.dequantize_np(rq, rs))


@pytest.mark.parametrize("precision", FLOAT_PRECISIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_codec_equals_jitted_reference(precision, seed):
    """The tier-2 codec: the port's torch codec against ``quantize_jnp``
    as the reference's cache insert runs it (jitted)."""
    X = _rows(seed)
    q, s = P.quantize(torch.from_numpy(X), precision)
    rq, rs = _jit_quantize(jnp.asarray(X), precision)
    assert q.numpy().dtype == np.asarray(rq).dtype
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        P.dequantize(q, s).numpy(),
        np.asarray(R.dequantize_jnp(rq, rs)))


def test_the_two_int8_scales_differ_as_the_reference_does():
    """Where the numpy and jitted reference scales disagree, the port's
    two codecs disagree on the same rows, by the same bits."""
    X = _rows(3, n=2000)
    ref_gap = R.quantize_np(X, "int8")[1] != np.asarray(
        _jit_quantize(jnp.asarray(X), "int8")[1])
    port_gap = P.quantize_np(X, "int8")[1] != P.quantize(
        torch.from_numpy(X), "int8")[1].numpy()
    np.testing.assert_array_equal(port_gap, ref_gap)
    assert ref_gap.any()  # the case is exercised


@pytest.mark.parametrize("codec", ["numpy", "torch"])
def test_zero_rows_get_scale_one(codec):
    X = np.zeros((3, 5), np.float32)
    if codec == "numpy":
        q, s = P.quantize_np(X, "int8")
    else:
        q, s = (t.numpy() for t in P.quantize(torch.from_numpy(X), "int8"))
    assert (q == 0).all() and (s == 1.0).all()
    assert (P.dequantize_np(q, s) == 0).all()


@pytest.mark.parametrize("codec", ["numpy", "torch"])
def test_requantization_matches_reference(codec):
    """Dequantized int8 rows quantized again (the fused driver's insert
    of its tier-3 rows into an int8 tier 2): codes unchanged, and the
    same bits as the reference's own round trip."""
    X = _rows(4)
    q, s = R.quantize_np(X, "int8")
    dq = R.dequantize_np(q, s)
    if codec == "numpy":
        got = P.quantize_np(dq, "int8")
        want = R.quantize_np(dq, "int8")
    else:
        got = tuple(t.numpy() for t in P.quantize(torch.from_numpy(dq),
                                                   "int8"))
        want = tuple(np.asarray(t) for t in _jit_quantize(jnp.asarray(dq),
                                                           "int8"))
    np.testing.assert_array_equal(got[0], q)  # codes are stable
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_float16_is_round_to_nearest_even():
    X = np.array([[1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 65520.0,
                   -1e-8]], np.float32)
    q, s = P.quantize(torch.from_numpy(X), "fp16")
    np.testing.assert_array_equal(q.numpy(), R.quantize_np(X, "fp16")[0])
    assert q.numpy()[0, 0] == np.float16(1.0)  # tie to even
    assert np.isinf(q.numpy()[0, 2])
    assert (s.numpy() == 1.0).all()


def test_error_bounds_match_reference():
    X = _rows(5)
    amax = np.abs(X).max(axis=-1)
    for precision in FLOAT_PRECISIONS:
        np.testing.assert_array_equal(P.max_abs_error(amax, precision),
                                      R.max_abs_error(amax, precision))
        q, s = P.quantize_np(X, precision)
        err = np.abs(P.dequantize_np(q, s) - X)
        assert (err <= P.max_abs_error(amax, precision)[:, None]
                + 1e-7).all()


@pytest.mark.parametrize("precision", FLOAT_PRECISIONS)
@pytest.mark.parametrize("dim", [1, 24, 768])
def test_bytes_and_budget_accounting(precision, dim):
    assert P.bytes_per_vector(dim, precision) == \
        R.bytes_per_vector(dim, precision)
    for budget in (0, 1, 999, 256_000, 10 ** 9):
        assert P.capacity_for_budget(budget, dim, precision) == \
            R.capacity_for_budget(budget, dim, precision)
    assert P.slab_dtype(precision) == {
        "float32": torch.float32, "float16": torch.float16,
        "int8": torch.int8}[precision]
    assert P.precision_of(P.slab_dtype(precision)) == precision


@pytest.mark.parametrize("k,alpha", [(10, 2.0), (10, 0.5), (7, 1.3),
                                     (1, 0.0), (64, 2.5)])
def test_rerank_pool(k, alpha):
    assert P.rerank_pool(k, alpha) == R.rerank_pool(k, alpha)


def test_precision_aliases_and_unknown():
    for name in ("float32", "fp32", "f32", "FP16", "f16", "float16",
                 "INT8", "i8", "pq", "pq8", "product"):
        assert P.canonical_precision(name) == R.canonical_precision(name)
    with pytest.raises(ValueError):
        P.canonical_precision("int4")


def test_pq_is_known_but_not_ported():
    """pq is a precision of the slab (uint8, M bytes a row), but not of
    the per-row scalar codecs, which refuse it as the reference's do: it
    is encoded through a codebook (tests/test_torch_pq.py)."""
    assert P.slab_dtype("pq") == torch.uint8
    assert P.bytes_per_vector(64, "product") == R.bytes_per_vector(
        64, "product")
    with pytest.raises(ValueError):
        P.quantize_np(np.zeros((2, 4), np.float32), "pq8")
    with pytest.raises(ValueError):
        R.quantize_np(np.zeros((2, 4), np.float32), "pq8")
