"""The port's embedding substrate (kernel B.7's plain version and
``models/embeddings.py``) against the JAX package, on the CPU.

On a CPU tensor ``ops.embedding_bag`` runs its plain version
``ref.embedding_bag_ref``, which sums each column in slot order as the
Pallas kernel's revisited output block does, so it must equal
``embedding_bag_pallas`` (interpret mode) bit for bit. The reference's
jnp oracle ``embedding_bag_ref`` and its ``embedding_bag_padded`` (which
takes weighted bags) reduce with ``jnp.sum``, whose order XLA picks, so
the port matches them to rtol 1e-6, atol 1e-6. The ragged bag's
``segment_sum`` is a scatter-add in XLA's order against ``index_add_``:
the same tolerance. The gathers (``multi_field_lookup``, the hash
lookup) are exact. The card side (the kernel against the plain version)
is in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.models import embeddings as rE
from repro_torch.kernels import ops, ref
from repro_torch.models import embeddings as E

TOL = 1e-6
# the shapes of tests/test_kernels.py::test_embedding_bag_shapes
BAG_SHAPES = [(10, 4, 3, 2), (100, 32, 7, 5), (50, 16, 1, 1)]


def _bag_inputs(seed, V, d, B, S, weighted=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, d)).astype(np.float32)
    idx = rng.integers(-1, V, (B, S)).astype(np.int32)
    w = rng.uniform(-1.0, 2.0, (B, S)).astype(np.float32) if weighted \
        else None
    return table, idx, w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _port_bag(table, idx, w, combiner):
    return ops.embedding_bag(_t(table), _t(idx), _t(w), combiner).numpy()


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,d,B,S", BAG_SHAPES)
def test_plain_bag_equals_pallas_bit_for_bit(combiner, V, d, B, S):
    table, idx, _ = _bag_inputs(V * d + B, V, d, B, S)
    want = np.asarray(embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(idx), combiner=combiner,
        interpret=True))
    got = _port_bag(table, idx, None, combiner)
    assert got.dtype == np.float32 and got.shape == (B, d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_all_padding_bag_is_zero_and_equals_pallas(combiner):
    table, _, _ = _bag_inputs(1, 10, 4, 2, 2)
    idx = np.array([[-1, -1], [0, 1]], np.int32)
    want = np.asarray(embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(idx), combiner=combiner))
    got = _port_bag(table, idx, None, combiner)
    np.testing.assert_array_equal(got, want)
    assert not np.any(got[0]) and np.all(np.signbit(got[0]) == 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,d,B,S", BAG_SHAPES + [(1000, 64, 33, 32)])
def test_padded_bag_matches_reference(weighted, combiner, V, d, B, S):
    """The port's ``embedding_bag_padded`` against the reference's (which
    runs its jnp oracle off the TPU, weights included) and against the
    jnp oracle itself."""
    table, idx, w = _bag_inputs(7 + S, V, d, B, S, weighted)
    jw = None if w is None else jnp.asarray(w)
    want = np.asarray(rE.embedding_bag_padded(
        jnp.asarray(table), jnp.asarray(idx), jw, combiner))
    oracle = np.asarray(rref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx), jw, combiner))
    got = E.embedding_bag_padded(_t(table), _t(idx), _t(w), combiner).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_ids_at_or_above_vocab_read_the_last_row(dtype):
    """Ids at or above V are clipped to V − 1, as the reference's oracle
    clips (its Pallas kernel clamps only at 0: ROADMAP §C)."""
    V, d = 12, 8
    table, _, _ = _bag_inputs(3, V, d, 1, 1)
    idx = np.array([[V, 3, -1], [V + 7, 2**31 - 1, V - 1],
                    [-5, -1, -1]], dtype)
    want = np.asarray(rref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx.astype(np.int32)), None, "sum"))
    got = _port_bag(table, idx, None, "sum")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1], 3 * table[V - 1])
    assert not np.any(got[2])


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_tables_are_widened_before_the_sum(dtype):
    table, idx, w = _bag_inputs(9, 40, 12, 6, 7, weighted=True)
    half = torch.from_numpy(table).to(dtype)
    got = ops.embedding_bag(half, torch.from_numpy(idx),
                            torch.from_numpy(w), "mean")
    want = ref.embedding_bag_ref(half.float(), torch.from_numpy(idx),
                                 torch.from_numpy(w), "mean")
    assert torch.equal(got, want)


def test_bag_rejects_an_unknown_combiner():
    table, idx, _ = _bag_inputs(0, 5, 4, 2, 2)
    with pytest.raises(ValueError):
        _port_bag(table, idx, None, "max")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_ragged_bag_matches_reference(combiner):
    rng = np.random.default_rng(4)
    V, d, L, n_bags = 30, 6, 40, 9
    table = rng.standard_normal((V, d)).astype(np.float32)
    indices = rng.integers(-1, V + 3, L).astype(np.int32)  # pads, past V
    seg = np.sort(rng.integers(0, n_bags + 2, L)).astype(np.int32)
    want = np.asarray(rE.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(indices), jnp.asarray(seg), n_bags,
        combiner))
    got = E.embedding_bag_ragged(
        torch.from_numpy(table), torch.from_numpy(indices),
        torch.from_numpy(seg), n_bags, combiner).numpy()
    assert got.shape == (n_bags, d)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_hashed_lookup_matches_reference_near_the_int32_edges():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((997, 4)).astype(np.float32)
    ids = np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 200),
        [0, 1, -1, -2, 2**31 - 1, 2**31 - 2, -2**31, -2**31 + 1],
    ]).astype(np.int32).reshape(13, 16)
    want = np.asarray(rE.hashed_embedding_lookup(jnp.asarray(table),
                                                 jnp.asarray(ids)))
    got = E.hashed_embedding_lookup(torch.from_numpy(table),
                                    torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_multi_field_lookup_matches_reference():
    rng = np.random.default_rng(6)
    F, V, d, B = 5, 20, 3, 11
    tables = rng.standard_normal((F, V, d)).astype(np.float32)
    ids = rng.integers(-3, V + 3, (B, F)).astype(np.int32)  # clipped ends
    want = np.asarray(rE.multi_field_lookup(jnp.asarray(tables),
                                            jnp.asarray(ids)))
    got = E.multi_field_lookup(torch.from_numpy(tables),
                               torch.from_numpy(ids)).numpy()
    assert got.shape == (B, F, d)
    np.testing.assert_array_equal(got, want)


def test_init_embedding_table_is_seeded_and_scaled():
    a = E.init_embedding_table(500, 8, torch.Generator().manual_seed(3),
                               device="cpu")["table"]
    b = E.init_embedding_table(500, 8, torch.Generator().manual_seed(3),
                               device="cpu")["table"]
    assert a.shape == (500, 8) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert 0.005 < float(a.std()) < 0.02  # scale 0.01
