"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere; the skip is
decided when a test runs, not at import. The file imports neither JAX
nor the JAX package, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: the merge only selects, so it must match exactly; the
gather-distance and dequant-gather-distance kernels sum d float32
products in another order than the plain versions, so they match to
rtol 1e-5, atol 1e-4 (the dequantized elements themselves are equal: the
kernel dequantizes with one unfused multiply, as the plain version does).
The ADC kernel sums its table entries in the plain version's order with
IEEE operations, so it must match exactly, and equal the numpy oracle
``pq.adc_distance_np`` too.
"""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import engine as E
from repro_torch.core import pq, quant
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.storage import InMemoryBackend
from repro_torch.kernels import ops, ref
from repro_torch.kernels.topk import MAX_CANDIDATES

METRICS = ["l2", "ip", "cos"]

MERGE_CASES = {
    "ties": ([[0.0] * 6], [[10, 11, 12, 13, 14, 15]], 6),
    "sentinels": ([[np.nan, 0.5, -np.inf, np.inf, 1.5, 0.25]],
                  [[1, 2, 3, 4, -1, 6]], 4),
    "duplicates": ([[5.0, 2.0, 2.0, 7.0, 2.0]], [[3, 9, 9, 3, 4]], 4),
    "cross_row_duplicates": ([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]],
                             [[7, 7, 8], [7, 8, 8]], 3),
    "k_exceeds_m": ([[3.0, 1.0]], [[5, 8]], 5),
    "all_sentinel_row": ([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
                         [[-1, -1, -1], [-1, 7, -1]], 2),
}


@pytest.fixture
def cuda():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _gd_inputs(seed, n, d, B, K):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    ids = rng.integers(-1, n, (B, K)).astype(np.int32)
    ids[:, -1] = -1
    return table, ids, Q


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [768, 30])  # float4 path, scalar path
def test_gather_distance_kernel_matches_plain(cuda, metric, d):
    table, ids, Q = _gd_inputs(3, n=300, d=d, B=8, K=97)
    args = [torch.from_numpy(a).to(cuda) for a in (table, ids, Q)]
    before = ops.launch_counts()
    got = ops.gather_distance_batch(*args, metric)
    single = ops.gather_distance(args[0], args[1][0], args[2][0], metric)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["gather_distance_batch"] == before["gather_distance_batch"] + 1
    assert after["gather_distance"] == before["gather_distance"] + 1
    want = ref.gather_distance_batch_ref(*args, metric)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.isinf(got[args[1] < 0]).all()
    assert torch.equal(single, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", ["int8", "float16"])
@pytest.mark.parametrize("d", [768, 30])  # 16-byte path, scalar path
def test_dequant_gather_distance_kernel_matches_plain(cuda, precision,
                                                      metric, d):
    table, ids, Q = _gd_inputs(4, n=300, d=d, B=8, K=97)
    payload, scales = quant.quantize_np(3 * table, precision)
    P = torch.from_numpy(payload).to(cuda)
    S = torch.from_numpy(scales).to(cuda) if precision == "int8" else None
    I, Qt = torch.from_numpy(ids).to(cuda), torch.from_numpy(Q).to(cuda)
    before = ops.launch_counts()
    got = ops.dequant_gather_distance_batch(P, S, I, Qt, metric)
    single = ops.dequant_gather_distance(P, S, I[0], Qt[0], metric)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for form in ("dequant_gather_distance", "dequant_gather_distance_batch"):
        assert after[form] == before[form] + 1
    want = ref.dequant_gather_distance_batch_ref(P, S, I, Qt, metric)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.isinf(got[I < 0]).all()
    assert torch.equal(single, got[0])


@pytest.mark.cuda
def test_dequant_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q8 = torch.zeros((10, 8), dtype=torch.int8, device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    Q = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError, match="scales"):
        ops.dequant_gather_distance_batch(q8, None, ids, Q)
    with pytest.raises(ValueError, match="no scales"):
        ops.dequant_gather_distance_batch(
            q8.half(), torch.ones(10, device=cuda), ids, Q)
    with pytest.raises(ValueError):
        ops.dequant_gather_distance_batch(q8.float(), None, ids, Q)


def _adc_inputs(seed, n, M, B, K, metric, dsub=4):
    """A random codebook, codes over ``n`` rows, one table per query (by
    the numpy oracle's builder) and -1-padded ids with one past the end."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((M, 256, dsub)).astype(np.float32)
    codes = rng.integers(0, 256, (n, M)).astype(np.uint8)
    Q = rng.standard_normal((B, M * dsub)).astype(np.float32)
    luts = np.stack([pq.build_lut_np(q, cent, metric) for q in Q])
    ids = rng.integers(-1, n, (B, K)).astype(np.int32)
    ids[:, -1] = -1
    ids[0, 0] = n + 5  # past the end: reads the last row, as the oracle
    return codes, luts, ids


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("M", [32, 192, 8, 20])  # chunks; 16-byte / byte path
def test_adc_gather_distance_kernel_equals_plain_and_oracle(cuda, metric,
                                                            M):
    """Both ADC forms on the card equal the plain version and the numpy
    oracle under array_equal; M = 192 takes several 32 KiB table chunks
    (12 at cos)."""
    codes, luts, ids = _adc_inputs(5, n=300, M=M, B=8, K=97, metric=metric)
    C, T, I = (torch.from_numpy(a).to(cuda) for a in (codes, luts, ids))
    before = ops.launch_counts()
    got = ops.adc_gather_distance_batch(C, T, I, metric)
    single = ops.adc_gather_distance(C, T[0], I[0], metric)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for form in ("adc_gather_distance", "adc_gather_distance_batch"):
        assert after[form] == before[form] + 1
    want = ref.adc_gather_distance_batch_ref(C, T, I, metric)
    assert torch.equal(got, want)
    assert torch.equal(single, got[0])
    assert torch.equal(single, ref.adc_gather_distance_ref(C, T[0], I[0],
                                                           metric))
    oracle = pq.adc_distance_batch_np(codes, luts, ids, metric)
    np.testing.assert_array_equal(got.cpu().numpy(), oracle)
    assert torch.isinf(got[I < 0]).all()


@pytest.mark.cuda
def test_adc_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    codes = torch.zeros((10, 8), dtype=torch.uint8, device=cuda)
    luts = torch.zeros((2, 1, 8, 256), device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="luts"):
        ops.adc_gather_distance_batch(codes, luts, ids, "cos")  # L = 2
    with pytest.raises(ValueError):
        ops.adc_gather_distance_batch(codes.to(torch.int8), luts, ids)
    with pytest.raises(ValueError):
        ops.adc_gather_distance_batch(codes, luts, ids.long())
    with pytest.raises(ValueError):
        ops.adc_gather_distance_batch(codes, luts[:, :, :4], ids)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_pq_codec_on_card_equals_cpu(cuda, metric):
    """The torch codec's encode and lookup tables give the same bits on
    the card as on the CPU (one IEEE operation at a time), and so does
    training (float64 cluster sums)."""
    rng = np.random.default_rng(6)
    X = rng.standard_normal((300, 64)).astype(np.float32)
    cb = pq.train_pq(X, n_subspaces=16, n_iters=4, seed=0, device="cpu")
    on_card = pq.train_pq(X, n_subspaces=16, n_iters=4, seed=0, device=cuda)
    np.testing.assert_array_equal(on_card.centroids, cb.centroids)
    cent = torch.from_numpy(cb.centroids)
    Xt = torch.from_numpy(X)
    assert torch.equal(pq.encode(Xt.to(cuda), cent.to(cuda)).cpu(),
                       pq.encode(Xt, cent))
    assert torch.equal(pq.build_lut(Xt[:5].to(cuda), cent.to(cuda),
                                    metric).cpu(),
                       pq.build_lut(Xt[:5], cent, metric))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,fused", [("batched", False), ("loop", False),
                                        ("loop", True)])
def test_pq_engine_on_card_matches_cpu(cuda, mode, fused):
    """The pq paths on the card against the same engine on the CPU, with
    one codebook: equal ids, reranked distances and access counts, a
    bit-equal tier 2, and the ADC kernel served every run."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((600, 64)).astype(np.float32)
    Q = X[rng.choice(600, 6)] + 0.1 * rng.standard_normal((6, 64)).astype(
        np.float32)
    g = build_hnsw(X, M=8, ef_construction=40, seed=0)
    cb = pq.train_pq(X, n_subspaces=16, n_iters=8, seed=0, device=cuda)
    res, tier2 = {}, {}
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        backend = InMemoryBackend(X)
        backend.codebook = cb
        eng = E.WebANNSEngine(backend, g, E.EngineConfig(
            cache_capacity=150, device=dev, precision="pq",
            pq_subspaces=16, rerank_alpha=4.0, fused=fused))
        res[dev] = eng.search(E.SearchRequest(query=Q, k=10, ef=32,
                                              batch_mode=mode))
        tier2[dev] = convert.cache_to_numpy(eng.store.cache)
    counts = ops.launch_counts()
    form = "adc_gather_distance" + ("" if mode == "loop" else "_batch")
    assert counts[form] > 0, counts
    on, off = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(on.ids, off.ids)
    np.testing.assert_array_equal(on.dists, off.dists)
    assert on.batch_stats.n_db == off.batch_stats.n_db
    for name in convert.CACHE_FIELDS:
        np.testing.assert_array_equal(tier2["cuda"][name], tier2["cpu"][name],
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_topk_kernel_matches_plain(cuda, case):
    d, i, k = MERGE_CASES[case]
    d = torch.tensor(d, dtype=torch.float32, device=cuda)
    i = torch.tensor(i, dtype=torch.int32, device=cuda)
    got = ops.merge_topk(d, i, k)
    want = ref.merge_topk_ref(d, i, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,k", [(32, 96, 64), (32, 161, 64), (32, 33, 1),
                                   (3, 1000, 50), (1, 7, 3),
                                   (2, MAX_CANDIDATES, 16)])
def test_merge_topk_kernel_random(cuda, B, M, k):
    rng = np.random.default_rng(B + M + k)
    d = np.round(rng.random((B, M)), 2).astype(np.float32)
    i = rng.integers(0, max(2, M // 2), (B, M)).astype(np.int32)
    i[rng.random((B, M)) < 0.15] = -1
    d[rng.random((B, M)) < 0.05] = np.nan
    d[rng.random((B, M)) < 0.05] = np.inf
    dt, it = torch.from_numpy(d).to(cuda), torch.from_numpy(i).to(cuda)
    for g, w in zip(ops.merge_topk(dt, it, k), ref.merge_topk_ref(dt, it, k)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    table = torch.zeros((10, 8), device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ops.gather_distance_batch(table, ids, torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError):
        ops.merge_topk(torch.zeros((2, 3), device=cuda),
                       torch.zeros((2, 3), dtype=torch.int32), 2)
    wide = (1, MAX_CANDIDATES + 1)  # more than one block's shared memory
    with pytest.raises(ValueError):
        ops.merge_topk(torch.zeros(wide, device=cuda),
                       torch.zeros(wide, dtype=torch.int32, device=cuda), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["batched", "loop"])
def test_engine_on_card_matches_engine_on_cpu(cuda, mode):
    """The same graph and queries served on the card and on the CPU:
    equal ids and access counts, distances to float32 rounding, and the
    driver's kernels ran. (Loop and batched results are not compared:
    a cold lazy search depends on the tier-2 state it meets, which the
    two drivers evolve differently — the JAX engine differs the same way
    on these inputs.)"""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((600, 64)).astype(np.float32)
    Q = X[rng.choice(600, 6)] + 0.1 * rng.standard_normal((6, 64)).astype(
        np.float32)
    g = build_hnsw(X, M=8, ef_construction=40, seed=0)
    res = {}
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        eng = E.WebANNSEngine(X, g, E.EngineConfig(cache_capacity=150,
                                                   device=dev))
        res[dev] = eng.search(E.SearchRequest(query=Q, k=10, ef=32,
                                              batch_mode=mode))
    counts = ops.launch_counts()
    form = "gather_distance_batch" if mode == "batched" else "gather_distance"
    assert counts[form] > 0 and counts["merge_topk"] > 0, counts
    on, off = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(on.ids, off.ids)
    np.testing.assert_allclose(on.dists, off.dists, rtol=1e-5)
    assert on.batch_stats.n_db == off.batch_stats.n_db
    assert [s.n_db for s in on.stats] == [s.n_db for s in off.stats]


@pytest.mark.cuda
@pytest.mark.parametrize("precision,mode,fused", [
    ("int8", "batched", False), ("int8", "loop", False),
    ("float16", "batched", False), ("float16", "loop", False),
    ("float32", "loop", True), ("float16", "loop", True),
    ("int8", "loop", True)])
def test_quantized_and_fused_engine_on_card_matches_cpu(cuda, precision,
                                                        mode, fused):
    """The quantized and fused paths on the card against the same engine
    on the CPU: equal ids, reranked distances and access counts, a
    bit-equal tier 2, and the dequant kernel served every quantized
    run."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((600, 64)).astype(np.float32)
    Q = X[rng.choice(600, 6)] + 0.1 * rng.standard_normal((6, 64)).astype(
        np.float32)
    g = build_hnsw(X, M=8, ef_construction=40, seed=0)
    res, tier2 = {}, {}
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        eng = E.WebANNSEngine(X, g, E.EngineConfig(
            cache_capacity=150, device=dev, precision=precision,
            fused=fused))
        res[dev] = eng.search(E.SearchRequest(query=Q, k=10, ef=32,
                                              batch_mode=mode))
        tier2[dev] = convert.cache_to_numpy(eng.store.cache)
    counts = ops.launch_counts()
    if precision != "float32":
        single = mode == "loop"
        form = "dequant_gather_distance" + ("" if single else "_batch")
        assert counts[form] > 0, counts
    on, off = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(on.ids, off.ids)
    np.testing.assert_allclose(on.dists, off.dists, rtol=1e-5)
    assert on.batch_stats.n_db == off.batch_stats.n_db
    for name in convert.CACHE_FIELDS:
        np.testing.assert_array_equal(tier2["cuda"][name], tier2["cpu"][name],
                                      err_msg=name)
