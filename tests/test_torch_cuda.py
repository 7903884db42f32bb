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
``pq.adc_distance_np`` too. The distance-matrix kernel forms its
products on the tensor cores in 3×TF32 (each element split into two TF32
parts, three products a pair) and sums them in another order than the
plain version's float32 matmul (TF32 off), so it matches to 1e-5 of the
scale of its terms: |q|² + |x|² for l2, |q|·|x| for ip, 1 for cos. The top-k kernel only selects, so it matches exactly.
The embedding-bag kernel sums each column in slot order with IEEE
operations, as its plain version does, so it matches exactly; the recsys
models on the card match their CPU forward to rtol 1e-4, atol 1e-5 (float32
matmuls and softmaxes that sum in other orders, TF32 off). A search
phase replayed from CUDA graphs (``core/step_graph.py``) must equal the
same phase's eager loop on the card exactly, launch counts included. The
hop-step kernel B.8 must equal the per-op step it replaces (B.1 or B.3
and B.2 around PyTorch ops) exactly: it runs their distance stage and
merge from the same headers.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import engine as E
from repro_torch.core import pq, quant
from repro_torch.core import search as S
from repro_torch.core import step_graph
from repro_torch.core import store as PS
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.storage import InMemoryBackend
from repro_torch.core.store import ExternalStore, TieredStore
from repro_torch.kernels import ops, ref
from repro_torch.core import distributed as D
from repro_torch.kernels.topk import MAX_CANDIDATES, TOPK_MAX_K
from repro_torch.launch import mesh as PM
from repro_torch import configs as PC
from repro_torch.data.synthetic import click_batches
from repro_torch.models import recsys as PRS

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the hop step's states and tier 2s)

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
# 16-byte code path (32, 192, 300 past the 256-subspace chunk: 16-byte
# loads need M % 16 == 0, so 300 takes the byte path); byte path (8, 20)
@pytest.mark.parametrize("M", [32, 192, 8, 20, 300])
def test_adc_gather_distance_kernel_equals_plain_and_oracle(cuda, metric,
                                                            M):
    """Both ADC forms on the card equal the plain version and the numpy
    oracle under array_equal; M = 300 takes two chunks of subspaces."""
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
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("M,B,K", [(192, 1, 97), (192, 3, 33), (512, 3, 97),
                                   (300, 1, 5)])
def test_adc_gather_distance_kernel_ragged_slots(cuda, metric, M, B, K):
    """A warp a (query, id) slot, four a block: B·K slots that leave the
    last block part empty (97, 99, 291, 5), ids −1 and past the end, M
    past one chunk (512: two full chunks on the 16-byte path), the
    fused bulk load's (1, 97): both forms equal the plain version and the
    oracle, and the single form equals the batched form's row."""
    codes, luts, ids = _adc_inputs(11, n=400, M=M, B=B, K=K, metric=metric)
    C, T, I = (torch.from_numpy(a).to(cuda) for a in (codes, luts, ids))
    got = ops.adc_gather_distance_batch(C, T, I, metric)
    rows = [ops.adc_gather_distance(C, T[b], I[b], metric) for b in range(B)]
    torch.cuda.synchronize()
    assert torch.equal(got, ref.adc_gather_distance_batch_ref(C, T, I, metric))
    for b in range(B):
        assert torch.equal(rows[b], got[b])
    np.testing.assert_array_equal(
        got.cpu().numpy(), pq.adc_distance_batch_np(codes, luts, ids, metric))
    assert torch.isinf(got[I < 0]).all() and torch.isfinite(got[I >= 0]).all()


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


def _merge_rows(kind, B, M, k):
    """(dists, ids) numpy rows for the merge, by kind:

    - ``ties``: rounded distances, ids from [0, M/2) (duplicates), ids -1
      and NaN / +inf distances;
    - ``path``: as the beam merge sends them, an ef = 64 beam of ascending
      distances then new entries, ids distinct, all valid;
    - ``beam``: the same with a k-wide beam (a filter's boosted ef);
    - ``dups_after`` / ``dups_before``: every id twice, its best copy in
      the first half of the row (equal distances included) or only in the
      second, so the dedup must look forward or back (at odd M the last
      entry's id is once);
    - ``sentinel_runs``: distinct ids, positions [256, 512) all sentinels
      (id -1, NaN, +inf and -inf in turn: a whole run of the wide
      variant) and every third entry elsewhere one too;
    - ``zeros``: distinct ids, distances -0.0, +0.0 and a few others, so
      -0.0 ties +0.0 and the output keeps each input's bits;
    - ``few_ids``: ids from [0, 12), so at most 12 survivors a row;
    - ``crowded``: distinct ids but for the 40 best entries, which share
      two ids, so the first survivors lie far apart in rank.
    """
    rng = np.random.default_rng(B + M + k)
    if kind == "ties":
        d = np.round(rng.random((B, M)), 2).astype(np.float32)
        i = rng.integers(0, max(2, M // 2), (B, M)).astype(np.int32)
        i[rng.random((B, M)) < 0.15] = -1
        d[rng.random((B, M)) < 0.05] = np.nan
        d[rng.random((B, M)) < 0.05] = np.inf
        return d, i
    ids = np.stack([rng.choice(10**6, M, replace=False)
                    for _ in range(B)]).astype(np.int32)
    if kind in ("path", "beam"):
        ef = min(64 if kind == "path" else k, M)
        d = np.concatenate([np.sort(rng.random((B, ef)), 1),
                            rng.random((B, M - ef))], 1)
        return d.astype(np.float32), ids
    if kind == "sentinel_runs":
        d = rng.random((B, M)).astype(np.float32)
        pos = np.arange(M)
        dead = ((pos >= 256) & (pos < 512)) | (pos % 3 == 0)
        kinds = pos % 4
        ids[:, dead & (kinds == 0)] = -1
        d[:, dead & (kinds == 1)] = np.nan
        d[:, dead & (kinds == 2)] = np.inf
        d[:, dead & (kinds == 3)] = -np.inf
        return d, ids
    if kind == "zeros":
        d = rng.choice(np.array([-0.0, 0.0, 0.5, 1.0], np.float32), (B, M))
        return d, ids
    if kind == "few_ids":
        return (np.round(rng.random((B, M)), 2).astype(np.float32),
                rng.integers(0, 12, (B, M)).astype(np.int32))
    if kind == "crowded":
        d = np.round(rng.random((B, M)), 2).astype(np.float32)
        best = np.argsort(d, 1, kind="stable")[:, :40]
        np.put_along_axis(ids, best, rng.integers(0, 2, (B, 40)), 1)
        return d, ids
    h = M // 2  # ids[:h] twice
    best = np.round(rng.random((B, h)), 2)
    if kind == "dups_after":  # the second copy equal (a tie) or worse
        first, second = best, best + rng.choice([0.0, 0.5], (B, h))
    else:  # the first copy strictly worse
        first, second = best + 0.5, best
    d = np.concatenate([first, second], 1).astype(np.float32)
    i = np.concatenate([ids[:, :h], ids[:, :h]], 1)
    if M % 2:  # one id once, at the end
        d = np.concatenate([d, rng.random((B, 1)).astype(np.float32)], 1)
        i = np.concatenate([i, ids[:, h:h + 1]], 1)
    return d, i


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M,k", [
    ("ties", 32, 96, 64), ("ties", 32, 161, 64), ("ties", 32, 33, 1),
    ("ties", 3, 1000, 50), ("ties", 1, 7, 3), ("ties", 2, MAX_CANDIDATES, 16),
    # the beam merge's rows: a hop, a load phase, the loop driver's B = 1
    ("path", 32, 96, 64), ("path", 32, 161, 64), ("path", 1, 96, 64),
    # both sides of the warp-sort variant's limit (kSortMax = 256 in
    # csrc/merge_topk.cu)
    ("ties", 4, 255, 64), ("ties", 4, 256, 64), ("ties", 4, 257, 64),
    ("ties", 3, 256, 256), ("ties", 3, 200, 300),  # k = M, k > M
    ("dups_after", 8, 160, 64), ("dups_before", 8, 160, 64),
    ("dups_after", 2, 600, 64), ("dups_before", 2, 600, 64),
    # a filter's wider beams (ef 208 and 256, degree 32): the per-op hop
    # step's row at ef 256 and the load phases' 2·ef + 33, batched and
    # single
    ("beam", 32, 288, 256), ("beam", 32, 545, 256), ("beam", 1, 288, 256),
    ("beam", 1, 545, 256), ("beam", 32, 449, 208), ("ties", 32, 545, 256),
    # the wide variant's joins: runs of 256 sorted by a warp each, merged
    # by rank; a row one entry past a run, on a run's end and past the
    # block's 16 runs (MAX_CANDIDATES, above)
    ("ties", 4, 512, 64), ("ties", 4, 513, 64), ("ties", 4, 769, 256),
    ("beam", 4, 1000, 256), ("ties", 2, MAX_CANDIDATES, 256),
    ("path", 2, MAX_CANDIDATES, 64),
    # duplicates across runs and within the first k ranks: every id twice
    ("dups_after", 32, 545, 256), ("dups_before", 32, 545, 256),
    ("dups_after", 4, 769, 300), ("dups_before", 2, MAX_CANDIDATES, 256),
    # whole runs of sentinels, fewer survivors than k, -0.0 against +0.0
    ("sentinel_runs", 4, 769, 64), ("sentinel_runs", 4, 545, 400),
    ("sentinel_runs", 2, 1000, 1000), ("zeros", 8, 545, 256),
    ("zeros", 4, 1000, 600),
    # k = 1, k = M, k > M past the warp variant
    ("ties", 8, 545, 1), ("beam", 8, 545, 1), ("ties", 3, 545, 545),
    ("ties", 3, 600, 700), ("beam", 3, 449, 449),
    # an id repeated many times: fewer survivors than k, or survivors far
    # apart in rank
    ("few_ids", 4, 545, 16), ("few_ids", 2, MAX_CANDIDATES, 16),
    ("crowded", 4, 769, 16), ("crowded", 2, MAX_CANDIDATES, 5),
    ("crowded", 4, 1000, 64), ("dups_before", 4, 1000, 16),
    ("dups_after", 4, 1000, 100),
])
def test_merge_topk_kernel_random(cuda, kind, B, M, k):
    d, i = _merge_rows(kind, B, M, k)
    dt, it = torch.from_numpy(d).to(cuda), torch.from_numpy(i).to(cuda)
    for g, w in zip(ops.merge_topk(dt, it, k), ref.merge_topk_ref(dt, it, k)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,ef,k", [(32, 256, 10), (1, 256, 10), (8, 96, 20),
                                    (4, 64, 64)])
@pytest.mark.parametrize("shared", [True, False])
def test_finalize_topk_with_deny_mask_on_card(cuda, B, ef, k, shared):
    """``search.finalize_topk`` under a filter's deny mask ((N,) shared
    or (B, N) a query) on the card, through B.2, equals the same on the
    CPU through the plain merge: denied and padded entries never win,
    the allowed ones keep their beam order."""
    rng = np.random.default_rng(B + ef + k)
    n = 5_000
    d = np.sort(rng.random((B, ef)), 1).astype(np.float32)
    i = np.stack([rng.choice(n, ef, replace=False)
                  for _ in range(B)]).astype(np.int32)
    i[:, ef - ef // 8:] = -1  # the beam's padded tail
    d[i < 0] = np.inf
    denied = rng.random(n if shared else (B, n)) < 0.5
    out = {}
    for dev in ("cuda", "cpu"):
        beam = S.Beam(torch.from_numpy(i).to(dev), torch.from_numpy(d).to(dev),
                      torch.zeros((B, ef), dtype=torch.bool, device=dev))
        st = S.SearchState(beam, *[torch.zeros(1, device=dev)] * 5)
        out[dev] = S.finalize_topk(st, k, torch.from_numpy(denied).to(dev))
        one = S.finalize_topk(S._first(S._map_state(st, lambda t: t[:1])),
                              k, torch.from_numpy(denied if shared
                                                  else denied[0]).to(dev))
        for a, b in zip(one, out[dev]):
            assert torch.equal(a.cpu(), b[0].cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.cpu(), b)
    ids = out["cpu"][1].numpy()
    rows = np.broadcast_to(denied, (B, n)) if shared else denied
    for b in range(B):
        kept = ids[b][ids[b] >= 0]
        assert not rows[b][kept].any()
        allowed = [x for x in i[b] if x >= 0 and not rows[b][x]]
        assert kept.tolist() == allowed[:k]


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,k", [(32, 161, 64), (32, 545, 256),
                                   (2, MAX_CANDIDATES, 16)])
def test_merge_topk_graph_capture(cuda, B, M, k):
    """A merge captured in a CUDA graph (no host sync, no allocation
    beyond its outputs) replays to the plain version's bits on new
    inputs: a load phase's row at ef 64 (the warp variant), a filter's
    at ef 256 and the widest row (the wide variant, which sets its
    shared-memory limit inside the capture, past the 48 KB default at
    the widest)."""
    d, i = (torch.from_numpy(a).to(cuda)
            for a in _merge_rows("path", B, M, k))
    ops.merge_topk(d, i, k)  # build and load before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.merge_topk(d, i, k)
    # the second and third: duplicates and sentinels
    for kind in ("path", "ties", "dups_before"):
        d2, i2 = _merge_rows(kind, B, M, k + 1)
        d.copy_(torch.from_numpy(d2))
        i.copy_(torch.from_numpy(i2))
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, ref.merge_topk_ref(d, i, k)):
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
    wide = (1, MAX_CANDIDATES + 1)  # past the widest row the merge takes
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


def scaled_error(got, want, Q, X, metric):
    """Largest |got − want| in units of the metric's scale (see above)."""
    qn = (Q.double() ** 2).sum(1)[:, None]
    xn = (X.double() ** 2).sum(1)[None, :]
    scale = {"l2": qn + xn, "ip": (qn * xn).sqrt(),
             "cos": torch.ones_like(qn * xn)}[metric]
    err = (got.double() - want.double()).abs() / scale.clamp_min(1e-30)
    return float(err.max()) if err.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("B,N,d", [
    (1, 1, 1), (3, 1000, 5), (32, 4097, 768), (129, 20000, 768),
    # the 3×TF32 kernel's edges: its tile is 128 rows by 8, 16 or 32
    # queries, its ring takes 32-deep slices by 16-byte copies, 4-byte
    # copies where d % 4 != 0
    (1, 1000, 64), (8, 3001, 770), (33, 5000, 64), (33, 1001, 770),
    (8, 300, 36)])
def test_distance_matrix_kernel_matches_plain(cuda, metric, B, N, d):
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(B + N + d)
    Q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32)).to(
        cuda)
    X = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32)).to(
        cuda)
    before = ops.launch_counts()["distance_matrix"]
    got = ops.distance_matrix(Q, X, metric)
    torch.cuda.synchronize()
    assert ops.launch_counts()["distance_matrix"] == before + 1
    want = ref.distance_matrix_ref(Q, X, metric)
    assert got.shape == (B, N) and bool(torch.isfinite(got).all())
    assert scaled_error(got, want, Q, X, metric) <= 1e-5


def _dm_inputs(seed, B, N, d, cuda, offset=0):
    """Gaussian Q (B, d) and X (N, d) on the card; X starts ``offset``
    floats into its buffer (1: a base off the 16-byte boundary)."""
    rng = np.random.default_rng(seed)
    Q = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    buf = torch.from_numpy(rng.standard_normal(offset + N * d).astype(
        np.float32)).to(cuda)
    X = buf[offset:].view(N, d)
    return Q.to(cuda), X


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("B,N,d", [(1, 1000, 64), (16, 129, 64)])
def test_distance_matrix_kernel_unaligned_table(cuda, metric, B, N, d):
    """X a view one float into its buffer, off the 16-byte boundary: the
    kernel takes its 4-byte copies, within 1e-5 of the scale."""
    Q, X = _dm_inputs(B * N + d, B, N, d, cuda, offset=1)
    assert X.data_ptr() % 16 != 0 and X.is_contiguous()
    got = ops.distance_matrix(Q, X, metric)
    want = ref.distance_matrix_ref(Q, X, metric)
    torch.cuda.synchronize()
    assert got.shape == (B, N) and bool(torch.isfinite(got).all())
    assert scaled_error(got, want, Q, X, metric) <= 1e-5


@pytest.mark.cuda
def test_distance_matrix_kernel_at_retrieval_shape(cuda):
    """Retrieval's (1, N, 64) ip at N = 200,000 (a persistent grid walks
    1,563 tiles), within 1e-5 of the scale."""
    Q, X = _dm_inputs(7, 1, 200_000, 64, cuda)
    got = ops.distance_matrix(Q, X, "ip")
    want = ref.distance_matrix_ref(Q, X, "ip")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert scaled_error(got, want, Q, X, "ip") <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_distance_matrix_kernel_padding_row(cuda, metric):
    """A table row of 3.4e38, as the substrate pads its shards: the
    kernel runs to its end, and every other column equals the plain
    version within 1e-5 of the scale."""
    Q, X = _dm_inputs(9, 32, 1000, 768, cuda)
    X[517] = float(D.PAD_VALUE)
    got = ops.distance_matrix(Q, X, metric)
    torch.cuda.synchronize()
    want = ref.distance_matrix_ref(Q, X, metric)
    keep = torch.ones(1000, dtype=torch.bool, device=cuda)
    keep[517] = False
    assert bool(torch.isfinite(got[:, keep]).all())
    assert scaled_error(got[:, keep], want[:, keep], Q, X[keep],
                        metric) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_distance_matrix_kernel_keeps_nan(cuda, metric):
    """A NaN in a query or a table row comes out NaN in that row or
    column, as in the plain version (the TF32 split alone may drop it;
    the norms carry it)."""
    Q, X = _dm_inputs(13, 4, 300, 64, cuda)
    X[7, 3] = float("nan")
    Q[2, 5] = float("nan")
    got = ops.distance_matrix(Q, X, metric)
    want = ref.distance_matrix_ref(Q, X, metric)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[:, 7]).all() and torch.isnan(got[2]).all())


def _topk_cases():
    rng = np.random.default_rng(5)
    ties = np.round(rng.random((4, 3000)), 1).astype(np.float32)
    infs = rng.random((6, 2500)).astype(np.float32)
    infs[rng.random(infs.shape) < 0.5] = np.inf
    infs[0] = np.inf  # an all-inf row
    infs[1, 3:] = np.inf  # fewer than k finite entries, across tiles
    infs[1, 2047] = 0.5
    return {
        "n_one": (rng.random((3, 1)).astype(np.float32), 1),
        "ragged_k10": (rng.standard_normal((7, 1500)).astype(np.float32), 10),
        "ties_across_tiles_k10": (ties, 10),
        "ties_across_tiles_cap": (ties, TOPK_MAX_K),
        "inf_rows_k10": (infs, 10),
        "inf_rows_cap": (infs, TOPK_MAX_K),
        "k_one_wide": (rng.standard_normal((2, 480_000)).astype(np.float32),
                       1),
        "scan_shape": (rng.random((32, 20_000)).astype(np.float32), 10),
        "global_reduce": (np.round(rng.random((32, 40)), 1).astype(
            np.float32), 10),
        # the merge levels' two keys a lane (32 < k <= 64), and a last tile
        # shorter than k (40 columns at k = 64)
        "ties_k63": (ties, 63), "ties_k64": (ties, 64),
        "short_last_tile_k64": (rng.random((3, 1064)).astype(np.float32), 64),
        # retrieval's row: 977 tiles, two merge levels (977 -> 31 -> 1)
        "retrieval_shape": (rng.standard_normal((1, 1_000_000)).astype(
            np.float32), 100),
        # ties that cross the first level's groups of 32 tiles (196 -> 7 -> 1)
        "tree_ties_cap": (np.round(rng.random((2, 200_000)), 2).astype(
            np.float32), TOPK_MAX_K),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_topk_cases()))
def test_topk_kernel_equals_plain(cuda, case):
    D_np, k = _topk_cases()[case]
    Dt = torch.from_numpy(D_np).to(cuda)
    before = ops.launch_counts()["topk"]
    got = ops.topk(Dt, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["topk"] == before + 1
    want = ref.topk_ref(Dt, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for row in got[1].cpu().numpy():  # distinct, in range
        assert len(set(row.tolist())) == k and row.max() < D_np.shape[1]


@pytest.mark.cuda
def test_topk_cap_on_card(cuda):
    from repro_torch.kernels import topk as T

    assert T._topk_lib().topk_max_k() == TOPK_MAX_K
    Dt = torch.rand((2, 5000), device=cuda)
    ops.topk(Dt, TOPK_MAX_K)
    with pytest.raises(ValueError, match="at most"):
        ops.topk(Dt, TOPK_MAX_K + 1)
    with pytest.raises(ValueError, match="row width"):
        ops.topk(Dt[:, :3].contiguous(), 4)
    with pytest.raises(ValueError):
        ops.topk(Dt.double(), 2)


@pytest.mark.cuda
def test_topk_merge_levels_on_card(cuda):
    """One level up to 32 tiles of 1,024 columns, then one more per
    factor of 32: the flat scan's and retrieval's rows take two."""
    from repro_torch.kernels import topk as T

    for N, levels in ((1, 1), (10, 1), (32 * 1024, 1), (32 * 1024 + 1, 2),
                      (480_000, 2), (1_000_000, 2), (32**2 * 1024, 2),
                      (32**2 * 1024 + 1, 3)):
        assert T.topk_levels(N) == levels, N


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_distance_topk_on_card_matches_cpu(cuda, metric):
    rng = np.random.default_rng(9)
    X = rng.standard_normal((5000, 96)).astype(np.float32)
    Q = rng.standard_normal((16, 96)).astype(np.float32)
    on = ops.distance_topk(torch.from_numpy(Q).to(cuda),
                           torch.from_numpy(X).to(cuda), 10, metric)
    off = ops.distance_topk(torch.from_numpy(Q), torch.from_numpy(X), 10,
                            metric)
    D = ref.distance_matrix_ref(torch.from_numpy(Q).double(),
                                torch.from_numpy(X).double(), metric)
    on_i, off_i = on[1].cpu(), off[1]
    for r, c in zip(*torch.nonzero(on_i != off_i, as_tuple=True)):
        gap = abs(float(D[r, on_i[r, c]]) - float(D[r, off_i[r, c]]))
        assert gap <= 2e-4, (int(r), int(c), gap)
    torch.testing.assert_close(on[0].cpu(), off[0], rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["flat", "hnsw"])
def test_substrate_world_of_one_on_card_matches_cpu(cuda, tmp_path, mode):
    """The substrate at world size 1 over NCCL against the same program
    over gloo on the CPU: ids equal but for near ties; the flat scan
    launched the distance kernel once and the top-k kernel twice."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((2000, 64)).astype(np.float32)
    Q = (X[rng.integers(0, 2000, 8)]
         + 0.2 * rng.standard_normal((8, 64))).astype(np.float32)
    index = D.build_sharded_index(X, 1, M=8, ef_construction=40,
                                  hnsw=mode == "hnsw")
    res = {}
    for dev in ("cuda", "cpu"):
        group = PM.make_shard_group(
            1, device=dev, init_method=f"file://{tmp_path / dev}", rank=0)
        try:
            shard = index.shard(0, group.device)
            search = D.make_distributed_search(group, k=10, ef=32, mode=mode)
            ops.reset_launch_counts()
            d_, i_ = search(Q, shard)
            res[dev] = (d_.cpu(), i_.cpu(), ops.launch_counts())
        finally:
            PM.destroy_shard_group()
    (don, ion, counts), (doff, ioff, _) = res["cuda"], res["cpu"]
    if mode == "flat":
        assert counts["distance_matrix"] == 1 and counts["topk"] == 2, counts
    else:
        assert counts["gather_distance_batch"] > 0 and counts["topk"] == 1
    exact = ref.distance_matrix_ref(torch.from_numpy(Q).double(),
                                    torch.from_numpy(X).double(), "l2")
    for r, c in zip(*torch.nonzero(ion != ioff, as_tuple=True)):
        gap = abs(float(exact[r, ion[r, c]]) - float(exact[r, ioff[r, c]]))
        assert gap <= 2e-4, (int(r), int(c), gap)
    torch.testing.assert_close(don, doff, rtol=2e-4, atol=2e-4)


EB_DTYPES = {"f32": torch.float32, "f16": torch.float16,
             "bf16": torch.bfloat16}


def _bag_case(rng, V, d, B, S, dtype, cuda):
    """A (V, d) table at ``dtype``, (B, S) int32 ids with padding, ids at
    and above V and (where B > 1) one all-padding bag, and weights."""
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(
        np.float32)).to(dtype).to(cuda)
    idx = rng.integers(-1, V + 3, (B, S)).astype(np.int32)
    idx[0, 0] = V  # at V: reads row V - 1
    if B > 1:
        idx[1] = -1  # a bag of nothing but padding
    w = rng.uniform(-1.0, 2.0, (B, S)).astype(np.float32)
    return (table, torch.from_numpy(idx).to(cuda),
            torch.from_numpy(w).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(EB_DTYPES))
@pytest.mark.parametrize("d", [1, 3, 64, 768])  # scalar and 4-wide loads
def test_embedding_bag_kernel_equals_plain(cuda, dtype, d):
    """Sum and mean, with and without weights, S in {1, 32}, B in {1, 512}:
    the kernel equals its plain version bit for bit."""
    rng = np.random.default_rng(d)
    for S in (1, 32):
        for B in (1, 512):
            table, idx, w = _bag_case(rng, 1000, d, B, S, EB_DTYPES[dtype],
                                      cuda)
            for combiner in ("sum", "mean"):
                for weights in (None, w):
                    before = ops.launch_counts()["embedding_bag"]
                    got = ops.embedding_bag(table, idx, weights, combiner)
                    want = ref.embedding_bag_ref(table, idx, weights,
                                                 combiner)
                    torch.cuda.synchronize()
                    assert ops.launch_counts()["embedding_bag"] == before + 1
                    assert got.dtype == torch.float32
                    assert torch.equal(got, want), (S, B, combiner,
                                                    weights is None)
                    if B > 1:
                        assert not bool(got[1].any())


@pytest.mark.cuda
def test_embedding_bag_kernel_takes_int64_ids_past_int32(cuda):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(
        np.float32)).to(cuda)
    idx = torch.tensor([[2**40, 3, -2**40], [49, 50, -1]],
                       dtype=torch.int64, device=cuda)
    got = ops.embedding_bag(table, idx)
    assert torch.equal(got, ref.embedding_bag_ref(table, idx))
    assert torch.equal(got[0], table[49] + table[3])
    small = idx[:, 1:].int().contiguous()  # int32 ids
    assert torch.equal(ops.embedding_bag(table, small),
                       ref.embedding_bag_ref(table, small))


@pytest.mark.cuda
def test_embedding_bag_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    table = torch.zeros((10, 8), device=cuda)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.embedding_bag(table.double(), idx)
    with pytest.raises(ValueError):
        ops.embedding_bag(table, idx.float())
    with pytest.raises(ValueError):
        ops.embedding_bag(table, idx.cpu())
    with pytest.raises(ValueError):
        ops.embedding_bag(table, idx, torch.ones((2, 2), device=cuda))
    with pytest.raises(ValueError):
        ops.embedding_bag(table, idx, combiner="max")
    with pytest.raises(ValueError):
        ops.embedding_bag(table[:0], idx)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dlrm-rm2", "din", "autoint", "bst"])
def test_recsys_forward_on_card_matches_cpu(cuda, arch):
    """The smoke config's serve step on the card against the same
    parameters on the CPU, TF32 off."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = PC.get(arch).make_smoke_config()
    cpu = PRS.init_recsys(cfg, torch.Generator().manual_seed(0), "cpu")
    card = PRS.init_recsys(cfg, torch.Generator().manual_seed(0), cuda)
    with torch.inference_mode():  # the serve step
        for batch in click_batches(cfg, 64, 2, seed=0):
            want = PRS.recsys_forward(cpu, batch)
            got = PRS.recsys_forward(card, batch)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(PRS.recsys_loss(card, batch).cpu(),
                                       PRS.recsys_loss(cpu, batch),
                                       rtol=1e-4, atol=1e-5)


# ------------------------------------------- the graph-replayed search loop

LOOP_N, LOOP_D, LOOP_EF = 600, 64, 32


def _loop_inputs(precision):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((LOOP_N, LOOP_D)).astype(np.float32)
    Q = X[rng.choice(LOOP_N, 32)] + 0.1 * rng.standard_normal(
        (32, LOOP_D)).astype(np.float32)
    g = build_hnsw(X, M=8, ef_construction=40, seed=0)
    codebook = None
    if precision == "pq":
        codebook = pq.PQCodebook(
            rng.standard_normal((8, 256, LOOP_D // 8)).astype(np.float32))
    return X, Q, g, codebook


def _warm_store(X, precision, eviction, codebook, dev):
    store = TieredStore(ExternalStore(X), capacity=150, device=dev,
                        precision=precision, eviction=eviction,
                        codebook=codebook)
    store.warm(np.arange(0, LOOP_N, 9)[:60])
    return store


def _assert_same_runs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, dict):
            assert set(x) == set(y)
            for name in x:
                np.testing.assert_array_equal(x[name], y[name], err_msg=name)
        elif isinstance(x, (list, tuple)):
            _assert_same_runs(x, y)
        else:
            assert x == y


def _phase_runs(cuda, precision, B):
    """One layer of the batched host driver (phases, host fetches, load
    phases) with its phases through ``search.batch_search_phase`` (CUDA
    graph replays) and through ``search.batch_search_phase_eager``: per
    side the state tensors after every phase, tier 2, the launch counts
    and the loop's stats."""
    X, Q, g, codebook = _loop_inputs(precision)
    nbrs = torch.from_numpy(np.asarray(g.neighbors, np.int32)).to(cuda)
    runs = {}
    for name, phase in (("graph", S.batch_search_phase),
                        ("eager", S.batch_search_phase_eager)):
        store = _warm_store(X, precision, "fifo", codebook, cuda)
        Qt = torch.from_numpy(Q[:B]).to(cuda)
        luts = (pq.build_lut(Qt, store.cache.codebook, "l2")
                if precision == "pq" else None)
        step_graph.reset_stats()
        ops.reset_launch_counts()
        states = S.batch_make_state(B, LOOP_EF, LOOP_EF + nbrs.shape[2] + 1,
                                    LOOP_N, cuda)
        states = S.batch_seed_state(
            states, Qt, torch.full((B, 1), g.entry_point, dtype=torch.int32,
                                   device=cuda),
            S.cache_tier2(store.cache, luts), "l2")
        trace = []
        for _ in range(100):
            states = phase(Qt, nbrs[0], states,
                           S.cache_tier2(store.cache, luts), "l2", LOOP_EF)
            trace.append(S._state_tensors(states))
            if int(states.miss_count.sum()) == 0:
                break
            rows, pos = store.gather_batch(states.miss_ids.cpu().numpy())
            states = S.batch_load_phase(Qt, states, states.miss_ids, rows,
                                        pos, "l2")
        torch.cuda.synchronize()
        runs[name] = (trace, convert.cache_to_numpy(store.cache),
                      ops.launch_counts(), dict(step_graph.stats))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "int8", "float16", "pq"])
@pytest.mark.parametrize("B", [1, 32])
def test_graph_replayed_phase_equals_eager_loop(cuda, precision, B):
    """One layer of the batched host driver (phases, host fetches, load
    phases) with its phases through ``search.batch_search_phase`` (CUDA
    graph replays) and through ``search.batch_search_phase_eager``: every
    state tensor after every phase, tier 2 and the launch counts equal."""
    runs = _phase_runs(cuda, precision, B)
    assert len(runs["graph"][0]) > 2  # several phases, loads between them
    assert runs["graph"][3]["replays"] > 0 and runs["eager"][3]["replays"] == 0
    assert runs["graph"][3]["syncs"] == runs["eager"][3]["syncs"]
    _assert_same_runs(runs["graph"][:3], runs["eager"][:3])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "int8", "float16", "pq"])
@pytest.mark.parametrize("B", [1, 32])
def test_graph_replayed_phase_launches_the_hop_step_kernel(cuda, precision,
                                                           B):
    """The same layer: its hop steps are B.8 launches at float32, int8
    and float16 (and none at pq, whose steps keep the per-op kernels),
    as many replayed as eager, the states equal."""
    runs = _phase_runs(cuda, precision, B)
    graph, eager = runs["graph"][2], runs["eager"][2]
    assert graph == eager
    if precision == "pq":
        assert graph["hop_step"] == 0 and graph["adc_gather_distance" + (
            "" if B == 1 else "_batch")] > 0
    else:
        assert graph["hop_step"] > 0
    _assert_same_runs(runs["graph"][:2], runs["eager"][:2])


def _payload(X, precision, codebook, dev):
    if precision == "pq":
        return (torch.from_numpy(pq.encode_np(X, codebook.centroids)).to(dev),
                None)
    p, sc = quant.quantize_np(X, precision)
    return (torch.from_numpy(p).to(dev),
            torch.from_numpy(sc).to(dev) if p.dtype == np.int8 else None)


def _fused_runs(cuda, precision, eviction):
    """The fused driver's layer (its masked step: hop, payload gather,
    tier-2 insert, load phase) through ``search.search_layer_lazy_fused``
    (graph replays) and ``search.search_layer_lazy_fused_eager``, four
    queries on one tier 2 each: per side the states, device counters and
    tier 2 after each query, the launch counts and the loop's stats."""
    X, Q, g, codebook = _loop_inputs(precision)
    nbrs = torch.from_numpy(np.asarray(g.neighbors, np.int32)).to(cuda)
    payload, scales = _payload(X, precision, codebook, cuda)
    entry = torch.tensor([g.entry_point], dtype=torch.int32, device=cuda)
    runs = {}
    for name, layer in (("graph", S.search_layer_lazy_fused),
                        ("eager", S.search_layer_lazy_fused_eager)):
        store = _warm_store(X, precision, eviction, codebook, cuda)
        cache = store.cache
        step_graph.reset_stats()
        ops.reset_launch_counts()
        out = []
        for q in torch.from_numpy(Q[:4]).to(cuda):
            luts = (pq.build_lut(q, cache.codebook, "l2")[None]
                    if precision == "pq" else None)
            st, cache, db, fc = layer(q, nbrs[0], payload, scales, cache,
                                      entry, LOOP_EF, "l2",
                                      eviction=store.eviction, luts=luts)
            out.append((S._state_tensors(st), int(db), int(fc),
                        convert.cache_to_numpy(cache)))
        runs[name] = (out, ops.launch_counts(), dict(step_graph.stats))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("eviction", ["fifo", "lru"])
@pytest.mark.parametrize("precision", ["float32", "int8", "float16", "pq"])
def test_graph_replayed_fused_layer_equals_eager_loop(cuda, precision,
                                                      eviction):
    """The fused driver's layer (its masked step: hop, payload gather,
    tier-2 insert, load phase) through ``search.search_layer_lazy_fused``
    (graph replays) and ``search.search_layer_lazy_fused_eager``, four
    queries on one tier 2 each: state, device counters, tier 2 and launch
    counts equal."""
    runs = _fused_runs(cuda, precision, eviction)
    assert sum(o[1] for o in runs["graph"][0]) > 1  # phases that missed
    assert runs["graph"][2]["replays"] > 0 and runs["eager"][2]["replays"] == 0
    _assert_same_runs(runs["graph"][:2], runs["eager"][:2])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "int8", "float16"])
def test_graph_replayed_fused_layer_launches_the_hop_step_kernel(cuda,
                                                                 precision):
    """The fused driver's masked step launches B.8 (its gate the () bool
    "not done"), as many times replayed as eager."""
    runs = _fused_runs(cuda, precision, "fifo")
    assert runs["graph"][1]["hop_step"] == runs["eager"][1]["hop_step"] > 0
    _assert_same_runs(runs["graph"][:2], runs["eager"][:2])


@pytest.mark.cuda
def test_capture_is_not_reused_after_resize_cache(cuda):
    """A warm engine's second search replays its captures and captures
    nothing; after ``resize_cache`` (new tier-2 tensors) the search
    captures anew and returns what a fresh engine's first search does."""
    X, Q, g, _ = _loop_inputs("float32")
    cfg = E.EngineConfig(cache_capacity=150, device="cuda")
    eng = E.WebANNSEngine(X, g, cfg)
    request = E.SearchRequest(query=Q, k=10, ef=LOOP_EF)
    eng.search(request)
    step_graph.reset_stats()
    eng.search(request)
    assert step_graph.stats["captures"] == 0
    assert step_graph.stats["replays"] > 0
    eng.resize_cache(150)
    got = eng.search(request)
    assert step_graph.stats["captures"] > 0
    want = E.WebANNSEngine(X, g, cfg).search(request)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    assert got.batch_stats.n_db == want.batch_stats.n_db


FAILED_CAPTURE = """
import torch
from repro_torch.core import step_graph

def step(carry, consts):
    (x,) = carry
    if bool(x.sum() > 1e9):  # a host sync: a graph cannot capture it
        x = x * 2
    return [x + 1], x < 10

x = torch.zeros(4, device="cuda")
try:
    step_graph.run_graph(step, [x], [], [], ("sync",), 2)
except RuntimeError:
    print("raised")
else:
    print("fell back")
"""


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A step that syncs cannot be captured: ``run_graph`` raises, and
    does not fall back to the eager loop (in its own process, as a
    failed capture may leave the CUDA context unusable)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-c", FAILED_CAPTURE], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.strip().splitlines()[-1:] == ["raised"], (
        out.stdout + out.stderr)


# ------------------------------------------------ the hop-step kernel (B.8)

HOP_N, HOP_D = 600, 64
HOP_WIDE_N = 60_000  # a visited row of 60,001 bytes, past a block's 48 KB
HOP_WIDE_CACHE = 2_000  # its tier 2: most fresh neighbours miss
HOP_PORT = {"search": S, "store": PS, "quant": quant}
# the beams a step starts from: chip_smoke.hop_state's (sorted, as every
# step, seed and load phase leaves them), the same over tie_corpus (exact
# ties within the beam, among the new entries and across the two),
# shuffled (out of order), and with repeated ids (B.8's merge_row path)
HOP_BEAMS = ["random", "ties", "unsorted", "duplicates"]


@pytest.fixture(scope="module")
def hop_data():
    """Corpus, queries, neighbour rows and tier 2s on the card (or a
    skip, decided when a test runs), by width d or "wide" (a 60,000-node
    graph at HOP_D), and as ("ties", d) over ``chip_smoke.tie_corpus``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    out = {}

    def entry(X, Q, n, degs, capacity):
        tier2 = {(p, c): cs.hop_tier2(HOP_PORT, X, p, c, rng, capacity, dev)
                 for p in ("float32", "int8", "float16")
                 for c in (False, True)}
        return X, Q, {deg: cs.hop_neighbors(rng, n, deg) for deg in degs}, \
            tier2

    for d in (HOP_D, 30):  # 16-byte loads, element loads
        X = rng.standard_normal((HOP_N, d)).astype(np.float32)
        out[d] = entry(X, cs.make_queries(X, 200, seed=4), HOP_N,
                       (16, 32, 128, 192), HOP_N // 3)
        out[("ties", d)] = entry(*cs.tie_corpus(rng, HOP_N, d, 200), HOP_N,
                                 (16, 32, 128, 192), HOP_N // 3)
    X = rng.standard_normal((HOP_WIDE_N, HOP_D)).astype(np.float32)
    out["wide"] = entry(X, cs.make_queries(X, 32, seed=4), HOP_WIDE_N, (32,),
                        HOP_WIDE_CACHE)
    out[("ties", "wide")] = entry(*cs.tie_corpus(rng, HOP_WIDE_N, HOP_D, 32),
                                  HOP_WIDE_N, (32,), HOP_WIDE_CACHE)
    return out


def _hop_pair(hop_data, d, precision, metric, B, gate, ef, deg, cached,
              seed, beam="random"):
    """B.8 and the per-op step on one mid-search state (of ``beam``'s
    kind): the two steps' nine tensors, and B.8's launches in between."""
    X, Qn, nbrs_np, tier2s = hop_data[("ties", d) if beam == "ties" else d]
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    state = cs.hop_state(S, rng, X, Qn[:B], nbrs_np[deg], ef, ef + deg + 1,
                         ef, 100_000, metric, dev)
    if beam == "unsorted":
        state = cs.shuffle_beams(S, state, rng)
    elif beam == "duplicates":
        state = cs.duplicate_beams(S, state, rng)
    g = None
    if gate:
        g = (torch.tensor(True, device=dev) if B == 1 else
             torch.from_numpy(rng.random(B) < 0.7).to(dev))
    Q = torch.from_numpy(Qn[:B]).to(dev)
    nbrs = torch.from_numpy(nbrs_np[deg]).to(dev)
    tier2 = tier2s[(precision, cached)]
    before = ops.launch_counts()["hop_step"]
    got = S.batch_hop_step(Q, nbrs, state, tier2, metric, ef, gate=g)
    n = ops.launch_counts()["hop_step"] - before
    want = S.batch_hop_step_plain(Q, nbrs, state, tier2, metric, ef, gate=g)
    torch.cuda.synchronize()
    return cs.hop_step_args(S, *got), cs.hop_step_args(S, *want), n


@pytest.mark.cuda
@pytest.mark.parametrize("beam", HOP_BEAMS)
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("deg", [16, 32])
@pytest.mark.parametrize("ef", [1, 10, 64])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", ["float32", "int8", "float16"])
def test_hop_step_kernel_equals_per_op_step(hop_data, precision, metric, B,
                                            gate, ef, deg, cached, beam):
    """B.8 against the per-op step (B.1 or B.3, then B.2, around PyTorch
    ops) on the same state: every output tensor equal (torch.equal), from
    sorted beams, beams with exact ties and beams out of order (B.8's
    merge by counted ranks) and beams with repeated ids (its merge_row
    path)."""
    got, want, n = _hop_pair(hop_data, HOP_D, precision, metric, B, gate,
                             ef, deg, cached, ef * 100 + deg, beam)
    assert n == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("beam", HOP_BEAMS)
@pytest.mark.parametrize("shape", [(30, 10, 32, 32), (HOP_D, 64, 192, 32),
                                   (HOP_D, 128, 128, 32),
                                   (HOP_D, 64, 32, 200),
                                   ("wide", 64, 32, 32)])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", ["float32", "int8", "float16"])
def test_hop_step_kernel_at_other_widths(hop_data, precision, metric, shape,
                                         beam):
    """Element loads (d = 30), merge rows of 256 (the largest the kernel
    takes, its widest warp sort) and of neighbour rows wider than a warp,
    B = 200 (more blocks than SMs) and a 60,000-node graph (visited rows
    of 60,001 bytes): still the per-op step's bits, from sorted, tied,
    shuffled and repeating beams."""
    d, ef, deg, B = shape
    got, want, n = _hop_pair(hop_data, d, precision, metric, B, True, ef,
                             deg, True, 5, beam)
    assert n == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_hop_step_wrapper_rejects_what_the_kernel_does_not_take(hop_data):
    from repro_torch.kernels import hop_step as HS

    X, Qn, nbrs_np, tier2s = hop_data[HOP_D]
    dev = torch.device("cuda")
    state = cs.hop_state(S, np.random.default_rng(0), X, Qn[:4],
                         nbrs_np[32], 8, 41, 8, 100_000, "l2", dev)
    Q = torch.from_numpy(Qn[:4]).to(dev)
    nbrs = torch.from_numpy(nbrs_np[32]).to(dev)
    t2 = tier2s[("int8", True)]
    args = [Q, nbrs, *S._state_tensors(state)]
    maps = [t2.cache.slot_of, t2.cache.id_of]
    HS.hop_step_cuda(*args, t2.table, t2.scales, *maps, "l2", 8, 100)
    with pytest.raises(ValueError, match="scales"):
        HS.hop_step_cuda(*args, t2.table, None, *maps, "l2", 8, 100)
    with pytest.raises(ValueError, match="float32, int8 or float16"):
        HS.hop_step_cuda(*args, t2.table.view(torch.uint8), None, *maps,
                         "l2", 8, 100)
    bad = list(args)
    bad[5] = bad[5][:, :-1].contiguous()  # visited without its spare column
    with pytest.raises(ValueError, match="visited"):
        HS.hop_step_cuda(*bad, t2.table, t2.scales, *maps, "l2", 8, 100)
    with pytest.raises(ValueError, match="gate"):
        HS.hop_step_cuda(*args, t2.table, t2.scales, *maps, "l2", 8, 100,
                         torch.ones(3, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="unknown metric"):
        HS.hop_step_cuda(*args, t2.table, t2.scales, *maps, "dot", 8, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["layer0", "upper"])
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("precision", ["float32", "int8", "float16"])
def test_hop_step_kernel_honours_preset_visited_bits(hop_data, precision, B,
                                                     layer):
    """Tombstones enter a search as pre-set ``visited`` bits
    (``batch_make_state``): from fresh states holding a third of the nodes
    so marked (the first entry's neighbours among them), seeded and then
    stepped, B.8 equals the per-op step under ``torch.equal`` at every
    step, layer 0's shape (ef 64, degree 32, a cached tier 2) and an upper
    layer's (ef 1, degree 16, the whole table), and no marked id enters a
    beam."""
    X, Qn, nbrs_np, tier2s = hop_data[HOP_D]
    dev = torch.device("cuda")
    ef, deg, cached = (64, 32, True) if layer == "layer0" else (1, 16, False)
    rng = np.random.default_rng(ef * 100 + B)
    tier2 = tier2s[(precision, cached)]
    n = X.shape[0]
    rows = nbrs_np[deg]
    live = np.flatnonzero((rows != -1).any(1))
    if cached:  # entries the seed finds in tier 2
        ids = tier2.cache.id_of.cpu().numpy()
        live = np.intersect1d(live, ids[ids >= 0])
    entry = rng.choice(live, B)
    tomb = rng.random(n) < 1 / 3
    tomb[rows[entry[0]][rows[entry[0]] >= 0]] = True
    tomb[entry] = False
    tomb_t = torch.from_numpy(tomb).to(dev)
    Q = torch.from_numpy(Qn[:B]).to(dev)
    nbrs = torch.from_numpy(rows).to(dev)
    state = S.batch_make_state(B, ef, ef + deg + 1, n, dev, tomb_t)
    state = S.batch_seed_state(
        state, Q, torch.from_numpy(entry[:, None].astype(np.int32)).to(dev),
        tier2, "l2")
    steps = 0
    for _ in range(8):
        before = ops.launch_counts()["hop_step"]
        got = S.batch_hop_step(Q, nbrs, state, tier2, "l2", ef)
        assert ops.launch_counts()["hop_step"] - before == 1
        want = S.batch_hop_step_plain(Q, nbrs, state, tier2, "l2", ef)
        for g, w in zip(cs.hop_step_args(S, *got), cs.hop_step_args(S, *want)):
            assert g.dtype == w.dtype and torch.equal(g, w)
        state = want[0]
        ids = state.beam.ids
        assert not bool(tomb_t[ids.clamp(min=0).long()][ids >= 0].any())
        assert torch.equal(state.visited[:, :n] | ~tomb_t, torch.ones_like(
            state.visited[:, :n]))  # every tombstone still marked
        steps += int(want[1].any())
    assert steps > 0  # the steps did work


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("ef", list(cs.HOP_MUTATED_EFS))
@pytest.mark.parametrize("precision", ["float32", "int8", "float16"])
@pytest.mark.parametrize("kind", list(cs.MUTATED_TIER2))
def test_hop_step_kernel_over_mutated_tier2(hop_data, kind, precision, ef,
                                            metric, B):
    """B.8 over the tier 2s mutations leave (``chip_smoke.mutated_tier2``:
    a delete's holes in ``slot_of`` and ``id_of``, an add's grown id
    space, tombstones pre-set in ``visited``) at ef 64 and a filter's 208:
    one launch, every output tensor equal to the per-op step's."""
    X, Qn, nbrs_np, _ = hop_data[HOP_D]
    dev = torch.device("cuda")
    rng = np.random.default_rng(ef + B)
    tier2, tomb = cs.mutated_tier2(HOP_PORT, X, precision, kind, rng,
                                   HOP_N // 3, dev)
    state = cs.tombstone_state(S, cs.hop_state(
        S, rng, X, Qn[:B], nbrs_np[32], ef, ef + 33, ef, 100_000, metric,
        dev), tomb)
    Q = torch.from_numpy(Qn[:B]).to(dev)
    nbrs = torch.from_numpy(nbrs_np[32]).to(dev)
    before = ops.launch_counts()["hop_step"]
    got = S.batch_hop_step(Q, nbrs, state, tier2, metric, ef)
    assert ops.launch_counts()["hop_step"] - before == 1
    want = S.batch_hop_step_plain(Q, nbrs, state, tier2, metric, ef)
    for g, w in zip(cs.hop_step_args(S, *got), cs.hop_step_args(S, *want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if kind == "tombstoned":  # no tombstoned id entered a beam or L
        held = [t.cpu().numpy().ravel() for t in (
            state.beam.ids, state.miss_ids, got[0].beam.ids,
            got[0].miss_ids)]
        fresh = np.setdiff1d(np.concatenate(held[2:]),
                             np.concatenate(held[:2]))
        assert not tomb[fresh[fresh >= 0]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("driver", ["loop", "batched", "fused"])
def test_mutated_engine_on_card_matches_cpu(cuda, driver, filtered):
    """One engine on the card and one on the CPU put through the same
    delete (the entry point among the ids), add and upsert, then served
    the same request, unfiltered or under a filter of selectivity 0.1
    (ef 32 boosted to 104): equal ids and access counts, distances to
    float32 rounding, no deleted or denied id, and, on the card, step
    graphs captured anew after the add."""
    from repro_torch.core.metadata import Filter

    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, 64)).astype(np.float32)
    X2 = rng.standard_normal((60, 64)).astype(np.float32)
    Q = np.concatenate([X[rng.choice(600, 4)], X2[:4]]) + 0.1 * \
        rng.standard_normal((8, 64)).astype(np.float32)
    meta = {"cat": np.arange(600) % 10}
    g = build_hnsw(X, M=8, ef_construction=40, seed=0)
    filt = Filter.eq("cat", 3) if filtered else None
    gone = np.concatenate([rng.choice(600, 30, replace=False),
                           [g.entry_point], [7, 8]])
    res, captures = {}, {}
    for dev in ("cuda", "cpu"):
        eng = E.WebANNSEngine.build(X, M=8, ef_construction=40, seed=0,
                                    metadata=meta, config=E.EngineConfig(
                                        cache_capacity=150, device=dev,
                                        fused=driver == "fused"))
        req = E.SearchRequest(query=Q, k=10, ef=32, filter=filt,
                              batch_mode="loop" if driver == "loop"
                              else "batched")
        eng.search(req)
        before = step_graph.stats["captures"]
        eng.delete(gone[:-2])
        eng.add(X2, metadata={"cat": np.arange(60) % 10})
        eng.upsert([7, 8], X[7:9] + 0.1)
        res[dev] = eng.search(req)
        captures[dev] = step_graph.stats["captures"] - before
    on, off = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(on.ids, off.ids)
    np.testing.assert_allclose(on.dists, off.dists, rtol=1e-5)
    assert [s.n_db for s in on.stats] == [s.n_db for s in off.stats]
    assert [s.items_fetched for s in on.stats] == \
        [s.items_fetched for s in off.stats]
    assert not np.isin(on.ids, gone).any()
    if filtered:  # 66 rows allowed: a row may come back padded
        cat = np.concatenate([meta["cat"], np.arange(60) % 10, [7, 8]])
        assert (cat[on.ids[on.ids >= 0]] == 3).all()
    else:
        assert (on.ids >= 0).all()
    assert captures["cuda"] > 0 and captures["cpu"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["single", "loop", "batched", "fused"])
def test_reopened_engine_on_card_equals_in_memory(cuda, tmp_path, driver):
    """A float32 engine saved and reopened on the card (tier 3 served from
    the mmap'd shards) against the in-memory card engine it was saved
    from, each from a cold tier 2: ids and distances bit for bit, access
    counts equal."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((600, 64)).astype(np.float32)
    Q = X[rng.choice(600, 6)] + 0.1 * rng.standard_normal((6, 64)).astype(
        np.float32)
    g = build_hnsw(X, M=8, ef_construction=40, seed=0)
    cfg = E.EngineConfig(cache_capacity=150, fused=driver == "fused")
    E.WebANNSEngine(X, g, cfg).save(str(tmp_path / "idx"),
                                    shard_bytes=1 << 15)
    mem = E.WebANNSEngine(X, g, cfg)
    disk = E.WebANNSEngine.open(str(tmp_path / "idx"), cfg)
    assert disk.device.type == "cuda"
    if driver == "single":
        req = E.SearchRequest(query=Q[0], k=10, ef=32)
    else:
        req = E.SearchRequest(query=Q, k=10, ef=32,
                              batch_mode="batched" if driver == "batched"
                              else "loop")
    a, b = mem.search(req), disk.search(req)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    assert mem.access_stats.n_db == disk.access_stats.n_db > 0
    assert mem.access_stats.items_fetched == disk.access_stats.items_fetched
    assert disk.external.base_backend.shard_reads > 0


# ------------------------------------------------- cache sizing on the card

SIZING_T_IN = 1e-4  # count-only latency model: seconds an item visited


def _sizing_ladder(eng, Q, t_theta, max_iters):
    """Algorithm 2 on ``eng`` with a ``t_query`` computed from the
    probes' counts (no clock): the ladder as plain values and each
    step's per-probe ids and ``n_db``."""
    from repro_torch.core import cache_opt as CO

    seen = []
    t_db = eng.external.access_cost(16)

    def query_test(c):
        eng.resize_cache(c, warm=True)
        res = [eng.search(E.SearchRequest(query=q, k=10, ef=LOOP_EF))
               for q in Q]
        seen.append((c, [r.ids.tolist() for r in res],
                     [r.stats.n_db for r in res]))
        n_db = float(np.mean([r.stats.n_db for r in res]))
        n_q = float(np.mean([r.stats.n_visited for r in res]))
        return CO.QueryTestStats(n_db=n_db, n_q=n_q,
                                 t_query=n_q * SIZING_T_IN + n_db * t_db,
                                 t_db=t_db)

    res = CO.optimize_memory_size(query_test, c0=eng.n, p=0.8,
                                  t_theta=t_theta, max_iters=max_iters)
    steps = [(s.c, s.theta, s.accepted, s.stats.n_db, s.stats.n_q)
             for s in res.steps]
    return (res.c_best, steps), seen


@pytest.mark.cuda
@pytest.mark.parametrize("mode,t_theta,max_iters", [
    ("webanns", 0.1, 3), ("webanns-base", 0.02, 32)])
def test_algorithm2_count_model_same_ladder_on_card_as_on_cpu(
        cuda, mode, t_theta, max_iters):
    """Algorithm 2 driving a card engine and a CPU engine on one graph,
    its ``t_query`` from counts alone: the same ladder (C, θ, accepted,
    n_db, n_q), the same c_best and the same ids at every step."""
    X, Q, g, _ = _loop_inputs("float32")
    out = {}
    for dev in ("cuda", "cpu"):
        eng = E.WebANNSEngine(X, g, E.EngineConfig(
            mode=mode, cache_capacity=LOOP_N, device=dev))
        out[dev] = _sizing_ladder(eng, Q[:4], t_theta, max_iters)
    assert out["cuda"] == out["cpu"]
    (c_best, steps), _ = out["cuda"]
    assert c_best < LOOP_N and len(steps) >= 2
    assert steps[0][3] == 0  # a warm full tier 2 needs no access


@pytest.mark.cuda
def test_resize_ladder_captures_anew_and_replays_as_the_eager_loop(
        cuda, monkeypatch):
    """Down a ladder of resizes: the first search after each
    ``resize_cache`` captures anew, the next ones replay and capture
    nothing, and every search equals an engine whose phases run the
    eager loop (ids and distances bit for bit, the same ``n_db``). The
    live captures stay bounded: a resized slab's captures are dropped."""
    X, Q, g, _ = _loop_inputs("float32")
    cfg = E.EngineConfig(cache_capacity=LOOP_N, device="cuda")
    ladder = (600, 450, 300, 150, 150, 75)
    got, alive = [], []
    eng = E.WebANNSEngine(X, g, cfg)
    for c in ladder:
        eng.resize_cache(c, warm=True)
        step_graph.reset_stats()
        first = eng.search(E.SearchRequest(query=Q[0], k=10, ef=LOOP_EF))
        assert step_graph.stats["captures"] > 0, c
        step_graph.reset_stats()
        rest = [eng.search(E.SearchRequest(query=q, k=10, ef=LOOP_EF))
                for q in Q[1:4]]
        assert step_graph.stats["captures"] == 0, c
        assert step_graph.stats["replays"] > 0, c
        got.append([first] + rest)
        alive.append(step_graph.n_captures())
    assert max(alive) <= alive[0], alive
    monkeypatch.setattr(S, "batch_search_phase", S.batch_search_phase_eager)
    eng = E.WebANNSEngine(X, g, cfg)
    step_graph.reset_stats()
    for c, results in zip(ladder, got):
        eng.resize_cache(c, warm=True)
        for q, r in zip(Q[:4], results):
            want = eng.search(E.SearchRequest(query=q, k=10, ef=LOOP_EF))
            np.testing.assert_array_equal(r.ids, want.ids)
            np.testing.assert_array_equal(r.dists, want.dists)
            assert r.stats.n_db == want.stats.n_db
    assert step_graph.stats["captures"] == step_graph.stats["replays"] == 0
