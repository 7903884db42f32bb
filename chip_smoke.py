#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It imports the port (``src/repro_torch``) only, never JAX or
the JAX package, and goes through five phases; any failure raises and
the script exits non-zero:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every kernel source under ``src/repro_torch/csrc`` with
   ``nvcc``, one process per source, all at once (timed), and the
   registers and spills ptxas reports for the distance-matrix and ADC
   kernels (``PTXAS_SOURCES``);
3. kernels against their plain PyTorch versions, on the card, at the
   shapes of the query path (the dequant kernel at int8 and float16), and
   the flat scan's: the merge exactly at tie-heavy rows on both sides of
   its variant switch (M = 255, 256, 257), at rows shaped as the beam
   merge sends them, at the rows a filter's wider beam sends ((32 and 1,
   288 and 545) to k = 256, (32, 449) to 208: ``filter_merge_shapes``),
   at a filtered finalize's (a (B, 256) beam, half denied, to k = 10),
   and at the wide variant's joins (``merge_checks``: runs of 256 ending
   at M = 512, 513, 769, 1,000 and ``MAX_CANDIDATES``; every id twice,
   its copies in other runs; whole runs of sentinels; -0.0 against
   +0.0; k = 1, k = M, k > M and fewer survivors than k); the distance
   matrix at l2/ip/cos within DM_TOL of the metric's scale, the top-k
   exactly (k = 1, 10 and the cap, ragged N, ties across tiles and
   across merge levels, all-inf rows, rows with fewer than k finite,
   retrieval's (1, 1,000,000)); and the embedding bag exactly (sum and
   mean, with and without weights, float32/float16/bfloat16 tables, d
   in {1, 3, 64, 768}, S in {1, 32}, B in {1, 512}, ids at and above V,
   all-padding bags, int64 ids); and
   the hop-step kernel B.8 on mid-search states over a 10,000 x 768
   table, at float32, int8 and float16, l2/ip/cos, B in {1, 32}, layer
   0's shape (ef 64, degree 32, a cached tier 2) and an upper layer's
   (ef 1, degree 16, the whole table), with and without a gate: equal
   to the per-op step on the card (``torch.equal``, all nine tensors)
   and to the plain version on the CPU (the beams within the gather
   kernels' tolerance, up to near ties; the rest exactly); and to the
   per-op step on states with exact ties (``tie_corpus``), beams out of
   order (``shuffle_beams``) and repeated ids (``duplicate_beams``);
   and, equal to the per-op step with one launch, over the tier 2s
   mutations leave (``mutated_tier2``: a delete's holes in ``slot_of``
   and ``id_of``, an add's grown id space, tombstones pre-set in
   ``visited``) at ef 64 and 208;
4. the query paths, on one N = 10,000, d = 768 corpus and one HNSW graph
   at the paper's widths (M = 16, ef_construction = 200), each on fresh
   engines on the card with a cold 25% tier 2 and its launch counts set
   to 0 just before it and read just after:
   - float32: one single query, a batch of 32 in ``batched`` mode and
     the same batch in ``loop`` mode; checked for loop = batched bits,
     fewer tier-3 accesses when batched, recall@10 against brute force,
     kernel launches, and agreement with an engine on the CPU;
   - int8 and float16 tier 2 with the exact rerank: the same three
     requests; checked for recall@10, ids against the CPU engine driver
     by driver and loop against batched (≥ 99% of positions), a tier 2
     bit-equal to the CPU engine's after the batched search, one rerank
     access a query or a batch, and the dequant kernel's launches;
   - the fused driver at float32, float16 and int8, serving the 32
     queries one at a time; checked as above, and float32 fused against
     the float32 loop's bits;
   - product quantization (``precision="pq"``, 192 subspaces, rerank
     α = 4) over one codebook trained on the card by the port's
     ``train_pq`` and adopted by every engine: single, ``batched``,
     ``loop`` and fused; checked for recall@10 against the JAX package's
     at this configuration (``REF_PQ_RECALL``), ids against the CPU
     engine (the fused driver's on its first ``PQ_CPU_FUSED_QUERIES``
     queries), a tier 2 of 480,000 bytes bit-equal to the CPU engine's,
     one rerank access, a fused payload of uint8 codes only, and the ADC
     kernel's launches;
   then every path's layer search replayed from CUDA graphs held to its
   eager loop (phase 4d): the single driver's and the batched driver's
   phases (``search.batch_search_phase`` against
   ``batch_search_phase_eager``) and the fused driver's layer
   (``search_layer_lazy_fused`` against its ``_eager`` form) at float32,
   int8, float16 and pq, from one partly warm tier 2, with
   ``torch.equal`` on every state tensor after every phase, tier 2, the
   fused counters and every kernel's launches equal;
   then cache sizing and the baseline (phase 4e), on the same corpus
   and graph, 8 probe queries, with the launch counts set to 0 just
   before it and read just after: (a) Algorithm 2
   (``cache_opt.optimize_memory_size``, p = 0.8, T_θ = 0.1 s) on a
   float32 card engine from C0 = N, its ``query_test(C)`` resizing and
   warming tier 2, serving one untimed search (the new slab's step loops
   are captured there) and then the timed probes; checked for n_db <= θ
   at every accepted step, c_best < C0, at least 2 steps, no capture in
   any timed probe set, live captures bounded over the ladder, and the
   probes' ids and ``n_db`` at c_best equal to a CPU engine's; p50/p99
   of 32 single queries at C0 and at c_best; (b) the byte-budgeted form
   (``optimize_memory_bytes``) at int8 and pq, C0 from the budget; (c)
   ``RollbackManager`` over (a)'s ladder: one ``n_db`` past θ steps back
   a rung, the next search captures anew and equals the CPU engine's at
   that size; (d) ``allocate_memory_bytes`` over a float32 and an int8
   tenant in the contended regime, every allocation within [floor,
   optimum] and the total within the usable budget; (e) MeMemo (the
   port's ``MememoEngine``, host numpy, prefetch 64) against the card
   engine in ``webanns`` and ``webanns-base`` mode at a 25% tier 2:
   accesses, items fetched, redundancy, recall@10 and p50/p99 of 8
   queries after a warm one, MeMemo's redundancy above 0.5 and
   WebANNS's 0, WebANNS's accesses below MeMemo's;
   then persistence (phase 4f), on the same corpus, graph and queries,
   with the launch counts set to 0 just before it and read just after:
   each precision's phase-4 engine saves its index (``save``) into a
   directory under ``build/`` that the phase deletes, checked for the
   payload's bytes from the shapes (4d a row at float32, 2d at float16,
   d + 4 at int8, 192 at pq beside a 786,432-byte codebook); engines
   opened on it with the default device (``WebANNSEngine.open``) serve
   the single, ``loop``, ``batched`` and fused requests from a cold tier
   2, tier 3 read from the mmap'd shard files (``shard_reads``); at
   float32 they equal the in-memory card engines bit for bit, ``n_db``
   and ``items_fetched`` too, and a reopened engine's batched p50 is
   timed beside an in-memory one's (10 batches of 32 each, host clock);
   at int8, float16 and pq they are held to CPU engines opened on the
   same directory (ids in ``MIN_AGREEMENT`` of the positions, ``n_db``
   equal; the batch in ``batched`` mode, the first
   ``PERSIST_CPU_QUERIES`` queries in the loop and fused drivers), with
   recall@10 beside the in-memory session's; then a seeded 5% of the
   float32 artifact's rows and its entry point are tombstoned on disk
   (``storage.save_tombstones``) and the artifact reopened: the entry
   point moves to a live node and no driver returns a tombstoned id, on
   the card and on the CPU, the two held to each other as above;
   then metadata filters and mutation (phase 4g), on the same corpus,
   graph and queries, with the launch counts set to 0 just before it and
   read just after: (a) a seeded ``cat`` (10 values) and ``year`` (50)
   column and three filters of selectivity 0.5, 0.1 and 0.02 (ef 64
   boosted to 96, 208, 256) through the single, ``loop``, ``batched``
   and fused drivers at float32 and int8 on fresh engines, each beside
   an unfiltered search at the boosted ef: no denied id, its ``n_db``
   (and at float32 ``items_fetched``) exactly, float32 recall@10 >= 0.95
   against the filtered brute force at 0.5 and 0.1, and at 0.1 the
   batched ids on 8 queries against a CPU engine's; (b) at float32,
   int8 and pq, 5% of the rows and the entry point deleted, 500 rows
   added and 100 upserted (host clock each) on an engine whose step
   graphs were captured, then phase 4's queries and 32 noisy copies of
   added rows served in the four drivers: the ids the mutations give
   and take, no deleted or upserted-away id, float32 finding each
   copy's row in its top 10 (>= 0.9), 8 queries against a CPU engine on
   the same index and tier 2, step graphs captured anew and replayed;
   then the distributed substrate at world size 1 over NCCL: the flat
   scan (``distributed_brute_force``, k = 10, l2) over the paper's own
   480,000 x 768 corpus, checked for recall@10 >= 0.999 against brute
   force with every miss a near tie, against the plain scan on the card,
   and for one distance-matrix and two top-k launches a search; and its
   hnsw mode over the first 2,000 rows against the same program over
   gloo on the CPU (every differing id a near tie);
   then the recsys serving slice: ``embedding_bag_padded`` (kernel B.7)
   over a 1,000,000 x 64 table (DLRM-RM2's) at B = 512 and 262,144
   against its plain version; DLRM-RM2, DIN, AutoInt and BST at their
   published configs (DLRM-RM2's 26 tables: 6.66 GB on the card) serving
   ``click_batches`` at B = 512 (DLRM-RM2 at 262,144 too), logits
   within rtol 1e-4, atol 1e-5 of the CPU forward on the same parameters,
   with p50/p99 of the serve step; ``retrieval_score`` over 1,000,000 x
   64 candidates (ip, k = 100) against the CPU plain scan (every
   differing id a near tie, scores within DM_TOL of the scale), one
   distance-matrix and one top-k launch, and both kernels held to their
   plain versions at this shape (the top-k exactly, its tree merging
   977 tiles' survivors in two levels);
5. times: each kernel, its plain version and its bound (CUDA events;
   B.8 beside the per-op step at float32, int8 and float16, B in {1,
   32}, layer 0 and an upper layer, and the device kernels of one
   replayed hop step through each, from torch.profiler; B.8's stage
   split from its timing instantiation's clock stamps beside the launch
   floor, an empty kernel on its grid, at float32;
   the merge also at the beam merge's rows and a filter's, the top-k also at
   retrieval's shape, each beside ``torch.topk``; the distance matrix at
   the flat scan's and retrieval's shapes beside ``torch.matmul``),
   the end-to-end latency of batched, single-query and fused searches at
   each precision, each beside one more search's host launches (kernel
   and graph launches, from the profiler), device busy and idle share,
   and host syncs (``count_syncs``); the sweep of K, the hop steps
   between two host checks (``search.STEPS_PER_SYNC``), over 1, 2, 4, 8
   and 16 at float32 in the three drivers; the flat scan's latency, with
   the device's idle share.

Standard output ends with four lines: every number of the run as one
``record:`` JSON object (also written to ``build/chip_smoke.json``),
the card's name and power limit, one JSON object listing the kernels,
and one ``{"ok": true, "device": ...}`` object. Without CUDA, or without
the repository around it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, and the
# float32 rate outside the tensor cores (the kernels do scalar f32 math)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# gather-distance vs its plain version: both sum 768 float32 products,
# in a different order (32 lanes + a shuffle tree against torch's
# reduction), so they agree to float32 rounding, not bit for bit; the
# dequant kernel's dequantized elements equal the plain version's, and
# its sums differ in the same way
GD_RTOL, GD_ATOL = 1e-5, 1e-4

QUANT = ("int8", "float16")
PRECISIONS = ("float32",) + QUANT
# a quantized path's ids against another run of it (the CPU engine, or
# the other driver): a cold lazy search depends on the tier-2 state it
# meets, so a near-tie rounded differently can change a later phase
MIN_AGREEMENT = 0.99


# product quantization: 192 subspaces of 4 dims (192 code bytes a row
# against int8's 772); coarser splits lose recall at d = 768 (PERF.md §2)
PQ_SUBSPACES = 192
PQ_ALPHA = 4.0
# recall@10 of the JAX package's pq drivers at this configuration, on
# these 32 queries, with its own codebook (seed 0), measured on the CPU by
# tools/pq_reference_recall.py, which imports Shape, the seeds and the
# pq settings from this file; the port's pq drivers must come within
# PQ_RECALL_TOL of them. The single-query driver is the loop's.
REF_PQ_RECALL = {"batched": 0.90625, "loop": 0.96875, "fused": 0.84375}
PQ_RECALL_TOL = 0.02
# the CPU engine that pq's fused driver on the card is held to serves the
# first 8 of the 32 queries: a fused engine serves them one at a time,
# so each is the card's query after the same ones, and the CPU's fused pq
# search takes about 4 s a query, two minutes for the whole batch
PQ_CPU_FUSED_QUERIES = 8

# the corpus, the HNSW build, the queries and the pq codebook
CORPUS_SEED, GRAPH_SEED, QUERY_SEED, PQ_SEED = 13, 0, 5, 0

# a filter of live selectivity s widens ef = 64 to ef·min(4, √(1/s)),
# snapped up to 8 (engine._boost_ef): 96 at s = 0.5, 208 at 0.1, 256 at
# s <= 1/16. The hop step's merge row is ef + degree (128, 240, 288: B.8
# takes the first two, the per-op step the last), a load phase's is
# 2·ef + degree + 1 (225, 449, 545): B.2's wide variant past 256 (runs
# of 256 sorted a warp each, merged by rank)
FILTER_EFS = (96, 208, 256)


@dataclasses.dataclass(frozen=True)
class Shape:
    """The served configuration: the paper's widths (src/repro/configs/
    webanns.py) at a corpus cut from 480k to N rows."""

    n: int = 10_000
    dim: int = 768
    M: int = 16
    ef_construction: int = 200
    ef: int = 64
    k: int = 10
    batch: int = 32
    cache: int = 2_500  # a cold 25% tier 2, so load phases happen

    @property
    def degree(self) -> int:  # layer-0 neighbor row width
        return 2 * self.M

    @property
    def miss_cap(self) -> int:  # load-phase width (engine: ef + deg + 1)
        return self.ef + self.degree + 1


def stamp(record: dict, phase: str) -> None:
    """The seconds since the run began at which ``phase`` starts."""
    record["started_s"][phase] = time.perf_counter() - record["t0"]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def load_port():
    """Import the port from the checkout this script sits in."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.engine as engine
    from repro_torch import convert
    from repro_torch.core import pq, quant
    from repro_torch.core import search, step_graph, store
    from repro_torch.core.eval import brute_force_topk, recall_at_k
    from repro_torch.core.hnsw import build_hnsw
    from repro_torch.core import index, metadata, storage
    from repro_torch.core.storage import InMemoryBackend
    from repro_torch.data.synthetic import corpus_embeddings
    from repro_torch.core import distributed
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import hop_step as hop_step_mod
    from repro_torch.kernels import topk as topk_mod
    from repro_torch.kernels.topk import TOPK_MAX_K
    from repro_torch.launch import mesh
    from repro_torch import configs
    from repro_torch.data.synthetic import click_batches
    from repro_torch.models import embeddings, recsys
    from repro_torch.core import cache_opt, mememo

    return dict(
        engine=engine, brute_force_topk=brute_force_topk,
        recall_at_k=recall_at_k, build_hnsw=build_hnsw,
        corpus_embeddings=corpus_embeddings, build=_build, ops=ops, ref=ref,
        topk=topk_mod, hop_step=hop_step_mod,
        kernel_names=kernel_names(_build.sources()),
        convert=convert, quant=quant, pq=pq, InMemoryBackend=InMemoryBackend,
        distributed=distributed, mesh=mesh, topk_max_k=TOPK_MAX_K,
        configs=configs, click_batches=click_batches, embeddings=embeddings,
        recsys=recsys, search=search, step_graph=step_graph, store=store,
        cache_opt=cache_opt, mememo=mememo, storage=storage, index=index,
        metadata=metadata,
    )


def kernel_names(sources) -> frozenset:
    """The names of the ``__global__`` functions in the CUDA sources."""
    decl = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return frozenset(name for src in sources
                     for name in decl.findall(src.read_text()))


# the sources whose kernels the latest slice redesigned: the run prints
# their registers and spills from the build's own ptxas report
PTXAS_SOURCES = ("hop_step", "distance_matrix", "adc_gather_distance")


def ptxas_report(logs: dict) -> dict:
    """``{source: [{kernel, registers, spill_stores, spill_loads}, ...]}``
    for PTXAS_SOURCES from ``nvcc -Xptxas -v`` output, one entry per
    instantiation, named by its template arguments; a source whose
    library was already built has no report."""
    out = {}
    for src in PTXAS_SOURCES:
        if src not in logs:
            out[src] = "built before this run: no report"
            continue
        entries = []
        for block in logs[src].split("Compiling entry function")[1:]:
            fn = re.search(r"([a-z_]+_kernel)I(\w*?)EEv", block)
            if fn is None:  # a kernel with no template: not a variant
                continue
            args = re.findall(r"L[ib](\d+)E", fn[2])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            entries.append(dict(
                kernel=f"{fn[1]}<{','.join(args)}>",
                registers=int(regs[1]) if regs else None,
                spill_stores=int(spill[1]) if spill else 0,
                spill_loads=int(spill[2]) if spill else 0))
        out[src] = entries
    return out


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def call_ms(fn, iters: int = 200) -> float:
    """CUDA-event time per call of ``fn`` over ``iters`` back-to-back
    calls from Python: where the host issues calls slower than the card
    runs them, this is the host's time per call."""
    for _ in range(20):
        fn()
    return _events_ms(fn, iters)


def device_ms(fns, replays: int = 5) -> float:
    """Device time per call: the calls in ``fns`` captured in order in
    one CUDA graph and replayed, so no host time sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    return _events_ms(graph.replay, replays) / len(fns)


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3


def gd_inputs(rng, table_rows: int, shape: Shape, width: int, dev):
    ids = rng.integers(0, table_rows, (shape.batch, width)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1  # padded / absent slots
    Q = rng.standard_normal((shape.batch, shape.dim)).astype(np.float32)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(Q).to(dev))


def merge_inputs(rng, B: int, M: int, dev):
    """Candidate rows with ties, duplicate ids and every kind of
    sentinel (id -1, NaN, +inf, -inf)."""
    d = np.round(rng.random((B, M)), 2).astype(np.float32)  # many ties
    ids = rng.integers(0, max(2, M // 2), (B, M)).astype(np.int32)  # dups
    ids[rng.random((B, M)) < 0.15] = -1
    d[rng.random((B, M)) < 0.05] = np.nan
    d[rng.random((B, M)) < 0.05] = np.inf
    d[rng.random((B, M)) < 0.03] = -np.inf
    return torch.from_numpy(d).to(dev), torch.from_numpy(ids).to(dev)


def path_merge_inputs(rng, B: int, M: int, ef: int, dev):
    """Rows as the beam merge sends them (``core/search.py::beam_merge``):
    an ef-wide beam of ascending distances, then M - ef new entries, every
    id distinct within its row and every entry valid."""
    beam = np.sort(rng.random((B, ef)), axis=1)
    d = np.concatenate([beam, rng.random((B, M - ef))], 1).astype(np.float32)
    ids = np.stack([rng.choice(1_000_000, M, replace=False)
                    for _ in range(B)]).astype(np.int32)
    return torch.from_numpy(d).to(dev), torch.from_numpy(ids).to(dev)


def twice_inputs(rng, B: int, M: int, dev):
    """Every id twice (the last once at odd M), the copies M // 2 apart,
    so in other runs of the wide variant; distances rounded to 0.01, so
    a copy ties its twin or another id at times."""
    h = M // 2
    ids = np.stack([rng.choice(1_000_000, M - h, replace=False)
                    for _ in range(B)]).astype(np.int32)
    ids = np.concatenate([ids, ids[:, :h]], 1)
    d = np.round(rng.random((B, M)), 2).astype(np.float32)
    return torch.from_numpy(d).to(dev), torch.from_numpy(ids).to(dev)


def sentinel_run_inputs(rng, B: int, M: int, dev):
    """Distinct ids, positions [256, 512) all sentinels (id -1, NaN,
    +inf and -inf in turn: a whole run of the wide variant), and
    distances -0.0 and +0.0 among the rest, which tie."""
    d, ids = path_merge_inputs(rng, B, M, 0, dev)
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    pos = np.arange(M)
    dead = (pos >= 256) & (pos < 512)
    ids[:, dead & (pos % 4 == 0)] = -1
    d[:, dead & (pos % 4 == 1)] = np.nan
    d[:, dead & (pos % 4 == 2)] = np.inf
    d[:, dead & (pos % 4 == 3)] = -np.inf
    zero = rng.random((B, M)) < 0.2
    d[zero] = rng.choice(np.array([-0.0, 0.0], np.float32), int(zero.sum()))
    return torch.from_numpy(d).to(dev), torch.from_numpy(ids).to(dev)


def crowded_inputs(rng, B: int, M: int, dev):
    """Distinct ids but for the 40 best entries, which share two, so the
    first survivors lie far apart in rank."""
    d, ids = path_merge_inputs(rng, B, M, 0, dev)
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    best = np.argsort(d, 1, kind="stable")[:, :40]
    np.put_along_axis(ids, best, rng.integers(0, 2, (B, 40)), 1)
    return torch.from_numpy(d).to(dev), torch.from_numpy(ids).to(dev)


MERGE_INPUTS = {"ties": merge_inputs, "twice": twice_inputs,
                "sentinel_runs": sentinel_run_inputs,
                "crowded": crowded_inputs}


def finalize_inputs(rng, B: int, ef: int, dev):
    """A layer-0 beam as ``search.finalize_topk`` hands it to the merge
    under a filter: ef ascending distances, distinct ids, about half of
    the entries denied and so (+inf, -1)."""
    d, i = path_merge_inputs(rng, B, ef, ef, dev)
    denied = torch.from_numpy(rng.random((B, ef)) < 0.5).to(dev)
    return torch.where(denied, np.inf, d), torch.where(denied, -1, i)


def filter_merge_shapes(shape: Shape) -> list:
    """(B, M, k) of the merges a filter's wider beam sends B.2 past 256
    entries: the per-op hop step at ef 256 (M = ef + degree) and the load
    phases at ef 208 and 256 (M = 2·ef + degree + 1), batched and single
    (DESIGN.md §9; ``FILTER_EFS``)."""
    out = []
    for B in (shape.batch, 1):
        out += [(B, 256 + shape.degree, 256),
                (B, 2 * 256 + shape.degree + 1, 256)]
    return out + [(shape.batch, 2 * 208 + shape.degree + 1, 208)]


def merge_checks(shape: Shape, max_m: int) -> list:
    """(kind, B, M, k) rows phase 3 holds the merge to its plain version
    on: the beam merge's rows a hop and a load phase (tie-heavy and
    path-like, the beam k wide), at B = 1 for the loop and single
    drivers, the finalize's k = 1, and the widths on both sides of the
    warp-sort variant's limit of 256; a filter's wider beams
    (``filter_merge_shapes``) and a filtered finalize (a (B, 256) beam,
    half denied, to k); and the wide variant's joins (runs of 256, merged
    by rank): rows ending one past a run, on a run's end and at the
    widest row ``max_m`` (``MAX_CANDIDATES``), every id twice at a
    filter's (B, 545) to 256 and past it, whole runs of sentinels with
    -0.0 and +0.0 ties, k = 1, k = M, k > M and fewer survivors than
    k, and rows whose 40 best entries share two ids."""
    hop, load = shape.ef + shape.degree, shape.ef + shape.miss_cap
    B, wide = shape.batch, 2 * 256 + shape.degree + 1
    joins = [("ties", 4, 512, shape.ef), ("ties", 4, 513, shape.ef),
             ("ties", 4, 769, 256), ("ties", 3, 1_000, 50),
             ("path", 4, 1_000, 256), ("ties", 2, max_m, 16),
             ("twice", 2, max_m, 256), ("twice", B, wide, 256),
             ("twice", 4, 769, 300), ("sentinel_runs", B, wide, 256),
             ("sentinel_runs", 4, 769, 600), ("ties", 8, wide, 1),
             ("ties", 3, wide, wide), ("ties", 3, 600, 700),
             ("crowded", 4, 769, 16), ("crowded", 2, max_m, 5)]
    return ([("ties", shape.batch, hop, shape.ef),
             ("ties", shape.batch, load, shape.ef),
             ("ties", shape.batch, shape.degree + 1, 1),
             ("path", shape.batch, hop, shape.ef),
             ("path", shape.batch, load, shape.ef),
             ("path", 1, hop, shape.ef),
             ("ties", 4, 255, shape.ef), ("ties", 4, 256, shape.ef),
             ("ties", 4, 257, shape.ef)]
            + [("path", B, M, k) for B, M, k in filter_merge_shapes(shape)]
            + [("ties", shape.batch, M, k)
               for B, M, k in filter_merge_shapes(shape) if B > 1]
            + [("finalize", B, 256, shape.k) for B in (shape.batch, 1)]
            + joins)


def check_kernels(port, shape: Shape, dev, rng) -> dict:
    """Each kernel against its plain version on the card."""
    ops, ref = port["ops"], port["ref"]
    table = torch.from_numpy(rng.standard_normal(
        (shape.cache, shape.dim)).astype(np.float32)).to(dev)
    err = {"gather_distance": 0.0, "gather_distance_batch": 0.0,
           "merge_topk": 0.0}
    for width in (shape.degree, shape.miss_cap):  # per hop, per load phase
        ids, Q = gd_inputs(rng, shape.cache, shape, width, dev)
        for metric in ("l2", "ip", "cos"):
            got = ops.gather_distance_batch(table, ids, Q, metric)
            want = ref.gather_distance_batch_ref(table, ids, Q, metric)
            one = ops.gather_distance(table, ids[0], Q[0], metric)
            one_ref = ref.gather_distance_ref(table, ids[0], Q[0], metric)
            torch.cuda.synchronize()
            pad = ids < 0
            check(bool(torch.isinf(got[pad]).all()), "padded ids give +inf")
            check(torch.allclose(got, want, rtol=GD_RTOL, atol=GD_ATOL),
                  f"gather_distance_batch {metric} width {width}")
            check(torch.allclose(one, one_ref, rtol=GD_RTOL, atol=GD_ATOL),
                  f"gather_distance {metric} width {width}")
            check(torch.equal(one, got[0]), "single form = batched form")
            fin = ~pad
            err["gather_distance_batch"] = max(
                err["gather_distance_batch"],
                float((got[fin] - want[fin]).abs().max()))
            err["gather_distance"] = max(
                err["gather_distance"],
                float((one[fin[0]] - one_ref[fin[0]]).abs().max()))
    err.update(check_dequant_kernels(port, shape, dev, rng))
    err.update(check_adc_kernels(port, shape, dev, rng))
    for kind, B, M, k in merge_checks(shape, port["topk"].MAX_CANDIDATES):
        if kind in MERGE_INPUTS:
            d, i = MERGE_INPUTS[kind](rng, B, M, dev)
        elif kind == "path":
            d, i = path_merge_inputs(rng, B, M, k, dev)
        else:
            d, i = finalize_inputs(rng, B, M, dev)
        got = ops.merge_topk(d, i, k)
        want = ref.merge_topk_ref(d, i, k)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("dists", "ids", "src")):
            check(torch.equal(g, w),
                  f"merge_topk {what} at {kind} ({B}, {M}) k={k}")
    return err


def quantized_table(port, rng, rows: int, dim: int, precision: str, dev):
    """A random (rows, dim) table quantized by the port's codec: the
    payload and its scales (None for float16) on the card."""
    X = rng.standard_normal((rows, dim)).astype(np.float32)
    payload, scales = port["quant"].quantize_np(X, precision)
    return (torch.from_numpy(payload).to(dev),
            torch.from_numpy(scales).to(dev) if precision == "int8" else None)


def check_dequant_kernels(port, shape: Shape, dev, rng) -> dict:
    """The dequant kernel against its plain version, int8 and float16 ×
    l2/ip/cos, at a hop's shape (32 queries × 32 ids over the tier-2
    slab) and a fused bulk load's (1 × miss_cap over the whole payload),
    in both forms."""
    ops, ref = port["ops"], port["ref"]
    err = {"dequant_gather_distance": 0.0,
           "dequant_gather_distance_batch": 0.0}
    for precision in QUANT:
        for rows, B, K in ((shape.cache, shape.batch, shape.degree),
                           (shape.n, 1, shape.miss_cap)):
            table, scales = quantized_table(port, rng, rows, shape.dim,
                                            precision, dev)
            ids, Q = gd_inputs(rng, rows, shape, K, dev)
            ids, Q = ids[:B].contiguous(), Q[:B].contiguous()
            for metric in ("l2", "ip", "cos"):
                what = f"{precision} {metric} ({B}, {K}) over {rows} rows"
                got = ops.dequant_gather_distance_batch(table, scales, ids,
                                                        Q, metric)
                want = ref.dequant_gather_distance_batch_ref(
                    table, scales, ids, Q, metric)
                one = ops.dequant_gather_distance(table, scales, ids[0],
                                                  Q[0], metric)
                one_ref = ref.dequant_gather_distance_ref(
                    table, scales, ids[0], Q[0], metric)
                torch.cuda.synchronize()
                pad = ids < 0
                check(bool(torch.isinf(got[pad]).all()),
                      f"padded ids give +inf: {what}")
                check(torch.allclose(got, want, rtol=GD_RTOL, atol=GD_ATOL),
                      f"dequant_gather_distance_batch {what}")
                check(torch.allclose(one, one_ref, rtol=GD_RTOL,
                                     atol=GD_ATOL),
                      f"dequant_gather_distance {what}")
                check(torch.equal(one, got[0]),
                      f"single form = batched form: {what}")
                fin = ~pad
                err["dequant_gather_distance_batch"] = max(
                    err["dequant_gather_distance_batch"],
                    float((got[fin] - want[fin]).abs().max()))
                err["dequant_gather_distance"] = max(
                    err["dequant_gather_distance"],
                    float((one[fin[0]] - one_ref[fin[0]]).abs().max()))
    return err


def adc_inputs(port, rng, rows: int, M: int, B: int, K: int, shape: Shape,
               metric: str, dev):
    """Random codes over ``rows`` rows, a random (M, 256, d / M) codebook,
    B queries' lookup tables built on the card by the path's builder, and
    -1-padded ids: the ADC kernel's inputs at a path's shape."""
    cent = torch.from_numpy(rng.standard_normal(
        (M, 256, shape.dim // M)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(
        0, 256, (rows, M)).astype(np.uint8)).to(dev)
    ids, Q = gd_inputs(rng, rows, shape, K, dev)
    ids, Q = ids[:B].contiguous(), Q[:B].contiguous()
    return codes, port["pq"].build_lut(Q, cent, metric), ids


def check_adc_kernels(port, shape: Shape, dev, rng) -> dict:
    """The ADC kernel against its plain version on the card, l2/ip/cos at
    M = 32, 192 and 384 (past its 256-subspace chunk), at a
    hop's shape (32 queries × 32 ids over the tier-2 slab) and a fused
    bulk load's (1 × miss_cap over the payload), in both forms, under
    torch.equal; and the kernel's output, copied to the host, against
    the numpy oracle ``pq.adc_distance_batch_np`` under array_equal."""
    ops, ref, pq = port["ops"], port["ref"], port["pq"]
    err = {"adc_gather_distance": 0.0, "adc_gather_distance_batch": 0.0}
    for M in (32, PQ_SUBSPACES, 2 * PQ_SUBSPACES):
        for rows, B, K in ((shape.cache, shape.batch, shape.degree),
                           (shape.n, 1, shape.miss_cap)):
            for metric in ("l2", "ip", "cos"):
                what = f"M={M} {metric} ({B}, {K}) over {rows} rows"
                codes, luts, ids = adc_inputs(port, rng, rows, M, B, K,
                                              shape, metric, dev)
                got = ops.adc_gather_distance_batch(codes, luts, ids, metric)
                want = ref.adc_gather_distance_batch_ref(codes, luts, ids,
                                                         metric)
                one = ops.adc_gather_distance(codes, luts[0], ids[0], metric)
                one_ref = ref.adc_gather_distance_ref(codes, luts[0], ids[0],
                                                      metric)
                torch.cuda.synchronize()
                check(bool(torch.isinf(got[ids < 0]).all()),
                      f"padded ids give +inf: {what}")
                check(torch.equal(got, want),
                      f"adc_gather_distance_batch = plain: {what}")
                check(torch.equal(one, one_ref),
                      f"adc_gather_distance = plain: {what}")
                check(torch.equal(one, got[0]),
                      f"single form = batched form: {what}")
                oracle = pq.adc_distance_batch_np(
                    codes.cpu().numpy(), luts.cpu().numpy(),
                    ids.cpu().numpy(), metric)
                check(np.array_equal(got.cpu().numpy(), oracle),
                      f"adc_gather_distance_batch = numpy oracle: {what}")
                fin = ids >= 0
                err["adc_gather_distance_batch"] = max(
                    err["adc_gather_distance_batch"],
                    float((got[fin] - want[fin]).abs().max()))
                err["adc_gather_distance"] = max(
                    err["adc_gather_distance"],
                    float((one[fin[0]] - one_ref[fin[0]]).abs().max()))
    return err


# distance-matrix kernel vs its plain version (a float32 matmul, TF32
# off): both sum d products in another order, so they agree to a small
# multiple of float32 rounding of the terms' scale: |q|^2 + |x|^2 for l2,
# |q|.|x| for ip, 1 for cos. The error is held in units of that scale.
DM_TOL = 1e-5
DM_SHAPES = ((1, 1, 1), (3, 1_000, 5), (32, 4_097, 768), (129, 20_000, 768))


def scaled_error(got, want, Q, X, metric: str) -> float:
    """Largest |got - want| in units of the metric's scale (DM_TOL)."""
    qn = (Q.double() ** 2).sum(1)[:, None]
    xn = (X.double() ** 2).sum(1)[None, :]
    scale = {"l2": qn + xn, "ip": (qn * xn).sqrt(),
             "cos": torch.ones_like(qn * xn)}[metric]
    err = (got.double() - want.double()).abs() / scale.clamp_min(1e-30)
    return float(err.max())


def topk_cases(rng, cap: int, dev) -> dict:
    """(D, k) inputs of the top-k kernel: k = 1, 10, 63 and 64 (the merge
    levels' two keys a lane) and the cap, N = 1, N no multiple of the
    1024-column tile (a last tile shorter than k), equal
    values across tiles and across the groups of 32 tiles its first merge
    level takes, all-inf rows, rows with fewer than k finite entries, and
    retrieval's (1, 1,000,000) at k = 100 (two merge levels)."""
    ties = np.round(rng.random((8, 5_000)), 1).astype(np.float32)
    infs = rng.random((8, 3_000)).astype(np.float32)
    infs[rng.random(infs.shape) < 0.5] = np.inf
    infs[0] = np.inf  # all-inf row
    infs[1, 4:] = np.inf  # fewer than k finite entries, in two tiles
    infs[1, 2_500] = 0.25
    wide = rng.standard_normal((32, 20_000)).astype(np.float32)
    cases = {
        "N=1,k=1": (rng.random((4, 1)).astype(np.float32), 1),
        "ragged,k=10": (rng.standard_normal((7, 1_500)).astype(np.float32),
                        10),
        "ties,k=1": (ties, 1), "ties,k=10": (ties, 10),
        f"ties,k={cap}": (ties, cap),
        "inf rows,k=10": (infs, 10), f"inf rows,k={cap}": (infs, cap),
        "wide,k=10": (wide, 10), f"wide,k={cap}": (wide, cap),
        "reduce (32, 10),k=10": (np.round(rng.random((32, 10)), 1).astype(
            np.float32), 10),
        "ties,k=63": (ties, 63), "ties,k=64": (ties, 64),
        "short last tile,k=64": (rng.random((3, 1_064)).astype(np.float32),
                                 64),
        f"tree ties (2, 200000),k={cap}": (np.round(rng.random(
            (2, 200_000)), 2).astype(np.float32), cap),
        "retrieval (1, 1000000),k=100": (rng.standard_normal(
            (1, 1_000_000)).astype(np.float32), 100),
    }
    return {name: (torch.from_numpy(D).to(dev), k)
            for name, (D, k) in cases.items()}


def check_flat_kernels(port, dev, rng) -> dict:
    """The flat scan's kernels against their plain versions on the card:
    the distance matrix at l2, ip and cos over DM_SHAPES within DM_TOL of
    the metric's scale; the top-k kernel exactly (values and ids) over
    ``topk_cases``, its ids distinct and in range; the cap refused one
    past it."""
    ops, ref = port["ops"], port["ref"]
    err = {"distance_matrix": 0.0, "topk": 0.0,
           "distance_matrix_scaled": 0.0}
    for B, N, d in DM_SHAPES:
        Q = torch.from_numpy(rng.standard_normal((B, d)).astype(
            np.float32)).to(dev)
        X = torch.from_numpy(rng.standard_normal((N, d)).astype(
            np.float32)).to(dev)
        for metric in ("l2", "ip", "cos"):
            got = ops.distance_matrix(Q, X, metric)
            want = ref.distance_matrix_ref(Q, X, metric)
            torch.cuda.synchronize()
            what = f"distance_matrix {metric} at ({B}, {N}, {d})"
            check(got.shape == (B, N) and bool(torch.isfinite(got).all()),
                  f"{what}: shape and finite values")
            s = scaled_error(got, want, Q, X, metric)
            check(s <= DM_TOL, f"{what}: error {s} of the scale > {DM_TOL}")
            err["distance_matrix_scaled"] = max(
                err["distance_matrix_scaled"], s)
            err["distance_matrix"] = max(err["distance_matrix"],
                                         float((got - want).abs().max()))
    cap = port["topk_max_k"]
    cases = topk_cases(rng, cap, dev)
    for name, (D, k) in cases.items():
        got = ops.topk(D, k)
        want = ref.topk_ref(D, k)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"topk = plain: {name}")
        ids = got[1].cpu().numpy()
        check(all(len(set(r.tolist())) == k for r in ids)
              and int(ids.max()) < D.shape[1], f"topk ids distinct: {name}")
    try:
        ops.topk(cases["wide,k=10"][0], cap + 1)
    except ValueError:
        pass
    else:
        raise RuntimeError(f"check failed: topk took k = {cap + 1} > cap")
    return err


EB_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def check_embedding_bag_kernel(port, dev, rng) -> dict:
    """B.7 against its plain version on the card under torch.equal: sum
    and mean, with and without weights, float32/float16/bfloat16 tables,
    d in {1, 3, 64, 768} (scalar and 4-wide loads), S in {1, 32}, B in
    {1, 512}; every case holds ids at and above V, and at B = 512 a bag
    of nothing but padding (which must come out 0). Then int64 ids,
    some past 2^31."""
    ops, ref = port["ops"], port["ref"]
    V = 1_000
    n = 0
    for dtype in EB_DTYPES:
        for d in (1, 3, 64, 768):
            table = torch.from_numpy(rng.standard_normal((V, d)).astype(
                np.float32)).to(dtype).to(dev)
            for S in (1, 32):
                for B in (1, 512):
                    idx = rng.integers(-1, V + 3, (B, S)).astype(np.int32)
                    idx[0, 0] = V
                    if B > 1:
                        idx[1] = -1
                    idx = torch.from_numpy(idx).to(dev)
                    w = torch.from_numpy(rng.uniform(-1.0, 2.0, (B, S))
                                         .astype(np.float32)).to(dev)
                    for combiner in ("sum", "mean"):
                        for weights in (None, w):
                            got = ops.embedding_bag(table, idx, weights,
                                                    combiner)
                            want = ref.embedding_bag_ref(table, idx,
                                                         weights, combiner)
                            torch.cuda.synchronize()
                            what = (f"embedding_bag {dtype} d={d} S={S} "
                                    f"B={B} {combiner} weighted="
                                    f"{weights is not None}")
                            check(torch.equal(got, want), f"{what} = plain")
                            check(B == 1 or not bool(got[1].any()),
                                  f"{what}: an all-padding bag is 0")
                            n += 1
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(
        np.float32)).to(dev)
    idx = torch.tensor([[2**40, 3, -2**40], [49, 50, -1]],
                       dtype=torch.int64, device=dev)
    got = ops.embedding_bag(table, idx)
    check(torch.equal(got, ref.embedding_bag_ref(table, idx))
          and torch.equal(got[0], table[49] + table[3]),
          "embedding_bag: int64 ids past 2^31 read row V - 1")
    return {"embedding_bag": 0.0, "embedding_bag_cases": n + 1}


# ------------------------------------------ phase 3: the hop step (B.8)


def hop_neighbors(rng, n: int, deg: int) -> np.ndarray:
    """(n, deg) int32 neighbour rows as a graph layer holds them: distinct
    ids of other nodes, a random tail of each row PAD (-1), a tenth of
    the rows empty."""
    rows = np.full((n, deg), -1, np.int32)
    for i in range(n):
        k = deg if rng.random() < 0.5 else int(rng.integers(0, deg + 1))
        if rng.random() < 0.1:
            k = 0
        pick = rng.choice(n - 1, k, replace=False)
        rows[i, :k] = pick + (pick >= i)
    return rows


def _np_dist(X: np.ndarray, q: np.ndarray, metric: str) -> np.ndarray:
    if metric == "l2":
        return ((X - q) ** 2).sum(-1)
    ip = X @ q
    if metric == "ip":
        return -ip
    return -ip / ((np.linalg.norm(X, axis=-1) + 1e-30)
                  * (np.linalg.norm(q) + 1e-30))


def hop_state(S, rng, X: np.ndarray, Q: np.ndarray, nbrs: np.ndarray,
              ef: int, miss_cap: int, trigger: int, max_hops: int,
              metric: str, dev):
    """A state of ``len(Q)`` queries in the middle of a layer search, for
    one hop step: each beam a sorted run of ids of nodes with neighbours,
    at their distances to the query, padding after it, some explored;
    ``visited`` holding the beam, the misses and a tenth of the other
    nodes (the spare column False); a miss list, hop and distance counts.
    About a tenth of the queries are inactive: beam all explored, ``|L|``
    at the trigger, or (where ``max_hops`` is small) the hop cap reached."""
    n = nbrs.shape[0]
    B = Q.shape[0]
    live = np.flatnonzero((nbrs != -1).any(1))
    ids = np.full((B, ef), -1, np.int32)
    dists = np.full((B, ef), np.inf, np.float32)
    explored = np.zeros((B, ef), bool)
    visited = rng.random((B, n + 1)) < 0.1
    visited[:, n] = False
    miss_ids = np.full((B, miss_cap), -1, np.int32)
    miss_count = np.zeros(B, np.int64)
    n_hops = rng.integers(0, 40, B).astype(np.int64)
    for b in range(B):
        k = int(rng.integers(1, min(ef, len(live)) + 1))
        pick = rng.choice(live, k, replace=False)
        dist = _np_dist(X[pick], Q[b], metric).astype(np.float32)
        order = np.argsort(dist, kind="stable")
        ids[b, :k], dists[b, :k] = pick[order], dist[order]
        if rng.random() < 0.1:
            explored[b, :k] = True
        else:
            explored[b, :k] = rng.random(k) < 0.5
            explored[b, rng.integers(0, k)] = False
        visited[b, pick] = True
        m = int(rng.integers(0, min(trigger, miss_cap)))
        if rng.random() < 0.1:
            m = min(trigger, miss_cap)
        free = np.flatnonzero(~visited[b, :n])
        missed = rng.choice(free, min(m, len(free)), replace=False)
        miss_ids[b, :len(missed)] = missed
        miss_count[b] = len(missed)
        visited[b, missed] = True
        if max_hops < 1_000 and rng.random() < 0.1:
            n_hops[b] = max_hops
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return S.SearchState(
        beam=S.Beam(t(ids), t(dists), t(explored)), visited=t(visited),
        miss_ids=t(miss_ids), miss_count=t(miss_count), n_hops=t(n_hops),
        n_dist=t(rng.integers(0, 400, B).astype(np.int64)))


def hop_tier2(port, X: np.ndarray, precision: str, cached: bool, rng,
              capacity: int, dev):
    """Tier 2 for a hop step: a tier-2 cache of ``capacity`` rows of X at
    ``precision``, filled with random rows, or (not ``cached``) the
    whole table at that precision."""
    S = port["search"]
    if cached:
        st = port["store"]
        store = st.TieredStore(st.ExternalStore(X), capacity=capacity,
                               device=dev, precision=precision)
        store.warm(rng.choice(X.shape[0], capacity, replace=False))
        return S.cache_tier2(store.cache)
    if precision == "float32":
        return S.resident_tier2(torch.as_tensor(X, device=dev))
    payload, sc = port["quant"].quantize_np(X, precision)
    return S.Tier2(torch.as_tensor(payload, device=dev),
                   torch.as_tensor(sc, device=dev)
                   if precision == "int8" else None)


def tie_corpus(rng, n: int, dim: int, n_queries: int):
    """(X, Q) whose l2 and ip distances tie exactly: rows drawn from 12
    distinct integer-valued ones, queries of small integers, so every such
    distance is a small integer, exact in any order of summation, and a
    beam's entries and a step's new ones tie with each other and across
    the two (float32 and float16; int8 and cos tie among equal rows)."""
    base = rng.integers(-2, 3, (12, dim)).astype(np.float32)
    X = base[rng.integers(0, 12, n)]
    Q = (base[rng.integers(0, 12, n_queries)]
         + rng.integers(-1, 2, (n_queries, dim))).astype(np.float32)
    return X, Q


def shuffle_beams(S, state, rng):
    """``state`` with each beam's entries (id, dist, explored together) in
    a random order, sentinels among them: beams out of (dist, position)
    order, for which B.8 ranks the whole merge row."""
    B, ef = state.beam.ids.shape
    perm = torch.as_tensor(np.argsort(rng.random((B, ef)), axis=1),
                           device=state.beam.ids.device)
    beam = S.Beam(*(t.gather(1, perm) for t in (
        state.beam.ids, state.beam.dists, state.beam.explored)))
    return dataclasses.replace(state, beam=beam)


def duplicate_beams(S, state, rng):
    """``state`` with ids repeated: in each beam of two or more entries one
    entry takes an earlier entry's id, and the beam's ids are no longer
    visited, so a neighbour may repeat one too. The merge's dedup then has
    work (B.8's exact fallback, ``warp_merge.cuh``'s merge_row)."""
    ids = state.beam.ids.clone()
    visited = state.visited.clone()
    n = visited.shape[1] - 1
    for b in range(ids.shape[0]):
        live = (ids[b] >= 0).nonzero()[:, 0].tolist()
        if len(live) >= 2:
            i, j = sorted(rng.choice(len(live), 2, replace=False))
            ids[b, live[j]] = ids[b, live[i]]
        keep = ids[b][ids[b] >= 0].long()
        visited[b, keep.clamp(0, n - 1)] = False
    return dataclasses.replace(
        state, beam=dataclasses.replace(state.beam, ids=ids), visited=visited)


def tier2_to(port, tier2, dev):
    """A copy of ``tier2`` (and its cache) on ``dev``."""
    to = (lambda t: None if t is None else t.to(dev))  # noqa: E731
    cache = tier2.cache
    if cache is not None:
        cache = dataclasses.replace(
            cache, **{f.name: to(getattr(cache, f.name))
                      for f in dataclasses.fields(cache)})
    return port["search"].Tier2(to(tier2.table), to(tier2.scales),
                                to(tier2.luts), cache)


def hop_step_args(S, state, active):
    """A step's state and ``active`` as the list of its nine tensors."""
    return S._state_tensors(state) + [active]


def same_up_to_ties(got, want, rtol: float, atol: float) -> tuple:
    """Two steps' beams, one from the kernel and one from the plain
    version, whose distances differ by rounding: each row's (id,
    explored) entries equal as sets, their distances within the
    tolerance, and any entry in one row only a near tie of the row's
    last kept distance. Returns (ok, largest distance error)."""
    g_ids, g_d, g_e = (t.cpu().numpy() for t in got)
    w_ids, w_d, w_e = (t.cpu().numpy() for t in want)
    err = 0.0
    for b in range(g_ids.shape[0]):
        g = {i: (d, e) for i, d, e in zip(g_ids[b], g_d[b], g_e[b]) if i >= 0}
        w = {i: (d, e) for i, d, e in zip(w_ids[b], w_d[b], w_e[b]) if i >= 0}
        for i in g.keys() & w.keys():
            (dg, eg), (dw, ew) = g[i], w[i]
            err = max(err, abs(float(dg) - float(dw)))
            if eg != ew or abs(dg - dw) > atol + rtol * abs(dw):
                return False, err
        cut = max([d for d, _ in w.values()], default=0.0)
        for i in g.keys() ^ w.keys():
            d = (g.get(i) or w.get(i))[0]
            if abs(d - cut) > 2 * (atol + rtol * abs(cut)):
                return False, err
    return True, err


HOP_METRICS = ("l2", "ip", "cos")


def check_hop_step_kernel(port, shape: Shape, dev, rng) -> dict:
    """B.8 against the per-op step on the card (``torch.equal`` on all
    nine output tensors) and against the plain version on the CPU (the
    integer and bool tensors exactly, the beams up to near ties within
    the gather kernels' tolerance), at float32, int8 and float16 and l2,
    ip and cos, at B = 1 and 32, on layer 0's shape (ef 64, degree 32,
    a cached tier 2) and an upper layer's (ef 1, degree 16, the whole
    table), the fused driver's () gate and a (B,) gate."""
    S, ops = port["search"], port["ops"]
    cpu = torch.device("cpu")
    X = rng.standard_normal((shape.n, shape.dim)).astype(np.float32)
    Qall = make_queries(X, shape.batch, seed=11)
    shapes = {"layer0": (shape.ef, shape.degree, True),
              "upper": (1, shape.degree // 2, False)}
    nbrs = {name: hop_neighbors(rng, shape.n, deg)
            for name, (_, deg, _) in shapes.items()}
    err, n_cases, n_active = 0.0, 0, 0
    for precision in PRECISIONS:
        for name, (ef, deg, cached) in shapes.items():
            tier2 = hop_tier2(port, X, precision, cached, rng, shape.cache,
                              dev)
            tier2_cpu = tier2_to(port, tier2, cpu)
            N = torch.as_tensor(nbrs[name], device=dev)
            miss_cap = ef + deg + 1
            for metric in HOP_METRICS:
                for B in (1, shape.batch):
                    Q = Qall[:B]
                    st = hop_state(S, rng, X, Q, nbrs[name], ef, miss_cap,
                                   ef, 100_000, metric, dev)
                    Qt = torch.as_tensor(Q, device=dev)
                    gate = (torch.tensor(True, device=dev) if B == 1 else
                            torch.as_tensor(rng.random(B) < 0.8, device=dev))
                    for g in (None, gate):
                        what = f"hop_step {precision} {name} {metric} B={B}"
                        before = ops.launch_counts()["hop_step"]
                        s1, a1 = S.batch_hop_step(Qt, N, st, tier2, metric,
                                                  ef, gate=g)
                        s2, a2 = S.batch_hop_step_plain(Qt, N, st, tier2,
                                                        metric, ef, gate=g)
                        torch.cuda.synchronize()
                        check(ops.launch_counts()["hop_step"] == before + 1,
                              f"{what}: one launch of the kernel")
                        got, want = hop_step_args(S, s1, a1), hop_step_args(
                            S, s2, a2)
                        check(all(x.dtype == y.dtype and torch.equal(x, y)
                                  for x, y in zip(got, want)),
                              f"{what}: = the per-op step (torch.equal)")
                        n_active += int(a1.sum())
                        s3, a3 = S.batch_hop_step_plain(
                            Qt.cpu(), N.cpu(), S._state_of(
                                [t.cpu() for t in S._state_tensors(st)]),
                            tier2_cpu, metric, ef,
                            gate=None if g is None else g.cpu())
                        plain = hop_step_args(S, s3, a3)
                        check(all(torch.equal(x.cpu(), y) for x, y in
                                  zip(got[3:], plain[3:])),
                              f"{what}: visited, L, counters, active = plain")
                        ok, e = same_up_to_ties(got[:3], plain[:3], GD_RTOL,
                                                GD_ATOL)
                        check(ok, f"{what}: beam = plain up to near ties")
                        err = max(err, e)
                        n_cases += 1
    check(n_active >= n_cases,
          f"hop_step: {n_active} active queries over {n_cases} cases")
    n_cases += check_hop_step_orders(port, shape, dev, rng, nbrs, shapes,
                                     X, Qall)
    n_mutated = check_hop_step_mutated(port, shape, dev, rng)
    return {"hop_step": err, "hop_step_cases": n_cases + n_mutated,
            "hop_step_mutated_cases": n_mutated}


def check_hop_step_orders(port, shape: Shape, dev, rng, nbrs, shapes, X,
                          Qall) -> int:
    """B.8 against the per-op step (``torch.equal``, all nine tensors) on
    the states its merge by counted ranks must get right and the one it
    hands to merge_row: exact ties within the beam, among the new entries
    and across the two (``tie_corpus``), beams out of order
    (``shuffle_beams``) and repeated ids (``duplicate_beams``); every
    precision, metric and layer shape, B = 32. Returns the number of
    cases."""
    S = port["search"]
    Xt, Qt_np = tie_corpus(rng, shape.n, shape.dim, shape.batch)
    n_cases = 0
    for kind, (Xk, Qk) in (("ties", (Xt, Qt_np)), ("unsorted", (X, Qall)),
                           ("duplicates", (X, Qall))):
        Qt = torch.as_tensor(Qk, device=dev)
        for precision in PRECISIONS:
            for name, (ef, deg, cached) in shapes.items():
                tier2 = hop_tier2(port, Xk, precision, cached, rng,
                                  shape.cache, dev)
                N = torch.as_tensor(nbrs[name], device=dev)
                for metric in HOP_METRICS:
                    st = hop_state(S, rng, Xk, Qk, nbrs[name], ef,
                                   ef + deg + 1, ef, 100_000, metric, dev)
                    if kind == "unsorted":
                        st = shuffle_beams(S, st, rng)
                    elif kind == "duplicates":
                        st = duplicate_beams(S, st, rng)
                    got = hop_step_args(S, *S.batch_hop_step(
                        Qt, N, st, tier2, metric, ef))
                    want = hop_step_args(S, *S.batch_hop_step_plain(
                        Qt, N, st, tier2, metric, ef))
                    check(all(x.dtype == y.dtype and torch.equal(x, y)
                              for x, y in zip(got, want)),
                          f"hop_step {kind} {precision} {name} {metric}: = "
                          "the per-op step (torch.equal)")
                    n_cases += 1
    return n_cases


MUTATED_TIER2 = ("evicted", "grown", "tombstoned")
# layer 0's ef and a filter's boost of it to 208 (merge rows of 96 and
# 240, both B.8's)
HOP_MUTATED_EFS = (64, 208)


def mutated_tier2(port, X: np.ndarray, precision: str, kind: str, rng,
                  capacity: int, dev):
    """A cached tier 2 of ``capacity`` rows of X at ``precision`` as a
    mutation leaves it, and the tombstone mask its searches start from:

    - "evicted": a full tier 2, then a third of its ids and a few
      uncached ones deleted (``TieredStore.invalidate``): holes in
      ``slot_of`` and ``id_of``;
    - "grown": a tier 2 over the first 90% of X, then the rest appended
      (``ExternalStore.append``), the id space grown
      (``TieredStore.grow``) and some appended rows inserted, evicting
      older ones;
    - "tombstoned": as "evicted", the deleted ids also tombstoned."""
    st = port["store"]
    n = X.shape[0]
    n_base = n - n // 10 if kind == "grown" else n
    store = st.TieredStore(st.ExternalStore(X[:n_base]), capacity=capacity,
                           device=dev, precision=precision)
    store.warm(rng.choice(n_base, capacity, replace=False))
    tomb = np.zeros(n, bool)
    if kind == "grown":
        store.external.append(X[n_base:])
        store.grow(n)
        store.warm(rng.choice(np.arange(n_base, n), n // 40, replace=False))
    else:
        cached = store.cache.id_of.cpu().numpy()
        gone = np.union1d(rng.choice(cached[cached >= 0], capacity // 3,
                                     replace=False),
                          rng.choice(n, n // 50, replace=False))
        store.invalidate(gone)
        tomb[gone] = kind == "tombstoned"
    return port["search"].cache_tier2(store.cache), tomb


def tombstone_state(S, state, tomb: np.ndarray):
    """``state`` with the ``tomb`` ids pre-marked visited, as
    ``batch_make_state`` marks tombstones (none of them in a beam or a
    miss list: a tombstoned id never enters either)."""
    t = tomb.copy()
    for held in (state.beam.ids, state.miss_ids):
        h = held.cpu().numpy()
        t[h[h >= 0]] = False
    visited = state.visited.clone()
    visited[:, :t.shape[0]] |= torch.as_tensor(t, device=visited.device)
    return dataclasses.replace(state, visited=visited)


def check_hop_step_mutated(port, shape: Shape, dev, rng) -> int:
    """B.8 against the per-op step (``torch.equal``, all nine tensors, one
    launch) over the tier 2s mutations leave (``mutated_tier2``: evicted
    holes, a grown id space, tombstones pre-set in ``visited``), at
    float32, int8 and float16, l2/ip/cos, B = 1 and 32, layer 0's degree
    and ef 64 and 208 (``HOP_MUTATED_EFS``). Returns the number of
    cases."""
    S, ops = port["search"], port["ops"]
    X = rng.standard_normal((shape.n, shape.dim)).astype(np.float32)
    Qall = make_queries(X, shape.batch, seed=12)
    nbrs = hop_neighbors(rng, shape.n, shape.degree)
    N = torch.as_tensor(nbrs, device=dev)
    n_cases = 0
    for kind in MUTATED_TIER2:
        for precision in PRECISIONS:
            tier2, tomb = mutated_tier2(port, X, precision, kind, rng,
                                        shape.cache, dev)
            for ef in HOP_MUTATED_EFS:
                for metric in HOP_METRICS:
                    for B in (1, shape.batch):
                        st = tombstone_state(S, hop_state(
                            S, rng, X, Qall[:B], nbrs, ef,
                            ef + shape.degree + 1, ef, 100_000, metric, dev),
                            tomb)
                        Qt = torch.as_tensor(Qall[:B], device=dev)
                        what = (f"hop_step over a {kind} tier 2, {precision} "
                                f"{metric} ef={ef} B={B}")
                        before = ops.launch_counts()["hop_step"]
                        got = hop_step_args(S, *S.batch_hop_step(
                            Qt, N, st, tier2, metric, ef))
                        check(ops.launch_counts()["hop_step"] == before + 1,
                              f"{what}: one launch of the kernel")
                        want = hop_step_args(S, *S.batch_hop_step_plain(
                            Qt, N, st, tier2, metric, ef))
                        check(all(x.dtype == y.dtype and torch.equal(x, y)
                                  for x, y in zip(got, want)),
                              f"{what}: = the per-op step (torch.equal)")
                        n_cases += 1
    return n_cases


# ------------------------------------------------------------ phase 4


def make_queries(X: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Noisy copies of corpus rows (benchmarks/common.py ``queries_for``)."""
    rng = np.random.default_rng(seed)
    base = X[rng.choice(X.shape[0], n)]
    return base + 0.25 * rng.standard_normal(base.shape).astype(np.float32)


REQUESTS = ("single", "batched", "loop")
# what each request serves: the first query alone, or the batch in a mode
# (a fused engine serves a batched request one fused query at a time)
REQUEST_FORMS = {"single": (0, "batched"), "batched": (None, "batched"),
                 "loop": (None, "loop"), "fused": (None, "batched")}


def run_query_path(port, shape: Shape, device: str, X, graph, Q,
                   requests=REQUESTS, precision: str = "float32",
                   fused: bool = False, codebook=None) -> dict:
    """The requests named in ``requests`` (a single query, a batch in
    ``batched`` mode, the batch in ``loop`` mode, or the batch on a fused
    engine), each on a fresh engine on ``device`` at ``precision``, with
    the launch counts set to 0 just before and read just after; launch
    counts per request. A ``codebook`` makes the engines pq (rerank α =
    PQ_ALPHA) and each adopts it through its storage backend. The checks
    are the caller's."""
    E, ops = port["engine"], port["ops"]
    extra = {}
    if codebook is not None:
        precision = "pq"
        extra = dict(pq_subspaces=codebook.n_subspaces,
                     rerank_alpha=PQ_ALPHA)
    cfg = E.EngineConfig(cache_capacity=shape.cache, ef_search=shape.ef,
                         device=device, precision=precision, fused=fused,
                         **extra)

    def source():
        if codebook is None:
            return X
        backend = port["InMemoryBackend"](X)
        backend.codebook = codebook
        return backend

    out = {"engines": {}, "launches": {}}
    ops.reset_launch_counts()
    for name in requests:
        first, mode = REQUEST_FORMS[name]
        before = ops.launch_counts()
        eng = E.WebANNSEngine(source(), graph, cfg)
        t0 = time.perf_counter()
        res = eng.search(E.SearchRequest(
            query=Q if first is None else Q[first], k=shape.k,
            batch_mode=mode))
        out[name] = res
        out["engines"][name] = eng
        out[name + "_s"] = time.perf_counter() - t0
        after = ops.launch_counts()
        out["launches"][name] = {f: after[f] - before[f] for f in after}
    out["launches_total"] = ops.launch_counts()
    return out


def _agreement(a: np.ndarray, b: np.ndarray) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


def check_results(port, shape: Shape, X, Q, res, what: str) -> float:
    """Shape, finite distances, ids in range and recall@10 of a batch's
    result; returns the recall."""
    check(res.ids.shape == (shape.batch, shape.k), f"{what}: ids shape")
    check(bool(np.isfinite(res.dists).all()), f"{what}: finite distances")
    check(bool(((res.ids >= 0) & (res.ids < shape.n)).all()),
          f"{what}: ids in range")
    truth = port["brute_force_topk"](X, Q, shape.k)
    recall = port["recall_at_k"](res.ids, truth)
    check(recall >= 0.90, f"{what}: recall@10 {recall} >= 0.90")
    return recall


def check_query_path(port, shape: Shape, X, Q, run) -> dict:
    single, batched, loop = run["single"], run["batched"], run["loop"]
    recall = check_results(port, shape, X, Q, batched, "float32, batched")
    check(np.array_equal(batched.ids, loop.ids), "loop ids = batched ids")
    check(np.array_equal(batched.dists, loop.dists),
          "loop dists = batched dists")
    check(np.array_equal(single.ids, loop.ids[0])
          and np.array_equal(single.dists, loop.dists[0]),
          "single query = first query of the loop")
    n_db_b, n_db_l = batched.batch_stats.n_db, loop.batch_stats.n_db
    check(n_db_b < n_db_l, f"batched n_db {n_db_b} < loop n_db {n_db_l}")
    return {"recall_at_10": recall, "n_db_batched": n_db_b,
            "n_db_loop": n_db_l,
            "items_fetched_batched": batched.batch_stats.items_fetched,
            "items_fetched_loop": loop.batch_stats.items_fetched,
            "n_phases_batched": batched.batch_stats.n_phases}


def check_quantized_path(port, shape: Shape, X, Q, run, cpu,
                         precision: str) -> dict:
    """A quantized path on the card against the same path on the CPU."""
    single, batched, loop = run["single"], run["batched"], run["loop"]
    what = f"{precision} path"
    out = {"recall_at_10": check_results(port, shape, X, Q, batched,
                                         f"{what}, batched")}
    out["recall_at_10_loop"] = check_results(port, shape, X, Q, loop,
                                             f"{what}, loop")
    check(single.ids.shape == (shape.k,)
          and bool(np.isfinite(single.dists).all()), f"{what}: single")
    out["loop_vs_batched"] = _agreement(loop.ids, batched.ids)
    check(out["loop_vs_batched"] >= MIN_AGREEMENT,
          f"{what}: loop ids agree with batched: {out['loop_vs_batched']}")
    for name in REQUESTS:
        a = _agreement(run[name].ids, cpu[name].ids)
        out[f"cpu_agreement_{name}"] = a
        check(a >= MIN_AGREEMENT,
              f"{what}: {name} ids agree with the CPU engine: {a}")
    conv = port["convert"]
    on = conv.cache_to_numpy(run["engines"]["batched"].store.cache)
    off = conv.cache_to_numpy(cpu["engines"]["batched"].store.cache)
    for field in conv.CACHE_FIELDS:
        check(on[field].dtype == off[field].dtype
              and np.array_equal(on[field], off[field]),
              f"{what}: tier-2 {field} after the batched search equals the "
              "CPU engine's")
    check(on["slab"].dtype == np.dtype(precision), f"{what}: slab dtype")
    bs = batched.batch_stats
    check(bs.n_db == bs.n_phases + 1,
          f"{what}: one rerank access for the batch ({bs.n_db} accesses, "
          f"{bs.n_phases} load phases)")
    check(all(s.n_db >= 1 for s in batched.stats), f"{what}: per-query n_db")
    for name, form in (("batched", "dequant_gather_distance_batch"),
                       ("loop", "dequant_gather_distance"),
                       ("single", "dequant_gather_distance")):
        n = run["launches"][name][form]
        check(n > 0, f"{what}: {form} launched in the {name} run ({n})")
    out.update(n_db_batched=bs.n_db, n_db_loop=loop.batch_stats.n_db,
               n_phases_batched=bs.n_phases,
               items_fetched_batched=bs.items_fetched,
               cache_bytes=run["engines"]["batched"].cache_bytes())
    return out


def check_fused_path(port, shape: Shape, X, Q, run, cpu, precision: str,
                     loop32=None) -> dict:
    """The fused driver at ``precision`` on the card: recall, the CPU
    engine's ids, the kernels that served it; at float32 the host loop
    driver's bits."""
    res = run["fused"]
    what = f"fused {precision}"
    out = {"recall_at_10": check_results(port, shape, X, Q, res, what)}
    out["cpu_agreement"] = _agreement(res.ids, cpu["fused"].ids)
    check(out["cpu_agreement"] >= MIN_AGREEMENT,
          f"{what}: ids agree with the CPU engine: {out['cpu_agreement']}")
    n = run["launches"]["fused"]
    form = ("gather_distance" if precision == "float32"
            else "dequant_gather_distance")
    check(n[form] > 0 and n["merge_topk"] > 0,
          f"{what}: {form} and merge_topk launched ({n})")
    if loop32 is not None:
        check(np.array_equal(res.ids, loop32.ids)
              and np.array_equal(res.dists, loop32.dists),
              f"{what}: bits equal the float32 loop driver's")
        check([s.n_db for s in res.stats] == [s.n_db for s in loop32.stats],
              f"{what}: accesses equal the loop driver's")
    out.update(n_db=res.batch_stats.n_db,
               items_fetched=res.batch_stats.items_fetched)
    return out


def check_pq_path(port, shape: Shape, X, Q, run, cpu) -> dict:
    """The pq paths on the card (``run`` holds single, batched, loop and
    fused) against the JAX package's recall and the CPU engine (whose
    fused run served the first ``PQ_CPU_FUSED_QUERIES`` queries)."""
    what = "pq path"
    out = {}
    for name in ("batched", "loop", "fused"):
        res = run[name]
        check(res.ids.shape == (shape.batch, shape.k)
              and bool(np.isfinite(res.dists).all())
              and bool(((res.ids >= 0) & (res.ids < shape.n)).all()),
              f"{what}, {name}: shape, finite distances, ids in range")
        truth = port["brute_force_topk"](X, Q, shape.k)
        recall = port["recall_at_k"](res.ids, truth)
        out[f"recall_at_10_{name}"] = recall
        out[f"reference_recall_at_10_{name}"] = REF_PQ_RECALL[name]
        check(abs(recall - REF_PQ_RECALL[name]) <= PQ_RECALL_TOL,
              f"{what}, {name}: recall@10 {recall} within {PQ_RECALL_TOL} "
              f"of the JAX package's {REF_PQ_RECALL[name]}")
    single, loop, batched = run["single"], run["loop"], run["batched"]
    check(np.array_equal(single.ids, loop.ids[0])
          and np.array_equal(single.dists, loop.dists[0]),
          f"{what}: single query = first query of the loop")
    out["loop_vs_batched"] = _agreement(loop.ids, batched.ids)
    for name in REQUESTS + ("fused",):
        want = cpu[name].ids  # the fused run's first queries
        a = _agreement(run[name].ids[:len(want)], want)
        out[f"cpu_agreement_{name}"] = a
        check(a >= MIN_AGREEMENT,
              f"{what}: {name} ids agree with the CPU engine: {a}")
    conv = port["convert"]
    on = conv.cache_to_numpy(run["engines"]["batched"].store.cache)
    off = conv.cache_to_numpy(cpu["engines"]["batched"].store.cache)
    for field in conv.CACHE_FIELDS:
        check(on[field].dtype == off[field].dtype
              and np.array_equal(on[field], off[field]),
              f"{what}: tier-2 {field} after the batched search equals the "
              "CPU engine's")
    check(on["slab"].dtype == np.uint8
          and on["slab"].shape == (shape.cache, PQ_SUBSPACES),
          f"{what}: slab of uint8 codes")
    eng = run["engines"]["batched"]
    out["cache_bytes"] = eng.cache_bytes()
    check(out["cache_bytes"] == shape.cache * PQ_SUBSPACES,
          f"{what}: tier-2 bytes {out['cache_bytes']} = "
          f"{shape.cache} x {PQ_SUBSPACES}")
    bs = batched.batch_stats
    check(bs.n_db == bs.n_phases + 1,
          f"{what}: one rerank access for the batch ({bs.n_db} accesses, "
          f"{bs.n_phases} load phases)")
    fused_eng = run["engines"]["fused"]
    payload, scales = fused_eng._payload
    check(payload.dtype == torch.uint8 and payload.is_cuda
          and tuple(payload.shape) == (shape.n, PQ_SUBSPACES)
          and scales is None,
          f"{what}: the fused payload is ({shape.n}, {PQ_SUBSPACES}) uint8 "
          f"codes with no float32 or int8 table ({payload.dtype}, "
          f"{tuple(payload.shape)})")
    cb = fused_eng.store.cache.codebook
    check(cb.is_cuda and tuple(cb.shape) == (PQ_SUBSPACES, 256,
                                             shape.dim // PQ_SUBSPACES),
          f"{what}: the codebook sits on the card beside the payload")
    out["payload_bytes"] = payload.numel()
    out["codebook_bytes"] = cb.numel() * 4
    for name, form in (("batched", "adc_gather_distance_batch"),
                       ("loop", "adc_gather_distance"),
                       ("single", "adc_gather_distance"),
                       ("fused", "adc_gather_distance")):
        n = run["launches"][name][form]
        check(n > 0, f"{what}: {form} launched in the {name} run ({n})")
    out.update(n_db_batched=bs.n_db, n_db_loop=loop.batch_stats.n_db,
               n_db_fused=run["fused"].batch_stats.n_db,
               n_phases_batched=bs.n_phases,
               items_fetched_batched=bs.items_fetched)
    return out


def check_rerank_access(port, shape: Shape, X, graph, Q,
                        codebook=None) -> dict:
    """On a tier 2 holding the whole corpus no load phase happens, so the
    exact rerank is the only tier-3 access: one for a single query (host
    or fused driver) and one for a batch."""
    E = port["engine"]
    out = {}
    for precision in QUANT + ("pq",):
        for fused in (False, True):
            source, extra = X, {}
            if precision == "pq":
                source = port["InMemoryBackend"](X)
                source.codebook = codebook
                extra = dict(pq_subspaces=codebook.n_subspaces,
                             rerank_alpha=PQ_ALPHA)
            eng = E.WebANNSEngine(source, graph, E.EngineConfig(
                cache_capacity=shape.n, ef_search=shape.ef, device="cuda",
                precision=precision, fused=fused, **extra))
            eng.warm_cache()
            one = eng.search(E.SearchRequest(query=Q[0], k=shape.k))
            key = f"{precision}{'_fused' if fused else ''}"
            check(one.stats.n_db == 1 and eng.access_stats.n_db == 1,
                  f"{key}: a warm single query costs one rerank access")
            out[key + "_single"] = one.stats.n_db
            if fused:
                continue
            many = eng.search(E.SearchRequest(query=Q, k=shape.k))
            check(many.batch_stats.n_db == 1
                  and eng.access_stats.n_db == 2,
                  f"{key}: a warm batch costs one rerank access")
            out[key + "_batch"] = many.batch_stats.n_db
    return out


# ----------------------------------------------------------- phase 4d


def _loop_store(port, shape: Shape, X, precision: str, codebook, dev):
    """A FIFO tier 2 at the query path's size, a third of it warm."""
    st = port["store"]
    store = st.TieredStore(st.ExternalStore(X), capacity=shape.cache,
                           device=dev, precision=precision,
                           codebook=codebook)
    store.warm(np.arange(0, shape.n, 12)[: shape.cache // 3])
    return store


def _phase_trace(port, shape: Shape, X, graph, Q, precision, codebook,
                 phase, B: int, dev) -> dict:
    """One layer-0 search of the first B queries by the host drivers'
    steps (phases through ``phase``, a host fetch and a load phase
    between them): the state tensors after every phase, tier 2 and the
    launch counts."""
    S, ops, sg = port["search"], port["ops"], port["step_graph"]
    store = _loop_store(port, shape, X, precision, codebook, dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    Qt = torch.as_tensor(Q[:B], device=dev)
    luts = (port["pq"].build_lut(Qt, store.cache.codebook, "l2")
            if precision == "pq" else None)
    sg.reset_stats()
    ops.reset_launch_counts()
    states = S.batch_make_state(B, shape.ef, shape.miss_cap, shape.n, dev)
    states = S.batch_seed_state(
        states, Qt, torch.full((B, 1), graph.entry_point, dtype=torch.int32,
                               device=dev),
        S.cache_tier2(store.cache, luts), "l2")
    trace = []
    for _ in range(200):
        states = phase(Qt, nbrs[0], states, S.cache_tier2(store.cache, luts),
                       "l2", shape.ef)
        trace.append(S._state_tensors(states))
        if int(states.miss_count.sum()) == 0:
            break
        rows, pos = store.gather_batch(states.miss_ids.cpu().numpy())
        states = S.batch_load_phase(Qt, states, states.miss_ids, rows, pos,
                                    "l2")
    torch.cuda.synchronize()
    return dict(trace=trace, tier2=port["convert"].cache_to_numpy(store.cache),
                launches=ops.launch_counts(), stats=dict(sg.stats))


def _fused_trace(port, shape: Shape, X, graph, Q, precision, codebook,
                 layer_fn, dev, n_queries: int = 2) -> dict:
    """Layer 0 of the fused driver for the first queries, one tier 2
    between them: state, device counters and tier 2 after each, and the
    launch counts."""
    S, ops, sg = port["search"], port["ops"], port["step_graph"]
    quant, pq = port["quant"], port["pq"]
    store = _loop_store(port, shape, X, precision, codebook, dev)
    if precision == "pq":
        payload = torch.as_tensor(pq.encode_np(X, codebook.centroids),
                                  device=dev)
        scales = None
    else:
        payload, sc = quant.quantize_np(X, precision)
        scales = (torch.as_tensor(sc, device=dev)
                  if payload.dtype == np.int8 else None)
        payload = torch.as_tensor(payload, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    entry = torch.tensor([graph.entry_point], dtype=torch.int32, device=dev)
    sg.reset_stats()
    ops.reset_launch_counts()
    cache, out = store.cache, []
    for q in torch.as_tensor(Q[:n_queries], device=dev):
        luts = (pq.build_lut(q, cache.codebook, "l2")[None]
                if precision == "pq" else None)
        st, cache, n_db, n_fetch = layer_fn(
            q, nbrs[0], payload, scales, cache, entry, shape.ef, "l2",
            eviction=store.eviction, luts=luts)
        out.append((S._state_tensors(st), int(n_db), int(n_fetch),
                    port["convert"].cache_to_numpy(cache)))
    torch.cuda.synchronize()
    return dict(trace=[o[0] for o in out], counts=[o[1:3] for o in out],
                tier2=out[-1][3], launches=ops.launch_counts(),
                stats=dict(sg.stats))


def _same_states(a, b) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(u.dtype == v.dtype and torch.equal(u, v)
                                 for u, v in zip(x, y))
        for x, y in zip(a, b))


def check_graph_replay(port, shape: Shape, X, graph, Q, codebook) -> dict:
    """Every path's layer search replayed from CUDA graphs against its
    eager loop on the card, on the same inputs: the single driver's (B =
    1) and the batched driver's (B = 32) phases through
    ``search.batch_search_phase`` and ``batch_search_phase_eager``, the
    fused driver's layer through ``search.search_layer_lazy_fused`` and
    ``search_layer_lazy_fused_eager``, at float32, int8, float16 and pq:
    ``torch.equal`` on every state tensor after every phase (or query),
    tier 2 and the fused counters equal, the same launches of every
    kernel, and graph replays on the graph side only."""
    S = port["search"]
    dev = torch.device("cuda")
    out = {}
    for precision in PRECISIONS + ("pq",):
        cb = codebook if precision == "pq" else None
        rec = {}
        for driver, B in (("single", 1), ("batched", shape.batch),
                          ("fused", 1)):
            what = f"graph replay, {precision} {driver}"
            if driver == "fused":
                runs = {name: _fused_trace(port, shape, X, graph, Q,
                                           precision, cb, fn, dev)
                        for name, fn in (
                            ("graph", S.search_layer_lazy_fused),
                            ("eager", S.search_layer_lazy_fused_eager))}
                check(runs["graph"]["counts"] == runs["eager"]["counts"],
                      f"{what}: device counters equal the eager loop's")
            else:
                runs = {name: _phase_trace(port, shape, X, graph, Q,
                                           precision, cb, fn, B, dev)
                        for name, fn in (
                            ("graph", S.batch_search_phase),
                            ("eager", S.batch_search_phase_eager))}
            g, e = runs["graph"], runs["eager"]
            check(_same_states(g["trace"], e["trace"]),
                  f"{what}: every state tensor equals the eager loop's")
            check(all(np.array_equal(g["tier2"][f], e["tier2"][f])
                      for f in e["tier2"]),
                  f"{what}: tier 2 equals the eager loop's")
            check(g["launches"] == e["launches"],
                  f"{what}: launches equal the eager loop's "
                  f"({g['launches']} against {e['launches']})")
            check(g["stats"]["replays"] > 0 and e["stats"]["replays"] == 0
                  and g["stats"]["syncs"] == e["stats"]["syncs"],
                  f"{what}: replays on the graph side only, the same host "
                  f"checks ({g['stats']} against {e['stats']})")
            rec[driver] = dict(
                phases_or_queries=len(g["trace"]), **g["stats"],
                launches={k: n for k, n in g["launches"].items() if n})
        out[precision] = rec
    return out


# the K sweep: hop steps between two host checks of a loop
SWEEP_KS = (1, 2, 4, 8, 16)


def sweep_steps_per_sync(port, shape: Shape, X, engines: dict,
                         n_batches: int = 4, n_single: int = 12) -> dict:
    """Search latency at each K in SWEEP_KS on warm engines (``engines``
    maps a path to ``(kind, engine)``): per K and path one search to
    capture, then ``n_batches`` batches or ``n_single`` queries timed;
    the K values in order and then in reverse, so a drift of the host
    falls on every K alike. Also the loop's host checks and graph
    replays per search at each K. The module's own K is restored."""
    S, sg = port["search"], port["step_graph"]
    k0 = S.STEPS_PER_SYNC
    acc = {name: {K: {"lat": [], "checks": 0, "replays": 0}
                  for K in SWEEP_KS} for name in engines}
    try:
        for rnd, ks in enumerate((SWEEP_KS, SWEEP_KS[::-1])):
            for K in ks:
                S.STEPS_PER_SYNC = K
                for name, (kind, eng) in engines.items():
                    _timed_searches(port, shape, X, eng, kind, 1,
                                    seed=400 + K)
                    sg.reset_stats()
                    n = n_batches if kind == "batched" else n_single
                    lat, _ = _timed_searches(port, shape, X, eng, kind, n,
                                             seed=450 + 1000 * rnd + 10 * K)
                    a = acc[name][K]
                    a["lat"] += lat
                    a["checks"] += sg.stats["syncs"]
                    a["replays"] += sg.stats["replays"]
    finally:
        S.STEPS_PER_SYNC = k0
    out = {}
    for name, per_k in acc.items():
        out[name] = {}
        for K, a in per_k.items():
            n = len(a["lat"])
            out[name][str(K)] = dict(_latency(a["lat"]),
                                     loop_checks_per_search=a["checks"] / n,
                                     replays_per_search=a["replays"] / n)
    return out


# ----------------------------------------------------------- phase 4e

# Algorithm 2 (paper §3.4) at the paper's parameters, over probe queries
# drawn as phase 4 draws its queries; t_db is one 64-item tier-3 access,
# as benchmarks/bench_cacheopt.py sets it
SIZING_P, SIZING_T_THETA = 0.8, 0.1
SIZING_PROBES = 8
SIZING_LATENCY_QUERIES = 32
SIZING_SEED, SIZING_LATENCY_SEED = 17, 19
T_DB_ITEMS = 64
# the byte budgets of (b): int8 gets the bytes of 2,500 float32 rows, pq
# the bytes of the whole corpus's codes (N x M), so both capacities stay
# within N (the reference does not cap C0 at the corpus)
SIZING_INT8_ROWS_F32 = 2_500
# (d): the two tenants' budget is 0.9 x the bytes of the whole corpus at
# int8, so the allocator's probe runs start both tenants from a capacity
# the budget caps (float32's at ~20% of N, int8's at ~80%), and its runs
# are cut to 3 steps: each tenant's optimum then stays within a few
# secant steps of its capped C0, and the two optima together pass the
# usable budget (the contended regime) whatever the clock gives θ
TENANT_BUDGET_FRAC = 0.9
TENANT_MAX_ITERS = 3
# (e): MeMemo's prefetch a miss (tests/test_mememo_baseline.py)
MEMEMO_PREFETCH = 64


def sized_searches(port, shape: Shape, eng, capacity: int, warm_q,
                   queries) -> dict:
    """Resize ``eng``'s tier 2 to ``capacity`` and warm it, serve
    ``warm_q`` untimed (the first search on a new slab captures its step
    loops, so the captures fall here), then each of ``queries``: their
    results, their host latencies (s) and the step-loop captures they
    made (0 once the loops are captured)."""
    E, sg = port["engine"], port["step_graph"]
    eng.resize_cache(capacity, warm=True)
    eng.search(E.SearchRequest(query=warm_q, k=shape.k))
    c0 = sg.stats["captures"]
    res, lat = [], []
    for q in queries:
        t0 = time.perf_counter()
        res.append(eng.search(E.SearchRequest(query=q, k=shape.k)))
        lat.append(time.perf_counter() - t0)
    return dict(results=res, lat=lat, captures=sg.stats["captures"] - c0)


def sizing_query_test(port, shape: Shape, eng, warm_q, probes, log: list):
    """Algorithm 2's ``query_test(C)`` on ``eng`` (as
    benchmarks/bench_cacheopt.py's): the mean ``n_db``, ``n_q`` (items
    visited) and ``T_query`` of the probes at ``C``, and ``t_db`` of one
    64-item access. Each call appends its C, counts, timed captures,
    live captures and per-probe ids and ``n_db`` to ``log``."""
    co, sg = port["cache_opt"], port["step_graph"]

    def query_test(capacity: int):
        run = sized_searches(port, shape, eng, capacity, warm_q, probes)
        stats = [r.stats for r in run["results"]]
        out = co.QueryTestStats(
            n_db=float(np.mean([s.n_db for s in stats])),
            n_q=float(np.mean([s.n_visited for s in stats])),
            t_query=float(np.mean([s.t_query for s in stats])),
            t_db=eng.external.access_cost(T_DB_ITEMS))
        log.append(dict(
            c=int(capacity), n_db=out.n_db, n_q=out.n_q,
            t_query_ms=out.t_query * 1e3, captures_timed=run["captures"],
            captures_alive=sg.n_captures(),
            ids=[r.ids.tolist() for r in run["results"]],
            n_db_each=[s.n_db for s in stats]))
        return out

    return query_test


def ladder_record(res, log: list) -> dict:
    """A CacheOptResult and its query_test log as one record, with the
    checks every ladder must pass: n_db <= θ at every accepted step, no
    capture inside a timed probe set, the live captures bounded (none
    more after any step than after the first: each resize's captures are
    dropped once its slab is gone)."""
    check([s.c for s in res.steps] == [e["c"] for e in log],
          "one query_test a step, in the ladder's order")
    steps = []
    for s, entry in zip(res.steps, log):
        if s.accepted:
            check(s.stats.n_db <= s.theta,
                  f"accepted C={s.c}: n_db {s.stats.n_db} <= θ {s.theta}")
        check(entry["captures_timed"] == 0,
              f"C={s.c}: no capture inside the timed probes "
              f"({entry['captures_timed']})")
        steps.append(dict(c=s.c, theta=s.theta, accepted=s.accepted,
                          n_db=entry["n_db"], n_q=entry["n_q"],
                          t_query_ms=entry["t_query_ms"],
                          captures_timed=entry["captures_timed"],
                          captures_alive=entry["captures_alive"]))
    alive = [e["captures_alive"] for e in log]
    check(max(alive) <= alive[0],
          f"live captures bounded over the ladder: {alive}")
    return dict(c0=res.c0, c_best=res.c_best,
                saved_fraction=res.saved_fraction(),
                bytes_per_item=res.bytes_per_item,
                c_best_bytes=res.c_best_bytes, n_steps=len(res.steps),
                steps=steps)


def run_cache_sizing(port, shape: Shape, X, graph, codebook) -> dict:
    """Phase 4e: the paper's cache-size optimizer and its baseline against
    the port's engine on the card, at phase 4's corpus and graph.

    (a) Algorithm 2 at float32 from C0 = N; (b) its byte-budgeted form
    at int8 and pq; (c) ``RollbackManager`` over (a)'s ladder; (d) the
    cross-tenant allocator over a float32 and an int8 tenant, below the
    sum of their optima; (e) MeMemo (host numpy) against the card engine
    in ``webanns`` and ``webanns-base`` mode at a 25% cache. Any failed
    check raises. Returns the record."""
    E, co, quant = port["engine"], port["cache_opt"], port["quant"]
    sg = port["step_graph"]
    queries = make_queries(X, SIZING_PROBES + 1, seed=SIZING_SEED)
    warm_q, probes = queries[0], queries[1:]
    lat_q = make_queries(X, SIZING_LATENCY_QUERIES, seed=SIZING_LATENCY_SEED)

    def engine(device="cuda", precision="float32", **kw):
        source, extra = X, {}
        if precision == "pq":
            source = port["InMemoryBackend"](X)
            source.codebook = codebook
            extra = dict(pq_subspaces=codebook.n_subspaces,
                         rerank_alpha=PQ_ALPHA)
        return E.WebANNSEngine(source, graph, E.EngineConfig(
            cache_capacity=shape.cache, ef_search=shape.ef, device=device,
            precision=precision, **extra, **kw))

    out = {}
    # (a) Algorithm 2 at float32 from a full tier 2
    t0 = time.perf_counter()
    f32 = engine()
    log_a: list = []
    res_a = co.optimize_memory_size(
        sizing_query_test(port, shape, f32, warm_q, probes, log_a),
        c0=shape.n, p=SIZING_P, t_theta=SIZING_T_THETA)
    rec = ladder_record(res_a, log_a)
    check(res_a.c_best < shape.n,
          f"c_best {res_a.c_best} < C0 {shape.n}: a warm full tier 2 "
          "needs no access")
    check(len(res_a.steps) >= 2, f"at least 2 steps ({len(res_a.steps)})")
    at_best = [e for e in log_a if e["c"] == res_a.c_best][0]
    cpu = engine(device="cpu")
    cpu_run = sized_searches(port, shape, cpu, res_a.c_best, warm_q, probes)
    cpu_ids = [r.ids.tolist() for r in cpu_run["results"]]
    cpu_n_db = [r.stats.n_db for r in cpu_run["results"]]
    check(cpu_ids == at_best["ids"],
          "at c_best every probe's ids on the card equal the CPU engine's")
    check(cpu_n_db == at_best["n_db_each"],
          f"at c_best every probe's n_db on the card ({at_best['n_db_each']})"
          f" equals the CPU engine's ({cpu_n_db})")
    for name, cap in (("c0", shape.n), ("c_best", res_a.c_best)):
        run = sized_searches(port, shape, f32, cap, warm_q, lat_q)
        check(run["captures"] == 0, f"no capture in the timed {name} run")
        rec[f"latency_at_{name}"] = dict(
            _latency(run["lat"]),
            n_db_per_query=float(np.mean([r.stats.n_db
                                          for r in run["results"]])))
    rec["n_db_at_c_best_cpu"] = cpu_n_db
    rec["s"] = time.perf_counter() - t0
    out["float32"] = rec
    # (b) the byte-budgeted Algorithm 2 at int8 and pq
    budgets = {"int8": SIZING_INT8_ROWS_F32 * quant.bytes_per_vector(
        shape.dim, "float32"), "pq": shape.n * PQ_SUBSPACES}
    tenants = {"float32": (f32, res_a)}  # (d)'s: float32 and int8
    for precision, budget in budgets.items():
        t0 = time.perf_counter()
        m = PQ_SUBSPACES if precision == "pq" else None
        eng = engine(precision=precision)
        log: list = []
        res = co.optimize_memory_bytes(
            sizing_query_test(port, shape, eng, warm_q, probes, log),
            budget, shape.dim, precision=precision, p=SIZING_P,
            t_theta=SIZING_T_THETA, n_subspaces=m)
        rec = ladder_record(res, log)
        want = quant.capacity_for_budget(budget, shape.dim, precision,
                                         n_subspaces=m)
        check(res.c0 == want and res.c0 <= shape.n,
              f"{precision}: C0 {res.c0} = capacity_for_budget {want} "
              f"<= N {shape.n}")
        check(res.c_best_bytes == res.c_best * quant.bytes_per_vector(
            shape.dim, precision, n_subspaces=m),
            f"{precision}: c_best_bytes in bytes")
        rec.update(budget_bytes=budget, s=time.perf_counter() - t0)
        out[precision] = rec
        if precision == "int8":
            tenants[precision] = (eng, res)
    # (c) rollback over (a)'s ladder: one n_db past θ steps back a rung
    t0 = time.perf_counter()
    ladder = res_a.ladder
    check(len(ladder) >= 2, f"a ladder of at least 2 rungs ({ladder})")
    sized_searches(port, shape, f32, ladder[-1][0], warm_q, [])
    rm = co.RollbackManager(ladder, resize=f32.resize_cache)
    theta = rm.current[1]
    n_db = math.floor(theta) + 1
    check(rm.observe(n_db), f"n_db {n_db} above θ {theta} rolls back")
    back = ladder[-2][0]
    check(rm.current == ladder[-2] and f32.store.capacity == back,
          f"one rung back, to C = {back} ({f32.store.capacity})")
    c0_caps = sg.stats["captures"]
    on = f32.search(E.SearchRequest(query=probes[0], k=shape.k))
    captured = sg.stats["captures"] - c0_caps
    check(captured > 0, f"the search after the rollback captures anew "
          f"({captured})")
    cpu.resize_cache(back)
    off = cpu.search(E.SearchRequest(query=probes[0], k=shape.k))
    check(np.array_equal(on.ids, off.ids) and on.stats.n_db == off.stats.n_db,
          f"after the rollback the card's ids and n_db ({on.stats.n_db}) "
          f"equal the CPU engine's at C = {back} ({off.stats.n_db})")
    out["rollback"] = dict(from_c=ladder[-1][0], theta=theta, n_db_fed=n_db,
                           to_c=back, captures_next_search=captured,
                           n_db_next_search=on.stats.n_db,
                           s=time.perf_counter() - t0)
    # (d) two tenants under one budget below the sum of their optima
    t0 = time.perf_counter()
    opt_bytes = sum(quant.bytes_per_vector(shape.dim, p) * r.c_best
                    for p, (_, r) in tenants.items())
    budget = int(TENANT_BUDGET_FRAC * shape.n * quant.bytes_per_vector(
        shape.dim, "int8")) // 10 * 10
    demands = [co.TenantDemand(
        tenant=p, dim=shape.dim, n_items=shape.n, precision=p,
        query_test=sizing_query_test(port, shape, eng, warm_q, probes, []))
        for p, (eng, _) in tenants.items()]
    alloc = co.allocate_memory_bytes(demands, budget,
                                     max_iters=TENANT_MAX_ITERS)
    grain = 64  # allocate_memory_bytes's shape_grain
    check(alloc.contended,
          f"budget {budget}: the usable {budget - alloc.reserve_bytes} "
          f"bytes are below the sum of the tenants' optima "
          f"{alloc.sum_opt_bytes} (contended)")
    for a in alloc.allocations.values():
        hi = co._round_to(a.c_opt, grain)
        check(co._round_to(1, grain) <= a.c_items <= hi,
              f"{a.tenant}: {a.c_items} items within [floor, optimum "
              f"{a.c_opt} rounded up to the grain {grain}, {hi}]")
    check(10 * alloc.total_alloc_bytes <= 9 * budget,
          f"total {alloc.total_alloc_bytes} <= 0.9 x budget {budget}")
    out["tenants"] = dict(
        budget_bytes=budget, max_iters=TENANT_MAX_ITERS,
        sum_ladder_opt_bytes=opt_bytes,
        reserve_bytes=alloc.reserve_bytes,
        total_alloc_bytes=alloc.total_alloc_bytes,
        sum_opt_bytes=alloc.sum_opt_bytes, contended=alloc.contended,
        allocations={t: dict(c_items=a.c_items, alloc_bytes=a.alloc_bytes,
                             c_opt=a.c_opt, opt_bytes=a.opt_bytes,
                             satisfied=a.satisfied, ladder=a.ladder)
                     for t, a in alloc.allocations.items()},
        s=time.perf_counter() - t0)
    # (e) MeMemo (host numpy) against the card engine at a 25% tier 2
    t0 = time.perf_counter()
    truth = port["brute_force_topk"](X, probes, shape.k)
    mem = port["mememo"].MememoEngine(X, graph, cache_capacity=shape.cache,
                                      prefetch_size=MEMEMO_PREFETCH)
    web = {mode: engine(mode=mode) for mode in ("webanns", "webanns-base")}

    def mememo_search(q):
        ids, _, stats = mem.query(q, k=shape.k, ef=shape.ef)
        return ids, stats

    def web_search(eng):
        def run(q):
            res = eng.search(E.SearchRequest(query=q, k=shape.k))
            return res.ids, res.stats
        return run

    base = {"mememo": (mem.external.stats, mememo_search)}
    base.update({m: (e.external.stats, web_search(e)) for m, e in web.items()})
    cmp = {}
    for name, (stats, search) in base.items():
        search(warm_q)
        fetched0, used0 = stats.items_fetched, stats.items_used
        ids, lat, n_db = [], [], []
        for q in probes:
            t1 = time.perf_counter()
            got, st = search(q)
            lat.append(time.perf_counter() - t1)
            ids.append(got)
            n_db.append(st.n_db)
        fetched = stats.items_fetched - fetched0
        cmp[name] = dict(
            _latency(lat), n_db_per_query=float(np.mean(n_db)),
            items_fetched=fetched,
            redundancy=(1.0 - (stats.items_used - used0) / fetched
                        if fetched else 0.0),
            recall_at_10=port["recall_at_k"](np.stack(ids), truth))
    check(cmp["mememo"]["redundancy"] > 0.5,
          f"MeMemo's redundancy {cmp['mememo']['redundancy']} > 0.5")
    for mode in web:
        check(cmp[mode]["redundancy"] == 0.0,
              f"{mode}'s redundancy {cmp[mode]['redundancy']} = 0.0")
    check(cmp["webanns"]["n_db_per_query"] < cmp["mememo"]["n_db_per_query"],
          f"WebANNS n_db a query {cmp['webanns']['n_db_per_query']} < "
          f"MeMemo's {cmp['mememo']['n_db_per_query']}")
    cmp["s"] = time.perf_counter() - t0
    out["mememo_vs_webanns"] = cmp
    return out


# ----------------------------------------------------------- phase 4f

PERSIST_PRECISIONS = ("float32", "int8", "float16", "pq")
PERSIST_DRIVERS = ("single", "loop", "batched", "fused")
# the CPU engines a lossy artifact's card engines are held to serve the
# batch in `batched` mode and its first PERSIST_CPU_QUERIES queries in
# the loop and fused drivers: those serve a batch one query after
# another, so their first rows are the card's first rows (the CPU's
# d = 768 hops are what the phase's time goes to)
PERSIST_CPU_QUERIES = 4
TOMBSTONE_FRAC, TOMBSTONE_SEED = 0.05, 17
PERSIST_TIMED_BATCHES = 10
# a .npy file is its array's bytes behind a header of this many at most
NPY_HEADER_MAX = 4096


def persist_config(port, shape: Shape, precision: str, fused: bool,
                   device=None):
    """The query path's engine config at ``precision`` (phases 4f and
    4g); ``device=None`` is the entry point's default, the card."""
    extra = {} if device is None else {"device": device}
    if precision == "pq":
        extra.update(pq_subspaces=PQ_SUBSPACES, rerank_alpha=PQ_ALPHA)
    return port["engine"].EngineConfig(
        cache_capacity=shape.cache, ef_search=shape.ef, precision=precision,
        fused=fused, **extra)


def artifact_payload(path: str) -> dict:
    """The vector payload's bytes as the saved shard arrays hold them
    (vectors or codes, int8 scales) and the files' sizes around them."""
    man = json.loads((Path(path) / "manifest.json").read_text())
    names = [sh[key] for sh in man["vector_shards"]
             for key in ("file", "scales_file") if key in sh]
    return {"arrays": sum(np.load(Path(path) / f, mmap_mode="r").nbytes
                          for f in names),
            "files": sum((Path(path) / f).stat().st_size for f in names),
            "n_files": len(names)}


def serve_opened(port, shape: Shape, path: str, precision: str, Q,
                 device=None, n_one_by_one=None) -> dict:
    """Each driver's request on a fresh engine opened on ``path`` (a cold
    tier 2), as phase 4 serves them; the loop and fused drivers on the
    first ``n_one_by_one`` queries where given. Records each open's
    seconds and the shard reads each search made."""
    E = port["engine"]
    out = {"open_s": {}, "shard_reads": {}, "engines": {}}
    for name in PERSIST_DRIVERS:
        first, mode = REQUEST_FORMS[name]
        q = Q if first is None else Q[first]
        if n_one_by_one is not None and name in ("loop", "fused"):
            q = Q[:n_one_by_one]
        t0 = time.perf_counter()
        eng = E.WebANNSEngine.open(path, persist_config(
            port, shape, precision, name == "fused", device))
        out["open_s"][name] = time.perf_counter() - t0
        reads = eng.external.base_backend.shard_reads
        out[name] = eng.search(E.SearchRequest(query=q, k=shape.k,
                                               batch_mode=mode))
        out["shard_reads"][name] = \
            eng.external.base_backend.shard_reads - reads
        out["engines"][name] = eng
    return out


def _rows(res, n=None) -> list:
    """Per-query (ids, dists, n_db, items_fetched) of a result."""
    stats = res.stats if isinstance(res.stats, list) else [res.stats]
    ids, dists = np.atleast_2d(res.ids), np.atleast_2d(res.dists)
    return [(ids[i], dists[i], s.n_db, s.items_fetched)
            for i, s in enumerate(stats)][:n]


def check_opened_results(port, shape: Shape, X, Q, served, what) -> dict:
    """Shape, finite distances, ids in range, tier 3 read from the
    files, and recall@10 of each driver of an opened artifact."""
    truth = port["brute_force_topk"](X, Q, shape.k)
    out = {}
    for name in PERSIST_DRIVERS:
        res = served[name]
        ids = np.atleast_2d(res.ids)
        check(ids.shape == ((1 if name == "single" else shape.batch),
                            shape.k)
              and bool(np.isfinite(res.dists).all())
              and bool(((ids >= 0) & (ids < shape.n)).all()),
              f"{what}, {name}: shape, finite distances, ids in range")
        check(served["shard_reads"][name] > 0,
              f"{what}, {name}: tier 3 read from the shard files "
              f"({served['shard_reads'][name]} reads)")
        if name != "single":
            out[f"recall_at_10_{name}"] = port["recall_at_k"](res.ids, truth)
    return out


def hold_to_cpu(card, cpu, what: str, n_one_by_one: int) -> dict:
    """Card engines against CPU engines on one directory: ids equal but
    for near ties (MIN_AGREEMENT of the positions, as phase 4 holds a
    quantized path), every query's ``n_db`` equal."""
    out = {}
    for name in PERSIST_DRIVERS:
        n = n_one_by_one if name in ("loop", "fused") else None
        a, b = _rows(card[name], n), _rows(cpu[name], n)
        check(len(a) == len(b), f"{what}, {name}: as many queries")
        agree = _agreement(np.stack([r[0] for r in a]),
                           np.stack([r[0] for r in b]))
        out[f"cpu_agreement_{name}"] = agree
        check(agree >= MIN_AGREEMENT,
              f"{what}, {name}: ids agree with the CPU engine: {agree}")
        check([r[2] for r in a] == [r[2] for r in b],
              f"{what}, {name}: n_db equals the CPU engine's "
              f"({[r[2] for r in a]} against {[r[2] for r in b]})")
    return out


def run_persistence(port, shape: Shape, X, Q, runs: dict) -> dict:
    """Phase 4f: each phase-4 engine saves its index at its precision into
    a directory under build/ (deleted at the end), and engines opened on
    it with the default device serve phase 4's requests from a cold tier
    2, tier 3 read lazily from the mmap'd shards. At float32 they equal
    the in-memory card engines bit for bit; the lossy artifacts' card
    engines are held to CPU engines opened on the same directory. Then a
    seeded 5% of the float32 artifact's rows, its entry point among
    them, are tombstoned on disk and the artifact reopened."""
    out = {"card": device_line()}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="persist_",
                                     dir=ROOT / "build") as root:
        paths = {}
        for precision in PERSIST_PRECISIONS:
            t_phase = time.perf_counter()
            o = out[precision] = {}
            src = runs[precision]["engines"]["batched"]
            path = paths[precision] = str(Path(root) / precision)
            t0 = time.perf_counter()
            info = src.save(path, precision=precision)
            o["save_s"] = time.perf_counter() - t0
            check(info["mode"] == "full", f"{precision}: a full save")
            o["bytes_written"] = info["bytes_written"]
            pay = artifact_payload(path)
            want = shape.n * port["quant"].bytes_per_vector(
                shape.dim, precision, n_subspaces=PQ_SUBSPACES)
            check(pay["arrays"] == want
                  and 0 < pay["files"] - pay["arrays"]
                  <= NPY_HEADER_MAX * pay["n_files"],
                  f"{precision}: the payload is {want} bytes from the shapes "
                  f"({pay})")
            o["payload_bytes"] = pay["arrays"]
            if precision == "pq":
                cb = port["pq"].PQCodebook.load(str(Path(path)
                                                    / "codebook.npz"))
                o["codebook_bytes"] = cb.nbytes()
                check(o["codebook_bytes"] == PQ_SUBSPACES * 256
                      * (shape.dim // PQ_SUBSPACES) * 4
                      and np.array_equal(cb.centroids,
                                         src.pq_codebook.centroids),
                      f"pq: the saved codebook is the session's "
                      f"({o['codebook_bytes']} bytes)")
            check(o["bytes_written"] > o["payload_bytes"],
                  f"{precision}: the graph shards come on top")
            t0 = time.perf_counter()
            port["index"].Index.load(path)
            o["index_load_s"] = time.perf_counter() - t0
            served = serve_opened(port, shape, path, precision, Q)
            o["open_s"] = served["open_s"]
            o["shard_reads"] = served["shard_reads"]
            check(all(e.device.type == "cuda"
                      for e in served["engines"].values()),
                  f"{precision}: opened on the card by default")
            o.update(check_opened_results(port, shape, X, Q, served,
                                          f"reopened {precision}"))
            mem = runs[precision]
            truth = port["brute_force_topk"](X, Q, shape.k)
            for name in ("batched", "loop"):
                o[f"in_memory_recall_at_10_{name}"] = port["recall_at_k"](
                    mem[name].ids, truth)
            fused_mem = (runs["pq"]["fused"] if precision == "pq"
                         else runs[f"fused_{precision}"]["fused"])
            o["in_memory_recall_at_10_fused"] = port["recall_at_k"](
                fused_mem.ids, truth)
            if precision == "float32":
                for name in PERSIST_DRIVERS:
                    want_res = (fused_mem if name == "fused"
                                else mem[name])
                    got = served[name]
                    check(np.array_equal(got.ids, want_res.ids)
                          and np.array_equal(got.dists, want_res.dists),
                          f"reopened float32, {name}: ids and dists equal "
                          "the in-memory card engine's")
                    check([r[2:] for r in _rows(got)]
                          == [r[2:] for r in _rows(want_res)],
                          f"reopened float32, {name}: n_db and "
                          "items_fetched equal the in-memory engine's")
                o["equal_to_in_memory"] = True
                o["batched_p50"] = reopened_p50(port, shape, X, src, path)
            else:
                # recall against the rows the artifact stores, which its
                # tier 3 serves and its exact rerank scores
                stored = port["brute_force_topk"](
                    served["engines"]["batched"].external.base_backend
                    .fetch(np.arange(shape.n)), Q, shape.k)
                for name in ("batched", "loop", "fused"):
                    o[f"recall_at_10_vs_stored_{name}"] = \
                        port["recall_at_k"](served[name].ids, stored)
                cpu = serve_opened(port, shape, path, precision, Q, "cpu",
                                   PERSIST_CPU_QUERIES)
                o.update(hold_to_cpu(served, cpu, f"reopened {precision}",
                                     PERSIST_CPU_QUERIES))
            o["n_db"] = {name: (served[name].batch_stats.n_db
                                if name != "single"
                                else served[name].stats.n_db)
                         for name in PERSIST_DRIVERS}
            o["s"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        out["tombstones"] = run_tombstones(port, shape, X, Q,
                                           paths["float32"])
        out["tombstones"]["s"] = time.perf_counter() - t0
    check(not any(Path(ROOT / "build").glob("persist_*")),
          "the phase's directory is gone")
    return out


def reopened_p50(port, shape: Shape, X, mem_src, path: str) -> dict:
    """Batched p50 of a reopened float32 engine beside an in-memory one
    (fresh engines, one warm-up batch each, then PERSIST_TIMED_BATCHES
    batches each in two turns: in-memory, reopened, reopened,
    in-memory; host clock, results on the host)."""
    E = port["engine"]
    cfg = persist_config(port, shape, "float32", False)
    engines = {"in_memory": E.WebANNSEngine(X, mem_src.graph, cfg),
               "reopened": E.WebANNSEngine.open(path, cfg)}
    lat = {name: [] for name in engines}
    for name, eng in engines.items():
        _timed_searches(port, shape, X, eng, "batched", 1, seed=90)
    half = PERSIST_TIMED_BATCHES // 2
    for turn, name in enumerate(("in_memory", "reopened", "reopened",
                                 "in_memory")):
        lat[name] += _timed_searches(port, shape, X, engines[name],
                                     "batched", half, seed=300 + 10 * turn)[0]
    return {name: _latency(v) for name, v in lat.items()}


def run_tombstones(port, shape: Shape, X, Q, path: str) -> dict:
    """A seeded TOMBSTONE_FRAC of the float32 artifact's rows, its entry
    point among them, tombstoned on disk with the port's own
    ``save_tombstones`` and ``update_manifest``; the artifact reopened on
    the card and on the CPU."""
    st = port["storage"]
    man = json.loads((Path(path) / "manifest.json").read_text())
    entry = int(man["entry_point"])
    rng = np.random.default_rng(TOMBSTONE_SEED)
    mask = np.zeros(shape.n, bool)
    mask[rng.choice(shape.n, int(TOMBSTONE_FRAC * shape.n),
                    replace=False)] = True
    mask[entry] = True
    st.save_tombstones(path, mask)
    st.update_manifest(path, {"mutation_epoch": 1})
    card = serve_opened(port, shape, path, "float32", Q)
    cpu = serve_opened(port, shape, path, "float32", Q, "cpu",
                       PERSIST_CPU_QUERIES)
    out = {"tombstoned": int(mask.sum()), "old_entry": entry}
    for where, served in (("card", card), ("cpu", cpu)):
        for name in PERSIST_DRIVERS:
            eng = served["engines"][name]
            ids = np.asarray(served[name].ids)
            check(eng.n_live == shape.n - int(mask.sum())
                  and not mask[eng.graph.entry_point]
                  and eng.graph.entry_point != entry,
                  f"tombstones, {where}, {name}: the entry point moved to a "
                  f"live node ({entry} -> {eng.graph.entry_point})")
            check(not mask[ids[ids >= 0]].any(),
                  f"tombstones, {where}, {name}: no tombstoned id returned")
    out["new_entry"] = card["engines"]["batched"].graph.entry_point
    out.update(check_opened_results(port, shape, X, Q, card, "tombstones"))
    out.update(hold_to_cpu(card, cpu, "tombstones", PERSIST_CPU_QUERIES))
    return out


# ----------------------------------------------------------- phase 4g

# per-id metadata of the filtered searches: `cat` 10 uniform values,
# `year` 50; the filters' selectivities and their boosted ef
META_SEED, MUTATION_SEED = 23, 29
FILTER_SELECTIVITY = {"cat<5": 0.5, "cat=3": 0.1, "year=2000": 0.02}
FILTER_DRIVERS = ("single", "loop", "batched", "fused")
# the loop and fused drivers serve the first ONE_BY_ONE queries one at a
# time; the batched driver the whole batch
ONE_BY_ONE = 8
# recall@10 of a float32 filtered search against the brute force over
# the allowed rows, at selectivity 0.5 and 0.1 (the reference's own
# acceptance, tests/test_filtered_search.py)
FILTER_MIN_RECALL = 0.95
# the mutations: 5% of the rows and the entry point deleted, 500 rows
# added (corpus rows moved by the corpus's own spread, 0.35), 100 live
# rows upserted; 32 noisy copies of added rows (make_queries' noise)
# join phase 4's queries, and float32 must find each copy's row in its
# top 10 for NOISY_MIN_HIT of them
DELETE_FRAC, N_ADDED, N_UPSERTED, N_NOISY = 0.05, 500, 100, 32
NOISY_MIN_HIT = 0.9
MUTATION_PRECISIONS = ("float32", "int8", "pq")


def filter_metadata(n: int) -> dict:
    rng = np.random.default_rng(META_SEED)
    return {"cat": rng.integers(0, 10, n),
            "year": 1975 + rng.integers(0, 50, n)}


def make_filters(port) -> dict:
    F = port["metadata"].Filter
    return {"cat<5": F.in_("cat", range(5)), "cat=3": F.eq("cat", 3),
            "year=2000": F.range("year", lo=2000, hi=2000)}


def serve(port, shape: Shape, eng, Q, name: str, filt=None, ef=None,
          n_one_by_one: int = ONE_BY_ONE):
    """``name``'s request (REQUEST_FORMS) of Q on ``eng``, the loop and
    fused drivers on the first ``n_one_by_one`` queries."""
    first, mode = REQUEST_FORMS[name]
    q = Q if first is None else Q[first]
    if name in ("loop", "fused"):
        q = Q[:n_one_by_one]
    return eng.search(port["engine"].SearchRequest(
        query=q, k=shape.k, ef=ef, batch_mode=mode, filter=filt))


def _access_rows(res) -> list:
    """Per-query (n_db, items_fetched) of a result, and the batch's."""
    rows = [r[2:] for r in _rows(res)]
    if res.batch_stats is not None:
        rows.append((res.batch_stats.n_db, res.batch_stats.items_fetched))
    return rows


def run_filters(port, shape: Shape, X, graph, Q) -> dict:
    """Phase 4g (a): three filters of live selectivity 0.5, 0.1 and 0.02
    (ef boosted to ``FILTER_EFS``) through the single, ``loop``,
    ``batched`` and fused drivers at float32 and int8, each on a fresh
    card engine (a cold 25% tier 2) beside an unfiltered search at the
    boosted ef on another: no denied id returned; the unfiltered search's
    ``n_db`` (and at float32 its ``items_fetched``) exactly; float32
    recall@10 against the brute force over the allowed rows >=
    FILTER_MIN_RECALL at 0.5 and 0.1 in the drivers that serve 8 queries
    or more (recorded at 0.02, and for the single query); and, at 0.1,
    the batched driver's ids on 8 queries against a CPU engine's."""
    E = port["engine"]
    meta = filter_metadata(shape.n)
    store = port["metadata"].MetadataStore(meta)
    out = {}
    for precision in ("float32", "int8"):
        for (fname, filt), want_ef in zip(make_filters(port).items(),
                                          FILTER_EFS):
            allow = filt.mask(store)
            sel = float(allow.mean())
            o = out[f"{precision} {fname}"] = {"selectivity": sel,
                                                "recall_at_10": {}}
            what = f"filter {fname} at {precision}"
            for name in FILTER_DRIVERS:
                cfg = persist_config(port, shape, precision, name == "fused")
                eng = E.WebANNSEngine(X, graph, cfg, metadata=meta)
                ef_eff = eng._boost_ef(shape.ef, sel)
                check(ef_eff == want_ef,
                      f"{what}: ef boosted to {ef_eff}, not {want_ef}")
                t0 = time.perf_counter()
                res = serve(port, shape, eng, Q, name, filt)
                o[f"{name}_s"] = time.perf_counter() - t0
                base = serve(port, shape, E.WebANNSEngine(X, graph, cfg),
                             Q, name, ef=ef_eff)
                ids = np.atleast_2d(res.ids)
                check(ids.shape[1] == shape.k
                      and not (~allow)[ids[ids >= 0]].any(),
                      f"{what}, {name}: no denied id returned")
                a, b = _access_rows(res), _access_rows(base)
                if precision == "float32":
                    check(a == b, f"{what}, {name}: n_db and items_fetched "
                          f"equal the unfiltered search's ({a} against {b})")
                elif sel >= 0.1:  # a rerank pool never comes up empty
                    check([r[0] for r in a] == [r[0] for r in b],
                          f"{what}, {name}: n_db equals the unfiltered "
                          "search's")
                qs = {"single": Q[:1], "loop": Q[:ONE_BY_ONE],
                      "fused": Q[:ONE_BY_ONE]}.get(name, Q)
                truth = np.flatnonzero(allow)[port["brute_force_topk"](
                    X[allow], qs, shape.k)]
                rec = port["recall_at_k"](ids, truth)
                o["recall_at_10"][name] = rec
                o[f"padded_{name}"] = int((ids < 0).sum())
                # held where a driver serves 8 queries or more (the
                # reference's acceptance is over 8; one query's recall
                # moves in steps of 0.1)
                if precision == "float32" and sel >= 0.1 \
                        and name != "single":
                    check(rec >= FILTER_MIN_RECALL,
                          f"{what}, {name}: recall@10 {rec} >= "
                          f"{FILTER_MIN_RECALL}")
            o["ef"] = ef_eff
        # the card against the CPU on the selectivity-0.1 filter
        filt = make_filters(port)["cat=3"]
        got = {}
        for device in ("cuda", "cpu"):
            eng = E.WebANNSEngine(X, graph, persist_config(
                port, shape, precision, False, device), metadata=meta)
            got[device] = eng.search(E.SearchRequest(
                query=Q[:ONE_BY_ONE], k=shape.k, filter=filt))
        agree = _agreement(got["cuda"].ids, got["cpu"].ids)
        out[f"{precision} cat=3"]["cpu_agreement"] = agree
        check(agree >= MIN_AGREEMENT,
              f"filter cat=3 at {precision}: ids agree with the CPU "
              f"engine ({agree})")
        check([s_.n_db for s_ in got["cuda"].stats]
              == [s_.n_db for s_ in got["cpu"].stats],
              f"filter cat=3 at {precision}: n_db equals the CPU engine's")
    return out


def run_mutation(port, shape: Shape, X, graph, Q, codebook) -> dict:
    """Phase 4g (b): on card engines at float32, int8 and pq (each on its
    own copy of phase 4's graph, after one batched search so tier 2 is
    warm and its step graphs captured): delete a seeded DELETE_FRAC of
    the rows and the entry point, add N_ADDED rows, upsert N_UPSERTED
    live rows (host clock each), then serve phase 4's queries and
    N_NOISY noisy copies of added rows in the single, ``batched``,
    ``loop`` and fused drivers (the fused engine opened on the mutated
    engine's index). Checked: the ids the mutations give and take, the
    entry point moved to a live node, no deleted or upserted-away id
    returned, float32 finding each copy's row in its top 10
    (NOISY_MIN_HIT), 8 queries against a CPU engine on the same index
    and tier 2, and step graphs captured anew after the add and replayed
    (``step_graph.stats``, ``n_captures()``)."""
    E, sg, conv = port["engine"], port["step_graph"], port["convert"]
    rng = np.random.default_rng(MUTATION_SEED)
    n = shape.n

    def moved(rows):  # the corpus's own spread around existing rows
        return rows + 0.35 * rng.standard_normal(rows.shape).astype(
            np.float32)

    dead = np.union1d(rng.choice(n, int(DELETE_FRAC * n), replace=False),
                      [graph.entry_point])
    added = moved(X[rng.choice(n, N_ADDED)])
    up_ids = rng.choice(np.setdiff1d(np.arange(n), dead), N_UPSERTED,
                        replace=False)
    up_rows = moved(X[up_ids])
    copies = rng.choice(N_ADDED, N_NOISY, replace=False)
    noisy = added[copies] + 0.25 * rng.standard_normal(
        (N_NOISY, shape.dim)).astype(np.float32)
    Qm = np.concatenate([Q, noisy]).astype(np.float32)
    gone = np.union1d(dead, up_ids)
    out = {}
    for precision in MUTATION_PRECISIONS:
        o = out[precision] = {}
        what = f"mutation at {precision}"
        source = X
        if precision == "pq":  # the engine adopts the card-trained codebook
            source = port["InMemoryBackend"](X)
            source.codebook = codebook
        eng = E.WebANNSEngine(source, copy.deepcopy(graph), persist_config(
            port, shape, precision, False))
        eng.search(E.SearchRequest(query=Q, k=shape.k))
        stats0, n_cap0 = dict(sg.stats), sg.n_captures()
        t0 = time.perf_counter()
        res_d = eng.delete(dead)
        o["delete_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_a = eng.add(added)
        o["add_s"] = time.perf_counter() - t0
        o["add_rows_per_s"] = N_ADDED / o["add_s"]
        t0 = time.perf_counter()
        res_u = eng.upsert(up_ids, up_rows)
        o["upsert_s"] = time.perf_counter() - t0
        check(np.array_equal(res_d.deleted, dead)
              and np.array_equal(res_a.ids, np.arange(n, n + N_ADDED))
              and np.array_equal(res_u.deleted, np.sort(up_ids))
              and np.array_equal(res_u.ids, np.arange(
                  n + N_ADDED, n + N_ADDED + N_UPSERTED))
              and res_u.n_total == n + N_ADDED + N_UPSERTED
              and res_u.n_live == n - len(dead) + N_ADDED,
              f"{what}: the ids the mutations gave and took")
        check(not eng.tombstones[eng.graph.entry_point]
              and eng.graph.entry_point != graph.entry_point,
              f"{what}: the entry point moved to a live node")
        # a CPU engine on the same index and tier 2
        cpu = E.WebANNSEngine(eng.index, config=persist_config(
            port, shape, precision, False, "cpu"))
        tier2 = conv.cache_to_numpy(eng.store.cache)
        cpu.store.cache = conv.cache_from_reference(
            *(tier2[f] for f in conv.CACHE_FIELDS), device="cpu")
        first = {dev: e.search(E.SearchRequest(query=Qm[:ONE_BY_ONE],
                                               k=shape.k))
                 for dev, e in (("cuda", eng), ("cpu", cpu))}
        o["cpu_agreement"] = _agreement(first["cuda"].ids, first["cpu"].ids)
        check(o["cpu_agreement"] >= MIN_AGREEMENT,
              f"{what}: ids agree with the CPU engine ({o['cpu_agreement']})")
        check([s_.n_db for s_ in first["cuda"].stats]
              == [s_.n_db for s_ in first["cpu"].stats],
              f"{what}: n_db equals the CPU engine's")
        fused = E.WebANNSEngine(eng.index, config=persist_config(
            port, shape, precision, True))
        o["hit_at_10"] = {}
        for name in FILTER_DRIVERS:
            t0 = time.perf_counter()
            res = serve(port, shape, fused if name == "fused" else eng, Qm,
                        name, n_one_by_one=len(Qm))
            o[f"{name}_s"] = time.perf_counter() - t0
            ids = np.atleast_2d(res.ids)
            check(ids.shape[1] == shape.k and (ids >= 0).all()
                  and not np.isin(ids, gone).any(),
                  f"{what}, {name}: no deleted or upserted-away id returned")
            if name != "single":
                rows = n + copies  # each noisy copy's own row
                hit = float(np.mean([r in row for r, row in
                                     zip(rows, ids[len(Q):])]))
                o["hit_at_10"][name] = hit
                if precision == "float32":
                    check(hit >= NOISY_MIN_HIT,
                          f"{what}, {name}: {hit} of the copies found their "
                          f"row in the top 10")
        stats1 = {k: sg.stats[k] - stats0[k] for k in stats0}
        o["captures_after_add"] = stats1["captures"]
        o["replays_after_add"] = stats1["replays"]
        o["n_captures"] = [n_cap0, sg.n_captures()]
        check(stats1["captures"] > 0 and stats1["replays"] > 0,
              f"{what}: step graphs captured anew after the add and "
              f"replayed ({stats1})")
    return out


def run_mutation_filters(port, shape: Shape, X, graph, Q, codebook) -> dict:
    """Phase 4g: filters (``run_filters``), then mutation
    (``run_mutation``), each timed on the host clock."""
    out = {"card": device_line()}
    t0 = time.perf_counter()
    out["filters"] = run_filters(port, shape, X, graph, Q)
    out["filters_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["mutation"] = run_mutation(port, shape, X, graph, Q, codebook)
    out["mutation_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------- phase 4b


# the flat scan at the paper's own size (Wiki-480k, d = 768): it needs no
# HNSW build, so nothing is cut; the hnsw mode of the same program builds
# a graph, so it runs on the first HNSW_SUBSTRATE_N rows
FLAT_N = 480_000
HNSW_SUBSTRATE_N = 2_000
FLAT_MIN_RECALL = 0.999


def rendezvous(name: str) -> str:
    """A fresh ``file://`` rendezvous for a process group, in the
    git-ignored build directory."""
    path = ROOT / "build" / f"{name}.rendezvous"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    return f"file://{path}"


def l2_64(X: np.ndarray, Q: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Float64 l2 distances (B, k) of the rows ``ids`` to the queries."""
    diff = X[ids].astype(np.float64) - Q.astype(np.float64)[:, None, :]
    return (diff * diff).sum(-1)


def near_tie(X, q, a: int, b: float, tol_rows) -> float:
    """Gap between row ``a``'s float64 l2 distance to ``q`` and the
    distance ``b``, in units of the distance kernel's tolerance
    DM_TOL·(|q|² + |x|²) at the largest |x|² of ``tol_rows``: a near tie
    is a gap <= 1."""
    q64 = q.astype(np.float64)
    da = float(((X[a].astype(np.float64) - q64) ** 2).sum())
    xn = max(float((X[r].astype(np.float64) ** 2).sum()) for r in tol_rows)
    return abs(da - b) / (DM_TOL * (float((q64 ** 2).sum()) + xn))


def check_flat_scan(port, shape: Shape, X, Q, ids, shard, dev) -> dict:
    """The flat scan's (B, k) ids against the exact top-k (recall@10 and
    near ties of every miss) and against the plain scan on the card
    (every differing position a near tie)."""
    k = shape.k
    check(ids.shape == (shape.batch, k)
          and bool(((ids >= 0) & (ids < X.shape[0])).all()),
          "flat scan: ids shape and range")
    truth = port["brute_force_topk"](X, Q, k)
    recall = port["recall_at_k"](ids, truth)
    got64 = l2_64(X, Q, ids)
    worst_miss = 0.0
    n_miss = 0
    for b in range(shape.batch):
        tenth = float(got64[b].max())
        for m in set(truth[b].tolist()) - set(ids[b].tolist()):
            n_miss += 1
            gap = near_tie(X, Q[b], m, tenth, [m, *ids[b].tolist()])
            worst_miss = max(worst_miss, gap)
            check(gap <= 1.0, f"flat scan: missed id {m} of query {b} is a "
                  f"near tie (gap {gap} of the tolerance)")
    check(recall >= FLAT_MIN_RECALL,
          f"flat scan: recall@10 {recall} >= {FLAT_MIN_RECALL}")
    Qd = torch.from_numpy(Q).to(dev)
    _, plain = port["ref"].distance_topk_ref(Qd, shard.vectors, k, "l2")
    plain = plain.cpu().numpy()
    plain64 = l2_64(X, Q, plain)
    worst_plain = 0.0
    for b, j in zip(*np.nonzero(plain != ids)):
        gap = near_tie(X, Q[b], int(ids[b, j]), float(plain64[b, j]),
                       [int(ids[b, j]), int(plain[b, j])])
        worst_plain = max(worst_plain, gap)
        check(gap <= 1.0, f"flat scan: id {ids[b, j]} at ({b}, {j}) differs "
              f"from the plain scan's {plain[b, j]} by more than a near tie")
    return {"recall_at_10": recall, "n_missed": n_miss,
            "worst_miss_gap": worst_miss,
            "plain_agreement": _agreement(ids, plain),
            "worst_plain_gap": worst_plain}


def run_substrate(port, shape: Shape, dev) -> dict:
    """The distributed substrate at world size 1 over NCCL: the flat scan
    over FLAT_N x 768 (``distributed_brute_force``) and the hnsw mode over
    the first HNSW_SUBSTRATE_N rows (``make_distributed_search``, the
    paper's M and ef_construction), each with the launch counts set to 0
    just before it and read just after; then the hnsw mode again over
    gloo on the CPU, the same index and queries. Returns the checks, the
    launch counts, and what the timings need (the group stays up)."""
    D, mesh, ops = port["distributed"], port["mesh"], port["ops"]
    out = {"record": {}, "launches": {}}
    t0 = time.perf_counter()
    X = port["corpus_embeddings"](FLAT_N, shape.dim, seed=CORPUS_SEED)
    index = D.build_sharded_index(X, 1, hnsw=False)
    out["record"]["flat_setup_s"] = time.perf_counter() - t0
    group = mesh.make_shard_group(1, device="cuda",
                                  init_method=rendezvous("substrate"),
                                  rank=0)
    shard = index.shard(0, group.device)
    del index
    Q = make_queries(X, shape.batch, seed=QUERY_SEED)
    search = D.distributed_brute_force(group, metric="l2", k=shape.k)
    torch.cuda.synchronize()
    # the launch counts are set to 0 just before the search, read after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dists, ids = search(Q, shard)
    ids = ids.cpu().numpy()
    out["record"]["flat_first_search_s"] = time.perf_counter() - t0
    n = ops.launch_counts()
    out["launches"]["flat"] = n
    check(n["distance_matrix"] == 1 and n["topk"] == 2,
          f"flat scan: distance_matrix once and topk twice a search ({n})")
    check(bool(torch.isfinite(dists).all()), "flat scan: finite distances")
    out["record"]["flat"] = check_flat_scan(port, shape, X, Q, ids, shard,
                                            dev)
    print(f"substrate, flat scan over {FLAT_N} x {shape.dim}: "
          f"{json.dumps(out['record']['flat'])}", flush=True)

    X2 = X[:HNSW_SUBSTRATE_N]
    t0 = time.perf_counter()
    index2 = D.build_sharded_index(X2, 1, M=shape.M,
                                   ef_construction=shape.ef_construction,
                                   seed=GRAPH_SEED)
    out["record"]["hnsw_substrate_build_s"] = time.perf_counter() - t0
    Q2 = make_queries(X2, shape.batch, seed=QUERY_SEED)
    hnsw = D.make_distributed_search(group, metric="l2", k=shape.k,
                                     ef=shape.ef, mode="hnsw")
    ops.reset_launch_counts()
    _, on = hnsw(Q2, index2.shard(0, group.device))
    on = on.cpu().numpy()
    n = ops.launch_counts()
    out["launches"]["hnsw"] = n
    check(n["gather_distance"] > 0 and n["gather_distance_batch"] > 0
          and n["merge_topk"] > 0 and n["topk"] == 1,
          f"hnsw mode: the gather, merge and top-k kernels served it ({n})")
    out.update(shard=shard, X=X)
    mesh.destroy_shard_group()  # the CPU run needs a gloo group

    cpu_group = mesh.make_shard_group(1, device="cpu",
                                      init_method=rendezvous("substrate_cpu"),
                                      rank=0)
    _, off = D.make_distributed_search(cpu_group, metric="l2", k=shape.k,
                                       ef=shape.ef, mode="hnsw")(
        Q2, index2.shard(0, "cpu"))
    mesh.destroy_shard_group()
    off = off.numpy()
    off64 = l2_64(X2, Q2, off)
    worst = 0.0
    for b, j in zip(*np.nonzero(on != off)):
        gap = near_tie(X2, Q2[b], int(on[b, j]), float(off64[b, j]),
                       [int(on[b, j]), int(off[b, j])])
        worst = max(worst, gap)
        check(gap <= 1.0, f"hnsw mode: id {on[b, j]} at ({b}, {j}) differs "
              f"from the CPU run's {off[b, j]} by more than a near tie")
    truth = port["brute_force_topk"](X2, Q2, shape.k)
    out["record"]["hnsw"] = {
        "n": HNSW_SUBSTRATE_N, "cpu_agreement": _agreement(on, off),
        "worst_gap": worst, "recall_at_10": port["recall_at_k"](on, truth)}
    print(f"substrate, hnsw mode over {HNSW_SUBSTRATE_N} rows: "
          f"{json.dumps(out['record']['hnsw'])}", flush=True)
    return out


# ----------------------------------------------------------- phase 4c


# the recsys serving slice: the embedding substrate's padded bag (kernel
# B.7) at DLRM-RM2's table shape, the four architectures' serve step at
# their published widths, and candidate retrieval (B.5, B.6)
RECSYS_ARCHS = ("dlrm-rm2", "din", "autoint", "bst")
RECSYS_SEED = 0  # the parameters' CPU generator and click_batches
RECSYS_RTOL, RECSYS_ATOL = 1e-4, 1e-5  # card vs CPU logits, TF32 off
SERVE_STEPS = 30
# B.7's bags: one 1,000,000 x 64 float32 table (DLRM-RM2's vocab and
# embed_dim), bags of up to 32 slots, each bag's length uniform in 1..32
# and the rest -1 (this slice's own choice of multi-hot shape)
BAG_ROWS, BAG_DIM, BAG_SLOTS = 1_000_000, 64, 32
RETRIEVAL_K = 100


def bag_ids(gen: torch.Generator, B: int, dev) -> torch.Tensor:
    """(B, BAG_SLOTS) int32 ids uniform over the table, each bag's length
    uniform in 1..BAG_SLOTS, the slots past it -1."""
    ids = torch.randint(0, BAG_ROWS, (B, BAG_SLOTS), generator=gen,
                        device=dev, dtype=torch.int32)
    length = torch.randint(1, BAG_SLOTS + 1, (B, 1), generator=gen,
                           device=dev)
    pad = torch.arange(BAG_SLOTS, device=dev)[None, :] >= length
    return ids.masked_fill(pad, -1)


def _serve_latency(run, n: int) -> dict:
    """``run()`` n times after two warm-ups, each on the host clock and
    ended by a synchronise."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return _latency(lat)


def run_recsys(port, dev) -> dict:
    """The recsys serving slice on the card, each path with the launch
    counts set to 0 just before it and read just after:

    - ``embedding_bag_padded`` over a BAG_ROWS x BAG_DIM table at
      serve_p99's and serve_bulk's batch, against its plain version;
    - each architecture's ``recsys_forward`` at its published config
      (parameters from a seeded CPU generator, moved to the card) on
      ``click_batches(seed=0)`` at serve_p99 (DLRM-RM2 at serve_bulk too),
      against the CPU forward on the same parameters; p50/p99 of the serve
      step (numpy batch in, logits on the card) and samples/s;
    - ``retrieval_score`` at retrieval_cand (1 x 1,000,000 x embed_dim,
      ip, k = 100) against the CPU plain scan, B.5 and B.6 against their
      plain versions at this shape, and its p50.
    """
    C, E, R, ops = port["configs"], port["embeddings"], port["recsys"], \
        port["ops"]
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "recsys: float32 matmuls run without TF32")
    shapes = C.base.RECSYS_SHAPES
    p99_b = shapes["serve_p99"].params["batch"]
    bulk_b = shapes["serve_bulk"].params["batch"]
    out = {"record": {}, "launches": {}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(RECSYS_SEED)

    # B.7 at DLRM-RM2's table shape
    table = E.init_embedding_table(
        BAG_ROWS, BAG_DIM, torch.Generator().manual_seed(RECSYS_SEED),
        device=dev)["table"]
    bags = {B: bag_ids(gen, B, dev) for B in (p99_b, bulk_b)}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = {B: E.embedding_bag_padded(table, idx) for B, idx in bags.items()}
    torch.cuda.synchronize()
    n = ops.launch_counts()
    out["launches"]["embedding_bag"] = n
    check(n["embedding_bag"] == 2, f"embedding bag: B.7 once a call ({n})")
    for B, idx in bags.items():
        check(torch.equal(got[B], port["ref"].embedding_bag_ref(table, idx)),
              f"embedding_bag_padded at B={B} = plain")
    out["record"]["embedding_bag"] = {
        "table": [BAG_ROWS, BAG_DIM], "slots": BAG_SLOTS,
        "mean_bag_len": float((bags[bulk_b] >= 0).float().sum(1).mean())}
    out["bag_table"] = table
    del got, bags

    # the four architectures' serve step
    serve = {}
    for arch in RECSYS_ARCHS:
        cfg = C.get(arch).make_config()
        t0 = time.perf_counter()
        model = R.init_recsys(cfg, torch.Generator().manual_seed(RECSYS_SEED),
                              device="cpu")
        init_s = time.perf_counter() - t0
        sizes = [p99_b] + ([bulk_b] if cfg.model == "dlrm" else [])
        batches = {B: next(port["click_batches"](cfg, B, 1, seed=RECSYS_SEED))
                   for B in sizes}
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = {B: R.recsys_forward(model, b) for B, b in batches.items()}
        cpu_s = time.perf_counter() - t0
        param_bytes = sum(p.numel() * 4 for p in model.parameters())
        torch.cuda.reset_peak_memory_stats()
        model.to(dev)
        o = {"config": cfg.name, "param_bytes": param_bytes,
             "init_s": init_s, "cpu_forward_s": cpu_s}
        with torch.inference_mode():  # serving: no autograd records
            for B, batch in batches.items():
                ops.reset_launch_counts()
                logits = R.recsys_forward(model, batch)
                torch.cuda.synchronize()
                out["launches"][f"{arch}_B{B}"] = ops.launch_counts()
                what = f"{arch} serve step at B={B}"
                check(logits.shape == (B,)
                      and bool(torch.isfinite(logits).all()),
                      f"{what}: finite logits of shape ({B},)")
                err = (logits.cpu() - want[B]).abs()
                check(torch.allclose(logits.cpu(), want[B],
                                     rtol=RECSYS_RTOL, atol=RECSYS_ATOL),
                      f"{what}: logits within rtol {RECSYS_RTOL}, atol "
                      f"{RECSYS_ATOL} of the CPU forward (max err "
                      f"{float(err.max())})")
                lat = _serve_latency(
                    lambda b=batch: R.recsys_forward(model, b), SERVE_STEPS)
                lat["samples_per_s"] = B * 1e3 / lat["mean_ms"]
                lat["max_abs_err"] = float(err.max())
                lat["loss"] = float(R.recsys_loss(model, batch))
                if B == p99_b or cfg.model == "dlrm":
                    lat["profile"] = profile_call(
                        lambda b=batch: R.recsys_forward(model, b).cpu(),
                        port["kernel_names"])
                o[f"B{B}"] = lat
        o["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        serve[arch] = o
        print(f"recsys, {arch}: {json.dumps(o)}", flush=True)
        del model, want, batches
        torch.cuda.empty_cache()
    out["record"]["serve"] = serve

    # candidate retrieval at retrieval_cand
    rc = shapes["retrieval_cand"].params
    D = C.get("dlrm-rm2").make_config().embed_dim
    t0 = time.perf_counter()
    cands = port["corpus_embeddings"](rc["n_candidates"], D,
                                      seed=CORPUS_SEED)
    q = make_queries(cands, rc["batch"], seed=QUERY_SEED)
    setup_s = time.perf_counter() - t0
    cands_d, q_d = torch.from_numpy(cands).to(dev), torch.from_numpy(q).to(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dists, ids = R.retrieval_score(q_d, cands_d, k=RETRIEVAL_K)
    torch.cuda.synchronize()
    n = ops.launch_counts()
    out["launches"]["retrieval"] = n
    check(n["distance_matrix"] == 1 and n["topk"] == 1,
          f"retrieval: the distance matrix once and the top-k once ({n})")
    check(dists.shape == (rc["batch"], RETRIEVAL_K)
          and bool(torch.isfinite(dists).all())
          and bool((dists[:, 1:] >= dists[:, :-1]).all()),
          "retrieval: finite scores, best first")
    # B.5 and B.6 against their plain versions at this path's own shape
    # and matrix, on the same card tensors
    D_k = ops.distance_matrix(q_d, cands_d, "ip")
    dm_err = scaled_error(D_k, port["ref"].distance_matrix_ref(
        q_d, cands_d, "ip"), q_d, cands_d, "ip")
    check(dm_err <= DM_TOL, f"retrieval: distance_matrix ip at "
          f"{tuple(q_d.shape)} x {tuple(cands_d.shape)}: error {dm_err} of "
          f"the scale > {DM_TOL}")
    top_k, top_r = ops.topk(D_k, RETRIEVAL_K), port["ref"].topk_ref(
        D_k, RETRIEVAL_K)
    torch.cuda.synchronize()
    check(torch.equal(top_k[0], top_r[0]) and torch.equal(top_k[1], top_r[1]),
          f"retrieval: topk = plain at k={RETRIEVAL_K} over "
          f"{D_k.shape[1]} columns (values and ids)")
    check(torch.equal(dists, top_k[0]) and torch.equal(ids, top_k[1]),
          "retrieval_score = the distance matrix's top-k")
    out["retrieval_D"] = D_k  # 4 MB, timed in phase 5
    out["retrieval_inputs"] = (q_d, cands_d)  # B.5 timed there too
    del top_k, top_r
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    plain_d, plain = R.retrieval_score(torch.from_numpy(q),
                                       torch.from_numpy(cands), k=RETRIEVAL_K)
    plain, plain_d = plain.numpy(), plain_d.numpy()
    ip64 = cands.astype(np.float64) @ q[0].astype(np.float64)
    qn = float(np.linalg.norm(q[0].astype(np.float64)))
    # the j-th best score of two versions differs by at most the largest
    # error over the rows in either top list
    xn = np.linalg.norm(cands[np.union1d(ids, plain)].astype(np.float64),
                        axis=1).max()
    dist_gap = float(np.abs(dists.astype(np.float64) - plain_d).max()
                     / (DM_TOL * qn * xn))
    check(dist_gap <= 1.0, f"retrieval: scores differ from the CPU plain "
          f"scan's by {dist_gap} x DM_TOL of the scale")
    worst = 0.0
    for b, j in zip(*np.nonzero(plain != ids)):
        a, c = int(ids[b, j]), int(plain[b, j])
        xn = max(float(np.linalg.norm(cands[r].astype(np.float64)))
                 for r in (a, c))
        gap = abs(ip64[a] - ip64[c]) / (DM_TOL * qn * xn)
        worst = max(worst, gap)
        check(gap <= 1.0, f"retrieval: id {a} at ({b}, {j}) differs from "
              f"the CPU plain scan's {c} by more than a near tie")
    lat = _serve_latency(
        lambda: R.retrieval_score(q_d, cands_d, k=RETRIEVAL_K)[1].cpu(),
        SERVE_STEPS)
    lat.update(n=rc["n_candidates"], dim=D, k=RETRIEVAL_K,
               setup_s=setup_s, plain_agreement=_agreement(ids, plain),
               worst_gap=worst, dist_gap=dist_gap, dm_scaled_err=dm_err,
               launches=n, profile=profile_call(
                   lambda: R.retrieval_score(q_d, cands_d,
                                             k=RETRIEVAL_K)[1].cpu(),
                   port["kernel_names"]))
    out["record"]["retrieval"] = lat
    print(f"recsys, retrieval_score: {json.dumps(lat)}", flush=True)
    return out


# ------------------------------------------------------------ phase 5


# gather-distance timing: 100 calls, each drawing its ids afresh over a
# table of this many rows (614 MB at d = 768, twelve times the H100's
# 50 MB L2), so each call's rows come from HBM as its bound assumes
COLD_ROWS = 200_000
COLD_CALLS = 100


def time_kernels(port, shape: Shape, dev, rng, launches, err) -> list:
    ops, ref = port["ops"], port["ref"]
    d_, B, K = shape.dim, shape.batch, shape.degree
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    big = torch.randn((COLD_ROWS, d_), generator=gen, device=dev)
    cold = [gd_inputs(rng, COLD_ROWS, shape, K, dev)
            for _ in range(COLD_CALLS)]
    # the tier-2 slab of the query path (2,500 rows, 7.7 MB): repeated
    # calls on it read from L2, as the hops of a search mostly do
    slab = torch.from_numpy(rng.standard_normal(
        (shape.cache, d_)).astype(np.float32)).to(dev)
    ids, Q = gd_inputs(rng, shape.cache, shape, K, dev)
    rows = []

    def gd_row(name, replaces, fn, plain, pick):
        # bytes: each distinct needed row, each query and each id read
        # once, each dist written once; l2 does a sub, a mul and an add
        # per element of every valid id; both averaged over the calls
        n_bytes = n_ops = 0.0
        for c_ids, c_Q in cold:
            i, q = pick(c_ids, c_Q)
            valid = i[i >= 0]
            n_rows = int(torch.unique(valid).numel())
            n_bytes += (n_rows + q.numel() // d_) * d_ * 4 + i.numel() * 8
            n_ops += 3 * int(valid.numel()) * d_
        t, by = bound_ms(n_bytes / COLD_CALLS, n_ops / COLD_CALLS)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/gather_distance.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=err[name],
            ms=device_ms([lambda a=a: fn(big, *pick(*a)) for a in cold]),
            plain_ms=device_ms([lambda a=a: plain(big, *pick(*a))
                                for a in cold]),
            bound_ms=t, bound_by=by, library_ms=None,
            l2_ms=device_ms([lambda: fn(slab, *pick(ids, Q))] * COLD_CALLS),
            call_ms=call_ms(lambda: fn(slab, *pick(ids, Q))),
            plain_call_ms=call_ms(lambda: plain(slab, *pick(ids, Q))),
        ))

    gd_row("gather_distance_batch",
           "src/repro/kernels/gather_distance.py:103",
           lambda t, i, q: ops.gather_distance_batch(t, i, q, "l2"),
           lambda t, i, q: ref.gather_distance_batch_ref(t, i, q, "l2"),
           lambda i, q: (i, q))
    gd_row("gather_distance", "src/repro/kernels/gather_distance.py:44",
           lambda t, i, q: ops.gather_distance(t, i, q, "l2"),
           lambda t, i, q: ref.gather_distance_ref(t, i, q, "l2"),
           lambda i, q: (i[0], q[0]))
    rows.append(time_merge(port, shape, dev, rng, launches, err))
    return rows


def time_merge(port, shape: Shape, dev, rng, launches, err) -> dict:
    """B.2 at the batched driver's per-hop beam merge, (32, ef + degree),
    k = ef, on tie-heavy rows (``merge_inputs``, kept as the row earlier
    versions of the kernel were timed on);
    and at the beam merge's own rows (``path_merge_inputs``) a hop, a load
    phase and at B = 1, each beside ``torch.topk`` on the same distances
    (a yardstick only: it has no id dedup and no sentinel rule); and the
    wide variant (runs of 256 merged by rank) at tie-heavy (32, 1,000)
    to k = ef and at the widest row it takes, (2, ``MAX_CANDIDATES``) to
    16; and at the rows a filter's wider beam sends
    (``filter_merge_shapes``, M > 256: the wide variant on the query
    path) and a filtered finalize's (a (B, 256) beam, half denied, to
    k = 10), each beside ``torch.topk``. Inputs are L2-resident, as on
    the query path, where the merge reads the row the hop has just
    written."""
    ops, ref = port["ops"], port["ref"]
    B, k = shape.batch, shape.ef

    def bound(B, M, k=k):  # bytes: (dist, id) read once, (dist, id, src)
        # written; operations: what a selection with a dedup needs, a
        # compare of each entry's key and a test of its id (below the
        # bytes at every row)
        return bound_ms(B * M * 8 + B * k * 12, 2 * B * M)

    def timed(d, i, k=k):
        return dict(
            ms=device_ms([lambda: ops.merge_topk(d, i, k)] * 100),
            library_ms=device_ms(
                [lambda: torch.topk(d, k, dim=1, largest=False)] * 100),
            bound_ms=bound(*d.shape, k)[0])

    Mm = shape.ef + shape.degree
    d, i = merge_inputs(rng, B, Mm, dev)
    t, by = bound(B, Mm)
    path = {}
    for b_, m_ in ((B, Mm), (B, shape.ef + shape.miss_cap), (1, Mm)):
        path[f"{b_}x{m_}"] = timed(*path_merge_inputs(rng, b_, m_, shape.ef,
                                                      dev))
    wide = merge_inputs(rng, B, 1_000, dev)
    widest = merge_inputs(rng, 2, port["topk"].MAX_CANDIDATES, dev)
    filt = {f"{b_}x{m_}_k{k_}": timed(*path_merge_inputs(rng, b_, m_, k_,
                                                          dev), k_)
            for b_, m_, k_ in filter_merge_shapes(shape)}
    for b_ in (B, 1):
        filt[f"finalize_{b_}x256_k{shape.k}"] = timed(
            *finalize_inputs(rng, b_, 256, dev), shape.k)
    return dict(
        name="merge_topk", route="cuda",
        source="src/repro_torch/csrc/merge_topk.cu",
        replaces="src/repro/kernels/topk.py:139",
        launches=launches["merge_topk"],
        max_abs_err=err["merge_topk"],
        ms=device_ms([lambda: ops.merge_topk(d, i, k)] * 100),
        plain_ms=device_ms([lambda: ref.merge_topk_ref(d, i, k)] * 100),
        bound_ms=t, bound_by=by,
        library_ms=device_ms(
            [lambda: torch.topk(d, k, dim=1, largest=False)] * 100),
        call_ms=call_ms(lambda: ops.merge_topk(d, i, k)),
        plain_call_ms=call_ms(lambda: ref.merge_topk_ref(d, i, k)),
        path=path, wide_shape=[B, 1_000], wide=timed(*wide),
        widest_shape=[2, port["topk"].MAX_CANDIDATES, 16],
        widest=timed(*widest, 16), filter=filt,
    )


def time_dequant_kernels(port, shape: Shape, dev, rng, launches,
                         err) -> list:
    """The dequant kernel's two forms at the path's shapes: the batched
    form at a hop (32 queries × 32 ids), the single form at a fused bulk
    load (1 × miss_cap). ``ms``, ``plain_ms`` and the bound are int8,
    HBM-cold (100 calls, each drawing its ids afresh over a 200,000-row
    table, 154 MB int8 and 307 MB float16, several times the 50 MB L2);
    ``l2_ms`` repeats one call on a table the size the path reads (the
    2,500-row slab, the 10,000-row payload), which stays in L2; the
    ``f16_*`` keys are the same at float16."""
    ops, ref = port["ops"], port["ref"]
    d_ = shape.dim
    rows = []
    for name, replaces, B, K, path_rows in (
            ("dequant_gather_distance_batch",
             "src/repro/kernels/dequant_gather_distance.py:112",
             shape.batch, shape.degree, shape.cache),
            ("dequant_gather_distance",
             "src/repro/kernels/dequant_gather_distance.py:49",
             1, shape.miss_cap, shape.n)):
        fn = getattr(ops, name)
        plain = getattr(ref, name + "_ref")
        if B == 1:
            def pick(i, q):
                return i[0], q[0]
        else:
            def pick(i, q):
                return i, q
        cold = [gd_inputs(rng, COLD_ROWS, shape, K, dev)
                for _ in range(COLD_CALLS)]
        ids, Q = gd_inputs(rng, path_rows, shape, K, dev)
        row = dict(name=name, route="cuda",
                   source="src/repro_torch/csrc/dequant_gather_distance.cu",
                   replaces=replaces, launches=launches[name],
                   max_abs_err=err[name], library_ms=None)
        for precision in QUANT:
            big, big_s = quantized_table(port, rng, COLD_ROWS, d_, precision,
                                         dev)
            tab, tab_s = quantized_table(port, rng, path_rows, d_, precision,
                                         dev)
            row_bytes = d_ + 4 if precision == "int8" else 2 * d_
            # bytes: each distinct needed row, each query and each id read
            # once, each dist written once; l2 does a dequant multiply, a
            # sub, a mul and an add per element of every valid id
            n_bytes = n_ops = 0.0
            for c_ids, c_Q in cold:
                i, q = pick(c_ids, c_Q)
                valid = i[i >= 0]
                n_rows = int(torch.unique(valid).numel())
                n_bytes += (n_rows * row_bytes + (q.numel() // d_) * d_ * 4
                            + i.numel() * 8)
                n_ops += 4 * int(valid.numel()) * d_
            t, by = bound_ms(n_bytes / COLD_CALLS, n_ops / COLD_CALLS)
            prefix = "" if precision == "int8" else "f16_"
            row.update({
                prefix + "ms": device_ms(
                    [lambda a=a: fn(big, big_s, *pick(*a)) for a in cold]),
                prefix + "plain_ms": device_ms(
                    [lambda a=a: plain(big, big_s, *pick(*a))
                     for a in cold]),
                prefix + "bound_ms": t, prefix + "bound_by": by,
                prefix + "l2_ms": device_ms(
                    [lambda: fn(tab, tab_s, *pick(ids, Q))] * COLD_CALLS),
                prefix + "call_ms": call_ms(
                    lambda: fn(tab, tab_s, *pick(ids, Q))),
            })
            del big, big_s
        rows.append(row)
    return rows


# hop-step timing: calls of one step on one state, captured in a graph
HOP_TIMED_CALLS = 100


def hop_work(Q, nbrs, state, tier2, out, active) -> tuple:
    """(bytes, operations) one hop step must move and do on these inputs:
    each input read and each output written once (the visited rows, the
    beam, L, the counters, ``active``, the queries), and for the active
    queries their neighbour rows, a slot_of and an id_of entry a fresh
    neighbour (with a cache) and each distinct usable tier-2 row once;
    l2's sub, mul and add per element of every usable row."""
    B, W = state.visited.shape
    ef, cap, d = state.beam.ef, state.miss_ids.shape[1], Q.shape[1]
    n_bytes = (2 * B * W + 2 * B * ef * 9 + 2 * B * cap * 4 + 2 * 3 * 8 * B
               + B + B * d * 4 + int(active.sum()) * nbrs.shape[1] * 4)
    fresh = (out.visited & ~state.visited).nonzero()[:, 1].to(torch.int32)
    present, slots = tier2.slots(fresh)
    table = tier2.table
    row_bytes = table.shape[1] * table.element_size() + (
        4 if tier2.scales is not None else 0)
    n_bytes += int(torch.unique(slots[present]).numel()) * row_bytes
    if tier2.cache is not None:
        n_bytes += 8 * int(fresh.numel())
    n_use = int((out.n_dist - state.n_dist).sum())
    return n_bytes, 3 * d * n_use


def time_hop_step(port, shape: Shape, X, graph, dev, rng, launches,
                  err) -> dict:
    """B.8 beside the per-op step it replaces (its plain version on the
    card: B.1 or B.3 and B.2 around PyTorch ops), device time a call from
    HOP_TIMED_CALLS calls on one state captured in a CUDA graph: at
    float32, int8 and float16 over a full 2,500-row tier 2 of the corpus,
    at B = 32 and 1, on layer 0 (ef 64, its 32-wide rows) and an upper
    layer (ef 1, layer 1's rows cut to their 16 real columns), each with
    its bound from this state's own work. The row's ``ms``, ``plain_ms``
    and bound are float32 layer 0 at B = 32. Then the device kernels of
    one replayed hop step (``replayed_step_kernels``)."""
    S = port["search"]
    nbrs = np.asarray(graph.neighbors, np.int32)
    check(bool((nbrs[1, :, 16:] == -1).all()),
          "upper-layer rows hold at most 16 neighbours")
    layers = {"layer0": (shape.ef, nbrs[0]),
              "upper": (1, np.ascontiguousarray(nbrs[1, :, :16]))}
    Qn = make_queries(X, shape.batch, seed=21)
    shapes = {}
    for precision in PRECISIONS:
        tier2 = hop_tier2(port, X, precision, True, rng, shape.cache, dev)
        for name, (ef, rows) in layers.items():
            N_ = torch.as_tensor(rows, device=dev)
            for B in (shape.batch, 1):
                Qt = torch.as_tensor(Qn[:B], device=dev)
                for _ in range(20):  # a single query that is active
                    st = hop_state(S, rng, X, Qn[:B], rows, ef,
                                   ef + rows.shape[1] + 1, ef, 100_000, "l2",
                                   dev)
                    out, active = S.batch_hop_step(Qt, N_, st, tier2, "l2",
                                                   ef)
                    if bool(active.any()):
                        break
                t, by = bound_ms(*hop_work(Qt, N_, st, tier2, out, active))
                shapes[f"{precision}_{name}_B{B}"] = dict(
                    ef=ef, degree=int(rows.shape[1]),
                    active=int(active.sum()),
                    usable=int((out.n_dist - st.n_dist).sum()),
                    ms=device_ms([lambda: S.batch_hop_step(
                        Qt, N_, st, tier2, "l2", ef)] * HOP_TIMED_CALLS),
                    per_op_ms=device_ms([lambda: S.batch_hop_step_plain(
                        Qt, N_, st, tier2, "l2", ef)] * HOP_TIMED_CALLS),
                    bound_ms=t, bound_by=by)
    main = shapes[f"float32_layer0_B{shape.batch}"]
    split = hop_step_split(port, shape, X, graph, dev, rng)
    return dict(
        name="hop_step", route="cuda",
        source="src/repro_torch/csrc/hop_step.cu",
        replaces=("src/repro/core/search.py:240 (no TPU kernel: the "
                  "reference's hop step, a lax.while_loop body that XLA "
                  "fuses)"),
        launches=launches["hop_step"], max_abs_err=err["hop_step"],
        ms=main["ms"], plain_ms=main["per_op_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, shapes=shapes, split=split,
        replayed_step_kernels=replayed_step_kernels(port, shape, X, graph,
                                                    dev, rng))


# stamped steps a split is averaged over, after as many warm-up steps
SPLIT_CALLS = 50


def hop_step_split(port, shape: Shape, X, graph, dev, rng) -> dict:
    """Where a float32 step's time goes: the kernel's timing instantiation
    (``hop_step.hop_step_stamps_cuda``) stamps the SM clock at its stage
    boundaries (``hop_step.STAMPS``); over SPLIT_CALLS steps on one state,
    each boundary's cycles after the block's start, the mean over the
    active queries' blocks and the mean of the slowest block's, also in
    µs at the SM clock measured here (``sm_cycles_per_ns``). Beside it the
    launch floor: an empty kernel on the step's grid, device time a call
    as ``device_ms`` times the step. At layer 0 (ef 64, degree 32) and an
    upper layer (ef 1, degree 16), B = 32 and 1, over a full cached tier
    2."""
    S, hs = port["search"], port["hop_step"]
    nbrs = np.asarray(graph.neighbors, np.int32)
    layers = {"layer0": (shape.ef, nbrs[0]),
              "upper": (1, np.ascontiguousarray(nbrs[1, :, :16]))}
    Qn = make_queries(X, shape.batch, seed=23)
    tier2 = hop_tier2(port, X, "float32", True, rng, shape.cache, dev)
    cache = tier2.cache
    out = {"stages": list(hs.STAMPS)}
    for name, (ef, rows) in layers.items():
        N_ = torch.as_tensor(rows, device=dev)
        for B in (shape.batch, 1):
            Qt = torch.as_tensor(Qn[:B], device=dev)
            for _ in range(20):  # a state with an active query
                st = hop_state(S, rng, X, Qn[:B], rows, ef,
                               ef + rows.shape[1] + 1, ef, 100_000, "l2",
                               dev)
                args = (Qt, N_, *(t.contiguous()
                                  for t in S._state_tensors(st)),
                        tier2.table, None, cache.slot_of, cache.id_of, "l2",
                        ef, 100_000)
                if bool(hs.hop_step_stamps_cuda(*args)[8].any()):
                    break
            stamps = []
            for i in range(2 * SPLIT_CALLS):
                got = hs.hop_step_stamps_cuda(*args)
                if i >= SPLIT_CALLS:
                    stamps.append(got[9][got[8]])
            st_ = torch.stack(stamps).double()  # (calls, active, stages)
            rel = st_ - st_[..., :1]
            per_ns = hs.sm_cycles_per_ns(dev)
            mean = rel.mean((0, 1)).tolist()
            slowest = rel.amax(1).mean(0).tolist()
            out[f"{name}_B{B}"] = dict(
                ef=ef, degree=int(rows.shape[1]), active=int(st_.shape[1]),
                cycles=mean, slowest_cycles=slowest,
                us=[c / per_ns / 1e3 for c in mean],
                slowest_us=[c / per_ns / 1e3 for c in slowest],
                sm_ghz=per_ns,
                launch_floor_ms=device_ms(
                    [lambda: hs.launch_floor_cuda(B, dev)] * HOP_TIMED_CALLS),
                step_ms=device_ms([lambda: S.batch_hop_step(
                    Qt, N_, st, tier2, "l2", ef)] * HOP_TIMED_CALLS))
    return out


# CUgraphNodeType (cuda.h)
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 10: "mem_alloc", 11: "mem_free",
                    13: "conditional"}


def graph_nodes(g) -> dict:
    """Nodes of a captured CUDA graph (kept: ``keep_graph=True``) by kind,
    read from the graph itself (libcuda's cuGraphGetNodes and
    cuGraphNodeGetType)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes")
    counts, kind = {}, ctypes.c_int(0)
    for node in nodes:
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType")
        name = GRAPH_NODE_KINDS.get(kind.value, str(kind.value))
        counts[name] = counts.get(name, 0) + 1
    return counts


def replayed_step_kernels(port, shape: Shape, X, graph, dev, rng) -> dict:
    """The device work of one replayed hop step, through B.8 and through
    the per-op step: K = STEPS_PER_SYNC steps of layer 0 at B = 32
    captured as ``step_graph`` captures a phase's steps (a warm-up block,
    K unrolled steps, the carry copied back), counted two ways: the
    graph's own nodes by kind (``graph_nodes``), and one replay under
    torch.profiler (its device kernels and copies); each over K, at
    float32, int8 and float16."""
    from torch.profiler import ProfilerActivity, profile

    S, sg = port["search"], port["step_graph"]
    K = S.STEPS_PER_SYNC
    nbrs0 = torch.as_tensor(np.asarray(graph.neighbors[0], np.int32),
                            device=dev)
    Qn = make_queries(X, shape.batch, seed=22)
    Qt = torch.as_tensor(Qn, device=dev)
    out = {}
    for precision in PRECISIONS:
        tier2 = hop_tier2(port, X, precision, True, rng, shape.cache, dev)
        st = hop_state(S, rng, X, Qn, graph.neighbors[0], shape.ef,
                       shape.miss_cap, shape.ef, 100_000, "l2", dev)
        rec = {}
        for route, fn in (("hop_step", S.batch_hop_step),
                          ("per_op", S.batch_hop_step_plain)):
            def step(carry, consts, fn=fn):
                s, active = fn(consts[0], nbrs0, S._state_of(carry), tier2,
                               "l2", shape.ef)
                return S._state_tensors(s), active

            carry, _ = sg._warm(step, S._state_tensors(st), [Qt], K)
            s_carry = [torch.empty_like(t) for t in carry]
            s_Q = torch.empty_like(Qt)
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(g):
                new, more = sg._block(step, s_carry, [s_Q], K)
                for dst, src in zip(s_carry, new):
                    dst.copy_(src)
            g.instantiate()
            nodes = graph_nodes(g)
            for _ in range(2):  # a warm replay, then the profiled one
                for dst, src in zip(s_carry + [s_Q], carry + [Qt]):
                    dst.copy_(src)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    g.replay()
                    torch.cuda.synchronize()
            names = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
            copies = [n for n in names if n.startswith(("Memcpy", "Memset"))]
            rec[route] = dict(
                graph_kernels_per_step=nodes.get("kernel", 0) / K,
                graph_nodes=nodes,
                profiled_kernels_per_step=(len(names) - len(copies)) / K,
                profiled_copies_per_replay=len(copies), steps_per_replay=K,
                profiled_kernel_names=sorted(set(names) - set(copies))[:12])
            del g
        out[precision] = rec
    return out


# ADC timing: each call draws its tables and ids afresh, so its tables
# come from HBM as the bound assumes: 100 batched calls read 630 MB of
# tables; the single form's tables are 192 KiB, so it takes 600 calls
# (115 MB, twice the L2). The codes table has a million rows (192 MB).
ADC_COLD_ROWS = 1_000_000
ADC_SINGLE_CALLS = 600
ADC_PLAIN_CALLS = 20  # the plain version is ~200 launches a call


def adc_bytes(codes: torch.Tensor, luts: torch.Tensor,
              ids: torch.Tensor) -> int:
    """The bytes one ADC call must move: of each query's tables, only the
    32-byte sectors (8 entries of a 256-entry row) that its valid ids'
    codes select; each distinct code row; each id read and each distance
    written once. The kernel reads these entries and rows, no whole
    table."""
    B, L, M, K = luts.shape
    valid = ids >= 0
    q = torch.arange(B, device=ids.device)[:, None].expand_as(ids)[valid]
    rows = ids[valid].long()
    sub = torch.arange(M, device=ids.device)
    sector = (q[:, None] * M + sub) * (K // 8) + (codes[rows].long() >> 3)
    return (int(torch.unique(sector).numel()) * 32 * L
            + int(torch.unique(rows).numel()) * M + ids.numel() * 8)


def time_adc_kernels(port, shape: Shape, dev, rng, launches, err) -> list:
    """The ADC kernel's two forms at M = 192, l2, at the path's shapes:
    the batched form at a hop (32 queries × 32 ids), the single form at
    a fused bulk load (1 × miss_cap), HBM-cold as above; ``l2_ms``
    repeats one call on path-sized tables (the 2,500-row slab, the
    10,000-row payload), which stay in L2."""
    ops, ref, pq = port["ops"], port["ref"], port["pq"]
    M = PQ_SUBSPACES
    cent = torch.from_numpy(rng.standard_normal(
        (M, 256, shape.dim // M)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    big = torch.randint(0, 256, (ADC_COLD_ROWS, M), generator=gen,
                        device=dev, dtype=torch.uint8)
    rows = []
    for name, replaces, B, K, path_rows, n_calls in (
            ("adc_gather_distance_batch",
             "src/repro/kernels/adc_gather_distance.py:123",
             shape.batch, shape.degree, shape.cache, COLD_CALLS),
            ("adc_gather_distance",
             "src/repro/kernels/adc_gather_distance.py:71",
             1, shape.miss_cap, shape.n, ADC_SINGLE_CALLS)):
        fn = getattr(ops, name)
        plain = getattr(ref, name + "_ref")
        calls = []
        for _ in range(n_calls):
            ids, Q = gd_inputs(rng, ADC_COLD_ROWS, shape, K, dev)
            ids, Q = ids[:B].contiguous(), Q[:B].contiguous()
            calls.append((pq.build_lut(Q, cent, "l2"), ids))

        def pick(luts, ids, B=B):
            return (luts, ids) if B > 1 else (luts[0], ids[0])

        # one add per subspace of every valid id
        n_bytes = n_ops = 0.0
        for luts, ids in calls:
            n_bytes += adc_bytes(big, luts, ids)
            n_ops += int((ids >= 0).sum()) * M
        t, by = bound_ms(n_bytes / n_calls, n_ops / n_calls)
        path_codes = big[:path_rows]
        luts0, ids0 = calls[0]
        ids0 = ids0.clamp(max=path_rows - 1)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/adc_gather_distance.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=err[name],
            ms=device_ms([lambda c=c: fn(big, *pick(*c), "l2")
                          for c in calls]),
            plain_ms=device_ms([lambda c=c: plain(big, *pick(*c), "l2")
                                for c in calls[:ADC_PLAIN_CALLS]], replays=2),
            bound_ms=t, bound_by=by,
            # no single PyTorch call computes an ADC sum
            library_ms=None,
            l2_ms=device_ms([lambda: fn(path_codes, *pick(luts0, ids0),
                                        "l2")] * COLD_CALLS),
            call_ms=call_ms(lambda: fn(path_codes, *pick(luts0, ids0),
                                       "l2")),
            M=M, tables_mb_per_call=calls[0][0].numel() * 4 / 1e6,
        ))
        del calls
    return rows


FLAT_TIMED_BATCHES = 30
# the top-k timings rotate over this many (32, 480000) matrices (61 MB
# each, 184 MB together against the 50 MB L2), so each call reads HBM
TOPK_COLD_MATRICES = 3


def time_flat_kernels(port, shape: Shape, shard, X, D_ret, ret_inputs, dev,
                      launches, err) -> list:
    """B.5 at the scan's shape (32, 480000, 768), l2, HBM-cold by size
    (the table is 1.47 GB), and at retrieval's (1, 1000000, 64), ip, on
    its own query and candidates ``ret_inputs`` (256 MB, five times the
    L2), each beside its bound, its plain version and
    ``torch.matmul(Q, X.T)`` in full float32 (TF32 off: the ip form but
    for the sign, the arithmetic of every metric); then B.6
    (:func:`time_topk`) over TOPK_COLD_MATRICES distance matrices of the
    scan and retrieval's ``D_ret``."""
    ops, ref = port["ops"], port["ref"]
    torch.backends.cuda.matmul.allow_tf32 = False
    table = shard.vectors
    N, d = table.shape
    B, k = shape.batch, shape.k
    mats = [torch.from_numpy(make_queries(X, B, seed=700 + i)).to(dev)
            for i in range(3)]

    def dm_bound(B, N, d):
        # bytes: Q, X read once, the (B, N) output written once;
        # operations: the 2·B·N·d of the product, the norms 2·(B + N)·d,
        # 3 an output
        return bound_ms((B * d + N * d + B * N) * 4,
                        2 * B * N * d + 2 * (B + N) * d + 3 * B * N)

    t, by = dm_bound(B, N, d)
    q_r, cands = ret_inputs
    t_r, by_r = dm_bound(q_r.shape[0], *cands.shape)
    ret_calls = 20
    rows = [dict(
        name="distance_matrix", route="cuda",
        source="src/repro_torch/csrc/distance_matrix.cu",
        replaces="src/repro/kernels/distance.py:68",
        launches=launches["distance_matrix"],
        max_abs_err=err["distance_matrix"],
        ms=device_ms([lambda q=q: ops.distance_matrix(q, table, "l2")
                      for q in mats], replays=3),
        plain_ms=device_ms([lambda q=q: ref.distance_matrix_ref(q, table,
                                                                "l2")
                            for q in mats], replays=3),
        bound_ms=t, bound_by=by,
        library_ms=device_ms([lambda q=q: torch.matmul(q, table.T)
                              for q in mats], replays=3),
        shape=[B, N, d], max_scaled_err=err["distance_matrix_scaled"],
        tf32=torch.backends.cuda.matmul.allow_tf32,
        retrieval=dict(
            shape=[q_r.shape[0], *cands.shape], metric="ip",
            ms=device_ms([lambda: ops.distance_matrix(q_r, cands, "ip")]
                         * ret_calls),
            plain_ms=device_ms([lambda: ref.distance_matrix_ref(
                q_r, cands, "ip")] * ret_calls),
            library_ms=device_ms([lambda: torch.matmul(q_r, cands.T)]
                                 * ret_calls),
            bound_ms=t_r, bound_by=by_r),
    )]
    Ds = [ops.distance_matrix(q, table, "l2")
          for q in mats[:TOPK_COLD_MATRICES]]
    rows.append(time_topk(port, shape, Ds, D_ret, dev, launches, err))
    return rows


def time_topk(port, shape: Shape, Ds, D_ret, dev, launches, err) -> dict:
    """B.6 at the flat scan's (32, 480000), k = 10, over the scan's
    distance matrices ``Ds`` (HBM-cold by rotation), at the global
    reduce's (32, S·k = 10), at the cap k = 128, and at retrieval's
    (1, 1,000,000), k = 100, over its own ip matrix ``D_ret`` (L2-resident,
    as B.5 has just written it on the path); each beside its bound, its
    plain version and ``torch.topk(D, k, largest=False)`` (no tie
    promise), with the merge levels the kernel runs there."""
    ops, ref = port["ops"], port["ref"]
    B, k = shape.batch, shape.k
    N = Ds[0].shape[1]
    levels = port["topk"].topk_levels
    small = torch.from_numpy(np.round(np.random.default_rng(3).random(
        (B, k)), 2).astype(np.float32)).to(dev)
    # bytes: the matrix read once, (dist, id) written; one ordered compare
    # an element
    t, by = bound_ms(B * N * 4 + B * k * 8, B * N)
    t_r, by_r = bound_ms(B * k * 4 + B * k * 8, B * k)
    Br, Nr = D_ret.shape
    kr = RETRIEVAL_K
    t_ret, by_ret = bound_ms(Br * Nr * 4 + Br * kr * 8, Br * Nr)
    return dict(
        name="topk", route="cuda", source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk.py:55",
        launches=launches["topk"], max_abs_err=err["topk"],
        ms=device_ms([lambda D=D: ops.topk(D, k) for D in Ds * 4]),
        plain_ms=device_ms([lambda D=D: ref.topk_ref(D, k) for D in Ds],
                           replays=2),
        bound_ms=t, bound_by=by,
        library_ms=device_ms([lambda D=D: torch.topk(D, k, largest=False)
                              for D in Ds * 4]),
        shape=[B, N], k=k, levels=levels(N),
        reduce_ms=device_ms([lambda: ops.topk(small, k)] * 100),
        reduce_plain_ms=device_ms([lambda: ref.topk_ref(small, k)] * 100),
        reduce_library_ms=device_ms(
            [lambda: torch.topk(small, k, largest=False)] * 100),
        reduce_bound_ms=t_r, reduce_bound_by=by_r,
        reduce_levels=levels(k),
        cap_k=port["topk_max_k"],
        cap_ms=device_ms([lambda D=D: ops.topk(D, port["topk_max_k"])
                          for D in Ds]),
        retrieval=dict(
            shape=[Br, Nr], k=kr, levels=levels(Nr),
            ms=device_ms([lambda: ops.topk(D_ret, kr)] * 20),
            plain_ms=device_ms([lambda: ref.topk_ref(D_ret, kr)] * 20),
            library_ms=device_ms(
                [lambda: torch.topk(D_ret, kr, largest=False)] * 20),
            bound_ms=t_ret, bound_by=by_ret),
    )


# B.7 timing: each call draws its bags afresh over the 256 MB table (five
# times the L2), so its rows come from HBM as the bound assumes
BAG_COLD_CALLS = {512: 100, 262_144: 4}


def bag_bytes(idx: torch.Tensor) -> int:
    """The bytes one bag call must move: each distinct valid row once,
    the ids read and the (B, d) float32 output written once."""
    n_rows = int(torch.unique(idx[idx >= 0]).numel())
    return n_rows * BAG_DIM * 4 + idx.numel() * 4 + idx.shape[0] * BAG_DIM * 4


def time_embedding_bag(port, table, dev, launches, err) -> list:
    """B.7 at serve_p99's batch (the row's ``ms``) and serve_bulk's
    (``bulk_*``), HBM-cold, beside its bound, its plain version and one
    PyTorch call on the same inputs: ``F.embedding_bag(idx.clamp(min=0),
    table, mode="sum", per_sample_weights=(idx >= 0).float())`` with the
    clamp and the mask made before the timed calls."""
    import torch.nn.functional as Fn

    ops, ref = port["ops"], port["ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    row = dict(name="embedding_bag", route="cuda",
               source="src/repro_torch/csrc/embedding_bag.cu",
               replaces="src/repro/kernels/embedding_bag.py:41",
               launches=launches["embedding_bag"],
               max_abs_err=err["embedding_bag"])
    for B, n_calls in BAG_COLD_CALLS.items():
        calls = [bag_ids(gen, B, dev) for _ in range(n_calls)]
        lib_in = [(i.clamp(min=0), (i >= 0).float()) for i in calls]
        n_bytes = sum(bag_bytes(i) for i in calls) / n_calls
        # one add a column of every valid slot
        n_ops = sum(int((i >= 0).sum()) for i in calls) * BAG_DIM / n_calls
        t, by = bound_ms(n_bytes, n_ops)
        prefix = "" if B == 512 else "bulk_"
        row.update({
            prefix + "ms": device_ms(
                [lambda i=i: ops.embedding_bag(table, i) for i in calls]),
            prefix + "plain_ms": device_ms(
                [lambda i=i: ref.embedding_bag_ref(table, i)
                 for i in calls[:20]], replays=2),
            prefix + "bound_ms": t, prefix + "bound_by": by,
            prefix + "library_ms": device_ms(
                [lambda a=a: Fn.embedding_bag(a[0], table, mode="sum",
                                              per_sample_weights=a[1])
                 for a in lib_in]),
            prefix + "shape": [B, BAG_SLOTS, BAG_DIM],
            prefix + "mb_moved": n_bytes / 1e6,
        })
        # the library sums in its own order: its distance from the kernel
        lib = Fn.embedding_bag(lib_in[0][0], table, mode="sum",
                               per_sample_weights=lib_in[0][1])
        row[prefix + "library_max_abs_diff"] = float(
            (lib - ops.embedding_bag(table, calls[0])).abs().max())
        del calls, lib_in, lib
    return [row]


def time_flat_scan(port, shape: Shape, shard, X) -> dict:
    """The flat scan end to end at world size 1 over NCCL: p50/p99 over
    FLAT_TIMED_BATCHES batches of 32 fresh queries (host clock; results
    copied back, so each search has finished), queries/s, and the device's
    idle share over one search under torch.profiler."""
    D, mesh = port["distributed"], port["mesh"]
    group = mesh.make_shard_group(1, device="cuda",
                                  init_method=rendezvous("flat_timing"),
                                  rank=0)
    try:
        search = D.distributed_brute_force(group, metric="l2", k=shape.k)
        batches = [make_queries(X, shape.batch, seed=500 + i)
                   for i in range(FLAT_TIMED_BATCHES + 2)]
        for q in batches[:2]:  # warm-up
            search(q, shard)[1].cpu()
        lat = []
        for q in batches[2:]:
            t0 = time.perf_counter()
            search(q, shard)[1].cpu()
            lat.append(time.perf_counter() - t0)
        out = _latency(lat)
        out["qps"] = shape.batch * 1e3 / out["mean_ms"]
        out["profile"] = profile_call(
            lambda: search(batches[0], shard)[1].cpu(), port["kernel_names"])
    finally:
        mesh.destroy_shard_group()
    return out


def _latency(lat_s) -> dict:
    lat = np.asarray(lat_s) * 1e3
    return dict(n=len(lat), p50_ms=float(np.percentile(lat, 50)),
                p90_ms=float(np.percentile(lat, 90)),
                p99_ms=float(np.percentile(lat, 99)),
                mean_ms=float(lat.mean()))


def _timed_searches(port, shape: Shape, X, eng, kind: str, n: int,
                    seed: int):
    """``n`` searches on ``eng`` (batches of 32 fresh queries, or single
    queries), each timed on the host clock: results come back to the
    host, so each search has finished when it returns. Returns the
    latencies (s) and the tier-3 accesses they made."""
    E = port["engine"]
    lat, n_db = [], 0
    if kind == "batched":
        queries = [make_queries(X, shape.batch, seed=seed + i)
                   for i in range(n)]
    else:
        queries = list(make_queries(X, n, seed=seed))
    for q in queries:
        t0 = time.perf_counter()
        res = eng.search(E.SearchRequest(query=q, k=shape.k))
        lat.append(time.perf_counter() - t0)
        n_db += (res.batch_stats.n_db if kind == "batched"
                 else res.stats.n_db)
    return lat, n_db


def time_end_to_end(port, shape: Shape, X, engines: dict,
                    n_batches: int = 10, n_single: int = 32) -> dict:
    """Latency of each path's searches on the engine its query path left
    warm. ``engines`` maps a path name to ``(kind, engine)``. After a
    warm-up (one batch or four queries) each path is timed in two rounds
    of half its searches, the paths in order and then in reverse, so a
    drift of the host over the run falls on every path alike and the
    two rounds' medians show the spread within this machine. Tier 2
    keeps turning over: each round brings new queries."""
    out = {name: {"lat": [], "n_db": 0, "round_p50_ms": []}
           for name in engines}
    for name, (kind, eng) in engines.items():
        _timed_searches(port, shape, X, eng, kind,
                        1 if kind == "batched" else 4, seed=90)
    order = list(engines)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            kind, eng = engines[name]
            n = (n_batches if kind == "batched" else n_single) // 2
            lat, n_db = _timed_searches(port, shape, X, eng, kind, n,
                                        seed=100 + 1000 * rnd)
            o = out[name]
            o["lat"] += lat
            o["n_db"] += n_db
            o["round_p50_ms"].append(float(np.percentile(lat, 50)) * 1e3)
    for name, (kind, eng) in engines.items():
        o = out[name]
        lat, n_db, rounds = o.pop("lat"), o.pop("n_db"), o.pop("round_p50_ms")
        o.update(_latency(lat), round_p50_ms=rounds, kind=kind,
                 cache_bytes=eng.cache_bytes())
        per = shape.batch if kind == "batched" else 1
        o["qps"] = per * 1e3 / o["mean_ms"]
        o["n_db_per_query"] = n_db / (len(lat) * per)
    return out


def profile_batched(port, shape: Shape, X, eng) -> dict:
    """One batched search on ``eng`` under torch.profiler
    (:func:`profile_call`)."""
    E = port["engine"]
    Qr = make_queries(X, shape.batch, seed=300)
    return profile_call(lambda: eng.search(E.SearchRequest(query=Qr,
                                                           k=shape.k)),
                        port["kernel_names"])


# CUDA runtime and driver calls the profiler records on the host: what
# puts work on the card (kernel and graph launches, copies, fills)
HOST_CALLS = re.compile(
    r"^cu(da)?(LaunchKernel|GraphLaunch|MemcpyAsync|MemsetAsync)")
HOST_LAUNCHES = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch)")


def count_syncs(run) -> dict:
    """``run()`` with its host syncs counted: the implicit ones (a copy to
    the host, ``bool``/``int`` of a card tensor), which PyTorch's sync
    debug mode reports one warning each, and explicit
    ``torch.cuda.synchronize`` calls."""
    explicit = [0]
    real = torch.cuda.synchronize

    def counting(*args, **kw):
        explicit[0] += 1
        return real(*args, **kw)

    torch.cuda.synchronize = counting
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize = real
    implicit = sum("synchronizing" in str(w.message) for w in caught)
    return {"implicit": implicit, "explicit": explicit[0],
            "total": implicit + explicit[0]}


def search_costs(port, shape: Shape, X, eng, kind: str) -> dict:
    """One more search on a warm path (a fresh batch or query) under the
    profiler: host launches (kernel and graph), device busy and idle
    share; one more with its host syncs counted; the loop's host checks
    and graph replays over both."""
    # a tree from before the graph-replayed loop has no step_graph
    E, sg = port["engine"], port.get("step_graph")
    Qs = [make_queries(X, shape.batch, seed=seed) for seed in (700, 701)]
    if kind != "batched":
        Qs = [q[0] for q in Qs]
    if sg is not None:
        sg.reset_stats()
    prof = profile_call(
        lambda: eng.search(E.SearchRequest(query=Qs[0], k=shape.k)),
        port["kernel_names"])
    syncs = count_syncs(
        lambda: eng.search(E.SearchRequest(query=Qs[1], k=shape.k)))
    out = {"host_launches": prof["host_launches"],
           "runtime_calls": prof["runtime_calls"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_idle_share": prof["device_idle_share"],
           "profiled_wall_ms": prof["wall_ms"], "syncs": syncs}
    if sg is not None:
        out.update(loop_checks_2_searches=sg.stats["syncs"],
                   graph_replays_2_searches=sg.stats["replays"])
    return out


def profile_call(run, port_kernels) -> dict:
    """``run()`` under torch.profiler: the device's busy time (the sum of
    its kernels, which run on one stream) against the wall time, and
    where the kernel and host time go: the eight largest kernels, and
    every kernel named in ``port_kernels`` (the port's own, see
    :func:`kernel_names`) however small. ``run`` must end in a copy to
    the host, so the wall covers the device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    busy_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    # the port's kernels sit in their files' anonymous namespaces
    own = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+)")
    averages = prof.key_averages()
    host = sorted(averages, key=lambda e: -e.self_cpu_time_total)
    runtime = {e.key: e.count for e in averages if HOST_CALLS.match(e.key)}
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=(1.0 - busy_us / wall_us) if busy_us else None,
        kernel_launches=sum(n for n, _ in kernels.values()),
        host_launches=sum(n for k, n in runtime.items()
                          if HOST_LAUNCHES.match(k)),
        runtime_calls=runtime,
        top_kernels=[dict(name=k[:80], n=n, ms=us / 1e3)
                     for k, (n, us) in top],
        port_kernels=[dict(name=k[:80], n=n, ms=us / 1e3)
                      for k, (n, us) in kernels.items()
                      if own.match(k) and own.match(k)[1] in port_kernels],
        top_host_ops=[dict(name=e.key[:80], n=e.count,
                           self_cpu_ms=e.self_cpu_time_total / 1e3)
                      for e in host[:8]],
    )


# ---------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    port = load_port()  # ImportError outside the repository
    shape = Shape()
    dev = torch.device("cuda")
    record = {"shape": dataclasses.asdict(shape), "started_s": {},
              "t0": time.perf_counter()}

    # 1. device
    card = device_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    record["card"] = card

    # 2. build
    stamp(record, "build")
    t0 = time.perf_counter()
    libs = port["build"].build_all()
    for name in libs:
        port["build"].library(name)
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {sorted(libs)} in {record['build_s']:.2f} s", flush=True)
    record["ptxas"] = ptxas_report(port["build"].LOGS)
    print(f"ptxas, redesigned kernels: {json.dumps(record['ptxas'])}",
          flush=True)

    # 3. kernels against their plain versions
    stamp(record, "kernels_vs_plain")
    rng = np.random.default_rng(0)
    err = check_kernels(port, shape, dev, rng)
    err.update(check_hop_step_kernel(port, shape, dev, rng))
    err.update(check_flat_kernels(port, dev, rng))
    err.update(check_embedding_bag_kernel(port, dev, rng))
    print(f"kernels vs plain: max abs err {err} (gather rtol {GD_RTOL}, "
          f"atol {GD_ATOL}, hop_step's beams too, up to near ties; "
          f"hop_step = the per-op step exactly; "
          f"distance_matrix within {DM_TOL} of the "
          f"metric's scale, largest {err['distance_matrix_scaled']}; merge, "
          "ADC, topk and embedding_bag exact)", flush=True)

    # 4. the query path
    stamp(record, "query_paths")
    torch.cuda.reset_peak_memory_stats()
    X = port["corpus_embeddings"](shape.n, shape.dim, seed=CORPUS_SEED)
    t0 = time.perf_counter()
    graph = port["build_hnsw"](X, M=shape.M,
                               ef_construction=shape.ef_construction,
                               seed=GRAPH_SEED)
    record["hnsw_build_s"] = time.perf_counter() - t0
    print(f"hnsw: N={shape.n} d={shape.dim} M={shape.M} "
          f"efc={shape.ef_construction} built in "
          f"{record['hnsw_build_s']:.1f} s, {graph.n_layers} layers",
          flush=True)
    Q = make_queries(X, shape.batch, seed=QUERY_SEED)
    # float32: each path below sets the counts to 0 just before it and
    # reads them just after; `launches` sums those readings per kernel
    run = run_query_path(port, shape, "cuda", X, graph, Q)
    for kname in ("gather_distance", "gather_distance_batch", "merge_topk",
                  "hop_step"):
        n = run["launches_total"][kname]
        check(n > 0, f"kernel {kname} launched on the query path ({n})")
    record["query_path"] = check_query_path(port, shape, X, Q, run)
    record["launches"] = {"float32": run["launches"]}
    record["query_path_s"] = {"float32": {r: run[r + "_s"]
                                          for r in REQUESTS}}
    launches = dict(run["launches_total"])
    cpu = run_query_path(port, shape, "cpu", X, graph, Q, ("batched",))
    agree = _agreement(cpu["batched"].ids, run["batched"].ids)
    check(agree >= 0.99, f"ids agree with the CPU engine: {agree}")
    record["query_path"]["cpu_agreement"] = agree
    print(f"query path, float32: {json.dumps(record['query_path'])}",
          flush=True)
    runs = {"float32": run}
    # the quantized tier 2 with its exact rerank
    stamp(record, "quantized_paths")
    for precision in QUANT:
        q_run = run_query_path(port, shape, "cuda", X, graph, Q,
                               precision=precision)
        q_cpu = run_query_path(port, shape, "cpu", X, graph, Q,
                               precision=precision)
        record[f"query_path_{precision}"] = check_quantized_path(
            port, shape, X, Q, q_run, q_cpu, precision)
        record["launches"][precision] = q_run["launches"]
        record["query_path_s"][precision] = {r: q_run[r + "_s"]
                                             for r in REQUESTS}
        for kname, n in q_run["launches_total"].items():
            launches[kname] += n
        runs[precision] = q_run
        print(f"query path, {precision}: "
              f"{json.dumps(record[f'query_path_{precision}'])}", flush=True)
    # the fused driver at every precision
    stamp(record, "fused_paths")
    for precision in PRECISIONS:
        f_run = run_query_path(port, shape, "cuda", X, graph, Q, ("fused",),
                               precision=precision, fused=True)
        f_cpu = run_query_path(port, shape, "cpu", X, graph, Q, ("fused",),
                               precision=precision, fused=True)
        key = f"fused_{precision}"
        record[key] = check_fused_path(
            port, shape, X, Q, f_run, f_cpu, precision,
            loop32=run["loop"] if precision == "float32" else None)
        record["launches"][key] = f_run["launches"]
        record["query_path_s"][key] = f_run["fused_s"]
        for kname, n in f_run["launches_total"].items():
            launches[kname] += n
        runs[key] = f_run
        print(f"query path, {key}: {json.dumps(record[key])}", flush=True)
    # product quantization over one codebook trained here, on the card
    stamp(record, "pq_paths")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codebook = port["pq"].train_pq(X, n_subspaces=PQ_SUBSPACES,
                                   seed=PQ_SEED, device="cuda")
    record["pq_train_s"] = time.perf_counter() - t0
    print(f"pq: codebook of {PQ_SUBSPACES} subspaces trained on the card in "
          f"{record['pq_train_s']:.2f} s", flush=True)
    pq_runs = {}
    for device in ("cuda", "cpu"):
        stamp(record, f"pq_{device}")
        r = run_query_path(port, shape, device, X, graph, Q,
                           codebook=codebook)
        f = run_query_path(
            port, shape, device, X, graph,
            Q if device == "cuda" else Q[:PQ_CPU_FUSED_QUERIES], ("fused",),
            fused=True, codebook=codebook)
        r["fused"], r["fused_s"] = f["fused"], f["fused_s"]
        r["engines"]["fused"] = f["engines"]["fused"]
        r["launches"]["fused"] = f["launches"]["fused"]
        r["launches_total"] = {kname: n + f["launches_total"][kname]
                               for kname, n in r["launches_total"].items()}
        pq_runs[device] = r
    record["query_path_pq"] = check_pq_path(port, shape, X, Q,
                                            pq_runs["cuda"], pq_runs["cpu"])
    record["launches"]["pq"] = pq_runs["cuda"]["launches"]
    for name, device in (("pq", "cuda"), ("pq_cpu", "cpu")):
        record["query_path_s"][name] = {r: pq_runs[device][r + "_s"]
                                        for r in REQUESTS + ("fused",)}
    for kname, n in pq_runs["cuda"]["launches_total"].items():
        launches[kname] += n
    runs["pq"] = pq_runs["cuda"]
    print(f"query path, pq: {json.dumps(record['query_path_pq'])}",
          flush=True)
    stamp(record, "rerank_access")
    record["rerank_access"] = check_rerank_access(port, shape, X, graph, Q,
                                                  codebook)
    record["peak_device_bytes_query_paths"] = torch.cuda.max_memory_allocated()
    record["graph_captures_alive"] = port["step_graph"].n_captures()
    # 4d. each path's graph-replayed layer search against its eager loop
    stamp(record, "graph_replay")
    t0 = time.perf_counter()
    record["graph_replay"] = check_graph_replay(port, shape, X, graph, Q,
                                                codebook)
    record["graph_replay_s"] = time.perf_counter() - t0
    print(f"graph replay = eager loop, bit for bit, K = "
          f"{port['search'].STEPS_PER_SYNC}: "
          f"{json.dumps(record['graph_replay'])}", flush=True)
    # 4e. cache sizing (Algorithm 2, its byte budgets, rollback, the
    # cross-tenant allocator) and the MeMemo baseline on the card engine
    stamp(record, "cache_sizing")
    ops = port["ops"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sizing = run_cache_sizing(port, shape, X, graph, codebook)
    counts = ops.launch_counts()
    record["cache_sizing_s"] = time.perf_counter() - t0
    for kname in ("hop_step", "gather_distance", "dequant_gather_distance",
                  "adc_gather_distance", "merge_topk"):
        check(counts[kname] > 0,
              f"kernel {kname} launched by the cache-sizing probes "
              f"({counts[kname]})")
    record["launches"]["cache_sizing"] = counts
    for kname, n in counts.items():
        launches[kname] += n
    sizing["card"] = device_line()
    record["cache_sizing"] = sizing
    print(f"cache sizing and the baseline, {sizing['card']}, in "
          f"{record['cache_sizing_s']:.1f} s: {json.dumps(sizing)}",
          flush=True)
    # 4f. persistence: each precision's index saved and reopened from its
    # shard files, the float32 one tombstoned on disk and reopened
    stamp(record, "persistence")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    persist = run_persistence(port, shape, X, Q, runs)
    counts = ops.launch_counts()
    record["persistence_s"] = time.perf_counter() - t0
    for kname in ("hop_step", "gather_distance", "gather_distance_batch",
                  "dequant_gather_distance", "dequant_gather_distance_batch",
                  "adc_gather_distance", "adc_gather_distance_batch",
                  "merge_topk"):
        check(counts[kname] > 0,
              f"kernel {kname} launched by the reopened engines "
              f"({counts[kname]})")
    record["launches"]["persistence"] = counts
    for kname, n in counts.items():
        launches[kname] += n
    record["persistence"] = persist
    print(f"persistence, {persist['card']}, in "
          f"{record['persistence_s']:.1f} s: {json.dumps(persist)}",
          flush=True)
    # 4g. metadata filters and mutation on phase 4's corpus and graph
    stamp(record, "mutation_filters")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mf = run_mutation_filters(port, shape, X, graph, Q, codebook)
    counts = ops.launch_counts()
    record["mutation_filters_s"] = time.perf_counter() - t0
    for kname in ("hop_step", "gather_distance", "gather_distance_batch",
                  "dequant_gather_distance", "dequant_gather_distance_batch",
                  "adc_gather_distance", "adc_gather_distance_batch",
                  "merge_topk"):
        check(counts[kname] > 0,
              f"kernel {kname} launched by the filtered and mutated "
              f"engines ({counts[kname]})")
    record["launches"]["mutation_filters"] = counts
    for kname, n in counts.items():
        launches[kname] += n
    record["mutation_filters"] = mf
    print(f"filters and mutation, {mf['card']}, in "
          f"{record['mutation_filters_s']:.1f} s: {json.dumps(mf)}",
          flush=True)
    # 4b. the distributed substrate: flat scan at 480k, hnsw mode
    stamp(record, "substrate")
    sub = run_substrate(port, shape, dev)
    record["substrate"] = sub["record"]
    for mode, counts in sub["launches"].items():
        record["launches"][f"substrate_{mode}"] = counts
        for kname, n in counts.items():
            launches[kname] += n
    # 4c. the recsys serving slice
    stamp(record, "recsys")
    rec = run_recsys(port, dev)
    record["recsys"] = rec["record"]
    for path, counts in rec["launches"].items():
        record["launches"][f"recsys_{path}"] = counts
        for kname, n in counts.items():
            launches[kname] += n
    for kname, n in launches.items():
        check(n > 0, f"kernel {kname} launched on the paths ({n})")
    record["launches_total"] = launches
    print(f"launches per path and request: {json.dumps(record['launches'])}",
          flush=True)

    # 5. times
    stamp(record, "times")
    rows = time_kernels(port, shape, dev, rng, launches, err)
    rows += time_dequant_kernels(port, shape, dev, rng, launches, err)
    rows.append(time_hop_step(port, shape, X, graph, dev, rng, launches,
                              err))
    print(f"hop step: {json.dumps(rows[-1])}", flush=True)
    rows += time_adc_kernels(port, shape, dev, rng, launches, err)
    rows += time_flat_kernels(port, shape, sub["shard"], sub["X"],
                              rec.pop("retrieval_D"),
                              rec.pop("retrieval_inputs"), dev, launches,
                              err)
    rows += time_embedding_bag(port, rec.pop("bag_table"), dev, launches,
                               err)
    record["kernels"] = rows
    record["flat_scan"] = time_flat_scan(port, shape, sub["shard"], sub["X"])
    print(f"end to end, flat scan: {json.dumps(record['flat_scan'])}",
          flush=True)
    del sub
    engines = {}
    for precision in PRECISIONS:
        r = runs[precision]["engines"]
        engines[f"{precision}_batched"] = ("batched", r["batched"])
        engines[f"{precision}_single"] = ("single", r["single"])
        engines[f"fused_{precision}"] = (
            "single", runs[f"fused_{precision}"]["engines"]["fused"])
    r = runs["pq"]["engines"]
    engines["pq_batched"] = ("batched", r["batched"])
    engines["pq_single"] = ("single", r["single"])
    engines["fused_pq"] = ("single", r["fused"])
    torch.cuda.reset_peak_memory_stats()
    e2e = time_end_to_end(port, shape, X, engines)
    for name, o in e2e.items():
        o.update(search_costs(port, shape, X, engines[name][1],
                              engines[name][0]))
        print(f"end to end, {name}: {json.dumps(o)}", flush=True)
    record["end_to_end"] = e2e
    record["steps_per_sync"] = port["search"].STEPS_PER_SYNC
    record["steps_per_sync_sweep"] = sweep_steps_per_sync(
        port, shape, X, {name: engines[name] for name in
                         ("float32_batched", "float32_single",
                          "fused_float32")})
    print(f"K sweep (hop steps a host check): "
          f"{json.dumps(record['steps_per_sync_sweep'])}", flush=True)
    record["peak_device_bytes_end_to_end"] = torch.cuda.max_memory_allocated()
    record["profile_batched"] = {
        p: profile_batched(port, shape, X, runs[p]["engines"]["batched"])
        for p in ("float32", "int8", "pq")}
    print(f"profile, one batched search: "
          f"{json.dumps(record['profile_batched'])}", flush=True)
    out_dir = ROOT / "build"  # git-ignored, beside the kernels' builds
    stamp(record, "end")
    out_dir.mkdir(exist_ok=True)
    del record["t0"]
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    print(f"record: {json.dumps(record)}")
    print(f"card: {device_line()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
