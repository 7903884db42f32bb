#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It imports the port (``src/repro_torch``) only, never JAX or
the JAX package, and goes through five phases; any failure raises and
the script exits non-zero:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every kernel source under ``src/repro_torch/csrc`` with
   ``nvcc`` (timed);
3. kernels against their plain PyTorch versions, on the card, at the
   shapes of the query path;
4. the query path: an N = 10,000, d = 768 corpus, an HNSW graph at the
   paper's widths (M = 16, ef_construction = 200), and engines on the
   card with a cold 25% tier 2 serving one single query, a batch of 32
   in ``batched`` mode and the same batch in ``loop`` mode; checked
   for loop = batched bits, fewer tier-3 accesses when batched,
   recall@10 against brute force, kernel launches, and agreement with
   an engine on the CPU;
5. times: each kernel, its plain version and its bound (CUDA events),
   and the end-to-end latency of batched and single-query searches.

Standard output ends with four lines: every number of the run as one
``record:`` JSON object, the card's name and power limit, one JSON object
listing the kernels, and one ``{"ok": true, "device": ...}`` object.
Without CUDA, or without the repository around it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
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
# reduction), so they agree to float32 rounding, not bit for bit
GD_RTOL, GD_ATOL = 1e-5, 1e-4


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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def load_port():
    """Import the port from the checkout this script sits in."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.engine as engine
    from repro_torch.core.eval import brute_force_topk, recall_at_k
    from repro_torch.core.hnsw import build_hnsw
    from repro_torch.data.synthetic import corpus_embeddings
    from repro_torch.kernels import _build, ops, ref

    return dict(
        engine=engine, brute_force_topk=brute_force_topk,
        recall_at_k=recall_at_k, build_hnsw=build_hnsw,
        corpus_embeddings=corpus_embeddings, build=_build, ops=ops, ref=ref,
    )


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
    for B, M, k in ((shape.batch, shape.ef + shape.degree, shape.ef),
                    (shape.batch, shape.ef + shape.miss_cap, shape.ef),
                    (shape.batch, shape.degree + 1, 1)):
        d, i = merge_inputs(rng, B, M, dev)
        got = ops.merge_topk(d, i, k)
        want = ref.merge_topk_ref(d, i, k)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("dists", "ids", "src")):
            check(torch.equal(g, w), f"merge_topk {what} at ({B}, {M}) k={k}")
    return err


# ------------------------------------------------------------ phase 4


def make_queries(X: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Noisy copies of corpus rows (benchmarks/common.py ``queries_for``)."""
    rng = np.random.default_rng(seed)
    base = X[rng.choice(X.shape[0], n)]
    return base + 0.25 * rng.standard_normal(base.shape).astype(np.float32)


REQUESTS = ("single", "batched", "loop")


def run_query_path(port, shape: Shape, device: str, X, graph, Q,
                   requests=REQUESTS) -> dict:
    """A single query, a batch in ``batched`` mode and the batch in
    ``loop`` mode (those of them named in ``requests``), each on a fresh
    engine on ``device``; launch counts per request. The checks are the
    caller's."""
    E, ops = port["engine"], port["ops"]
    cfg = E.EngineConfig(cache_capacity=shape.cache, ef_search=shape.ef,
                         device=device)
    out = {"engines": {}, "launches": {}}
    ops.reset_launch_counts()
    for name, query, mode in (("single", Q[0], "batched"),
                              ("batched", Q, "batched"),
                              ("loop", Q, "loop")):
        if name not in requests:
            continue
        before = ops.launch_counts()
        eng = E.WebANNSEngine(X, graph, cfg)
        t0 = time.perf_counter()
        res = eng.search(E.SearchRequest(query=query, k=shape.k,
                                         batch_mode=mode))
        out[name] = res
        out["engines"][name] = eng
        out[name + "_s"] = time.perf_counter() - t0
        after = ops.launch_counts()
        out["launches"][name] = {f: after[f] - before[f] for f in after}
    out["launches_total"] = ops.launch_counts()
    return out


def check_query_path(port, shape: Shape, X, Q, run) -> dict:
    single, batched, loop = run["single"], run["batched"], run["loop"]
    check(batched.ids.shape == (shape.batch, shape.k), "batched ids shape")
    check(bool(np.isfinite(batched.dists).all()), "finite distances")
    check(bool(((batched.ids >= 0) & (batched.ids < shape.n)).all()),
          "ids in range")
    check(np.array_equal(batched.ids, loop.ids), "loop ids = batched ids")
    check(np.array_equal(batched.dists, loop.dists),
          "loop dists = batched dists")
    check(np.array_equal(single.ids, loop.ids[0])
          and np.array_equal(single.dists, loop.dists[0]),
          "single query = first query of the loop")
    n_db_b, n_db_l = batched.batch_stats.n_db, loop.batch_stats.n_db
    check(n_db_b < n_db_l, f"batched n_db {n_db_b} < loop n_db {n_db_l}")
    truth = port["brute_force_topk"](X, Q, shape.k)
    recall = port["recall_at_k"](batched.ids, truth)
    check(recall >= 0.90, f"recall@10 {recall} >= 0.90")
    return {"recall_at_10": recall, "n_db_batched": n_db_b,
            "n_db_loop": n_db_l,
            "items_fetched_batched": batched.batch_stats.items_fetched,
            "items_fetched_loop": loop.batch_stats.items_fetched,
            "n_phases_batched": batched.batch_stats.n_phases}


# ------------------------------------------------------------ phase 5


# gather-distance timing: 100 calls, each drawing its ids afresh over a
# table of this many rows (614 MB at d = 768, twelve times the H100's
# 50 MB L2), so each call's rows come from HBM as its bound assumes
COLD_ROWS = 200_000
COLD_CALLS = 100


def time_kernels(port, shape: Shape, dev, rng, run, err) -> list:
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
            replaces=replaces, launches=run["launches_total"][name],
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
    # the batched driver's per-hop beam merge: ef beam + deg new entries
    Mm = shape.ef + shape.degree
    d, i = merge_inputs(rng, B, Mm, dev)
    k = shape.ef
    # bytes: (dist, id) read once, (dist, id, src) written; k rounds of
    # M compares
    t, by = bound_ms(B * Mm * 8 + B * k * 12, B * k * Mm)
    rows.append(dict(
        name="merge_topk", route="cuda",
        source="src/repro_torch/csrc/merge_topk.cu",
        replaces="src/repro/kernels/topk.py:139",
        launches=run["launches_total"]["merge_topk"],
        max_abs_err=err["merge_topk"],
        # its 24 KB of inputs sit in L2 here, as on the query path, where
        # the merge reads the candidate row the hop has just written
        ms=device_ms([lambda: ops.merge_topk(d, i, k)] * 100),
        plain_ms=device_ms([lambda: ref.merge_topk_ref(d, i, k)] * 100),
        bound_ms=t, bound_by=by,
        # yardstick only: torch.topk has no id dedup and no sentinel rule
        library_ms=device_ms(
            [lambda: torch.topk(d, k, dim=1, largest=False)] * 100),
        call_ms=call_ms(lambda: ops.merge_topk(d, i, k)),
        plain_call_ms=call_ms(lambda: ref.merge_topk_ref(d, i, k)),
    ))
    return rows


def _latency(lat_s) -> dict:
    lat = np.asarray(lat_s) * 1e3
    return dict(n=len(lat), p50_ms=float(np.percentile(lat, 50)),
                p90_ms=float(np.percentile(lat, 90)),
                p99_ms=float(np.percentile(lat, 99)),
                mean_ms=float(lat.mean()))


def time_end_to_end(port, shape: Shape, X, run) -> dict:
    """Latency of searches on the engines the query path left warm:
    30 batches of 32 fresh queries (batched driver) and 128 single
    queries, each timed on the host clock (results come back to the
    host, so each search has finished when it returns). Tier 2 keeps
    turning over: each batch brings new queries."""
    E = port["engine"]
    out = {}
    eng = run["engines"]["batched"]
    lat, n_db = [], 0
    for rep in range(31):
        Qr = make_queries(X, shape.batch, seed=100 + rep)
        t0 = time.perf_counter()
        res = eng.search(E.SearchRequest(query=Qr, k=shape.k))
        lat.append(time.perf_counter() - t0)
        n_db += res.batch_stats.n_db if rep else 0
    out["batched"] = _latency(lat[1:])  # the first one is a warm-up
    out["batched"]["qps"] = shape.batch * 1e3 / out["batched"]["mean_ms"]
    out["batched"]["n_db_per_query"] = n_db / (30 * shape.batch)
    eng = run["engines"]["single"]
    lat, n_db = [], 0
    for j, q in enumerate(make_queries(X, 132, seed=200)):
        t0 = time.perf_counter()
        res = eng.search(E.SearchRequest(query=q, k=shape.k))
        lat.append(time.perf_counter() - t0)
        n_db += res.stats.n_db if j >= 4 else 0
    out["single"] = _latency(lat[4:])
    out["single"]["qps"] = 1e3 / out["single"]["mean_ms"]
    out["single"]["n_db_per_query"] = n_db / 128
    return out


def profile_batched(port, shape: Shape, X, run) -> dict:
    """One batched search under torch.profiler: the device's busy time
    (the sum of its kernels, which run on one stream) against the wall
    time, and where the kernel and host time go."""
    from torch.profiler import ProfilerActivity, profile

    E = port["engine"]
    eng = run["engines"]["batched"]
    Qr = make_queries(X, shape.batch, seed=300)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.search(E.SearchRequest(query=Qr, k=shape.k))
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    busy_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=(1.0 - busy_us / wall_us) if busy_us else None,
        kernel_launches=sum(n for n, _ in kernels.values()),
        top_kernels=[dict(name=k[:80], n=n, ms=us / 1e3)
                     for k, (n, us) in top],
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
    record = {"shape": dataclasses.asdict(shape)}

    # 1. device
    card = device_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    record["card"] = card

    # 2. build
    t0 = time.perf_counter()
    libs = port["build"].build_all()
    for name in libs:
        port["build"].library(name)
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {sorted(libs)} in {record['build_s']:.2f} s", flush=True)

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    err = check_kernels(port, shape, dev, rng)
    print(f"kernels vs plain: max abs err {err} (gather rtol {GD_RTOL}, "
          f"atol {GD_ATOL}; merge exact)", flush=True)

    # 4. the query path
    X = port["corpus_embeddings"](shape.n, shape.dim, seed=13)
    t0 = time.perf_counter()
    graph = port["build_hnsw"](X, M=shape.M,
                               ef_construction=shape.ef_construction, seed=0)
    record["hnsw_build_s"] = time.perf_counter() - t0
    print(f"hnsw: N={shape.n} d={shape.dim} M={shape.M} "
          f"efc={shape.ef_construction} built in "
          f"{record['hnsw_build_s']:.1f} s, {graph.n_layers} layers",
          flush=True)
    Q = make_queries(X, shape.batch, seed=5)
    run = run_query_path(port, shape, "cuda", X, graph, Q)
    for kname, n in run["launches_total"].items():
        check(n > 0, f"kernel {kname} launched on the query path ({n})")
    record["query_path"] = check_query_path(port, shape, X, Q, run)
    record["launches"] = run["launches"]
    record["query_path_s"] = {r: run[r + "_s"] for r in REQUESTS}
    cpu = run_query_path(port, shape, "cpu", X, graph, Q, ("batched",))
    agree = float((cpu["batched"].ids == run["batched"].ids).mean())
    check(agree >= 0.99, f"ids agree with the CPU engine: {agree}")
    record["query_path"]["cpu_agreement"] = agree
    print(f"query path: {json.dumps(record['query_path'])}", flush=True)
    print(f"launches per request: {json.dumps(run['launches'])}",
          flush=True)

    # 5. times
    rows = time_kernels(port, shape, dev, rng, run, err)
    record["kernels"] = rows
    record["end_to_end"] = time_end_to_end(port, shape, X, run)
    print(f"end to end: {json.dumps(record['end_to_end'])}", flush=True)
    record["profile_batched"] = profile_batched(port, shape, X, run)
    print(f"profile, one batched search: "
          f"{json.dumps(record['profile_batched'])}", flush=True)

    print(f"record: {json.dumps(record)}")
    print(f"card: {device_line()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
