#!/usr/bin/env python3
"""Every query path of ``chip_smoke.py`` for one tree of the port: the
first request's results, then latency, host launches, host syncs and
device busy time on the warm engines, so that two trees can be held side
by side in one call on the card.

    python3 tools/bench_search_loop.py --src DIR --out FILE \\
        [--graph-cache FILE] [--part paths|hop_step|both|merge]

The measurement is this checkout's: the configuration, queries, seeds and
helpers come from its ``chip_smoke.py`` (``Shape``, ``make_queries``,
``run_query_path``, ``time_end_to_end``, ``search_costs``); only the port
under test is imported from ``--src`` (this checkout's ``src``, or the
``src`` of a ``git archive`` of another commit unpacked under ``build/``,
whose kernels then build under that tree's own ``build/``). For each of
float32, int8, float16 and pq it serves the batched, single and fused
paths as ``chip_smoke.py`` phases 4 and 5 do: the first request on fresh
engines (recall@10, tier-3 accesses, the ids), then the timed rounds and
one profiled and one sync-counted search a path. ``--graph-cache`` keeps
the HNSW graph (a numpy build, the same in every tree) in an ``.npz`` for
the next run. To compare a parent and a change on one card, run parent,
change, change, parent in one call, each writing its own ``--out``.
``--part hop_step`` (or ``both``) times the hop-step kernel B.8 instead
of (or after) the paths, as ``chip_smoke.py`` phase 5 does
(``time_hop_step``): its time at each shape beside the per-op step, its
stage split from the kernel's timing instantiation and the launch floor
(``hop_step_split``, so the tree must have that instantiation), and the
device kernels of one replayed hop step.
``--part merge`` times the merge kernel B.2 instead (``time_merge``: the
beam merge's rows, a filter's rows past 256 and the widest row, each
beside ``torch.topk``; then a finalize's rows past 256, a (B, ef) beam
about half denied to k = 10 at ef in ``FINALIZE_EFS``, where the work of
a selection grows with M and not with k, each held to the plain merge),
then serves phase 4g's three filters
(selectivity 0.5, 0.1 and 0.02, ef boosted to 96, 208 and 256) as
batched float32 searches of phase 4's 32 queries, each on a fresh card
engine: the first search on the host clock (phase 4g's time), its ids,
``n_db``, ``items_fetched`` and recall@10 against the brute force over
the allowed rows, and B.2's launches on rows past 256 (counted by the
wrapper, graph replays included); then ``FILTER_TIMED_BATCHES`` warm
searches of fresh queries, and one more run eagerly (no graph replay, so
the profiler sees every launch) under torch.profiler: the device time
and count of B.2's kernels past 256 beside the device's busy time.
Prints the card and the output path; needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (this checkout's harness)


def load_port(src: Path) -> dict:
    """The port of the tree at ``src``, under the names ``chip_smoke.py``'s
    helpers take; ``step_graph`` only where the tree has it."""
    sys.path.insert(0, str(src))
    import repro_torch.core.engine as engine
    from repro_torch.core import pq, quant, search, store
    from repro_torch.core.eval import brute_force_topk, recall_at_k
    from repro_torch.core.graph import HNSWGraph
    from repro_torch.core.hnsw import build_hnsw
    from repro_torch.core.storage import InMemoryBackend
    from repro_torch.data.synthetic import corpus_embeddings
    from repro_torch.kernels import _build, ops, ref, topk

    port = dict(engine=engine, pq=pq, search=search, ops=ops, build=_build,
                quant=quant, store=store, ref=ref, topk=topk,
                brute_force_topk=brute_force_topk, recall_at_k=recall_at_k,
                HNSWGraph=HNSWGraph, build_hnsw=build_hnsw,
                InMemoryBackend=InMemoryBackend,
                corpus_embeddings=corpus_embeddings,
                kernel_names=cs.kernel_names(_build.sources()))
    try:
        from repro_torch.core import step_graph
    except ImportError:  # a tree from before the graph-replayed loop
        step_graph = None
    if step_graph is not None:
        port["step_graph"] = step_graph
    try:
        from repro_torch.kernels import hop_step
    except ImportError:  # a tree from before the hop-step kernel
        hop_step = None
    if hop_step is not None:
        port["hop_step"] = hop_step
    return port


def load_graph(port, shape: cs.Shape, X: np.ndarray, cache):
    fields = ("neighbors", "levels", "entry_point", "max_level", "M",
              "metric")
    if cache is not None and Path(cache).exists():
        z = np.load(cache)
        return port["HNSWGraph"](
            z["neighbors"], z["levels"], int(z["entry_point"]),
            int(z["max_level"]), int(z["M"]), str(z["metric"])), 0.0
    t0 = time.perf_counter()
    g = port["build_hnsw"](X, M=shape.M, ef_construction=shape.ef_construction,
                           seed=cs.GRAPH_SEED)
    build_s = time.perf_counter() - t0
    if cache is not None:
        np.savez(cache, **{f: np.asarray(getattr(g, f)) for f in fields})
    return g, build_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, required=True,
                    help="the src directory of the tree to measure")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--graph-cache", type=Path, default=None)
    ap.add_argument("--part", choices=("paths", "hop_step", "both", "merge"),
                    default="paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_search_loop: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    port = load_port(args.src.resolve())
    shape = cs.Shape()
    out = {"src": str(args.src), "card": cs.device_line(),
           "torch": torch.__version__,
           "steps_per_sync": getattr(port["search"], "STEPS_PER_SYNC", None)}
    t0 = time.perf_counter()
    port["build"].build_all()
    out["build_s"] = time.perf_counter() - t0
    X = port["corpus_embeddings"](shape.n, shape.dim, seed=cs.CORPUS_SEED)
    graph, out["hnsw_build_s"] = load_graph(port, shape, X, args.graph_cache)
    if args.part == "merge":
        measure_merge(port, shape, X, graph, out)
    if args.part in ("hop_step", "both"):
        out["hop_step"] = cs.time_hop_step(
            port, shape, X, graph, torch.device("cuda"),
            np.random.default_rng(0), {"hop_step": 0}, {"hop_step": 0.0})
        print(f"hop step: {json.dumps(out['hop_step'])}", flush=True)
    if args.part in ("paths", "both"):
        measure_paths(port, shape, X, graph, out)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(f"card: {out['card']}; wrote {args.out}")
    return 0


# warm filtered searches timed a filter, after the first
FILTER_TIMED_BATCHES = 5

# a finalize's beam widths past 256 (the engine puts no cap on ef)
FINALIZE_EFS = (512, 1_024, 2_048, 4_096)


def count_wide_merges(topk) -> None:
    """Count B.2's launches on rows past 256 entries under a launch
    counter of their own, ``merge_topk_wide``, beside ``merge_topk``: a
    CUDA graph's capture records it and every replay adds it, as for the
    kernels' own counters."""
    topk.launches["merge_topk_wide"] = 0
    real = topk.merge_topk_cuda

    def counted(dists, ids, k):
        out = real(dists, ids, k)
        if dists.shape[1] > 256:
            topk.launches["merge_topk_wide"] += 1
        return out

    topk.merge_topk_cuda = counted


def time_finalize_rows(port, shape: cs.Shape, dev) -> dict:
    """B.2 at a finalize's (B, ef) rows to k past 256 entries, at B =
    32 and 1, beside ``torch.topk`` on the same distances, each launch's
    output equal to ``ref.merge_topk_ref``'s."""
    ops, ref, k = port["ops"], port["ref"], shape.k
    rng = np.random.default_rng(1)
    out = {}
    for ef in FINALIZE_EFS:
        for b in (shape.batch, 1):
            d, i = cs.finalize_inputs(rng, b, ef, dev)
            equal = all(torch.equal(g, w) for g, w in zip(
                ops.merge_topk(d, i, k), ref.merge_topk_ref(d, i, k)))
            cs.check(equal, f"merge ({b}, {ef}) to {k} = the plain merge")
            out[f"finalize_{b}x{ef}_k{k}"] = dict(
                ms=cs.device_ms([lambda: ops.merge_topk(d, i, k)] * 100),
                library_ms=cs.device_ms(
                    [lambda: torch.topk(d, k, dim=1, largest=False)] * 100),
                bound_ms=cs.bound_ms(b * ef * 8 + b * k * 12,
                                     2 * b * ef)[0])
    return out


def measure_merge(port, shape: cs.Shape, X, graph, out: dict) -> None:
    """B.2's times (``time_merge``) and phase 4g's filtered batched
    searches with B.2's share past 256, into ``out``."""
    dev = torch.device("cuda")
    out["merge"] = cs.time_merge(port, shape, dev, np.random.default_rng(0),
                                 {"merge_topk": 0}, {"merge_topk": 0.0})
    print(f"merge: {json.dumps(out['merge'])}", flush=True)
    out["finalize_rows"] = time_finalize_rows(port, shape, dev)
    print(f"finalize rows: {json.dumps(out['finalize_rows'])}", flush=True)
    from repro_torch.core import metadata  # the measured tree's

    port["metadata"] = metadata  # for make_filters
    count_wide_merges(port["topk"])
    E, ops, sg = port["engine"], port["ops"], port["step_graph"]
    wide = re.compile(r"merge_topk_(?!warp)\w*kernel")
    meta = cs.filter_metadata(shape.n)
    store = metadata.MetadataStore(meta)
    Q = cs.make_queries(X, shape.batch, seed=cs.QUERY_SEED)
    out["filters"] = {}
    for fname, filt in cs.make_filters(port).items():
        allow = filt.mask(store)
        eng = E.WebANNSEngine(X, graph, cs.persist_config(
            port, shape, "float32", False), metadata=meta)
        o = out["filters"][fname] = {
            "selectivity": float(allow.mean()),
            "ef": eng._boost_ef(shape.ef, float(allow.mean()))}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = cs.serve(port, shape, eng, Q, "batched", filt)
        o["first_s"] = time.perf_counter() - t0
        n = ops.launch_counts()
        truth = np.flatnonzero(allow)[port["brute_force_topk"](
            X[allow], Q, shape.k)]
        o.update(merge_launches=n["merge_topk"],
                 wide_launches=n["merge_topk_wide"],
                 recall_at_10=port["recall_at_k"](np.atleast_2d(res.ids),
                                                  truth),
                 ids=np.atleast_2d(res.ids).tolist(),
                 n_db_items=[[int(x) for x in r]
                             for r in cs._access_rows(res)])
        lat = []
        for i in range(FILTER_TIMED_BATCHES):
            q = cs.make_queries(X, shape.batch, seed=400 + i)
            t0 = time.perf_counter()
            eng.search(E.SearchRequest(query=q, k=shape.k, filter=filt))
            lat.append(time.perf_counter() - t0)
        o["warm"] = cs._latency(lat)
        # one more search with every step loop eager, under the profiler
        q = cs.make_queries(X, shape.batch, seed=500)
        run_graph = sg.run_graph
        sg.run_graph = (lambda step, carry, consts, baked, params, steps:
                        sg.run_eager(step, carry, consts, steps))
        ops.reset_launch_counts()
        try:
            prof = cs.profile_call(lambda: eng.search(E.SearchRequest(
                query=q, k=shape.k, filter=filt)), port["kernel_names"])
        finally:
            sg.run_graph = run_graph
        mine = [r for r in prof["port_kernels"] if wide.search(r["name"])]
        o["eager_profiled"] = dict(
            wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
            wide_launches=ops.launch_counts()["merge_topk_wide"],
            wide_kernels=sum(r["n"] for r in mine),
            wide_kernel_ms=sum(r["ms"] for r in mine))
        brief = {k: v for k, v in o.items() if k not in ("ids", "n_db_items")}
        print(f"filter {fname}: {json.dumps(brief)}", flush=True)


def measure_paths(port, shape: cs.Shape, X, graph, out: dict) -> None:
    """The first request, timed rounds and costs of every path, into
    ``out``."""
    Q = cs.make_queries(X, shape.batch, seed=cs.QUERY_SEED)
    truth = port["brute_force_topk"](X, Q, shape.k)
    codebook = port["pq"].train_pq(X, n_subspaces=cs.PQ_SUBSPACES,
                                   seed=cs.PQ_SEED, device="cuda")
    engines, first = {}, {}
    t0 = time.perf_counter()
    for precision in cs.PRECISIONS + ("pq",):
        cb = codebook if precision == "pq" else None
        run = cs.run_query_path(port, shape, "cuda", X, graph, Q,
                                ("single", "batched"), precision=precision,
                                codebook=cb)
        fused = cs.run_query_path(port, shape, "cuda", X, graph, Q,
                                  ("fused",), precision=precision,
                                  fused=True, codebook=cb)
        for name, r, kind in (("batched", run, "batched"),
                              ("single", run, "single"),
                              ("fused", fused, "single")):
            res = r[name]
            path = (f"fused_{precision}" if name == "fused"
                    else f"{precision}_{name}")
            engines[path] = (kind, r["engines"][name])
            ids = np.atleast_2d(np.asarray(res.ids))
            stats = res.stats if isinstance(res.stats, list) else [res.stats]
            first[path] = dict(
                recall_at_10=port["recall_at_k"](
                    ids, truth[: len(ids)]),
                n_db=[s.n_db for s in stats], ids=ids.tolist(),
                launches=r["launches"][name], first_s=r[name + "_s"])
    out["first_requests_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    e2e = cs.time_end_to_end(port, shape, X, engines)
    for name, o in e2e.items():
        o.update(cs.search_costs(port, shape, X, engines[name][1],
                                 engines[name][0]))
        o["first"] = first[name]
        print(f"{name}: p50 {o['p50_ms']:.2f} ms, host launches "
              f"{o['host_launches']}, syncs {o['syncs']['total']}",
              flush=True)
    out["paths"] = e2e
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["shape"] = dataclasses.asdict(shape)


if __name__ == "__main__":
    sys.exit(main())
