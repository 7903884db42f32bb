#!/usr/bin/env python3
"""Every query path of ``chip_smoke.py`` for one tree of the port: the
first request's results, then latency, host launches, host syncs and
device busy time on the warm engines, so that two trees can be held side
by side in one call on the card.

    python3 tools/bench_search_loop.py --src DIR --out FILE \\
        [--graph-cache FILE] [--part paths|hop_step|both]

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
Prints the card and the output path; needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    from repro_torch.kernels import _build, ops

    port = dict(engine=engine, pq=pq, search=search, ops=ops, build=_build,
                quant=quant, store=store,
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
    ap.add_argument("--part", choices=("paths", "hop_step", "both"),
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
    if args.part != "paths":
        out["hop_step"] = cs.time_hop_step(
            port, shape, X, graph, torch.device("cuda"),
            np.random.default_rng(0), {"hop_step": 0}, {"hop_step": 0.0})
        print(f"hop step: {json.dumps(out['hop_step'])}", flush=True)
    if args.part != "hop_step":
        measure_paths(port, shape, X, graph, out)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(f"card: {out['card']}; wrote {args.out}")
    return 0


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
