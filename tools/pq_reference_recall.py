#!/usr/bin/env python3
"""recall@10 of the JAX package's pq drivers at ``chip_smoke.py``'s
configuration, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/pq_reference_recall.py

``chip_smoke.py`` holds the port's pq paths on the card to these
recalls (its ``REF_PQ_RECALL``); the card has no JAX, so they are
measured here. The configuration is imported from ``chip_smoke.py``
(its ``Shape``, seeds, ``make_queries``, ``PQ_SUBSPACES`` and
``PQ_ALPHA``), so the two cannot drift apart: a corpus of
``corpus_embeddings`` rows, its HNSW graph, noisy corpus rows as
queries, a cold tier 2, and a codebook the reference trains once and
every engine adopts through its storage backend.

With ``--port`` the port's engine also runs here, on the CPU, with a
codebook of the port's own ``train_pq``: the spread between two
codebooks at this configuration. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def drive(E, make_engine, Q, k, truth, recall_at_k) -> dict:
    """recall@10 of each driver, each on a fresh engine: ``batched`` and
    ``loop`` serve the batch, ``fused`` serves it one query at a time."""
    out = {}
    for name, fused, mode in (("batched", False, "batched"),
                              ("loop", False, "loop"),
                              ("fused", True, "batched")):
        t0 = time.perf_counter()
        res = make_engine(fused).search(E.SearchRequest(
            query=Q, k=k, batch_mode=mode))
        out[name] = recall_at_k(np.asarray(res.ids), truth)
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_ids"] = np.asarray(res.ids).tolist()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port's engine on the CPU")
    args = ap.parse_args()
    from repro.core import engine as R
    from repro.core import pq as RP
    from repro.core.eval import brute_force_topk, recall_at_k
    from repro.core.hnsw import build_hnsw
    from repro.core.storage import InMemoryBackend
    from repro.data.synthetic import corpus_embeddings

    sys.path.insert(0, str(ROOT))
    import chip_smoke as S  # the smoke run's configuration

    shape = S.Shape()
    n, dim, k = shape.n, shape.dim, shape.k
    X = corpus_embeddings(n, dim, seed=S.CORPUS_SEED)
    t0 = time.perf_counter()
    graph = build_hnsw(X, M=shape.M, ef_construction=shape.ef_construction,
                       seed=S.GRAPH_SEED)
    build_s = time.perf_counter() - t0
    Q = S.make_queries(X, shape.batch, seed=S.QUERY_SEED)
    truth = brute_force_topk(X, Q, k)
    kw = dict(cache_capacity=shape.cache, ef_search=shape.ef,
              precision="pq", pq_subspaces=S.PQ_SUBSPACES,
              rerank_alpha=S.PQ_ALPHA)
    t0 = time.perf_counter()
    codebook = RP.train_pq(X, n_subspaces=S.PQ_SUBSPACES, seed=S.PQ_SEED)
    record = {"config": dict(kw, **dataclasses.asdict(shape)),
              "hnsw_build_s": build_s,
              "reference_train_s": time.perf_counter() - t0}

    def reference(fused):
        backend = InMemoryBackend(X)
        backend.codebook = codebook
        return R.WebANNSEngine(backend, graph, R.EngineConfig(
            fused=fused, **kw))

    record["reference"] = drive(R, reference, Q, k, truth, recall_at_k)
    if args.port:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch import convert
        from repro_torch.core import engine as P
        from repro_torch.core import pq as PP
        from repro_torch.core.storage import InMemoryBackend as PBackend

        g, table = convert.from_reference(
            X, graph.neighbors, graph.levels, graph.entry_point,
            graph.max_level, graph.M, graph.metric)
        t0 = time.perf_counter()
        port_cb = PP.train_pq(table, n_subspaces=S.PQ_SUBSPACES,
                              seed=S.PQ_SEED, device="cpu")
        record["port_train_s"] = time.perf_counter() - t0

        def port(fused):
            backend = PBackend(table)
            backend.codebook = port_cb
            return P.WebANNSEngine(backend, g, P.EngineConfig(
                device="cpu", fused=fused, **kw))

        record["port_cpu"] = drive(P, port, Q, k, truth, recall_at_k)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
