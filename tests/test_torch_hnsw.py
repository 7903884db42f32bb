"""Port HNSW construction: the same seed gives the reference's graph.

Construction is host NumPy in both packages, so the graphs must be
``array_equal`` — neighbors, levels, entry point, max level. The search
also relies on one property of the graph: no neighbor row holds an id
twice, which is why the merge kernel's id dedup is a no-op in the beam
merge.
"""

import numpy as np
import pytest

from repro.core.hnsw import build_hnsw as ref_build
from repro_torch.core.graph import PAD
from repro_torch.core.hnsw import build_hnsw, exact_search, knn_search_np
from repro_torch.data.synthetic import corpus_embeddings


def _assert_same_graph(got, want):
    np.testing.assert_array_equal(got.neighbors, want.neighbors)
    np.testing.assert_array_equal(got.levels, want.levels)
    assert got.entry_point == want.entry_point
    assert got.max_level == want.max_level
    assert (got.M, got.metric) == (want.M, want.metric)


def _duplicate_rows(neighbors):
    """Count (layer, node) rows in which some id appears twice."""
    n = 0
    for layer in neighbors:
        for row in layer:
            live = row[row != PAD]
            n += len(live) != len(np.unique(live))
    return n


@pytest.mark.parametrize(
    "fixture,metric,M,efc,seed",
    [
        ("small_dataset", "l2", 8, 60, 3),  # the conftest small_graph
        ("small_dataset", "ip", 8, 40, 1),
        ("clustered_dataset", "l2", 8, 60, 0),
        ("clustered_dataset", "cos", 6, 40, 2),
    ],
)
def test_build_matches_reference(request, fixture, metric, M, efc, seed):
    X, _ = request.getfixturevalue(fixture)
    got = build_hnsw(X, M=M, ef_construction=efc, metric=metric, seed=seed)
    want = ref_build(X, M=M, ef_construction=efc, metric=metric, seed=seed)
    _assert_same_graph(got, want)
    got.validate()
    assert _duplicate_rows(got.neighbors) == 0


def test_small_graph_fixture_rebuilt_by_port(small_dataset, small_graph):
    X, _ = small_dataset
    _assert_same_graph(build_hnsw(X, M=8, ef_construction=60, seed=3),
                       small_graph)


def test_no_duplicate_neighbors_at_published_width():
    """d = 768, M = 16 (the paper's widths) at a small N."""
    X = corpus_embeddings(300, 768, seed=13)
    g = build_hnsw(X, M=16, ef_construction=40, seed=0)
    assert _duplicate_rows(g.neighbors) == 0


def test_numpy_knn_search_recall(clustered_dataset):
    X, Q = clustered_dataset
    g = build_hnsw(X, M=8, ef_construction=60, seed=0)
    hits = 0
    for q in Q:
        ids, _ = knn_search_np(X, g, q, k=10, ef=64)
        ex, _ = exact_search(X, q, 10)
        hits += len(set(ids.tolist()) & set(ex.tolist()))
    assert hits / (10 * len(Q)) > 0.9
