"""The paper's own config: WebANNS HNSW engine over a Wiki-480k-like payload."""

from repro_torch.configs.base import ANNS_SHAPES, ArchSpec, register

register(ArchSpec(
    arch_id="webanns",
    family="anns",
    source="SIGIR'25 (this paper)",
    make_config=lambda: {
        "M": 16, "ef_construction": 200, "ef_search": 64, "k": 10,
        "dim": 768, "metric": "l2",
    },
    make_smoke_config=lambda: {
        "M": 8, "ef_construction": 40, "ef_search": 32, "k": 5,
        "dim": 32, "metric": "l2",
    },
    shapes=ANNS_SHAPES,
    notes="Wiki-480k-like payload (768-d embeddings), sharded over the "
          "mesh data axis; see core/distributed.py.",
))
