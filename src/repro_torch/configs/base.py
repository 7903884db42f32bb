"""Config registry of the port: each ported architecture is a selectable
config, as in ``repro.configs.base``.

A copy of the reference's registry (``ShapeSpec``, ``ArchSpec``,
``register``, ``get``, ``list_archs``) and of its recsys and ANNS shape
sets; the reference's ``sds`` (JAX shape stand-ins) has no counterpart.
Each ``ArchSpec`` carries the published configuration and a reduced smoke
configuration, equal field by field to the reference's. The LM and GNN
architectures register when their models are ported; until then
:func:`get` names them as unported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode' | 'serve' | 'retrieval'
    params: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # 'lm' | 'gnn' | 'recsys' | 'anns'
    source: str  # citation tag from the assignment
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: Dict[str, ShapeSpec]
    notes: str = ""


REGISTRY: Dict[str, ArchSpec] = {}

# the reference's architectures whose models the port has not yet
UNPORTED = ("deepseek-moe-16b", "mistral-large-123b", "nequip",
            "phi3.5-moe-42b-a6.6b", "qwen2.5-14b", "stablelm-12b")


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    if arch_id in UNPORTED:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet: the LM and GNN models come "
            f"with ROADMAP item A.9; available: {sorted(REGISTRY)}"
        )
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]


def list_archs() -> list:
    return sorted(REGISTRY)


# ------------------------------------------------------------ shape sets

RECSYS_SHAPES: Dict[str, ShapeSpec] = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval",
        {"batch": 1, "n_candidates": 1_000_000},
    ),
}

ANNS_SHAPES: Dict[str, ShapeSpec] = {
    "query_sharded": ShapeSpec(
        "query_sharded", "retrieval",
        {"batch": 1024, "n_items": 4_194_304, "dim": 768, "k": 10,
         "ef": 64},
    ),
    "query_flat": ShapeSpec(
        "query_flat", "retrieval",
        {"batch": 1024, "n_items": 4_194_304, "dim": 768, "k": 10},
    ),
}
