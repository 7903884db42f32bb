"""The persistable index artifact (the port's copy of
``repro.core.index``; DESIGN.md §6, mutation lifecycle §8).

An :class:`Index` is everything a query session needs, bundled: the HNSW
graph (levels + neighbor shards + metric/entry-point metadata), the
vector payload behind a :class:`~repro_torch.core.storage.StorageBackend`,
the tombstone set, and the lineage metadata that makes *delta*
persistence safe (``uuid``) and incremental insertion reproducible
(``level_state``).

``save(path)`` is two-mode:

- **full** — one directory of chunked ``.npy`` shards plus a single
  ``manifest.json``, stamped with the v2 keys.
- **delta** — when ``path`` already holds an earlier save of the SAME
  index lineage (matching ``index_uuid``, same vector codec), only the
  mutations are written: append-only vector delta shards for rows the
  directory has never seen, the neighbor shards whose rows incremental
  insertion dirtied, the (small) ``levels.npy`` + tombstone id list,
  and a manifest merge bumping ``mutation_epoch``. Existing vector
  shards are NEVER rewritten.

``load(path)`` replays the result in one pass: the merged manifest's
shard lists already interleave base + delta shards in id order, so the
initialization-stage bulk load (one access per shard, no HNSW rebuild)
is identical for mutated and never-mutated artifacts.

On-disk layout (one directory)::

    manifest.json            graph metadata + graph shard list
                             + dim / vector_dtype / vector_shards
                             + v2: format_version / index_uuid /
                               mutation_epoch / tombstones_file /
                               level_seed / levels_drawn
    neighbors_l{l}_s{s}.npy  graph neighbor shards (per layer)
    levels.npy               per-node top layer
    vectors_s{s}.npy         vector payload shards (f32 / f16 / int8)
    vector_scales_s{s}.npy   per-row dequant scales (int8 codec only)
    codes_s{s}.npy           pq code shards, and one codebook.npz (§12)
    tombstones.npy           sorted int64 ids of deleted rows
    metadata_{name}.npy      one per-id metadata column per file (§9);
                             listed under manifest "metadata_columns"

The manifest is a strict superset of the graph-only format already
emitted under ``reports/bench_cache/`` — ``HNSWGraph.load`` keeps
working on Index directories, graph-only directories upgrade in place
via :func:`repro_torch.core.storage.save_vector_shards`, and v1
(pre-mutation) manifests load with an empty tombstone set. The format is
the reference's, file for file: an index either package saved opens in
the other, and equal full saves write byte-equal shards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid as uuid_mod
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.graph import HNSWGraph
from repro_torch.core.hnsw import build_hnsw
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.quant import canonical_precision
from repro_torch.core.storage import (
    MANIFEST_FORMAT_VERSION,
    InMemoryBackend,
    ShardedFileBackend,
    StorageBackend,
    append_vector_shards,
    load_metadata,
    load_tombstones,
    save_metadata,
    save_tombstones,
    save_vector_shards,
    update_manifest,
)


@dataclasses.dataclass
class Index:
    """Graph + vector payload + tombstones: the saveable artifact."""

    graph: HNSWGraph
    backend: StorageBackend
    path: Optional[str] = None  # where this index was loaded from, if any
    tombstones: Optional[np.ndarray] = None  # (N,) bool; None = none
    uuid: Optional[str] = None  # lineage id gating delta saves
    # (seed, draws) of the HNSW level stream: an engine continues this
    # stream on add() so grow-by-add matches the offline build (§8)
    level_state: Optional[Tuple[int, int]] = None
    # (ef_construction, heuristic) the graph was built with: add() must
    # insert with the same knobs or grow-by-add parity silently breaks
    insert_params: Optional[Tuple[int, bool]] = None
    # per-id metadata columns behind filtered search (DESIGN.md §9);
    # None = the index carries no metadata
    metadata: Optional[object] = None  # MetadataStore
    # frozen PQ codebook (DESIGN.md §12): required to save at
    # precision="pq"; adopted from the artifact on load so a reopening
    # engine never retrains
    codebook: Optional[object] = None  # PQCodebook

    @property
    def n_items(self) -> int:
        return self.backend.n_items

    @property
    def dim(self) -> int:
        return self.backend.dim

    @property
    def metric(self) -> str:
        return self.graph.metric

    @property
    def n_live(self) -> int:
        dead = 0 if self.tombstones is None else int(self.tombstones.sum())
        return self.n_items - dead

    # ----------------------------------------------------------- factory

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        M: int = 16,
        ef_construction: int = 200,
        metric: str = "l2",
        seed: int = 0,
        heuristic: bool = True,
        metadata=None,
    ) -> "Index":
        """Offline construction (the paper's service-worker stage).
        ``metadata`` maps column name → per-row values (one per vector)
        and becomes the index's :class:`MetadataStore` (DESIGN.md §9)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        graph = build_hnsw(
            vectors, M=M, ef_construction=ef_construction,
            metric=metric, seed=seed, heuristic=heuristic,
        )
        meta = None
        if metadata is not None:
            meta = (metadata if isinstance(metadata, MetadataStore)
                    else MetadataStore(metadata, n_rows=vectors.shape[0]))
            if meta.n_rows != vectors.shape[0]:
                raise ValueError(
                    f"metadata covers {meta.n_rows} rows, corpus holds "
                    f"{vectors.shape[0]}"
                )
        return cls(
            graph=graph, backend=InMemoryBackend(vectors),
            tombstones=np.zeros(vectors.shape[0], dtype=bool),
            level_state=(seed, vectors.shape[0]),
            insert_params=(ef_construction, heuristic),
            metadata=meta,
        )

    # -------------------------------------------------------- persistence

    def _delta_eligible(self, path: str, precision: str) -> bool:
        """Delta saves require ``path`` to hold an earlier save of THIS
        index lineage at the same vector codec."""
        mpath = os.path.join(path, "manifest.json")
        if self.uuid is None or not os.path.exists(mpath):
            return False
        with open(mpath) as f:
            manifest = json.load(f)
        return (
            manifest.get("index_uuid") == self.uuid
            and "vector_shards" in manifest
            and canonical_precision(manifest.get("vector_dtype", "float32"))
            == precision
            and int(manifest.get("N", 0)) <= self.graph.size
        )

    def save(
        self,
        path: str,
        shard_bytes: int = 64 * 1024 * 1024,
        precision: str = "float32",
        dirty_nodes=(),
    ) -> dict:
        """Persist graph + vectors (+ tombstones) to ``path``.

        If ``path`` already holds an earlier save of this index's
        lineage at the same codec, only the deltas are written (see the
        module docstring); otherwise a full save. ``dirty_nodes`` is
        the set of pre-existing graph rows mutated since the last save
        (the engine tracks it across ``add``/``upsert`` calls; ignored
        on full saves, where everything is written anyway).

        Returns ``{"mode": "full"|"delta", "bytes_written": int,
        "epoch": int}`` — the witness the update benchmark and the
        delta-save tests assert on.
        """
        precision = canonical_precision(precision)
        if self.uuid is None:
            self.uuid = uuid_mod.uuid4().hex
        if self._delta_eligible(path, precision):
            return self._save_delta(path, shard_bytes, dirty_nodes)
        return self._save_full(path, shard_bytes, precision)

    def _meta_extra(self, epoch: int) -> dict:
        extra = {
            "format_version": MANIFEST_FORMAT_VERSION,
            "index_uuid": self.uuid,
            "mutation_epoch": epoch,
        }
        if self.level_state is not None:
            extra["level_seed"] = int(self.level_state[0])
            extra["levels_drawn"] = int(self.level_state[1])
        if self.insert_params is not None:
            extra["insert_ef_construction"] = int(self.insert_params[0])
            extra["insert_heuristic"] = bool(self.insert_params[1])
        return extra

    def _save_full(
        self, path: str, shard_bytes: int, precision: str
    ) -> dict:
        os.makedirs(path, exist_ok=True)
        self.graph.save(path, shard_bytes=shard_bytes)
        save_vector_shards(path, self.backend.vectors,
                           shard_bytes=shard_bytes, precision=precision,
                           codebook=self.codebook)
        save_tombstones(
            path,
            self.tombstones if self.tombstones is not None
            else np.zeros(self.n_items, bool),
        )
        if self.metadata is not None:
            save_metadata(path, self.metadata)
        manifest = update_manifest(path, self._meta_extra(epoch=0))
        self.path = path
        return {
            "mode": "full",
            # a full save writes exactly the artifact files the manifest
            # references (directory-size deltas lie when overwriting an
            # existing save in place)
            "bytes_written": _artifact_bytes(path, manifest),
            "epoch": 0,
        }

    def _save_delta(
        self, path: str, shard_bytes: int, dirty_nodes
    ) -> dict:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        written = self.graph.save_delta(
            path, dirty_nodes, shard_bytes=shard_bytes
        )
        shards = manifest["vector_shards"]
        n_persisted = int(shards[-1]["stop"]) if shards else 0
        if n_persisted < self.n_items:  # append-only payload delta
            new_rows = self.backend.fetch(
                np.arange(n_persisted, self.n_items, dtype=np.int64)
            )
            written += append_vector_shards(
                path, new_rows, shard_bytes=shard_bytes
            )
        written += save_tombstones(
            path,
            self.tombstones if self.tombstones is not None
            else np.zeros(self.n_items, bool),
        )
        if self.metadata is not None:
            # metadata columns are small (like the tombstone list) and
            # rewritten whole on every save — they are not append-only
            written += save_metadata(path, self.metadata)
        epoch = int(manifest.get("mutation_epoch", 0)) + 1
        update_manifest(path, self._meta_extra(epoch=epoch))
        self.path = path
        return {"mode": "delta", "bytes_written": written, "epoch": epoch}

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "Index":
        """Initialization-stage bulk load: one access per shard.

        The graph is materialized (it is consulted every hop); the
        vector payload stays on disk behind :class:`ShardedFileBackend`
        (``mmap=True``) so tier-3 fetches during queries are actual
        media reads — pass ``mmap=False`` to stage shards through RAM.
        Delta saves replay here for free: the merged manifest's shard
        lists already hold base + delta shards in id order, and the
        tombstone file restores the deleted set.
        """
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no manifest.json under {path!r} — not an index directory"
            )
        with open(mpath) as f:
            manifest = json.load(f)
        graph = HNSWGraph.load(path)
        backend = ShardedFileBackend(path, mmap=mmap)
        level_state = None
        if "level_seed" in manifest and "levels_drawn" in manifest:
            level_state = (
                int(manifest["level_seed"]), int(manifest["levels_drawn"])
            )
        insert_params = None
        if "insert_ef_construction" in manifest:
            insert_params = (
                int(manifest["insert_ef_construction"]),
                bool(manifest.get("insert_heuristic", True)),
            )
        return cls(
            graph=graph,
            backend=backend,
            path=path,
            tombstones=load_tombstones(path, manifest, backend.n_items),
            uuid=manifest.get("index_uuid"),
            level_state=level_state,
            insert_params=insert_params,
            metadata=load_metadata(path, manifest, backend.n_items),
            codebook=backend.codebook,  # None unless a pq artifact
        )


def _artifact_bytes(path: str, manifest: dict) -> int:
    """Total size of every file a full save wrote: all shards the
    manifest references, plus levels / tombstones / the manifest."""
    files = {"manifest.json", "levels.npy"}
    if manifest.get("tombstones_file"):
        files.add(manifest["tombstones_file"])
    if manifest.get("codebook_file"):
        files.add(manifest["codebook_file"])
    for col in manifest.get("metadata_columns", []):
        files.add(col["file"])
    for layer_shards in manifest.get("shards", []):
        files.update(sh["file"] for sh in layer_shards)
    for sh in manifest.get("vector_shards", []):
        files.add(sh["file"])
        if "scales_file" in sh:
            files.add(sh["scales_file"])
    return sum(
        os.path.getsize(os.path.join(path, f)) for f in files
        if os.path.exists(os.path.join(path, f))
    )
