"""Flat, padded HNSW graph arrays (NumPy; the port's copy of
``repro.core.graph``).

The index is stored as dense, statically-shaped arrays so the online query
path can index it on the device:

- ``neighbors``: ``(n_layers, N, max_degree) int32``; entry ``-1`` = padding.
  Layer 0 allows up to ``2*M`` links (HNSW convention), upper layers ``M``;
  all layers are padded to ``max_degree = 2*M``.
- ``levels``: ``(N,) int32`` — highest layer each node appears in.
- ``entry_point`` / ``max_level``: search entry state.

Construction is host-side NumPy in both packages, so the graph arrays are
bit-identical between them for the same seed. The persisted artifact is a
set of ``.npy`` shards loadable in chunks (paper §4.1 "streaming data
loading") under a ``manifest.json``, in the reference's format: a graph
either package saved loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.core.storage import update_manifest

PAD = -1  # sentinel for absent neighbor slots


@dataclasses.dataclass
class HNSWGraph:
    """Immutable flat HNSW graph (construction output, query input)."""

    neighbors: np.ndarray  # (n_layers, N, max_degree) int32, PAD-padded
    levels: np.ndarray  # (N,) int32
    entry_point: int
    max_level: int
    M: int  # construction connectivity parameter
    metric: str = "l2"  # 'l2' | 'ip' | 'cos'

    @property
    def n_layers(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def size(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def max_degree(self) -> int:
        return int(self.neighbors.shape[2])

    def degree(self, layer: int, node: int) -> int:
        row = self.neighbors[layer, node]
        return int((row != PAD).sum())

    def validate(self) -> None:
        """Cheap structural invariants; raises ``ValueError`` on a breach."""
        L, N, _ = self.neighbors.shape
        checks = [
            (self.levels.shape == (N,), "levels shape"),
            (0 <= self.entry_point < N, "entry point out of range"),
            (self.max_level == int(self.levels.max()), "max_level"),
            (L == self.max_level + 1, "layer count"),
            (int(self.levels[self.entry_point]) == self.max_level,
             "entry point not on the top layer"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"invalid HNSW graph: {what}")
        for l in range(L):
            nb = self.neighbors[l]
            if not ((nb == PAD) | ((nb >= 0) & (nb < N))).all():
                raise ValueError(f"layer {l}: neighbor id out of range")
            absent = np.nonzero(self.levels < l)[0]
            if absent.size and not (nb[absent] == PAD).all():
                raise ValueError(f"layer {l}: node below layer has links")

    # ---------------------------------------------------------------- io

    def save(self, path: str, shard_bytes: int = 64 * 1024 * 1024) -> None:
        """Persist as chunked shards + manifest (streaming-load friendly)."""
        os.makedirs(path, exist_ok=True)
        manifest = {
            "entry_point": int(self.entry_point),
            "max_level": int(self.max_level),
            "M": int(self.M),
            "metric": self.metric,
            "n_layers": self.n_layers,
            "N": self.size,
            "max_degree": self.max_degree,
            "shards": [],
        }
        flat = self.neighbors.reshape(self.n_layers, -1)
        rows_per_shard = max(1, shard_bytes // max(1, flat.shape[1] * 4))
        for l in range(self.n_layers):
            layer_shards = []
            nb = self.neighbors[l]
            for s, start in enumerate(range(0, nb.shape[0], rows_per_shard)):
                stop = min(nb.shape[0], start + rows_per_shard)
                fn = f"neighbors_l{l}_s{s}.npy"
                np.save(os.path.join(path, fn), nb[start:stop])
                layer_shards.append({"file": fn, "start": start, "stop": stop})
            manifest["shards"].append(layer_shards)
        np.save(os.path.join(path, "levels.npy"), self.levels)
        # merge, don't rewrite: an Index directory keeps its
        # vector_shards section when the graph alone is re-persisted
        update_manifest(path, manifest)

    def save_delta(
        self,
        path: str,
        dirty_rows,
        shard_bytes: int = 64 * 1024 * 1024,
    ) -> int:
        """Delta-persist graph mutations onto an existing save at ``path``.

        Incremental insertion changes three things: the new rows (always
        at the tail), the neighbor lists of the pre-existing nodes they
        linked to (``dirty_rows``, collected by ``insert_hnsw``), and the
        entry metadata. So a delta save rewrites ONLY the existing
        neighbor shards whose row range intersects ``dirty_rows``,
        appends new shards for rows beyond the manifest's ``N`` (plus
        whole new top layers), rewrites the small ``levels.npy``, and
        merges the updated graph metadata into the manifest. Vector
        shards are untouched. Returns the bytes written.
        """
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        if (manifest.get("max_degree") != self.max_degree
                or manifest.get("M") != self.M
                or manifest.get("N", 0) > self.size):
            raise ValueError(
                f"{path!r}: existing graph save is not a prefix of this "
                "graph (M/max_degree/N mismatch) — use save() instead"
            )
        old_n = int(manifest["N"])
        old_layers = manifest["shards"]
        dirty = np.unique(np.fromiter(
            (int(r) for r in dirty_rows), dtype=np.int64,
            count=len(dirty_rows),
        )) if len(dirty_rows) else np.empty(0, np.int64)
        dirty = dirty[dirty < old_n]  # new rows ride in appended shards
        flat_row_bytes = self.size * self.max_degree * 4
        rows_per_shard = max(1, shard_bytes // max(1, flat_row_bytes))
        written = 0

        def _write(fn: str, arr: np.ndarray) -> int:
            fp = os.path.join(path, fn)
            np.save(fp, arr)
            return os.path.getsize(fp)

        shards = []
        for l in range(self.n_layers):
            nb = self.neighbors[l]
            layer_shards = list(old_layers[l]) if l < len(old_layers) else []
            for sh in layer_shards:  # rewrite only dirty-intersecting
                lo, hi = int(sh["start"]), int(sh["stop"])
                if dirty.size and np.any((dirty >= lo) & (dirty < hi)):
                    written += _write(sh["file"], nb[lo:hi])
            start0 = old_n if l < len(old_layers) else 0
            s_idx = len(layer_shards)
            for start in range(start0, self.size, rows_per_shard):
                stop = min(self.size, start + rows_per_shard)
                fn = f"neighbors_l{l}_s{s_idx}.npy"
                written += _write(fn, nb[start:stop])
                layer_shards.append(
                    {"file": fn, "start": start, "stop": stop}
                )
                s_idx += 1
            shards.append(layer_shards)
        written += _write("levels.npy", self.levels)
        update_manifest(path, {
            "entry_point": int(self.entry_point),
            "max_level": int(self.max_level),
            "n_layers": self.n_layers,
            "N": self.size,
            "shards": shards,
        })
        return written

    @classmethod
    def load(cls, path: str) -> "HNSWGraph":
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        L, N, D = manifest["n_layers"], manifest["N"], manifest["max_degree"]
        neighbors = np.full((L, N, D), PAD, dtype=np.int32)
        for l, layer_shards in enumerate(manifest["shards"]):
            for sh in layer_shards:  # chunked ("streaming") load
                neighbors[l, sh["start"] : sh["stop"]] = np.load(
                    os.path.join(path, sh["file"])
                )
        levels = np.load(os.path.join(path, "levels.npy"))
        return cls(
            neighbors=neighbors,
            levels=levels,
            entry_point=manifest["entry_point"],
            max_level=manifest["max_level"],
            M=manifest["M"],
            metric=manifest["metric"],
        )


def empty_graph(n: int, max_level: int, M: int, metric: str = "l2") -> HNSWGraph:
    return HNSWGraph(
        neighbors=np.full((max_level + 1, n, 2 * M), PAD, dtype=np.int32),
        levels=np.zeros(n, dtype=np.int32),
        entry_point=0,
        max_level=max_level,
        M=M,
        metric=metric,
    )


def random_levels(n: int, M: int, rng: np.random.Generator) -> np.ndarray:
    """HNSW level assignment: P(level >= l) = exp(-l / mL), mL = 1/ln(M)."""
    m_l = 1.0 / np.log(M)
    u = rng.random(n)
    lv = np.floor(-np.log(u) * m_l).astype(np.int32)
    return lv
