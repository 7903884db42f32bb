"""Tier-3 storage backends and index shard I/O (the port's copy of
``repro.core.storage``, DESIGN.md §6).

Tier 3 lives on the host in both packages: a backend serves ``(k, d)``
float32 rows as NumPy arrays, and the tiered store uploads the rows a
load phase needs to the device. The protocol surface:

- ``fetch(ids) -> (k, d) float32``   one bulk read ("one transaction")
- ``n_items`` / ``dim``              payload geometry
- ``access_cost(n) -> float``        modeled seconds for an n-item read

Backends compose:

- :class:`InMemoryBackend`   — the payload as a host NumPy array;
- :class:`ShardedFileBackend` — the payload as mmap-backed ``.npy``
  vector shards described by a ``manifest.json`` (float32, float16,
  int8 with per-row scales, or pq codes decoded through the directory's
  ``codebook.npz``); a fetch reads only the pages it touches, so lazy
  loading amortizes real media reads (the paper's IndexedDB, §3.2);
- :class:`DeltaBackend`      — a frozen base plus appended host rows;
- :class:`LatencyModel`      — the paper's analytic cost model
  ``t_access = t_setup + n · t_per_item`` over any backend.

The shard writers (:func:`save_vector_shards`, :func:`append_vector_shards`,
the tombstone and metadata files, :func:`update_manifest`) write the
reference's on-disk format byte for byte, so an artifact either package
saved opens in the other. The codecs are the port's own
(:mod:`repro_torch.core.quant`, :mod:`repro_torch.core.pq`), bit-equal to
the reference's NumPy ones.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core import pq, quant

VECTOR_SHARD_PREFIX = "vectors_s"
VECTOR_SCALE_PREFIX = "vector_scales_s"
VECTOR_CODES_PREFIX = "codes_s"  # PQ code shards (DESIGN.md §12)
CODEBOOK_FILE = "codebook.npz"  # one frozen codebook per directory
TOMBSTONE_FILE = "tombstones.npy"
METADATA_PREFIX = "metadata_"

# Manifest format versions: 1 = the read-only artifact (older manifests
# carry no key); 2 adds the mutation-lifecycle keys (index_uuid,
# mutation_epoch, tombstones_file, level_seed/levels_drawn) on top of a
# strict superset of v1, so v2 readers accept v1 artifacts. The
# metadata_columns key (DESIGN.md §9) is optional under v2.
MANIFEST_FORMAT_VERSION = 2


@runtime_checkable
class StorageBackend(Protocol):
    """The tier-3 seam: what a storage medium must provide."""

    @property
    def n_items(self) -> int: ...

    @property
    def dim(self) -> int: ...

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """One bulk read of ``ids`` (assumed valid, no -1 padding)."""
        ...

    def access_cost(self, n: int) -> float:
        """Modeled seconds for one n-item access (0.0 = unmodeled)."""
        ...


class InMemoryBackend:
    """Tier 3 as a host NumPy array."""

    def __init__(self, vectors: np.ndarray):
        self._vectors = np.asarray(vectors, dtype=np.float32)

    @property
    def n_items(self) -> int:
        return int(self._vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self._vectors.shape[1])

    @property
    def vectors(self) -> np.ndarray:
        return self._vectors

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        return self._vectors[np.asarray(ids)]

    def access_cost(self, n: int) -> float:
        return 0.0


class ShardedFileBackend:
    """Tier 3 as mmap-backed ``.npy`` vector shards + ``manifest.json``.

    The manifest carries a ``vector_shards`` list of
    ``{"file", "start", "stop"}`` entries — the same chunked-shard format
    the HNSW graph already persists (``reports/bench_cache/``), extended
    with ``dim`` / ``vector_dtype`` keys. Shards are opened ``mmap_mode=
    'r'`` so a fetch reads only the touched pages from disk; the
    ``shard_reads`` counter records how many shard files each engine run
    actually hit (the "served from disk" witness used by tests).

    **Quantized shard codec** (DESIGN.md §7): when the manifest records
    ``vector_dtype`` of ``"int8"`` each shard entry also names a
    ``scales_file`` holding the per-row float32 scales; ``fetch``
    dequantizes on the way out, so the :class:`StorageBackend` protocol
    surface stays float32 and every consumer (tiered store, rerank,
    fused path) is codec-oblivious. ``"float16"`` shards need no scales.
    The int8 codec is re-quantization stable (see ``core/quant.py``), so
    tier-2 re-quantizing these fetches on insert is lossless.

    ``"pq"`` artifacts (DESIGN.md §12) hold ``codes_s{s}.npy`` uint8
    code shards plus ONE ``codebook.npz`` named by the manifest's
    ``codebook_file`` key; ``fetch`` decodes through it (protocol stays
    float32), and the loaded :class:`~repro_torch.core.pq.PQCodebook` is
    exposed as ``.codebook`` so a reopening engine can adopt the frozen
    codebook instead of retraining. Re-encoding a decoded row is stable,
    so a pq tier-2 cache re-encoding these fetches never drifts.
    """

    def __init__(self, path: str, mmap: bool = True):
        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if "vector_shards" not in manifest:
            raise ValueError(
                f"{path!r}: manifest.json has no 'vector_shards' section "
                "(graph-only artifact?) — persist vectors with Index.save "
                "or storage.save_vector_shards first"
            )
        self.precision = quant.canonical_precision(
            manifest.get("vector_dtype", "float32")
        )
        self.codebook: Optional[pq.PQCodebook] = None
        if self.precision == "pq":
            self.codebook = pq.PQCodebook.load(
                os.path.join(path, manifest.get("codebook_file",
                                                CODEBOOK_FILE))
            )
        self._meta = [
            (int(s["start"]), int(s["stop"]), s["file"])
            for s in manifest["vector_shards"]
        ]
        mode = "r" if mmap else None
        self._shards = [
            np.load(os.path.join(path, fn), mmap_mode=mode)
            for _, _, fn in self._meta
        ]
        self._scales = [
            np.load(os.path.join(path, s["scales_file"]), mmap_mode=mode)
            if "scales_file" in s else None
            for s in manifest["vector_shards"]
        ]
        self._starts = np.array([m[0] for m in self._meta], np.int64)
        self._n = int(self._meta[-1][1]) if self._meta else 0
        self._dim = int(manifest["dim"])
        self._dense: Optional[np.ndarray] = None
        self.shard_reads = 0  # shard files touched across all fetches

    @property
    def n_items(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._dim

    def _dequant(self, rows: np.ndarray, scales) -> np.ndarray:
        if self.precision == "int8":
            return rows.astype(np.float32) * np.asarray(scales)[:, None]
        if self.precision == "pq":
            return pq.decode_np(np.asarray(rows), self.codebook.centroids)
        return np.asarray(rows, np.float32)

    @property
    def vectors(self) -> np.ndarray:
        """All-in-one materialization (init-stage load; cached), float32."""
        if self._dense is None:
            self._dense = np.concatenate([
                self._dequant(np.asarray(s), sc)
                for s, sc in zip(self._shards, self._scales)
            ])
            self.shard_reads += len(self._shards)
        return self._dense

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        out = np.empty((len(ids), self._dim), np.float32)
        shard_of = np.searchsorted(self._starts, ids, side="right") - 1
        for s in np.unique(shard_of):
            m = shard_of == s
            local = ids[m] - self._starts[s]
            sc = (self._scales[s][local]
                  if self._scales[s] is not None else None)
            out[m] = self._dequant(self._shards[s][local], sc)
            self.shard_reads += 1
        return out

    def fetch_range(self, lo: int, hi: int) -> np.ndarray:
        """Contiguous read of rows ``[lo, hi)`` touching ONLY the shard
        files overlapping the range — the mesh-staging path
        (``distributed.build_sharded_engine_state``) uses this so each
        mesh shard's tier-3 load stays local to its own files
        (``shard_reads`` counts exactly the overlapping files)."""
        lo, hi = int(lo), int(hi)
        out = np.empty((max(0, hi - lo), self._dim), np.float32)
        for (start, stop, _), shard, sc in zip(
            self._meta, self._shards, self._scales
        ):
            a, b = max(lo, start), min(hi, stop)
            if a >= b:
                continue
            rows = shard[a - start: b - start]
            out[a - lo: b - lo] = self._dequant(
                rows, sc[a - start: b - start] if sc is not None else None
            )
            self.shard_reads += 1
        return out

    def access_cost(self, n: int) -> float:
        return 0.0  # real media: cost is measured (wall), not modeled


class DeltaBackend:
    """Mutable tier 3: a frozen base backend + appended in-memory rows.

    The mutation lifecycle (DESIGN.md §8) never rewrites what a backend
    already holds — the base (an mmap'd shard directory, an in-memory
    array) stays immutable and ``append`` accumulates new rows host-side.
    Fetches split by id range and ``vectors`` concatenates lazily (cached,
    invalidated per append), so every consumer of the
    :class:`StorageBackend` protocol — tiered store, rerank, fused path,
    ``Index.save`` — is mutability-oblivious. ``engine.save`` persists
    the appended rows as append-only delta shards.
    """

    def __init__(self, base: StorageBackend):
        self.base = base
        self._delta = np.zeros((0, base.dim), dtype=np.float32)
        # geometric materialization buffer for `vectors`: the base is
        # staged once, appended rows are filled in incrementally, so a
        # stream of add() calls costs amortized O(rows added) — not a
        # full re-concatenation (= full disk read on mmap bases) each
        self._buf: Optional[np.ndarray] = None
        self._n_mat = 0  # rows of _buf currently filled

    @property
    def n_base(self) -> int:
        return self.base.n_items

    @property
    def n_items(self) -> int:
        return self.base.n_items + self._delta.shape[0]

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def vectors(self) -> np.ndarray:
        n = self.n_items
        nb = self.base.n_items
        if self._buf is None:
            cap = max(n + 8, n + n // 2)
            self._buf = np.empty((cap, self.dim), dtype=np.float32)
            self._buf[:nb] = self.base.vectors
            self._n_mat = nb
        if self._n_mat < n:
            if n > self._buf.shape[0]:  # grow geometrically
                cap = max(n, 2 * self._buf.shape[0])
                buf = np.empty((cap, self.dim), dtype=np.float32)
                buf[: self._n_mat] = self._buf[: self._n_mat]
                self._buf = buf
            self._buf[self._n_mat: n] = self._delta[self._n_mat - nb:]
            self._n_mat = n
        return self._buf[:n]

    def append(self, rows: np.ndarray) -> np.ndarray:
        """Append ``rows`` ((k, d) float32); returns their new ids."""
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        if rows.shape[1] != self.dim:
            raise ValueError(
                f"appended rows have dim {rows.shape[1]}, backend "
                f"holds dim {self.dim}"
            )
        start = self.n_items
        self._delta = np.concatenate([self._delta, rows])
        return np.arange(start, start + rows.shape[0], dtype=np.int64)

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        nb = self.base.n_items
        out = np.empty((len(ids), self.dim), np.float32)
        in_base = ids < nb
        if in_base.any():
            out[in_base] = self.base.fetch(ids[in_base])
        if (~in_base).any():
            out[~in_base] = self._delta[ids[~in_base] - nb]
        return out

    def access_cost(self, n: int) -> float:
        return self.base.access_cost(n)


class LatencyModel:
    """Composable access-cost model over any backend (paper Fig. 3b).

    ``access_cost(n) = inner.access_cost(n) + t_setup + n · t_per_item``.
    With ``simulate=True`` each fetch actually sleeps its own modeled
    share; by default the cost is accounted analytically (by
    ExternalStore) so tests stay fast and deterministic.
    """

    def __init__(
        self,
        inner: StorageBackend,
        t_setup: float = 1.0e-3,
        t_per_item: float = 2.0e-6,
        simulate: bool = False,
    ):
        self.inner = inner
        self.t_setup = float(t_setup)
        self.t_per_item = float(t_per_item)
        self.simulate = bool(simulate)

    @property
    def n_items(self) -> int:
        return self.inner.n_items

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def vectors(self) -> np.ndarray:
        return self.inner.vectors

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        out = self.inner.fetch(ids)
        if self.simulate:
            time.sleep(self.t_setup + len(np.asarray(ids)) * self.t_per_item)
        return out

    def access_cost(self, n: int) -> float:
        return self.inner.access_cost(n) + self.t_setup + n * self.t_per_item


def unwrap_backend(backend: StorageBackend) -> StorageBackend:
    """Strip LatencyModel wrappers down to the storage medium itself."""
    while isinstance(backend, LatencyModel):
        backend = backend.inner
    return backend


# ------------------------------------------------------------ persistence


def save_vector_shards(
    path: str,
    vectors: np.ndarray,
    shard_bytes: int = 64 * 1024 * 1024,
    precision: str = "float32",
    codebook=None,
) -> List[dict]:
    """Write ``vectors`` as chunked ``.npy`` shards under ``path`` and
    merge a ``vector_shards`` section into ``path/manifest.json``
    (creating the manifest if absent). Returns the shard list.

    ``precision`` selects the on-disk codec (``core/quant.py``):
    float32 (identity), float16, or int8 — the latter additionally
    writes one per-shard ``vector_scales_s{s}.npy`` of per-row float32
    scales, referenced from each shard entry as ``scales_file``, and
    records the dtype in the manifest so :class:`ShardedFileBackend`
    can dequantize on fetch. Shard row counts are computed from the
    *encoded* bytes/row, so a fixed ``shard_bytes`` holds ~4× more
    int8 rows per shard.

    ``"pq"`` (DESIGN.md §12) writes ``codes_s{s}.npy`` uint8 code
    shards — M bytes/row, so 10–30× more rows per shard — plus ONE
    ``codebook.npz`` referenced by the manifest's ``codebook_file``
    key. The trained :class:`~repro_torch.core.pq.PQCodebook` (or raw
    centroids) is required: a directory holds exactly one frozen
    codebook, and delta appends re-encode through it.
    """
    precision = quant.canonical_precision(precision)
    vectors = np.asarray(vectors, dtype=np.float32)
    os.makedirs(path, exist_ok=True)
    cent = None
    extra = {}
    if precision == "pq":
        if codebook is None:
            raise ValueError(
                "pq shards need the trained codebook — pass the "
                "PQCodebook (see repro_torch.core.pq.train_pq)"
            )
        cent = np.asarray(
            getattr(codebook, "centroids", codebook), np.float32
        )
        pq.PQCodebook(centroids=cent).save(
            os.path.join(path, CODEBOOK_FILE)
        )
        extra["codebook_file"] = CODEBOOK_FILE
        row_bytes = quant.bytes_per_vector(
            int(vectors.shape[1]), precision, n_subspaces=cent.shape[0]
        )
    else:
        row_bytes = quant.bytes_per_vector(int(vectors.shape[1]), precision)
    rows_per_shard = max(1, shard_bytes // max(1, row_bytes))
    shards: List[dict] = []
    for s, start in enumerate(range(0, vectors.shape[0], rows_per_shard)):
        stop = min(vectors.shape[0], start + rows_per_shard)
        entry = {"start": start, "stop": stop}
        if precision == "pq":
            fn = f"{VECTOR_CODES_PREFIX}{s}.npy"
            np.save(os.path.join(path, fn),
                    pq.encode_np(vectors[start:stop], cent))
        else:
            fn = f"{VECTOR_SHARD_PREFIX}{s}.npy"
            payload, scales = quant.quantize_np(
                vectors[start:stop], precision
            )
            np.save(os.path.join(path, fn), payload)
            if precision == "int8":
                sfn = f"{VECTOR_SCALE_PREFIX}{s}.npy"
                np.save(os.path.join(path, sfn), scales)
                entry["scales_file"] = sfn
        entry["file"] = fn
        shards.append(entry)
    update_manifest(
        path,
        {
            "dim": int(vectors.shape[1]),
            "vector_dtype": precision,
            "vector_shards": shards,
            **extra,
        },
    )
    return shards


def append_vector_shards(
    path: str,
    new_vectors: np.ndarray,
    shard_bytes: int = 64 * 1024 * 1024,
) -> int:
    """Append-only delta persistence of new payload rows (DESIGN.md §8).

    Writes ``new_vectors`` as additional ``vectors_s{s}.npy`` shards
    continuing the manifest's existing ``vector_shards`` list — existing
    shard files are NEVER rewritten. The delta is encoded at the
    manifest's recorded ``vector_dtype`` (a directory holds exactly one
    codec; the caller falls back to a full save on precision change).
    Returns the bytes written.
    """
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    shards = manifest["vector_shards"]
    precision = quant.canonical_precision(
        manifest.get("vector_dtype", "float32")
    )
    new_vectors = np.atleast_2d(np.asarray(new_vectors, dtype=np.float32))
    if new_vectors.shape[1] != int(manifest["dim"]):
        raise ValueError(
            f"delta rows dim {new_vectors.shape[1]} != manifest dim "
            f"{manifest['dim']}"
        )
    start0 = int(shards[-1]["stop"]) if shards else 0
    cent = None
    if precision == "pq":
        # delta rows re-encode through the directory's FROZEN codebook
        # (§12) so base and delta codes stay mutually comparable
        cent = pq.PQCodebook.load(
            os.path.join(path, manifest.get("codebook_file",
                                            CODEBOOK_FILE))
        ).centroids
        row_bytes = quant.bytes_per_vector(
            new_vectors.shape[1], precision, n_subspaces=cent.shape[0]
        )
    else:
        row_bytes = quant.bytes_per_vector(new_vectors.shape[1], precision)
    rows_per_shard = max(1, shard_bytes // max(1, row_bytes))
    written = 0
    s_idx = len(shards)
    for off in range(0, new_vectors.shape[0], rows_per_shard):
        chunk = new_vectors[off: off + rows_per_shard]
        entry = {
            "start": start0 + off,
            "stop": start0 + off + chunk.shape[0],
        }
        if precision == "pq":
            fn = f"{VECTOR_CODES_PREFIX}{s_idx}.npy"
            np.save(os.path.join(path, fn), pq.encode_np(chunk, cent))
        else:
            fn = f"{VECTOR_SHARD_PREFIX}{s_idx}.npy"
            payload, scales = quant.quantize_np(chunk, precision)
            np.save(os.path.join(path, fn), payload)
            if precision == "int8":
                sfn = f"{VECTOR_SCALE_PREFIX}{s_idx}.npy"
                np.save(os.path.join(path, sfn), scales)
                written += os.path.getsize(os.path.join(path, sfn))
                entry["scales_file"] = sfn
        written += os.path.getsize(os.path.join(path, fn))
        entry["file"] = fn
        shards.append(entry)
        s_idx += 1
    update_manifest(path, {"vector_shards": shards})
    return written


def save_tombstones(path: str, tombstones: np.ndarray) -> int:
    """Persist the tombstone set as one small id-list file + manifest key.

    ``tombstones`` is the engine's (N,) bool mask; stored as the sorted
    int64 id list (tiny, rewritten whole on every save — it is the one
    mutation-lifecycle file that is not append-only). Returns bytes
    written.
    """
    ids = np.nonzero(np.asarray(tombstones, bool))[0].astype(np.int64)
    fp = os.path.join(path, TOMBSTONE_FILE)
    np.save(fp, ids)
    update_manifest(path, {"tombstones_file": TOMBSTONE_FILE})
    return os.path.getsize(fp)


def save_metadata(path: str, store) -> int:
    """Persist a :class:`~repro_torch.core.metadata.MetadataStore` as one
    ``metadata_{name}.npy`` array per column plus a ``metadata_columns``
    manifest section (DESIGN.md §9). Like the tombstone list, metadata
    is small next to the vector payload and is rewritten whole on every
    save (full or delta). Returns bytes written."""
    written = 0
    entries = []
    for name, col in sorted(store.to_columns().items()):
        fn = f"{METADATA_PREFIX}{name}.npy"
        np.save(os.path.join(path, fn), col)
        written += os.path.getsize(os.path.join(path, fn))
        entries.append({"name": name, "file": fn, "dtype": str(col.dtype)})
    update_manifest(path, {"metadata_columns": entries})
    return written


def load_metadata(path: str, manifest: dict, n_items: int):
    """MetadataStore from a manifest's ``metadata_columns`` section;
    ``None`` when the artifact carries no metadata. Columns persisted
    before later rows were appended are fill-extended to ``n_items``
    (the same backfill rule MetadataStore.extend applies live)."""
    from repro_torch.core.metadata import MetadataStore, pad_column

    entries = manifest.get("metadata_columns")
    if not entries:
        return None
    cols = {}
    for e in entries:
        col = np.load(os.path.join(path, e["file"]))
        if len(col) > n_items:
            raise ValueError(
                f"metadata column {e['name']!r} has {len(col)} rows, "
                f"payload holds {n_items}"
            )
        # pad_column keeps the saved CANONICAL dtype (int64/float64/str)
        # even for full-length columns — fill inference must never
        # promote an int column to float on the way back in
        cols[e["name"]] = pad_column(col, n_items)
    # allow_reserved: a reopened artifact legitimately carries engine-
    # stamped columns (the filter-isolation tenant stamp, DESIGN.md §11)
    return MetadataStore(cols, n_rows=n_items, allow_reserved=True)


def load_tombstones(path: str, manifest: dict, n_items: int) -> np.ndarray:
    """Tombstone mask ((n_items,) bool) from a manifest; absent = none."""
    mask = np.zeros(n_items, dtype=bool)
    fn = manifest.get("tombstones_file")
    if fn:
        ids = np.load(os.path.join(path, fn))
        mask[ids[ids < n_items]] = True
    return mask


def update_manifest(path: str, extra: dict) -> dict:
    """Merge ``extra`` keys into ``path/manifest.json`` (create if new)."""
    mpath = os.path.join(path, "manifest.json")
    manifest = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    manifest.update(extra)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    return manifest
