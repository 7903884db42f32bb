"""Per-id metadata columns and the predicate DSL behind filtered search
(the port's copy of ``repro.core.metadata``, DESIGN.md §9; NumPy only).

- :class:`MetadataStore`: typed columns (int64 / float64 / unicode)
  keyed by vector id, host-resident by design: they are consulted only
  when a filter compiles to its allow-bitmap, never during traversal,
  so filtering adds no tier-3 access. They grow with the id space
  (``add``/``upsert`` append rows; a deleted id keeps its row). An index
  artifact carries them as ``metadata_{name}.npy`` files
  (:func:`repro_torch.core.storage.save_metadata`).
- :class:`Filter`: a composable predicate tree (``Filter.eq / in_ /
  range / and_ / or_ / not_`` and ``& | ~``), compiled on the host by
  :meth:`Filter.mask` to one ``(N,)`` allow-bitmap. Its complement is
  the search's deny mask, route-but-don't-return: a denied id still
  routes the traversal but never reaches the returned top-k or a
  rerank pool (:func:`repro_torch.core.search.finalize_topk`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

# Dunder column names are RESERVED for the engine/serving layers: user
# metadata dicts (build/add/upsert) may never introduce them. The one
# reserved column in use today is the multi-tenant owner stamp
# (DESIGN.md §11) — filter-isolation sessions compile every search's
# tenant predicate against it, so a user-writable tenant column would
# be a cross-tenant leak by construction.
TENANT_COLUMN = "__tenant__"
_RESERVED_RE = re.compile(r"^__.*__$")


def _column_kind(arr: np.ndarray) -> str:
    if arr.dtype.kind in "iub":
        return "int"
    if arr.dtype.kind == "f":
        return "float"
    if arr.dtype.kind in "US":
        return "str"
    raise TypeError(
        f"unsupported metadata dtype {arr.dtype} — columns must be "
        "int, float, or str"
    )


def _canon(values: Sequence) -> np.ndarray:
    """Coerce a value sequence to one of the three canonical dtypes."""
    arr = np.asarray(values)
    kind = _column_kind(arr)
    if kind == "int":
        return arr.astype(np.int64)
    if kind == "float":
        return arr.astype(np.float64)
    return arr.astype(np.str_)


def _fill_array(kind: str, n: int) -> np.ndarray:
    """``n`` fill values at the kind's CANONICAL dtype — including for
    n == 0, where dtype inference from an empty Python list would come
    back float64 and poison concatenation promotion."""
    if kind == "int":
        return np.zeros(n, np.int64)
    if kind == "float":
        return np.full(n, np.nan, np.float64)
    return np.full(n, "", dtype=np.str_)


def pad_column(values: Sequence, n_rows: int) -> np.ndarray:
    """Canonicalize a column and fill-extend it to ``n_rows`` (the
    backfill rule persistence uses when a column was saved before later
    rows were appended)."""
    col = _canon(values)
    if len(col) > n_rows:
        raise ValueError(
            f"column has {len(col)} rows, store holds {n_rows}"
        )
    if len(col) == n_rows:
        return col
    return np.concatenate(
        [col, _fill_array(_column_kind(col), n_rows - len(col))]
    )


class MetadataStore:
    """Columnar per-id metadata (host-resident; never fetched at query
    time). ``columns`` maps name → value sequence; every column must
    cover all ``n_rows`` ids."""

    def __init__(
        self,
        columns: Optional[Dict[str, Sequence]] = None,
        n_rows: Optional[int] = None,
        allow_reserved: bool = False,
    ):
        self._cols: Dict[str, np.ndarray] = {}
        if columns:
            lengths = {len(v) for v in columns.values()}
            if len(lengths) > 1:
                raise ValueError(
                    f"metadata columns have mismatched lengths: "
                    f"{ {k: len(v) for k, v in columns.items()} }"
                )
            for name, vals in columns.items():
                self._check_name(name, allow_reserved=allow_reserved)
                self._cols[name] = _canon(vals)
        self._n = n_rows if n_rows is not None else (
            len(next(iter(self._cols.values()))) if self._cols else 0
        )
        for name, col in self._cols.items():
            if len(col) != self._n:
                raise ValueError(
                    f"column {name!r} has {len(col)} rows, store holds "
                    f"{self._n}"
                )

    @staticmethod
    def _check_name(name: str, allow_reserved: bool = False) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid column name {name!r}: must match "
                "[A-Za-z_][A-Za-z0-9_]* (it becomes a shard filename)"
            )
        if _RESERVED_RE.match(name) and not allow_reserved:
            raise ValueError(
                f"metadata column {name!r} is reserved: dunder names "
                "belong to the engine (the multi-tenant session manager "
                f"stamps {TENANT_COLUMN!r} itself — DESIGN.md §11)"
            )

    @property
    def n_rows(self) -> int:
        return self._n

    @property
    def names(self) -> List[str]:
        return sorted(self._cols)

    def column(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(
                f"unknown metadata column {name!r}; have {self.names}"
            )
        return self._cols[name]

    def _extended_columns(
        self, count: int, values: Optional[Dict[str, Sequence]]
    ) -> Dict[str, np.ndarray]:
        """Pure form of :meth:`extend`: compute (and fully validate) the
        post-append column set without mutating the store."""
        values = values or {}
        for name, vals in values.items():
            # a reserved column may be EXTENDED once it exists (upsert
            # inherits the retired rows' full column set, tenant stamp
            # included) but never INTRODUCED through a user value dict
            self._check_name(name, allow_reserved=name in self._cols)
            if len(vals) != count:
                raise ValueError(
                    f"column {name!r}: {len(vals)} values for {count} rows"
                )
        new_cols: Dict[str, np.ndarray] = {}
        for name, col in self._cols.items():
            kind = _column_kind(col)
            if name in values:
                tail = _canon(values[name])
                if _column_kind(tail) != kind:
                    raise TypeError(
                        f"column {name!r} holds {kind} values; appended "
                        f"rows are {_column_kind(tail)}"
                    )
            else:
                tail = _fill_array(kind, count)
            new_cols[name] = np.concatenate([col, tail])
        for name, vals in values.items():
            if name in self._cols:
                continue
            tail = _canon(vals)
            head = _fill_array(_column_kind(tail), self._n)
            new_cols[name] = np.concatenate([head, tail])
        return new_cols

    def validate_extend(
        self, count: int, values: Optional[Dict[str, Sequence]] = None
    ) -> None:
        """Raise exactly what :meth:`extend` would — name, length, kind,
        dtype — WITHOUT mutating. Mutation callers (``engine.add``) run
        this before committing anything, so a bad metadata dict can
        never leave the store out of sync with the id space."""
        self._extended_columns(count, values)

    def extend(
        self, count: int, values: Optional[Dict[str, Sequence]] = None
    ) -> None:
        """Append ``count`` rows. ``values`` supplies per-column value
        lists (each of length ``count``); omitted existing columns are
        filled with their kind's fill value, and previously-unseen
        columns are backfilled over the old rows the same way."""
        self._cols = self._extended_columns(count, values)
        self._n += count

    def assign(
        self,
        name: str,
        rows: Sequence[int],
        values: Sequence,
        allow_reserved: bool = False,
    ) -> None:
        """Overwrite ``values`` at row positions ``rows`` (creating the
        column — backfilled with its kind's fill value — if absent).
        This is the write path the session manager uses to stamp the
        reserved tenant column AFTER a mutation lands, so whatever a
        caller smuggled into the value dict is overwritten by the owner
        of record (DESIGN.md §11)."""
        self._check_name(name, allow_reserved=allow_reserved)
        rows = np.asarray(rows, dtype=np.int64)
        vals = _canon(values)
        if len(rows) != len(vals):
            raise ValueError(
                f"assign: {len(vals)} values for {len(rows)} rows"
            )
        if rows.size and (rows.min() < 0 or rows.max() >= self._n):
            raise ValueError(
                f"assign rows out of range [0, {self._n})"
            )
        if name not in self._cols:
            self._cols[name] = _fill_array(_column_kind(vals), self._n)
        col = self._cols[name]
        if _column_kind(col) != _column_kind(vals):
            raise TypeError(
                f"column {name!r} holds {_column_kind(col)} values; "
                f"assigned rows are {_column_kind(vals)}"
            )
        if col.dtype.kind == "U" and vals.dtype.itemsize > col.dtype.itemsize:
            col = col.astype(vals.dtype)  # widen fixed-width unicode
        col[rows] = vals
        self._cols[name] = col

    def to_columns(self) -> Dict[str, np.ndarray]:
        """The raw column arrays (persistence uses this)."""
        return dict(self._cols)


# ----------------------------------------------------------- predicate DSL


@dataclasses.dataclass(frozen=True)
class Filter:
    """One predicate tree node. Build with the classmethod constructors
    (``Filter.eq("user", 3) & Filter.range("ts", lo=10)``); compile with
    :meth:`mask` to the per-query allow-bitmap."""

    op: str  # 'eq' | 'in' | 'range' | 'and' | 'or' | 'not'
    column: Optional[str] = None
    value: object = None
    children: Tuple["Filter", ...] = ()

    # ------------------------------------------------------ constructors

    @classmethod
    def eq(cls, column: str, value) -> "Filter":
        return cls(op="eq", column=column, value=value)

    @classmethod
    def in_(cls, column: str, values: Sequence) -> "Filter":
        return cls(op="in", column=column, value=tuple(values))

    @classmethod
    def range(cls, column: str, lo=None, hi=None) -> "Filter":
        """Inclusive-bounds range predicate; either bound may be None."""
        if lo is None and hi is None:
            raise ValueError("Filter.range needs at least one bound")
        return cls(op="range", column=column, value=(lo, hi))

    @classmethod
    def and_(cls, *filters: "Filter") -> "Filter":
        return cls(op="and", children=tuple(filters))

    @classmethod
    def or_(cls, *filters: "Filter") -> "Filter":
        return cls(op="or", children=tuple(filters))

    @classmethod
    def not_(cls, f: "Filter") -> "Filter":
        return cls(op="not", children=(f,))

    def __and__(self, other: "Filter") -> "Filter":
        return Filter.and_(self, other)

    def __or__(self, other: "Filter") -> "Filter":
        return Filter.or_(self, other)

    def __invert__(self) -> "Filter":
        return Filter.not_(self)

    # ------------------------------------------------------- compilation

    def mask(self, store: Optional[MetadataStore]) -> np.ndarray:
        """Compile to the ``(N,)`` bool allow-bitmap against ``store``."""
        if store is None:
            raise ValueError(
                "cannot evaluate a Filter: the engine has no metadata "
                "(pass metadata= at build/add time)"
            )
        if self.op == "and":
            out = np.ones(store.n_rows, bool)
            for c in self.children:
                out &= c.mask(store)
            return out
        if self.op == "or":
            out = np.zeros(store.n_rows, bool)
            for c in self.children:
                out |= c.mask(store)
            return out
        if self.op == "not":
            return ~self.children[0].mask(store)
        col = store.column(self.column)
        if self.op == "eq":
            return col == np.asarray(self.value)
        if self.op == "in":
            return np.isin(col, _canon(list(self.value)))
        if self.op == "range":
            lo, hi = self.value
            out = np.ones(store.n_rows, bool)
            if lo is not None:
                out &= col >= lo
            if hi is not None:
                out &= col <= hi
            return out
        raise ValueError(f"unknown filter op {self.op!r}")
