"""Vector quantization codec of the tier-2 slab (DESIGN.md §7), for the port.

A copy of the numpy-only half of ``repro.core.quant`` plus a PyTorch twin
of its jnp codec; nothing of ``repro`` is imported. The ``precision``
knob sets the slab dtype:

- ``"float32"``: identity. 4·d bytes a vector.
- ``"float16"``: elementwise round-to-nearest-even downcast (``"fp16"``
  accepted). 2·d bytes a vector.
- ``"int8"``: one symmetric scale a row, ``s = max|x| / 127`` (1.0 for an
  all-zero row), ``q = clip(round(x / s), -127, 127)`` with round half to
  even and a true division (not a multiplication by ``1/s``). d + 4 bytes
  a vector (the float32 scale rides along).

Each codec equals its counterpart in the reference bit for bit, on the
CPU and on the card, since every step is one correctly rounded IEEE
operation. The two reference codecs differ in one place, and the port
keeps the difference: ``quantize_np`` divides ``max|x|`` by 127, while
``quantize_jnp`` runs jitted inside the reference's cache insert, where
XLA computes ``max|x| · fl32(1/127)`` — one ulp apart in a few percent
of rows. :func:`quantize` (tier 2) follows the jitted form and
:func:`quantize_np` (the fused driver's tier-3 payload) the numpy one.

``"pq"`` (product quantization, DESIGN.md §12) stores M uint8 codes a
row, encoded through a trained codebook by :mod:`repro_torch.core.pq`:
its slab dtype and byte accounting live here, while :func:`quantize` and
:func:`quantize_np` refuse it, as the reference's per-row codecs do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

PRECISIONS = ("float32", "float16", "int8", "pq")

_ALIASES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "float16": "float16", "fp16": "float16", "f16": "float16",
    "int8": "int8", "i8": "int8",
    "pq": "pq", "pq8": "pq", "product": "pq",
}

# one f32 scale per vector rides along with int8 payloads
SCALE_BYTES = 4

# default number of PQ subspaces when a caller asks for "pq" capacity
# without saying how many — matches EngineConfig.pq_subspaces
DEFAULT_PQ_SUBSPACES = 8

# float32 1/127: the factor of the tier-2 codec's scale (see quantize)
_INV_127 = float(np.float32(1.0 / 127.0))

_SLAB_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "pq": torch.uint8,  # one code byte per subspace
}


def canonical_precision(precision: str) -> str:
    """Normalize a precision name (``fp16`` → ``float16``, …)."""
    try:
        return _ALIASES[str(precision).lower()]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}: expected one of {PRECISIONS}"
        ) from None


def _scalar_codec(precision: str) -> str:
    p = canonical_precision(precision)
    if p == "pq":
        raise ValueError(
            "pq rows are encoded through a trained codebook — use "
            "repro_torch.core.pq.encode/encode_np, not quantize_*"
        )
    return p


def slab_dtype(precision: str) -> torch.dtype:
    """Storage dtype of a slab at ``precision``."""
    return _SLAB_DTYPES[canonical_precision(precision)]


def precision_of(dtype: torch.dtype) -> str:
    """The precision whose slab has ``dtype``."""
    for name, dt in _SLAB_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"no precision stores {dtype}")


def bytes_per_vector(
    dim: int, precision: str, n_subspaces: Optional[int] = None
) -> int:
    """Resident bytes of ONE cached vector, its scale included. A pq row
    is M code bytes whatever ``dim`` (``n_subspaces``, default
    :data:`DEFAULT_PQ_SUBSPACES`); the shared codebook is amortized over
    the corpus and not charged per row."""
    p = canonical_precision(precision)
    if p == "float32":
        return 4 * dim
    if p == "float16":
        return 2 * dim
    if p == "pq":
        m = DEFAULT_PQ_SUBSPACES if n_subspaces is None else int(n_subspaces)
        if m <= 0:
            raise ValueError(f"n_subspaces must be > 0, got {m}")
        return m
    return dim + SCALE_BYTES  # int8 payload + f32 scale


def capacity_for_budget(
    budget_bytes: int, dim: int, precision: str,
    n_subspaces: Optional[int] = None,
) -> int:
    """How many vectors a byte budget holds at ``precision`` (≥ 1)."""
    return max(1, int(budget_bytes) // bytes_per_vector(
        dim, precision, n_subspaces=n_subspaces))


# ----------------------------------------------------------- torch codec


def quantize(
    vecs: torch.Tensor, precision: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``(..., d)`` float rows → (payload, per-row scales), on
    the rows' device. Scales are all ones for the float precisions, as
    in the reference's ``quantize_jnp``."""
    p = _scalar_codec(precision)
    vecs = vecs.to(torch.float32)
    ones = torch.ones(vecs.shape[:-1], dtype=torch.float32,
                      device=vecs.device)
    if p == "float32":
        return vecs, ones
    if p == "float16":
        return vecs.to(torch.float16), ones
    amax = vecs.abs().amax(dim=-1)
    # the reference runs quantize_jnp under jit, where XLA turns amax / 127
    # into amax * fl32(1/127): the tier-2 scales follow that form (a
    # tensor operand, so no backend rewrites it again)
    scale = amax * torch.full_like(amax, _INV_127)
    safe = torch.where(scale > 0, scale, ones)
    q = torch.clamp(torch.round(vecs / safe[..., None]), -127, 127)
    return q.to(torch.int8), safe


def dequantize(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize` → float32 rows."""
    if payload.dtype == torch.int8:
        return payload.to(torch.float32) * scales[..., None]
    return payload.to(torch.float32)


# ----------------------------------------------------------- numpy codec


def quantize_np(
    vecs: np.ndarray, precision: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side codec, bit-identical to the reference's ``quantize_np``
    (the scale divides by 127; see the module docstring)."""
    p = _scalar_codec(precision)
    vecs = np.asarray(vecs, np.float32)
    ones = np.ones(vecs.shape[:-1], np.float32)
    if p == "float32":
        return vecs, ones
    if p == "float16":
        return vecs.astype(np.float16), ones
    amax = np.max(np.abs(vecs), axis=-1)
    scale = (amax / np.float32(127.0)).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(vecs / safe[..., None]), -127, 127)
    return q.astype(np.int8), safe


def dequantize_np(payload: np.ndarray, scales: np.ndarray) -> np.ndarray:
    if payload.dtype == np.int8:
        return payload.astype(np.float32) * np.asarray(scales)[..., None]
    return np.asarray(payload, np.float32)


# ------------------------------------------------------------ error bounds


def max_abs_error(row_amax, precision: str = "int8"):
    """Per-row worst-case elementwise reconstruction error, from the
    per-row ``max|x|`` of the original rows: 0 for float32,
    ``max|x| · 2^-11`` for float16, ``(max|x| / 127) / 2`` for int8."""
    p = canonical_precision(precision)
    row_amax = np.asarray(row_amax, np.float32)
    if p == "float32":
        return np.zeros_like(row_amax)
    if p == "float16":
        return row_amax * np.float32(2.0 ** -11)
    return (row_amax / np.float32(127.0)) * np.float32(0.5)


def rerank_pool(k: int, alpha: float) -> int:
    """Exact-rerank candidate pool size: ``max(k, ceil(α·k))``."""
    return max(int(k), int(math.ceil(float(alpha) * int(k))))
