"""Product-quantization codec and ADC lookup tables (DESIGN.md §12), for
the port.

A vector is split into M contiguous subspaces of ``dsub = d / M`` dims,
each quantized to one of 256 per-subspace centroids, so a row is M uint8
codes. For a decoded vector ``x̂ = concat_m centroids[m, code_m]`` the
distance to a query decomposes over subspaces, so a per-query lookup
table ``lut[l, m, k]`` of subspace terms, built once, turns each
candidate's distance into M table lookups: the asymmetric distance
computation (ADC) that ``kernels/adc_gather_distance.py`` runs on the
card.

Two halves, as in ``repro.core.pq``:

- a copy of the reference's numpy half (:class:`PQCodebook`,
  :func:`encode_np`, :func:`decode_np`, :func:`residual_energy`,
  :func:`build_lut_np`, :func:`adc_distance_np`,
  :func:`adc_distance_batch_np`): the oracles of the tests and of
  ``chip_smoke.py``, and the fused driver's payload codec. Nothing of
  ``repro`` is imported;
- torch twins of its jnp half (:func:`encode`, :func:`decode`,
  :func:`build_lut`) on the tensors' device, and :func:`train_pq`.

The torch twins sum over a subspace's ``dsub`` dims one separate
multiply and add at a time, so each result is a chain of IEEE float32
operations that gives the same bits on the CPU and on the card. The
reference's jitted ``encode_jnp`` sums in XLA's order instead, so the
intermediate distances differ in their last bits, but the nearest
centroid (``argmin``, ties to the lowest index) is the same on every
input the tests draw.

:func:`train_pq` runs the reference's Lloyd k-means (empty clusters keep
their centroid). It draws its initial rows with a ``torch.Generator``
seeded on the CPU, which cannot reproduce ``jax.random``: its codebook
is the port's own, but the same on the card and on the CPU. Parity
tests carry the reference's codebook across
(``convert.codebook_from_reference``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

N_CENTROIDS = 256  # one uint8 code per subspace, by construction
# float32 elements of scratch a step of encode() and of a Lloyd
# iteration may hold (64 MiB and 128 MiB); larger inputs go in chunks
ENCODE_SCRATCH_FLOATS = 1 << 24
LLOYD_SCRATCH_FLOATS = 1 << 25


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    """Trained product-quantization codebook (frozen across mutations).

    ``centroids`` is ``(M, 256, dsub)`` float32 — M per-subspace
    codebooks of 256 centroids each, covering vectors of dimension
    ``M * dsub``.
    """

    centroids: np.ndarray  # (M, K, dsub) float32

    @property
    def n_subspaces(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def n_centroids(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def dsub(self) -> int:
        return int(self.centroids.shape[2])

    @property
    def dim(self) -> int:
        return self.n_subspaces * self.dsub

    def nbytes(self) -> int:
        """Resident bytes of the shared codebook (amortized, not
        charged per cached row — see ``quant.bytes_per_vector``)."""
        return int(np.asarray(self.centroids).nbytes)

    def save(self, path: str) -> None:
        """Serialize to one ``.npz`` (the ``codebook.npz`` artifact)."""
        np.savez(path, centroids=np.asarray(self.centroids, np.float32))

    @classmethod
    def load(cls, path: str) -> "PQCodebook":
        with np.load(path) as z:
            cent = np.asarray(z["centroids"], np.float32)
        if cent.ndim != 3:
            raise ValueError(
                f"codebook centroids must be (M, K, dsub), got {cent.shape}"
            )
        return cls(centroids=cent)


def _split(vecs, M: int):
    """(..., d) → (..., M, dsub) contiguous subspace view (numpy or torch)."""
    d = vecs.shape[-1]
    if d % M:
        raise ValueError(
            f"dim {d} is not divisible by n_subspaces {M} — pick M "
            f"dividing the vector dimension"
        )
    return vecs.reshape(*vecs.shape[:-1], M, d // M)


# ----------------------------------------------------------- numpy codec


def encode_np(vecs: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Host-side encoder (shard codec), chunked so the (n, M, K)
    distance scratch stays small for corpus-sized inputs."""
    cent = np.asarray(centroids, np.float32)
    M = cent.shape[0]
    vecs = np.asarray(vecs, np.float32)
    lead = vecs.shape[:-1]
    flat = vecs.reshape(-1, vecs.shape[-1])
    c2 = np.sum(cent * cent, axis=-1)  # (M, K)
    out = np.empty((flat.shape[0], M), np.uint8)
    chunk = 4096
    for lo in range(0, flat.shape[0], chunk):
        xs = np.asarray(_split(flat[lo: lo + chunk], M))  # (n, M, dsub)
        x2 = np.sum(xs * xs, axis=-1)  # (n, M)
        xc = np.einsum("nmd,mkd->nmk", xs, cent)
        d2 = x2[..., None] - 2.0 * xc + c2[None]
        out[lo: lo + chunk] = np.argmin(d2, axis=-1).astype(np.uint8)
    return out.reshape(*lead, M)


def decode_np(codes: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    cent = np.asarray(centroids, np.float32)
    M = cent.shape[0]
    codes = np.asarray(codes)
    parts = cent[np.arange(M), codes.astype(np.int64)]  # (..., M, dsub)
    return parts.reshape(*codes.shape[:-1], M * cent.shape[2])


def residual_energy(vecs: np.ndarray, codebook: PQCodebook) -> np.ndarray:
    """Per-vector squared reconstruction error ``‖x − x̂‖²``: the ADC
    distance of a row is within ``sqrt(residual_energy)`` of its true l2
    distance (triangle inequality), the error the rerank pool trades
    against."""
    vecs = np.atleast_2d(np.asarray(vecs, np.float32))
    dec = decode_np(encode_np(vecs, codebook.centroids), codebook.centroids)
    diff = vecs - dec
    return np.sum(diff * diff, axis=-1)


def lut_tables(metric: str) -> int:
    """Number of stacked tables L per query: cos needs a second
    squared-norm table; l2/ip accumulate a single one."""
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(metric)
    return 2 if metric == "cos" else 1


def build_lut_np(
    q: np.ndarray, centroids: np.ndarray, metric: str = "l2"
) -> np.ndarray:
    """Per-query ADC table ``(L, M, K)`` float32 (q against ALL centroids).

    - l2:  ``lut[0, m, k] = ‖q_m − c_mk‖²``; distance = Σ_m entries.
    - ip:  ``lut[0, m, k] = −(q_m · c_mk)``; distance = Σ_m entries.
    - cos: q is normalized here; ``lut[0] = q_m · c_mk`` and
      ``lut[1] = ‖c_mk‖²`` accumulate to (s1, s2) with the final
      distance ``−s1 / (√s2 + 1e-30)`` applied by the consumer.
    """
    cent = np.asarray(centroids, np.float32)
    M = cent.shape[0]
    q = np.asarray(q, np.float32)
    if metric == "cos":
        q = q / (np.linalg.norm(q) + np.float32(1e-30))
    qs = np.asarray(_split(q, M))  # (M, dsub)
    if metric == "l2":
        diff = qs[:, None, :] - cent
        return np.sum(diff * diff, axis=-1)[None].astype(np.float32)
    s1 = np.einsum("md,mkd->mk", qs, cent).astype(np.float32)
    if metric == "ip":
        return -s1[None]
    if metric == "cos":
        s2 = np.sum(cent * cent, axis=-1).astype(np.float32)
        return np.stack([s1, s2])
    raise ValueError(metric)


def adc_distance_np(
    codes: np.ndarray,  # (N, M) uint8
    lut: np.ndarray,  # (L, M, K) float32 — build_lut_np output
    ids: np.ndarray,  # (B,) int32, -1 padded
    metric: str = "l2",
) -> np.ndarray:
    """The numpy oracle the ADC kernel equals bit for bit.

    Gathers each candidate's code row, selects its M table entries (an
    exact gather), and sums them over subspaces SEQUENTIALLY in float32,
    left to right. +inf for padded ids; ids past the end read the last
    row.
    """
    codes = np.asarray(codes)
    lut = np.asarray(lut, np.float32)
    ids = np.asarray(ids)
    M = codes.shape[1]
    safe = np.clip(ids, 0, codes.shape[0] - 1)
    c = codes[safe].astype(np.int64)  # (B, M)
    sel = lut[:, np.arange(M)[None, :], c]  # (L, B, M) exact gather
    acc = np.zeros(sel.shape[:2], np.float32)  # (L, B)
    for m in range(M):  # sequential f32 accumulation (bit-match contract)
        acc += sel[:, :, m]
    if metric == "cos":
        d = -acc[0] / (np.sqrt(acc[1]) + np.float32(1e-30))
    else:
        d = acc[0]
    return np.where(ids >= 0, d, np.float32(np.inf)).astype(np.float32)


def adc_distance_batch_np(
    codes: np.ndarray,  # (N, M)
    luts: np.ndarray,  # (B, L, M, K) — one table per query
    ids: np.ndarray,  # (B, K_ids) int32, -1 padded
    metric: str = "l2",
) -> np.ndarray:
    """Batched numpy oracle: one LUT per id row → (B, K_ids) distances."""
    return np.stack([
        adc_distance_np(codes, luts[b], ids[b], metric)
        for b in range(len(ids))
    ])


# ----------------------------------------------------------- torch codec


def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ_j a[..., j] · b[..., j]`` (broadcast), one float32 multiply
    and one add at a time in order j = 0, 1, …: the same bits on every
    device."""
    acc = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j] * b[..., j]
    return acc


def encode(vecs: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Encode ``(..., d)`` float rows → ``(..., M)`` uint8 codes on their
    device: the nearest centroid of each subspace by ``encode_jnp``'s
    expanded form ``d2 = x2 − 2·xc + c2``, ties to the LOWEST centroid
    index, which makes re-encoding a decoded vector stable. Rows go in
    chunks whose (n, M, K) scratch stays under
    :data:`ENCODE_SCRATCH_FLOATS`."""
    cent = centroids.to(torch.float32)
    M, K = cent.shape[0], cent.shape[1]
    xs = _split(vecs.to(torch.float32), M)  # (..., M, dsub)
    lead = xs.shape[:-2]
    xs = xs.reshape(-1, M, xs.shape[-1])
    c2 = _seq_dot(cent, cent)  # (M, K)
    rows = max(1, ENCODE_SCRATCH_FLOATS // (M * K))
    out = torch.empty((xs.shape[0], M), dtype=torch.uint8, device=xs.device)
    for lo in range(0, xs.shape[0], rows):
        x = xs[lo: lo + rows]
        x2 = _seq_dot(x, x)  # (n, M)
        xc = _seq_dot(x[..., None, :], cent)  # (n, M, K)
        d2 = x2[..., None] - 2.0 * xc + c2
        out[lo: lo + rows] = torch.argmin(d2, dim=-1).to(torch.uint8)
    return out.reshape(*lead, M)


def decode(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode` → ``(..., d)`` float32: an exact gather,
    so it equals :func:`decode_np` bit for bit."""
    cent = centroids.to(torch.float32)
    M = cent.shape[0]
    sub = torch.arange(M, device=codes.device)
    parts = cent[sub, codes.long()]  # (..., M, dsub)
    return parts.reshape(*codes.shape[:-1], M * cent.shape[2])


def build_lut(
    q: torch.Tensor, centroids: torch.Tensor, metric: str = "l2"
) -> torch.Tensor:
    """Per-query ADC tables ``(..., L, M, K)`` float32 for ``(..., d)``
    queries, on their device (the layout of :func:`build_lut_np`). A
    search builds them once, not once a hop. The cos query's norm is
    summed in float64 and rounded once, so it too is the same on every
    device."""
    cent = centroids.to(torch.float32)
    M = cent.shape[0]
    q = q.to(torch.float32)
    lut_tables(metric)  # raises for an unknown metric
    if metric == "cos":
        norm = torch.linalg.vector_norm(q.double(), dim=-1, keepdim=True)
        q = q / (norm.float() + 1e-30)
    qs = _split(q, M)[..., None, :]  # (..., M, 1, dsub)
    if metric == "l2":
        diff = qs - cent
        lut = _seq_dot(diff, diff)[..., None, :, :]
    else:
        s1 = _seq_dot(qs, cent)  # (..., M, K)
        if metric == "ip":
            lut = (-s1)[..., None, :, :]
        else:
            s2 = _seq_dot(cent, cent).expand_as(s1)
            lut = torch.stack([s1, s2], dim=-3)
    return lut.contiguous()


# ---------------------------------------------------------------- training


def _lloyd_step(Xs: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration for all M subspaces: ``Xs`` (M, N, dsub),
    ``cent`` (M, K, dsub). Empty clusters keep their centroid.

    The assignment takes :func:`encode`'s form (``x2 − 2·xc + c2`` one
    IEEE operation at a time, ties to the lowest index), so it is the
    same on every device; the cluster sums are taken in float64, where a
    sum of float32 values is exact or nearly so whatever its order, and
    rounded once. So the card and the CPU train the same codebook but
    for a rare last-bit difference. The subspaces go in groups whose
    (m, N, K) scratch stays under :data:`LLOYD_SCRATCH_FLOATS`."""
    M, N, dsub = Xs.shape
    K = cent.shape[1]
    x2 = _seq_dot(Xs, Xs)  # (M, N)
    c2 = _seq_dot(cent, cent)  # (M, K)
    group = max(1, LLOYD_SCRATCH_FLOATS // max(1, N * K))
    out = []
    for lo in range(0, M, group):
        x, c = Xs[lo: lo + group], cent[lo: lo + group]
        m = x.shape[0]
        xc = _seq_dot(x[:, :, None, :], c[:, None, :, :])  # (m, N, K)
        d2 = x2[lo: lo + group, :, None] - 2.0 * xc \
            + c2[lo: lo + group, None, :]
        del xc
        assign = torch.argmin(d2, dim=2)  # (m, N)
        del d2
        counts = torch.zeros((m, K), dtype=torch.float64, device=x.device)
        counts.scatter_add_(1, assign, torch.ones_like(assign,
                                                       dtype=torch.float64))
        sums = torch.zeros((m, K, dsub), dtype=torch.float64,
                           device=x.device)
        sums.scatter_add_(1, assign[:, :, None].expand(m, N, dsub),
                          x.double())
        mean = (sums / torch.clamp(counts, min=1.0)[:, :, None]).float()
        out.append(torch.where(counts[:, :, None] > 0, mean, c))
    return torch.cat(out)


def train_pq(
    vectors: np.ndarray,
    n_subspaces: int = 8,
    n_iters: int = 15,
    seed: int = 0,
    device: DeviceLike = None,
) -> PQCodebook:
    """Train an (M × 256)-centroid codebook by per-subspace k-means on
    ``device`` (the card unless ``"cpu"``).

    The initial centroids are rows drawn with replacement by a CPU
    ``torch.Generator`` seeded with ``seed`` (the same draw on every
    device); ``n_iters`` Lloyd steps follow (see :func:`_lloyd_step`:
    the same codebook on the card and on the CPU).
    """
    dev = resolve_device(device)
    X = np.atleast_2d(np.asarray(vectors, np.float32))
    N, _ = X.shape
    M = int(n_subspaces)
    Xs = torch.as_tensor(
        np.ascontiguousarray(_split(X, M).transpose(1, 0, 2)), device=dev
    )  # (M, N, dsub)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    idx = torch.randint(0, N, (M, N_CENTROIDS), generator=gen).to(dev)
    cent = Xs[torch.arange(M, device=dev)[:, None], idx]  # (M, K, dsub)
    for _ in range(int(n_iters)):
        cent = _lloyd_step(Xs, cent)
    return PQCodebook(centroids=cent.cpu().numpy().astype(np.float32))
