"""Plain PyTorch versions of the port's kernels.

Each ``<name>_ref`` computes what the hand-written kernel computes, in
float32. On a CPU tensor :mod:`repro_torch.kernels.ops` runs these; on the
card ``chip_smoke.py`` holds each kernel against its plain version, and
the CPU tests hold the plain versions to the JAX package's oracles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import distances

INF = float("inf")


def distance_matrix_ref(
    Q: torch.Tensor,  # (B, d) float32
    X: torch.Tensor,  # (N, d) float32
    metric: str = "l2",
) -> torch.Tensor:
    """(B, N) distances in the reference's GEMM form: l2 ``max(|q|² +
    |x|² − 2q·x, 0)``, ip ``−q·x``, cos ``−q·x / ((|q| + 1e-30)(|x| +
    1e-30))``, in float32 (a float32 matmul on the card runs without TF32
    unless asked)."""
    return distances.distance_matrix(Q.float(), X.float(), metric)


def topk_ref(D: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of a (B, N) matrix as ``(dists (B, k),
    ids (B, k) int32)``: a stable sort of each row and its first k, so ties
    go to the lower column (``lax.top_k``'s order on negated values), ids
    are distinct and ``< N``, and a NaN sorts after +inf."""
    if not 0 <= k <= D.shape[1]:
        raise ValueError(f"topk: k={k} must lie in [0, N={D.shape[1]}]")
    dists, ids = torch.sort(D.float(), dim=1, stable=True)
    return dists[:, :k].contiguous(), ids[:, :k].int().contiguous()


def distance_topk_ref(
    Q: torch.Tensor, X: torch.Tensor, k: int, metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of ``X`` to each query: :func:`topk_ref` of
    :func:`distance_matrix_ref`."""
    return topk_ref(distance_matrix_ref(Q, X, metric), k)


def gather_distance_batch_ref(
    table: torch.Tensor,  # (N, d) float32
    ids: torch.Tensor,  # (B, K) int32, -1 padded
    Q: torch.Tensor,  # (B, d) float32
    metric: str = "l2",
) -> torch.Tensor:
    """(B, K) distances of ``table[ids[b]]`` to ``Q[b]``; +inf where id < 0.

    Ids past the table's end are clipped to its last row, as the
    reference's oracle does.
    """
    B, K = ids.shape
    if table.shape[0] == 0:
        return torch.full((B, K), INF, dtype=torch.float32, device=ids.device)
    safe = ids.long().clamp(0, table.shape[0] - 1)
    x = table[safe].float()  # (B, K, d)
    q = Q.float()[:, None, :]
    if metric == "l2":
        diff = x - q
        d = (diff * diff).sum(-1)
    elif metric == "ip":
        d = -(x * q).sum(-1)
    elif metric == "cos":
        d = -(x * q).sum(-1) / (
            (torch.linalg.vector_norm(x, dim=-1) + 1e-30)
            * (torch.linalg.vector_norm(q, dim=-1) + 1e-30)
        )
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids >= 0, d, torch.full_like(d, INF))


def gather_distance_ref(
    table: torch.Tensor,  # (N, d)
    ids: torch.Tensor,  # (B,) int32, -1 padded
    q: torch.Tensor,  # (d,)
    metric: str = "l2",
) -> torch.Tensor:
    """Single-query form: the batched form at one query, so both give the
    same bits for the same row and query."""
    return gather_distance_batch_ref(table, ids[None], q[None], metric)[0]


def dequant_gather_distance_batch_ref(
    table: torch.Tensor,  # (N, d) int8 or float16 quantized payload
    scales,  # (N,) float32 per-row scales (int8), None (float16)
    ids: torch.Tensor,  # (B, K) int32, -1 padded
    Q: torch.Tensor,  # (B, d) float32
    metric: str = "l2",
) -> torch.Tensor:
    """(B, K) distances of the dequantized ``table[ids[b]]`` to ``Q[b]``;
    +inf where id < 0.

    An int8 row is ``x.float() * scale``, a float16 row ``x.float()``
    (no scale); then exactly what :func:`gather_distance_batch_ref`
    computes, on the gathered rows only.
    """
    B, K = ids.shape
    if table.shape[0] == 0:
        return torch.full((B, K), INF, dtype=torch.float32, device=ids.device)
    safe = ids.long().clamp(0, table.shape[0] - 1)
    x = table[safe].float()  # (B, K, d): the gathered rows only
    if table.dtype == torch.int8:
        x = x * scales[safe][..., None]
    elif scales is not None:
        raise ValueError("a float16 table carries no scales")
    rows = torch.arange(B * K, dtype=torch.int32, device=ids.device)
    return gather_distance_batch_ref(
        x.reshape(B * K, -1),
        torch.where(ids >= 0, rows.reshape(B, K), -1), Q, metric,
    )


def dequant_gather_distance_ref(
    table: torch.Tensor,  # (N, d) int8 or float16
    scales,  # (N,) float32 (int8) or None (float16)
    ids: torch.Tensor,  # (K,) int32, -1 padded
    q: torch.Tensor,  # (d,)
    metric: str = "l2",
) -> torch.Tensor:
    """Single-query form: the batched form at one query."""
    return dequant_gather_distance_batch_ref(
        table, scales, ids[None], q[None], metric
    )[0]


def adc_gather_distance_batch_ref(
    codes: torch.Tensor,  # (N, M) uint8 PQ codes
    luts: torch.Tensor,  # (B, L, M, 256) float32, one table per query
    ids: torch.Tensor,  # (B, K) int32, -1 padded
    metric: str = "l2",
) -> torch.Tensor:
    """(B, K) ADC distances: ``Σ_m luts[b, l, m, codes[ids[b, i], m]]``,
    summed left to right in float32 one subspace at a time; cos finishes
    with ``-s1 / (sqrt(s2) + 1e-30)``. +inf where id < 0; ids past the
    end read the last row. Equals ``pq.adc_distance_batch_np`` bit for
    bit (exact gathers, then the same chain of IEEE operations)."""
    B, K = ids.shape
    N, M = codes.shape
    if N == 0:
        return torch.full((B, K), INF, dtype=torch.float32, device=ids.device)
    L, n_cent = luts.shape[1], luts.shape[3]
    safe = ids.long().clamp(0, N - 1)
    sub = torch.arange(M, device=ids.device) * n_cent
    flat = (sub + codes[safe].long()).reshape(B, 1, K * M)  # (B, 1, K·M)
    sel = luts.reshape(B, L, M * n_cent).gather(
        2, flat.expand(B, L, K * M)).reshape(B, L, K, M)  # exact gather
    acc = torch.zeros((B, L, K), dtype=torch.float32, device=ids.device)
    for m in range(M):  # sequential float32 sum (the bit-match order)
        acc = acc + sel[..., m]
    if metric == "cos":
        # sqrt and the division are taken in float64 and rounded once to
        # float32, which is the correctly rounded float32 result on every
        # device (torch's float32 sqrt on the CPU may be one ulp off)
        root = torch.sqrt(acc[:, 1].double()).float()
        den = root + torch.full_like(root, 1e-30)
        d = (-acc[:, 0].double() / den.double()).float()
    elif metric in ("l2", "ip"):
        d = acc[:, 0]
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids >= 0, d, torch.full_like(d, INF))


def adc_gather_distance_ref(
    codes: torch.Tensor,  # (N, M) uint8
    lut: torch.Tensor,  # (L, M, 256) float32, one query's table
    ids: torch.Tensor,  # (K,) int32, -1 padded
    metric: str = "l2",
) -> torch.Tensor:
    """Single-query form: the batched form at one query (the same
    bits), equal to ``pq.adc_distance_np``."""
    return adc_gather_distance_batch_ref(
        codes, lut[None], ids[None], metric)[0]


def merge_topk_ref(
    dists: torch.Tensor,  # (B, M) float32 candidate distances
    ids: torch.Tensor,  # (B, M) int32 global ids, -1 sentinel padded
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k smallest of each row as ``(dists, ids, src)``, each (B, k).

    Entries with ``id < 0`` or a non-finite distance are sentinels and
    never win. A duplicate id keeps only its best ``(dist, position)``
    copy. Ties go to the lower input position (``lax.top_k``'s order on
    negated distances). ``src`` is each winner's input position; rows
    past the survivors come back ``(+inf, -1, -1)``.
    """
    ids = ids.int()
    B, M = dists.shape
    if k > M:  # fewer candidates than k: pad with sentinels
        dists = torch.cat(
            [dists, dists.new_full((B, k - M), INF)], dim=1
        )
        ids = torch.cat([ids, ids.new_full((B, k - M), -1)], dim=1)
        M = k
    d = dists.float()
    d = torch.where((ids >= 0) & torch.isfinite(d), d, torch.full_like(d, INF))
    # stable ascending sort: equal distances keep input-position order
    d_s, order = torch.sort(d, dim=1, stable=True)
    i_s = ids.gather(1, order)
    valid = torch.isfinite(d_s)
    # duplicate = an earlier (better-ranked) valid entry carries the same id
    same = i_s[:, :, None] == i_s[:, None, :]
    earlier = torch.ones(M, M, dtype=torch.bool, device=d.device).tril(-1)
    dup = (same & earlier & valid[:, :, None] & valid[:, None, :]).any(-1)
    keep = valid & ~dup
    # kept entries stay ascending and in position order among ties, so a
    # stable partition that moves them to the front yields the k winners
    sel = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)[1][:, :k]
    ok = keep.gather(1, sel)
    return (
        torch.where(ok, d_s.gather(1, sel), torch.full_like(d_s[:, :k], INF)),
        torch.where(ok, i_s.gather(1, sel), torch.full_like(i_s[:, :k], -1)),
        torch.where(ok, order.gather(1, sel).int(),
                    torch.full_like(i_s[:, :k], -1)),
    )


def embedding_bag_ref(
    table: torch.Tensor,  # (V, d) float32 / float16 / bfloat16
    idx: torch.Tensor,  # (B, S) int32 or int64, -1 padded
    weights: Optional[torch.Tensor] = None,  # (B, S) or None
    combiner: str = "sum",
) -> torch.Tensor:
    """Padded multi-hot embedding bag: (B, d) float32.

    Ids are clipped to [0, V − 1] and rows widened to float32; each valid
    slot (id >= 0) adds its row, times its weight where weights are given,
    one slot at a time in slot order from +0.0, so each column is the same
    chain of IEEE operations as the kernel's. A padded slot adds nothing,
    whatever its row or weight holds. ``mean`` divides by the valid slots'
    count (their weights' sum), floored at 1e-9, so an all-padding bag
    gives 0.
    """
    if combiner not in ("sum", "mean"):
        raise ValueError(combiner)
    B, S = idx.shape
    idx = idx.long()
    valid = idx >= 0
    rows = table[idx.clamp(0, table.shape[0] - 1)].float()  # (B, S, d)
    w = None if weights is None else weights.float()
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    cnt = torch.zeros((B,), dtype=torch.float32, device=table.device)
    for s in range(S):  # slot order: the kernel's summation order
        x = rows[:, s] if w is None else rows[:, s] * w[:, s, None]
        c = torch.ones_like(cnt) if w is None else w[:, s]
        acc = acc + torch.where(valid[:, s, None], x, 0.0)
        cnt = cnt + torch.where(valid[:, s], c, 0.0)
    if combiner == "sum":
        return acc
    return acc / cnt.clamp_min(1e-9)[:, None]
