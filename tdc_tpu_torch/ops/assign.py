"""Assignment, Lloyd and fuzzy sufficient statistics (counterpart:
tdc_tpu/ops/assign.py).

The stats contraction is the JAX package's one-hot matmul:
one_hot(assign, K)ᵀ @ x gives the (K, d) per-cluster sums and the one-hot
column sums give the counts. A matmul sums in a fixed order, so the XLA
twin stays bitwise repeatable on the card (an `index_add_` would use
float atomics there). Empty clusters keep their previous centroid
(`apply_centroid_update`).

Fuzzy C-Means statistics (`FuzzyStats`, `fuzzy_memberships`,
`fuzzy_stats` and its N-blocked forms) follow the JAX formula exactly:
u = (d² + eps)^(−1/(m−1)) normalised over K, μ = u^m, then Σμx, Σμ and
Σμd².

The sample-weighted twins (`lloyd_stats_weighted`, `fuzzy_stats_weighted`
and their N-blocked forms) scale each row's one-hot or μ row by its weight
w ≥ 0, so the same contraction gives Σw·x (Σw·μx) and the column sums give
the weight mass. They run in f32. A blocked form pads its ragged tail
with zero-weight rows, which add exactly nothing, so it needs no
correction term.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tdc_tpu_torch.ops.distance import pairwise_sq_dist


class SufficientStats(NamedTuple):
    """Lloyd sufficient statistics."""

    sums: torch.Tensor  # (K, d) Σx per cluster, f32
    counts: torch.Tensor  # (K,) points per cluster, f32
    sse: torch.Tensor  # () sum of min squared distances, f32


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Hard assignment: argmin over squared distances, smallest index on
    ties (int32)."""
    return torch.argmin(pairwise_sq_dist(x, centroids), dim=-1).to(torch.int32)


def cluster_stats(
    x: torch.Tensor, assign: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx per cluster (K, d), counts (K,)) from a precomputed assignment,
    via the one-hot matmul (exact one-hot, f32 accumulation)."""
    one_hot = F.one_hot(assign.long(), k).to(torch.float32)  # (N, K)
    sums = one_hot.T @ x.float()
    counts = one_hot.sum(dim=0)
    return sums, counts


def lloyd_stats(x: torch.Tensor, centroids: torch.Tensor) -> SufficientStats:
    """Distance → argmin → one-hot-matmul sufficient stats."""
    d2 = pairwise_sq_dist(x, centroids)
    mind, assign = torch.min(d2, dim=-1)
    sums, counts = cluster_stats(x, assign, centroids.shape[0])
    return SufficientStats(sums=sums, counts=counts, sse=mind.sum())


def assign_refined(
    x: torch.Tensor, centroids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, exact min d²) with exact-distance champion refinement: the
    matmul form nominates the top-2 centroids per point and the exact
    subtract-square form picks the winner among them."""
    xf = x.float()
    cf = centroids.float()
    if cf.shape[0] == 1:
        diff = xf - cf[0]
        return (
            torch.zeros(x.shape[0], dtype=torch.int32, device=x.device),
            (diff * diff).sum(dim=-1),
        )
    d2 = pairwise_sq_dist(xf, cf)
    # The two nominees in jax.lax.top_k's order: the lower index first
    # among equal values (torch.topk gives no order among equal values).
    # torch.argmin returns the first minimal index.
    first = torch.argmin(d2, dim=-1)
    d2 = d2.scatter(1, first[:, None], torch.inf)
    idx2 = torch.stack([first, torch.argmin(d2, dim=-1)], dim=1)  # (N, 2)
    diff = xf[:, None, :] - cf[idx2]  # (N, 2, d)
    e = (diff * diff).sum(dim=-1)  # (N, 2) exact distances
    mind, pick = torch.min(e, dim=-1)
    labels = torch.gather(idx2, 1, pick[:, None])[:, 0]
    return labels.to(torch.int32), mind


def lloyd_stats_refined(
    x: torch.Tensor, centroids: torch.Tensor
) -> SufficientStats:
    """lloyd_stats with exact-distance champion refinement."""
    labels, mind = assign_refined(x, centroids)
    sums, counts = cluster_stats(x, labels, centroids.shape[0])
    return SufficientStats(sums=sums, counts=counts, sse=mind.sum())


def _sum_blocks(block_stats, n: int, block_rows: int):
    """block_stats(start, end) summed field by field over the N-blocks, in
    block order."""
    total = None
    for s in range(0, n, block_rows):
        st = block_stats(s, s + block_rows)
        total = st if total is None else type(st)(
            *(a + b for a, b in zip(total, st)))
    return total


def lloyd_stats_weighted(x: torch.Tensor, centroids: torch.Tensor,
                         sample_weight: torch.Tensor) -> SufficientStats:
    """Weighted Lloyd stats: Σ w·x per cluster, the weight mass per cluster
    as `counts`, and SSE = Σ w·min d²."""
    d2 = pairwise_sq_dist(x, centroids)
    mind, assign = torch.min(d2, dim=-1)
    w = sample_weight.float()
    one_hot_w = (F.one_hot(assign, centroids.shape[0]).to(torch.float32)
                 * w[:, None])
    return SufficientStats(sums=one_hot_w.T @ x.float(),
                           counts=one_hot_w.sum(dim=0), sse=(w * mind).sum())


def _pad_weighted(x: torch.Tensor, w: torch.Tensor, block_rows: int):
    """x and w zero-padded to a multiple of block_rows rows."""
    pad = (-x.shape[0]) % block_rows
    if not pad:
        return x, w
    return F.pad(x, (0, 0, 0, pad)), F.pad(w, (0, pad))


def lloyd_stats_weighted_blocked(x: torch.Tensor, centroids: torch.Tensor,
                                 sample_weight: torch.Tensor,
                                 block_rows: int) -> SufficientStats:
    """lloyd_stats_weighted over N-blocks, summed in block order, for any N:
    the ragged tail is padded with zero-weight rows."""
    x, w = _pad_weighted(x, sample_weight, block_rows)
    return _sum_blocks(lambda s, e: lloyd_stats_weighted(x[s:e], centroids,
                                                         w[s:e]),
                       x.shape[0], block_rows)


def lloyd_stats_blocked(
    x: torch.Tensor, centroids: torch.Tensor, block_rows: int, stats_fn=None
) -> SufficientStats:
    """lloyd_stats over N-blocks, summed in block order, so the (block, K)
    intermediates stay bounded. Requires N % block_rows == 0."""
    if stats_fn is None:
        stats_fn = lloyd_stats
    n = x.shape[0]
    if n % block_rows != 0:
        raise ValueError(f"N={n} not divisible by block_rows={block_rows}")
    return _sum_blocks(lambda s, e: stats_fn(x[s:e], centroids), n,
                       block_rows)


def lloyd_stats_padded_blocked(
    x: torch.Tensor, centroids: torch.Tensor, block_rows: int, stats_fn=None
) -> SufficientStats:
    """lloyd_stats_blocked for any N: zero-pads to a block multiple and
    subtracts the padding's exact contribution (a zero row lands on the
    argmin-‖c‖² cluster with zero Σx and sse ‖c‖²; that holds for the
    refined stats too)."""
    n_fake = (-x.shape[0]) % block_rows
    xp = F.pad(x, (0, 0, 0, n_fake)) if n_fake else x
    stats = lloyd_stats_blocked(xp, centroids, block_rows, stats_fn)
    if n_fake == 0:
        return stats
    cf = centroids.float()
    c2 = (cf * cf).sum(dim=-1)
    j = torch.argmin(c2)
    counts = stats.counts.clone()
    counts[j] -= float(n_fake)
    return SufficientStats(
        sums=stats.sums, counts=counts, sse=stats.sse - n_fake * c2[j]
    )


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                k: int) -> torch.Tensor:
    """(k,) f32 sums of `values` by segment id in [0, k), the same bits on
    every run and device: rows in a stable sort by segment, one f64
    running sum, each segment's sum the difference of its ends (an
    `index_add_` would add f32 atomics in no fixed order on CUDA)."""
    seg = segments.long()
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=k)
    run = torch.cat([torch.zeros(1, dtype=torch.float64,
                                 device=values.device),
                     torch.cumsum(values.double()[order], 0)])
    ends = torch.cumsum(counts, 0)
    return (run[ends] - run[ends - counts]).float()


def apply_centroid_update(
    stats: SufficientStats, prev_centroids: torch.Tensor
) -> torch.Tensor:
    """New centroids = Σx / count; an empty cluster keeps its previous
    centroid."""
    counts = stats.counts[:, None]
    new = stats.sums / torch.where(counts > 0, counts, torch.ones_like(counts))
    return torch.where(counts > 0, new, prev_centroids.to(new.dtype))


class FuzzyStats(NamedTuple):
    """Fuzzy C-Means sufficient statistics."""

    weighted_sums: torch.Tensor  # (K, d) Σ u^m x, f32
    weights: torch.Tensor  # (K,) Σ u^m, f32
    objective: torch.Tensor  # () Σ u^m d², the objective J_m, f32


def _memberships_from_d2(d2: torch.Tensor, m: float,
                         eps: float) -> torch.Tensor:
    """u = (d² + eps)^(−1/(m−1)) normalised over K; eps keeps a point that
    sits exactly on a centroid at full membership there instead of NaN."""
    inv = (d2 + eps) ** (-1.0 / (m - 1.0))
    return inv / inv.sum(dim=-1, keepdim=True)


def fuzzy_memberships(x: torch.Tensor, centroids: torch.Tensor,
                      m: float = 2.0, eps: float = 1e-9) -> torch.Tensor:
    """Fuzzy membership matrix U (N, K), from matmul-form squared
    distances."""
    return _memberships_from_d2(pairwise_sq_dist(x, centroids), m, eps)


def fuzzy_stats(x: torch.Tensor, centroids: torch.Tensor, m: float = 2.0,
                eps: float = 1e-9) -> FuzzyStats:
    """Memberships → μ = u^m → (μᵀx, Σμ, Σμd²), with an (N, K) matrix."""
    d2 = pairwise_sq_dist(x, centroids)
    mu = _memberships_from_d2(d2, m, eps) ** m
    return FuzzyStats(weighted_sums=mu.T @ x.float(), weights=mu.sum(dim=0),
                      objective=(mu * d2).sum())


def fuzzy_stats_blocked(x: torch.Tensor, centroids: torch.Tensor, m: float,
                        block_rows: int) -> FuzzyStats:
    """fuzzy_stats over N-blocks, summed in block order (memberships are
    row-local, so fuzzy stats block exactly like Lloyd stats). Requires
    N % block_rows == 0."""
    n = x.shape[0]
    if n % block_rows != 0:
        raise ValueError(f"N={n} not divisible by block_rows={block_rows}")
    return _sum_blocks(lambda s, e: fuzzy_stats(x[s:e], centroids, m=m), n,
                       block_rows)


def fuzzy_stats_padded_blocked(x: torch.Tensor, centroids: torch.Tensor,
                               m: float, block_rows: int) -> FuzzyStats:
    """fuzzy_stats_blocked for any N: zero-pads to a block multiple and
    subtracts the padding's exact contribution (a zero row's memberships
    depend only on ‖c‖²: they add to the weights and the objective, not to
    Σμx)."""
    n_fake = (-x.shape[0]) % block_rows
    xp = F.pad(x, (0, 0, 0, n_fake)) if n_fake else x
    stats = fuzzy_stats_blocked(xp, centroids, m, block_rows)
    if n_fake == 0:
        return stats
    zs = fuzzy_stats(x.new_zeros((1, x.shape[1])), centroids, m=m)
    return FuzzyStats(
        weighted_sums=stats.weighted_sums,
        weights=stats.weights - n_fake * zs.weights,
        objective=stats.objective - n_fake * zs.objective,
    )


def fuzzy_stats_weighted(x: torch.Tensor, centroids: torch.Tensor,
                         sample_weight: torch.Tensor, m: float = 2.0,
                         eps: float = 1e-9) -> FuzzyStats:
    """Sample-weighted fuzzy stats, J = Σᵢ wᵢ Σⱼ uᵢⱼ^m d²ᵢⱼ. Memberships do
    not depend on w; each row's μ = u^m is scaled by its weight."""
    d2 = pairwise_sq_dist(x, centroids)
    mu = (_memberships_from_d2(d2, m, eps) ** m
          * sample_weight.float()[:, None])
    return FuzzyStats(weighted_sums=mu.T @ x.float(), weights=mu.sum(dim=0),
                      objective=(mu * d2).sum())


def fuzzy_stats_weighted_blocked(x: torch.Tensor, centroids: torch.Tensor,
                                 sample_weight: torch.Tensor, m: float,
                                 block_rows: int) -> FuzzyStats:
    """fuzzy_stats_weighted over N-blocks, summed in block order, for any N:
    the ragged tail is padded with zero-weight rows."""
    x, w = _pad_weighted(x, sample_weight, block_rows)
    return _sum_blocks(lambda s, e: fuzzy_stats_weighted(x[s:e], centroids,
                                                         w[s:e], m=m),
                       x.shape[0], block_rows)
