"""Clustering quality metrics on the device (counterpart:
tdc_tpu/analysis/metrics.py; sklearn.metrics parity).

- silhouette_score: the O(N²) pairwise work runs in row blocks, and the
  per-cluster distance sums come from a (B, N) × (N, K) one-hot product
  per block: at most a (block_rows, N) tile, never N×N.
- davies_bouldin_score / calinski_harabasz_score: O(N·K) from one pass
  of per-cluster statistics.

Labels are encoded on the host (`_encode_labels`). Per-cluster sums are
products or fixed-order segment sums (`ops/assign.segment_sum`), never
f32 atomics, so a score repeats bitwise on the card. Entry points take
`device=None` ("cuda"; "cpu" runs on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tdc_tpu_torch.models.kmeans import _as_points
from tdc_tpu_torch.ops.assign import segment_sum
from tdc_tpu_torch.ops.distance import pairwise_sq_dist
from tdc_tpu_torch.utils.device import resolve_device


def _encode_labels(labels, device) -> tuple[torch.Tensor, int]:
    """Contiguous 0..k-1 labels, encoded on the host (sklearn does the
    same before scoring): unused label ids make no empty clusters."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    uniq, enc = np.unique(np.asarray(labels), return_inverse=True)
    return torch.as_tensor(enc.reshape(-1), dtype=torch.int64,
                           device=device), len(uniq)


def _points(x, device) -> torch.Tensor:
    return _as_points(x, resolve_device(device)).float()


def silhouette_score(x, labels, *, block_rows: int = 4096,
                     device=None) -> float:
    """Mean silhouette coefficient (Euclidean). Peak memory: one
    (block_rows, N) f32 tile and the (N, K) one-hot."""
    x = _points(x, device)
    labels, k = _encode_labels(labels, x.device)
    if k < 2:
        raise ValueError("silhouette requires at least 2 clusters")
    n = x.shape[0]
    one_hot = F.one_hot(labels, k).to(torch.float32)  # (N, K)
    counts = torch.bincount(labels, minlength=k).to(torch.float32)
    block_rows = min(block_rows, n)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(0, n, block_rows):
        blk, blab = x[s:s + block_rows], labels[s:s + block_rows]
        dist = torch.sqrt(torch.clamp_min(pairwise_sq_dist(blk, x), 0.0))
        sums = dist @ one_hot  # (B, K) distances to each cluster
        own = sums.gather(1, blab[:, None])[:, 0]
        own_count = counts[blab]
        # a(i): mean distance to its own cluster, itself excluded.
        a = own / torch.clamp_min(own_count - 1.0, 1.0)
        # b(i): the least mean distance to another cluster.
        other = sums / torch.clamp_min(counts[None, :], 1.0)
        other = other.masked_fill(F.one_hot(blab, k).bool(), float("inf"))
        other = other.masked_fill(counts[None, :] <= 0, float("inf"))
        b = other.min(dim=1).values
        s_i = torch.where(
            own_count > 1.0,
            (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30),
            0.0)  # sklearn: a singleton cluster scores 0
        total += s_i.sum(dtype=torch.float64)
    return float(total / n)


def _cluster_moments(x, labels, k: int):
    """(counts, centroids, per-cluster Σ‖x−c‖², per-cluster mean distance
    to the centroid)."""
    one_hot = F.one_hot(labels, k).to(torch.float32)
    counts = torch.bincount(labels, minlength=k).to(torch.float32)
    centroids = (one_hot.T @ x) / torch.clamp_min(counts[:, None], 1.0)
    d2 = pairwise_sq_dist(x, centroids)
    own_d2 = d2.gather(1, labels[:, None])[:, 0]
    within = segment_sum(own_d2, labels, k)
    mean_dist = (segment_sum(torch.sqrt(torch.clamp_min(own_d2, 0.0)),
                             labels, k) / torch.clamp_min(counts, 1.0))
    return counts, centroids, within, mean_dist


def davies_bouldin_score(x, labels, *, device=None) -> float:
    """Mean over clusters of the worst (S_i + S_j) / ‖c_i − c_j‖ ratio."""
    x = _points(x, device)
    labels, k = _encode_labels(labels, x.device)
    if k < 2:
        raise ValueError("davies_bouldin requires at least 2 clusters")
    _, centroids, _, s = _cluster_moments(x, labels, k)
    m = torch.sqrt(torch.clamp_min(pairwise_sq_dist(centroids, centroids),
                                   0.0))
    ratio = (s[:, None] + s[None, :]) / torch.where(m > 0, m, float("inf"))
    ratio = ratio.masked_fill(torch.eye(k, dtype=torch.bool,
                                        device=x.device), float("-inf"))
    return float(ratio.max(dim=1).values.mean())


def calinski_harabasz_score(x, labels, *, device=None) -> float:
    """(between / (k−1)) / (within / (n−k))."""
    x = _points(x, device)
    labels, k = _encode_labels(labels, x.device)
    n = x.shape[0]
    if k < 2:
        raise ValueError("calinski_harabasz requires at least 2 clusters")
    counts, centroids, within, _ = _cluster_moments(x, labels, k)
    grand = x.mean(dim=0)
    between = float((counts * ((centroids - grand[None, :]) ** 2).sum(
        dim=1)).sum())
    w = float(within.sum())
    if w == 0.0:
        return 1.0  # sklearn's value when every point is on its mean
    return between * (n - k) / (w * max(k - 1, 1))


__all__ = [
    "silhouette_score",
    "davies_bouldin_score",
    "calinski_harabasz_score",
]
