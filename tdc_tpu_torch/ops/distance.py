"""Pairwise distances in matmul form (counterpart: tdc_tpu/ops/distance.py).

    ||x - c||^2 = ||x||^2 - 2 x . c^T + ||c||^2

The dominant cost is one (N, d) x (d, K) f32 matmul with an (N, K) output
and no rank-3 intermediate. TF32 is off (utils/device.py), so the product
keeps full f32 precision like the JAX package's HIGHEST-precision dot.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.utils import device as _device  # noqa: F401  (f32 policy)


def pairwise_sq_dist(
    x: torch.Tensor,
    centroids: torch.Tensor,
    *,
    center: bool = False,
    shifted: bool = False,
) -> torch.Tensor:
    """(N, K) squared Euclidean distances, clamped at 0.

    center: subtract the centroid mean from both operands first (exact —
      distances are translation-invariant — and it removes the ‖x‖²·eps
      cancellation term when the data sits far from the origin).
    shifted: drop the row-constant ‖x‖² term and the clamp: returns
      ‖c‖² − 2x·c, whose per-row argmin is the same assignment. This is
      the form the distance-argmin kernels compute.
    """
    if center and shifted:
        raise ValueError(
            "center=True and shifted=True cannot combine: the shifted "
            "form's dropped constant would be the centered Σ‖x−μ‖², not "
            "Σ‖x‖² — the add-back recipe breaks"
        )
    x = x.float()
    centroids = centroids.float()
    if center:
        mu = centroids.mean(dim=0)
        x = x - mu
        centroids = centroids - mu
    c_sq = (centroids * centroids).sum(dim=-1)  # (K,)
    cross = x @ centroids.T  # (N, K)
    if shifted:
        return c_sq - 2.0 * cross
    x_sq = (x * x).sum(dim=-1, keepdim=True)  # (N, 1)
    return torch.clamp_min(x_sq - 2.0 * cross + c_sq, 0.0)


def pairwise_sq_dist_direct(
    x: torch.Tensor, centroids: torch.Tensor, *, block_rows: int = 4096
) -> torch.Tensor:
    """Exact (x−c)² squared distances, blocked over N so the
    (block, K, d) difference tensor stays bounded."""
    x = x.float()
    c = centroids.float()
    out = []
    for s in range(0, x.shape[0], block_rows):
        diff = x[s:s + block_rows, None, :] - c[None, :, :]
        out.append((diff * diff).sum(dim=-1))
    if not out:
        return x.new_zeros((0, c.shape[0]))
    return torch.cat(out)


def pairwise_dist(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Euclidean distance (N, K)."""
    return torch.sqrt(pairwise_sq_dist(x, centroids))


def cosine_similarity(x: torch.Tensor,
                      centroids: torch.Tensor) -> torch.Tensor:
    """(N, K) cosine similarity for spherical K-Means: rows and centroids
    L2-normalized (norms clamped at 1e-12), then one f32 product (TF32
    off, as the JAX version's HIGHEST precision)."""
    x = x.float()
    c = centroids.float()
    x_n = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                              1e-12)
    c_n = c / torch.clamp_min(torch.linalg.norm(c, dim=-1, keepdim=True),
                              1e-12)
    return x_n @ c_n.T
