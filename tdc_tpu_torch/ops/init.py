"""Centroid seeding (counterpart: tdc_tpu/ops/init.py).

Every stochastic init draws from an explicit `torch.Generator` that lives
on the points' device, so seeding runs on the card with no host round
trip. JAX's threefry and torch's generators never give the same numbers:
seeded inits match the JAX package in distribution, not in value.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.ops.distance import pairwise_sq_dist


def init_first_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """First-K-rows seeding (reference parity: initial_centers = X[0:K])."""
    return x[:k].to(torch.float32).clone()


def init_random(
    generator: torch.Generator, x: torch.Tensor, k: int
) -> torch.Tensor:
    """K distinct random rows, uniformly."""
    n = x.shape[0]
    if k > n:
        raise ValueError(f"cannot draw k={k} distinct rows from N={n}")
    idx = torch.randperm(n, generator=generator, device=x.device)[:k]
    return x[idx].to(torch.float32)


def init_kmeans_pp(
    generator: torch.Generator, x: torch.Tensor, k: int
) -> torch.Tensor:
    """k-means++ (D² sampling) on the device. Each round keeps a running
    min squared distance (N,) and draws the next center ∝ D² by a
    Gumbel top-1 over log D² — categorical sampling with no cumulative
    sum and no host synchronisation, as the JAX version does."""
    n = x.shape[0]
    xf = x.to(torch.float32)
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centers = torch.empty((k, x.shape[1]), dtype=torch.float32,
                          device=x.device)
    centers[0] = xf.index_select(0, first)[0]
    d2 = pairwise_sq_dist(xf, centers[:1])[:, 0]  # (N,)
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    for i in range(1, k):
        u = torch.rand(n, generator=generator, device=x.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-38)))
        logw = torch.where(d2 > 0, torch.log(d2), neg_inf)
        nxt = torch.argmax(logw + gumbel).reshape(1)
        c = xf.index_select(0, nxt)  # (1, d)
        centers[i] = c[0]
        d2 = torch.minimum(d2, pairwise_sq_dist(xf, c)[:, 0])
    return centers
