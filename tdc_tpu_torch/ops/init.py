"""Centroid seeding (counterpart: tdc_tpu/ops/init.py).

Every stochastic init draws from an explicit `torch.Generator` that lives
on the points' device, so seeding runs on the card with no host round
trip. JAX's threefry and torch's generators never give the same numbers:
seeded inits match the JAX package in distribution, not in value.

With `sample_weight` the draws follow the weights, as sklearn's do:
`init_random` takes K distinct rows ∝ w and k-means++ takes its first
center ∝ w and every later one ∝ w·D², so a zero-weight point never
seeds. Without weights the generator calls and their order are those of
the unweighted version, so seeded unweighted results do not move.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.ops.distance import pairwise_sq_dist


def init_first_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """First-K-rows seeding (reference parity: initial_centers = X[0:K])."""
    return x[:k].to(torch.float32).clone()


def _gumbel(generator: torch.Generator, n: int,
            device: torch.device) -> torch.Tensor:
    """(N,) standard Gumbel noise from one torch.rand draw."""
    u = torch.rand(n, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(1e-38)))


def _log_mass(v: torch.Tensor) -> torch.Tensor:
    """log v where v > 0, -inf elsewhere (a point that can never be drawn)."""
    return torch.where(v > 0, torch.log(v), float("-inf"))


def _weights(sample_weight, x: torch.Tensor):
    if sample_weight is None:
        return None
    return torch.as_tensor(sample_weight, dtype=torch.float32,
                           device=x.device)


def init_random(
    generator: torch.Generator, x: torch.Tensor, k: int, sample_weight=None
) -> torch.Tensor:
    """K distinct random rows: uniformly, or ∝ sample_weight (Gumbel top-K
    over log w, which draws K rows without replacement ∝ w)."""
    n = x.shape[0]
    if k > n:
        raise ValueError(f"cannot draw k={k} distinct rows from N={n}")
    w = _weights(sample_weight, x)
    if w is None:
        idx = torch.randperm(n, generator=generator, device=x.device)[:k]
    else:
        if int((w > 0).sum()) < k:
            raise ValueError(
                f"fewer than k={k} points carry positive sample_weight")
        keys = _log_mass(w) + _gumbel(generator, n, x.device)
        idx = torch.topk(keys, k).indices
    return x[idx].to(torch.float32)


def init_kmeans_pp(
    generator: torch.Generator, x: torch.Tensor, k: int, sample_weight=None
) -> torch.Tensor:
    """k-means++ (D² sampling) on the device. Each round keeps a running
    min squared distance (N,) and draws the next center ∝ D² (∝ w·D² with
    weights) by a Gumbel top-1 over its log — categorical sampling with no
    cumulative sum and no host synchronisation, as the JAX version does.
    The first center is uniform, or a Gumbel top-1 over log w."""
    n = x.shape[0]
    xf = x.to(torch.float32)
    w = _weights(sample_weight, x)
    if w is None:
        first = torch.randint(0, n, (1,), generator=generator,
                              device=x.device)
    else:
        first = torch.argmax(
            _log_mass(w) + _gumbel(generator, n, x.device)).reshape(1)
    centers = torch.empty((k, x.shape[1]), dtype=torch.float32,
                          device=x.device)
    centers[0] = xf.index_select(0, first)[0]
    d2 = pairwise_sq_dist(xf, centers[:1])[:, 0]  # (N,)
    for i in range(1, k):
        gumbel = _gumbel(generator, n, x.device)
        logw = _log_mass(d2 if w is None else w * d2)
        nxt = torch.argmax(logw + gumbel).reshape(1)
        c = xf.index_select(0, nxt)  # (1, d)
        centers[i] = c[0]
        d2 = torch.minimum(d2, pairwise_sq_dist(xf, c)[:, 0])
    return centers
