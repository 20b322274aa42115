"""Synthetic Gaussian blobs (counterpart: tdc_tpu/data/synthetic.py).

The same recipe as the JAX package — K centers uniform in
[-2·class_sep, 2·class_sep]^d, uniform labels, unit Gaussian noise — drawn
from a `torch.Generator` seeded with `seed`, on the target device. The
numbers differ from the JAX package's (different generators); the
distribution is the same.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.utils.device import resolve_device


def make_blobs(seed: int, n_obs: int, n_dim: int, k: int, *,
               class_sep: float = 1.5, device=None,
               dtype: torch.dtype = torch.float32):
    """(X (n_obs, n_dim) of `dtype`, y (n_obs,) int32) on `device`
    (None = 'cuda'), sample-major. The points are drawn in float32 and
    rounded to `dtype` (bfloat16 for the CLI's --dtype bfloat16)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    centers = (torch.rand((k, n_dim), generator=g, device=dev) * 2.0 - 1.0
               ) * 2.0 * class_sep
    labels = torch.randint(0, k, (n_obs,), generator=g, device=dev)
    x = torch.randn((n_obs, n_dim), generator=g, device=dev)
    x += centers[labels]
    return x.to(dtype), labels.to(torch.int32)
