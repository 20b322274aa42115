"""Synthetic Gaussian blobs and the reference's .npz layout (counterpart:
tdc_tpu/data/synthetic.py).

The same recipe as the JAX package — K centers uniform in
[-2·class_sep, 2·class_sep]^d, uniform labels, unit Gaussian noise — drawn
from a `torch.Generator` seeded with `seed`, on the target device. The
numbers differ from the JAX package's (different generators); the
distribution is the same. layout='features' generates the (d, N) storage
directly; its centers and labels are the samples layout's, its noise is
drawn in the transposed shape.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.utils.device import resolve_device


# Columns per step of the features layout's center add: bounds its (d,
# chunk) gather to ~0.5 GB at any d.
_FEATURE_CHUNK_BYTES = 1 << 29


def make_blobs(seed: int, n_obs: int, n_dim: int, k: int, *,
               class_sep: float = 1.5, device=None,
               dtype: torch.dtype = torch.float32, layout: str = "samples"):
    """(X, y (n_obs,) int32) on `device` (None = 'cuda'): X is
    (n_obs, n_dim) for layout='samples' or (n_dim, n_obs) for
    layout='features', drawn in float32 and rounded to `dtype` (bfloat16
    for the CLI's --dtype bfloat16). The features layout is generated in
    that shape, its centers added in column chunks, so no (n_obs, n_dim)
    buffer exists."""
    if layout not in ("samples", "features"):
        raise ValueError(f"unknown layout {layout!r}")
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    centers = (torch.rand((k, n_dim), generator=g, device=dev) * 2.0 - 1.0
               ) * 2.0 * class_sep
    labels = torch.randint(0, k, (n_obs,), generator=g, device=dev)
    if layout == "samples":
        x = torch.randn((n_obs, n_dim), generator=g, device=dev)
        x += centers[labels]
    else:
        x = torch.randn((n_dim, n_obs), generator=g, device=dev)
        ct = centers.T.contiguous()
        step = max(1, _FEATURE_CHUNK_BYTES // (4 * max(n_dim, 1)))
        for s in range(0, n_obs, step):
            x[:, s:s + step] += ct[:, labels[s:s + step]]
    return x.to(dtype), labels.to(torch.int32)


def make_classification_data(seed: int, n_obs: int, n_dim: int, *,
                             class_sep: float = 1.5, device=None):
    """The 2-class variant of the reference's make_data signature
    (n_classes=2, class_sep=1.5): `make_blobs` with K=2."""
    return make_blobs(seed, n_obs, n_dim, 2, class_sep=class_sep,
                      device=device)


def save_npz(filepath: str, x, y) -> None:
    """Write the reference's .npz layout (keys 'X', 'Y'); tensors are
    copied to the host first."""
    import numpy as np

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    np.savez(filepath, X=host(x), Y=host(y))
