"""Carry fitted K-Means state between the JAX package and the port.

Both packages' results reduce to plain arrays: pass
`np.asarray(jax_result.centroids)` (and optionally n_iter, sse, shift,
converged) to `kmeans_state_from_numpy` to predict with the port from
centroids the JAX package fitted; `to_numpy` goes the other way.
"""

from __future__ import annotations

import numpy as np
import torch

from tdc_tpu_torch.models.kmeans import KMeansResult
from tdc_tpu_torch.utils.device import resolve_device


def kmeans_state_from_numpy(
    centroids,
    *,
    n_iter: int = 0,
    sse: float = float("nan"),
    shift: float = float("nan"),
    converged: bool = False,
    device=None,
) -> KMeansResult:
    """A KMeansResult on `device` (None = 'cuda') from numpy state."""
    dev = resolve_device(device)
    c = np.asarray(centroids, dtype=np.float32)
    if c.ndim != 2:
        raise ValueError(f"centroids must be (K, d), got {c.shape}")
    return KMeansResult(
        centroids=torch.tensor(c, device=dev),
        n_iter=int(n_iter),
        sse=torch.tensor(float(sse), dtype=torch.float32, device=dev),
        shift=torch.tensor(float(shift), dtype=torch.float32, device=dev),
        converged=bool(converged),
    )


def to_numpy(result: KMeansResult) -> dict:
    """{'centroids', 'n_iter', 'sse', 'shift', 'converged'} as numpy
    values."""
    return {
        "centroids": result.centroids.detach().cpu().numpy(),
        "n_iter": np.int32(result.n_iter),
        "sse": np.float32(float(result.sse)),
        "shift": np.float32(float(result.shift)),
        "converged": np.bool_(result.converged),
    }
