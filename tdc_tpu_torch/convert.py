"""Carry fitted K-Means and Fuzzy C-Means state between the JAX package and
the port.

Both packages' results reduce to plain arrays: pass
`np.asarray(jax_result.centroids)` (and optionally n_iter, sse or
objective, shift, converged) to `kmeans_state_from_numpy` or
`fuzzy_state_from_numpy` to predict with the port from centroids the JAX
package fitted; `to_numpy` goes the other way for either result.
"""

from __future__ import annotations

import numpy as np
import torch

from tdc_tpu_torch.models.fuzzy import FuzzyCMeansResult
from tdc_tpu_torch.models.kmeans import KMeansResult
from tdc_tpu_torch.utils.device import resolve_device


def _state(centroids, device, **scalars) -> dict:
    dev = resolve_device(device)
    c = np.asarray(centroids, dtype=np.float32)
    if c.ndim != 2:
        raise ValueError(f"centroids must be (K, d), got {c.shape}")
    out = {"centroids": torch.tensor(c, device=dev)}
    for name, value in scalars.items():
        out[name] = torch.tensor(float(value), dtype=torch.float32,
                                 device=dev)
    return out


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
    return KMeansResult(n_iter=int(n_iter), converged=bool(converged),
                        **_state(centroids, device, sse=sse, shift=shift))


def fuzzy_state_from_numpy(
    centroids,
    *,
    n_iter: int = 0,
    objective: float = float("nan"),
    shift: float = float("nan"),
    converged: bool = False,
    device=None,
) -> FuzzyCMeansResult:
    """A FuzzyCMeansResult on `device` (None = 'cuda') from numpy state."""
    return FuzzyCMeansResult(
        n_iter=int(n_iter), converged=bool(converged),
        **_state(centroids, device, objective=objective, shift=shift))


def to_numpy(result: KMeansResult | FuzzyCMeansResult) -> dict:
    """{'centroids', 'n_iter', 'sse' or 'objective', 'shift', 'converged'}
    as numpy values."""
    cost = "sse" if isinstance(result, KMeansResult) else "objective"
    return {
        "centroids": result.centroids.detach().cpu().numpy(),
        "n_iter": np.int32(result.n_iter),
        cost: np.float32(float(getattr(result, cost))),
        "shift": np.float32(float(result.shift)),
        "converged": np.bool_(result.converged),
    }
