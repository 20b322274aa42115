"""Carry fitted K-Means, Fuzzy C-Means and Gaussian Mixture state between
the JAX package and the port.

The packages' results reduce to plain arrays: pass
`np.asarray(jax_result.centroids)` (and optionally n_iter, sse or
objective, shift, converged, and the (n_iter, 2) history, as
`fuzzy_fit_sharded` returns it) to `kmeans_state_from_numpy` or
`fuzzy_state_from_numpy`, or a GMMResult's means, variances, weights and
covariance_type to `gmm_state_from_numpy`, to predict and score with the
port from a model the JAX package fitted; `to_numpy` goes the other way
for any of the three results.
"""

from __future__ import annotations

import numpy as np
import torch

from tdc_tpu_torch.models.fuzzy import FuzzyCMeansResult
from tdc_tpu_torch.models.gmm import COVARIANCE_TYPES, GMMResult
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
    history=None,
    device=None,
) -> FuzzyCMeansResult:
    """A FuzzyCMeansResult on `device` (None = 'cuda') from numpy state;
    `history` is the (n_iter, 2) [objective, shift] array, kept as
    numpy."""
    return FuzzyCMeansResult(
        n_iter=int(n_iter), converged=bool(converged),
        history=None if history is None else np.asarray(history, np.float32),
        **_state(centroids, device, objective=objective, shift=shift))


def gmm_state_from_numpy(
    means,
    variances,
    weights,
    covariance_type: str = "diag",
    *,
    n_iter: int = 0,
    log_likelihood: float = float("nan"),
    converged: bool = False,
    device=None,
) -> GMMResult:
    """A GMMResult on `device` (None = 'cuda') from numpy state; the
    variances take the covariance type's shape (diag (K, d), spherical
    (K,), tied (d, d), full (K, d, d))."""
    if covariance_type not in COVARIANCE_TYPES:
        raise ValueError(
            f"covariance_type must be one of {COVARIANCE_TYPES}, "
            f"got {covariance_type!r}")
    state = _state(means, device, log_likelihood=log_likelihood)
    m = state.pop("centroids")
    k, d = m.shape
    var = np.asarray(variances, dtype=np.float32)
    want = {"diag": (k, d), "spherical": (k,), "tied": (d, d),
            "full": (k, d, d)}[covariance_type]
    if var.shape != want:
        raise ValueError(f"{covariance_type} variances must be {want}, got "
                         f"{var.shape}")
    w = np.asarray(weights, dtype=np.float32)
    if w.shape != (k,):
        raise ValueError(f"weights must be ({k},), got {w.shape}")
    return GMMResult(
        means=m, variances=torch.tensor(var, device=m.device),
        weights=torch.tensor(w, device=m.device), n_iter=int(n_iter),
        converged=bool(converged), covariance_type=covariance_type,
        **state)


def to_numpy(result: KMeansResult | FuzzyCMeansResult | GMMResult) -> dict:
    """As numpy values: {'centroids', 'n_iter', 'sse' or 'objective',
    'shift', 'converged'} for K-Means and Fuzzy C-Means; {'means',
    'variances', 'weights', 'n_iter', 'log_likelihood', 'converged',
    'covariance_type'} for a GMM."""
    if isinstance(result, GMMResult):
        return {
            "means": result.means.detach().cpu().numpy(),
            "variances": result.variances.detach().cpu().numpy(),
            "weights": result.weights.detach().cpu().numpy(),
            "n_iter": np.int32(result.n_iter),
            "log_likelihood": np.float32(float(result.log_likelihood)),
            "converged": np.bool_(result.converged),
            "covariance_type": result.covariance_type,
        }
    cost = "sse" if isinstance(result, KMeansResult) else "objective"
    out = {
        "centroids": result.centroids.detach().cpu().numpy(),
        "n_iter": np.int32(result.n_iter),
        cost: np.float32(float(getattr(result, cost))),
        "shift": np.float32(float(result.shift)),
        "converged": np.bool_(result.converged),
    }
    if result.history is not None:
        out["history"] = np.asarray(result.history, np.float32)
    return out
