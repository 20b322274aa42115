"""Validation shared by the model fits (counterpart:
tdc_tpu/models/_common.py, copied so the port imports nothing of the JAX
package)."""

from __future__ import annotations

import numpy as np
import torch


def validate_sample_weight(sample_weight, n: int, k: int,
                           device: torch.device) -> torch.Tensor:
    """Validate per-point weights and return them as an (N,) float32 tensor
    on `device`.

    One copy for kmeans and fuzzy so the error contract cannot drift. It
    rejects a wrong shape, entries that are not finite, negative entries,
    and fewer than K positive entries (weighted inits draw only from
    positive-mass points, and fewer than K of them cannot seed K distinct
    clusters).
    """
    if isinstance(sample_weight, torch.Tensor):
        sample_weight = sample_weight.detach().cpu().numpy()
    host = np.asarray(sample_weight)
    if host.shape != (n,):
        raise ValueError(f"sample_weight shape {host.shape} != ({n},)")
    if not np.isfinite(host).all():
        # NaN passes both comparisons below (NaN < 0 and NaN > 0 are
        # False) and would poison every centroid.
        raise ValueError("sample_weight entries must be finite")
    if (host < 0).any():
        raise ValueError("sample_weight entries must be nonnegative")
    n_pos = int((host > 0).sum())
    if n_pos < k:
        raise ValueError(
            f"sample_weight has only {n_pos} positive entries; "
            f"need at least K={k}"
        )
    return torch.as_tensor(host.astype(np.float32), device=device)
