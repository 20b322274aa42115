"""The streamed fits' batch screen (counterpart: tdc_tpu/data/ingest.py,
the `screen_batch` and `IngestAbort` parts, copied so the port imports
nothing of the JAX package).

Every batch of a streamed fit passes `screen_batch` on the host before
it is copied to the device: the width contract and one min/max scan for
non-finite values. The JAX package's strict default policy
(`max_bad_fraction=0.0`) ends a fit at the first bad batch with
`IngestAbort`; that is the only policy here. Retries, quarantine and a
tolerated bad fraction are ROADMAP.md Queue A, A7(d).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class IngestAbort(RuntimeError):
    """A streamed batch failed the screen: the fit stops rather than
    cluster non-finite or misshapen rows."""


def _finite_range(v) -> bool:
    """Whether every value is finite, from the minimum and the maximum
    alone (NaN propagates into both): one pass, no mask the size of v."""
    if isinstance(v, torch.Tensor):
        return bool(torch.isfinite(torch.stack(torch.aminmax(v))).all())
    lo, hi = np.min(v), np.max(v)
    return math.isfinite(float(lo)) and math.isfinite(float(hi))


def screen_batch(x, *, d: int | None = None, w=None) -> str | None:
    """Integrity screen for one batch: None when clean, else a short
    reason. Checks the feature-width/shape contract and scans for
    non-finite values (numpy: min and max, NaN poisoning both ends; a
    tensor: isfinite on its own device); weighted streams also scan the
    weight row. The JAX version screens host batches only and passes
    device arrays unscreened; the port's streamed fits screen each batch
    on the card after its copy, where the scan is one reduction and one
    scalar read."""
    if x.ndim != 2 or (d is not None and x.shape[1] != d):
        return f"bad_shape:{tuple(x.shape)}"
    if x.shape[0] and x.shape[1] and not _finite_range(x):
        return "nonfinite"
    if w is not None and len(w) and not _finite_range(w):
        return "nonfinite_weights"
    return None
