"""Worker liveness heartbeats (counterpart: tdc_tpu/utils/heartbeat.py).

A supervisor sets TDC_HEARTBEAT_FILE (the JAX package's variable, so
either package's supervisor can watch a port worker) and treats a file
that stops changing as a hang. Without the variable a beat does nothing,
so library code calls maybe_beat() unconditionally.
"""

from __future__ import annotations

import os
import time

_last_beat = 0.0


def maybe_beat(min_interval: float = 1.0, progress=None) -> None:
    """Touch $TDC_HEARTBEAT_FILE, at most once per `min_interval`
    seconds; `progress` (e.g. "iter=4 batch=7") becomes the file's
    content, for a postmortem. Never raises: an unwritable file must not
    take down the fit it reports on."""
    global _last_beat
    path = os.environ.get("TDC_HEARTBEAT_FILE")
    if not path:
        return
    now = time.monotonic()
    if now - _last_beat < min_interval:
        return
    _last_beat = now
    try:
        if progress is None:
            with open(path, "a"):
                pass
        else:
            with open(path, "w") as f:
                f.write(str(progress))
        os.utime(path, None)
    except OSError:
        pass
