"""Structured JSONL event logging — the port's own copy of
tdc_tpu/utils/structlog.py (same record shape, so both packages' run logs
parse alike).

One JSON object per line: {"ts", "event", ...fields}. Cheap, append-only,
greppable; the CSV stays the canonical results matrix, this is the run log.
"""

from __future__ import annotations

import json
import os
import sys
import time

# Gang process index, stamped on every record once distributed init has
# resolved it. The port is single-process in this slice, so it stays None
# unless a caller sets it.
_PROCESS_INDEX: int | None = None


def set_process_index(index: int | None) -> None:
    """Record this process's gang index for log attribution (multihost
    init calls this; None clears — tests)."""
    global _PROCESS_INDEX
    _PROCESS_INDEX = None if index is None else int(index)


def process_index() -> int | None:
    return _PROCESS_INDEX


def _stamp(rec: dict) -> dict:
    """pid always, process_index when distributed init resolved one.
    Stamped BEFORE caller fields so an explicit pid=/process_index=
    field wins (the supervisor echoes workers' records verbatim)."""
    rec["pid"] = os.getpid()
    if _PROCESS_INDEX is not None:
        rec["process_index"] = _PROCESS_INDEX
    return rec


def emit(event: str, **fields) -> None:
    """One ad-hoc JSONL ops/recovery event: always to stderr, and appended
    to $TDC_RUNLOG when set.

    The module-function twin of RunLog.event for code that has no RunLog
    plumbed through (checkpoint restore fallbacks, the gang supervisor's
    echo): recovery events land machine-parseable next to the serve
    request log instead of as raw prose on stderr. Never raises.
    """
    rec = _stamp({"ts": round(time.time(), 3), "event": event})
    rec.update(fields)
    line = json.dumps(rec, default=str)
    print(line, file=sys.stderr, flush=True)
    path = os.environ.get("TDC_RUNLOG")
    if path:
        try:
            with open(path, "a") as f:
                f.write(line + "\n")
        except OSError:
            pass


class RunLog:
    """Append-only JSONL logger; no-op when path is None."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def event(self, name: str, **fields) -> None:
        if not self.path:
            return
        rec = _stamp({"ts": round(time.time(), 3), "event": name})
        rec.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
