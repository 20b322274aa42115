"""The ingest guard of the streamed fits: read retries with backoff,
corrupt-batch quarantine and a bounded loss (counterpart:
tdc_tpu/data/ingest.py; the same policy, verdicts, event names, error
types and words).

- **Retries** (`GuardedStream`): a failed read is classified transient
  or permanent (`classify_error`, HTTP status semantics included);
  transient ones retry with bounded exponential backoff and
  deterministic jitter under a per-read deadline. Retries run where the
  read runs: on the spill ring's workers for ranged streams
  (`read_batch(i)`), inline otherwise. Every retry is an `ingest_retry`
  event; an abandoned read is one `ingest_failed` event, then
  `IngestReadError` (transient, exhausted) or the original exception
  (permanent). Sequential (generator) streams cannot be read again:
  classification and the loud failure, no retry.

- **Quarantine**: a batch that fails a check is never skipped (skipping
  would part the ranks' collectives): it becomes a `Quarantined` marker,
  which the fits stage as the all-padding batch of the batch's geometry
  (zero valid rows, zero weights) and which adds nothing to the stats.
  The guard checks on the host what needs no scan of the values: the
  `data.corrupt` fault point, the width contract and the CRC of a
  sidecar or manifest (inside `read_batch`, `CorruptBatch`). The scan for
  non-finite values runs on the fit's device after the copy
  (`screen_batch` in `models/streaming._Pass`): a verdict found there is
  booked with `quarantine_after_read`, with the same accounting. A fit
  of several ranks that reduces once a pass (`scan_on_host`) scans the
  whole batch on the host instead, as the JAX package does: every rank
  reads the whole batch, so every rank reaches the same verdict, where
  each rank's scan of its own rows would not. When every batch is clean
  the guard yields the stream's own arrays: a guarded fit is bit for bit
  the unguarded one.

- **Bounded loss**: a per-fit `IngestCounter` (mirrored into
  `GLOBAL_INGEST`) and the `IngestReport` on every streamed result. More
  quarantined rows in a pass than `max_bad_fraction` allows end the fit
  with `IngestAbort` after one `ingest_abort` event; the strict default
  0.0 ends it at the first quarantine. On several ranks
  (`defer_aborts`) the abort, and a read that failed for good, wait for
  the end of the pass, so every rank has reached the pass's collectives
  when it raises: the failed batch's place is held by the all-padding
  batch of its geometry meanwhile. The first batch's read for the init
  is not in a pass, and fails at once.

- **Streams that read ahead** (`reads_ahead`, the native loader): the
  guard iterates the stream's own pass, whose reader runs ahead of the
  fit, and keeps `read_batch` for the spill ring's workers.

The JAX module's `trace.instant` span marks belong to the tracing layer
(`obs/`, ROADMAP.md Queue A, A12) and are left out.
"""

from __future__ import annotations

import http.client
import math
import threading
import time
import zlib
from typing import NamedTuple

import numpy as np
import torch

from tdc_tpu_torch.data import spill as spill_lib
from tdc_tpu_torch.data.device_cache import stream_hints
from tdc_tpu_torch.testing.faults import fault_point
from tdc_tpu_torch.utils.structlog import emit


class IngestPolicy(NamedTuple):
    """Knobs of one fit's ingest guard (CLI: --io_retries / --io_backoff /
    --io_deadline / --max_bad_fraction).

    io_retries: transient read failures retried per batch read (0
      disables retry; permanent failures never retry).
    io_backoff: base backoff seconds; attempt n sleeps
      io_backoff * 2^(n-1) * u with deterministic u in [0.5, 1.0).
    io_deadline: seconds for one read including its retries; a retry that
      cannot fit the rest fails instead of sleeping past it. None = none.
    max_bad_fraction: largest share of a pass's rows that may be
      quarantined before the fit aborts; the strict default 0.0 aborts on
      the first quarantine.
    screen: run the integrity screen (the host checks and the scan for
      non-finite values on the device).
    """

    io_retries: int = 2
    io_backoff: float = 0.05
    io_deadline: float | None = None
    max_bad_fraction: float = 0.0
    screen: bool = True


DEFAULT_POLICY = IngestPolicy()

# The guard as a pass-through (no retry, no screen): the policy the
# transparency tests hold the guarded fits to.
PASSTHROUGH_POLICY = IngestPolicy(io_retries=0, screen=False,
                                  max_bad_fraction=1.0)


def resolve_policy(ingest) -> IngestPolicy:
    """None -> DEFAULT_POLICY, an IngestPolicy as it is, a dict overrides
    the defaults field by field."""
    if ingest is None:
        return DEFAULT_POLICY
    if isinstance(ingest, IngestPolicy):
        return ingest
    if isinstance(ingest, dict):
        return IngestPolicy(**ingest)
    raise TypeError(
        f"ingest must be an IngestPolicy, dict, or None; got {type(ingest)}"
    )


class CorruptBatch(Exception):
    """An integrity failure found during the read (a CRC mismatch, a torn
    record): a quarantine verdict, not a crash. `shape`/`dtype` give the
    replacement batch's geometry without reading the bytes again."""

    def __init__(self, message: str, *, batch: int, reason: str,
                 shape=None, dtype=None):
        super().__init__(message)
        self.batch = int(batch)
        self.reason = reason
        self.shape = None if shape is None else tuple(shape)
        self.dtype = dtype


class IngestReadError(RuntimeError):
    """A transient-classified read that the retry policy could not
    recover (retries exhausted or the deadline spent). Always preceded by
    one `ingest_failed` event naming the batch and the store; permanent
    failures re-raise the original exception after the same event."""


class IngestAbort(RuntimeError):
    """Too much of a pass was quarantined (more than the fit's
    max_bad_fraction) to trust the result, or the first batch that a
    named init needs failed the screen. Always preceded by one event
    (`ingest_abort`, `ingest_quarantine`)."""


# Transient = worth retrying against a flaky or cold store; permanent =
# retrying cannot help. Unknown types are permanent: retrying an
# unclassified error hides bugs.
_PERMANENT_OS = (FileNotFoundError, PermissionError, IsADirectoryError,
                 NotADirectoryError)
_TRANSIENT = (ConnectionError, TimeoutError, InterruptedError,
              BlockingIOError)


def classify_error(e: BaseException) -> str:
    """'transient' | 'permanent' | 'corrupt' for one read failure. An
    error with an int `.status` is classified by HTTP status class:
    408/429 and 5xx transient, any other 4xx permanent. http.client's
    IncompleteRead and other HTTPExceptions are transient (the transfer
    died, not the object); residual OSErrors too."""
    if isinstance(e, CorruptBatch):
        return "corrupt"
    status = getattr(e, "status", None)
    if isinstance(status, int):
        if status in (408, 429) or 500 <= status <= 599:
            return "transient"
        if 400 <= status <= 499:
            return "permanent"
    if isinstance(e, _PERMANENT_OS):
        return "permanent"
    if isinstance(e, _TRANSIENT):
        return "transient"
    if isinstance(e, OSError):
        return "transient"
    if isinstance(e, http.client.HTTPException):
        return "transient"
    return "permanent"


def backoff_delay(base: float, attempt: int, label: str, batch: int) -> float:
    """base * 2^(attempt-1) * u, u in [0.5, 1.0) from a crc32 of (label,
    batch, attempt): reproducible under $TDC_FAULTS, still decorrelating
    concurrent ring reads. Capped at 5 s."""
    u = 0.5 + (zlib.crc32(f"{label}:{batch}:{attempt}".encode())
               % 1024) / 2048.0
    return min(float(base) * (2.0 ** max(attempt - 1, 0)) * u, 5.0)


def describe_store(batches) -> str:
    """The store's name in events: a path-like attribute of the stream,
    else its type name."""
    for attr in ("path", "source", "name"):
        v = getattr(batches, attr, None)
        if isinstance(v, str) and v:
            return v
    return type(batches).__name__


def _zeros(shape) -> np.ndarray:
    """A read-only all-zero array of `shape` that holds one element: the
    replacement batch's values are never read, only its geometry."""
    return np.broadcast_to(np.zeros((), np.float32), tuple(shape))


class Quarantined:
    """One quarantined batch: the replacement the fits stage as the
    all-padding batch. Carries the batch's geometry (`x.shape`, zeros),
    zero weights on a weighted stream, its index and the reason."""

    __slots__ = ("x", "w", "index", "reason")

    def __init__(self, x, w, index: int, reason: str):
        self.x = x
        self.w = w
        self.index = index
        self.reason = reason

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"Quarantined(batch={self.index}, reason={self.reason!r}, "
                f"shape={tuple(self.x.shape)})")


class IngestCounter:
    """Thread-safe tally of the guard's work, mirrored into GLOBAL_INGEST.
    Quarantine counts here are event counts (a batch quarantined every
    pass counts every pass); the per-fit report's distinct view lives on
    the guard."""

    def __init__(self, _mirror=None):
        self._lock = threading.Lock()
        self._mirror = _mirror
        self.retries = 0
        self.read_failures = 0
        self.quarantined_batches = 0
        self.quarantined_rows = 0
        self.crc_failures = 0

    def add_retry(self) -> None:
        with self._lock:
            self.retries += 1
        if self._mirror is not None:
            self._mirror.add_retry()

    def add_failure(self) -> None:
        with self._lock:
            self.read_failures += 1
        if self._mirror is not None:
            self._mirror.add_failure()

    def add_quarantine(self, rows: int, crc: bool = False) -> None:
        with self._lock:
            self.quarantined_batches += 1
            self.quarantined_rows += int(rows)
            if crc:
                self.crc_failures += 1
        if self._mirror is not None:
            self._mirror.add_quarantine(rows, crc)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "retries": self.retries,
                "read_failures": self.read_failures,
                "quarantined_batches": self.quarantined_batches,
                "quarantined_rows": self.quarantined_rows,
                "crc_failures": self.crc_failures,
            }


# The process-wide tally every fit's counter mirrors into.
GLOBAL_INGEST = IngestCounter()


class IngestReport(NamedTuple):
    """A streamed fit's ingest summary (the result's `ingest` field).
    Quarantine fields are distinct per pass: a batch quarantined every
    pass counts once, and `quarantined_rows` is the mass one pass
    drops."""

    retries: int  # read attempts retried after transient failures
    read_failures: int  # reads abandoned (permanent / retries exhausted)
    quarantined_batches: int  # distinct stream batch indices quarantined
    quarantined_rows: int  # rows those batches held (one pass's worth)
    rows_per_pass: int  # total rows one full pass streams (0 = unknown)
    crc_failures: int  # quarantines from CRC mismatches

    @property
    def dropped_fraction(self) -> float:
        """quarantined_rows / rows_per_pass (0.0 when nothing was
        quarantined or the pass size is unknown)."""
        if self.rows_per_pass <= 0:
            return 0.0
        return self.quarantined_rows / self.rows_per_pass


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
    weight row. The streamed fits run it on the card after each copy,
    where the scan is one reduction and one scalar read (the JAX package
    scans host batches)."""
    if x.ndim != 2 or (d is not None and x.shape[1] != d):
        return f"bad_shape:{tuple(x.shape)}"
    if x.shape[0] and x.shape[1] and not _finite_range(x):
        return "nonfinite"
    if w is not None and len(w) and not _finite_range(w):
        return "nonfinite_weights"
    return None


class GuardedStream:
    """The guard around a fit's batch stream.

    Keeps the protocols the fits and the spill ring use: `__call__` -> a
    fresh per-pass iterator; the ranged protocol (`read_batch(i)` +
    `num_batches`) when the stream has it, so the ring's workers read
    through the guard and retry there; the sizing protocol by attribute
    delegation. Yields the stream's batches untouched when clean,
    `Quarantined` markers when not. Thread-safe.
    """

    def __init__(self, batches, policy: IngestPolicy, *, d: int | None = None,
                 weighted: bool = False, label: str = "fit",
                 counter: IngestCounter | None = None):
        self._raw = batches
        self.policy = policy
        self.d = d
        self.weighted = weighted
        self.label = label
        self.counter = (counter if counter is not None
                        else IngestCounter(_mirror=GLOBAL_INGEST))
        self.store = describe_store(batches)
        self._lock = threading.Lock()
        self._q_rows: dict[int, int] = {}  # distinct index -> rows dropped
        self._reads = 0  # logical reads (pass windows = // num_batches)
        self._pass_rows = 0
        self._pass_q_rows = 0
        self._rows_per_pass = 0  # total of the last completed pass
        # With several ranks an abort waits for the end of the pass
        # (`raise_deferred`): a rank that raised alone would leave the
        # others waiting in a collective.
        self.defer_aborts = False
        self._deferred: str | None = None
        self._failed: BaseException | None = None
        # Set by the fit of several ranks that reduces once a pass (module
        # docstring): the non-finite scan runs here, on the whole batch.
        self.scan_on_host = False
        self._ranged = spill_lib.ranged_reader(batches)
        if self._ranged is not None:
            # An instance attribute, so spill_lib.ranged_reader(guard)
            # finds the guarded read and retries run on the ring's workers.
            self.read_batch = self._read_guarded
        self._hints = stream_hints(batches)
        self._known_rows = (None if self._hints is None
                            else int(self._hints.n_rows))

    # The sizing protocol (num_batches, batch_rows, n_rows, x, dtype, ...)
    # of the stream, which the residency planner reads.
    def __getattr__(self, name):
        return getattr(self._raw, name)

    # ---------------- reads ----------------

    def _read_retrying(self, i: int, read):
        """The retry and deadline ladder around one read that can be made
        again. Raises through _fail; returns the stream's batch."""
        p = self.policy
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                fault_point("data.read.transient")
                fault_point("data.read.permanent")
                return read(i)
            except Exception as e:
                kind = classify_error(e)
                if kind == "corrupt":
                    raise
                attempt += 1
                delay = backoff_delay(p.io_backoff, attempt, self.label, i)
                # A 429/503 Retry-After is the earliest useful retry: the
                # backoff's floor (capped at 30 s), counted against the
                # deadline like any delay.
                ra = getattr(e, "retry_after", None)
                if ra is not None:
                    try:
                        delay = max(delay, min(float(ra), 30.0))
                    except (TypeError, ValueError):
                        pass
                elapsed = time.monotonic() - t0
                retryable = (
                    kind == "transient"
                    and attempt <= p.io_retries
                    and (p.io_deadline is None
                         or elapsed + delay <= p.io_deadline)
                )
                if not retryable:
                    self._fail(i, kind, attempt, e)
                self.counter.add_retry()
                emit("ingest_retry", label=self.label, store=self.store,
                     batch=i, attempt=attempt, kind=kind,
                     delay_s=round(delay, 4),
                     error=f"{type(e).__name__}: {e}"[:200])
                time.sleep(delay)

    def _read_guarded(self, i: int):
        """One ranged read: classify/retry around the stream's read_batch,
        then the host screen. Runs where the caller runs: a spill worker,
        or the fit's thread."""
        try:
            try:
                batch = self._read_retrying(i, self._ranged[0])
            except CorruptBatch as e:
                return self._quarantine_corrupt(i, e)
            return self._admit(i, batch)
        except Exception as e:
            return self._stand_in(i, e)

    def _stand_in(self, i: int, e: Exception):
        """A read that failed for good, on one of several ranks: the error
        waits for the pass end (`raise_deferred`) and the all-padding
        batch of the batch's geometry holds its place, so this rank's
        collectives run as the other ranks' do. Raised at once on one
        rank, or where the geometry is unknown."""
        shape = self._expected_shape(i=i)
        if not self.defer_aborts or shape is None:
            raise e
        with self._lock:
            if self._failed is None:
                self._failed = e
        return Quarantined(_zeros(shape), self._zero_w(shape), i,
                           "read_failed")

    def failed(self) -> bool:
        """Whether a read failed for good in this pass (its error waits
        for `raise_deferred`)."""
        with self._lock:
            return self._failed is not None

    def first_batch(self):
        """Retry and screen the stream's first batch for the init and the
        equal-rows check, with no pass accounting (the first pass reads it
        again). The batch when clean, a Quarantined marker when not:
        an init derived from it must refuse the marker."""
        if self._ranged is not None:
            try:
                batch = self._read_retrying(0, self._ranged[0])
            except CorruptBatch as e:
                return self._peek_quarantined(0, e)
        else:
            try:
                fault_point("data.read.transient")
                fault_point("data.read.permanent")
                batch = next(iter(self._raw()))
            except StopIteration:
                raise ValueError(
                    f"{self.label}: empty batch stream ({self.store})"
                ) from None
            except Exception as e:
                self._fail(0, classify_error(e), 1, e)
        x, w = self._split(batch)
        reason = self._screen(x, w)
        if reason is None:
            return batch
        emit("ingest_quarantine", label=self.label, store=self.store,
             batch=0, rows=self._rows_of(x), reason=reason, peek=True)
        shape = self._expected_shape(x)
        if shape is None:
            self._fail(0, "corrupt", 1, CorruptBatch(
                f"first batch has shape {tuple(x.shape)} and the expected "
                "geometry is unknown", batch=0, reason=reason))
        return Quarantined(_zeros(shape), self._zero_w(shape, w), 0, reason)

    def _peek_quarantined(self, i: int, e: CorruptBatch):
        shape = e.shape if e.shape is not None else self._expected_shape()
        if shape is None:
            self._fail(i, "corrupt", 1, e)
        return Quarantined(_zeros(shape), self._zero_w(shape), i,
                           f"crc:{e.reason}")

    def _fail(self, i: int, kind: str, attempts: int, e: Exception):
        """An abandoned read: one ingest_failed event naming the batch and
        the store, then the original exception (permanent, corrupt) or
        IngestReadError (transient, exhausted)."""
        self.counter.add_failure()
        emit("ingest_failed", label=self.label, store=self.store, batch=i,
             kind=kind, attempts=attempts,
             error=f"{type(e).__name__}: {e}"[:300])
        if kind != "transient":
            raise e
        raise IngestReadError(
            f"{self.label}: batch {i} of {self.store} failed "
            f"({kind}, {attempts} attempt(s)): {type(e).__name__}: {e}"
        ) from e

    def _expected_shape(self, x=None, i=None) -> tuple[int, int] | None:
        """The replacement batch's geometry: the batch's own row count
        (off a 2-D batch) or the stream's batch_rows (batch `i`'s share of
        n_rows when the stream has both), times the fit's width. The
        corrupt batch's own width cannot be trusted."""
        rows = None
        shape = getattr(x, "shape", None)
        if shape is not None and len(shape) == 2:
            rows = int(shape[0])
        if rows is None:
            br = getattr(self._raw, "batch_rows", None)
            if br is None and i is not None and self._hints is not None:
                br = self._hints.batch_rows
            try:
                rows = int(br)
            except (TypeError, ValueError):
                return None
            if i is not None and self._known_rows is not None:
                rows = max(0, min(rows, self._known_rows - i * rows))
        return None if self.d is None else (rows, int(self.d))

    def _zero_w(self, shape, w=None):
        return (np.zeros(shape[0], np.float32)
                if self.weighted or w is not None else None)

    def _quarantine_corrupt(self, i: int, e: CorruptBatch):
        """Store-detected corruption (a CRC mismatch): the replacement
        takes the error's geometry (the batch's shape is intact, only its
        bytes are wrong)."""
        shape = e.shape
        if shape is None:
            shape = self._expected_shape()
            if shape is None:
                self._fail(i, "corrupt", 1, e)
        return self._book_quarantine(i, _zeros(shape), self._zero_w(shape),
                                     f"crc:{e.reason}", crc=True)

    # ---------------- screen + accounting ----------------

    def _split(self, batch):
        if self.weighted and isinstance(batch, tuple):
            return batch
        return batch, None

    def _screen(self, x, w=None) -> str | None:
        """The host part of the screen: the `data.corrupt` fault point and
        the width contract; the non-finite scan too under `scan_on_host`,
        else on the device (module docstring)."""
        if not self.policy.screen:
            return None
        try:
            fault_point("data.corrupt")
        except Exception as e:
            return f"injected:{type(e).__name__}"
        if getattr(x, "ndim", None) != 2 or (
                self.d is not None and x.shape[1] != self.d):
            return f"bad_shape:{tuple(getattr(x, 'shape', ()))}"
        if self.scan_on_host:
            if isinstance(x, np.ndarray):
                from tdc_tpu_torch.data.loader import restore_bf16

                x = restore_bf16(x)  # a '|V2' array: its bf16 values
            return screen_batch(x, w=w)
        return None

    def _admit(self, i: int, batch):
        """Screen one read batch and book its pass accounting."""
        x, w = self._split(batch)
        reason = self._screen(x, w)
        if reason is None:
            self._book_rows(self._rows_of(x))
            return batch
        if reason.startswith("bad_shape"):
            # A truncated record or a wrong width: the replacement takes
            # the expected geometry, or the stats would crash on it.
            shape = self._expected_shape(x)
            if shape is None:
                self._fail(i, "corrupt", 1, CorruptBatch(
                    f"batch {i} has shape {tuple(x.shape)} and the "
                    "expected geometry is unknown (no feature width / "
                    "batch_rows to rebuild from)",
                    batch=i, reason=reason,
                ))
        else:
            shape = tuple(x.shape)
        return self._book_quarantine(i, _zeros(shape), self._zero_w(shape, w),
                                     reason)

    @staticmethod
    def _rows_of(x) -> int:
        return int(x.shape[0])

    def _book_rows(self, rows: int) -> None:
        with self._lock:
            self._begin_read_locked()
            self._pass_rows += rows
            over = self._end_read_locked()
        if over:
            self._abort(over)

    def _book_quarantine(self, i: int, zx, zw, reason: str,
                         crc: bool = False):
        rows = self._rows_of(zx)
        self.counter.add_quarantine(rows, crc=crc)
        emit("ingest_quarantine", label=self.label, store=self.store,
             batch=i, rows=rows, reason=reason)
        with self._lock:
            self._begin_read_locked()
            self._pass_rows += rows
            self._q_rows[i] = rows
            self._pass_q_rows += rows
            over = (self._budget_exceeded_locked(at_pass_end=False)
                    or self._end_read_locked())
        if over:
            self._abort(over)
        return Quarantined(zx, zw, i, reason)

    def quarantine_after_read(self, i: int, rows: int, reason: str) -> None:
        """Book a verdict reached after the read (the fit's scan on the
        device, or another rank's verdict on this batch): the read booked
        the batch's rows as clean; this books them quarantined, with the
        event and the budget check of a quarantine found on the host."""
        self.counter.add_quarantine(rows)
        emit("ingest_quarantine", label=self.label, store=self.store,
             batch=i, rows=int(rows), reason=reason)
        with self._lock:
            self._q_rows[i] = int(rows)
            self._pass_q_rows += int(rows)
            over = self._budget_exceeded_locked(at_pass_end=False)
        if over:
            self._abort(over)

    def _begin_read_locked(self) -> None:
        nb = self._num_batches()
        if nb and self._reads % nb == 0:
            # First read of a new pass window: reset per-pass tallies.
            self._pass_rows = 0
            self._pass_q_rows = 0
        self._reads += 1

    def _end_read_locked(self) -> str | None:
        """Pass-window bookkeeping after one read; the abort detail when
        the completed pass exceeded the loss budget."""
        nb = self._num_batches()
        if nb and self._reads % nb == 0:
            self._rows_per_pass = self._pass_rows
            return self._budget_exceeded_locked(at_pass_end=True)
        return None

    def _num_batches(self) -> int | None:
        if self._ranged is not None:
            return int(self._ranged[1])
        nb = getattr(self._raw, "num_batches", None)
        try:
            return int(nb)
        except (TypeError, ValueError):
            return None

    def _budget_exceeded_locked(self, at_pass_end: bool) -> str | None:
        """The abort detail when the pass's quarantined share provably
        exceeds max_bad_fraction: against the advertised pass size when
        the stream has one, else at the pass's end."""
        if self._pass_q_rows <= 0:
            return None
        mbf = float(self.policy.max_bad_fraction)
        if mbf <= 0.0:
            return (f"{self._pass_q_rows} row(s) quarantined under the "
                    "strict max_bad_fraction=0.0 policy")
        total = self._known_rows
        if total is None and at_pass_end:
            total = self._pass_rows
        if total and self._pass_q_rows / total > mbf:
            return (f"quarantined {self._pass_q_rows}/{total} rows "
                    f"({self._pass_q_rows / total:.3f}) > "
                    f"max_bad_fraction={mbf}")
        return None

    def _abort(self, detail: str):
        if self.defer_aborts:
            with self._lock:
                self._deferred = self._deferred or detail
            return
        self._raise_abort(detail)

    def _raise_abort(self, detail: str):
        emit("ingest_abort", label=self.label, store=self.store,
             quarantined_batches=len(self._q_rows),
             quarantined_rows=self._pass_q_rows, detail=detail)
        raise IngestAbort(
            f"{self.label}: too much data quarantined to trust the result "
            f"({detail}); raise max_bad_fraction only if bounded loss is "
            "acceptable, or fix the store"
        )

    def raise_deferred(self, failed_elsewhere: bool = False) -> None:
        """Raise what `defer_aborts` held back, if anything: this rank's
        failed read, else IngestReadError when a read failed on another
        rank (`failed_elsewhere`), else the abort (the fits call this at
        the end of each pass, after its collectives)."""
        with self._lock:
            detail, self._deferred = self._deferred, None
            failed, self._failed = self._failed, None
        if failed is not None:
            raise failed
        if failed_elsewhere:
            raise IngestReadError(
                f"{self.label}: a batch read of {self.store} failed for "
                "good on another rank (its ingest_failed event names the "
                "batch)")
        if detail is not None:
            self._raise_abort(detail)

    # ---------------- iteration ----------------

    def __call__(self):
        if self._ranged is not None and not getattr(self._raw, "reads_ahead",
                                                    False):
            return self._iter_ranged()
        return self._iter_sequential()

    def _iter_ranged(self):
        for i in range(int(self._ranged[1])):
            yield self._read_guarded(i)

    def _iter_sequential(self):
        """Sequential (generator) streams: a failed `next` cannot be made
        again (the generator is closed; on a weighted stream, going on
        past the zip would misalign points and weights), so every read
        failure classifies and fails loudly without retry, CorruptBatch
        included. The screen and its verdicts run as on ranged reads."""
        it = iter(self._raw())
        i = 0
        while True:
            try:
                fault_point("data.read.transient")
                fault_point("data.read.permanent")
                batch = next(it)
            except StopIteration:
                with self._lock:
                    self._rows_per_pass = self._pass_rows
                    over = self._budget_exceeded_locked(at_pass_end=True)
                    # The pass window is the iterator here: sequential
                    # streams may not advertise num_batches.
                    self._pass_rows = 0
                    self._pass_q_rows = 0
                    self._reads = 0
                if over:
                    self._abort(over)
                return
            except Exception as e:
                try:
                    self._fail(i, classify_error(e), 1, e)
                except Exception as err:
                    # The iterator is spent: stand-ins hold the rest of
                    # the pass's places, when the stream says how many.
                    nb = self._num_batches()
                    if nb is None:
                        raise
                    for j in range(i, nb):
                        yield self._stand_in(j, err)
                    return
            yield self._admit(i, batch)
            i += 1

    # ---------------- report ----------------

    def quarantined_rows_seen(self) -> int:
        """Distinct quarantined rows so far (the first pass's crosscheck
        compares it across ranks)."""
        with self._lock:
            return sum(self._q_rows.values())

    def report(self) -> IngestReport:
        c = self.counter.snapshot()
        with self._lock:
            q_rows = sum(self._q_rows.values())
            rows_pp = self._rows_per_pass or self._pass_rows
            if not rows_pp and self._known_rows:
                rows_pp = self._known_rows
            return IngestReport(
                retries=c["retries"],
                read_failures=c["read_failures"],
                quarantined_batches=len(self._q_rows),
                quarantined_rows=q_rows,
                rows_per_pass=int(rows_pp),
                crc_failures=c["crc_failures"],
            )


def guard_stream(batches, ingest, *, d: int | None = None,
                 weighted: bool = False, label: str = "fit") -> GuardedStream:
    """The streamed fits' one ingest wiring point: resolve the policy and
    wrap the (possibly weighted-zipped) stream. Wrap before
    spill_lib.wrap_stream, so the ring's reads go through the guard."""
    return GuardedStream(
        batches, resolve_policy(ingest), d=d, weighted=weighted, label=label,
    )


__all__ = [
    "DEFAULT_POLICY",
    "GLOBAL_INGEST",
    "PASSTHROUGH_POLICY",
    "CorruptBatch",
    "GuardedStream",
    "IngestAbort",
    "IngestCounter",
    "IngestPolicy",
    "IngestReadError",
    "IngestReport",
    "Quarantined",
    "backoff_delay",
    "classify_error",
    "describe_store",
    "guard_stream",
    "resolve_policy",
    "screen_batch",
]
