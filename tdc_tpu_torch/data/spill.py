"""The spill tier: batches staged ahead of the consumer, so the copy of
batch i+1 to the card overlaps batch i's compute (counterpart:
tdc_tpu/data/spill.py).

A streamed fit copies each batch to the card in line with its compute.
When the dataset does not fit the card (`data/device_cache.plan_residency`
picks "spill"), a bounded ring stages the next batches on worker threads
instead: each worker reads its batch, stages it exactly as the inline path
does, and copies it to the card. On a CUDA device a worker reads into a
pinned host buffer and copies from it with `copy_(non_blocking=True)` on a
CUDA stream of its own, records an event and waits for it, so the slot is
handed over full. The consumer makes its current stream wait on that
event and calls `record_stream` on the batch, so the caching allocator
does not give the batch's memory to a later copy while a kernel still
reads it. A pinned buffer is written again only after its copy's event
has completed. On a CPU device the same threads run without streams.

- Bit-exactness: the ring changes when a batch is staged, never what it
  is: the consumer sees the tensors the inline path would have made, in
  stream order, so a spilled fit equals a streamed one bit for bit.
- Bounded memory: at most `slots` staged batches wait ahead of the
  consumer, which holds one more: the (slots + 1) slots `plan_residency`
  budgets. Each slot has its own pinned buffers and its own copy stream.
- Batch boundaries are kept: heartbeats, mid-pass checkpoints and
  preemption land per batch, as in a streamed pass.

Streams with the ranged protocol (`ranged_reader`: a thread-safe
`read_batch(i)` beside `num_batches`, which `NpzStream` has) get up to
`slots` reads and copies in flight on a pool, delivered in order. The
pool lives across passes (`SpillRing`): when a pass ends normally the
ring starts the next pass's first `slots` batches at once (staging never
reads the centroids), so they copy while the fit checks its shift; each
handoff emits a `spill_cross_pass` event and is counted. `release` ends
it after the fit's last pass. Other streams get one producer thread per
pass (`prefetch_map`), which `models/streaming._prefetched` also uses.
"""

from __future__ import annotations

import queue as queue_lib
import threading
import time
import warnings
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from tdc_tpu_torch.utils.structlog import emit

# Batch slots the ring stages ahead of the consumer: 2 is double
# buffering, one slot computing while one fills.
DEFAULT_SPILL_SLOTS = 2


class StagedBatch(NamedTuple):
    """One batch staged on the fit's device, exactly as the inline path
    stages it."""

    xb: object  # this rank's rows, zero rows appended up to its slice
    n_valid: int  # this rank's rows of xb before the zero padding
    n_local: int  # the batch's rows as the stream yielded them
    wb: object = None  # their weights (zero for the pad rows), or None
    ready: object = None  # CUDA event after the copies, or None
    # The ingest guard's quarantine reason (data/ingest.py): the batch is
    # the all-padding batch of its geometry, n_valid 0; None when clean.
    verdict: object = None


class H2DCounter:
    """The ring's transfer tally: bytes staged to the device, batches
    staged, the producers' seconds for the whole staging of a batch
    (read, stage, copy to the card and its completion: `copy_s`), the
    consumer's seconds waiting on the ring (`stall_s`), the deepest ring
    fill seen, and the batches staged across pass boundaries. Thread-safe;
    `_mirror` (GLOBAL_H2D) gets every addition too."""

    def __init__(self, _mirror=None):
        self._lock = threading.Lock()
        self._mirror = _mirror
        self.h2d_bytes = 0
        self.batches = 0
        self.copy_s = 0.0
        self.stall_s = 0.0
        self.depth_max = 0
        self.cross_pass = 0

    def add_copy(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.h2d_bytes += int(nbytes)
            self.batches += 1
            self.copy_s += float(seconds)
        if self._mirror is not None:
            self._mirror.add_copy(nbytes, seconds)

    def add_stall(self, seconds: float) -> None:
        with self._lock:
            self.stall_s += float(seconds)
        if self._mirror is not None:
            self._mirror.add_stall(seconds)

    def sample_depth(self, depth: int) -> None:
        with self._lock:
            self.depth_max = max(self.depth_max, int(depth))
        if self._mirror is not None:
            self._mirror.sample_depth(depth)

    def add_cross_pass(self, batches: int) -> None:
        with self._lock:
            self.cross_pass += int(batches)
        if self._mirror is not None:
            self._mirror.add_cross_pass(batches)

    def snapshot(self) -> dict:
        with self._lock:
            return {"h2d_bytes": self.h2d_bytes, "batches": self.batches,
                    "copy_s": self.copy_s, "stall_s": self.stall_s,
                    "depth_max": self.depth_max,
                    "cross_pass": self.cross_pass}

    def report(self, slots: int) -> "SpillReport":
        return SpillReport(slots=int(slots), **self.snapshot())


# The process-wide tally every fit's counter mirrors into.
GLOBAL_H2D = H2DCounter()


class SpillReport(NamedTuple):
    """A fit's ring summary (the `h2d` field of its result). copy_s and
    stall_s are the producers' staging seconds and the consumer's
    waiting seconds; `overlap_lower_bound` is the consumer-side floor on
    the share of the copy time hidden behind compute (a consumer that
    runs ahead of the device waits longer than the copies it did not
    hide), an alarm for a starved ring rather than the overlap itself."""

    slots: int  # ring slots requested
    batches: int  # batches staged through the ring
    h2d_bytes: int  # bytes staged host to device
    copy_s: float  # producer seconds: read, stage, copy, completion
    stall_s: float  # consumer seconds waiting on the ring
    depth_max: int  # deepest ring fill seen
    cross_pass: int = 0  # batches staged across pass boundaries

    @property
    def overlap_lower_bound(self) -> float:
        """1 - stall_s / copy_s, clamped to [0, 1]."""
        if self.copy_s <= 0.0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.stall_s / self.copy_s))


def prefetch_map(it, depth: int, counter: H2DCounter | None = None):
    """Pull `it` on a background thread through a bounded queue of
    `depth` items; depth <= 0 yields `it` unchanged.

    Producer exceptions re-raise in the consumer after the items queued
    before them. Early consumer exit (break, .close(), garbage
    collection of the generator) sets a stop event, drains the queue and
    joins the producer, so no thread is left parked on a full queue
    holding batches. `counter` books the consumer's waits and samples the
    queue's depth after each put."""
    if depth <= 0:
        yield from it
        return
    q = queue_lib.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        """A bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_lib.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not put(item) or stop.is_set():
                    # A put parked on the full queue can still succeed
                    # after close (the drain frees its slot): never pull
                    # another item past the consumer's exit.
                    return
                if counter is not None:
                    counter.sample_depth(q.qsize())
            put(end)
        except BaseException as e:  # re-raised in the consumer
            put(e)

    t = threading.Thread(target=produce, name="tdc-prefetch", daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if counter is not None:
                counter.add_stall(time.perf_counter() - t0)
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue_lib.Empty:
            pass
        t.join(timeout=5.0)


def device_rows(a, rows: int, device) -> torch.Tensor:
    """`a` (numpy or a tensor) on `device` with a plain synchronous copy,
    zero rows appended up to `rows`."""
    if isinstance(a, np.ndarray):
        with warnings.catch_warnings():
            # A read-only memory map: the tensor is only read from.
            warnings.simplefilter("ignore", UserWarning)
            a = torch.from_numpy(a)
    if a.shape[0] == rows:
        return a.to(device)
    out = torch.zeros((rows, *a.shape[1:]), dtype=a.dtype, device=device)
    out[:a.shape[0]].copy_(a)
    return out


class _PinnedCopies:
    """The CUDA side of the ring: per slot, pinned host buffers (one per
    array of a batch, grown as needed) and a copy stream."""

    def __init__(self, device, n_slots: int):
        self.device = torch.device(device)
        self.streams = [torch.cuda.Stream(self.device)
                        for _ in range(n_slots)]
        self.buffers = {}  # (slot, array index) -> pinned tensor

    def put_fn(self, slot: int):
        """put(a, rows) for one batch staged in `slot`: its arrays in
        order (the points, then the weights) through the slot's pinned
        buffers onto the slot's stream."""
        index = iter(range(1 << 30))

        def put(a, rows: int) -> torch.Tensor:
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                return device_rows(a, rows, self.device)
            if isinstance(a, np.ndarray):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    a = torch.from_numpy(a)
            n = a.shape[0]
            key = (slot, next(index))
            buf = self.buffers.get(key)
            if (buf is None or buf.dtype != a.dtype
                    or buf.shape[1:] != a.shape[1:] or buf.shape[0] < n):
                buf = torch.empty((max(n, 1), *a.shape[1:]), dtype=a.dtype,
                                  pin_memory=True)
                self.buffers[key] = buf
            buf[:n].copy_(a)
            with torch.cuda.stream(self.streams[slot]):
                out = torch.empty((rows, *a.shape[1:]), dtype=a.dtype,
                                  device=self.device)
                out[:n].copy_(buf[:n], non_blocking=True)
                if rows > n:
                    out[n:].zero_()
            return out

        return put

    def finish(self, slot: int):
        """The event after the slot's copies, waited for: the slot is
        handed over full, and its pinned buffers may be written again."""
        ev = torch.cuda.Event()
        ev.record(self.streams[slot])
        ev.synchronize()
        return ev


def _tensors(staged) -> list:
    """The tensors of a staged item (a StagedBatch's points and weights,
    a tensor, or the tensors of a tuple)."""
    if isinstance(staged, StagedBatch):
        return [t for t in (staged.xb, staged.wb) if t is not None]
    if isinstance(staged, torch.Tensor):
        return [staged]
    if isinstance(staged, (tuple, list)):
        return [t for t in staged if isinstance(t, torch.Tensor)]
    return []


def ranged_reader(batches):
    """The ranged protocol of a stream: (read_batch, n_batches), where
    read_batch(i) is a thread-safe read of the i-th batch of `batches()`,
    or None for a stream that only iterates."""
    rb = getattr(batches, "read_batch", None)
    nb = getattr(batches, "num_batches", None)
    if rb is None or nb is None:
        return None
    try:
        nb = int(nb)
    except (TypeError, ValueError):
        return None
    return (rb, nb) if nb >= 1 else None


class SpillRing:
    """The spill tier's staged stream: a zero-arg re-iterable callable, as
    the fits take. `prepare(batch, put)` stages one raw batch and returns
    what the consumer gets (the fits return a StagedBatch); `put(a, rows)`
    is the ring's copy of a host array to the device, zero rows appended
    up to `rows`: through the slot's pinned buffer and copy stream on a
    CUDA device, a plain copy elsewhere.

    Ranged streams: one pool of `slots` workers for the ring's life,
    delivery in stream order with up to `slots` stages in flight, and the
    next pass's first `slots` batches staged when a pass ends normally
    (module docstring). Early close (a consumer exception, a closed
    generator) cancels the queued stages and joins the pool; `release()`
    does the same after the fit's last pass, and a later pass builds a new
    pool. Other streams: one producer thread per pass."""

    def __init__(self, batches, prepare, *,
                 slots: int = DEFAULT_SPILL_SLOTS,
                 counter: H2DCounter | None = None, device=None):
        self.batches = batches
        self.prepare = prepare
        self.slots = max(int(slots), 2)
        self.counter = counter
        self.device = torch.device("cpu" if device is None else device)
        self._ranged = ranged_reader(batches)
        self._ex = None  # the pool, built on first use
        self._pending = None  # the next pass's first stages
        self._pinned = None
        self._seq = 0  # stages submitted: stage s uses slot s % (slots + 1)

    def _staged(self, batch, seq: int):
        """One batch staged in slot seq % (slots + 1), timed and counted."""
        t0 = time.perf_counter()
        slot = seq % (self.slots + 1)
        if self._pinned is not None:
            staged = self.prepare(batch, self._pinned.put_fn(slot))
            ready = self._pinned.finish(slot)
            if isinstance(staged, StagedBatch):
                staged = staged._replace(ready=ready)
        else:
            staged = self.prepare(
                batch, lambda a, rows: device_rows(a, rows, self.device))
        if self.counter is not None:
            self.counter.add_copy(
                sum(t.numel() * t.element_size() for t in _tensors(staged)),
                time.perf_counter() - t0)
        return staged

    def _start_pass(self) -> None:
        """The pinned buffers and copy streams, made on the consumer's
        thread before any stage of a CUDA ring runs."""
        if self.device.type == "cuda" and self._pinned is None:
            self._pinned = _PinnedCopies(self.device, self.slots + 1)

    def _deliver(self, staged):
        """Order the consumer's stream after the batch's copies, and keep
        its memory from a later copy while the consumer's kernels read
        it."""
        if isinstance(staged, StagedBatch) and staged.ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(staged.ready)
            for t in _tensors(staged):
                t.record_stream(current)
        return staged

    def _submit(self, i: int):
        seq, self._seq = self._seq, self._seq + 1
        return self._ex.submit(
            lambda: self._staged(self._ranged[0](i), seq))

    def _teardown(self) -> None:
        """Cancel queued stages and join the workers (at most `slots`
        stages finish and are dropped)."""
        ex, self._ex = self._ex, None
        futs, self._pending = self._pending, None
        for f in futs or ():
            f.cancel()
        if ex is not None:
            ex.shutdown(wait=True)
        self._pinned = None

    def _ranged_pass(self):
        from concurrent.futures import ThreadPoolExecutor

        n_batches = self._ranged[1]
        self._start_pass()
        if self._ex is None:
            self._ex = ThreadPoolExecutor(max_workers=self.slots,
                                          thread_name_prefix="tdc-spill")
        if self._pending is not None:
            # The previous pass's handoff: staged while the fit checked
            # its shift.
            futs, self._pending = self._pending, None
        else:
            futs = deque(self._submit(i)
                         for i in range(min(self.slots, n_batches)))
        nxt = len(futs)
        completed = False
        try:
            while futs:
                t0 = time.perf_counter()
                staged = futs.popleft().result()
                if self.counter is not None:
                    self.counter.add_stall(time.perf_counter() - t0)
                    self.counter.sample_depth(sum(f.done() for f in futs))
                if nxt < n_batches:
                    futs.append(self._submit(nxt))
                    nxt += 1
                yield self._deliver(staged)
                del staged
            completed = True
            # The next pass's first batches, staged while the fit checks
            # its shift (staging never reads the centroids).
            k = min(self.slots, n_batches)
            self._pending = deque(self._submit(i) for i in range(k))
            if self.counter is not None:
                self.counter.add_cross_pass(k)
            emit("spill_cross_pass", batches=k, slots=self.slots)
        finally:
            if not completed:
                for f in futs:
                    f.cancel()
                self._teardown()

    def _serial_pass(self):
        def staged():
            for seq, batch in enumerate(self.batches()):
                yield self._staged(batch, seq)

        self._start_pass()
        it = prefetch_map(staged(), self.slots - 1, counter=self.counter)
        try:
            for item in it:
                yield self._deliver(item)
        finally:
            it.close()

    def __call__(self):
        if self._ranged is not None:
            return self._ranged_pass()
        return self._serial_pass()

    def release(self) -> None:
        """Cancel the next pass's stages, join the pool and free the
        pinned buffers. Idempotent; the ring stays usable."""
        self._teardown()


def release(stream) -> None:
    """Release `stream` if it is a SpillRing; leave any other stream (the
    caller's own) as it is. The fits call this after their last pass."""
    if isinstance(stream, SpillRing):
        stream.release()


def wrap_stream(plan, batches, prepare, device=None):
    """The fits' one spill wiring point: (the ring over `batches`, a
    per-fit H2DCounter mirrored into GLOBAL_H2D) when `plan` (a
    ResidencyPlan or None) picked the spill tier, else (batches, None).
    A ring supersedes the fit's `prefetch` (pass 0 with it); pair it with
    `release(stream)` after the last pass."""
    if plan is None or not plan.spill:
        return batches, None
    counter = H2DCounter(_mirror=GLOBAL_H2D)
    return (SpillRing(batches, prepare, counter=counter, device=device),
            counter)


__all__ = [
    "DEFAULT_SPILL_SLOTS",
    "GLOBAL_H2D",
    "H2DCounter",
    "SpillReport",
    "SpillRing",
    "StagedBatch",
    "device_rows",
    "prefetch_map",
    "ranged_reader",
    "release",
    "wrap_stream",
]
