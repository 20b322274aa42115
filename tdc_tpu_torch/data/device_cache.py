"""The device-resident dataset cache: the budget planner and the cache
that the streamed fits fill during their first pass (counterpart:
tdc_tpu/data/device_cache.py).

A streamed fit copies every batch from the host to the card on every
pass, even when the whole dataset (this rank's slice of it) would fit in
the card's memory. With `residency="hbm"` the first pass also keeps each
prepared batch on the card, and iterations 2..N run over that cache
(`models/streaming._Pass.run_cached`) without reading the stream again.

- `plan_residency` decides between streaming, the cache ("hbm") and the
  spill ring ("spill", `data/spill.py`) from the stream's advertised
  geometry (`stream_hints`) and the per-device budget
  (`data/batching.planner_budget_bytes`), in the JAX package's order and
  words, with its structlog events. Its byte counts use the port's own
  working-set model (`data/batching.working_set_row_bytes`).
- `DeviceCacheBuilder` fills the cache during the first pass: the full
  batches in one preallocated (n_full, B_pad, d) tensor (each batch
  copied into its slot, so the fill peaks at the dataset plus one
  batch), the last batch kept as `tail` in its own shape, and the
  weights' twins. Each slot holds exactly the tensor the streamed pass
  handed to the kernels (the same zero-padding to the rank slice, the
  same dtype, contiguous, its first byte aligned as a fresh allocation's
  is), so a pass over the cache makes the same calls on the same values
  as a streamed pass: the same bits. A stream that
  breaks its advertised geometry, a batch the ingest guard quarantines
  (`data/ingest.py`), or a CUDA out-of-memory error during the fill,
  abandons the cache loudly (`residency_cache_abandoned`) and the fit
  keeps streaming.
- `DeviceCache` holds the cached batches and this rank's valid rows of
  each; `scan_cache` visits them in stream order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tdc_tpu_torch.data.batching import (
    is_oom_error,
    planner_budget_bytes,
    release_device_memory,
    working_set_row_bytes,
)
from tdc_tpu_torch.utils.structlog import emit

RESIDENCY_MODES = ("stream", "auto", "hbm", "spill")

# Device-resident model-state copies the budget reserves beside the
# cache: the accumulator, one batch's stats, the old and new centroids,
# the per-pass reduce's output and the quantized reduce's residual, all
# O(K·d) f32 (the JAX package's count).
_STATE_COPIES = 6


def state_reserve_bytes(k: int, d: int) -> int:
    """Per-device bytes of the model-state copies the planner reserves
    beside the cache (the CLI's batch cap uses the same count)."""
    return _STATE_COPIES * k * d * 4


class StreamHints(NamedTuple):
    """A stream's advertised geometry (what every rank streams)."""

    n_rows: int
    batch_rows: int
    n_batches: int


def stream_hints(batches) -> StreamHints | None:
    """The sizing protocol of a batch stream: `num_batches`, `batch_rows`
    (or `rows_per_batch`) and the total rows (`n_rows`, `shape[0]` or
    `x.shape[0]`). None when the stream advertises nothing (a bare
    generator): the planner then cannot budget a cache."""
    nb = getattr(batches, "num_batches", None)
    br = getattr(batches, "batch_rows", None)
    if br is None:
        br = getattr(batches, "rows_per_batch", None)
    n = getattr(batches, "n_rows", None)
    if n is None:
        shape = getattr(batches, "shape", None)
        if shape is None:
            shape = getattr(getattr(batches, "x", None), "shape", None)
        if shape is not None:
            n = shape[0]
    try:
        nb, br, n = int(nb), int(br), int(n)
    except (TypeError, ValueError):
        return None
    if nb < 1 or br < 1 or n < 1:
        return None
    return StreamHints(n_rows=n, batch_rows=br, n_batches=nb)


def stream_itemsize(batches) -> int | None:
    """The stream's element width: an `itemsize` attribute, else the
    itemsize of `dtype` or `x.dtype` (a numpy or a torch dtype; a '|V2'
    bfloat16 array has 2). None when the stream advertises nothing:
    callers then budget f32."""
    size = getattr(batches, "itemsize", None)
    if size is None:
        dt = getattr(batches, "dtype", None)
        if dt is None:
            dt = getattr(getattr(batches, "x", None), "dtype", None)
        if dt is not None:
            try:
                size = np.dtype(dt).itemsize
            except TypeError:  # a torch dtype
                size = getattr(dt, "itemsize", None)
    try:
        size = int(size)
    except (TypeError, ValueError):
        return None
    return size if size >= 1 else None


class SizedBatches:
    """The sizing protocol attached to any zero-arg batch callable, so the
    planner can budget it (`NpzStream` advertises it already).
    `read_batch` optionally attaches the spill ring's ranged protocol (a
    thread-safe random-access read of batch i, `data/spill.ranged_reader`)
    so the ring can stage several batches at once."""

    def __init__(self, fn, n_rows: int, batch_rows: int,
                 itemsize: int | None = None, read_batch=None):
        self._fn = fn
        self.n_rows = int(n_rows)
        self.batch_rows = int(batch_rows)
        if itemsize is not None:
            self.itemsize = int(itemsize)
        if read_batch is not None:
            self.read_batch = read_batch

    @property
    def num_batches(self) -> int:
        return -(-self.n_rows // self.batch_rows)

    def __call__(self):
        return self._fn()


@dataclass(frozen=True)
class ResidencyPlan:
    """The planner's decision. mode is what the fit does ("hbm", "spill"
    or "stream"); requested is what the caller asked for."""

    mode: str
    requested: str
    reason: str
    hints: StreamHints | None
    resident_bytes: int  # per-device cache bytes (0 when streaming)
    reserve_bytes: int  # per-device working set reserved beside it
    budget_bytes: int  # per-device budget
    spill_bytes: int = 0  # per-device ring bytes (spill mode only)
    spill_slots: int = 0  # ring slots the spill mode runs with

    @property
    def resident(self) -> bool:
        return self.mode == "hbm"

    @property
    def spill(self) -> bool:
        return self.mode == "spill"


def _round_up(n: int, multiple: int) -> int:
    return -(-n // max(multiple, 1)) * max(multiple, 1)


def plan_residency(
    requested: str,
    *,
    hints: StreamHints | None,
    d: int,
    k: int,
    n_devices: int = 1,
    pad_multiple: int = 1,
    itemsize: int = 4,
    weighted: bool = False,
    kernel: str = "xla",
    cursor: int = 0,
    mid_pass_ckpt: bool = False,
    device=None,
    label: str = "fit",
) -> ResidencyPlan:
    """Streaming, the cache or the spill ring for one fit: the JAX
    package's decision order, reasons and events.

    Geometry: each batch of `batch_rows` rows is padded to `pad_multiple`
    (the ranks: each rank stages ceil(B / P) rows); the test is per
    device:

        rows_per_dev · d · itemsize            (the cache; + 4 B a row weighted)
      + batch_rows_per_dev · working_set_row   (one batch's stats pass)
      + state_reserve_bytes(k, d)              (accumulators and centroids)
      <= planner_budget_bytes(device)

    The spill ring fits when (DEFAULT_SPILL_SLOTS + 1) batch slots and
    the same reserve do. 'auto' takes the cache where it fits, else the
    ring (`residency_spill`), else streams (`residency_fallback`, never a
    truncation); 'hbm' and 'spill' force their tier
    (`residency_forced_over_budget` where the model disagrees). 'hbm'
    needs hints and refuses ckpt_every_batches (a pass over the cache has
    no mid-pass boundaries); 'auto' then streams. A mid-pass resume cursor
    streams in every mode (the fill needs the whole pass). 'spill' keeps
    the batch boundaries, so it composes with mid-pass saves, and runs
    without hints (only its budget check needs them)."""
    if requested not in RESIDENCY_MODES:
        raise ValueError(
            f"residency={requested!r}: use one of {RESIDENCY_MODES}")
    from tdc_tpu_torch.data.spill import DEFAULT_SPILL_SLOTS

    slots = DEFAULT_SPILL_SLOTS
    budget = planner_budget_bytes(device)
    if requested == "stream":
        return ResidencyPlan("stream", requested, "requested", hints, 0, 0,
                             budget)
    if mid_pass_ckpt and requested != "spill":
        if requested == "hbm":
            raise ValueError(
                "residency='hbm' is incompatible with ckpt_every_batches: "
                "the compiled on-device loop has no mid-pass batch "
                "boundaries to checkpoint at — drop one of the two, or "
                "use residency='auto' to prefer the mid-pass durability")
        emit("residency_fallback", label=label, requested=requested,
             reason="mid_pass_ckpt",
             detail="ckpt_every_batches promises bounded-loss mid-pass "
                    "saves; the resident loop only reaches the host at "
                    "chunk boundaries — streaming to keep that contract")
        return ResidencyPlan("stream", requested, "mid_pass_ckpt", hints,
                             0, 0, budget)
    if cursor:
        emit("residency_fallback", label=label, requested=requested,
             reason="mid_pass_resume",
             detail="a mid-pass checkpoint resume replays a partial pass; "
                    "the cache fill needs the full stream — streaming this "
                    "run")
        return ResidencyPlan("stream", requested, "mid_pass_resume", hints,
                             0, 0, budget)
    if hints is None:
        if requested == "hbm":
            raise ValueError(
                "residency='hbm' needs the stream's size: pass an NpzStream/"
                "NativePrefetchStream, or wrap the callable in "
                "data.device_cache.SizedBatches(fn, n_rows, batch_rows)")
        if requested == "spill":
            emit("residency_spill", label=label, requested=requested,
                 reason="requested_no_hints", spill_slots=slots,
                 detail="stream advertises no size — running the prefetch "
                        "ring without a budget feasibility check")
            return ResidencyPlan("spill", requested, "requested_no_hints",
                                 None, 0, 0, budget, spill_bytes=0,
                                 spill_slots=slots)
        emit("residency_fallback", label=label, requested=requested,
             reason="no_size_hints",
             detail="stream advertises no num_batches/batch_rows/n_rows; "
                    "cannot budget a cache or a spill ring — streaming")
        return ResidencyPlan("stream", requested, "no_size_hints", None,
                             0, 0, budget)

    full_global = _round_up(hints.batch_rows, pad_multiple)
    tail_rows = hints.n_rows - hints.batch_rows * (hints.n_batches - 1)
    tail_global = _round_up(max(tail_rows, 0), pad_multiple)
    total_rows = full_global * (hints.n_batches - 1) + tail_global
    rows_per_dev = -(-total_rows // max(n_devices, 1))
    resident = rows_per_dev * d * itemsize
    if weighted:
        resident += rows_per_dev * 4
    batch_per_dev = -(-full_global // max(n_devices, 1))
    reserve = (batch_per_dev * working_set_row_bytes(d, k, itemsize=itemsize,
                                                     kernel=kernel)
               + state_reserve_bytes(k, d))
    # The ring's footprint: `slots` batches staged ahead and the one being
    # consumed (data/spill.py's bound).
    slot = batch_per_dev * d * itemsize + (batch_per_dev * 4 if weighted
                                           else 0)
    ring = (slots + 1) * slot
    if requested != "spill" and resident + reserve <= budget:
        return ResidencyPlan("hbm", requested, "fits", hints, resident,
                             reserve, budget)
    if requested == "hbm":
        emit("residency_forced_over_budget", label=label,
             resident_bytes=resident, reserve_bytes=reserve,
             budget_bytes=budget,
             detail="residency='hbm' forced past the planner's budget "
                    "model; an HBM OOM during the fill will fall back to "
                    "streaming")
        return ResidencyPlan("hbm", requested, "forced", hints, resident,
                             reserve, budget)
    if ring + reserve <= budget:
        reason = "requested" if requested == "spill" else "cache_over_budget"
        emit("residency_spill", label=label, requested=requested,
             reason=reason, spill_slots=slots, spill_bytes=ring,
             resident_bytes=resident, reserve_bytes=reserve,
             budget_bytes=budget,
             detail="prefetch ring fits the per-device budget; H2D copies "
                    "will overlap compute"
                    + ("" if requested == "spill"
                       else " (full HBM cache is over budget)"))
        return ResidencyPlan("spill", requested, reason, hints, resident,
                             reserve, budget, spill_bytes=ring,
                             spill_slots=slots)
    if requested == "spill":
        emit("residency_forced_over_budget", label=label,
             resident_bytes=resident, reserve_bytes=reserve,
             spill_bytes=ring, budget_bytes=budget,
             detail="residency='spill' forced past the planner's budget "
                    "model (even the slot ring exceeds it); an HBM OOM "
                    "during staging will fail the fit")
        return ResidencyPlan("spill", requested, "forced", hints, resident,
                             reserve, budget, spill_bytes=ring,
                             spill_slots=slots)
    emit("residency_fallback", label=label, requested=requested,
         reason="over_budget", resident_bytes=resident,
         reserve_bytes=reserve, spill_bytes=ring, budget_bytes=budget,
         detail="dataset + accumulators exceed the per-device HBM budget "
                "and even the spill slot ring does not fit; streaming "
                "every pass instead (no truncation)")
    return ResidencyPlan("stream", requested, "over_budget", hints,
                         resident, reserve, budget)


class DeviceCache(NamedTuple):
    """This rank's cached batches: `stacked` (n_full, B_pad, d) or None
    for a one-batch stream, `tail` the last batch in its own shape, the
    weights' twins (None unweighted), and this rank's valid rows of every
    full batch (`nv_full`) and of the tail (`nv_tail`): the rows past them
    are the zero padding to the rank slice (weighted batches count every
    row valid: their pad rows weigh nothing)."""

    stacked: torch.Tensor | None
    tail: torch.Tensor
    w_stacked: torch.Tensor | None
    w_tail: torch.Tensor | None
    nv_full: int | None
    nv_tail: int

    @property
    def n_batches(self) -> int:
        n = 0 if self.stacked is None else self.stacked.shape[0]
        return n + 1


def cache_pad_rows(cache: DeviceCache) -> int:
    """The zero-pad rows of a whole pass over the cache: the count a
    streamed per-pass reduce adds up batch by batch."""
    pad = cache.tail.shape[0] - cache.nv_tail
    if cache.stacked is not None:
        n_full, b_pad = cache.stacked.shape[0], cache.stacked.shape[1]
        pad += n_full * (b_pad - cache.nv_full)
    return pad


def scan_cache(acc, cache: DeviceCache, one, weighted: bool):
    """Fold every cached batch into `acc` in stream order:
    one(acc, xb, wb, nv) for each full batch, then for the tail. Each xb
    is a contiguous (B_pad, d) view of its slot."""
    if cache.stacked is not None:
        for i in range(cache.stacked.shape[0]):
            acc = one(acc, cache.stacked[i],
                      cache.w_stacked[i] if weighted else None,
                      cache.nv_full)
    return one(acc, cache.tail, cache.w_tail, cache.nv_tail)


# A slot's first byte is a multiple of this, as a fresh allocation's is
# (the CUDA caching allocator's 512-byte blocks): a kernel reading a slot
# takes the path it takes on the streamed batch.
_SLOT_ALIGN = 512


def _stacked_like(t: torch.Tensor, n: int) -> torch.Tensor:
    """Room for n batches shaped like `t`, on its device: an (n, *shape)
    view whose slots are contiguous and start _SLOT_ALIGN-aligned."""
    per = t.numel()
    stride = -(-per * t.element_size() // _SLOT_ALIGN) * _SLOT_ALIGN
    stride //= t.element_size()
    buf = torch.empty((n * stride,), dtype=t.dtype, device=t.device)
    return buf.as_strided((n, *t.shape), (stride, *t.stride()))


class DeviceCacheBuilder:
    """Fills a DeviceCache during the first streamed pass.

    add() takes each prepared batch (on the fit's device, padded to the
    rank slice) and this rank's valid rows of it. Every batch but the last
    must have one shape and one valid-row count; any surprise (more or
    fewer batches than advertised, a ragged middle batch, a tail of
    another width, a weight stream that comes or goes, a CUDA
    out-of-memory error) abandons the cache with a structlog event, frees
    it, and finish() returns None: the fit keeps streaming, never
    computing on a wrong cache."""

    def __init__(self, n_batches: int, *, weighted: bool = False,
                 label: str = "fit"):
        if n_batches < 1:
            raise ValueError(f"n_batches must be >= 1, got {n_batches}")
        self.n_batches = int(n_batches)
        self.weighted = weighted
        self.label = label
        self.abandoned: str | None = None
        self._i = 0
        self._stacked = self._w_stacked = None
        self._tail = self._w_tail = None
        self._full_shape = None
        self._nv_full: int | None = None
        self._nv_tail: int | None = None

    def abandon(self, reason: str, **fields) -> None:
        """Drop the cache (one event, the first reason kept): a geometry
        surprise in the fill, or a quarantined batch, which the cache
        would not hold; the fit streams on."""
        if self.abandoned is None:
            emit("residency_cache_abandoned", label=self.label,
                 reason=reason, **fields)
        self.abandoned = reason
        self._stacked = self._w_stacked = self._tail = self._w_tail = None

    def add(self, xb: torch.Tensor, n_valid: int, wb=None) -> None:
        """Record one prepared batch. Never raises on a geometry surprise
        or an out-of-memory error: it abandons."""
        if self.abandoned is not None:
            return
        i = self._i
        if i >= self.n_batches:
            self.abandon("more_batches_than_advertised",
                        advertised=self.n_batches)
            return
        if self.weighted != (wb is not None):
            self.abandon("weight_stream_mismatch")
            return
        try:
            if i == self.n_batches - 1:  # the tail (any row count)
                if self._full_shape is not None and (
                        tuple(xb.shape[1:]) != self._full_shape[1:]):
                    self.abandon("tail_feature_width_mismatch",
                                got=list(xb.shape),
                                expected=list(self._full_shape))
                    return
                self._tail, self._w_tail = xb, wb
                self._nv_tail = int(n_valid)
            else:
                if i == 0:
                    self._full_shape = tuple(xb.shape)
                    self._nv_full = int(n_valid)
                    self._stacked = _stacked_like(xb, self.n_batches - 1)
                    if self.weighted:
                        self._w_stacked = _stacked_like(
                            wb, self.n_batches - 1)
                elif (tuple(xb.shape) != self._full_shape
                      or int(n_valid) != self._nv_full):
                    self.abandon("batch_geometry_mismatch", batch=i,
                                got=list(xb.shape),
                                expected=list(self._full_shape))
                    return
                self._stacked[i].copy_(xb)
                if self.weighted:
                    self._w_stacked[i].copy_(wb)
        except Exception as e:
            if not is_oom_error(e):
                raise
            self.abandon("hbm_oom_during_fill", error=str(e)[:200])
        else:
            self._i = i + 1
            return
        # Outside the handler, so its frames hold no buffer any more.
        release_device_memory()

    def finish(self) -> DeviceCache | None:
        """The filled cache, or None if the fill was abandoned (a stream
        that ended before its advertised batch count included)."""
        if self.abandoned is None and self._i != self.n_batches:
            self.abandon("fewer_batches_than_advertised", got=self._i,
                        advertised=self.n_batches)
        if self.abandoned is not None:
            return None
        return DeviceCache(stacked=self._stacked, tail=self._tail,
                           w_stacked=self._w_stacked, w_tail=self._w_tail,
                           nv_full=self._nv_full, nv_tail=self._nv_tail)


__all__ = [
    "RESIDENCY_MODES",
    "DeviceCache",
    "DeviceCacheBuilder",
    "ResidencyPlan",
    "SizedBatches",
    "StreamHints",
    "cache_pad_rows",
    "plan_residency",
    "scan_cache",
    "state_reserve_bytes",
    "stream_hints",
    "stream_itemsize",
]
