"""Exact out-of-core Lloyd K-Means and Fuzzy C-Means over streamed
batches (counterpart: tdc_tpu/models/streaming.py, the core:
`_history_array`, `_prefetched`, `_run_pass`,
`_prepare_batch`, `_check_equal_local_rows`, `streaming_fold`,
`streamed_kmeans_fit`, `mean_combine_fit` and `streamed_fuzzy_fit`).

The reference's out-of-core job (run_experiments,
scripts/distribuitedClustering.py:296-318) runs an independent K-Means
per batch and averages the centroids (`mean_combine_fit` keeps that for
comparison). The exact streamed fit instead sums the sufficient
statistics of every batch within an iteration and updates the centroids
once: the same fit as in memory up to the f32 summation order, with only
the (K, d) stats on the device between batches.

Each pass reads the stream once (`_run_pass`) through the ingest guard
(`data/ingest.guard_stream`: read retries, the host checks, CRCs): every
batch is copied to the fit's device with a plain synchronous copy
(`_prepare_batch`), screened there for non-finite values, and handed to
the stats route of `kernel`: 'pallas' runs the CUDA kernels
(B1, B5 on bf16 batches, B2 + B3 past the fused limit; B4 weighted; B6
for fuzzy), 'pallas_bf16' runs B5, 'xla' the plain PyTorch stats. A
kernel that fails to build or launch raises; nothing here catches it.

Several ranks (`mesh=`): every rank passes the same stream, as the
in-memory fits take the same x. Each rank copies only its rows of every
batch (`host_shard_bounds`), padded with zero rows to ceil(B / P), so
every rank's slice has the same size; the padding's exact contribution is
subtracted (`parallel.sharded_k.padding_correction`: each zero row lands
on the argmin-‖c‖² cluster). The pad count, like a bad batch, travels in
the stats' all_reduce, so every rank corrects by the same count and
raises on the same batch. reduce='per_batch' all-reduces every batch;
'per_pass' accumulates each rank's stats in f32 and all-reduces once per
pass (`parallel/reduce.py`); 'per_pass:bf16' and 'per_pass:int8' also
encode the (K, d) sums on the wire, each rank carrying its residual from
pass to pass (error feedback). On a hierarchical mesh
(`make_hierarchical_mesh`) a rank's rows are its joint (dcn, ici) block
and every reduce runs ici first. The fit result's `comms` counts the
reduces and their logical bytes.

The loops run on the host, as the in-memory fits' do: the shift is read
once per iteration when tol >= 0. The semantics are the JAX fits':
tol < 0 runs exactly max_iters iterations; one more pass scores the
returned centroids; converged = tol >= 0 and shift <= tol; the history
holds [cost, shift] per iteration. A named init is resolved against the
first batch of the stream (rank 0's draw, broadcast, under a mesh), so a
streamed fit seeded by name differs from an in-memory one.

Residency (`residency=`, the JAX package's modes and events): 'hbm'
fills a device cache during the first pass (`data/device_cache.py`) and
runs iterations 2..N over it (`_Pass.run_cached`), reading nothing from
the stream; 'spill' stages the batches ahead of the consumer on worker
threads, through pinned buffers and a copy stream on the card
(`data/spill.py`); 'auto' takes the cache where the planner's budget holds
it, else the ring, else streams. Every mode gives the bits of
residency='stream': the cache and the ring hold exactly the tensors the
streamed pass hands to the kernels, visited in the same order.

Checkpoints (`ckpt_dir`, `utils/checkpoint.py`): the K-Means and fuzzy
fits save every `ckpt_every` iterations and at the end, and with
`ckpt_every_batches` also mid-pass: the accumulator, the batch cursor
and the rows it covers. A resume replays the interrupted pass's first
batches on the host only (their shapes: no copy, no kernel) and adds the
rest in the same order, so a resumed fit equals an uninterrupted one bit
for bit. A gang (a mesh of several ranks) has rank 0 write and every
rank meet at a barrier; every rank restores the same step. With
`utils/preempt.install_preemption_handler` a SIGTERM ends the fit at the
next batch boundary (one rank) or after the pass (a gang) with a
checkpoint and `Preempted` (exit code 75); `utils/heartbeat.maybe_beat`
marks every batch, and every pass over a device cache. A pass over a
cache ends at the iteration's end: its preemption check comes after it.

Ingest (`ingest=`, `data/ingest.IngestPolicy`; the result's `ingest` is
the IngestReport): a quarantined batch (a CRC mismatch, a wrong width, a
non-finite value, an injected verdict) is staged as the all-padding batch
of its geometry and adds nothing, so the fit equals the fit without that
batch; the strict default policy aborts at the first quarantine
(`IngestAbort`). The batch's collectives run all the same. Under a mesh
with reduce='per_batch' each rank scans its own rows on its device and
the batch's all_reduce carries every rank's verdict, so all ranks drop
the batch if any rank found it bad; under 'per_pass', where no reduce
follows a batch, the guard scans the whole batch on the host, which
every rank reads, so every rank reaches the same verdict. The end of
every pass crosschecks the ranks' rows, batches and quarantined rows. On
several ranks aborts, and reads that failed for good, wait for the end
of the pass, and mid-pass checkpoints are not written after such a
failure. The streamed GMM fit is not guarded (as in the JAX package): a
bad batch ends it.

Not ported, raising NotImplementedError that names ROADMAP.md Queue A,
A10: coarse or bounded assignment.
"""

from __future__ import annotations

import sys
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from tdc_tpu_torch.data import device_cache as cache_lib
from tdc_tpu_torch.data import ingest as ingest_lib
from tdc_tpu_torch.data import spill as spill_lib
from tdc_tpu_torch.data.device_cache import RESIDENCY_MODES
from tdc_tpu_torch.data.ingest import IngestAbort, Quarantined, screen_batch
from tdc_tpu_torch.data.loader import restore_bf16
from tdc_tpu_torch.data.spill import StagedBatch, device_rows
from tdc_tpu_torch.models.fuzzy import FuzzyCMeansResult
from tdc_tpu_torch.models.kmeans import (
    KMeansResult,
    _normalize,
    _not_ported,
    auto_block_rows,
    resolve_init,
    resolve_init_replicated,
)
from tdc_tpu_torch.ops.assign import (
    FuzzyStats,
    SufficientStats,
    apply_centroid_update,
    fuzzy_stats,
    fuzzy_stats_padded_blocked,
    fuzzy_stats_weighted,
    fuzzy_stats_weighted_blocked,
    lloyd_stats,
    lloyd_stats_padded_blocked,
    lloyd_stats_weighted,
    lloyd_stats_weighted_blocked,
)
from tdc_tpu_torch.parallel import reduce as reduce_lib
from tdc_tpu_torch.parallel import reshard as reshard_lib
from tdc_tpu_torch.testing.faults import fault_point
from tdc_tpu_torch.utils import checkpoint as ckpt_lib
from tdc_tpu_torch.utils import preempt
from tdc_tpu_torch.utils.device import resolve_device
from tdc_tpu_torch.utils.heartbeat import maybe_beat
from tdc_tpu_torch.utils.structlog import emit


# ---------------------------------------------------------------------------
# The stream: prefetch, staging, one pass
# ---------------------------------------------------------------------------


def _prefetched(it, depth: int):
    """Pull `it` on a background thread through a bounded queue, so the
    host-side part of staging (slicing this rank's rows, restoring bf16
    files, converting dtypes) overlaps the device work. depth <= 0 yields
    `it` unchanged. The machinery is `data/spill.prefetch_map`'s:
    producer exceptions re-raise in the consumer after the items queued
    before them, and an early consumer exit joins the producer."""
    return spill_lib.prefetch_map(it, depth)


def _history_array(history) -> np.ndarray:
    """(n, 2) f32 from a list of (cost, shift) pairs that may hold device
    scalars (the tol < 0 loop reads nothing per iteration): one stack, one
    copy to the host."""
    if not history:
        return np.zeros((0, 2), np.float32)
    if not any(isinstance(v, torch.Tensor) for pair in history
               for v in pair):
        return np.asarray(history, np.float32)
    dev = next(v.device for pair in history for v in pair
               if isinstance(v, torch.Tensor))
    rows = [torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                         device=dev).reshape(())
                         for v in pair]) for pair in history]
    return torch.stack(rows).cpu().numpy().astype(np.float32)


def _weighted_stream(batches, sample_weight_batches):
    """Pair a point stream with an optional weight stream, strictly: a
    weight stream that runs short must not silently drop point batches."""
    if sample_weight_batches is None:
        return batches
    return lambda: zip(batches(), sample_weight_batches(), strict=True)


class _Staged(NamedTuple):
    """One batch as this rank stages it on the host."""

    x: object  # this rank's rows: numpy (f32), a tensor (f32 or bf16)
    w: object  # their weights (numpy f32) or None
    rows: int  # the global batch's rows
    slice_rows: int  # this rank's padded slice: ceil(rows / P)
    verdict: object = None  # a quarantine's reason (data/ingest.py)


def _data_ranks(mesh) -> tuple[int, int]:
    """(this rank's block, the block count) along the mesh's data axes
    (`parallel.mesh.data_index`); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    from tdc_tpu_torch.parallel.mesh import data_index

    return data_index(mesh)


def _host_rows(a):
    """A batch's rows in a form the device copy takes: numpy f32 (a
    contiguous f32 slice, memory-mapped ones too, as it is: the copy to
    the card reads it), or a tensor in f32 or bf16 (a '|V2' bf16 array is
    restored as torch.bfloat16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype not in (torch.float32, torch.bfloat16):
            a = a.float()
        return a.contiguous() if a.device.type == "cpu" else a
    a = restore_bf16(a)
    if isinstance(a, torch.Tensor):
        return a
    return np.ascontiguousarray(a, dtype=np.float32)


def _slice_rows(rows: int, mesh, pad: bool) -> int:
    """The rows of this rank's device slice of a `rows`-row batch: ceil(B
    / P) for every rank where the fit pads the slices to one size, else
    its own np.array_split share."""
    index, count = _data_ranks(mesh)
    if pad:
        return -(-rows // count)
    from tdc_tpu_torch.parallel.multihost import host_shard_bounds

    s, e = host_shard_bounds(rows, index, count)
    return e - s


def _cast_rows(a, cast):
    """Host rows (numpy f32 or a tensor) as a tensor of dtype `cast` (the
    K-sharded fits' bf16 cast: half the bytes copied to the card); None
    leaves them as they are."""
    if cast is None or getattr(a, "dtype", None) == cast:
        return a
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(cast)


def _stage(batch, d: int, mesh, weighted: bool, *, pad: bool = True,
           cast=None) -> _Staged:
    """Host side of a batch: the width contract, then this rank's rows
    (np.array_split bounds over the data axis) and their weights. A
    `Quarantined` marker stages as the all-padding batch of its geometry:
    no valid rows (zero weights), the slice of the batch's row count.
    pad=False keeps a rank's slice at its own rows (the K-sharded fits
    pad nothing); `cast` converts the rows on the host (`_cast_rows`)."""
    if isinstance(batch, Quarantined):
        rows = int(batch.x.shape[0])
        return _Staged(np.zeros((0, d), np.float32),
                       np.zeros(0, np.float32) if weighted else None, rows,
                       _slice_rows(rows, mesh, pad), batch.reason)
    xb, wb = batch if weighted else (batch, None)
    if xb.ndim != 2 or xb.shape[1] != d:
        raise IngestAbort(
            f"a streamed batch has shape {tuple(xb.shape)}; every batch "
            f"must be (rows, {d}) (bad_shape)")
    rows = int(xb.shape[0])
    if wb is not None:
        wb = np.asarray(wb.cpu() if isinstance(wb, torch.Tensor) else wb,
                        np.float32)
        if wb.shape != (rows,):
            raise ValueError(
                f"weight batch shape {wb.shape} != ({rows},) — the weight "
                "stream must yield one weight row per point row, batch "
                "for batch")
    index, count = _data_ranks(mesh)
    if count > 1:
        from tdc_tpu_torch.parallel.multihost import host_shard_bounds

        s, e = host_shard_bounds(rows, index, count)
        xb = xb[s:e]
        wb = None if wb is None else wb[s:e]
    return _Staged(_cast_rows(_host_rows(xb), cast), wb, rows,
                   _slice_rows(rows, mesh, pad))


def _prepare_batch(sb: _Staged, device):
    """(rows, weights or None) of a staged batch on `device`: this rank's
    rows copied with a plain synchronous copy and zero-padded to the rank
    slice ceil(B / P) (zero weights for the pad rows)."""
    return (device_rows(sb.x, sb.slice_rows, device),
            None if sb.w is None else device_rows(sb.w, sb.slice_rows,
                                                  device))


def _put_staged(sb: _Staged, put) -> StagedBatch:
    """A staged batch on the device through `put(a, rows)`: the spill
    ring's copies, or `device_rows` inline; the same tensors either way."""
    return StagedBatch(put(sb.x, sb.slice_rows), int(sb.x.shape[0]),
                       sb.rows,
                       None if sb.w is None else put(sb.w, sb.slice_rows),
                       verdict=sb.verdict)


def _check_equal_local_rows(first_rows, mesh, device) -> None:
    """Every rank must stream the same batches: checked once, on the
    first batch's row count (equal counts give equal rank slices)."""
    if mesh is None or mesh.size <= 1:
        return
    from tdc_tpu_torch.parallel.mesh import check_same_on_every_rank

    check_same_on_every_rank(
        torch.tensor([float(first_rows)], dtype=torch.float64,
                     device=device),
        what="first batch's row counts (every rank streams the same "
             "batches)")


def _batch_rows(batch) -> int:
    """A stream batch's row count, read from its shape alone (weighted
    streams yield (x, w) pairs; a quarantined batch keeps its geometry,
    so a verdict never moves a resume's row count)."""
    if isinstance(batch, Quarantined):
        return int(batch.x.shape[0])
    return int((batch[0] if isinstance(batch, tuple) else batch).shape[0])


class _Replayed(NamedTuple):
    """A batch of a resumed pass's replayed prefix: its rows only."""

    rows: int


def _run_pass(batches, prefetch: int, zero_acc, step_fn, stage=None, *,
              ckpt=None, ckpt_every_batches=None, n_iter: int = 0,
              skip: int = 0, acc0=None, rows0: int = 0, save_args=None,
              preempt_batch: bool = False, preempt_can_save: bool = False):
    """One accumulation pass over the stream, the loop every streamed
    fit shares: step_fn(acc, batch) -> (acc, n_rows) for each batch,
    `stage` (host-side, on the prefetch thread when prefetch > 0) first.
    Returns (acc, rows). The staging thread stops when the loop ends, a
    raise included.

    Resume (skip > 0): the first `skip` batches are replayed on the host
    only (their row counts, read from their shapes: no copy to the
    device, no kernel) into `acc0`, which covers `rows0` rows. A prefix
    that now holds another row count means the batch layout changed: the
    pass restarts from its beginning with a fresh accumulator (a note on
    stderr).

    Mid-pass checkpoints (ckpt + ckpt_every_batches, n_iter > 0 only,
    never in the final scoring pass): every ckpt_every_batches consumed
    batches the accumulator, the cursor and the rows go to ckpt.save,
    with save_args = (centroids, shift, history), constant over a pass.

    Preemption (utils/preempt): with preempt_batch (a fit of one rank), a
    raised flag ends the pass at the next batch boundary with Preempted,
    after a mid-pass save where preempt_can_save allows one (the caller
    set ckpt_every_batches and the accumulator is not a per-pass
    deferred one) and the periodic save did not just write this state.
    A gang checks once per pass instead (the fits' loops).

    maybe_beat marks every batch, the replayed ones too."""
    while True:
        acc = acc0 if acc0 is not None else zero_acc()
        rows = rows0
        skipped_rows = 0
        prefix_ok = skip == 0
        mismatch = False

        def staged(skip=skip):
            for i, batch in enumerate(batches()):
                if i < skip:
                    yield _Replayed(_batch_rows(batch))
                else:
                    yield batch if stage is None else stage(batch)

        it = _prefetched(staged(), prefetch)
        try:
            for i, batch in enumerate(it):
                maybe_beat(progress=f"iter={n_iter} batch={i}")
                fault_point("stream.batch")
                if i < skip:
                    if preempt_batch and preempt.requested():
                        # The checkpoint on disk covers this state.
                        raise preempt.Preempted(
                            f"preempted during resume replay at batch "
                            f"{i + 1}")
                    skipped_rows += batch.rows
                    if i == skip - 1:
                        if skipped_rows != rows0:
                            mismatch = True
                            break
                        prefix_ok = True
                    continue
                acc, n_rows = step_fn(acc, batch)
                rows += int(n_rows)
                consumed = i + 1
                can_save = (n_iter > 0 and ckpt is not None
                            and ckpt.dir is not None)
                # Host-side bookkeeping (Python ints and flags).
                saved = bool(can_save and ckpt_every_batches  # tdclint: disable=TDC002
                             and consumed % ckpt_every_batches == 0)
                if saved:
                    ckpt.save(n_iter - 1, *save_args, batch_cursor=consumed,
                              acc=acc, rows_seen=rows)
                if preempt_batch and preempt.requested():
                    if preempt_can_save and can_save and not saved:
                        ckpt.save(n_iter - 1, *save_args,
                                  batch_cursor=consumed, acc=acc,
                                  rows_seen=rows)
                    raise preempt.Preempted(
                        f"preempted at batch boundary {consumed} of "
                        f"iteration {n_iter}")
        finally:
            it.close()
        if not mismatch and not prefix_ok:
            # The stream ended inside the replayed prefix.
            mismatch = True
        if not mismatch:
            return acc, rows
        print(f"note: mid-pass checkpoint covers {rows0} rows but the first "
              f"{skip} batches now hold {skipped_rows}; batch layout changed "
              "— restarting the interrupted pass from its beginning",
              file=sys.stderr)
        skip, acc0, rows0 = 0, None, 0


# ---------------------------------------------------------------------------
# Per-batch accumulation and the shared pass machinery
# ---------------------------------------------------------------------------


def _screen_device(xb, wb) -> str | None:
    """The non-finite scan (and the weights' sign) of a batch already on
    the fit's device: one reduction and one scalar read."""
    reason = screen_batch(xb, w=wb)
    if reason is None and wb is not None and bool((wb < 0).any()):
        reason = "negative_weights"
    return reason


def _raise_bad(reason: str, where: str) -> None:
    """The end of a fit that is not guarded (the streamed GMM fit, the
    mean-combined fit, as in the JAX package) at a bad batch; negative
    weights end any fit."""
    if reason == "negative_weights":
        raise ValueError("sample weights must be nonnegative")
    raise IngestAbort(
        f"{where} failed the ingest screen ({reason}); this fit is not "
        "routed through the ingest guard, so a bad batch ends it")


def _crosscheck_pass(device, rows: int, batches: int, quarantined: int,
                     failed: bool) -> bool:
    """The end of a gang's pass: every rank must have streamed the same
    rows in the same batches and reached the same ingest verdicts
    (quarantined rows). Returns whether a read failed for good on some
    rank (the guards raise then; the totals are not compared). One
    all_reduce (`parallel.mesh.rank_range`), so every rank learns of a
    difference and raises alike."""
    from tdc_tpu_torch.parallel.mesh import rank_range

    mine = [float(rows), float(batches), float(quarantined), float(failed)]
    lo, hi = rank_range(torch.tensor(mine, dtype=torch.float64,
                                     device=device))
    if hi[3] > 0:
        return True
    if hi[:2] != lo[:2]:
        raise ValueError(
            f"the per-pass row and batch totals (every rank streams the "
            f"same batches) differ between ranks (this rank: {mine[:2]}, "
            f"range over the ranks: {lo[:2]} to {hi[:2]}); every rank must "
            "pass the same stream")
    if hi[2] != lo[2]:
        emit("ingest_abort", quarantined_rows=int(quarantined),
             detail="quarantine verdicts diverge across ranks")
        raise IngestAbort(
            "multi-process streamed fit: ingest quarantine verdicts diverge "
            f"across ranks (quarantined rows from {int(lo[2])} to "
            f"{int(hi[2])}; this rank {int(quarantined)}) — every rank "
            "must read the same bytes of every batch")
    return False


class _Pass:
    """The pass machinery the three streamed fits share.

    local(xb, wb, params) gives one batch's stats of this rank's rows
    (uncorrected); correct(stats, n_pad, params, dtype) subtracts n_pad
    zero rows' contribution. Per pass: stage, copy, screen, stats; per
    batch (or once per pass) the all_reduce that also carries the pad
    count and the bad-batch count; then the correction. A quantized
    per-pass reduce keeps this rank's error-feedback residual in
    `self.err` from pass to pass. `batches` may be a spill ring
    (`data/spill.py`), whose StagedBatch items skip the inline staging;
    `run_cached` makes a pass over a device cache instead of the
    stream.

    `guard` (a `data/ingest.GuardedStream`, the stream's own guard) turns
    a batch that fails the screen into a quarantine: the batch adds
    nothing and its collectives run all the same (module docstring).
    Without one (the streamed GMM fit) a bad batch ends the fit on every
    rank.

    The K-sharded fits (`parallel/sharded_k.py`) pass `stage` (the host
    side of a batch, in place of `_stage`), `deferred_fns` (their
    per-pass (zero, add, reduce)) and `cost_shapes` (the logical (K, d)
    stats a reduce is booked at, where `shapes` is a rank's K-shard)."""

    def __init__(self, batches, *, d, mesh, device, prefetch, weighted,
                 strategy, shapes, local, correct, guard=None, stage=None,
                 deferred_fns=None, cost_shapes=None):
        self.batches, self.d, self.mesh, self.device = (batches, d, mesh,
                                                        device)
        self.guard = guard
        self.prefetch, self.weighted = prefetch, weighted
        self.local, self.correct = local, correct
        self.stage = stage or (lambda batch: _stage(batch, d, mesh,
                                                    weighted))
        self.multi = _data_ranks(mesh)[1] > 1
        # Several ranks in all (a K-sharded grid may have one data rank).
        self.gang = _is_gang(mesh)
        self.deferred = strategy.deferred and self.multi
        self.counter = reduce_lib.CommsCounter(
            _mirror=reduce_lib.GLOBAL_COMMS)
        self.passes = 0
        self.strategy = strategy
        self.zero = lambda: reduce_lib.zero_deferred(shapes, device)
        self.err = None
        if self.multi:
            from tdc_tpu_torch.parallel.mesh import data_axes

            quantize = strategy.quantize
            self.cost = reduce_lib.tree_reduce_cost(
                cost_shapes or shapes, data_axes(mesh), quantize)
            self.zero, self.acc_add, self.reducer = (
                deferred_fns or reduce_lib.make_deferred_fns(
                    mesh, shapes, local, quantize, device))
            if quantize is not None:
                self.err = self.zero()
        self._extras = {}
        if guard is not None:
            # A rank that aborted alone would leave the others waiting in
            # a collective: on several ranks aborts wait for the pass end.
            guard.defer_aborts = self.gang
            # No reduce follows a batch under 'per_pass': the verdicts
            # must agree by construction (module docstring).
            guard.scan_on_host = self.deferred

    def _extra(self, pad: float) -> torch.Tensor:
        """[pad, 0, 0] on the device, made once per value: a cached
        batch's reduce payload, with no copy from the host per pass."""
        if pad not in self._extras:
            self._extras[pad] = torch.tensor(
                [pad, 0.0, 0.0], dtype=torch.float32, device=self.device)
        return self._extras[pad]

    def _reduced(self, s, extra, params, dtype, where):
        """All-reduce `s` with `extra` = [pad rows, bad rank slices,
        batches with negative weights] riding in the same buffer: every
        rank then corrects by the same count and raises alike. Returns
        (s, the bad rank slices): without a guard bad slices end the fit,
        with one the caller quarantines."""
        if self.err is None:
            s, ex = self.reducer(s, extra)
        else:
            s, self.err, ex = self.reducer(s, self.err, extra)
        self.counter.add(*self.cost)
        pad, bad, negative = (float(v) for v in ex)
        if negative > 0:
            _raise_bad("negative_weights", where)
        if bad > 0 and self.guard is None:
            _raise_bad(f"nonfinite on {int(bad)} rank slice(s)", where)
        if pad > 0:
            s = self.correct(s, pad, params, dtype)
        return s, bad

    def _screen(self, xb, wb) -> str | None:
        """The device scan of a batch's valid rows: the non-finite scan
        unless the guard's policy turns the screen off; the weights' sign
        always (a contract, not a verdict). Under the guard's
        `scan_on_host` the host scanned the values already."""
        g = self.guard
        if g is None or (g.policy.screen and not g.scan_on_host):
            return _screen_device(xb, wb)
        if wb is not None and bool((wb < 0).any()):
            return "negative_weights"
        return None

    def run(self, params, fill=None, **resume):
        """One pass; returns (stats of every row of the stream, the
        stream's row count). `fill` (a DeviceCacheBuilder) receives every
        batch that passed its screen and is abandoned at a quarantined
        one. `resume` holds `_run_pass`'s cursor, checkpoint and
        preemption arguments."""
        self.passes += 1
        dev = self.device
        guard = self.guard
        state = {"extra": torch.zeros(3, dtype=torch.float32, device=dev),
                 "dtype": torch.float32, "i": 0, "batches": 0}

        def stage(batch):
            if isinstance(batch, StagedBatch):
                return batch
            return self.stage(batch)

        def keep(xb, wb, pad) -> None:
            if fill is not None:
                fill.add(xb, xb.shape[0] - pad, wb)

        def drop(i, sb, reason) -> None:
            """A bad batch: booked with the guard unless its read already
            was (a host verdict), and the cache abandoned. Without a guard
            (a per-pass gang) the pass's reduce ends the fit."""
            if guard is not None and sb.verdict is None:
                guard.quarantine_after_read(i, sb.n_local, reason)
            if fill is not None:
                fill.abandon("quarantined_batch", batch=i)

        def step(acc, sb):
            i = state["i"]
            state["i"] += 1
            if not isinstance(sb, StagedBatch):
                if sb.rows == 0:
                    return acc, 0
                sb = _put_staged(sb, lambda a, rows: device_rows(a, rows,
                                                                 dev))
            elif sb.n_local == 0:
                return acc, 0
            state["batches"] += 1
            xb, wb, n = sb.xb, sb.wb, sb.n_valid
            reason = sb.verdict
            if reason is None:
                state["dtype"] = xb.dtype
                reason = self._screen(xb[:n], None if wb is None else wb[:n])
            negative = reason == "negative_weights"
            bad = reason is not None and not negative
            # Weighted pad rows weigh nothing, and a bad batch's rows are
            # never scored: no correction.
            pad = 0 if self.weighted or bad else xb.shape[0] - n
            if not self.multi:
                if reason is not None and (guard is None or negative):
                    _raise_bad(reason, f"batch {i}")
                if bad:
                    drop(i, sb, reason)
                    return acc, sb.n_local
                keep(xb, wb, pad)
                return reduce_lib.tree_add(
                    acc, self.local(xb, wb, params)), sb.n_local
            extra = torch.tensor([float(pad), float(bad), float(negative)],
                                 dtype=torch.float32, device=dev)
            if self.deferred:
                # Every rank's verdict (the guard's host scan; the pass's
                # crosscheck holds them equal).
                state["extra"] += extra
                if bad:
                    drop(i, sb, reason)
                    return acc, sb.n_local
                keep(xb, wb, pad)
                return (acc if negative
                        else self.acc_add(acc, xb, wb, params)), sb.n_local
            s = (self.zero() if reason is not None
                 else self.local(xb, wb, params))
            s, n_bad = self._reduced(s, extra, params, xb.dtype, f"batch {i}")
            if n_bad > 0:
                # Bad on some rank: every rank drops the batch.
                drop(i, sb, reason or "quarantined_on_another_rank")
                return acc, sb.n_local
            keep(xb, wb, pad)
            return reduce_lib.tree_add(acc, s), sb.n_local

        acc, rows = _run_pass(self.batches, self.prefetch, self.zero, step,
                              stage=stage, **resume)
        if self.deferred:
            acc = self._reduced(acc, state["extra"], params, state["dtype"],
                                f"pass {self.passes}")[0]
        failed_elsewhere = False
        if self.gang:
            # Every rank streamed the same rows in the same batches and
            # reached the same verdicts (a divergence would otherwise sum
            # mismatched slices silently), unless a read failed.
            failed_elsewhere = _crosscheck_pass(
                dev, rows, state["batches"],
                0 if guard is None else guard.quarantined_rows_seen(),
                guard is not None and guard.failed())
        if guard is not None:
            guard.raise_deferred(failed_elsewhere)
        return acc, rows

    def run_cached(self, params, cache):
        """One pass over a device cache (`data/device_cache.py`): the
        calls `run` makes for each batch, in the same order (the stats,
        the reduces, the padding corrections), so the same bits; the
        screens and copies are left out, the cached batches having passed
        both when they filled it. Returns the stats."""
        self.passes += 1
        w = self.weighted
        if not self.multi:
            return cache_lib.scan_cache(
                self.zero(), cache,
                lambda a, xb, wb, nv: reduce_lib.tree_add(
                    a, self.local(xb, wb, params)), w)
        if self.deferred:
            acc = cache_lib.scan_cache(
                self.zero(), cache,
                lambda a, xb, wb, nv: self.acc_add(a, xb, wb, params), w)
            return self._reduced(
                acc, self._extra(float(cache_lib.cache_pad_rows(cache))),
                params, cache.tail.dtype, f"pass {self.passes}")[0]

        def one(a, xb, wb, nv):
            s = self._reduced(self.local(xb, wb, params),
                              self._extra(float(xb.shape[0] - nv)), params,
                              xb.dtype, "a cached batch")[0]
            return reduce_lib.tree_add(a, s)

        return cache_lib.scan_cache(self.zero(), cache, one, w)

    def agreed(self, cache, label: str):
        """`cache` if every rank of a gang filled one, else None on every
        rank (one collective over every axis: a K-sharded grid's model
        ranks too): the ranks must all run over their caches or all
        stream, or their collectives part ways."""
        if not self.gang:
            return cache
        import torch.distributed as dist

        flag = torch.tensor([int(cache is not None)], dtype=torch.int32,
                            device=self.device)
        self.mesh.psum(flag, *self.mesh.axis_names, op=dist.ReduceOp.MIN)
        if int(flag.item()) == 0 and cache is not None:
            emit("residency_cache_abandoned", label=label,
                 reason="abandoned_on_another_rank")
            return None
        return cache

    def report(self) -> reduce_lib.CommsReport:
        c = self.counter
        return reduce_lib.CommsReport(
            strategy=self.strategy.label(), reduces=c.reduces,
            logical_bytes=c.logical_bytes, passes=self.passes,
            data_bytes=c.data_bytes, model_bytes=c.model_bytes,
            gathers=c.gathers)


def _refuse_unported(label: str, *, residency="stream",
                     assign="exact", probe=None, bounds="hamerly") -> None:
    """The streamed fits' options that are not ported, each naming its
    ROADMAP.md item."""
    if residency not in RESIDENCY_MODES:
        raise ValueError(f"residency={residency!r}: use one of "
                         f"{RESIDENCY_MODES}")
    if assign != "exact" or probe is not None or bounds != "hamerly":
        raise _not_ported(
            f"{label}: assign={assign!r}, probe={probe!r}, bounds="
            f"{bounds!r} (coarse and bounded assignment)", "Queue A, A10")


def _reduce_plan(strategy, mesh, ckpt_dir, ckpt_every_batches,
                 cursor: int = 0, allow_quantize: bool = True) -> None:
    """The JAX package's checks of `reduce=` against the checkpoint
    options (`_reduce_plan`), in its words: a quantized reduce needs
    several ranks and refuses ckpt_dir (a resume would restart the
    error-feedback residual); a per-pass reduce on several ranks refuses
    mid-pass checkpoints and a mid-pass cursor (its accumulator is each
    rank's own partial). allow_quantize=False is the K-sharded fits'
    gate. The ranks counted are the mesh's, both axes of a K-sharded
    grid, as the JAX check counts the mesh's devices."""
    ranks = 1 if mesh is None else mesh.size
    deferred = strategy.deferred and ranks > 1
    if strategy.quantize is not None:
        if not allow_quantize:
            raise ValueError(
                "quantized stats reduce is wired for the 1-D streamed "
                "fits; the K-sharded drivers support "
                "reduce='per_batch'|'per_pass'")
        if ranks <= 1:
            raise ValueError(
                "quantized stats reduce requires a multi-device mesh (there "
                "is no cross-device reduce to quantize)")
        if ckpt_dir is not None:
            raise ValueError(
                "quantized reduce does not support ckpt_dir: a resume would "
                "restart the error-feedback residual, breaking the "
                "bit-identical-resume contract")
    if deferred and ckpt_every_batches:
        raise ValueError(
            "reduce='per_pass' does not support mid-pass checkpointing "
            "(the deferred accumulator is device-layout state); use "
            "per-iteration checkpoints (ckpt_every)")
    if deferred and cursor:
        raise ValueError(
            "cannot resume a mid-pass (per-batch) checkpoint with "
            "reduce='per_pass' — finish the interrupted pass in per-batch "
            "mode or resume from a per-iteration checkpoint")


def _is_gang(mesh) -> bool:
    """Does the fit span several ranks (processes)? Then its checkpoints
    have one writer and its preemption check is a collective."""
    return mesh is not None and mesh.size > 1


def _placed(a, mesh, device) -> torch.Tensor:
    """A host array as a float32 tensor on `device`, rank 0's on every
    rank of `mesh` (the restore's placement: a replicate)."""
    t = torch.as_tensor(np.asarray(a, np.float32)).to(device)
    if mesh is None:
        return t
    from tdc_tpu_torch.parallel.mesh import replicate

    return replicate(t, mesh)


class _ResumeState(NamedTuple):
    centroids: object  # (K, d) f32 tensor, or None without a checkpoint
    start_iter: int
    shift: float
    history: list
    cursor: int  # batches consumed in the interrupted pass (0 = none)
    rows_seen: int  # rows `acc` covers (checks the batch layout)
    acc: object  # the restored accumulator, or None


class _StreamCheckpointer:
    """Checkpoint and restore for the streamed K-Means and fuzzy fits
    (the JAX package's `_StreamCheckpointer`): the accumulator NamedTuple
    is saved through a {meta name: field} map, and `params` (spherical /
    m, weighted) are saved and checked on restore, with k and d, in the
    JAX package's words. Every save records the layout manifest. A
    mid-pass save rewrites the step of the last completed iteration: the
    centroids are those of that step, enriched with the pass's progress.
    """

    def __init__(self, ckpt_dir, k, d, params: dict, acc_map: dict, *,
                 mesh=None, keep: int | None = None, device=None,
                 guard=None):
        self.dir = ckpt_dir
        self.guard = guard
        self.k, self.d = k, d
        self.params = params
        self.acc_map = acc_map
        self.mesh = mesh
        self.gang = _is_gang(mesh)
        self.keep = keep
        self.device = device

    def restore(self, acc_cls) -> _ResumeState:
        none = _ResumeState(None, 0, float("inf"), [], 0, 0, None)
        if self.dir is None:
            return none
        saved = ckpt_lib.restore_checkpoint(self.dir)
        if self.gang:
            # Every rank must resume at the same point (none included), or
            # the ranks' collectives part ways.
            from tdc_tpu_torch.parallel.mesh import check_same_on_every_rank

            point = ([-1, 0, 0] if saved is None else [
                saved.n_iter, saved.batch_cursor,
                int(np.asarray(saved.meta.get("acc_rows", 0)))])
            check_same_on_every_rank(
                torch.tensor(point, dtype=torch.float64, device=self.device),
                what="checkpoint steps and cursors restored")
        if saved is None:
            return none
        if saved.meta.get("k") != self.k or saved.meta.get("d") != self.d:
            raise ValueError(
                f"checkpoint in {self.dir} is for K={saved.meta.get('k')}, "
                f"d={saved.meta.get('d')}, not ({self.k}, {self.d})")
        for name, want in self.params.items():
            legacy = {"weighted": False}
            got = saved.meta.get(name, legacy.get(name, want))
            if isinstance(want, bool):
                mismatch = bool(got) != want
            else:
                mismatch = float(got) != float(want)
            if mismatch:
                raise ValueError(
                    f"checkpoint in {self.dir} was written with {name}={got}; "
                    f"this run uses {name}={want} — refusing to mix state")
        start_iter = saved.n_iter
        # A resume with nothing left to run still reports the run as it
        # was saved.
        shift = float(saved.meta.get("shift", float("inf")))
        hist = np.asarray(saved.meta.get("history", []), np.float32)
        history = [tuple(float(v) for v in r) for r in hist.reshape(-1, 2)]
        # Row i of the history is iteration i + 1: pad a shorter one.
        if len(history) < start_iter:
            history = ([(float("nan"), float("nan"))]
                       * (start_iter - len(history)) + history)
        cursor, rows_seen, acc = 0, 0, None
        if saved.batch_cursor > 0 and next(iter(self.acc_map)) in saved.meta:
            cursor = int(saved.batch_cursor)
            rows_seen = int(np.asarray(saved.meta.get("acc_rows", 0)))
            acc = acc_cls(**{field: saved.meta[name]
                             for name, field in self.acc_map.items()})

        def place(tree):
            c, acc = tree
            return (_placed(c, self.mesh, self.device),
                    None if acc is None else acc_cls(*(
                        _placed(t, self.mesh, self.device) for t in acc)))

        c, acc = reshard_lib.redistribute(
            (saved.centroids, acc), reshard_lib.layout_from_meta(saved.meta),
            self.mesh, place)
        return _ResumeState(c, start_iter, shift, history, cursor, rows_seen,
                            acc)

    def save(self, n_iter, c, shift, history, *, batch_cursor=0, acc=None,
             rows_seen=0) -> None:
        if acc is not None and self.gang and self.guard is not None:
            from tdc_tpu_torch.parallel.mesh import rank_range

            # A read that failed for good on some rank left its batch out
            # of this pass, which then raises: a resume from this state
            # would go without the batch. Every rank skips the save.
            failed = torch.tensor([float(self.guard.failed())],
                                  device=self.device)
            if rank_range(failed)[1][0] > 0:
                return
        meta = {"k": self.k, "d": self.d, "shift": float(shift)}
        meta.update(self.params)
        meta.update(reshard_lib.layout_meta(self.mesh))
        if history:
            meta["history"] = np.asarray(
                [[float(v) for v in r] for r in history],
                np.float32).reshape(-1, 2)
        if acc is not None:
            meta["acc_rows"] = int(rows_seen)
            meta.update({name: getattr(acc, field)
                         for name, field in self.acc_map.items()})
        ckpt_lib.save_checkpoint(
            self.dir,
            ckpt_lib.ClusterState(centroids=c, n_iter=n_iter, key=None,
                                  batch_cursor=batch_cursor, meta=meta),
            step=n_iter, gang=self.gang, keep_last_n=self.keep)


def _first_for_init(guard):
    """The stream's first batch through the guard (retries and the host
    screen apply to it as to any batch). A quarantine verdict refuses: an
    init derived from the zeroed replacement would seed garbage."""
    fb = guard.first_batch()
    if isinstance(fb, Quarantined):
        _refuse_first(guard, fb.reason)
    return fb


def _refuse_first(guard, reason: str) -> None:
    raise IngestAbort(
        f"{guard.label}: the stream's first batch failed the ingest "
        f"screen ({reason}) and the init must be derived from it — "
        "pass an explicit init array, or repair the store")


def _first_batch(stream, d: int, weighted: bool, device, guard=None):
    """The stream's first batch, whole (every rank reads all of it: the
    named inits are resolved against it), screened, on `device`. Through
    `guard` when the fit has one: a verdict (on the host, or the scan on
    the device) refuses the init, after an `ingest_quarantine` event."""
    fb = (next(iter(stream())) if guard is None
          else _first_for_init(guard))
    sb = _stage(fb, d, None, weighted)
    x, w = _prepare_batch(sb, device)
    screen = guard is None or guard.policy.screen
    reason = _screen_device(x, w) if screen else None
    if reason is not None:
        if guard is None or reason == "negative_weights":
            _raise_bad(reason, "the stream's first batch")
        emit("ingest_quarantine", label=guard.label, store=guard.store,
             batch=0, rows=sb.rows, reason=reason, peek=True)
        _refuse_first(guard, reason)
    return x, w, sb.rows


def _resolve_stream_init(stream, k: int, d: int, init, generator, mesh,
                         weighted: bool, device, spherical: bool = False,
                         guard=None, sample_rows: int | None = None):
    """(K, d) f32 centroids: an explicit array as it is (rank 0's under a
    mesh), or a named init resolved against the first batch (through
    `guard`; its first `sample_rows` rows where that is set, as the
    K-sharded fits seed). Returns (centroids, the first batch's row
    count)."""
    if isinstance(init, str):
        first, first_w, rows = _first_batch(stream, d, weighted, device,
                                            guard)
        if sample_rows is not None:
            first = first[:sample_rows]
            first_w = None if first_w is None else first_w[:sample_rows]
        if spherical:
            first = _normalize(first.float())
        if mesh is not None:
            c = resolve_init_replicated(first, k, init, generator, mesh,
                                        first_w)
        else:
            c = resolve_init(first, k, init, generator, first_w)
    else:
        # A copy: the broadcast below writes into it, and on the CPU
        # .to() would hand back the caller's own (perhaps read-only) array.
        c = torch.as_tensor(init if isinstance(init, torch.Tensor)
                            else np.asarray(init)).to(device, torch.float32,
                                                      copy=True)
        if mesh is not None:
            from tdc_tpu_torch.parallel.mesh import replicate

            c = replicate(c.contiguous(), mesh)
        # The equal-rows check reads the first batch's geometry (a
        # quarantined one's included), through the guard.
        fb = (next(iter(stream())) if guard is None
              else guard.first_batch())
        rows = _batch_rows(fb)
    # A copy: first_k's rows are a view that would keep the whole first
    # batch on the device for the fit.
    c = c.to(torch.float32).clone()
    if c.shape != (k, d):
        raise ValueError(f"init shape {tuple(c.shape)} != {(k, d)}")
    return c, rows


# ---------------------------------------------------------------------------
# K-Means
# ---------------------------------------------------------------------------


def _lloyd_shapes(k: int, d: int) -> SufficientStats:
    return SufficientStats(sums=(k, d), counts=(k,), sse=())


def _corrected_lloyd(s: SufficientStats, n_pad, c, kernel: str, dtype):
    """`s` less n_pad zero rows: the kernel routes scored them against
    the centroids cast to the batch dtype, the plain route in f32."""
    from tdc_tpu_torch.parallel.sharded_k import padding_correction

    cd = (c.to(dtype) if kernel in ("pallas", "pallas_bf16") else c)
    counts, sse = padding_correction(s.counts, s.sse, cd, n_pad)
    return SufficientStats(sums=s.sums, counts=counts, sse=sse)


class _LloydRoute:
    """The per-batch Lloyd stats of one fit's kernel: the route's
    function is picked once per batch dtype (one `kernel_selected`
    event), the plain route's row block once from the first batch."""

    def __init__(self, k: int, d: int, kernel: str, label: str):
        self.k, self.d, self.kernel, self.label = k, d, kernel, label
        self.fns = {}
        self.block_rows = None

    def _block(self, xb) -> int:
        if self.block_rows is None:
            self.block_rows = auto_block_rows(xb.shape[0], self.k,
                                              device=xb.device)
        return self.block_rows

    def __call__(self, xb, c, wb=None) -> SufficientStats:
        if wb is not None:
            return self._weighted(xb, c, wb)
        if self.kernel in ("pallas", "pallas_bf16"):
            fn = self.fns.get(xb.dtype)
            if fn is None:
                from tdc_tpu_torch.ops.lloyd_kernels import lloyd_stats_for

                fn = self.fns[xb.dtype] = lloyd_stats_for(
                    self.k, self.d, dtype=xb.dtype, label=self.label,
                    mxu_dtype=("bfloat16" if self.kernel == "pallas_bf16"
                               else None))
            return fn(xb, c)
        block = self._block(xb)
        if block:
            return lloyd_stats_padded_blocked(xb, c, block)
        return lloyd_stats(xb, c)

    def _weighted(self, xb, c, wb) -> SufficientStats:
        if self.kernel == "pallas":
            fn = self.fns.get("weighted")
            if fn is None:
                from tdc_tpu_torch.ops.lloyd_kernels import (
                    lloyd_stats_weighted_for,
                )

                fn = self.fns["weighted"] = lloyd_stats_weighted_for(
                    self.k, self.d, label=self.label)
            return fn(xb, c, wb)
        block = self._block(xb)
        if block:
            return lloyd_stats_weighted_blocked(xb, c, wb, block)
        return lloyd_stats_weighted(xb, c, wb)


def _batch_lloyd_stats(batch, w, centroids, spherical: bool,
                       route: _LloydRoute) -> SufficientStats:
    """One batch's Lloyd stats on `route`, uncorrected (weighted: 'counts'
    is the weight mass); spherical rows normalized first (zero rows stay
    zero)."""
    if spherical:
        batch = _normalize(batch.float())
    return route(batch, centroids, w)


def _lloyd_pass_fns(spherical: bool, route: _LloydRoute, kernel: str):
    """(local, correct) of a K-Means pass (`_Pass`): one batch's Lloyd
    stats on `route` (weighted: pad rows carry zero weight and add
    exactly nothing), and the subtraction of n_pad zero rows (each lands
    on the argmin-‖c‖² cluster with zero Σx and ‖c_j‖² of SSE; spherical
    leaves zero rows unnormalized, with the same result)."""
    return (lambda xb, wb, c: _batch_lloyd_stats(xb, wb, c, spherical,
                                                 route),
            lambda s, n_pad, c, dtype: _corrected_lloyd(s, n_pad, c, kernel,
                                                        dtype))


def _check_kernel(kernel, *, weighted, mesh) -> None:
    """The JAX fits' refusals of an explicit kernel, in their words."""
    if kernel not in ("xla", "pallas", "pallas_bf16"):
        raise ValueError(
            f"unknown kernel {kernel!r} (use 'xla', 'pallas', or "
            "'pallas_bf16')")
    if weighted and kernel == "pallas" and mesh is not None:
        raise ValueError(
            "kernel='pallas' with sample_weight_batches is single-device "
            "(the weighted kernels have no shard_map tower); drop mesh or "
            "the explicit kernel")
    if kernel == "pallas_bf16" and mesh is not None:
        raise ValueError(
            "kernel='pallas_bf16' is single-device (the bf16-MXU epilogue "
            "has no shard_map tower; stream bf16 batches with "
            "kernel='pallas' for the same MXU precision on a mesh)")
    if kernel == "pallas_bf16" and weighted:
        raise ValueError(
            "kernel='pallas_bf16' does not support sample_weight_batches "
            "(the weighted epilogue keeps full precision); drop the "
            "explicit kernel")


def streamed_kmeans_fit(
    batches: Callable[[], Iterable],
    k: int,
    d: int,
    *,
    init,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    spherical: bool = False,
    mesh=None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 5,
    ckpt_every_batches: int | None = None,
    ckpt_keep_last_n: int | None = None,
    prefetch: int = 0,
    sample_weight_batches: Callable[[], Iterable] | None = None,
    kernel: str = "xla",
    reduce="per_batch",
    residency: str = "stream",
    ingest=None,
    assign: str = "exact",
    probe=None,
    bounds: str = "hamerly",
    device=None,
) -> KMeansResult:
    """Exact Lloyd over a re-iterable stream of (B, d) batches.

    Args:
      batches: zero-arg callable returning a fresh iterator over the
        dataset (`data.NpzStream`): numpy arrays (f32, or '|V2' bf16) or
        tensors (f32 or bf16; a tensor on the fit's device is used as it
        is). Each iteration makes one full pass.
      init: explicit (K, d) array, or an init name ('kmeans++', 'random',
        'first_k') resolved against the first batch of the stream.
      generator: torch.Generator on `device` for the named inits (default:
        one seeded with 0).
      spherical: cosine K-Means (rows and centroids L2-normalized).
      mesh: a `parallel.mesh.Mesh`; every rank passes the same stream and
        stages its rows of each batch (see the module docstring).
      prefetch: depth of the host-side staging thread (0 = off).
      sample_weight_batches: zero-arg callable of (B,) weight rows aligned
        batch for batch: mass-weighted stats.
      kernel: 'xla', 'pallas' (B1, B5 on bf16 batches, B2 + B3 past the
        fused limit; weighted B4 or B2 + B3), 'pallas_bf16' (B5),
        'auto' or 'auto:quantized'.
      reduce: 'per_batch' (one all_reduce per batch), 'per_pass' (one
        per iteration), 'per_pass:bf16' or 'per_pass:int8' (the (K, d)
        sums quantized on the wire with error feedback; a mesh of several
        ranks only); a ReduceStrategy.
      device: None means 'cuda'; 'cpu' runs the plain versions.
      ckpt_dir: save a checkpoint (`utils/checkpoint.py`, the JAX
        package's state.npz format) every `ckpt_every` iterations and at
        the end, and resume from the newest one found there.
      ckpt_every_batches: also save mid-pass every this many batches: the
        accumulator (copied to the host after the batch that completes
        it), the batch cursor and the rows it covers, so a resume replays
        the pass's first batches on the host only and adds the rest in
        the same order: bit-identical to an uninterrupted fit.
      ckpt_keep_last_n: keep only the newest N steps (None keeps all).
      residency: 'stream' (the default), 'hbm', 'spill' or 'auto' (see
        the module docstring and `data/device_cache.plan_residency`). 'hbm'
        needs a stream that advertises its size (`NpzStream`,
        `data.device_cache.SizedBatches`) and refuses ckpt_every_batches;
        a mid-pass resume streams that run. The result's `h2d` is the
        spill ring's SpillReport (None off the spill tier).
      ingest: the ingest guard's policy (`data/ingest.IngestPolicy`, a
        dict of its fields, or None for the strict default): read retries,
        quarantine and the loss budget (module docstring). The result's
        `ingest` is the IngestReport; with a clean stream the guarded fit
        is bit for bit the unguarded one.
      assign, probe, bounds: the JAX version's, not ported (they raise,
        naming ROADMAP.md Queue A, A10) but at their defaults.

    Preemption (`utils/preempt.install_preemption_handler`): a SIGTERM
    makes the fit checkpoint at the next batch boundary (one rank; the
    mid-pass save needs ckpt_every_batches) or after the pass (a gang,
    whose ranks agree once per pass) and raise Preempted (exit code 75).

    Returns a KMeansResult with the per-iteration [sse, shift] history,
    `comms` (the reduces this fit issued) and n_iter_run, the iterations
    this call ran.
    """
    weighted = sample_weight_batches is not None
    strategy = reduce_lib.resolve_reduce(reduce)
    _refuse_unported("streamed_kmeans_fit", residency=residency,
                     assign=assign, probe=probe, bounds=bounds)
    dev = resolve_device(device)
    if kernel.startswith("auto"):
        from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

        kernel = resolve_kernel(
            kernel, k=k, d=d, device=dev, label="streamed_kmeans_fit",
            model="kmeans_weighted" if weighted else "kmeans",
            ineligible=("sample weights with a mesh have no weighted "
                        "kernel tower" if weighted and mesh is not None
                        else None),
            mxu_ineligible=("the bf16 epilogue has no data-parallel tower"
                            if mesh is not None else None))
    _check_kernel(kernel, weighted=weighted, mesh=mesh)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    label = "streamed_kmeans_fit"
    stream = _weighted_stream(batches, sample_weight_batches)
    guard = ingest_lib.guard_stream(stream, ingest, d=d, weighted=weighted,
                                    label=label)
    c, first_rows = _resolve_stream_init(stream, k, d, init, generator,
                                         mesh, weighted, dev, spherical,
                                         guard=guard)
    if spherical:
        c = _normalize(c)
    _check_equal_local_rows(first_rows, mesh, dev)
    ckpt = _StreamCheckpointer(
        ckpt_dir, k, d,
        params={"spherical": bool(spherical), "weighted": weighted},
        acc_map={"acc_sums": "sums", "acc_counts": "counts",
                 "acc_sse": "sse"},
        mesh=mesh, keep=ckpt_keep_last_n, device=dev, guard=guard)
    state = ckpt.restore(SufficientStats)
    _reduce_plan(strategy, mesh, ckpt_dir, ckpt_every_batches,
                 cursor=state.cursor)
    plan, builder = _plan_1d_residency(
        residency, batches, k, d, mesh, weighted=weighted, kernel=kernel,
        cursor=state.cursor, label=label,
        mid_pass_ckpt=ckpt_every_batches is not None, device=dev)
    run_stream, h2d = _spilled(plan, guard, d, mesh, weighted, dev)
    local, correct = _lloyd_pass_fns(
        spherical, _LloydRoute(k, d, kernel, label), kernel)
    machine = _Pass(run_stream, d=d, mesh=mesh, device=dev,
                    prefetch=prefetch if h2d is None else 0,
                    weighted=weighted, strategy=strategy,
                    shapes=_lloyd_shapes(k, d), local=local,
                    correct=correct, guard=guard)

    def update(acc, c):
        new_c = apply_centroid_update(acc, c)
        return _normalize(new_c) if spherical else new_c

    try:
        c, n_iter, shift, history, start_iter, cache = _fit_loop(
            machine, ckpt, state, c, update, max_iters=max_iters, tol=tol,
            ckpt_every=ckpt_every, ckpt_every_batches=ckpt_every_batches,
            mass=(lambda acc: acc.counts) if weighted else None,
            cost=lambda acc: acc.sse,
            plan=plan, builder=builder, label=label)
        # One more pass so the SSE is the returned centroids' (the loop's
        # is one update stale).
        sse = _final_stats(machine, cache, c, ckpt.gang).sse
    finally:
        # End the ring's staging of a next pass (no-op off the spill tier).
        spill_lib.release(run_stream)
    return KMeansResult(
        centroids=c, n_iter=n_iter, sse=sse,
        shift=torch.tensor(shift, dtype=torch.float32, device=dev),
        converged=bool(tol >= 0 and shift <= tol),
        history=_history_array(history), n_iter_run=n_iter - start_iter,
        comms=machine.report(),
        h2d=None if h2d is None else h2d.report(plan.spill_slots),
        ingest=guard.report())


def _plan_1d_residency(residency, batches, k, d, mesh, *, weighted,
                       kernel, cursor, label, mid_pass_ckpt, device):
    """The planner for the streamed K-Means and fuzzy fits: each of the P
    data ranks stages ceil(B / P) rows of every batch (the JAX package's
    single-process mesh geometry: pad to P, P devices). Returns (plan,
    cache builder or None); residency='stream' returns (None, None)."""
    if residency == "stream":
        return None, None
    ranks = _data_ranks(mesh)[1]
    plan = cache_lib.plan_residency(
        residency, hints=cache_lib.stream_hints(batches), d=d, k=k,
        n_devices=ranks, pad_multiple=ranks,
        itemsize=cache_lib.stream_itemsize(batches) or 4,
        weighted=weighted, kernel=kernel, cursor=cursor,
        mid_pass_ckpt=mid_pass_ckpt, device=device, label=label)
    builder = (cache_lib.DeviceCacheBuilder(plan.hints.n_batches,
                                            weighted=weighted, label=label)
               if plan.resident else None)
    return plan, builder


def _spilled(plan, stream, d, mesh, weighted, device):
    """(the stream the passes read, its H2DCounter or None): a spill
    ring over the fit's own staging where `plan` picked the spill tier
    (`data/spill.wrap_stream`)."""

    def prepare(batch, put):
        return _put_staged(_stage(batch, d, mesh, weighted), put)

    return spill_lib.wrap_stream(plan, stream, prepare, device=device)


def _fit_loop(machine, ckpt, state, c, update, *, max_iters, tol,
              ckpt_every, ckpt_every_batches, mass, cost, plan=None,
              builder=None, label="", shift_fn=None):
    """The iterations of a streamed K-Means or fuzzy fit (the JAX fits'
    loop): one pass each from the restored state (the interrupted pass's
    cursor and accumulator first), `update(acc, c)` the new centroids,
    the shift read once an iteration when tol >= 0 or checkpointing; a
    checkpoint every `ckpt_every` iterations, on convergence and at the
    last; the preemption check after each iteration (a collective on a
    gang, where the handler is installed). `mass(acc)` (weighted fits)
    must be positive after the first pass.

    Residency (`plan`, not None unless residency='stream'): the first
    pass of the run fills `builder`'s cache, which every rank of a gang
    must have filled; iterations 2..N then run over it (`run_cached`),
    the rest of the loop as it is. `shift_fn(new_c, c)` gives the
    shift (default: the largest centroid movement of `c`; the K-sharded
    fits take it over every model shard). Returns (centroids, n_iter,
    shift, history, start_iter, cache or None)."""
    if state.centroids is not None:
        c = state.centroids
    start_iter, shift, history = state.start_iter, state.shift, state.history
    cursor, acc0 = state.cursor, state.acc
    sync = tol >= 0 or ckpt.dir is not None
    n_iter = start_iter
    cache = None
    # A restored run that had converged has nothing left to do.
    done = tol >= 0 and shift <= tol
    for n_iter in range(start_iter + 1, int(max_iters) + 1) if not done \
            else ():
        first = n_iter == start_iter + 1 and not cursor
        if cache is not None:
            acc = machine.run_cached(c, cache)
            maybe_beat(progress=f"iter={n_iter} cached")
        else:
            acc, _ = machine.run(
                c, fill=builder if first else None, n_iter=n_iter,
                skip=cursor, acc0=acc0,
                rows0=state.rows_seen if cursor else 0, ckpt=ckpt,
                ckpt_every_batches=ckpt_every_batches,
                save_args=(c, shift, history), preempt_batch=not ckpt.gang,
                preempt_can_save=bool(ckpt_every_batches)
                and not machine.deferred)
        if plan is not None and first:
            cache = machine.agreed(None if builder is None
                                   else builder.finish(), label)
        cursor, acc0 = 0, None
        if (mass is not None and n_iter == start_iter + 1
                and float(mass(acc).sum()) <= 0.0):
            raise ValueError(
                "all sample weights are zero — the weighted fit has no mass")
        new_c = update(acc, c)
        shift_dev = (torch.linalg.norm(new_c - c, dim=-1).max()
                     if shift_fn is None else shift_fn(new_c, c))
        shift = float(shift_dev) if sync else shift_dev
        history.append((float(cost(acc)) if sync else cost(acc), shift))
        c = new_c
        done = sync and tol >= 0 and shift <= tol
        saved = ckpt.dir is not None and (
            done or n_iter % ckpt_every == 0 or n_iter == max_iters)
        if saved:
            ckpt.save(n_iter, c, shift, history)
        if preempt.installed() and preempt.sync_requested(
                gang=ckpt.gang, mesh=ckpt.mesh, device=ckpt.device):
            if ckpt.dir is not None and not saved:
                ckpt.save(n_iter, c, shift, history)
            raise preempt.Preempted(f"preempted after iteration {n_iter}")
        if done:
            break
    return c, n_iter, float(shift), history, start_iter, cache


def _final_stats(machine, cache, c, gang: bool):
    """The reporting pass at the returned centroids: over the cache when
    the fit has one, else over the stream."""
    if cache is None:
        return machine.run(c, preempt_batch=not gang)[0]
    return machine.run_cached(c, cache)


def streaming_fold(centroids, counts, batch, n_valid=None,
                   sample_weight=None, decay: float = 1.0):
    """One exact sufficient-stats fold of `batch` into a running
    (centroids, counts) state with exponential forgetting: decay=1 is the
    lifetime running average, decay < 1 down-weights history by `decay`
    per fold. Empty clusters keep their centroid. n_valid marks the first
    rows as real and the rest as zero padding (exact correction); with
    sample_weight, padding carries zero weight instead and counts are
    weight mass. Plain stats, as the JAX version's.

    Returns (new_centroids, new_counts, window_sse): the batch's SSE
    against the centroids before the fold."""
    c = torch.as_tensor(centroids).float()
    batch = torch.as_tensor(batch).to(c.device)
    if sample_weight is not None:
        s = lloyd_stats_weighted(batch, c, torch.as_tensor(
            sample_weight, dtype=torch.float32, device=c.device))
        bcounts, bsums, bsse = s.counts, s.sums, s.sse
    else:
        s = lloyd_stats(batch, c)
        bcounts, bsums, bsse = s.counts, s.sums, s.sse
        if n_valid is not None:
            from tdc_tpu_torch.parallel.sharded_k import padding_correction

            n_pad = float(batch.shape[0]) - float(n_valid)
            bcounts, bsse = padding_correction(bcounts, bsse, c, n_pad)
    prior = torch.as_tensor(counts, dtype=torch.float32,
                            device=c.device) * float(decay)
    new_counts = prior + bcounts
    new_c = (prior[:, None] * c + bsums) / torch.clamp_min(
        new_counts, 1e-12)[:, None]
    new_c = torch.where(new_counts[:, None] > 0, new_c, c)
    return new_c, new_counts, bsse


def mean_combine_fit(
    batches: Callable[[], Iterable],
    k: int,
    d: int,
    *,
    init,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = -1.0,
    spherical: bool = False,
    mesh=None,
    prefetch: int = 0,
    kernel: str = "xla",
    device=None,
) -> KMeansResult:
    """The reference's batch mode: an INDEPENDENT full Lloyd fit per batch
    from the same init, then the unweighted mean of the per-batch
    centroids (scripts/distribuitedClustering.py:310). Not exact Lloyd:
    use streamed_kmeans_fit for that. Empty clusters keep their previous
    centroid instead of going NaN (reference defect 6).

    n_iter = the most iterations of any batch, sse = the combined
    centers' SSE over the whole stream (one extra pass), shift and
    converged the worst per-batch values."""
    from tdc_tpu_torch.models.kmeans import kmeans_fit

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    c0, _ = _resolve_stream_init(batches, k, d, init, generator, mesh,
                                 False, dev, spherical)
    bmesh_size = _data_ranks(mesh)[1]
    total = torch.zeros((k, d), dtype=torch.float32, device=dev)
    n_batches, n_iter, shift, converged = 0, 0, 0.0, True
    for batch in _prefetched(map(lambda b: _stage(b, d, None, False),
                                 batches()), prefetch):
        xb = _prepare_batch(batch, dev)[0]
        reason = _screen_device(xb, None)
        if reason is not None:
            _raise_bad(reason, f"batch {n_batches}")
        # A ragged batch's independent fit runs on one rank: padding would
        # bias it (the reference's equal-size split divided evenly).
        bmesh = mesh if xb.shape[0] % bmesh_size == 0 else None
        res = kmeans_fit(xb, k, init=c0, max_iters=max_iters, tol=tol,
                         spherical=spherical, mesh=bmesh, kernel=kernel,
                         device=dev)
        total = total + res.centroids
        n_batches += 1
        n_iter = max(n_iter, int(res.n_iter))
        shift = max(shift, float(res.shift))
        converged = converged and bool(res.converged)
    if n_batches == 0:
        raise ValueError("empty batch stream")
    c = total / n_batches  # the reference's unweighted np.mean (:310)
    if spherical:
        c = _normalize(c)
    # Score the combined centers exactly, one stats pass over the stream
    # on this rank (no collective, as the JAX version scores its batches
    # single-device).
    local, correct = _lloyd_pass_fns(
        spherical, _LloydRoute(k, d, kernel, "mean_combine_fit"), kernel)
    acc, _ = _Pass(batches, d=d, mesh=None, device=dev, prefetch=prefetch,
                   weighted=False,
                   strategy=reduce_lib.resolve_reduce("per_batch"),
                   shapes=_lloyd_shapes(k, d), local=local,
                   correct=correct).run(c)
    return KMeansResult(
        centroids=c, n_iter=n_iter, sse=acc.sse,
        shift=torch.tensor(shift, dtype=torch.float32, device=dev),
        converged=converged)


# ---------------------------------------------------------------------------
# Fuzzy C-Means
# ---------------------------------------------------------------------------


def _fuzzy_shapes(k: int, d: int) -> FuzzyStats:
    return FuzzyStats(weighted_sums=(k, d), weights=(k,), objective=())


def _corrected_fuzzy(s: FuzzyStats, n_pad, c, m: float, kernel: str,
                     dtype) -> FuzzyStats:
    """`s` less n_pad zero rows: a zero row's memberships depend only on
    ‖c‖² (scored against the centroids rounded to the batch dtype on the
    kernel route, as B6 widens bf16 rows); it adds to the weights and the
    objective, nothing to Σμx."""
    cd = c.to(dtype).float() if kernel == "pallas" else c
    zs = fuzzy_stats(torch.zeros((1, c.shape[1]), dtype=torch.float32,
                                 device=c.device), cd, m=m)
    n_pad = float(n_pad)
    return FuzzyStats(weighted_sums=s.weighted_sums,
                      weights=s.weights - n_pad * zs.weights,
                      objective=s.objective - n_pad * zs.objective)


class _FuzzyRoute:
    """The per-batch fuzzy stats of one fit's kernel (B6 on 'pallas',
    picked once: one `kernel_selected` event)."""

    def __init__(self, k: int, d: int, m: float, kernel: str, label: str):
        self.k, self.d, self.m, self.kernel, self.label = (k, d, m, kernel,
                                                           label)
        self.fn = None
        self.block_rows = None

    def __call__(self, xb, c, wb=None) -> FuzzyStats:
        if self.kernel == "pallas" and wb is None:
            if self.fn is None:
                from tdc_tpu_torch.ops.fuzzy_kernels import fuzzy_stats_for

                self.fn = fuzzy_stats_for(self.k, self.d, label=self.label)
            return self.fn(xb, c, self.m)
        if self.block_rows is None:
            self.block_rows = auto_block_rows(xb.shape[0], self.k,
                                              device=xb.device)
        if wb is not None:
            if self.block_rows:
                return fuzzy_stats_weighted_blocked(xb, c, wb, self.m,
                                                    self.block_rows)
            return fuzzy_stats_weighted(xb, c, wb, m=self.m)
        if self.block_rows:
            return fuzzy_stats_padded_blocked(xb, c, self.m, self.block_rows)
        return fuzzy_stats(xb, c, m=self.m)


def _fuzzy_pass_fns(route: _FuzzyRoute, m: float, kernel: str):
    """(local, correct) of a Fuzzy C-Means pass (`_Pass`): one batch's
    fuzzy stats on `route` (weighted ones in f32 plain ops, the JAX
    package's mass exactness rule; zero-weight pad rows add nothing), and
    the subtraction of n_pad zero rows (`_corrected_fuzzy`)."""
    return (lambda xb, wb, c: route(xb, c, wb),
            lambda s, n_pad, c, dtype: _corrected_fuzzy(s, n_pad, c, m,
                                                        kernel, dtype))


def streamed_fuzzy_fit(
    batches: Callable[[], Iterable],
    k: int,
    d: int,
    *,
    m: float = 2.0,
    init,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    mesh=None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 5,
    ckpt_every_batches: int | None = None,
    ckpt_keep_last_n: int | None = None,
    prefetch: int = 0,
    sample_weight_batches: Callable[[], Iterable] | None = None,
    kernel: str = "xla",
    reduce="per_batch",
    residency: str = "stream",
    ingest=None,
    device=None,
) -> FuzzyCMeansResult:
    """Exact streamed Fuzzy C-Means: the contract of streamed_kmeans_fit
    (checkpoints, mid-pass resume, residency, the ingest guard and the
    preemption drain included) with
    the per-iteration [objective, shift] history; kernel='pallas' runs B6
    per batch and refuses sample weights (the weighted stats run in f32
    plain ops for mass exactness)."""
    if m <= 1.0:
        raise ValueError(f"fuzzifier m must be > 1, got {m}")
    weighted = sample_weight_batches is not None
    strategy = reduce_lib.resolve_reduce(reduce)
    _refuse_unported("streamed_fuzzy_fit", residency=residency)
    dev = resolve_device(device)
    if kernel.startswith("auto"):
        from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

        kernel = resolve_kernel(
            kernel, k=k, d=d, device=dev, model="fuzzy",
            label="streamed_fuzzy_fit",
            ineligible=("the weighted fuzzy stats run in f32 plain ops for "
                        "mass exactness" if weighted else None))
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    if weighted and kernel == "pallas":
        raise ValueError(
            "kernel='pallas' does not support sample_weight_batches (the "
            "weighted stats run in f32 XLA for mass exactness); drop the "
            "explicit kernel")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    label = "streamed_fuzzy_fit"
    stream = _weighted_stream(batches, sample_weight_batches)
    guard = ingest_lib.guard_stream(stream, ingest, d=d, weighted=weighted,
                                    label=label)
    c, first_rows = _resolve_stream_init(stream, k, d, init, generator,
                                         mesh, weighted, dev, guard=guard)
    _check_equal_local_rows(first_rows, mesh, dev)
    ckpt = _StreamCheckpointer(
        ckpt_dir, k, d, params={"m": float(m), "weighted": weighted},
        acc_map={"acc_wsums": "weighted_sums", "acc_weights": "weights",
                 "acc_obj": "objective"},
        mesh=mesh, keep=ckpt_keep_last_n, device=dev, guard=guard)
    state = ckpt.restore(FuzzyStats)
    _reduce_plan(strategy, mesh, ckpt_dir, ckpt_every_batches,
                 cursor=state.cursor)
    plan, builder = _plan_1d_residency(
        residency, batches, k, d, mesh, weighted=weighted, kernel=kernel,
        cursor=state.cursor, label=label,
        mid_pass_ckpt=ckpt_every_batches is not None, device=dev)
    run_stream, h2d = _spilled(plan, guard, d, mesh, weighted, dev)
    local, correct = _fuzzy_pass_fns(
        _FuzzyRoute(k, d, float(m), kernel, label), float(m), kernel)
    machine = _Pass(run_stream, d=d, mesh=mesh, device=dev,
                    prefetch=prefetch if h2d is None else 0,
                    weighted=weighted, strategy=strategy,
                    shapes=_fuzzy_shapes(k, d), local=local,
                    correct=correct, guard=guard)

    try:
        c, n_iter, shift, history, start_iter, cache = _fit_loop(
            machine, ckpt, state, c,
            lambda acc, c: acc.weighted_sums / torch.clamp_min(
                acc.weights[:, None], 1e-12),
            max_iters=max_iters, tol=tol, ckpt_every=ckpt_every,
            ckpt_every_batches=ckpt_every_batches,
            mass=(lambda acc: acc.weights) if weighted else None,
            cost=lambda acc: acc.objective,
            plan=plan, builder=builder, label=label)
        objective = _final_stats(machine, cache, c, ckpt.gang).objective
    finally:
        spill_lib.release(run_stream)
    return FuzzyCMeansResult(
        centroids=c, n_iter=n_iter, objective=objective,
        shift=torch.tensor(shift, dtype=torch.float32, device=dev),
        converged=bool(tol >= 0 and shift <= tol),
        history=_history_array(history), n_iter_run=n_iter - start_iter,
        comms=machine.report(),
        h2d=None if h2d is None else h2d.report(plan.spill_slots),
        ingest=guard.report())
