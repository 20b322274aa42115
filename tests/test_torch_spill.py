"""The port's spill tier (`tdc_tpu_torch/data/spill.py` and
residency='spill' in the streamed fits) against the JAX package's
(tests/test_spill.py), on the CPU, where the ring runs its threads
without CUDA streams.

- Ring machinery: the ranged protocol; delivery in stream order when the
  stages finish out of order (forced with events, never timed); errors
  surface in order; an early close joins the workers; the report's
  overlap bound; release and reuse.
- Fits: residency='spill' (and 'auto' where only the ring fits) gives the
  bits of residency='stream' for K-Means and fuzzy, ranged and serial,
  weighted, spherical, on a bf16 stream, and with mid-pass checkpoints (a
  resume mid-pass streams that run, bit for bit); against the JAX
  package's own 'spill' fits within the streamed fits' f32 tolerances.
  The per-fit H2D report and the process-wide tally are filled in; the
  ring hands staged batches across pass boundaries.
"""

import json
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from tdc_tpu_torch.data import device_cache as tdc
from tdc_tpu_torch.data import spill as tsp
from tdc_tpu_torch.data.loader import NpzStream
from tdc_tpu_torch.models import streaming as tst

K, D = 8, 8


def _data(n=1003, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8, size=(8, d)).astype(np.float32)
    return (centers[rng.integers(0, 8, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _sized(x, rows, ranged=False):
    def gen():
        for i in range(0, x.shape[0], rows):
            yield x[i:i + rows]

    read = (lambda i: x[i * rows:(i + 1) * rows]) if ranged else None
    return tdc.SizedBatches(gen, x.shape[0], rows, read_batch=read)


def _events(path):
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


@pytest.fixture
def runlog(tmp_path, monkeypatch):
    path = tmp_path / "runlog.jsonl"
    monkeypatch.setenv("TDC_RUNLOG", str(path))
    return path


def _tensor_stage(b, put):
    return tsp.StagedBatch(put(b, b.shape[0]), b.shape[0], b.shape[0])


# ---------------------------------------------------------------------------
# Ring machinery
# ---------------------------------------------------------------------------


def test_ranged_reader_protocol():
    x = _data(512, 4)
    assert tsp.ranged_reader(NpzStream(x, 128)) is not None
    assert tsp.ranged_reader(_sized(x, 128, ranged=True)) is not None
    assert tsp.ranged_reader(_sized(x, 128)) is None
    assert tsp.ranged_reader(lambda: iter([x])) is None
    s = NpzStream(_data(1003, 4), 256)
    for i, b in enumerate(s()):
        np.testing.assert_array_equal(b, s.read_batch(i))


@pytest.mark.parametrize("slots", [2, 4])
def test_out_of_order_stages_are_delivered_in_order(slots):
    """Each window's first stage waits until its last has finished, so
    the stages complete out of order (events, not timing); the consumer
    still sees the stream's order. Only this pass's stages are counted:
    the read log is taken when the last batch is delivered, before the
    ring stages the next pass's first batches."""
    x = _data(2048, 4)
    rows = 128
    n = x.shape[0] // rows
    done = [threading.Event() for _ in range(n)]
    order = []
    lock = threading.Lock()

    def read(i):
        last = min((i // slots) * slots + slots, n) - 1
        if i % slots == 0 and i != last:
            assert done[last].wait(timeout=30)
        with lock:
            order.append(i)
        done[i].set()
        return x[i * rows:(i + 1) * rows]

    counter = tsp.H2DCounter()
    ring = tsp.SpillRing(tdc.SizedBatches(None, 2048, rows,
                                          read_batch=read),
                         _tensor_stage, slots=slots, counter=counter)
    got = []
    for sb in ring():
        got.append(sb.xb.numpy().copy())
        if len(got) == n:
            in_pass = list(order)
    tsp.release(ring)
    np.testing.assert_array_equal(np.concatenate(got), x)
    assert sorted(in_pass) == list(range(n))
    assert in_pass != list(range(n))  # they did finish out of order
    assert counter.cross_pass == slots


def test_staging_errors_surface_in_order():
    x = _data(512, 4)

    def read(i):
        if i == 2:
            raise RuntimeError("cold store died")
        return x[i * 128:(i + 1) * 128]

    ring = tsp.SpillRing(
        tdc.SizedBatches(lambda: (read(i) for i in range(4)), 512, 128,
                         read_batch=read), _tensor_stage)
    it = ring()
    assert next(it).xb.shape == (128, 4)
    assert next(it).xb.shape == (128, 4)
    with pytest.raises(RuntimeError, match="cold store died"):
        next(it)

    def gen():
        yield x[:128]
        raise RuntimeError("io died mid-pass")

    it = tsp.SpillRing(_sized_gen(gen), _tensor_stage)()
    next(it)
    with pytest.raises(RuntimeError, match="io died mid-pass"):
        next(it)


def _sized_gen(gen):
    return tdc.SizedBatches(gen, 512, 128)


def _ring_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("tdc-spill", "tdc-prefetch"))
            and t.is_alive()]


def _threads_die(baseline, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(_ring_threads()) <= baseline:
            return
        time.sleep(0.02)
    raise AssertionError(f"ring threads still alive: {_ring_threads()}")


@pytest.mark.parametrize("ranged", [True, False])
def test_close_mid_fill_joins_the_workers(ranged):
    x = _data(4096, 4)
    baseline = len(_ring_threads())

    def slow_read(i):
        time.sleep(0.01)
        return x[i * 128:(i + 1) * 128]

    stream = tdc.SizedBatches(lambda: (slow_read(i) for i in range(32)),
                              4096, 128,
                              read_batch=slow_read if ranged else None)
    it = tsp.SpillRing(stream, _tensor_stage)()
    next(it)
    it.close()
    _threads_die(baseline)


def test_report_overlap_lower_bound_clamped():
    r = tsp.SpillReport(slots=2, batches=4, h2d_bytes=1, copy_s=1.0,
                        stall_s=0.25, depth_max=1)
    assert r.overlap_lower_bound == 0.75
    assert r._replace(stall_s=5.0).overlap_lower_bound == 0.0
    assert r._replace(copy_s=0.0).overlap_lower_bound == 0.0


def test_release_tears_down_and_the_ring_stays_usable():
    x = _data(400, 4, seed=13)
    ring = tsp.SpillRing(_sized(x, 100, ranged=True),
                         lambda b, put: put(b, b.shape[0]))
    out1 = [b.clone() for b in ring()]
    assert ring._pending  # the next pass's first stages
    out2 = [b.clone() for b in ring()]
    np.testing.assert_array_equal(torch.cat(out1).numpy(), x)
    np.testing.assert_array_equal(torch.cat(out2).numpy(), x)
    tsp.release(ring)
    assert ring._ex is None and ring._pending is None
    out3 = [b.clone() for b in ring()]
    np.testing.assert_array_equal(torch.cat(out3).numpy(), x)
    tsp.release(ring)

    class Foreign:
        closed = False

        def close(self):
            self.closed = True

    s = Foreign()
    tsp.release(s)
    assert not s.closed


def test_device_rows_pads_with_zero_rows():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    out = tsp.device_rows(a, 5, "cpu")
    np.testing.assert_array_equal(out.numpy()[:3], a)
    assert out.shape == (5, 2) and not out[3:].any()
    assert tsp.device_rows(a, 3, "cpu").shape == (3, 2)


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

X = _data()


def _kmeans(residency, rows=200, ranged=True, x=None, **kw):
    kw.setdefault("max_iters", 4)
    kw.setdefault("tol", -1.0)
    x = X if x is None else x
    return tst.streamed_kmeans_fit(_sized(x, rows, ranged=ranged), K, D,
                                   init=X[:K], residency=residency,
                                   device="cpu", **kw)


def _same(a, b, cost="sse"):
    assert torch.equal(a.centroids, b.centroids)
    assert float(getattr(a, cost)) == float(getattr(b, cost))
    np.testing.assert_array_equal(a.history, b.history)
    assert (a.n_iter, a.converged) == (b.n_iter, b.converged)


@pytest.mark.parametrize("ranged", [True, False])
@pytest.mark.parametrize("kw", [
    dict(), dict(spherical=True), dict(tol=1e-6, max_iters=20),
    dict(kernel="pallas")], ids=["plain", "spherical", "converging",
                                 "pallas"])
def test_spill_kmeans_equals_the_streamed_fit(ranged, kw):
    _same(_kmeans("spill", ranged=ranged, **kw),
          _kmeans("stream", ranged=ranged, **kw))


def test_spill_bf16_stream_equals_the_streamed_fit():
    v2 = X.astype(ml_dtypes.bfloat16).view(np.dtype("V2"))
    kw = dict(max_iters=4, tol=-1.0, kernel="pallas", device="cpu",
              init=X[:K])
    a = tst.streamed_kmeans_fit(NpzStream(v2, 200), K, D, residency="spill",
                                **kw)
    b = tst.streamed_kmeans_fit(NpzStream(v2, 200), K, D, **kw)
    _same(a, b)


@pytest.mark.parametrize("ranged", [True, False])
def test_spill_fuzzy_equals_the_streamed_fit(ranged):
    def fit(residency):
        return tst.streamed_fuzzy_fit(_sized(X, 200, ranged=ranged), K, D,
                                      init=X[:K], max_iters=3,
                                      residency=residency, device="cpu")

    base, res = fit("stream"), fit("spill")
    _same(res, base, "objective")
    assert 4 * 6 <= res.h2d.batches <= 4 * 6 + res.h2d.slots


@pytest.mark.parametrize("fuzzy", [False, True])
def test_spill_weighted_equals_the_streamed_fit(fuzzy):
    w = np.abs(_data(1003, 1, seed=3)).ravel() + 0.1
    fit = tst.streamed_fuzzy_fit if fuzzy else tst.streamed_kmeans_fit

    def run(residency):
        return fit(_sized(X, 200, ranged=True), K, D, init=X[:K],
                   max_iters=3, tol=-1.0, sample_weight_batches=_sized(w, 200),
                   residency=residency, device="cpu")

    base, res = run("stream"), run("spill")
    _same(res, base, "objective" if fuzzy else "sse")
    # Weighted streams zip (x, w): the ring runs its serial producer.
    assert res.h2d.cross_pass == 0
    assert res.h2d.batches == 4 * 6


def test_h2d_report_is_filled_in():
    res = _kmeans("spill")
    h = res.h2d
    # 4 iterations and the reporting pass, 6 batches each; the ring also
    # stages up to `slots` batches of a next pass after each pass (those
    # the next pass takes are among its 6; release cancels the last ones,
    # some of which may have been staged already).
    assert 5 * 6 <= h.batches <= 5 * 6 + h.slots
    assert h.cross_pass == 5 * min(h.slots, 6)
    assert h.h2d_bytes >= 5 * X.nbytes and h.copy_s > 0.0
    assert h.slots == tsp.DEFAULT_SPILL_SLOTS and h.depth_max >= 0
    assert 0.0 <= h.overlap_lower_bound <= 1.0
    assert _kmeans("stream").h2d is None


def test_global_counter_mirrors_the_fits():
    before = tsp.GLOBAL_H2D.snapshot()
    x = _data(600, D, seed=5)
    _kmeans("spill", x=x, max_iters=2)
    after = tsp.GLOBAL_H2D.snapshot()
    delta = after["h2d_bytes"] - before["h2d_bytes"]
    assert x.nbytes * 3 <= delta <= x.nbytes * 3 + 2 * 200 * D * 4
    assert 9 <= after["batches"] - before["batches"] <= 11
    assert after["cross_pass"] - before["cross_pass"] == 3 * 2


def test_auto_picks_spill_where_only_the_ring_fits(runlog, monkeypatch):
    probe = tdc.plan_residency("spill", hints=tdc.stream_hints(_sized(X, 200)),
                               d=D, k=K, device="cpu")
    monkeypatch.setattr(tdc, "planner_budget_bytes",
                        lambda device=None: probe.reserve_bytes
                        + probe.spill_bytes + 1)
    res = _kmeans("auto")
    _same(res, _kmeans("stream"))
    assert res.h2d is not None and res.h2d.batches > 0
    ev = [e for e in _events(runlog) if e["event"] == "residency_spill"
          and e["reason"] == "cache_over_budget"]
    assert ev and ev[0]["label"] == "streamed_kmeans_fit"


def test_spill_mid_pass_checkpoints_resume_bit_for_bit(tmp_path, runlog):
    """Spill keeps the batch boundaries: ckpt_every_batches saves
    mid-pass; a crash in pass 3 and a resume (which streams that run: a
    mid-pass cursor) end equal to the uninterrupted fit."""
    ck = str(tmp_path / "ck")
    reads = [0]
    lock = threading.Lock()

    def read(i):
        # Two passes of 6 reads, each followed by 2 of the next pass's
        # first batches: read 16 is in pass 3, after its first 3 batches.
        with lock:
            reads[0] += 1
            if reads[0] > 6 * 2 + 3:
                raise RuntimeError("injected crash")
        return X[i * 200:(i + 1) * 200]

    def gen():
        return (X[i:i + 200] for i in range(0, 1003, 200))

    crashing = tdc.SizedBatches(gen, 1003, 200, read_batch=read)
    kw = dict(init=X[:K], max_iters=4, tol=-1.0, device="cpu",
              ckpt_dir=ck, ckpt_every_batches=2)
    with pytest.raises(RuntimeError, match="injected crash"):
        tst.streamed_kmeans_fit(crashing, K, D, residency="spill", **kw)
    from tdc_tpu_torch.utils import checkpoint as tck

    saved = tck.restore_checkpoint(ck)
    assert saved.batch_cursor > 0  # a mid-pass save
    resumed = tst.streamed_kmeans_fit(_sized(X, 200, ranged=True), K, D,
                                      residency="spill", **kw)
    assert resumed.h2d is None  # the cursor streams this run
    ev = [e for e in _events(runlog) if e["event"] == "residency_fallback"]
    assert [e["reason"] for e in ev] == ["mid_pass_resume"]
    _same(resumed, _kmeans("stream"))


def test_spill_fits_against_jax():
    """The port's residency='spill' fits against the JAX package's own,
    within the streamed fits' f32 tolerances."""
    from tdc_tpu.data.device_cache import SizedBatches as JSized
    from tdc_tpu.models import streaming as jst

    def jsized(x, rows):
        return JSized(lambda: (x[i:i + rows] for i in
                               range(0, x.shape[0], rows)),
                      x.shape[0], rows,
                      read_batch=lambda i: x[i * rows:(i + 1) * rows])

    for fuzzy in (False, True):
        jfit = jst.streamed_fuzzy_fit if fuzzy else jst.streamed_kmeans_fit
        tfit = tst.streamed_fuzzy_fit if fuzzy else tst.streamed_kmeans_fit
        want = jfit(jsized(X, 200), K, D, init=X[:K], max_iters=6,
                    tol=1e-6, residency="spill")
        got = tfit(_sized(X, 200, ranged=True), K, D, init=X[:K],
                   max_iters=6, tol=1e-6, residency="spill", device="cpu")
        cost = "objective" if fuzzy else "sse"
        assert (got.n_iter, got.converged) == (int(want.n_iter),
                                               bool(want.converged))
        np.testing.assert_allclose(got.centroids.numpy(),
                                   np.asarray(want.centroids), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(getattr(got, cost)),
                                   float(getattr(want, cost)), rtol=1e-5)
        assert got.h2d.cross_pass == want.h2d.cross_pass


def test_cross_pass_handoff_is_loud(runlog):
    x = _data(900, 6, seed=11)
    kw = dict(init=x[:5], max_iters=4, tol=-1.0, device="cpu")
    plain = tst.streamed_kmeans_fit(_sized(x, 300, ranged=True), 5, 6, **kw)
    res = tst.streamed_kmeans_fit(_sized(x, 300, ranged=True), 5, 6,
                                  residency="spill", **kw)
    _same(res, plain)
    assert res.h2d.cross_pass > 0
    ev = [e for e in _events(runlog) if e["event"] == "spill_cross_pass"]
    assert len(ev) == 5 and ev[0]["batches"] == 2
    serial = tst.streamed_kmeans_fit(_sized(x, 300), 5, 6,
                                     residency="spill", **kw)
    _same(serial, plain)
    assert serial.h2d.cross_pass == 0


def test_bare_generator_streams_with_the_no_hints_reason(runlog):
    x = _data(600, 4)
    res = tst.streamed_kmeans_fit(lambda: iter([x[:300], x[300:]]), 4, 4,
                                  init=x[:4], max_iters=2, tol=-1.0,
                                  residency="auto", device="cpu")
    assert res.h2d is None
    ev = [e for e in _events(runlog) if e["event"] == "residency_fallback"]
    assert ev and ev[0]["reason"] == "no_size_hints"
    spilled = tst.streamed_kmeans_fit(lambda: iter([x[:300], x[300:]]), 4,
                                      4, init=x[:4], max_iters=2, tol=-1.0,
                                      residency="spill", device="cpu")
    assert spilled.h2d.batches == 6
    assert torch.equal(spilled.centroids, res.centroids)


def test_prefetch_is_superseded_by_the_ring():
    a = _kmeans("spill", prefetch=3)
    b = _kmeans("stream", prefetch=3)
    _same(a, b)
    assert a.h2d.batches >= 5 * 6
