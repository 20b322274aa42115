"""The port's ingest guard (`tdc_tpu_torch/data/ingest.py`, the streamed
fits' `ingest=` policy) and the loader's CRC tier against the JAX
package's, on the CPU: the cases of tests/test_ingest.py and the chaos
gang of tests/test_chaos.py (as gloo groups of the port), less the
K-sharded towers (ROADMAP.md Queue A, A9) and the serve metrics (A11).

The same seeded numpy batches and explicit inits go through both
packages. Verdicts, reports, events and errors are held equal exactly;
fits against the JAX package's at the streamed tolerances (centroids
rtol 1e-5 / atol 1e-5, SSE and J_m rtol 1e-5; the fuzzy centroids
rtol 1e-4 / atol 8e-4, see the test); within the port bitwise
where the contract is bitwise: a clean guarded fit against the
pass-through policy, a transient storm against the clean fit, and a
quarantined batch against the same fit with that batch removed
(K-Means and fuzzy, one rank and 2 and 4 gloo ranks in every reduce
mode). The gang against one rank's oracle: 1e-4 (the JAX chaos test's
tolerance; the ranks' f32 sums come in another order).
"""

import json
import multiprocessing as mp
import os
import queue as queue_lib
import time
import traceback

import numpy as np
import pytest
import torch

from tdc_tpu_torch.data import ingest as ting
from tdc_tpu_torch.data.device_cache import SizedBatches
from tdc_tpu_torch.data.ingest import (
    PASSTHROUGH_POLICY,
    CorruptBatch,
    IngestAbort,
    IngestPolicy,
    IngestReadError,
    Quarantined,
)
from tdc_tpu_torch.data.loader import (
    NpzStream,
    crc_sidecar_path,
    write_crc_sidecar,
)
from tdc_tpu_torch.models.streaming import (
    streamed_fuzzy_fit,
    streamed_kmeans_fit,
)
from tdc_tpu_torch.testing import faults as tfaults
from tdc_tpu_torch.testing.flaky_http import FlakyHTTPServer

RTOL = 1e-5


def _data(n=1003, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8, size=(8, d)).astype(np.float32)
    x = centers[rng.integers(0, 8, n)] + rng.normal(size=(n, d)).astype(
        np.float32)
    return x.astype(np.float32)


X = _data(1003, 8)


def _events(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture
def runlog(tmp_path, monkeypatch):
    path = tmp_path / "runlog.jsonl"
    monkeypatch.setenv("TDC_RUNLOG", str(path))
    return path


@pytest.fixture
def inject(monkeypatch):
    """Set a $TDC_FAULTS spec with clean hit counters in both packages."""
    from tdc_tpu.testing import faults as jfaults

    def _set(spec):
        monkeypatch.setenv("TDC_FAULTS", spec)
        tfaults.reset()
        jfaults.reset()

    yield _set
    monkeypatch.delenv("TDC_FAULTS", raising=False)
    tfaults.reset()
    jfaults.reset()


def _transient_spec(start=2, stop=40, step=3):
    """~1/3 of guarded read attempts fail transiently."""
    return ",".join(f"data.read.transient=raise:ConnectionError@{n}"
                    for n in range(start, stop, step))


def _kfit(stream, k=8, d=8, **kw):
    kw.setdefault("max_iters", 3)
    kw.setdefault("tol", -1.0)
    kw.setdefault("init", X[:k])
    return streamed_kmeans_fit(stream, k, d, device="cpu", **kw)


def _jkfit(stream, k=8, d=8, **kw):
    from tdc_tpu.models.streaming import streamed_kmeans_fit as jfit

    kw.setdefault("max_iters", 3)
    kw.setdefault("tol", -1.0)
    kw.setdefault("init", X[:k])
    return jfit(stream, k, d, **kw)


def _jpolicy(p):
    from tdc_tpu.data.ingest import IngestPolicy as JPolicy

    return JPolicy(**p._asdict())


def _jnpz(x, rows, **kw):
    from tdc_tpu.data.loader import NpzStream as JNpz

    return JNpz(x, rows, **kw)


def _assert_fits(got, want, cost="sse"):
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(float(getattr(got, cost)),
                               float(getattr(want, cost)), rtol=RTOL)


def _same(a, b, cost="sse"):
    assert torch.equal(a.centroids, b.centroids)
    assert float(getattr(a, cost)) == float(getattr(b, cost))


def _poisoned(rows=200, bad=slice(400, 600), val=np.nan, x=X):
    xp = x.copy()
    xp[bad] = val
    return xp


def _without(x, rows, *drop):
    def gen():
        for i in range(-(-x.shape[0] // rows)):
            if i not in drop:
                yield x[i * rows:(i + 1) * rows]

    return lambda: gen()


# ---------------------------------------------------------------------------
# Classification, backoff, the screen, the policy
# ---------------------------------------------------------------------------


def _errors():
    import http.client

    from tdc_tpu_torch.data.store import StoreHTTPError, StoreShortBlob

    odd = RuntimeError("boom")
    odd.status = 503
    odd2 = RuntimeError("boom")
    odd2.status = "503"
    out = [ConnectionError("x"), TimeoutError("x"), OSError(5, "EIO"),
           InterruptedError("x"), BlockingIOError("x"),
           FileNotFoundError("x"), PermissionError("x"),
           IsADirectoryError("x"), ValueError("x"), TypeError("x"),
           RuntimeError("x"), CorruptBatch("x", batch=0, reason="crc"),
           http.client.IncompleteRead(b"xx"), http.client.BadStatusLine(""),
           http.client.RemoteDisconnected("gone"), StoreShortBlob("short"),
           odd, odd2]
    out += [StoreHTTPError(f"HTTP {s}", status=s)
            for s in (500, 502, 503, 504, 599, 408, 429, 400, 401, 403,
                      404, 410)]
    return out


def test_classification_matches_jax():
    from tdc_tpu.data import ingest as jing
    from tdc_tpu.data import store as jstore

    for e in _errors():
        want = jing.classify_error(e)
        if isinstance(e, CorruptBatch):
            want = jing.classify_error(jing.CorruptBatch(
                "x", batch=0, reason="crc"))
        if type(e).__name__ == "StoreHTTPError":
            want = jing.classify_error(jstore.StoreHTTPError(
                str(e), status=e.status))
        assert ting.classify_error(e) == want, e


def test_backoff_is_the_jax_ladder():
    from tdc_tpu.data import ingest as jing

    for base, attempt, label, batch in ((0.1, 1, "fit", 3),
                                        (0.1, 3, "fit", 3),
                                        (100.0, 10, "fit", 0),
                                        (0.05, 2, "streamed_kmeans_fit", 7)):
        assert ting.backoff_delay(base, attempt, label, batch) == \
            jing.backoff_delay(base, attempt, label, batch)
    d1 = ting.backoff_delay(0.1, 1, "fit", 3)
    assert 0.05 <= d1 < 0.1 and ting.backoff_delay(100.0, 10, "f", 0) == 5.0


def test_screen_and_policy_resolution():
    from tdc_tpu.data import ingest as jing

    x = _data(64, 4)
    bad = x.copy()
    bad[3, 2] = np.nan
    w = np.ones(64, np.float32)
    wb = w.copy()
    wb[5] = np.nan
    for args in ((x, 4, None), (bad, 4, None), (x, 5, None),
                 (x.ravel(), 4, None), (x, 4, w), (x, 4, wb)):
        assert ting.screen_batch(args[0], d=args[1], w=args[2]) == \
            jing.screen_batch(args[0], d=args[1], w=args[2])
    assert ting.screen_batch(torch.from_numpy(bad), d=4) == "nonfinite"
    assert ting.resolve_policy(None) == ting.DEFAULT_POLICY
    assert tuple(ting.DEFAULT_POLICY) == tuple(jing.DEFAULT_POLICY)
    assert tuple(ting.PASSTHROUGH_POLICY) == tuple(jing.PASSTHROUGH_POLICY)
    assert tuple(ting.resolve_policy({"io_retries": 7})) == tuple(
        jing.resolve_policy({"io_retries": 7}))
    with pytest.raises(TypeError):
        ting.resolve_policy(3)
    assert ting.IngestReport._fields == jing.IngestReport._fields
    assert ting.IngestPolicy._fields == jing.IngestPolicy._fields


def test_retry_after_floors_the_backoff(runlog):
    from tdc_tpu_torch.data.store import StoreHTTPError

    x = _data(400, 4, seed=9)
    tripped = []

    def read(i):
        if i == 1 and not tripped:
            tripped.append(i)
            raise StoreHTTPError("HTTP 429", status=429, retry_after=0.2)
        return x[i * 100:(i + 1) * 100]

    def gen():
        for i in range(4):
            yield x[i * 100:(i + 1) * 100]

    base = _kfit(NpzStream(x, 100), 4, 4, init=x[:4], max_iters=2)
    res = _kfit(SizedBatches(gen, 400, 100, read_batch=read), 4, 4,
                init=x[:4], max_iters=2,
                ingest=IngestPolicy(io_retries=2, io_backoff=1e-3))
    assert res.ingest.retries == 1
    _same(base, res)
    ev = [e for e in _events(runlog) if e["event"] == "ingest_retry"]
    assert ev and ev[0]["delay_s"] >= 0.2


# ---------------------------------------------------------------------------
# Retries and failures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("residency", ["stream", "spill"])
def test_transient_retries_are_transparent(inject, runlog, residency):
    base = _kfit(NpzStream(X, 200))
    policy = IngestPolicy(io_retries=3, io_backoff=1e-3)
    inject(_transient_spec())
    res = _kfit(NpzStream(X, 200), ingest=policy, residency=residency)
    inject(_transient_spec())
    want = _jkfit(_jnpz(X, 200), ingest=_jpolicy(policy))
    assert res.ingest.retries > 0
    _same(base, res)
    _assert_fits(res, want)
    ev = [e for e in _events(runlog) if e["event"] == "ingest_retry"]
    assert ev and ev[0]["kind"] == "transient"
    assert ev[0]["store"] == "NpzStream" and "batch" in ev[0]


@pytest.mark.parametrize("spec, policy, exc, attempts", [
    ("data.read.transient=raise:ConnectionError@3+",
     IngestPolicy(io_retries=2, io_backoff=1e-3), IngestReadError, 3),
    ("data.read.permanent=raise:ValueError@3",
     IngestPolicy(io_retries=5, io_backoff=1e-3), ValueError, 1),
], ids=["exhausted", "permanent"])
def test_abandoned_reads_fail_loudly_as_in_jax(inject, runlog, spec, policy,
                                               exc, attempts):
    """One ingest_failed event, then IngestReadError (exhausted) or the
    original type (permanent), with the JAX package's words; the port's
    explicit init reads the first batch once more (one more hit), so the
    JAX spec is shifted by one to fail at the same batch."""
    inject(spec)
    with pytest.raises(exc) as got:
        _kfit(NpzStream(X, 200), ingest=policy)
    ev = [e for e in _events(runlog) if e["event"] == "ingest_failed"]
    assert len(ev) == 1 and ev[0]["attempts"] == attempts
    assert ev[0]["store"] == "NpzStream"
    point, rest = spec.split("@")
    n = int(rest.rstrip("+"))
    inject(f"{point}@{n - 1}{'+' if rest.endswith('+') else ''}")
    with pytest.raises(Exception) as want:
        _jkfit(_jnpz(X, 200), ingest=_jpolicy(policy))
    assert type(want.value).__name__ == exc.__name__
    assert str(got.value) == str(want.value)
    if exc is ValueError:
        assert not [e for e in _events(runlog)
                    if e["event"] == "ingest_retry"]


def test_deadline_bounds_the_retry_ladder(inject, runlog):
    inject("data.read.transient=raise:ConnectionError@1+")
    with pytest.raises(IngestReadError):
        _kfit(NpzStream(X, 200), ingest=IngestPolicy(
            io_retries=100, io_backoff=0.2, io_deadline=0.3))
    ev = [e for e in _events(runlog) if e["event"] == "ingest_failed"]
    assert ev and ev[0]["attempts"] < 100


def test_spill_worker_failure_is_classified_not_raw(inject, runlog):
    inject("data.read.permanent=raise:ValueError@6")
    with pytest.raises(ValueError, match="injected fault"):
        _kfit(NpzStream(X, 200), residency="spill",
              ingest=IngestPolicy(io_retries=2, io_backoff=1e-3))
    ev = [e for e in _events(runlog) if e["event"] == "ingest_failed"]
    assert len(ev) == 1 and ev[0]["kind"] == "permanent"


def test_sequential_stream_failure_is_loud_no_retry(runlog):
    def gen():
        yield X[:200]
        yield X[200:400]
        raise ConnectionError("cold store died")

    with pytest.raises(IngestReadError, match="batch 2"):
        _kfit(lambda: gen(), ingest=IngestPolicy(io_retries=5))
    ev = [e for e in _events(runlog) if e["event"] == "ingest_failed"]
    assert len(ev) == 1 and ev[0]["attempts"] == 1


# ---------------------------------------------------------------------------
# Quarantine: equal to the batch removed
# ---------------------------------------------------------------------------


HALF = IngestPolicy(max_bad_fraction=0.5)


def test_quarantined_equals_removed_bitwise_kmeans(runlog):
    res = _kfit(NpzStream(_poisoned(), 200), max_iters=4, ingest=HALF)
    oracle = _kfit(_without(X, 200, 2), max_iters=4)
    _same(res, oracle)
    want = _jkfit(_jnpz(_poisoned(), 200), max_iters=4,
                  ingest=_jpolicy(HALF))
    _assert_fits(res, want)
    assert res.ingest == want.ingest
    assert res.ingest.quarantined_rows == 200
    assert res.ingest.rows_per_pass == 1003
    assert res.ingest.dropped_fraction == pytest.approx(200 / 1003)
    ev = [e for e in _events(runlog) if e["event"] == "ingest_quarantine"]
    assert ev and ev[0]["reason"] == "nonfinite" and ev[0]["batch"] == 2


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_quarantined_equals_removed_bitwise_fuzzy(kernel):
    kw = dict(init=X[:8], max_iters=3, tol=-1.0, kernel=kernel,
              device="cpu")
    res = streamed_fuzzy_fit(NpzStream(_poisoned(val=np.inf), 200), 8, 8,
                             ingest=HALF, **kw)
    oracle = streamed_fuzzy_fit(_without(X, 200, 2), 8, 8, **kw)
    _same(res, oracle, "objective")
    # The JAX fit with the batch removed: its quarantine subtracts the
    # zero rows' memberships, exact only to the f32 rounding.
    from tdc_tpu.models.streaming import streamed_fuzzy_fit as jfit

    want = jfit(_without(X, 200, 2), 8, 8, init=X[:8], max_iters=3,
                tol=-1.0)
    # Fuzzy on these blobs (several seeds share one): each iteration
    # carries the memberships' f32 rounding further (1.7e-4 after three
    # on the clean stream too), so the centroids are held at 1e-4 of
    # their scale of 8 and J_m at rtol 1e-5.
    assert int(res.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(res.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-4,
                               atol=8e-4)
    np.testing.assert_allclose(float(res.objective), float(want.objective),
                               rtol=RTOL)
    assert res.ingest.quarantined_batches == 1


def test_weighted_quarantine_and_nonfinite_weights():
    w = (np.abs(_data(1003, 1, seed=3)).ravel() + 0.1).astype(np.float32)
    res = _kfit(NpzStream(_poisoned(), 200),
                sample_weight_batches=NpzStream(w, 200), ingest=HALF)
    assert res.ingest.quarantined_batches == 1
    oracle = _kfit(_without(X, 200, 2),
                   sample_weight_batches=_without(w, 200, 2))
    _same(res, oracle)
    wbad = w.copy()
    wbad[450] = np.nan
    res2 = _kfit(NpzStream(X, 200), sample_weight_batches=NpzStream(wbad,
                                                                    200),
                 ingest=HALF)
    assert res2.ingest.quarantined_batches == 1
    _same(res2, oracle)


def test_bad_shape_batch_quarantined_with_expected_geometry(runlog):
    def read(i):
        b = X[i * 200:(i + 1) * 200]
        return b[:, :5] if i == 2 else b

    stream = SizedBatches(lambda: (read(i) for i in range(5)), 1000, 200,
                          read_batch=read)
    res = _kfit(stream, ingest=HALF)
    assert res.ingest.quarantined_batches == 1
    _same(res, _kfit(_without(X[:1000], 200, 2)))
    ev = [e for e in _events(runlog) if e["event"] == "ingest_quarantine"]
    assert ev and ev[0]["reason"].startswith("bad_shape")


def _torn(i):
    if i == 2:
        raise CorruptBatch("torn record", batch=i, reason="torn_record",
                           shape=(200, 8), dtype=np.float32)
    return X[i * 200:(i + 1) * 200]


def test_corrupt_read_on_weighted_stream_fails_loudly(runlog):
    stream = SizedBatches(lambda: (_torn(i) for i in range(5)), 1000, 200,
                          read_batch=_torn)
    with pytest.raises(CorruptBatch, match="torn record"):
        _kfit(stream, sample_weight_batches=NpzStream(
            np.ones(1000, np.float32), 200), ingest=HALF)
    ev = [e for e in _events(runlog) if e["event"] == "ingest_failed"]
    assert len(ev) == 1 and ev[0]["kind"] == "corrupt"


def test_corrupt_read_on_ranged_stream_quarantined():
    stream = SizedBatches(lambda: (_torn(i) for i in range(5)), 1000, 200,
                          read_batch=_torn)
    res = _kfit(stream, ingest=HALF)
    assert res.ingest.quarantined_batches == 1
    assert res.ingest.crc_failures >= 1
    _same(res, _kfit(_without(X[:1000], 200, 2)))


def test_init_peek_goes_through_the_guard(inject, runlog):
    inject("data.read.transient=raise:ConnectionError@1")
    res = _kfit(NpzStream(X, 200), init="kmeans++", max_iters=2,
                ingest=IngestPolicy(io_retries=3, io_backoff=1e-3))
    assert res.ingest.retries >= 1
    ev = [e for e in _events(runlog) if e["event"] == "ingest_retry"]
    assert ev and ev[0]["batch"] == 0


@pytest.mark.parametrize("where", ["host", "device"])
def test_init_from_poisoned_first_batch_refused(runlog, where):
    """A quarantined first batch cannot seed a named init (the JAX words),
    whether the host screen (a wrong width) or the device scan finds
    it; an explicit init over the same stream completes."""
    if where == "device":
        stream = NpzStream(_poisoned(bad=slice(0, 200)), 200)
    else:
        def read(i):
            b = X[i * 200:(i + 1) * 200]
            return b[:, :5] if i == 0 else b

        stream = SizedBatches(lambda: (read(i) for i in range(5)), 1000,
                              200, read_batch=read)
    with pytest.raises(IngestAbort, match="explicit init"):
        _kfit(stream, init="kmeans++", max_iters=2,
              ingest=IngestPolicy(max_bad_fraction=1.0))
    ev = [e for e in _events(runlog) if e["event"] == "ingest_quarantine"]
    assert ev and ev[0]["batch"] == 0 and ev[0].get("peek")
    res = _kfit(stream, max_iters=2,
                ingest=IngestPolicy(max_bad_fraction=1.0))
    assert res.ingest.quarantined_batches == 1


def test_injected_corrupt_verdict(inject, runlog):
    inject("data.corrupt=raise:ValueError@2")
    res = _kfit(NpzStream(X, 200), max_iters=2, ingest=HALF)
    assert res.ingest.quarantined_batches == 1
    ev = [e for e in _events(runlog) if e["event"] == "ingest_quarantine"]
    assert ev and ev[0]["reason"] == "injected:ValueError"


def test_spill_quarantine_bit_exact_with_plain():
    base = _kfit(NpzStream(_poisoned(), 200), ingest=HALF)
    res = _kfit(NpzStream(_poisoned(), 200), ingest=HALF, residency="spill")
    _same(base, res)
    assert res.h2d is not None and res.ingest.quarantined_batches == 1


def test_hbm_fill_abandons_loudly_and_fit_completes(runlog):
    xp = _poisoned()
    stream = SizedBatches(
        lambda: (xp[i:i + 200] for i in range(0, 1003, 200)), 1003, 200)
    res = _kfit(stream, residency="hbm", ingest=HALF)
    _same(res, _kfit(_without(X, 200, 2)))
    ab = [e for e in _events(runlog)
          if e["event"] == "residency_cache_abandoned"]
    assert ab and ab[0]["reason"] == "quarantined_batch"


def test_midpass_ckpt_resume_with_quarantine(tmp_path):
    from tdc_tpu_torch.utils import preempt

    xp = X[:1000].copy()
    xp[250:375] = np.nan  # batch 2 of 8 (125-row batches)

    def mk(trip_at=None):
        seen = {"n": 0}

        def batches():
            for i in range(0, 1000, 125):
                seen["n"] += 1
                if trip_at is not None and seen["n"] == trip_at:
                    preempt.request()
                yield xp[i:i + 125]

        return batches

    kw = dict(max_iters=4, ingest=HALF)
    full = _kfit(mk(), **kw)
    d = str(tmp_path / "ck")
    ck = dict(ckpt_dir=d, ckpt_every=100, ckpt_every_batches=100)
    preempt.reset()
    with pytest.raises(preempt.Preempted):
        _kfit(mk(trip_at=21), **kw, **ck)
    preempt.reset()
    resumed = _kfit(mk(), **kw, **ck)
    _same(resumed, full)


# ---------------------------------------------------------------------------
# The CRC sidecar, across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecars_verify_across_packages(tmp_path, writer):
    from tdc_tpu.data import loader as jload

    x = _data(800, 4, seed=1)
    p = str(tmp_path / "pts.npy")
    np.save(p, x)
    write = write_crc_sidecar if writer == "port" else jload.write_crc_sidecar
    write(x, 200, crc_sidecar_path(p))
    a = NpzStream.from_npy(p, 200)
    b = jload.NpzStream.from_npy(p, 200)
    assert a._crcs == b._crcs and a._crcs is not None
    for i in range(4):
        np.testing.assert_array_equal(a.read_batch(i), b.read_batch(i))
    with open(p, "r+b") as f:
        f.seek(128 + 200 * 4 * 4 + 37)  # into batch 1's bytes
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x10]))
    for s in (NpzStream.from_npy(p, 200), jload.NpzStream.from_npy(p, 200)):
        with pytest.raises(Exception, match="batch 1 CRC mismatch"):
            s.read_batch(1)
        s.read_batch(2)


def test_sidecar_refusals_in_the_jax_words(tmp_path):
    from tdc_tpu.data import loader as jload

    x = _data(800, 4, seed=1)
    p = str(tmp_path / "pts.npy")
    np.save(p, x)
    write_crc_sidecar(x, 100, crc_sidecar_path(p))
    for fn in (lambda m: m.NpzStream.from_npy(p, 200),
               lambda m: m.NpzStream.from_npy(p, 100, verify_crc="on"),
               lambda m: m.NpzStream(x[:10], 100,
                                     crc_sidecar=crc_sidecar_path(p))):
        with pytest.raises(ValueError) as got:
            fn(__import__("tdc_tpu_torch.data.loader", fromlist=["x"]))
        with pytest.raises(ValueError) as want:
            fn(jload)
        assert str(got.value) == str(want.value)
    q = str(tmp_path / "bare.npy")
    np.save(q, x[:100])
    with pytest.raises(FileNotFoundError):
        NpzStream.from_npy(q, 50, verify_crc="require")
    assert NpzStream.from_npy(q, 50)._crcs is None
    assert NpzStream.from_npy(p, 100, verify_crc="off")._crcs is None


def test_stream_write_crc_sidecar_arms_and_matches_jax(tmp_path):
    from tdc_tpu.data import loader as jload

    x = _data(450, 3, seed=4)
    s = NpzStream(x, 100)
    s.write_crc_sidecar(str(tmp_path / "a.json"))
    j = jload.NpzStream(x, 100)
    j.write_crc_sidecar(str(tmp_path / "b.json"))
    assert json.load(open(tmp_path / "a.json")) == \
        json.load(open(tmp_path / "b.json"))
    assert s._crcs == j._crcs


def test_bit_flip_quarantined_not_crashed(tmp_path, runlog):
    x = _data(800, 4, seed=2)
    p = str(tmp_path / "pts.npy")
    np.save(p, x)
    write_crc_sidecar(x, 200, crc_sidecar_path(p))
    with open(p, "r+b") as f:
        f.seek(128 + 200 * 4 * 4 + 37)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x10]))
    res = _kfit(NpzStream.from_npy(p, 200), 4, 4, init=x[:4], ingest=HALF)
    assert res.ingest.quarantined_batches == 1
    assert res.ingest.crc_failures >= 1
    _same(res, _kfit(_without(x, 200, 1), 4, 4, init=x[:4]))
    from tdc_tpu.data import loader as jload

    want = _jkfit(jload.NpzStream.from_npy(p, 200), 4, 4, init=x[:4],
                  ingest=_jpolicy(HALF))
    _assert_fits(res, want)
    assert res.ingest == want.ingest
    ev = [e for e in _events(runlog) if e["event"] == "ingest_quarantine"]
    assert ev and ev[0]["reason"] == "crc:crc_mismatch"
    assert ev[0]["store"] == p


def test_batch_iterator_and_synthetic_helpers(tmp_path):
    from tdc_tpu.data import loader as jload
    from tdc_tpu_torch.data import (
        batch_iterator,
        make_classification_data,
        save_npz,
    )

    x = _data(103, 3)
    for nb in (1, 4, 7):
        got = list(batch_iterator(x, nb))
        want = list(jload.batch_iterator(x, nb))
        assert [g.shape for g in got] == [w.shape for w in want]
        np.testing.assert_array_equal(np.concatenate(got), x)
    xc, yc = make_classification_data(3, 500, 4, device="cpu")
    assert xc.shape == (500, 4) and set(yc.unique().tolist()) <= {0, 1}
    save_npz(str(tmp_path / "d.npz"), xc, yc)
    with np.load(tmp_path / "d.npz") as z:
        np.testing.assert_array_equal(z["X"], xc.numpy())
        np.testing.assert_array_equal(z["Y"], yc.numpy())


def test_every_jax_data_name_resolves_in_the_port():
    import tdc_tpu.data as jdata
    import tdc_tpu_torch.data as tdata

    missing = [n for n in jdata.__all__ if not hasattr(tdata, n)]
    assert missing == []


# ---------------------------------------------------------------------------
# Bounded loss
# ---------------------------------------------------------------------------


def test_strict_default_aborts_on_first_quarantine(runlog):
    with pytest.raises(IngestAbort, match="max_bad_fraction") as got:
        _kfit(NpzStream(_poisoned(), 200))
    ev = [e for e in _events(runlog) if e["event"] == "ingest_abort"]
    assert len(ev) == 1 and ev[0]["quarantined_rows"] == 200
    from tdc_tpu.data.ingest import IngestAbort as JAbort

    with pytest.raises(JAbort) as want:
        _jkfit(_jnpz(_poisoned(), 200))
    assert str(got.value) == str(want.value)


def test_fraction_budget_allows_and_bounds_the_loss(runlog):
    res = _kfit(NpzStream(_poisoned(), 200), max_iters=2,
                ingest=IngestPolicy(max_bad_fraction=0.25))
    assert res.ingest.dropped_fraction < 0.25
    xp = X.copy()
    xp[200:600] = np.nan  # 2 of 6 batches, ~40%
    with pytest.raises(IngestAbort, match="max_bad_fraction"):
        _kfit(NpzStream(xp, 200), max_iters=2,
              ingest=IngestPolicy(max_bad_fraction=0.25))
    assert [e for e in _events(runlog) if e["event"] == "ingest_abort"]


def test_sequential_stream_budget_checked_at_pass_end():
    xp = X.copy()
    xp[0:400] = np.nan

    def gen():
        for i in range(0, 1003, 200):
            yield xp[i:i + 200]

    with pytest.raises(IngestAbort):
        _kfit(lambda: gen(), max_iters=2,
              ingest=IngestPolicy(max_bad_fraction=0.25))


# ---------------------------------------------------------------------------
# Clean transparency, the report, the counters, the protocols
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuzzy", [False, True])
def test_clean_guarded_fit_is_the_passthrough(fuzzy):
    kw = dict(init=X[:8], max_iters=3, tol=-1.0, device="cpu")
    fit = streamed_fuzzy_fit if fuzzy else streamed_kmeans_fit
    base = fit(NpzStream(X, 200), 8, 8, ingest=PASSTHROUGH_POLICY, **kw)
    res = fit(NpzStream(X, 200), 8, 8, **kw)
    _same(base, res, "objective" if fuzzy else "sse")
    rep = res.ingest
    assert rep.retries == 0 and rep.read_failures == 0
    assert rep.quarantined_batches == 0 and rep.dropped_fraction == 0.0
    assert rep.rows_per_pass == 1003


def test_global_counter_mirrors_fits():
    before = ting.GLOBAL_INGEST.snapshot()
    x = _data(600, 4, seed=5)
    xp = x.copy()
    xp[200:400] = np.nan
    _kfit(NpzStream(xp, 200), 4, 4, init=x[:4], max_iters=2, ingest=HALF)
    after = ting.GLOBAL_INGEST.snapshot()
    assert after["quarantined_batches"] > before["quarantined_batches"]
    assert (after["quarantined_rows"] - before["quarantined_rows"]) \
        % 200 == 0


def test_guard_protocols_forwarded():
    from tdc_tpu_torch.data import device_cache as dc
    from tdc_tpu_torch.data import spill as spill_lib

    x = _data(1000, 8)
    g = ting.guard_stream(NpzStream(x, 250), None, d=8)
    assert dc.stream_hints(g) == dc.StreamHints(1000, 250, 4)
    assert dc.stream_itemsize(g) == 4
    ranged = spill_lib.ranged_reader(g)
    assert ranged is not None and ranged[1] == 4
    np.testing.assert_array_equal(ranged[0](2), x[500:750])
    b = ting.guard_stream(lambda: iter([x[:200], x[200:]]), None, d=8)
    assert spill_lib.ranged_reader(b) is None
    np.testing.assert_array_equal(np.concatenate(list(b())), x)
    q = Quarantined(np.zeros((5, 3), np.float32), None, 7, "nonfinite")
    assert q.x.shape == (5, 3) and q.index == 7 and "nonfinite" in repr(q)


def test_cli_ingest_flags(tmp_path, capsys):
    """The CLI's eight data-plane flags: the JAX CLI's refusals in its
    words, and a quarantine through --max_bad_fraction."""
    from tdc_tpu.cli import main as jcli
    from tdc_tpu_torch.cli import main as tcli

    p = str(tmp_path / "x.npy")
    np.save(p, _poisoned())
    base = ["--K=8", f"--data_file={p}", "--n_max_iters=2", "--init=first_k"]
    for bad in (["--io_retries=-1"], ["--io_backoff=-1"],
                ["--io_deadline=0"], ["--max_bad_fraction=2"],
                ["--store_timeout=1"], ["--store_base=/x"],
                ["--data_manifest=m.json", "--streamed"],
                ["--data_manifest=m.json"],
                ["--native_loader", "--layout=features"]):
        msgs = []
        for mod in (tcli, jcli):
            parser = mod.build_parser()
            args = parser.parse_args([*base, *bad])
            with pytest.raises(SystemExit):
                mod.validate_args(parser, args)
            msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert msgs[0].split("error: ")[1] == msgs[1].split("error: ")[1]
    with pytest.raises(SystemExit, match="apply to the streamed"):
        tcli.run_experiment(tcli.build_parser().parse_args(
            [*base, "--max_bad_fraction=0.5", "--device=cpu"]))
    log = str(tmp_path / "log.csv")
    assert tcli.main([*base, "--num_batches=6", "--device=cpu",
                      "--max_bad_fraction=0.5", f"--log_file={log}"]) == 0
    assert tcli.main([*base, "--num_batches=6", "--device=cpu",
                      f"--log_file={log}"]) == 1
    assert "IngestAbort" in open(log).read()


# ---------------------------------------------------------------------------
# Ranks: every reduce mode on 2 and 4 gloo ranks, and the chaos gang
# ---------------------------------------------------------------------------


MODES = ("per_batch", "per_pass", "per_pass:int8")


def _rank_job(world, rank, extra):
    from tdc_tpu_torch.parallel import mesh as tmesh

    out = {}
    mesh = tmesh.make_mesh(world)
    xp = _poisoned()
    for reduce in MODES:
        for fuzzy in (False, True):
            fit = streamed_fuzzy_fit if fuzzy else streamed_kmeans_fit
            kw = dict(init=X[:8], max_iters=3, tol=-1.0, mesh=mesh,
                      reduce=reduce, device="cpu")
            q = fit(NpzStream(xp, 200), 8, 8, ingest=HALF, **kw)
            r = fit(_without(X, 200, 2), 8, 8, **kw)
            clean = fit(NpzStream(X, 200), 8, 8, **kw)
            passthrough = fit(NpzStream(X, 200), 8, 8,
                              ingest=PASSTHROUGH_POLICY, **kw)
            out[reduce, fuzzy] = dict(
                q=q.centroids.numpy(), removed=r.centroids.numpy(),
                report=tuple(q.ingest), clean=clean.centroids.numpy(),
                passthrough=passthrough.centroids.numpy())
        for name, kw in (("hbm", dict(residency="hbm")),
                         ("spill", dict(residency="spill"))):
            q = streamed_kmeans_fit(NpzStream(xp, 200), 8, 8, init=X[:8],
                                    max_iters=3, tol=-1.0, mesh=mesh,
                                    reduce=reduce, ingest=HALF,
                                    device="cpu", **kw)
            out[reduce, name] = q.centroids.numpy()
        try:
            streamed_kmeans_fit(NpzStream(xp, 200), 8, 8, init=X[:8],
                                max_iters=2, tol=-1.0, mesh=mesh,
                                reduce=reduce, device="cpu")
            out[reduce, "strict"] = None
        except IngestAbort as e:
            out[reduce, "strict"] = str(e)
    # A NaN in the last rank's rows of batch 2 only: every rank drops the
    # batch in every reduce mode (per_pass: each rank scans the whole
    # batch on the host).
    xl = X.copy()
    xl[599, 3] = np.nan
    for reduce in MODES:
        for fuzzy in (False, True):
            fit = streamed_fuzzy_fit if fuzzy else streamed_kmeans_fit
            q = fit(NpzStream(xl, 200), 8, 8, init=X[:8], max_iters=3,
                    tol=-1.0, mesh=mesh, reduce=reduce, ingest=HALF,
                    device="cpu")
            out[reduce, fuzzy, "local"] = (q.centroids.numpy(),
                                           tuple(q.ingest))
        # The same batches as tensors, from a bare generator.
        q = streamed_kmeans_fit(
            lambda: (torch.from_numpy(xl[i:i + 200])
                     for i in range(0, 1003, 200)),
            8, 8, init=X[:8], max_iters=3, tol=-1.0, mesh=mesh,
            reduce=reduce, ingest=HALF, device="cpu")
        out[reduce, "tensors", "local"] = q.centroids.numpy()
    # A read that fails for good on the last rank only, in pass 2 (read
    # 9: the init's peek, 6 reads a pass): every rank raises at the end
    # of that pass, and no mid-pass checkpoint of it is written.
    ckpt = os.path.join(os.environ["TDC_TEST_TMP"], f"ckpt{world}")
    for reduce, kw in (("per_batch", dict(ckpt_dir=ckpt, ckpt_every=1,
                                           ckpt_every_batches=2)),
                       ("per_pass", {})):
        if rank == world - 1:
            os.environ["TDC_FAULTS"] = "data.read.permanent=raise:ValueError@9"
        tfaults.reset()
        try:
            streamed_kmeans_fit(NpzStream(X, 200), 8, 8, init=X[:8],
                                max_iters=3, tol=-1.0, mesh=mesh,
                                reduce=reduce, device="cpu", **kw)
            out[reduce, "failed"] = None
        except Exception as e:
            out[reduce, "failed"] = f"{type(e).__name__}: {e}"
        finally:
            os.environ.pop("TDC_FAULTS", None)
            tfaults.reset()
    from tdc_tpu_torch.utils.checkpoint import restore_checkpoint

    saved = restore_checkpoint(ckpt)
    out["failed_ckpt"] = (saved.n_iter, saved.batch_cursor)
    if extra == "chaos":
        # The chaos gang (tests/test_chaos.py): ~30% transient reads on
        # every rank plus one globally poisoned batch, one launch.
        os.environ["TDC_FAULTS"] = _transient_spec()
        tfaults.reset()
        x = _chaos_blobs()
        xp = x.copy()
        xp[512:768] = np.nan
        res = streamed_kmeans_fit(
            NpzStream(xp, 256), 5, 4, init=x[:5], max_iters=5, tol=-1.0,
            mesh=mesh, device="cpu",
            ingest=IngestPolicy(io_retries=6, io_backoff=0.01,
                                max_bad_fraction=0.5))
        del os.environ["TDC_FAULTS"]
        out["chaos"] = (res.centroids.numpy(), tuple(res.ingest))
    return out


def _chaos_blobs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024, 4)).astype(np.float32)
    x[:256] += 4.0
    x[256:512] -= 4.0
    return x


def _rank_main(rank, world, init_method, extra, queue):
    from tdc_tpu_torch.parallel import multihost as tmh

    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        # The spawn's scratch directory (init_method is a file there).
        os.environ["TDC_TEST_TMP"] = os.path.dirname(
            init_method[len("file://"):])
        job = _store_job if extra == "store" else _rank_job
        queue.put((rank, job(world, rank, extra)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        tmh.shutdown()


def _spawn(tmp, world, extra=None, timeout=300):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{tmp}/store{world}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, extra, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, out = q.get(timeout=2)
                results[rank] = out
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    pytest.fail(f"ranks {dead} exited without a result, or "
                                f"{timeout} s passed")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(world):
        if isinstance(results.get(rank), str):
            pytest.fail(f"rank {rank} failed:\n{results[rank]}")
    return [results[r] for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {2: _spawn(tmp_path_factory.mktemp("ingest2"), 2, "chaos"),
            4: _spawn(tmp_path_factory.mktemp("ingest4"), 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("reduce", MODES)
@pytest.mark.parametrize("fuzzy", [False, True])
def test_ranks_quarantine_equals_removed(groups, world, reduce, fuzzy):
    ranks = groups[world]
    for out in ranks:
        got = out[reduce, fuzzy]
        # Bitwise: the same batches on the same ranks, the quarantined
        # one's collectives run but add nothing.
        np.testing.assert_array_equal(got["q"], got["removed"])
        np.testing.assert_array_equal(got["clean"], got["passthrough"])
        np.testing.assert_array_equal(got["q"], ranks[0][reduce, fuzzy]["q"])
        assert got["report"][2:5] == (1, 200, 1003)  # batches, rows, pass
    one = (streamed_fuzzy_fit if fuzzy else streamed_kmeans_fit)(
        _without(X, 200, 2), 8, 8, init=X[:8], max_iters=3, tol=-1.0,
        device="cpu")
    if not reduce.endswith("int8"):
        # Against one rank: the f32 sums' order (int8's encoding moves
        # near-ties further: tests/test_torch_reduce.py holds it).
        np.testing.assert_allclose(ranks[0][reduce, fuzzy]["q"],
                                   one.centroids.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("reduce", MODES)
def test_ranks_residency_and_strict_default(groups, world, reduce):
    for out in groups[world]:
        want = out[reduce, False]["q"]
        np.testing.assert_array_equal(out[reduce, "hbm"], want)
        np.testing.assert_array_equal(out[reduce, "spill"], want)
        assert "strict max_bad_fraction=0.0" in out[reduce, "strict"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("reduce", MODES)
@pytest.mark.parametrize("fuzzy", [False, True])
def test_ranks_drop_a_batch_bad_in_one_ranks_rows(groups, world, reduce,
                                                  fuzzy):
    """A non-finite value in the last rank's rows only: every rank reaches
    the verdict (per_pass by the host scan of the whole batch), and the
    fit is bitwise the fit without the batch, with the same report."""
    for out in groups[world]:
        got, report = out[reduce, fuzzy, "local"]
        np.testing.assert_array_equal(got, out[reduce, fuzzy]["removed"])
        assert report[2:5] == (1, 200, 1003)
        if not fuzzy:
            np.testing.assert_array_equal(out[reduce, "tensors", "local"],
                                          got)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("reduce", ["per_batch", "per_pass"])
def test_a_read_failed_on_one_rank_raises_on_every_rank(groups, world,
                                                        reduce):
    """The failing rank raises its read's own error and the others
    IngestReadError, all at the end of the pass (none is left waiting in
    a collective); the checkpoint on disk is iteration 1's end, not a
    mid-pass state of the pass that lost the batch."""
    ranks = groups[world]
    assert ranks[-1][reduce, "failed"].startswith(
        "ValueError: injected fault at data.read.permanent")
    for out in ranks[:-1]:
        assert out[reduce, "failed"].startswith("IngestReadError: ")
        assert "failed for good on another rank" in out[reduce, "failed"]
    for out in ranks:
        assert out["failed_ckpt"] == (1, 0)


def test_chaos_gang_flaky_reads_and_a_poisoned_batch(groups):
    ranks = groups[2]
    c0, rep0 = ranks[0]["chaos"]
    for c, rep in (r["chaos"] for r in ranks):
        np.testing.assert_array_equal(c, c0)  # replicated state agrees
        assert rep[0] > 0  # retries
        assert rep[2:4] == (1, 256)  # one batch, its rows (every rank's)
    x = _chaos_blobs()

    def batches():
        for b in (0, 1, 3):
            yield x[b * 256:(b + 1) * 256]

    from tdc_tpu.models.streaming import streamed_kmeans_fit as jfit

    want = jfit(batches, 5, 4, init=x[:5], max_iters=5, tol=-1.0)
    np.testing.assert_allclose(c0, np.asarray(want.centroids), rtol=1e-4,
                               atol=1e-4)


def _store_job(world, rank, extra):
    from tdc_tpu_torch.data.store import open_manifest_stream
    from tdc_tpu_torch.parallel import mesh as tmesh

    mdir, url = os.environ["TDC_TEST_MDIR"], os.environ["TDC_TEST_URL"]
    init = np.load(os.path.join(mdir, "..", "init.npy"))
    mesh = tmesh.make_mesh(world)
    policy = IngestPolicy(io_retries=6, io_backoff=0.01,
                          max_bad_fraction=0.5)
    out = {}
    for name, where, kw in (("http", url, dict(timeout=0.5)),
                            ("file", os.path.join(mdir, "manifest.json"),
                             {})):
        res = streamed_kmeans_fit(
            open_manifest_stream(where, spec=mesh, **kw), 5, 4, init=init,
            max_iters=3, tol=-1.0, mesh=mesh, ingest=policy, device="cpu")
        out[name] = (res.centroids.numpy(), tuple(res.ingest))
    return out


def test_chaos_gang_over_a_flaky_http_manifest(tmp_path, monkeypatch):
    """tests/test_chaos.py's object-store gang on two gloo ranks: a
    two-shard manifest served with ~30% 503s, one stalled and one
    truncated read, and a bit flipped on disk in global batch 5. Every
    rank reads every batch, so both ranks quarantine batch 5; the HTTP
    fit is bitwise the file:// fit; against one rank's oracle 1e-4."""
    from tdc_tpu_torch.data.manifest import build_manifest

    rng = np.random.default_rng(7)
    x = rng.normal(size=(960, 4)).astype(np.float32)
    x[:240] += 4.0
    x[240:480] -= 4.0
    mdir = tmp_path / "blobs"
    build_manifest(x, 120, str(mdir), n_shards=2)
    blob = mdir / "part-00001.bin"
    raw = bytearray(blob.read_bytes())
    raw[(600 - 480) * 16 + 7] ^= 0x40
    blob.write_bytes(bytes(raw))
    np.save(tmp_path / "init.npy", x[:5])
    server = FlakyHTTPServer(str(mdir), fail_every=3, fail_status=503,
                             retry_after=0.01, stall_requests={4},
                             stall_s=1.0, truncate_requests={9})
    with server as base_url:
        monkeypatch.setenv("TDC_TEST_MDIR", str(mdir))
        monkeypatch.setenv("TDC_TEST_URL", f"{base_url}/manifest.json")
        ranks = _spawn(str(tmp_path), 2, "store")
    assert server.fault_count > 0
    c_http = [r["http"][0] for r in ranks]
    np.testing.assert_array_equal(c_http[0], c_http[1])
    for r in ranks:
        np.testing.assert_array_equal(r["http"][0], r["file"][0])
        assert r["http"][1][2:4] == (1, 120) and r["file"][1][2:4] == (1, 120)
        assert r["file"][1][0] == 0
    assert sum(r["http"][1][0] for r in ranks) > 0

    def batches():
        for b in (0, 1, 2, 3, 4, 6, 7):
            yield x[b * 120:(b + 1) * 120]

    from tdc_tpu.models.streaming import streamed_kmeans_fit as jfit

    want = jfit(batches, 5, 4, init=x[:5], max_iters=3, tol=-1.0)
    np.testing.assert_allclose(c_http[0], np.asarray(want.centroids),
                               rtol=1e-4, atol=1e-4)



def test_concurrent_guarded_reads_keep_the_tallies():
    """The spill ring's workers read through one guard at once: with more
    threads than cores and a short switch interval, every read and
    quarantine is counted once (no lost update in the pass windows)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    def read(i):
        if i % 5 == 3:
            raise CorruptBatch("bad", batch=i, reason="crc_mismatch",
                               shape=(10, 8), dtype=np.float32)
        return X[:10]

    passes, nb = 6, 40
    stream = SizedBatches(lambda: iter(()), nb * 10, 10, read_batch=read)
    counter = ting.IngestCounter()
    g = ting.GuardedStream(stream, IngestPolicy(max_bad_fraction=1.0), d=8,
                           counter=counter)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4 * (os.cpu_count() or 1)) as ex:
            out = list(ex.map(g.read_batch, [i for _ in range(passes)
                                             for i in range(nb)]))
    finally:
        sys.setswitchinterval(old)
    bad = sum(isinstance(b, Quarantined) for b in out)
    assert bad == passes * nb // 5
    snap = counter.snapshot()
    assert snap["quarantined_batches"] == bad == snap["crc_failures"]
    assert snap["quarantined_rows"] == 10 * bad
    rep = g.report()
    assert rep.quarantined_batches == nb // 5 and rep.rows_per_pass == nb * 10
    assert g._reads == passes * nb
