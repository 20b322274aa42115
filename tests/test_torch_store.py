"""The port's object-store data plane (`tdc_tpu_torch/data/store.py`,
`testing/flaky_http.py`) against the JAX package's, on the CPU: the
store and fault-routing cases of tests/test_store.py (the manifest and
assignment cases: tests/test_torch_manifest.py).

The same seeded numpy data goes through both packages. Stream reads are
held equal exactly (the same bytes, the same errors in the same
words). Fits: the port's guarded fit against the
JAX package's at the streamed tolerances (centroids rtol 1e-5 / atol
1e-5, SSE rtol 1e-5), and within the port bitwise where the contract is
bitwise (a quarantined batch against that batch removed, an HTTP fault
storm against the file:// fit). The HTTP servers bind port 0 on
127.0.0.1, one per test.
"""

import json
import os

import numpy as np
import pytest
import torch

from tdc_tpu_torch.data import manifest as tman
from tdc_tpu_torch.data import store as tstore
from tdc_tpu_torch.data.ingest import CorruptBatch, IngestAbort, IngestPolicy
from tdc_tpu_torch.models.streaming import streamed_kmeans_fit
from tdc_tpu_torch.testing.flaky_http import FlakyHTTPServer

RTOL = 1e-5


def _data(n=960, d=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8, size=(6, d)).astype(np.float32)
    x = centers[rng.integers(0, 6, n)] + rng.normal(size=(n, d)).astype(
        np.float32)
    return x.astype(np.float32)


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


def _raises_alike(port_call, jax_call):
    """Both calls raise the same exception type with the same words."""
    with pytest.raises(Exception) as got:
        port_call()
    with pytest.raises(Exception) as want:
        jax_call()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def _assert_fits(got, want):
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


# ---------------------------------------------------------------------------
# The stream's protocols and backends
# ---------------------------------------------------------------------------


def test_sequential_ranged_and_sizing_protocols(tmp_path, runlog):
    from tdc_tpu_torch.data import device_cache as tdc
    from tdc_tpu_torch.data import spill as tspill

    x = _data(600, 6, seed=6)
    tman.build_manifest(x, 150, str(tmp_path), n_shards=2)
    s = tstore.open_manifest_stream(str(tmp_path))
    np.testing.assert_array_equal(np.concatenate(list(s())), x)
    np.testing.assert_array_equal(
        np.concatenate([s.read_batch(i) for i in range(4)]), x)
    assert s.n_rows == 600 and s.batch_rows == 150
    assert s.itemsize == 4 and s.dtype == np.float32
    assert tdc.stream_hints(s) == tdc.StreamHints(600, 150, 4)
    assert tspill.ranged_reader(s)[1] == 4
    ev = [e for e in _events(runlog) if e["event"] == "manifest_open"]
    assert ev and ev[0]["num_batches"] == 4 and ev[0]["shards"] == 2
    s.close()


def test_fetch_manifest_resolve_url_and_schemes(tmp_path):
    from tdc_tpu.data import store as jstore

    x = _data(480, 4, seed=7)
    tman.build_manifest(x, 120, str(tmp_path))
    m = tstore.fetch_manifest(str(tmp_path))
    assert m.to_json() == jstore.fetch_manifest(str(tmp_path)).to_json()
    for name, base in (("m.json", "http://h:1/b"), ("m.json", "/data/"),
                       ("http://x/m.json", "/d"), ("/abs/m.json", "/d"),
                       ("m.json", None)):
        assert tstore.resolve_url(name, base) == \
            jstore.resolve_url(name, base)
    _raises_alike(
        lambda: tstore.open_manifest_stream("s3://bucket/manifest.json"),
        lambda: jstore.open_manifest_stream("s3://bucket/manifest.json"))


def test_http_bit_identical_to_file(tmp_path):
    x = _data(600, 6, seed=8)
    tman.build_manifest(x, 150, str(tmp_path), n_shards=3)
    via_file = np.concatenate(
        list(tstore.open_manifest_stream(str(tmp_path))()))
    with FlakyHTTPServer(str(tmp_path)) as url:
        s = tstore.open_manifest_stream(url + "/" + tman.MANIFEST_NAME)
        via_http = np.concatenate(list(s()))
        s.close()
    np.testing.assert_array_equal(via_file, via_http)
    np.testing.assert_array_equal(via_file, x)


def test_http_connections_are_per_thread(tmp_path):
    """Each reading thread keeps its own keep-alive connection (the spill
    ring's workers must not share a socket)."""
    import threading

    x = _data(600, 6, seed=8)
    tman.build_manifest(x, 150, str(tmp_path))
    with FlakyHTTPServer(str(tmp_path)) as url:
        st = tstore.HTTPRangeStore(url)
        conns, errors = [], []

        def read():
            try:
                for _ in range(3):
                    st.read_range("part-00000.bin", 0, 64)
                conns.append(st._local.conn)
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=read) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st.close()
    assert not errors and len({id(c) for c in conns}) == 3
    assert st.counter.snapshot()["reads"] == 9


def test_store_counter_books_reads_and_bytes(tmp_path):
    x = _data(480, 4, seed=9)
    tman.build_manifest(x, 120, str(tmp_path))
    c = tstore.StoreCounter()
    before = tstore.GLOBAL_STORE.snapshot()["reads"]
    s = tstore.open_manifest_stream(str(tmp_path), counter=c)
    list(s())
    s.close()
    snap = c.snapshot()
    assert snap["reads"] == 4 and snap["bytes"] == x.nbytes
    assert snap["failed"] == 0
    assert tstore.GLOBAL_STORE.snapshot()["reads"] == before  # own counter


def test_short_blobs_and_http_statuses(tmp_path):
    (tmp_path / "b.bin").write_bytes(b"\0" * 100)
    with pytest.raises(tstore.StoreShortBlob):
        tstore.FileStore(str(tmp_path)).read_range("b.bin", 0, 200)
    with FlakyHTTPServer(str(tmp_path)) as url:
        st = tstore.HTTPRangeStore(url)
        with pytest.raises(tstore.StoreShortBlob):
            st.read_range("b.bin", 200, 50)
        st.close()
    with FlakyHTTPServer(str(tmp_path), fail_every=1, fail_status=503,
                         retry_after=7) as url:
        st = tstore.HTTPRangeStore(url)
        with pytest.raises(tstore.StoreHTTPError) as ei:
            st.read_range("b.bin", 0, 10)
        st.close()
    assert ei.value.status == 503 and ei.value.retry_after == 7.0


def test_store_fault_points(tmp_path, monkeypatch):
    """store.read.* fire on every ranged read attempt and store.list on
    the manifest load, as in the JAX package."""
    from tdc_tpu_torch.testing import faults

    x = _data(480, 4, seed=9)
    tman.build_manifest(x, 120, str(tmp_path))
    monkeypatch.setenv("TDC_FAULTS", "store.list=raise:ConnectionError")
    faults.reset()
    with pytest.raises(ConnectionError, match="store.list"):
        tstore.open_manifest_stream(str(tmp_path))
    monkeypatch.setenv("TDC_FAULTS",
                       "store.read.transient=raise:ConnectionError@2")
    faults.reset()
    s = tstore.open_manifest_stream(str(tmp_path))
    s.read_batch(0)
    with pytest.raises(ConnectionError):
        s.read_batch(1)
    assert s.store.counter.snapshot()["failed"] == 1
    faults.reset()


# ---------------------------------------------------------------------------
# Corruption -> quarantine; transfer faults -> transparent retries
# ---------------------------------------------------------------------------


X = _data(960, 6, seed=10)


def _built(tmp_path, **kw):
    d = str(tmp_path / "blobs")
    tman.build_manifest(X, 120, d, **kw)
    return d


def _fit(stream, **kw):
    kw.setdefault("max_iters", 4)
    kw.setdefault("tol", -1.0)
    return streamed_kmeans_fit(stream, 6, 6, init=X[:6], device="cpu", **kw)


def _jfit(stream, **kw):
    from tdc_tpu.models.streaming import streamed_kmeans_fit as jfit

    kw.setdefault("max_iters", 4)
    kw.setdefault("tol", -1.0)
    return jfit(stream, 6, 6, init=X[:6], **kw)


def _flip_bit(mdir, blob="part-00000.bin", byte=3):
    p = os.path.join(mdir, blob)
    raw = bytearray(open(p, "rb").read())
    raw[byte] ^= 0x10
    open(p, "wb").write(bytes(raw))


def _without(*drop):
    def gen():
        for i in range(8):
            if i not in drop:
                yield X[i * 120:(i + 1) * 120]

    return lambda: gen()


def test_crc_bit_flip_raises_corrupt(tmp_path):
    mdir = _built(tmp_path)
    _flip_bit(mdir)
    s = tstore.open_manifest_stream(mdir)
    with pytest.raises(CorruptBatch, match="CRC32 mismatch"):
        s.read_batch(0)
    with pytest.raises(CorruptBatch, match="CRC32 mismatch"):
        next(iter(s()))
    s.close()


def test_crc_bit_flip_quarantined_equals_removed(tmp_path, runlog):
    from tdc_tpu.data import store as jstore
    from tdc_tpu.data.ingest import IngestPolicy as JPolicy

    mdir = _built(tmp_path)
    _flip_bit(mdir, byte=3)  # batch 0
    res = _fit(tstore.open_manifest_stream(mdir),
               ingest=IngestPolicy(max_bad_fraction=0.5))
    assert res.ingest.quarantined_batches == 1
    assert res.ingest.quarantined_rows == 120
    oracle = _fit(_without(0))
    assert torch.equal(res.centroids, oracle.centroids)
    assert float(res.sse) == float(oracle.sse)
    want = _jfit(jstore.open_manifest_stream(mdir),
                 ingest=JPolicy(max_bad_fraction=0.5))
    _assert_fits(res, want)
    assert res.ingest == want.ingest
    ev = [e for e in _events(runlog) if e["event"] == "ingest_quarantine"]
    assert ev and ev[0]["reason"] == "crc:crc_mismatch"


def test_truncated_blob_on_disk_quarantined(tmp_path, runlog):
    mdir = _built(tmp_path, n_shards=4)
    p = os.path.join(mdir, "part-00003.bin")
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:len(raw) // 2])
    res = _fit(tstore.open_manifest_stream(mdir),
               ingest=IngestPolicy(max_bad_fraction=0.5, io_retries=2,
                                   io_backoff=1e-3))
    assert res.ingest.quarantined_batches == 1
    assert res.ingest.retries == 0  # classified corrupt, never retried
    assert torch.equal(res.centroids, _fit(_without(7)).centroids)
    ev = [e for e in _events(runlog) if e["event"] == "ingest_quarantine"]
    assert ev and ev[0]["reason"] == "crc:short_blob"


def test_strict_default_aborts_on_corruption(tmp_path, runlog):
    mdir = _built(tmp_path)
    _flip_bit(mdir)
    with pytest.raises(IngestAbort, match="max_bad_fraction"):
        _fit(tstore.open_manifest_stream(mdir))
    assert [e for e in _events(runlog) if e["event"] == "ingest_abort"]


def test_http_storm_rides_the_retry_ladder(tmp_path):
    """~1/3 of blob requests 503 (with Retry-After) and one truncated
    body: the guarded fit is bitwise the clean file:// fit."""
    mdir = _built(tmp_path, n_shards=2)
    base = _fit(tstore.open_manifest_stream(mdir))
    with FlakyHTTPServer(mdir, fail_every=3, retry_after=0.01,
                         truncate_requests={5}) as url:
        res = _fit(tstore.open_manifest_stream(url + "/" +
                                               tman.MANIFEST_NAME),
                   ingest=IngestPolicy(io_retries=4, io_backoff=1e-3))
    assert res.ingest.retries > 0 and res.ingest.quarantined_batches == 0
    assert torch.equal(base.centroids, res.centroids)
    assert float(base.sse) == float(res.sse)
    _assert_fits(res, _jfit(_without()))


def test_stalled_socket_times_out_and_recovers(tmp_path):
    mdir = _built(tmp_path)
    with FlakyHTTPServer(mdir, stall_requests={1}, stall_s=1.0) as url:
        res = _fit(tstore.open_manifest_stream(
            url + "/" + tman.MANIFEST_NAME, timeout=0.3),
            ingest=IngestPolicy(io_retries=3, io_backoff=1e-3))
    base = _fit(tstore.open_manifest_stream(mdir))
    assert res.ingest.retries >= 1
    assert torch.equal(base.centroids, res.centroids)


def test_persistent_404_fails_loudly_no_retry_storm(tmp_path, runlog):
    mdir = _built(tmp_path)
    os.remove(os.path.join(mdir, "part-00000.bin"))
    with FlakyHTTPServer(mdir) as url:
        with pytest.raises(tstore.StoreHTTPError, match="404"):
            _fit(tstore.open_manifest_stream(url + "/" + tman.MANIFEST_NAME),
                 ingest=IngestPolicy(io_retries=5, io_backoff=1e-3))
    ev = [e for e in _events(runlog) if e["event"] == "ingest_failed"]
    assert ev and ev[0]["attempts"] == 1 and ev[0]["kind"] == "permanent"


@pytest.mark.parametrize("residency", ["spill", "hbm"])
def test_residency_over_manifest_bit_exact(tmp_path, residency):
    mdir = _built(tmp_path, n_shards=2)
    base = _fit(tstore.open_manifest_stream(mdir))
    res = _fit(tstore.open_manifest_stream(mdir), residency=residency)
    assert torch.equal(base.centroids, res.centroids)
    if residency == "spill":
        assert res.h2d is not None and res.h2d.cross_pass > 0


def test_midpass_ckpt_resume_bit_identical(tmp_path):
    from tdc_tpu_torch.utils import preempt

    mdir = _built(tmp_path)
    full = _fit(tstore.open_manifest_stream(mdir))
    trip = {"reads": 0}
    s = tstore.open_manifest_stream(mdir)
    raw_read = s.read_batch

    def tripping_read(i):
        trip["reads"] += 1
        if trip["reads"] == 13:  # mid-pass, second iteration
            preempt.request()
        return raw_read(i)

    s.read_batch = tripping_read
    d = str(tmp_path / "ck")
    preempt.reset()
    with pytest.raises(preempt.Preempted):
        _fit(s, ckpt_dir=d, ckpt_every=100, ckpt_every_batches=3)
    preempt.reset()
    resumed = _fit(tstore.open_manifest_stream(mdir), ckpt_dir=d,
                   ckpt_every=100, ckpt_every_batches=3)
    assert torch.equal(resumed.centroids, full.centroids)
