"""The port's preemption drain (`utils/preempt.py`) and heartbeat
(`utils/heartbeat.py`) in the streamed fits, on the CPU.

A worker process with the handler installed that gets a SIGTERM
mid-pass exits 75 with a mid-pass checkpoint, from which a resume equals
the uninterrupted fit bit for bit; a second SIGTERM exits at once. In
this process the flag is raised with `preempt.request()` (the handler is
never installed here: a pytest worker keeps its own SIGTERM), and reset
after each test.
"""

import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tdc_tpu.utils import heartbeat as jhb
from tdc_tpu.utils import preempt as jpre
from tdc_tpu_torch.data import loader as tload
from tdc_tpu_torch.models import streaming as tst
from tdc_tpu_torch.utils import checkpoint as tck
from tdc_tpu_torch.utils import heartbeat as thb
from tdc_tpu_torch.utils import preempt

REPO = Path(__file__).resolve().parent.parent
N, K, D = 1200, 6, 5
ROWS = 200  # 6 batches a pass


def _blobs():
    rng = np.random.default_rng(0)
    centers = rng.uniform(-5, 5, size=(K, D))
    x = (centers[rng.integers(0, K, size=N)]
         + rng.normal(size=(N, D))).astype(np.float32)
    return x, x[:K].copy()


@pytest.fixture(autouse=True)
def _clear_flag():
    preempt.reset()
    yield
    preempt.reset()


def _child(code: str, *args) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          capture_output=True, text=True, timeout=120,
                          env=env)


SIGTERM_FIT = """
import os, signal, sys
import numpy as np
from tdc_tpu_torch.data.loader import NpzStream
from tdc_tpu_torch.models.streaming import streamed_kmeans_fit
from tdc_tpu_torch.utils import preempt

x = np.load(sys.argv[1])
preempt.install_preemption_handler()


def _batches(s):
    for i in range(s.num_batches):
        yield NpzStream.read_batch(s, i)


class Signalling(NpzStream):
    fetched = 0
    # Iterate only (no ranged reads through the ingest guard), so every
    # read passes __call__.
    read_batch = None

    def __call__(self):
        for b in _batches(self):
            Signalling.fetched += 1
            # The init's read, pass 1, then the 4th batch of pass 2.
            if Signalling.fetched == 1 + 6 + 4:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


streamed_kmeans_fit(Signalling(x, 200), 6, 5, init=x[:6].copy(),
                    max_iters=8, tol=-1.0, ckpt_dir=sys.argv[2],
                    ckpt_every=100, ckpt_every_batches=3, prefetch=2,
                    device="cpu")
print("not preempted")
"""


def test_sigterm_drains_to_exit_75_with_a_resumable_checkpoint(tmp_path):
    x, init = _blobs()
    npy = tmp_path / "x.npy"
    np.save(npy, x)
    d = str(tmp_path / "ck")
    proc = _child(SIGTERM_FIT, npy, d)
    assert proc.returncode == preempt.PREEMPTED_EXIT_CODE, proc.stderr
    assert "not preempted" not in proc.stdout
    assert '"event": "preempt_requested", "signal": 15' in proc.stderr
    saved = tck.restore_checkpoint(d)
    # Iteration 1 done; the drain saved pass 2's batches consumed so far:
    # the staging thread (prefetch=2) fetches ahead of the loop, so the
    # signal comes while the loop is at one of batches 1..4, and the
    # cursor and rows count the batches the loop consumed.
    assert saved.n_iter == 1 and 1 <= saved.batch_cursor <= 6
    assert int(saved.meta["acc_rows"]) == ROWS * saved.batch_cursor
    full = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                   max_iters=8, tol=-1.0, device="cpu")
    res = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                  max_iters=8, tol=-1.0, ckpt_dir=d,
                                  ckpt_every=100, ckpt_every_batches=3,
                                  device="cpu")
    assert torch.equal(res.centroids, full.centroids)
    assert (res.n_iter, res.n_iter_run) == (8, 7)


SECOND_SIGTERM = """
import os, signal, time
from tdc_tpu_torch.utils import preempt

preempt.install_preemption_handler()
os.kill(os.getpid(), signal.SIGTERM)
print("drain requested", preempt.requested(), flush=True)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)
print("survived", flush=True)
"""


def test_second_sigterm_force_exits_with_the_code():
    proc = _child(SECOND_SIGTERM)
    assert proc.returncode == preempt.PREEMPTED_EXIT_CODE
    assert "drain requested True" in proc.stdout
    assert "survived" not in proc.stdout


def _batches(s):
    """The stream's batches, read as NpzStream reads them (the subclasses
    below hide `read_batch` so the ingest guard iterates them)."""
    for i in range(s.num_batches):
        yield tload.NpzStream.read_batch(s, i)


class Requesting(tload.NpzStream):
    """Raises the preemption flag as it yields batch `at` of pass `in_pass`
    (passes counted from the fit's first full pass)."""

    # Iterate only (no ranged reads through the ingest guard), so every
    # read passes __call__.
    read_batch = None

    def __init__(self, x, rows, in_pass, at):
        super().__init__(x, rows)
        self.calls, self.in_pass, self.at = 0, in_pass, at

    def __call__(self):
        self.calls += 1
        for i, b in enumerate(_batches(self)):
            # Call 1 is the explicit init's read of the first batch.
            if self.calls == self.in_pass + 1 and i == self.at:
                preempt.request()
            yield b


@pytest.mark.parametrize("every_batches, step, cursor", [
    (None, 1, 0), (5, 1, 3), (3, 1, 3)])
def test_mid_pass_preempt_saves_only_with_ckpt_every_batches(
        tmp_path, every_batches, step, cursor):
    x, init = _blobs()
    d = str(tmp_path / "ck")
    with pytest.raises(preempt.Preempted,
                       match="preempted at batch boundary 3 of iteration 2"
                       ) as exc:
        tst.streamed_kmeans_fit(Requesting(x, ROWS, 2, 2), K, D, init=init,
                                max_iters=8, tol=-1.0, ckpt_dir=d,
                                ckpt_every=1,
                                ckpt_every_batches=every_batches,
                                device="cpu")
    assert exc.value.code == preempt.PREEMPTED_EXIT_CODE
    saved = tck.restore_checkpoint(d)
    assert (saved.n_iter, saved.batch_cursor) == (step, cursor)
    # A flag raised before the resume ends it in the replayed prefix
    # (the checkpoint on disk covers that state), or at its first batch.
    preempt.request()
    with pytest.raises(preempt.Preempted,
                       match="during resume replay at batch 1"
                       if cursor else "batch boundary 1 of iteration 2"):
        tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                max_iters=8, tol=-1.0, ckpt_dir=d,
                                ckpt_every=1,
                                ckpt_every_batches=every_batches,
                                device="cpu")
    preempt.reset()
    full = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                   max_iters=8, tol=-1.0, device="cpu")
    res = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                  max_iters=8, tol=-1.0, ckpt_dir=d,
                                  ckpt_every=1,
                                  ckpt_every_batches=every_batches,
                                  device="cpu")
    assert torch.equal(res.centroids, full.centroids)


def test_preempt_api_against_jax():
    assert preempt.PREEMPTED_EXIT_CODE == jpre.PREEMPTED_EXIT_CODE == 75
    e = preempt.Preempted("drained")
    assert isinstance(e, SystemExit) and not isinstance(e, Exception)
    assert (e.code, str(e)) == (75, "drained")
    assert str(preempt.Preempted()) == str(jpre.Preempted()) == "preempted"
    assert not preempt.requested() and not preempt.sync_requested()
    preempt.request()
    assert preempt.requested() and preempt.sync_requested(gang=True)
    preempt.reset()
    assert not preempt.requested()
    preempt.reinstall_if_installed()  # a no-op: never installed here
    assert not preempt.installed()
    errors = []

    def off_main():
        try:
            preempt.install_preemption_handler()
        except RuntimeError as err:
            errors.append(str(err))

    t = threading.Thread(target=off_main)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert errors == ["install_preemption_handler must run on the main "
                      "thread (signal.signal requirement)"]
    assert signal.getsignal(signal.SIGTERM) is not preempt._on_signal


def test_heartbeat_marks_batches_and_never_raises(tmp_path, monkeypatch):
    beat = tmp_path / "beat"
    monkeypatch.setenv("TDC_HEARTBEAT_FILE", str(beat))
    monkeypatch.setattr(thb, "_last_beat", 0.0)
    x, init = _blobs()
    tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                            max_iters=2, tol=-1.0, device="cpu")
    text = beat.read_text()
    assert re.fullmatch(r"iter=\d+ batch=\d+", text), text
    # The JAX package's heartbeat writes the same form.
    monkeypatch.setattr(jhb, "_last_beat", 0.0)
    jhb.maybe_beat(progress="iter=1 batch=0")
    assert re.fullmatch(r"iter=\d+ batch=\d+", beat.read_text())
    # At most one beat a min_interval.
    monkeypatch.setattr(thb, "_last_beat", 0.0)
    thb.maybe_beat(progress="first")
    thb.maybe_beat(progress="second")
    assert beat.read_text() == "first"
    # An unwritable path (a directory) and no variable: no raise.
    monkeypatch.setenv("TDC_HEARTBEAT_FILE", str(tmp_path))
    monkeypatch.setattr(thb, "_last_beat", 0.0)
    thb.maybe_beat(progress="x")
    thb.maybe_beat()
    monkeypatch.delenv("TDC_HEARTBEAT_FILE")
    thb.maybe_beat(progress="y")


def _staging_threads():
    return [t for t in threading.enumerate()
            if t.name == "tdc-prefetch" and t.is_alive()]


@pytest.mark.parametrize("how", ["crash", "preempt"])
def test_a_raise_in_the_loop_stops_the_staging_thread(tmp_path, how):
    x, init = _blobs()
    # A one-slot queue the staging thread keeps full.
    stream = (Requesting(x, 100, 1, 1) if how == "preempt"
              else tload.NpzStream(x, 100))
    calls = []

    def step_fails(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("the loop fails")
        return real(*a, **kw)

    real = tst._batch_lloyd_stats
    want = (preempt.Preempted if how == "preempt" else RuntimeError)
    try:
        if how == "crash":
            tst._batch_lloyd_stats = step_fails
        with pytest.raises(want) as exc:
            tst.streamed_kmeans_fit(stream, K, D, init=init, max_iters=2,
                                    tol=-1.0, prefetch=1,
                                    ckpt_dir=str(tmp_path / "ck"),
                                    ckpt_every_batches=1, device="cpu")
    finally:
        tst._batch_lloyd_stats = real
    # The traceback still holds the fit's frames: the thread is gone all
    # the same.
    assert exc.value is not None and _staging_threads() == []
