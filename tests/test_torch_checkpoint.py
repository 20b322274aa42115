"""The port's checkpoint and resume (`utils/checkpoint.py`,
`parallel/reshard.py`, the streamed and mini-batch fits' `ckpt_dir`,
`load_fitted` on a checkpoint directory, the CLI's checkpoint flags)
against the JAX package on the CPU.

The format both ways: a port save restores through the JAX package's
`restore_checkpoint` with equal arrays and meta, and the JAX package's
state.npz saves (its `_manual_save`, and `save_checkpoint` as several
processes run it) restore in the port; its orbax steps raise the port's
format error. Resume: a fit killed mid-pass (a stream that raises after
a set number of batches, the JAX package's `_FusedStream`) and resumed
equals the same package's uninterrupted fit bit for bit; the JAX
streamed fit resumed from the port's mid-pass checkpoint ends within
rtol 1e-5 / atol 1e-5 of the port's resumed fit in the centroids, with
n_iter and converged equal (another f32 summation order). Ranks: two on
gloo (a file:// store under the test's tmp directory).
"""

import csv
import multiprocessing as mp
import os
import queue as queue_lib
import shutil
import time
import traceback

import jax
import numpy as np
import pytest
import torch

from tdc_tpu.data import loader as jload
from tdc_tpu.models import streaming as jst
from tdc_tpu.parallel import multihost as jmh
from tdc_tpu.parallel import reshard as jrs
from tdc_tpu.utils import checkpoint as jck
from tdc_tpu_torch.cli import main as tcli
from tdc_tpu_torch.data import loader as tload
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import minibatch as tmb
from tdc_tpu_torch.models import persist as tper
from tdc_tpu_torch.models import streaming as tst
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh
from tdc_tpu_torch.parallel import reshard as trs
from tdc_tpu_torch.utils import checkpoint as tck
from tdc_tpu_torch.utils import preempt

RTOL = 1e-5
N, K, D = 1200, 6, 5
ROWS = 200  # 6 batches a pass


def _blobs(seed=0, n=N, k=K, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)].copy()


def _weights(n=N):
    w = np.random.default_rng(1).uniform(0.5, 2.0, n).astype(np.float32)
    w[::7] = 0.0
    return w


class FusedStream:
    """An NpzStream that raises after yielding `fuse` batches in all
    (across passes): a crash mid-pass."""

    def __init__(self, x, rows, fuse):
        self.inner = tload.NpzStream(x, rows)
        self.fuse = fuse
        self.yielded = 0

    def __call__(self):
        for batch in self.inner():
            if self.yielded >= self.fuse:
                raise RuntimeError("injected crash")
            self.yielded += 1
            yield batch


def _state(meta=None, key=None, cursor=0, n_iter=3):
    return tck.ClusterState(
        centroids=np.arange(12, dtype=np.float32).reshape(3, 4),
        n_iter=n_iter, key=key, batch_cursor=cursor,
        meta={"k": 3, "d": 4, **(meta or {})})


def _as_jax(monkeypatch):
    """Run the JAX package's save_checkpoint as a process of a gang of two
    does (the state.npz format), in this one process."""
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jmh, "barrier", lambda *a, **kw: None)


# ---------------------------------------------------------------------------
# The format, both ways
# ---------------------------------------------------------------------------


def test_port_save_restores_in_jax(tmp_path):
    d = str(tmp_path / "ck")
    meta = {"shift": 0.25, "history": np.ones((2, 2), np.float32),
            "acc_sums": torch.arange(8.0).reshape(2, 4), "model": "gmm",
            "spherical": True, "layout_n_devices": 2}
    tck.save_checkpoint(d, _state(meta, cursor=4), step=3)
    got = jck.restore_checkpoint(d)
    assert (got.n_iter, got.batch_cursor, got.key) == (3, 4, None)
    np.testing.assert_array_equal(np.asarray(got.centroids),
                                  np.arange(12, dtype=np.float32)
                                  .reshape(3, 4))
    mine = tck.restore_checkpoint(d)
    assert set(got.meta) == set(mine.meta) == {"k", "d", *meta}
    for name in mine.meta:
        np.testing.assert_array_equal(np.asarray(got.meta[name]),
                                      mine.meta[name])
    np.testing.assert_array_equal(mine.meta["acc_sums"],
                                  np.arange(8.0).reshape(2, 4))
    assert str(mine.meta["model"]) == "gmm" and bool(mine.meta["spherical"])
    with np.load(os.path.join(d, "step_00000003", "state.npz")) as z:
        plain = {n for n in z.files if not n.startswith("crc_")}
        assert {f"crc_{n}" for n in plain} <= set(z.files)
        assert not bool(z["has_key"])
        np.testing.assert_array_equal(z["key"], np.zeros(2, np.uint32))


@pytest.mark.parametrize("how", ["manual_save", "save_checkpoint"])
def test_jax_state_npz_restores_in_port(tmp_path, monkeypatch, how):
    d = str(tmp_path / "ck")
    key = np.asarray(jax.random.PRNGKey(7))
    meta = {"k": 3, "d": 4, "shift": 0.5,
            "history": np.full((3, 2), 2.0, np.float32)}
    centroids = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)
    if how == "manual_save":
        jck._manual_save(os.path.join(d, "step_00000005"), {
            "centroids": centroids, "n_iter": 5, "key": key,
            "has_key": True, "batch_cursor": 2, "meta": dict(meta)})
    else:
        _as_jax(monkeypatch)
        jck.save_checkpoint(d, jck.ClusterState(centroids, 5, key, 2, meta),
                            step=5)
    got = tck.restore_checkpoint(d)
    assert (got.n_iter, got.batch_cursor) == (5, 2)
    np.testing.assert_array_equal(got.centroids, centroids)
    np.testing.assert_array_equal(got.key, key)
    assert float(got.meta["shift"]) == 0.5 and int(got.meta["k"]) == 3
    np.testing.assert_array_equal(got.meta["history"], meta["history"])


def test_jax_orbax_step_raises_the_format_error(tmp_path):
    d = str(tmp_path / "ck")
    jck.save_checkpoint(d, jck.ClusterState(
        np.zeros((2, 2), np.float32), 1, None, 0, {"k": 2, "d": 2}), step=1)
    assert not os.path.exists(os.path.join(d, "step_00000001", "state.npz"))
    for call in (lambda: tck.restore_checkpoint(d),
                 lambda: tck.restore_checkpoint(d, step=1)):
        with pytest.raises(tck.CheckpointFormatError,
                           match="orbax checkpoint.*_manual_save"):
            call()
    # Never skipped for an older step either.
    tck.save_checkpoint(d, _state(n_iter=0), step=0)
    with pytest.raises(tck.CheckpointFormatError):
        tck.restore_checkpoint(d)


# ---------------------------------------------------------------------------
# Integrity and retention
# ---------------------------------------------------------------------------


def test_crc_corruption_falls_back_a_step(tmp_path):
    d = str(tmp_path / "ck")
    tck.save_checkpoint(d, _state(n_iter=3), step=3)
    tck.save_checkpoint(d, _state(n_iter=4), step=4)
    f = os.path.join(d, "step_00000004", "state.npz")
    with np.load(f) as z:
        data = {k: z[k] for k in z.files}
    data["centroids"] = np.full((3, 4), 666.0, np.float32)  # CRCs kept
    np.savez(f, **data)
    with pytest.raises(tck.CheckpointCorrupt, match="centroids"):
        tck.restore_checkpoint(d, step=4)
    assert tck.restore_checkpoint(d).n_iter == 3
    with pytest.raises(jck.CheckpointCorrupt, match="centroids"):
        jck.restore_checkpoint(d, step=4)


def test_truncated_newest_step_is_skipped(tmp_path):
    d = tmp_path / "ck"
    tck.save_checkpoint(str(d), _state(n_iter=3), step=3)
    (d / "step_00000004").mkdir()  # a crash before the first swap
    (d / "step_00000004" / "state.tmp-1234abcd.npz").write_bytes(b"x")
    assert tck.restore_checkpoint(str(d)).n_iter == 3
    assert tck.latest_step(str(d)) == 4


def test_unreadable_steps(tmp_path, capsys):
    one = tmp_path / "one" / "step_00000001"
    one.mkdir(parents=True)
    (one / "state.npz").write_bytes(b"garbage")
    assert tck.restore_checkpoint(str(one.parent)) is None
    assert "ckpt_step_unreadable" in capsys.readouterr().err
    with pytest.raises(Exception):
        tck.restore_checkpoint(str(one.parent), step=1)
    many = tmp_path / "many"
    for s in (1, 2, 3):
        (many / f"step_{s:08d}").mkdir(parents=True)
        (many / f"step_{s:08d}" / "state.npz").write_bytes(b"not a zip")
    with pytest.raises(RuntimeError, match="none could be loaded"):
        tck.restore_checkpoint(str(many))
    assert tck.restore_checkpoint(str(tmp_path / "nope")) is None


def test_keep_last_n_prunes_and_zero_is_refused(tmp_path):
    d = str(tmp_path / "ck")
    for step in range(1, 6):
        tck.save_checkpoint(d, _state(n_iter=step), step=step, keep_last_n=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    with pytest.raises(ValueError, match="keep_last_n must be >= 1 or None"):
        tck.save_checkpoint(d, _state(), step=6, keep_last_n=0)
    x, init = _blobs()
    d2 = str(tmp_path / "fit")
    tst.streamed_kmeans_fit(tload.NpzStream(x, 300), K, D, init=init,
                            max_iters=6, tol=-1.0, ckpt_dir=d2, ckpt_every=1,
                            ckpt_keep_last_n=3, device="cpu")
    assert sorted(os.listdir(d2)) == [f"step_{s:08d}" for s in (4, 5, 6)]


def test_layout_manifest_against_jax():
    assert trs.layout_meta(None) == jrs.layout_meta(
        jrs.MeshSpec.of(None)) == {
            "layout_n_devices": 1, "layout_n_processes": 1,
            "layout_n_data": 1, "layout_n_model": 1, "layout_hier": 0}
    meta = {k: np.asarray(v) for k, v in trs.layout_meta(None).items()}
    assert tuple(trs.layout_from_meta(meta)) == tuple(
        jrs.layout_from_meta(meta))
    assert trs.layout_from_meta({"k": 2}) is None
    m = trs.LayoutManifest(4, 4, 4, 1, 1)
    assert m.describe() == jrs.LayoutManifest(4, 4, 4, 1, 1).describe()


# ---------------------------------------------------------------------------
# Resume: the streamed fits
# ---------------------------------------------------------------------------


FITS = {
    "kmeans": (tst.streamed_kmeans_fit, jst.streamed_kmeans_fit, {}),
    "kmeans_spherical": (tst.streamed_kmeans_fit, jst.streamed_kmeans_fit,
                         {"spherical": True}),
    "kmeans_weighted": (tst.streamed_kmeans_fit, jst.streamed_kmeans_fit,
                        {"weighted": True}),
    "fuzzy": (tst.streamed_fuzzy_fit, jst.streamed_fuzzy_fit, {"m": 2.0}),
    "fuzzy_weighted": (tst.streamed_fuzzy_fit, jst.streamed_fuzzy_fit,
                       {"m": 1.7, "weighted": True}),
}


def _kw(case, stream_cls, prefetch=0):
    kw = dict(FITS[case][2])
    if kw.pop("weighted", False):
        kw["sample_weight_batches"] = stream_cls(_weights(), ROWS)
    if prefetch:
        kw["prefetch"] = prefetch
    return kw


@pytest.mark.parametrize("case, prefetch", [
    ("kmeans", 0), ("kmeans", 2), ("kmeans_spherical", 0),
    ("kmeans_weighted", 0), ("fuzzy", 0), ("fuzzy_weighted", 2)])
def test_kill_mid_pass_resume_is_bit_identical_and_jax_resumes_it(
        tmp_path, case, prefetch):
    tfit, jfit, _ = FITS[case]
    x, init = _blobs()
    common = dict(init=init, max_iters=8, tol=-1.0)
    full = tfit(tload.NpzStream(x, ROWS), K, D, device="cpu",
                **_kw(case, tload.NpzStream, prefetch), **common)
    d = str(tmp_path / "ck")
    ck = dict(ckpt_dir=d, ckpt_every=100, ckpt_every_batches=2)
    # The init reads the first batch once; then two whole passes (12) and
    # three batches of the third: the save after batch 2 holds cursor 2.
    with pytest.raises(RuntimeError, match="injected crash"):
        tfit(FusedStream(x, ROWS, 1 + 12 + 3), K, D, device="cpu",
             **_kw(case, tload.NpzStream, prefetch), **common, **ck)
    saved = tck.restore_checkpoint(d)
    assert (saved.n_iter, saved.batch_cursor) == (2, 2)
    assert int(saved.meta["acc_rows"]) == 2 * ROWS
    # The JAX streamed fit resumes from a copy of the port's mid-pass
    # checkpoint.
    jd = str(tmp_path / "jck")
    shutil.copytree(d, jd)
    jres = jfit(jload.NpzStream(x, ROWS), K, D,
                **_kw(case, jload.NpzStream), **common,
                **{**ck, "ckpt_dir": jd})
    res = tfit(tload.NpzStream(x, ROWS), K, D, device="cpu",
               **_kw(case, tload.NpzStream, prefetch), **common, **ck)
    assert torch.equal(res.centroids, full.centroids)
    np.testing.assert_array_equal(res.history, full.history)
    assert (res.n_iter, res.n_iter_run, res.converged) == (8, 6, False)
    assert (int(jres.n_iter), bool(jres.converged)) == (8, False)
    assert jres.n_iter_run == res.n_iter_run
    np.testing.assert_allclose(np.asarray(jres.centroids),
                               res.centroids.numpy(), rtol=RTOL, atol=1e-5)


def test_checkpointing_changes_no_result(tmp_path):
    x, init = _blobs()
    for tfit, kw in ((tst.streamed_kmeans_fit, {}),
                     (tst.streamed_fuzzy_fit, {"m": 2.0})):
        plain = tfit(tload.NpzStream(x, ROWS), K, D, init=init, max_iters=30,
                     tol=1e-4, device="cpu", **kw)
        d = str(tmp_path / tfit.__name__)
        with_ck = tfit(tload.NpzStream(x, ROWS), K, D, init=init,
                       max_iters=30, tol=1e-4, ckpt_dir=d, ckpt_every=2,
                       ckpt_every_batches=4, device="cpu", **kw)
        assert torch.equal(plain.centroids, with_ck.centroids)
        assert (plain.n_iter, plain.converged) == (with_ck.n_iter,
                                                   with_ck.converged)
        # A resume of the converged run runs nothing and reports it.
        again = tfit(tload.NpzStream(x, ROWS), K, D, init=init, max_iters=30,
                     tol=1e-4, ckpt_dir=d, device="cpu", **kw)
        assert torch.equal(again.centroids, plain.centroids)
        assert (again.n_iter, again.n_iter_run, again.converged) == (
            plain.n_iter, 0, True)
        np.testing.assert_array_equal(again.history, plain.history)


def test_resume_refusals_in_the_jax_words(tmp_path):
    x, init = _blobs()
    d = str(tmp_path / "ck")
    tst.streamed_kmeans_fit(tload.NpzStream(x, 300), K, D, init=init,
                            max_iters=2, tol=-1.0, ckpt_dir=d, device="cpu")
    # Each package on the port's checkpoint: the same words.
    for k, kw, words in (
            (5, {}, r"is for K=6, d=5, not \(5, 5\)"),
            (K, dict(spherical=True), "spherical=False; this run uses "
                                      "spherical=True — refusing to mix "
                                      "state"),
            (K, dict(weights=True), "weighted=False; this run uses "
                                    "weighted=True")):
        for fit, stream in ((tst.streamed_kmeans_fit, tload.NpzStream),
                            (jst.streamed_kmeans_fit, jload.NpzStream)):
            args = dict(init=init[:k], max_iters=4, tol=-1.0, ckpt_dir=d,
                        spherical=kw.get("spherical", False))
            if kw.get("weights"):
                args["sample_weight_batches"] = stream(_weights(), 300)
            if fit is tst.streamed_kmeans_fit:
                args["device"] = "cpu"
            with pytest.raises(ValueError, match=words):
                fit(stream(x, 300), k, D, **args)
    fd = str(tmp_path / "fz")
    tst.streamed_fuzzy_fit(tload.NpzStream(x, 300), K, D, m=2.0, init=init,
                           max_iters=2, tol=-1.0, ckpt_dir=fd, ckpt_every=1,
                           device="cpu")
    with pytest.raises(ValueError, match="m=2.0; this run uses m=3.0"):
        tst.streamed_fuzzy_fit(tload.NpzStream(x, 300), K, D, m=3.0,
                               init=init, max_iters=4, tol=-1.0, ckpt_dir=fd,
                               device="cpu")
    # The reduce checks: a quantized reduce needs ranks before ckpt_dir.
    with pytest.raises(ValueError, match="requires a multi-device mesh"):
        tst.streamed_fuzzy_fit(tload.NpzStream(x, 300), K, D, init=init,
                               reduce="per_pass:bf16", ckpt_dir=fd,
                               device="cpu")


def test_batch_layout_change_restarts_the_pass(tmp_path, capsys):
    x, init = _blobs()
    full = tst.streamed_kmeans_fit(tload.NpzStream(x, 100), K, D, init=init,
                                   max_iters=8, tol=-1.0, device="cpu")
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected crash"):
        tst.streamed_kmeans_fit(FusedStream(x, ROWS, 1 + 12 + 3), K, D,
                                init=init, max_iters=8, tol=-1.0, ckpt_dir=d,
                                ckpt_every=100, ckpt_every_batches=2,
                                device="cpu")
    # 100-row batches: the cursor (2) would skip 200 rows, but the saved
    # accumulator covers 400.
    res = tst.streamed_kmeans_fit(tload.NpzStream(x, 100), K, D, init=init,
                                  max_iters=8, tol=-1.0, ckpt_dir=d,
                                  ckpt_every=100, ckpt_every_batches=2,
                                  device="cpu")
    assert ("batch layout changed — restarting the interrupted pass from "
            "its beginning") in capsys.readouterr().err
    np.testing.assert_allclose(res.centroids.numpy(), full.centroids.numpy(),
                               rtol=RTOL, atol=1e-5)
    assert res.n_iter == 8


# ---------------------------------------------------------------------------
# Resume: mini-batch and the GMM
# ---------------------------------------------------------------------------


def test_minibatch_resume_with_reassignment_draws_is_bit_identical(
        tmp_path):
    x, _ = _blobs()
    kw = dict(init="kmeans++", epochs=4, tol=-1.0, reassignment_ratio=0.3,
              device="cpu", generator=torch.Generator().manual_seed(4))
    full = tmb.minibatch_kmeans_fit(tload.NpzStream(x, 100), K, D, **kw)
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected crash"):
        tmb.minibatch_kmeans_fit(
            FusedStream(x, 100, 12 + 5), K, D, ckpt_dir=d,
            **{**kw, "generator": torch.Generator().manual_seed(4)})
    saved = tck.restore_checkpoint(d)
    assert saved.n_iter == 1 and bool(saved.meta["minibatch"])
    assert str(saved.meta[tmb.GENERATOR_DEVICE_META]) == "cpu"
    # The generator passed now is not drawn from: the saved state is.
    res = tmb.minibatch_kmeans_fit(
        tload.NpzStream(x, 100), K, D, ckpt_dir=d,
        **{**kw, "generator": torch.Generator().manual_seed(99)})
    assert torch.equal(res.centroids, full.centroids)
    np.testing.assert_array_equal(res.history, full.history)
    assert (res.n_iter, res.n_iter_run) == (4, 3)
    assert float(res.sse) == float(full.sse)
    st = str(tmp_path / "st")
    tst.streamed_kmeans_fit(tload.NpzStream(x, 300), K, D, init=x[:K],
                            max_iters=1, ckpt_dir=st, device="cpu")
    with pytest.raises(ValueError, match="not a mini-batch state"):
        tmb.minibatch_kmeans_fit(tload.NpzStream(x, 100), K, D, ckpt_dir=st,
                                 device="cpu")
    with pytest.raises(ValueError, match=r"is for K=6, d=5, not \(4, 5\)"):
        tmb.minibatch_kmeans_fit(tload.NpzStream(x, 100), 4, D, ckpt_dir=d,
                                 device="cpu")


def test_minibatch_resumes_a_jax_checkpoint_that_draws_nothing(
        tmp_path, monkeypatch):
    from tdc_tpu.models import minibatch as jmb

    x, init = _blobs()
    d = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _as_jax(m)
        jmb.minibatch_kmeans_fit(jload.NpzStream(x, 100), K, D, init=init,
                                 epochs=2, tol=-1.0, reassignment_ratio=0.0,
                                 ckpt_dir=d, key=jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="threefry key"):
        tmb.minibatch_kmeans_fit(tload.NpzStream(x, 100), K, D, init=init,
                                 epochs=5, ckpt_dir=d, device="cpu")
    j = jmb.minibatch_kmeans_fit(jload.NpzStream(x, 100), K, D, init=init,
                                 epochs=4, tol=-1.0, reassignment_ratio=0.0)
    t = tmb.minibatch_kmeans_fit(tload.NpzStream(x, 100), K, D, init=init,
                                 epochs=4, tol=-1.0, reassignment_ratio=0.0,
                                 ckpt_dir=d, device="cpu")
    assert (t.n_iter, t.n_iter_run) == (4, 2)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    # Its own steps from that resume hold no generator state either.
    with pytest.raises(ValueError, match="holds no generator state"):
        tmb.minibatch_kmeans_fit(tload.NpzStream(x, 100), K, D, init=init,
                                 epochs=5, ckpt_dir=d, device="cpu")


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_gmm_resume_is_bit_identical_and_a_finished_run_is_a_no_op(
        tmp_path, cov):
    x, init = _blobs()
    kw = dict(init=init, tol=-1.0, covariance_type=cov, device="cpu")
    full = tgmm.streamed_gmm_fit(tload.NpzStream(x, 300), K, D, max_iters=6,
                                 **kw)
    d = str(tmp_path / "ck")
    # The seeding reads the first batch; then two passes (8) and two
    # batches of the third: the per-iteration step 2 is on disk.
    with pytest.raises(RuntimeError, match="injected crash"):
        tgmm.streamed_gmm_fit(FusedStream(x, 300, 1 + 8 + 2), K, D,
                              max_iters=6, ckpt_dir=d, ckpt_every=1, **kw)
    saved = tck.restore_checkpoint(d)
    assert saved.n_iter == 2 and str(saved.meta["cov_type"]) == cov
    res = tgmm.streamed_gmm_fit(tload.NpzStream(x, 300), K, D, max_iters=6,
                                ckpt_dir=d, ckpt_every=1, **kw)
    for name in ("means", "variances", "weights"):
        assert torch.equal(getattr(res, name), getattr(full, name)), name
    assert float(res.log_likelihood) == float(full.log_likelihood)
    assert (res.n_iter, res.n_iter_run) == (6, 4)
    assert "final_ll" in tck.restore_checkpoint(d).meta
    again = tgmm.streamed_gmm_fit(FusedStream(x, 300, 0), K, D, max_iters=6,
                                  ckpt_dir=d, **kw)
    assert (again.n_iter, again.n_iter_run) == (6, 0)
    assert float(again.log_likelihood) == float(full.log_likelihood)
    assert torch.equal(again.means, full.means)
    # The JAX package's checks, in its words.
    for extra, words in ((dict(reg_covar=1e-3), "reg_covar=1e-06"),
                         (dict(covariance_type="tied"),
                          f"covariance_type='{cov}', requested 'tied'"),
                         (dict(sample_weight_batches=tload.NpzStream(
                             _weights(), 300)), "weighted=False")):
        with pytest.raises(ValueError, match=words):
            tgmm.streamed_gmm_fit(tload.NpzStream(x, 300), K, D,
                                  max_iters=8, ckpt_dir=d,
                                  **{**kw, **extra})
    km = str(tmp_path / "km")
    tst.streamed_kmeans_fit(tload.NpzStream(x, 300), K, D, init=init,
                            max_iters=1, ckpt_dir=km, device="cpu")
    with pytest.raises(ValueError, match="not a GMM checkpoint"):
        tgmm.streamed_gmm_fit(tload.NpzStream(x, 300), K, D, max_iters=8,
                              ckpt_dir=km, **kw)


# ---------------------------------------------------------------------------
# Persistence: a checkpoint directory as a fitted model
# ---------------------------------------------------------------------------


def test_load_fitted_on_a_port_checkpoint_in_both_packages(tmp_path):
    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.models import persist as jper
    from tdc_tpu.models.gmm import gmm_predict as jgmm_predict
    from tdc_tpu.models.kmeans import kmeans_predict as jpredict
    from tdc_tpu_torch.models.gmm import gmm_predict as tgmm_predict
    from tdc_tpu_torch.models.kmeans import kmeans_predict as tpredict

    x, init = _blobs()
    dirs = {name: str(tmp_path / name) for name in ("km", "fz", "gmm")}
    tst.streamed_kmeans_fit(tload.NpzStream(x, 300), K, D, init=init,
                            max_iters=3, ckpt_dir=dirs["km"], device="cpu")
    tst.streamed_fuzzy_fit(tload.NpzStream(x, 300), K, D, m=1.5, init=init,
                           max_iters=3, ckpt_dir=dirs["fz"], device="cpu")
    tgmm.streamed_gmm_fit(tload.NpzStream(x, 300), K, D, init=init,
                          max_iters=3, ckpt_dir=dirs["gmm"], device="cpu")
    for name, model in (("km", "kmeans"), ("fz", "fuzzy"), ("gmm", "gmm")):
        t, j = tper.load_fitted(dirs[name]), jper.load_fitted(dirs[name])
        assert (t.model, t.k, t.d, t.version) == (model, K, D,
                                                  "ckpt-step-3")
        assert (j.model, j.k, j.d, j.version) == (t.model, t.k, t.d,
                                                  t.version)
        assert t.params == j.params
        for a in t.arrays:
            np.testing.assert_array_equal(t.arrays[a], np.asarray(
                j.arrays[a]))
        if model == "gmm":
            fitted = {n: t.arrays[n] for n in ("means", "variances",
                                                "weights")}
            tl = tgmm_predict(torch.from_numpy(x), tgmm.GMMResult(
                **{n: torch.from_numpy(a) for n, a in fitted.items()},
                n_iter=3, log_likelihood=torch.tensor(0.0), converged=False,
                covariance_type=t.params["covariance_type"]))
            jl = jgmm_predict(x, jgmm.GMMResult(
                **fitted, n_iter=3, log_likelihood=0.0, converged=False,
                covariance_type=j.params["covariance_type"]))
        else:
            tl = tpredict(torch.from_numpy(x), torch.from_numpy(t.centroids),
                          device="cpu")
            jl = jpredict(x, j.centroids)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tper.manifest_fingerprint(dirs[name])[:2] == ("ckpt", 3)
        assert tper.manifest_fingerprint(dirs[name]) == \
            jper.manifest_fingerprint(dirs[name])
    assert tper.load_fitted(dirs["km"], model="fuzzy").model == "fuzzy"


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def npy(tmp_path_factory):
    x, _ = _blobs(3, n=3000, k=12, d=8)
    path = tmp_path_factory.mktemp("ck_cli") / "data.npy"
    np.save(path, x)
    return str(path)


def _row(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


CLI = ["--K=12", "--init=first_k", "--tol=-1", "--n_max_iters=4",
       "--seed=7", "--device", "cpu"]


@pytest.mark.parametrize("flags, words", [
    (["--ckpt_dir=ck", "--mean_combine"],
     "--ckpt_dir is not supported with --mean_combine"),
    (["--ckpt_keep_last_n=0", "--ckpt_dir=ck"],
     "--ckpt_keep_last_n must be >= 1"),
    (["--ckpt_keep_last_n=2"], "--ckpt_keep_last_n requires --ckpt_dir"),
    (["--ckpt_keep_last_n=2", "--ckpt_dir=ck", "--minibatch"],
     "--ckpt_keep_last_n applies to the 1-D streamed kmeans/fuzzy fits only"),
    (["--ckpt_keep_last_n=2", "--ckpt_dir=ck",
      "--method_name=gaussianMixture"],
     "--ckpt_keep_last_n applies to the 1-D streamed kmeans/fuzzy fits only"),
    (["--ckpt_every_batches=2", "--ckpt_dir=ck",
      "--method_name=gaussianMixture"],
     "gaussianMixture checkpoints per iteration only "
     "(--ckpt_every_batches is kmeans/fuzzy)"),
    (["--ckpt_dir=ck", "--method_name=bisectingKMeans", "--init=kmeans++"],
     "bisectingKMeans does not checkpoint"),
    (["--ckpt_every_batches=2"], "--ckpt_every_batches requires --ckpt_dir"),
    (["--ckpt_every_batches=0", "--ckpt_dir=ck"],
     "--ckpt_every_batches must be >= 1"),
    (["--ckpt_every_batches=2", "--ckpt_dir=ck", "--minibatch"],
     "--minibatch checkpoints per epoch only"),
    (["--ckpt_dir=ck", "--layout=features"],
     "--ckpt_dir is not supported with it"),
    (["--ckpt_dir=ck", "--ckpt_keep_last_n=2",
      "--method_name=distributedFuzzyCMeans", "--shard_k=2", "--n_GPUs=2"],
     "--ckpt_keep_last_n applies to the 1-D streamed kmeans/fuzzy fits "
     "only"),
], ids=["mean_combine", "keep0", "keep_no_dir", "keep_minibatch", "keep_gmm",
        "gmm_batches", "bisecting", "batches_no_dir", "batches0",
        "minibatch_batches", "features", "shard_k"])
def test_cli_checkpoint_refusals(npy, flags, words, capsys, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2" if "--n_GPUs=2" in flags else "1")
    with pytest.raises(SystemExit) as exc:
        tcli.main([*CLI, f"--data_file={npy}", *flags])
    assert exc.value.code == 2
    assert words in capsys.readouterr().err


@pytest.mark.parametrize("method", ["distributedKMeans",
                                    "distributedFuzzyCMeans",
                                    "gaussianMixture", "minibatch"])
def test_cli_checkpointed_row_and_rerun(npy, tmp_path, method):
    flags = (["--minibatch", "--num_batches=3"] if method == "minibatch"
             else [f"--method_name={method}", "--num_batches=3"])
    plain, ck = tmp_path / "plain.csv", tmp_path / "ck.csv"
    args = [*CLI, f"--data_file={npy}", *flags]
    assert tcli.main([*args, f"--log_file={plain}"]) == 0
    d = str(tmp_path / "ck")
    if method == "distributedKMeans":
        args.append("--ckpt_every_batches=2")
    assert tcli.main([*args, f"--log_file={ck}", f"--ckpt_dir={d}"]) == 0
    assert tcli.main([*args, f"--log_file={ck}", f"--ckpt_dir={d}"]) == 0
    p, (first, rerun) = _row(plain)[0], _row(ck)
    for row in (first, rerun):
        assert (row["sse"], row["n_iter"], row["status"]) == (
            p["sse"], p["n_iter"], "ok")
        # One fit: its time is the computation's.
        assert row["computation_time"] == row["initialization_time"]
    assert (first["n_iter_run"], rerun["n_iter_run"]) == ("4", "0")
    assert float(rerun["points_per_sec_per_chip"]) == 0.0
    assert tck.latest_step(d) == 4
    # Without --num_batches a checkpointed fit streams its one batch.
    one = tmp_path / "one.csv"
    assert tcli.main([*CLI, f"--data_file={npy}", f"--log_file={one}",
                      f"--ckpt_dir={tmp_path / 'one'}",
                      *[f for f in flags if not f.startswith(
                          ("--num_batches", "--ckpt_every"))]]) == 0
    assert _row(one)[0]["num_batches"] == "1"
    assert tck.latest_step(str(tmp_path / "one")) == 4


# ---------------------------------------------------------------------------
# Gangs: two ranks on gloo
# ---------------------------------------------------------------------------


def _gang_job(tmp):
    """On each rank: a per_batch fit killed mid-pass and resumed against
    the uninterrupted fit; a per-pass fit saved per iteration; a
    preemption flag raised on rank 1 alone; a 2-rank save for a 1-rank
    resume (in the parent)."""
    out = {}
    rank = tmh.process_index()
    x, init = _blobs()
    mesh = tmesh.make_mesh(2)
    common = dict(init=init, max_iters=6, tol=-1.0, mesh=mesh, device="cpu")
    full = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, **common)
    out["full"] = full.centroids.numpy()
    # Rank 0's explicit init is every rank's; the broadcast leaves the
    # caller's array as it was.
    mine = init + np.float32(rank)
    tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D,
                            **{**common, "init": mine, "max_iters": 1})
    out["init_kept"] = bool(np.array_equal(mine, init + np.float32(rank)))
    d = os.path.join(tmp, "gang")
    ck = dict(ckpt_dir=d, ckpt_every=100, ckpt_every_batches=2)
    try:
        tst.streamed_kmeans_fit(FusedStream(x, ROWS, 1 + 12 + 3), K, D,
                                **common, **ck)
    except RuntimeError as e:
        out["crash"] = str(e)
    saved = tck.restore_checkpoint(d)
    out["saved"] = (saved.n_iter, saved.batch_cursor,
                    int(saved.meta["layout_n_devices"]))
    res = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, **common,
                                  **ck)
    out["resumed"] = res.centroids.numpy()
    out["n_iter_run"] = res.n_iter_run
    out["steps"] = sorted(os.listdir(d))
    # Per iteration under per_pass (mid-pass saves are refused there).
    pd = os.path.join(tmp, "per_pass")
    tst.streamed_fuzzy_fit(tload.NpzStream(x, ROWS), K, D, ckpt_dir=pd,
                           ckpt_every=1, reduce="per_pass",
                           **{**common, "max_iters": 3})
    pres = tst.streamed_fuzzy_fit(tload.NpzStream(x, ROWS), K, D,
                                  ckpt_dir=pd, reduce="per_pass",
                                  **{**common, "max_iters": 5})
    pfull = tst.streamed_fuzzy_fit(tload.NpzStream(x, ROWS), K, D,
                                   reduce="per_pass", **{**common,
                                                         "max_iters": 5})
    out["per_pass"] = (pres.n_iter_run,
                       bool(torch.equal(pres.centroids, pfull.centroids)))
    try:
        tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, ckpt_dir=pd,
                                ckpt_every_batches=2, reduce="per_pass",
                                **common)
    except ValueError as e:
        out["per_pass_refusal"] = str(e)
    # Rank 1 alone raises the flag mid-pass 2: both ranks stop after it.
    preempt.install_preemption_handler()

    def _batches(s):
        for i in range(s.num_batches):
            yield tload.NpzStream.read_batch(s, i)

    class Flagging(tload.NpzStream):
        passes = 0
        # Iterate only (no ranged reads through the ingest guard), so
        # every pass calls __call__.
        read_batch = None

        def __call__(self):
            Flagging.passes += 1
            for i, b in enumerate(_batches(self)):
                if rank == 1 and Flagging.passes == 3 and i == 2:
                    preempt.request()
                yield b

    qd = os.path.join(tmp, "preempt")
    try:
        tst.streamed_kmeans_fit(Flagging(x, ROWS), K, D, ckpt_dir=qd,
                                ckpt_every=100, **common)
        out["preempted"] = None
    except preempt.Preempted as e:
        out["preempted"] = (str(e), e.code)
    finally:
        preempt.reset()
    out["preempt_step"] = tck.latest_step(qd)
    # A 2-rank per-iteration save for the parent's 1-rank resume.
    tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D,
                            ckpt_dir=os.path.join(tmp, "resize"),
                            ckpt_every=1, **{**common, "max_iters": 3})
    return out


def _rank_main(rank, world, init_method, tmp, queue):
    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        queue.put((rank, _gang_job(tmp)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        tmh.shutdown()


def _spawn(tmp, world=2, timeout=240):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, tmp, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    # The wait's deadline: it never reaches a checkpoint.
    deadline = time.monotonic() + timeout  # tdclint: disable=TDC007
    try:
        while len(results) < world:
            try:
                rank, out = queue.get(timeout=2)
                results[rank] = out
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                late = time.monotonic() > deadline  # tdclint: disable=TDC007
                if dead or late:
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


def test_two_rank_gang_saves_once_resumes_and_preempts_together(tmp_path,
                                                                capsys):
    ranks = _spawn(str(tmp_path))
    for out in ranks:
        assert out["crash"] == "injected crash" and out["init_kept"]
        assert out["saved"] == (2, 2, 2)
        np.testing.assert_array_equal(out["resumed"], out["full"])
        assert out["n_iter_run"] == 4
        assert out["per_pass"] == (2, True)
        assert "does not support mid-pass checkpointing" in out[
            "per_pass_refusal"]
        assert out["preempted"] == ("preempted after iteration 2", 75)
        assert out["preempt_step"] == 2
    np.testing.assert_array_equal(ranks[0]["full"], ranks[1]["full"])
    assert ranks[0]["steps"] == ranks[1]["steps"]
    # No tmp file of a second writer is left in any step.
    gang = tmp_path / "gang"
    for step in ranks[0]["steps"]:
        assert os.listdir(gang / step) == ["state.npz"]
    # The 2-rank save resumes on one rank: the same run as a 1-rank fit
    # from the saved centroids, bit for bit, after one resize event.
    x, _ = _blobs()
    saved = tck.restore_checkpoint(str(tmp_path / "resize"))
    assert (saved.n_iter, int(saved.meta["layout_n_devices"])) == (3, 2)
    capsys.readouterr()
    res = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D,
                                  init=x[:K], max_iters=6, tol=-1.0,
                                  ckpt_dir=str(tmp_path / "resize"),
                                  device="cpu")
    assert "reshard_redistribute" in capsys.readouterr().err
    one = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D,
                                  init=saved.centroids, max_iters=3,
                                  tol=-1.0, device="cpu")
    assert (res.n_iter, res.n_iter_run) == (6, 3)
    assert torch.equal(res.centroids, one.centroids)
