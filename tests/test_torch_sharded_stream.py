"""The port's streamed K-sharded towers (`parallel/sharded_k.py`:
`streamed_kmeans_fit_sharded`, `streamed_fuzzy_fit_sharded`, their
gathered checkpoints and the ingest guard) against the JAX package's, on
the CPU.

Two groups of gloo ranks, 2 as a (1, 2) grid and 4 as a (2, 2) grid,
each spawned once per test run (the first test worker that needs a group
starts it through a `file://` store and keeps its numpy results on disk
for the others, `test_torch_reduce.shared_groups`), run every check of
their world size; the JAX towers run here on the conftest's 8 virtual
devices from the same seeded numpy batches (tests/test_sharded_k.py's
1600 x 6 blobs, K=8, 300-row batches: five full and a ragged 100-row
one) and the same explicit init, with their Pallas kernels in interpret
mode where the port runs B2 + B3 (K-Means) and B7 + B8 (fuzzy) as their
plain versions.

Tolerances (float32 sums in another order across ranks than across
devices; the port pads nothing, the JAX towers pad each batch with zero
rows and subtract them): equal n_iter and converged; centroids within
1e-5 (rtol 1e-5); the cost rtol 1e-5, plus, for K-Means, atol 1e-5 of
Σ‖x‖² (the port sums shifted minima and adds Σ‖x‖², the JAX streamed
tower sums clamped distances); the labels of every row at the two fits'
centroids equal except where the two nearest centroids lie within 1e-4
(relative) of each other; the history's costs rtol 1e-5 and atol 1e-5
of Σ‖x‖² (an iteration in flight carries the centroids' f32 differences
into its cost, each d² in the expanded form rounding at ‖x‖²). bf16 rows:
the same, the JAX tower's bf16 staging and the port's host cast giving
the same rows. The comms report's counts and bytes equal JAX's exactly.
On one batch per_batch is bitwise the in-memory tower
(`kmeans_fit_sharded`, `fuzzy_fit_sharded` up to its objective's sum
order), a killed and resumed fit bitwise the uninterrupted one, and a
fit over a stream with one bad batch (a NaN in one data rank's rows)
bitwise the fit over the stream without it, on every rank.
"""

import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_checkpoint import FusedStream, _as_jax
from test_torch_reduce import same_on_every_rank, shared_groups, spawn_ranks

from tdc_tpu.data import loader as jload
from tdc_tpu.parallel import sharded_k as jsk
from tdc_tpu_torch.data import loader as tload
from tdc_tpu_torch.data.ingest import IngestPolicy
from tdc_tpu_torch.parallel import multihost as tmh
from tdc_tpu_torch.parallel import sharded_k as tsk
from tdc_tpu_torch.utils import checkpoint as tck

RTOL = 1e-5
N, K, D = 1600, 8, 6
ROWS = 300  # 5 full batches and a ragged 100-row one
CK_ROWS = 400  # the checkpoint runs: 4 batches a pass
GRIDS = {2: (1, 2), 4: (2, 2)}
MAX_ITERS, TOL = 10, 1e-4
NEAR_TIE = 1e-4
RESIDENCY = ("hbm", "spill", "auto")

KMEANS_CASES = {
    "per_batch_xla": {},
    "per_pass_xla": {"reduce": "per_pass"},
    "per_batch_pallas": {"kernel": "pallas"},
    "per_pass_pallas": {"kernel": "pallas", "reduce": "per_pass"},
    "spherical_blocked": {"spherical": True, "block_rows": 64},
    "bf16_xla": {"dtype": "bf16"},
    "bf16_pallas": {"kernel": "pallas", "dtype": "bf16"},
}
FUZZY_CASES = {
    "per_batch_xla": {},
    "per_pass_xla": {"reduce": "per_pass"},
    "per_batch_pallas": {"kernel": "pallas"},
    "per_pass_pallas": {"kernel": "pallas", "reduce": "per_pass"},
    "blocked": {"block_rows": 64},
    "bf16_pallas": {"kernel": "pallas", "dtype": "bf16", "rows": 299},
}


def _data():
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=10, size=(8, 6)).astype(np.float32)
    x = (centers[rng.integers(0, 8, N)]
         + rng.normal(size=(N, D)).astype(np.float32)).astype(np.float32)
    return x, x[:K].copy()


def _sum_sq(x) -> float:
    return float((x.astype(np.float64) ** 2).sum())


def _kw(case: dict, package: str) -> dict:
    """A case's keywords for one package: 'bf16' as its dtype."""
    kw = {k: v for k, v in case.items() if k != "rows"}
    if kw.get("dtype") == "bf16":
        kw["dtype"] = torch.bfloat16 if package == "port" else jnp.bfloat16
    return kw


def _out(res, cost: str) -> dict:
    return {"centroids": res.centroids.cpu().numpy(),
            "n_iter": int(res.n_iter), "converged": bool(res.converged),
            "cost": float(getattr(res, cost)),
            "history": np.asarray(res.history),
            "comms": res.comms._asdict(), "n_iter_run": res.n_iter_run}


def _fits(mesh, x, init) -> dict:
    out = {}
    for name, case in KMEANS_CASES.items():
        out["kmeans", name] = _out(tsk.streamed_kmeans_fit_sharded(
            tload.NpzStream(x, ROWS), K, D, mesh, init=init,
            max_iters=MAX_ITERS, tol=TOL, device="cpu",
            **_kw(case, "port")), "sse")
    for name, case in FUZZY_CASES.items():
        out["fuzzy", name] = _out(tsk.streamed_fuzzy_fit_sharded(
            tload.NpzStream(x, case.get("rows", ROWS)), K, D, mesh,
            init=init, max_iters=MAX_ITERS, tol=TOL, device="cpu",
            **_kw(case, "port")), "objective")
    # A non-finite value in batch 2 (in the rows of data rank 0): every
    # rank drops the batch, and the fit is the fit without it, bitwise.
    bad = x.copy()
    bad[2 * ROWS + 5, 3] = np.nan
    rest = np.delete(x, np.s_[2 * ROWS:3 * ROWS], axis=0)
    policy = IngestPolicy(max_bad_fraction=0.5)
    for name, fit, reduce in (
            ("kmeans", tsk.streamed_kmeans_fit_sharded, "per_batch"),
            ("kmeans", tsk.streamed_kmeans_fit_sharded, "per_pass"),
            ("fuzzy", tsk.streamed_fuzzy_fit_sharded, "per_batch")):
        kw = dict(init=init, max_iters=4, tol=-1, reduce=reduce,
                  kernel="pallas", device="cpu")
        q = fit(tload.NpzStream(bad, ROWS), K, D, mesh, ingest=policy, **kw)
        ref = fit(tload.NpzStream(rest, ROWS), K, D, mesh, **kw)
        out["quarantine", name, reduce] = (
            torch.equal(q.centroids, ref.centroids),
            q.ingest.quarantined_batches, q.ingest.quarantined_rows)
    # Residency: each mode of both towers against its 'stream' twin above.
    for (tower, case), fit, cost in (
            (("kmeans", "per_batch_pallas"), tsk.streamed_kmeans_fit_sharded,
             "sse"),
            (("kmeans", "per_pass_xla"), tsk.streamed_kmeans_fit_sharded,
             "sse"),
            (("fuzzy", "per_batch_pallas"), tsk.streamed_fuzzy_fit_sharded,
             "objective"),
            (("fuzzy", "per_pass_xla"), tsk.streamed_fuzzy_fit_sharded,
             "objective")):
        kw = _kw((KMEANS_CASES if tower == "kmeans" else FUZZY_CASES)[case],
                 "port")
        for mode in RESIDENCY:
            res = fit(tload.NpzStream(x, ROWS), K, D, mesh, init=init,
                      max_iters=MAX_ITERS, tol=TOL, device="cpu",
                      residency=mode, **kw)
            # The ring's staging count runs ahead by its own timing.
            out["residency", tower, case, mode] = (
                _out(res, cost), None if res.h2d is None
                else res.h2d.batches > 0)
    # One batch under per_batch: the in-memory towers' bits.
    for kern in ("xla", "pallas"):
        a = tsk.streamed_kmeans_fit_sharded(
            tload.NpzStream(x, N), K, D, mesh, init=init, max_iters=5,
            tol=-1, kernel=kern, device="cpu")
        b = tsk.kmeans_fit_sharded(x, K, mesh, init=init, max_iters=5,
                                   tol=-1, kernel=kern, device="cpu")
        out["one_batch", "kmeans", kern] = (
            torch.equal(a.centroids, b.centroids), float(a.sse),
            float(b.sse), np.asarray(a.history), np.asarray(b.history))
        a = tsk.streamed_fuzzy_fit_sharded(
            tload.NpzStream(x, N), K, D, mesh, init=init, max_iters=5,
            tol=-1, kernel=kern, block_rows=N, device="cpu")
        b = tsk.fuzzy_fit_sharded(x, K, mesh, init=init, max_iters=5,
                                  tol=-1, kernel=kern, block_rows=N,
                                  device="cpu")
        out["one_batch", "fuzzy", kern] = (
            torch.equal(a.centroids, b.centroids),
            float(a.objective), float(b.objective))
    return out


class _OnePass:
    """NpzStream whose iteration raises once the explicit init's read and
    one full pass are done: an 'hbm' fit must never read it again. It
    iterates only (no ranged `read_batch` for the ingest guard), so every
    read passes __call__."""

    def __init__(self, x, rows):
        self.inner = tload.NpzStream(x, rows)
        self.calls = 0

    def __getattr__(self, name):
        if name == "read_batch":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __call__(self):
        self.calls += 1
        if self.calls > 2:
            raise AssertionError("the stream was read after the fill pass")
        return self.inner()


def _residency_checks(mesh, x, init, d) -> dict:
    """'hbm' over a stream that raises when read after pass 1; model rank
    1 unable to fill (the gang streams, bitwise); an 'hbm' fit killed in
    its 3rd cached pass (iteration 4) and resumed from its per-iteration
    save: bitwise the uninterrupted 'stream' fit."""
    import unittest.mock as mock

    from tdc_tpu_torch.data import device_cache as cache_lib
    from tdc_tpu_torch.models import streaming as tst

    out = {}
    kw = dict(init=init, max_iters=5, tol=-1.0, kernel="pallas",
              device="cpu")
    for name, fit in (("kmeans", tsk.streamed_kmeans_fit_sharded),
                      ("fuzzy", tsk.streamed_fuzzy_fit_sharded)):
        ref = fit(tload.NpzStream(x, ROWS), K, D, mesh, **kw)
        stream = _OnePass(x, ROWS)
        res = fit(stream, K, D, mesh, residency="hbm", **kw)
        out["one_pass", name] = (stream.calls, torch.equal(res.centroids,
                                                           ref.centroids))
        events = []
        real_add = cache_lib.DeviceCacheBuilder.add

        def add(self, xb, n_valid, wb=None):
            if mesh.axis_index(tsk.MODEL_AXIS) == 1:
                self.abandon("hbm_oom_during_fill")
                return
            real_add(self, xb, n_valid, wb)

        record = (lambda event, **f: events.append((event, f.get("reason"))))
        with mock.patch.object(cache_lib.DeviceCacheBuilder, "add", add), \
                mock.patch.object(cache_lib, "emit", record), \
                mock.patch.object(tst, "emit", record):
            res = fit(tload.NpzStream(x, ROWS), K, D, mesh, residency="hbm",
                      **kw)
        out["abandoned", name] = (
            torch.equal(res.centroids, ref.centroids),
            [e for e in events if e[0] == "residency_cache_abandoned"])
    ref = tsk.streamed_kmeans_fit_sharded(tload.NpzStream(x, ROWS), K, D,
                                          mesh, **kw)
    real_cached = tst._Pass.run_cached
    calls = []

    def crashing(self, params, cache):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected crash")
        return real_cached(self, params, cache)

    crash = ""
    with mock.patch.object(tst._Pass, "run_cached", crashing):
        try:
            tsk.streamed_kmeans_fit_sharded(
                tload.NpzStream(x, ROWS), K, D, mesh, residency="hbm",
                ckpt_dir=d, ckpt_every=1, **kw)
        except RuntimeError as e:
            crash = str(e)
    saved = tck.restore_checkpoint(d).n_iter
    res = tsk.streamed_kmeans_fit_sharded(
        tload.NpzStream(x, ROWS), K, D, mesh, residency="hbm", ckpt_dir=d,
        ckpt_every=1, **kw)
    out["hbm_kill"] = (crash, saved, res.n_iter_run,
                       torch.equal(res.centroids, ref.centroids),
                       float(res.sse) == float(ref.sse))
    return out


def _kill_and_resume(fit, mesh, x, init, d):
    """The uninterrupted 5-iteration fit, a fit killed in pass 3 (its
    mid-pass checkpoint every 2 batches: cursor 2 on disk) and the
    resumed one, bitwise."""
    kw = dict(init=init, max_iters=5, tol=-1.0, device="cpu")
    full = fit(tload.NpzStream(x, CK_ROWS), K, D, mesh, **kw)
    ck = dict(ckpt_dir=d, ckpt_every=100, ckpt_every_batches=2)
    # The explicit init reads batch 0 once; pass 3's batch 3 raises.
    crash = ""
    try:
        fit(FusedStream(x, CK_ROWS, 1 + 8 + 2), K, D, mesh, **kw, **ck)
    except RuntimeError as e:
        crash = str(e)
    saved = tck.restore_checkpoint(d)
    resumed = fit(tload.NpzStream(x, CK_ROWS), K, D, mesh, **kw, **ck)
    return (crash, (saved.n_iter, saved.batch_cursor),
            torch.equal(resumed.centroids, full.centroids),
            resumed.n_iter_run)


def _ckpt_job(tmp, x, init) -> dict:
    """On the (1, 2) grid: kill and resume, both towers; a per-iteration
    save (3 iterations) resumed to 6 on a (2, 1) grid, against a (2, 1)
    fit from the saved centroids (bitwise), and left for the parent's
    1x1 resume; per_pass with ckpt_every_batches refused."""
    out = {}
    mesh = tsk.make_mesh_2d(1, 2)
    other = tsk.make_mesh_2d(2, 1)
    kw = dict(init=init, tol=-1.0, device="cpu")
    for name, fit in (("kmeans", tsk.streamed_kmeans_fit_sharded),
                      ("fuzzy", tsk.streamed_fuzzy_fit_sharded)):
        out["kill", name] = _kill_and_resume(
            fit, mesh, x, init, os.path.join(tmp, f"kill_{name}"))
        d = os.path.join(tmp, f"resize_{name}")
        fit(tload.NpzStream(x, CK_ROWS), K, D, mesh, max_iters=3,
            ckpt_dir=d, **kw)
        saved = tck.restore_checkpoint(d)
        # The (2, 1) resume writes its steps into a copy: the parent
        # resumes the save itself.
        if tmh.process_index() == 0:
            shutil.copytree(d, d + "_2x1")
        tmh.barrier()
        res = fit(tload.NpzStream(x, CK_ROWS), K, D, other, max_iters=6,
                  ckpt_dir=d + "_2x1", **kw)
        ref = fit(tload.NpzStream(x, CK_ROWS), K, D, other, max_iters=3,
                  **{**kw, "init": saved.centroids})
        out["resize", name] = (
            res.n_iter, res.n_iter_run,
            torch.equal(res.centroids, ref.centroids),
            saved.meta["layout_n_data"], saved.meta["layout_n_model"], d)
        try:
            fit(tload.NpzStream(x, CK_ROWS), K, D, mesh, max_iters=2,
                ckpt_dir=os.path.join(tmp, "pp"), ckpt_every_batches=2,
                reduce="per_pass", **kw)
            out["per_pass_ckpt", name] = None
        except ValueError as e:
            out["per_pass_ckpt", name] = str(e)
    return out


def _job(world, tmp):
    x, init = _data()
    mesh = tsk.make_mesh_2d(*GRIDS[world])
    out = _fits(mesh, x, init)
    out.update(_residency_checks(mesh, x, init,
                                 os.path.join(tmp, f"hbm_kill_{world}")))
    if world == 2:
        out.update(_ckpt_job(tmp, x, init))
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    def make(tmp):
        return {w: spawn_ranks(tmp, w, _job, (str(tmp),)) for w in (2, 4)}

    return shared_groups(tmp_path_factory, "torch_sharded_stream_ranks",
                         make)


def _jax_fit(tower, grid, case, x, init):
    fit = (jsk.streamed_kmeans_fit_sharded if tower == "kmeans"
           else jsk.streamed_fuzzy_fit_sharded)
    return fit(jload.NpzStream(x, case.get("rows", ROWS)), K, D,
               jsk.make_mesh_2d(*grid), init=init, max_iters=MAX_ITERS,
               tol=TOL, **_kw(case, "jax"))


def _far_label_flips(x, a, b) -> int:
    """Rows whose labels at centroids a and b differ, less those whose
    two nearest centroids (at either set) lie within NEAR_TIE of each
    other."""
    xf = x.astype(np.float64)
    labels, ties = [], []
    for c in (a, b):
        d2 = ((xf[:, None, :] - np.asarray(c, np.float64)[None]) ** 2).sum(-1)
        two = np.sort(d2, axis=1)[:, :2]
        labels.append(d2.argmin(axis=1))
        ties.append((two[:, 1] - two[:, 0]) <= NEAR_TIE * two[:, 1])
    return int(((labels[0] != labels[1]) & ~(ties[0] | ties[1])).sum())


@pytest.mark.parametrize("case", list(KMEANS_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_streamed_kmeans_fit_sharded_against_the_jax_tower(groups, world,
                                                            case):
    x, init = _data()
    got = same_on_every_rank(groups[world], ("kmeans", case))
    kw = KMEANS_CASES[case]
    j = _jax_fit("kmeans", GRIDS[world], kw, x, init)
    xs = (x / np.linalg.norm(x, axis=1, keepdims=True)
          if kw.get("spherical") else x)
    if kw.get("dtype"):
        xs = xs.astype(ml_dtypes.bfloat16).astype(np.float32)
    cost_atol = 1e-5 * _sum_sq(xs)
    assert (got["n_iter"], got["converged"]) == (int(j.n_iter),
                                                 bool(j.converged))
    np.testing.assert_allclose(got["centroids"], np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got["cost"], float(j.sse), rtol=RTOL,
                               atol=cost_atol)
    np.testing.assert_allclose(got["history"][:, 0],
                               np.asarray(j.history)[:, 0], rtol=RTOL,
                               atol=cost_atol)
    assert _far_label_flips(xs, got["centroids"], j.centroids) == 0
    assert tuple(got["comms"].values()) == tuple(j.comms)


@pytest.mark.parametrize("case", list(FUZZY_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_streamed_fuzzy_fit_sharded_against_the_jax_tower(groups, world,
                                                           case):
    x, init = _data()
    got = same_on_every_rank(groups[world], ("fuzzy", case))
    kw = FUZZY_CASES[case]
    j = _jax_fit("fuzzy", GRIDS[world], kw, x, init)
    assert (got["n_iter"], got["converged"]) == (int(j.n_iter),
                                                 bool(j.converged))
    np.testing.assert_allclose(got["centroids"], np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got["cost"], float(j.objective), rtol=RTOL)
    # Iterations in flight (a centroid crossing between blobs) carry the
    # centroids' f32 differences into the cost: the expanded d²'s bound.
    np.testing.assert_allclose(got["history"][:, 0],
                               np.asarray(j.history)[:, 0], rtol=RTOL,
                               atol=1e-5 * _sum_sq(x))
    assert _far_label_flips(x, got["centroids"], j.centroids) == 0
    assert tuple(got["comms"].values()) == tuple(j.comms)


@pytest.mark.parametrize("kern", ["xla", "pallas"])
@pytest.mark.parametrize("world", [2, 4])
def test_one_batch_is_the_in_memory_tower(groups, world, kern):
    """The centroids bitwise; the SSE too on one data rank (on two the
    streamed tower adds each rank's Σ‖x‖² before the data-axis sum, the
    in-memory one after it)."""
    same, sse_a, sse_b, hist_a, hist_b = same_on_every_rank(
        groups[world], ("one_batch", "kmeans", kern))
    assert same
    np.testing.assert_array_equal(hist_a[:, 1], hist_b[:, 1])
    if GRIDS[world][0] == 1:
        assert sse_a == sse_b
        np.testing.assert_array_equal(hist_a, hist_b)
    np.testing.assert_allclose(sse_a, sse_b, rtol=RTOL)
    same, obj_a, obj_b = same_on_every_rank(groups[world],
                                            ("one_batch", "fuzzy", kern))
    assert same
    np.testing.assert_allclose(obj_a, obj_b, rtol=RTOL)


@pytest.mark.parametrize("mode", RESIDENCY)
@pytest.mark.parametrize("tower, case", [("kmeans", "per_batch_pallas"),
                                         ("kmeans", "per_pass_xla"),
                                         ("fuzzy", "per_batch_pallas"),
                                         ("fuzzy", "per_pass_xla")])
@pytest.mark.parametrize("world", [2, 4])
def test_residency_is_bitwise_the_stream(groups, world, tower, case, mode):
    """'hbm' (the cache, iterations 2..N over it), 'spill' (the pinned
    ring) and 'auto' (the CPU's 16 GiB budget holds the cache) on every
    rank: the centroids, cost, history, n_iter, passes and the data-axis
    reduces of 'stream'. The ring also books the champion exchange as
    'stream'; a cached pass books none, as the JAX tower."""
    got, staged = same_on_every_rank(groups[world],
                                     ("residency", tower, case, mode))
    want = same_on_every_rank(groups[world], (tower, case))
    for key in ("centroids", "cost", "history", "n_iter", "converged"):
        np.testing.assert_array_equal(got[key], want[key])
    fields = ("strategy", "reduces", "passes", "data_bytes")
    assert ([got["comms"][f] for f in fields]
            == [want["comms"][f] for f in fields])
    if mode == "spill":
        assert got["comms"] == want["comms"]
        assert staged is True
    else:
        assert staged is None


@pytest.mark.parametrize("tower", ["kmeans", "fuzzy"])
@pytest.mark.parametrize("world", [2, 4])
def test_hbm_reads_the_stream_once(groups, world, tower):
    """The explicit init's read and the fill pass, nothing after."""
    calls, same = same_on_every_rank(groups[world], ("one_pass", tower))
    assert calls == 2 and same


@pytest.mark.parametrize("tower", ["kmeans", "fuzzy"])
@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_that_cannot_fill_makes_the_gang_stream(groups, world,
                                                       tower):
    """Model rank 1 abandons its fill: it says why, every other rank says
    another rank abandoned, and every rank streams: bitwise the 'stream'
    fit."""
    n_model = GRIDS[world][1]
    for rank, out in enumerate(groups[world]):
        same, events = out["abandoned", tower]
        reason = ("hbm_oom_during_fill" if rank % n_model == 1
                  else "abandoned_on_another_rank")
        assert same and events == [("residency_cache_abandoned", reason)]


@pytest.mark.parametrize("world", [2, 4])
def test_killed_hbm_fit_resumes_bitwise(groups, world):
    crash, saved, n_run, same, same_sse = same_on_every_rank(groups[world],
                                                             "hbm_kill")
    assert crash == "injected crash"
    assert saved == 3 and n_run == 2 and same and same_sse


@pytest.mark.parametrize("requested, budget", [("auto", "all"),
                                               ("auto", "ring_only"),
                                               ("hbm", "none"),
                                               ("spill", "all")])
@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("grid, block_rows", [((2, 2), 0), ((2, 4), 64),
                                               ((1, 2), 0)])
def test_sharded_plan_against_jax(grid, block_rows, dtype, requested, budget,
                                  monkeypatch):
    """`_plan_sharded_residency` against the JAX package's on the same
    hints: the cache is replicated across the model axis, so each rank
    budgets its data coordinate's rows (N / n_data of them, padded as the
    JAX towers pad), at the host cast's itemsize."""
    from tdc_tpu.data import device_cache as jdc
    from tdc_tpu.parallel.meshspec import MeshSpec
    from tdc_tpu_torch.data import device_cache as tdc
    from tdc_tpu_torch.parallel.mesh import Mesh

    x, _ = _data()
    rows = 100  # 16 batches: a cache well past the 3-slot ring
    jmesh = jsk.make_mesh_2d(*grid)
    tmesh = Mesh(grid, (tsk.DATA_AXIS, tsk.MODEL_AXIS), (0, 0), (None, None))
    jdtype, tdtype = ((jnp.bfloat16, torch.bfloat16) if dtype
                      else (None, None))

    def plans(nbytes, requested=requested):
        monkeypatch.setattr(jdc, "hbm_budget_bytes", lambda device=None:
                            nbytes)
        monkeypatch.setattr(tdc, "planner_budget_bytes", lambda device=None:
                            nbytes)
        jp = jsk._plan_sharded_residency(
            requested, jload.NpzStream(x, rows), K, D, MeshSpec.of(jmesh),
            pad_multiple=grid[0] * max(block_rows, 1), kernel="xla",
            dtype=jdtype, cursor=0, label="t")[0]
        tp = tsk._plan_sharded_residency(
            requested, tload.NpzStream(x, rows), K, D, tmesh,
            block_rows=block_rows, kernel="xla", dtype=tdtype, cursor=0,
            label="t", mid_pass_ckpt=False, device="cpu")[0]
        return jp, tp

    if budget == "ring_only":  # between the two models' ring and cache
        (js, ts), (jh, th) = plans(1 << 40, "spill"), plans(1 << 40, "hbm")
        nbytes = max(js.spill_bytes + js.reserve_bytes,
                     ts.spill_bytes + ts.reserve_bytes)
        assert nbytes < min(jh.resident_bytes + jh.reserve_bytes,
                            th.resident_bytes + th.reserve_bytes)
    else:
        nbytes = {"none": 10, "all": 1 << 40}[budget]
    jp, tp = plans(nbytes)
    assert (tp.mode, tp.reason) == (jp.mode, jp.reason)
    assert (tp.resident_bytes, tp.spill_bytes, tp.spill_slots) == (
        jp.resident_bytes, jp.spill_bytes, jp.spill_slots)
    multiple = grid[0] * max(block_rows, 1)
    padded = N // rows * (-(-rows // multiple) * multiple)
    assert tp.resident_bytes == -(-padded // grid[0]) * D * (2 if dtype
                                                             else 4)


@pytest.mark.parametrize("key", [("kmeans", "per_batch"),
                                 ("kmeans", "per_pass"),
                                 ("fuzzy", "per_batch")])
@pytest.mark.parametrize("world", [2, 4])
def test_a_quarantined_batch_is_dropped_on_every_rank(groups, world, key):
    same, batches, rows = same_on_every_rank(groups[world],
                                             ("quarantine", *key))
    assert same and (batches, rows) == (1, ROWS)


@pytest.mark.parametrize("tower", ["kmeans", "fuzzy"])
def test_killed_mid_pass_resumes_bitwise(groups, tower):
    crash, saved, same, n_run = same_on_every_rank(groups[2],
                                                   ("kill", tower))
    assert crash == "injected crash"
    assert saved == (2, 2)  # iterations 1-2 done, 2 batches of pass 3
    assert same and n_run == 3


@pytest.mark.parametrize("tower", ["kmeans", "fuzzy"])
def test_save_on_one_split_resumes_on_another(groups, tower, tmp_path):
    n_iter, n_run, same, n_data, n_model, d = same_on_every_rank(
        groups[2], ("resize", tower))
    assert (n_iter, n_run, same) == (6, 3, True)
    assert (int(n_data), int(n_model)) == (1, 2)  # the layout manifest
    # The (1, 2) save on a 1x1 grid in this process: the fit from the
    # saved centroids, bitwise.
    x, init = _data()
    fit = (tsk.streamed_kmeans_fit_sharded if tower == "kmeans"
           else tsk.streamed_fuzzy_fit_sharded)
    work = str(tmp_path / "ck")
    shutil.copytree(d, work)
    saved = tck.restore_checkpoint(work).centroids
    one = tsk.make_mesh_2d(1, 1)
    res = fit(tload.NpzStream(x, CK_ROWS), K, D, one, init=init,
              max_iters=6, tol=-1.0, ckpt_dir=work, device="cpu")
    ref = fit(tload.NpzStream(x, CK_ROWS), K, D, one, init=saved,
              max_iters=3, tol=-1.0, device="cpu")
    assert (res.n_iter, res.n_iter_run) == (6, 3)
    assert torch.equal(res.centroids, ref.centroids)


@pytest.mark.parametrize("tower", ["kmeans", "fuzzy"])
def test_per_pass_refuses_mid_pass_checkpoints_in_the_jax_words(
        groups, tower, tmp_path):
    fit = (jsk.streamed_kmeans_fit_sharded if tower == "kmeans"
           else jsk.streamed_fuzzy_fit_sharded)
    x, init = _data()
    with pytest.raises(ValueError) as exc:
        fit(jload.NpzStream(x, CK_ROWS), K, D, jsk.make_mesh_2d(1, 2),
            init=init, max_iters=2, tol=-1.0, ckpt_dir=str(tmp_path),
            ckpt_every_batches=2, reduce="per_pass")
    assert same_on_every_rank(groups[2], ("per_pass_ckpt", tower)) == str(
        exc.value)


TOWERS = {"kmeans": (jsk.streamed_kmeans_fit_sharded,
                     tsk.streamed_kmeans_fit_sharded),
          "fuzzy": (jsk.streamed_fuzzy_fit_sharded,
                    tsk.streamed_fuzzy_fit_sharded)}
CK = dict(max_iters=6, tol=-1.0, ckpt_every=100, ckpt_every_batches=2)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_jax_sharded_save_resumes_in_the_port(tower, tmp_path,
                                              monkeypatch):
    """The JAX tower killed in pass 3 on a (1, 2) grid after its mid-pass
    save (the gathered (K, d) state, as a gang of processes writes it);
    the port resumes it on one rank, accumulator included, and ends
    within 1e-5 of the uninterrupted JAX fit."""
    jfit, tfit = TOWERS[tower]
    x, init = _data()
    jm = jsk.make_mesh_2d(1, 2)
    full = jfit(jload.NpzStream(x, CK_ROWS), K, D, jm, init=init,
                max_iters=6, tol=-1.0)
    d = str(tmp_path / "jax")
    with monkeypatch.context() as mp:
        _as_jax(mp)
        with pytest.raises(RuntimeError, match="injected crash"):
            jfit(FusedStream(x, CK_ROWS, 8 + 2), K, D, jm, init=init,
                 ckpt_dir=d, **CK)
    saved = tck.restore_checkpoint(d)
    assert (saved.n_iter, saved.batch_cursor) == (2, 2)
    res = tfit(tload.NpzStream(x, CK_ROWS), K, D, tsk.make_mesh_2d(1, 1),
               init=init, ckpt_dir=d, device="cpu", **CK)
    assert (res.n_iter, res.n_iter_run) == (6, 4)
    np.testing.assert_allclose(res.centroids.numpy(),
                               np.asarray(full.centroids), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_port_sharded_save_resumes_in_jax(tower, tmp_path):
    """The port killed in pass 3 after its mid-pass save; the JAX tower
    resumes it on a (1, 2) grid and ends within 1e-5 of its own
    uninterrupted fit."""
    jfit, tfit = TOWERS[tower]
    x, init = _data()
    d = str(tmp_path / "port")
    with pytest.raises(RuntimeError, match="injected crash"):
        tfit(FusedStream(x, CK_ROWS, 1 + 8 + 2), K, D,
             tsk.make_mesh_2d(1, 1), init=init, ckpt_dir=d, device="cpu",
             **CK)
    jm = jsk.make_mesh_2d(1, 2)
    res = jfit(jload.NpzStream(x, CK_ROWS), K, D, jm, init=init, ckpt_dir=d,
               **CK)
    full = jfit(jload.NpzStream(x, CK_ROWS), K, D, jm, init=init,
                max_iters=6, tol=-1.0)
    assert (int(res.n_iter), res.n_iter_run) == (6, 4)
    np.testing.assert_allclose(np.asarray(res.centroids),
                               np.asarray(full.centroids), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("tower", list(TOWERS))
@pytest.mark.parametrize("kw, error, words", [
    ({"gather": "int8"}, NotImplementedError,
     "Queue A, A9: parallel/gather.py"),
    ({"reduce": "per_pass:int8"}, ValueError,
     "quantized stats reduce is wired for the 1-D streamed fits"),
    ({"residency": "disk"}, ValueError, "residency='disk'"),
])
def test_refusals(tower, kw, error, words):
    x, init = _data()
    with pytest.raises(error, match=words.replace("(", r"\(")):
        TOWERS[tower][1](tload.NpzStream(x, ROWS), K, D,
                         tsk.make_mesh_2d(1, 1), init=init, device="cpu",
                         **kw)
    if error is ValueError and "reduce" in kw:
        with pytest.raises(ValueError) as exc:
            TOWERS[tower][0](jload.NpzStream(x, ROWS), K, D,
                             jsk.make_mesh_2d(1, 2), init=init, **kw)
        assert str(exc.value).startswith(words)


def test_kmeans_assign_refusal_names_a10():
    x, init = _data()
    with pytest.raises(NotImplementedError, match="Queue A, A10"):
        tsk.streamed_kmeans_fit_sharded(
            tload.NpzStream(x, ROWS), K, D, tsk.make_mesh_2d(1, 1),
            init=init, assign="coarse", device="cpu")


def test_entry_points_default_to_the_card():
    x, init = _data()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    for fit in (tsk.streamed_kmeans_fit_sharded,
                tsk.streamed_fuzzy_fit_sharded,
                tsk.streamed_gmm_fit_sharded):
        with pytest.raises(RuntimeError, match="CUDA"):
            fit(tload.NpzStream(x, ROWS), K, D, tsk.make_mesh_2d(1, 1),
                init=init)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsk.gmm_fit_sharded(x, K, tsk.make_mesh_2d(1, 1), init=init)
