"""The residency wiring of the port's streamed K-Means and fuzzy fits
(`models/streaming.py`: the cache filled in pass 1, iterations 2..N over
it through `_Pass.run_cached`), on the CPU.

The bar is the JAX package's own (tests/test_resident.py's TestParity):
residency='hbm' and 'auto' give the bits of residency='stream'
(torch.equal on the centroids, equal SSE or objective, history, n_iter
and converged) on one rank, on 2 and 4 ranks of gloo (per_batch,
per_pass and per_pass:int8), weighted, spherical, on a bf16 stream,
with early convergence, a single batch and a ragged tail. Against the
JAX package's own residency='hbm' fits the port agrees within the
streamed fits' f32 tolerances (tests/test_torch_streaming.py: centroids
rtol 1e-5 / atol 1e-5, costs rtol 1e-5, n_iter and converged equal).
An 'hbm' fit reads nothing from its stream after its first pass; its
checkpoints are the streamed fit's and resume bit for bit.
"""

import json
import multiprocessing as mp
import queue as queue_lib
import time
import traceback

import ml_dtypes
import numpy as np
import pytest
import torch

from tdc_tpu_torch.data.loader import NpzStream
from tdc_tpu_torch.models import streaming as tst
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh
from tdc_tpu_torch.utils import preempt

N, K, D = 1003, 8, 8
ROWS = 256  # 4 batches, the last one 235 rows
MESH_ROWS = 149  # 6 batches of 149 and one of 109: no world divides them


def _data(n=N, d=D, seed=0):
    """Odd N: the last batch is ragged, and padded on every mesh."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8, size=(8, d)).astype(np.float32)
    return (centers[rng.integers(0, 8, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _weights(n=N, seed=5):
    w = np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(np.float32)
    w[::11] = 0.0
    return w


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


def _out(res):
    cost = res.objective if hasattr(res, "objective") else res.sse
    return {"centroids": res.centroids.cpu().numpy(),
            "cost": float(cost), "history": np.asarray(res.history),
            "n_iter": int(res.n_iter), "converged": bool(res.converged),
            "passes": res.comms.passes, "reduces": res.comms.reduces}


def _assert_same(got, want):
    """Bit for bit: the JAX package's parity bar."""
    np.testing.assert_array_equal(got["centroids"], want["centroids"])
    assert got["cost"] == want["cost"]
    np.testing.assert_array_equal(got["history"], want["history"])
    assert (got["n_iter"], got["converged"]) == (want["n_iter"],
                                                 want["converged"])
    assert (got["passes"], got["reduces"]) == (want["passes"],
                                               want["reduces"])


CASES = {
    "kmeans": dict(),
    "kmeans_pallas": dict(kernel="pallas"),
    "kmeans_weighted": dict(weighted=True),
    "kmeans_weighted_pallas": dict(weighted=True, kernel="pallas"),
    "kmeans_spherical": dict(spherical=True),
    "kmeans_bf16_pallas": dict(bf16=True, kernel="pallas"),
    "kmeans_early_stop": dict(tol=2e-2, max_iters=50),
    "kmeans_single_batch": dict(rows=N),
    "kmeans_fixed_iters": dict(tol=-1.0),
    "fuzzy": dict(fuzzy=True),
    "fuzzy_pallas": dict(fuzzy=True, kernel="pallas"),
    "fuzzy_weighted": dict(fuzzy=True, weighted=True),
    "fuzzy_early_stop": dict(fuzzy=True, tol=1e-2, max_iters=50),
    "fuzzy_single_batch": dict(fuzzy=True, rows=N),
    "fuzzy_fixed_iters": dict(fuzzy=True, tol=-1.0),
}


def _fit(case, residency, x=None, mesh=None, rows=None, stream_cls=None,
         **extra):
    """One CASES fit of the port, on the CPU."""
    kw = dict(CASES[case])
    fuzzy, weighted = kw.pop("fuzzy", False), kw.pop("weighted", False)
    bf16 = kw.pop("bf16", False)
    rows = kw.pop("rows", rows or ROWS)
    x = _data() if x is None else x
    if bf16:
        x = x.astype(ml_dtypes.bfloat16).view(np.dtype("V2"))
    stream = (stream_cls or NpzStream)(x, rows)
    kw.setdefault("tol", 1e-6)
    kw.setdefault("max_iters", 8)
    kw.update(init=_data()[:K], mesh=mesh, residency=residency,
              device="cpu", **extra)
    if weighted:
        kw["sample_weight_batches"] = NpzStream(_weights(x.shape[0]), rows)
    fit = tst.streamed_fuzzy_fit if fuzzy else tst.streamed_kmeans_fit
    return fit(stream, K, D, **kw)


@pytest.mark.parametrize("residency", ["hbm", "auto"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resident_fit_equals_the_streamed_fit(case, residency, runlog):
    got = _fit(case, residency)
    want = _fit(case, "stream")
    _assert_same(_out(got), _out(want))
    assert got.h2d is None
    events = [e["event"] for e in _events(runlog)]
    assert "residency_fallback" not in events
    assert "residency_cache_abandoned" not in events


class _OnePass:
    """NpzStream whose iteration raises once the explicit init's read and
    one full pass are done: an 'hbm' fit must never read it again."""

    def __init__(self, x, rows):
        self.inner = NpzStream(x, rows)
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self):
        self.calls += 1
        if self.calls > 2:
            raise AssertionError("the stream was read after the fill pass")
        return self.inner()


@pytest.mark.parametrize("case", ["kmeans", "kmeans_weighted", "fuzzy",
                                  "kmeans_fixed_iters"])
def test_hbm_fit_reads_nothing_after_the_fill(case):
    stream = _OnePass(_data(), ROWS)
    got = _fit(case, "hbm", stream_cls=lambda x, rows: stream)
    assert stream.calls == 2
    want = _fit(case, "stream")
    _assert_same(_out(got), _out(want))
    assert got.n_iter > 1


def test_resident_loop_runs_the_cached_passes(monkeypatch):
    """Against a silent fallback faking the parity tests: after the fill
    pass, every pass (iterations 2..N and the reporting pass) runs over
    the cache."""
    cached = []
    real = tst._Pass.run_cached

    def counting(self, params, cache):
        cached.append(cache.n_batches)
        return real(self, params, cache)

    monkeypatch.setattr(tst._Pass, "run_cached", counting)
    res = _fit("kmeans_fixed_iters", "hbm")
    assert res.n_iter == 8 and cached == [4] * 8  # 7 iterations + report
    assert res.comms.passes == 9


def test_cached_passes_beat_the_heartbeat(monkeypatch):
    """Iterations 2..N read no batch, so the loop marks each one."""
    beats = []
    monkeypatch.setattr(tst, "maybe_beat",
                        lambda progress=None, **kw: beats.append(progress))
    res = _fit("kmeans_fixed_iters", "hbm")
    assert [b for b in beats if b.endswith("cached")] == [
        f"iter={i} cached" for i in range(2, res.n_iter + 1)]


def test_jax_parity_of_the_resident_fits():
    """The port's residency='hbm' and 'auto' fits against the JAX
    package's own, within the streamed fits' f32 tolerances."""
    from tdc_tpu.data.loader import NpzStream as JStream
    from tdc_tpu.models import streaming as jst

    x = _data()
    for fuzzy in (False, True):
        jfit = jst.streamed_fuzzy_fit if fuzzy else jst.streamed_kmeans_fit
        for residency in ("hbm", "auto"):
            want = jfit(JStream(x, ROWS), K, D, init=x[:K], max_iters=8,
                        tol=1e-6, residency=residency)
            got = _fit("fuzzy" if fuzzy else "kmeans", residency)
            cost = "objective" if fuzzy else "sse"
            assert (got.n_iter, got.converged) == (int(want.n_iter),
                                                   bool(want.converged))
            np.testing.assert_allclose(got.centroids.numpy(),
                                       np.asarray(want.centroids),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(getattr(got, cost)),
                                       float(getattr(want, cost)),
                                       rtol=1e-5)
            np.testing.assert_allclose(got.history[:, 0],
                                       np.asarray(want.history)[:, 0],
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints and preemption
# ---------------------------------------------------------------------------


def _cost(res):
    return float(res.objective if hasattr(res, "objective") else res.sse)


@pytest.mark.parametrize("case", ["kmeans_fixed_iters", "fuzzy_fixed_iters"])
def test_hbm_checkpoints_match_the_streamed_fits_and_resume(case, tmp_path):
    """The saves an 'hbm' fit writes are the streamed fit's, step for step
    and bit for bit; a later run resumes from the last and finishes
    equal to an uninterrupted streamed fit (tests/test_resident.py's
    test_ckpt_cadence_and_resume)."""
    from tdc_tpu_torch.utils import checkpoint as ck

    saves = {}
    for residency in ("stream", "hbm"):
        d = tmp_path / residency
        _fit(case, residency, max_iters=5, ckpt_dir=str(d), ckpt_every=2)
        steps = sorted(p.name for p in d.iterdir() if p.is_dir())
        saves[residency] = [(s, ck.restore_checkpoint(str(d), step=int(
            s.split("_")[-1]))) for s in steps]
    assert [s for s, _ in saves["hbm"]] == [s for s, _ in saves["stream"]]
    assert len(saves["hbm"]) == 3  # iterations 2, 4 and 5
    for (_, a), (_, b) in zip(saves["hbm"], saves["stream"]):
        np.testing.assert_array_equal(a.centroids, b.centroids)
        np.testing.assert_array_equal(a.meta["history"], b.meta["history"])
        assert a.n_iter == b.n_iter
    resumed = _fit(case, "hbm", max_iters=9, ckpt_dir=str(tmp_path / "hbm"),
                   ckpt_every=2)
    want = _fit(case, "stream", max_iters=9)
    assert resumed.n_iter_run == 4
    np.testing.assert_array_equal(resumed.centroids.numpy(),
                                  want.centroids.numpy())
    assert _cost(resumed) == _cost(want)
    np.testing.assert_array_equal(resumed.history, want.history)


def test_hbm_refuses_mid_pass_checkpoints_and_auto_streams(tmp_path, runlog):
    with pytest.raises(ValueError, match="incompatible with "
                                         "ckpt_every_batches"):
        _fit("kmeans", "hbm", ckpt_dir=str(tmp_path / "a"),
             ckpt_every_batches=2)
    got = _fit("kmeans", "auto", ckpt_dir=str(tmp_path / "b"),
               ckpt_every_batches=2)
    want = _fit("kmeans", "stream")
    np.testing.assert_array_equal(got.centroids.numpy(),
                                  want.centroids.numpy())
    ev = [e for e in _events(runlog) if e["event"] == "residency_fallback"]
    assert [e["reason"] for e in ev] == ["mid_pass_ckpt"]


@pytest.mark.parametrize("case", ["kmeans_fixed_iters", "fuzzy_fixed_iters"])
def test_preemption_during_the_cached_passes_saves_and_resumes(
        case, tmp_path, monkeypatch):
    """A preemption notice during a pass over the cache: the streamed
    loop's check after that iteration saves and raises Preempted; the
    resumed fit equals the uninterrupted one. (The handler counts as
    installed; no signal handler is set in the test process.)"""
    monkeypatch.setitem(preempt._state, "installed", True)
    calls = []
    real = tst._Pass.run_cached

    def notice(self, params, cache):
        calls.append(1)
        if len(calls) == 2:
            preempt.request()
        return real(self, params, cache)

    monkeypatch.setattr(tst._Pass, "run_cached", notice)
    try:
        with pytest.raises(preempt.Preempted,
                           match=r"preempted after iteration 3"):
            _fit(case, "hbm", ckpt_dir=str(tmp_path), ckpt_every=3)
    finally:
        preempt.reset()
    monkeypatch.setattr(tst._Pass, "run_cached", real)
    resumed = _fit(case, "hbm", ckpt_dir=str(tmp_path), ckpt_every=3)
    want = _fit(case, "stream")
    assert resumed.n_iter_run == 5
    np.testing.assert_array_equal(resumed.centroids.numpy(),
                                  want.centroids.numpy())
    np.testing.assert_array_equal(resumed.history, want.history)


def test_resume_converged_reads_nothing(tmp_path):
    _fit("kmeans_early_stop", "hbm", ckpt_dir=str(tmp_path))
    again = _fit("kmeans_early_stop", "hbm", ckpt_dir=str(tmp_path))
    want = _fit("kmeans_early_stop", "stream")
    assert again.n_iter_run == 0 and again.converged
    np.testing.assert_array_equal(again.centroids.numpy(),
                                  want.centroids.numpy())


# ---------------------------------------------------------------------------
# Ranks: 2 and 4 on gloo
# ---------------------------------------------------------------------------

MESH_CASES = {
    "kmeans_per_batch": dict(),
    "kmeans_per_pass": dict(kernel="pallas", reduce="per_pass"),
    "kmeans_int8": dict(reduce="per_pass:int8"),
    "kmeans_weighted": dict(weighted=True),
    "fuzzy_per_batch": dict(fuzzy=True),
    "fuzzy_per_pass": dict(fuzzy=True, reduce="per_pass"),
}
MODES = ("stream", "hbm", "spill", "auto")


def _mesh_job():
    mesh = tmesh.make_mesh()
    x = _data()
    out = {}
    for case, kw in MESH_CASES.items():
        kw = dict(kw)
        fuzzy, weighted = kw.pop("fuzzy", False), kw.pop("weighted", False)
        fit = tst.streamed_fuzzy_fit if fuzzy else tst.streamed_kmeans_fit
        for mode in MODES:
            extra = dict(kw)
            if weighted:
                extra["sample_weight_batches"] = NpzStream(_weights(),
                                                           MESH_ROWS)
            res = fit(NpzStream(x, MESH_ROWS), K, D, init=x[:K], mesh=mesh,
                      max_iters=6, tol=1e-6, residency=mode, device="cpu",
                      **extra)
            out[case, mode] = _out(res)
    return out


def _rank_main(rank, world, init_method, queue):
    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        queue.put((rank, _mesh_job()))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        tmh.shutdown()


def _spawn(tmp_path, world, timeout=240):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_path / f'store{world}'}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, out = queue.get(timeout=2)
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
    return {w: _spawn(tmp_path_factory.mktemp(f"resident_ranks{w}"), w)
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["hbm", "spill", "auto"])
@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_residency_equals_the_streamed_fit(groups, world, mode, case):
    """Each rank caches (or spills) its own slice of every batch, padded;
    every rank's fit is the streamed fit's, bit for bit, reduces and
    passes counted alike."""
    for ranks in groups[world]:
        _assert_same(ranks[case, mode], ranks[case, "stream"])
    first = groups[world][0][case, mode]
    for ranks in groups[world][1:]:
        _assert_same(ranks[case, mode], first)


def test_mesh_resident_fit_against_jax(groups):
    """Two ranks' per-pass 'hbm' fit against the JAX mesh's, within the
    streamed mesh fits' tolerances (tests/test_torch_streaming.py)."""
    from tdc_tpu.data.loader import NpzStream as JStream
    from tdc_tpu.models import streaming as jst
    from tdc_tpu.parallel import mesh as jmesh

    x = _data()
    want = jst.streamed_kmeans_fit(JStream(x, MESH_ROWS), K, D, init=x[:K],
                                   mesh=jmesh.make_mesh(2), max_iters=6,
                                   tol=1e-6, reduce="per_pass",
                                   residency="hbm")
    got = groups[2][0]["kmeans_per_pass", "hbm"]
    assert (got["n_iter"], got["converged"]) == (int(want.n_iter),
                                                 bool(want.converged))
    np.testing.assert_allclose(got["centroids"], np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["cost"], float(want.sse), rtol=1e-5,
                               atol=1e-5 * float((x * x).sum()))
    assert got["reduces"] == int(want.comms.reduces)
