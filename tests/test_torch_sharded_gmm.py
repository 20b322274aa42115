"""The port's K-sharded Gaussian Mixture tower (`parallel/sharded_k.py`:
`make_sharded_gmm_stats`, `gmm_fit_sharded`, `streamed_gmm_fit_sharded`
and its gathered checkpoints) against the JAX package's, on the CPU.

Two groups of gloo ranks, 2 as a (1, 2) grid and 4 as a (2, 2) grid,
each spawned once per test run (`test_torch_reduce.shared_groups`), run
every port fit of their world size; the JAX towers run here on the
conftest's 8 virtual devices on the same grids, from the same seeded
numpy inputs (tests/test_sharded_k.py's 1600 x 6 blobs, K=8, the first 8
rows as the explicit init). Cases: in memory; block_rows=100; a ragged
N=1597 (block_rows=100: the JAX tower pads and corrects, the port pads
nothing); the bf16 host cast; 300-row batches with a ragged 100-row last
one, also at block_rows=64 (the JAX tower pads every batch and corrects).

Tolerances: n_iter and converged equal; the mean log-likelihood within
1e-5 relative; the means within 1e-5 relative and atol 2e-4, the
variances within 5e-4 relative and atol 1e-5, the weights within 1e-4
relative. All three are looser than 1e-5 for one reason: a variance is
E_r[x²] − μ² in f32, and here |μ|² reaches ~630 σ², so the f32 order of
the sums moves it by ~1e-4 of itself (the JAX tower's own (1, 1) and
(2, 2) grids differ by up to 9.3e-5 relative in the variances on these
inputs, and its own tests hold its layouts to rtol 1e-3); the starting
variances (the hard-assignment moments, 6.1e-5 apart in the two
packages) carry that into every E-step's responsibilities at the blobs'
boundaries, and so into the means and the smallest weights. Measured
over the cases here: means 7.0e-5 absolute, variances 1.9e-4 relative,
weights 4.4e-5 relative, log-likelihood 1.6e-6 relative. The E-step
sums alone (`make_sharded_gmm_stats`, seeded parameters in): ll, Σr
rtol 1e-5; Σr·x, Σr·x² rtol 1e-5 and atol 1e-5 of their largest
magnitude. On one batch the streamed tower is bitwise the
in-memory one (means, variances, weights); a killed and resumed
streamed fit is bitwise the uninterrupted one on every rank; each
package resumes the other's save within the fit tolerances.
"""

import os

import jax
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
from tdc_tpu_torch.parallel import sharded_k as tsk
from tdc_tpu_torch.parallel.mesh import Mesh, shard_points
from tdc_tpu_torch.utils import checkpoint as tck

N, K, D = 1600, 8, 6
ROWS = 300  # 5 full batches and a ragged 100-row one
CK_ROWS = 400  # the checkpoint runs: 4 batches a pass
GRIDS = {2: (1, 2), 4: (2, 2)}
MAX_ITERS, TOL = 30, 1e-4
CASES = {
    "in_memory": {},
    "blocked": {"block_rows": 100},
    "ragged": {"n": 1597, "block_rows": 100},
    "bf16": {"dtype": "bf16"},
    "streamed": {"rows": ROWS},
    "streamed_blocked": {"rows": ROWS, "block_rows": 64},
}
CK = dict(max_iters=6, tol=-1.0, ckpt_every=1)


def _data():
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=10, size=(8, 6)).astype(np.float32)
    x = (centers[rng.integers(0, 8, N)]
         + rng.normal(size=(N, D)).astype(np.float32)).astype(np.float32)
    return x, x[:K].copy()


def _params():
    """(means, variances, weights) for the E-step check, seeded."""
    x, init = _data()
    rng = np.random.default_rng(3)
    var = rng.uniform(0.5, 2.0, size=(K, D)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=K).astype(np.float32)
    return init + 0.1, var, (w / w.sum()).astype(np.float32)


def _fit(package: str, case: dict, mesh, x, init, **extra):
    """One case's fit in `package` ('port' or 'jax')."""
    port = package == "port"
    xs = x[:case.get("n", N)]
    kw = dict(init=init, max_iters=MAX_ITERS, tol=TOL,
              block_rows=case.get("block_rows", 0))
    if case.get("dtype"):
        kw["dtype"] = torch.bfloat16 if port else jnp.bfloat16
    if port:
        kw["device"] = "cpu"
    kw.update(extra)
    sk, loader = (tsk, tload) if port else (jsk, jload)
    if "rows" in case:
        return sk.streamed_gmm_fit_sharded(loader.NpzStream(xs, case["rows"]),
                                           K, D, mesh, **kw)
    return sk.gmm_fit_sharded(xs, K, mesh, **kw)


def _out(res) -> dict:
    return {"means": np.asarray(res.means), "variances":
            np.asarray(res.variances), "weights": np.asarray(res.weights),
            "n_iter": int(res.n_iter), "converged": bool(res.converged),
            "ll": float(res.log_likelihood)}


def _stats(mesh, x, block_rows):
    """The port's E-step sums on this rank, whole over K (every rank)."""
    means, var, w = (torch.from_numpy(a) for a in _params())
    mine = tsk._model_rows(mesh, means, var, w)
    s = tsk.make_sharded_gmm_stats(mesh, block_rows)(
        shard_points(torch.from_numpy(x), mesh), *mine)
    return (float(s.ll), *(tsk._whole_centroids(t, mesh).numpy()
                           for t in s[1:]))


def _ckpt_job(tmp, mesh, x, init) -> dict:
    """On the (1, 2) grid: the uninterrupted fit, one killed in pass 3
    (per-iteration saves) and its resume, the no-op resume of the
    finished run; a 3-iteration save for the JAX tower to resume; and
    the resume of the JAX tower's save (made before the ranks started)."""
    out = {}
    kw = dict(init=init, device="cpu", **CK)
    full = tsk.streamed_gmm_fit_sharded(tload.NpzStream(x, CK_ROWS), K, D,
                                        mesh, **kw)
    d = os.path.join(tmp, "kill")
    crash = ""
    try:
        # The seeding reads the 4 batches once; pass 3's 3rd raises.
        tsk.streamed_gmm_fit_sharded(FusedStream(x, CK_ROWS, 4 + 8 + 2), K,
                                     D, mesh, ckpt_dir=d, **kw)
    except RuntimeError as e:
        crash = str(e)
    saved = tck.restore_checkpoint(d).n_iter
    resumed = tsk.streamed_gmm_fit_sharded(tload.NpzStream(x, CK_ROWS), K,
                                           D, mesh, ckpt_dir=d, **kw)
    again = tsk.streamed_gmm_fit_sharded(tload.NpzStream(x, CK_ROWS), K, D,
                                         mesh, ckpt_dir=d, **kw)
    out["kill"] = (crash, saved, resumed.n_iter_run, again.n_iter_run,
                   *(torch.equal(getattr(resumed, f), getattr(full, f))
                     for f in ("means", "variances", "weights")),
                   float(resumed.log_likelihood),
                   float(again.log_likelihood), float(full.log_likelihood))
    tsk.streamed_gmm_fit_sharded(
        tload.NpzStream(x, CK_ROWS), K, D, mesh, ckpt_dir=os.path.join(
            tmp, "port_save"), **{**kw, "max_iters": 3})
    res = tsk.streamed_gmm_fit_sharded(
        tload.NpzStream(x, CK_ROWS), K, D, mesh,
        ckpt_dir=os.path.join(tmp, "jax_save"), **kw)
    out["from_jax"] = (res.n_iter, res.n_iter_run, _out(res))
    return out


def _job(world, tmp):
    x, init = _data()
    mesh = tsk.make_mesh_2d(*GRIDS[world])
    out = {name: _out(_fit("port", case, mesh, x, init))
           for name, case in CASES.items()}
    for rows in (0, 100):
        out["stats", rows] = _stats(mesh, x, rows)
    one = _fit("port", {"rows": N}, mesh, x, init)
    mem = _fit("port", {}, mesh, x, init)
    out["one_batch"] = (one.n_iter, mem.n_iter, *(
        torch.equal(getattr(one, f), getattr(mem, f))
        for f in ("means", "variances", "weights")))
    if world == 2:
        out.update(_ckpt_job(tmp, mesh, x, init))
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    def make(tmp):
        # The JAX tower's 3-iteration save on a (1, 2) grid, which the
        # ranks resume: in the state.npz format a process of a JAX gang
        # writes (the port reads no orbax step).
        x, init = _data()
        with pytest.MonkeyPatch.context() as mp:
            _as_jax(mp)
            jsk.streamed_gmm_fit_sharded(
                jload.NpzStream(x, CK_ROWS), K, D, jsk.make_mesh_2d(1, 2),
                init=init, ckpt_dir=str(tmp / "jax_save"),
                **{**CK, "max_iters": 3})
        return {"tmp": str(tmp), **{
            w: spawn_ranks(tmp, w, _job, (str(tmp),)) for w in (2, 4)}}

    return shared_groups(tmp_path_factory, "torch_sharded_gmm_ranks", make)


def _assert_fit(got: dict, want) -> None:
    assert (got["n_iter"], got["converged"]) == (int(want.n_iter),
                                                 bool(want.converged))
    np.testing.assert_allclose(got["means"], np.asarray(want.means),
                               rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(got["variances"], np.asarray(want.variances),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got["weights"], np.asarray(want.weights),
                               rtol=1e-4)
    np.testing.assert_allclose(got["ll"], float(want.log_likelihood),
                               rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_gmm_towers_against_jax(groups, world, case):
    x, init = _data()
    got = same_on_every_rank(groups[world], case)
    want = _fit("jax", CASES[case], jsk.make_mesh_2d(*GRIDS[world]), x,
                init)
    _assert_fit(got, want)


@pytest.mark.parametrize("block_rows", [0, 100])
@pytest.mark.parametrize("world", [2, 4])
def test_make_sharded_gmm_stats_against_jax(groups, world, block_rows):
    x, _ = _data()
    got = same_on_every_rank(groups[world], ("stats", block_rows))
    fn = jax.jit(jsk.make_sharded_gmm_stats(jsk.make_mesh_2d(*GRIDS[world]),
                                            block_rows))
    want = [np.asarray(t) for t in fn(jnp.asarray(x),
                                      *map(jnp.asarray, _params()))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("world", [2, 4])
def test_one_batch_is_the_in_memory_tower(groups, world):
    n_one, n_mem, *same = same_on_every_rank(groups[world], "one_batch")
    assert n_one == n_mem and all(same)


def test_killed_and_resumed_is_bitwise(groups):
    (crash, saved, n_run, n_again, *same, ll_res, ll_again,
     ll_full) = same_on_every_rank(groups[2], "kill")
    assert crash == "injected crash"
    assert saved == 2 and n_run == 4  # iterations 1-2 saved, 3-6 resumed
    assert all(same) and ll_res == ll_full
    # The finished run's resume reads no pass and reuses its final ll.
    assert n_again == 0 and ll_again == ll_res


def test_jax_save_resumes_in_the_port(groups):
    """The JAX tower's (1, 2) save at iteration 3, resumed on two ranks
    to 6: within the fit tolerances of the JAX tower's uninterrupted
    fit."""
    n_iter, n_run, got = same_on_every_rank(groups[2], "from_jax")
    x, init = _data()
    want = jsk.streamed_gmm_fit_sharded(jload.NpzStream(x, CK_ROWS), K, D,
                                        jsk.make_mesh_2d(1, 2), init=init,
                                        **CK)
    assert (n_iter, n_run) == (6, 3)
    _assert_fit(got, want)


def test_port_save_resumes_in_jax(groups, tmp_path):
    """The port's gathered (1, 2) save at iteration 3 (rank 0 wrote the
    whole state), resumed by the JAX tower on a (1, 2) grid to 6."""
    import shutil

    x, init = _data()
    d = str(tmp_path / "ck")
    shutil.copytree(os.path.join(groups["tmp"], "port_save"), d)
    jm = jsk.make_mesh_2d(1, 2)
    res = jsk.streamed_gmm_fit_sharded(jload.NpzStream(x, CK_ROWS), K, D,
                                       jm, init=init, ckpt_dir=d, **CK)
    want = jsk.streamed_gmm_fit_sharded(jload.NpzStream(x, CK_ROWS), K, D,
                                        jm, init=init, **CK)
    assert (int(res.n_iter), res.n_iter_run) == (6, 3)
    _assert_fit(_out(res), want)


def test_changed_model_axis_is_refused_in_the_jax_words(groups, tmp_path):
    """A (1, 2) save on a 1x1 grid, in both packages: the same error."""
    import shutil

    x, init = _data()
    words = []
    for sk, loader, mesh, extra in (
            (tsk, tload, tsk.make_mesh_2d(1, 1), {"device": "cpu"}),
            (jsk, jload, jsk.make_mesh_2d(1, 1), {})):
        d = str(tmp_path / "ck")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(groups["tmp"], "port_save"), d)
        with pytest.raises(ValueError) as exc:
            sk.streamed_gmm_fit_sharded(loader.NpzStream(x, CK_ROWS), K, D,
                                        mesh, init=init, ckpt_dir=d, **CK,
                                        **extra)
        words.append(str(exc.value))
    assert words[0] == words[1] and "refusing to mix state" in words[0]


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("k, init", [(K, "kmeans"), (9, "first_k")])
def test_refusals_in_the_jax_words(streamed, k, init):
    """On a (1, 2) grid (the port's a grid of this one process: both
    refusals come before any collective)."""
    x, _ = _data()
    words = []
    for sk, loader, mesh, extra in (
            (tsk, tload, Mesh((1, 2), (tsk.DATA_AXIS, tsk.MODEL_AXIS),
                              (0, 0), (None, None)), {"device": "cpu"}),
            (jsk, jload, jsk.make_mesh_2d(1, 2), {})):
        with pytest.raises(ValueError) as exc:
            if streamed:
                sk.streamed_gmm_fit_sharded(loader.NpzStream(x, ROWS), k, D,
                                            mesh, init=init, **extra)
            else:
                sk.gmm_fit_sharded(x, k, mesh, init=init, **extra)
        words.append(str(exc.value))
    assert words[0] == words[1]


def test_the_towers_launch_no_kernel(monkeypatch):
    """The E-step is plain products, as the JAX tower's XLA step: no
    wrapper of B1–B12 is called."""
    from tdc_tpu_torch.ops import fuzzy_kernels, gmm_kernels, lloyd_kernels
    from tdc_tpu_torch.ops import sorted_stats, tall

    called = []
    for mod in (fuzzy_kernels, gmm_kernels, lloyd_kernels, sorted_stats,
                tall):
        for name in dir(mod):
            fn = getattr(mod, name)
            if hasattr(fn, "launches"):
                monkeypatch.setattr(
                    mod, name, lambda *a, _n=name, **kw: called.append(_n))
    x, init = _data()
    mesh = tsk.make_mesh_2d(1, 1)
    _fit("port", {}, mesh, x, init, max_iters=3)
    _fit("port", {"rows": ROWS}, mesh, x, init, max_iters=3)
    assert called == []


def test_bf16_stream_is_the_host_cast():
    """A stream of bf16 rows ('|V2', as ml_dtypes arrays are saved) gives
    the fit of f32 rows cast on the host, bitwise."""
    x, init = _data()
    xb = x.astype(ml_dtypes.bfloat16)
    mesh = tsk.make_mesh_2d(1, 1)
    kw = dict(init=init, max_iters=5, tol=-1, device="cpu")
    a = tsk.streamed_gmm_fit_sharded(
        tload.NpzStream(xb.view(np.dtype("V2")), ROWS), K, D, mesh, **kw)
    # The widened rows seed alike; the host cast gives the bf16 rows back.
    b = tsk.streamed_gmm_fit_sharded(
        tload.NpzStream(xb.astype(np.float32), ROWS), K, D, mesh,
        dtype=torch.bfloat16, **kw)
    assert torch.equal(a.means, b.means) and torch.equal(a.variances,
                                                         b.variances)
