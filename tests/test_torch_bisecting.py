"""Bisecting K-Means of the port against the JAX package's, on the CPU.

k-means++ is pinned in both packages to the same function of its inputs
(the first and last positive-weight rows it is given), so every split
starts alike. Both strategies, weights, `return_labels`, the error words
for data with too few distinct points, the streamed fit against the
JAX package's and the port's in-memory one, and two gloo ranks (in
memory and streamed) against one process.

Tolerances (float32, another summation order): centroids rtol 1e-5 /
atol 1e-5, SSE rtol 1e-5, n_iter and the hierarchical labels equal.
"""

import multiprocessing as mp
import queue as queue_lib
import time
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_tpu.data import loader as jload
from tdc_tpu.models import bisecting as jbis
from tdc_tpu.models import kmeans as jkm
from tdc_tpu_torch.data import loader as tload
from tdc_tpu_torch.models import bisecting as tbis
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh

RTOL = 1e-5
N, K, D = 900, 6, 4
ROWS = 200


def _pinned_rows(x, k, w):
    """k evenly spaced positive-weight rows of x: the pinned k-means++."""
    w = np.ones(len(x)) if w is None else np.asarray(w)
    idx = np.nonzero(w > 0)[0]
    return np.asarray(x)[idx[np.linspace(0, len(idx) - 1, k).astype(int)]]


def pin_jax(key, x, k, sample_weight=None):
    return jnp.asarray(_pinned_rows(np.asarray(x, np.float32), k,
                                    None if sample_weight is None
                                    else np.asarray(sample_weight)))


def pin_port(generator, x, k, sample_weight=None):
    w = None if sample_weight is None else sample_weight.cpu().numpy()
    rows = _pinned_rows(x.float().cpu().numpy(), k, w)
    return torch.from_numpy(rows.astype(np.float32)).to(x.device)


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(jkm, "init_kmeans_pp", pin_jax)
    monkeypatch.setattr(tkm, "init_kmeans_pp", pin_port)


def _blobs(seed=0, n=N, k=K, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    w = rng.uniform(0, 2, size=n).astype(np.float32)
    w[::9] = 0.0
    return x, w


def _assert_fit(t, j, t_labels=None, j_labels=None):
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(t.sse), float(j.sse), rtol=RTOL)
    assert t.n_iter == int(j.n_iter) and t.converged
    if t_labels is not None:
        np.testing.assert_array_equal(t_labels, j_labels)


CASES = [("biggest_inertia", False), ("largest_cluster", False),
         ("biggest_inertia", True), ("largest_cluster", True)]


@pytest.mark.parametrize("strategy, weighted", CASES)
def test_in_memory_against_jax(pinned, strategy, weighted):
    x, w = _blobs()
    sw = w if weighted else None
    kw = dict(max_iters=15, tol=1e-4, bisecting_strategy=strategy,
              sample_weight=sw, return_labels=True)
    j, jl = jbis.bisecting_kmeans_fit(x, K, **kw)
    t, tl = tbis.bisecting_kmeans_fit(x, K, device="cpu", **kw)
    assert tl.dtype == np.int32 and tl.shape == (N,)
    _assert_fit(t, j, tl, jl)


@pytest.mark.parametrize("strategy, weighted", CASES)
def test_streamed_against_jax_and_in_memory(pinned, strategy, weighted):
    x, w = _blobs(1)
    kw = dict(max_iters=15, tol=1e-4, bisecting_strategy=strategy,
              return_labels=True)
    j, jl = jbis.streamed_bisecting_kmeans_fit(
        jload.NpzStream(x, ROWS), K, D,
        sample_weight_batches=(jload.NpzStream(w, ROWS) if weighted
                               else None), **kw)
    t, tl = tbis.streamed_bisecting_kmeans_fit(
        tload.NpzStream(x, ROWS), K, D,
        sample_weight_batches=(tload.NpzStream(w, ROWS) if weighted
                               else None), device="cpu", prefetch=2, **kw)
    _assert_fit(t, j, tl, jl)
    # In memory, the port's split seeds see the whole cluster rather than
    # the gathered members: the same rows here, so the fits agree.
    m, ml = tbis.bisecting_kmeans_fit(x, K, sample_weight=w if weighted
                                      else None, device="cpu", **kw)
    np.testing.assert_array_equal(ml, tl)
    np.testing.assert_allclose(float(m.sse), float(t.sse), rtol=RTOL)


def _duplicates():
    rows = np.array([[0.0, 0.0], [5.0, 5.0], [9.0, -3.0]], np.float32)
    return np.repeat(rows, 30, axis=0)


@pytest.mark.parametrize("streamed", [False, True])
def test_too_few_distinct_points_in_the_jax_words(pinned, streamed):
    x = _duplicates()
    errors = []
    for mod, stream, kw in ((jbis, jload.NpzStream, {}),
                            (tbis, tload.NpzStream, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            if streamed:
                mod.streamed_bisecting_kmeans_fit(stream(x, 40), 5, 2,
                                                  max_iters=5, **kw)
            else:
                mod.bisecting_kmeans_fit(x, 5, max_iters=5, **kw)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert "no splittable cluster left after 3 clusters" in errors[1]


def test_argument_errors_in_the_jax_words():
    x, _ = _blobs()
    for kw, words in (({"bisecting_strategy": "median"},
                       "bisecting_strategy must be one of"),):
        with pytest.raises(ValueError, match=words):
            tbis.bisecting_kmeans_fit(x, 3, device="cpu", **kw)
        with pytest.raises(ValueError, match=words):
            jbis.bisecting_kmeans_fit(x, 3, **kw)
    with pytest.raises(ValueError, match="n_obs=5 < K=6"):
        tbis.bisecting_kmeans_fit(x[:5], 6, device="cpu")
    with pytest.raises(ValueError, match="k must be >= 1"):
        tbis.streamed_bisecting_kmeans_fit(tload.NpzStream(x, ROWS), 0, D,
                                           device="cpu")


def test_repeats_bitwise_and_counts_every_split():
    x, w = _blobs(2)
    a = tbis.bisecting_kmeans_fit(x, K, sample_weight=w, device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    b = tbis.bisecting_kmeans_fit(x, K, sample_weight=w, device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.centroids, b.centroids) and a.sse == b.sse
    assert a.n_iter >= K - 1


# Two gloo ranks: each split's 2-means data parallel, in memory (N = 901
# zero-weight-padded to 902) and streamed, against one process.

MESH_N = N + 1


def _mesh_job(world):
    tkm.init_kmeans_pp = pin_port
    x, w = _blobs(3, n=MESH_N)
    mesh = tmesh.make_mesh(world)
    out = {}
    for strategy in ("biggest_inertia", "largest_cluster"):
        res, lab = tbis.bisecting_kmeans_fit(
            x, K, max_iters=15, bisecting_strategy=strategy, mesh=mesh,
            return_labels=True, device="cpu")
        out["mem", strategy] = (res.centroids.numpy(), float(res.sse),
                                res.n_iter, lab)
    res, lab = tbis.streamed_bisecting_kmeans_fit(
        tload.NpzStream(x, ROWS), K, D, max_iters=15, mesh=mesh,
        sample_weight_batches=tload.NpzStream(w, ROWS), return_labels=True,
        device="cpu")
    out["streamed"] = (res.centroids.numpy(), float(res.sse), res.n_iter,
                       lab)
    return out


def _rank_main(rank, world, init_method, queue):
    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        queue.put((rank, _mesh_job(world)))
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
def ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("bis_ranks"), 2)


@pytest.mark.parametrize("case", [("mem", "biggest_inertia"),
                                  ("mem", "largest_cluster"), "streamed"])
def test_mesh_against_one_process(ranks, pinned, case):
    a, b = ranks[0][case], ranks[1][case]
    for u, v in zip(a, b):  # every rank: the same bits
        assert np.array_equal(np.asarray(u), np.asarray(v))
    x, w = _blobs(3, n=MESH_N)
    if case == "streamed":
        one, lab = tbis.streamed_bisecting_kmeans_fit(
            tload.NpzStream(x, ROWS), K, D, max_iters=15,
            sample_weight_batches=tload.NpzStream(w, ROWS),
            return_labels=True, device="cpu")
    else:
        one, lab = tbis.bisecting_kmeans_fit(
            x, K, max_iters=15, bisecting_strategy=case[1],
            return_labels=True, device="cpu")
    c, sse, n_iter, labels = a
    np.testing.assert_allclose(c, one.centroids.numpy(), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(sse, float(one.sse), rtol=RTOL)
    assert n_iter == one.n_iter
    np.testing.assert_array_equal(labels, lab)
