"""kmeans_fit / kmeans_predict of the port against the JAX package's, on
the CPU, from the same explicit init array.

Tolerances: n_iter and converged equal; labels equal; centroids within
rtol 1e-5 and atol 1e-5 and SSE within rtol 1e-5 (float32 summation order
differs between the frameworks; the blobs keep every point far from a
tie, so the trajectories do not fork).
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from tdc_tpu.models import kmeans as jkm
from tdc_tpu_torch import convert
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.parallel import mesh as tmesh

RTOL = 1e-5


def _blobs(seed=0, n=2000, k=12, d=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(k, d))
    y = rng.integers(0, k, size=n)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    init = x[rng.choice(n, k, replace=False)].copy()
    return x, init


def _fit_both(x, init, **kw):
    j = jkm.kmeans_fit(x, init.shape[0], init=init, **kw)
    t = tkm.kmeans_fit(x, init.shape[0], init=init, device="cpu", **kw)
    return j, t


def _assert_fit(j, t):
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(t.sse), float(j.sse), rtol=RTOL)


@pytest.mark.parametrize("tol", [-1.0, 1e-4])
@pytest.mark.parametrize("kernel", ["xla", "pallas", "refined"])
def test_kmeans_fit(kernel, tol):
    x, init = _blobs()
    j, t = _fit_both(x, init, max_iters=15, tol=tol, kernel=kernel)
    _assert_fit(j, t)
    if tol < 0:
        assert t.n_iter == 15
    else:
        assert t.converged and t.n_iter < 15


def test_kmeans_fit_auto_resolves_like_jax_on_cpu():
    x, init = _blobs(1)
    _assert_fit(*_fit_both(x, init, max_iters=8, tol=1e-4, kernel="auto"))


def test_kmeans_fit_spherical():
    x, init = _blobs(2)
    _assert_fit(*_fit_both(x, init, max_iters=10, tol=1e-4, spherical=True))


def test_kmeans_fit_relocate_empty_cluster():
    x, init = _blobs(3)
    init[4] = 500.0  # empty from the first iteration on
    j, t = _fit_both(x, init, max_iters=10, tol=-1.0,
                     empty_policy="relocate")
    _assert_fit(j, t)
    assert np.abs(t.centroids.numpy()).max() < 100.0  # it was relocated


def test_refined_fit_with_duplicated_seeds_matches_jax():
    """C4: five copies of x[1] among the seeds. Every tie goes to the
    lowest index, as jax.lax.top_k orders it, so the copies stay empty
    and x[1]'s rows go to centroid 1 in both packages."""
    x = np.random.default_rng(3).normal(size=(2000, 12)).astype(np.float32)
    init = np.concatenate([x[:30], np.repeat(x[1:2], 5, axis=0)])
    j, t = _fit_both(x, init, max_iters=15, tol=1e-4, kernel="refined")
    _assert_fit(j, t)
    from tdc_tpu.ops import assign as jassign
    from tdc_tpu_torch.ops import assign as tassign
    want = np.asarray(jassign.assign_refined(x, np.asarray(j.centroids))[0])
    got = tassign.assign_refined(torch.from_numpy(x), t.centroids)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_relocate_empty_takes_equal_costs_in_top_k_order():
    """C4's second site: rows of equal cost relocate in jax.lax.top_k's
    order (descending cost, the lower index first): (1, 0), then (-1, 0)."""
    x = np.array([[1, 0], [-1, 0], [0, 1], [0, -1], [0, 0], [.5, 0],
                  [0, .5], [-.5, 0], [0, -.5]], np.float32)
    new_c = np.array([[0, 0], [100, 100], [200, 200]], np.float32)
    counts = np.array([9, 0, 0], np.float32)
    want = np.asarray(jkm._relocate_empty(
        jax.numpy.asarray(x), jax.numpy.asarray(new_c),
        jax.numpy.asarray(counts), 0))
    got = tkm._relocate_empty(torch.from_numpy(x), torch.from_numpy(new_c),
                              torch.from_numpy(counts), 0).numpy()
    np.testing.assert_array_equal(want[1:], [[1, 0], [-1, 0]])
    np.testing.assert_array_equal(got, want)


def test_kmeans_fit_history():
    x, init = _blobs(4)
    j, t = _fit_both(x, init, max_iters=12, tol=1e-4, history=True)
    _assert_fit(j, t)
    assert t.history.shape == (t.n_iter, 2)
    np.testing.assert_allclose(t.history, np.asarray(j.history), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_kmeans_predict_from_converted_state(kernel):
    x, init = _blobs(5)
    j = jkm.kmeans_fit(x, init.shape[0], init=init, max_iters=5)
    state = convert.kmeans_state_from_numpy(
        np.asarray(j.centroids), n_iter=int(j.n_iter), sse=float(j.sse),
        shift=float(j.shift), converged=bool(j.converged), device="cpu")
    got = tkm.kmeans_predict(x, state.centroids, kernel=kernel, device="cpu")
    want = jkm.kmeans_predict(x, j.centroids, kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = convert.to_numpy(state)
    np.testing.assert_array_equal(back["centroids"], np.asarray(j.centroids))
    assert back["n_iter"] == int(j.n_iter)
    assert back["converged"] == bool(j.converged)


def test_whole_slice_fit_in_jax_predict_in_port():
    # The JAX package fits with its own k-means++ seeding; the port takes
    # the state over and labels the points exactly as the JAX package does.
    x, _ = _blobs(6, n=3000, k=20, d=10)
    j = jkm.kmeans_fit(x, 20, key=jax.random.PRNGKey(3), max_iters=30,
                       kernel="pallas")
    state = convert.kmeans_state_from_numpy(np.asarray(j.centroids),
                                            device="cpu")
    got = tkm.kmeans_predict(x, state.centroids, kernel="pallas",
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jkm.kmeans_predict(
                                      x, j.centroids, kernel="xla")))
    # And the port's own fit from the JAX init reaches the same model.
    t = tkm.kmeans_fit(x, 20, init=np.asarray(
        jkm.resolve_init(jax.numpy.asarray(x), 20, "kmeans++",
                         jax.random.PRNGKey(3))),
        max_iters=30, kernel="pallas", device="cpu")
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)


def test_kmeans_fit_stochastic_init_is_seeded():
    x, _ = _blobs(7)
    fits = [tkm.kmeans_fit(x, 12, init=init, max_iters=5, device="cpu",
                           generator=torch.Generator().manual_seed(11))
            for init in ("kmeans++", "kmeans++", "random")]
    assert torch.equal(fits[0].centroids, fits[1].centroids)
    best = tkm.kmeans_fit(x, 12, init="random", n_init=3, max_iters=5,
                          device="cpu",
                          generator=torch.Generator().manual_seed(11))
    assert float(best.sse) <= float(fits[2].sse) + 1e-3


# A mesh of one rank needs no process group.
ONE_RANK = tmesh.make_mesh(1)


@pytest.mark.parametrize("kw", [
    {"mesh": ONE_RANK, "empty_policy": "relocate"},
])
def test_unported_options_raise_naming_the_roadmap(kw):
    # Relocation with a mesh raised NotImplementedError (naming A4) before
    # it was ported. Now: on a one-rank mesh it is the mesh-less fit, the
    # doomed seed relocated (tests/test_kmeans.py:140's input).
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal([0, 0], 0.2, (50, 2)),
                        rng.normal([8, 0], 0.2, (50, 2))]).astype(np.float32)
    init = np.array([[0.1, 0.0], [7.9, 0.0], [500.0, 500.0]], np.float32)
    got = tkm.kmeans_fit(x, 3, init=init, device="cpu", max_iters=2, **kw)
    kw = {k: v for k, v in kw.items() if k != "mesh"}
    want = tkm.kmeans_fit(x, 3, init=init, device="cpu", max_iters=2, **kw)
    assert got.n_iter == want.n_iter
    torch.testing.assert_close(got.centroids, want.centroids, rtol=0,
                               atol=1e-6)
    assert float(got.centroids[2].abs().max()) < 100.0


@pytest.mark.parametrize("weighted_on_a_mesh", [True, False])
def test_kmeans_parallel_init_follows_jax(monkeypatch, weighted_on_a_mesh):
    # Both raised NotImplementedError (naming A8) before k-means‖ was
    # ported. Now: seeded with JAX's draws, the fit is the JAX package's
    # (rank 0 draws and broadcasts on the one-rank mesh).
    from test_torch_kmeans_parallel import JaxDraws, inject

    x, init = _blobs(4)
    w = None
    if weighted_on_a_mesh:
        w = np.random.default_rng(4).uniform(0, 2, len(x)).astype(
            np.float32)
        w[::9] = 0.0
    key = jax.random.PRNGKey(3)
    inject(monkeypatch, JaxDraws(key, len(x), 12, weighted=w is not None))
    j = jkm.kmeans_fit(x, 12, init="kmeans||", key=key, sample_weight=w,
                       max_iters=10, tol=1e-4)
    t = tkm.kmeans_fit(x, 12, init="kmeans||", sample_weight=w,
                       mesh=ONE_RANK if weighted_on_a_mesh else None,
                       max_iters=10, tol=1e-4, device="cpu")
    _assert_fit(j, t)


@pytest.mark.parametrize("case", ["features", "tall_on_samples",
                                  "features_bf16"])
def test_feature_major_options_follow_jax(case):
    # These three raised NotImplementedError (naming B10) before the
    # features layout was ported. Now: the layout fits as the JAX
    # package's does, on f32 and bf16 columns, and kernel='tall' on
    # sample-major points fails in both packages (ValueError in the port,
    # a shape error in the JAX package).
    x, init = _blobs(2, n=1024, k=6, d=5)
    if case == "tall_on_samples":
        for fit, kw in ((jkm.kmeans_fit, {}), (tkm.kmeans_fit,
                                               {"device": "cpu"})):
            with pytest.raises((ValueError, TypeError)):
                fit(x, 6, init=init, max_iters=2, kernel="tall", **kw)
        return
    xt = np.ascontiguousarray(x.T)
    if case == "features_bf16":
        xt = xt.astype(ml_dtypes.bfloat16)
    j = jkm.kmeans_fit(xt, 6, init=init, max_iters=8, tol=1e-4,
                       layout="features")
    t = tkm.kmeans_fit(xt, 6, init=init, max_iters=8, tol=1e-4,
                       layout="features", device="cpu")
    _assert_fit(j, t)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkm.kmeans_fit(np.zeros((10, 2), np.float32), 2)
