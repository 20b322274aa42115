"""The port's sklearn-style estimators against the JAX package's, on the
CPU, from the same explicit inits (or, for BisectingKMeans, the same
pinned k-means++; for KMeans(init='kmeans||'), JAX's own draws): the
fitted attributes, predict, fit_predict, transform, score,
predict_proba, score_samples, bic, aic and sample.

Tolerances (float32, another summation order): centers rtol 1e-5 /
atol 1e-5; inertia and objective rtol 1e-5; transform rtol 1e-5 / atol
1e-5; memberships atol 1e-5; labels and n_iter_ equal. GaussianMixture:
the GMM fits' tolerances (means atol 1e-4, covariances rtol 1e-4 / atol
1e-5, weights atol 1e-5, lower bound rtol 1e-5), then its predict side
against the JAX functions on the port's fitted parameters: labels
equal, posteriors atol 1e-4 (a few rows on the edge of a narrow diag
component, where the two packages' rounding of the expanded log-probs
moves a posterior by up to 4.1e-5; the facade's own values equal the
port's functions' bitwise), log p(x) rtol 1e-5 and atol 1e-5 of the
largest |log p(x)| (as test_torch_gmm.py holds log-probs: the expanded
form cancels), the mean score rtol 1e-5, BIC and AIC rtol 1e-6.
"""

import jax
import numpy as np
import pytest

from tdc_tpu.models import estimators as jest
from tdc_tpu.models import kmeans as jkm
from tdc_tpu_torch.models import estimators as test_
from tdc_tpu_torch.models import kmeans as tkm

RTOL = 1e-5


def _blobs(seed=0, n=900, k=6, d=4):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-7, 7, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    w = rng.uniform(0, 2, size=n).astype(np.float32)
    w[::11] = 0.0
    return x, x[rng.choice(n, k, replace=False)].copy(), w


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("kw", [{}, {"kernel": "pallas"},
                                {"spherical": True}, {"weighted": True}])
def test_kmeans(kw):
    kw = dict(kw)
    x, init, w = _blobs()
    sw = w if kw.pop("weighted", False) else None
    j = jest.KMeans(6, init=init, max_iter=30, **kw).fit(x, sample_weight=sw)
    t = test_.KMeans(6, init=init, max_iter=30, device="cpu",
                     **kw).fit(x, sample_weight=sw)
    _close(t.cluster_centers_, j.cluster_centers_)
    np.testing.assert_allclose(t.inertia_, j.inertia_, rtol=RTOL)
    assert (t.n_iter_, t.converged_) == (j.n_iter_, j.converged_)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    np.testing.assert_array_equal(t.predict(x[:100]), j.predict(x[:100]))
    _close(t.transform(x[:50]), j.transform(x[:50]))
    np.testing.assert_allclose(t.score(x), j.score(x), rtol=RTOL)
    np.testing.assert_array_equal(t.fit_predict(x, sample_weight=sw),
                                  t.labels_)


def test_kmeans_parallel_seeded_kmeans(monkeypatch):
    from test_torch_kmeans_parallel import JaxDraws, inject

    x, _, _ = _blobs(1)
    inject(monkeypatch, JaxDraws(jax.random.PRNGKey(3), len(x), 6))
    j = jest.KMeans(6, init="kmeans||", random_state=3).fit(x)
    t = test_.KMeans(6, init="kmeans||", random_state=3,
                     device="cpu").fit(x)
    _close(t.cluster_centers_, j.cluster_centers_)
    np.testing.assert_array_equal(t.labels_, j.labels_)


@pytest.mark.parametrize("strategy", ["biggest_inertia", "largest_cluster"])
def test_bisecting_kmeans(monkeypatch, strategy):
    from test_torch_bisecting import pin_jax, pin_port

    monkeypatch.setattr(jkm, "init_kmeans_pp", pin_jax)
    monkeypatch.setattr(tkm, "init_kmeans_pp", pin_port)
    x, _, w = _blobs(2)
    j = jest.BisectingKMeans(6, max_iter=20, bisecting_strategy=strategy
                             ).fit(x, sample_weight=w)
    t = test_.BisectingKMeans(6, max_iter=20, bisecting_strategy=strategy,
                              device="cpu").fit(x, sample_weight=w)
    _close(t.cluster_centers_, j.cluster_centers_)
    np.testing.assert_allclose(t.inertia_, j.inertia_, rtol=RTOL)
    assert t.n_iter_ == j.n_iter_
    np.testing.assert_array_equal(t.labels_, j.labels_)
    np.testing.assert_array_equal(t.predict(x), j.predict(x))
    np.testing.assert_array_equal(t.fit_predict(x, sample_weight=w),
                                  t.labels_)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_fuzzy_cmeans(kernel):
    x, init, _ = _blobs(3)
    j = jest.FuzzyCMeans(6, m=1.8, init=init, max_iter=40).fit(x)
    t = test_.FuzzyCMeans(6, m=1.8, init=init, max_iter=40, kernel=kernel,
                          device="cpu").fit(x)
    _close(t.cluster_centers_, j.cluster_centers_)
    np.testing.assert_allclose(t.objective_, j.objective_, rtol=RTOL)
    assert (t.n_iter_, t.converged_) == (j.n_iter_, j.converged_)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    np.testing.assert_array_equal(t.predict(x), j.predict(x))
    np.testing.assert_allclose(t.predict_proba(x), j.predict_proba(x),
                               atol=1e-5)


@pytest.mark.parametrize("cov", ["diag", "spherical", "tied", "full"])
def test_gaussian_mixture(cov):
    # The fit against JAX's with the GMM fits' tolerances (PERF.md §6:
    # means atol 1e-4, covariances rtol 1e-4 / atol 1e-5, weights atol
    # 1e-5; EM carries f32 rounding forward), then the predict side
    # against the JAX package's functions on the port's fitted
    # parameters (carried state, as tests/test_torch_gmm.py does).
    from tdc_tpu.models import gmm as jgmm

    x, init, _ = _blobs(4)
    j = jest.GaussianMixture(6, covariance_type=cov, init=init).fit(x)
    t = test_.GaussianMixture(6, covariance_type=cov, init=init,
                              device="cpu").fit(x)
    assert (t.n_iter_, t.converged_) == (j.n_iter_, j.converged_)
    np.testing.assert_allclose(t.means_, j.means_, atol=1e-4)
    np.testing.assert_allclose(t.covariances_, j.covariances_, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t.weights_, j.weights_, atol=1e-5)
    np.testing.assert_allclose(t.lower_bound_, j.lower_bound_, rtol=RTOL)
    carried = jgmm.GMMResult(means=t.means_, variances=t.covariances_,
                             weights=t.weights_, n_iter=t.n_iter_,
                             log_likelihood=t.lower_bound_,
                             converged=t.converged_, covariance_type=cov)
    from tdc_tpu_torch.models import gmm as tgmm

    np.testing.assert_array_equal(t.predict(x),
                                  np.asarray(jgmm.gmm_predict(x, carried)))
    # The facade returns the port's functions' values, bitwise.
    np.testing.assert_array_equal(
        t.predict_proba(x), tgmm.gmm_predict_proba(x, t._result).numpy())
    np.testing.assert_allclose(
        t.predict_proba(x), np.asarray(jgmm.gmm_predict_proba(x, carried)),
        atol=1e-4)
    np.testing.assert_allclose(t.score(x), jgmm.gmm_score(x, carried),
                               rtol=RTOL)
    want = np.asarray(jgmm.gmm_score_samples(x, carried))
    np.testing.assert_array_equal(
        t.score_samples(x), tgmm.gmm_score_samples(x, t._result).numpy())
    np.testing.assert_allclose(t.score_samples(x), want, rtol=RTOL,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(t.bic(x), jgmm.gmm_bic(x, carried),
                               rtol=1e-6)
    np.testing.assert_allclose(t.aic(x), jgmm.gmm_aic(x, carried),
                               rtol=1e-6)
    xs, ls = t.sample(400)
    assert xs.shape == (400, 4) and ls.shape == (400,)
    assert set(np.unique(ls)) <= set(range(6))
    xs2, _ = t.sample(400)
    np.testing.assert_array_equal(xs, xs2)  # random_state + 1, each call
    np.testing.assert_array_equal(t.fit_predict(x), t.predict(x))


def test_unfitted_estimators_raise():
    x, _, _ = _blobs()
    for est in (test_.KMeans(3, device="cpu"),
                test_.BisectingKMeans(3, device="cpu"),
                test_.FuzzyCMeans(3, device="cpu"),
                test_.GaussianMixture(3, device="cpu")):
        with pytest.raises(AttributeError, match="not fitted"):
            est.predict(x)


def test_random_state_seeds_the_fit():
    x, _, _ = _blobs(5)
    a = test_.KMeans(6, random_state=7, device="cpu").fit(x)
    b = test_.KMeans(6, random_state=7, device="cpu").fit(x)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
