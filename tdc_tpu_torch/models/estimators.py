"""sklearn-style estimators over the functional fits (counterpart:
tdc_tpu/models/estimators.py).

fit / predict / fit_predict / transform / score, with cluster_centers_,
inertia_, n_iter_ and the other fitted attributes as numpy arrays, the
JAX package's constructor arguments and defaults, and two additions:
`random_state` seeds a `torch.Generator` on the estimator's device, and
`device` (None means 'cuda'; 'cpu' runs the plain versions) says where
the fit runs. FuzzyCMeans and GaussianMixture also take `kernel`
('xla', the JAX package's path, or 'pallas': B6 and B9).
"""

from __future__ import annotations

import numpy as np
import torch

from tdc_tpu_torch.models.fuzzy import fuzzy_cmeans_fit, fuzzy_predict
from tdc_tpu_torch.models.kmeans import _as_points, kmeans_fit, kmeans_predict
from tdc_tpu_torch.ops.distance import pairwise_dist, pairwise_sq_dist
from tdc_tpu_torch.utils.device import resolve_device


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Estimator:
    def _generator(self, offset: int = 0) -> torch.Generator:
        return torch.Generator(device=self._device()).manual_seed(
            int(self.random_state) + offset)

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    def _check_fitted(self, attr: str = "cluster_centers_"):
        if not hasattr(self, attr):
            raise AttributeError("estimator is not fitted; call fit(X) first")


class KMeans(_Estimator):
    """K-Means estimator (Lloyd on the GPU).

    Differences from sklearn: `init` also accepts 'kmeans||' and 'first_k';
    `spherical=True` gives cosine K-Means; `mesh` shards points over ranks;
    `kernel='pallas'` runs the CUDA kernels (B1; B4 with sample weights).
    `n_init` defaults to 1, not sklearn's 10: one seeding per fit.
    """

    def __init__(self, n_clusters: int = 8, *, init="kmeans++",
                 max_iter: int = 300, tol: float = 1e-4,
                 random_state: int = 0, spherical: bool = False, mesh=None,
                 kernel: str = "xla", n_init: int = 1, device=None):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.spherical = spherical
        self.mesh = mesh
        self.kernel = kernel
        self.n_init = n_init
        self.device = device

    def fit(self, X, y=None, sample_weight=None) -> "KMeans":
        dev = self._device()
        x = _as_points(X, dev)
        res = kmeans_fit(x, self.n_clusters, init=self.init,
                         generator=self._generator(),
                         max_iters=self.max_iter, tol=self.tol,
                         spherical=self.spherical, mesh=self.mesh,
                         kernel=self.kernel, sample_weight=sample_weight,
                         n_init=self.n_init, device=dev)
        self.cluster_centers_ = _numpy(res.centroids)
        self.inertia_ = float(res.sse)
        self.n_iter_ = int(res.n_iter)
        self.converged_ = bool(res.converged)
        self.labels_ = _numpy(kmeans_predict(x, res.centroids,
                                             spherical=self.spherical,
                                             device=dev))
        return self

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        return _numpy(kmeans_predict(X, self.cluster_centers_,
                                     spherical=self.spherical,
                                     device=self._device()))

    def fit_predict(self, X, y=None, sample_weight=None) -> np.ndarray:
        return self.fit(X, sample_weight=sample_weight).labels_

    def _distances(self, X, fn) -> torch.Tensor:
        self._check_fitted()
        dev = self._device()
        return fn(_as_points(X, dev).float(),
                  torch.from_numpy(self.cluster_centers_).to(dev))

    def transform(self, X) -> np.ndarray:
        """Distances to each center (sklearn semantics)."""
        return _numpy(self._distances(X, pairwise_dist))

    def score(self, X, y=None) -> float:
        """Negative sum of squared distances to the closest center on X
        (sklearn semantics: higher is better)."""
        d2 = self._distances(X, pairwise_sq_dist)
        return -float(d2.min(dim=1).values.sum())


class BisectingKMeans(_Estimator):
    """sklearn.cluster.BisectingKMeans-style facade over
    models/bisecting.py. `labels_`/`inertia_` come from the hierarchical
    split assignment; `predict()` uses the flat nearest-center rule, which
    can differ on boundary points, as sklearn's tree-descent predict
    can."""

    def __init__(self, n_clusters: int = 8, *, max_iter: int = 300,
                 tol: float = 1e-4, random_state: int = 0, n_init: int = 1,
                 bisecting_strategy: str = "biggest_inertia", device=None):
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.n_init = n_init
        self.bisecting_strategy = bisecting_strategy
        self.device = device

    def fit(self, X, y=None, sample_weight=None) -> "BisectingKMeans":
        from tdc_tpu_torch.models.bisecting import bisecting_kmeans_fit

        res, labels = bisecting_kmeans_fit(
            X, self.n_clusters, generator=self._generator(),
            max_iters=self.max_iter, tol=self.tol, n_init=self.n_init,
            bisecting_strategy=self.bisecting_strategy,
            sample_weight=sample_weight, return_labels=True,
            device=self._device())
        self.cluster_centers_ = _numpy(res.centroids)
        self.inertia_ = float(res.sse)
        self.n_iter_ = int(res.n_iter)
        self.labels_ = labels
        return self

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        return _numpy(kmeans_predict(X, self.cluster_centers_,
                                     device=self._device()))

    def fit_predict(self, X, y=None, sample_weight=None) -> np.ndarray:
        return self.fit(X, sample_weight=sample_weight).labels_


class FuzzyCMeans(_Estimator):
    """Fuzzy C-Means estimator with an explicit fuzzifier m."""

    def __init__(self, n_clusters: int = 8, *, m: float = 2.0,
                 init="kmeans++", max_iter: int = 300, tol: float = 1e-4,
                 random_state: int = 0, mesh=None, kernel: str = "xla",
                 device=None):
        self.n_clusters = n_clusters
        self.m = m
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.mesh = mesh
        self.kernel = kernel
        self.device = device

    def fit(self, X, y=None, sample_weight=None) -> "FuzzyCMeans":
        dev = self._device()
        x = _as_points(X, dev)
        res = fuzzy_cmeans_fit(x, self.n_clusters, m=self.m, init=self.init,
                               generator=self._generator(),
                               max_iters=self.max_iter, tol=self.tol,
                               mesh=self.mesh, sample_weight=sample_weight,
                               kernel=self.kernel, device=dev)
        self.cluster_centers_ = _numpy(res.centroids)
        self.objective_ = float(res.objective)
        self.n_iter_ = int(res.n_iter)
        self.converged_ = bool(res.converged)
        self.labels_ = _numpy(fuzzy_predict(x, res.centroids, m=self.m,
                                            device=dev))
        return self

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        return _numpy(fuzzy_predict(X, self.cluster_centers_, m=self.m,
                                    device=self._device()))

    def predict_proba(self, X) -> np.ndarray:
        """Membership matrix (N, K), rows sum to 1."""
        self._check_fitted()
        return _numpy(fuzzy_predict(X, self.cluster_centers_, m=self.m,
                                    soft=True, device=self._device()))

    def fit_predict(self, X, y=None, sample_weight=None) -> np.ndarray:
        return self.fit(X, sample_weight=sample_weight).labels_


class GaussianMixture(_Estimator):
    """GMM estimator (sklearn.mixture facade over models/gmm.py). All four
    covariance types; covariances_ takes the sklearn shape for the type.
    Beyond sklearn: fit() accepts sample_weight."""

    def __init__(self, n_components: int = 1, *,
                 covariance_type: str = "diag", init="kmeans",
                 max_iter: int = 100, tol: float = 1e-4,
                 reg_covar: float = 1e-6, random_state: int = 0, mesh=None,
                 kernel: str = "xla", device=None):
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.reg_covar = reg_covar
        self.random_state = random_state
        self.mesh = mesh
        self.kernel = kernel
        self.device = device

    def fit(self, X, y=None, sample_weight=None) -> "GaussianMixture":
        from tdc_tpu_torch.models.gmm import gmm_fit

        res = gmm_fit(X, self.n_components, init=self.init,
                      generator=self._generator(), max_iters=self.max_iter,
                      tol=self.tol, reg_covar=self.reg_covar, mesh=self.mesh,
                      covariance_type=self.covariance_type,
                      sample_weight=sample_weight, kernel=self.kernel,
                      device=self._device())
        self._result = res
        self.means_ = _numpy(res.means)
        self.covariances_ = _numpy(res.variances)
        self.weights_ = _numpy(res.weights)
        self.n_iter_ = int(res.n_iter)
        self.converged_ = bool(res.converged)
        self.lower_bound_ = float(res.log_likelihood)
        # No labels_ on fit (sklearn parity): labels cost an extra E-step
        # pass; fit_predict and predict compute them on demand.
        return self

    def predict(self, X) -> np.ndarray:
        from tdc_tpu_torch.models.gmm import gmm_predict

        self._check_fitted("_result")
        return _numpy(gmm_predict(X, self._result))

    def predict_proba(self, X) -> np.ndarray:
        from tdc_tpu_torch.models.gmm import gmm_predict_proba

        self._check_fitted("_result")
        return _numpy(gmm_predict_proba(X, self._result))

    def score(self, X, y=None) -> float:
        from tdc_tpu_torch.models.gmm import gmm_score

        self._check_fitted("_result")
        return gmm_score(X, self._result)

    def score_samples(self, X) -> np.ndarray:
        from tdc_tpu_torch.models.gmm import gmm_score_samples

        self._check_fitted("_result")
        return _numpy(gmm_score_samples(X, self._result))

    def bic(self, X) -> float:
        from tdc_tpu_torch.models.gmm import gmm_bic

        self._check_fitted("_result")
        return gmm_bic(X, self._result)

    def aic(self, X) -> float:
        from tdc_tpu_torch.models.gmm import gmm_aic

        self._check_fitted("_result")
        return gmm_aic(X, self._result)

    def sample(self, n_samples: int = 1):
        """(X (n, d), labels (n,)) drawn from the fitted mixture, from a
        generator seeded with random_state + 1."""
        from tdc_tpu_torch.models.gmm import gmm_sample

        self._check_fitted("_result")
        x, labels = gmm_sample(self._result, n_samples, self._generator(1))
        return _numpy(x), _numpy(labels)

    def fit_predict(self, X, y=None, sample_weight=None) -> np.ndarray:
        return self.fit(X, sample_weight=sample_weight).predict(X)


__all__ = ["BisectingKMeans", "FuzzyCMeans", "GaussianMixture", "KMeans"]
