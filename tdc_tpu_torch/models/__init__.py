"""Clustering algorithms (counterpart: tdc_tpu/models): Lloyd K-Means,
Fuzzy C-Means and Gaussian Mixture EM, in memory and streamed
(`models/streaming.py`, `streamed_gmm_fit`), mini-batch and bisecting
K-Means, the sklearn-style estimators and fitted-model persistence."""

from tdc_tpu_torch.models.bisecting import (
    bisecting_kmeans_fit,
    streamed_bisecting_kmeans_fit,
)
from tdc_tpu_torch.models.estimators import (
    BisectingKMeans,
    FuzzyCMeans,
    GaussianMixture,
    KMeans,
)
from tdc_tpu_torch.models.fuzzy import (
    FuzzyCMeansResult,
    fuzzy_cmeans_fit,
    fuzzy_predict,
    predict_proba,
)
from tdc_tpu_torch.models.gmm import (
    COVARIANCE_TYPES,
    GMMResult,
    gmm_aic,
    gmm_bic,
    gmm_fit,
    gmm_n_parameters,
    gmm_predict,
    gmm_predict_proba,
    gmm_sample,
    gmm_score,
    gmm_score_samples,
    streamed_gmm_fit,
)
from tdc_tpu_torch.models.kmeans import KMeansResult, kmeans_fit, kmeans_predict
from tdc_tpu_torch.models.minibatch import (
    MiniBatchKMeans,
    MiniBatchState,
    minibatch_kmeans_fit,
    minibatch_step,
)
from tdc_tpu_torch.models.persist import FittedModel, load_fitted, save_fitted
from tdc_tpu_torch.models.streaming import (
    mean_combine_fit,
    streamed_fuzzy_fit,
    streamed_kmeans_fit,
    streaming_fold,
)

__all__ = ["BisectingKMeans", "COVARIANCE_TYPES", "FittedModel",
           "FuzzyCMeans", "FuzzyCMeansResult", "GMMResult",
           "GaussianMixture", "KMeans", "KMeansResult", "MiniBatchKMeans",
           "MiniBatchState", "bisecting_kmeans_fit", "fuzzy_cmeans_fit",
           "fuzzy_predict", "gmm_aic", "gmm_bic", "gmm_fit",
           "gmm_n_parameters", "gmm_predict", "gmm_predict_proba",
           "gmm_sample", "gmm_score", "gmm_score_samples", "kmeans_fit",
           "kmeans_predict", "load_fitted", "mean_combine_fit",
           "minibatch_kmeans_fit", "minibatch_step", "predict_proba",
           "save_fitted", "streamed_bisecting_kmeans_fit",
           "streamed_fuzzy_fit", "streamed_gmm_fit", "streamed_kmeans_fit",
           "streaming_fold"]
