"""Clustering algorithms (counterpart: tdc_tpu/models). Lloyd K-Means,
Fuzzy C-Means and Gaussian Mixture EM, in memory and streamed
(`models/streaming.py`, `streamed_gmm_fit`), are ported; ROADMAP.md
Queue A lists the rest."""

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
from tdc_tpu_torch.models.streaming import (
    mean_combine_fit,
    streamed_fuzzy_fit,
    streamed_kmeans_fit,
    streaming_fold,
)

__all__ = ["COVARIANCE_TYPES", "FuzzyCMeansResult", "GMMResult",
           "KMeansResult", "fuzzy_cmeans_fit", "fuzzy_predict", "gmm_aic",
           "gmm_bic", "gmm_fit", "gmm_n_parameters", "gmm_predict",
           "gmm_predict_proba", "gmm_sample", "gmm_score",
           "gmm_score_samples", "kmeans_fit", "kmeans_predict",
           "mean_combine_fit", "predict_proba", "streamed_fuzzy_fit",
           "streamed_gmm_fit", "streamed_kmeans_fit", "streaming_fold"]
