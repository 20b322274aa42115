"""Clustering algorithms (counterpart: tdc_tpu/models). Lloyd K-Means and
Fuzzy C-Means are ported; ROADMAP.md Queue A lists the rest."""

from tdc_tpu_torch.models.fuzzy import (
    FuzzyCMeansResult,
    fuzzy_cmeans_fit,
    fuzzy_predict,
    predict_proba,
)
from tdc_tpu_torch.models.kmeans import KMeansResult, kmeans_fit, kmeans_predict

__all__ = ["FuzzyCMeansResult", "KMeansResult", "fuzzy_cmeans_fit",
           "fuzzy_predict", "kmeans_fit", "kmeans_predict", "predict_proba"]
