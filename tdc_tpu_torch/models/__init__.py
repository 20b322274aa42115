"""Clustering algorithms (counterpart: tdc_tpu/models). Only Lloyd K-Means
is ported in this slice; ROADMAP.md Queue A lists the rest."""

from tdc_tpu_torch.models.kmeans import KMeansResult, kmeans_fit, kmeans_predict

__all__ = ["KMeansResult", "kmeans_fit", "kmeans_predict"]
