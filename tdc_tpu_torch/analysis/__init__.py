"""Clustering quality metrics (counterpart: tdc_tpu/analysis; its
`compile_results.py` and `plots.py` are not ported: ROADMAP.md Queue A,
A12)."""

from tdc_tpu_torch.analysis.metrics import (
    calinski_harabasz_score,
    davies_bouldin_score,
    silhouette_score,
)

__all__ = [
    "calinski_harabasz_score",
    "davies_bouldin_score",
    "silhouette_score",
]
