"""tdc_tpu_torch — the PyTorch/CUDA port of `tdc_tpu` for NVIDIA Hopper.

Module paths mirror `tdc_tpu/`, so each file names its JAX counterpart.
The port imports `torch` and `numpy` only: nothing of JAX and nothing of
`tdc_tpu`. Every TPU kernel on the ported path is a hand-written CUDA
kernel under `csrc/`, built with `nvcc` at first use (ops/_build.py).

Numerics are float32 throughout. The package turns TF32 off for matrix
products and convolutions when `tdc_tpu_torch.utils.device` is imported
(every entry point does), so a plain f32 matmul on the card keeps full
f32 precision like the JAX package's HIGHEST-precision dots.

Entry points take `device=None`, which means "cuda"; with no card they
raise instead of falling back to the CPU. Pass `device="cpu"` to run the
plain PyTorch versions of the kernels on the CPU (the tests do).

The public names resolve lazily (PEP 562): `import tdc_tpu_torch` does
not import torch.
"""

__version__ = "0.1.0"

_LAZY = {
    "FuzzyCMeansResult": ("tdc_tpu_torch.models.fuzzy", "FuzzyCMeansResult"),
    "fuzzy_cmeans_fit": ("tdc_tpu_torch.models.fuzzy", "fuzzy_cmeans_fit"),
    "fuzzy_predict": ("tdc_tpu_torch.models.fuzzy", "fuzzy_predict"),
    "predict_proba": ("tdc_tpu_torch.models.fuzzy", "predict_proba"),
    "fuzzy_state_from_numpy": ("tdc_tpu_torch.convert",
                               "fuzzy_state_from_numpy"),
    "GMMResult": ("tdc_tpu_torch.models.gmm", "GMMResult"),
    "gmm_fit": ("tdc_tpu_torch.models.gmm", "gmm_fit"),
    "gmm_predict": ("tdc_tpu_torch.models.gmm", "gmm_predict"),
    "gmm_predict_proba": ("tdc_tpu_torch.models.gmm", "gmm_predict_proba"),
    "gmm_state_from_numpy": ("tdc_tpu_torch.convert", "gmm_state_from_numpy"),
    "KMeansResult": ("tdc_tpu_torch.models.kmeans", "KMeansResult"),
    "kmeans_fit": ("tdc_tpu_torch.models.kmeans", "kmeans_fit"),
    "kmeans_predict": ("tdc_tpu_torch.models.kmeans", "kmeans_predict"),
    "kmeans_state_from_numpy": ("tdc_tpu_torch.convert",
                                "kmeans_state_from_numpy"),
    "to_numpy": ("tdc_tpu_torch.convert", "to_numpy"),
    "KMeans": ("tdc_tpu_torch.models.estimators", "KMeans"),
    "BisectingKMeans": ("tdc_tpu_torch.models.estimators",
                        "BisectingKMeans"),
    "FuzzyCMeans": ("tdc_tpu_torch.models.estimators", "FuzzyCMeans"),
    "GaussianMixture": ("tdc_tpu_torch.models.estimators",
                        "GaussianMixture"),
    "MiniBatchKMeans": ("tdc_tpu_torch.models.minibatch", "MiniBatchKMeans"),
    "minibatch_kmeans_fit": ("tdc_tpu_torch.models.minibatch",
                             "minibatch_kmeans_fit"),
    "bisecting_kmeans_fit": ("tdc_tpu_torch.models.bisecting",
                             "bisecting_kmeans_fit"),
    "init_kmeans_parallel": ("tdc_tpu_torch.ops.kmeans_parallel",
                             "init_kmeans_parallel"),
    "save_fitted": ("tdc_tpu_torch.models.persist", "save_fitted"),
    "load_fitted": ("tdc_tpu_torch.models.persist", "load_fitted"),
    "silhouette_score": ("tdc_tpu_torch.analysis.metrics",
                         "silhouette_score"),
    "davies_bouldin_score": ("tdc_tpu_torch.analysis.metrics",
                             "davies_bouldin_score"),
    "calinski_harabasz_score": ("tdc_tpu_torch.analysis.metrics",
                                "calinski_harabasz_score"),
    "make_mesh": ("tdc_tpu_torch.parallel.mesh", "make_mesh"),
}

__all__ = [*_LAZY, "__version__"]


def __getattr__(name: str):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(__all__)
