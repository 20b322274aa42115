"""The port's clustering quality metrics against the JAX package's, on the
CPU: silhouette, Davies-Bouldin and Calinski-Harabasz within rtol 1e-5
(float32 sums in another order), on blobs, with singleton clusters and
with non-contiguous label ids, for several silhouette row blocks."""

import numpy as np
import pytest
import torch

from tdc_tpu.analysis import metrics as jmet
from tdc_tpu_torch.analysis import metrics as tmet

RTOL = 1e-5
METRICS = ("silhouette_score", "davies_bouldin_score",
           "calinski_harabasz_score")


def _data(case):
    rng = np.random.default_rng(0)
    centers = rng.uniform(-6, 6, size=(5, 3))
    labels = rng.integers(0, 5, size=500)
    x = (centers[labels] + rng.normal(size=(500, 3))).astype(np.float32)
    if case == "singletons":
        labels = labels.copy()
        labels[7] = 5
        labels[19] = 6
    elif case == "non_contiguous":
        labels = np.array([3, 17, 40, 41, 999])[labels]
    return x, labels


@pytest.mark.parametrize("case", ["blobs", "singletons", "non_contiguous"])
@pytest.mark.parametrize("metric", METRICS)
def test_metric_against_jax(case, metric):
    x, labels = _data(case)
    want = getattr(jmet, metric)(x, labels)
    got = getattr(tmet, metric)(x, labels, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # Tensor inputs give the same value.
    assert getattr(tmet, metric)(torch.from_numpy(x),
                                 torch.from_numpy(labels),
                                 device="cpu") == got


@pytest.mark.parametrize("block_rows", [1, 37, 500, 4096])
def test_silhouette_row_blocks(block_rows):
    x, labels = _data("singletons")
    np.testing.assert_allclose(
        tmet.silhouette_score(x, labels, block_rows=block_rows,
                              device="cpu"),
        jmet.silhouette_score(x, labels), rtol=RTOL)


@pytest.mark.parametrize("metric", METRICS)
def test_one_cluster_raises_in_the_jax_words(metric):
    x, _ = _data("blobs")
    with pytest.raises(ValueError) as j:
        getattr(jmet, metric)(x, np.zeros(len(x), int))
    with pytest.raises(ValueError) as t:
        getattr(tmet, metric)(x, np.zeros(len(x), int), device="cpu")
    assert str(t.value) == str(j.value)


def test_calinski_harabasz_points_on_their_means():
    x = np.repeat(np.array([[0.0, 1.0], [4.0, 4.0]], np.float32), 5, axis=0)
    labels = np.repeat([0, 1], 5)
    assert tmet.calinski_harabasz_score(x, labels, device="cpu") == 1.0
    assert jmet.calinski_harabasz_score(x, labels) == 1.0
