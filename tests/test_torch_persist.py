"""Fitted-model persistence of the port against the JAX package's, on the
CPU: a model saved by either package loads in the other and predicts the
same labels (exactly: the same centroids, the same nearest-center rule,
blobs far from ties); both write the same content-hash `version` and the
same manifest for the same arrays; retention, pinning, staging and the
fingerprint behave alike; a checkpoint directory raises, naming
ROADMAP.md A7(b)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tdc_tpu.models import fuzzy as jfz
from tdc_tpu.models import gmm as jgmm
from tdc_tpu.models import kmeans as jkm
from tdc_tpu.models import persist as jper
from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.models import persist as tper


def _blobs(seed=0, n=800, k=5, d=4):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)].copy()


def _fits(model, x, init):
    """(JAX result, port result) from the same explicit init."""
    if model == "kmeans":
        return (jkm.kmeans_fit(x, len(init), init=init, max_iters=10),
                tkm.kmeans_fit(x, len(init), init=init, max_iters=10,
                               device="cpu"))
    if model == "fuzzy":
        return (jfz.fuzzy_cmeans_fit(x, len(init), init=init, max_iters=10),
                tfz.fuzzy_cmeans_fit(x, len(init), init=init, max_iters=10,
                                     device="cpu"))
    return (jgmm.gmm_fit(x, len(init), init=init, max_iters=10,
                         key=jax.random.PRNGKey(0)),
            tgmm.gmm_fit(x, len(init), init=init, max_iters=10,
                         device="cpu"))


def _predict_port(fm, x):
    if fm.model == "gmm":
        res = tgmm.GMMResult(
            means=torch.from_numpy(fm.arrays["means"]),
            variances=torch.from_numpy(fm.arrays["variances"]),
            weights=torch.from_numpy(fm.arrays["weights"]), n_iter=0,
            converged=True,
            covariance_type=fm.params["covariance_type"],
            log_likelihood=torch.tensor(0.0))
        return tgmm.gmm_predict(x, res).numpy()
    return tkm.kmeans_predict(x, fm.centroids, device="cpu").numpy()


def _predict_jax(fm, x):
    if fm.model == "gmm":
        res = jgmm.GMMResult(
            means=fm.arrays["means"], variances=fm.arrays["variances"],
            weights=fm.arrays["weights"], n_iter=0, converged=True,
            covariance_type=fm.params["covariance_type"],
            log_likelihood=0.0)
        return np.asarray(jgmm.gmm_predict(x, res))
    return np.asarray(jkm.kmeans_predict(x, fm.centroids))


@pytest.mark.parametrize("model", ["kmeans", "fuzzy", "gmm"])
def test_saved_by_either_loads_in_the_other(tmp_path, model):
    x, init = _blobs()
    j, t = _fits(model, x, init)
    jv = jper.save_fitted(str(tmp_path / "jax"), j)
    tv = tper.save_fitted(str(tmp_path / "port"), t)
    from_jax = tper.load_fitted(str(tmp_path / "jax"))
    from_port = jper.load_fitted(str(tmp_path / "port"))
    assert (from_jax.model, from_jax.version) == (model, jv)
    assert (from_port.model, from_port.version) == (model, tv)
    np.testing.assert_array_equal(_predict_port(from_jax, x),
                                  _predict_jax(from_jax, x))
    np.testing.assert_array_equal(_predict_jax(from_port, x),
                                  _predict_port(from_port, x))
    assert from_port.params == from_jax.params


@pytest.mark.parametrize("model", ["kmeans", "gmm"])
def test_same_arrays_same_version_and_manifest(tmp_path, model):
    rng = np.random.default_rng(1)
    arrays = ({"centroids": rng.normal(size=(6, 3)).astype(np.float32)}
              if model == "kmeans" else
              {"means": rng.normal(size=(4, 3)).astype(np.float32),
               "variances": rng.uniform(1, 2, (4, 3)).astype(np.float32),
               "weights": np.full(4, 0.25, np.float32)})
    kw = dict(model=model, arrays=arrays, kernel="xla",
              params={"covariance_type": "diag"} if model == "gmm" else {})
    jv = jper.save_fitted(str(tmp_path / "j"), **kw)
    tv = tper.save_fitted(str(tmp_path / "t"), **kw)
    assert jv == tv == tper._arrays_version(arrays)
    for name in (tper.MANIFEST_NAME, f"arrays-{tv}.npz"):
        assert (open(tmp_path / "j" / name, "rb").read()
                == open(tmp_path / "t" / name, "rb").read()), name
    # A port result and a JAX result with the same centroids hash alike.
    if model == "kmeans":
        c = arrays["centroids"]
        res = tkm.KMeansResult(centroids=torch.from_numpy(c), n_iter=1,
                               sse=torch.tensor(0.0),
                               shift=torch.tensor(0.0), converged=True)
        assert tper.save_fitted(str(tmp_path / "r"), res) == tv


def test_retention_pinning_staging_and_fingerprint(tmp_path):
    d = str(tmp_path / "m")
    assert tper.manifest_fingerprint(d) is None
    versions = []
    for i in range(4):
        c = np.full((2, 2), float(i), np.float32)
        versions.append(tper.save_fitted(
            d, model="kmeans", arrays={"centroids": c},
            pinned_versions=versions[:1]))
        os.utime(os.path.join(d, f"arrays-{versions[-1]}.npz"),
                 (i + 1, i + 1))
    # keep_versions=2: the current and one before, plus the pinned first.
    assert tper.list_array_versions(d) == sorted(
        [versions[0], versions[2], versions[3]])
    staged = tper.stage_arrays(d, {"centroids": np.ones((2, 2),
                                                        np.float32)})
    assert staged in tper.list_array_versions(d)
    assert tper.load_fitted(d).version == versions[3]  # not yet live
    fp = tper.manifest_fingerprint(d)
    assert fp[2] == versions[3] and fp == jper.manifest_fingerprint(d)
    man = json.load(open(os.path.join(d, tper.MANIFEST_NAME)))
    assert man["arrays"] == f"arrays-{versions[3]}.npz"


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="unknown model type"):
        tper.save_fitted(str(tmp_path / "a"), model="svm",
                         arrays={"centroids": np.zeros((1, 1))})
    with pytest.raises(ValueError, match="missing arrays"):
        tper.save_fitted(str(tmp_path / "a"), model="gmm",
                         arrays={"means": np.zeros((1, 1))})
    with pytest.raises(TypeError, match="cannot persist"):
        tper.save_fitted(str(tmp_path / "a"), object())
    with pytest.raises(FileNotFoundError):
        tper.load_fitted(str(tmp_path / "empty"))
    ck = tmp_path / "ckpt"
    (ck / "step_00000003").mkdir(parents=True)
    # A checkpoint directory whose only step holds no state yet (a crash
    # before the first write): no loadable step, as in the JAX package.
    with pytest.raises(FileNotFoundError, match="loadable checkpoint step"):
        tper.load_fitted(str(ck))
    with pytest.raises(FileNotFoundError, match="loadable checkpoint step"):
        jper.load_fitted(str(ck))
    assert tper.manifest_fingerprint(str(ck))[:2] == ("ckpt", 3)
    assert tper.manifest_fingerprint(str(ck)) == jper.manifest_fingerprint(
        str(ck))
