"""Fitted-model persistence (counterpart: tdc_tpu/models/persist.py).

A fitted model is two files in a directory, the JAX package's format
byte for byte, so a model saved by either package loads in the other:

    <model_dir>/arrays-<version>.npz   # the parameter arrays
    <model_dir>/manifest.json          # type/k/d/dtype/kernel + array file

The manifest is written last with an atomic os.replace and names the
arrays file it belongs to, so a reader that polls the manifest always
sees a consistent pair. `version` is a content hash of the arrays (the
same function as the JAX package's), so republishing identical
parameters is a visible no-op.

This module is numpy only: it takes the port's fit results through
`convert.to_numpy`. `load_fitted` also serves a raw `utils/checkpoint.py`
directory (step_XXXXXXXX children, either package's state.npz), so a fit
interrupted or finished under the streamed drivers can be served
directly.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

MANIFEST_NAME = "manifest.json"
_FORMAT_VERSION = 1

# model type -> required array names (the predict-side parameters)
_MODEL_ARRAYS = {
    "kmeans": ("centroids",),
    "fuzzy": ("centroids",),
    "gmm": ("means", "variances", "weights"),
}


@dataclass
class FittedModel:
    """A loaded fitted model: host-side arrays + the manifest metadata."""

    model: str  # 'kmeans' | 'fuzzy' | 'gmm'
    k: int
    d: int
    arrays: dict[str, np.ndarray]
    dtype: str = "float32"
    kernel: str = "auto"  # preferred predict kernel ('auto'|'xla'|'pallas')
    params: dict[str, Any] = field(default_factory=dict)  # spherical/m/cov
    version: str = ""  # content hash of the arrays
    path: str = ""

    @property
    def centroids(self) -> np.ndarray:
        return self.arrays["centroids" if self.model != "gmm" else "means"]


def _arrays_version(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _result_to_payload(result) -> tuple[str, dict, dict]:
    """(model_type, arrays, params) from one of the port's fit results."""
    cls = type(result).__name__
    if cls not in ("KMeansResult", "FuzzyCMeansResult", "GMMResult"):
        raise TypeError(
            f"cannot persist a {cls}; expected KMeansResult / "
            "FuzzyCMeansResult / GMMResult (or pass arrays= explicitly)")
    from tdc_tpu_torch.convert import to_numpy

    out = to_numpy(result)
    if cls == "GMMResult":
        return ("gmm", {name: out[name] for name in _MODEL_ARRAYS["gmm"]},
                {"covariance_type": out["covariance_type"]})
    model = "kmeans" if cls == "KMeansResult" else "fuzzy"
    return model, {"centroids": out["centroids"]}, {}


def stage_arrays(model_dir: str, arrays: dict[str, np.ndarray]) -> str:
    """Write the arrays file for `arrays` without touching the manifest;
    returns the content-hash version. Idempotent (the file is content-
    addressed): until save_fitted swaps the manifest, readers cannot load
    the staged version."""
    version = _arrays_version(arrays)
    os.makedirs(model_dir, exist_ok=True)
    arrays_path = os.path.join(model_dir, f"arrays-{version}.npz")
    if not os.path.exists(arrays_path):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        tmp = arrays_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, arrays_path)
    return version


def list_array_versions(model_dir: str) -> list[str]:
    """Content-hash versions with an arrays file currently on disk."""
    try:
        names = os.listdir(model_dir)
    except OSError:
        return []
    return sorted(
        n[len("arrays-"):-len(".npz")]
        for n in names
        if n.startswith("arrays-") and n.endswith(".npz")
    )


def save_fitted(
    model_dir: str,
    result=None,
    *,
    model: str | None = None,
    arrays: dict[str, np.ndarray] | None = None,
    kernel: str = "auto",
    params: dict | None = None,
    keep_versions: int = 2,
    pinned_versions=(),
) -> str:
    """Persist a fitted model; returns its content-hash version.

    Pass a fit result of the port (KMeansResult / FuzzyCMeansResult /
    GMMResult) or explicit `model` + `arrays`. Re-saving into a live
    model_dir publishes: arrays land first, the manifest swap is atomic,
    and the previous `keep_versions` arrays files are kept (and every
    version in `pinned_versions`), so a reader mid-load of the old
    manifest never sees its arrays vanish.
    """
    if result is not None:
        model, arr, auto_params = _result_to_payload(result)
        arr.update(arrays or {})
    else:
        if model is None or arrays is None:
            raise ValueError("pass a fit result, or model= and arrays=")
        arr, auto_params = dict(arrays), {}
    if model not in _MODEL_ARRAYS:
        raise ValueError(f"unknown model type {model!r}")
    missing = [n for n in _MODEL_ARRAYS[model] if n not in arr]
    if missing:
        raise ValueError(f"model {model!r} is missing arrays {missing}")
    merged = dict(auto_params)
    merged.update(params or {})

    first = arr[_MODEL_ARRAYS[model][0]]
    k, d = int(first.shape[0]), int(first.shape[-1])
    version = stage_arrays(model_dir, arr)
    arrays_name = f"arrays-{version}.npz"

    manifest = {
        "format_version": _FORMAT_VERSION,
        "model": model,
        "k": k,
        "d": d,
        "dtype": str(first.dtype),
        "kernel": kernel,
        "params": merged,
        "version": version,
        "arrays": arrays_name,
    }
    tmp = os.path.join(model_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(model_dir, MANIFEST_NAME))

    _prune_old_arrays(model_dir, keep=keep_versions, current=arrays_name,
                      pinned=pinned_versions)
    return version


def _prune_old_arrays(model_dir: str, keep: int, current: str,
                      pinned=()) -> None:
    protect = {current} | {f"arrays-{v}.npz" for v in pinned}
    old = sorted(
        (os.path.getmtime(os.path.join(model_dir, n)), n)
        for n in os.listdir(model_dir)
        if n.startswith("arrays-") and n.endswith(".npz")
        and n not in protect
    )
    for _, name in old[: max(len(old) - (keep - 1), 0)]:
        try:
            os.remove(os.path.join(model_dir, name))
        except OSError:
            pass  # a concurrent publisher already pruned it


def manifest_fingerprint(model_dir: str) -> tuple | None:
    """Cheap change-detection key for hot-reload polling: (mtime_ns, size,
    version) of the manifest, or a (step, stat) key for a checkpoint
    directory (a served fit advances when a new step lands). None when the
    directory has neither (or the manifest is mid-swap)."""
    path = os.path.join(model_dir, MANIFEST_NAME)
    try:
        st = os.stat(path)
        with open(path) as f:
            version = json.load(f).get("version", "")
    except (OSError, ValueError):
        return _checkpoint_fingerprint(model_dir)
    return (st.st_mtime_ns, st.st_size, version)


def _checkpoint_fingerprint(ckpt_dir: str) -> tuple | None:
    from tdc_tpu_torch.utils.checkpoint import latest_step

    try:
        step = latest_step(ckpt_dir)
    except OSError:
        return None
    if step is None:
        return None
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    for name in ("state.npz", ""):  # manual gang format, else the step dir
        try:
            st = os.stat(os.path.join(step_dir, name) if name else step_dir)
            return ("ckpt", step, st.st_mtime_ns, st.st_size)
        except OSError:
            continue
    return None


def load_fitted(model_dir: str, *, model: str | None = None) -> FittedModel:
    """Load a fitted model from a save_fitted directory (either
    package's) or a raw checkpoint directory.

    A checkpoint carries its model type in its meta: a GMM's holds
    variances and weights, a fuzzy fit's its fuzzifier `m`, anything else
    is K-Means centroids. `model=` overrides that.
    """
    manifest_path = os.path.join(model_dir, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            man = json.load(f)
        with np.load(os.path.join(model_dir, man["arrays"]),
                     allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        return FittedModel(
            model=man["model"],
            k=int(man["k"]),
            d=int(man["d"]),
            arrays=arrays,
            dtype=man.get("dtype", "float32"),
            kernel=man.get("kernel", "auto"),
            params=man.get("params", {}),
            version=man.get("version", ""),
            path=model_dir,
        )
    return _load_from_checkpoint(model_dir, model)


def _load_from_checkpoint(ckpt_dir: str, model: str | None) -> FittedModel:
    from tdc_tpu_torch.utils.checkpoint import restore_checkpoint

    state = restore_checkpoint(ckpt_dir)
    if state is None:
        raise FileNotFoundError(
            f"{ckpt_dir} has neither a {MANIFEST_NAME} nor a loadable "
            "checkpoint step")
    meta = state.meta
    c = np.asarray(state.centroids)
    params: dict[str, Any] = {}
    if model is None:
        if "variances" in meta and "weights" in meta:
            model = "gmm"
        elif "m" in meta:
            model = "fuzzy"
        else:
            model = "kmeans"
    if model == "gmm":
        arrays = {"means": c, "variances": np.asarray(meta["variances"]),
                  "weights": np.asarray(meta["weights"])}
        # A streamed GMM's checkpoint names its covariance type; the JAX
        # package's sharded GMM tower writes diag ones without it.
        params["covariance_type"] = str(meta.get("cov_type", "diag"))
    else:
        arrays = {"centroids": c}
        if model == "fuzzy" and "m" in meta:
            params["m"] = float(np.asarray(meta["m"]))
        if "spherical" in meta:
            params["spherical"] = bool(np.asarray(meta["spherical"]))
    return FittedModel(
        model=model,
        k=int(c.shape[0]),
        d=int(c.shape[-1]),
        arrays=arrays,
        dtype=str(c.dtype),
        kernel="auto",
        params=params,
        version=f"ckpt-step-{state.n_iter}",
        path=ckpt_dir,
    )


__all__ = ["FittedModel", "list_array_versions", "load_fitted",
           "manifest_fingerprint", "save_fitted", "stage_arrays"]
