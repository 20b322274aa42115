"""Dataset loading (counterpart: tdc_tpu/data/loader.py, the
`load_points`, `_restore_bf16`, `load_points_feature_major` and
`to_feature_major` parts): the reference's .npz layout (keys 'X', 'Y'),
plain .npy files and feature-major `*.fm.npy` files, bfloat16 included.
The files are the JAX package's: each package reads the other's.
"""

from __future__ import annotations

import numpy as np
import torch


def restore_bf16(x):
    """numpy cannot name bfloat16, so an ml_dtypes bfloat16 array round-trips
    through .npy/.npz as unstructured 2-byte void ('|V2'). Such an array
    comes back as a torch.bfloat16 tensor of the same bits (read as uint16,
    without ml_dtypes); any other array is returned as it is."""
    if x.dtype.kind == "V" and x.dtype.itemsize == 2 and x.dtype.names is None:
        return torch.from_numpy(np.array(x.view(np.uint16))).view(
            torch.bfloat16)
    return x


FEATURE_MAJOR_SUFFIX = ".fm.npy"


def load_points(data_file: str, *, mmap: bool = True):
    """(X, Y-or-None) from an .npz (keys 'X', 'Y') or a .npy (memory-mapped
    by default). X is a numpy array, or a torch.bfloat16 tensor for a
    bfloat16 file (read into memory: `restore_bf16`). A feature-major
    `*.fm.npy` file raises: read as sample-major it would cluster d
    "points" of dimension N."""
    if data_file.endswith(FEATURE_MAJOR_SUFFIX):
        raise ValueError(
            f"{data_file} is a feature-major ({FEATURE_MAJOR_SUFFIX}) "
            "file; load it with load_points_feature_major / "
            "--layout=features, or re-save sample-major"
        )
    if data_file.endswith(".npz"):
        with np.load(data_file, allow_pickle=False) as z:
            x = restore_bf16(z["X"])
            y = z["Y"] if "Y" in z.files else None
        return x, y
    x = np.load(data_file, mmap_mode="r" if mmap else None)
    return restore_bf16(x), None


def load_points_feature_major(data_file: str, *, mmap: bool = True,
                              chunk_rows: int = 1 << 20):
    """(X (d, N), Y-or-None) for the features layout. A `*.fm.npy` file
    already stores (d, N) and is memory-mapped as it is; any other .npy or
    .npz is the sample-major (N, d) layout, transposed in row chunks (for
    a memory-mapped .npy the peak is one chunk plus the result). X is a
    numpy array, or a torch.bfloat16 tensor for a bfloat16 file
    (`restore_bf16`)."""
    if data_file.endswith(FEATURE_MAJOR_SUFFIX):
        x = np.load(data_file, mmap_mode="r" if mmap else None)
        return restore_bf16(x), None
    x, y = load_points(data_file, mmap=mmap)
    if x.ndim != 2:
        raise ValueError(f"expected 2-D points, got shape {tuple(x.shape)}")
    n, d = x.shape
    if isinstance(x, torch.Tensor):
        out = torch.empty((d, n), dtype=x.dtype)
    else:
        out = np.empty((d, n), x.dtype)
    for s in range(0, n, chunk_rows):
        out[:, s:s + chunk_rows] = x[s:s + chunk_rows].T
    return out, y


def to_feature_major(src_path: str, dst_path: str, *,
                     chunk_rows: int = 1 << 20, key: str = "X") -> str:
    """Write a sample-major .npy/.npz as a feature-major `*.fm.npy`, once,
    so later feature-major loads memory-map it instead of transposing. A
    .npy source streams memmap to memmap in row chunks; an .npz member
    cannot be memory-mapped, so that source is read whole. bfloat16
    files stay 2-byte '|V2' arrays, as numpy stores them."""
    if not dst_path.endswith(FEATURE_MAJOR_SUFFIX):
        raise ValueError(
            f"feature-major files use the {FEATURE_MAJOR_SUFFIX!r} suffix "
            f"(got {dst_path!r}) — the suffix is how "
            "load_points_feature_major knows not to transpose again"
        )
    if src_path.endswith(".npz"):
        with np.load(src_path, allow_pickle=False) as z:
            src = z[key]
    else:
        src = np.load(src_path, mmap_mode="r")
    n, d = src.shape
    out = np.lib.format.open_memmap(dst_path, mode="w+", dtype=src.dtype,
                                    shape=(d, n))
    for s in range(0, n, chunk_rows):
        out[:, s:s + chunk_rows] = np.asarray(src[s:s + chunk_rows]).T
    out.flush()
    return dst_path
