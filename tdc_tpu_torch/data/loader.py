"""Dataset loading (counterpart: tdc_tpu/data/loader.py, the `load_points`
and `_restore_bf16` parts): the reference's .npz layout (keys 'X', 'Y')
and plain .npy files, bfloat16 included.
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


def load_points(data_file: str, *, mmap: bool = True):
    """(X, Y-or-None) from an .npz (keys 'X', 'Y') or a .npy (memory-mapped
    by default). X is a numpy array, or a torch.bfloat16 tensor for a
    bfloat16 file (read into memory: `restore_bf16`)."""
    if data_file.endswith(".npz"):
        with np.load(data_file, allow_pickle=False) as z:
            x = restore_bf16(z["X"])
            y = z["Y"] if "Y" in z.files else None
        return x, y
    if data_file.endswith(".fm.npy"):
        raise ValueError(
            f"{data_file} is a feature-major file; the feature-major layout "
            "is not ported yet (ROADMAP.md Queue B, B10)")
    x = np.load(data_file, mmap_mode="r" if mmap else None)
    return restore_bf16(x), None
