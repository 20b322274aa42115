"""Dataset loading (counterpart: tdc_tpu/data/loader.py, the `load_points`
part): the reference's .npz layout (keys 'X', 'Y') and plain .npy files.
"""

from __future__ import annotations

import numpy as np


def load_points(data_file: str, *, mmap: bool = True):
    """(X, Y-or-None) as numpy from an .npz (keys 'X', 'Y') or a .npy
    (memory-mapped by default)."""
    if data_file.endswith(".npz"):
        with np.load(data_file, allow_pickle=False) as z:
            x = z["X"]
            y = z["Y"] if "Y" in z.files else None
        return x, y
    if data_file.endswith(".fm.npy"):
        raise ValueError(
            f"{data_file} is a feature-major file; the feature-major layout "
            "is not ported yet (ROADMAP.md Queue B, B10)")
    return np.load(data_file, mmap_mode="r" if mmap else None), None
