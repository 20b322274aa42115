"""Dataset loading and streaming (counterpart: tdc_tpu/data/loader.py,
the `load_points`, `_restore_bf16`, `load_points_feature_major`,
`to_feature_major` and `NpzStream` parts): the reference's .npz layout
(keys 'X', 'Y'), plain .npy files and feature-major `*.fm.npy` files,
bfloat16 included. The files are the JAX package's: each package reads
the other's.

`NpzStream` is the streamed fits' batch source: a re-iterable stream of
(B, d) host batches over a memory-mapped or in-memory array. Its CRC32
sidecar verification is not ported (ROADMAP.md Queue A, A7(d)) and
raises.
"""

from __future__ import annotations

import os

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
CRC_SIDECAR_SUFFIX = ".crc.json"
_CRC_NOT_PORTED = ("CRC32 sidecar verification is not ported to "
                   "tdc_tpu_torch yet (ROADMAP.md Queue A, A7(d))")


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


def crc_sidecar_path(data_path: str) -> str:
    """Conventional sidecar location next to a data file."""
    return data_path + CRC_SIDECAR_SUFFIX


class NpzStream:
    """Re-iterable stream of (B, d) host batches over a memory-mapped or
    in-memory array (numpy, '|V2' bfloat16 included, or a CPU tensor).

    `stream()` returns a fresh iterator each call: one full pass per fit
    iteration. Batch i is rows [i·batch_rows, (i+1)·batch_rows), the last
    one short. Each batch is a view of the backing array, not a copy: the
    streamed fits copy only the rows they stage (under a mesh, this
    rank's rows of every batch), so a rank never reads another rank's
    rows from a memory-mapped file. A bfloat16 '|V2' array stays '|V2'
    here and is restored (`restore_bf16`) when staged.

    `crc_sidecar` (per-batch CRC32 verification) is not ported and
    raises (ROADMAP.md Queue A, A7(d)).
    """

    def __init__(self, x, batch_rows: int, crc_sidecar=None):
        if crc_sidecar is not None:
            raise NotImplementedError(_CRC_NOT_PORTED)
        if int(batch_rows) < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
        self.x = x
        self.batch_rows = int(batch_rows)

    @classmethod
    def from_npy(cls, path: str, batch_rows: int, *, mmap: bool = True,
                 verify_crc: str = "auto") -> "NpzStream":
        """Open a .npy as a stream (memory-mapped by default). The JAX
        package arms CRC verification when the sidecar exists
        (verify_crc='auto') or is required; here a sidecar that would be
        read raises, naming A7(d), rather than be silently ignored."""
        if verify_crc not in ("auto", "require", "off"):
            raise ValueError(
                f"verify_crc={verify_crc!r}: use 'auto', 'require', "
                "or 'off'")
        if verify_crc == "require" or (
                verify_crc == "auto" and os.path.exists(
                    crc_sidecar_path(path))):
            raise NotImplementedError(_CRC_NOT_PORTED)
        s = cls(np.load(path, mmap_mode="r" if mmap else None), batch_rows)
        s.path = path
        return s

    def __call__(self):
        for i in range(self.num_batches):
            yield self.read_batch(i)

    def read_batch(self, i: int):
        """Batch `i` of the `__call__` order, as a view."""
        start = i * self.batch_rows
        return self.x[start:start + self.batch_rows]

    @property
    def num_batches(self) -> int:
        return -(-self.x.shape[0] // self.batch_rows)

    @property
    def n_rows(self) -> int:
        return int(self.x.shape[0])
