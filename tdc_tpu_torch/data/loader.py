"""Dataset loading and streaming (counterpart: tdc_tpu/data/loader.py,
all of it but `NpzStream.to_npy`): the reference's .npz layout (keys
'X', 'Y'), plain .npy files and feature-major `*.fm.npy` files, bfloat16
included. The files are the JAX package's: each package reads the
other's.

`NpzStream` is the streamed fits' batch source: a re-iterable stream of
(B, d) host batches over a memory-mapped or in-memory array. A CRC32
sidecar (`write_crc_sidecar`: one checksum per batch slice, the JAX
package's JSON file) arms a check of every batch read: a mismatch raises
`data.ingest.CorruptBatch`, which the ingest guard quarantines. A
sidecar written by either package verifies in the other.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Iterator

import numpy as np
import torch

from tdc_tpu_torch.testing.faults import fault_point


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


def load_points(data_file: str, *, mmap: bool = True):
    """(X, Y-or-None) from an .npz (keys 'X', 'Y') or a .npy (memory-mapped
    by default). X is a numpy array, or a torch.bfloat16 tensor for a
    bfloat16 file (read into memory: `restore_bf16`). A feature-major
    `*.fm.npy` file raises: read as sample-major it would cluster d
    "points" of dimension N."""
    fault_point("data.load")
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


def batch_iterator(x, num_batches: int) -> Iterator:
    """Sequential contiguous batches of `x`, np.array_split's sizes (the
    first n % num_batches batches one row longer)."""
    n = x.shape[0]
    base, extra = divmod(n, num_batches)
    start = 0
    for i in range(num_batches):
        size = base + (1 if i < extra else 0)
        yield x[start:start + size]
        start += size


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


def _raw_bytes(b) -> np.ndarray:
    """A batch's C-order bytes as a uint8 array (numpy, '|V2' bfloat16
    or a CPU tensor, bfloat16 included): what the CRCs are computed
    over, in either package."""
    if isinstance(b, torch.Tensor):
        b = b.contiguous()
        if b.dtype == torch.bfloat16:
            b = b.view(torch.int16)
        b = b.numpy()
    return np.ascontiguousarray(b).reshape(-1).view(np.uint8)


def batch_crc(b) -> int:
    """CRC32 of one batch's raw bytes (`zlib.crc32`)."""
    return zlib.crc32(_raw_bytes(b))


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.dtype(x.dtype))


def write_crc_sidecar(x, batch_rows: int, path: str) -> str:
    """Write the CRC32 sidecar of a batched array: one checksum per
    `read_batch(i)` slice of `batch_rows` rows, over the slice's bytes
    (the JAX package's JSON: batch_rows, n_rows, dtype, crcs). Written
    atomically (a tmp file, then os.replace)."""
    batch_rows = int(batch_rows)
    n = int(x.shape[0])
    meta = {
        "batch_rows": batch_rows,
        "n_rows": n,
        "dtype": _dtype_name(x),
        "crcs": [batch_crc(x[s:s + batch_rows])
                 for s in range(0, n, batch_rows)],
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)
    return path


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

    `crc_sidecar` (a path written by `write_crc_sidecar`, or its loaded
    dict) arms a CRC32 check of every `read_batch`: bytes that changed on
    disk raise `data.ingest.CorruptBatch`, which the ingest guard turns
    into a quarantine. A sidecar for another batch_rows or row count is
    refused: it would verify nothing.
    """

    def __init__(self, x, batch_rows: int, crc_sidecar=None):
        if int(batch_rows) < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
        self.x = x
        self.batch_rows = int(batch_rows)
        self._crcs = None
        if crc_sidecar is not None:
            if isinstance(crc_sidecar, str):
                with open(crc_sidecar) as f:
                    crc_sidecar = json.load(f)
            if int(crc_sidecar.get("batch_rows", -1)) != self.batch_rows:
                raise ValueError(
                    "CRC sidecar was written for batch_rows="
                    f"{crc_sidecar.get('batch_rows')}, stream uses "
                    f"{self.batch_rows} — re-generate the sidecar "
                    "(write_crc_sidecar) for this batch size")
            if int(crc_sidecar.get("n_rows", -1)) != int(x.shape[0]):
                raise ValueError(
                    f"CRC sidecar covers {crc_sidecar.get('n_rows')} rows, "
                    f"stream holds {x.shape[0]}")
            self._crcs = [int(c) for c in crc_sidecar["crcs"]]

    @classmethod
    def from_npy(cls, path: str, batch_rows: int, *, mmap: bool = True,
                 verify_crc: str = "auto") -> "NpzStream":
        """Open a .npy as a stream (memory-mapped by default), arming the
        CRC check when the conventional sidecar exists (verify_crc='auto'),
        always ('require': a missing sidecar raises) or never ('off')."""
        if verify_crc not in ("auto", "require", "off"):
            # An unknown value silently disabling verification would be
            # the quiet failure the sidecar exists to prevent.
            raise ValueError(
                f"verify_crc={verify_crc!r}: use 'auto', 'require', "
                "or 'off'")
        x = np.load(path, mmap_mode="r" if mmap else None)
        sidecar = crc_sidecar_path(path)
        have = os.path.exists(sidecar)
        if verify_crc == "require" and not have:
            raise FileNotFoundError(
                f"verify_crc='require' but no sidecar at {sidecar}")
        s = cls(x, batch_rows,
                crc_sidecar=sidecar if have and verify_crc != "off" else None)
        s.path = path  # the store's name in ingest events
        return s

    def write_crc_sidecar(self, path: str) -> str:
        """Write (and arm) the sidecar for this stream's geometry."""
        out = write_crc_sidecar(self.x, self.batch_rows, path)
        with open(out) as f:
            self._crcs = [int(c) for c in json.load(f)["crcs"]]
        return out

    def __call__(self):
        for i in range(self.num_batches):
            yield self.read_batch(i)

    def read_batch(self, i: int):
        """Batch `i` of the `__call__` order, as a view; thread-safe (the
        spill ring reads several at once). With an armed sidecar its bytes
        are checked here, on the thread that read them."""
        start = i * self.batch_rows
        b = self.x[start:start + self.batch_rows]
        if self._crcs is not None:
            got, want = batch_crc(b), self._crcs[i]
            if got != want:
                from tdc_tpu_torch.data.ingest import CorruptBatch

                raise CorruptBatch(
                    f"batch {i} CRC mismatch (want {want}, got {got})",
                    batch=i, reason="crc_mismatch", shape=tuple(b.shape),
                    dtype=np.float32)
        return b

    @property
    def num_batches(self) -> int:
        return -(-self.x.shape[0] // self.batch_rows)

    @property
    def n_rows(self) -> int:
        return int(self.x.shape[0])
