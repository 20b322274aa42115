"""ctypes wrapper over the native prefetch loader (counterpart:
tdc_tpu/data/native_loader.py; the C++ source is the port's own copy,
`csrc/prefetch_loader.cpp`).

A C++ thread reads the next batches of an .npy file ahead of the fit, so
disk reads overlap the card's compute. The ingest guard iterates that
pass (`reads_ahead`); the spill ring's workers read by `read_batch`
(positional pread), and a stream read only so opens no C++ reader. The
library is built at first use
with g++ into `tdc_tpu_torch/_build/` (`ops/_build.load_host_library`);
a failed build raises with the compiler's output. There is no fallback:
no prebuilt library is loaded, and the caller gets the error rather than
another stream.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    """The loader library, built on first use and bound once per process
    (the ABI: ldr_open/next/reset/close/last_error)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from tdc_tpu_torch.ops._build import load_host_library

        lib = load_host_library("prefetch_loader.cpp")
        lib.ldr_open.restype = ctypes.c_int64
        lib.ldr_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int64] * 5
        lib.ldr_next.restype = ctypes.c_int64
        lib.ldr_next.argtypes = [ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_int64]
        lib.ldr_reset.restype = ctypes.c_int64
        lib.ldr_reset.argtypes = [ctypes.c_int64]
        lib.ldr_close.restype = ctypes.c_int64
        lib.ldr_close.argtypes = [ctypes.c_int64]
        lib.ldr_last_error.restype = ctypes.c_int64
        _lib = lib
        return _lib


def _npy_header(path: str):
    """(data_offset, dtype, shape) of an uncompressed C-order .npy."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if fortran:
            raise ValueError("Fortran-ordered .npy not supported")
        return f.tell(), dtype, shape


class NativePrefetchStream:
    """Re-iterable prefetched batch stream over an .npy file.

    The NpzStream protocol: each call returns a fresh iterator over
    (rows_per_batch, d) batches, one pass per Lloyd iteration, the C++
    reader `depth` batches ahead; the reader (its ring of `depth`
    batches and its thread) is opened at the first call. Also the spill
    ring's ranged protocol (`read_batch(i)` + `num_batches`): positional
    `os.pread` on the same geometry, thread-safe (pread carries its own
    offset, no cursor shared with the C++ thread or between ring
    workers). The C++ ring slot is recycled as soon as its batch is
    copied out, into a buffer of this stream's pool that no batch handed
    out still uses (`_free_buffer`).
    """

    # The guard iterates `__call__` rather than reading batch by batch:
    # the C++ reader is this stream's point (data/ingest.GuardedStream).
    reads_ahead = True

    def __init__(self, npy_path: str, rows_per_batch: int, *, depth: int = 4):
        offset, dtype, shape = _npy_header(npy_path)
        if len(shape) != 2:
            raise ValueError(f"expected 2-D points file, got shape {shape}")
        self.dtype = dtype
        self.shape = shape
        self.rows_per_batch = int(rows_per_batch)
        self.depth = int(depth)
        self._row_bytes = int(dtype.itemsize * shape[1])
        self._offset = int(offset)
        # Built (or its build's error raised) here, opened at first use.
        self._lib = _load_lib()
        self._id = -1
        self._open_lock = threading.Lock()
        self._pool: list[np.ndarray] = []
        self._fd = os.open(npy_path, os.O_RDONLY)
        self.path = npy_path  # the store's name in ingest events

    def _reader(self) -> int:
        """The C++ reader's handle, opened on the first pass."""
        with self._open_lock:
            if self._id < 0:
                self._id = self._lib.ldr_open(
                    self.path.encode(), self._offset, self._row_bytes,
                    self.shape[0], self.rows_per_batch, self.depth)
                if self._id < 0:
                    raise OSError(f"ldr_open failed (errno "
                                  f"{self._lib.ldr_last_error()})")
            return self._id

    @property
    def num_batches(self) -> int:
        return -(-self.shape[0] // self.rows_per_batch)

    @property
    def n_rows(self) -> int:
        return int(self.shape[0])

    def _free_buffer(self) -> np.ndarray:
        """A batch buffer of the pool that no batch handed out refers to
        any more, else a new one for the pool. A batch is a view of its
        buffer, and every view of a view keeps the buffer as its base, so
        the buffer is free when only the pool refers to it (CPython's
        reference count: the pool, the loop's name and the call's
        argument). Reuse spares faulting a fresh buffer's pages in, which
        takes longer than the copy into them (PERF.md)."""
        for buf in self._pool:
            if sys.getrefcount(buf) <= 3:
                return buf
        buf = np.empty((self.rows_per_batch, self.shape[1]), self.dtype)
        self._pool.append(buf)
        return buf

    def __call__(self):
        lib, rid = self._lib, self._reader()
        if lib.ldr_reset(rid) != 0:
            raise OSError("ldr_reset failed")
        while True:
            buf = self._free_buffer()
            rows = lib.ldr_next(
                rid, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
            )
            if rows < 0:
                raise OSError(
                    f"ldr_next failed (errno {lib.ldr_last_error()})")
            if rows == 0:
                return
            batch = buf[:rows]
            del buf  # the batch holds its buffer while the consumer does
            yield batch
            del batch

    def read_batch(self, i: int) -> np.ndarray:
        """Batch `i` of the `__call__` order through a positional pread:
        the same batch boundaries and ragged tail as the C++ reader."""
        nb = self.num_batches
        if not (0 <= i < nb):
            raise IndexError(f"batch {i} out of range [0, {nb})")
        row0 = i * self.rows_per_batch
        rows = min(self.rows_per_batch, self.shape[0] - row0)
        want = rows * self._row_bytes
        off = self._offset + row0 * self._row_bytes
        out = np.empty((rows, self.shape[1]), self.dtype)
        view = memoryview(out.reshape(-1).view(np.uint8))
        got = 0
        while got < want:
            n = os.preadv(self._fd, [view[got:]], off + got)
            if n <= 0:
                raise OSError(
                    f"{self.path}: EOF at byte {off + got} reading batch "
                    f"{i} ({want} bytes expected) — truncated .npy")
            got += n
        return out

    def close(self):
        if getattr(self, "_id", -1) >= 0:
            self._lib.ldr_close(self._id)
            self._id = -1
        if getattr(self, "_fd", -1) >= 0:
            try:
                os.close(self._fd)
            finally:
                self._fd = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["NativePrefetchStream"]
