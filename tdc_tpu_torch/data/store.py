"""The object-store data plane: ranged blob backends and the manifest
stream (counterpart: tdc_tpu/data/store.py).

The store sits behind the one protocol the streamed fits already speak,
the ranged `read_batch(i)`, so the spill ring and the ingest guard
(`data/ingest.py`) apply unchanged:

- `FileStore`: `file://` (or a bare path) — positional `os.pread` on
  blobs under a base directory; thread-safe, so the spill ring's workers
  read one blob at once.
- `HTTPRangeStore`: stdlib `http.client`, `Range: bytes=a-b` GETs over
  one keep-alive connection per thread (`_ThreadConn`). Its failures are
  typed for `data.ingest.classify_error`: 5xx / 408 / 429 raise
  `StoreHTTPError` (an OSError with `.status` and `.retry_after`), resets
  and stalls surface as the stdlib's ConnectionError/TimeoutError, a body
  cut by a dropped connection as `http.client.IncompleteRead` (all
  transient), other 4xx are permanent. A blob verifiably shorter than the
  manifest says (416, or a whole body that ends early) is
  `StoreShortBlob`, which `ManifestStream` turns into `CorruptBatch`: a
  quarantine, not a retry.
- `ManifestStream`: local batch i -> its global batch (`assign_batches`)
  -> shard and offset -> one ranged read -> CRC32 check (mismatch:
  `CorruptBatch`, reason ``crc_mismatch``) -> `np.frombuffer`. It
  advertises num_batches/batch_rows/n_rows/dtype, so the residency
  planner sizes it like any stream.

Placement: the port's streamed fits pass the same stream on every rank
of a mesh and copy each rank's rows of every batch, so
`open_manifest_stream(spec=mesh)` opens every batch on every rank (the
JAX package's `process_scale == 1` form): each rank reads and checks
whole batches, and every rank reaches the same CRC verdict by
construction. Explicit `process_index`/`num_processes` still give the
disjoint contiguous ranges of `assign_batches`.

Every read attempt passes the `store.read.transient` and
`store.read.permanent` fault points, manifest loads `store.list`.
`StoreCounter` (reads, failed attempts, bytes, stall seconds) is mirrored
into `GLOBAL_STORE`. Stdlib and numpy only.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.parse
import zlib
from typing import Iterator

import numpy as np

from tdc_tpu_torch.data.ingest import CorruptBatch
from tdc_tpu_torch.data.manifest import (
    MANIFEST_NAME,
    Manifest,
    assign_batches,
    parse_manifest,
)
from tdc_tpu_torch.testing.faults import fault_point
from tdc_tpu_torch.utils.structlog import emit

DEFAULT_TIMEOUT = 10.0  # seconds; per-read socket deadline (stall bound)


class StoreHTTPError(OSError):
    """A non-success HTTP status from the store. Carries `.status` (int)
    and `.retry_after` (seconds, float, or None) so classify_error can
    route by status class and the retry ladder can honor the server's
    requested floor. OSError subclass: anything that does NOT know the
    HTTP semantics still lands in the existing residual-OSError
    transient bucket rather than crashing on an unknown type."""

    def __init__(self, message: str, *, status: int, retry_after=None):
        super().__init__(message)
        self.status = int(status)
        self.retry_after = retry_after


class StoreShortBlob(OSError):
    """The stored blob is VERIFIABLY shorter than the manifest's geometry
    claims (range past EOF, or a complete body that ended early): a
    truncated object, not a dropped transfer. ManifestStream converts it
    to CorruptBatch -> zero-mass quarantine; retrying cannot grow the
    blob."""


def _parse_retry_after(value) -> float | None:
    """Delta-seconds form only (the HTTP-date form needs a clock the
    deterministic backoff tier refuses to depend on)."""
    if value is None:
        return None
    try:
        ra = float(value)
    except (TypeError, ValueError):
        return None
    return ra if ra >= 0 else None


class StoreCounter:
    """Thread-safe tally of store reads (the IngestCounter pattern): one
    per stream, mirrored into the process-wide GLOBAL_STORE that serve
    /metrics exports as tdc_store_*. `failed` counts ATTEMPTS that
    raised (each becomes an ingest retry or an abandoned read);
    `stall_s` is the wall-clock those failed attempts burned — the
    store-side tail the H2D stall counter cannot see."""

    def __init__(self, _mirror=None):
        self._lock = threading.Lock()
        self._mirror = _mirror
        self.reads = 0
        self.failed = 0
        self.bytes = 0
        self.stall_s = 0.0

    def add_read(self, nbytes: int) -> None:
        with self._lock:
            self.reads += 1
            self.bytes += int(nbytes)
        if self._mirror is not None:
            self._mirror.add_read(nbytes)

    def add_failed(self, stall_s: float) -> None:
        with self._lock:
            self.failed += 1
            self.stall_s += float(stall_s)
        if self._mirror is not None:
            self._mirror.add_failed(stall_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "reads": self.reads,
                "failed": self.failed,
                "bytes": self.bytes,
                "stall_s": self.stall_s,
            }


# Process-wide counter (mirrored into by every per-stream counter);
# surfaced by the serve /metrics endpoint as tdc_store_*.
GLOBAL_STORE = StoreCounter()


class FileStore:
    """Ranged reads over blobs in a local directory (`file://` or a bare
    path). pread is both thread-safe and cursor-free, so ring producer
    threads share nothing."""

    def __init__(self, base: str, counter: StoreCounter | None = None):
        self.base = base
        self.counter = counter if counter is not None \
            else StoreCounter(_mirror=GLOBAL_STORE)
        self._lock = threading.Lock()
        self._fds: dict = {}

    def _fd(self, blob: str) -> int:
        with self._lock:
            fd = self._fds.get(blob)
            if fd is None:
                fd = os.open(os.path.join(self.base, blob), os.O_RDONLY)
                self._fds[blob] = fd
            return fd

    def read_range(self, blob: str, offset: int, length: int) -> bytes:
        """`length` bytes of `blob` starting at `offset`; StoreShortBlob
        when the blob verifiably ends before offset+length."""
        t0 = time.perf_counter()
        try:
            fault_point("store.read.transient")
            fault_point("store.read.permanent")
            fd = self._fd(blob)
            chunks = []
            got = 0
            while got < length:
                b = os.pread(fd, length - got, offset + got)
                if not b:
                    raise StoreShortBlob(
                        f"{blob}: EOF at byte {offset + got}, manifest "
                        f"claims {offset + length}"
                    )
                chunks.append(b)
                got += len(b)
        except Exception:
            self.counter.add_failed(time.perf_counter() - t0)
            raise
        data = b"".join(chunks)
        self.counter.add_read(len(data))
        return data

    def read_doc(self, name: str) -> bytes:
        """Whole small object (the manifest itself)."""
        fault_point("store.list")
        with open(os.path.join(self.base, name), "rb") as f:
            return f.read()

    def close(self) -> None:
        with self._lock:
            fds, self._fds = self._fds, {}
        for fd in fds.values():
            try:
                os.close(fd)
            except OSError:
                pass

    def __repr__(self):  # pragma: no cover - debug aid
        return f"FileStore({self.base!r})"


class _ThreadConn(threading.local):
    conn = None


class HTTPRangeStore:
    """Ranged reads over HTTP/1.1 (stdlib http.client, no new deps).

    One persistent connection per thread (`threading.local`): the spill
    ring's producers each own a socket, reused across batches, torn down
    and rebuilt after any error (a connection that just failed is in an
    unknown protocol state). `timeout` is the per-read SOCKET deadline —
    a stalled server surfaces as the stdlib's timeout (TimeoutError
    subclass since 3.10), which classify_error already calls transient.
    """

    def __init__(self, base_url: str, *, timeout: float = DEFAULT_TIMEOUT,
                 counter: StoreCounter | None = None):
        u = urllib.parse.urlsplit(base_url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"HTTPRangeStore needs http(s)://, "
                             f"got {base_url!r}")
        self.base = base_url.rstrip("/")
        self.timeout = float(timeout)
        self.counter = counter if counter is not None \
            else StoreCounter(_mirror=GLOBAL_STORE)
        self._scheme = u.scheme
        self._netloc = u.netloc
        self._path = u.path.rstrip("/")
        self._local = _ThreadConn()

    def _connect(self):
        cls = (http.client.HTTPSConnection if self._scheme == "https"
               else http.client.HTTPConnection)
        return cls(self._netloc, timeout=self.timeout)

    def _drop(self) -> None:
        conn, self._local.conn = self._local.conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def _request(self, name: str, headers: dict):
        conn = self._local.conn
        if conn is None:
            conn = self._local.conn = self._connect()
        conn.request("GET", f"{self._path}/{name}", headers=headers)
        return conn.getresponse()

    def _get(self, name: str, headers: dict):
        """One GET -> (status, headers, body bytes). Raises StoreHTTPError
        on retryable/permanent statuses; transport faults propagate with
        their stdlib types (reset -> ConnectionError, stall -> timeout,
        torn body -> IncompleteRead) after the dead socket is dropped."""
        try:
            resp = self._request(name, headers)
            body = resp.read()
        except Exception:
            self._drop()
            raise
        if resp.status in (408, 429) or resp.status >= 500:
            # Server-side transient: the connection is healthy but the
            # response is garbage — drop it anyway (some servers close
            # after errors without saying so) and let the retry ladder
            # honor any Retry-After the server sent.
            self._drop()
            raise StoreHTTPError(
                f"{self.base}/{name}: HTTP {resp.status}",
                status=resp.status,
                retry_after=_parse_retry_after(
                    resp.getheader("Retry-After")),
            )
        if resp.status == 416:
            # Range past EOF: the blob is shorter than the manifest
            # claims. Not a network fault — quarantine territory.
            raise StoreShortBlob(
                f"{self.base}/{name}: HTTP 416, blob shorter than the "
                "manifest's geometry"
            )
        if resp.status not in (200, 206):
            raise StoreHTTPError(
                f"{self.base}/{name}: HTTP {resp.status}",
                status=resp.status,
            )
        return resp.status, body

    def read_range(self, blob: str, offset: int, length: int) -> bytes:
        t0 = time.perf_counter()
        try:
            fault_point("store.read.transient")
            fault_point("store.read.permanent")
            status, body = self._get(
                blob,
                {"Range": f"bytes={offset}-{offset + length - 1}"})
            if status == 200:
                # Server ignored the Range header: slice the full body.
                body = body[offset:offset + length]
            if len(body) < length:
                # A COMPLETE response (read() returned without
                # IncompleteRead) that still misses bytes: the object
                # itself is short.
                raise StoreShortBlob(
                    f"{self.base}/{blob}: ranged read returned "
                    f"{len(body)} of {length} bytes"
                )
        except Exception:
            self.counter.add_failed(time.perf_counter() - t0)
            raise
        self.counter.add_read(len(body))
        return body

    def read_doc(self, name: str) -> bytes:
        fault_point("store.list")
        status, body = self._get(name, {})
        return body

    def close(self) -> None:
        self._drop()

    def __repr__(self):  # pragma: no cover - debug aid
        return f"HTTPRangeStore({self.base!r})"


class ManifestStream:
    """Ranged batch stream over a manifest + store (see module doc).

    Speaks every protocol the streamed drivers already know:
    `__call__` (fresh sequential iterator), `read_batch(i)` +
    `num_batches` (the spill ring's RANGED protocol; thread-safe because
    both backends are), and the sizing protocol
    (`batch_rows`/`n_rows`/`dtype` — all LOCAL to this process's
    assignment). `path` is the manifest URL for ingest events.
    """

    def __init__(self, manifest: Manifest, store, *, url: str = "",
                 process_index: int = 0, num_processes: int = 1):
        self.manifest = manifest
        self.store = store
        self.path = url or f"manifest:{getattr(store, 'base', '?')}"
        self.num_processes = int(num_processes)
        self.process_index = int(process_index)
        self._assigned = assign_batches(
            manifest.num_batches, self.num_processes, self.process_index)
        self.disjoint_shards = self.num_processes > 1
        if self.disjoint_shards and manifest.n_rows % manifest.batch_rows:
            raise ValueError(
                f"manifest holds a ragged tail batch "
                f"({manifest.n_rows} rows % batch_rows="
                f"{manifest.batch_rows}) — gang processes must stream "
                "equal local row counts per batch (the per-batch "
                "collective contract); pad or re-shard the dataset"
            )
        self.batch_rows = manifest.batch_rows
        self.dtype = manifest.dtype
        self.itemsize = manifest.itemsize
        # LOCAL rows: only the final assigned batch can be ragged, and
        # only in single-process mode (refused above for gangs).
        last_g = self._assigned[-1]
        last_rows = min(self.batch_rows,
                        manifest.n_rows - last_g * self.batch_rows)
        self.n_rows = self.batch_rows * (len(self._assigned) - 1) + last_rows
        emit("manifest_open", url=self.path,
             num_batches=len(self._assigned),
             global_batches=manifest.num_batches,
             process_index=self.process_index,
             num_processes=self.num_processes,
             n_rows=self.n_rows, batch_rows=self.batch_rows,
             dtype=str(self.dtype), shards=len(manifest.shards))

    @property
    def num_batches(self) -> int:
        return len(self._assigned)

    @property
    def assigned_batches(self) -> range:
        """This process's global batch range (tests/debugging)."""
        return self._assigned

    def read_batch(self, i: int) -> np.ndarray:
        """Local batch `i`: one ranged store read + CRC verify."""
        g = self._assigned[i]  # range raises IndexError out of bounds
        shard, offset, rows, crc = self.manifest.locate(g)
        want = rows * self.manifest.row_bytes
        data = self.store.read_range(shard.blob, offset, want)
        shape = (rows, self.manifest.d)
        if zlib.crc32(data) != crc:
            raise CorruptBatch(
                f"batch {i} (global {g}, blob {shard.blob!r}): CRC32 "
                "mismatch against the manifest",
                batch=i, reason="crc_mismatch",
                shape=shape, dtype=self.dtype,
            )
        return np.frombuffer(data, dtype=self.dtype).reshape(shape)

    def __call__(self) -> Iterator[np.ndarray]:
        for i in range(self.num_batches):
            try:
                yield self.read_batch(i)
            except StoreShortBlob as e:
                # On the RANGED path the guard re-reads through
                # read_batch and _short_as_corrupt below converts there;
                # the sequential path converts here so an unguarded
                # iteration still fails with quarantine semantics.
                raise self._short_to_corrupt(i, e) from e

    def _short_to_corrupt(self, i: int, e: StoreShortBlob) -> CorruptBatch:
        g = self._assigned[i]
        shard, _, rows, _ = self.manifest.locate(g)
        return CorruptBatch(
            f"batch {i} (global {g}, blob {shard.blob!r}): {e}",
            batch=i, reason="short_blob",
            shape=(rows, self.manifest.d), dtype=self.dtype,
        )

    def close(self) -> None:
        close = getattr(self.store, "close", None)
        if close is not None:
            close()


def _wrap_short_blob(stream: ManifestStream):
    """Bind read_batch so StoreShortBlob surfaces as CorruptBatch (the
    guard's quarantine verdict) on the ranged path too."""
    raw = stream.read_batch

    def read_batch(i: int) -> np.ndarray:
        try:
            return raw(i)
        except StoreShortBlob as e:
            raise stream._short_to_corrupt(i, e) from e

    stream.read_batch = read_batch  # instance attr shadows the method
    return stream


def resolve_url(name: str, base: str | None) -> str:
    """Resolve a possibly-relative manifest name against a base URL/dir
    (one configured bucket, many datasets). Absolute names — a scheme or
    a leading / — pass through untouched; without a base so does
    everything else."""
    if not base or "://" in name or name.startswith("/"):
        return name
    return base.rstrip("/") + "/" + name


def _open_store(url: str, timeout: float,
                counter: StoreCounter | None):
    """Split `url` (manifest.json over file:// / bare path / http(s)://)
    into (store backend, document name) and fetch+parse the manifest."""
    u = urllib.parse.urlsplit(url)
    if u.scheme in ("http", "https"):
        base, name = url.rsplit("/", 1)
        store = HTTPRangeStore(base, timeout=timeout, counter=counter)
    elif u.scheme in ("", "file"):
        path = u.path if u.scheme == "file" else url
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        base, name = os.path.split(path)
        store = FileStore(base or ".", counter=counter)
    else:
        raise ValueError(f"unsupported manifest URL scheme: {url!r}")
    try:
        doc = json.loads(store.read_doc(name).decode("utf-8"))
    except json.JSONDecodeError as e:
        raise ValueError(f"manifest at {url!r} is not JSON: {e}") from e
    return parse_manifest(doc), store


def fetch_manifest(url: str, *,
                   timeout: float = DEFAULT_TIMEOUT) -> "Manifest":
    """Fetch, parse, and validate the manifest document alone — the
    geometry probe (n_rows, d, dtype, batch_rows) callers need before
    any mesh or stream exists (the CLI sizes the fit from it)."""
    manifest, _ = _open_store(url, timeout, None)
    return manifest


def open_manifest_stream(url: str, *, spec=None, process_index=None,
                         num_processes=None,
                         timeout: float = DEFAULT_TIMEOUT,
                         counter: StoreCounter | None = None
                         ) -> ManifestStream:
    """Open `url` (a manifest.json over file:// / a bare path /
    http(s)://) as a ManifestStream.

    `spec` is the fit's mesh (`parallel.mesh.Mesh`) or None: either way
    every batch opens on every rank, the port's mesh rule (module
    docstring). Explicit `process_index`/`num_processes` give a disjoint
    batch range instead. Defaults to one process.
    """
    manifest, store = _open_store(url, timeout, counter)
    if spec is not None and (process_index is not None
                             or num_processes is not None):
        raise ValueError("pass spec OR process_index/num_processes, "
                         "not both")
    return _wrap_short_blob(ManifestStream(
        manifest, store, url=url,
        process_index=process_index or 0,
        num_processes=num_processes or 1,
    ))


__all__ = [
    "DEFAULT_TIMEOUT",
    "FileStore",
    "GLOBAL_STORE",
    "HTTPRangeStore",
    "ManifestStream",
    "StoreCounter",
    "StoreHTTPError",
    "StoreShortBlob",
    "fetch_manifest",
    "open_manifest_stream",
    "resolve_url",
]
