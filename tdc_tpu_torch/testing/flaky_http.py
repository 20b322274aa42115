"""In-process flaky HTTP blob server for object-store chaos tests
(counterpart: tdc_tpu/testing/flaky_http.py, a stdlib copy).

Serves a directory of blobs (a `build_manifest` output dir) over real
sockets with INJECTABLE fault programs, so the HTTP-range store backend
(tdc_tpu_torch/data/store.py) is exercised against the failure modes production object
stores actually produce — 5xx storms, 429s with Retry-After, stalled
responses under the client's socket deadline, and bodies truncated by a
dropped connection — from inside one pytest process (ThreadingHTTPServer
on port 0; `with FlakyHTTPServer(root) as url:`).

Fault program: a global request counter over BLOB requests (names in
`spare` — the manifest by default — are never faulted, so stream OPEN
stays deterministic while reads ride the storm) drives three injections:

- `fail_every=N`: every Nth counted request answers `fail_status`
  (~1/N deterministic error rate; `retry_after` adds the header, which
  the ingest retry ladder must honor as a backoff floor);
- `stall_requests={i, ...}` + `stall_s`: counted request i sleeps
  before answering — longer than the client timeout, this is the
  stalled-socket read;
- `truncate_requests={i, ...}`: counted request i advertises the full
  Content-Length but sends half the body and drops the connection —
  the client sees `http.client.IncompleteRead` (a TRANSIENT transfer
  death, distinct from a blob that is short on disk, which is
  quarantine territory).

The counter (and `fault_count`) is shared across every client of the
server — a 2-process gang hammering one server sees one interleaved
storm, like production. Faults are injected per REQUEST, not per blob,
so retries of a faulted read succeed: the chaos contract is "transient
storm is survived transparently", while permanent corruption is staged
on DISK (corrupt a blob's bytes; the manifest CRC catches it).
"""

from __future__ import annotations

import http.server
import os
import socket
import threading
import time
import urllib.parse


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Headers and body go out in separate writes: without TCP_NODELAY each
    # response waits on the client's delayed ACK (~40 ms a request).
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # pragma: no cover - silence
        pass

    def do_GET(self):
        srv = self.server.owner
        name = os.path.basename(urllib.parse.urlsplit(self.path).path)
        path = os.path.join(srv.root, name)
        if not os.path.isfile(path):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        fault = None
        if name not in srv.spare:
            fault = srv._next_fault()
        if fault == "fail":
            self.send_response(srv.fail_status)
            if srv.retry_after is not None:
                self.send_header("Retry-After", str(srv.retry_after))
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if fault == "stall":
            time.sleep(srv.stall_s)
        with open(path, "rb") as f:
            blob = f.read()
        rng = self.headers.get("Range")
        status, body = 200, blob
        if rng and rng.startswith("bytes="):
            try:
                a, b = rng[len("bytes="):].split("-", 1)
                lo, hi = int(a), int(b)
            except ValueError:
                lo, hi = 0, len(blob) - 1
            if lo >= len(blob):
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{len(blob)}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            status, body = 206, blob[lo:hi + 1]
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        if status == 206:
            self.send_header("Content-Range",
                             f"bytes {lo}-{lo + len(body) - 1}/{len(blob)}")
        self.end_headers()
        if fault == "truncate":
            # Advertised full length, half the bytes, dead socket: the
            # client's read() raises IncompleteRead. The shutdown sends
            # the FIN now (a bare close leaves the handler's files holding
            # the socket, and the client waits out its read deadline).
            self.wfile.write(body[:max(len(body) // 2, 1)])
            self.wfile.flush()
            self.close_connection = True
            self.connection.shutdown(socket.SHUT_RDWR)
            return
        self.wfile.write(body)


class FlakyHTTPServer:
    """See module doc. Context manager yielding the base URL."""

    def __init__(self, root: str, *, fail_every: int = 0,
                 fail_status: int = 503, retry_after=None,
                 stall_requests=(), stall_s: float = 0.0,
                 truncate_requests=(), spare=("manifest.json",)):
        self.root = root
        self.fail_every = int(fail_every)
        self.fail_status = int(fail_status)
        self.retry_after = retry_after
        self.stall_requests = frozenset(int(i) for i in stall_requests)
        self.stall_s = float(stall_s)
        self.truncate_requests = frozenset(int(i) for i in truncate_requests)
        self.spare = frozenset(spare)
        self._lock = threading.Lock()
        self.request_count = 0
        self.fault_count = 0
        self._httpd = None
        self._thread = None

    def _next_fault(self) -> str | None:
        with self._lock:
            i = self.request_count
            self.request_count += 1
            fault = None
            if i in self.stall_requests:
                fault = "stall"
            elif i in self.truncate_requests:
                fault = "truncate"
            elif self.fail_every and (i % self.fail_every
                                      == self.fail_every - 1):
                fault = "fail"
            if fault is not None:
                self.fault_count += 1
            return fault

    def start(self) -> str:
        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), _Handler)
        self._httpd.owner = self
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tdc-flaky-http", daemon=True)
        self._thread.start()
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None

    def __enter__(self) -> str:
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["FlakyHTTPServer"]
