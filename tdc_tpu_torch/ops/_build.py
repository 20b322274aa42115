"""Build the CUDA kernels in `csrc/` with nvcc at first use and bind them
with ctypes (no counterpart: the JAX package's Pallas kernels compile
inside XLA).

Each `csrc/*.cu` compiles on its own nvcc process, all started together,
for `sm_90a` (Hopper); the objects link into one shared library with a
plain C interface. The library lands in `tdc_tpu_torch/_build/` (listed in
`.gitignore`) under a name keyed by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree loads the library it already built.
Every C entry point returns `cudaGetLastError()` after its launches;
`check` turns a non-zero code into an exception.

`load_host_library` builds a plain C++ source of `csrc/` (no CUDA: the
prefetch loader of `data/native_loader.py`) with g++ the same way: into
`_build/`, keyed by a hash of the source and flags, atomically renamed
into place; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# name -> argtypes; every pointer and the stream are void*, every entry
# point that launches returns an int CUDA error code
# (tdc_segment_chunk_rows, tdc_segment_meta_bytes, tdc_fuzzy_k_tile,
# tdc_fuzzy_grid, tdc_gmm_row_block and tdc_tall_grid return the geometry
# that sizes B3's and B12's, B8's, B9's, B11's and B10's tile form's
# workspaces;
# tdc_lloyd_scratch_floats and tdc_lloyd_bf16_scratch_floats, in
# LONG_RESULTS, the size of the per-call scratch of B1, B2, B4 and B7 and
# of B5's).
SIGNATURES = {
    "tdc_distance_argmin": [_P, _P, _LL, _I, _I, _I, _I, _P, _P, _P, _P],
    "tdc_lloyd_stats_fused": [_P, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P],
    "tdc_lloyd_stats_fused_weighted": [_P, _P, _P, _LL, _I, _I, _I, _P, _P,
                                       _P, _P, _P, _P, _P, _P, _P],
    "tdc_lloyd_stats_fused_bf16": [_P, _I, _P, _P, _LL, _I, _I, _I, _P, _P,
                                   _P, _P, _P, _P, _P, _P, _P],
    "tdc_segment_sums": [_P, _P, _LL, _I, _I, _P, _P, _P, _P, _I, _P],
    "tdc_gathered_segment_sums": [_P, _I, _P, _P, _LL, _I, _I, _P, _P, _P,
                                  _P, _P],
    "tdc_segment_chunk_rows": [],
    "tdc_segment_meta_bytes": [],
    "tdc_fuzzy_normalizer": [_P, _P, _P, _LL, _I, _I, _F, _F, _I, _P, _P,
                             _P, _P],
    "tdc_fuzzy_accumulate": [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _F, _F,
                             _I, _P, _P, _P, _P, _P, _P, _P],
    "tdc_fuzzy_accumulate_mu": [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _F, _F,
                                _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                _P],
    "tdc_fuzzy_stats": [_P, _P, _P, _LL, _I, _I, _F, _F, _F, _LL, _I, _I,
                        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                        _P],
    "tdc_row_sq_norms": [_P, _LL, _I, _P, _P],
    "tdc_fuzzy_k_tile": [],
    "tdc_fuzzy_grid": [_LL, _I, _I, _I],
    "tdc_gmm_stats": [_P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I, _I, _P, _P,
                      _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "tdc_gmm_row_block": [],
    "tdc_tall_lloyd_stats": [_P, _I, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P],
    "tdc_tall_fuzzy_stats": [_P, _I, _P, _P, _LL, _I, _I, _F, _F, _F, _I,
                             _P, _P, _P, _P, _P, _P, _P],
    "tdc_tall_grid": [_LL, _I],
    "tdc_lloyd_scratch_floats": [_I, _I],
    "tdc_lloyd_bf16_scratch_floats": [_I, _I],
}
# Entry points that return a long long instead of an int.
LONG_RESULTS = ("tdc_lloyd_scratch_floats", "tdc_lloyd_bf16_scratch_floats")


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc / ptxas output of this build ('' when reused)


_LOADED: KernelLibrary | None = None


def find_nvcc() -> str:
    """nvcc from PATH, $CUDA_HOME or /usr/local/cuda; raises if none."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels build only where the CUDA toolkit is installed"
    )


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], out: Path) -> str:
    tmp = BUILD_DIR / f"tmp_{out.stem}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    log = []
    try:
        for src in sources:
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src),
                   "-o", str(tmp / f"{src.stem}.o")]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        objs = [str(tmp / f"{src.stem}.o") for src in sources]
        so_tmp = tmp / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so_tmp), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, out)  # atomic: a reader sees all or nothing
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return "".join(log)


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"libtdc_kernels_{_digest(sorted(CSRC.glob('*.cu*')))}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = _compile(find_nvcc(), sources, out)
    seconds = time.perf_counter() - t0 if log else 0.0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _LL if name in LONG_RESULTS else ctypes.c_int
    lib.tdc_error_string.argtypes = [ctypes.c_int]
    lib.tdc_error_string.restype = ctypes.c_char_p
    _LOADED = KernelLibrary(lib, out, seconds, log)
    return _LOADED


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = _LOADED.lib.tdc_error_string(err).decode() if _LOADED else "?"
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_HOST_LIBS: dict = {}


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else g++ from PATH; raises if none."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "no C++ compiler found ($CXX, g++ on PATH): the native "
            "prefetch loader is built from csrc/ at first use")
    return cxx


def load_host_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>` as a shared library with
    the host compiler (HOST_CXX_FLAGS); cached per process. Raises
    RuntimeError with the compiler's output when the build fails."""
    if source in _HOST_LIBS:
        return _HOST_LIBS[source]
    src = CSRC / source
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{out.name}.tmp-{os.getpid()}"
        proc = subprocess.run(
            [find_cxx(), *HOST_CXX_FLAGS, str(src), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {source} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}")
        os.replace(tmp, out)  # atomic: a reader sees all or nothing
    lib = _HOST_LIBS[source] = ctypes.CDLL(str(out))
    return lib
