"""The port's native prefetch loader (`tdc_tpu_torch/data/native_loader.py`
over its own copy of the C++ source, `csrc/prefetch_loader.cpp`, built
with g++ into `tdc_tpu_torch/_build/`) against the JAX package's, on the
CPU: the cases of tests/test_native_loader.py.

Batches are held equal to the file's bytes and to the JAX loader's
exactly; fits over the loader bitwise the port's NpzStream fit, and
against the JAX package's fit over its own loader at the streamed
tolerances (centroids rtol 1e-5 / atol 1e-5).
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from tdc_tpu_torch.data import native_loader as tnl
from tdc_tpu_torch.data.loader import NpzStream
from tdc_tpu_torch.data.native_loader import NativePrefetchStream
from tdc_tpu_torch.models.streaming import (
    streamed_fuzzy_fit,
    streamed_kmeans_fit,
)
from tdc_tpu_torch.ops import _build

PKG = Path(_build.__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def npy_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1003, 6)).astype(np.float32)
    p = str(tmp_path_factory.mktemp("native") / "pts.npy")
    np.save(p, x)
    return p, x


def test_the_library_is_the_ports_own_build(npy_file):
    s = NativePrefetchStream(npy_file[0], 128)
    path = Path(s._lib._name).resolve()
    assert path.parent == (PKG / "_build").resolve()
    assert path.name.startswith("libprefetch_loader_")
    s.close()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building broken.cpp failed"):
        _build.load_host_library("broken.cpp")
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("rows, depth", [(128, 4), (256, 2), (1003, 1),
                                         (5000, 3)])
def test_stream_reproduces_file_and_the_jax_loader(npy_file, rows, depth):
    from tdc_tpu.data.native_loader import NativePrefetchStream as J

    path, x = npy_file
    s = NativePrefetchStream(path, rows_per_batch=rows, depth=depth)
    j = J(path, rows_per_batch=rows, depth=depth)
    got, want = list(s()), list(j())
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), x)
    assert s.num_batches == j.num_batches == -(-1003 // rows)
    s.close()
    j.close()


def test_stream_reiterable_and_reset_midway(npy_file):
    path, x = npy_file
    s = NativePrefetchStream(path, rows_per_batch=256, depth=2)
    for _ in range(3):
        np.testing.assert_array_equal(np.concatenate(list(s())), x)
    it = s()
    next(it), next(it)  # two of four batches, then a new pass
    np.testing.assert_array_equal(np.concatenate(list(s())), x)
    s.close()


def test_open_missing_file_raises():
    with pytest.raises((OSError, FileNotFoundError)):
        NativePrefetchStream("/nonexistent/file.npy", 128)


def test_ranged_read_batch_parity_and_ragged_tail(npy_file):
    path, x = npy_file
    s = NativePrefetchStream(path, rows_per_batch=128)
    assert s.read_batch(0).shape == (128, 6)
    np.testing.assert_array_equal(s.read_batch(7), x[896:])  # 107 rows
    got = np.concatenate([s.read_batch(i) for i in reversed(range(8))])
    want = np.concatenate([x[i * 128:(i + 1) * 128]
                           for i in reversed(range(8))])
    np.testing.assert_array_equal(got, want)
    for bad in (8, -1):
        with pytest.raises(IndexError):
            s.read_batch(bad)
    s.close()


def test_ranged_reads_with_a_sequential_pass_and_from_threads(npy_file):
    path, x = npy_file
    s = NativePrefetchStream(path, rows_per_batch=128)
    it = s()
    first = next(it)
    np.testing.assert_array_equal(s.read_batch(3), x[384:512])
    np.testing.assert_array_equal(np.concatenate([first] + list(it)), x)
    with ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(s.read_batch, range(8)))
    np.testing.assert_array_equal(np.concatenate(got), x)
    s.close()


def test_bf16_file_streams_as_its_bits(tmp_path):
    bits = np.random.default_rng(0).integers(
        0, 1 << 15, size=(300, 4)).astype(np.uint16)
    p = str(tmp_path / "bf16.npy")
    np.save(p, bits.view("V2"))
    s = NativePrefetchStream(p, 128)
    got = np.concatenate(list(s()))
    assert got.dtype == np.dtype("V2")
    np.testing.assert_array_equal(got.view(np.uint16), bits)
    np.testing.assert_array_equal(s.read_batch(2).view(np.uint16),
                                  bits[256:])
    s.close()


@pytest.mark.parametrize("residency", ["stream", "spill", "hbm"])
@pytest.mark.parametrize("fuzzy", [False, True])
def test_fits_over_the_loader_are_the_npzstream_fits(npy_file, residency,
                                                     fuzzy):
    path, x = npy_file
    fit = streamed_fuzzy_fit if fuzzy else streamed_kmeans_fit
    kw = dict(init=x[:4], max_iters=3, tol=-1.0, device="cpu")
    base = fit(NpzStream(x, 200), 4, 6, **kw)
    s = NativePrefetchStream(path, 200)
    res = fit(s, 4, 6, residency=residency, **kw)
    assert torch.equal(base.centroids, res.centroids)
    if residency == "spill":
        assert res.h2d is not None and res.h2d.cross_pass > 0
    s.close()


def test_batch_buffers_are_reused_only_once_released(npy_file):
    """Held batches (and slices of them) keep their bytes while later
    passes run; a pass whose batches are let go reuses two buffers."""
    path, x = npy_file
    s = NativePrefetchStream(path, 200)
    held = list(s())
    sliced = [b[10:20] for b in s()]
    for _ in range(3):
        for b in s():
            pass
    np.testing.assert_array_equal(np.concatenate(held), x)
    np.testing.assert_array_equal(
        np.concatenate(sliced),
        np.concatenate([x[i + 10:i + 20] for i in range(0, 1003, 200)]))
    s.close()
    s = NativePrefetchStream(path, 200)
    for _ in range(3):
        assert [float(b.sum()) for b in s()] == [
            float(x[i:i + 200].sum()) for i in range(0, 1003, 200)]
    assert len(s._pool) == 2
    s.close()


@pytest.mark.parametrize("residency", ["stream", "spill"])
def test_guarded_fits_read_through_the_cpp_pass(npy_file, residency,
                                                monkeypatch):
    """The guard iterates the C++ reader's pass (one ldr_next a batch and
    one more that ends the pass; batch 0's read for the init by pread);
    the spill ring's workers read by pread and open no C++ reader."""
    path, x = npy_file
    s = NativePrefetchStream(path, 200)
    calls = {"ldr_next": 0, "read_batch": 0}

    class Counted:
        def __getattr__(self, name):
            return getattr(tnl._load_lib(), name)

        def ldr_next(self, *a):
            calls["ldr_next"] += 1
            return tnl._load_lib().ldr_next(*a)

    monkeypatch.setattr(s, "_lib", Counted())
    real_read = s.read_batch

    def read_batch(i):
        calls["read_batch"] += 1
        return real_read(i)

    monkeypatch.setattr(s, "read_batch", read_batch)
    res = streamed_kmeans_fit(s, 4, 6, init="first_k", max_iters=3,
                              tol=-1.0, residency=residency, device="cpu")
    assert res.n_iter == 3
    passes, nb = 4, 6  # 3 iterations and the final scoring pass
    if residency == "stream":
        assert calls == {"ldr_next": passes * (nb + 1), "read_batch": 1}
        assert s._id >= 0
    else:
        assert calls["ldr_next"] == 0 and s._id == -1
        assert calls["read_batch"] >= passes * nb + 1
    s.close()


def test_fit_matches_the_jax_fit_over_its_loader(npy_file):
    from tdc_tpu.data.native_loader import NativePrefetchStream as J
    from tdc_tpu.models import streamed_kmeans_fit as jfit

    path, x = npy_file
    s, j = NativePrefetchStream(path, 200), J(path, 200)
    got = streamed_kmeans_fit(s, 4, 6, init=x[:4], max_iters=25, tol=1e-6,
                              device="cpu")
    want = jfit(j, 4, 6, init=x[:4], max_iters=25, tol=1e-6)
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    s.close()
    j.close()


def test_loader_under_the_cli(npy_file, tmp_path):
    from tdc_tpu_torch.cli import main as tcli

    path, _ = npy_file
    log = str(tmp_path / "log.csv")
    for extra in ([], ["--residency=spill"]):
        assert tcli.main([f"--data_file={path}", "--native_loader", "--K=4",
                          "--num_batches=5", "--n_max_iters=3",
                          "--init=first_k", "--device=cpu",
                          f"--log_file={log}", *extra]) == 0
    rows = open(log).read().strip().splitlines()
    assert len(rows) == 3 and rows[1].split(",")[-1] == "ok"
    assert tnl._lib is not None
