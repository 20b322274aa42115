"""bf16 points and the bf16 kernel B5 in the port, against the JAX package
on the CPU.

The same seeded numpy inputs go to both packages; bf16 arrays are
ml_dtypes' bfloat16 on the JAX side and the same bits as a
torch.bfloat16 tensor on the port's side. The JAX side runs its own code:
XLA for the plain paths, the Pallas kernels in interpret mode (automatic
off-TPU). On the port's side CPU tensors take the plain PyTorch versions
of the kernels: B5's (`lloyd_stats_fused_bf16_plain`), and B2, B3, B4 and
B6 on rows widened to f32 with the centroids rounded to bf16
(`lloyd_kernels.widened`).

B5 is held to `lloyd_stats_fused(x, c, mxu_dtype="bfloat16")` on f32 x and
to `lloyd_stats_fused(x_bf16, c)` on bf16 x. Every comparison is xla with
xla and pallas with pallas: on one bf16 dataset the two routes differ in
the JAX package itself (the plain path promotes the rows against f32
centroids; the kernels round the centroids to bf16).

Tolerances (float32, different summation order in the two frameworks):
labels and counts equal; sums rtol 1e-5, atol 1e-4; the weight mass rtol
1e-6, atol 1e-5; SSE rtol 1e-5 with an atol of 1e-5 of the squared-norm
scale; fuzzy Σμx, Σμ and the objective rtol 1e-5 with an atol of 1e-5 of
the summed magnitude; fits equal in n_iter and converged, centroids within
1e-5 (GMM means 1e-4, as in test_torch_gmm.py).
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from tdc_tpu.models import fuzzy as jfz
from tdc_tpu.models import gmm as jgmm
from tdc_tpu.models import kmeans as jkm
from tdc_tpu.ops import pallas_kernels as jpk
from tdc_tpu.ops import sorted_stats as jss
from tdc_tpu_torch.data import make_blobs
from tdc_tpu_torch.data.loader import restore_bf16
from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.ops import fuzzy_kernels as tfk
from tdc_tpu_torch.ops import lloyd_kernels as tlk
from tdc_tpu_torch.ops import sorted_stats as tss

RTOL = 1e-5
BF16 = ml_dtypes.bfloat16


def _t(a):
    """numpy → torch; an ml_dtypes bfloat16 array → the same bits as a
    torch.bfloat16 tensor."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _case(name):
    """(x f32, centroids f32) for one named case, seeded: ragged N, K and d
    (no block or tile multiple of either package), a wide case, duplicate
    centroids and an empty cluster."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, k, d = {"ragged": (1000, 37, 19), "wide": (1500, 96, 48),
               "duplicate": (700, 20, 5), "empty": (900, 24, 16)}[name]
    x = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    c = (x[rng.choice(n, k, replace=False)]
         + rng.normal(scale=0.05, size=(k, d))).astype(np.float32)
    if name == "duplicate":
        c[7] = c[3]
        c[11] = c[3]
    if name == "empty":
        c[5] = 100.0
    return x, c


CASES = ["ragged", "wide", "duplicate", "empty"]


def _sse_atol(x, c):
    x = np.asarray(x, np.float32)
    return 1e-5 * float((x * x).sum(1).max() + (c * c).sum(1).max())


def _assert_stats(got, want, x, c):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL,
                               atol=_sse_atol(x, c))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_b5_plain_against_the_interpret_mode_kernel(rows, case):
    x, c = _case(case)
    if rows == "f32":
        want = jpk.lloyd_stats_fused(x, c, mxu_dtype="bfloat16")
    else:
        x = x.astype(BF16)
        want = jpk.lloyd_stats_fused(x, c)
    before = tlk.lloyd_stats_fused_bf16.launches
    got, labels = tlk.lloyd_stats_fused_bf16(_t(x), _t(c), return_labels=True)
    assert tlk.lloyd_stats_fused_bf16.launches == before  # plain: no launch
    _assert_stats(got, want, x, c)
    np.testing.assert_array_equal(
        torch.bincount(labels.long(), minlength=c.shape[0]).numpy(),
        got.counts.numpy())
    if case == "duplicate":
        assert not np.isin(labels.numpy(), [7, 11]).any()
    if case == "empty":
        assert float(got.counts[5]) == 0.0


def test_b5_rounds_what_the_reference_rounds():
    # f32 rows: the champion sees the rows and centroids rounded to bf16,
    # c2 comes from the f32 centroids, Σx from the unrounded rows. bf16
    # rows: c2 from the rounded centroids. A row exactly between two
    # centroids that differ only below bf16's precision shows each rule.
    c = np.array([[1.0, 0.0], [1.0 + 2.0 ** -12, 0.0]], np.float32)
    x = np.array([[1.0 + 2.0 ** -13, 0.25]], np.float32)
    f32 = tlk.lloyd_stats_fused_bf16(_t(x), _t(c))
    want = jpk.lloyd_stats_fused(x, c, mxu_dtype="bfloat16")
    np.testing.assert_array_equal(f32.counts.numpy(), np.asarray(want.counts))
    # The rounded row is (1, 0.25) against two rounded centroids (1, 0),
    # and ‖c₁‖² > ‖c₀‖² in f32: centroid 0 takes it.
    assert f32.counts.tolist() == [1.0, 0.0]
    assert f32.sums[0, 0].item() == x[0, 0]  # the unrounded row
    xb = x.astype(BF16)
    cb = np.array([[1.0, 0.0], [1.0 - 2.0 ** -12, 0.0]], np.float32)
    got = tlk.lloyd_stats_fused_bf16(_t(xb), _t(cb))
    # Both centroids round to (1, 0): an exact tie, the smaller index wins.
    assert got.counts.tolist() == [1.0, 0.0]
    np.testing.assert_array_equal(
        got.counts.numpy(), np.asarray(jpk.lloyd_stats_fused(xb, cb).counts))


def test_b5_wrapper_checks_inputs():
    x = torch.zeros((10, 4))
    c = torch.zeros((3, 4))
    with pytest.raises(TypeError):
        tlk.lloyd_stats_fused_bf16(x.double(), c)
    with pytest.raises(TypeError):
        tlk.lloyd_stats_fused_bf16(x, c.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tlk.lloyd_stats_fused_bf16(x, torch.zeros((3, 5)))
    with pytest.raises(ValueError, match="FUSED_MAX_KD"):
        tlk.lloyd_stats_fused_bf16(torch.zeros((4, 1024)),
                                   torch.zeros((1024, 1024)))
    # B1 stays f32-only: bf16 rows take B5.
    with pytest.raises(TypeError):
        tlk.lloyd_stats_fused(x.to(torch.bfloat16), c)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("return_dist", [False, True])
def test_distance_argmin_on_bf16_rows(case, return_dist):
    x, c = _case(case)
    xb = x.astype(BF16)
    wl, wm = jpk.distance_argmin(xb, c, return_dist=return_dist)
    gl, gm = tlk.distance_argmin(_t(xb), _t(c), return_dist=return_dist)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=RTOL,
                               atol=_sse_atol(x, c))


@pytest.mark.parametrize("case", CASES)
def test_sorted_route_on_bf16_rows(case):
    x, c = _case(case)
    xb = x.astype(BF16)
    _assert_stats(tss.lloyd_stats_sorted(_t(xb), _t(c)),
                  jss.lloyd_stats_sorted(xb, c), x, c)


def _weights(n, seed=1):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 3, size=n).astype(np.float32)
    w[rng.choice(n, 50, replace=False)] = 0.0
    return w


def _assert_weighted(got, want, x, c):
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL,
                               atol=3 * _sse_atol(x, c))


@pytest.mark.parametrize("case", ["ragged", "duplicate"])
@pytest.mark.parametrize("route", ["fused", "sorted"])
def test_weighted_routes_on_bf16_rows(route, case):
    x, c = _case(case)
    xb = x.astype(BF16)
    w = _weights(x.shape[0])
    if route == "fused":
        got = tlk.lloyd_stats_fused_weighted(_t(xb), _t(c), _t(w))
        want = jpk.lloyd_stats_fused_weighted(xb, c, w)
    else:
        got = tss.lloyd_stats_sorted_weighted(_t(xb), _t(c), _t(w))
        want = jss.lloyd_stats_sorted_weighted(xb, c, w)
    _assert_weighted(got, want, x, c)


@pytest.mark.parametrize("m", [2.0, 1.7])
def test_fuzzy_kernel_on_bf16_rows(m):
    # block_n = N: the JAX kernel pads no rows. With padding, its zero-row
    # correction is computed against the unrounded centroids while the
    # kernel saw rounded ones, which on bf16 rows leaves a residue of
    # ~0.5% in Σμ at this shape (its default block_n=2048 pads 1024 rows);
    # ROADMAP.md records it.
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(1024, 12)) * 2).astype(BF16)
    c = rng.normal(size=(9, 12)).astype(np.float32) * 2
    got = tfk.fuzzy_stats_fused(_t(x), _t(c), m)
    want = jpk.fuzzy_stats_fused(x, c, m=m, block_n=1024)
    mag = float(np.abs(np.asarray(x, np.float32)).sum())
    np.testing.assert_allclose(got.weighted_sums.numpy(),
                               np.asarray(want.weighted_sums), rtol=RTOL,
                               atol=1e-5 * mag)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=RTOL, atol=1e-5 * x.shape[0])
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)


def _blobs(seed=0, n=2000, k=12, d=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(k, d))
    y = rng.integers(0, k, size=n)
    x = (centers[y] + rng.normal(size=(n, d))).astype(BF16)
    init = np.asarray(x[rng.choice(n, k, replace=False)], np.float32)
    return x, init


def _assert_fit(j, t):
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_bf16"])
@pytest.mark.parametrize("tol", [-1.0, 1e-4])
def test_kmeans_fit_on_bf16_points(kernel, tol):
    x, init = _blobs()
    kw = dict(init=init, max_iters=8, tol=tol, kernel=kernel)
    j = jkm.kmeans_fit(x, 12, **kw)
    t = tkm.kmeans_fit(x, 12, device="cpu", **kw)  # a numpy bf16 array
    _assert_fit(j, t)
    np.testing.assert_allclose(float(t.sse), float(j.sse), rtol=RTOL)


def test_kmeans_fit_pallas_bf16_on_f32_points():
    x, init = _blobs(1)
    x = np.asarray(x, np.float32)
    kw = dict(init=init, max_iters=8, tol=1e-4, kernel="pallas_bf16")
    j = jkm.kmeans_fit(x, 12, **kw)
    t = tkm.kmeans_fit(x, 12, device="cpu", **kw)
    _assert_fit(j, t)
    np.testing.assert_allclose(float(t.sse), float(j.sse), rtol=RTOL)


def test_xla_and_pallas_differ_on_bf16_points_in_both_packages():
    # The plain path promotes the rows against f32 centroids; the kernels
    # round the centroids to bf16. Each package shows the same gap.
    x, init = _blobs(2)
    kw = dict(init=init, max_iters=3, tol=-1.0)
    jx, jp = (jkm.kmeans_fit(x, 12, kernel=k, **kw) for k in ("xla",
                                                              "pallas"))
    tx, tp = (tkm.kmeans_fit(x, 12, kernel=k, device="cpu", **kw)
              for k in ("xla", "pallas"))
    assert float(jx.sse) != float(jp.sse)
    np.testing.assert_allclose(float(tx.sse), float(jx.sse), rtol=RTOL)
    np.testing.assert_allclose(float(tp.sse), float(jp.sse), rtol=RTOL)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_kmeans_predict_on_bf16_points(kernel):
    x, c = _case("ragged")
    xb = x.astype(BF16)
    np.testing.assert_array_equal(
        tkm.kmeans_predict(xb, c, kernel=kernel, device="cpu").numpy(),
        np.asarray(jkm.kmeans_predict(xb, c, kernel=kernel)))


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_fuzzy_fit_on_bf16_points(kernel):
    # N = 2048, the JAX kernel's block here: no padded rows (see
    # test_fuzzy_kernel_on_bf16_rows).
    x, init = _blobs(3, n=2048, k=6, d=5)
    kw = dict(m=2.0, init=init, max_iters=6, tol=-1.0, kernel=kernel)
    j = jfz.fuzzy_cmeans_fit(x, 6, **kw)
    t = tfz.fuzzy_cmeans_fit(x, 6, device="cpu", **kw)
    _assert_fit(j, t)
    np.testing.assert_allclose(float(t.objective), float(j.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_gmm_fit_on_bf16_points(kernel):
    x, init = _blobs(4, n=1500, k=6, d=4)
    kw = dict(init=init, max_iters=8, tol=-1.0, covariance_type="diag",
              kernel=kernel)
    j = jgmm.gmm_fit(x, 6, **kw)
    t = tgmm.gmm_fit(x, 6, device="cpu", **kw)
    assert t.n_iter == int(j.n_iter) and t.converged == bool(j.converged)
    np.testing.assert_allclose(t.means.numpy(), np.asarray(j.means),
                               atol=1e-4)
    np.testing.assert_allclose(float(t.log_likelihood),
                               float(j.log_likelihood), rtol=RTOL)


def _events(capsys):
    return [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("kw,choice,reason", [
    ({}, "pallas_bf16", ":quantized accepted"),
    ({"itemsize": 2}, "pallas", "rows are not f32"),
    ({"model": "kmeans_weighted"}, "pallas", "model=kmeans_weighted"),
    ({"model": "fuzzy"}, "pallas", "model=fuzzy"),
    ({"model": "gmm"}, "pallas", "model=gmm"),
    ({"k": 16384, "d": 768}, "pallas", "past the fused limit"),
    ({"device": "cpu"}, "xla", "CUDA-only"),
    ({"model": "gmm", "ineligible": "the fused E-step is diag/spherical"},
     "xla", "diag/spherical"),
])
def test_resolve_kernel_auto_quantized(kw, choice, reason, capsys):
    args = dict(k=1024, d=128, device="cuda", model="kmeans", label="t")
    args.update(kw)
    assert tlk.resolve_kernel("auto:quantized", **args) == choice
    (event,) = _events(capsys)
    assert event["event"] == "kernel_selected"
    assert event["kernel"] == choice and reason in event["reason"]
    # Plain auto never picks the bf16 epilogue.
    assert tlk.resolve_kernel("auto", **args) == (
        "pallas" if choice == "pallas_bf16" else choice)


def test_fits_resolve_auto_quantized_on_the_cpu(capsys):
    x, init = _blobs(5, n=400, k=4, d=3)
    tkm.kmeans_fit(x, 4, init=init, max_iters=2, kernel="auto:quantized",
                   device="cpu")
    tfz.fuzzy_cmeans_fit(x, 4, init=init, max_iters=2,
                         kernel="auto:quantized", device="cpu")
    tgmm.gmm_fit(x, 4, init=init, max_iters=2, kernel="auto:quantized",
                 device="cpu")
    events = [e for e in _events(capsys) if e["event"] == "kernel_selected"]
    assert [(e["model"], e["kernel"]) for e in events] == [
        ("kmeans", "xla"), ("fuzzy", "xla"), ("gmm", "xla")]


@pytest.mark.parametrize("dtype,mxu,route,reason", [
    (torch.float32, None, "fused", "stays bounded"),
    (torch.bfloat16, None, "fused_bf16", "bf16 rows"),
    (torch.float32, "bfloat16", "fused_bf16", "mxu_dtype='bfloat16'"),
    (torch.float32, "bfloat16", "sorted", "full input precision"),
    (torch.bfloat16, None, "sorted", "would grow past its limit"),
])
def test_lloyd_stats_for_routes_by_dtype(dtype, mxu, route, reason, capsys):
    k, d = (16384, 768) if route == "sorted" else (1024, 128)
    fn = tlk.lloyd_stats_for(k, d, dtype=dtype, mxu_dtype=mxu)
    assert fn is {"fused": tlk.lloyd_stats_fused,
                  "fused_bf16": tlk.lloyd_stats_fused_bf16,
                  "sorted": tss.lloyd_stats_sorted}[route]
    (event,) = _events(capsys)
    assert event["kernel"] == route and reason in event["reason"]
    with pytest.raises(ValueError, match="mxu_dtype"):
        tlk.lloyd_stats_for(k, d, mxu_dtype="float16")


def test_pallas_bf16_rejections_match_the_reference():
    x, init = _blobs(6, n=300, k=4, d=3)
    w = np.ones(300, np.float32)
    for fit, kw in ((jkm.kmeans_fit, {}), (tkm.kmeans_fit, {"device": "cpu"})):
        with pytest.raises(ValueError, match="does not support sample_weight"):
            fit(x, 4, init=init, kernel="pallas_bf16", sample_weight=w, **kw)
    with pytest.raises(ValueError, match="single-device"):
        tkm.kmeans_fit(x, 4, init=init, kernel="pallas_bf16", mesh=object(),
                       device="cpu")


def test_points_keep_bf16_and_restore_from_numpy():
    x = np.arange(12, dtype=np.float32).reshape(4, 3).astype(BF16)
    raw = x.view(np.dtype("V2"))  # what np.load gives for a bf16 file
    t = restore_bf16(raw)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))
    assert restore_bf16(np.zeros(3, np.float32)).dtype == np.float32
    assert tkm._as_points(x, torch.device("cpu")).dtype == torch.bfloat16
    assert tkm._as_points(np.zeros((2, 2)),
                          torch.device("cpu")).dtype == torch.float32
    xb, _ = make_blobs(0, 100, 3, 4, device="cpu", dtype=torch.bfloat16)
    assert xb.dtype == torch.bfloat16 and xb.shape == (100, 3)
