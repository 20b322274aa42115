"""The port's kernels B1, B2 and B3, through their wrappers on CPU tensors
(which run the plain PyTorch versions), against the JAX package's Pallas
kernels in interpret mode (automatic off-TPU).

Cases: ragged N (not a block multiple of either package), K and d not
multiples of 128, duplicate centroids (the tie goes to the smallest
index), an empty cluster, and labels outside [0, k) for B3.

Tolerances: labels and counts exactly equal; sums within rtol 1e-5 and
atol 1e-4 (|sums| ≲ 100 here, float32 summation order); SSE and minimum
distances within rtol 1e-5 and 1e-5 of the squared-norm scale.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from tdc_tpu.ops import pallas_kernels as jpk
from tdc_tpu.ops import sorted_stats as jss
from tdc_tpu_torch.ops import _build
from tdc_tpu_torch.ops import assign as tassign
from tdc_tpu_torch.ops import lloyd_kernels as tlk
from tdc_tpu_torch.ops import sorted_stats as tss

RTOL = 1e-5


def _case(name):
    """(x, centroids) for one named case, seeded."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, k, d = {"ragged": (1000, 37, 19), "wide": (1500, 96, 48),
               "duplicate": (700, 20, 5), "empty": (900, 24, 16)}[name]
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = (x[rng.choice(n, k, replace=False)]
         + rng.normal(scale=0.05, size=(k, d))).astype(np.float32)
    if name == "duplicate":
        c[7] = c[3]
        c[11] = c[3]
    if name == "empty":
        c[5] = 100.0
    return x, c


CASES = ["ragged", "wide", "duplicate", "empty"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scale(x, c):
    return 1e-5 * float((x * x).sum(1).max() + (c * c).sum(1).max())


def _assert_stats(got, want, x, c):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL,
                               atol=_scale(x, c))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["lloyd_stats_fused", "lloyd_stats_auto"])
def test_lloyd_stats_fused(fn, case):
    x, c = _case(case)
    got = getattr(tlk, fn)(_t(x), _t(c))
    _assert_stats(got, getattr(jpk, fn)(x, c), x, c)
    if case == "duplicate":
        assert float(got.counts[7]) == 0.0 and float(got.counts[11]) == 0.0
        assert float(got.counts[3]) > 0.0
    if case == "empty":
        assert float(got.counts[5]) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_lloyd_stats_fused_return_labels(case):
    # With return_labels B1 also gives each row's champion: the JAX
    # package's distance_argmin labels; the stats are unchanged.
    x, c = _case(case)
    st, lab = tlk.lloyd_stats_fused(_t(x), _t(c), return_labels=True)
    assert lab.dtype == torch.int32 and lab.shape == (x.shape[0],)
    np.testing.assert_array_equal(lab.numpy(),
                                  np.asarray(jpk.distance_argmin(x, c)[0]))
    _assert_stats(st, jpk.lloyd_stats_fused(x, c), x, c)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("return_dist", [False, True])
def test_distance_argmin(case, return_dist):
    x, c = _case(case)
    wl, wm = jpk.distance_argmin(x, c, return_dist=return_dist)
    gl, gm = tlk.distance_argmin(_t(x), _t(c), return_dist=return_dist)
    assert gl.dtype == torch.int32 and gm.dtype == torch.float32
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=RTOL,
                               atol=_scale(x, c))
    if case == "duplicate":
        assert not np.isin(gl.numpy(), [7, 11]).any()


def _labels_with_strays(n, k, seed):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, size=n).astype(np.int32)
    lab[rng.choice(n, 40, replace=False)] = -3  # outside [0, k): ignored
    lab[rng.choice(n, 40, replace=False)] = k + 5
    lab[lab == 2] = 0  # label 2 absent: an empty run
    return lab


@pytest.mark.parametrize("pallas", [True, False])
def test_sorted_cluster_stats(pallas):
    x, _ = _case("ragged")
    lab = _labels_with_strays(x.shape[0], 37, 1)
    ws, wc = jss.sorted_cluster_stats(x, lab, 37, pallas=pallas)
    gs, gc = tss.sorted_cluster_stats(_t(x), _t(lab), 37, pallas=pallas)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL,
                               atol=1e-4)
    assert float(gc[2]) == 0.0 and not gs[2].any()


def test_sorted_counts():
    lab = np.sort(_labels_with_strays(500, 30, 2).clip(0, 30))
    np.testing.assert_array_equal(
        tss.sorted_counts(_t(lab), 30).numpy(),
        np.asarray(jss.sorted_counts(lab, 30)))


@pytest.mark.parametrize("case", CASES)
def test_lloyd_stats_sorted(case):
    x, c = _case(case)
    _assert_stats(tss.lloyd_stats_sorted(_t(x), _t(c)),
                  jss.lloyd_stats_sorted(x, c), x, c)


def test_segment_sums_plain_matches_loop():
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(50, 6)).astype(np.float32)
    starts = np.array([0, 0, 7, 7, 30, 50], np.int32)
    got = tss.segment_sums(_t(xs), _t(starts)).numpy()
    want = np.stack([xs[a:b].sum(0) for a, b in zip(starts[:-1], starts[1:])])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_route_past_fused_limit_is_sorted_and_agrees():
    # Port-only: K·d past FUSED_MAX_KD routes to B2 + B3, which gives the
    # same stats as the dense plain path.
    rng = np.random.default_rng(4)
    k, d = 1024, tlk.FUSED_MAX_KD // 1024 + 1
    x = rng.normal(size=(300, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    assert tlk.lloyd_stats_for(k, d) is tss.lloyd_stats_sorted
    assert tlk.lloyd_stats_for(1024, 128) is tlk.lloyd_stats_fused
    with pytest.raises(ValueError):
        tlk.lloyd_stats_fused(_t(x), _t(c))
    _assert_stats(tlk.lloyd_stats_auto(_t(x), _t(c)),
                  tassign.lloyd_stats(_t(x), _t(c)), x, c)


def test_resolve_kernel_auto_by_device():
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cpu") == "xla"
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cuda") == "pallas"
    assert tlk.resolve_kernel("refined", k=8, d=4, device="cuda") == "refined"
    # auto:quantized takes the plain auto choice wherever the bf16
    # epilogue does not apply (here: the CPU), never an error.
    assert tlk.resolve_kernel("auto:quantized", k=8, d=4,
                              device="cpu") == "xla"


def test_wrappers_check_inputs():
    x = torch.zeros((10, 4))
    with pytest.raises(TypeError):
        tlk.distance_argmin(x.double(), torch.zeros((3, 4)).double())
    with pytest.raises(ValueError):
        tlk.lloyd_stats_fused(x, torch.zeros((3, 5)))
    with pytest.raises(TypeError):
        tss.segment_sums(x, torch.zeros(3, dtype=torch.int64))


def test_plain_versions_do_not_count_launches():
    x, c = _case("ragged")
    before = (tlk.distance_argmin.launches, tlk.lloyd_stats_fused.launches,
              tss.segment_sums.launches)
    tss.lloyd_stats_sorted(_t(x), _t(c))
    tlk.lloyd_stats_fused(_t(x), _t(c))
    assert (tlk.distance_argmin.launches, tlk.lloyd_stats_fused.launches,
            tss.segment_sums.launches) == before



def _c_entry_points():
    """name -> parameter list of every `extern "C"` function in csrc/."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" \w+\s+(tdc_\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = params
    return found


def _ctype_of(param: str):
    if "*" in param:
        return ctypes.c_void_p
    decl = " ".join(param.replace("const ", "").split()[:-1])
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[decl]


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_sources(name):
    # Each entry point's argtypes list the C parameters one for one: a
    # missing or extra argument shifts every later pointer on the card.
    params = _c_entry_points()[name]
    assert [_ctype_of(p) for p in params] == _build.SIGNATURES[name]
