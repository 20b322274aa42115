"""Sample-weighted K-Means and Fuzzy C-Means of the port against the JAX
package, on the CPU.

The same seeded numpy inputs go to both packages. The JAX side runs its
own code: `ops.assign` in XLA, and the Pallas `lloyd_stats_fused_weighted`
and `lloyd_stats_sorted_weighted` in interpret mode (automatic off-TPU)
with block_n=256 and sort_block=128, so their zero-weight padding runs
wherever N is not a block multiple. On the port's side, CPU tensors take
the plain PyTorch versions of the kernels (B4, and B2 + B3 on the sorted
route).

Tolerances (float32, different summation order in the two frameworks):
sums rtol 1e-5, atol 1e-4; the weight mass rtol 1e-6, atol 1e-5; SSE rtol
1e-5; fuzzy Σμx, Σμ and the objective rtol 1e-5 with an atol of 1e-5 of
the summed magnitude; fits equal in n_iter and converged, centroids rtol
1e-5 and atol 1e-5, SSE or objective rtol 1e-5.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tdc_tpu.models import _common as jcommon
from tdc_tpu.models import fuzzy as jfz
from tdc_tpu.models import kmeans as jkm
from tdc_tpu.ops import assign as jassign
from tdc_tpu.ops import pallas_kernels as jpk
from tdc_tpu.ops import sorted_stats as jss
from tdc_tpu_torch.models import _common as tcommon
from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.ops import assign as tassign
from tdc_tpu_torch.ops import init as tinit
from tdc_tpu_torch.ops import lloyd_kernels as tlk
from tdc_tpu_torch.ops import sorted_stats as tss
from tdc_tpu_torch.parallel import mesh as tmesh

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _case(name):
    """(x, centroids, weights) for one named case, seeded. Every case has
    50 zero-weight rows. 'small': the JAX package's own weighted-kernel
    shape. 'ragged': N, K and d that are no block or tile multiple.
    'duplicate': centroid 3 copied to 7 and 11 (ties go to the smallest
    index, so the copies take no mass)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, k, d = {"small": (700, 5, 6), "ragged": (1000, 37, 19),
               "duplicate": (900, 20, 5)}[name]
    x = (rng.normal(size=(n, d)) * 4).astype(np.float32)
    c = (x[rng.choice(n, k, replace=False)]
         + rng.normal(scale=0.1, size=(k, d))).astype(np.float32)
    if name == "duplicate":
        c[7] = c[3]
        c[11] = c[3]
    w = rng.uniform(0, 3, size=n).astype(np.float32)
    w[rng.choice(n, 50, replace=False)] = 0.0
    return x, c, w


CASES = ["small", "ragged", "duplicate"]


def _assert_lloyd(got, want):
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_lloyd_stats_weighted(case):
    x, c, w = _case(case)
    _assert_lloyd(tassign.lloyd_stats_weighted(_t(x), _t(c), _t(w)),
                  jassign.lloyd_stats_weighted(x, c, w))


@pytest.mark.parametrize("block_rows", [128, 300, 1000])
def test_lloyd_stats_weighted_blocked(block_rows):
    x, c, w = _case("ragged")
    _assert_lloyd(
        tassign.lloyd_stats_weighted_blocked(_t(x), _t(c), _t(w),
                                             block_rows),
        jassign.lloyd_stats_weighted_blocked(x, c, w, block_rows))


def _assert_fuzzy(got, want, x, c, w, m):
    mu = (np.asarray(jassign.fuzzy_memberships(x, c, m=m)) ** m
          * w[:, None])
    np.testing.assert_allclose(got.weighted_sums.numpy(),
                               np.asarray(want.weighted_sums), rtol=RTOL,
                               atol=1e-5 * float((mu.T @ np.abs(x)).max()))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=RTOL,
                               atol=1e-5 * float(np.max(want.weights)))
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("m", [2.0, 1.7])
@pytest.mark.parametrize("case", CASES)
def test_fuzzy_stats_weighted(case, m):
    x, c, w = _case(case)
    _assert_fuzzy(tassign.fuzzy_stats_weighted(_t(x), _t(c), _t(w), m=m),
                  jassign.fuzzy_stats_weighted(x, c, w, m=m), x, c, w, m)


@pytest.mark.parametrize("block_rows", [128, 300, 1000])
def test_fuzzy_stats_weighted_blocked(block_rows):
    x, c, w = _case("ragged")
    _assert_fuzzy(
        tassign.fuzzy_stats_weighted_blocked(_t(x), _t(c), _t(w), 1.7,
                                             block_rows),
        jassign.fuzzy_stats_weighted_blocked(x, c, w, 1.7, block_rows),
        x, c, w, 1.7)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["lloyd_stats_fused_weighted_plain",
                                "lloyd_stats_fused_weighted",
                                "lloyd_stats_auto_weighted"])
def test_lloyd_stats_fused_weighted_against_interpret_mode(fn, case):
    # A live interpret-mode run of the JAX kernel (N % 256 != 0: its
    # zero-weight padding runs), and the XLA twin.
    x, c, w = _case(case)
    assert x.shape[0] % 256
    got = getattr(tlk, fn)(_t(x), _t(c), _t(w))
    _assert_lloyd(got, jpk.lloyd_stats_fused_weighted(x, c, w, block_n=256))
    _assert_lloyd(got, jassign.lloyd_stats_weighted(x, c, w))
    if case == "duplicate":
        assert float(got.counts[7]) == 0.0 and float(got.counts[11]) == 0.0
        assert not got.sums[7].any() and not got.sums[11].any()
        assert float(got.counts[3]) > 0.0


@pytest.mark.parametrize("case", CASES)
def test_lloyd_stats_fused_weighted_return_labels(case):
    # With return_labels B4 also gives each row's champion (zero-weight
    # rows too): the JAX package's distance_argmin labels; the stats are
    # unchanged.
    x, c, w = _case(case)
    st, lab = tlk.lloyd_stats_fused_weighted(_t(x), _t(c), _t(w),
                                             return_labels=True)
    assert lab.dtype == torch.int32 and lab.shape == (x.shape[0],)
    np.testing.assert_array_equal(lab.numpy(),
                                  np.asarray(jpk.distance_argmin(x, c)[0]))
    _assert_lloyd(st, jpk.lloyd_stats_fused_weighted(x, c, w, block_n=256))


@pytest.mark.parametrize("case", CASES)
def test_lloyd_stats_sorted_weighted(case):
    x, c, w = _case(case)
    got = tss.lloyd_stats_sorted_weighted(_t(x), _t(c), _t(w))
    _assert_lloyd(got, jss.lloyd_stats_sorted_weighted(x, c, w,
                                                       sort_block=128))
    _assert_lloyd(got, jassign.lloyd_stats_weighted(x, c, w))


def test_zero_weight_rows_add_nothing():
    # The stats of x with 50 zero-weight rows equal those of x without
    # them (to the rounding of another summation order).
    x, c, w = _case("ragged")
    keep = w > 0
    for fn in (tlk.lloyd_stats_fused_weighted,
               tss.lloyd_stats_sorted_weighted):
        a = fn(_t(x), _t(c), _t(w))
        b = fn(_t(x[keep]), _t(c), _t(w[keep]))
        np.testing.assert_allclose(a.sums.numpy(), b.sums.numpy(), rtol=RTOL,
                                   atol=1e-4)
        np.testing.assert_allclose(a.counts.numpy(), b.counts.numpy(),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(float(a.sse), float(b.sse), rtol=RTOL)


def test_weighted_route_by_shape():
    # B4 while K·(d+1) <= FUSED_MAX_KD, the weighted sorted route past it;
    # past the limit the wrapper raises and the route still agrees with the
    # XLA twin.
    assert tlk.lloyd_stats_weighted_for(1024, 128) is (
        tlk.lloyd_stats_fused_weighted)
    assert tlk.lloyd_stats_weighted_for(16384, 768) is (
        tss.lloyd_stats_sorted_weighted)
    k = 1024
    d = tlk.FUSED_MAX_KD // k  # K·d fits B1, K·(d+1) does not fit B4
    assert tlk.fused_fits(k, d) and not tlk.fused_weighted_fits(k, d)
    assert tlk.lloyd_stats_weighted_for(k, d) is (
        tss.lloyd_stats_sorted_weighted)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    w = rng.uniform(0, 2, size=300).astype(np.float32)
    with pytest.raises(ValueError, match="FUSED_MAX_KD"):
        tlk.lloyd_stats_fused_weighted(_t(x), _t(c), _t(w))
    _assert_lloyd(tlk.lloyd_stats_auto_weighted(_t(x), _t(c), _t(w)),
                  tassign.lloyd_stats_weighted(_t(x), _t(c), _t(w)))


def test_weighted_wrapper_checks_inputs_and_counts_no_plain_launch():
    x, c, w = _case("small")
    before = (tlk.lloyd_stats_fused_weighted.launches,
              tlk.distance_argmin.launches, tss.segment_sums.launches)
    tlk.lloyd_stats_auto_weighted(_t(x), _t(c), _t(w))
    tss.lloyd_stats_sorted_weighted(_t(x), _t(c), _t(w))
    assert (tlk.lloyd_stats_fused_weighted.launches,
            tlk.distance_argmin.launches,
            tss.segment_sums.launches) == before
    with pytest.raises(ValueError, match="weights must be"):
        tlk.lloyd_stats_fused_weighted(_t(x), _t(c), _t(w[:-1]))
    with pytest.raises(TypeError):
        tlk.lloyd_stats_fused_weighted(_t(x), _t(c), _t(w).double())


def test_resolve_kernel_weighted():
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cuda",
                              model="kmeans_weighted") == "pallas"
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cpu",
                              model="kmeans_weighted") == "xla"
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cuda", model="fuzzy",
                              ineligible="no weighted kernel") == "xla"


def _blobs(seed=0, n=1500, k=8, d=6):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(k, d))
    y = rng.integers(0, k, size=n)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    init = x[rng.choice(n, k, replace=False)].copy()
    w = rng.uniform(0, 3, size=n).astype(np.float32)
    w[rng.choice(n, 50, replace=False)] = 0.0
    return x, init, w


def _assert_fit(j, t, cost="sse"):
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(getattr(t, cost)),
                               float(getattr(j, cost)), rtol=RTOL)


@pytest.mark.parametrize("tol", [-1.0, 1e-4])
@pytest.mark.parametrize("kernel", ["xla", "pallas", "auto"])
def test_weighted_kmeans_fit(kernel, tol):
    x, init, w = _blobs()
    kw = dict(init=init, sample_weight=w, max_iters=15, tol=tol,
              kernel=kernel)
    j = jkm.kmeans_fit(x, 8, **kw)
    t = tkm.kmeans_fit(x, 8, device="cpu", **kw)
    _assert_fit(j, t)
    if tol < 0:
        assert t.n_iter == 15
    else:
        assert t.converged and t.n_iter < 15


def test_weighted_kmeans_fit_relocate_reads_the_mass():
    x, init, w = _blobs(1)
    init[4] = 500.0  # empty from the first iteration on
    kw = dict(init=init, sample_weight=w, max_iters=10, tol=-1.0,
              empty_policy="relocate")
    j = jkm.kmeans_fit(x, 8, kernel="pallas", **kw)
    for kernel in ("xla", "pallas"):
        t = tkm.kmeans_fit(x, 8, device="cpu", kernel=kernel, **kw)
        _assert_fit(j, t)
        assert np.abs(t.centroids.numpy()).max() < 100.0


@pytest.mark.parametrize("kernel", ["xla", "auto"])
def test_weighted_fuzzy_cmeans_fit(kernel):
    x, init, w = _blobs(2)
    kw = dict(init=init, sample_weight=w, m=1.7, max_iters=12, tol=1e-4,
              kernel=kernel)
    _assert_fit(jfz.fuzzy_cmeans_fit(x, 8, **kw),
                tfz.fuzzy_cmeans_fit(x, 8, device="cpu", **kw), "objective")


def test_weighted_fuzzy_auto_announces_the_plain_path(capsys):
    x, init, w = _blobs(3)
    tfz.fuzzy_cmeans_fit(x, 8, init=init, sample_weight=w, max_iters=2,
                         kernel="auto", device="cpu")
    events = [json.loads(line) for line in capsys.readouterr().err.splitlines()
              if '"kernel_selected"' in line]
    assert len(events) == 1
    assert events[0]["kernel"] == "xla"
    assert "weighted fuzzy" in events[0]["reason"]


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_integer_weights_equal_duplicated_rows(kernel):
    x, init, _ = _blobs(4)
    w = np.ones(len(x), np.float32)
    w[: len(x) // 3] = 2.0
    dup = np.concatenate([x, x[: len(x) // 3]])
    kw = dict(init=init, max_iters=12, tol=-1.0, device="cpu")
    a = tkm.kmeans_fit(x, 8, sample_weight=w, kernel=kernel, **kw)
    b = tkm.kmeans_fit(dup, 8, kernel=kernel, **kw)
    np.testing.assert_allclose(a.centroids.numpy(), b.centroids.numpy(),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(a.sse), float(b.sse), rtol=RTOL)
    fa = tfz.fuzzy_cmeans_fit(x, 8, sample_weight=w, kernel="xla", **kw)
    fb = tfz.fuzzy_cmeans_fit(dup, 8, kernel="xla", **kw)
    np.testing.assert_allclose(fa.centroids.numpy(), fb.centroids.numpy(),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(fa.objective), float(fb.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_all_one_weights_equal_no_weights(kernel):
    x, init, _ = _blobs(5)
    ones = np.ones(len(x), np.float32)
    kw = dict(init=init, max_iters=12, tol=1e-4, device="cpu")
    a = tkm.kmeans_fit(x, 8, sample_weight=ones, kernel=kernel, **kw)
    b = tkm.kmeans_fit(x, 8, kernel=kernel, **kw)
    assert (a.n_iter, a.converged) == (b.n_iter, b.converged)
    np.testing.assert_allclose(a.centroids.numpy(), b.centroids.numpy(),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(a.sse), float(b.sse), rtol=RTOL)
    fa = tfz.fuzzy_cmeans_fit(x, 8, sample_weight=ones, kernel="xla", **kw)
    fb = tfz.fuzzy_cmeans_fit(x, 8, kernel="xla", **kw)
    assert fa.n_iter == fb.n_iter
    np.testing.assert_allclose(fa.centroids.numpy(), fb.centroids.numpy(),
                               rtol=RTOL, atol=1e-5)


# Row indices the unweighted seeded draws picked on the commit before
# weights were added (init_random and init_kmeans_pp, generator seed 5,
# K=7): the weighted draws must leave the unweighted ones as they were.
_UNWEIGHTED_PINS = {"init_random": [11, 146, 273, 204, 10, 85, 238],
                    "init_kmeans_pp": [11, 8, 29, 240, 222, 299, 159]}


@pytest.mark.parametrize("which", sorted(_UNWEIGHTED_PINS))
def test_unweighted_init_draws_unchanged(which):
    x = np.random.default_rng(21).normal(size=(300, 5)).astype(np.float32)
    got = getattr(tinit, which)(torch.Generator().manual_seed(5), _t(x), 7)
    np.testing.assert_array_equal(got.numpy(), x[_UNWEIGHTED_PINS[which]])


@pytest.mark.parametrize("which", ["init_random", "init_kmeans_pp"])
def test_zero_weight_points_never_seed(which):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(400, 3)).astype(np.float32)
    w = np.zeros(400, np.float32)
    pos = rng.choice(400, 12, replace=False)
    w[pos] = rng.uniform(0.1, 2.0, size=12)
    fn = getattr(tinit, which)
    for seed in range(20):
        got = fn(torch.Generator().manual_seed(seed), _t(x), 10, _t(w))
        rows = [int(np.where((x == r).all(1))[0][0]) for r in got.numpy()]
        assert set(rows) <= set(pos.tolist())
        assert len(set(rows)) == 10


@pytest.mark.parametrize("which", ["init_random", "init_kmeans_pp"])
def test_first_weighted_draw_follows_the_weights(which):
    # One center from three points with weights 1 : 2 : 7 over 3000 seeds:
    # each frequency within 0.03 of its share (about 4 standard errors).
    x = np.array([[0.0], [1.0], [2.0]], np.float32)
    w = np.array([1.0, 2.0, 7.0], np.float32)
    fn = getattr(tinit, which)
    picks = [int(fn(torch.Generator().manual_seed(s), _t(x), 1, _t(w))[0, 0])
             for s in range(3000)]
    freq = np.bincount(picks, minlength=3) / len(picks)
    np.testing.assert_allclose(freq, w / w.sum(), atol=0.03)


def test_fewer_than_k_positive_weights_raise():
    x, _, _ = _blobs(7, n=200)
    w = np.zeros(200, np.float32)
    w[:5] = 1.0
    with pytest.raises(ValueError, match="positive"):
        tkm.kmeans_fit(x, 8, sample_weight=w, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tinit.init_random(torch.Generator(), _t(x), 8, _t(w))


@pytest.mark.parametrize("bad", ["shape", "nan", "inf", "negative",
                                 "too_few"])
def test_validate_sample_weight_error_contract(bad):
    n, k = 50, 4
    w = np.ones(n, np.float32)
    if bad == "shape":
        w = np.ones((n, 1), np.float32)
    elif bad == "nan":
        w[3] = np.nan
    elif bad == "inf":
        w[3] = np.inf
    elif bad == "negative":
        w[3] = -1.0
    else:
        w[k - 1:] = 0.0
    with pytest.raises(ValueError) as want:
        jcommon.validate_sample_weight(w, n, k)
    with pytest.raises(ValueError) as got:
        tcommon.validate_sample_weight(w, n, k, torch.device("cpu"))
    assert str(got.value) == str(want.value)


def test_validate_sample_weight_returns_f32_on_the_device():
    w = tcommon.validate_sample_weight(torch.arange(1, 6, dtype=torch.float64),
                                       5, 3, torch.device("cpu"))
    assert w.dtype == torch.float32 and w.shape == (5,)
    np.testing.assert_array_equal(w.numpy(), [1, 2, 3, 4, 5])


def test_weighted_rejections():
    x, init, w = _blobs(8, n=300)
    with pytest.raises(ValueError, match="refined"):
        tkm.kmeans_fit(x, 8, init=init, sample_weight=w, kernel="refined",
                       device="cpu")
    with pytest.raises(ValueError, match="pallas"):
        tfz.fuzzy_cmeans_fit(x, 8, init=init, sample_weight=w,
                             kernel="pallas", device="cpu")
    for fit, words in ((tkm.kmeans_fit, "single-device"),
                       (tfz.fuzzy_cmeans_fit, "does not support")):
        # The JAX package's refusals of the weighted kernels on a mesh.
        with pytest.raises(ValueError, match=words):
            fit(x, 8, init=init, sample_weight=w, kernel="pallas",
                mesh=tmesh.make_mesh(1), device="cpu")
        # The JAX package's errors: K-Means rejects the weights, Fuzzy
        # C-Means does not know the kernel.
        with pytest.raises(ValueError, match="pallas_bf16"):
            fit(x, 8, init=init, sample_weight=w, kernel="pallas_bf16",
                device="cpu")


def test_weighted_kmeanspp_fit_is_seeded_and_reaches_jax_quality():
    # Stochastic weighted seeding cannot match JAX's draws; the fit from
    # it is reproducible and lands within 1% of the JAX package's weighted
    # SSE from its own k-means++ seeding on well-separated blobs.
    x, _, w = _blobs(9)
    fits = [tkm.kmeans_fit(x, 8, sample_weight=w, max_iters=30,
                           device="cpu",
                           generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(fits[0].centroids, fits[1].centroids)
    j = jkm.kmeans_fit(x, 8, sample_weight=w, max_iters=30,
                       key=jax.random.PRNGKey(3))
    assert float(fits[0].sse) <= 1.01 * float(j.sse)
