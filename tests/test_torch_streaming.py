"""The port's streamed fits (`models/streaming.py`, `streamed_gmm_fit`),
their reduces (`parallel/reduce.py`), batching (`data/batching.py`,
`data/loader.NpzStream`) and the CLI's streamed and OOM-adaptive paths,
against the JAX package on the CPU.

The same seeded numpy batches and the same explicit inits go through the
JAX function (its Pallas kernels in interpret mode where it reaches one)
and the port's (the kernels' plain versions). Tolerances (f32, another
summation order): fits equal in n_iter and converged, centroids (means)
within rtol 1e-5 / atol 1e-5, SSE, J_m and the mean log-likelihood rtol
1e-5, the history's costs as the cost and its shifts within 2·√d times
the centroid bound; per-batch stats: counts equal, sums rtol 1e-5 / atol
1e-4, SSE rtol 1e-5; comms counts equal. Ranks: groups of 2 and 4 on
gloo (file:// stores under the test's tmp directory), each rank streaming
the same batches and staging its np.array_split slice of each, padded;
the JAX side on the conftest's 8 virtual devices with a mesh of the same
size, which pads each batch at its end instead, so the pad rows sit on
other ranks but number the same.
"""

import csv
import multiprocessing as mp
import queue as queue_lib
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from tdc_tpu_torch.cli import main as tcli
from tdc_tpu_torch.data import batching as tbat
from tdc_tpu_torch.data import ingest as ting
from tdc_tpu_torch.data import loader as tload
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.models import streaming as tst
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh
from tdc_tpu_torch.parallel import reduce as tred
from tdc_tpu_torch.parallel import sharded_k as tsk

RTOL = 1e-5
N, K, D = 1003, 6, 5
ROWS = 130  # 8 batches, the last one 93 rows: a ragged last batch
MESH_ROWS = 149  # 6 batches of 149 and one of 109: no world divides them
GMM_ROWS = 250  # 4 batches of 250 and one of 3: the seeding batch is 250


def _blobs(seed=0, n=N, k=K, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    init = x[rng.choice(n, k, replace=False)].copy()
    return x, init


def _gmm_blobs(seed=0, n=N, k=K, d=D):
    """tests/test_torch_gmm.py's overlapping blobs of unequal scales (EM
    keeps gaining for a dozen steps), at this file's N: the GMM parity
    data of the in-memory tests. The GMM cases stream GMM_ROWS-row
    batches: seeded on 130 rows, two components start from 4 and 6
    points, and eight EM steps from there carry the kernel route's f32
    differences (B9's plain version sums in f64, the JAX interpret-mode
    kernel in f32 over padded blocks) to 1.08e-5 of the log-likelihood."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, size=(k, d))
    scales = rng.uniform(0.5, 1.5, size=(k, 1))
    y = rng.integers(0, k, size=n)
    x = (centers[y] + scales[y] * rng.normal(size=(n, d))).astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)].copy()


def _weights(n=N, seed=1):
    w = np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(np.float32)
    w[::7] = 0.0
    return w


def _out(res):
    """numpy view of a K-Means, fuzzy or GMM result of either package."""
    c = res.means if hasattr(res, "means") else res.centroids
    cost = (res.log_likelihood if hasattr(res, "log_likelihood")
            else res.objective if hasattr(res, "objective") else res.sse)
    comms = getattr(res, "comms", None)
    return {"centroids": np.asarray(c), "n_iter": int(res.n_iter),
            "converged": bool(res.converged), "cost": float(cost),
            "history": (None if getattr(res, "history", None) is None
                        else np.asarray(res.history)),
            "variances": (np.asarray(res.variances)
                          if hasattr(res, "variances") else None),
            "weights": (np.asarray(res.weights)
                        if hasattr(res, "weights") else None),
            "comms": None if comms is None else (
                comms.strategy, int(comms.reduces),
                int(comms.logical_bytes), int(comms.passes))}


def _assert_fit(got, want, d=D, cost_atol=0.0):
    assert got["n_iter"] == want["n_iter"]
    assert got["converged"] == want["converged"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=RTOL,
                               atol=cost_atol)
    if want["variances"] is not None:
        # GMM fits: tests/test_torch_gmm.py's fit tolerances (EM carries
        # the f32 rounding differences forward).
        np.testing.assert_allclose(got["centroids"], want["centroids"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["variances"], want["variances"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["weights"], want["weights"],
                                   rtol=0, atol=1e-5)
        return
    np.testing.assert_allclose(got["centroids"], want["centroids"],
                               rtol=RTOL, atol=1e-5)
    if want["history"] is not None:
        assert got["history"].shape == want["history"].shape
        np.testing.assert_allclose(got["history"][:, 0],
                                   want["history"][:, 0], rtol=RTOL,
                                   atol=max(cost_atol, 1e-5))
        c_tol = RTOL * float(np.abs(want["centroids"]).max()) + 1e-5
        np.testing.assert_allclose(got["history"][:, 1],
                                   want["history"][:, 1], rtol=RTOL,
                                   atol=2 * np.sqrt(d) * c_tol)


def _jstream(x, rows):
    from tdc_tpu.data.loader import NpzStream

    return NpzStream(x, rows)


# ---------------------------------------------------------------------------
# One process: the port's streamed fits against the JAX package's
# ---------------------------------------------------------------------------


def test_streamed_equals_fullbatch_and_jax(blobs_small):
    """tests/test_streaming.py:13 on the port: batches of 130 (an uneven
    final batch), the same fit as in memory, and the JAX streamed fit."""
    from tdc_tpu.models import streamed_kmeans_fit as jfit

    x, _, _ = blobs_small
    init = x[:3]
    full = tkm.kmeans_fit(x, 3, init=init, max_iters=40, tol=1e-6,
                          device="cpu")
    st = tst.streamed_kmeans_fit(tload.NpzStream(x, 130), 3, 2, init=init,
                                 max_iters=40, tol=1e-6, device="cpu")
    np.testing.assert_allclose(st.centroids.numpy(), full.centroids.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert st.n_iter == full.n_iter
    np.testing.assert_allclose(float(st.sse), float(full.sse), rtol=1e-4)
    want = jfit(_jstream(x, 130), 3, 2, init=init, max_iters=40, tol=1e-6)
    _assert_fit(_out(st), _out(want), d=2)


CASES = {
    "kmeans_xla": dict(kernel="xla"),
    "kmeans_pallas": dict(kernel="pallas"),
    "kmeans_spherical": dict(kernel="xla", spherical=True),
    "kmeans_weighted_xla": dict(kernel="xla", weighted=True),
    "kmeans_weighted_pallas": dict(kernel="pallas", weighted=True),
    "fuzzy_xla": dict(kernel="xla", fuzzy=True),
    "fuzzy_pallas": dict(kernel="pallas", fuzzy=True),
    "fuzzy_weighted": dict(kernel="xla", fuzzy=True, weighted=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_fits_against_jax(case):
    """K-Means and Fuzzy C-Means, each kernel route, weighted and
    spherical, on 8 batches with a ragged last one."""
    from tdc_tpu.models import streaming as jst

    kw = dict(CASES[case])
    fuzzy, weighted = kw.pop("fuzzy", False), kw.pop("weighted", False)
    x, init = _blobs()
    w = _weights() if weighted else None
    common = dict(init=init, max_iters=30, tol=1e-4, kernel=kw["kernel"])
    if fuzzy:
        common["m"] = 1.7
    else:
        common["spherical"] = kw.get("spherical", False)
    tfit = tst.streamed_fuzzy_fit if fuzzy else tst.streamed_kmeans_fit
    jfit = jst.streamed_fuzzy_fit if fuzzy else jst.streamed_kmeans_fit
    got = tfit(tload.NpzStream(x, ROWS), K, D, device="cpu",
               sample_weight_batches=(None if w is None
                                      else tload.NpzStream(w, ROWS)),
               **common)
    want = jfit(_jstream(x, ROWS), K, D,
                sample_weight_batches=(None if w is None
                                       else _jstream(w, ROWS)), **common)
    assert got.n_iter > 2
    _assert_fit(_out(got), _out(want), cost_atol=RTOL * float((x * x).sum()))
    assert _out(got)["comms"] == ("per_batch", 0, 0, got.n_iter + 1)


@pytest.mark.parametrize("cov,kernel", [("diag", "xla"), ("spherical", "xla"),
                                        ("tied", "xla"), ("full", "xla"),
                                        ("diag", "pallas"),
                                        ("spherical", "pallas")])
def test_streamed_gmm_against_jax(cov, kernel):
    """All four covariance types, B9's plain version on diag and
    spherical, 5 batches with a 3-row last one, from the same means."""
    from tdc_tpu.models.gmm import streamed_gmm_fit as jfit

    x, init = _gmm_blobs()
    kw = dict(init=init, max_iters=8, tol=-1.0, kernel=kernel,
              covariance_type=cov)
    got = tgmm.streamed_gmm_fit(tload.NpzStream(x, GMM_ROWS), K, D,
                                device="cpu", **kw)
    want = jfit(_jstream(x, GMM_ROWS), K, D, **kw)
    _assert_fit(_out(got), _out(want))
    assert _out(got)["comms"] == ("per_batch", 0, 0, 9)
    assert got.n_iter == 8 and not got.converged


def test_streamed_gmm_weighted_and_converged_against_jax():
    from tdc_tpu.models.gmm import streamed_gmm_fit as jfit

    x, init = _gmm_blobs()
    w = _weights()
    for kw in (dict(tol=-1.0, max_iters=6,
                    sample_weight_batches="w"),
               dict(tol=1e-3, max_iters=60)):
        weighted = kw.pop("sample_weight_batches", None) is not None
        got = tgmm.streamed_gmm_fit(
            tload.NpzStream(x, GMM_ROWS), K, D, init=init, device="cpu",
            sample_weight_batches=(tload.NpzStream(w, GMM_ROWS) if weighted
                                   else None), **kw)
        want = jfit(_jstream(x, GMM_ROWS), K, D, init=init,
                    sample_weight_batches=(_jstream(w, GMM_ROWS) if weighted
                                           else None), **kw)
        _assert_fit(_out(got), _out(want))
    assert got.converged and got.n_iter < 60


def test_streamed_gmm_named_init_seeds_on_the_first_batch():
    """A named init is resolved against the first batch: first_k takes its
    first K rows, as the JAX version's does."""
    from tdc_tpu.models.gmm import streamed_gmm_fit as jfit

    x, _ = _gmm_blobs()
    got = tgmm.streamed_gmm_fit(tload.NpzStream(x, GMM_ROWS), K, D,
                                init="first_k", max_iters=4, tol=-1.0,
                                device="cpu")
    want = jfit(_jstream(x, GMM_ROWS), K, D, init="first_k", max_iters=4,
                tol=-1.0)
    _assert_fit(_out(got), _out(want))


def _pass_stats(fns, xb, wb, params, n_pad, dtype=torch.float32):
    """One batch's stats as a streamed fit's pass makes them from its
    (local, correct) pair: local, then the n_pad zero rows subtracted."""
    local, correct = fns
    s = local(xb, wb, params)
    return correct(s, n_pad, params, dtype) if n_pad else s


def test_per_batch_accumulate_against_jax():
    """One batch's corrected stats as the fits' passes make them
    (`_lloyd_pass_fns`, `_fuzzy_pass_fns`, `_gmm_pass_fns`) against the JAX
    `_accumulate`, `_accumulate_fuzzy` and `_accumulate_gmm` on a
    zero-padded batch. The port's fuzzy kernel
    route is held to the JAX package's plain route: the JAX interpret-mode
    B6 pads this 100-row batch to its 128-row block and subtracts that
    padding too, which leaves 3.4e-4 of Σμ in cluster 4 here (the port's
    kernel masks rows and lands within 2e-7 of the f64 sums)."""
    import jax.numpy as jnp

    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.models import streaming as jst
    from tdc_tpu.ops.assign import FuzzyStats, SufficientStats

    x, init = _blobs()
    xb = np.concatenate([x[:97], np.zeros((3, D), np.float32)])
    c = torch.from_numpy(init)
    for kern in ("xla", "pallas"):
        zero = SufficientStats(jnp.zeros((K, D)), jnp.zeros(K), jnp.zeros(()))
        want = jst._accumulate(zero, jnp.asarray(xb), jnp.asarray(init),
                               jnp.asarray(97), False, kern)
        got = _pass_stats(tst._lloyd_pass_fns(
            False, tst._LloydRoute(K, D, kern, "test"), kern),
            torch.from_numpy(xb), None, c, 3)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
        np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                                   rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(float(got.sse), float(want.sse),
                                   rtol=RTOL)
        zero = FuzzyStats(jnp.zeros((K, D)), jnp.zeros(K), jnp.zeros(()))
        want = jst._accumulate_fuzzy(zero, jnp.asarray(xb),
                                     jnp.asarray(init), jnp.asarray(97),
                                     2.0, "xla")
        got = _pass_stats(tst._fuzzy_pass_fns(
            tst._FuzzyRoute(K, D, 2.0, kern, "test"), 2.0, kern),
            torch.from_numpy(xb), None, c, 3)
        for u, v in zip(got, want):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=RTOL,
                                       atol=1e-4)
    var = np.full((K, D), 1.5, np.float32)
    wts = np.full(K, 1.0 / K, np.float32)
    for cov, v in (("diag", var), ("full", np.stack([np.eye(D) * 1.5] * K)
                                   .astype(np.float32))):
        jacc = jgmm.GMMStats(jnp.zeros(()), jnp.zeros(K), jnp.zeros((K, D)),
                             jnp.zeros(jgmm._gmm_sxx_shape(K, D, cov)))
        want = jgmm._accumulate_gmm(jacc, jnp.asarray(xb), jnp.asarray(init),
                                    jnp.asarray(v), jnp.asarray(wts),
                                    jnp.asarray(97), "xla", cov)
        got = _pass_stats(tgmm._gmm_pass_fns("xla", cov),
                          torch.from_numpy(xb), None,
                          (c, torch.from_numpy(v), torch.from_numpy(wts)), 3)
        for u, v2 in zip(got, want):
            np.testing.assert_allclose(u.numpy(), np.asarray(v2), rtol=RTOL,
                                       atol=1e-4)


def test_weighted_per_batch_accumulate_against_jax():
    """One weighted batch (pad rows of zero weight) as the fits' passes
    stage it: Lloyd on both routes (B4's plain version on 'pallas'), fuzzy
    and GMM, against the JAX `_accumulate_weighted`,
    `_accumulate_fuzzy_weighted` and `_accumulate_gmm_weighted`."""
    import jax.numpy as jnp

    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.models import streaming as jst
    from tdc_tpu.ops.assign import FuzzyStats, SufficientStats

    x, init = _blobs()
    xb = np.concatenate([x[:97], np.zeros((3, D), np.float32)])
    w = np.concatenate([_weights()[:97], np.zeros(3, np.float32)])
    tx, tw, c = torch.from_numpy(xb), torch.from_numpy(w), \
        torch.from_numpy(init)
    jx, jw, jc = jnp.asarray(xb), jnp.asarray(w), jnp.asarray(init)
    for kern in ("xla", "pallas"):
        zero = SufficientStats(jnp.zeros((K, D)), jnp.zeros(K), jnp.zeros(()))
        want = jst._accumulate_weighted(zero, jx, jw, jc, False, kern)
        got = _pass_stats(tst._lloyd_pass_fns(
            False, tst._LloydRoute(K, D, kern, "test"), kern), tx, tw, c, 0)
        np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                                   rtol=RTOL, atol=1e-4)
        for u, v in zip(got[1:], want[1:]):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=RTOL)
    zero = FuzzyStats(jnp.zeros((K, D)), jnp.zeros(K), jnp.zeros(()))
    want = jst._accumulate_fuzzy_weighted(zero, jx, jw, jc, 1.7)
    got = _pass_stats(tst._fuzzy_pass_fns(
        tst._FuzzyRoute(K, D, 1.7, "xla", "test"), 1.7, "xla"), tx, tw, c, 0)
    for u, v in zip(got, want):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=RTOL,
                                   atol=1e-4)
    wts = np.full(K, 1.0 / K, np.float32)
    jacc = jgmm.GMMStats(jnp.zeros(()), jnp.zeros(K), jnp.zeros((K, D)),
                         jnp.zeros((D, D)))
    want = jgmm._accumulate_gmm_weighted(jacc, jx, jw, jc,
                                         jnp.asarray(np.eye(D) * 1.5,
                                                     jnp.float32),
                                         jnp.asarray(wts), "tied")
    got = _pass_stats(tgmm._gmm_pass_fns("xla", "tied"), tx, tw,
                      (c, torch.from_numpy((np.eye(D) * 1.5)
                                           .astype(np.float32)),
                       torch.from_numpy(wts)), 0)
    for u, v in zip(got, want):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=RTOL,
                                   atol=1e-4)


def test_padding_correction_tie_rule_against_jax():
    """Zero rows go to the argmin-‖c‖² cluster, the smallest index on a
    tie (clusters 1 and 3 share the least norm)."""
    from tdc_tpu.parallel.sharded_k import padding_correction as jpc

    c = np.array([[3.0, 0.0], [0.0, 1.0], [2.0, 2.0], [1.0, 0.0]],
                 np.float32)
    counts = np.array([4.0, 7.0, 1.0, 2.0], np.float32)
    got = tsk.padding_correction(torch.from_numpy(counts),
                                 torch.tensor(10.0), torch.from_numpy(c), 2)
    import jax.numpy as jnp

    want = jpc(jnp.asarray(counts), jnp.float32(10.0), jnp.asarray(c), 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), [4.0, 5.0, 1.0, 2.0])
    assert float(got[1]) == float(want[1]) == 8.0


def test_mean_combine_matches_manual_reference_semantics_and_jax(
        blobs_small):
    """tests/test_streaming.py:256 on the port, and against JAX's."""
    from tdc_tpu.models import mean_combine_fit as jfit

    x, _, _ = blobs_small
    init = x[:3]
    res = tst.mean_combine_fit(tload.NpzStream(x, 400), 3, 2, init=init,
                               max_iters=10, tol=-1.0, device="cpu")
    manual = np.mean([tkm.kmeans_fit(x[s:s + 400], 3, init=init,
                                     max_iters=10, tol=-1.0,
                                     device="cpu").centroids.numpy()
                      for s in range(0, len(x), 400)], axis=0)
    np.testing.assert_allclose(res.centroids.numpy(), manual, rtol=1e-5,
                               atol=1e-5)
    assert res.n_iter == 10
    exact = tst.streamed_kmeans_fit(tload.NpzStream(x, 400), 3, 2,
                                    init=init, max_iters=10, tol=-1.0,
                                    device="cpu")
    assert float(res.sse) >= float(exact.sse) - 1e-3
    for kern in ("xla", "pallas"):
        got = tst.mean_combine_fit(tload.NpzStream(x, 400), 3, 2, init=init,
                                   max_iters=10, tol=1e-4, kernel=kern,
                                   device="cpu")
        want = jfit(_jstream(x, 400), 3, 2, init=init, max_iters=10,
                    tol=1e-4, kernel=kern)
        _assert_fit(_out(got), _out(want), d=2)


def test_streaming_fold_against_jax(blobs_small):
    """tests/test_streaming.py:662-731: the lifetime average, decay,
    the padding correction and weights, against the JAX fold."""
    import jax.numpy as jnp

    from tdc_tpu.models.streaming import streaming_fold as jfold

    x, _, _ = blobs_small
    c0 = x[:3]
    z = np.zeros(3, np.float32)
    rows = x[:100]
    padded = np.concatenate([rows, np.zeros((28, 2), np.float32)])
    w = np.ones(200, np.float32)
    w[:50] = 2.0
    for args, kw in (
            ((c0, z, x[:256]), {}),
            ((c0, np.full(3, 1e6, np.float32), x[:256]), {"decay": 0.0}),
            ((c0, np.full(3, 50.0, np.float32), x[:256]), {"decay": 0.5}),
            ((c0, z, padded, 100), {}),
            ((c0, z, x[:200], None, w), {})):
        got = tst.streaming_fold(*[None if a is None else torch.as_tensor(a)
                                   for a in args], **kw)
        want = jfold(*[None if a is None else jnp.asarray(a)
                       for a in args], **kw)
        for u, v in zip(got, want):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-5,
                                       atol=1e-5)
    # The padded fold equals the unpadded one, counts exactly.
    a = tst.streaming_fold(torch.from_numpy(c0), torch.from_numpy(z),
                           torch.from_numpy(rows))
    b = tst.streaming_fold(torch.from_numpy(c0), torch.from_numpy(z),
                           torch.from_numpy(padded), 100)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_named_init_does_not_keep_the_first_batch():
    """first_k's centroids are rows of the first batch: the fit copies
    them, so no view keeps that whole batch alive on the device."""
    x, _ = _blobs()
    for fit in (tst.streamed_kmeans_fit, tst.streamed_fuzzy_fit):
        res = fit(tload.NpzStream(x, ROWS), K, D, init="first_k",
                  max_iters=0, device="cpu")
        np.testing.assert_array_equal(res.centroids.numpy(), x[:K])
        assert res.centroids.untyped_storage().nbytes() == K * D * 4
    res = tgmm.streamed_gmm_fit(tload.NpzStream(x, ROWS), K, D,
                                init="first_k", max_iters=0, device="cpu")
    assert res.means.untyped_storage().nbytes() == K * D * 4


def test_prefetch_matches_no_prefetch_and_streams_tensors():
    """prefetch=2 gives the prefetch=0 fit bitwise; a stream of CPU
    tensors and of a '|V2' bf16 array fits like its numpy twin."""
    x, init = _blobs()
    a = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                max_iters=6, tol=-1.0, device="cpu")
    b = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                max_iters=6, tol=-1.0, prefetch=2,
                                device="cpu")
    c = tst.streamed_kmeans_fit(tload.NpzStream(torch.from_numpy(x), ROWS),
                                K, D, init=init, max_iters=6, tol=-1.0,
                                device="cpu")
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.centroids, c.centroids)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    v2 = xb.view(torch.int16).numpy().view(np.dtype("V2"))
    d = tst.streamed_kmeans_fit(tload.NpzStream(v2, ROWS), K, D, init=init,
                                max_iters=6, tol=-1.0, kernel="pallas",
                                device="cpu")
    e = tst.streamed_kmeans_fit(tload.NpzStream(xb, ROWS), K, D, init=init,
                                max_iters=6, tol=-1.0, kernel="pallas",
                                device="cpu")
    assert torch.equal(d.centroids, e.centroids)


# ---------------------------------------------------------------------------
# _prefetched (tests/test_streaming.py:85-229)
# ---------------------------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "tdc-prefetch" and t.is_alive()]


def test_prefetched_order_errors_and_close():
    items = [np.full((2, 2), i) for i in range(7)]
    got = list(tst._prefetched(iter(items), depth=3))
    assert [int(g[0, 0]) for g in got] == list(range(7))

    def boom():
        yield items[0]
        raise RuntimeError("io died")

    it = tst._prefetched(boom(), depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="io died"):
        next(it)

    def dead():
        raise OSError("mount gone")
        yield  # pragma: no cover - makes this a generator

    t0 = time.monotonic()
    with pytest.raises(OSError, match="mount gone"):
        next(tst._prefetched(dead(), depth=2))
    assert time.monotonic() - t0 < 10.0

    def dies_after_filling():
        yield from items[:3]
        raise RuntimeError("read 3 failed")

    it = tst._prefetched(dies_after_filling(), depth=2)
    time.sleep(0.2)
    seen = []
    with pytest.raises(RuntimeError, match="read 3 failed"):
        for b in it:
            seen.append(int(b[0, 0]))
    assert seen == [0, 1, 2]


def test_prefetched_close_and_break_join_the_producer():
    import gc
    import itertools

    baseline = len(_prefetch_threads())
    produced = []

    def tracked():
        for i in itertools.count():
            produced.append(i)
            yield np.full((2, 2), i)

    gen = tst._prefetched(tracked(), depth=2)
    assert int(next(gen)[0, 0]) == 0
    gen.close()  # joins the producer
    assert len(_prefetch_threads()) <= baseline
    # depth queued + one in hand + the consumed one, plus at most one
    # more pulled before the stop flag is seen.
    assert len(produced) <= 2 + 2 + 1
    for i, _ in enumerate(tst._prefetched(iter(range(64)), depth=2)):
        if i == 3:
            break
    gc.collect()
    deadline = time.monotonic() + 5.0
    while len(_prefetch_threads()) > baseline:
        assert time.monotonic() < deadline
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# Batching and the OOM-adaptive retry
# ---------------------------------------------------------------------------


def _oom(msg="CUDA out of memory. Tried to allocate 2.00 GiB"):
    return torch.cuda.OutOfMemoryError(msg)


def test_oom_adaptive_doubles_and_gives_up():
    seen = []

    def run(nb):
        seen.append(nb)
        if nb < 8:
            raise _oom()
        return "fit"

    assert tbat.oom_adaptive(run, initial_num_batches=1) == ("fit", 8)
    assert seen == [1, 2, 4, 8]
    seen.clear()

    def never(nb):
        seen.append(nb)
        raise _oom()

    with pytest.raises(MemoryError, match=r"still RESOURCE_EXHAUSTED after "
                                          r"3 doublings \(num_batches=48\)"):
        tbat.oom_adaptive(never, initial_num_batches=3, max_doublings=3)
    assert seen == [3, 6, 12, 24]


def test_oom_adaptive_lets_other_errors_through():
    """A failed kernel build or launch is not an OOM: it propagates on
    the first attempt, never retried on smaller batches, even when its
    message reads like one."""
    calls = []

    def run(nb):
        calls.append(nb)
        raise RuntimeError("tdc_lloyd_stats_fused: CUDA error 2 (out of "
                           "memory) at launch")

    with pytest.raises(RuntimeError, match="at launch"):
        tbat.oom_adaptive(run)
    assert calls == [1]
    assert tbat.is_oom_error(_oom())
    assert not tbat.is_oom_error(RuntimeError("CUDA out of memory"))
    assert not tbat.is_oom_error(MemoryError("host"))


def test_oom_adaptive_drops_the_failed_attempt_before_retrying():
    """The failed attempt's frames are released before the retry: an
    object its frame held is collected before the next attempt runs."""
    import weakref

    refs = []

    class Big:
        pass

    def run(nb):
        held = Big()
        refs.append(weakref.ref(held))
        if nb == 1:
            raise _oom()
        assert refs[0]() is None
        return nb

    assert tbat.oom_adaptive(run) == (2, 2)


def test_batch_sizing_against_jax():
    """The card's memory, which the CLI sizes generated points against: a
    CPU device has none and raises (the JAX version guesses 16 GiB)."""
    with pytest.raises(ValueError, match="no device memory"):
        tbat.device_hbm_bytes("cpu")


def test_npz_stream_and_batch_iterator_against_jax(tmp_path):
    from tdc_tpu.data import loader as jload

    x, _ = _blobs()
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    s, js = tload.NpzStream.from_npy(path, ROWS), jload.NpzStream.from_npy(
        path, ROWS)
    assert s.num_batches == js.num_batches == 8 and s.n_rows == N
    for _ in range(2):  # re-iterable: each call a fresh pass
        batches = list(s())
        assert len(batches) == 8
        for a, b in zip(batches, js()):
            np.testing.assert_array_equal(a, b)


def test_nonfinite_batch_makes_the_fit_raise():
    x, init = _blobs()
    bad = x.copy()
    bad[500, 2] = np.nan
    # The K-Means and fuzzy fits go through the ingest guard: its strict
    # default policy quarantines the batch and aborts (the JAX words);
    # the GMM fit is not guarded and names the batch.
    for fit, words in ((tst.streamed_kmeans_fit, "strict max_bad_fraction"),
                       (tst.streamed_fuzzy_fit, "strict max_bad_fraction"),
                       (tgmm.streamed_gmm_fit,
                        r"batch 3 failed the ingest screen")):
        with pytest.raises(ting.IngestAbort, match=words):
            fit(tload.NpzStream(bad, ROWS), K, D, init=init, max_iters=3,
                device="cpu")
    # The first batch, through a named init.
    bad = x.copy()
    bad[0, 0] = np.inf
    with pytest.raises(ting.IngestAbort, match="first batch"):
        tst.streamed_kmeans_fit(tload.NpzStream(bad, ROWS), K, D,
                                init="first_k", device="cpu")
    # A batch of the wrong width (quarantined: the strict default aborts),
    # and negative weights (the JAX words).
    with pytest.raises(ting.IngestAbort, match="strict max_bad_fraction"):
        tst.streamed_kmeans_fit(lambda: iter([x[:50, :4]]), K, D, init=init,
                                device="cpu")
    w = _weights()
    w[700] = -1.0
    with pytest.raises(ValueError, match="sample weights must be "
                                         "nonnegative"):
        tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                sample_weight_batches=tload.NpzStream(
                                    w, ROWS), device="cpu")
    assert ting.screen_batch(x, d=D) is None
    assert ting.screen_batch(x, d=4) == "bad_shape:(1003, 5)"
    assert ting.screen_batch(torch.from_numpy(bad)) == "nonfinite"


@pytest.mark.parametrize("call, item", [
    (lambda s: tst.streamed_kmeans_fit(s, K, D, init="first_k",
                                       ckpt_dir="ck", device="cpu"),
     "A7(b)"),
    (lambda s: tst.streamed_fuzzy_fit(s, K, D, init="first_k",
                                      ckpt_every_batches=2, device="cpu"),
     "A7(b)"),
    (lambda s: tgmm.streamed_gmm_fit(s, K, D, init="first_k",
                                     ckpt_dir="ck", device="cpu"), "A7(b)"),
    (lambda s: tst.streamed_kmeans_fit(s, K, D, init="first_k",
                                       residency="hbm", device="cpu"),
     "A7(c)"),
    (lambda s: tst.streamed_fuzzy_fit(s, K, D, init="first_k",
                                      residency="spill", device="cpu"),
     "A7(c)"),
    (lambda s: tst.streamed_kmeans_fit(s, K, D, init="first_k",
                                       ingest={"max_bad_fraction": 0.1},
                                       device="cpu"), "A7(d)"),
    (lambda s: tst.streamed_kmeans_fit(s, K, D, init="first_k",
                                       assign="coarse", device="cpu"),
     "A10"),
    (lambda s: tst.streamed_kmeans_fit(s, K, D, init="first_k",
                                       bounds="elkan", device="cpu"), "A10"),
    (lambda s: tst.streamed_kmeans_fit(s, K, D, init="first_k",
                                       reduce="per_pass:int8",
                                       ckpt_dir="ck", device="cpu"),
     "A7(b)"),
    (lambda s: tgmm.streamed_gmm_fit(s, K, D, init="first_k",
                                     reduce="per_pass:bf16", ckpt_dir="ck",
                                     device="cpu"), "A7(b)"),
    (lambda s: tload.NpzStream(np.zeros((4, 2)), 2, crc_sidecar={}),
     "A7(d)"),
    (lambda s: tst.streamed_fuzzy_fit(s, K, D, init="first_k", ckpt_every=5,
                                      device="cpu"), "A7(b)"),
])
def test_refusals_name_their_queue_item(call, item, tmp_path,
                                        monkeypatch):
    x, _ = _blobs()
    if item == "A7(d)":
        # The data plane is ported: the guarded fit runs and equals the
        # JAX package's (tolerances of the module docstring), and a
        # sidecar for another batch size is refused in the JAX package's
        # words (tests/test_torch_ingest.py holds the rest).
        from tdc_tpu.data import loader as jload
        from tdc_tpu.models import streaming as jst

        try:
            got = call(tload.NpzStream(x, ROWS))
        except ValueError as e:
            with pytest.raises(ValueError) as want:
                jload.NpzStream(np.zeros((4, 2)), 2, crc_sidecar={})
            assert str(e) == str(want.value)
            return
        want = jst.streamed_kmeans_fit(_jstream(x, ROWS), K, D,
                                       init="first_k",
                                       ingest={"max_bad_fraction": 0.1})
        _assert_fit(_out(got), _out(want))
        assert got.ingest == want.ingest
        return
    if item == "A7(c)":
        # Residency is ported: these calls run (tests/test_torch_resident.py
        # and tests/test_torch_spill.py hold them to the streamed fit).
        res = call(tload.NpzStream(x, ROWS))
        assert np.isfinite(res.centroids.numpy()).all() and res.n_iter >= 1
        return
    if item == "A7(b)":
        # Checkpoint/resume is ported: these calls run (their relative
        # "ck" directory in the test's tmp directory), or a quantized
        # reduce on one rank raises the JAX package's ValueError, which
        # comes before its refusal of ckpt_dir.
        monkeypatch.chdir(tmp_path)
        try:
            call(tload.NpzStream(x, ROWS))
        except ValueError as e:
            assert "requires a multi-device mesh" in str(e)
        return
    with pytest.raises(NotImplementedError, match=item.replace(
            "(", r"\(").replace(")", r"\)")):
        call(tload.NpzStream(x, ROWS))


def test_streamed_kmeans_parallel_init_follows_jax(monkeypatch):
    # This raised NotImplementedError (naming A8) before k-means‖ was
    # ported. Now: seeded on the first batch with JAX's draws, the
    # streamed fit is the JAX package's.
    import jax

    from test_torch_kmeans_parallel import JaxDraws, inject

    from tdc_tpu.models import streaming as jst

    x, _ = _blobs()
    key = jax.random.PRNGKey(8)
    inject(monkeypatch, JaxDraws(key, ROWS, K))
    want = jst.streamed_kmeans_fit(_jstream(x, ROWS), K, D, init="kmeans||",
                                   key=key, max_iters=12, tol=1e-4)
    got = tst.streamed_kmeans_fit(tload.NpzStream(x, ROWS), K, D,
                                  init="kmeans||", max_iters=12, tol=1e-4,
                                  device="cpu")
    _assert_fit(_out(got), _out(want))


def test_kernel_refusals_in_the_jax_words():
    x, init = _blobs()
    s, w = tload.NpzStream(x, ROWS), tload.NpzStream(_weights(), ROWS)
    with pytest.raises(ValueError, match="does not support "
                                         "sample_weight_batches"):
        tst.streamed_kmeans_fit(s, K, D, init=init, kernel="pallas_bf16",
                                sample_weight_batches=w, device="cpu")
    with pytest.raises(ValueError, match="does not support "
                                         "sample_weight_batches"):
        tst.streamed_fuzzy_fit(s, K, D, init=init, kernel="pallas",
                               sample_weight_batches=w, device="cpu")
    with pytest.raises(ValueError, match="unweighted streams only"):
        tgmm.streamed_gmm_fit(s, K, D, init=init, kernel="pallas",
                              sample_weight_batches=w, device="cpu")
    with pytest.raises(ValueError, match="'diag'/'spherical' only"):
        tgmm.streamed_gmm_fit(s, K, D, init=init, kernel="pallas",
                              covariance_type="full", device="cpu")
    with pytest.raises(ValueError, match="residency="):
        tst.streamed_kmeans_fit(s, K, D, init=init, residency="ram",
                                device="cpu")
    with pytest.raises(ValueError, match="reduce mode"):
        tst.streamed_kmeans_fit(s, K, D, init=init, reduce="per_step",
                                device="cpu")
    with pytest.raises(ValueError, match="weighted fit has no mass"):
        tst.streamed_kmeans_fit(s, K, D, init=init, device="cpu",
                                sample_weight_batches=tload.NpzStream(
                                    np.zeros(N, np.float32), ROWS))


def test_reduce_strategy_and_cost_against_jax():
    import jax
    import jax.numpy as jnp

    from tdc_tpu.parallel import reduce as jred

    for name in ("per_batch", "per_pass", "per_pass:bf16"):
        a, b = tred.resolve_reduce(name), jred.resolve_reduce(name)
        assert (a.mode, a.quantize, a.deferred, a.label()) == (
            b.mode, b.quantize, b.deferred, b.label())
    with pytest.raises(ValueError, match="requires mode='per_pass'"):
        tred.ReduceStrategy("per_batch", "int8")
    shapes = tst._lloyd_shapes(K, D)
    jtree = tuple(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)
    assert tred.tree_reduce_cost(shapes, ("data",)) == \
        jred.tree_reduce_cost(jtree, ("data",))
    counter = tred.CommsCounter()
    counter.add(3, 120)
    counter.add(1, 8, axis="model", gathers=1)
    assert counter.snapshot() == {"reduces": 4, "gathers": 1,
                                  "logical_bytes": 128, "data_bytes": 120,
                                  "model_bytes": 8}
    rep = tred.CommsReport("per_batch", 8, 800, 4)
    assert rep.reduces_per_pass == 2.0


# ---------------------------------------------------------------------------
# The CLI: streamed rows against the JAX CLI's, and the OOM retry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def npy(tmp_path_factory):
    rng = np.random.default_rng(0)
    centers = rng.uniform(-3, 3, size=(40, 20))
    y = rng.integers(0, 40, size=3000)
    x = (centers[y] + rng.normal(size=(3000, 20))).astype(np.float32)
    path = tmp_path_factory.mktemp("stream_cli") / "data.npy"
    np.save(path, x)
    return str(path)


@pytest.fixture(scope="module")
def wnpy(npy):
    w = np.random.default_rng(3).uniform(0.0, 2.0, 3000).astype(np.float32)
    w[::11] = 0.0
    path = npy.replace("data.npy", "w.npy")
    np.save(path, w)
    return path


def _row(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


TIMING = {"setup_time", "initialization_time", "computation_time",
          "points_per_sec_per_chip"}
CLI_FLAGS = ["--K=40", "--init=first_k", "--tol=-1", "--n_max_iters=5",
             "--seed=7", "--num_batches=4"]


@pytest.mark.parametrize("flags", [
    ["--method_name=distributedKMeans", "--kernel=pallas"],
    ["--method_name=distributedKMeans", "--kernel=pallas", "WEIGHTS"],
    ["--method_name=distributedKMeans", "--kernel=xla", "--reduce=per_pass",
     "--prefetch=2"],
    ["--method_name=distributedKMeans", "--kernel=pallas",
     "--mean_combine"],
    ["--method_name=distributedFuzzyCMeans", "--kernel=pallas",
     "--fuzzifier=2.0"],
    # K=8 on the 40 blobs: no component of the first-batch seeding holds
    # one point (a singleton's variance sits at reg_covar, where the two
    # packages' E[x²] − μ² cancel differently: ROADMAP.md, "Not faults").
    ["--method_name=gaussianMixture", "--kernel=pallas",
     "--covariance_type=diag", "--K=8"],
], ids=["kmeans", "kmeans_weighted", "kmeans_per_pass", "mean_combine",
        "fuzzy", "gmm"])
def test_cli_streamed_rows_agree(npy, wnpy, tmp_path, flags):
    from tdc_tpu.cli import main as jcli

    jlog, tlog = tmp_path / "jax.csv", tmp_path / "port.csv"
    flags = [f"--weight_file={wnpy}" if f == "WEIGHTS" else f for f in flags]
    args = [*CLI_FLAGS, *flags, f"--data_file={npy}"]
    assert jcli.main([*args, f"--log_file={jlog}", "--n_GPUs=1",
                      "--cache_dir="]) == 0
    assert tcli.main([*args, f"--log_file={tlog}", "--device", "cpu"]) == 0
    j, t = _row(jlog), _row(tlog)
    assert list(j) == list(t)
    assert (t["num_batches"], t["n_iter"], t["status"]) == ("4", "5", "ok")
    np.testing.assert_allclose(float(t["sse"]), float(j["sse"]), rtol=RTOL)
    for col in set(j) - TIMING - {"sse"}:
        assert t[col] == j[col], col


def test_cli_history_file_against_jax(npy, tmp_path):
    from tdc_tpu.cli import main as jcli

    for cli, name, extra in ((jcli, "jax", ["--n_GPUs=1", "--cache_dir="]),
                             (tcli, "port", ["--device", "cpu"])):
        assert cli.main([*CLI_FLAGS, f"--data_file={npy}",
                         f"--history_file={tmp_path / name}.csv",
                         *extra]) == 0
    j = np.loadtxt(tmp_path / "jax.csv", delimiter=",", skiprows=1)
    t = np.loadtxt(tmp_path / "port.csv", delimiter=",", skiprows=1)
    assert t.shape == j.shape == (5, 3)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-4)


def test_cli_oom_retries_streamed_at_twice_the_batches(npy, tmp_path,
                                                       monkeypatch):
    """An out-of-memory in-memory fit finishes streamed: the row says
    num_batches 2 (chosen by doubling), the fit equals a direct streamed
    fit at that count, and a kernel failure is reported, not retried."""
    import tdc_tpu_torch.models as tmodels

    real_fit, real_stream = tmodels.kmeans_fit, tmodels.streamed_kmeans_fit
    seen = {"in_memory": 0, "streamed": []}

    def oom_fit(*a, **kw):
        seen["in_memory"] += 1
        raise _oom()

    def stream_fit(batches, *a, **kw):
        res = real_stream(batches, *a, **kw)
        seen["streamed"].append((batches.batch_rows, res))
        return res

    monkeypatch.setattr(tmodels, "kmeans_fit", oom_fit)
    monkeypatch.setattr(tmodels, "streamed_kmeans_fit", stream_fit)
    log = tmp_path / "oom.csv"
    flags = [f for f in CLI_FLAGS if not f.startswith("--num_batches")]
    assert tcli.main([*flags, f"--data_file={npy}", f"--log_file={log}",
                      "--kernel=pallas", "--device", "cpu"]) == 0
    row = _row(log)
    assert row["num_batches"] == "2" and row["status"] == "ok"
    assert seen["in_memory"] == 1 and len(seen["streamed"]) == 2
    rows, res = seen["streamed"][-1]
    assert rows == 1500
    want = real_stream(tload.NpzStream(np.load(npy), 1500), 40, 20,
                       init="first_k", max_iters=5, tol=-1,
                       kernel="pallas", device="cpu")
    assert torch.equal(res.centroids, want.centroids)
    assert float(row["sse"]) == float(want.sse)

    def broken(*a, **kw):
        raise RuntimeError("tdc_lloyd_stats_fused: CUDA error 700")

    monkeypatch.setattr(tmodels, "kmeans_fit", broken)
    log = tmp_path / "broken.csv"
    assert tcli.main([*flags, f"--data_file={npy}", f"--log_file={log}",
                      "--device", "cpu"]) == 1
    assert _row(log)["status"] == "error:RuntimeError"


@pytest.mark.parametrize("method, fit, streamed", [
    ("distributedKMeans", "kmeans_fit", "streamed_kmeans_fit"),
    ("distributedFuzzyCMeans", "fuzzy_cmeans_fit", "streamed_fuzzy_fit"),
    ("gaussianMixture", "gmm_fit", "streamed_gmm_fit"),
])
def test_cli_oom_retry_drops_the_in_memory_copy(npy, tmp_path, monkeypatch,
                                                method, fit, streamed):
    """An in-memory fit that runs out of memory after the CLI copied the
    --data_file points for it: no reference to that copy is left when the
    streamed retry starts, nor in the computation fit (on the card the
    copy is the whole dataset)."""
    import weakref

    import tdc_tpu_torch.models as tmodels

    real_stream = getattr(tmodels, streamed)
    copies, alive = [], []

    def oom_fit(xx, *a, **kw):
        copies.append(weakref.ref(xx))
        raise _oom()

    def stream_fit(*a, **kw):
        alive.append([ref() is not None for ref in copies])
        return real_stream(*a, **kw)

    monkeypatch.setattr(tmodels, fit, oom_fit)
    monkeypatch.setattr(tmodels, streamed, stream_fit)
    log = tmp_path / "oom.csv"
    flags = [f for f in CLI_FLAGS if not f.startswith(("--num_batches",
                                                       "--K="))]
    assert tcli.main([*flags, f"--method_name={method}", "--K=8",
                      f"--data_file={npy}", f"--log_file={log}",
                      "--device", "cpu"]) == 0
    assert _row(log)["num_batches"] == "2"
    assert alive == [[False], [False]]


@pytest.mark.parametrize("flags", [["--minibatch"],
                                   ["--init=kmeans_parallel"]])
def test_cli_streamed_retired_refusals_agree_with_jax(npy, tmp_path, flags,
                                                      monkeypatch):
    # Both were refused (naming A8b and A8a) before mini-batch and
    # k-means‖ were ported. Now: the same flags over the streamed rows
    # give the JAX CLI's row (--init is first_k in CLI_FLAGS, the last
    # --init wins; k-means‖ seeds on the first batch with JAX's draws:
    # the mini-batch fit's init key, the streamed fit's PRNGKey(--seed)
    # as it is).
    import jax

    from test_torch_kmeans_parallel import JaxDraws, inject

    from tdc_tpu.cli import main as jcli

    key = jax.random.PRNGKey(7)
    if "--minibatch" in flags:
        key = jax.random.split(key)[0]
    inject(monkeypatch, JaxDraws(key, 750, 40))
    jlog, tlog = tmp_path / "jax.csv", tmp_path / "port.csv"
    args = [*CLI_FLAGS, *flags, "--reassignment_ratio=0"
            if "--minibatch" in flags else "--kernel=pallas",
            f"--data_file={npy}"]
    assert jcli.main([*args, f"--log_file={jlog}", "--n_GPUs=1",
                      "--cache_dir="]) == 0
    assert tcli.main([*args, f"--log_file={tlog}", "--device", "cpu"]) == 0
    j, t = _row(jlog), _row(tlog)
    assert list(j) == list(t)
    assert (t["num_batches"], t["n_iter"], t["status"]) == ("4", "5", "ok")
    np.testing.assert_allclose(float(t["sse"]), float(j["sse"]), rtol=RTOL)
    for col in set(j) - TIMING - {"sse"}:
        assert t[col] == j[col], col


@pytest.mark.parametrize("flags, words", [
    (["--num_batches=4", "--reduce=per_pass:bf16",
      "--method_name=distributedFuzzyCMeans", "--shard_k=2"],
     "--reduce=per_pass:bf16|int8 applies to the 1-D streamed fits; "
     "--shard_k supports --reduce=per_batch|per_pass"),
    (["--method_name=distributedFuzzyCMeans", "--shard_k=2",
      "--mean_combine"], "--mean_combine supports distributedKMeans only"),
    (["--mean_combine", "--weight_file=w.npy"],
     "--weight_file is not supported with --minibatch/--mean_combine"),
    (["--num_batches=2", "--kernel=refined"], "in-memory single-shard"),
    (["--num_batches=2", "--layout=features"], "single-batch, single-shard"),
    (["--streamed", "--empty_policy=relocate"], "in-memory only"),
    (["--num_batches=0"], "--num_batches must be >= 1"),
])
def test_cli_streamed_refusals(npy, flags, words, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", f"--data_file={npy}", *flags])
    assert exc.value.code == 2
    assert words in capsys.readouterr().err


def test_cli_reduce_knob_fails_fast_in_memory(npy):
    with pytest.raises(SystemExit, match="applies to the streamed"):
        tcli.main(["--K=4", f"--data_file={npy}", "--reduce=per_pass",
                   "--device", "cpu"])


@pytest.mark.parametrize("flags", [
    [], ["--mean_combine", "--num_batches=2"],
    ["--minibatch", "--num_batches=2"],
    ["--method_name=bisectingKMeans", "--num_batches=2"]])
def test_cli_quantized_reduce_refusals_in_the_jax_words(npy, flags):
    # In memory, mean_combine, mini-batch and bisecting take no reduce
    # strategy: the JAX CLI's words, before any fit.
    with pytest.raises(SystemExit, match="applies to the streamed "
                       "kmeans/fuzzy/gaussianMixture drivers"):
        tcli.main(["--K=4", f"--data_file={npy}", "--reduce=per_pass:int8",
                   *flags, "--device", "cpu"])


# ---------------------------------------------------------------------------
# Ranks: 2 and 4 on gloo, against the JAX mesh
# ---------------------------------------------------------------------------

MESH_CASES = {
    "kmeans_xla_per_batch": dict(kernel="xla"),
    "kmeans_xla_per_pass": dict(kernel="xla", reduce="per_pass"),
    "kmeans_pallas_per_batch": dict(kernel="pallas"),
    "kmeans_pallas_per_pass": dict(kernel="pallas", reduce="per_pass"),
    "kmeans_weighted": dict(kernel="xla", weighted=True),
    "fuzzy_xla_per_batch": dict(kernel="xla", fuzzy=True),
    "fuzzy_pallas_per_pass": dict(kernel="pallas", fuzzy=True,
                                  reduce="per_pass"),
    "gmm_diag_per_batch": dict(kernel="xla", gmm="diag"),
    "gmm_full_per_pass": dict(kernel="xla", gmm="full", reduce="per_pass"),
}


def _case_data(case):
    return _gmm_blobs() if case.startswith("gmm") else _blobs()


def _mesh_fit(case, x, init, w, stream_cls, mesh, **extra):
    """One MESH_CASES fit with either package's functions."""
    kw = dict(MESH_CASES[case])
    fuzzy, gmm = kw.pop("fuzzy", False), kw.pop("gmm", None)
    weighted = kw.pop("weighted", False)
    kw.update(init=init, mesh=mesh, max_iters=12, **extra)
    if weighted:
        kw["sample_weight_batches"] = stream_cls(w, MESH_ROWS)
    if gmm:
        kw.update(covariance_type=gmm, tol=-1.0, max_iters=6)
    else:
        kw["tol"] = 1e-4
    return fuzzy, gmm, kw


def _mesh_job(world):
    out = {}
    x, init = _blobs()
    w = _weights()
    mesh = tmesh.make_mesh(world)
    for case in MESH_CASES:
        xc, ic = _case_data(case)
        fuzzy, gmm, kw = _mesh_fit(case, xc, ic, w, tload.NpzStream, mesh,
                                   device="cpu")
        fit = (tgmm.streamed_gmm_fit if gmm else tst.streamed_fuzzy_fit
               if fuzzy else tst.streamed_kmeans_fit)
        out[case] = _out(fit(tload.NpzStream(xc, MESH_ROWS), K, D, **kw))
    # The pad rows' tie rule: clusters 0 and 1 share the least ‖c‖², so
    # every zero row lands on 0 and is taken off 0 (one iteration, so the
    # update reads the corrected counts).
    tie = init.copy()
    tie[0] = [0.1, 0.0, 0.0, 0.0, 0.0]
    tie[1] = [0.0, 0.1, 0.0, 0.0, 0.0]
    for kern in ("xla", "pallas"):
        out["tie", kern] = _out(tst.streamed_kmeans_fit(
            tload.NpzStream(x, MESH_ROWS), K, D, init=tie, mesh=mesh,
            max_iters=1, tol=-1.0, kernel=kern, device="cpu"))
    # A named init: rank 0 draws (each rank's generator differs).
    gen = torch.Generator().manual_seed(5 + tmh.process_index())
    out["kmeanspp"] = tst.streamed_kmeans_fit(
        tload.NpzStream(x, MESH_ROWS), K, D, init="kmeans++", generator=gen,
        mesh=mesh, max_iters=0, device="cpu").centroids.numpy()
    # A non-finite value in the last rank's slice of batch 2 only: every
    # rank aborts on it.
    bad = x.copy()
    bad[2 * MESH_ROWS + MESH_ROWS - 1, 0] = np.nan
    for reduce in ("per_batch", "per_pass"):
        try:
            tst.streamed_kmeans_fit(tload.NpzStream(bad, MESH_ROWS), K, D,
                                    init=init, mesh=mesh, reduce=reduce,
                                    device="cpu")
            out["bad", reduce] = None
        except ting.IngestAbort as e:
            out["bad", reduce] = str(e)
    # Streams that differ between ranks are refused on every rank.
    try:
        tst.streamed_kmeans_fit(
            tload.NpzStream(x[:N - tmh.process_index()], MESH_ROWS), K, D,
            init=init, mesh=mesh, device="cpu")
        out["differ"] = None
    except ValueError as e:
        out["differ"] = str(e)
    return out


def _rank_main(rank, world, init_method, queue):
    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        queue.put((rank, _mesh_job(world)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        tmh.shutdown()


def _spawn(tmp_path, world, timeout=240):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_path / f'store{world}'}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, out = queue.get(timeout=2)
                results[rank] = out
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    pytest.fail(f"ranks {dead} exited without a result, or "
                                f"{timeout} s passed")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(world):
        if isinstance(results.get(rank), str):
            pytest.fail(f"rank {rank} failed:\n{results[rank]}")
    return [results[r] for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {w: _spawn(tmp_path_factory.mktemp(f"stream_ranks{w}"), w)
            for w in (2, 4)}


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key]["centroids"], first["centroids"])
        for f in ("n_iter", "converged", "cost", "comms"):
            assert r[key][f] == first[f], f
    return first


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_streamed_mesh_fits_against_jax(groups, world, case):
    """Per batch and per pass on 2 and 4 ranks, each rank's slice of
    every batch padded (no world size divides 149 or 109), against the
    JAX mesh: the same fit, and comms counts equal (num_batches reduces
    a pass against one)."""
    from tdc_tpu.data.loader import NpzStream as JStream
    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.models import streaming as jst
    from tdc_tpu.parallel import mesh as jmesh

    x, init = _case_data(case)
    got = _same_on_every_rank(groups[world], case)
    fuzzy, gmm, kw = _mesh_fit(case, x, init, _weights(), JStream,
                               jmesh.make_mesh(world))
    # The kernel route is held to the JAX mesh's plain route, the same
    # function: the JAX interpret-mode kernels pad each device's few dozen
    # rows to their row block and correct that padding too, which moves
    # the SSE by up to 1.4e-4 relative here (the port's kernels mask).
    kw["kernel"] = "xla"
    fit = (jgmm.streamed_gmm_fit if gmm else jst.streamed_fuzzy_fit
           if fuzzy else jst.streamed_kmeans_fit)
    want = _out(fit(JStream(x, MESH_ROWS), K, D, **kw))
    _assert_fit(got, want, cost_atol=RTOL * float((x * x).sum()))
    assert got["comms"] == want["comms"]
    strategy, reduces, nbytes, passes = got["comms"]
    per_pass = 1 if strategy == "per_pass" else 7  # 7 batches a pass
    assert reduces == per_pass * passes
    # The same fit as one rank's (within the f32 bound, not bitwise).
    one = _out((tgmm.streamed_gmm_fit if gmm else tst.streamed_fuzzy_fit
                if fuzzy else tst.streamed_kmeans_fit)(
        tload.NpzStream(x, MESH_ROWS), K, D,
        **_mesh_fit(case, x, init, _weights(), tload.NpzStream, None,
                    device="cpu")[2]))
    _assert_fit(got, one, cost_atol=RTOL * float((x * x).sum()))


@pytest.mark.parametrize("world", [2, 4])
def test_streamed_mesh_padding_ties_refusals_and_init(groups, world):
    x, init = _blobs()
    tie = init.copy()
    tie[0] = [0.1, 0.0, 0.0, 0.0, 0.0]
    tie[1] = [0.0, 0.1, 0.0, 0.0, 0.0]
    for kern in ("xla", "pallas"):
        got = _same_on_every_rank(groups[world], ("tie", kern))
        one = _out(tst.streamed_kmeans_fit(
            tload.NpzStream(x, MESH_ROWS), K, D, init=tie, max_iters=1,
            tol=-1.0, kernel=kern, device="cpu"))
        _assert_fit(got, one)
    first = groups[world][0]["kmeanspp"]
    for r in groups[world][1:]:
        np.testing.assert_array_equal(r["kmeanspp"], first)
    for r in groups[world]:
        # The strict default ingest policy: only the last rank's rows hold
        # the NaN. per_batch: the batch's reduce carries that rank's
        # verdict; per_pass: every rank scans the whole batch on the host.
        # Every rank drops batch 2 and aborts at the pass's end.
        for reduce in ("per_batch", "per_pass"):
            assert "strict max_bad_fraction=0.0" in r["bad", reduce]
    for r in groups[world]:
        assert "every rank streams the same batches" in r["differ"]
