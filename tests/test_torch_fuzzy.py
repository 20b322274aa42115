"""Fuzzy C-Means of the port against the JAX package, on the CPU.

The same seeded numpy inputs go to both packages. The JAX side runs its
own code: `ops.assign` in XLA, and the Pallas `fuzzy_stats_fused` in
interpret mode (automatic off-TPU) with block_n=128, so its zero-row
padding correction runs wherever N is not a multiple of 128. On the port's
side, CPU tensors take the plain PyTorch versions of the kernel B6.

Tolerances (float32, different summation order in the two frameworks):
memberships rtol 1e-5 and atol 1e-7; weighted sums, weights and the
objective rtol 1e-5 with an atol of 1e-5 of the summed magnitude
(Σμ|x| for the sums, the largest weight for the weights); fits equal in
n_iter and converged, centroids rtol 1e-5 and atol 1e-5, objective rtol
1e-5; hard labels equal.
"""

import jax
import numpy as np
import pytest
import torch

from tdc_tpu.models import fuzzy as jfz
from tdc_tpu.ops import assign as jassign
from tdc_tpu.ops import pallas_kernels as jpk
from tdc_tpu.ops import tall as jtall
from tdc_tpu_torch import convert
from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.ops import assign as tassign
from tdc_tpu_torch.ops import fuzzy_kernels as tfk
from tdc_tpu_torch.ops import lloyd_kernels as tlk
from tdc_tpu_torch.parallel import mesh as tmesh

RTOL = 1e-5
MS = [2.0, 1.7]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _case(name):
    """(x, centroids) for one named case, seeded. 'ragged': N = 1000 (not
    a multiple of 128), K and d odd. 'on_centroid': row 5 sits exactly on
    an integer-valued centroid 2, so its d² is exactly 0."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, k, d = {"ragged": (1000, 13, 7), "on_centroid": (700, 9, 5),
               "wide": (900, 16, 8)}[name]
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = (x[rng.choice(n, k, replace=False)]
         + rng.normal(scale=0.3, size=(k, d))).astype(np.float32)
    if name == "on_centroid":
        c[2] = np.round(c[2] * 2)
        x[5] = c[2]
    return x, c


CASES = ["ragged", "on_centroid", "wide"]


def _assert_stats(got, want, x, c, m):
    mu = np.asarray(jassign.fuzzy_memberships(x, c, m=m)) ** m
    abs_sums = mu.T @ np.abs(x)
    np.testing.assert_allclose(got.weighted_sums.numpy(),
                               np.asarray(want.weighted_sums), rtol=RTOL,
                               atol=1e-5 * float(abs_sums.max()))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=RTOL,
                               atol=1e-5 * float(np.max(want.weights)))
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("case", CASES)
def test_fuzzy_memberships(case, m):
    x, c = _case(case)
    got = tassign.fuzzy_memberships(_t(x), _t(c), m=m)
    want = np.asarray(jassign.fuzzy_memberships(x, c, m=m))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got.numpy().sum(1), 1.0, rtol=1e-5)
    if case == "on_centroid":
        assert float(got[5, 2]) > 1.0 - 1e-6


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("case", CASES)
def test_fuzzy_stats(case, m):
    x, c = _case(case)
    _assert_stats(tassign.fuzzy_stats(_t(x), _t(c), m=m),
                  jassign.fuzzy_stats(x, c, m=m), x, c, m)


@pytest.mark.parametrize("block_rows", [128, 300, 1000])
def test_fuzzy_stats_padded_blocked(block_rows):
    x, c = _case("ragged")
    _assert_stats(
        tassign.fuzzy_stats_padded_blocked(_t(x), _t(c), 1.7, block_rows),
        jassign.fuzzy_stats_padded_blocked(x, c, 1.7, block_rows), x, c, 1.7)


def test_fuzzy_stats_blocked_needs_a_block_multiple():
    x, c = _case("ragged")
    with pytest.raises(ValueError):
        tassign.fuzzy_stats_blocked(_t(x), _t(c), 2.0, 128)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["fuzzy_stats_fused_plain",
                                "fuzzy_stats_fused", "fuzzy_stats_auto"])
def test_fuzzy_stats_fused_against_interpret_mode(fn, case, m):
    # N % 128 != 0 in every case: JAX pads and subtracts n_fake zero rows,
    # the port masks. The results must agree all the same.
    x, c = _case(case)
    assert x.shape[0] % 128
    got = getattr(tfk, fn)(_t(x), _t(c), m)
    want = jpk.fuzzy_stats_fused(x, c, m=m, block_n=128)
    _assert_stats(got, want, x, c, m)
    if case == "on_centroid":
        # The row on centroid 2 has full membership there: the stats of
        # that row alone put weight 1 on centroid 2 and 0 elsewhere.
        one = getattr(tfk, fn)(_t(x[5:6]), _t(c), m)
        assert float(one.weights[2]) > 1.0 - 1e-6
        assert float(one.weights.sum() - one.weights[2]) < 1e-6
        np.testing.assert_allclose(one.weighted_sums[2].numpy(), x[5],
                                   rtol=1e-6)


def test_fuzzy_route_takes_every_shape():
    for k, d in [(1, 1), (1024, 128), (16384, 768), (100000, 4096)]:
        assert tfk.fuzzy_stats_for(k, d) is tfk.fuzzy_stats_fused


def test_fuzzy_wrapper_checks_inputs_and_counts_no_plain_launch():
    x, c = _case("ragged")
    before = tfk.fuzzy_stats_fused.launches
    tfk.fuzzy_stats_fused(_t(x), _t(c))
    tfk.fuzzy_stats_auto(_t(x), _t(c))
    assert tfk.fuzzy_stats_fused.launches == before
    with pytest.raises(ValueError, match="m must be > 1"):
        tfk.fuzzy_stats_fused(_t(x), _t(c), 1.0)
    with pytest.raises(TypeError):
        tfk.fuzzy_stats_fused(_t(x).double(), _t(c).double())
    with pytest.raises(ValueError):
        tfk.fuzzy_stats_fused(_t(x), _t(c)[:, :3])


def test_resolve_kernel_fuzzy_auto_by_device():
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cpu",
                              model="fuzzy") == "xla"
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cuda",
                              model="fuzzy") == "pallas"
    # An unknown model: 'xla' off the card, the JAX package's ValueError
    # on it (ROADMAP Queue C5).
    assert tlk.resolve_kernel("auto", k=8, d=4, device="cpu",
                              model="bisecting") == "xla"
    with pytest.raises(ValueError, match="unknown model 'bisecting'"):
        tlk.resolve_kernel("auto", k=8, d=4, device="cuda",
                           model="bisecting")


def _blobs(seed=0, n=1000, k=6, d=5):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(k, d))
    y = rng.integers(0, k, size=n)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    init = x[rng.choice(n, k, replace=False)].copy()
    return x, init


def _fit_both(x, init, **kw):
    j = jfz.fuzzy_cmeans_fit(x, init.shape[0], init=init, **kw)
    t = tfz.fuzzy_cmeans_fit(x, init.shape[0], init=init, device="cpu", **kw)
    return j, t


def _assert_fit(j, t):
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(t.objective), float(j.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("tol", [-1.0, 1e-4])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_fuzzy_cmeans_fit(kernel, tol):
    x, init = _blobs()
    j, t = _fit_both(x, init, m=2.0, max_iters=12, tol=tol, kernel=kernel)
    _assert_fit(j, t)
    if tol < 0:
        assert t.n_iter == 12 and not t.converged
    else:
        assert t.converged and t.n_iter < 12


def test_fuzzy_cmeans_fit_m17_auto():
    x, init = _blobs(1)
    _assert_fit(*_fit_both(x, init, m=1.7, max_iters=10, tol=1e-4,
                           kernel="auto"))


def test_fuzzy_cmeans_fit_history():
    x, init = _blobs(2)
    j, t = _fit_both(x, init, max_iters=10, tol=1e-4, history=True)
    _assert_fit(j, t)
    assert t.history.shape == (t.n_iter, 2)
    np.testing.assert_allclose(t.history, np.asarray(j.history), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_fuzzy_predict_soft_and_hard(kernel):
    x, init = _blobs(3)
    j = jfz.fuzzy_cmeans_fit(x, 6, init=init, max_iters=8)
    c = np.asarray(j.centroids)
    hard = tfz.fuzzy_predict(x, c, kernel=kernel, device="cpu")
    np.testing.assert_array_equal(hard.numpy(),
                                  np.asarray(jfz.fuzzy_predict(x, c)))
    want = np.asarray(jfz.fuzzy_predict(x, c, m=1.7, soft=True))
    for block_rows in (0, 128):
        soft = tfz.fuzzy_predict(x, c, m=1.7, soft=True,
                                 block_rows=block_rows, device="cpu")
        np.testing.assert_allclose(soft.numpy(), want, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(
        tfz.predict_proba(x, c, m=1.7, device="cpu").numpy(), want,
        rtol=RTOL, atol=1e-7)


def test_fit_in_jax_predict_in_port():
    # The JAX package fits with its own k-means++ seeding and the Pallas
    # kernel; the port takes the state over and labels the points as the
    # JAX package does.
    x, _ = _blobs(4, n=900, k=8, d=6)
    j = jfz.fuzzy_cmeans_fit(x, 8, key=jax.random.PRNGKey(5), max_iters=20,
                             kernel="pallas")
    state = convert.fuzzy_state_from_numpy(
        np.asarray(j.centroids), n_iter=int(j.n_iter),
        objective=float(j.objective), shift=float(j.shift),
        converged=bool(j.converged), device="cpu")
    got = tfz.fuzzy_predict(x, state.centroids, kernel="pallas",
                            device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfz.fuzzy_predict(x, j.centroids)))
    back = convert.to_numpy(state)
    np.testing.assert_array_equal(back["centroids"], np.asarray(j.centroids))
    assert back["n_iter"] == int(j.n_iter)
    assert back["objective"] == np.float32(j.objective)
    assert back["converged"] == bool(j.converged)
    assert "sse" not in back


# A mesh of one rank needs no process group.
ONE_RANK = tmesh.make_mesh(1)


@pytest.mark.parametrize("kw", [
    {"mesh": ONE_RANK, "init": "kmeans_parallel"},
    {"sample_weight": True, "mesh": ONE_RANK, "init": "k-means||"},
    {"init": "kmeans_parallel"},
    {"init": "k-means||"},
    {"init": "kmeans||"},
])
def test_fuzzy_kmeans_parallel_init_follows_jax(monkeypatch, kw):
    # These raised NotImplementedError (naming A8) before k-means‖ was
    # ported. Now: seeded with JAX's draws, the fit is the JAX package's
    # (rank 0 draws and broadcasts on the one-rank mesh).
    from test_torch_kmeans_parallel import JaxDraws, inject

    kw = dict(kw)
    x, _ = _blobs(6)
    w = None
    if kw.pop("sample_weight", False):
        w = np.random.default_rng(6).uniform(0, 2, len(x)).astype(
            np.float32)
        w[::9] = 0.0
    k = 6
    key = jax.random.PRNGKey(4)
    inject(monkeypatch, JaxDraws(key, len(x), k, weighted=w is not None))
    j = jfz.fuzzy_cmeans_fit(x, k, init=kw["init"], key=key,
                             sample_weight=w, max_iters=15, tol=1e-4)
    t = tfz.fuzzy_cmeans_fit(x, k, sample_weight=w, max_iters=15, tol=1e-4,
                             device="cpu", **kw)
    assert t.n_iter == int(j.n_iter) and t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(t.objective), float(j.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("case", ["features", "tall_on_samples"])
def test_fuzzy_feature_major_options_follow_jax(case):
    # Both raised NotImplementedError (naming B11) before the features
    # layout was ported. Now the layout fits as the JAX package's does,
    # and kernel='tall' on sample-major points fails in both packages
    # (ValueError in the port, a TypeError in the JAX package). N is the
    # JAX kernel's own column block, so it pads no columns: its padding
    # correction subtracts each fake column's memberships and cancels.
    n = jtall.tall_block_n(5, 6, temps=5)
    rng = np.random.default_rng(3)
    centers = rng.uniform(-4, 4, size=(5, 6))
    x = (centers[rng.integers(0, 5, size=n)]
         + rng.normal(size=(n, 6))).astype(np.float32)
    init = x[:5].copy()
    if case == "tall_on_samples":
        for fit, kw in ((jfz.fuzzy_cmeans_fit, {}),
                        (tfz.fuzzy_cmeans_fit, {"device": "cpu"})):
            with pytest.raises((ValueError, TypeError)):
                fit(x, 5, init=init, max_iters=2, kernel="tall", **kw)
        return
    xt = np.ascontiguousarray(x.T)
    j = jfz.fuzzy_cmeans_fit(xt, 5, init=init, max_iters=6, tol=-1.0,
                             layout="features")
    t = tfz.fuzzy_cmeans_fit(xt, 5, init=init, max_iters=6, tol=-1.0,
                             layout="features", device="cpu")
    assert t.n_iter == int(j.n_iter) == 6
    assert t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=1e-5, atol=1e-5)


def test_fuzzy_fit_rejects_m_at_most_one_and_unknown_kernel():
    x = np.zeros((100, 4), np.float32)
    with pytest.raises(ValueError, match="m must be > 1"):
        tfz.fuzzy_cmeans_fit(x, 3, m=1.0, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        tfz.fuzzy_cmeans_fit(x, 3, kernel="refined", device="cpu",
                             init="first_k")


def test_fuzzy_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfz.fuzzy_cmeans_fit(np.zeros((10, 2), np.float32), 2)


def test_fuzzy_pallas_bf16_raises_the_reference_error():
    # The bf16 epilogue exists for the Lloyd kernel only: Fuzzy C-Means
    # does not know the kernel, in both packages, with the same message.
    x = np.random.default_rng(0).normal(size=(100, 4)).astype(np.float32)
    msgs = []
    for fit, kw in ((jfz.fuzzy_cmeans_fit, {}),
                    (tfz.fuzzy_cmeans_fit, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            fit(x, 3, init="first_k", max_iters=2, kernel="pallas_bf16",
                **kw)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0] == (
        "unknown kernel 'pallas_bf16' (use 'xla' or 'pallas')")
