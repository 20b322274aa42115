"""Gaussian Mixture EM of the port against the JAX package, on the CPU.

The same seeded numpy inputs go to both packages. The JAX side runs its
own code: the XLA E-step, and the Pallas `gmm_stats_fused` in interpret
mode (automatic off-TPU) with block_n=128, so its zero-row padding
correction runs wherever N is not a multiple of 128. On the port's side,
CPU tensors take the plain PyTorch version of the kernel B9.

Tolerances (float32, different summation order in the two frameworks;
the plain version sums in f64, the JAX kernel in f32):
- E-step stats: ll_sum rtol 1e-5; nk rtol 1e-5, atol 1e-4; Σr·x and Σr·x²
  rtol 1e-5, atol 1e-5 of their largest magnitude — tighter than the
  reference's own kernel test (nk 1e-4 / 1e-3, sums 1e-4 / 1e-2, ll 1e-5).
  ll_sum also gets an atol of 2^-23 times Σ_i of the magnitudes that cancel
  in the row's log-probs (½Σx²/σ² + Σ|xμ|/σ² + |bias|, its largest over
  K): the rounding the expanded form carries. It matters only in the
  'tight' case (σ² near 1e-2), where the reference's interpret-mode kernel
  and its own XLA E-step differ beyond rtol 1e-5 and the port lies
  between them.
- log-probs: rtol 1e-5, atol 1e-5 of the largest |logp| (the expanded
  Mahalanobis form cancels to about that).
- fits: equal n_iter and converged; means atol 1e-4, variances and
  covariances rtol 1e-4 and atol 1e-5, weights atol 1e-5, mean
  log-likelihood rtol 1e-5. Twelve EM steps on overlapping blobs carry
  the f32 rounding differences forward, so these sit above the stats'.
- predict: labels equal except at recorded near-ties (two components'
  log-probs within 1e-4); responsibilities atol 1e-5; score_samples rtol
  1e-5; BIC and AIC rtol 1e-6; n_parameters equal.
"""

import functools
import json

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import torch

from tdc_tpu.models import gmm as jgmm
from tdc_tpu.models import kmeans as jkm
from tdc_tpu.ops import pallas_kernels as jpk
from tdc_tpu_torch import convert
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.ops import gmm_kernels as tgk
from tdc_tpu_torch.parallel import mesh as tmesh

COV_TYPES = ["diag", "spherical", "tied", "full"]
MAX_ITERS = 12


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _stats_case(name):
    """(x, means, variances, weights) for one named case, seeded.
    'ragged': N = 1000 (not a multiple of 128), K and d odd. 'tight':
    variances near 1e-2, where −½·x²/σ² + x·μ/σ² cancels hardest."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, k, d = {"ragged": (1000, 7, 5), "wide": (1500, 8, 8),
               "tight": (777, 3, 2)}[name]
    centers = rng.uniform(-4, 4, size=(k, d))
    scale = 0.1 if name == "tight" else 1.0
    y = rng.integers(0, k, size=n)
    x = (centers[y] + scale * rng.normal(size=(n, d))).astype(np.float32)
    means = (centers + scale * rng.normal(scale=0.3, size=(k, d))
             ).astype(np.float32)
    var = (scale ** 2 * rng.uniform(0.5, 2.0, size=(k, d))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    return x, means, var, (w / w.sum()).astype(np.float32)


STATS_CASES = ["ragged", "wide", "tight"]


@functools.lru_cache(maxsize=None)
def _jax_stats(case):
    """(interpret-mode kernel stats, XLA E-step stats) of one case."""
    x, means, var, w = _stats_case(case)
    kern = jpk.gmm_stats_fused(jnp.asarray(x), jnp.asarray(means),
                               jnp.asarray(var), jnp.asarray(w), block_n=128)
    return kern, _jax_xla_estep(x, means, var, w)


def _jax_xla_estep(x, means, var, w):
    logp = jgmm._log_prob(jnp.asarray(x), jnp.asarray(means),
                          jnp.asarray(var), jnp.log(jnp.asarray(w)))
    norm = jsp.logsumexp(logp, axis=1, keepdims=True)
    r = jnp.exp(logp - norm)
    return (jnp.sum(norm), jnp.sum(r, axis=0), r.T @ x, r.T @ (x * x))


def _cancelling_magnitude(x, means, var, w):
    """Σ_i max_k (½Σ_d x²/σ² + Σ_d |x·μ|/σ² + |bias_k|), in f64."""
    x, means, var = (np.asarray(a, np.float64) for a in (x, means, var))
    bias = -0.5 * ((means ** 2 / var).sum(1) + np.log(var).sum(1)
                   + x.shape[1] * np.log(2 * np.pi)) + np.log(w)
    terms = (0.5 * (x ** 2) @ (1 / var).T + np.abs(x) @ np.abs(means / var).T
             + np.abs(bias))
    return float(terms.max(axis=1).sum())


def _assert_stats(got, want, ll_atol):
    ll, nk, sx, sxx = (np.asarray(a) for a in want)
    np.testing.assert_allclose(float(got.ll_sum), float(ll), rtol=1e-5,
                               atol=ll_atol)
    np.testing.assert_allclose(got.nk.numpy(), nk, rtol=1e-5, atol=1e-4)
    for g, v in ((got.sx, sx), (got.sxx, sxx)):
        np.testing.assert_allclose(g.numpy(), v, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(v).max()))


def _stats_fn(name):
    return tgmm.gmm_stats_auto if name == "gmm_stats_auto" else getattr(
        tgk, name)


@pytest.mark.parametrize("case", STATS_CASES)
@pytest.mark.parametrize("fn", ["gmm_stats_fused_plain", "gmm_stats_fused",
                                "gmm_stats_auto"])
def test_gmm_stats_against_interpret_mode_and_xla(fn, case):
    # N % 128 != 0 in every case: JAX pads and subtracts n_fake zero rows
    # (and -1e30 bias columns past K), the port masks. Both must agree.
    x, means, var, w = _stats_case(case)
    assert x.shape[0] % 128
    got = _stats_fn(fn)(_t(x), _t(means), _t(var), _t(w))
    ll_atol = 2.0 ** -23 * _cancelling_magnitude(x, means, var, w)
    for want in _jax_stats(case):
        _assert_stats(got, want, ll_atol)


def test_gmm_stats_wrapper_checks_inputs_and_counts_no_plain_launch():
    x, means, var, w = (_t(a) for a in _stats_case("ragged"))
    before = tgk.gmm_stats_fused.launches
    tgk.gmm_stats_fused(x, means, var, w)
    assert tgk.gmm_stats_fused.launches == before  # CPU: the plain version
    with pytest.raises(ValueError, match="variances"):
        tgk.gmm_stats_fused(x, means, var[:, :3], w)
    with pytest.raises(ValueError, match="weights"):
        tgk.gmm_stats_fused(x, means, var, w[:3])
    with pytest.raises(TypeError):
        tgk.gmm_stats_fused(x, means, var.double(), w)
    with pytest.raises(ValueError):
        tgk.gmm_stats_fused(x, means[:, :3], var[:, :3], w)


def _cov_params(cov_type, k, d, rng):
    if cov_type == "diag":
        return rng.uniform(0.5, 2.0, size=(k, d)).astype(np.float32)
    if cov_type == "spherical":
        return rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    a = rng.normal(scale=0.4, size=(k, d, d))
    full = (a @ a.transpose(0, 2, 1) + np.eye(d)).astype(np.float32)
    return full[0] if cov_type == "tied" else full


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_log_prob_t(cov_type):
    rng = np.random.default_rng(3)
    n, k, d = 500, 5, 4
    x = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
    means = rng.normal(scale=2.0, size=(k, d)).astype(np.float32)
    cov = _cov_params(cov_type, k, d, rng)
    logw = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    want = np.asarray(jgmm._log_prob_t(jnp.asarray(x), jnp.asarray(means),
                                       jnp.asarray(cov), jnp.asarray(logw),
                                       cov_type))
    got = tgmm._log_prob_t(_t(x), _t(means), _t(cov), _t(logw), cov_type)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _blobs(seed=0, n=1500, k=6, d=4):
    """Overlapping blobs with unequal scales: EM keeps gaining for a dozen
    steps, so the fits compare whole trajectories."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, size=(k, d))
    scales = rng.uniform(0.5, 1.5, size=(k, 1))
    y = rng.integers(0, k, size=n)
    x = (centers[y] + scales[y] * rng.normal(size=(n, d))).astype(np.float32)
    init = x[rng.choice(n, k, replace=False)].copy()
    w = rng.uniform(0, 3, size=n).astype(np.float32)
    w[rng.choice(n, 50, replace=False)] = 0.0
    return x, init, w


def _assert_fit(j, t):
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    assert t.covariance_type == j.covariance_type
    np.testing.assert_allclose(t.means.numpy(), np.asarray(j.means),
                               atol=1e-4)
    np.testing.assert_allclose(t.variances.numpy(), np.asarray(j.variances),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               atol=1e-5)
    np.testing.assert_allclose(float(t.log_likelihood),
                               float(j.log_likelihood), rtol=1e-5)


_JAX_FITS = {}


def _jax_fit(x, k, **kw):
    """The JAX fit for these arguments, computed once per module (the
    carried-state tests reuse the fits of the parity tests)."""
    key = tuple(sorted((name, v if np.isscalar(v) or v is None
                        else np.asarray(v).tobytes())
                       for name, v in kw.items()))
    if key not in _JAX_FITS:
        _JAX_FITS[key] = jgmm.gmm_fit(x, k, **kw)
    return _JAX_FITS[key]


# tol 0.02: in every fit below that converges, the first gain under it is
# at least 4e-4 under it and every earlier gain 18% over it, far beyond
# the ~1e-6 f32 noise of the mean log-likelihood, so n_iter is decided the
# same way on both sides.
TOL = 0.02


@pytest.mark.parametrize("tol", [-1.0, TOL])
@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_gmm_fit_xla(cov_type, tol):
    x, init, _ = _blobs()
    kw = dict(init=init, max_iters=MAX_ITERS, tol=tol,
              covariance_type=cov_type)
    j = _jax_fit(x, 6, **kw)
    t = tgmm.gmm_fit(x, 6, device="cpu", **kw)
    _assert_fit(j, t)
    if tol < 0:
        assert t.n_iter == MAX_ITERS and not t.converged
    else:
        assert t.converged and t.n_iter < MAX_ITERS


@pytest.mark.parametrize("tol", [-1.0, TOL])
@pytest.mark.parametrize("cov_type", ["diag", "spherical"])
def test_gmm_fit_pallas(cov_type, tol):
    # The port's kernel route (B9's plain version here) against the JAX
    # package's interpret-mode fused E-step.
    x, init, _ = _blobs(1)
    kw = dict(init=init, max_iters=MAX_ITERS, tol=tol,
              covariance_type=cov_type, kernel="pallas")
    _assert_fit(_jax_fit(x, 6, **kw), tgmm.gmm_fit(x, 6, device="cpu", **kw))


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_gmm_fit_weighted_xla(cov_type):
    x, init, w = _blobs(2)
    kw = dict(init=init, max_iters=MAX_ITERS, tol=TOL,
              covariance_type=cov_type, sample_weight=w)
    _assert_fit(_jax_fit(x, 6, **kw), tgmm.gmm_fit(x, 6, device="cpu", **kw))


def test_gmm_fit_auto_resolves_by_eligibility(capsys):
    x, init, w = _blobs(4, n=300)
    kw = dict(init=init, max_iters=3, tol=-1.0, device="cpu")
    a = tgmm.gmm_fit(x, 6, kernel="auto", **kw)
    b = tgmm.gmm_fit(x, 6, kernel="xla", **kw)
    assert torch.equal(a.means, b.means)
    tgmm.gmm_fit(x, 6, kernel="auto", covariance_type="full", **kw)
    tgmm.gmm_fit(x, 6, kernel="auto", sample_weight=w, **kw)
    events = [json.loads(line) for line in capsys.readouterr().err.splitlines()
              if '"kernel_selected"' in line and '"gmm_fit"' in line]
    assert [e["kernel"] for e in events] == ["xla", "xla", "xla"]
    assert "device=cpu" in events[0]["reason"]
    assert "diag/spherical, unweighted" in events[1]["reason"]
    assert "diag/spherical, unweighted" in events[2]["reason"]


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_gmm_fit_on_a_one_rank_mesh_against_jax(cov_type, capsys):
    # The mesh path (the E-step's sums through the data-axis reduce, the
    # start's moments with the global mean and variance) on a mesh of one
    # rank, against the JAX package's one-device mesh.
    from tdc_tpu.parallel import mesh as jmesh

    x, init, _ = _blobs(6)
    kw = dict(init=init, max_iters=MAX_ITERS, tol=TOL,
              covariance_type=cov_type)
    want = jgmm.gmm_fit(x, 6, mesh=jmesh.make_mesh(1), **kw)
    got = tgmm.gmm_fit(x, 6, mesh=tmesh.make_mesh(1), kernel="auto",
                       device="cpu", **kw)
    _assert_fit(want, got)
    events = [json.loads(line) for line in capsys.readouterr().err.splitlines()
              if '"kernel_selected"' in line and '"gmm_fit"' in line]
    assert [e["kernel"] for e in events] == ["xla"]


def _pinned_kmeanspp(draws):
    """A k-means++ stand-in that returns the given (K, d) draws in turn,
    so both packages' init='kmeans' restarts start from the same seeds."""
    it = iter(draws)
    return lambda *args, **kwargs: next(it)


@pytest.mark.parametrize("weighted", [False, True])
def test_gmm_fit_kmeans_init_with_pinned_draws(monkeypatch, weighted):
    x, _, w = _blobs(5)
    rng = np.random.default_rng(5)
    draws = [x[rng.choice(len(x), 6, replace=False)] for _ in range(3)]
    monkeypatch.setattr(jkm, "init_kmeans_pp", _pinned_kmeanspp(
        [jnp.asarray(dr) for dr in draws]))
    monkeypatch.setattr(tkm, "init_kmeans_pp", _pinned_kmeanspp(
        [_t(dr) for dr in draws]))
    kw = dict(init="kmeans", max_iters=MAX_ITERS, tol=TOL,
              sample_weight=w if weighted else None)
    j = jgmm.gmm_fit(x, 6, key=jax.random.PRNGKey(0), **kw)
    t = tgmm.gmm_fit(x, 6, device="cpu", **kw)
    _assert_fit(j, t)


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_carried_fit_predicts_and_scores_alike(cov_type):
    x, init, _ = _blobs()
    j = _jax_fit(x, 6, init=init, max_iters=MAX_ITERS, tol=-1.0,
                 covariance_type=cov_type)
    t = convert.gmm_state_from_numpy(
        np.asarray(j.means), np.asarray(j.variances), np.asarray(j.weights),
        cov_type, n_iter=int(j.n_iter),
        log_likelihood=float(j.log_likelihood), converged=bool(j.converged),
        device="cpu")
    labels = tgmm.gmm_predict(x, t).numpy()
    want = np.asarray(jgmm.gmm_predict(x, j))
    assert labels.dtype == np.int32
    diff = np.nonzero(labels != want)[0]
    if diff.size:  # near-ties only: the two log-probs within 1e-4
        logp = np.asarray(jgmm._log_prob_t(
            jnp.asarray(x), j.means, j.variances, jnp.log(j.weights),
            cov_type))
        gap = np.abs(logp[diff, labels[diff]] - logp[diff, want[diff]])
        assert (gap <= 1e-4).all(), gap.max()
    np.testing.assert_allclose(tgmm.gmm_predict_proba(x, t).numpy(),
                               np.asarray(jgmm.gmm_predict_proba(x, j)),
                               atol=1e-5)
    np.testing.assert_allclose(tgmm.gmm_score_samples(x, t).numpy(),
                               np.asarray(jgmm.gmm_score_samples(x, j)),
                               rtol=1e-5)
    assert tgmm.gmm_n_parameters(t) == jgmm.gmm_n_parameters(j)
    np.testing.assert_allclose(tgmm.gmm_bic(x, t), jgmm.gmm_bic(x, j),
                               rtol=1e-6)
    np.testing.assert_allclose(tgmm.gmm_aic(x, t), jgmm.gmm_aic(x, j),
                               rtol=1e-6)
    back = convert.to_numpy(t)
    assert back["covariance_type"] == cov_type
    assert back["n_iter"] == int(j.n_iter)
    for name in ("means", "variances", "weights"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(j, name)))


@pytest.mark.parametrize("block_rows", [0, 128])
def test_moments_from_hard_assign(monkeypatch, block_rows):
    # Mean 5 sits far from every point: its component is empty and takes
    # the global variance. With block_rows the labels and moments run in
    # 128-row blocks (N = 1500 is not a multiple).
    x, init, _ = _blobs(6)
    init[5] = 100.0
    monkeypatch.setattr(tgmm, "auto_block_rows",
                        lambda *a, **kw: block_rows)
    var, w = tgmm._moments_from_hard_assign(_t(x), _t(init), 1e-6)
    jvar, jw = jgmm._moments_from_hard_assign(jnp.asarray(x),
                                              jnp.asarray(init), 1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    assert float(w[5]) < 1e-11


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_gmm_sample(cov_type):
    rng = np.random.default_rng(7)
    k, d = 3, 2
    means = np.array([[0.0, 0.0], [8.0, 0.0], [0.0, 8.0]], np.float32)
    cov = _cov_params(cov_type, k, d, rng)
    res = convert.gmm_state_from_numpy(means, cov, [0.2, 0.3, 0.5], cov_type,
                                       device="cpu")
    xs, comp = tgmm.gmm_sample(res, 20000, torch.Generator().manual_seed(1))
    again = tgmm.gmm_sample(res, 20000, torch.Generator().manual_seed(1))
    assert torch.equal(xs, again[0]) and torch.equal(comp, again[1])
    assert xs.shape == (20000, d) and xs.dtype == torch.float32
    assert comp.dtype == torch.int32
    freq = np.bincount(comp.numpy(), minlength=k) / 20000
    np.testing.assert_allclose(freq, [0.2, 0.3, 0.5], atol=0.02)
    for j in range(k):
        np.testing.assert_allclose(xs[comp == j].mean(0).numpy(), means[j],
                                   atol=0.1)


def test_gmm_validations():
    x, init, w = _blobs(8, n=300)
    for cov_type in ("full", "tied"):
        with pytest.raises(ValueError, match="pallas"):
            tgmm.gmm_fit(x, 6, init=init, kernel="pallas",
                         covariance_type=cov_type, device="cpu")
    with pytest.raises(ValueError, match="pallas"):
        tgmm.gmm_fit(x, 6, init=init, kernel="pallas", sample_weight=w,
                     device="cpu")
    with pytest.raises(ValueError, match="covariance_type"):
        tgmm.gmm_fit(x, 6, init=init, covariance_type="banana", device="cpu")
    with pytest.raises(ValueError, match="nonnegative"):
        tgmm.gmm_fit(x, 6, init=init, sample_weight=-np.ones(len(x)),
                     device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        tgmm.gmm_fit(x, 6, init=init, kernel="refined", device="cpu")
    # A mesh runs the torch E-step: B9 is single-device, as the JAX
    # package's Pallas E-step is.
    with pytest.raises(ValueError, match="unweighted, single-device "
                                         "E-step only"):
        tgmm.gmm_fit(x, 6, init=init, mesh=tmesh.make_mesh(1),
                     kernel="pallas", device="cpu")
    with pytest.raises(ValueError, match="full variances"):
        convert.gmm_state_from_numpy(init, np.ones((6, 4), np.float32),
                                     np.ones(6) / 6, "full", device="cpu")


def _collapsing_points():
    """Five unit blobs in d=6 with every 7th row replaced by row 3 (215
    identical rows): from first_k means a full-covariance component
    collapses onto the repeated row within a few EM steps."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(loc=c, size=(300, 6)) for c in range(5)])
    x = x.astype(np.float32)
    x[::7] = x[3]
    return x


@pytest.mark.parametrize("cov_type", ["full", "tied"])
def test_collapsing_component_gives_nan_not_an_error(cov_type):
    # A covariance that is not positive definite: the JAX package's
    # Cholesky factor is NaN, and the NaN runs through n_iter, converged,
    # the log-likelihood and the means; the port matches instead of
    # raising. Values near the collapse are not compared.
    x = _collapsing_points()
    kw = dict(init="first_k", max_iters=30, tol=1e-4,
              covariance_type=cov_type)
    j = jgmm.gmm_fit(x, 4, **kw)
    t = tgmm.gmm_fit(x, 4, device="cpu", **kw)
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    assert np.isnan(float(t.log_likelihood)) == np.isnan(
        float(j.log_likelihood))
    np.testing.assert_array_equal(np.isnan(t.means.numpy()),
                                  np.isnan(np.asarray(j.means)))
    if cov_type == "full":
        assert int(j.n_iter) == 7 and not bool(j.converged)
        assert np.isnan(float(j.log_likelihood))
        assert np.isnan(np.asarray(j.means)).any()


def test_cholesky_of_a_singular_covariance_is_nan():
    cov = torch.stack([torch.eye(3), torch.zeros((3, 3))])
    chol = tgmm._cholesky(cov)
    assert torch.equal(chol[0], torch.eye(3))
    assert bool(torch.isnan(chol[1]).all())
