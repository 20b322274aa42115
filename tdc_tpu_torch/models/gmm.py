"""Gaussian Mixture Models via EM, all four sklearn covariance types
(counterpart: tdc_tpu/models/gmm.py, the in-memory part, :52-577).

The E-step is the JAX package's matmul form, never an (N, K, d) tensor:
diag and spherical expand Σ_d (x − μ)²/σ² into two (N, d) × (d, K)
products; tied whitens x and the means once through the shared Cholesky
factor; full solves per component in a loop over K. The M-step reads the
responsibilities' moments Σr, Σr·x and the covariance type's second
moment (Σr·x², Σr·xxᵀ, or the iteration-constant Σxxᵀ for tied).

The JAX package traces the EM loop into one `lax.while_loop`. Here, as in
`models/kmeans.py`, the loop runs on the host and every iteration's work
stays on the device; the host reads the mean log-likelihood once per
iteration, which the `i < 1 or ll − prev_ll > tol` test needs. The
semantics are the JAX package's:

- at least one EM step; stop when the mean log-likelihood gain of the
  latest step is not above tol (compared in f32), or at max_iters;
- the final log-likelihood is recomputed at the returned parameters, so a
  fit makes n_iter + 1 E-steps;
- converged = n_iter > 1 and the last gain <= tol.

kernel='pallas' runs the E-step on B9 (`ops/gmm_kernels.gmm_stats_fused`):
diag, and spherical with the scalar variance broadcast across d (the same
log-density, and the (K, d) second moment the spherical M-step averages),
unweighted only; anything else raises, so no plain numbers are recorded
under the kernel's name. 'auto' resolves to pallas on CUDA where eligible,
else xla, with one `kernel_selected` event. Sample weights run on xla.

Supported: float32 or bfloat16 inputs (bf16 points are widened to f32 at
entry, as the JAX version takes `xf = x.astype(f32)` throughout), and
mesh= for all four covariance types: every rank passes the same x, takes
its block of rows (`parallel.mesh.shard_points`), and each E-step's
log-likelihood, Σr, Σr·x and second moment, the hard-assignment moments
of the start and the tied type's Σxxᵀ are summed over the data axes in
one all_reduce each; the M-step (and its Cholesky factors) then runs
alike on every rank. The mesh E-step is the torch one: kernel='pallas'
with a mesh raises, as the JAX version refuses its Pallas E-step there.
The K-sharded fit (A9) has no entry point in the port yet.

`streamed_gmm_fit` is the exact out-of-core EM (counterpart:
`streamed_gmm_fit`, `_batch_gmm_stats[_weighted]`,
`_gmm_zero_row_correction` and `_gmm_pass_correction`; the JAX
`_accumulate_gmm[_weighted]` are the pass's `_gmm_pass_fns`): one pass
over a re-iterable stream of batches per EM iteration, the E-step stats summed over the batches, all four
covariance types (B9 per batch for diag and spherical on 'pallas', the
torch E-step otherwise), the streamed K-Means' pass machinery
(`models/streaming.py`): rank slices padded and corrected under a mesh,
per-batch or per-pass reduces, the batch screen.

A covariance that is not positive definite (a component collapsed onto
repeated rows) gives a NaN Cholesky factor for that component, as
`jnp.linalg.cholesky` does, and the NaN flows into the log-likelihood,
the parameters, n_iter and converged as in the JAX version; it does not
raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tdc_tpu_torch.models._common import validate_sample_weight
from tdc_tpu_torch.models.kmeans import (
    _as_points,
    auto_block_rows,
    kmeans_fit,
    resolve_init,
    resolve_init_replicated,
)
from tdc_tpu_torch.ops.assign import assign_clusters, cluster_stats
from tdc_tpu_torch.ops.gmm_kernels import GMMStats, gmm_stats_for
from tdc_tpu_torch.utils.device import resolve_device

_LOG_2PI = math.log(2.0 * math.pi)

COVARIANCE_TYPES = ("diag", "spherical", "tied", "full")


class GMMResult(NamedTuple):
    means: torch.Tensor  # (K, d) f32
    # Covariance parameters, shaped by covariance_type (sklearn convention):
    # diag (K, d), spherical (K,), tied (d, d), full (K, d, d).
    variances: torch.Tensor
    weights: torch.Tensor  # (K,) mixing proportions, sum to 1
    n_iter: int  # EM iterations run
    log_likelihood: torch.Tensor  # () f32 — mean per-point log-likelihood
    converged: bool
    # Iterations executed by THIS fit call (None = same as n_iter).
    n_iter_run: object = None
    covariance_type: str = "diag"
    # The streamed fit's parallel.reduce.CommsReport (None in memory).
    comms: object = None


def _log_prob(x, means, variances, log_weights):
    """(N, K) log [π_k N(x | μ_k, diag σ²_k)] in matmul form, f32."""
    inv = 1.0 / variances  # (K, d)
    maha = ((x * x) @ inv.T - 2.0 * (x @ (means * inv).T)
            + (means * means * inv).sum(dim=1)[None, :])
    log_det = torch.log(variances).sum(dim=1)
    d = x.shape[1]
    return (-0.5 * (maha + log_det[None, :] + d * _LOG_2PI)
            + log_weights[None, :])


def _log_prob_spherical(x, means, variances, log_weights):
    """(N, K) log-prob with one σ²_k per component: the plain squared
    distance matmul scaled per component."""
    d2 = ((x * x).sum(dim=1, keepdim=True) - 2.0 * (x @ means.T)
          + (means * means).sum(dim=1)[None, :])
    d = x.shape[1]
    maha = d2 / variances[None, :]
    log_det = d * torch.log(variances)
    return (-0.5 * (maha + log_det[None, :] + d * _LOG_2PI)
            + log_weights[None, :])


def _cholesky(cov):
    """Lower Cholesky factors of (..., d, d) covariances; a factor whose
    matrix is not positive definite is all NaN, as jnp.linalg.cholesky
    gives it (torch.linalg.cholesky would raise, and cholesky_ex leaves a
    partial factor)."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def _log_prob_tied(x, means, cov, log_weights):
    """(N, K) log-prob with one shared (d, d) covariance: whiten x and the
    means once through the Cholesky factor, then the diag expansion in
    whitened space."""
    chol = _cholesky(cov)
    z = torch.linalg.solve_triangular(chol, x.T, upper=False).T  # (N, d)
    zm = torch.linalg.solve_triangular(chol, means.T, upper=False).T
    maha = ((z * z).sum(dim=1, keepdim=True) - 2.0 * (z @ zm.T)
            + (zm * zm).sum(dim=1)[None, :])
    log_det = 2.0 * torch.log(torch.diagonal(chol)).sum()
    d = x.shape[1]
    return -0.5 * (maha + log_det + d * _LOG_2PI) + log_weights[None, :]


def _log_prob_full(x, means, covs, log_weights):
    """(N, K) log-prob with per-component (d, d) covariances: a loop over K
    of triangular solves, never an (N, K, d) tensor."""
    chol = _cholesky(covs)  # (K, d, d)
    maha = torch.stack([
        (torch.linalg.solve_triangular(chol[j], (x - means[j]).T,
                                       upper=False) ** 2).sum(dim=0)
        for j in range(means.shape[0])
    ], dim=1)  # (N, K)
    log_det = 2.0 * torch.log(
        torch.diagonal(chol, dim1=1, dim2=2)).sum(dim=1)
    d = x.shape[1]
    return (-0.5 * (maha + log_det[None, :] + d * _LOG_2PI)
            + log_weights[None, :])


def _log_prob_t(x, means, cov, log_weights, cov_type: str):
    if cov_type == "diag":
        return _log_prob(x, means, cov, log_weights)
    if cov_type == "spherical":
        return _log_prob_spherical(x, means, cov, log_weights)
    if cov_type == "tied":
        return _log_prob_tied(x, means, cov, log_weights)
    if cov_type == "full":
        return _log_prob_full(x, means, cov, log_weights)
    raise ValueError(f"unknown covariance_type {cov_type!r}")


def gmm_stats_auto(x, means, variances, weights):
    """Diag-GMM E-step sufficient stats (ll_sum, nk (K,), sx (K, d),
    sxx (K, d)) on the kernel route: B9 at every (K, d), since its two
    phases have no K·d limit (the JAX version falls back to XLA past its
    VMEM model; nothing here needs to)."""
    return gmm_stats_for(*means.shape)(x, means, variances, weights)


def _m_step(nk, sx, sxx, n_rows, reg):
    """Diag M-step: means, variances clamped at 0 plus reg_covar, and the
    renormalised weights."""
    safe = torch.clamp_min(nk, 1e-12)[:, None]
    means = sx / safe
    variances = torch.clamp_min(sxx / safe - means * means, 0.0) + reg
    weights = torch.clamp_min(nk / n_rows, 1e-12)
    return means, variances, weights / weights.sum()


def _m_step_t(nk, sx, second, wsum, reg, cov_type: str):
    """Covariance-type-aware M-step. `second` is the type's second moment:
    Σr·x² (K, d) for diag/spherical, Σr·xxᵀ (K, d, d) for full, the
    iteration-constant Σxxᵀ (d, d) for tied."""
    if cov_type == "diag":
        return _m_step(nk, sx, second, wsum, reg)
    safe = torch.clamp_min(nk, 1e-12)[:, None]
    means = sx / safe
    d = means.shape[1]
    eye = torch.eye(d, dtype=torch.float32, device=means.device)
    if cov_type == "spherical":
        # sklearn: the mean of the (reg-floored) diag variances.
        cov = (torch.clamp_min(second / safe - means * means, 0.0)
               + reg).mean(dim=1)
    elif cov_type == "full":
        outer = means[:, :, None] * means[:, None, :]
        cov = second / torch.clamp_min(nk, 1e-12)[:, None, None] - outer
        cov = cov + reg * eye[None]
    else:  # tied: Σ_k nk μμᵀ == sxᵀ @ means since nk·μ = sx
        cov = (second - sx.T @ means) / wsum + reg * eye
    weights = torch.clamp_min(nk / wsum, 1e-12)
    return means, cov, weights / weights.sum()


def _psum_data(mesh, *ts):
    """The tensors `ts` summed over the mesh's data axes in one
    all_reduce (f32)."""
    from tdc_tpu_torch.parallel.mesh import data_axes
    from tdc_tpu_torch.parallel.reduce import tree_all_reduce

    return tuple(tree_all_reduce(tuple(ts), mesh, data_axes(mesh)))


def _em_loop(x, means0, cov0, weights0, max_iters: int, tol: float,
             reg: float, cov_type: str = "diag", w=None,
             kernel: str = "xla", mesh=None, n=None):
    """The EM iteration; returns (means, cov, weights, n_iter, final_ll,
    converged). `w` (sample weights) scales each row's responsibilities
    (xla only). With `mesh`, x (and w) are this rank's rows, n the
    global row count, and the E-step's sums are summed over the data
    axes."""
    d = x.shape[1]
    if n is None:
        n = x.shape[0]
    if w is not None:
        wsum = w.sum() if mesh is None else _psum_data(mesh, w.sum())[0]
    else:
        wsum = torch.tensor(float(n), dtype=torch.float32, device=x.device)
    if cov_type == "tied":
        # Σ wᵢ xxᵀ is iteration-constant (responsibilities sum to 1 per
        # point), so the tied M-step needs only nk and sx per iteration.
        xw = x if w is None else x * w[:, None]
        s_total = xw.T @ x
        if mesh is not None:
            s_total = _psum_data(mesh, s_total)[0]
    if kernel == "pallas":
        stats_fn = gmm_stats_for(means0.shape[0], d, label="gmm_fit")

    def e_and_stats(means, cov, log_weights):
        if kernel == "pallas":
            # Spherical is the diag kernel with the scalar variance
            # broadcast across d: the same log-density, and the (K, d)
            # second moment the spherical M-step averages.
            var_d = (cov if cov_type == "diag"
                     else cov[:, None].expand(-1, d).contiguous())
            st = stats_fn(x, means.contiguous(), var_d,
                          torch.exp(log_weights))
            return st.ll_sum / n, st.nk, st.sx, st.sxx
        logp = _log_prob_t(x, means, cov, log_weights, cov_type)  # (N, K)
        norm = torch.logsumexp(logp, dim=1, keepdim=True)
        r = torch.exp(logp - norm)
        if w is not None:
            r = r * w[:, None]
        nk = r.sum(dim=0)
        sx = r.T @ x
        if cov_type in ("diag", "spherical"):
            s2 = r.T @ (x * x)
        elif cov_type == "full":
            # K sequential (d, N) × (N, d) products, no (N, K, d) tensor.
            s2 = torch.stack([(x * r[:, j:j + 1]).T @ x
                              for j in range(r.shape[1])])
        else:  # tied: the second moment is the precomputed constant
            s2 = None
        if mesh is not None:
            ll_sum = (norm.sum() if w is None
                      else (w * norm[:, 0]).sum())
            sums = (ll_sum, nk, sx) + (() if s2 is None else (s2,))
            ll_sum, nk, sx, *rest = _psum_data(mesh, *sums)
            return ll_sum / wsum, nk, sx, (rest[0] if rest else None)
        ll = ((w * norm[:, 0]).sum() / wsum if w is not None
              else norm.mean())
        return ll, nk, sx, s2

    means, cov, weights = means0, cov0, weights0
    # The mean log-likelihood before and after the latest step, as f32 on
    # the host, so the gain is compared with tol in f32 as the JAX loop
    # compares them on the device.
    tol32 = np.float32(tol)
    prev_ll = ll = np.float32(-np.inf)
    n_iter = 0
    while n_iter < max_iters and (n_iter < 1 or ll - prev_ll > tol32):
        step_ll, nk, sx, s2 = e_and_stats(means, cov, torch.log(weights))
        second = s_total if cov_type == "tied" else s2
        means, cov, weights = _m_step_t(nk, sx, second, wsum, reg, cov_type)
        prev_ll, ll = ll, np.float32(step_ll.item())
        n_iter += 1
    # Final log-likelihood of the RETURNED parameters (the loop's is one
    # step stale).
    final_ll = e_and_stats(means, cov, torch.log(weights))[0]
    converged = bool(n_iter > 1 and ll - prev_ll <= tol32)
    return means, cov, weights, n_iter, final_ll, converged


def gmm_fit(
    x,
    k: int,
    *,
    init="kmeans",
    generator: torch.Generator | None = None,
    max_iters: int = 100,
    tol: float = 1e-4,
    reg_covar: float = 1e-6,
    mesh=None,
    covariance_type: str = "diag",
    sample_weight=None,
    kernel: str = "xla",
    device=None,
) -> GMMResult:
    """Fit a GMM with EM.

    Args:
      x: (N, d) points (numpy or torch), float32 on `device` (bfloat16
        widened, which is exact). With `mesh`, the same on every rank and
        N divisible by the mesh size.
      init: 'kmeans' (a short K-Means fit seeds the means: k-means++, 10
        iterations, tol 1e-3, best of 3 — sklearn's default), any
        resolve_init spec ('kmeans++', 'random', 'first_k'), or an explicit
        (K, d) means array. Initial variances and weights come from the
        hard assignment to the initial means. With `mesh`, the draws are
        rank 0's (`kmeans_fit(mesh=)`, `resolve_init_replicated`).
      generator: torch.Generator on `device` for the stochastic inits
        (default: one seeded with 0).
      tol: threshold on the mean per-point log-likelihood gain (sklearn
        semantics).
      reg_covar: variance floor added every M-step.
      mesh: a `parallel.mesh.Mesh` (`make_mesh`, `make_hierarchical_mesh`):
        each rank fits its rows and every rank returns the same result.
      covariance_type: 'diag' | 'spherical' | 'tied' | 'full'
        (result.variances takes the matching shape).
      sample_weight: optional (N,) nonnegative per-point weights, scaling
        each point's responsibilities (equivalent to repeating rows); xla
        only.
      kernel: 'xla' (plain PyTorch ops), 'pallas' (the E-step kernel B9:
        diag or spherical, unweighted, single-device) or 'auto' /
        'auto:quantized' (pallas on CUDA where eligible, xla otherwise).
      device: None means 'cuda'; 'cpu' runs the plain versions.
    """
    if covariance_type not in COVARIANCE_TYPES:
        raise ValueError(
            f"covariance_type must be one of {COVARIANCE_TYPES}, "
            f"got {covariance_type!r}")
    dev = resolve_device(device)
    x = _as_points(x, dev).float()
    n, d = x.shape
    eligible = (covariance_type in ("diag", "spherical")
                and sample_weight is None and mesh is None)
    if kernel.startswith("auto"):
        from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

        kernel = resolve_kernel(
            kernel, k=k, d=d, device=dev, model="gmm", label="gmm_fit",
            ineligible=(None if eligible else
                        "the fused E-step is diag/spherical, unweighted, "
                        "single-device only"))
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    if kernel == "pallas" and not eligible:
        raise ValueError(
            "kernel='pallas' supports the diag/spherical, unweighted, "
            "single-device E-step only")
    w = None
    if sample_weight is not None:
        w = validate_sample_weight(sample_weight, n, k, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if mesh is not None and n % mesh.size != 0:
        raise ValueError(f"N={n} not divisible by mesh size {mesh.size}")
    if isinstance(init, str) and init == "kmeans":
        # Best of 3 k-means++ restarts by SSE: one draw can split or merge
        # blobs, and EM inherits that basin.
        means0 = kmeans_fit(
            x, k, init="kmeans++", generator=generator, max_iters=10,
            tol=1e-3, mesh=mesh, n_init=3, sample_weight=sample_weight,
            device=dev,
        ).centroids
    elif mesh is not None:
        means0 = resolve_init_replicated(x, k, init, generator, mesh, w)
    else:
        means0 = resolve_init(x, k, init, generator, w)
    means0 = means0.to(torch.float32).contiguous()
    if mesh is not None:
        from tdc_tpu_torch.parallel.mesh import shard_points

        x = shard_points(x, mesh)
        if w is not None:
            w = shard_points(w, mesh)
    # Initial variances and weights from the hard assignment to the
    # initial means (sklearn's one-hot responsibilities): a loose global
    # variance lets early E-steps merge separated components.
    variances0, weights0 = _moments_from_hard_assign(x, means0, reg_covar,
                                                     mesh, n)
    cov0 = _diag_to_cov(variances0, weights0, covariance_type)
    means, cov, weights, n_iter, ll, converged = _em_loop(
        x, means0, cov0, weights0, int(max_iters), float(tol),
        float(reg_covar), covariance_type, w, kernel, mesh, n)
    return GMMResult(means=means, variances=cov, weights=weights,
                     n_iter=n_iter, log_likelihood=ll, converged=converged,
                     covariance_type=covariance_type)


def _diag_to_cov(var, weights, cov_type: str):
    """Project the hard-assignment diag variance estimate (K, d) into the
    requested covariance parameterization for the EM start."""
    if cov_type == "diag":
        return var
    if cov_type == "spherical":
        return var.mean(dim=1)
    if cov_type == "tied":
        return torch.diag((weights[:, None] * var).sum(dim=0))
    d = var.shape[1]  # full: embed the diagonals
    return var[:, :, None] * torch.eye(d, dtype=var.dtype,
                                       device=var.device)[None]


def _moments_from_hard_assign(x, means, reg, mesh=None, n=None):
    """(variances (K, d), weights (K,)) from one-hot nearest-mean
    responsibilities: per-component variance around the component's own
    empirical mean, the global variance for empty components. Labels
    (smallest index on ties) and moments are taken in row blocks of
    `auto_block_rows`, so no (N, K) buffer outgrows the memory budget.
    With `mesh`, x is this rank's rows and n the global row count: the
    moments, and the global mean and variance, are summed over the data
    axes."""
    k = means.shape[0]
    rows = auto_block_rows(x.shape[0], k, device=x.device) or max(
        x.shape[0], 1)
    nk = torch.zeros(k, dtype=torch.float32, device=x.device)
    moments = torch.zeros((k, 2 * x.shape[1]), dtype=torch.float32,
                          device=x.device)
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        sums, counts = cluster_stats(torch.cat([xb, xb * xb], dim=1),
                                     assign_clusters(xb, means), k)
        moments += sums
        nk += counts
    if mesh is None:
        n = x.shape[0]
        gvar = torch.var(x, dim=0, unbiased=False)
    else:
        # jnp.var over the global rows: the global mean, then the mean
        # squared deviation from it.
        moments, nk, xsum = _psum_data(mesh, moments, nk, x.sum(dim=0))
        dev2 = _psum_data(mesh, ((x - xsum / n) ** 2).sum(dim=0))[0]
        gvar = dev2 / n
    safe = torch.clamp_min(nk, 1.0)[:, None]
    mu, ex2 = (moments / safe).chunk(2, dim=1)
    var = torch.clamp_min(ex2 - mu * mu, 0.0) + reg
    gvar = torch.clamp_min(gvar, 1e-6) + reg
    var = torch.where(nk[:, None] > 0, var, gvar[None, :])
    w = torch.clamp_min(nk / n, 1e-12)
    return var, w / w.sum()


def _logp_of(x, result: GMMResult):
    """(x on the result's device, (N, K) log-probs under the mixture)."""
    x = _as_points(x, result.means.device).float()
    return x, _log_prob_t(x, result.means, result.variances,
                          torch.log(result.weights), result.covariance_type)


def gmm_predict(x, result: GMMResult) -> torch.Tensor:
    """Hard component labels (N,) int32: argmax posterior, smallest index
    on ties. Runs on the result's device."""
    return torch.argmax(_logp_of(x, result)[1], dim=1).to(torch.int32)


def gmm_predict_proba(x, result: GMMResult) -> torch.Tensor:
    """(N, K) posterior responsibilities."""
    logp = _logp_of(x, result)[1]
    return torch.exp(logp - torch.logsumexp(logp, dim=1, keepdim=True))


def gmm_score_samples(x, result: GMMResult) -> torch.Tensor:
    """(N,) per-point log p(x) under the mixture (sklearn .score_samples)."""
    return torch.logsumexp(_logp_of(x, result)[1], dim=1)


def gmm_score(x, result: GMMResult) -> float:
    """Mean per-point log-likelihood (sklearn .score)."""
    return float(gmm_score_samples(x, result).mean())


def gmm_n_parameters(result: GMMResult) -> int:
    """Free-parameter count for BIC/AIC (sklearn's _n_parameters)."""
    k, d = result.means.shape
    cov_params = {
        "diag": k * d,
        "spherical": k,
        "tied": d * (d + 1) // 2,
        "full": k * d * (d + 1) // 2,
    }[result.covariance_type]
    return int(cov_params + k * d + k - 1)


def gmm_bic(x, result: GMMResult) -> float:
    """Bayesian information criterion on x (lower is better)."""
    n = np.shape(x)[0]
    return float(-2.0 * gmm_score(x, result) * n
                 + gmm_n_parameters(result) * float(np.log(n)))


def gmm_aic(x, result: GMMResult) -> float:
    """Akaike information criterion on x (lower is better)."""
    n = np.shape(x)[0]
    return float(-2.0 * gmm_score(x, result) * n
                 + 2 * gmm_n_parameters(result))


def gmm_sample(result: GMMResult, n_samples: int,
               generator: torch.Generator):
    """Draw (X (n, d) f32, labels (n,) int32) from the fitted mixture
    (sklearn .sample): components by weight, then the matching Gaussian.
    `generator` lives on the result's device; torch's draws are not the
    JAX package's, so samples agree in distribution only."""
    dev = result.means.device
    d = result.means.shape[1]
    comp = torch.multinomial(result.weights, n_samples, replacement=True,
                             generator=generator)
    z = torch.randn((n_samples, d), generator=generator, device=dev)
    means = result.means[comp]
    cov_type = result.covariance_type
    if cov_type == "diag":
        x = means + z * torch.sqrt(result.variances)[comp]
    elif cov_type == "spherical":
        x = means + z * torch.sqrt(result.variances)[comp][:, None]
    elif cov_type == "tied":
        x = means + z @ torch.linalg.cholesky(result.variances).T
    else:  # full: per-component Cholesky, gathered per sample
        chols = torch.linalg.cholesky(result.variances)  # (K, d, d)
        x = means + torch.einsum("nd,ned->ne", z, chols[comp])
    return x, comp.to(torch.int32)


# ---------------------------------------------------------------------------
# Streamed EM
# ---------------------------------------------------------------------------


def _gmm_sxx_shape(k: int, d: int, cov_type: str) -> tuple:
    return {"diag": (k, d), "spherical": (k, d), "tied": (d, d),
            "full": (k, d, d)}[cov_type]


def _gmm_shapes(k: int, d: int, cov_type: str) -> GMMStats:
    return GMMStats(ll_sum=(), nk=(k,), sx=(k, d),
                    sxx=_gmm_sxx_shape(k, d, cov_type))


def _second_moment(xf, r, cov_type: str):
    """The covariance type's second moment of one batch: Σr·x² (K, d),
    Σr·xxᵀ (K, d, d) as K (d, B) × (B, d) products, or the
    responsibility-free Σxxᵀ (d, d) for tied (r holds the weights there,
    or None)."""
    if cov_type in ("diag", "spherical"):
        return r.T @ (xf * xf)
    if cov_type == "full":
        return torch.stack([(xf * r[:, j:j + 1]).T @ xf
                            for j in range(r.shape[1])])
    return (xf if r is None else xf * r[:, None]).T @ xf


def _batch_gmm_stats(batch, means, variances, weights, kernel: str = "xla",
                     cov_type: str = "diag", stats_fn=None) -> GMMStats:
    """One batch's E-step stats, uncorrected. kernel='pallas' runs B9
    (`stats_fn`, the fit's `gmm_stats_for` choice), spherical with the
    scalar variance broadcast across d."""
    xf = batch.float()
    if kernel == "pallas":
        d = xf.shape[1]
        var_d = (variances if cov_type == "diag"
                 else variances[:, None].expand(-1, d).contiguous())
        fn = stats_fn or gmm_stats_for(*means.shape)
        return fn(xf, means.contiguous(), var_d, weights)
    logp = _log_prob_t(xf, means, variances, torch.log(weights), cov_type)
    norm = torch.logsumexp(logp, dim=1, keepdim=True)
    r = torch.exp(logp - norm)
    return GMMStats(ll_sum=norm.sum(), nk=r.sum(dim=0), sx=r.T @ xf,
                    sxx=_second_moment(xf, None if cov_type == "tied"
                                       else r, cov_type))


def _batch_gmm_stats_weighted(batch, w, means, variances, weights,
                              cov_type: str = "diag") -> GMMStats:
    """Weighted one-batch E-step stats: responsibilities scaled by w, so
    zero-weight rows add exactly nothing."""
    xf = batch.float()
    logp = _log_prob_t(xf, means, variances, torch.log(weights), cov_type)
    norm = torch.logsumexp(logp, dim=1, keepdim=True)
    r = torch.exp(logp - norm) * w[:, None]
    return GMMStats(ll_sum=(w * norm[:, 0]).sum(), nk=r.sum(dim=0),
                    sx=r.T @ xf,
                    sxx=_second_moment(xf, w if cov_type == "tied" else r,
                                       cov_type))


def _gmm_zero_row_correction(means, variances, weights, n_pad, d: int,
                             cov_type: str):
    """(Δll, Δnk) that `n_pad` zero rows contributed: their
    responsibilities and log-likelihood depend only on the parameters
    (zero rows add nothing to sx or sxx)."""
    zlogp = _log_prob_t(torch.zeros((1, d), dtype=torch.float32,
                                    device=means.device), means, variances,
                        torch.log(weights), cov_type)
    znorm = torch.logsumexp(zlogp, dim=1)
    zr = torch.exp(zlogp - znorm[:, None])[0]
    n_pad = float(n_pad)
    return n_pad * znorm[0], n_pad * zr


def _gmm_pass_correction(red: GMMStats, means, variances, weights, n_pad,
                         cov_type: str) -> GMMStats:
    """`red` less n_pad zero rows' contribution (per batch or once per
    pass: the parameters are pass-constant, so both are one evaluation
    scaled by the pad count)."""
    dll, dnk = _gmm_zero_row_correction(means, variances, weights, n_pad,
                                        means.shape[1], cov_type)
    return GMMStats(ll_sum=red.ll_sum - dll, nk=red.nk - dnk, sx=red.sx,
                    sxx=red.sxx)


def _gmm_pass_fns(kernel: str, cov_type: str, stats_fn=None):
    """(local, correct) of an EM pass (`models/streaming._Pass`), with the
    parameters (means, variances, weights) as the pass's params: one
    batch's E-step stats (weighted ones on the torch E-step, pad rows of
    zero weight adding nothing), and the subtraction of n_pad zero rows
    (`_gmm_pass_correction`)."""

    def local(xb, wb, params):
        if wb is not None:
            return _batch_gmm_stats_weighted(xb, wb, *params, cov_type)
        return _batch_gmm_stats(xb, *params, kernel, cov_type, stats_fn)

    return local, (lambda s, n_pad, params, dtype: _gmm_pass_correction(
        s, *params, n_pad, cov_type))


def streamed_gmm_fit(
    batches,
    k: int,
    d: int,
    *,
    init="kmeans",
    generator: torch.Generator | None = None,
    max_iters: int = 100,
    tol: float = 1e-4,
    reg_covar: float = 1e-6,
    mesh=None,
    prefetch: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 5,
    kernel: str = "xla",
    covariance_type: str = "diag",
    sample_weight_batches=None,
    reduce="per_batch",
    device=None,
) -> GMMResult:
    """Exact streamed EM over a re-iterable stream of (B, d) batches: one
    full pass per EM iteration, the E-step stats summed over the batches
    (the JAX version's contract; see `models/streaming.py` for the stream,
    the mesh and `reduce`).

    The means come from `init` ('kmeans': a short K-Means fit, as
    gmm_fit; any resolve_init spec; or an explicit (K, d) array), the
    variances and weights from the hard assignment to them, all on the
    FIRST batch (rank 0's, broadcast, under a mesh). The log-likelihood
    and the M-step normalize by the stream's row count (by Σw when
    weighted). kernel='pallas' runs B9 for diag and spherical, unweighted
    and single-device.

    ckpt_dir: a checkpoint (`utils/checkpoint.py`) every `ckpt_every`
    iterations, on convergence and at the end: the means as the
    centroids, the variances, weights, log-likelihood and the layout in
    the meta, the JAX version's. A resume restores first and skips the
    seeding; it checks k, d, reg_covar, the covariance type and the
    weighting, in the JAX version's words. Per iteration only (an
    interrupted pass runs again). A resume of a finished run returns
    the saved final log-likelihood without a pass. Returns a GMMResult
    with `comms` and n_iter_run, the iterations this call ran."""
    from tdc_tpu_torch.models import streaming as st
    from tdc_tpu_torch.parallel import reduce as reduce_lib
    from tdc_tpu_torch.parallel import reshard as reshard_lib
    from tdc_tpu_torch.utils import checkpoint as ckpt_lib

    if covariance_type not in COVARIANCE_TYPES:
        raise ValueError(
            f"covariance_type must be one of {COVARIANCE_TYPES}, "
            f"got {covariance_type!r}")
    weighted = sample_weight_batches is not None
    strategy = reduce_lib.resolve_reduce(reduce)
    dev = resolve_device(device)
    if kernel.startswith("auto"):
        from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

        kernel = resolve_kernel(
            kernel, k=k, d=d, device=dev, model="gmm",
            label="streamed_gmm_fit",
            ineligible=(
                "the fused E-step is diag/spherical, unweighted, "
                "single-device only"
                if (covariance_type not in ("diag", "spherical")
                    or weighted or mesh is not None) else None))
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    if kernel == "pallas" and mesh is not None:
        raise ValueError(
            "streamed kernel='pallas' supports single-device streams only")
    if kernel == "pallas" and covariance_type not in ("diag", "spherical"):
        raise ValueError(
            "streamed kernel='pallas' supports covariance_type "
            "'diag'/'spherical' only (spherical runs the diag kernel with "
            "the scalar variance broadcast)")
    if kernel == "pallas" and weighted:
        raise ValueError(
            "streamed kernel='pallas' supports unweighted streams only "
            "(the fused E-step kernel has no weight input)")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    stream = st._weighted_stream(batches, sample_weight_batches)
    gang = st._is_gang(mesh)
    # Restore first: a resume does not pay for the seeding it would throw
    # away.
    start_iter, prev_ll, saved_final_ll = 0, -float("inf"), None
    resume_converged = False
    saved = None if ckpt_dir is None else ckpt_lib.restore_checkpoint(
        ckpt_dir)
    if saved is not None:
        if saved.meta.get("model") != "gmm":
            raise ValueError(
                f"checkpoint in {ckpt_dir} is not a GMM checkpoint")
        if (int(saved.meta.get("k")) != k or int(saved.meta.get("d")) != d
                or float(saved.meta.get("reg")) != float(reg_covar)):
            raise ValueError(
                f"checkpoint in {ckpt_dir} was written with "
                f"k={saved.meta.get('k')}, d={saved.meta.get('d')}, "
                f"reg_covar={saved.meta.get('reg')} — refusing to mix "
                "state")
        saved_ct = str(saved.meta.get("cov_type", "diag"))
        if saved_ct != covariance_type:
            raise ValueError(
                f"checkpoint in {ckpt_dir} was written with "
                f"covariance_type={saved_ct!r}, requested "
                f"{covariance_type!r} — refusing to mix state")
        saved_w = bool(np.asarray(saved.meta.get("weighted", False)))
        if saved_w != weighted:
            raise ValueError(
                f"checkpoint in {ckpt_dir} was written with "
                f"weighted={saved_w} — refusing to resume with a "
                "different weighting")
        start_iter = saved.n_iter
        # The next gain compares with the saved iteration's ll, as the
        # uninterrupted loop's prev_ll does.
        prev_ll = float(saved.meta.get("ll", -float("inf")))
        # The ll of the returned parameters, which the finishing run's
        # scoring pass wrote ("ll" is the E-step's, before the M-step).
        saved_final_ll = saved.meta.get("final_ll")
        resume_converged = bool(np.asarray(saved.meta.get("converged",
                                                          False)))
        # Full host arrays: placement at any world size is a replicate.
        means, variances, weights = reshard_lib.redistribute(
            (saved.centroids, saved.meta["variances"],
             saved.meta["weights"]),
            reshard_lib.layout_from_meta(saved.meta), mesh,
            lambda tree: tuple(st._placed(t, mesh, dev) for t in tree))
        first_rows = (st._batch_rows(next(iter(stream())))
                      if mesh is not None else 0)
    else:
        # Seeding moments stay unweighted (an initialization heuristic).
        first, _, first_rows = st._first_batch(stream, d, weighted, dev)
        first = first.float()
        if isinstance(init, str) and init == "kmeans":
            means = kmeans_fit(first, k, init="kmeans++",
                               generator=generator, max_iters=10, tol=1e-3,
                               n_init=3, device=dev).centroids
        else:
            means = resolve_init(first, k, init, generator)
        # A copy: first_k's rows are a view that would keep the whole
        # first batch on the device for the fit.
        means = means.to(torch.float32).clone()
        if means.shape != (k, d):
            raise ValueError(f"init means shape {tuple(means.shape)} != "
                             f"{(k, d)}")
        variances, weights = _moments_from_hard_assign(first, means,
                                                       reg_covar)
        variances = _diag_to_cov(variances, weights, covariance_type)
        del first
        if mesh is not None:
            # First-batch draws may differ per rank: rank 0's start EM.
            from tdc_tpu_torch.parallel.mesh import replicate

            means, variances, weights = (replicate(t.contiguous(), mesh)
                                         for t in (means, variances,
                                                   weights))
    st._check_equal_local_rows(first_rows, mesh, dev)
    st._reduce_plan(strategy, mesh, ckpt_dir, None)
    local, correct = _gmm_pass_fns(
        kernel, covariance_type,
        gmm_stats_for(k, d, label="streamed_gmm_fit")
        if kernel == "pallas" else None)
    machine = st._Pass(
        stream, d=d, mesh=mesh, device=dev, prefetch=prefetch,
        weighted=weighted, strategy=strategy,
        shapes=_gmm_shapes(k, d, covariance_type), local=local,
        correct=correct)

    def save(n_iter, ll, done, final_ll=None):
        meta = {"model": "gmm", "k": k, "d": d, "reg": float(reg_covar),
                "cov_type": covariance_type, "weighted": weighted,
                "variances": variances, "weights": weights,
                "ll": float(ll), "converged": bool(done),
                **reshard_lib.layout_meta(mesh)}
        if final_ll is not None:
            meta["final_ll"] = float(final_ll)
        ckpt_lib.save_checkpoint(
            ckpt_dir, ckpt_lib.ClusterState(
                centroids=means, n_iter=n_iter, key=None, batch_cursor=0,
                meta=meta), step=n_iter, gang=gang)

    def full_pass(params):
        acc, rows = machine.run(params)
        # Weighted: Σw == Σ_k nk (Σ_k r = 1 per unit weight); the floor
        # guards only against division by zero.
        norm = (max(float(acc.nk.sum()), 1e-12) if weighted
                else max(rows, 1))
        return acc, norm

    ll = prev_ll
    n_iter, converged = start_iter, resume_converged
    for n_iter in (() if resume_converged
                   else range(start_iter + 1, int(max_iters) + 1)):
        acc, n_rows = full_pass((means, variances, weights))
        ll = float(acc.ll_sum) / n_rows
        means, variances, weights = _m_step_t(acc.nk, acc.sx, acc.sxx,
                                              n_rows, reg_covar,
                                              covariance_type)
        done = n_iter > 1 and ll - prev_ll <= tol
        if ckpt_dir is not None and (done or n_iter % ckpt_every == 0
                                     or n_iter == max_iters):
            save(n_iter, ll, done)
        if done:
            converged = True
            break
        prev_ll = ll
    if (resume_converged or start_iter >= max_iters) \
            and saved_final_ll is not None:
        # A resume of a finished run: its scoring pass is on disk.
        final_ll = float(np.asarray(saved_final_ll))
    else:
        # The log-likelihood of the RETURNED parameters.
        acc, n_rows = full_pass((means, variances, weights))
        final_ll = float(acc.ll_sum) / n_rows
        if ckpt_dir is not None and (converged or n_iter >= max_iters):
            save(n_iter, ll, converged, final_ll=final_ll)
    return GMMResult(
        means=means, variances=variances, weights=weights, n_iter=n_iter,
        log_likelihood=torch.tensor(final_ll, dtype=torch.float32,
                                    device=dev),
        converged=converged, n_iter_run=n_iter - start_iter,
        covariance_type=covariance_type, comms=machine.report())
