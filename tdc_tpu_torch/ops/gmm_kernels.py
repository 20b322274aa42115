"""The GMM kernel B9 (counterpart: tdc_tpu/ops/pallas_kernels.py, the
`_gmm_mxu`, `_gmm_fold` and `gmm_stats_fused` parts, :1294-1459).

As in `ops/fuzzy_kernels.py`, the kernel has three parts here:

- the wrapper `gmm_stats_fused`, which checks its inputs, allocates every
  output and workspace with `torch.empty`, and on a CUDA tensor launches
  the hand-written kernel from `csrc/gmm_kernels.cu` on the current stream
  or raises;
- the plain PyTorch version `gmm_stats_fused_plain`, the same function
  with the same matmul-form formula (logp = (x²)·(−½/σ²)ᵀ + x·(μ/σ²)ᵀ +
  bias, the row logsumexp, r = exp(logp − norm), then the moments). The
  wrapper uses it only for a CPU tensor; the tests hold it to the JAX
  package and `chip_smoke.py` holds the kernel to it on the card;
- a launch counter, `gmm_stats_fused.launches`, which only the kernel
  launch increments.

The kernel is two phases per row chunk (the E-step product and the row
logsumexp, which writes the chunk's log-probs to a scratch of at most
MU_SCRATCH_BYTES, then a K-tiled accumulate that reads them; both
products on the tensor cores in 3xTF32), so it takes every (K, d): the
JAX package's VMEM model `gmm_block_n` has no counterpart, and there is
no route limit and no fallback. See the note in `csrc/gmm_kernels.cu`
and PERF.md.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tdc_tpu_torch.ops import _build
from tdc_tpu_torch.ops.fuzzy_kernels import (
    _D_SLICE,
    _TC_K_TILE,
    phase1_k_splits,
    row_scratch_plan,
)
from tdc_tpu_torch.ops.lloyd_kernels import _PLAIN_TILE_ELEMS, _check, _stream
from tdc_tpu_torch.utils.structlog import emit

_LOG_2PI = math.log(2.0 * math.pi)


class GMMStats(NamedTuple):
    """Diag-GMM E-step sufficient statistics, all f32 (the JAX package's
    `models/gmm.GMMStats` fields)."""

    ll_sum: torch.Tensor  # () Σ log p(x)
    nk: torch.Tensor  # (K,) Σ responsibilities
    sx: torch.Tensor  # (K, d) Σ r·x
    sxx: torch.Tensor  # (K, d) Σ r·x²


def _check_gmm(name: str, x, means, variances, weights) -> None:
    _check(name, x, means)
    if variances.shape != means.shape:
        raise ValueError(f"{name}: variances {tuple(variances.shape)} must "
                         f"match means {tuple(means.shape)}")
    if weights.shape != (means.shape[0],):
        raise ValueError(f"{name}: weights {tuple(weights.shape)} must be "
                         f"({means.shape[0]},)")
    for what, t in (("variances", variances), ("weights", weights)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 {what} only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: x on {x.device}, {what} on {t.device}")


def _operands(means, variances, weights):
    """(−½/σ² (K, d), μ/σ² (K, d), bias (K,)) in f32, from 1/σ², μ/σ² and
    bias = −½(Σμ²/σ² + Σlog σ² + d·log 2π) + log π as the JAX wrapper
    computes them in XLA. The −½ scaling is exact, so x²·(−½/σ²) is the
    reference's −½·(x²·(1/σ²))."""
    d = means.shape[1]
    inv = 1.0 / variances
    muinv = means * inv
    bias = -0.5 * ((means * means * inv).sum(dim=1)
                   + torch.log(variances).sum(dim=1) + d * _LOG_2PI
                   ) + torch.log(weights)
    return (-0.5 * inv).contiguous(), muinv.contiguous(), bias.contiguous()


def gmm_stats_fused_plain(x: torch.Tensor, means: torch.Tensor,
                          variances: torch.Tensor,
                          weights: torch.Tensor) -> GMMStats:
    """Plain version of B9, over row blocks of at most _PLAIN_TILE_ELEMS
    (rows, K) elements, so no (N, K) buffer exists. Log-probs and
    responsibilities are f32 as in the kernel; the four sums are taken in
    f64 and rounded once, so the plain version is the accurate side of the
    kernel check."""
    k, d = means.shape
    nv, muinv, bias = _operands(means, variances, weights)
    f64 = torch.float64
    ll = torch.zeros((), dtype=f64, device=x.device)
    nk = torch.zeros(k, dtype=f64, device=x.device)
    sx = torch.zeros((k, d), dtype=f64, device=x.device)
    sxx = torch.zeros((k, d), dtype=f64, device=x.device)
    rows = max(1, _PLAIN_TILE_ELEMS // k)
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        xsq = xb * xb
        logp = xsq @ nv.T + xb @ muinv.T + bias
        norm = torch.logsumexp(logp, dim=1, keepdim=True)
        r = torch.exp(logp - norm)
        rt = r.T.double()
        ll += norm.sum(dtype=f64)
        nk += r.sum(dim=0, dtype=f64)
        sx += rt @ xb.double()
        sxx += rt @ xsq.double()
    return GMMStats(ll_sum=ll.float(), nk=nk.float(), sx=sx.float(),
                    sxx=sxx.float())


def _launch(x, nv, muinv, bias, phases: int = 3) -> GMMStats:
    """B9 on CUDA tensors, one row chunk of the log-prob scratch at a time
    (`row_scratch_plan`): phase 1 (the E-step product on the tensor cores
    and the row logsumexp, writing the chunk's log-probs, its K tiles
    split `phase1_k_splits` ways), then phase 2 (r = exp(logp − norm)
    and the moments on the tensor cores), then the fixed-order sum of the
    partials. `phases` 1 or 2 runs one phase alone,
    for timing them apart (chip_smoke.py); the outputs are then not the
    stats. Counts no launch: `gmm_stats_fused` is the kernel's entry
    point."""
    n, d = x.shape
    k = nv.shape[0]
    dev = x.device
    lib = _build.load().lib
    # One phase-2 CTA per SM, over its (64-component K tile, slice of x
    # and its squares) pairs; two phase-1 CTAs.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rc, kp, grid = row_scratch_plan(n, k, _TC_K_TILE // 2,
                                    -(-d // _D_SLICE), sms)
    splits = phase1_k_splits(rc, k, 2 * sms)
    blocks = -(-n // lib.tdc_gmm_row_block())
    f32, f64 = torch.float32, torch.float64
    scr = torch.empty(rc * kp, dtype=f32, device=dev)
    part = torch.empty(2 * splits * rc, dtype=f32, device=dev)
    norm = torch.empty(max(n, 1), dtype=f32, device=dev)
    ll_part = torch.empty(max(blocks, 1), dtype=f64, device=dev)
    ws = torch.empty((grid, k, 2 * d), dtype=f64, device=dev)
    wpart = torch.empty((grid, k), dtype=f64, device=dev)
    ll_sum = torch.empty((), dtype=f32, device=dev)
    nk = torch.empty(k, dtype=f32, device=dev)
    sx = torch.empty((k, d), dtype=f32, device=dev)
    sxx = torch.empty((k, d), dtype=f32, device=dev)
    _build.check(lib.tdc_gmm_stats(
        x.data_ptr(), nv.data_ptr(), muinv.data_ptr(), bias.data_ptr(), n,
        k, d, rc, kp, grid, splits, scr.data_ptr(), part.data_ptr(),
        norm.data_ptr(), ll_part.data_ptr(), ws.data_ptr(), wpart.data_ptr(),
        ll_sum.data_ptr(), nk.data_ptr(), sx.data_ptr(), sxx.data_ptr(),
        phases, _stream(x),
    ), "gmm_stats_fused")
    return GMMStats(ll_sum=ll_sum, nk=nk, sx=sx, sxx=sxx)


def gmm_stats_fused(x: torch.Tensor, means: torch.Tensor,
                    variances: torch.Tensor,
                    weights: torch.Tensor) -> GMMStats:
    """B9: the diag-GMM E-step stats (ll_sum (), nk (K,), sx = Σr·x (K, d),
    sxx = Σr·x² (K, d)) in f32, with no (N, K) buffer. Takes every
    (K, d)."""
    _check_gmm("gmm_stats_fused", x, means, variances, weights)
    if x.device.type == "cpu":
        return gmm_stats_fused_plain(x, means, variances, weights)
    out = _launch(x, *_operands(means, variances, weights))
    gmm_stats_fused.launches += 1
    return out


gmm_stats_fused.launches = 0


def gmm_stats_for(k: int, d: int, *, label: str = ""):
    """The kernel route's E-step stats function for (K, d): B9 at every
    (K, d), since its two phases have no K·d limit. One `kernel_selected`
    event names the choice; a fit asks once and reuses the function."""
    emit("kernel_selected", kernel="fused", model="gmm", k=int(k), d=int(d),
         reason=("two-phase fused E-step kernel (row logsumexp, then "
                 "K-tiled accumulate): no (N, K) buffer and no K·d limit"),
         label=label or "gmm_stats_auto")
    return gmm_stats_fused
