"""The feature-major kernels B10 and B11 (counterpart: tdc_tpu/ops/tall.py,
`lloyd_stats_tall`, `fuzzy_stats_tall` and `tall_block_n`).

The points come as xt (d, N), f32 or bf16; the centroids as (K, d) f32.
The layout exists in the JAX package because a TPU pads a sample-major
(N, d) buffer's minor axis to 128 lanes, a 25.6× blow-up at d = 5. A GPU
does not pad, so here the layout is API parity: `layout="features"`,
`--layout=features` and `*.fm.npy` files run on these kernels.

As in `ops/lloyd_kernels.py`, each kernel has three parts here:

- the wrapper (`lloyd_stats_tall`, `fuzzy_stats_tall`), which checks its
  inputs, allocates every output and workspace with `torch.empty`, and on
  a CUDA tensor launches the hand-written kernel from
  `csrc/tall_kernels.cu` on the current stream or raises;
- the plain PyTorch version (`*_plain`), the same function with the same
  formula (d² = max((‖x‖² − 2·c·x) + ‖c‖², 0) per column, the smallest
  index among equal minima; for fuzzy u = (d² + eps)^(−1/(m−1))
  normalised over K, μ = u^m). The wrapper uses it only for a CPU tensor;
  the tests hold it to the JAX package and `chip_smoke.py` holds the
  kernel to it on the card;
- a launch counter, `<wrapper>.launches`, which only the kernel launch
  increments.

bf16 columns take the centroids rounded to bf16, and ‖c‖² of the rounded
values, as the JAX wrappers cast the centroids to the columns' dtype; the
products c·x are then exact in f32.

`tall_block_n` is the JAX package's VMEM sizing rule, kept only as the
error contract: where it gives 0 the JAX functions raise, and so do these,
with the same words. The kernels themselves take every shape below that
limit and size themselves for the card.

B10 has two forms (csrc/tall_kernels.cu). Its streaming form (d <= 8 and
K·(d+1) <= LLOYD_MAX_ENTRIES) runs one persistent CTA per SM that streams
column tiles through a ring of shared-memory slots; its plan
(`lloyd_plan`, `lloyd_grid`) is made here and checked by the kernel's
entry point, which refuses a plan that does not fit. Every other
shape takes the tile form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tdc_tpu_torch.ops import _build
from tdc_tpu_torch.ops.assign import FuzzyStats, SufficientStats
from tdc_tpu_torch.ops.fuzzy_kernels import _check_m
from tdc_tpu_torch.ops.lloyd_kernels import (
    _PLAIN_TILE_ELEMS,
    ROW_DTYPES,
    _stream,
)


def tall_block_n(
    k: int,
    d: int,
    itemsize: int = 4,
    *,
    temps: int = 3,
    budget: int = 10 << 20,
    cap: int = 1 << 15,
) -> int:
    """The JAX package's N-block for the tall kernels: the largest multiple
    of 128 (at most `cap`) whose VMEM footprint fits `budget`, or 0 where
    even 128 columns do not fit. A copy of the reference's model (resident
    (K_s, d8) accumulators and centroid tile, plus `temps` (K_s, BN) f32
    temporaries and the column tile per point); 0 is where the reference
    raises."""
    k_s = -(-k // 8) * 8
    d8 = -(-d // 8) * 8
    fixed = k_s * max(d8, 128) * (8 + itemsize) + 32 * k_s
    per_col = temps * k_s * 4 + d8 * itemsize + 8
    avail = budget - fixed
    if avail < 128 * per_col:
        return 0
    return int(min(cap, avail // per_col // 128 * 128))


def _check_tall(name: str, xt: torch.Tensor, c: torch.Tensor) -> None:
    if xt.dim() != 2 or c.dim() != 2:
        raise ValueError(f"{name}: xt and centroids must be 2-D, got "
                         f"{tuple(xt.shape)} and {tuple(c.shape)}")
    if xt.shape[0] != c.shape[1]:
        raise ValueError(f"{name}: xt must be (d, N) with d = "
                         f"{c.shape[1]} (the centroids' width), got "
                         f"{tuple(xt.shape)}")
    if c.shape[0] < 1:
        raise ValueError(f"{name}: need at least one centroid")
    if xt.dtype not in ROW_DTYPES or c.dtype != torch.float32:
        raise TypeError(f"{name}: xt must be float32 or bfloat16 and the "
                        f"centroids float32, got {xt.dtype} and {c.dtype}")
    if xt.device != c.device:
        raise ValueError(f"{name}: xt on {xt.device}, centroids on "
                         f"{c.device}")
    if xt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {xt.device}")
    if xt.device.type == "cuda" and not xt.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs contiguous xt")


def _check_limit(name: str, xt: torch.Tensor, k: int, temps: int) -> None:
    """The reference's error contract (see `tall_block_n`)."""
    if tall_block_n(k, xt.shape[0], xt.element_size(), temps=temps) == 0:
        raise ValueError(
            f"{name}: K={k} too large for VMEM; use the "
            "sample-major kernels (tall layout only wins at small d)"
        )


def _operands(xt: torch.Tensor, centroids: torch.Tensor):
    """(centroids as the kernel sees them, f32 and contiguous; their ‖c‖²):
    rounded to bf16 for bf16 columns, as they are for f32 columns."""
    c = centroids
    if xt.dtype == torch.bfloat16:
        c = c.to(torch.bfloat16).float()
    c = c.contiguous()
    return c, (c * c).sum(dim=1)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _grid(n: int, device: torch.device) -> int:
    """B11's and B10's tile form's CTAs (csrc `tdc_tall_grid`)."""
    return _build.load().lib.tdc_tall_grid(n, _sms(device))


# B10's streaming form, as csrc/tall_kernels.cu lays it out: 8 or 12
# consumer warps whose threads take 4 adjacent columns each of a tile of
# 128·warps columns; a CTA's shared memory holds the slots' mbarriers
# (LLOYD_MAX_SLOTS pairs), the centroids and their ‖c‖² (K rounded up to
# 4), one f64 SSE a consumer thread, each consumer thread's (K, d+1)
# accumulator, then (at a 128-byte boundary) the ring: slots of d rows of
# a tile's elements and 16 bytes.
LLOYD_WARPS = (12, 8)  # the widest that fits first
LLOYD_MAX_ENTRIES = 144  # K·(d+1), with d <= 8
LLOYD_MAX_SLOTS = 16
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may take on sm_90


class LloydPlan(NamedTuple):
    """B10's streaming form: consumer warps and ring slots; (0, 0) for
    the tile form."""
    warps: int
    slots: int

    @property
    def tile_cols(self) -> int:
        return 128 * self.warps


def lloyd_smem(k: int, d: int, slots: int, itemsize: int,
               warps: int) -> int:
    """Bytes of shared memory of B10's streaming form."""
    threads = 32 * warps
    kp4 = -(-k // 4) * 4
    head = (2 * LLOYD_MAX_SLOTS * 8 + (d + 1) * kp4 * 4 + threads * 8
            + k * (d + 1) * threads * 4)
    ring = -(-head // 128) * 128
    return ring + slots * d * (4 * threads * itemsize + 16)


def lloyd_plan(k: int, d: int, itemsize: int) -> LloydPlan:
    """B10's form at (K, d): the tile form (d > 8 or K·(d+1) >
    LLOYD_MAX_ENTRIES; at that limit the 8-warp form's accumulators still
    leave two slots and 32 KiB of f32 columns at every d), else the
    streaming form with the most consumer warps whose accumulators leave
    room for a ring of at least two slots and 32 KiB of columns, and as
    many slots as then fit, at most LLOYD_MAX_SLOTS."""
    if d > 8 or k * (d + 1) > LLOYD_MAX_ENTRIES:
        return LloydPlan(0, 0)
    for warps in LLOYD_WARPS:
        tile_bytes = d * 128 * warps * itemsize
        least = max(2, -(-(32 << 10) // tile_bytes))
        if lloyd_smem(k, d, least, itemsize, warps) <= SMEM_LIMIT:
            break
    slot = tile_bytes + 16 * d
    slots = (SMEM_LIMIT - lloyd_smem(k, d, 0, itemsize, warps)) // slot
    return LloydPlan(warps, min(LLOYD_MAX_SLOTS, slots))


def lloyd_grid(n: int, sms: int, plan: LloydPlan) -> int:
    """CTAs (workspace rows) of B10's streaming form: one per SM, at most
    one per tile, at least 1."""
    return max(1, min(sms, -(-n // plan.tile_cols)))


def _column_d2(xb: torch.Tensor, c: torch.Tensor, c2: torch.Tensor):
    """(K, cols) d² = max((‖x‖² − 2·c·x) + ‖c‖², 0) of f32 columns."""
    x2 = (xb * xb).sum(dim=0)
    return torch.clamp_min(x2 - 2.0 * (c @ xb) + c2[:, None], 0.0)


def lloyd_stats_tall_plain(xt: torch.Tensor, centroids: torch.Tensor, *,
                           return_labels: bool = False):
    """Plain version of B10, over column blocks of at most
    _PLAIN_TILE_ELEMS (K, cols) elements: champions by d² (first index
    among equal minima), then Σx per cluster, counts, and SSE = Σ of the
    clamped minima, clamped at 0. Σx and the SSE are taken in f64 and
    rounded once (an f32 `index_add_` of 10^8 columns drifts past the
    kernel check's tolerance on the card), so the plain version is the
    accurate side of that check. With `return_labels` also the (N,) int32
    champions."""
    k, d = centroids.shape
    c, c2 = _operands(xt, centroids)
    n = xt.shape[1]
    sums = torch.zeros((k, d), dtype=torch.float64, device=xt.device)
    counts = torch.zeros(k, dtype=torch.int64, device=xt.device)
    sse = torch.zeros((), dtype=torch.float64, device=xt.device)
    labels = torch.empty(n, dtype=torch.int32, device=xt.device)
    cols = max(1, _PLAIN_TILE_ELEMS // k)
    for s in range(0, n, cols):
        xb = xt[:, s:s + cols].float()
        mind, lab = torch.min(_column_d2(xb, c, c2), dim=0)
        labels[s:s + cols] = lab.to(torch.int32)
        sums.index_add_(0, lab, xb.T.double())
        counts += torch.bincount(lab, minlength=k)
        sse += mind.sum(dtype=torch.float64)
    stats = SufficientStats(sums=sums.float(), counts=counts.float(),
                            sse=torch.clamp_min(sse, 0.0).float())
    return (stats, labels) if return_labels else stats


def _launch_lloyd(xt: torch.Tensor, centroids: torch.Tensor,
                  return_labels: bool = False, stream_only: bool = False):
    """B10 on CUDA tensors: (SufficientStats, labels or None). stream_only
    (streaming form only): the kernel takes the columns and adds Σx² to
    the SSE, nothing else (its stats are not B10's): the time of its
    memory path."""
    d, n = xt.shape
    k = centroids.shape[0]
    dev = xt.device
    plan = lloyd_plan(k, d, xt.element_size())
    grid = lloyd_grid(n, _sms(dev), plan) if plan.warps else _grid(n, dev)
    # the streaming form's partial sums stay f64 until one rounding
    ws = torch.empty((grid, k, d), device=dev, dtype=torch.float64
                     if plan.warps else torch.float32)
    cnt = torch.empty((grid, k), dtype=torch.int32, device=dev)
    sse_part = torch.empty(grid, dtype=torch.float64, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    sse = torch.empty((), dtype=torch.float32, device=dev)
    labels = (torch.empty(n, dtype=torch.int32, device=dev)
              if return_labels else None)
    c, c2 = _operands(xt, centroids)
    _build.check(_build.load().lib.tdc_tall_lloyd_stats(
        xt.data_ptr(), int(xt.dtype == torch.bfloat16), c.data_ptr(),
        c2.data_ptr(), n, k, d, grid, plan.warps, plan.slots,
        int(stream_only),
        ws.data_ptr(), cnt.data_ptr(), sse_part.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), sse.data_ptr(),
        None if labels is None else labels.data_ptr(), _stream(xt),
    ), "lloyd_stats_tall")
    return SufficientStats(sums=sums, counts=counts, sse=sse), labels


def lloyd_stats_tall(xt: torch.Tensor, centroids: torch.Tensor, *,
                     return_labels: bool = False):
    """B10: Lloyd sufficient stats over feature-major points xt (d, N) in
    one pass, no (K, N) buffer. Returns SufficientStats(sums (K, d), counts
    (K,), sse ()) in f32, equal to the sample-major stats of xt.T; with
    `return_labels` also the (N,) int32 champions. Raises where the JAX
    package's `lloyd_stats_tall` does (K past its VMEM limit)."""
    _check_tall("lloyd_stats_tall", xt, centroids)
    k = centroids.shape[0]
    _check_limit("lloyd_stats_tall", xt, k, temps=3)
    if xt.device.type == "cpu":
        return lloyd_stats_tall_plain(xt, centroids,
                                      return_labels=return_labels)
    stats, labels = _launch_lloyd(xt, centroids, return_labels)
    lloyd_stats_tall.launches += 1
    return (stats, labels) if return_labels else stats


lloyd_stats_tall.launches = 0


def tall_memberships(xb: torch.Tensor, c: torch.Tensor, c2: torch.Tensor,
                     m: float, eps: float = 1e-9):
    """(μ = u^m (K, cols), d² (K, cols)) of f32 columns against the
    centroids as the kernel sees them (`_operands`)."""
    d2 = _column_d2(xb, c, c2)
    inv = (d2 + eps) ** (-1.0 / (m - 1.0))
    return (inv / inv.sum(dim=0, keepdim=True)) ** m, d2


def fuzzy_stats_tall_plain(xt: torch.Tensor, centroids: torch.Tensor,
                           m: float = 2.0, eps: float = 1e-9) -> FuzzyStats:
    """Plain version of B11, over column blocks of at most
    _PLAIN_TILE_ELEMS (K, cols) elements. Memberships are f32 as in the
    kernel; the three sums are taken in f64 and rounded once, so the plain
    version is the accurate side of the kernel check. Objective clamped
    at 0."""
    _check_m("fuzzy_stats_tall_plain", m)
    k, d = centroids.shape
    c, c2 = _operands(xt, centroids)
    wsums = torch.zeros((k, d), dtype=torch.float64, device=xt.device)
    weights = torch.zeros(k, dtype=torch.float64, device=xt.device)
    objective = torch.zeros((), dtype=torch.float64, device=xt.device)
    cols = max(1, _PLAIN_TILE_ELEMS // k)
    for s in range(0, xt.shape[1], cols):
        xb = xt[:, s:s + cols].float()
        mu, d2 = tall_memberships(xb, c, c2, m, eps)
        wsums += mu.double() @ xb.T.double()
        weights += mu.sum(dim=1, dtype=torch.float64)
        objective += (mu * d2).sum(dtype=torch.float64)
    return FuzzyStats(weighted_sums=wsums.float(), weights=weights.float(),
                      objective=torch.clamp_min(objective, 0.0).float())


def fuzzy_stats_tall(xt: torch.Tensor, centroids: torch.Tensor,
                     m: float = 2.0, eps: float = 1e-9) -> FuzzyStats:
    """B11: fuzzy C-means sufficient stats over feature-major points xt
    (d, N), no (K, N) buffer. Returns FuzzyStats(weighted_sums (K, d),
    weights (K,), objective ()) in f32, the objective clamped at 0, equal
    to the sample-major stats of xt.T. Raises where the JAX package's
    `fuzzy_stats_tall` does (K past its VMEM limit)."""
    _check_tall("fuzzy_stats_tall", xt, centroids)
    _check_m("fuzzy_stats_tall", m)
    d, n = xt.shape
    k = centroids.shape[0]
    _check_limit("fuzzy_stats_tall", xt, k, temps=5)
    if xt.device.type == "cpu":
        return fuzzy_stats_tall_plain(xt, centroids, m=m, eps=eps)
    dev = xt.device
    grid = _grid(n, dev)
    ws = torch.empty((grid, k, d), dtype=torch.float32, device=dev)
    wpart = torch.empty((grid, k), dtype=torch.float64, device=dev)
    opart = torch.empty(grid, dtype=torch.float64, device=dev)
    wsums = torch.empty((k, d), dtype=torch.float32, device=dev)
    weights = torch.empty(k, dtype=torch.float32, device=dev)
    objective = torch.empty((), dtype=torch.float32, device=dev)
    c, c2 = _operands(xt, centroids)
    _build.check(_build.load().lib.tdc_tall_fuzzy_stats(
        xt.data_ptr(), int(xt.dtype == torch.bfloat16), c.data_ptr(),
        c2.data_ptr(), n, k, d, -1.0 / (m - 1.0), m, eps, grid,
        ws.data_ptr(), wpart.data_ptr(), opart.data_ptr(), wsums.data_ptr(),
        weights.data_ptr(), objective.data_ptr(), _stream(xt),
    ), "fuzzy_stats_tall")
    fuzzy_stats_tall.launches += 1
    return FuzzyStats(weighted_sums=wsums, weights=weights,
                      objective=objective)


fuzzy_stats_tall.launches = 0
