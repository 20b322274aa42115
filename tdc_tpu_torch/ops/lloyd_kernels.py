"""The Lloyd kernels B1, B2, B4 and B5 (counterpart:
tdc_tpu/ops/pallas_kernels.py, the `lloyd_stats_fused` (with and without
mxu_dtype="bfloat16"), `distance_argmin`, `lloyd_stats_fused_weighted`,
`lloyd_stats_auto[_weighted]` and `resolve_kernel` parts).

Each kernel has three parts here:

- the wrapper (`distance_argmin`, `lloyd_stats_fused`,
  `lloyd_stats_fused_weighted`, `lloyd_stats_fused_bf16`), which checks its
  inputs, allocates every output and workspace with `torch.empty`, and on
  a CUDA tensor launches the hand-written kernel from
  `csrc/lloyd_kernels.cu` (B5: `csrc/lloyd_bf16_kernels.cu`) on the
  current stream or raises;
- the plain PyTorch version (`*_plain`), the same function with the same
  shifted-distance form ‖c‖² − 2x·c, tie-break (smallest index among equal
  minima) and SSE formula. The wrapper uses it only for a CPU tensor; the
  tests hold it to the JAX package and `chip_smoke.py` holds the kernel to
  it on the card;
- a launch counter, `<wrapper>.launches`, which only the kernel launch
  increments.

The kernels are compute-bound on the H100 at the main path's shapes (the
2·N·K·d distance product: on the TF32 tensor cores as three TF32 products
(3xTF32) for B1, B2 and B4, on the bf16 tensor cores for B5); see the
notes in the sources and PERF.md.

bf16 rows. B5 takes them natively, and it also serves f32 rows under
mxu_dtype="bfloat16" (`kernel="pallas_bf16"`). B2 and B4, like B6, take
bf16 rows widened to f32 (`widened`): the same function as the JAX
kernels on bf16 rows, computed by the f32 kernels.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.ops import _build
from tdc_tpu_torch.ops.assign import SufficientStats
from tdc_tpu_torch.utils import device as _device  # noqa: F401  (f32 policy)
from tdc_tpu_torch.utils.structlog import emit

# B1's route limit. The fused kernels keep one (K, d) f32 partial per CTA
# in device memory (B1, B4 and B5: one CTA per SM, 132 on an H100 SXM).
# K·d up to 2^19 keeps that workspace ≤ 132 · 2^19 · 4 B = 264 MiB,
# and its zeroing and fixed-order reduction under ~1% of the distance work
# at the same K·d. Beyond it lloyd_stats_auto takes the sorted route (B2 +
# B3), whose memory does not grow with K·d.
FUSED_MAX_KD = 1 << 19
# B4 (weighted) is held to K·(d+1) ≤ FUSED_MAX_KD, as the JAX package's
# weighted route is (its accumulator carries the mass as column d).

# Rows per block of B1, B4 (csrc/lloyd_kernels.cu, kTcBM) and B5
# (csrc/lloyd_bf16_kernels.cu, kBM).
_TC_BM = 128

# Rows per block of the plain versions: keeps their (rows, K) distance
# tile at 256 MiB, so they run at the main path's shapes on the card.
_PLAIN_TILE_ELEMS = 1 << 26


# Row dtypes the kernel wrappers take (B1 and B9: float32 only).
ROW_DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, x: torch.Tensor, c: torch.Tensor,
           x_dtypes: tuple = (torch.float32,)) -> None:
    if x.dim() != 2 or c.dim() != 2:
        raise ValueError(f"{name}: x and centroids must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if x.shape[1] != c.shape[1]:
        raise ValueError(f"{name}: x has d={x.shape[1]}, centroids "
                         f"d={c.shape[1]}")
    if c.shape[0] < 1:
        raise ValueError(f"{name}: need at least one centroid")
    if x.dtype not in x_dtypes or c.dtype != torch.float32:
        want = " or ".join(str(t).removeprefix("torch.") for t in x_dtypes)
        raise TypeError(f"{name}: x must be {want} and the centroids "
                        f"float32, got {x.dtype} and {c.dtype}")
    if x.device != c.device:
        raise ValueError(f"{name}: x on {x.device}, centroids on {c.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous()
                                        and c.is_contiguous()):
        raise ValueError(f"{name}: the CUDA kernel needs contiguous inputs")


def widened(x: torch.Tensor, centroids: torch.Tensor):
    """(rows, centroids) for an f32 kernel (B2, B4, B6) given bf16 rows:
    the rows widened to f32, which is exact, and the centroids rounded to
    bf16 and widened, as the JAX wrappers cast the centroids to x.dtype,
    so ‖c‖² comes from the rounded values. f32 rows pass through. The cost
    is one f32 copy of the rows per call."""
    if x.dtype != torch.bfloat16:
        return x, centroids
    return x.float(), centroids.to(torch.bfloat16).float()


def _sq_norms(c: torch.Tensor) -> torch.Tensor:
    """‖c‖² per centroid, f32 — computed outside the kernel as the JAX
    wrappers compute it in XLA."""
    return (c * c).sum(dim=1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _champions_plain(x, c, c2):
    """(labels int32, shifted min f32) over row blocks: argmin of
    ‖c‖² − 2x·c, first (smallest) index among equal minima."""
    n, k = x.shape[0], c.shape[0]
    rows = max(1, _PLAIN_TILE_ELEMS // k)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    mind = torch.empty(n, dtype=torch.float32, device=x.device)
    for s in range(0, n, rows):
        d2 = c2 - 2.0 * (x[s:s + rows] @ c.T)
        m, a = torch.min(d2, dim=1)
        labels[s:s + rows] = a.to(torch.int32)
        mind[s:s + rows] = m
    return labels, mind


def distance_argmin_plain(x, centroids, *, return_dist: bool = False):
    """Plain version of B2: (labels (N,) int32, min (N,) f32)."""
    labels, mind = _champions_plain(x, centroids, _sq_norms(centroids))
    if return_dist:
        mind = torch.clamp_min(mind + (x * x).sum(dim=1), 0.0)
    return labels, mind


def distance_argmin(x: torch.Tensor, centroids: torch.Tensor, *,
                    return_dist: bool = False):
    """B2: (argmin (N,) int32, min squared distance (N,) f32) with no
    (N, K) buffer. Without `return_dist` the distance is the shifted
    ‖c‖² − 2x·c (argmin-valid); with it ‖x‖² is added back and clamped
    at 0 (the kernel scores the champion again in f32: ‖x − c‖², or
    ‖c‖² − 2x·c). The kernel takes `fused_tc_grid` CTAs and a scratch for
    the centroids split into TF32 halves and ‖c‖². bf16 rows run widened
    (`widened`)."""
    _check("distance_argmin", x, centroids, ROW_DTYPES)
    x, centroids = widened(x, centroids)
    if x.device.type == "cpu":
        return distance_argmin_plain(x, centroids, return_dist=return_dist)
    n, d = x.shape
    k = centroids.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    mind = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return labels, mind
    lib = _build.load().lib
    scratch = torch.empty(lib.tdc_lloyd_scratch_floats(k, d),
                          dtype=torch.float32, device=x.device)
    _build.check(lib.tdc_distance_argmin(
        x.data_ptr(), centroids.data_ptr(), n, k, d, int(return_dist),
        fused_tc_grid(x.device, n), scratch.data_ptr(), labels.data_ptr(),
        mind.data_ptr(), _stream(x),
    ), "distance_argmin")
    distance_argmin.launches += 1
    return labels, mind


distance_argmin.launches = 0


def lloyd_stats_fused_plain(x: torch.Tensor, centroids: torch.Tensor, *,
                            return_labels: bool = False):
    """Plain version of B1: champions by the shifted distance, then Σx per
    cluster, counts, and SSE = max(Σ min + Σ‖x‖², 0). With
    `return_labels` also the (N,) int32 champions."""
    k, d = centroids.shape
    c2 = _sq_norms(centroids)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    sse = torch.zeros((), dtype=torch.float32, device=x.device)
    labels = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    rows = max(1, _PLAIN_TILE_ELEMS // k)
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        labels[s:s + rows], mind = _champions_plain(xb, centroids, c2)
        lab = labels[s:s + rows].long()
        sums.index_add_(0, lab, xb)
        counts += torch.bincount(lab, minlength=k).to(torch.float32)
        sse = sse + mind.sum() + (xb * xb).sum()
    stats = SufficientStats(sums=sums, counts=counts,
                            sse=torch.clamp_min(sse, 0.0))
    return (stats, labels) if return_labels else stats


def fused_tc_grid(device: torch.device, n: int) -> int:
    """The CTA count of B1, B2, B4, B5 and B7: one per SM (each takes most
    of its shared memory), no more than there are 128-row blocks, at least
    one."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms, -(-n // _TC_BM)))


def _fused_tc(x: torch.Tensor, centroids: torch.Tensor,
              sample_weight: torch.Tensor | None, return_labels: bool):
    """Launches B1 (sample_weight None) or B4 on CUDA tensors on
    `fused_tc_grid` CTAs; returns (stats, labels or None). The
    scratch: the centroids split into TF32 halves in the layout the kernel
    streams and ‖c‖² (sized by the library), the (grid, K, d) sums and the
    (grid, K) counts (B1, int32) or mass (B4, f32) of each CTA."""
    (n, d), k, dev = x.shape, centroids.shape[0], x.device
    grid = fused_tc_grid(dev, n)
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    scratch = torch.empty(lib.tdc_lloyd_scratch_floats(k, d), **f32)
    ws = torch.empty((grid, k, d), **f32)
    part = (torch.empty((grid, k), dtype=torch.int32, device=dev)
            if sample_weight is None else torch.empty((grid, k), **f32))
    sse_part = torch.empty(grid, dtype=torch.float64, device=dev)
    sums = torch.empty((k, d), **f32)
    counts = torch.empty(k, **f32)
    sse = torch.empty((), **f32)
    labels = (torch.empty(n, dtype=torch.int32, device=dev)
              if return_labels else None)
    head = (x.data_ptr(), centroids.data_ptr())
    if sample_weight is not None:
        head += (sample_weight.data_ptr(),)
    entry = ("tdc_lloyd_stats_fused" if sample_weight is None
             else "tdc_lloyd_stats_fused_weighted")
    _build.check(getattr(lib, entry)(
        *head, n, k, d, grid, scratch.data_ptr(), ws.data_ptr(),
        part.data_ptr(), sse_part.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), sse.data_ptr(),
        None if labels is None else labels.data_ptr(), _stream(x),
    ), entry.removeprefix("tdc_"))
    return SufficientStats(sums=sums, counts=counts, sse=sse), labels


def fused_fits(k: int, d: int) -> bool:
    """Whether B1's (grid, K, d) workspace stays within FUSED_MAX_KD."""
    return k * d <= FUSED_MAX_KD


def lloyd_stats_fused(x: torch.Tensor, centroids: torch.Tensor, *,
                      return_labels: bool = False):
    """B1: Lloyd sufficient stats in one pass over x, no (N, K) buffer.
    Returns SufficientStats(sums (K, d), counts (K,), sse ()) in f32, SSE
    clamped at 0; with `return_labels` also the (N,) int32 champions.
    Raises past the fused limit (use lloyd_stats_auto)."""
    _check("lloyd_stats_fused", x, centroids)
    k, d = centroids.shape
    if not fused_fits(k, d):
        raise ValueError(
            f"lloyd_stats_fused: K·d = {k * d} exceeds FUSED_MAX_KD = "
            f"{FUSED_MAX_KD}; use lloyd_stats_auto (sorted route)"
        )
    if x.device.type == "cpu":
        return lloyd_stats_fused_plain(x, centroids,
                                       return_labels=return_labels)
    stats, labels = _fused_tc(x, centroids, None, return_labels)
    lloyd_stats_fused.launches += 1
    return (stats, labels) if return_labels else stats


lloyd_stats_fused.launches = 0


def _check_weights(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if w.dim() != 1 or w.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: weights must be ({x.shape[0]},), got "
                         f"{tuple(w.shape)}")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: float32 weights only, got {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, weights on {w.device}")
    if x.device.type == "cuda" and not w.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs contiguous weights")


def lloyd_stats_fused_weighted_plain(
        x: torch.Tensor, centroids: torch.Tensor,
        sample_weight: torch.Tensor, *, return_labels: bool = False):
    """Plain version of B4: champions by the shifted distance, then Σw·x
    per cluster, the mass Σw as counts, and SSE = max(Σ w·(min + ‖x‖²),
    0). With `return_labels` also the (N,) int32 champions."""
    k, d = centroids.shape
    c2 = _sq_norms(centroids)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    mass = torch.zeros(k, dtype=torch.float32, device=x.device)
    sse = torch.zeros((), dtype=torch.float32, device=x.device)
    labels = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    rows = max(1, _PLAIN_TILE_ELEMS // k)
    for s in range(0, x.shape[0], rows):
        xb, wb = x[s:s + rows], sample_weight[s:s + rows]
        labels[s:s + rows], mind = _champions_plain(xb, centroids, c2)
        lab = labels[s:s + rows].long()
        sums.index_add_(0, lab, xb * wb[:, None])
        mass.index_add_(0, lab, wb)
        sse = sse + (wb * (mind + (xb * xb).sum(dim=1))).sum()
    stats = SufficientStats(sums=sums, counts=mass,
                            sse=torch.clamp_min(sse, 0.0))
    return (stats, labels) if return_labels else stats


def fused_weighted_fits(k: int, d: int) -> bool:
    """Whether B4 is within its limit, K·(d+1) ≤ FUSED_MAX_KD."""
    return k * (d + 1) <= FUSED_MAX_KD


def lloyd_stats_fused_weighted(x: torch.Tensor, centroids: torch.Tensor,
                               sample_weight: torch.Tensor, *,
                               return_labels: bool = False):
    """B4: weighted Lloyd stats in one pass over x, no (N, K) buffer.
    Returns SufficientStats(sums = Σw·x (K, d), counts = the weight mass
    (K,), sse = Σ w·min d² ()) in f32, SSE clamped at 0; with
    `return_labels` also the (N,) int32 champions. A zero-weight row adds
    nothing. Raises past the fused limit (use lloyd_stats_auto_weighted).
    bf16 rows run widened (`widened`)."""
    _check("lloyd_stats_fused_weighted", x, centroids, ROW_DTYPES)
    _check_weights("lloyd_stats_fused_weighted", x, sample_weight)
    k, d = centroids.shape
    if not fused_weighted_fits(k, d):
        raise ValueError(
            f"lloyd_stats_fused_weighted: K·(d+1) = {k * (d + 1)} exceeds "
            f"FUSED_MAX_KD = {FUSED_MAX_KD}; use lloyd_stats_auto_weighted "
            "(sorted route)"
        )
    x, centroids = widened(x, centroids)
    if x.device.type == "cpu":
        return lloyd_stats_fused_weighted_plain(x, centroids, sample_weight,
                                                return_labels=return_labels)
    stats, labels = _fused_tc(x, centroids, sample_weight, return_labels)
    lloyd_stats_fused_weighted.launches += 1
    return (stats, labels) if return_labels else stats


lloyd_stats_fused_weighted.launches = 0


def _bf16_operands(x: torch.Tensor, centroids: torch.Tensor):
    """(centroids rounded to bf16, ‖c‖² f32) for B5: ‖c‖² of the f32
    centroids for f32 rows, of the rounded ones for bf16 rows (the JAX
    wrapper's `centroids.astype(x.dtype)` before its ‖c‖²)."""
    cb = centroids.to(torch.bfloat16).contiguous()
    return cb, _sq_norms(cb.float() if x.dtype == torch.bfloat16
                         else centroids)


def lloyd_stats_fused_bf16_plain(x: torch.Tensor, centroids: torch.Tensor,
                                 *, return_labels: bool = False):
    """Plain version of B5: champions by c2 − 2·x̃·c̃ᵀ, where x̃ and c̃ are
    the rows and centroids rounded to bf16 (the products of two bf16
    values are exact in f32; the f32 matmul sums them), then Σx of the
    rows at their own dtype (f32 unrounded, bf16 widened), counts, and
    SSE = max(Σ min + Σ‖x‖², 0) with the same rows. With `return_labels`
    also the (N,) int32 champions."""
    k, d = centroids.shape
    cb, c2 = _bf16_operands(x, centroids)
    cr = cb.float()
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    sse = torch.zeros((), dtype=torch.float32, device=x.device)
    labels = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    rows = max(1, _PLAIN_TILE_ELEMS // k)
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows].float()
        lab, mind = _champions_plain(xb.to(torch.bfloat16).float(), cr, c2)
        labels[s:s + rows] = lab
        sums.index_add_(0, lab.long(), xb)
        counts += torch.bincount(lab.long(), minlength=k).to(torch.float32)
        sse = sse + mind.sum() + (xb * xb).sum()
    stats = SufficientStats(sums=sums, counts=counts,
                            sse=torch.clamp_min(sse, 0.0))
    return (stats, labels) if return_labels else stats


def lloyd_stats_fused_bf16(x: torch.Tensor, centroids: torch.Tensor, *,
                           return_labels: bool = False):
    """B5: Lloyd sufficient stats with the distance cross product on bf16
    operands and f32 accumulation (the bf16 tensor cores), in one pass over
    x, no (N, K) buffer. x is f32 (the JAX kernel's mxu_dtype="bfloat16")
    or bf16 (its plain kernel on bf16 inputs; the two are the same
    function there); the centroids are f32. Returns SufficientStats(sums
    (K, d), counts (K,), sse ()) in f32, SSE clamped at 0; Σx and ‖x‖²
    read the rows at their own dtype. With `return_labels` also the (N,)
    int32 champions. Raises past the fused limit (use lloyd_stats_auto)."""
    _check("lloyd_stats_fused_bf16", x, centroids, ROW_DTYPES)
    k, d = centroids.shape
    if not fused_fits(k, d):
        raise ValueError(
            f"lloyd_stats_fused_bf16: K·d = {k * d} exceeds FUSED_MAX_KD = "
            f"{FUSED_MAX_KD}; use lloyd_stats_auto (sorted route)"
        )
    if x.device.type == "cpu":
        return lloyd_stats_fused_bf16_plain(x, centroids,
                                            return_labels=return_labels)
    (n, d), dev = x.shape, x.device
    grid = fused_tc_grid(dev, n)
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load().lib
    scratch = torch.empty(lib.tdc_lloyd_bf16_scratch_floats(k, d), **f32)
    ws = torch.empty((grid, k, d), **f32)
    cnt = torch.empty((grid, k), dtype=torch.int32, device=dev)
    sse_part = torch.empty(grid, dtype=torch.float64, device=dev)
    sums = torch.empty((k, d), **f32)
    counts = torch.empty(k, **f32)
    sse = torch.empty((), **f32)
    labels = (torch.empty(n, dtype=torch.int32, device=dev)
              if return_labels else None)
    cb, c2 = _bf16_operands(x, centroids)
    _build.check(lib.tdc_lloyd_stats_fused_bf16(
        x.data_ptr(), int(x.dtype == torch.bfloat16), cb.data_ptr(),
        c2.data_ptr(), n, k, d, grid, scratch.data_ptr(), ws.data_ptr(),
        cnt.data_ptr(), sse_part.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), sse.data_ptr(),
        None if labels is None else labels.data_ptr(), _stream(x),
    ), "lloyd_stats_fused_bf16")
    lloyd_stats_fused_bf16.launches += 1
    stats = SufficientStats(sums=sums, counts=counts, sse=sse)
    return (stats, labels) if return_labels else stats


lloyd_stats_fused_bf16.launches = 0


def lloyd_stats_for(k: int, d: int, *, dtype: torch.dtype = torch.float32,
                    mxu_dtype: str | None = None, label: str = ""):
    """The kernel route's stats function for (K, d) and the rows' dtype:
    within FUSED_MAX_KD `lloyd_stats_fused` (B1) for f32 rows, or
    `lloyd_stats_fused_bf16` (B5) for bf16 rows or with
    mxu_dtype="bfloat16"; else `lloyd_stats_sorted` (B2 + B3), where
    mxu_dtype is dropped and the rows run at their own precision, as in the
    JAX package. One `kernel_selected` event names the choice and the
    reason; a fit asks once and reuses the function for every
    iteration."""
    from tdc_tpu_torch.ops.sorted_stats import lloyd_stats_sorted

    if mxu_dtype not in (None, "bfloat16"):
        raise ValueError(
            f"lloyd_stats_for: mxu_dtype={mxu_dtype!r} (only 'bfloat16', or "
            "None for full input precision)")
    bf16 = dtype == torch.bfloat16 or mxu_dtype is not None
    if fused_fits(k, d):
        fn, route, reason = lloyd_stats_fused, "fused", (
            f"K·d = {k * d} <= {FUSED_MAX_KD}: the per-CTA (K, d) "
            "workspace of the fused kernel stays bounded")
        if bf16:
            fn, route = lloyd_stats_fused_bf16, "fused_bf16"
            reason += ("; bf16 cross operands on the tensor cores, f32 "
                       "accumulate (" + ("bf16 rows" if mxu_dtype is None
                                         else "mxu_dtype='bfloat16'") + ")")
    else:
        fn, route, reason = lloyd_stats_sorted, "sorted", (
            f"K·d = {k * d} > {FUSED_MAX_KD}: the fused kernel's "
            "workspace would grow past its limit")
        if mxu_dtype is not None and dtype != torch.bfloat16:
            reason += ("; the bf16 epilogue is fused-only, so the sorted "
                       "path runs at full input precision")
    emit("kernel_selected", kernel=route, model="kmeans", k=int(k), d=int(d),
         reason=reason, label=label or "lloyd_stats_auto")
    return fn


def lloyd_stats_auto(x: torch.Tensor,
                     centroids: torch.Tensor) -> SufficientStats:
    """Lloyd stats on the kernel route: B1 (f32 rows) or B5 (bf16 rows)
    where the fused workspace fits, else the sorted path
    (ops/sorted_stats.lloyd_stats_sorted)."""
    return lloyd_stats_for(*centroids.shape, dtype=x.dtype)(x, centroids)


def lloyd_stats_weighted_for(k: int, d: int, *, label: str = ""):
    """The weighted kernel route's stats function for (K, d), called as
    fn(x, centroids, sample_weight): `lloyd_stats_fused_weighted` (B4)
    while K·(d+1) ≤ FUSED_MAX_KD, else `lloyd_stats_sorted_weighted` (B2,
    then B3 over [w·x | w]). One `kernel_selected` event names the choice
    and the reason."""
    from tdc_tpu_torch.ops.sorted_stats import lloyd_stats_sorted_weighted

    if fused_weighted_fits(k, d):
        fn, route, reason = lloyd_stats_fused_weighted, "fused_weighted", (
            f"K·(d+1) = {k * (d + 1)} <= {FUSED_MAX_KD}: the per-CTA "
            "(K, d+1) workspace of the weighted fused kernel stays bounded")
    else:
        fn, route, reason = lloyd_stats_sorted_weighted, "sorted_weighted", (
            f"K·(d+1) = {k * (d + 1)} > {FUSED_MAX_KD}: the weighted fused "
            "kernel's workspace would grow past its limit")
    emit("kernel_selected", kernel=route, model="kmeans_weighted", k=int(k),
         d=int(d), reason=reason, label=label or "lloyd_stats_auto_weighted")
    return fn


def lloyd_stats_auto_weighted(x: torch.Tensor, centroids: torch.Tensor,
                              sample_weight: torch.Tensor) -> SufficientStats:
    """Weighted Lloyd stats on the kernel route: B4 where its workspace
    fits, else the weighted sorted path
    (ops/sorted_stats.lloyd_stats_sorted_weighted)."""
    return lloyd_stats_weighted_for(*centroids.shape)(x, centroids,
                                                      sample_weight)


def resolve_kernel(kernel: str, *, k: int, d: int, device: torch.device,
                   model: str = "kmeans", label: str = "",
                   ineligible: str | None = None,
                   mxu_ineligible: str | None = None,
                   itemsize: int = 4) -> str:
    """The default-kernel policy: 'auto' resolves to 'pallas' (the CUDA
    kernels) on a CUDA device and to 'xla' (plain PyTorch) on the CPU, with
    one `kernel_selected` event; an explicit name passes through. CUDA
    plays the part that platform == 'tpu' plays in the JAX version.
    `model` is 'kmeans', 'kmeans_weighted', 'kmeans_sharded' (the K-sharded
    K-Means tower: B2 + B3 on each shard, `k` its K/P centroids),
    'fuzzy', 'fuzzy_sharded' (the K-sharded fuzzy tower: B7 + B8 on each
    shard) or 'gmm'; every kernel route takes every (K, d). `ineligible` names a caller-side reason the
    kernels cannot apply at all (weighted fuzzy stats run in f32 plain ops;
    the GMM kernel is diag/spherical and unweighted; weights on a mesh):
    auto then resolves to 'xla' with that reason in the event.
    `mxu_ineligible` names one that rules out only the bf16 epilogue (a
    mesh): ':quantized' then takes the plain auto choice.

    'auto:quantized' is auto plus permission to pick 'pallas_bf16' (B5 on
    f32 rows: bf16 cross operands, f32 stats) where it applies: CUDA,
    model='kmeans' (unweighted), f32 rows (itemsize 4: bf16 rows already
    run B5 under 'pallas') and (K, d) within the fused limit. Anywhere
    else it takes the plain auto choice, with the reason in the event,
    never an error."""
    if kernel not in ("auto", "auto:quantized"):
        return kernel
    device = torch.device(device)
    if ineligible is not None:
        choice, reason = "xla", ineligible
    elif device.type == "cuda":
        # The JAX version checks the model only on its accelerator: off it
        # every model resolves to 'xla'.
        if model not in ("kmeans", "kmeans_weighted", "kmeans_sharded",
                         "fuzzy", "fuzzy_sharded", "gmm"):
            raise ValueError(f"resolve_kernel: unknown model {model!r}")
        choice, reason = "pallas", (
            f"CUDA device: the hand-written {model} kernels apply at any "
            f"(K={k}, d={d})")
    else:
        choice, reason = "xla", (
            f"device={device.type}: the kernels are CUDA-only; plain "
            "PyTorch ops run instead")
    if kernel == "auto:quantized" and choice == "pallas":
        if model != "kmeans":
            reason += (f"; bf16 epilogue declined: it is unweighted "
                       f"kmeans-fused only (model={model})")
        elif mxu_ineligible is not None:
            reason += f"; bf16 epilogue declined: {mxu_ineligible}"
        elif itemsize != 4:
            reason += ("; bf16 epilogue declined: the rows are not f32, and "
                       "bf16 rows already run it under 'pallas'")
        elif not fused_fits(k, d):
            reason += (f"; bf16 epilogue declined: K·d = {k * d} is past "
                       "the fused limit, where the sorted path runs at full "
                       "input precision")
        else:
            choice = "pallas_bf16"
            reason += ("; :quantized accepted: bf16 cross operands on the "
                       "tensor cores, f32 accumulate and f32 stats")
    emit("kernel_selected", kernel=choice, model=model, k=int(k), d=int(d),
         reason=reason, label=label)
    return choice
