"""Sort-based cluster sufficient statistics and the B3 kernel
(counterpart: tdc_tpu/ops/sorted_stats.py).

Sort the points by label and every cluster's rows form one contiguous run
of the sorted order; Σx per cluster is then a segmented row sum over those
runs — N·d adds, instead of the dense one-hot contraction's 2·N·K·d FLOPs.
The sort, the run boundaries and the counts stay plain PyTorch
(`torch.sort(stable=True)`, `torch.searchsorted`), as the JAX wrapper
keeps them in XLA. The segmented sum is B3 (`segment_sums`,
`csrc/segment_sums.cu`), the counterpart of `_windowed_stats_pallas`.

The JAX kernel numbers the runs by dense rank and writes them into
(B, 2B) windows because a TPU kernel walks fixed-size blocks in grid
order; the wrapper then gathers rank → label and zeroes absent labels.
On Hopper the kernel cuts the sorted rows into fixed chunks, one CTA
each, and sums a run that crosses chunks from its per-chunk partials in a
second pass, so the runs need no windows and are indexed by label
directly (run j = rows [lo[j], lo[j+1]) of the sorted order, where lo
comes from the same searchsorted that gives the counts): an absent label
is an empty run, whose sum the kernel writes as zeros, and the rank
gather and mask have nothing left to do. The result equals the JAX
package's (K, d) sums.

The weighted route (`lloyd_stats_sorted_weighted`) sorts [w·x | w]
(N, d+1) instead of x: B3 then gives Σw·x in the first d columns and the
weight mass in the last, with no kernel of its own.

bf16 rows take both routes widened: B2 on the rows widened to f32 with
the centroids rounded to bf16 (`lloyd_kernels.widened`, as the JAX
wrapper casts the centroids to x.dtype), and B3 on the gathered rows
widened to f32, which is exact. Under kernel="pallas_bf16" past the fused
limit the routes run at the rows' own precision, as in the JAX package
(`lloyd_kernels.lloyd_stats_for` says so in its event).
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.ops import _build
from tdc_tpu_torch.ops.assign import SufficientStats
from tdc_tpu_torch.ops.lloyd_kernels import distance_argmin


def sorted_counts(sorted_labels: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) f32 occurrence counts of 0..k-1 in an ascending label array,
    via k+1 binary searches."""
    q = torch.arange(k + 1, dtype=sorted_labels.dtype,
                     device=sorted_labels.device)
    lo = torch.searchsorted(sorted_labels, q)
    return (lo[1:] - lo[:-1]).to(torch.float32)


def _check_segments(xs: torch.Tensor, starts: torch.Tensor) -> None:
    if xs.dim() != 2 or xs.dtype != torch.float32:
        raise TypeError("segment_sums: xs must be a 2-D float32 tensor")
    if starts.dim() != 1 or starts.dtype != torch.int32 or starts.numel() < 1:
        raise TypeError("segment_sums: starts must be a non-empty 1-D int32 "
                        "tensor")
    if xs.device != starts.device:
        raise ValueError(f"segment_sums: xs on {xs.device}, starts on "
                         f"{starts.device}")
    if xs.device.type == "cuda" and not (xs.is_contiguous()
                                         and starts.is_contiguous()):
        raise ValueError("segment_sums: the CUDA kernel needs contiguous "
                         "inputs")


def segment_sums_plain(xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Plain version of B3: out[s] = Σ xs[starts[s]:starts[s+1]] (S, d)."""
    n_seg = starts.numel() - 1
    lengths = (starts[1:] - starts[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=xs.device), lengths)
    lo = int(starts[0])
    out = torch.zeros((n_seg, xs.shape[1]), dtype=torch.float32,
                      device=xs.device)
    return out.index_add_(0, seg, xs[lo:lo + seg.numel()])


def segment_sums(xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """B3: per-segment row sums of sorted rows. `starts` (S+1,) int32 is
    nondecreasing within [0, N]; segment s is rows [starts[s],
    starts[s+1]). Each CTA owns a fixed chunk of rows and adds every run
    in it in row order; a run that crosses chunks is summed from its
    per-chunk partials in chunk order: deterministic, no atomics, and no
    CTA waits on a long run. Empty segments give zero rows."""
    _check_segments(xs, starts)
    if xs.device.type == "cpu":
        return segment_sums_plain(xs, starts)
    (n, d), n_seg = xs.shape, starts.numel() - 1
    lib = _build.load().lib
    chunks = -(-n // lib.tdc_segment_chunk_rows())
    out = torch.empty((n_seg, d), dtype=torch.float32, device=xs.device)
    head = torch.empty((chunks, d), dtype=torch.float32, device=xs.device)
    tail = torch.empty((chunks, d), dtype=torch.float32, device=xs.device)
    _build.check(lib.tdc_segment_sums(
        xs.data_ptr(), starts.data_ptr(), n, n_seg, d, head.data_ptr(),
        tail.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(xs.device).cuda_stream,
    ), "segment_sums")
    segment_sums.launches += 1
    return out


segment_sums.launches = 0


def sorted_cluster_stats(
    x: torch.Tensor, labels: torch.Tensor, k: int, *, pallas: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx per cluster (k, d) f32, counts (k,) f32) from per-point labels.
    Labels outside [0, k) are ignored. pallas=True runs the segmented sum
    through B3 (`segment_sums`); pallas=False through its plain version."""
    labels = labels.to(torch.int32)
    labels = torch.where((labels >= 0) & (labels < k), labels,
                         torch.full_like(labels, k))
    keys, order = torch.sort(labels, stable=True)
    lo = torch.searchsorted(
        keys, torch.arange(k + 1, dtype=torch.int32, device=x.device))
    counts = (lo[1:] - lo[:-1]).to(torch.float32)
    xs = x.index_select(0, order).to(torch.float32).contiguous()
    starts = lo.to(torch.int32)
    sums = (segment_sums if pallas else segment_sums_plain)(xs, starts)
    return sums, counts


def lloyd_stats_sorted(x: torch.Tensor,
                       centroids: torch.Tensor) -> SufficientStats:
    """Lloyd sufficient stats for large K·d: B2 (`distance_argmin`, true
    min distances) then the sort-based stats with B3."""
    arg, mind = distance_argmin(x, centroids, return_dist=True)
    sums, counts = sorted_cluster_stats(x, arg, centroids.shape[0],
                                        pallas=True)
    return SufficientStats(sums=sums, counts=counts, sse=mind.sum())


def lloyd_stats_sorted_weighted(x: torch.Tensor, centroids: torch.Tensor,
                                sample_weight: torch.Tensor) -> SufficientStats:
    """Weighted Lloyd stats for large K·d: B2 (true min distances; the
    argmin does not depend on w), then the sort-based stats with B3 over
    [w·x | w]. Returns SufficientStats(sums = Σw·x, counts = the weight
    mass, sse = Σ w·min d²). Zero-weight rows add nothing."""
    k, d = centroids.shape
    arg, mind = distance_argmin(x, centroids, return_dist=True)
    w = sample_weight.float()
    xw = torch.cat([x.float() * w[:, None], w[:, None]], dim=1)
    ext, _ = sorted_cluster_stats(xw, arg, k, pallas=True)
    return SufficientStats(sums=ext[:, :d].contiguous(),
                           counts=ext[:, d].contiguous(),
                           sse=(w * mind).sum())
