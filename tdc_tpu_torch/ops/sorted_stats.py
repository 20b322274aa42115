"""Sort-based cluster sufficient statistics and the B3 and B12 kernels
(counterpart: tdc_tpu/ops/sorted_stats.py).

Sort the points by label and every cluster's rows form one contiguous run
of the sorted order; Σx per cluster is then a segmented row sum over those
runs — N·d adds, instead of the dense one-hot contraction's 2·N·K·d FLOPs.
The sort, the run boundaries and the counts stay plain PyTorch
(`torch.sort(stable=True)`, `torch.searchsorted`), as the JAX wrapper
keeps them in XLA. The segmented sum is B3 (`segment_sums`,
`csrc/segment_sums.cu`), the counterpart of `_windowed_stats_pallas`, over
the rows gathered into sorted order; with `fuse_gather=True` it is B12
(`gathered_segment_sums`, the same source), the counterpart of
`_gathered_windowed_stats_pallas`, which reads the unsorted rows through
the sort permutation itself, so no gathered copy is made. No entry point
of the JAX package passes `fuse_gather=True`, and none here does: its
default stays False.

The JAX kernel numbers the runs by dense rank and writes them into
(B, 2B) windows because a TPU kernel walks fixed-size blocks in grid
order; the wrapper then gathers rank → label and zeroes absent labels.
On Hopper the kernel cuts the sorted rows into fixed chunks, one CTA
each; a CTA sums each short run that starts in its chunk whole, and a
long run is summed from its per-chunk partials in a second pass, so the
runs need no windows and are indexed by label
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
widened to f32, which is exact (B12 reads the bf16 rows and widens them
in registers). Under kernel="pallas_bf16" past the fused limit the
routes run at the rows' own precision, as in the JAX package
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


def _check_starts(name: str, starts: torch.Tensor, rows: torch.Tensor,
                  what: str) -> None:
    if starts.dim() != 1 or starts.dtype != torch.int32 or starts.numel() < 1:
        raise TypeError(f"{name}: starts must be a non-empty 1-D int32 "
                        "tensor")
    if rows.device != starts.device:
        raise ValueError(f"{name}: {what} on {rows.device}, starts on "
                         f"{starts.device}")
    if rows.device.type == "cuda" and not (rows.is_contiguous()
                                           and starts.is_contiguous()):
        raise ValueError(f"{name}: the CUDA kernel needs contiguous inputs")


def _check_segments(xs: torch.Tensor, starts: torch.Tensor) -> None:
    if xs.dim() != 2 or xs.dtype != torch.float32:
        raise TypeError("segment_sums: xs must be a 2-D float32 tensor")
    _check_starts("segment_sums", starts, xs, "xs")


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


def _workspace(rows: torch.Tensor, starts: torch.Tensor):
    """(library, out (S, d), head and tail (chunks, d), meta, S) for B3 or
    B12 over `rows`' N rows: one head and one tail row of partial sums
    and one record of pass 2's bookkeeping per pass-1 chunk of rows, the
    chunk size and record size as the kernel library gives them."""
    (n, d), n_seg = rows.shape, starts.numel() - 1
    lib = _build.load().lib
    chunks = -(-n // lib.tdc_segment_chunk_rows())
    dev = rows.device
    out = torch.empty((n_seg, d), dtype=torch.float32, device=dev)
    head = torch.empty((chunks, d), dtype=torch.float32, device=dev)
    tail = torch.empty((chunks, d), dtype=torch.float32, device=dev)
    meta = torch.empty(chunks * lib.tdc_segment_meta_bytes(),
                       dtype=torch.uint8, device=dev)
    return lib, out, head, tail, meta, n_seg


def _launch_segment_sums(xs: torch.Tensor, starts: torch.Tensor, work,
                         passes: int = 3) -> torch.Tensor:
    """B3's launches on CUDA tensors into the workspace `work` of
    `_workspace`: `passes` 3 runs both passes; 1 or 2 runs one alone on
    the same workspace, for timing them apart (`chip_smoke.py`; pass 2
    reads what pass 1 wrote there). Counts no launch: `segment_sums` is
    the kernel's entry point."""
    lib, out, head, tail, meta, n_seg = work
    _build.check(lib.tdc_segment_sums(
        xs.data_ptr(), starts.data_ptr(), xs.shape[0], n_seg, xs.shape[1],
        head.data_ptr(), tail.data_ptr(), out.data_ptr(), meta.data_ptr(),
        passes, torch.cuda.current_stream(xs.device).cuda_stream,
    ), "segment_sums")
    return out


def segment_sums(xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """B3: per-segment row sums of sorted rows. `starts` (S+1,) int32 is
    nondecreasing within [0, N]; segment s is rows [starts[s],
    starts[s+1]). Each CTA owns a fixed chunk of rows and adds, in row
    order, every short segment that starts there; a long one is cut at
    chunk edges and summed from its per-chunk partials in chunk order:
    deterministic, no atomics, and no CTA waits on a long run. Empty
    segments give zero rows."""
    _check_segments(xs, starts)
    if xs.device.type == "cpu":
        return segment_sums_plain(xs, starts)
    out = _launch_segment_sums(xs, starts, _workspace(xs, starts))
    segment_sums.launches += 1
    return out


segment_sums.launches = 0


def _check_gathered(x: torch.Tensor, order: torch.Tensor,
                    starts: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("gathered_segment_sums: x must be a 2-D float32 or "
                        "bfloat16 tensor")
    if (order.dim() != 1 or order.dtype != torch.int32
            or order.numel() != x.shape[0]):
        raise TypeError("gathered_segment_sums: order must be a 1-D int32 "
                        "tensor with one entry per row of x")
    _check_starts("gathered_segment_sums", starts, x, "x")
    _check_starts("gathered_segment_sums", starts, order, "order")


def gathered_segment_sums_plain(x: torch.Tensor, order: torch.Tensor,
                                starts: torch.Tensor) -> torch.Tensor:
    """Plain version of B12: B3's plain version on x[order] in f32."""
    return segment_sums_plain(x.index_select(0, order).float(), starts)


def gathered_segment_sums(x: torch.Tensor, order: torch.Tensor,
                          starts: torch.Tensor) -> torch.Tensor:
    """B12: out[s] = Σ x[order[p]] for p in [starts[s], starts[s+1]): B3
    on the rows x[order] without gathering them first. x (N, d) is f32 or
    bf16 (read as it is, widened in registers); order (N,) int32 indexes
    its rows. The add order is B3's, so the result is bitwise B3's on
    x.index_select(0, order) widened to f32."""
    _check_gathered(x, order, starts)
    if x.device.type == "cpu":
        return gathered_segment_sums_plain(x, order, starts)
    lib, out, head, tail, meta, n_seg = _workspace(x, starts)
    _build.check(lib.tdc_gathered_segment_sums(
        x.data_ptr(), int(x.dtype == torch.bfloat16), order.data_ptr(),
        starts.data_ptr(), x.shape[0], n_seg, x.shape[1], head.data_ptr(),
        tail.data_ptr(), out.data_ptr(), meta.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    ), "gathered_segment_sums")
    gathered_segment_sums.launches += 1
    return out


gathered_segment_sums.launches = 0


def sorted_cluster_stats(
    x: torch.Tensor, labels: torch.Tensor, k: int, *, pallas: bool = False,
    fuse_gather: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx per cluster (k, d) f32, counts (k,) f32) from per-point labels.
    Labels outside [0, k) are ignored. pallas=True runs the segmented sum
    through B3 (`segment_sums`) on the gathered rows; pallas=False through
    its plain version. fuse_gather=True (with pallas=True only, as in the
    JAX package) runs B12 (`gathered_segment_sums`) on the unsorted rows,
    f32 or bf16, and the sort permutation instead: the same sums, no
    gathered copy."""
    labels = labels.to(torch.int32)
    labels = torch.where((labels >= 0) & (labels < k), labels,
                         torch.full_like(labels, k))
    keys, order = torch.sort(labels, stable=True)
    lo = torch.searchsorted(
        keys, torch.arange(k + 1, dtype=torch.int32, device=x.device))
    counts = (lo[1:] - lo[:-1]).to(torch.float32)
    starts = lo.to(torch.int32)
    if pallas and fuse_gather:
        xg = x if x.dtype == torch.bfloat16 else x.to(torch.float32)
        sums = gathered_segment_sums(xg.contiguous(), order.to(torch.int32),
                                     starts)
        return sums, counts
    xs = x.index_select(0, order).to(torch.float32).contiguous()
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
