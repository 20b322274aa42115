"""Lloyd K-Means (counterpart: tdc_tpu/models/kmeans.py).

The JAX package traces the whole loop into one `lax.while_loop`. Here the
loop runs on the host and every iteration's work stays on the device; the
host reads the scalar centroid shift once per iteration, and only when a
tolerance is set. The semantics are the JAX package's:

- tol < 0 runs exactly max_iters iterations;
- the final SSE is recomputed at the returned centroids, so a fit makes
  n_iter + 1 stats calls;
- converged = shift <= max(tol, 0) and n_iter > 0.

Supported: float32 or bfloat16 inputs, kernel in {'xla', 'refined',
'pallas', 'pallas_bf16', 'auto', 'auto:quantized'}, sample weights on
'xla' and 'pallas' (the weighted kernel route: B4, or B2 + B3 past its
limit), layout='features': x is (d, N) and every stats call runs B10
(`ops/tall.py`), with the JAX package's restrictions (no mesh, weights or
relocation; kernel 'xla', meaning unset, or 'tall'), and mesh=: one
process per GPU (`parallel/mesh.py`), every rank passing the same x;
rank 0 seeds and broadcasts the init, each rank takes its block of rows,
and the stats of every iteration are all-reduced over the data axis
(`parallel/reduce.py`), so every rank runs the same loop and returns the
same centroids. The rest raises NotImplementedError naming the ROADMAP.md
item that ports it.

bf16 points stay one 2-byte copy on the device, as in the JAX package.
The plain paths promote them to f32 against f32 centroids. The kernel
route runs B5 (bf16 cross operands, f32 accumulate, stats of the rows at
their own dtype), which also serves f32 points under 'pallas_bf16'; the
other kernels take bf16 rows widened (`ops/lloyd_kernels.widened`). So on
one bf16 dataset 'xla' and 'pallas' give different results, as they do
in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tdc_tpu_torch.data.loader import restore_bf16
from tdc_tpu_torch.models._common import validate_sample_weight
from tdc_tpu_torch.ops.assign import (
    apply_centroid_update,
    assign_clusters,
    lloyd_stats,
    lloyd_stats_padded_blocked,
    lloyd_stats_refined,
    lloyd_stats_weighted,
    lloyd_stats_weighted_blocked,
)
from tdc_tpu_torch.ops.distance import pairwise_sq_dist
from tdc_tpu_torch.ops.init import init_first_k, init_kmeans_pp, init_random
from tdc_tpu_torch.utils.device import resolve_device


# The names of k-means‖ seeding (ops/kmeans_parallel.py).
PARALLEL_INITS = ("kmeans||", "k-means||", "kmeans_parallel")


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (K, d) float32
    n_iter: int  # iterations run
    sse: torch.Tensor  # () float32 — SSE at the returned centroids
    shift: torch.Tensor  # () float32 — last max centroid movement (L2)
    converged: bool
    # (n_iter, 2) numpy [sse, shift] per iteration when history=True: row i
    # is the cost at the iteration's input centroids and its shift.
    history: object = None
    # Iterations executed by THIS fit call (None = same as n_iter).
    n_iter_run: object = None
    # The streamed fits' parallel.reduce.CommsReport (None in memory).
    comms: object = None
    # The streamed fits' data.spill.SpillReport under the spill tier, else
    # None.
    h2d: object = None
    # The streamed fits' data.ingest.IngestReport (read retries,
    # quarantined batches and rows, the dropped share); None in memory.
    ingest: object = None


def _normalize(c: torch.Tensor) -> torch.Tensor:
    return c / torch.clamp_min(torch.linalg.norm(c, dim=-1, keepdim=True),
                               1e-12)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tdc_tpu_torch yet (ROADMAP.md {item})")


def _weighted_stats_fn(kernel: str, block_rows: int, k: int, d: int, w):
    """The weighted stats for kernel 'xla' or 'pallas' (kmeans_fit rejects
    'refined' with weights); 'counts' is the weight mass."""
    if kernel == "pallas":
        # The weighted CUDA kernel route, decided once per fit (one event).
        from tdc_tpu_torch.ops.lloyd_kernels import lloyd_stats_weighted_for

        fn = lloyd_stats_weighted_for(k, d, label="kmeans_fit")
        return lambda x, c: fn(x, c, w)
    if block_rows:
        return lambda x, c: lloyd_stats_weighted_blocked(x, c, w, block_rows)
    return lambda x, c: lloyd_stats_weighted(x, c, w)


def _stats_fn(kernel: str, block_rows: int, k: int, d: int, w=None,
              dtype: torch.dtype = torch.float32):
    if w is not None and kernel in ("xla", "pallas"):
        return _weighted_stats_fn(kernel, block_rows, k, d, w)
    if kernel == "xla":
        if block_rows:
            return lambda x, c: lloyd_stats_padded_blocked(x, c, block_rows)
        return lloyd_stats
    if kernel == "refined":
        if block_rows:
            return lambda x, c: lloyd_stats_padded_blocked(
                x, c, block_rows, lloyd_stats_refined)
        return lloyd_stats_refined
    if kernel in ("pallas", "pallas_bf16"):
        # The CUDA kernel route, decided once per fit (one event): B1 or
        # B5 by the rows' dtype and mxu_dtype, or B2 + B3 past the fused
        # limit.
        from tdc_tpu_torch.ops.lloyd_kernels import lloyd_stats_for

        return lloyd_stats_for(
            k, d, dtype=dtype, label="kmeans_fit",
            mxu_dtype="bfloat16" if kernel == "pallas_bf16" else None)
    if kernel == "tall":
        # B10 over feature-major points; on sample-major points its shape
        # check raises, as the JAX package's tall kernel fails there.
        from tdc_tpu_torch.ops.tall import lloyd_stats_tall

        return lloyd_stats_tall
    raise ValueError(
        f"unknown kernel {kernel!r} (use 'xla', 'refined', 'pallas', "
        "'pallas_bf16' or 'auto')")


def _device_memory_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 << 30


def auto_block_rows(n: int, k: int, *, budget_bytes: int | None = None,
                    device=None) -> int:
    """N-block size so the (block, K) f32 intermediates of the plain stats
    stay within a memory budget; 0 = no blocking needed."""
    if budget_bytes is None:
        budget_bytes = _device_memory_bytes(torch.device(device or "cpu"))
    # Working set ≈ 2 (N, K) f32 buffers (distances + one-hot).
    if 8 * n * k <= 0.3 * budget_bytes:
        return 0
    block = int(0.15 * budget_bytes / (8 * k))
    return max(1 << max(block.bit_length() - 1, 10), 1024)  # pow2, ≥1024


def _blocked_min_dist(x, c, block_rows: int) -> torch.Tensor:
    """(N,) squared distance of every point to its nearest centroid,
    N-blocked so the (block, K) distance tile stays bounded."""
    if not block_rows or x.shape[0] <= block_rows:
        return pairwise_sq_dist(x, c).min(dim=1).values
    return torch.cat([
        pairwise_sq_dist(x[s:s + block_rows], c).min(dim=1).values
        for s in range(0, x.shape[0], block_rows)
    ])


def _relocate_empty(x, new_c, counts, block_rows: int,
                    mesh=None) -> torch.Tensor:
    """sklearn-style empty-cluster relocation: every zero-count centroid is
    replaced by a distinct highest-cost point (largest squared distance to
    its nearest UPDATED centroid); the i-th empty slot takes the i-th
    costliest point. The cost pass runs only when a cluster is empty.

    With `mesh`, x is this rank's rows and `counts` the summed ones, so
    every rank takes the same branch. The costliest rows are taken in
    jax.lax.top_k's order over the global row index (rank-major: the
    ranks hold contiguous blocks): each rank's top min(K, n_local) by a
    stable descending sort, then (cost, global index, row) of every rank
    in one all_reduce of a zero-filled (ranks · m, d + 2) f64 buffer in
    which each rank fills its own slots (adding zeros is exact; gloo on
    CUDA tensors has no all_gather), ordered by cost descending and, among
    equal costs, by global index ascending. Every rank picks the same
    rows, bit for bit."""
    k = new_c.shape[0]
    empty = counts <= 0.0
    if not bool(empty.any()):
        return new_c
    if not block_rows:
        block_rows = auto_block_rows(int(x.shape[0]), k, device=x.device)
    mind = _blocked_min_dist(x, new_c, block_rows)
    # The costliest rows in jax.lax.top_k's order: descending cost, the
    # lower index first among equal costs (a stable sort; torch.topk gives
    # no order among equal values).
    top = torch.sort(mind, descending=True, stable=True).indices[
        :min(k, x.shape[0])]
    cand = x[top].to(torch.float32)
    if mesh is not None:
        cand = _global_candidates(x, mind[top], top, cand, k, mesh)
    rank = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0,
                       cand.shape[0] - 1)
    return torch.where(empty[:, None], cand[rank], new_c)


def _global_candidates(x, cost, top, cand, k: int, mesh) -> torch.Tensor:
    """The (min(K, N), d) f32 rows of the global top-K costs, in top_k's
    order, from every rank's local top (see `_relocate_empty`)."""
    from tdc_tpu_torch.parallel.mesh import data_axes, data_index

    # kmeans_fit(mesh=) takes N divisible by the ranks: equal blocks.
    index, count = data_index(mesh)
    n_local = x.shape[0]
    m = min(k, n_local)
    buf = torch.zeros((count * m, x.shape[1] + 2), dtype=torch.float64,
                      device=x.device)
    slot = buf[index * m:(index + 1) * m]
    slot[:, 0] = cost
    slot[:, 1] = (top + index * n_local).to(torch.float64)
    slot[:, 2:] = cand
    mesh.psum(buf, *data_axes(mesh))
    # Cost descending, the global index ascending among equal costs: a
    # stable sort by cost of the candidates in index order.
    by_index = torch.sort(buf[:, 1], stable=True).indices
    order = by_index[torch.sort(buf[by_index, 0], descending=True,
                                stable=True).indices]
    return buf[order[:min(k, n_local * count)], 2:].to(torch.float32)


def _lloyd_loop(
    x: torch.Tensor,
    init_centroids: torch.Tensor,
    max_iters: int,
    tol: float,
    spherical: bool,
    kernel: str = "xla",
    block_rows: int = 0,
    history: bool = False,
    empty_policy: str = "keep",
    w: torch.Tensor | None = None,
    mesh=None,
) -> KMeansResult:
    """The Lloyd iteration. tol < 0 disables the convergence test;
    history=True records (sse, shift) per iteration on the device. `w`
    (sample weights) routes to the weighted stats; 'relocate' then reads
    the weight mass. With `mesh`, x (and w) are this rank's rows and the
    stats are summed over the data axis, so the shift, and with it every
    branch, is the same on every rank."""
    stats_fn = _stats_fn(kernel, block_rows, *init_centroids.shape, w=w,
                         dtype=x.dtype)
    if mesh is not None:
        from tdc_tpu_torch.parallel.reduce import reduced_tree_stats

        stats_fn = reduced_tree_stats(mesh, stats_fn)
    c = init_centroids.to(torch.float32)
    if spherical:
        c = _normalize(c)
    hist = (torch.full((max_iters, 2), float("nan"), device=x.device)
            if history else None)
    shift = torch.tensor(float("inf"), device=x.device)
    n_iter = 0
    while n_iter < max_iters:
        stats = stats_fn(x, c)
        new_c = apply_centroid_update(stats, c)
        if spherical:
            new_c = _normalize(new_c)
        if empty_policy == "relocate":
            new_c = _relocate_empty(x, new_c, stats.counts, block_rows,
                                    mesh)
            if spherical:
                new_c = _normalize(new_c)
        shift = torch.linalg.norm(new_c - c, dim=-1).max()
        if history:
            hist[n_iter, 0] = stats.sse
            hist[n_iter, 1] = shift
        c = new_c
        n_iter += 1
        if tol >= 0 and not float(shift) > tol:
            break
    # The loop's SSE is measured before the last update: recompute it once
    # so the reported SSE matches the returned centroids.
    final_sse = stats_fn(x, c).sse
    return KMeansResult(
        centroids=c,
        n_iter=n_iter,
        sse=final_sse,
        shift=shift,
        converged=bool(float(shift) <= max(tol, 0.0) and n_iter > 0),
        history=hist[:n_iter].cpu().numpy() if history else None,
    )


def _check_generator(generator, x: torch.Tensor) -> None:
    if generator.device.type != x.device.type:
        raise ValueError(
            f"the generator lives on {generator.device}, the points on "
            f"{x.device}; seed a generator on the points' device")


def resolve_init(x: torch.Tensor, k: int, init, generator,
                 sample_weight=None) -> torch.Tensor:
    """Turn an init spec ('first_k' | 'random' | 'kmeans++' | 'kmeans||'
    | array) into (K, d) float32 centroids on x's device. With
    sample_weight the stochastic inits draw ∝ w ('random', the first
    k-means++ center) or ∝ w·D² (later k-means++ rounds, k-means‖
    oversampling), so zero-weight points never seed."""
    if not isinstance(init, str):
        c = torch.as_tensor(np.asarray(init) if not isinstance(
            init, torch.Tensor) else init).to(x.device, torch.float32)
        if c.shape[0] != k:
            raise ValueError(
                f"init centroids have {c.shape[0]} rows, expected K={k}")
        return c
    if init == "first_k":
        return init_first_k(x, k)
    _check_generator(generator, x)
    if init == "random":
        return init_random(generator, x, k, sample_weight)
    if init in ("kmeans++", "k-means++"):
        return init_kmeans_pp(generator, x, k, sample_weight)
    if init in PARALLEL_INITS:
        from tdc_tpu_torch.ops.kmeans_parallel import init_kmeans_parallel

        return init_kmeans_parallel(generator, x, k,
                                    sample_weight=sample_weight)
    raise ValueError(f"unknown init: {init!r}")


def resolve_init_replicated(x: torch.Tensor, k: int, init, generator,
                            mesh, sample_weight=None) -> torch.Tensor:
    """resolve_init for a mesh: a stochastic init is drawn on rank 0 alone
    and broadcast (JAX: the init replicated over the mesh), so the ranks'
    generators need not agree. Explicit arrays, 'first_k' and every
    refusal resolve on every rank alike, so no rank raises alone and
    leaves the others waiting in the broadcast."""
    from tdc_tpu_torch.parallel.mesh import replicate
    from tdc_tpu_torch.parallel.multihost import process_index

    drawn = isinstance(init, str) and init in ("random", "kmeans++",
                                               "k-means++", *PARALLEL_INITS)
    if drawn and process_index() != 0:
        _check_generator(generator, x)
        if init == "random" and k > x.shape[0]:
            raise ValueError(
                f"cannot draw k={k} distinct rows from N={x.shape[0]}")
        c = torch.empty((k, x.shape[1]), dtype=torch.float32,
                        device=x.device)
    else:
        c = resolve_init(x, k, init, generator, sample_weight)
    return replicate(c, mesh)


def _as_points(x, device: torch.device, shape: str = "(N, d)"
               ) -> torch.Tensor:
    """2-D points on `device` ((N, d), or (d, N) in the features layout):
    bfloat16 stays bfloat16 (a numpy array of ml_dtypes' bfloat16 too,
    without importing it), any other float type becomes float32."""
    x = torch.as_tensor(restore_bf16(x) if isinstance(x, np.ndarray) else x)
    if not x.is_floating_point():
        raise TypeError(f"points must be floating point, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"points must be {shape}, got {tuple(x.shape)}")
    dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    return x.to(device=device, dtype=dtype).contiguous()


def _init_block(xt: torch.Tensor, init_sample: int) -> torch.Tensor:
    """The first `init_sample` points of feature-major xt (d, N) as a
    sample-major f32 block: where the features layout seeds."""
    return xt[:, :min(xt.shape[1], init_sample)].T.float().contiguous()


def _check_kernel_options(kernel: str, sample_weight, mesh) -> None:
    """The JAX package's refusals of an explicit kernel with weights or a
    mesh, in its words (checked again after 'auto' resolves)."""
    if sample_weight is not None and kernel == "pallas" and mesh is not None:
        raise ValueError(
            "kernel='pallas' with sample_weight is single-device (the "
            "weighted kernels have no shard_map tower); drop mesh or the "
            "explicit kernel"
        )
    if kernel == "pallas_bf16" and mesh is not None:
        raise ValueError(
            "kernel='pallas_bf16' is single-device (the bf16-MXU epilogue "
            "has no shard_map tower; cast the input to bf16 with "
            "kernel='pallas' for the same MXU precision on a mesh)"
        )
    if kernel == "pallas_bf16" and sample_weight is not None:
        raise ValueError(
            "kernel='pallas_bf16' does not support sample_weight (the "
            "weighted epilogue keeps full precision); drop the explicit "
            "kernel")


def kmeans_fit(
    x,
    k: int,
    *,
    init="kmeans++",
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    spherical: bool = False,
    mesh=None,
    kernel: str = "xla",
    sample_weight=None,
    n_init: int = 1,
    layout: str = "samples",
    history: bool = False,
    init_sample: int = 1 << 18,
    empty_policy: str = "keep",
    device=None,
) -> KMeansResult:
    """Fit K-Means.

    Args:
      x: (N, d) points (numpy or torch) on `device`: bfloat16 stays
        bfloat16, any other float type becomes float32.
      k: number of clusters.
      init: 'kmeans++', 'kmeans||' (k-means‖; also 'k-means||',
        'kmeans_parallel'), 'random', 'first_k', or an explicit (K, d)
        array.
      generator: torch.Generator on `device` for the stochastic inits
        (default: one seeded with 0).
      max_iters: iteration cap; tol: center-shift tolerance (negative =
        exactly max_iters iterations).
      spherical: cosine K-Means (points and centroids L2-normalized).
      mesh: a `parallel.mesh.Mesh` (`make_mesh`): x (and sample_weight)
        the same on every rank, N divisible by the mesh size; each rank
        fits its block of rows and all of them return the same result.
      kernel: 'xla' (plain PyTorch ops), 'refined' (exact-distance champion
        refinement), 'pallas' (the CUDA kernels: B1 fused, B5 for bf16
        points, or B2 + B3 sorted past the fused limit; with weights B4,
        or B2 + B3 over [w·x | w]), 'pallas_bf16' (B5 on f32 points too:
        bf16 cross operands, f32 stats; unweighted, single-device),
        'auto' (pallas on CUDA, xla on the CPU) or 'auto:quantized' (auto,
        and pallas_bf16 where it applies).
      sample_weight: optional (N,) nonnegative per-point weights (sklearn
        `sample_weight` parity): the stats become Σw·x, the weight mass and
        Σw·min d², and the stochastic inits draw by weight. 'refined'
        rejects them.
      n_init: restarts for stochastic inits; the lowest final SSE wins.
      layout: 'samples' (x is (N, d)) or 'features' (x is (d, N); every
        stats call runs B10, `ops/tall.py`; no mesh, weights or
        relocation, kernel 'xla' or 'tall').
      history: also return (sse, shift) per iteration.
      init_sample: 'features' layout only: the inits run on the first
        `init_sample` points, transposed to a sample-major f32 block.
      empty_policy: 'keep' (an empty cluster keeps its centroid) or
        'relocate' (sklearn parity: reseed from the costliest points).
      device: None means 'cuda'; 'cpu' runs the plain versions.
    """
    # The layout checks first, in the JAX package's order and words.
    if layout not in ("samples", "features"):
        raise ValueError(f"unknown layout {layout!r}")
    if empty_policy not in ("keep", "relocate"):
        raise ValueError(f"unknown empty_policy {empty_policy!r}")
    if empty_policy == "relocate" and layout == "features":
        raise ValueError(
            "empty_policy='relocate' needs the sample-major layout (the "
            "relocation pass gathers point rows)"
        )
    features = layout == "features"
    if features:
        if mesh is not None or sample_weight is not None:
            raise ValueError(
                "layout='features' does not support mesh/sample_weight yet"
            )
        if kernel not in ("xla", "tall"):
            # 'xla' (the signature default) means "unset"; an explicit
            # other kernel must not be silently discarded.
            raise ValueError(
                f"layout='features' runs the tall kernel; kernel={kernel!r} "
                "is not supported with it"
            )
        kernel = "tall"
    _check_kernel_options(kernel, sample_weight, mesh)
    dev = resolve_device(device)
    x = _as_points(x, dev, "(d, N)" if features else "(N, d)")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    stochastic = isinstance(init, str) and init != "first_k"
    if n_init > 1 and stochastic:
        best = None
        for _ in range(n_init):
            res = kmeans_fit(
                x, k, init=init, generator=generator, max_iters=max_iters,
                tol=tol, spherical=spherical, kernel=kernel,
                mesh=mesh, sample_weight=sample_weight, n_init=1,
                layout=layout, history=history, init_sample=init_sample,
                empty_policy=empty_policy, device=dev,
            )
            if best is None or float(res.sse) < float(best.sse):
                best = res
        return best
    if features:
        if spherical:
            x = x.float()
            x = x / torch.clamp_min(
                torch.linalg.norm(x, dim=0, keepdim=True), 1e-12)
        c_init = resolve_init(_init_block(x, init_sample), k, init,
                              generator)
        return _lloyd_loop(x, c_init, int(max_iters), float(tol),
                           bool(spherical), "tall", 0, bool(history))
    n, d = x.shape
    if kernel.startswith("auto"):
        from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

        kernel = resolve_kernel(
            kernel, k=k, d=d, device=dev, label="kmeans_fit",
            model="kmeans" if sample_weight is None else "kmeans_weighted",
            itemsize=x.element_size(),
            ineligible=(
                "sample weights with a mesh have no weighted kernel tower"
                if sample_weight is not None and mesh is not None else None),
            mxu_ineligible=("the bf16 epilogue has no data-parallel tower"
                            if mesh is not None else None))
        _check_kernel_options(kernel, sample_weight, mesh)
    w = None
    if sample_weight is not None:
        if kernel == "refined":
            # The exact-champion path has no weighted variant; an explicit
            # request must not record plain numbers as refined ones.
            raise ValueError(
                "kernel='refined' does not support sample_weight; drop the "
                "explicit kernel")
        w = validate_sample_weight(sample_weight, n, k, dev)
    if spherical:
        x = _normalize(x.float())
    if mesh is not None:
        from tdc_tpu_torch.parallel.mesh import shard_points

        if n % mesh.size != 0:
            # Padding rows would bias cluster means; the exact path
            # requires even shardability (the JAX package's words).
            raise ValueError(
                f"N={n} not divisible by mesh size {mesh.size}; "
                "truncate/pad the data or use streamed_kmeans_fit")
        c_init = resolve_init_replicated(x, k, init, generator, mesh, w)
        x = shard_points(x, mesh)
        if w is not None:
            w = shard_points(w, mesh)
    else:
        c_init = resolve_init(x, k, init, generator, w)
    block_rows = (auto_block_rows(x.shape[0], k, device=dev)
                  if kernel in ("xla", "refined") else 0)
    return _lloyd_loop(x, c_init, int(max_iters), float(tol),
                       bool(spherical), kernel, block_rows, bool(history),
                       empty_policy, w, mesh)


def kmeans_predict(x, centroids, *, spherical: bool = False,
                   kernel: str = "auto", device=None) -> torch.Tensor:
    """Per-point cluster labels (N,) int32.

    kernel: 'xla', 'pallas' (B2, the blockwise distance-argmin kernel: no
    (N, K) buffer), or 'auto' — pallas on CUDA once the (N, K) matrix
    would pass 1 GiB, as the JAX version does on a TPU ('auto:quantized'
    resolves the same way: predict has no stats to quantize). bf16 points
    run promoted on 'xla' and widened, with the centroids rounded to bf16,
    on 'pallas', as the JAX version's two paths do.
    """
    dev = resolve_device(device)
    x = _as_points(x, dev)
    if spherical:
        x = _normalize(x.float())
    c = torch.as_tensor(centroids).to(dev, torch.float32).contiguous()
    if kernel.startswith("auto"):
        big = 4 * x.shape[0] * c.shape[0] > (1 << 30)
        kernel = "pallas" if (dev.type == "cuda" and big) else "xla"
    if kernel == "pallas":
        from tdc_tpu_torch.ops.lloyd_kernels import distance_argmin

        return distance_argmin(x, c)[0]
    if kernel != "xla":
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla', 'pallas' "
                         "or 'auto')")
    return assign_clusters(x, c)
