"""Fuzzy C-Means with an explicit fuzzifier (counterpart:
tdc_tpu/models/fuzzy.py).

The JAX package traces the loop into one `lax.while_loop`. Here, as in
`models/kmeans.py`, the loop runs on the host and every iteration's work
stays on the device; the host reads the scalar centroid shift once per
iteration, and only when a tolerance is set. The semantics are the JAX
package's:

- new centroids = Σμx / max(Σμ, 1e-12); shift = the largest row L2 norm
  of the move;
- tol < 0 runs exactly max_iters iterations;
- the final objective is recomputed at the returned centroids, so a fit
  makes n_iter + 1 stats calls;
- converged = shift <= max(tol, 0) and n_iter > 0.

Supported: mesh= (data parallel, as in `models/kmeans.py`: every rank
passes the same x, rank 0 seeds, the stats are all-reduced), float32 or
bfloat16 inputs, layout='samples' or
'features' (x is (d, N) and every stats call runs B11, `ops/tall.py`,
with the JAX package's restrictions: no mesh or weights, kernel 'xla',
meaning unset, or 'tall'), kernel in {'xla', 'pallas', 'auto',
'auto:quantized'} ('auto:quantized' takes the plain auto choice: the
bf16 epilogue is K-Means only; 'pallas_bf16' is an unknown kernel here,
as in the JAX package). bf16 points run
promoted on 'xla' and widened, with the centroids rounded to bf16, on
B6, as the JAX package's two paths do. Sample weights run the f32 plain
stats ('xla'), as in the JAX package: an explicit kernel='pallas' with
weights raises, and 'auto' resolves to 'xla' with the reason in its
`kernel_selected` event. The rest raises NotImplementedError naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tdc_tpu_torch.models._common import validate_sample_weight
from tdc_tpu_torch.models.kmeans import (
    _as_points,
    _init_block,
    auto_block_rows,
    kmeans_predict,
    resolve_init,
    resolve_init_replicated,
)
from tdc_tpu_torch.ops.assign import (
    fuzzy_memberships,
    fuzzy_stats,
    fuzzy_stats_padded_blocked,
    fuzzy_stats_weighted,
    fuzzy_stats_weighted_blocked,
)
from tdc_tpu_torch.utils.device import resolve_device


class FuzzyCMeansResult(NamedTuple):
    centroids: torch.Tensor  # (K, d) float32
    n_iter: int  # iterations run
    objective: torch.Tensor  # () float32 — J_m = Σ u^m d² at the centroids
    shift: torch.Tensor  # () float32 — last max centroid movement (L2)
    converged: bool
    # (n_iter, 2) numpy [objective, shift] per iteration when history=True:
    # row i is the objective at the iteration's input centroids and its
    # shift.
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


def _fuzzy_stats_fn(kernel: str, m: float, block_rows: int, k: int, d: int,
                    w=None):
    if w is not None and kernel == "xla":
        # fuzzy_cmeans_fit rejects kernel='pallas' with weights.
        if block_rows:
            return lambda x, c: fuzzy_stats_weighted_blocked(x, c, w, m,
                                                             block_rows)
        return lambda x, c: fuzzy_stats_weighted(x, c, w, m=m)
    if kernel == "pallas":
        # The CUDA kernel route, decided once per fit (one event).
        from tdc_tpu_torch.ops.fuzzy_kernels import fuzzy_stats_for

        fn = fuzzy_stats_for(k, d, label="fuzzy_fit")
        return lambda x, c: fn(x, c, m)
    if kernel == "tall":
        # B11 over feature-major points; on sample-major points its shape
        # check raises, as the JAX package's tall kernel fails there.
        from tdc_tpu_torch.ops.tall import fuzzy_stats_tall

        return lambda x, c: fuzzy_stats_tall(x, c, m=m)
    if kernel != "xla":
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    if block_rows:
        return lambda x, c: fuzzy_stats_padded_blocked(x, c, m, block_rows)
    return lambda x, c: fuzzy_stats(x, c, m=m)


def _fcm_loop(
    x: torch.Tensor,
    init_centroids: torch.Tensor,
    max_iters: int,
    tol: float,
    m: float,
    kernel: str = "xla",
    block_rows: int = 0,
    history: bool = False,
    w: torch.Tensor | None = None,
    mesh=None,
) -> FuzzyCMeansResult:
    """The fuzzy C-means iteration. tol < 0 disables the convergence test;
    history=True records (objective, shift) per iteration on the device.
    `w` (sample weights) routes to the weighted plain stats. With `mesh`,
    x (and w) are this rank's rows and the stats are summed over the data
    axis."""
    stats_fn = _fuzzy_stats_fn(kernel, m, block_rows, *init_centroids.shape,
                               w=w)
    if mesh is not None:
        from tdc_tpu_torch.parallel.reduce import reduced_tree_stats

        stats_fn = reduced_tree_stats(mesh, stats_fn)
    c = init_centroids.to(torch.float32)
    hist = (torch.full((max_iters, 2), float("nan"), device=x.device)
            if history else None)
    shift = torch.tensor(float("inf"), device=x.device)
    n_iter = 0
    while n_iter < max_iters:
        stats = stats_fn(x, c)
        new_c = stats.weighted_sums / torch.clamp_min(
            stats.weights[:, None], 1e-12)
        shift = torch.linalg.norm(new_c - c, dim=-1).max()
        if history:
            hist[n_iter, 0] = stats.objective
            hist[n_iter, 1] = shift
        c = new_c
        n_iter += 1
        if tol >= 0 and not float(shift) > tol:
            break
    final_obj = stats_fn(x, c).objective
    return FuzzyCMeansResult(
        centroids=c,
        n_iter=n_iter,
        objective=final_obj,
        shift=shift,
        converged=bool(float(shift) <= max(tol, 0.0) and n_iter > 0),
        history=hist[:n_iter].cpu().numpy() if history else None,
    )


def fuzzy_cmeans_fit(
    x,
    k: int,
    *,
    m: float = 2.0,
    init="kmeans++",
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    mesh=None,
    kernel: str = "xla",
    sample_weight=None,
    layout: str = "samples",
    history: bool = False,
    init_sample: int = 1 << 18,
    device=None,
) -> FuzzyCMeansResult:
    """Fit Fuzzy C-Means.

    Args:
      x: (N, d) points (numpy or torch) on `device`: bfloat16 stays
        bfloat16, any other float type becomes float32.
      k: number of clusters; m: the fuzzifier, > 1.
      init: 'kmeans++', 'random', 'first_k', or an explicit (K, d) array.
      generator: torch.Generator on `device` for the stochastic inits
        (default: one seeded with 0).
      max_iters: iteration cap; tol: center-shift tolerance (negative =
        exactly max_iters iterations).
      mesh: a `parallel.mesh.Mesh`: x (and sample_weight) the same on every
        rank, N divisible by the mesh size; each rank fits its rows.
      kernel: 'xla' (plain PyTorch ops, N-blocked past the memory budget),
        'pallas' (the CUDA kernel B6) or 'auto' / 'auto:quantized' (pallas
        on CUDA, xla on the CPU; xla whenever sample_weight is given).
      sample_weight: optional (N,) nonnegative per-point weights: each
        row's u^m is scaled by its weight (memberships do not depend on
        it); f32 plain stats only.
      layout: 'samples' (x is (N, d)) or 'features' (x is (d, N); every
        stats call runs B11; no mesh or weights, kernel 'xla' or 'tall').
      history: also return (objective, shift) per iteration.
      init_sample: 'features' layout only: the inits run on the first
        `init_sample` points, transposed to a sample-major f32 block.
      device: None means 'cuda'; 'cpu' runs the plain versions.
    """
    if m <= 1.0:
        raise ValueError(f"fuzzifier m must be > 1, got {m}")
    if layout not in ("samples", "features"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "features":
        if mesh is not None or sample_weight is not None:
            raise ValueError(
                "layout='features' does not support mesh/sample_weight yet"
            )
        if kernel not in ("xla", "tall"):
            # 'xla' (the signature default) means "unset".
            raise ValueError(
                f"layout='features' runs the tall kernel; kernel={kernel!r} "
                "is not supported with it"
            )
        dev = resolve_device(device)
        x = _as_points(x, dev, "(d, N)")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        c_init = resolve_init(_init_block(x, init_sample), k, init,
                              generator)
        return _fcm_loop(x, c_init, int(max_iters), float(tol), float(m),
                         "tall", 0, bool(history))
    dev = resolve_device(device)
    x = _as_points(x, dev)
    n, d = x.shape
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if kernel.startswith("auto"):
        from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

        kernel = resolve_kernel(
            kernel, k=k, d=d, device=dev, model="fuzzy", label="fuzzy_fit",
            ineligible=("the weighted fuzzy stats run in f32 plain ops for "
                        "mass exactness, as in the JAX package"
                        if sample_weight is not None else None))
    w = None
    if sample_weight is not None:
        if kernel == "pallas":
            # An explicit kernel request must not run the plain weighted
            # stats under the kernel's name.
            raise ValueError(
                "kernel='pallas' does not support sample_weight; drop the "
                "explicit kernel")
        w = validate_sample_weight(sample_weight, n, k, dev)
    if mesh is not None:
        from tdc_tpu_torch.parallel.mesh import shard_points

        if n % mesh.size != 0:
            raise ValueError(f"N={n} not divisible by mesh size {mesh.size}")
        c_init = resolve_init_replicated(x, k, init, generator, mesh, w)
        x = shard_points(x, mesh)
        if w is not None:
            w = shard_points(w, mesh)
    else:
        c_init = resolve_init(x, k, init, generator, w)
    block_rows = (auto_block_rows(x.shape[0], k, device=dev)
                  if kernel == "xla" else 0)
    return _fcm_loop(x, c_init, int(max_iters), float(tol), float(m), kernel,
                     block_rows, bool(history), w, mesh)


def fuzzy_predict(x, centroids, *, m: float = 2.0, soft: bool = False,
                  block_rows: int = 0, kernel: str = "auto", device=None):
    """Memberships (soft=True, (N, K) f32) or hard labels ((N,) int32).

    Hard labels: membership falls as the squared distance grows, so
    argmax(u) == argmin(d²) — routed through kmeans_predict (B2, the
    distance-argmin kernel, under kernel='pallas'). No (N, K) matrix.

    Soft: the (N, K) output is the result asked for; with block_rows > 0
    (or automatically past 1 GB) it is computed in N-blocks, so no
    intermediate beyond the output itself exists.
    """
    if not soft:
        return kmeans_predict(x, centroids, kernel=kernel, device=device)
    dev = resolve_device(device)
    x = _as_points(x, dev)
    c = torch.as_tensor(centroids).to(dev, torch.float32).contiguous()
    n, k = x.shape[0], c.shape[0]
    if block_rows == 0 and 4 * n * k > (1 << 30):
        block_rows = 1 << 16
    if not block_rows or n <= block_rows:
        return fuzzy_memberships(x, c, m=m)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    for s in range(0, n, block_rows):
        out[s:s + block_rows] = fuzzy_memberships(x[s:s + block_rows], c, m=m)
    return out


def predict_proba(x, centroids, *, m: float = 2.0, block_rows: int = 0,
                  device=None):
    """Soft membership matrix (N, K) — sklearn-style alias."""
    return fuzzy_predict(x, centroids, m=m, soft=True, block_rows=block_rows,
                         device=device)
