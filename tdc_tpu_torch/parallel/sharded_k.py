"""The in-memory K-sharded towers: K-Means and Fuzzy C-Means
(counterpart: tdc_tpu/parallel/sharded_k.py, the `make_mesh_2d`,
`_block_champions`, `_block_stats`, `make_sharded_stats`, `sum_sq`,
`make_sharded_lloyd_step`, `sharded_assign`, `_device_loop`,
`_resolve_init_sharded`, `kmeans_fit_sharded`, `_fuzzy_fit_fns`,
`make_sharded_fuzzy_stats` and `fuzzy_fit_sharded` parts).

A (data, model) grid of ranks: a rank's data coordinate picks its rows,
its model coordinate its block of K/P contiguous centroids
(`P(MODEL_AXIS, None)` in the JAX package). No rank ever holds more than
(rows, K/P) of anything.

K-Means: each shard finds every row's nearest of its K/P centroids (B2,
`distance_argmin`, on the kernel route), the global champion is the
smallest of the shards' minima (ties to the smallest global index), and
each shard sums the rows its own centroids won with the sort-based stats
(B3), a sentinel label for the rows another shard won. JAX all_gathers
the shards' (min, arg) pairs over the model axis; here each shard writes
its pair into its own row of zero (P, rows) buffers that an all_reduce
sums (adding zeros is exact), and the JAX selection follows as it is.
The stats are then summed over the data axis. The loop and the final SSE
run the shifted minima ‖c‖² − 2x·c and add Σ‖x‖², computed once per fit.

Fuzzy C-Means: the one quantity that crosses model shards per point is
the membership normaliser s = Σ_k (d² + eps)^(−1/(m−1)): each shard
computes its own part, the parts are summed over the model axis, and each
shard accumulates its centroids' stats with that s. On the kernel route
that is B7 (`fuzzy_normalizer`), an all_reduce of s, then B8
(`fuzzy_accumulate`); on 'xla' the same in plain ops, a block of rows at
a time. The stats are then summed over the data axis, the objective over
both axes (after B8 clamps each shard's part at 0, as the JAX kernel
does).

The fuzzy tower splits rows np.array_split-wise, so a ragged N gives the
ranks unequal rows and pads nothing: the JAX package's zero-row padding
and its exact correction (`_pad_rows_sharded`, `_fuzzy_pad_correction`)
have nothing to correct here. The K-Means tower refuses a ragged N, as
the JAX one does. The loops run on the host, reading the shift once per
iteration; the shift comes from the all-reduced stats, so every rank
takes the same branch. Every rank returns the whole (K, d) centroids,
assembled by an all_reduce of a zero (K, d) buffer in which each model
shard fills its own rows. The collectives are all_reduce and broadcast
only, which gloo takes on CUDA tensors.

`padding_correction` is the exact zero-row correction the streamed fits
apply where a rank's slice of a batch is padded (`models/streaming.py`).

Not ported: the streamed towers, the GMM tower, coarse and bounded
assignment and the compressed gathers (ROADMAP.md Queue A, A7, A9, A10).
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.models.fuzzy import FuzzyCMeansResult
from tdc_tpu_torch.models.kmeans import (
    KMeansResult,
    _as_points,
    _normalize,
    _not_ported,
    auto_block_rows,
    resolve_init,
    resolve_init_replicated,
)
from tdc_tpu_torch.ops.assign import FuzzyStats
from tdc_tpu_torch.ops.distance import pairwise_sq_dist
from tdc_tpu_torch.parallel.mesh import (
    Mesh,
    make_grid,
    replicate,
    shard_points,
)
from tdc_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh_2d(n_data: int, n_model: int) -> Mesh:
    """(data, model) grid over the n_data·n_model ranks of the job."""
    return make_grid((n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def _resolve_init_sharded(x, k: int, init, generator, *,
                          sample_rows: int = 65536) -> torch.Tensor:
    """Init for the K-sharded fit: arrays pass through; names resolve on
    the first ≤ sample_rows rows (the seeding problem is tiny next to the
    fit)."""
    if not isinstance(init, str):
        c = torch.as_tensor(init).to(x.device, torch.float32)
        if c.shape[0] != k:
            raise ValueError(f"init has {c.shape[0]} rows, expected {k}")
        return c
    return resolve_init(x[:min(x.shape[0], sample_rows)], k, init,
                        generator)


def make_sharded_fuzzy_stats(mesh: Mesh, m: float = 2.0, eps: float = 1e-9,
                             block_rows: int = 0, kernel: str = "xla"):
    """fn(x_loc, c_loc) → FuzzyStats of this rank's model shard: Σμx
    (K/P, d) and Σμ (K/P,) summed over the data axis, the objective over
    both axes. x_loc is this rank's rows, c_loc its K/P centroids.
    kernel='pallas' runs B7 and B8 (internally blocked: block_rows does
    not apply); 'xla' takes block_rows rows at a time (0: all), with one
    all_reduce of the block's s."""
    p = -1.0 / (m - 1.0)

    def local_xla(x_loc, c_loc):
        k_per, d = c_loc.shape
        wsums = torch.zeros((k_per, d), dtype=torch.float32,
                            device=x_loc.device)
        weights = torch.zeros(k_per, dtype=torch.float32,
                              device=x_loc.device)
        obj = torch.zeros((), dtype=torch.float32, device=x_loc.device)
        rows = block_rows or max(x_loc.shape[0], 1)
        for start in range(0, x_loc.shape[0], rows):
            xb = x_loc[start:start + rows]
            d2 = pairwise_sq_dist(xb, c_loc)  # (b, K/P), clamped at 0
            inv = (d2 + eps) ** p
            s = mesh.psum(inv.sum(dim=1, keepdim=True), MODEL_AXIS)
            mu = (inv / s) ** m
            wsums += mu.T @ xb.float()
            weights += mu.sum(dim=0)
            obj += (mu * d2).sum()
        return wsums, weights, obj

    def local_pallas(x_loc, c_loc):
        from tdc_tpu_torch.ops.fuzzy_kernels import (
            fuzzy_accumulate,
            fuzzy_normalizer,
        )

        s, x2 = fuzzy_normalizer(x_loc, c_loc, m, eps, return_x2=True)
        mesh.psum(s, MODEL_AXIS)  # the global normaliser
        fs = fuzzy_accumulate(x_loc, c_loc, s, m, eps, x2=x2)
        return fs.weighted_sums, fs.weights, fs.objective

    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    local = local_pallas if kernel == "pallas" else local_xla

    def stats(x_loc, c_loc) -> FuzzyStats:
        wsums, weights, obj = local(x_loc, c_loc)
        k_per, d = wsums.shape
        # One data-axis all_reduce of [Σμx | Σμ | J_m], then J_m over the
        # model axis too.
        flat = mesh.psum(torch.cat([wsums.reshape(-1), weights,
                                    obj.reshape(1)]), DATA_AXIS)
        obj = mesh.psum(flat[-1:].clone(), MODEL_AXIS)[0]
        return FuzzyStats(weighted_sums=flat[:k_per * d].view(k_per, d),
                          weights=flat[k_per * d:-1], objective=obj)

    return stats


def _block_champions(x_blk, c_loc, kernel: str, mesh: Mesh,
                     shifted: bool = False):
    """Per-row global (min d², argmin) across all K shards. Each model
    shard scores the rows against its local centroids; the per-shard
    champions cross the model axis as two (P, rows) buffers, each shard's
    in its own row of zeros, summed by all_reduce. shifted=True drops the
    row-constant ‖x‖² (and the 0-clamp) from the minima: every shard
    shifts a row by the same amount, so the champions do not change."""
    k_per = c_loc.shape[0]
    j = mesh.axis_index(MODEL_AXIS)
    if kernel == "pallas":
        from tdc_tpu_torch.ops.lloyd_kernels import distance_argmin

        arg, lmin = distance_argmin(x_blk, c_loc, return_dist=not shifted)
    else:
        d2 = pairwise_sq_dist(x_blk, c_loc, shifted=shifted)  # (rows, K/P)
        lmin, arg = torch.min(d2, dim=1)  # the first index among equal minima
    n_model = mesh.axis_size(MODEL_AXIS)
    mins = torch.zeros((n_model, x_blk.shape[0]), dtype=torch.float32,
                       device=x_blk.device)
    args = torch.zeros((n_model, x_blk.shape[0]), dtype=torch.int32,
                       device=x_blk.device)
    mins[j] = lmin
    args[j] = arg.to(torch.int32) + j * k_per
    mesh.psum(mins, MODEL_AXIS)
    mesh.psum(args, MODEL_AXIS)
    # The JAX selection: min, then the smallest index among the shards
    # that reach it. The same bits on every rank.
    gmin = mins.min(dim=0).values
    garg = torch.where(mins == gmin[None, :], args, 2 ** 30).min(dim=0).values
    return gmin, garg


def _block_stats(x_blk, c_loc, kernel: str, mesh: Mesh,
                 shifted: bool = False):
    """(sums (K/P, d), counts (K/P,), sse ()) of this shard's centroids
    over the rows: rows another shard won take the sentinel label K/P,
    which the sort-based stats drop."""
    from tdc_tpu_torch.ops.sorted_stats import sorted_cluster_stats

    k_per = c_loc.shape[0]
    gmin, garg = _block_champions(x_blk, c_loc, kernel, mesh, shifted)
    rel = garg - mesh.axis_index(MODEL_AXIS) * k_per
    sums, counts = sorted_cluster_stats(x_blk, rel, k_per,
                                        pallas=kernel == "pallas")
    return sums, counts, gmin.sum()


def _row_blocks(x_loc, block_rows: int, kernel: str) -> list:
    """This rank's rows as the towers take them: block_rows at a time on
    'xla' (its (block, K/P) distances bound the memory; the rows must be
    a multiple), at once on the kernel route, which has no such buffer."""
    n_loc = x_loc.shape[0]
    if not (block_rows and n_loc > block_rows and kernel != "pallas"):
        return [x_loc]
    if n_loc % block_rows != 0:
        raise ValueError(
            f"local shard rows {n_loc} not divisible by "
            f"block_rows={block_rows}"
        )
    return list(x_loc.split(block_rows))


def make_sharded_stats(mesh: Mesh, kernel: str = "xla", block_rows: int = 0,
                       shifted: bool = False):
    """fn(x_loc, c_loc) → (sums (K/P, d), counts (K/P,), sse ()) of this
    rank's model shard, summed over the data axis; sse is the same on
    every rank. x_loc is this rank's rows, c_loc its K/P centroids.
    block_rows > 0 takes the rows that many at a time on 'xla'.
    shifted=True returns sse without Σ‖x‖² (see `_block_champions`)."""

    def stats(x_loc, c_loc):
        k_per, d = c_loc.shape
        sums = torch.zeros((k_per, d), dtype=torch.float32,
                           device=x_loc.device)
        counts = torch.zeros(k_per, dtype=torch.float32, device=x_loc.device)
        sse = torch.zeros((), dtype=torch.float32, device=x_loc.device)
        for blk in _row_blocks(x_loc, block_rows, kernel):
            s, ct, e = _block_stats(blk, c_loc, kernel, mesh, shifted)
            sums, counts, sse = sums + s, counts + ct, sse + e
        # One data-axis all_reduce of [Σx | counts | sse].
        flat = mesh.psum(torch.cat([sums.reshape(-1), counts,
                                    sse.reshape(1)]), DATA_AXIS)
        return (flat[:k_per * d].view(k_per, d), flat[k_per * d:-1],
                flat[-1])

    return stats


def sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ‖x‖² as an f32 scalar: the iteration-invariant SSE term, computed
    once per fit and passed to the sharded step as `x2sum`."""
    xf = x.float()
    return (xf * xf).sum()


def padding_correction(counts: torch.Tensor, sse: torch.Tensor,
                       centroids: torch.Tensor, n_pad):
    """Remove the exact contribution of `n_pad` zero-padding rows from
    Lloyd stats: each lands on the argmin-‖c‖² cluster (the smallest
    index on ties) with zero Σx, one count and ‖c_j‖² of SSE. Returns
    (counts, sse); `centroids` are those the rows were scored against
    (cast to the batch dtype on the kernel routes)."""
    c = centroids.float()
    c2 = (c * c).sum(dim=-1)
    j = torch.argmin(c2)
    n_pad = torch.as_tensor(n_pad, dtype=torch.float32, device=c.device)
    counts = counts.clone()
    counts[j] -= n_pad
    return counts, sse - n_pad * c2[j]


def make_sharded_lloyd_step(mesh: Mesh, kernel: str = "xla",
                            block_rows: int = 0, spherical: bool = False):
    """step(x_loc, c_loc, x2sum) → (new c_loc, shift over all K, sse at
    c_loc), x2sum = Σ‖x‖² over all rows (`sum_sq`): the distance pass
    reports shifted minima (the same champions) and the SSE is max(Σ
    shifted minima + x2sum, 0), which loses relative precision when the
    SSE is far below Σ‖x‖², as in the JAX package. The rows are not
    padded, so the JAX step's padding correction has nothing to do."""
    stats_shifted = make_sharded_stats(mesh, kernel, block_rows,
                                       shifted=True)

    def step(x_loc, c_loc, x2sum):
        sums, counts, sse = stats_shifted(x_loc, c_loc)
        sse = torch.clamp_min(sse + x2sum, 0.0)
        new_c = torch.where(counts[:, None] > 0,
                            sums / torch.clamp_min(counts[:, None], 1.0),
                            c_loc)
        if spherical:
            new_c = _normalize(new_c)
        shift = _model_max(torch.linalg.norm(new_c - c_loc, dim=-1).max(),
                           mesh)
        return new_c, shift, sse

    return step


def sharded_assign(mesh: Mesh, kernel: str = "xla", block_rows: int = 0,
                   shifted: bool = True):
    """fn(x_loc, c_loc) → the global labels (int32) of this rank's rows,
    blocked as the stats tower. shifted=True (the default) compares the
    unclamped ‖c‖² − 2x·c, as the fit's step does; shifted=False the
    clamped d², which can tie near-duplicate centroids at 0 (either index
    is a valid argmin)."""

    def assign(x_loc, c_loc):
        return torch.cat([
            _block_champions(blk, c_loc, kernel, mesh, shifted)[1]
            for blk in _row_blocks(x_loc, block_rows, kernel)])

    return assign


def _model_max(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The largest of every model shard's scalar v, the same bits on every
    rank, by a sum: each shard writes its v into its own slot of zeros."""
    slots = torch.zeros(mesh.axis_size(MODEL_AXIS), dtype=v.dtype,
                        device=v.device)
    slots[mesh.axis_index(MODEL_AXIS)] = v
    return mesh.psum(slots, MODEL_AXIS).max()


def _whole_centroids(c_loc: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The (K, d) centroids on every rank: a zero buffer, this shard's
    rows filled, summed over the model axis (exact: the rest are 0)."""
    k_per, d = c_loc.shape
    n_model = mesh.axis_size(MODEL_AXIS)
    j = mesh.axis_index(MODEL_AXIS)
    full = torch.zeros((k_per * n_model, d), dtype=c_loc.dtype,
                       device=c_loc.device)
    full[j * k_per:(j + 1) * k_per] = c_loc
    return mesh.psum(full, MODEL_AXIS)


def _fuzzy_fit_fns(mesh: Mesh, m: float, block_rows: int, kernel: str):
    """fuzzy_fit_sharded's step: c_loc → (new c_loc, shift over all K,
    objective at c_loc)."""
    stats_fn = make_sharded_fuzzy_stats(mesh, m, 1e-9, block_rows=block_rows,
                                        kernel=kernel)

    def step(x_loc, c_loc):
        fs = stats_fn(x_loc, c_loc)
        new_c = fs.weighted_sums / torch.clamp_min(fs.weights[:, None], 1e-12)
        shift = _model_max(torch.linalg.norm(new_c - c_loc, dim=-1).max(),
                           mesh)
        return new_c, shift, fs.objective

    return step


def _device_loop(step, c0, max_iters: int, tol: float):
    """Run step(c) → (new_c, shift, cost) while i < max_iters and, with
    tol ≥ 0, shift > tol. Returns (c, shift, n_iter, hist): hist is the
    (n_iter, 2) [cost, shift] history on the device. The JAX version is a
    device-side while_loop; here the host reads the shift once per
    iteration, only when tol ≥ 0."""
    c = c0
    shift = torch.tensor(float("inf"), device=c0.device)
    hist = torch.zeros((max_iters, 2), dtype=torch.float32, device=c0.device)
    n_iter = 0
    while n_iter < max_iters and (tol < 0 or float(shift) > tol):
        c, shift, cost = step(c)
        hist[n_iter, 0] = cost
        hist[n_iter, 1] = shift
        n_iter += 1
    return c, shift, n_iter, hist[:n_iter]


def kmeans_fit_sharded(
    x,
    k: int,
    mesh: Mesh,
    *,
    init,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    spherical: bool = False,
    kernel: str = "xla",
    block_rows: int = 0,
    assign: str = "exact",
    gather: str = "fp32",
    device=None,
) -> KMeansResult:
    """Lloyd K-Means with the rows sharded over 'data' and the centroids
    over 'model' (`make_mesh_2d`): the large-K regime. Every rank passes
    the same x, N a multiple of the data axis and K of the model axis;
    init is a (K, d) array or a name, which rank 0 resolves on the first
    ≤ 65,536 rows and broadcasts. kernel: 'xla', 'pallas' (B2 + B3 on
    each shard) or 'auto' (pallas on CUDA). block_rows > 0 takes each
    rank's rows that many at a time on 'xla'; 0 takes them at once, as in
    the JAX package. Returns the whole (K, d) centroids on every rank,
    n_iter, the SSE at the returned centroids, the last shift, converged
    (tol ≥ 0 and shift ≤ tol) and the (n_iter, 2) [sse, shift] history,
    row i the SSE at iteration i's input centroids. assign='exact' and
    gather='fp32' only: the others are not ported."""
    from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

    n_data = mesh.axis_size(DATA_AXIS)
    n_model = mesh.axis_size(MODEL_AXIS)
    if x.shape[0] % n_data != 0:
        raise ValueError(f"N={x.shape[0]} not divisible by data axis "
                         f"{n_data}")
    if k % n_model != 0:
        raise ValueError(f"K={k} not divisible by model axis {n_model}")
    if gather != "fp32":
        raise _not_ported(f"kmeans_fit_sharded(gather={gather!r})",
                          "Queue A, A9: parallel/gather.py")
    if assign != "exact":
        raise _not_ported(f"kmeans_fit_sharded(assign={assign!r})",
                          "Queue A, A10: ops/subk.py, ops/bounds.py")
    dev = resolve_device(device)
    x = _as_points(x, dev)
    if spherical:
        x = _normalize(x.float())
    kernel = resolve_kernel(kernel, k=k // n_model, d=x.shape[1],
                            device=dev, model="kmeans_sharded",
                            label="kmeans_fit_sharded")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if isinstance(init, str):
        c = resolve_init_replicated(x[:min(x.shape[0], 65536)], k, init,
                                    generator, mesh)
    else:
        c = replicate(_resolve_init_sharded(x, k, init, generator), mesh)
    if spherical:
        c = _normalize(c)
    x_loc = shard_points(x, mesh)
    j, k_per = mesh.axis_index(MODEL_AXIS), k // n_model
    c_loc = c[j * k_per:(j + 1) * k_per].contiguous()
    # Once per fit; the step then skips the ‖x‖² re-read.
    x2sum = mesh.psum(sum_sq(x_loc).reshape(1), DATA_AXIS)[0]
    step = make_sharded_lloyd_step(mesh, kernel, int(block_rows), spherical)
    c_loc, shift, n_iter, hist = _device_loop(
        lambda ci: step(x_loc, ci, x2sum), c_loc, int(max_iters), float(tol))
    # One extra step: the SSE at the RETURNED centroids.
    _, _, sse = step(x_loc, c_loc, x2sum)
    return KMeansResult(
        centroids=_whole_centroids(c_loc, mesh),
        n_iter=n_iter,
        sse=sse,
        shift=shift,
        converged=bool(tol >= 0 and float(shift) <= tol),
        history=hist.cpu().numpy(),
    )


def fuzzy_fit_sharded(
    x,
    k: int,
    mesh: Mesh,
    *,
    m: float = 2.0,
    init,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    block_rows: int = 0,
    kernel: str = "xla",
    dtype=None,
    device=None,
) -> FuzzyCMeansResult:
    """Fuzzy C-Means with the rows sharded over 'data' and the centroids
    over 'model' (`make_mesh_2d`): the large-K regime. Every rank passes
    the same x; a named init resolves on rank 0 on the first ≤ 65,536 rows
    and is broadcast. kernel: 'xla', 'pallas' (B7 + B8 on each shard) or
    'auto' (pallas on CUDA). dtype (torch.bfloat16) converts each rank's
    rows; the stats stay f32. Returns the whole (K, d) centroids on every
    rank, n_iter, the objective at the returned centroids, the last shift,
    converged (tol ≥ 0 and shift ≤ tol) and the (n_iter, 2) [objective,
    shift] history. block_rows (the 'xla' route's rows per block): 0
    sizes blocks from the device's memory, where the JAX version's 0
    means one block; the result does not depend on it beyond f32
    summation order."""
    from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

    n_data = mesh.axis_size(DATA_AXIS)
    n_model = mesh.axis_size(MODEL_AXIS)
    if k % n_model != 0:
        raise ValueError(f"K={k} not divisible by model axis {n_model}")
    if m <= 1.0:
        raise ValueError(f"fuzzifier m must be > 1, got {m}")
    dev = resolve_device(device)
    x = _as_points(x, dev)
    kernel = resolve_kernel(kernel, k=k // n_model, d=x.shape[1],
                            device=dev, model="fuzzy_sharded",
                            label="fuzzy_fit_sharded")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if isinstance(init, str):
        c = resolve_init_replicated(x[:min(x.shape[0], 65536)], k, init,
                                    generator, mesh)
    else:
        c = replicate(_resolve_init_sharded(x, k, init, generator), mesh)
    x_loc = shard_points(x, mesh)
    if dtype is not None:
        x_loc = x_loc.to(dtype)
    j, k_per = mesh.axis_index(MODEL_AXIS), k // n_model
    c_loc = c[j * k_per:(j + 1) * k_per].contiguous()
    if kernel == "xla" and not block_rows:
        block_rows = auto_block_rows(-(-x.shape[0] // n_data), k_per,
                                     device=dev)
    step = _fuzzy_fit_fns(mesh, float(m), int(block_rows), kernel)
    c_loc, shift, n_iter, hist = _device_loop(
        lambda ci: step(x_loc, ci), c_loc, int(max_iters), float(tol))
    _, _, obj = step(x_loc, c_loc)  # objective of the RETURNED centroids
    return FuzzyCMeansResult(
        centroids=_whole_centroids(c_loc, mesh),
        n_iter=n_iter,
        objective=obj,
        shift=shift,
        converged=bool(tol >= 0 and float(shift) <= tol),
        history=hist.cpu().numpy(),
    )
