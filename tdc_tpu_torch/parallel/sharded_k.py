"""The K-sharded towers: K-Means, Fuzzy C-Means and the diag Gaussian
Mixture, in memory and streamed (counterpart:
tdc_tpu/parallel/sharded_k.py, the `make_mesh_2d`, `_block_champions`,
`_block_stats`, `make_sharded_stats`, `sum_sq`,
`make_sharded_lloyd_step`, `sharded_assign`, `_device_loop`,
`_resolve_init_sharded`, `kmeans_fit_sharded`, `_fuzzy_fit_fns`,
`make_sharded_fuzzy_stats`, `fuzzy_fit_sharded`, `_gmm_fit_fns`,
`make_sharded_gmm_stats` and `gmm_fit_sharded` parts, and the streamed
ones: `_ShardedAcc`, `make_sharded_deferred_reduce`,
`make_sharded_deferred_accumulate`, `_GatheringCheckpointer` (with
`_whole_centroids` for `_host_full`), `_make_put_batch` (the host cast
of `_cast_points`), `_stream_kernel_itemsize`, `_plan_sharded_residency`,
`_sharded_stream_loop`, `streamed_kmeans_fit_sharded`,
`_ShardedFuzzyAcc`, `streamed_fuzzy_fit_sharded`, `_ShardedGMMAcc` and
`streamed_gmm_fit_sharded`; one deferred reduce serves every tower).

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

Gaussian Mixture (diag): the quantity that crosses model shards per
point is the log-normaliser, a logsumexp over every component: the
row's maximum log-probability is all-reduced (MAX) over the model axis,
then Σ exp(logp − max) (SUM). Each shard then forms its components'
responsibilities and sums Σr, Σr·x and Σr·x² over the data axis; the
M-step is the 1-D fits' (`models/gmm._m_step`), the weights normalised
over every shard. The E-step is plain f32 products, as the JAX tower's
XLA step: no kernel runs on this tower.

The fuzzy and GMM towers split rows np.array_split-wise, so a ragged N
gives the ranks unequal rows and pads nothing: the JAX package's
zero-row padding and its exact corrections (`_pad_rows_sharded`,
`_fuzzy_pad_correction`, `_gmm_pad_correction`) have nothing to correct
here. The K-Means tower refuses a ragged N, as the JAX one does. The
loops run on the host, reading the shift (the GMM's log-likelihood) once
per iteration; it comes from the all-reduced stats, so every rank takes
the same branch. Every rank returns the whole (K, d) centroids,
assembled by an all_reduce of a zero (K, d) buffer in which each model
shard fills its own rows. The collectives are all_reduce and broadcast
only, which gloo takes on CUDA tensors.

`padding_correction` is the exact zero-row correction the 1-D streamed
fits apply where a rank's slice of a batch is padded
(`models/streaming.py`).

The streamed towers (`streamed_kmeans_fit_sharded`,
`streamed_fuzzy_fit_sharded`, `streamed_gmm_fit_sharded`) run on the
1-D streamed fits' machinery
(`models/streaming._Pass` and `_fit_loop`: the ingest guard, the
heartbeat, the SIGTERM drain, mid-pass checkpoints): each rank copies its
data coordinate's rows of every batch, unpadded, so the JAX towers'
zero-row padding and its correction (`_pad_rows_sharded`,
`_fuzzy_pad_correction`) have nothing to do; each batch's stats of a
rank's K/P centroids accumulate across the pass, reduced over the data
axis per batch ('per_batch') or once a pass ('per_pass', the add in
place). A checkpoint holds the whole (K, d) state: the ranks of rank 0's
model row gather their shards before rank 0 writes
(`_GatheringCheckpointer`), and a restore slices each rank's rows out,
so a save on one (data, model) split resumes on another. The GMM tower
is not guarded and saves per iteration in the JAX package's
`gmm_sharded` meta, gathered the same way (`_GMMCheckpoints`), and
refuses a restore on another model axis, as the JAX tower does.

Residency (`residency=` of the streamed K-Means and fuzzy towers, the
1-D fits' modes): every rank streams the same batches and keeps its
data coordinate's rows, so a rank's cache (or spill ring) holds those
rows, the same on every rank of a model row: the cache is replicated
across the model axis (`_plan_sharded_residency` budgets N / n_data rows
a rank). Iterations 2..N run over it; every rank of the gang must have
filled its cache, or all stream.

Not ported: the compressed gathers (`parallel/gather.py`), the mesh
spec and the supervisor (ROADMAP.md Queue A, A9), coarse and bounded
assignment (A10).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
from tdc_tpu_torch.parallel import reduce as reduce_lib
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


def _fuzzy_partials(mesh: Mesh, m: float, eps: float, block_rows: int,
                    kernel: str):
    """fn(x_loc, c_loc) → (Σμx (K/P, d), Σμ (K/P,), J_m ()) of this rank's
    rows and model shard, summed over neither axis: the per-row
    normaliser s crosses the model axis inside (one all_reduce per block
    on 'xla', one per call on the kernel route). The 'xla' blocks are
    block_rows rows (0: all), the last one ragged."""
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
    return local_pallas if kernel == "pallas" else local_xla


def make_sharded_fuzzy_stats(mesh: Mesh, m: float = 2.0, eps: float = 1e-9,
                             block_rows: int = 0, kernel: str = "xla"):
    """fn(x_loc, c_loc) → FuzzyStats of this rank's model shard: Σμx
    (K/P, d) and Σμ (K/P,) summed over the data axis, the objective over
    both axes. x_loc is this rank's rows, c_loc its K/P centroids.
    kernel='pallas' runs B7 and B8 (internally blocked: block_rows does
    not apply); 'xla' takes block_rows rows at a time (0: all), with one
    all_reduce of the block's s."""
    local = _fuzzy_partials(mesh, m, eps, block_rows, kernel)

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


def _row_blocks(x_loc, block_rows: int, kernel: str,
                ragged: bool = False) -> list:
    """This rank's rows as the towers take them: block_rows at a time on
    'xla' (its (block, K/P) distances bound the memory; the rows must be
    a multiple, or with `ragged` the last block is shorter: the streamed
    towers pad nothing), at once on the kernel route, which has no such
    buffer."""
    n_loc = x_loc.shape[0]
    if not (block_rows and n_loc > block_rows and kernel != "pallas"):
        return [x_loc]
    if n_loc % block_rows != 0 and not ragged:
        raise ValueError(
            f"local shard rows {n_loc} not divisible by "
            f"block_rows={block_rows}"
        )
    return list(x_loc.split(block_rows))


def _lloyd_partials(x_loc, c_loc, kernel: str, mesh: Mesh, block_rows: int,
                    shifted: bool, ragged: bool = False):
    """(sums (K/P, d), counts (K/P,), sse ()) of this rank's rows and
    model shard, summed over the blocks (`_row_blocks`), not over the
    data axis."""
    k_per, d = c_loc.shape
    sums = torch.zeros((k_per, d), dtype=torch.float32, device=x_loc.device)
    counts = torch.zeros(k_per, dtype=torch.float32, device=x_loc.device)
    sse = torch.zeros((), dtype=torch.float32, device=x_loc.device)
    for blk in _row_blocks(x_loc, block_rows, kernel, ragged):
        s, ct, e = _block_stats(blk, c_loc, kernel, mesh, shifted)
        sums, counts, sse = sums + s, counts + ct, sse + e
    return sums, counts, sse


def make_sharded_stats(mesh: Mesh, kernel: str = "xla", block_rows: int = 0,
                       shifted: bool = False):
    """fn(x_loc, c_loc) → (sums (K/P, d), counts (K/P,), sse ()) of this
    rank's model shard, summed over the data axis; sse is the same on
    every rank. x_loc is this rank's rows, c_loc its K/P centroids.
    block_rows > 0 takes the rows that many at a time on 'xla'.
    shifted=True returns sse without Σ‖x‖² (see `_block_champions`)."""

    def stats(x_loc, c_loc):
        k_per, d = c_loc.shape
        sums, counts, sse = _lloyd_partials(x_loc, c_loc, kernel, mesh,
                                            block_rows, shifted)
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
        new_c = _lloyd_update(sums, counts, c_loc, spherical)
        return new_c, _shard_shift(new_c, c_loc, mesh), sse

    return step


def _lloyd_update(sums, counts, c_loc, spherical: bool) -> torch.Tensor:
    """A model shard's new centroids: the mean of its rows, an empty
    cluster kept where it was; L2-normalized when spherical."""
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp_min(counts[:, None], 1.0), c_loc)
    return _normalize(new_c) if spherical else new_c


def _shard_shift(new_c, c_loc, mesh: Mesh) -> torch.Tensor:
    """The largest centroid movement over every model shard."""
    return _model_max(torch.linalg.norm(new_c - c_loc, dim=-1).max(), mesh)


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
    """The (K, ...) whole of a K-sharded tensor (centroids, sums, counts)
    on every rank of this rank's model row: a zero buffer, this shard's
    rows filled, summed over the model axis (exact: the rest are 0)."""
    k_per = c_loc.shape[0]
    n_model = mesh.axis_size(MODEL_AXIS)
    j = mesh.axis_index(MODEL_AXIS)
    full = torch.zeros((k_per * n_model, *c_loc.shape[1:]),
                       dtype=c_loc.dtype, device=c_loc.device)
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
        return new_c, _shard_shift(new_c, c_loc, mesh), fs.objective

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


# ---------------------------------------------------------------------------
# The Gaussian Mixture tower
# ---------------------------------------------------------------------------


class _ShardedGMMAcc(NamedTuple):
    """The diag E-step's sums on one rank: the log-likelihood over its
    rows (the same on every model shard: the normaliser is global), and
    Σr (K/P,), Σr·x and Σr·x² (K/P, d) of its model shard."""

    ll: torch.Tensor
    nk: torch.Tensor
    sx: torch.Tensor
    sxx: torch.Tensor


def _gmm_partials(mesh: Mesh, x_loc, means_loc, var_loc, w_loc,
                  block_rows: int, ragged: bool = False) -> _ShardedGMMAcc:
    """The E-step sums of this rank's rows and model shard, summed over
    the blocks (`_row_blocks`), not over the data axis. Each block's rows
    go to f32; logp is the JAX package's expanded form, xsq @ inv.T −
    2·x @ (μ·inv).T + Σμ²·inv; the row's log-normaliser is a logsumexp
    across the model axis: an all_reduce MAX of the (b, 1) maxima, then a
    SUM of Σ exp(logp − max)."""
    import torch.distributed as dist

    from tdc_tpu_torch.models.gmm import _LOG_2PI

    k_per, d = means_loc.shape
    inv = 1.0 / var_loc
    log_det = torch.log(var_loc).sum(dim=1)
    log_w = torch.log(w_loc)
    mu_inv = means_loc * inv
    bias = (means_loc * means_loc * inv).sum(dim=1)
    dev = x_loc.device
    acc = _ShardedGMMAcc(
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.zeros(k_per, dtype=torch.float32, device=dev),
        torch.zeros((k_per, d), dtype=torch.float32, device=dev),
        torch.zeros((k_per, d), dtype=torch.float32, device=dev))
    for blk in _row_blocks(x_loc, block_rows, "xla", ragged):
        xf = blk.float()
        xsq = xf * xf
        # In place, in the JAX order: (maha + log_det + d·log 2π)·(−½)
        # + log w; one (b, K/P) buffer becomes logp, then r.
        logp = xsq @ inv.T
        logp.addmm_(xf, mu_inv.T, alpha=-2.0)
        logp.add_(bias).add_(log_det).add_(d * _LOG_2PI).mul_(-0.5)
        logp.add_(log_w)
        mx = mesh.psum(logp.max(dim=1, keepdim=True).values, MODEL_AXIS,
                       op=dist.ReduceOp.MAX)
        e = (logp - mx).exp_()
        se = mesh.psum(e.sum(dim=1, keepdim=True), MODEL_AXIS)
        del e
        norm = mx + torch.log(se)
        r = logp.sub_(norm).exp_()
        acc = _ShardedGMMAcc(acc.ll + norm.sum(), acc.nk + r.sum(dim=0),
                             acc.sx + r.T @ xf, acc.sxx + r.T @ xsq)
    return acc


def make_sharded_gmm_stats(mesh: Mesh, block_rows: int = 0):
    """fn(x_loc, means_loc, var_loc, w_loc) → (ll, nk, sx, sxx): the
    K-sharded diag-GMM E-step of this rank's rows against its K/P
    components, Σr, Σr·x and Σr·x² summed over the data axis, and ll,
    the sum of every row's log-normaliser, the same on every rank (it
    crosses the data axis only: the normaliser is global already). The
    cross-shard quantity is the per-row logsumexp (`_gmm_partials`).
    block_rows > 0 takes the rows that many at a time; they must be a
    multiple of it, as in the JAX package. Plain large products, as the
    JAX package's XLA matmuls: no kernel."""

    def stats(x_loc, means_loc, var_loc, w_loc) -> _ShardedGMMAcc:
        part = _gmm_partials(mesh, x_loc, means_loc, var_loc, w_loc,
                             block_rows)
        return reduce_lib.tree_all_reduce(part, mesh, (DATA_AXIS,))

    return stats


def _model_sum(mesh: Mesh):
    """total(w) for `models/gmm._m_step`: Σ of every model shard's w."""
    return lambda w: mesh.psum(w.sum().reshape(1), MODEL_AXIS)[0]


def _refuse_gmm(label: str, k: int, n_model: int, init) -> None:
    """The K-sharded GMM towers' refusals, in the JAX words."""
    if k % n_model != 0:
        raise ValueError(f"K={k} not divisible by model axis {n_model}")
    if isinstance(init, str) and init == "kmeans":
        if label == "gmm_fit_sharded":
            raise ValueError(
                "gmm_fit_sharded seeds from a host subsample "
                "(_resolve_init_sharded); init='kmeans' (a full K-Means "
                "pre-fit) is the unsharded gmm_fit's mode — pass "
                "'kmeans++' or an array")
        raise ValueError(
            "streamed_gmm_fit_sharded seeds from a host subsample; "
            "init='kmeans' (a full K-Means pre-fit) is the unsharded mode")


def _gmm_start(sample, k: int, init, generator, mesh: Mesh, reg: float):
    """(means, variances, weights), whole, the same bits on every rank:
    the means are `init` (an array, or a name that rank 0 resolves on
    `sample` and broadcasts), the variances and weights the hard
    assignment's moments on `sample` (`models/gmm._moments_from_hard_
    assign`), also rank 0's."""
    from tdc_tpu_torch.models.gmm import _moments_from_hard_assign

    if isinstance(init, str):
        means = resolve_init_replicated(sample, k, init, generator, mesh)
    else:
        # A copy: the broadcast writes into it (an array init is the
        # caller's own).
        means = replicate(
            _resolve_init_sharded(sample, k, init, generator).clone(), mesh)
    means = means.to(torch.float32).clone()
    if means.shape != (k, sample.shape[1]):
        raise ValueError(
            f"init means shape {tuple(means.shape)} != {(k, sample.shape[1])}"
            " — either the rows don't match d, or an explicit init array "
            "has the wrong feature width")
    var, w = _moments_from_hard_assign(sample, means, reg)
    return means, replicate(var.contiguous(), mesh), replicate(
        w.contiguous(), mesh)


def _model_rows(mesh: Mesh, *ts) -> list:
    """This rank's K/P rows of each whole (K, ...) tensor."""
    n_model = mesh.axis_size(MODEL_AXIS)
    j = mesh.axis_index(MODEL_AXIS)
    out = []
    for t in ts:
        k_per = t.shape[0] // n_model
        out.append(t[j * k_per:(j + 1) * k_per].contiguous())
    return out


def gmm_fit_sharded(
    x,
    k: int,
    mesh: Mesh,
    *,
    init="kmeans++",
    generator: torch.Generator | None = None,
    max_iters: int = 100,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    block_rows: int = 0,
    dtype=None,
    device=None,
):
    """Diag-covariance GMM EM with the rows sharded over 'data' and the
    components over 'model' (`make_mesh_2d`). Every rank passes the same
    x. The means come from `init` (an array, or a name resolved by rank 0
    on the first ≤ 65,536 rows); the variances and weights from the hard
    assignment to them on those rows. Each iteration is one E-step
    (`make_sharded_gmm_stats`: the distributed logsumexp) and the shared
    M-step (`models/gmm._m_step`, the weights normalised over every
    shard). It stops at max_iters, or once i >= 2 and the mean
    log-likelihood gain ll − prev_ll <= tol (compared in f32, as the JAX
    loop compares on the device). dtype (torch.bfloat16) converts each
    rank's rows; the E-step still runs in f32.

    Each rank takes its np.array_split rows and pads nothing: the results
    equal the JAX tower's zero-row-corrected ones (`_gmm_pad_correction`)
    to f32 order. block_rows > 0 takes a rank's rows that many at a time
    (the last block shorter). No kernel runs: the E-step is plain large
    products, as the JAX tower's XLA step.

    Returns a GMMResult with the whole (K, d) means and variances and
    the (K,) weights on every rank; log_likelihood is the last E-step's
    mean (before its M-step, as in the JAX package: no rescoring pass);
    converged = n_iter >= 2 and the last gain <= tol."""
    from tdc_tpu_torch.models.gmm import GMMResult, _m_step

    n_model = mesh.axis_size(MODEL_AXIS)
    _refuse_gmm("gmm_fit_sharded", k, n_model, init)
    dev = resolve_device(device)
    x = _as_points(x, dev)
    n = x.shape[0]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    means, var, w = _gmm_start(x[:min(n, 65536)].float(), k, init,
                               generator, mesh, float(reg_covar))
    x_loc = shard_points(x, mesh)
    if dtype is not None:
        x_loc = x_loc.to(dtype)
    del x
    means, var, w = _model_rows(mesh, means, var, w)
    block_rows, total = int(block_rows), _model_sum(mesh)

    def step(means, var, w):
        part = _gmm_partials(mesh, x_loc, means, var, w, block_rows,
                             ragged=True)
        ll, nk, sx, sxx = reduce_lib.tree_all_reduce(part, mesh,
                                                     (DATA_AXIS,))
        return (ll / n, *_m_step(nk, sx, sxx, n, float(reg_covar), total))

    tol32 = np.float32(tol)
    prev_ll = ll = np.float32(-np.inf)
    n_iter = 0
    while n_iter < max_iters and (n_iter < 2 or ll - prev_ll > tol32):
        step_ll, means, var, w = step(means, var, w)
        prev_ll, ll = ll, np.float32(step_ll.item())
        n_iter += 1
    return GMMResult(
        means=_whole_centroids(means, mesh),
        variances=_whole_centroids(var, mesh),
        weights=_whole_centroids(w, mesh), n_iter=n_iter,
        log_likelihood=torch.tensor(float(ll), dtype=torch.float32,
                                    device=dev),
        converged=bool(n_iter >= 2 and float(ll) - float(prev_ll) <= tol),
        covariance_type="diag")


# ---------------------------------------------------------------------------
# The streamed towers
# ---------------------------------------------------------------------------


class _ShardedAcc(NamedTuple):
    """A streamed K-Means pass's accumulator on one rank: its model
    shard's Σx (K/P, d) and counts (K/P,), and the SSE (the same on every
    rank): Σ shifted minima + Σ‖x‖², clamped at 0 where it is read."""

    sums: torch.Tensor
    counts: torch.Tensor
    sse: torch.Tensor


class _ShardedFuzzyAcc(NamedTuple):
    """A streamed fuzzy pass's accumulator on one rank: its model shard's
    Σμx (K/P, d) and Σμ (K/P,), and J_m over every shard."""

    wsums: torch.Tensor
    weights: torch.Tensor
    obj: torch.Tensor


def make_sharded_deferred_reduce(mesh: Mesh):
    """The per-pass reduce of the streamed K-sharded towers: fn(acc,
    extra=None) → `acc` summed over the data axis in ONE all_reduce (the
    fields packed into one buffer, `extra` riding along and returned
    summed, as `parallel.reduce.tree_all_reduce`). The model axis is
    untouched: each rank keeps its shard. It serves the fuzzy tower too
    (the JAX package's `make_sharded_fuzzy_deferred_reduce`), whose J_m
    is summed over the model axis per batch, beside the normaliser s
    that crosses it anyway (JAX sums J_m over both axes here)."""

    def reduce(acc, extra=None):
        return reduce_lib.tree_all_reduce(acc, mesh, (DATA_AXIS,), extra)

    return reduce


def make_sharded_deferred_accumulate(stats_fn):
    """fn(acc, *args) adding `stats_fn(*args)` (one batch's partials of
    this rank's rows) into the per-pass accumulator IN PLACE, field by
    field in f32: no second generation of the accumulator is kept live
    (the JAX version donates it)."""

    def accumulate(acc, *args):
        for a, part in zip(acc, stats_fn(*args)):
            a.add_(part.float())
        return acc

    return accumulate


class _GatheringCheckpointer:
    """`models/streaming._StreamCheckpointer` for the K-sharded towers:
    a save writes the whole (K, d) state (centroids, and a mid-pass
    accumulator's sums and counts) with the layout manifest, so a save
    taken on one (data, model) split restores on another; a restore
    slices this rank's K/P rows out of the whole.

    Every rank is a process: rank 0 writes, and it holds one model shard.
    So the ranks of rank 0's model row (data coordinate 0) gather their
    shards over the model axis first (an all_reduce of zero buffers);
    the other ranks gather nothing and hand the writer's protocol
    placeholders it never reads (they only meet at its barrier)."""

    def __init__(self, inner, mesh: Mesh):
        self.inner, self.mesh = inner, mesh

    def __getattr__(self, name):
        return getattr(self.inner, name)  # dir, gang, device

    def restore(self, acc_cls):
        state = self.inner.restore(acc_cls)
        if state.centroids is None:
            return state
        n_model = self.mesh.axis_size(MODEL_AXIS)
        k_per = state.centroids.shape[0] // n_model
        j = self.mesh.axis_index(MODEL_AXIS)

        def mine(t):
            return t[j * k_per:(j + 1) * k_per].contiguous()

        acc = None if state.acc is None else acc_cls(
            mine(state.acc[0]), mine(state.acc[1]), state.acc[2])
        return state._replace(centroids=mine(state.centroids), acc=acc)

    def save(self, n_iter, c, shift, history, *, batch_cursor=0, acc=None,
             rows_seen=0) -> None:
        if self.mesh.axis_index(DATA_AXIS) == 0:
            c = _whole_centroids(c, self.mesh)
            if acc is not None:
                acc = type(acc)(_whole_centroids(acc[0], self.mesh),
                                _whole_centroids(acc[1], self.mesh), acc[2])
        else:
            c = torch.zeros((0, 0))
            if acc is not None:
                acc = type(acc)(*(torch.zeros(0) for _ in acc))
        self.inner.save(n_iter, c, shift, history, batch_cursor=batch_cursor,
                        acc=acc, rows_seen=rows_seen)


def _make_put_batch(d: int, mesh: Mesh, dtype, book=None):
    """The host side of a batch for the streamed K-sharded towers: the
    width contract, this rank's rows along the data axis (np.array_split
    bounds: the ranks of a model row take the same rows), cast to `dtype`
    on the host. Nothing is padded, so nothing needs the JAX towers'
    zero-row correction (`padding_correction`, `_fuzzy_pad_correction`).
    `book(rows)` sees every staged batch's global row count."""
    from tdc_tpu_torch.models.streaming import _stage

    def put_batch(batch):
        sb = _stage(batch, d, mesh, False, pad=False, cast=dtype)
        if book is not None:
            book(sb.rows)
        return sb

    return put_batch


def _stream_kernel_itemsize(batches, dtype) -> int:
    """The bytes of one element the kernels see in a streamed fit: the
    host cast's dtype where one is asked for, else the stream's own
    (`data/device_cache.stream_itemsize`), else f32's."""
    from tdc_tpu_torch.data import device_cache as cache_lib

    if dtype is not None:
        return torch.empty(0, dtype=dtype).element_size()
    return cache_lib.stream_itemsize(batches) or 4


def _refuse_sharded(label: str, *, residency: str, gather: str,
                    assign: str = "exact", probe=None) -> None:
    """The options of the streamed K-sharded towers that are not ported,
    each naming its ROADMAP.md item (`kmeans_fit_sharded`'s form)."""
    from tdc_tpu_torch.data.device_cache import RESIDENCY_MODES

    if residency not in RESIDENCY_MODES:
        raise ValueError(f"residency={residency!r}: use one of "
                         f"{RESIDENCY_MODES}")
    if gather != "fp32":
        raise _not_ported(f"{label}(gather={gather!r})",
                          "Queue A, A9: parallel/gather.py")
    if assign != "exact" or probe is not None:
        raise _not_ported(f"{label}(assign={assign!r}, probe={probe!r})",
                          "Queue A, A10: ops/subk.py, ops/bounds.py")


def _champion_booking(counter_of, mesh: Mesh, pad_multiple: int,
                      block_rows: int):
    """book(rows) for one staged batch: the model-axis bytes of its
    champion (min, argmin) exchange, as the JAX towers book them (two
    gathers of the batch padded to `pad_multiple` rows, one pair per
    block); nothing without a model axis to cross."""
    n_data = mesh.axis_size(DATA_AXIS)
    n_model = mesh.axis_size(MODEL_AXIS)

    def book(rows: int) -> None:
        if n_model <= 1:
            return
        padded = -(-rows // pad_multiple) * pad_multiple
        rows_loc = padded // n_data
        gathers = 2
        if block_rows and rows_loc > block_rows:
            gathers *= rows_loc // block_rows
        counter_of().add(0, 2 * n_model * padded * 4, axis="model",
                         gathers=gathers)

    return book


def _plan_sharded_residency(residency, batches, k, d, mesh: Mesh, *,
                            block_rows, kernel, dtype, cursor, label,
                            mid_pass_ckpt, device):
    """The residency planner of the streamed K-sharded towers (the JAX
    package's `_plan_sharded_residency`): every rank streams the same
    batches and keeps its data coordinate's rows, so the cache is
    replicated across the model axis and the budget divides by the data
    axis, not the world; the batches are budgeted at the JAX towers'
    padding (n_data × block_rows) and at the kernels' itemsize (the host
    cast's, else the stream's own). Returns (plan, cache builder or
    None); 'stream' returns (None, None)."""
    from tdc_tpu_torch.data import device_cache as cache_lib

    if residency == "stream":
        return None, None
    n_data = mesh.axis_size(DATA_AXIS)
    plan = cache_lib.plan_residency(
        residency, hints=cache_lib.stream_hints(batches), d=d, k=k,
        n_devices=n_data, pad_multiple=n_data * max(block_rows, 1),
        itemsize=_stream_kernel_itemsize(batches, dtype), weighted=False,
        kernel=kernel, cursor=cursor, mid_pass_ckpt=mid_pass_ckpt,
        device=device, label=label)
    builder = (cache_lib.DeviceCacheBuilder(plan.hints.n_batches,
                                            label=label)
               if plan.resident else None)
    return plan, builder


def _booked_as_taken(ring, book):
    """The spill ring's staged batches, each booked (`book(rows)`) as the
    pass takes it: the ring stages ahead, into the next pass too."""

    def batches():
        for sb in ring():
            book(sb.n_local)
            yield sb

    return batches


def _sharded_machine(stream, *, guard, d, k, mesh, dev, prefetch,
                     strategy, shapes, local, dtype, block_rows,
                     champions: bool, plan=None):
    """The `models/streaming._Pass` of a streamed K-sharded tower over
    `stream` (the guarded stream, `data/ingest.guard_stream`, or the
    GMM tower's own): this rank's rows unpadded (`_make_put_batch`), the
    per-pass add in place and ONE data-axis reduce, the comms booked at
    the logical (K, d) shapes on the data axis and, with `champions`
    (K-Means), the champion exchange on the model axis. On the spill
    tier (`plan`) the pinned ring stages the same rows
    (`data/spill.wrap_stream`). Returns (machine, the stream to release
    after the fit, its H2DCounter or None)."""
    from tdc_tpu_torch.data import spill as spill_lib
    from tdc_tpu_torch.models.streaming import _Pass, _put_staged

    book = None
    if champions:
        book = _champion_booking(
            lambda: machine.counter, mesh,
            mesh.axis_size(DATA_AXIS) * max(block_rows, 1), block_rows)
    put_batch = _make_put_batch(d, mesh, dtype)
    ring, h2d = spill_lib.wrap_stream(
        plan, stream, lambda batch, put: _put_staged(put_batch(batch), put),
        device=dev)
    if h2d is None:
        batches, stage = stream, _make_put_batch(d, mesh, dtype, book)
    else:
        batches = ring if book is None else _booked_as_taken(ring, book)
        stage, prefetch = put_batch, 0
    machine = _Pass(
        batches, d=d, mesh=mesh, device=dev, prefetch=prefetch,
        weighted=False, strategy=strategy, shapes=shapes,
        local=local, correct=None, guard=guard, stage=stage,
        deferred_fns=(lambda: reduce_lib.zero_deferred(shapes, dev),
                      make_sharded_deferred_accumulate(local),
                      make_sharded_deferred_reduce(mesh)),
        cost_shapes=type(shapes)(*(
            (k, *s[1:]) if len(s) else s for s in shapes)))
    return machine, ring, h2d


def _sharded_stream_loop(machine, ring, ckpt, state, c_loc, update, *,
                         mesh, max_iters, tol, ckpt_every,
                         ckpt_every_batches, cost, plan, builder, label):
    """The iteration driver of the streamed K-sharded towers, on the
    streamed fits' loop (`models/streaming._fit_loop`): resume from the
    restored state (the interrupted pass's cursor and accumulator
    first), one pass an iteration (`_Pass.run`: the stream read once,
    each batch's stats on this rank's rows and model shard), the update,
    the shift over every model shard read once an iteration when tol >=
    0 or checkpointing, the saves, the heartbeat and the SIGTERM drain
    (exit 75; the gang's flags agree over both axes). Under 'hbm'
    (`plan`, `builder`) the first pass fills this rank's cache and
    iterations 2..N run over it (`_Pass.run_cached`), once every rank of
    the gang has one. One more pass scores the returned centroids; the
    spill ring (`ring`) is released after it. Returns (c_loc, n_iter,
    start_iter, shift, history, the final pass's accumulator)."""
    from tdc_tpu_torch.data import spill as spill_lib
    from tdc_tpu_torch.models.streaming import _final_stats, _fit_loop

    try:
        c_loc, n_iter, shift, history, start_iter, cache = _fit_loop(
            machine, ckpt, state, c_loc, update, max_iters=max_iters,
            tol=tol, ckpt_every=ckpt_every,
            ckpt_every_batches=ckpt_every_batches, mass=None, cost=cost,
            plan=plan, builder=builder, label=label,
            shift_fn=lambda new_c, c: _shard_shift(new_c, c, mesh))
        final = _final_stats(machine, cache, c_loc, ckpt.gang)
    finally:
        spill_lib.release(ring)
    return c_loc, n_iter, start_iter, shift, history, final


def _sharded_setup(batches, k, d, mesh, *, init, generator, spherical,
                   ckpt_dir, ckpt_every_batches, strategy, ingest, params,
                   acc_map, acc_cls, dev, label):
    """What both streamed towers do before their loop, in the JAX order:
    the guard, the checkpointer (restored FIRST: a resume re-pays no
    init), then the init (an array, or a name resolved by rank 0 on the
    first ≤ 65,536 rows of the stream's first batch and broadcast).
    Returns (guard, ckpt, state, this rank's K/P centroids)."""
    from tdc_tpu_torch.data import ingest as ingest_lib
    from tdc_tpu_torch.models.streaming import (
        _check_equal_local_rows,
        _reduce_plan,
        _resolve_stream_init,
        _StreamCheckpointer,
    )

    guard = ingest_lib.guard_stream(batches, ingest, d=d, label=label)
    ckpt = _GatheringCheckpointer(_StreamCheckpointer(
        ckpt_dir, k, d, params=params, acc_map=acc_map, mesh=mesh,
        device=dev, guard=guard), mesh)
    state = ckpt.restore(acc_cls)
    if state.cursor:
        # A mid-pass (per-batch) checkpoint cannot resume under per_pass.
        _reduce_plan(strategy, mesh, ckpt_dir, ckpt_every_batches,
                     cursor=state.cursor, allow_quantize=False)
    if state.centroids is not None:
        return guard, ckpt, state, state.centroids
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    c, first_rows = _resolve_stream_init(
        batches, k, d, init, generator, mesh, False, dev, spherical,
        guard=guard, sample_rows=65536)
    _check_equal_local_rows(first_rows, mesh, dev)
    if spherical:
        c = _normalize(c)
    j, k_per = mesh.axis_index(MODEL_AXIS), k // mesh.axis_size(MODEL_AXIS)
    return guard, ckpt, state, c[j * k_per:(j + 1) * k_per].contiguous()


def streamed_kmeans_fit_sharded(
    batches,
    k: int,
    d: int,
    mesh: Mesh,
    *,
    init,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    spherical: bool = False,
    kernel: str = "xla",
    block_rows: int = 0,
    dtype=None,
    prefetch: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 1,
    ckpt_every_batches: int | None = None,
    reduce="per_batch",
    residency: str = "stream",
    ingest=None,
    assign: str = "exact",
    probe=None,
    gather: str = "fp32",
    device=None,
) -> KMeansResult:
    """Exact out-of-core Lloyd with the rows sharded over 'data' and the
    centroids over 'model' (`make_mesh_2d`): the BASELINE config-5 regime
    (K=16,384, d=768, bf16), streamed. `batches` is the streamed fits'
    zero-arg callable of (rows, d) batches, the same on every rank; each
    rank copies only its data coordinate's rows of each batch (no
    padding), and each batch's stats of its K/P centroids accumulate
    across the pass (B2 + B3 on kernel='pallas', as `kmeans_fit_sharded`;
    'xla' takes block_rows rows at a time, the last block shorter). The
    champions and the SSE follow `kmeans_fit_sharded`: shifted minima,
    Σ‖x‖² added back per batch, so one batch on per_batch gives that
    fit's bits.

    reduce: 'per_batch' (one data-axis all_reduce a batch; exact, bitwise
    resumable mid-pass) or 'per_pass' (each rank's partials accumulate in
    place, one data-axis all_reduce a pass: f32 reordered, no mid-pass
    checkpoint); 'per_pass:bf16|int8' raise, as in the JAX package.
    dtype (torch.bfloat16) casts each rank's rows on the host; the stats
    stay f32. spherical normalizes rows and centroids. init: a (K, d)
    array or a name (`_sharded_setup`). prefetch, ingest (the guard:
    retries, quarantine, loss budget), ckpt_dir / ckpt_every /
    ckpt_every_batches (the gathered (K, d) state and the layout
    manifest: a save on one (data, model) split restores on another) as
    the 1-D streamed fits. kernel: 'xla', 'pallas' or 'auto'.

    residency: 'stream', 'hbm', 'spill' or 'auto', as the 1-D streamed
    fits (`models/streaming.py`), planned by `_plan_sharded_residency`:
    each rank caches (or stages through the pinned ring) its data
    coordinate's rows, the same on every rank of a model row; every mode
    gives the bits of 'stream' on every rank. A cached pass books its
    data-axis reduces and, as the JAX tower, no champion exchange.

    Not ported, raising NotImplementedError that names ROADMAP.md Queue A:
    assign / probe other than exact (A10), gather other than 'fp32' (A9,
    parallel/gather.py).

    Returns the whole (K, d) centroids on every rank, n_iter, the SSE at
    them (one more pass), shift, converged, the (n_iter, 2) [sse, shift]
    history, n_iter_run, `comms` (data-axis reduces and bytes, model-axis
    champion exchanges and bytes), the spill ring's `h2d` report (None
    off the spill tier) and the ingest report."""
    from tdc_tpu_torch.models.streaming import _history_array, _reduce_plan
    from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

    label = "streamed_kmeans_fit_sharded"
    n_data = mesh.axis_size(DATA_AXIS)
    n_model = mesh.axis_size(MODEL_AXIS)
    if k % n_model != 0:
        raise ValueError(f"K={k} not divisible by model axis {n_model}")
    _refuse_sharded(label, residency=residency, gather=gather,
                    assign=assign, probe=probe)
    dev = resolve_device(device)
    kernel = resolve_kernel(kernel, k=k // n_model, d=d, device=dev,
                            model="kmeans_sharded", label=label,
                            itemsize=_stream_kernel_itemsize(batches, dtype))
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    strategy = reduce_lib.resolve_reduce(reduce)
    _reduce_plan(strategy, mesh, ckpt_dir, ckpt_every_batches,
                 allow_quantize=False)
    guard, ckpt, state, c_loc = _sharded_setup(
        batches, k, d, mesh, init=init, generator=generator,
        spherical=spherical, ckpt_dir=ckpt_dir,
        ckpt_every_batches=ckpt_every_batches, strategy=strategy,
        ingest=ingest, params={"spherical": bool(spherical)},
        acc_map={"acc_sums": "sums", "acc_counts": "counts",
                 "acc_sse": "sse"},
        acc_cls=_ShardedAcc, dev=dev, label=label)
    block_rows = int(block_rows)

    def local(xb, wb, c):
        if spherical:
            xb = _normalize(xb.float())  # zero rows stay zero
        sums, counts, sse = _lloyd_partials(xb, c, kernel, mesh, block_rows,
                                            shifted=True, ragged=True)
        return _ShardedAcc(sums, counts, sse + sum_sq(xb))

    k_per = k // n_model
    plan, builder = _plan_sharded_residency(
        residency, batches, k, d, mesh, block_rows=block_rows,
        kernel=kernel, dtype=dtype, cursor=state.cursor, label=label,
        mid_pass_ckpt=ckpt_every_batches is not None, device=dev)
    machine, ring, h2d = _sharded_machine(
        guard, guard=guard, d=d, k=k, mesh=mesh, dev=dev,
        prefetch=prefetch, strategy=strategy,
        shapes=_ShardedAcc((k_per, d), (k_per,), ()), local=local,
        dtype=dtype, block_rows=block_rows, champions=True, plan=plan)
    c_loc, n_iter, start_iter, shift, history, final = _sharded_stream_loop(
        machine, ring, ckpt, state, c_loc,
        lambda acc, c: _lloyd_update(acc.sums, acc.counts, c, spherical),
        mesh=mesh, max_iters=max_iters, tol=tol, ckpt_every=ckpt_every,
        ckpt_every_batches=ckpt_every_batches,
        cost=lambda acc: torch.clamp_min(acc.sse, 0.0), plan=plan,
        builder=builder, label=label)
    return KMeansResult(
        centroids=_whole_centroids(c_loc, mesh), n_iter=n_iter,
        sse=torch.clamp_min(final.sse, 0.0),
        shift=torch.tensor(shift, dtype=torch.float32, device=dev),
        converged=bool(tol >= 0 and shift <= tol),
        history=_history_array(history), n_iter_run=n_iter - start_iter,
        comms=machine.report(),
        h2d=None if h2d is None else h2d.report(plan.spill_slots),
        ingest=guard.report())


def streamed_fuzzy_fit_sharded(
    batches,
    k: int,
    d: int,
    mesh: Mesh,
    *,
    m: float = 2.0,
    init,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    kernel: str = "xla",
    block_rows: int = 0,
    dtype=None,
    prefetch: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 1,
    ckpt_every_batches: int | None = None,
    reduce="per_batch",
    residency: str = "stream",
    ingest=None,
    gather: str = "fp32",
    device=None,
) -> FuzzyCMeansResult:
    """Exact out-of-core Fuzzy C-Means under the (data, model) grid: the
    contract of `streamed_kmeans_fit_sharded` with the fuzzy tower's
    stats (`fuzzy_fit_sharded`: B7, the all_reduce of each row's
    normaliser s over the model axis, then B8 on kernel='pallas'; plain
    ops block_rows rows at a time on 'xla', 0: the blocks sized from the
    device's memory). s crosses the model axis every batch under
    'per_pass' too; J_m is summed over the model axis per batch, the
    data axis with the stats; `residency` as the K-Means tower. Returns
    the whole (K, d) centroids on every rank, n_iter, the objective at
    them, shift, converged, the [objective, shift] history, n_iter_run,
    comms, h2d and the ingest report."""
    from tdc_tpu_torch.models.streaming import _history_array, _reduce_plan
    from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

    label = "streamed_fuzzy_fit_sharded"
    n_model = mesh.axis_size(MODEL_AXIS)
    if k % n_model != 0:
        raise ValueError(f"K={k} not divisible by model axis {n_model}")
    if m <= 1.0:
        raise ValueError(f"fuzzifier m must be > 1, got {m}")
    _refuse_sharded(label, residency=residency, gather=gather)
    dev = resolve_device(device)
    kernel = resolve_kernel(kernel, k=k // n_model, d=d, device=dev,
                            model="fuzzy_sharded", label=label,
                            itemsize=_stream_kernel_itemsize(batches, dtype))
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    strategy = reduce_lib.resolve_reduce(reduce)
    _reduce_plan(strategy, mesh, ckpt_dir, ckpt_every_batches,
                 allow_quantize=False)
    guard, ckpt, state, c_loc = _sharded_setup(
        batches, k, d, mesh, init=init, generator=generator,
        spherical=False, ckpt_dir=ckpt_dir,
        ckpt_every_batches=ckpt_every_batches, strategy=strategy,
        ingest=ingest, params={"m": float(m)},
        acc_map={"acc_wsums": "wsums", "acc_weights": "weights",
                 "acc_obj": "obj"},
        acc_cls=_ShardedFuzzyAcc, dev=dev, label=label)
    k_per = k // n_model

    def local(xb, wb, c):
        rows = int(block_rows)
        if kernel == "xla" and not rows:
            # Sized from the batch and the card's whole memory: the same
            # blocks on every pass, so a resume is bitwise.
            rows = auto_block_rows(xb.shape[0], k_per, device=dev)
        wsums, weights, obj = _fuzzy_partials(mesh, float(m), 1e-9, rows,
                                              kernel)(xb, c)
        return _ShardedFuzzyAcc(wsums, weights,
                                mesh.psum(obj.reshape(1), MODEL_AXIS)[0])

    plan, builder = _plan_sharded_residency(
        residency, batches, k, d, mesh, block_rows=int(block_rows),
        kernel=kernel, dtype=dtype, cursor=state.cursor, label=label,
        mid_pass_ckpt=ckpt_every_batches is not None, device=dev)
    machine, ring, h2d = _sharded_machine(
        guard, guard=guard, d=d, k=k, mesh=mesh, dev=dev,
        prefetch=prefetch, strategy=strategy,
        shapes=_ShardedFuzzyAcc((k_per, d), (k_per,), ()), local=local,
        dtype=dtype, block_rows=int(block_rows), champions=False, plan=plan)
    c_loc, n_iter, start_iter, shift, history, final = _sharded_stream_loop(
        machine, ring, ckpt, state, c_loc,
        lambda acc, c: acc.wsums / torch.clamp_min(acc.weights[:, None],
                                                   1e-12),
        mesh=mesh, max_iters=max_iters, tol=tol, ckpt_every=ckpt_every,
        ckpt_every_batches=ckpt_every_batches, cost=lambda acc: acc.obj,
        plan=plan, builder=builder, label=label)
    return FuzzyCMeansResult(
        centroids=_whole_centroids(c_loc, mesh), n_iter=n_iter,
        objective=final.obj,
        shift=torch.tensor(shift, dtype=torch.float32, device=dev),
        converged=bool(tol >= 0 and shift <= tol),
        history=_history_array(history), n_iter_run=n_iter - start_iter,
        comms=machine.report(),
        h2d=None if h2d is None else h2d.report(plan.spill_slots),
        ingest=guard.report())


def _gmm_stream_sample(batches, d: int, device, rows: int = 65536):
    """The stream's first ≤ `rows` rows in f32 on `device`, read across
    as many batches as that takes: the prefix the in-memory tower seeds
    from, so the two fits follow the same trajectory. Each batch is
    copied as it is read (a stream may reuse its buffer between yields).
    Returns (the rows, the first batch's row count)."""
    from tdc_tpu_torch.models.streaming import _batch_rows, _host_rows

    chunks, got, first_rows = [], 0, None
    for b in batches():
        if first_rows is None:
            first_rows = _batch_rows(b)
        chunks.append(torch.as_tensor(_host_rows(b)).to(
            device, torch.float32, copy=True))
        got += chunks[-1].shape[0]
        if got >= rows:
            break
    sample = torch.cat(chunks)[:rows]
    if sample.ndim != 2 or sample.shape[1] != d:
        raise ValueError(
            f"the stream's rows are {tuple(sample.shape[1:])}-wide, "
            f"expected ({d},)")
    return sample, first_rows


class _GMMCheckpoints:
    """The streamed K-sharded GMM fit's per-iteration checkpoints, in the
    JAX package's meta (model='gmm_sharded', k, d, reg, shard_model,
    variances, weights, ll, converged, final_ll) with the layout
    manifest. A save writes the whole (K, d) state: the ranks of rank
    0's model row gather their shards over the model axis (the
    `_GatheringCheckpointer` rule) and rank 0 writes. A restore checks
    k, d, reg_covar and the model axis, in the JAX words, and slices this
    rank's K/P rows out."""

    def __init__(self, ckpt_dir, k: int, d: int, reg: float, mesh: Mesh,
                 device):
        from tdc_tpu_torch.models.streaming import _is_gang

        self.dir, self.k, self.d, self.reg = ckpt_dir, k, d, reg
        self.mesh, self.device = mesh, device
        self.gang = _is_gang(mesh)

    def restore(self):
        """None, or (start_iter, prev_ll, final_ll or None, converged,
        this rank's (means, variances, weights))."""
        from tdc_tpu_torch.utils import checkpoint as ckpt_lib

        if self.dir is None:
            return None
        saved = ckpt_lib.restore_checkpoint(self.dir)
        if self.gang:
            from tdc_tpu_torch.parallel.mesh import check_same_on_every_rank

            check_same_on_every_rank(
                torch.tensor([-1.0 if saved is None else saved.n_iter],
                             dtype=torch.float64, device=self.device),
                what="checkpoint steps restored")
        if saved is None:
            return None
        meta = saved.meta
        if meta.get("model") != "gmm_sharded":
            raise ValueError(f"checkpoint in {self.dir} is not a K-sharded "
                             "GMM checkpoint")
        n_model = self.mesh.axis_size(MODEL_AXIS)
        if (int(meta.get("k")) != self.k or int(meta.get("d")) != self.d
                or float(meta.get("reg")) != self.reg
                or int(meta.get("shard_model")) != n_model):
            raise ValueError(
                f"checkpoint in {self.dir} was written with "
                f"k={meta.get('k')}, d={meta.get('d')}, "
                f"reg_covar={meta.get('reg')}, "
                f"shard_model={meta.get('shard_model')} — refusing to mix "
                "state")
        params = [torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
                  for a in (saved.centroids, meta["variances"],
                            meta["weights"])]
        final_ll = meta.get("final_ll")
        return (int(saved.n_iter), float(meta.get("ll", -float("inf"))),
                None if final_ll is None else float(np.asarray(final_ll)),
                bool(np.asarray(meta.get("converged", False))),
                _model_rows(self.mesh, *params))

    def save(self, n_iter, params, ll, done, final_ll=None) -> None:
        from tdc_tpu_torch.parallel import reshard as reshard_lib
        from tdc_tpu_torch.utils import checkpoint as ckpt_lib

        if self.mesh.axis_index(DATA_AXIS) == 0:
            means, var, w = (_whole_centroids(t, self.mesh) for t in params)
        else:  # placeholders: only rank 0 writes
            means = var = w = torch.zeros(0)
        meta = {"model": "gmm_sharded", "k": self.k, "d": self.d,
                "reg": self.reg,
                "shard_model": self.mesh.axis_size(MODEL_AXIS),
                "variances": var, "weights": w, "ll": float(ll),
                "converged": bool(done),
                **reshard_lib.layout_meta(self.mesh)}
        if final_ll is not None:
            meta["final_ll"] = float(final_ll)
        ckpt_lib.save_checkpoint(
            self.dir, ckpt_lib.ClusterState(
                centroids=means, n_iter=n_iter, key=None, batch_cursor=0,
                meta=meta), step=n_iter, gang=self.gang)


def streamed_gmm_fit_sharded(
    batches,
    k: int,
    d: int,
    mesh: Mesh,
    *,
    init="kmeans++",
    generator: torch.Generator | None = None,
    max_iters: int = 100,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    block_rows: int = 0,
    prefetch: int = 0,
    dtype=None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 5,
    device=None,
):
    """Exact out-of-core diag-covariance GMM EM under the (data, model)
    grid: each batch's K-sharded E-step sums (ll, Σr, Σr·x, Σr·x²; the
    `gmm_fit_sharded` tower, block_rows rows at a time, the last block
    shorter) accumulate over the pass, reduced over the data axis per
    batch; the M-step is the shared `models/gmm._m_step` of the totals.
    Each rank copies its data coordinate's rows of every batch,
    unpadded, cast to `dtype` on the host (the E-step stays f32). The
    stream is the streamed fits' zero-arg callable, the same on every
    rank, and is not guarded (as the JAX tower's): a non-finite batch
    ends the fit. The heartbeat marks every batch.

    Seeding is `gmm_fit_sharded`'s on the stream's first ≤ 65,536 rows,
    read across as many batches as that takes (the in-memory tower's
    prefix); init='kmeans' raises in the JAX words. The loop stops as
    the in-memory tower's; one more pass scores the returned parameters
    (log_likelihood).

    ckpt_dir: a checkpoint every `ckpt_every` iterations, at convergence
    and at the last (`_GMMCheckpoints`: the JAX `state.npz` meta,
    gathered to rank 0); a restore on another model axis, k, d or
    reg_covar raises. Iteration-granular: an interrupted pass runs
    again. Resuming a finished checkpoint reuses its final_ll without a
    pass. Returns a GMMResult with the whole (K, d) means and variances
    and the (K,) weights on every rank, n_iter_run and `comms`."""
    from tdc_tpu_torch.models.gmm import GMMResult, _m_step
    from tdc_tpu_torch.models.streaming import (
        _batch_rows,
        _check_equal_local_rows,
    )

    label = "streamed_gmm_fit_sharded"
    n_model = mesh.axis_size(MODEL_AXIS)
    _refuse_gmm(label, k, n_model, init)
    dev = resolve_device(device)
    reg = float(reg_covar)
    ckpt = _GMMCheckpoints(ckpt_dir, k, d, reg, mesh, dev)
    restored = ckpt.restore()
    start_iter, prev_ll, saved_final_ll, resume_converged = (
        0, -float("inf"), None, False)
    if restored is not None:
        (start_iter, prev_ll, saved_final_ll, resume_converged,
         params) = restored
        first_rows = _batch_rows(next(iter(batches())))
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        sample, first_rows = _gmm_stream_sample(batches, d, dev)
        params = _model_rows(mesh, *_gmm_start(sample, k, init, generator,
                                               mesh, reg))
        del sample
    _check_equal_local_rows(first_rows, mesh, dev)
    block_rows, k_per = int(block_rows), k // n_model
    strategy = reduce_lib.resolve_reduce("per_batch")

    def local(xb, wb, params):
        return _gmm_partials(mesh, xb, *params, block_rows, ragged=True)

    machine, ring, _ = _sharded_machine(
        batches, guard=None, d=d, k=k, mesh=mesh, dev=dev,
        prefetch=prefetch, strategy=strategy,
        shapes=_ShardedGMMAcc((), (k_per,), (k_per, d), (k_per, d)),
        local=local, dtype=dtype, block_rows=block_rows, champions=False)
    total = _model_sum(mesh)
    ll, n_iter, converged = prev_ll, start_iter, resume_converged
    for n_iter in (() if resume_converged
                   else range(start_iter + 1, int(max_iters) + 1)):
        acc, rows = machine.run(params)
        ll = float(acc.ll / rows)
        params = _m_step(acc.nk, acc.sx, acc.sxx, rows, reg, total)
        done = n_iter > 1 and ll - prev_ll <= tol
        if ckpt_dir is not None and (done or n_iter % ckpt_every == 0
                                     or n_iter == max_iters):
            ckpt.save(n_iter, params, ll, done)
        if done:
            converged = True
            break
        prev_ll = ll
    if (resume_converged or start_iter >= max_iters) \
            and saved_final_ll is not None:
        final_ll = saved_final_ll  # the finished run's scoring pass
    else:
        # The log-likelihood of the RETURNED parameters.
        acc, rows = machine.run(params)
        final_ll = float(acc.ll) / max(rows, 1)
        if ckpt_dir is not None and (converged or n_iter >= max_iters):
            ckpt.save(n_iter, params, ll, converged, final_ll=final_ll)
    means, var, w = (_whole_centroids(t, mesh) for t in params)
    return GMMResult(
        means=means, variances=var, weights=w, n_iter=n_iter,
        log_likelihood=torch.tensor(final_ll, dtype=torch.float32,
                                    device=dev),
        converged=converged, n_iter_run=n_iter - start_iter,
        covariance_type="diag", comms=machine.report())
