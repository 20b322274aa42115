"""Mini-batch K-Means (counterpart: tdc_tpu/models/minibatch.py;
BASELINE.json config 3).

The reference approximates out-of-core K-Means by a full Lloyd fit per
batch and the unweighted mean of the per-batch centroids
(scripts/distribuitedClustering.py:310). This is the principled
alternative: per-center learning-rate updates (Sculley 2010, as in
sklearn's MiniBatchKMeans), one step per batch. For exact out-of-core
Lloyd see models/streaming.py.

The step is the JAX version's: the batch's Lloyd stats (kernel='pallas':
B1 through `lloyd_stats_for`, B5 on bf16 batches, B2 + B3 past B1's
limit; with weights B4 through `lloyd_stats_weighted_for`), the padding
correction of `n_valid` (the streamed fits': each zero row lands on
the argmin-‖c‖² cluster), the running-average update, and sklearn's
low-count reassignment. The state stays on the device and a step reads
nothing back to the host; `minibatch_kmeans_fit` reads the epoch's shift
and last SSE once per epoch, as the JAX version's `float(...)` does.

Draws: one `torch.Generator` on the points' device serves the init and
then the reassignment's per-row uniforms (`_uniforms`, the step's only
draw; the JAX version splits a key into an init key and a step key).

Several ranks (`mesh=`): every rank passes the same batches, as the
streamed fits take the same stream. The step stages this rank's rows of
the batch (`models/streaming._stage` and `_prepare_batch`: np.array_split
bounds, zero rows or zero weights up to ceil(B / P)) and all-reduces the
stats (`parallel/collectives.distributed_lloyd_stats`). Rank 0 draws the
reassignment's uniforms and broadcasts them; each replacement row comes
from the rank that holds it, summed over the data axis (exact: the other
ranks add zeros).

Checkpoints (`minibatch_kmeans_fit(ckpt_dir=)`): per epoch, the JAX
version's meta (the lifetime counts, the step, the last SSE, the shift
and the history) and the generator's state under a meta entry of the
port's own, so a resume continues the same learning rates and the same
draws: bit-identical to an uninterrupted fit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tdc_tpu_torch.models.kmeans import (
    KMeansResult,
    resolve_init,
    resolve_init_replicated,
)
from tdc_tpu_torch.ops.assign import lloyd_stats, lloyd_stats_weighted
from tdc_tpu_torch.utils import checkpoint as ckpt_lib
from tdc_tpu_torch.utils.device import resolve_device
from tdc_tpu_torch.utils.heartbeat import maybe_beat

# The meta entries of the generator's state (uint8) and its device type:
# the port's own (the JAX version saves its threefry key as the key).
GENERATOR_META = "torch_generator"
GENERATOR_DEVICE_META = "torch_generator_device"


class MiniBatchState(NamedTuple):
    centroids: torch.Tensor  # (K, d) float32
    counts: torch.Tensor  # (K,) float32: lifetime per-center counts (mass)
    step: int
    last_sse: torch.Tensor  # () float32: SSE of the last batch
    generator: torch.Generator | None = None  # reassignment draws


def _uniforms(generator: torch.Generator, n: int,
              device: torch.device) -> torch.Tensor:
    """The (n,) per-row uniforms that rank rows for low-count
    reassignment: a step's only draw."""
    return torch.rand(n, generator=generator, device=device)


def _check_kernel(kernel: str, weighted: bool, mesh) -> None:
    if kernel not in ("xla", "pallas"):
        # An unknown value must not silently run (and record) the plain
        # path under another label.
        raise ValueError(f"unknown kernel {kernel!r} (use 'xla' or 'pallas')")
    if weighted and kernel == "pallas" and mesh is not None:
        raise ValueError(
            "sample_weight with kernel='pallas' on a mesh is not "
            "supported for mini-batch steps; use kernel='xla'")


def _stats_route(kernel: str, k: int, d: int, dtype, weighted: bool, mesh,
                 cache: dict | None):
    """fn(x, c, w) -> the batch's Lloyd stats (all-reduced on a mesh),
    picked once per dtype and weighting when `cache` is kept."""
    key = (dtype, weighted)
    if cache is not None and key in cache:
        return cache[key]
    if weighted:
        if kernel == "pallas":
            from tdc_tpu_torch.ops.lloyd_kernels import (
                lloyd_stats_weighted_for,
            )

            local = lloyd_stats_weighted_for(k, d, label="minibatch_step")
        else:
            local = lloyd_stats_weighted
        if mesh is not None:
            from tdc_tpu_torch.parallel.reduce import reduced_tree_stats

            fn = reduced_tree_stats(mesh, local)
        else:
            fn = local
    elif mesh is not None:
        from tdc_tpu_torch.parallel.collectives import (
            distributed_lloyd_stats,
        )

        def fn(x, c, w):
            return distributed_lloyd_stats(x, c, mesh, kernel=kernel)
    else:
        if kernel == "pallas":
            from tdc_tpu_torch.ops.lloyd_kernels import lloyd_stats_for

            local = lloyd_stats_for(k, d, dtype=dtype, label="minibatch_step")
        else:
            local = lloyd_stats

        def fn(x, c, w):
            return local(x, c)
    if cache is not None:
        cache[key] = fn
    return fn


def _on_device(a, d: int, device, weighted: bool, w=None):
    """A whole batch (and its weights) on `device`: host arrays (bf16
    '|V2' files and memory maps included) through the streamed fits'
    staging, tensors moved as they are."""
    from tdc_tpu_torch.models.streaming import _prepare_batch, _stage

    sb = _stage((a, w) if weighted else a, d, None, weighted)
    return _prepare_batch(sb, device)


def minibatch_step(
    state: MiniBatchState,
    batch,
    n_valid: int | None = None,
    sample_weight=None,
    *,
    reassignment_ratio: float = 0.0,
    kernel: str = "xla",
    mesh=None,
    _routes: dict | None = None,
) -> MiniBatchState:
    """One mini-batch update: assign the batch, move each centroid toward
    its batch mean with per-center rate 1/lifetime_count.

    batch: (rows, d) points (numpy or torch; on a mesh the whole batch,
      the same on every rank: each rank stages its own rows).
    n_valid: rows beyond it are zero padding; their exact contribution
      (argmin-‖c‖² cluster count and SSE, zero Σx) is removed.
    sample_weight: (rows,) weights; a weight-w row counts as w duplicated
      rows, lifetime counts become weight mass, and zero-weight rows
      (weighted padding too) add nothing, so no n_valid correction runs.
    reassignment_ratio > 0: sklearn's low-count reassignment, after the
      update: every center whose lifetime count is below ratio ×
      max(count) takes a distinct row of this batch, uniformly drawn (a
      stable sort of per-row uniforms; pad rows and zero-weight rows
      sink), and its count is reset to the least count among the kept
      centers. Never the whole codebook in one step; skipped when the
      batch has fewer rows than K.
    kernel: 'xla' (plain PyTorch) or 'pallas' (B1, B4 with weights).
    """
    c = state.centroids
    k, d = c.shape
    dev = c.device
    weighted = sample_weight is not None
    _check_kernel(kernel, weighted, mesh)
    offset, count = 0, 1
    if mesh is not None:
        from tdc_tpu_torch.models.streaming import (
            _data_ranks,
            _prepare_batch,
            _stage,
        )
        from tdc_tpu_torch.parallel.multihost import host_shard_bounds

        item = (batch, sample_weight) if weighted else batch
        sb = _stage(item, d, mesh, weighted)
        xb, wb = _prepare_batch(sb, dev)
        index, count = _data_ranks(mesh)
        offset = host_shard_bounds(sb.rows, index, count)[0]
        rows = sb.rows
    else:
        if isinstance(batch, torch.Tensor) and batch.device == dev and (
                not weighted or isinstance(sample_weight, torch.Tensor)):
            xb, wb = batch, sample_weight
            if wb is not None:
                wb = wb.to(torch.float32)
        else:
            xb, wb = _on_device(batch, d, dev, weighted, sample_weight)
        rows = xb.shape[0]
    # The rows of the (padded) global batch: the JAX version's layout,
    # the real rows first.
    n = xb.shape[0] * count
    stats = _stats_route(kernel, k, d, xb.dtype, weighted, mesh,
                         _routes)(xb, c, wb)
    valid = rows if n_valid is None else int(n_valid)
    n_pad = n - valid
    if n_pad and not weighted:
        from tdc_tpu_torch.parallel.sharded_k import padding_correction

        counts, sse = padding_correction(stats.counts, stats.sse, c, n_pad)
        stats = stats._replace(counts=counts, sse=sse)
    new_counts = state.counts + stats.counts
    # c <- c + (Σx − n_b·c) / max(total, 1): a running average over every
    # point the center has absorbed.
    denom = torch.clamp_min(new_counts, 1.0)[:, None]
    centroids = c + (stats.sums - stats.counts[:, None] * c) / denom
    generator = state.generator
    if reassignment_ratio > 0.0:
        if generator is None:
            raise ValueError(
                "reassignment_ratio > 0 requires a generator in the state")
        if n >= k:  # a smaller batch cannot supply k distinct rows
            centroids, new_counts = _reassign(
                centroids, new_counts, xb, wb, generator,
                reassignment_ratio, n, valid, offset, mesh,
                None if not weighted or mesh is None else sample_weight)
    return MiniBatchState(centroids=centroids, counts=new_counts,
                          step=state.step + 1, last_sse=stats.sse,
                          generator=generator)


def _reassign(centroids, counts, xb, wb, generator, ratio, n, valid, offset,
              mesh, global_w):
    """The low-count reassignment (see minibatch_step). Row indices are
    the global batch's (the real rows first, then the padding); on a mesh
    this rank holds the real rows [offset, offset + its rows)."""
    k = centroids.shape[0]
    dev = centroids.device
    low = counts < ratio * counts.max()
    # A ratio near 1 can mark every center: never reassign them all.
    low = low & ~low.all()
    if mesh is None:
        u = _uniforms(generator, n, dev)
    else:
        from tdc_tpu_torch.parallel.mesh import replicate
        from tdc_tpu_torch.parallel.multihost import process_index

        u = (_uniforms(generator, n, dev) if process_index() == 0
             else torch.empty(n, device=dev))
        u = replicate(u, mesh)
    scores = torch.where(torch.arange(n, device=dev) < valid, u,
                         float("-inf"))
    if wb is not None:
        # Zero-weight rows (weighted padding too) are not data.
        if mesh is None:
            w_all = wb
        else:
            w_all = torch.zeros(n, dtype=torch.float32, device=dev)
            w_all[:global_w.shape[0]] = torch.as_tensor(
                np.asarray(global_w.cpu() if isinstance(global_w,
                                                        torch.Tensor)
                           else global_w, np.float32)).to(dev)
        scores = torch.where(w_all > 0, scores, float("-inf"))
    cand = torch.argsort(-scores, stable=True)[:k]  # k distinct rows
    # Only onto a real row (a heavily padded batch leaves some at -inf).
    low = low & (scores[cand] > float("-inf"))
    if mesh is None:
        replacement = xb.index_select(0, cand).to(torch.float32)
    else:
        from tdc_tpu_torch.parallel.mesh import data_axes

        local = cand - offset
        held = (local >= 0) & (local < xb.shape[0])
        replacement = xb.index_select(0, local.clamp(0, xb.shape[0] - 1)
                                      ).to(torch.float32)
        replacement = torch.where(held[:, None], replacement, 0.0)
        mesh.psum(replacement, *data_axes(mesh))
    centroids = torch.where(low[:, None], replacement, centroids)
    kept_min = torch.where(low, float("inf"), counts).min()
    counts = torch.where(low, torch.clamp_max(kept_min, 1e30), counts)
    return centroids, counts


class MiniBatchKMeans:
    """Host-side loop state: feed batches (numpy or torch) through steps.

    Usage:
        mbk = MiniBatchKMeans(k=1024, d=128, init=c0)
        for batch in loader:
            maybe_beat()  # supervised-gang liveness
            mbk.partial_fit(batch)
        labels = kmeans_predict(x, mbk.centroids)
    """

    def __init__(self, k: int, d: int, *, init=None, generator=None,
                 mesh=None, reassignment_ratio: float = 0.0,
                 kernel: str = "xla", device=None):
        self.k, self.d = k, d
        self.device = resolve_device(device)
        self._state: MiniBatchState | None = None
        self._init_spec = init
        self._generator = generator
        self.mesh = mesh
        self.reassignment_ratio = float(reassignment_ratio)
        self.kernel = kernel
        self._routes: dict = {}

    def _ensure_init(self, batch) -> None:
        if self._state is not None:
            return
        init = "kmeans++" if self._init_spec is None else self._init_spec
        gen = self._generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        xb, _ = _on_device(batch, self.d, self.device, False)
        if self.mesh is not None:
            c0 = resolve_init_replicated(xb, self.k, init, gen, self.mesh)
        else:
            c0 = resolve_init(xb, self.k, init, gen)
        # A copy: first_k's rows are a view of the batch.
        c0 = c0.to(torch.float32).clone()
        if c0.shape != (self.k, self.d):
            raise ValueError(f"init shape {tuple(c0.shape)} != "
                             f"{(self.k, self.d)}")
        self._state = MiniBatchState(
            centroids=c0,
            counts=torch.zeros(self.k, dtype=torch.float32,
                               device=self.device),
            step=0,
            last_sse=torch.tensor(float("inf"), device=self.device),
            generator=gen)

    def partial_fit(self, batch, sample_weight=None) -> "MiniBatchKMeans":
        self._ensure_init(batch)
        self._state = minibatch_step(
            self._state, batch, None, sample_weight,
            reassignment_ratio=self.reassignment_ratio, kernel=self.kernel,
            mesh=self.mesh, _routes=self._routes)
        return self

    @classmethod
    def from_fitted(cls, fitted, *, counts=None, prior_count: float = 0.0,
                    generator=None, mesh=None,
                    reassignment_ratio: float = 0.0, kernel: str = "xla",
                    device=None) -> "MiniBatchKMeans":
        """Resume mini-batch folding from a served model: a
        models/persist.FittedModel (or a path `load_fitted` accepts)
        becomes a live partial_fit state. `counts` seeds the per-center
        lifetime counts; without it every center starts at `prior_count`
        pseudo-points, which sets how hard the first batches pull the
        centroids. `generator` draws the reassignment's uniforms."""
        if isinstance(fitted, str):
            from tdc_tpu_torch.models.persist import load_fitted

            fitted = load_fitted(fitted)
        if fitted.model != "kmeans":
            raise ValueError(
                f"MiniBatchKMeans.from_fitted needs a kmeans model, got "
                f"{fitted.model!r} (fuzzy/gmm parameters are not fit under "
                "the hard-assignment mini-batch objective)")
        dev = resolve_device(device)
        c0 = torch.as_tensor(np.asarray(fitted.arrays["centroids"],
                                        np.float32)).to(dev)
        k, d = int(c0.shape[0]), int(c0.shape[-1])
        mbk = cls(k, d, init=c0, generator=generator, mesh=mesh,
                  reassignment_ratio=reassignment_ratio, kernel=kernel,
                  device=dev)
        if mesh is not None:
            from tdc_tpu_torch.parallel.mesh import replicate

            c0 = replicate(c0, mesh)
        if counts is None:
            counts = torch.full((k,), float(prior_count),
                                dtype=torch.float32, device=dev)
        else:
            counts = torch.as_tensor(np.asarray(
                counts.cpu() if isinstance(counts, torch.Tensor) else counts,
                np.float32)).to(dev)
            if tuple(counts.shape) != (k,):
                raise ValueError(
                    f"counts shape {tuple(counts.shape)} != ({k},)")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        mbk._state = MiniBatchState(
            centroids=c0, counts=counts, step=0,
            last_sse=torch.tensor(float("inf"), device=dev),
            generator=generator)
        return mbk

    @property
    def centroids(self) -> torch.Tensor:
        if self._state is None:
            raise ValueError("partial_fit was never called")
        return self._state.centroids

    @property
    def state(self) -> MiniBatchState:
        if self._state is None:
            raise ValueError("partial_fit was never called")
        return self._state


def minibatch_kmeans_fit(
    batches,
    k: int,
    d: int,
    *,
    init="kmeans++",
    generator: torch.Generator | None = None,
    epochs: int = 1,
    tol: float = 1e-4,
    mesh=None,
    prefetch: int = 0,
    reassignment_ratio: float = 0.01,
    ckpt_dir: str | None = None,
    ckpt_every: int = 1,
    kernel: str = "xla",
    device=None,
) -> KMeansResult:
    """Mini-batch K-Means over a re-iterable batch stream (`batches()`
    returns a fresh iterator, as for streamed_kmeans_fit).

    Each epoch is one pass, each batch one step. Convergence is the
    largest centroid shift over an epoch against `tol` (negative tol =
    fixed epochs). Returns a KMeansResult: n_iter counts epochs, sse is
    the last batch's SSE (mini-batch never scores the whole dataset),
    history holds [last batch SSE, shift] per epoch.

    init: a name ('kmeans++', 'kmeans||', 'random', 'first_k') resolved on
      the first batch, or a (K, d) array; generator: the init's and the
      reassignment's draws (default: one seeded with 0 on `device`).
    reassignment_ratio: sklearn parity (default 0.01); 0 disables.
    kernel: 'xla', 'pallas' or 'auto' (pallas on CUDA, xla on the CPU).
    ckpt_dir: per-epoch checkpoint and resume: the whole mini-batch state
      (centroids, lifetime counts, step, last SSE, the generator's state),
      saved every `ckpt_every` epochs and at the end, so a resumed run
      continues the same learning rates and draws. A checkpoint of the
      JAX version carries a threefry key, which no torch generator
      continues: it resumes only where the fit draws nothing more
      (reassignment_ratio=0).
    """
    from tdc_tpu_torch.models.streaming import _is_gang, _prefetched

    dev = resolve_device(device)
    if kernel.startswith("auto"):
        from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel

        kernel = resolve_kernel(
            kernel, k=k, d=d, device=dev, model="kmeans",
            label="minibatch_kmeans_fit",
            mxu_ineligible="mini-batch updates have no bf16-MXU epilogue")
    mbk = MiniBatchKMeans(k, d, init=init, generator=generator, mesh=mesh,
                          reassignment_ratio=reassignment_ratio,
                          kernel=kernel, device=dev)
    shift, history, start_epoch = float("inf"), [], 0
    if ckpt_dir is not None:
        saved = ckpt_lib.restore_checkpoint(ckpt_dir)
        if saved is not None:
            mbk._state = _restored_state(saved, ckpt_dir, k, d, dev,
                                         reassignment_ratio)
            start_epoch = int(saved.n_iter)
            shift = float(saved.meta.get("shift", np.inf))
            hist = np.asarray(saved.meta.get("history", []), np.float32)
            history = [tuple(float(v) for v in r) for r in hist.reshape(-1, 2)]

    def save(n_epoch):
        st = mbk.state
        meta = {"k": k, "d": d, "minibatch": True, "shift": float(shift),
                "mb_counts": st.counts, "mb_step": int(st.step),
                "mb_last_sse": float(st.last_sse)}
        if st.generator is not None:
            meta[GENERATOR_META] = st.generator.get_state().numpy()
            meta[GENERATOR_DEVICE_META] = st.generator.device.type
        if history:
            meta["history"] = np.asarray(history, np.float32).reshape(-1, 2)
        ckpt_lib.save_checkpoint(
            ckpt_dir, ckpt_lib.ClusterState(
                centroids=st.centroids, n_iter=n_epoch, key=None,
                batch_cursor=0, meta=meta),
            step=n_epoch, gang=_is_gang(mesh))

    n_epoch = start_epoch
    done = tol >= 0 and shift <= tol
    for n_epoch in range(start_epoch + 1, epochs + 1) if not done else ():
        c_start = None
        for batch in _prefetched(batches(), prefetch):
            maybe_beat()  # supervised-gang liveness
            if c_start is None:
                mbk._ensure_init(batch)
                c_start = mbk.centroids.clone()
            mbk.partial_fit(batch)
        shift = float(torch.linalg.norm(mbk.centroids - c_start,
                                        dim=-1).max())
        history.append((float(mbk.state.last_sse), shift))
        done = tol >= 0 and shift <= tol
        if ckpt_dir is not None and (done or n_epoch % ckpt_every == 0
                                     or n_epoch == epochs):
            save(n_epoch)
        if done:
            break
    return KMeansResult(
        centroids=mbk.centroids, n_iter=n_epoch, sse=mbk.state.last_sse,
        shift=torch.tensor(shift, dtype=torch.float32, device=dev),
        converged=bool(tol >= 0 and shift <= tol),
        history=np.asarray(history, np.float32).reshape(-1, 2),
        n_iter_run=n_epoch - start_epoch)


def _restored_state(saved, ckpt_dir, k, d, device,
                    reassignment_ratio) -> MiniBatchState:
    """The MiniBatchState of a checkpoint, checked as the JAX version
    checks it; the generator from the port's own meta entry."""
    if saved.meta.get("k") != k or saved.meta.get("d") != d:
        raise ValueError(
            f"checkpoint in {ckpt_dir} is for K={saved.meta.get('k')}"
            f", d={saved.meta.get('d')}, not ({k}, {d})")
    if not saved.meta.get("minibatch", False):
        raise ValueError(
            f"checkpoint in {ckpt_dir} is not a mini-batch state")
    generator = None
    if GENERATOR_META in saved.meta:
        kind = str(saved.meta.get(GENERATOR_DEVICE_META, "cpu"))
        if kind != device.type:
            raise ValueError(
                f"checkpoint in {ckpt_dir} holds a {kind} generator's state; "
                f"this run draws on {device.type} — resume on a {kind} "
                "device")
        generator = torch.Generator(device=device)
        generator.set_state(torch.from_numpy(
            np.asarray(saved.meta[GENERATOR_META], np.uint8).copy()))
    elif reassignment_ratio > 0:
        raise ValueError(
            f"checkpoint in {ckpt_dir} carries the JAX package's threefry "
            "key, which no torch generator can continue: the resumed "
            "reassignment draws would differ from the run it continues; "
            "resume with reassignment_ratio=0 or in the JAX package"
            if saved.key is not None else
            f"checkpoint in {ckpt_dir} holds no generator state to continue "
            "the reassignment draws; resume with reassignment_ratio=0")
    return MiniBatchState(
        centroids=torch.as_tensor(np.asarray(saved.centroids,
                                             np.float32)).to(device),
        counts=torch.as_tensor(np.asarray(saved.meta["mb_counts"],
                                          np.float32)).to(device),
        step=int(np.asarray(saved.meta["mb_step"])),
        last_sse=torch.tensor(
            float(np.asarray(saved.meta.get("mb_last_sse", np.inf))),
            dtype=torch.float32, device=device),
        generator=generator)


__all__ = ["MiniBatchKMeans", "MiniBatchState", "minibatch_kmeans_fit",
           "minibatch_step"]
