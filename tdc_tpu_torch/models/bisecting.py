"""Bisecting K-Means (counterpart: tdc_tpu/models/bisecting.py).

Divisive hierarchical clustering (sklearn.cluster.BisectingKMeans
parity): start from one cluster and split the worst one with a 2-means
fit until K clusters exist. Each split is a mask-weighted 2-means over
all N rows: the candidate cluster's membership becomes `sample_weight`
of the port's `kmeans_fit` at its default kernel ('xla', as the JAX
version's), so every split runs the same (N, d) fit.

The points go to the device once (with a mesh, zero-weight-padded once to
a multiple of its size); the hierarchical labels live on the host, as in
the JAX version. The per-cluster SSE, which decides the next split, is
summed in a fixed order (`ops/assign.segment_sum`), so a fit repeats
bitwise on the card.

The streamed form keeps the labels on the host, one chunk per batch, and
runs each split as the port's exact `streamed_kmeans_fit` over a mask
weight stream. Its k-means++ seeding draws from up to `_SEED_CAP`
positive-weight member rows gathered from the first batches that hold
them; after each split one pass over the stream both labels the members
by side and sums the per-cluster SSE at the new centers.
"""

from __future__ import annotations

import numpy as np
import torch

from tdc_tpu_torch.models.kmeans import (
    KMeansResult,
    _as_points,
    kmeans_fit,
    kmeans_predict,
    resolve_init,
)
from tdc_tpu_torch.ops.assign import segment_sum
from tdc_tpu_torch.utils.device import resolve_device

STRATEGIES = ("biggest_inertia", "largest_cluster")

# Streamed splits seed k-means++ from at most this many gathered member
# rows of the target cluster (the cap bounds host memory independently of
# cluster size).
_SEED_CAP = 4096


def _per_cluster_sse(x, labels, centers, w=None):
    """(K,) within-cluster (optionally weighted) SSE from the gathered
    own-center distances, O(N·d), summed in a fixed order."""
    diff = x.float() - centers[labels]
    d2 = (diff * diff).sum(dim=1)
    if w is not None:
        d2 = d2 * w
    return segment_sum(d2, labels, centers.shape[0])


def _check_strategy(bisecting_strategy: str, k: int) -> None:
    if bisecting_strategy not in STRATEGIES:
        raise ValueError(
            f"bisecting_strategy must be one of {STRATEGIES}, "
            f"got {bisecting_strategy!r}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def _no_split_left(next_label: int, k: int) -> ValueError:
    return ValueError(
        f"no splittable cluster left after {next_label} clusters (need "
        f"K={k}); the data has too few distinct points")


def _result(centers, total_iters: int, sse_total: float, device):
    return KMeansResult(
        centroids=torch.as_tensor(centers).to(device),
        n_iter=int(total_iters),
        sse=torch.tensor(sse_total, dtype=torch.float32, device=device),
        shift=torch.tensor(0.0, device=device),  # no global Lloyd loop ran
        converged=True)


def bisecting_kmeans_fit(
    x,
    k: int,
    *,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    n_init: int = 1,
    bisecting_strategy: str = "biggest_inertia",
    sample_weight=None,
    return_labels: bool = False,
    mesh=None,
    device=None,
):
    """Fit K clusters by K−1 successive 2-means splits.

    Args:
      generator: torch.Generator on `device` for every split's k-means++
        (default: one seeded with 0).
      bisecting_strategy: 'biggest_inertia' (split the cluster with the
        largest within-cluster SSE, sklearn's default) or
        'largest_cluster' (most points, or most weight).
      n_init: k-means++ restarts per split.
      sample_weight: optional (N,) nonnegative weights, multiplied into
        each split's membership mask.
      mesh: each split's weighted 2-means runs data parallel (every rank
        passes the same x); uneven N is zero-weight-padded once.
      return_labels: also return the (N,) int32 hierarchical labels (the
        split assignment `sse` is computed from).
      device: None means 'cuda'; 'cpu' runs the plain versions.

    Returns a KMeansResult (or (KMeansResult, labels)): centroids (K, d);
    sse the within-cluster total over the hierarchical labels; n_iter the
    inner Lloyd iterations summed over every 2-means run; converged True.
    Raises ValueError when no cluster with 2 distinct positive-weight
    points is left to split before K.
    """
    _check_strategy(bisecting_strategy, k)
    dev = resolve_device(device)
    x = _as_points(x, dev)
    n, d = x.shape
    if n < k:
        raise ValueError(f"n_obs={n} < K={k}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    base_w = None
    if sample_weight is not None:
        from tdc_tpu_torch.models._common import validate_sample_weight

        base_w = validate_sample_weight(sample_weight, n, k, dev)
    if mesh is not None:
        # Zero-weight padding once, so every split's data-parallel 2-means
        # sees N divisible by the mesh; pad rows carry no mass anywhere.
        rem = (-n) % mesh.size
        if rem:
            if base_w is None:
                base_w = torch.ones(n, dtype=torch.float32, device=dev)
            x = torch.cat([x, x.new_zeros((rem, d))])
            base_w = torch.cat([base_w, base_w.new_zeros(rem)])
    n_rows = x.shape[0]
    labels = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    if base_w is None:
        mean0 = x.float().mean(dim=0)
    else:
        mean0 = ((x.float() * base_w[:, None]).sum(dim=0)
                 / max(float(base_w.sum()), 1e-12))
    centers = mean0[None, :].clone()
    sse = _per_cluster_sse(x, labels, centers, base_w)
    splittable = [True]
    total_iters = 0

    for next_label in range(1, k):
        while True:
            candidates = [i for i, ok in enumerate(splittable) if ok]
            if not candidates:
                raise _no_split_left(next_label, k)
            if bisecting_strategy == "biggest_inertia":
                score = sse
            else:
                score = segment_sum(
                    torch.ones(n_rows, device=dev) if base_w is None
                    else base_w, labels, centers.shape[0])
            cand = torch.tensor(candidates, device=dev)
            target = candidates[int(torch.argmax(score[cand]))]
            mask = labels == target
            w = mask.float() if base_w is None else mask.float() * base_w
            if int((w > 0).sum()) < 2:
                splittable[target] = False
                continue
            res = kmeans_fit(x, 2, init="kmeans++", generator=generator,
                             max_iters=max_iters, tol=tol, sample_weight=w,
                             n_init=n_init, mesh=mesh, device=dev)
            # The 2-means ran even when the split turns out degenerate.
            total_iters += int(res.n_iter)
            side = kmeans_predict(x, res.centroids, device=dev)
            # A split needs a positive-weight member on each side.
            pos = mask & (w > 0)
            left = bool((pos & (side == 0)).any())
            right = bool((pos & (side == 1)).any())
            if not left or not right:
                # Duplicate points: this cluster cannot be divided.
                splittable[target] = False
                continue
            break
        # Every member row moves with its side (zero-weight rows too).
        labels = torch.where(mask & (side == 1), next_label, labels)
        new_c = res.centroids.to(torch.float32)
        centers = torch.cat([centers, new_c[1:2]])
        centers[target] = new_c[0]
        splittable.append(True)
        sse = _per_cluster_sse(x, labels, centers, base_w)

    result = _result(centers, total_iters, float(sse.sum()), dev)
    if return_labels:
        return result, labels[:n].to(torch.int32).cpu().numpy()
    return result


def streamed_bisecting_kmeans_fit(
    batches,
    k: int,
    d: int,
    *,
    generator: torch.Generator | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    n_init: int = 1,
    bisecting_strategy: str = "biggest_inertia",
    sample_weight_batches=None,
    prefetch: int = 0,
    return_labels: bool = False,
    mesh=None,
    device=None,
):
    """Out-of-core bisecting K-Means over a re-iterable batch stream
    (`batches()` returns a fresh iterator; the batch layout must be the
    same on every pass, since the labels are kept per batch).

    bisecting_kmeans_fit's procedure with every full-array pass replaced
    by a pass over the stream: labels on the host, one int64 chunk per
    batch; each split an exact streamed weighted 2-means
    (`streamed_kmeans_fit`) over the candidate's membership mask (× the
    base weights), seeded by k-means++ on up to `_SEED_CAP` gathered
    positive-weight member rows; one combined pass per split for the side
    labels and the per-cluster SSE at the new centers. `mesh` runs every
    split's 2-means data parallel; the label and SSE passes stay on each
    rank. Args and returns as bisecting_kmeans_fit.
    """
    from tdc_tpu_torch.models.streaming import (
        _host_rows,
        _prefetched,
        _weighted_stream,
        streamed_kmeans_fit,
    )

    _check_strategy(bisecting_strategy, k)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    weighted = sample_weight_batches is not None
    stream = _weighted_stream(batches, sample_weight_batches)

    def on_device(xb) -> torch.Tensor:
        rows = _host_rows(xb)
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.array(rows))
        return rows.to(device=dev, dtype=torch.float32)

    # Pass 1: the (weighted) mean, the batch row counts and host copies of
    # the weights. The sums stay on the device; one read after the loop.
    sums = torch.zeros(d, dtype=torch.float64, device=dev)
    mass = torch.zeros((), dtype=torch.float64, device=dev)
    rows, w_chunks = [], [] if weighted else None
    for item in _prefetched(stream(), prefetch):
        xb, wb = item if weighted else (item, None)
        xb = on_device(xb)
        rows.append(int(xb.shape[0]))
        if wb is None:
            sums += xb.sum(dim=0, dtype=torch.float64)
            mass += xb.shape[0]
        else:
            # A copy: a stream may reuse its weight buffer between yields.
            wh = np.array(wb.cpu() if isinstance(wb, torch.Tensor) else wb,
                          np.float32)
            if wh.shape != (xb.shape[0],):
                raise ValueError(
                    f"weight batch shape {wh.shape} != ({xb.shape[0]},)")
            if not np.isfinite(wh).all():
                raise ValueError("sample_weight entries must be finite")
            if (wh < 0).any():
                raise ValueError("sample weights must be nonnegative")
            w_chunks.append(wh)
            wt = torch.from_numpy(wh).to(dev)
            sums += (xb * wt[:, None]).sum(dim=0, dtype=torch.float64)
            mass += wt.sum(dtype=torch.float64)
    n = sum(rows)
    if n < k:
        raise ValueError(f"n_obs={n} < K={k}")
    mass = float(mass)
    if weighted and mass <= 0:
        raise ValueError("all sample weights are zero")
    labels_chunks = [np.zeros(r, np.int64) for r in rows]
    centers = (sums / max(mass, 1e-12)).float()[None, :]

    def counts(k_cur):
        """Per-cluster positive-weight members (the splittability test)
        and mass (the 'largest_cluster' score), on the host."""
        pos = np.zeros(k_cur)
        m = np.zeros(k_cur)
        for i, lab in enumerate(labels_chunks):
            if not weighted:
                b = np.bincount(lab, minlength=k_cur)
                pos += b
                m += b
            else:
                pos += np.bincount(lab[w_chunks[i] > 0], minlength=k_cur)
                m += np.bincount(lab, weights=w_chunks[i], minlength=k_cur)
        return pos, m

    def sse_pass(centers_now, split=None):
        """(K,) weighted within-cluster SSE over the stream at
        `centers_now`. With split = (target, new label, 2-means
        centroids), the pass first labels the target's members by side
        (the new labels are returned, not installed) and reports whether
        each side holds a positive-weight member."""
        k_cur = centers_now.shape[0]
        acc = torch.zeros(k_cur, dtype=torch.float64, device=dev)
        sides, left, right = [], False, False
        for i, item in enumerate(_prefetched(batches(), prefetch)):
            xb = on_device(item)
            lab_host = labels_chunks[i]
            wc = None if not weighted else torch.from_numpy(
                w_chunks[i]).to(dev)
            lab = torch.from_numpy(lab_host).to(dev)
            if split is not None:
                target, next_label, c2 = split
                side = kmeans_predict(xb, c2, device=dev)
                member = lab == target
                pos = member if wc is None else member & (wc > 0)
                left = left or bool((pos & (side == 0)).any())
                right = right or bool((pos & (side == 1)).any())
                lab = torch.where(member & (side == 1), next_label, lab)
                sides.append(lab)
            diff = xb - centers_now[lab]
            d2 = (diff * diff).sum(dim=1)
            if wc is not None:
                d2 = d2 * wc
            acc += segment_sum(d2, lab, k_cur).double()
        return acc.float(), sides, left and right

    sse = sse_pass(centers)[0]
    splittable = [True]
    total_iters = 0

    for next_label in range(1, k):
        while True:
            candidates = [i for i, ok in enumerate(splittable) if ok]
            if not candidates:
                raise _no_split_left(next_label, k)
            pos, cluster_mass = counts(centers.shape[0])
            score = (sse.cpu().numpy() if bisecting_strategy
                     == "biggest_inertia" else cluster_mass)
            target = candidates[int(np.argmax(score[candidates]))]
            if pos[target] < 2:
                splittable[target] = False
                continue

            def mask_stream(target=target):
                def gen():
                    for i, lab in enumerate(labels_chunks):
                        w = (lab == target).astype(np.float32)
                        if weighted:
                            w = w * w_chunks[i]
                        yield w
                return gen()

            # Seed rows: up to _SEED_CAP positive-weight members, gathered
            # from the first batches that hold them (members may straddle
            # batches). Plain batches(), not _prefetched: this scan stops
            # early.
            seed_rows, seed_w, got = [], [], 0
            for i, item in enumerate(batches()):
                m = labels_chunks[i] == target
                if weighted:
                    m = m & (w_chunks[i] > 0)
                if m.any():
                    # A copy: a stream may reuse its batch buffer.
                    host = _host_rows(item)
                    host = (host.float().cpu().numpy()
                            if isinstance(host, torch.Tensor) else host)
                    seed_rows.append(np.array(host, np.float32)[m])
                    seed_w.append(w_chunks[i][m] if weighted
                                  else np.ones(int(m.sum()), np.float32))
                    got += int(m.sum())
                    if got >= _SEED_CAP:
                        break
            seed_x = torch.from_numpy(
                np.concatenate(seed_rows)[:_SEED_CAP]).to(dev)
            seed_wt = torch.from_numpy(
                np.concatenate(seed_w)[:_SEED_CAP]).to(dev)
            # n_init restarts: the lowest weighted SSE wins, and only the
            # winner's iterations count.
            res = None
            for _ in range(n_init):
                init2 = resolve_init(seed_x, 2, "kmeans++", generator,
                                     seed_wt)
                r = streamed_kmeans_fit(
                    batches, 2, d, init=init2, generator=generator,
                    max_iters=max_iters, tol=tol,
                    sample_weight_batches=mask_stream, prefetch=prefetch,
                    mesh=mesh, device=dev)
                if res is None or float(r.sse) < float(res.sse):
                    res = r
            total_iters += int(res.n_iter)
            new_c = res.centroids.to(torch.float32)
            candidate = torch.cat([centers, new_c[1:2]])
            candidate[target] = new_c[0]
            new_sse, sides, ok = sse_pass(candidate,
                                          (target, next_label, new_c))
            if not ok:
                splittable[target] = False
                continue
            break
        for i, lab in enumerate(sides):
            labels_chunks[i] = lab.cpu().numpy()
        centers, sse = candidate, new_sse
        splittable.append(True)

    result = _result(centers, total_iters, float(sse.sum()), dev)
    if return_labels:
        return result, np.concatenate(labels_chunks).astype(np.int32)
    return result


__all__ = ["bisecting_kmeans_fit", "streamed_bisecting_kmeans_fit"]
