"""Data-parallel sufficient statistics (counterpart:
tdc_tpu/parallel/collectives.py).

Each rank runs the stats of its rows as on one GPU (`kernel="pallas"`:
the kernel route, B1 or B5 fused or B2 + B3 sorted for Lloyd, B6 for
fuzzy; `"xla"`: plain PyTorch ops), then one all_reduce sums the stats
over the data axis (`reduce.reduced_tree_stats`); on a hierarchical
(dcn, ici) mesh two, the ici axis first. Only the (K, d) stats cross
between ranks.
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.ops.assign import (
    FuzzyStats,
    SufficientStats,
    fuzzy_stats,
    lloyd_stats,
)
from tdc_tpu_torch.parallel.mesh import Mesh
from tdc_tpu_torch.parallel.reduce import reduced_tree_stats


def distributed_lloyd_stats(x: torch.Tensor, centroids: torch.Tensor,
                            mesh: Mesh, axis_name: str | None = None,
                            kernel: str = "xla") -> SufficientStats:
    """Lloyd stats of every rank's rows: x is this rank's rows
    (`mesh.shard_points`), centroids the same on every rank."""
    if kernel == "pallas":
        from tdc_tpu_torch.ops.lloyd_kernels import lloyd_stats_auto

        local_fn = lloyd_stats_auto
    else:
        local_fn = lloyd_stats
    return reduced_tree_stats(mesh, local_fn, axis_name)(x, centroids)


def distributed_fuzzy_stats(x: torch.Tensor, centroids: torch.Tensor,
                            mesh: Mesh, m: float = 2.0,
                            axis_name: str | None = None,
                            kernel: str = "xla") -> FuzzyStats:
    """Fuzzy C-Means stats of every rank's rows, as
    `distributed_lloyd_stats`; kernel='pallas' runs B6 on each rank."""
    if kernel == "pallas":
        from tdc_tpu_torch.ops.fuzzy_kernels import fuzzy_stats_auto

        def local_fn(x, c):
            return fuzzy_stats_auto(x, c, m=m)
    else:
        def local_fn(x, c):
            return fuzzy_stats(x, c, m=m)
    return reduced_tree_stats(mesh, local_fn, axis_name)(x, centroids)
