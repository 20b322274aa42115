"""Multi-GPU runs on torch.distributed (counterpart: tdc_tpu/parallel):
process groups, the grid of ranks (flat, or hierarchical dcn × ici),
data-parallel stats, the reduce strategies of the streamed fits (per
batch, per pass, quantized with error feedback) and the K-sharded
K-Means and fuzzy towers (`parallel.sharded_k`). The JAX package's
`parallel/compat.py` (a shim over JAX versions of `shard_map`'s keywords)
has no counterpart: nothing here runs `shard_map`."""

from tdc_tpu_torch.parallel.collectives import (
    distributed_fuzzy_stats,
    distributed_lloyd_stats,
)
from tdc_tpu_torch.parallel.mesh import (
    Mesh,
    make_hierarchical_mesh,
    make_mesh,
    replicate,
    shard_points,
)
from tdc_tpu_torch.parallel.reduce import (
    GLOBAL_COMMS,
    CommsReport,
    ReduceStrategy,
    resolve_reduce,
)
from tdc_tpu_torch.parallel.multihost import (
    initialize_distributed,
    initialize_from_env,
)
from tdc_tpu_torch.parallel.sharded_k import (
    fuzzy_fit_sharded,
    kmeans_fit_sharded,
    make_mesh_2d,
    make_sharded_lloyd_step,
    make_sharded_stats,
    sharded_assign,
)

__all__ = ["GLOBAL_COMMS", "CommsReport", "Mesh", "ReduceStrategy",
           "distributed_fuzzy_stats", "distributed_lloyd_stats",
           "fuzzy_fit_sharded", "initialize_distributed",
           "initialize_from_env", "kmeans_fit_sharded",
           "make_hierarchical_mesh", "make_mesh",
           "make_mesh_2d", "make_sharded_lloyd_step", "make_sharded_stats",
           "replicate", "resolve_reduce", "shard_points",
           "sharded_assign"]
