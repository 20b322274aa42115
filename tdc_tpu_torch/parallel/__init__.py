"""Multi-GPU runs on torch.distributed (counterpart: tdc_tpu/parallel):
process groups, the grid of ranks, data-parallel stats and the K-sharded
fuzzy tower (`parallel.sharded_k`, imported on its own)."""

from tdc_tpu_torch.parallel.collectives import (
    distributed_fuzzy_stats,
    distributed_lloyd_stats,
)
from tdc_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_points,
)
from tdc_tpu_torch.parallel.multihost import (
    initialize_distributed,
    initialize_from_env,
)

__all__ = ["Mesh", "distributed_fuzzy_stats", "distributed_lloyd_stats",
           "initialize_distributed", "initialize_from_env", "make_mesh",
           "replicate", "shard_points"]
