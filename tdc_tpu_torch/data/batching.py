"""The card's memory, batch sizing and the OOM-adaptive retry
(counterpart: tdc_tpu/data/batching.py).

Reference counterparts: the hand-tuned per-GPU-count max_size table
(New-Distributed-KMeans.ipynb#cell13) and the OOM-halving loop (`except
ResourceExhaustedError: num_batches *= 2`,
scripts/distribuitedClustering.py:357-360). Batch rows come from the
card's memory and the port's own working set per row
(`working_set_row_bytes`); the retry loop doubles num_batches on a CUDA
out-of-memory error and on nothing else: a kernel that fails to build or
launch raises as it is, never retried on smaller batches.
"""

from __future__ import annotations

import gc
from typing import Callable, TypeVar

import torch

T = TypeVar("T")


def device_hbm_bytes(device=None) -> int:
    """The card's total memory (`torch.cuda.mem_get_info`). A CPU device
    raises: it has no device memory to size batches against."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(
            f"device_hbm_bytes: {dev} has no device memory; it applies "
            "to a CUDA device")
    return int(torch.cuda.mem_get_info(dev)[1])


# Share of the card's memory that batch sizing works within (the JAX
# package's safety fraction).
SAFETY_FRACTION = 0.6


def working_set_row_bytes(n_dim: int, k: int, *, itemsize: int = 4,
                          kernel: str = "xla") -> int:
    """Device bytes one point row costs in one Lloyd stats pass of the
    port. 'pallas': the row itself and 16 bytes (B1 and B5 keep no
    (rows, K) buffer; past B1's K·d limit the sorted route keeps a label,
    a min d² and a sort index a row). The plain 'xla' form: the row, its
    (K,) f32 distances and its one-hot row, built as int64 and cast to
    f32 (16·K bytes in all)."""
    if kernel == "pallas":
        return itemsize * n_dim + 16
    return itemsize * n_dim + 16 * k


def hbm_budget_bytes(device=None) -> int:
    """The bytes batch sizing works within: SAFETY_FRACTION of the
    card's memory (a CPU device raises, as `device_hbm_bytes` does)."""
    return int(SAFETY_FRACTION * device_hbm_bytes(device))


# The memory the residency planner assumes for a device that has none to
# report: the JAX package's default (16 GiB, its `_DEFAULT_HBM_BYTES`), so
# a fit on the CPU makes the JAX package's residency decisions.
CPU_PLANNING_BYTES = 16 << 30


def planner_budget_bytes(device=None) -> int:
    """The residency planner's budget (`data/device_cache.py`): the card's
    `hbm_budget_bytes` on a CUDA device, SAFETY_FRACTION of
    CPU_PLANNING_BYTES on any other."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return int(SAFETY_FRACTION * CPU_PLANNING_BYTES)
    return hbm_budget_bytes(dev)


def rows_in_budget(budget: int, n_dim: int, k: int, *, n_devices: int = 1,
                   itemsize: int = 4, kernel: str = "xla",
                   resident_bytes: int = 0) -> int:
    """The most points per global batch whose working set fits `budget`
    bytes a device less `resident_bytes` (a resident dataset cache's
    share): rows per device = what is left / working_set_row_bytes, times
    n_devices, at least 1."""
    per_row = working_set_row_bytes(n_dim, k, itemsize=itemsize,
                                    kernel=kernel)
    return max(max(budget - resident_bytes, 0) // per_row * n_devices, 1)


def auto_batch_size(n_dim: int, k: int, *, n_devices: int = 1,
                    itemsize: int = 4, device=None,
                    kernel: str = "xla") -> int:
    """`rows_in_budget` of each card's `hbm_budget_bytes`."""
    return rows_in_budget(hbm_budget_bytes(device), n_dim, k,
                          n_devices=n_devices, itemsize=itemsize,
                          kernel=kernel)


def is_oom_error(e: BaseException) -> bool:
    """True for torch.cuda.OutOfMemoryError and for nothing else."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def release_device_memory() -> None:
    """Give a failed attempt's device memory back: collect the objects
    its frames held, then return the allocator's cached blocks."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def oom_adaptive(run: Callable[[int], T], *, initial_num_batches: int = 1,
                 max_doublings: int = 12) -> tuple[T, int]:
    """Call run(num_batches); on a CUDA out-of-memory error double
    num_batches and retry (reference semantics, :357-360). Returns
    (result, num_batches_used). Between attempts the failed one's
    memory is released (its exception and frames dropped first), so the
    retry does not meet the first attempt's leftovers."""
    num_batches = initial_num_batches
    for _ in range(max_doublings + 1):
        try:
            return run(num_batches), num_batches
        except Exception as e:
            if not is_oom_error(e):
                raise
        # Outside the handler: the exception, its traceback and the
        # failed attempt's frames are gone.
        release_device_memory()
        num_batches *= 2
    raise MemoryError(
        f"still RESOURCE_EXHAUSTED after {max_doublings} doublings "
        f"(num_batches={num_batches})"
    )
