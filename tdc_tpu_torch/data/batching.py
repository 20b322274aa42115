"""The card's memory and the OOM-adaptive retry (counterpart:
tdc_tpu/data/batching.py, its `device_hbm_bytes`, `is_oom_error` and
`oom_adaptive`).

Reference counterpart: the OOM-halving loop (`except
ResourceExhaustedError: num_batches *= 2`,
scripts/distribuitedClustering.py:357-360). The retry loop doubles
num_batches on a CUDA out-of-memory error and on nothing else: a kernel
that fails to build or launch raises as it is, never retried on smaller
batches. The JAX package's working-set batch sizing (`auto_batch_size`)
serves its mini-batch fit and its device cache, which are not ported
(ROADMAP.md Queue A, A8b and A7(c)).
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
