"""Process groups for multi-GPU runs (counterpart:
tdc_tpu/parallel/multihost.py).

The JAX package drives every device of a host from one process and joins
hosts with `jax.distributed`. The port runs one process per GPU (a rank)
and joins them with `torch.distributed`:

- `initialize_from_env` reads what torchrun sets (RANK, WORLD_SIZE,
  LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
  `initialize_distributed` takes an explicit `init_method` (the tests use
  a `file://` store). World size 1 needs no handshake.
- Backend: `gloo` for CPU tensors. For CUDA tensors `nccl`, each local
  rank on its own card (`torch.cuda.set_device(LOCAL_RANK)`), while the
  host has a card for every local rank. Where local ranks outnumber the
  cards, NCCL refuses two ranks on one GPU, so the ranks share the cards
  and run `gloo` on the same CUDA tensors, with a `distributed_backend`
  event that names the choice. That is not a fallback: the data and the
  kernels stay on the card. Gloo takes CUDA tensors only in `all_reduce`,
  `broadcast` and `barrier`, so the port's collectives are those three.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tdc_tpu_torch.utils.structlog import emit, set_process_index


def process_count() -> int:
    """Ranks in the job: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank: 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def _backend(device: torch.device, local_rank: int,
             local_world_size: int) -> str:
    """The backend for tensors on `device`, after placing a CUDA rank on
    its card."""
    if device.type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the gloo CPU path")
    cards = torch.cuda.device_count()
    if local_world_size <= cards:
        torch.cuda.set_device(local_rank)
        return "nccl"
    torch.cuda.set_device(local_rank % cards)
    emit("distributed_backend", backend="gloo", local_rank=local_rank,
         local_world_size=local_world_size, cards=cards, reason=(
             f"{local_world_size} local ranks share {cards} card(s) and NCCL "
             "takes one rank per GPU: gloo all-reduces the same CUDA "
             "tensors"))
    return "gloo"


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, *, device="cuda",
                           local_rank: int | None = None,
                           local_world_size: int | None = None
                           ) -> tuple[int, int]:
    """Join the process group (a no-op when it is up already, or for a
    world of one). `init_method` defaults to "env://" (MASTER_ADDR and
    MASTER_PORT); the local rank and local world size default to the rank
    and the world size (one host). Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world_size = int(world_size or 1)
    if world_size <= 1:
        return 0, 1
    if rank is None:
        raise ValueError("initialize_distributed: a world of "
                         f"{world_size} needs this process's rank")
    rank = int(rank)
    backend = _backend(
        torch.device(device), rank if local_rank is None else local_rank,
        world_size if local_world_size is None else local_world_size)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    from tdc_tpu_torch.utils.preempt import reinstall_if_installed

    # The JAX package's call order: a drain handler installed before the
    # group came up stays in place.
    reinstall_if_installed()
    set_process_index(rank)
    emit("gang_init", process_id=rank, num_processes=world_size,
         backend=backend)
    return rank, world_size


def launched_world_size() -> int:
    """The world size of this launch: the process group's, else torchrun's
    WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize_from_env(device="cuda") -> tuple[int, int]:
    """Join the process group that torchrun describes in the environment
    (absent: a world of one, no handshake). Returns (rank, world size)."""
    env = os.environ
    if dist.is_initialized() or "WORLD_SIZE" not in env:
        return initialize_distributed(device=device)
    world = int(env["WORLD_SIZE"])
    rank = int(env.get("RANK", "0"))
    return initialize_distributed(
        "env://", world, rank, device=device,
        local_rank=int(env.get("LOCAL_RANK", rank)),
        local_world_size=int(env.get("LOCAL_WORLD_SIZE", world)))


def barrier() -> None:
    """Every rank waits for the others; a no-op in one process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
        set_process_index(None)


def host_shard_bounds(n_global: int, index: int | None = None,
                      count: int | None = None) -> tuple[int, int]:
    """[start, end) of shard `index` of `count` (default: this rank of the
    world) over n_global rows: an even split with the remainder spread
    over the first shards (np.array_split semantics)."""
    p = process_index() if index is None else int(index)
    np_ = process_count() if count is None else int(count)
    base, extra = divmod(int(n_global), np_)
    start = p * base + min(p, extra)
    return start, start + base + (1 if p < extra else 0)
