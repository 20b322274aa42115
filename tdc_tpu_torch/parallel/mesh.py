"""The grid of ranks and its placement helpers (counterpart:
tdc_tpu/parallel/mesh.py).

JAX's `Mesh` is one controller's array of devices, and `shard_map` runs a
body per device. Here each device is a rank of its own process, and a
`Mesh` is that rank's view of an explicit grid:

- its shape and axis names, row-major over the ranks (rank r of a
  (n_data, n_model) grid sits at (r // n_model, r % n_model), as JAX's
  `make_mesh_2d` reshapes its device list);
- this rank's coordinates: its place on the data axis picks its rows
  (`shard_points`), its place on the model axis its block of centroids;
- one process subgroup per axis (`dist.new_group`): the ranks that differ
  from this one only along that axis. `jax.lax.psum(·, axis)` becomes
  `Mesh.psum(·, axis)`, an `all_reduce` over that subgroup.

In one process without a process group every axis has size 1 and `psum`
returns its input: a 1-rank mesh runs the same code as a larger one.

`make_hierarchical_mesh` is the two-level (dcn, ici) data-parallel grid:
the outer axis crosses hosts, the inner one stays among one host's ranks.
The points shard over both axes (a rank's block is its joint index
dcn·n_ici + ici, `data_index`), and `psum` over both reduces the ici axis
first, then the dcn axis, so each host's payload crosses hosts once,
already combined (`parallel/reduce.tree_psum`).
"""

from __future__ import annotations

import math
import os
import socket
import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from tdc_tpu_torch.parallel.multihost import (
    host_shard_bounds,
    process_count,
    process_index,
)

DATA_AXIS = "data"
# The two axes of a hierarchical mesh: across hosts (the data-center
# network) and within a host (the GPUs' own links).
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a grid of ranks (see the module docstring)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    coords: tuple[int, ...]  # this rank's place on each axis
    groups: tuple  # per axis: this rank's subgroup, None in one process

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def psum(self, t: torch.Tensor, *axes: str,
             op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce `t` (a sum, or `op`) over the ranks along the named
        axes, in place; returns `t`. The innermost axis goes first
        (JAX's `tree_psum` order: ici before dcn), whatever order the
        names come in. Every rank along those axes gets the same bits."""
        for name in sorted(axes, key=self.axis_names.index, reverse=True):
            group = self.groups[self.axis_names.index(name)]
            if group is not None:
                dist.all_reduce(t, op=op, group=group)
        return t


def _check_size(shape: tuple, world: int) -> None:
    need = math.prod(shape)
    if need > world:
        raise ValueError(f"need {need} devices, have {world}")
    if need < world:
        raise ValueError(
            f"the grid {shape} takes {need} of the {world} ranks launched; "
            "the port runs one rank per device, so launch exactly "
            f"{need}")


def make_grid(shape, axis_names, ranks=None) -> Mesh:
    """A grid of the given shape over every rank of the job: its product
    must equal the world size (one rank per device). `ranks` (an array of
    that shape) places the ranks; by default row-major in rank order."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    world = process_count()
    _check_size(shape, world)
    rank = process_index()
    ranks = (np.arange(world) if ranks is None
             else np.asarray(ranks)).reshape(shape)
    coords = tuple(int(i[0]) for i in np.nonzero(ranks == rank))
    groups = [None] * len(shape)
    if dist.is_initialized():
        for ax in range(len(shape)):
            # Every rank makes every group, in the same order.
            for line in np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax]):
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[ax] = group
    return Mesh(shape, axis_names, coords, tuple(groups))


def make_mesh(n_devices: int | None = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over the ranks of the job (JAX: over the
    first `n_devices` devices). None means every rank."""
    return make_grid((process_count() if n_devices is None else n_devices,),
                     (axis_name,))


def _host_keys(world: int) -> np.ndarray:
    """(world,) int64: one key per host, the same on every rank. A rank's
    host is its host name with its torchrun node (rank // LOCAL_WORLD_SIZE,
    one node when that is unset); the keys are gathered through one
    all_reduce of a zero-filled buffer in which each rank fills its own
    slot (gloo on CUDA tensors has no all_gather)."""
    if world == 1 or not dist.is_initialized():
        return np.zeros(world, np.int64)
    rank = process_index()
    node = rank // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    key = (zlib.crc32(socket.gethostname().encode()) << 20) + node + 1
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    keys = torch.zeros(world, dtype=torch.int64, device=device)
    keys[rank] = key
    dist.all_reduce(keys)
    return keys.cpu().numpy()


def make_hierarchical_mesh(n_hosts: int | None = None,
                           n_devices: int | None = None) -> Mesh:
    """Two-level (dcn, ici) data-parallel mesh (counterpart:
    tdc_tpu/parallel/mesh.make_hierarchical_mesh): hosts × each host's
    ranks, the ranks grouped by host (`_host_keys`) in rank order within
    a host. On one host `n_hosts` emulates the grouping (the reduce runs
    in the same two stages; only the links differ). n_devices must equal
    the world size, as in `make_grid`."""
    world = process_count()
    n = world if n_devices is None else int(n_devices)
    _check_size((n,), world)
    keys = _host_keys(world)
    hosts = {int(k): i for i, k in enumerate(dict.fromkeys(keys.tolist()))}
    host_of = np.array([hosts[int(k)] for k in keys])
    if n_hosts is None:
        n_hosts = len(hosts)
    if n_hosts <= 0 or n % n_hosts != 0:
        raise ValueError(
            f"{n} devices not divisible into {n_hosts} host groups")
    ordered = sorted(range(n), key=lambda r: (host_of[r], r))
    grid = np.asarray(ordered).reshape(n_hosts, n // n_hosts)
    if len(hosts) > 1:
        # The ici axis must stay within a host: a row that spans hosts
        # would run every "intra-host" reduce across hosts, and quantize
        # the wrong stage.
        for i, row in enumerate(grid):
            spans = sorted({int(host_of[r]) for r in row})
            if len(spans) != 1:
                raise ValueError(
                    f"hierarchical mesh row {i} spans hosts {spans}; the "
                    "ici axis must be intra-host — use one host group per "
                    "host and per-host device counts divisible by the "
                    "group size")
    return make_grid(grid.shape, (DCN_AXIS, ICI_AXIS), ranks=grid)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axis names the points' rows shard over: ("dcn", "ici") on a
    hierarchical mesh, else the data axis, or the first axis of a mesh
    without one."""
    if DCN_AXIS in mesh.axis_names and ICI_AXIS in mesh.axis_names:
        return (DCN_AXIS, ICI_AXIS)
    if DATA_AXIS in mesh.axis_names:
        return (DATA_AXIS,)
    return (mesh.axis_names[0],)


def is_hierarchical(mesh: Mesh) -> bool:
    return len(data_axes(mesh)) > 1


def data_index(mesh: Mesh, axis_name: str | None = None
               ) -> tuple[int, int]:
    """(this rank's block, the block count) of the rows along the data
    axes: the joint index dcn·n_ici + ici on a hierarchical mesh (JAX's
    P(("dcn", "ici"))), or `axis_name`'s index alone."""
    index, count = 0, 1
    for name in ((axis_name,) if axis_name else data_axes(mesh)):
        index = index * mesh.axis_size(name) + mesh.axis_index(name)
        count *= mesh.axis_size(name)
    return index, count


def pad_to_multiple(x, multiple: int, fill_value=np.nan):
    """Pad the leading axis of a numpy array or tensor to a multiple of
    `multiple`. Returns (padded, n_valid)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        pad = torch.full((rem, *x.shape[1:]), fill_value, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x, pad]), n
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad_width, constant_values=fill_value), n


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's `x` on every rank (JAX: a replicated array): a broadcast
    over the job. Every rank passes a tensor of the same shape and dtype;
    the others' values are overwritten."""
    x = x.contiguous()
    if dist.is_initialized():
        dist.broadcast(x, src=0)
    return x


def check_same_on_every_rank(x: torch.Tensor, what: str = "points") -> None:
    """Raise unless `x` holds the same values on every rank, as JAX's one
    global array does by construction: rank 0 broadcasts a fingerprint
    (the shape, Σx and Σ|x| in f64) and every rank compares its own."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    mine = torch.tensor(
        [*x.shape, float(x.sum(dtype=torch.float64)),
         float(x.abs().sum(dtype=torch.float64))],
        dtype=torch.float64, device=x.device)
    theirs = replicate(mine.clone(), None)
    # Every rank learns whether any rank differs, so all of them raise
    # and none is left waiting in a later collective.
    differ = (~torch.eq(mine, theirs)).sum().reshape(1)
    dist.all_reduce(differ)
    if int(differ) != 0:
        raise ValueError(
            f"the {what} differ between ranks (rank {process_index()}: "
            f"{mine.tolist()}, rank 0: {theirs.tolist()}); every rank must "
            "pass the same array")


def shard_points(x: torch.Tensor, mesh: Mesh,
                 axis_name: str | None = None) -> torch.Tensor:
    """This rank's contiguous block of the rows of `x` along the data axes
    (`data_index`; np.array_split bounds: a ragged N gives the first ranks
    one row more). `x` must be the same on every rank; that is checked."""
    check_same_on_every_rank(x)
    start, end = host_shard_bounds(x.shape[0], *data_index(mesh, axis_name))
    return x[start:end]
