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
`make_hierarchical_mesh` (the two-stage dcn × ici reduce) is not ported
(ROADMAP.md Queue A, A4).
"""

from __future__ import annotations

import math
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

    def psum(self, t: torch.Tensor, *axes: str) -> torch.Tensor:
        """Sum `t` over the ranks along each named axis in turn, in place;
        returns `t`. Every rank along those axes gets the same bits."""
        for name in axes:
            group = self.groups[self.axis_names.index(name)]
            if group is not None:
                dist.all_reduce(t, group=group)
        return t


def make_grid(shape, axis_names) -> Mesh:
    """A grid of the given shape over every rank of the job: its product
    must equal the world size (one rank per device)."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    need, world = math.prod(shape), process_count()
    if need > world:
        raise ValueError(f"need {need} devices, have {world}")
    if need < world:
        raise ValueError(
            f"the grid {shape} takes {need} of the {world} ranks launched; "
            "the port runs one rank per device, so launch exactly "
            f"{need}")
    rank = process_index()
    coords = tuple(int(i) for i in np.unravel_index(rank, shape))
    groups = [None] * len(shape)
    if dist.is_initialized():
        ranks = np.arange(world).reshape(shape)
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


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axis names the points' rows shard over: the data axis, or the
    first axis of a mesh without one."""
    if DATA_AXIS in mesh.axis_names:
        return (DATA_AXIS,)
    return (mesh.axis_names[0],)


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
    """This rank's contiguous block of the rows of `x` along the data axis
    (np.array_split bounds: a ragged N gives the first ranks one row
    more). `x` must be the same on every rank; that is checked."""
    check_same_on_every_rank(x)
    name = axis_name or data_axes(mesh)[0]
    start, end = host_shard_bounds(x.shape[0], mesh.axis_index(name),
                                   mesh.axis_size(name))
    return x[start:end]
