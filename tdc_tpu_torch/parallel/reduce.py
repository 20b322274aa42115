"""Cross-rank reduction of sufficient statistics (counterpart:
tdc_tpu/parallel/reduce.py, the one-stage f32 `reduced_tree_stats`).

Each rank computes the stats of its own rows; every field is then summed
over the data axis, so every rank holds the stats of all rows. The fields
travel as one f32 buffer in one `all_reduce`. The JAX package's two-stage
`tree_psum` (within the host first) and its quantized per-pass reduces
are not ported (ROADMAP.md Queue A, A4 and A7).
"""

from __future__ import annotations

import torch

from tdc_tpu_torch.parallel.mesh import Mesh, data_axes


def tree_all_reduce(stats, mesh: Mesh, axes: tuple[str, ...]):
    """The NamedTuple `stats` with every field summed over `axes`: one
    all_reduce of the fields packed into one f32 buffer (each element's
    sum is the same as a reduce of its own field)."""
    fields = [t.float() for t in stats]
    flat = torch.cat([t.reshape(-1) for t in fields])
    mesh.psum(flat, *axes)
    out, at = [], 0
    for t in fields:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return type(stats)(*out)


def reduced_tree_stats(mesh: Mesh, local_fn, axis_name: str | None = None):
    """fn(*args) → `local_fn(*args)`'s stats summed over the mesh's data
    axis (`axis_name` overrides it). The rows in `args` are this rank's
    own (`mesh.shard_points`); the JAX version shards its global
    arguments itself, which a rank that holds only its rows does not
    need."""
    axes = (axis_name,) if axis_name is not None else data_axes(mesh)

    def run(*args):
        return tree_all_reduce(local_fn(*args), mesh, axes)

    return run
