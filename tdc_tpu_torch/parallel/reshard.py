"""The layout manifest of a checkpoint (counterpart: the manifest part of
tdc_tpu/parallel/reshard.py).

Every streamed fit's checkpoint records the mesh it was saved under as
five `layout_*` meta ints, so a restore at another world size is
recognised. In the port each rank is a process, so n_devices =
n_processes = the mesh's ranks; the streamed fits' meshes are 1-D or
hierarchical (dcn × ici), so n_model = 1. The state a checkpoint holds
is full host arrays, so placing it on any mesh is a replicate: a save
taken at N ranks restores at M (`redistribute` names the resize in a
`reshard_redistribute` event, then places).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# Checkpoint-meta key prefix of the manifest.
LAYOUT_META_PREFIX = "layout_"


class LayoutManifest(NamedTuple):
    """The mesh layout a checkpoint was written under."""

    n_devices: int
    n_processes: int
    n_data: int
    n_model: int
    hier: int  # 1 = hierarchical (dcn, ici) mesh, else 0

    def describe(self) -> str:
        return (f"{self.n_devices}dev/{self.n_processes}proc"
                f"(data={self.n_data},model={self.n_model}"
                f"{',hier' if self.hier else ''})")


def manifest_of(mesh) -> LayoutManifest:
    """The layout of `mesh` (None: one device, one process)."""
    if mesh is None:
        return LayoutManifest(1, 1, 1, 1, 0)
    from tdc_tpu_torch.parallel.mesh import data_index, is_hierarchical

    return LayoutManifest(n_devices=mesh.size, n_processes=mesh.size,
                          n_data=data_index(mesh)[1], n_model=1,
                          hier=int(is_hierarchical(mesh)))


def layout_meta(mesh) -> dict:
    """Checkpoint-meta entries for this layout (numeric, npz-safe)."""
    m = manifest_of(mesh)
    return {LAYOUT_META_PREFIX + k: int(v) for k, v in m._asdict().items()}


def layout_from_meta(meta: dict) -> LayoutManifest | None:
    """A checkpoint's manifest, or None for one written without it."""
    if meta is None or LAYOUT_META_PREFIX + "n_devices" not in meta:
        return None
    return LayoutManifest(**{
        f: int(np.asarray(meta.get(LAYOUT_META_PREFIX + f, 0)))
        for f in LayoutManifest._fields})


def redistribute(tree, old: LayoutManifest | None, mesh, place):
    """Place host-side checkpoint state on `mesh` with `place(tree)`,
    after one `reshard_redistribute` event when the saved layout differs
    from this one."""
    cur = manifest_of(mesh)
    if old is not None and old != cur:
        from tdc_tpu_torch.utils.structlog import emit

        emit("reshard_redistribute", saved_layout=old.describe(),
             new_layout=cur.describe())
    return place(tree)


__all__ = ["LAYOUT_META_PREFIX", "LayoutManifest", "layout_from_meta",
           "layout_meta", "manifest_of", "redistribute"]
