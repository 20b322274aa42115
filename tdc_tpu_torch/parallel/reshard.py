"""The layout manifest of a checkpoint (counterpart: the manifest part of
tdc_tpu/parallel/reshard.py).

Every streamed fit's checkpoint records the mesh it was saved under as
five `layout_*` meta ints, so a restore at another world size is
recognised. In the port each rank is a process, so n_devices =
n_processes = the mesh's ranks; n_model is the model axis of a K-sharded
(data, model) grid, 1 on the 1-D and hierarchical (dcn × ici) meshes.
The state a checkpoint holds is full host arrays (the K-sharded fits
gather their shards before they write), so placing it on any mesh is a
replicate, then a K-shard's slice: a save taken at N ranks, or on one
(data, model) split, restores at M or on another (`redistribute` names
the resize in a `reshard_redistribute` event and passes the
`reshard.redistribute` fault point, then places).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tdc_tpu_torch.testing.faults import fault_point

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

    n_model = (mesh.axis_size("model") if "model" in mesh.axis_names
               else 1)
    return LayoutManifest(n_devices=mesh.size, n_processes=mesh.size,
                          n_data=data_index(mesh)[1], n_model=n_model,
                          hier=int(is_hierarchical(mesh)))


def layout_meta(mesh) -> dict:
    """Checkpoint-meta entries for this layout (numeric, npz-safe)."""
    m = manifest_of(mesh)
    return {LAYOUT_META_PREFIX + k: int(v) for k, v in m._asdict().items()}


def layout_from_meta(meta: dict) -> LayoutManifest | None:
    """A checkpoint's manifest, or None for one written without it. The
    `ckpt.restore.layout` fault point fires where a manifest is read."""
    if meta is None or LAYOUT_META_PREFIX + "n_devices" not in meta:
        return None
    fault_point("ckpt.restore.layout")
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
        fault_point("reshard.redistribute")
    return place(tree)


__all__ = ["LAYOUT_META_PREFIX", "LayoutManifest", "layout_from_meta",
           "layout_meta", "manifest_of", "redistribute"]
