"""Checkpoint and resume (counterpart: tdc_tpu/utils/checkpoint.py).

A checkpoint is (centroids, iteration, key, batch cursor, meta) under
`<ckpt_dir>/step_<8 digits>/state.npz`, the JAX package's single-writer
format: every array, and every meta entry as `meta_<name>`, beside a
`crc_<name>` CRC32 of its raw bytes, written to a uuid-named tmp file
and swapped in with `os.replace`. The port always writes this format,
so the JAX package's `restore_checkpoint` reads a port checkpoint as it
is, and the port reads the JAX package's multi-process saves.

A step directory without `state.npz` that holds other files is an orbax
save (the JAX package's single-process format). The port has no orbax,
so restoring one raises `CheckpointFormatError`, which says how to get a
`state.npz` save; the newest-first scan never skips such a step.

The key: JAX's is a threefry key, which no torch generator continues. The
port writes `has_key=False` with the zero (2,) key; a fit that draws
after its init (mini-batch) keeps its generator state in a meta entry of
its own.

Gangs: each rank of a mesh is a process. A fit whose mesh spans several
ranks saves with gang=True: rank 0 is the single writer, and every rank
meets at `parallel.multihost.barrier()` before returning, so a restore
on any rank happens after the write.

Every array is a full host copy (tensors are copied to the host here,
which waits for the card), so a save taken at N ranks restores at M.

Fault points (`testing/faults.py`): `ckpt.save.pre_replace` between the
tmp write and the rename, `ckpt.restore` before a step's state is read.
"""

from __future__ import annotations

import os
import shutil
import uuid
import zlib
from typing import Any, NamedTuple

import numpy as np

from tdc_tpu_torch.testing.faults import fault_point

STATE_NAME = "state.npz"


class CheckpointCorrupt(ValueError):
    """state.npz loaded but an array failed its CRC32. The newest-first
    restore scan treats the step as unreadable and falls back; an
    explicit-step restore propagates it."""


class CheckpointFormatError(ValueError):
    """A step directory in a format the port cannot read (an orbax
    save). Never skipped: the restore scan raises it."""


class ClusterState(NamedTuple):
    """Everything needed to resume a clustering run."""

    centroids: Any  # (K, d) f32
    n_iter: int
    key: Any  # the JAX package's PRNG key data, or None
    batch_cursor: int  # batches consumed in the current pass (streamed)
    meta: dict  # method/K/n_dim/... for the checks on restore


def _host(v) -> np.ndarray:
    """A numpy copy of `v`; a tensor is copied to the host (a sync)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _manual_save(path: str, payload: dict) -> None:
    """The single-writer atomic save: one .npz, swapped into the stable
    step directory with os.replace, so a reader sees either the old or
    the new state (mid-pass saves rewrite the same step)."""
    meta = payload.pop("meta")
    os.makedirs(path, exist_ok=True)
    arrays = {k: _host(v) for k, v in payload.items()}
    arrays.update({f"meta_{k}": _host(v) for k, v in meta.items()})
    crcs = {
        f"crc_{k}": np.uint32(zlib.crc32(np.ascontiguousarray(v).tobytes()))
        for k, v in arrays.items()
    }
    # np.savez keeps a name that already ends in .npz. The uuid never
    # reaches a persisted name: os.replace swaps the file to state.npz.
    tmp = os.path.join(path, f"state.tmp-{uuid.uuid4().hex[:8]}.npz")  # tdclint: disable=TDC007
    np.savez(tmp, **arrays, **crcs)
    fault_point("ckpt.save.pre_replace")
    os.replace(tmp, os.path.join(path, STATE_NAME))


def _manual_restore(path: str) -> dict:
    with np.load(os.path.join(path, STATE_NAME), allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    crcs = {k[len("crc_"):]: payload.pop(k) for k in list(payload)
            if k.startswith("crc_")}
    # Saves from before the CRCs carry none and skip the check.
    for name, want in crcs.items():
        if name not in payload:
            continue
        got = zlib.crc32(np.ascontiguousarray(payload[name]).tobytes())
        if got != int(want):
            raise CheckpointCorrupt(
                f"{os.path.join(path, STATE_NAME)}: array {name!r} CRC32 "
                f"{got:#010x} != stored {int(want):#010x} — checkpoint is "
                "corrupt")
    payload["meta"] = {k[len("meta_"):]: payload.pop(k) for k in list(payload)
                       if k.startswith("meta_")}
    return payload


def _is_orbax_step(path: str) -> bool:
    """A step directory without state.npz that holds more than tmp files
    of the manual format (a crash before the first swap leaves only
    those, or nothing)."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return STATE_NAME not in names and any(
        not n.startswith("state.tmp-") for n in names)


def _prune_old_steps(ckpt_dir: str, keep_last_n: int) -> None:
    """Drop all but the newest keep_last_n step directories; only the
    writer calls it, after its own write."""
    for s in _all_steps(ckpt_dir)[:-keep_last_n]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def save_checkpoint(ckpt_dir: str, state: ClusterState, step: int, *,
                    gang: bool | None = None,
                    keep_last_n: int | None = None) -> str:
    """Write `state` under ckpt_dir/step_<step>; returns the path.

    keep_last_n: after the write, keep only the newest N step directories
    (None keeps all; N >= 2 keeps the step a corrupt newest one falls
    back to). gang: True when the fit spans several ranks (rank 0 writes,
    every rank meets at a barrier), False for a fit of this process alone;
    None infers it from the process group's size. A failed write raises.
    """
    if keep_last_n is not None and keep_last_n < 1:
        # keep_last_n=0 would prune the step just written.
        raise ValueError(f"keep_last_n must be >= 1 or None, got {keep_last_n}")
    from tdc_tpu_torch.parallel import multihost

    if gang is None:
        gang = multihost.process_count() > 1
    path = _step_dir(ckpt_dir, step)
    if not gang or multihost.process_index() == 0:
        _manual_save(path, {
            "centroids": state.centroids,
            "n_iter": np.asarray(state.n_iter),
            "key": (np.zeros(2, np.uint32) if state.key is None
                    else state.key),
            "has_key": np.asarray(state.key is not None),
            "batch_cursor": np.asarray(state.batch_cursor),
            "meta": dict(state.meta),
        })
        if keep_last_n is not None:
            _prune_old_steps(ckpt_dir, keep_last_n)
    if gang:
        multihost.barrier()
    return path


def _all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
                  if name.startswith("step_") and name.split("_")[1].isdigit())


def latest_step(ckpt_dir: str) -> int | None:
    steps = _all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str,
                       step: int | None = None) -> ClusterState | None:
    """Load the given (default: the newest valid) checkpoint, or None if
    there is none.

    With step=None the steps are tried newest first: a crash can leave
    the newest step truncated (no state yet) or corrupt, and the resume
    falls back to the previous one. Several steps of which none loads
    raise RuntimeError; a single unreadable step returns None (a crash
    while writing the first checkpoint). An orbax step raises
    CheckpointFormatError; an explicit step propagates its error."""
    if step is None:
        from tdc_tpu_torch.utils.structlog import emit

        steps = _all_steps(ckpt_dir)
        errors = []
        for cand in reversed(steps):
            try:
                return restore_checkpoint(ckpt_dir, cand)
            except CheckpointFormatError:
                raise
            except Exception as e:  # a truncated or corrupt step
                errors.append((cand, e))
                emit("ckpt_step_unreadable", dir=ckpt_dir, step=cand,
                     error=f"{type(e).__name__}: {e}",
                     action="trying the previous step")
        if len(steps) > 1:
            raise RuntimeError(
                f"checkpoint dir {ckpt_dir} has {len(steps)} steps but "
                "none could be loaded — refusing to silently restart from "
                f"scratch; last error: {type(errors[-1][1]).__name__}: "
                f"{errors[-1][1]} (delete the directory to start fresh)")
        return None
    path = _step_dir(ckpt_dir, step)
    fault_point("ckpt.restore")
    if _is_orbax_step(path):
        raise CheckpointFormatError(
            f"{path} is an orbax checkpoint (the JAX package's "
            "single-process format), which tdc_tpu_torch cannot read: "
            "load it with tdc_tpu.utils.checkpoint.restore_checkpoint and "
            "write it again with tdc_tpu.utils.checkpoint._manual_save "
            "(the state.npz format, which multi-process JAX runs and "
            "tdc_tpu_torch write)")
    payload = _manual_restore(path)
    key = (np.asarray(payload["key"]) if bool(np.asarray(payload["has_key"]))
           else None)
    return ClusterState(
        centroids=np.asarray(payload["centroids"]),
        n_iter=int(np.asarray(payload["n_iter"])),
        key=key,
        batch_cursor=int(np.asarray(payload["batch_cursor"])),
        meta=dict(payload["meta"]),
    )


__all__ = ["CheckpointCorrupt", "CheckpointFormatError", "ClusterState",
           "latest_step", "restore_checkpoint", "save_checkpoint"]
