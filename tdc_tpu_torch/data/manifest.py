"""Sharded dataset manifests: the object-store data plane's table of
contents (counterpart: tdc_tpu/data/manifest.py; the same file format,
so a manifest written by either package reads in the other).

A manifest is one small JSON document describing a dataset as a list of
ranged binary blobs — per shard: the blob name, an optional byte offset
into it, a row count, and one CRC32 per `read_batch` slice — plus the
global geometry (dtype, feature width, total rows, batch rows).

Layout rules, all validated loudly at load (`Manifest.validate`):

- shard row counts sum exactly to `n_rows`;
- every shard except the globally LAST one holds a multiple of
  `batch_rows` rows, so a batch never straddles two blobs and every
  `read_batch(i)` is ONE contiguous ranged read;
- each shard carries exactly `ceil(rows / batch_rows)` CRCs — one per
  batch slice, computed over the slice's raw little-endian bytes.

Blobs are raw C-order row bytes with no header (`.bin`), or any file
whose rows start at the shard's `offset` (a `.npy` after its header):
offset math is `offset + row * d * itemsize`, and any HTTP range server
can serve them. `build_manifest` writes the blobs + manifest.

Process assignment (`assign_batches`): contiguous equal batch ranges —
process p of P reads global batches [p*NB/P, (p+1)*NB/P), refused where
NB % P != 0 (unequal batch counts would deadlock the per-batch
collectives). The port's streamed fits do not use it under a mesh: every
rank there reads every batch and copies its rows of it
(`data/store.open_manifest_stream`).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import NamedTuple

import numpy as np

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"


class ShardSpec(NamedTuple):
    """One ranged blob of a manifest."""

    blob: str  # blob name, relative to the manifest's base URL
    rows: int  # rows this shard holds
    offset: int  # byte offset of the shard's first row inside the blob
    crcs: tuple  # one CRC32 per read_batch slice of this shard


class Manifest(NamedTuple):
    """A loaded, validated dataset manifest."""

    dtype: np.dtype
    d: int  # feature width
    n_rows: int  # global rows across all shards
    batch_rows: int  # rows per read_batch slice
    shards: tuple  # ShardSpec, in row order

    @property
    def num_batches(self) -> int:
        return -(-self.n_rows // self.batch_rows)

    @property
    def row_bytes(self) -> int:
        return int(self.dtype.itemsize) * self.d

    @property
    def itemsize(self) -> int:
        return int(self.dtype.itemsize)

    def validate(self) -> "Manifest":
        """Refuse a manifest whose totals or geometry lie (see module doc);
        returns self so load sites can chain."""
        if self.d < 1 or self.batch_rows < 1 or self.n_rows < 1:
            raise ValueError(
                f"manifest geometry invalid: d={self.d}, "
                f"batch_rows={self.batch_rows}, n_rows={self.n_rows}"
            )
        if not self.shards:
            raise ValueError("manifest lists no shards")
        total = sum(s.rows for s in self.shards)
        if total != self.n_rows:
            raise ValueError(
                f"manifest shard rows sum to {total} but n_rows says "
                f"{self.n_rows} — refusing to stream from a manifest whose "
                "totals lie (a shard list drifted from its header)"
            )
        for si, s in enumerate(self.shards):
            if s.rows < 1 or s.offset < 0:
                raise ValueError(
                    f"manifest shard {si} ({s.blob!r}) invalid: "
                    f"rows={s.rows}, offset={s.offset}"
                )
            last = si == len(self.shards) - 1
            if not last and s.rows % self.batch_rows != 0:
                raise ValueError(
                    f"manifest shard {si} ({s.blob!r}) holds {s.rows} rows, "
                    f"not a multiple of batch_rows={self.batch_rows} — only "
                    "the final shard may be ragged (a batch must never "
                    "straddle two blobs: one read_batch = one ranged read)"
                )
            want_crcs = -(-s.rows // self.batch_rows)
            if len(s.crcs) != want_crcs:
                raise ValueError(
                    f"manifest shard {si} ({s.blob!r}) carries "
                    f"{len(s.crcs)} CRCs for {want_crcs} batch slice(s) — "
                    "re-generate the manifest (build_manifest) for this "
                    "batch size"
                )
        return self

    def locate(self, g: int):
        """(shard, byte_offset_in_blob, rows, crc) of global batch `g`."""
        if not (0 <= g < self.num_batches):
            raise IndexError(f"batch {g} out of range "
                             f"[0, {self.num_batches})")
        row0 = g * self.batch_rows
        for s in self.shards:
            if row0 < s.rows:
                rows = min(self.batch_rows, s.rows - row0)
                return (s, s.offset + row0 * self.row_bytes, rows,
                        int(s.crcs[row0 // self.batch_rows]))
            row0 -= s.rows
        raise IndexError(f"batch {g} beyond the shard list")  # unreachable

    def to_json(self) -> dict:
        return {
            "version": MANIFEST_VERSION,
            "dtype": str(self.dtype),
            "d": self.d,
            "n_rows": self.n_rows,
            "batch_rows": self.batch_rows,
            "shards": [
                {"blob": s.blob, "rows": s.rows, "offset": s.offset,
                 "crcs": list(s.crcs)}
                for s in self.shards
            ],
        }


def parse_manifest(doc: dict) -> Manifest:
    """Build + validate a Manifest from its JSON document."""
    version = doc.get("version")
    if version != MANIFEST_VERSION:
        raise ValueError(
            f"unsupported manifest version {version!r} "
            f"(this build reads version {MANIFEST_VERSION})"
        )
    try:
        m = Manifest(
            dtype=np.dtype(doc["dtype"]),
            d=int(doc["d"]),
            n_rows=int(doc["n_rows"]),
            batch_rows=int(doc["batch_rows"]),
            shards=tuple(
                ShardSpec(
                    blob=str(s["blob"]),
                    rows=int(s["rows"]),
                    offset=int(s.get("offset", 0)),
                    crcs=tuple(int(c) for c in s["crcs"]),
                )
                for s in doc["shards"]
            ),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed manifest document: {e}") from e
    return m.validate()


def assign_batches(n_batches: int, num_processes: int,
                   process_index: int) -> range:
    """Disjoint contiguous batch range for one gang process — pure
    arithmetic, zero coordination. Refuses the layouts where disjoint
    reading would break the per-batch collective contract (see module
    doc): NB % P != 0."""
    n_batches = int(n_batches)
    num_processes = int(num_processes)
    process_index = int(process_index)
    if not (0 <= process_index < num_processes):
        raise ValueError(
            f"process_index {process_index} out of range "
            f"[0, {num_processes})"
        )
    if num_processes <= 1:
        return range(n_batches)
    if n_batches % num_processes != 0:
        raise ValueError(
            f"manifest holds {n_batches} batches, not divisible by "
            f"{num_processes} gang processes — disjoint assignment would "
            "give hosts unequal batch counts and the per-batch collectives "
            "would deadlock; re-shard the dataset (build_manifest) to a "
            "batch count divisible by the gang size"
        )
    per = n_batches // num_processes
    return range(process_index * per, (process_index + 1) * per)


def build_manifest(x: np.ndarray, batch_rows: int, out_dir: str, *,
                   shard_rows=None, n_shards: int | None = None) -> str:
    """Export `x` as raw `.bin` blobs + manifest.json under `out_dir`.

    `shard_rows` (explicit per-shard row counts) or `n_shards` (equal
    split, rounded to whole batches) control the sharding; default one
    shard. Every shard except the last must come out a whole number of
    batches — enforced here so the written manifest always validates.
    Returns the manifest path.
    """
    x = np.ascontiguousarray(x)
    if x.ndim != 2:
        raise ValueError(f"expected 2-D points, got shape {x.shape}")
    n, d = x.shape
    batch_rows = int(batch_rows)
    if shard_rows is None:
        if n_shards is None:
            shard_rows = [n]
        else:
            nb = -(-n // batch_rows)
            per = -(-nb // int(n_shards)) * batch_rows
            shard_rows = []
            left = n
            while left > 0:
                take = min(per, left)
                shard_rows.append(take)
                left -= take
    if sum(shard_rows) != n:
        raise ValueError(
            f"shard_rows {shard_rows} sum to {sum(shard_rows)}, "
            f"dataset holds {n}"
        )
    os.makedirs(out_dir, exist_ok=True)
    shards = []
    row0 = 0
    for si, rows in enumerate(shard_rows):
        if si < len(shard_rows) - 1 and rows % batch_rows != 0:
            raise ValueError(
                f"shard {si} rows {rows} not a multiple of "
                f"batch_rows={batch_rows} (only the last shard may be "
                "ragged)"
            )
        blob = f"part-{si:05d}.bin"
        chunk = x[row0:row0 + rows]
        crcs = [
            zlib.crc32(np.ascontiguousarray(
                chunk[b:b + batch_rows]).tobytes())
            for b in range(0, rows, batch_rows)
        ]
        tmp = os.path.join(out_dir, blob + ".tmp")
        with open(tmp, "wb") as f:
            f.write(chunk.tobytes())
        os.replace(tmp, os.path.join(out_dir, blob))
        shards.append(ShardSpec(blob=blob, rows=int(rows), offset=0,
                                crcs=tuple(crcs)))
        row0 += rows
    m = Manifest(dtype=x.dtype, d=int(d), n_rows=int(n),
                 batch_rows=batch_rows, shards=tuple(shards)).validate()
    path = os.path.join(out_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(m.to_json(), f)
    os.replace(tmp, path)
    return path


__all__ = [
    "MANIFEST_NAME",
    "MANIFEST_VERSION",
    "Manifest",
    "ShardSpec",
    "assign_batches",
    "build_manifest",
    "parse_manifest",
]
