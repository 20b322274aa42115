"""The port's sharded dataset manifests (`tdc_tpu_torch/data/manifest.py`)
against the JAX package's (`tdc_tpu/data/manifest.py`), on the CPU: the
manifest and assignment cases of tests/test_store.py.

Manifest checks and batch assignment are held equal exactly: the same
documents, the same ranges, the same errors in the same words. The file
format is shared: a manifest and its blobs written by either package
read in the other, byte for byte.
"""

import json
import os

import numpy as np
import pytest

from tdc_tpu_torch.data import manifest as tman
from tdc_tpu_torch.data import store as tstore


def _data(n=960, d=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8, size=(6, d)).astype(np.float32)
    x = centers[rng.integers(0, 6, n)] + rng.normal(size=(n, d)).astype(
        np.float32)
    return x.astype(np.float32)


def _raises_alike(port_call, jax_call):
    """Both calls raise the same exception type with the same words."""
    with pytest.raises(Exception) as got:
        port_call()
    with pytest.raises(Exception) as want:
        jax_call()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Manifest integrity, held to the JAX package's checks
# ---------------------------------------------------------------------------


def _doc(**over):
    doc = {
        "version": 1, "dtype": "float32", "d": 4, "n_rows": 480,
        "batch_rows": 120,
        "shards": [
            {"blob": "a.bin", "rows": 240, "offset": 0, "crcs": [1, 2]},
            {"blob": "b.bin", "rows": 240, "offset": 0, "crcs": [3, 4]},
        ],
    }
    doc.update(over)
    return doc


def _straddling():
    doc = _doc()
    doc["shards"][0].update(rows=200, crcs=[1, 2])
    doc["shards"][1].update(rows=280, crcs=[3, 4, 5])
    return doc


def _crc_short():
    doc = _doc()
    doc["shards"][0]["crcs"] = [1]
    return doc


@pytest.mark.parametrize("doc", [
    _doc(version=2), _doc(n_rows=481), _crc_short(), _straddling(),
    _doc(shards=[{"blob": "a.bin"}]), _doc(d=0), _doc(shards=[]),
], ids=["version", "totals_lie", "crc_count", "straddle", "malformed",
        "geometry", "no_shards"])
def test_bad_manifest_refused_in_the_jax_words(doc):
    from tdc_tpu.data import manifest as jman

    _raises_alike(lambda: tman.parse_manifest(json.loads(json.dumps(doc))),
                  lambda: jman.parse_manifest(json.loads(json.dumps(doc))))


def test_clean_doc_and_locate_match_jax():
    from tdc_tpu.data import manifest as jman

    got, want = tman.parse_manifest(_doc()), jman.parse_manifest(_doc())
    assert got.to_json() == want.to_json()
    assert got.num_batches == want.num_batches == 4
    m = tman.Manifest(
        dtype=np.dtype(np.float32), d=4, n_rows=480, batch_rows=120,
        shards=(tman.ShardSpec("a.bin", 240, 64, (7, 8)),
                tman.ShardSpec("b.bin", 240, 0, (9, 10)))).validate()
    jm = jman.Manifest(
        dtype=np.dtype(np.float32), d=4, n_rows=480, batch_rows=120,
        shards=(jman.ShardSpec("a.bin", 240, 64, (7, 8)),
                jman.ShardSpec("b.bin", 240, 0, (9, 10)))).validate()
    for g in range(4):
        a, b = m.locate(g), jm.locate(g)
        assert (a[0].blob, *a[1:]) == (b[0].blob, *b[1:])
    _raises_alike(lambda: m.locate(4), lambda: jm.locate(4))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifest_files_read_across_packages(tmp_path, writer):
    """A manifest and its blobs written by either package read in the
    other, byte for byte."""
    from tdc_tpu.data import manifest as jman
    from tdc_tpu.data import store as jstore

    x = _data(500, 4, seed=2)
    build = tman.build_manifest if writer == "port" else jman.build_manifest
    path = build(x, 120, str(tmp_path), n_shards=2)
    with open(path) as f:
        doc = json.load(f)
    assert tman.parse_manifest(doc).to_json() == \
        jman.parse_manifest(doc).to_json()
    a = tstore.open_manifest_stream(str(tmp_path))
    b = jstore.open_manifest_stream(str(tmp_path))
    assert (a.num_batches, a.n_rows) == (b.num_batches, b.n_rows) == (5, 500)
    for i in range(5):
        np.testing.assert_array_equal(a.read_batch(i), b.read_batch(i))
    np.testing.assert_array_equal(np.concatenate(list(a())), x)
    a.close()
    b.close()


def test_build_manifest_writes_the_jax_files(tmp_path):
    from tdc_tpu.data import manifest as jman

    x = _data(700, 5, seed=3)
    p = tman.build_manifest(x, 100, str(tmp_path / "p"),
                            shard_rows=[300, 200, 200])
    j = jman.build_manifest(x, 100, str(tmp_path / "j"),
                            shard_rows=[300, 200, 200])
    assert open(p).read() == open(j).read()
    for blob in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "p" / blob).read_bytes() == \
            (tmp_path / "j" / blob).read_bytes()
    _raises_alike(
        lambda: tman.build_manifest(x, 100, str(tmp_path / "q"),
                                    shard_rows=[250, 450]),
        lambda: jman.build_manifest(x, 100, str(tmp_path / "r"),
                                    shard_rows=[250, 450]))


def test_non_json_manifest_refused(tmp_path):
    from tdc_tpu.data import store as jstore

    (tmp_path / tman.MANIFEST_NAME).write_text("not json {")
    _raises_alike(lambda: tstore.open_manifest_stream(str(tmp_path)),
                  lambda: jstore.open_manifest_stream(str(tmp_path)))


# ---------------------------------------------------------------------------
# Assignment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("procs", [1, 2, 4])
@pytest.mark.parametrize("n_batches", [4, 8, 12])
def test_assignment_matches_jax(procs, n_batches):
    from tdc_tpu.data import manifest as jman

    for p in range(procs):
        assert tman.assign_batches(n_batches, procs, p) == \
            jman.assign_batches(n_batches, procs, p)


@pytest.mark.parametrize("args", [(10, 4, 0), (8, 2, 2)],
                         ids=["indivisible", "bad_index"])
def test_assignment_refusals_in_the_jax_words(args):
    from tdc_tpu.data import manifest as jman

    _raises_alike(lambda: tman.assign_batches(*args),
                  lambda: jman.assign_batches(*args))


def test_disjoint_stream_assignment_and_ragged_tail(tmp_path):
    """Explicit process coordinates give the JAX package's disjoint
    ranges; a gang with a ragged tail batch is refused in its words."""
    from tdc_tpu.data import store as jstore

    x = _data(960, 6, seed=3)
    tman.build_manifest(x, 120, str(tmp_path / "a"),
                        shard_rows=[480, 240, 240])
    local = []
    for p in range(2):
        s = tstore.open_manifest_stream(str(tmp_path / "a"), process_index=p,
                                        num_processes=2)
        j = jstore.open_manifest_stream(str(tmp_path / "a"), process_index=p,
                                        num_processes=2)
        assert s.disjoint_shards and s.num_batches == 4 and s.n_rows == 480
        assert s.assigned_batches == j.assigned_batches
        local.append(np.concatenate([s.read_batch(i) for i in range(4)]))
        s.close()
        j.close()
    np.testing.assert_array_equal(np.concatenate(local), x)
    y = _data(430, 4, seed=4)
    tman.build_manifest(y, 120, str(tmp_path / "b"))
    _raises_alike(
        lambda: tstore.open_manifest_stream(str(tmp_path / "b"),
                                            process_index=0,
                                            num_processes=2),
        lambda: jstore.open_manifest_stream(str(tmp_path / "b"),
                                            process_index=0,
                                            num_processes=2))
    s = tstore.open_manifest_stream(str(tmp_path / "b"))
    assert s.num_batches == 4 and s.n_rows == 430
    s.close()


def test_mesh_placement_opens_every_batch(tmp_path):
    """The port's mesh rule: spec= (a mesh, or None) opens every batch
    on every rank; spec with explicit coordinates is refused."""
    from tdc_tpu_torch.parallel.mesh import make_mesh

    x = _data(480, 4, seed=5)
    tman.build_manifest(x, 120, str(tmp_path))
    s = tstore.open_manifest_stream(str(tmp_path), spec=make_mesh(1))
    assert not s.disjoint_shards and s.num_batches == 4
    s.close()
    with pytest.raises(ValueError, match="not both"):
        tstore.open_manifest_stream(str(tmp_path), spec=make_mesh(1),
                                    process_index=0)
