"""The port's two-stage and quantized reduce (`parallel/reduce.py`:
`tree_psum`, `deferred_reduce`, `tree_reduce_cost`) and its hierarchical
mesh (`parallel/mesh.make_hierarchical_mesh`), against the JAX package on
the CPU.

One group of 4 gloo ranks (spawned once per test run: the first test
worker that needs it starts it through a `file://` store and keeps its
numpy results on disk for the others) runs every multi-rank check; the
JAX side runs here on the conftest's 8 virtual devices with meshes of 4.
Tolerances:
- the cost model: JAX's (reduces, logical bytes), exactly;
- int8: the reduced sums and every rank's residual within 1 ulp of JAX's
  (the codes and their sum are exact; both packages divide and round the
  same f32 values);
- bf16: each package adds the ranks' bf16 values in its own order,
  rounding each partial sum to bf16: every such rounding is at most the
  bf16 unit roundoff (2^-8) of Σ|addends|, so the port's sums lie within
  (ranks − 1) such roundings of the exact sum of the bf16 values, and
  within twice that of JAX's; the residuals, taken before any sum,
  within 1 ulp;
- error feedback: the mean of two reduces (the second fed the first's
  residual) misses the true sum by < 0.6 × one reduce's miss;
- the hierarchical (2, 2) mesh: every rank's output bitwise equal, and
  out + Σ new_err = Σ acc + Σ err to rtol 1e-5, atol 1e-4 under int8
  (under bf16 also up to the dcn stage's one bf16 addition);
- the f32 fields of a quantized reduce and the pad counts riding with
  them: rtol 1e-6 of the f32 sums (four addends; exact for the counts).
"""

import fcntl
import multiprocessing as mp
import os
import pickle
import queue as queue_lib
import time
import traceback
from typing import NamedTuple

import numpy as np
import pytest
import torch

from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import streaming as tst
from tdc_tpu_torch.ops.assign import SufficientStats
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh
from tdc_tpu_torch.parallel import reduce as tred

WORLD = 4
BF16_ROUNDOFF = 2.0 ** -8  # half a bf16 step, relative


class One(NamedTuple):
    """A one-field stats tree (JAX's {"sums": ...})."""

    sums: torch.Tensor


# ---------------------------------------------------------------------------
# Rank groups: spawned once, shared by the test workers
# ---------------------------------------------------------------------------


def _rank_main(rank, world, init_method, job, args, queue):
    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        queue.put((rank, job(world, *args)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        tmh.shutdown()


def spawn_ranks(tmp_path, world, job, args=(), timeout=300):
    """Run `job(world, *args)` on `world` spawned gloo ranks; returns
    their results in rank order."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_path / f'store{world}'}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, job, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:  # drain before joining
            try:
                rank, out = queue.get(timeout=2)
                results[rank] = out
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    pytest.fail(f"ranks {dead} exited without a result, or "
                                f"{timeout} s passed")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(world):
        if isinstance(results.get(rank), str):
            pytest.fail(f"rank {rank} failed:\n{results[rank]}")
    return [results[r] for r in range(world)]


def shared_groups(tmp_path_factory, name, make):
    """make(tmp_dir) once per test run: under pytest-xdist the first
    worker computes it under a file lock in the run's shared temporary
    directory and pickles it there; the other workers read it."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            out = make(tmp_path_factory.mktemp(name))
            with open(path, "wb") as f:
                pickle.dump(out, f)
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(a, b)


def same_on_every_rank(ranks, key):
    """Rank 0's value of `key`, after checking every rank's is bitwise
    the same (arrays, or nested tuples of them)."""
    for r in ranks[1:]:
        _assert_same(r[key], ranks[0][key])
    return ranks[0][key]


# ---------------------------------------------------------------------------
# Inputs (the JAX package's tests/test_reduce.py, on 4 devices)
# ---------------------------------------------------------------------------


def _ef_sums(world=WORLD):
    """Per-device (16, 8) sums whose rows span 3 decades (int8 quantizes
    them for real): tests/test_reduce.py:331-360."""
    rng = np.random.default_rng(7)
    return rng.normal(size=(world, 16, 8)).astype(np.float32) * np.logspace(
        0, 3, 16).astype(np.float32)[None, :, None]


def _hier_acc_err(world=WORLD):
    """Distinct per-device accumulators and residuals:
    tests/test_reduce.py:384-408."""
    rng = np.random.default_rng(11)
    acc = rng.normal(size=(world, 16, 8)).astype(np.float32)
    err = rng.normal(size=(world, 16, 8)).astype(np.float32) * 0.1
    return acc, err


def _lloyd_tree(world=WORLD):
    rng = np.random.default_rng(5)
    return (rng.normal(size=(world, 6, 5)).astype(np.float32) * 30,
            rng.integers(0, 50, size=(world, 6)).astype(np.float32),
            rng.uniform(0, 100, size=(world,)).astype(np.float32))


def _reduce_job(world):
    out = {}
    flat = tmesh.make_mesh(world)
    hier = tmesh.make_hierarchical_mesh(2)
    # This rank's block of the per-device inputs (JAX's device order).
    rank = tmesh.data_index(flat)[0]
    out["hier"] = (hier.shape, hier.coords, tmesh.data_index(hier),
                   tmesh.data_axes(hier), tmesh.is_hierarchical(hier),
                   tmesh.is_hierarchical(flat))
    sums = _ef_sums(world)
    acc = One(torch.from_numpy(sums[rank]))
    zero = One(torch.zeros(16, 8))
    for q in ("int8", "bf16"):
        red = tred.deferred_reduce(flat, q)
        r1, e1 = red(acc, zero)
        r2, _ = red(acc, e1)
        out["flat", q] = (r1.sums.numpy(), r2.sums.numpy())
        out["flat_err", q] = e1.sums.numpy()
    a, e = _hier_acc_err(world)
    for q in ("int8", "bf16"):
        r, ne = tred.deferred_reduce(hier, q)(
            One(torch.from_numpy(a[rank])), One(torch.from_numpy(e[rank])))
        out["hier", q] = r.sums.numpy()
        out["hier_err", q] = ne.sums.numpy()
    # A Lloyd tree with the pad counts riding along: the f32 fields of a
    # quantized reduce, and the un-quantized reduce of both meshes.
    sums, counts, sse = _lloyd_tree(world)
    tree = SufficientStats(torch.from_numpy(sums[rank]),
                           torch.from_numpy(counts[rank]),
                           torch.tensor(sse[rank]))
    extra = torch.cat([tree.counts[:1], torch.ones(1), torch.zeros(1)])
    for name, m in (("flat", flat), ("hier", hier)):
        for q in (None, "int8", "bf16"):
            res = tred.tree_psum(tree, m, tmesh.data_axes(m), quantize=q,
                                 extra=extra)
            out["tree", name, q] = (tuple(t.numpy() for t in res[0]),
                                    res[2].numpy())
            out["tree_err", name, q] = (
                None if res[1] is None else tuple(t.numpy() for t in res[1]))
    # Host grouping from the launch: LOCAL_WORLD_SIZE=2 puts ranks 0-1
    # and 2-3 on two nodes; =1 each rank on its own, so a 2-host grid has
    # rows that span nodes. The refusals raise on every rank alike.
    saved = os.environ.get("LOCAL_WORLD_SIZE")
    try:
        os.environ["LOCAL_WORLD_SIZE"] = "2"
        two = tmesh.make_hierarchical_mesh()
        out["two_nodes"] = (two.shape, two.coords)
        os.environ["LOCAL_WORLD_SIZE"] = "1"
        own = tmesh.make_hierarchical_mesh()
        out["own_nodes"] = (own.shape, own.coords)
        for key, call in (
                ("spans", lambda: tmesh.make_hierarchical_mesh(2)),
                ("indivisible", lambda: tmesh.make_hierarchical_mesh(3)),
                ("short", lambda: tmesh.make_hierarchical_mesh(
                    2, n_devices=2))):
            try:
                call()
                out[key] = None
            except ValueError as err:
                out[key] = str(err)
    finally:
        if saved is None:
            os.environ.pop("LOCAL_WORLD_SIZE", None)
        else:
            os.environ["LOCAL_WORLD_SIZE"] = saved
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_groups(tmp_path_factory, "torch_reduce_ranks",
                         lambda tmp: spawn_ranks(tmp, WORLD, _reduce_job))


def _jax_deferred(mesh, quantize, acc, err):
    """JAX's deferred_reduce on per-device (world, ...) arrays; returns
    (reduced, per-device residuals) as numpy."""
    import jax

    from tdc_tpu.parallel import mesh as jmesh
    from tdc_tpu.parallel import reduce as jred

    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(
            jmesh.data_axes(mesh) if jmesh.is_hierarchical(mesh)
            else jmesh.data_axes(mesh)[0]))
    put = lambda a: {"sums": jax.device_put(a, spec)}  # noqa: E731
    r, e = jred.deferred_reduce(mesh, quantize)(put(acc), put(err))
    return np.asarray(r["sums"]), np.asarray(e["sums"])


# ---------------------------------------------------------------------------
# The cost model (one process)
# ---------------------------------------------------------------------------


def _shape_trees(kind):
    import jax
    import jax.numpy as jnp

    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.models import streaming as jst

    k, d = 16, 8
    if kind == "kmeans":
        return tst._lloyd_shapes(k, d), jst._lloyd_example(k, d)
    if kind == "fuzzy":
        return tst._fuzzy_shapes(k, d), jst._fuzzy_example(k, d)
    port = tgmm._gmm_shapes(k, d, kind)
    want = jgmm._gmm_example(k, d, kind)
    assert tuple(port) == tuple(
        jax.ShapeDtypeStruct(s.shape, jnp.float32).shape for s in want)
    return port, want


@pytest.mark.parametrize("quantize", [None, "bf16", "int8"])
@pytest.mark.parametrize("axes", [("data",), ("dcn", "ici")])
@pytest.mark.parametrize("kind", ["kmeans", "fuzzy", "diag", "spherical",
                                  "tied", "full"])
def test_tree_reduce_cost_against_jax(kind, axes, quantize):
    from tdc_tpu.parallel import reduce as jred

    port, want = _shape_trees(kind)
    cost = tred.tree_reduce_cost(port, axes, quantize)
    assert cost == jred.tree_reduce_cost(want, axes, quantize)
    if quantize is not None:
        # At K=16, d=8 the encoding pays for its scales.
        assert cost[1] < tred.tree_reduce_cost(port, axes)[1]


# ---------------------------------------------------------------------------
# The hierarchical mesh
# ---------------------------------------------------------------------------


def test_hierarchical_mesh_layout(ranks):
    for r, out in enumerate(ranks):
        shape, coords, index, axes, hier, flat = out["hier"]
        assert shape == (2, 2)
        assert coords == (r // 2, r % 2)
        # The rank's block of rows: JAX's P(("dcn", "ici")) order.
        assert index == (r, 4)
        assert axes == ("dcn", "ici")
        assert hier and not flat
        assert out["two_nodes"] == ((2, 2), (r // 2, r % 2))
        assert out["own_nodes"] == ((4, 1), (r, 0))


def test_hierarchical_mesh_refusals_in_the_jax_words(ranks):
    for out in ranks:
        assert "hierarchical mesh row 0 spans hosts [0, 1]; the ici " \
               "axis must be intra-host" in out["spans"]
        assert out["indivisible"] == \
            "4 devices not divisible into 3 host groups"
        assert "launch exactly 2" in out["short"]


# ---------------------------------------------------------------------------
# Quantized reduces against the JAX package
# ---------------------------------------------------------------------------


def test_deferred_int8_against_jax_with_error_feedback(ranks):
    from tdc_tpu.parallel import mesh as jmesh

    sums = _ef_sums()
    r1, r2 = same_on_every_rank(ranks, ("flat", "int8"))
    want_r, want_e = _jax_deferred(jmesh.make_mesh(WORLD), "int8", sums,
                                   np.zeros_like(sums))
    np.testing.assert_array_max_ulp(r1, want_r, maxulp=1)
    for r, out in enumerate(ranks):
        np.testing.assert_array_max_ulp(out["flat_err", "int8"], want_e[r],
                                        maxulp=1)
    # Error feedback: the error is deferred into the next reduce, not
    # lost (tests/test_reduce.py:331-360).
    truth = sums.sum(axis=0)
    single = np.abs(r1 - truth).max()
    assert single > 0  # int8 quantizes this data for real
    assert np.abs((r1 + r2) / 2 - truth).max() < 0.6 * single
    # The residual is what the encoding lost on this rank.
    total = r1 + sum(out["flat_err", "int8"] for out in ranks)
    np.testing.assert_allclose(total, truth, rtol=1e-5, atol=1e-3)


def test_deferred_bf16_against_jax(ranks):
    from tdc_tpu.parallel import mesh as jmesh

    sums = _ef_sums()
    r1 = same_on_every_rank(ranks, ("flat", "bf16"))[0]
    want_r, want_e = _jax_deferred(jmesh.make_mesh(WORLD), "bf16", sums,
                                   np.zeros_like(sums))
    assert r1.dtype == np.float32
    q = torch.from_numpy(sums).to(torch.bfloat16).float().numpy()
    bound = (WORLD - 1) * BF16_ROUNDOFF * np.abs(q).sum(0)
    assert np.all(np.abs(r1 - q.sum(0)) <= bound)
    assert np.all(np.abs(r1 - want_r) <= 2 * bound)
    for r, out in enumerate(ranks):
        np.testing.assert_array_max_ulp(out["flat_err", "bf16"], want_e[r],
                                        maxulp=1)


@pytest.mark.parametrize("quantize", ["int8", "bf16"])
def test_hierarchical_quantized_is_replicated_and_keeps_the_books(
        ranks, quantize):
    """tests/test_reduce.py:384-408 on a (2, 2) mesh: the dcn-stage
    encoder sees the same value at every ici position, so every rank's
    output holds the same bits, and out + Σ new_err = Σ acc + Σ err."""
    from tdc_tpu.parallel import mesh as jmesh

    acc, err = _hier_acc_err()
    out = same_on_every_rank(ranks, ("hier", quantize))
    new_err = np.stack([r["hier_err", quantize] for r in ranks])
    total = acc.sum(0) + err.sum(0)
    if quantize == "int8":
        np.testing.assert_allclose(out + new_err.sum(0), total, rtol=1e-5,
                                   atol=1e-4)
    else:
        # The residuals hold what each host's encoding lost; the one bf16
        # addition of the dcn stage rounds too (2^-8 of its addends'
        # magnitude), and that no residual holds.
        y = acc + err
        hosts = np.stack([y[0] + y[1], y[2] + y[3]])
        q = torch.from_numpy(hosts).to(torch.bfloat16).float().numpy()
        bound = BF16_ROUNDOFF * np.abs(q).sum(0) + 1e-4
        assert np.all(np.abs(out + new_err.sum(0) - total) <= bound)
    # Against JAX's make_hierarchical_mesh(2, n_devices=4): the same
    # residuals (identical within an ici group, stored / group size).
    want_r, want_e = _jax_deferred(
        jmesh.make_hierarchical_mesh(2, n_devices=WORLD), quantize, acc,
        err)
    if quantize == "int8":
        np.testing.assert_array_max_ulp(out, want_r, maxulp=1)
        np.testing.assert_array_max_ulp(new_err, want_e, maxulp=1)
    else:
        # Two bf16 addends on the dcn stage: one rounding, as JAX's.
        np.testing.assert_array_equal(out, want_r)
        np.testing.assert_array_max_ulp(new_err, want_e, maxulp=1)
    np.testing.assert_array_equal(new_err[0], new_err[1])
    np.testing.assert_array_equal(new_err[2], new_err[3])


@pytest.mark.parametrize("mesh_name", ["flat", "hier"])
@pytest.mark.parametrize("quantize", [None, "int8", "bf16"])
def test_tree_psum_fields_and_extra(ranks, mesh_name, quantize):
    """Counts, the scalar cost and the pad counts stay f32; only the
    (K, d) sums are encoded, within the encoding's step of the sum."""
    sums, counts, sse = _lloyd_tree()
    red, extra = same_on_every_rank(ranks, ("tree", mesh_name, quantize))
    np.testing.assert_allclose(red[1], counts.sum(0), rtol=0)
    np.testing.assert_allclose(red[2], sse.sum(0), rtol=1e-6)
    np.testing.assert_array_equal(extra, [counts[:, 0].sum(), 4.0, 0.0])
    if quantize is None:
        assert all(r["tree_err", mesh_name, None] is None for r in ranks)
        np.testing.assert_allclose(red[0], sums.sum(0), rtol=1e-6,
                                   atol=1e-4)
        return
    # bf16: each rank's rounding plus the additions' (2^-8 each);
    # int8: half a code step from each of the 4 ranks.
    step = (WORLD * 2 * BF16_ROUNDOFF * np.abs(sums).sum(0)
            if quantize == "bf16"
            else 2 * np.abs(sums).max(axis=(0, 2))[:, None] / 127.0)
    assert np.all(np.abs(red[0] - sums.sum(0)) <= step)
    # Nothing but the sums carries a residual.
    for r in ranks:
        errs = r["tree_err", mesh_name, quantize]
        assert not np.any(errs[1]) and not np.any(errs[2])


def test_quantized_reduce_needs_a_mesh_of_several_ranks():
    x = np.zeros((64, 2), np.float32)
    from tdc_tpu_torch.data.loader import NpzStream

    for fit in (tst.streamed_kmeans_fit, tst.streamed_fuzzy_fit,
                tgmm.streamed_gmm_fit):
        with pytest.raises(ValueError, match="requires a multi-device "
                                             "mesh"):
            fit(NpzStream(x, 32), 2, 2, init=x[:2], max_iters=1,
                reduce="per_pass:int8", device="cpu")
    with pytest.raises(ValueError, match="requires a multi-device mesh"):
        tst.streamed_kmeans_fit(NpzStream(x, 32), 2, 2, init=x[:2],
                                max_iters=1, reduce="per_pass:bf16",
                                mesh=tmesh.make_mesh(1), device="cpu")
    # With ckpt_dir too (checkpoints are ported): the JAX package's
    # _reduce_plan refuses the single rank first, before ckpt_dir.
    with pytest.raises(ValueError, match="requires a multi-device mesh"):
        tst.streamed_kmeans_fit(NpzStream(x, 32), 2, 2, init=x[:2],
                                reduce="per_pass:int8", ckpt_dir="ck",
                                device="cpu")
