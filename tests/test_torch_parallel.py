"""The port's multi-rank fits against the JAX package, on the CPU.

Groups of 2 and 4 ranks run on gloo, each rank a process started with
torch.multiprocessing ("spawn") that joins through a `file://` store under
the test's tmp directory (no ports, so parallel test workers never
clash). Each group runs every check of its world size in one go and
returns numpy results; the JAX side runs here on the conftest's 8 virtual
CPU devices with the same seeded inputs and the same explicit inits
(JAX's draws and torch's never agree), with its Pallas kernels in
interpret mode.

Tolerances (float32, another reduction order across ranks than across
devices): data-parallel stats as PERF.md §6 (sums rtol 1e-5 / atol 1e-4,
counts equal, SSE rtol 1e-5; Σμx within 1e-5 of Σμ|x|, Σμ and J_m rtol
1e-5); fits equal in n_iter and converged, centroids within 1e-5, cost
rtol 1e-5 (on the kernel routes, whose costs come from the expanded d²
that cancels ‖x‖², also atol 1e-5·Σ‖x‖²), the history's costs as the
cost and its shifts rtol 1e-5 / atol 2·√d times the centroid bound (a
shift compares two centroid sets, each within that bound). Across world
sizes the stats agree within the same f32 bound, not bitwise; at one
world size two runs are bitwise equal. The K-sharded K-Means tower
(`kmeans_fit_sharded`, N=300, K=8, grids (1, 2), (2, 1) and (2, 2), also
spherical) is held to the same fit bounds, its SSE with atol 1e-5·Σ‖x‖²
on both kernels (both packages add Σ‖x‖² to the shifted minima); its
stats with the true minima (`make_sharded_stats`, rows in blocks on
'xla') as the data-parallel stats; `sharded_assign` labels are equal,
shifted and clamped, a centroid copied into the other model shard losing
every row to the lower index; its refusals are the JAX package's words,
and assign/gather modes that are not ported name their ROADMAP item.

Gaussian Mixture EM on a mesh (`gmm_fit(mesh=)`, all four covariance
types, explicit init means on tests/test_gmm.py's aniso_blobs) against
JAX's `gmm_fit(mesh=make_mesh(w))`: n_iter and converged equal, the mean
log-likelihood rtol 1e-5, means atol 1e-4, covariances rtol 1e-4 / atol
1e-5, weights atol 1e-5 (EM carries the f32 reduction-order differences
forward). init="kmeans" draws on rank 0: the fit equals one process's
with rank 0's generator within the same bounds; `GaussianMixture(mesh=)`
is the function, bitwise. Empty-cluster relocation on a mesh
(tests/test_kmeans.py:140's doomed seed) against JAX's
`kmeans_fit(mesh=, empty_policy="relocate")` on both kernels: n_iter
equal, centroids within 1e-5; on integer points with two rows of equal
cost on different ranks, the lower global index wins, exactly.
"""

import multiprocessing as mp
import queue as queue_lib
import time
import traceback

import numpy as np
import pytest
import torch

from tdc_tpu_torch import convert
from tdc_tpu_torch.models import estimators as test
from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.parallel import collectives as tcol
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh
from tdc_tpu_torch.parallel import sharded_k as tsk

RTOL = 1e-5
N, K, D = 300, 6, 5  # the data-parallel case: N divisible by 2 and 4
SN, SK = 301, 8  # the K-sharded case: N ragged, K divisible by 2
GRIDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
KERNELS = ("xla", "pallas")


def _blobs(seed, n, k, d):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    init = x[rng.choice(n, k, replace=False)].copy()
    return x, init


def _fit_out(res):
    return {"centroids": res.centroids.numpy(), "n_iter": int(res.n_iter),
            "converged": bool(res.converged),
            "cost": float(res.sse if hasattr(res, "sse") else res.objective),
            "history": None if res.history is None else
            np.asarray(res.history)}


def _sharded(x, init, grid, kernel, dtype=None):
    return tsk.fuzzy_fit_sharded(
        x, SK, tsk.make_mesh_2d(*grid), init=init, max_iters=10, tol=1e-4,
        kernel=kernel, dtype=dtype, device="cpu")


def _job(world):
    """Every check of one group, on this rank: returns a dict of numpy
    results and refusal messages."""
    out = {}
    x, init = _blobs(0, N, K, D)
    mesh = tmesh.make_mesh(world)
    xl = tmesh.shard_points(torch.from_numpy(x), mesh)
    c = torch.from_numpy(init)
    for kern in KERNELS:
        out["lloyd", kern] = tuple(t.numpy() for t in
                                   tcol.distributed_lloyd_stats(
                                       xl, c, mesh, kernel=kern))
        out["fuzzy", kern] = tuple(t.numpy() for t in
                                   tcol.distributed_fuzzy_stats(
                                       xl, c, mesh, m=1.7, kernel=kern))
        kw = dict(init=init, mesh=mesh, kernel=kern, max_iters=12,
                  tol=1e-4, history=True, device="cpu")
        out["kmeans", kern] = _fit_out(tkm.kmeans_fit(x, K, **kw))
        out["cmeans", kern] = _fit_out(tfz.fuzzy_cmeans_fit(x, K, **kw))
    w = np.random.default_rng(1).uniform(0.5, 2.0, N).astype(np.float32)
    out["kmeans_weighted"] = _fit_out(tkm.kmeans_fit(
        x, K, init=init, mesh=mesh, sample_weight=w, max_iters=12,
        device="cpu"))
    # A named init: rank 0 draws (each rank's generator differs) and
    # broadcasts; max_iters=0 returns the init.
    gen = torch.Generator().manual_seed(5 + tmh.process_index())
    out["kmeanspp"] = tkm.kmeans_fit(
        x, K, init="kmeans++", generator=gen, mesh=mesh, max_iters=0,
        device="cpu").centroids.numpy()
    a = tkm.kmeans_fit(x, K, init=init, mesh=mesh, kernel="pallas",
                       max_iters=12, device="cpu")
    b = tkm.kmeans_fit(x, K, init=init, mesh=mesh, kernel="pallas",
                       max_iters=12, device="cpu")
    out["repeat_kmeans"] = (torch.equal(a.centroids, b.centroids)
                            and torch.equal(a.sse, b.sse))
    # Refusals, raised alike on every rank.
    for name, call in (
            ("kmeans_ragged", lambda: tkm.kmeans_fit(
                x[:N + 1 - world], K, init=init, mesh=mesh, device="cpu")),
            ("cmeans_ragged", lambda: tfz.fuzzy_cmeans_fit(
                x[:N + 1 - world], K, init=init, mesh=mesh, device="cpu")),
            ("differ", lambda: tkm.kmeans_fit(
                x + tmh.process_index(), K, init=init, mesh=mesh,
                device="cpu"))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    # The K-sharded tower on this world's grids: f32 on a ragged N for
    # both kernels, and bf16 rows on the largest grid.
    xs, init_s = _blobs(2, SN, SK, D)
    try:
        tsk.fuzzy_fit_sharded(xs, SK - 1, tsk.make_mesh_2d(1, world),
                              init="first_k", device="cpu")
        out["k_ragged"] = None
    except ValueError as e:
        out["k_ragged"] = str(e)
    for grid in GRIDS[world]:
        for kern in KERNELS:
            out["sharded", grid, kern, "f32"] = _fit_out(
                _sharded(xs, init_s, grid, kern))
    if world == 4:
        xb = torch.from_numpy(xs).to(torch.bfloat16)
        for kern in KERNELS:
            out["sharded", (2, 2), kern, "bf16"] = _fit_out(
                _sharded(xb, init_s, (2, 2), kern))
        r1 = _sharded(xs, init_s, (2, 2), "pallas")
        r2 = _sharded(xs, init_s, (2, 2), "pallas")
        out["repeat_sharded"] = (torch.equal(r1.centroids, r2.centroids)
                                 and torch.equal(r1.objective, r2.objective))
    _kmeans_sharded_job(world, out)
    _gmm_relocate_job(world, out)
    return out


COV_TYPES = ("diag", "spherical", "tied", "full")


def _aniso_blobs():
    """tests/test_gmm.py's aniso_blobs: per-dimension scales, unequal
    sizes (N = 1000, so 2 and 4 ranks split it evenly)."""
    rng = np.random.default_rng(0)
    a = rng.normal([0, 0], [0.5, 2.0], size=(600, 2))
    b = rng.normal([10, 0], [2.0, 0.5], size=(300, 2))
    c = rng.normal([0, 12], [1.0, 1.0], size=(100, 2))
    x = np.concatenate([a, b, c]).astype(np.float32)
    x = x[rng.permutation(len(x))]
    means0 = np.array([[0.5, 0.3], [9.0, 0.5], [0.4, 11.0]], np.float32)
    return x, means0


def _doomed_seed():
    """tests/test_kmeans.py:140: two tight blobs and an init centroid
    parked far away, which captures nothing on the first step."""
    rng = np.random.default_rng(3)
    a = rng.normal([0, 0], 0.2, (500, 2)).astype(np.float32)
    b = rng.normal([8, 0], 0.2, (500, 2)).astype(np.float32)
    init = np.array([[0.1, 0.0], [7.9, 0.0], [500.0, 500.0]], np.float32)
    return np.concatenate([a, b]), init


def _tied_costs():
    """400 integer points whose cluster means are exact: (0, ±1), (±1, 0)
    around (0, 0) and around (8, 0) (with (8, ±2)), plus (0, -30) at row
    1 and (0, 30) at row 398. After one step the means are (0, 0) and
    (8, 0) exactly, the two far rows cost 900 each, and they sit on the
    first and the last rank: the empty cluster must take row 1's
    (0, -30)."""
    ring = np.array([[0, 1], [0, -1], [1, 0], [-1, 0]], np.float32)
    x = np.concatenate([np.tile(ring, (50, 1)),
                        np.tile(ring + [8, 0], (49, 1)),
                        [[8, 2], [8, -2]]])
    x = x[np.random.default_rng(4).permutation(len(x))]
    x = np.insert(x, 1, [0, -30], axis=0)
    x = np.insert(x, len(x) - 1, [0, 30], axis=0)
    init = np.array([[0.1, 0.0], [7.9, 0.0], [500.0, 500.0]], np.float32)
    return x.astype(np.float32), init


def _gmm_out(res):
    return {"means": res.means.numpy(), "variances": res.variances.numpy(),
            "weights": res.weights.numpy(), "n_iter": int(res.n_iter),
            "converged": bool(res.converged),
            "ll": float(res.log_likelihood)}


def _gmm_relocate_job(world, out):
    """gmm_fit(mesh=) and relocation with a mesh on this world."""
    mesh = tmesh.make_mesh(world)
    x, means0 = _aniso_blobs()
    for cov in COV_TYPES:
        out["gmm", cov] = _gmm_out(tgmm.gmm_fit(
            x, 3, init=means0, mesh=mesh, covariance_type=cov,
            max_iters=50, tol=1e-4, device="cpu"))
    gen = torch.Generator().manual_seed(5 + tmh.process_index())
    out["gmm_kmeans_init"] = _gmm_out(tgmm.gmm_fit(
        x, 3, init="kmeans", generator=gen, mesh=mesh, max_iters=50,
        device="cpu"))
    est = test.GaussianMixture(3, covariance_type="full", init=means0,
                               max_iter=50, mesh=mesh, device="cpu").fit(x)
    out["gmm_estimator"] = (est.means_, est.covariances_, est.weights_,
                            est.n_iter_, est.lower_bound_)
    xd, init = _doomed_seed()
    for kern in KERNELS:
        out["relocate", kern] = _fit_out(tkm.kmeans_fit(
            xd, 3, init=init, mesh=mesh, kernel=kern, max_iters=50,
            tol=0.0, empty_policy="relocate", device="cpu"))
    xt, init = _tied_costs()
    out["relocate_tie"] = _fit_out(tkm.kmeans_fit(
        xt, 3, init=init, mesh=mesh, max_iters=1, tol=-1.0,
        empty_policy="relocate", device="cpu"))
    for name, call in (
            ("gmm_ragged", lambda: tgmm.gmm_fit(
                x[:1001 - world], 3, init=means0, mesh=mesh, device="cpu")),
            ("gmm_pallas", lambda: tgmm.gmm_fit(
                x, 3, init=means0, mesh=mesh, kernel="pallas",
                device="cpu"))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)


def _tied(init):
    """The init with centroid 1 copied into the first centroid of the
    upper half of K: on a grid with two model shards, one copy in each."""
    c = init.copy()
    c[SK // 2 + 1] = c[1]
    return c


def _kmeans_sharded_job(world, out):
    """The K-sharded K-Means tower on this world's grids: fits and labels
    for both kernels, a tie across model shards, repeats and refusals."""
    x, init = _blobs(3, N, SK, D)
    xt = torch.from_numpy(x)
    for grid in GRIDS[world]:
        mesh = tsk.make_mesh_2d(*grid)
        x_loc = tmesh.shard_points(xt, mesh)
        j, k_per = mesh.axis_index("model"), SK // grid[1]
        c_loc = torch.from_numpy(init[j * k_per:(j + 1) * k_per])
        for kern in KERNELS:
            for spherical in (False, True):
                res = tsk.kmeans_fit_sharded(
                    x, SK, mesh, init=init, max_iters=10, tol=1e-4,
                    kernel=kern, spherical=spherical, device="cpu")
                out["kmeans_sharded", grid, kern, spherical] = _fit_out(res)
            # The stats with the true minima, rows in blocks on 'xla'.
            out["kmeans_sharded_stats", grid, kern] = (j, tuple(
                t.numpy() for t in tsk.make_sharded_stats(
                    mesh, kern, block_rows=N // grid[0] // 3)(x_loc, c_loc)))
            for name, c, shifted in (("init", init, True),
                                     ("tie", _tied(init), True),
                                     ("clamped", init, False)):
                cl = torch.from_numpy(c[j * k_per:(j + 1) * k_per])
                out["kmeans_assign", grid, kern, name] = (
                    mesh.axis_index("data"),
                    tsk.sharded_assign(mesh, kern, shifted=shifted)(
                        x_loc, cl).numpy())
    grid = GRIDS[world][0]
    mesh = tsk.make_mesh_2d(*grid)
    runs = [tsk.kmeans_fit_sharded(x, SK, mesh, init=init, max_iters=10,
                                   tol=1e-4, kernel="pallas", device="cpu")
            for _ in range(2)]
    out["repeat_kmeans_sharded"] = all(
        torch.equal(getattr(runs[0], f), getattr(runs[1], f))
        for f in ("centroids", "sse", "shift"))
    for name, call, err in (
            ("ks_ragged_n", lambda: tsk.kmeans_fit_sharded(
                x[:N - 1], SK, tsk.make_mesh_2d(world, 1), init="first_k",
                device="cpu"), ValueError),
            ("ks_ragged_k", lambda: tsk.kmeans_fit_sharded(
                x, SK - 1, tsk.make_mesh_2d(1, world), init="first_k",
                device="cpu"), ValueError),
            ("ks_assign", lambda: tsk.kmeans_fit_sharded(
                x, SK, mesh, init=init, assign="coarse", device="cpu"),
             NotImplementedError),
            ("ks_gather", lambda: tsk.kmeans_fit_sharded(
                x, SK, mesh, init=init, gather="int8", device="cpu"),
             NotImplementedError)):
        try:
            call()
            out[name] = None
        except err as e:
            out[name] = str(e)


def _rank_main(rank, world, init_method, queue):
    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        queue.put((rank, _job(world)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        tmh.shutdown()


def _spawn(tmp_path, world, timeout=240):
    """Start `world` ranks, return their results in rank order."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_path / f'store{world}'}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, queue))
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


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {w: _spawn(tmp_path_factory.mktemp(f"ranks{w}"), w)
            for w in (2, 4)}


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        if isinstance(first, dict):
            for f in first:
                np.testing.assert_array_equal(r[key][f], first[f])
        elif isinstance(first, tuple):
            for u, v in zip(r[key], first):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(r[key], first)
    return first


def _assert_fit(got, want_c, want_n, want_conv, want_cost, want_hist=None,
                cost_atol=0.0):
    assert got["n_iter"] == int(want_n)
    assert got["converged"] == bool(want_conv)
    np.testing.assert_allclose(got["centroids"], np.asarray(want_c),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got["cost"], float(want_cost), rtol=RTOL,
                               atol=cost_atol)
    if want_hist is not None:
        np.testing.assert_allclose(got["history"][:, 0],
                                   np.asarray(want_hist)[:, 0], rtol=RTOL,
                                   atol=max(cost_atol, 1e-5))
        # The shift compares two centroid sets, each within the centroid
        # tolerance: it inherits 2·√d times that bound.
        c_tol = RTOL * float(np.abs(np.asarray(want_c)).max()) + 1e-5
        np.testing.assert_allclose(got["history"][:, 1],
                                   np.asarray(want_hist)[:, 1], rtol=RTOL,
                                   atol=2 * np.sqrt(D) * c_tol)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_stats_against_the_jax_mesh(groups, world):
    from tdc_tpu.ops import assign as jassign
    from tdc_tpu.parallel import collectives as jcol
    from tdc_tpu.parallel import mesh as jmesh

    x, init = _blobs(0, N, K, D)
    jm = jmesh.make_mesh(world)
    xs = jmesh.shard_points(x, jm)
    mu = np.asarray(jassign.fuzzy_memberships(x, init, m=1.7)) ** 1.7
    fuzzy_scale = float((mu.T @ np.abs(x)).max())
    for kern in KERNELS:
        got = _same_on_every_rank(groups[world], ("lloyd", kern))
        want = jcol.distributed_lloyd_stats(xs, init, jm, kernel=kern)
        np.testing.assert_allclose(got[0], np.asarray(want.sums), rtol=RTOL,
                                   atol=1e-4)
        np.testing.assert_array_equal(got[1], np.asarray(want.counts))
        np.testing.assert_allclose(got[2], np.asarray(want.sse), rtol=RTOL)
        got = _same_on_every_rank(groups[world], ("fuzzy", kern))
        want = jcol.distributed_fuzzy_stats(xs, init, jm, m=1.7,
                                            kernel=kern)
        np.testing.assert_allclose(got[0], np.asarray(want.weighted_sums),
                                   rtol=0, atol=1e-5 * fuzzy_scale)
        np.testing.assert_allclose(got[1], np.asarray(want.weights),
                                   rtol=RTOL)
        np.testing.assert_allclose(got[2], np.asarray(want.objective),
                                   rtol=RTOL)
        # Across world sizes: the same stats within the f32 bound, not
        # bitwise.
        other = groups[6 - world][0]["fuzzy", kern]
        np.testing.assert_allclose(other[0], got[0], rtol=0,
                                   atol=1e-5 * fuzzy_scale)
        for u, v in zip(other[1:], got[1:]):
            np.testing.assert_allclose(u, v, rtol=RTOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kern", KERNELS)
def test_data_parallel_fits_against_the_jax_mesh(groups, world, kern):
    from tdc_tpu.models import fuzzy as jfz
    from tdc_tpu.models import kmeans as jkm
    from tdc_tpu.parallel import mesh as jmesh

    x, init = _blobs(0, N, K, D)
    kw = dict(init=init, mesh=jmesh.make_mesh(world), kernel=kern,
              max_iters=12, tol=1e-4, history=True)
    j = jkm.kmeans_fit(x, K, **kw)
    # The kernel routes' costs come from the expanded d² = ‖x‖² + ‖c‖² −
    # 2x·c in both packages (the SSE as Σ min(‖c‖² − 2x·c) + Σ‖x‖²): their
    # f32 rounding scales with Σ‖x‖², here ~5.5x the SSE and ~13x J_m,
    # and each rank or device sums its own part, so the bound is 1e-5 of
    # Σ‖x‖². The JAX package's own J_m on 2 and on 4 devices differ by
    # 4e-5 relative.
    cost_atol = (1e-5 * float((x.astype(np.float64) ** 2).sum())
                 if kern == "pallas" else 0.0)
    _assert_fit(_same_on_every_rank(groups[world], ("kmeans", kern)),
                j.centroids, j.n_iter, j.converged, j.sse, j.history,
                cost_atol)
    j = jfz.fuzzy_cmeans_fit(x, K, **kw)
    _assert_fit(_same_on_every_rank(groups[world], ("cmeans", kern)),
                j.centroids, j.n_iter, j.converged, j.objective, j.history,
                cost_atol)
    if kern == "xla":
        w = np.random.default_rng(1).uniform(0.5, 2.0, N).astype(np.float32)
        j = jkm.kmeans_fit(x, K, init=init, mesh=jmesh.make_mesh(world),
                           sample_weight=w, max_iters=12)
        _assert_fit(_same_on_every_rank(groups[world], "kmeans_weighted"),
                    j.centroids, j.n_iter, j.converged, j.sse)


@pytest.mark.parametrize("world", [2, 4])
def test_rank0_draws_the_init_and_runs_repeat_bitwise(groups, world):
    x, _ = _blobs(0, N, K, D)
    want = tkm.resolve_init(torch.from_numpy(x), K, "kmeans++",
                            torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(
        _same_on_every_rank(groups[world], "kmeanspp"), want.numpy())
    assert all(r["repeat_kmeans"] for r in groups[world])
    if world == 4:
        assert all(r["repeat_sharded"] for r in groups[world])


@pytest.mark.parametrize("world", [2, 4])
def test_refusals_in_the_jax_words(groups, world):
    from tdc_tpu.models import fuzzy as jfz
    from tdc_tpu.models import kmeans as jkm
    from tdc_tpu.parallel import mesh as jmesh

    x, init = _blobs(0, N, K, D)
    ragged = x[:N + 1 - world]
    for key, fit in (("kmeans_ragged", jkm.kmeans_fit),
                     ("cmeans_ragged", jfz.fuzzy_cmeans_fit)):
        with pytest.raises(ValueError) as exc:
            fit(ragged, K, init=init, mesh=jmesh.make_mesh(world))
        assert _same_on_every_rank(groups[world], key) == str(exc.value)
    # Points that differ between ranks: every rank raises.
    for r in groups[world]:
        assert "differ between ranks" in r["differ"]
    from tdc_tpu.parallel import sharded_k as jsk

    xs, _ = _blobs(2, SN, SK, D)
    with pytest.raises(ValueError) as exc:
        jsk.fuzzy_fit_sharded(xs, SK - 1, jsk.make_mesh_2d(1, world),
                              init="first_k")
    assert _same_on_every_rank(groups[world], "k_ragged") == str(exc.value)


def _assert_gmm(got, want, ll_rtol=RTOL):
    assert got["n_iter"] == int(want.n_iter)
    assert got["converged"] == bool(want.converged)
    np.testing.assert_allclose(got["ll"], float(want.log_likelihood),
                               rtol=ll_rtol)
    np.testing.assert_allclose(got["means"], np.asarray(want.means), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["variances"], np.asarray(want.variances),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["weights"], np.asarray(want.weights),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cov", COV_TYPES)
def test_gmm_fit_on_a_mesh_against_jax(groups, world, cov):
    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.parallel import mesh as jmesh

    x, means0 = _aniso_blobs()
    got = _same_on_every_rank(groups[world], ("gmm", cov))
    want = jgmm.gmm_fit(x, 3, init=means0, mesh=jmesh.make_mesh(world),
                        covariance_type=cov, max_iters=50, tol=1e-4)
    _assert_gmm(got, want)
    assert got["converged"] and got["n_iter"] > 2


@pytest.mark.parametrize("world", [2, 4])
def test_gmm_kmeans_init_and_estimator_on_a_mesh(groups, world):
    x, means0 = _aniso_blobs()
    # Rank 0's draws seed the best-of-3 K-Means: one process with rank
    # 0's generator gives the same fit.
    one = tgmm.gmm_fit(x, 3, init="kmeans",
                       generator=torch.Generator().manual_seed(5),
                       max_iters=50, device="cpu")
    got = dict(_same_on_every_rank(groups[world], "gmm_kmeans_init"))
    # Restarts that reach the same clustering in another component order
    # have SSEs equal but for the f32 reduction order, so the mesh and
    # one process may keep different ones: the same mixture, its
    # components permuted. Match them by their means first.
    perm = [int(np.argmin(np.linalg.norm(one.means.numpy() - m, axis=1)))
            for m in got["means"]]
    assert sorted(perm) == [0, 1, 2]
    inv = np.argsort(perm)
    for f in ("means", "variances", "weights"):
        got[f] = got[f][inv]
    _assert_gmm(got, one)
    est = _same_on_every_rank(groups[world], "gmm_estimator")
    fit = groups[world][0]["gmm", "full"]
    for u, v in zip(est[:3], ("means", "variances", "weights")):
        np.testing.assert_array_equal(u, fit[v])
    assert (est[3], est[4]) == (fit["n_iter"], fit["ll"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kern", KERNELS)
def test_relocate_on_a_mesh_against_jax(groups, world, kern):
    from tdc_tpu.models import kmeans as jkm
    from tdc_tpu.parallel import mesh as jmesh

    x, init = _doomed_seed()
    got = _same_on_every_rank(groups[world], ("relocate", kern))
    want = jkm.kmeans_fit(x, 3, init=init, mesh=jmesh.make_mesh(world),
                          kernel=kern, max_iters=50, tol=0.0,
                          empty_policy="relocate")
    assert got["n_iter"] == int(want.n_iter)
    np.testing.assert_allclose(got["centroids"], np.asarray(want.centroids),
                               rtol=0, atol=1e-5)
    # The doomed centroid was revived: no cluster ends empty.
    labels = tkm.kmeans_predict(x, got["centroids"], kernel="xla",
                                device="cpu").numpy()
    assert (np.bincount(labels, minlength=3) > 0).all()


@pytest.mark.parametrize("world", [2, 4])
def test_relocate_tie_takes_the_lower_global_index(groups, world):
    from tdc_tpu.models import kmeans as jkm

    x, init = _tied_costs()
    got = _same_on_every_rank(groups[world], "relocate_tie")["centroids"]
    np.testing.assert_array_equal(got[:2], [[0, 0], [8, 0]])
    np.testing.assert_array_equal(got[2], [0, -30])
    # The JAX package's top_k on one device takes the same row.
    want = jkm.kmeans_fit(x, 3, init=init, max_iters=1, tol=-1.0,
                          empty_policy="relocate").centroids
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("world", [2, 4])
def test_gmm_mesh_refusals_in_the_jax_words(groups, world):
    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.parallel import mesh as jmesh

    x, means0 = _aniso_blobs()
    for key, kw, xx in (("gmm_ragged", {}, x[:1001 - world]),
                        ("gmm_pallas", {"kernel": "pallas"}, x)):
        with pytest.raises(ValueError) as exc:
            jgmm.gmm_fit(xx, 3, init=means0, mesh=jmesh.make_mesh(world),
                         **kw)
        assert _same_on_every_rank(groups[world], key) == str(exc.value)


def test_refusals_of_kernels_on_a_mesh_in_the_jax_words():
    from tdc_tpu.models import kmeans as jkm
    from tdc_tpu.parallel import mesh as jmesh

    x, init = _blobs(0, N, K, D)
    w = np.ones(N, np.float32)
    for kw in ({"kernel": "pallas", "sample_weight": w},
               {"kernel": "pallas_bf16"}):
        msgs = []
        for fit, mesh, extra in ((jkm.kmeans_fit, jmesh.make_mesh(2), {}),
                                 (tkm.kmeans_fit, tmesh.make_mesh(1),
                                  {"device": "cpu"})):
            with pytest.raises(ValueError) as exc:
                fit(x, K, init=init, mesh=mesh, **kw, **extra)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tmesh.make_mesh(2)


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("case", ["1x2", "2x1", "2x2", "2x2_bf16"])
def test_fuzzy_fit_sharded_against_the_jax_tower(groups, case, kern):
    import jax.numpy as jnp

    from tdc_tpu.parallel import sharded_k as jsk

    grid = tuple(int(v) for v in case[:3].split("x"))
    bf16 = case.endswith("bf16")
    xs, init = _blobs(2, SN, SK, D)
    j = jsk.fuzzy_fit_sharded(xs, SK, jsk.make_mesh_2d(*grid), init=init,
                              max_iters=10, tol=1e-4, kernel=kern,
                              dtype=jnp.bfloat16 if bf16 else None)
    got = _same_on_every_rank(
        groups[grid[0] * grid[1]],
        ("sharded", grid, kern, "bf16" if bf16 else "f32"))
    _assert_fit(got, j.centroids, j.n_iter, j.converged, j.objective,
                j.history)
    if case == "1x2" and kern == "xla":
        # The JAX tower's result carries over whole, history included, and
        # labels points in the port as it does in the JAX package.
        from tdc_tpu.models import fuzzy as jfz

        state = convert.fuzzy_state_from_numpy(
            np.asarray(j.centroids), n_iter=int(j.n_iter),
            objective=float(j.objective), shift=float(j.shift),
            converged=bool(j.converged), history=j.history, device="cpu")
        back = convert.to_numpy(state)
        np.testing.assert_array_equal(back["history"], np.asarray(j.history))
        np.testing.assert_array_equal(back["centroids"],
                                      np.asarray(j.centroids))
        assert (back["n_iter"], back["converged"]) == (int(j.n_iter),
                                                       bool(j.converged))
        np.testing.assert_array_equal(
            tfz.fuzzy_predict(xs, state.centroids, device="cpu").numpy(),
            np.asarray(jfz.fuzzy_predict(xs, j.centroids)))
    # One process, a 1x1 grid, the same init: the same fit within the f32
    # bound (no collective at all there).
    one = _fit_out(tsk.fuzzy_fit_sharded(
        torch.from_numpy(xs).to(torch.bfloat16) if bf16 else xs, SK,
        tsk.make_mesh_2d(1, 1), init=init, max_iters=10, tol=1e-4,
        kernel=kern, device="cpu"))
    _assert_fit(got, one["centroids"], one["n_iter"], one["converged"],
                one["cost"], one["history"])


def _labels_by_data_shard(ranks, key, n_data):
    """The whole (N,) labels from each rank's rows: the ranks of one data
    coordinate agree, and the data coordinates concatenate in order."""
    parts = {}
    for r in ranks:
        i, lab = r[key]
        if i in parts:
            np.testing.assert_array_equal(lab, parts[i])
        parts[i] = lab
    return np.concatenate([parts[i] for i in range(n_data)])


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("case", ["1x2", "2x1", "2x2", "1x2_spherical",
                                  "2x2_spherical"])
def test_kmeans_fit_sharded_against_the_jax_tower(groups, case, kern):
    import jax.numpy as jnp

    from tdc_tpu.parallel import sharded_k as jsk

    grid = tuple(int(v) for v in case[:3].split("x"))
    spherical = case.endswith("spherical")
    ranks = groups[grid[0] * grid[1]]
    x, init = _blobs(3, N, SK, D)
    jm = jsk.make_mesh_2d(*grid)
    j = jsk.kmeans_fit_sharded(x, SK, jm, init=init, max_iters=10, tol=1e-4,
                               kernel=kern, spherical=spherical)
    # Both packages report the SSE as Σ shifted minima + Σ‖x‖² (the x2sum
    # step): its f32 rounding scales with Σ‖x‖² (N on the unit sphere).
    xs = x / np.linalg.norm(x, axis=1, keepdims=True) if spherical else x
    cost_atol = 1e-5 * float((xs.astype(np.float64) ** 2).sum())
    _assert_fit(_same_on_every_rank(
        ranks, ("kmeans_sharded", grid, kern, spherical)), j.centroids,
        j.n_iter, j.converged, j.sse, j.history, cost_atol)
    if spherical:
        return
    # The stats with the true minima (the JAX tower's default), each model
    # shard's own K/P rows, the data axis summed.
    want = jsk.make_sharded_stats(jm, kern)(jnp.asarray(x), jnp.asarray(init))
    k_per = SK // grid[1]
    for r in ranks:
        m, got = r["kmeans_sharded_stats", grid, kern]
        rows = slice(m * k_per, (m + 1) * k_per)
        np.testing.assert_allclose(got[0], np.asarray(want[0])[rows],
                                   rtol=RTOL, atol=1e-4)
        np.testing.assert_array_equal(got[1], np.asarray(want[1])[rows])
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=RTOL)
    for name, c, shifted in (("init", init, True), ("tie", _tied(init), True),
                             ("clamped", init, False)):
        want = np.asarray(jsk.sharded_assign(jm, kern, shifted=shifted)(
            jnp.asarray(x), jnp.asarray(c)))
        got = _labels_by_data_shard(ranks, ("kmeans_assign", grid, kern,
                                            name), grid[0])
        np.testing.assert_array_equal(got, want)
        if name == "tie":
            # The copy in the upper shard never wins: the lower global
            # index takes every row the two share.
            assert (got == 1).any() and not (got == SK // 2 + 1).any()


@pytest.mark.parametrize("world", [2, 4])
def test_kmeans_fit_sharded_repeats_and_refusals(groups, world):
    from tdc_tpu.parallel import sharded_k as jsk

    assert all(r["repeat_kmeans_sharded"] for r in groups[world])
    x, init = _blobs(3, N, SK, D)
    for key, call in (
            ("ks_ragged_n", lambda: jsk.kmeans_fit_sharded(
                x[:N - 1], SK, jsk.make_mesh_2d(world, 1), init="first_k")),
            ("ks_ragged_k", lambda: jsk.kmeans_fit_sharded(
                x, SK - 1, jsk.make_mesh_2d(1, world), init="first_k"))):
        with pytest.raises(ValueError) as exc:
            call()
        assert _same_on_every_rank(groups[world], key) == str(exc.value)
    for key, item in (("ks_assign", "A10"), ("ks_gather", "A9")):
        msg = _same_on_every_rank(groups[world], key)
        assert "not ported" in msg and item in msg


def test_host_shard_bounds_and_a_world_of_one():
    assert [tmh.host_shard_bounds(10, i, 3) for i in range(3)] == [
        (0, 4), (4, 7), (7, 10)]
    assert tmh.initialize_distributed(world_size=1) == (0, 1)
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    m = tsk.make_mesh_2d(1, 1)
    t = torch.ones(3)
    assert m.psum(t, "data", "model") is t and torch.equal(t, torch.ones(3))
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(tmesh.shard_points(x, tmesh.make_mesh(1)), x)
    padded, n = tmesh.pad_to_multiple(x, 4, 0.0)
    assert padded.shape == (8, 2) and n == 6
