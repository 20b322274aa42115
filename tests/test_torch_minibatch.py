"""Mini-batch K-Means of the port against the JAX package's, on the CPU.

The step is compared on 'xla' and 'pallas' (the port's B1 and B4 plain
versions; the JAX package's Pallas kernels in interpret mode), weighted,
with zero padding marked by n_valid, and with low-count reassignment fed
JAX's own uniforms (`_uniforms` replaced by the draws of the JAX state's
key splits). The fit is compared over a stream from an explicit init,
and a mesh of two gloo ranks against one process and the JAX package's
8-device mesh.

Tolerances (float32, another summation order): centroids rtol 1e-5 /
atol 1e-5, lifetime counts rtol 1e-5, the batch SSE rtol 1e-5 (on
'pallas' also atol 1e-5·Σ‖x‖² of the batch: the JAX kernel's SSE comes
from the expanded d², which cancels ‖x‖²); a fit's history SSE as the
batch SSE and its shifts atol 1e-5; n_iter and converged equal.
"""

import multiprocessing as mp
import queue as queue_lib
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_tpu.models import minibatch as jmb
from tdc_tpu_torch.data import loader as tload
from tdc_tpu_torch.models import minibatch as tmb
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh

RTOL = 1e-5
N, K, D = 600, 8, 5
ROWS = 150


def _blobs(seed=0, n=N, k=K, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(k, d))
    x = (centers[rng.integers(0, k, size=n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    init = x[rng.choice(n, k, replace=False)].copy()
    # A center far from every point: it takes no row, so its count stays
    # low and reassignment moves it.
    init[-1] = 100.0
    w = rng.uniform(0, 2, size=n).astype(np.float32)
    w[::7] = 0.0
    return x, init, w


def _states(init, counts=None, step_key=None):
    counts = np.zeros(K, np.float32) if counts is None else counts
    j = jmb.MiniBatchState(
        centroids=jnp.asarray(init), counts=jnp.asarray(counts),
        step=jnp.asarray(0, jnp.int32), last_sse=jnp.asarray(jnp.inf),
        key=step_key)
    t = tmb.MiniBatchState(
        centroids=torch.from_numpy(init.copy()),
        counts=torch.from_numpy(counts.copy()), step=0,
        last_sse=torch.tensor(float("inf")),
        generator=torch.Generator().manual_seed(0))
    return j, t


class JaxUniforms:
    """The uniforms of the JAX step's reassignment, from its state key:
    each step splits the key, then draws (n,) uniforms from the sub key."""

    def __init__(self, key):
        self.key = key

    def __call__(self, generator, n, device):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(sub, (n,))))


def _assert_state(t, j, sse_atol=0.0):
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(t.counts.numpy(), np.asarray(j.counts),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(t.last_sse), float(j.last_sse),
                               rtol=RTOL, atol=sse_atol)
    assert t.step == int(j.step)


STEP_CASES = {
    "xla": dict(kernel="xla"),
    "pallas": dict(kernel="pallas"),
    "xla_weighted": dict(kernel="xla", weighted=True),
    "pallas_weighted": dict(kernel="pallas", weighted=True),
    "xla_n_valid": dict(kernel="xla", n_valid=True),
    "pallas_n_valid": dict(kernel="pallas", n_valid=True),
    "xla_reassign": dict(kernel="xla", ratio=0.05),
    "pallas_reassign_n_valid": dict(kernel="pallas", ratio=0.05,
                                    n_valid=True),
    "xla_reassign_weighted": dict(kernel="xla", ratio=0.05, weighted=True),
}


@pytest.mark.parametrize("case", STEP_CASES)
def test_steps_against_jax(monkeypatch, case):
    spec = STEP_CASES[case]
    x, init, w = _blobs()
    kernel, ratio = spec["kernel"], spec.get("ratio", 0.0)
    # Two copies of the key: the JAX step donates its state's.
    js, ts = _states(init, step_key=jax.random.PRNGKey(9))
    monkeypatch.setattr(tmb, "_uniforms", JaxUniforms(jax.random.PRNGKey(9)))
    for s in range(0, N, ROWS):
        xb = x[s:s + ROWS]
        wb = w[s:s + ROWS] if spec.get("weighted") else None
        n_valid = None
        if spec.get("n_valid"):
            # 20 zero rows of padding after the batch's real rows.
            xb = np.concatenate([xb, np.zeros((20, D), np.float32)])
            n_valid = ROWS
        js = jmb.minibatch_step(
            js, jnp.asarray(xb),
            None if n_valid is None else jnp.asarray(n_valid),
            None if wb is None else jnp.asarray(wb),
            reassignment_ratio=ratio, kernel=kernel)
        ts = tmb.minibatch_step(ts, torch.from_numpy(xb), n_valid,
                                None if wb is None else torch.from_numpy(wb),
                                reassignment_ratio=ratio, kernel=kernel)
        # The JAX kernel's SSE comes from the expanded d², which cancels
        # ‖x‖² (the port's plain version is within 1e-7 of the f64 SSE).
        _assert_state(ts, js, 1e-5 * float((xb.astype(np.float64) ** 2).sum())
                      if kernel == "pallas" else 0.0)
    if ratio:
        # The far center was reassigned onto a row of a batch.
        assert float(ts.centroids[-1].abs().max()) < 50.0


def test_step_refusals_in_the_jax_words():
    _, init, w = _blobs()
    _, ts = _states(init)
    x = torch.zeros((10, D))
    with pytest.raises(ValueError, match="unknown kernel 'tall'"):
        tmb.minibatch_step(ts, x, kernel="tall")
    with pytest.raises(ValueError, match="not supported for mini-batch"):
        tmb.minibatch_step(ts, x, sample_weight=torch.ones(10),
                           kernel="pallas", mesh=tmesh.make_mesh(1))
    with pytest.raises(ValueError, match="requires a generator"):
        tmb.minibatch_step(ts._replace(generator=None), x,
                           reassignment_ratio=0.1)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "auto"])
def test_fit_over_a_stream_against_jax(monkeypatch, kernel):
    x, init, _ = _blobs(1)
    key = jax.random.PRNGKey(4)
    _, step_key = jax.random.split(key)
    monkeypatch.setattr(tmb, "_uniforms", JaxUniforms(step_key))
    from tdc_tpu.data import loader as jload

    j = jmb.minibatch_kmeans_fit(jload.NpzStream(x, ROWS), K, D, init=init,
                                 key=key, epochs=6, tol=1e-3,
                                 kernel=kernel)
    t = tmb.minibatch_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                 epochs=6, tol=1e-3, kernel=kernel,
                                 device="cpu")
    assert (t.n_iter, t.converged) == (int(j.n_iter), bool(j.converged))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    sse_atol = 1e-5 * max(float((x[s:s + ROWS].astype(np.float64) ** 2
                                 ).sum()) for s in range(0, N, ROWS)
                          ) if kernel == "pallas" else 0.0
    np.testing.assert_allclose(t.history[:, 0], j.history[:, 0], rtol=RTOL,
                               atol=sse_atol)
    np.testing.assert_allclose(t.history[:, 1], j.history[:, 1], atol=1e-5)
    np.testing.assert_allclose(float(t.sse), float(j.sse), rtol=RTOL,
                               atol=sse_atol)


def test_fit_checkpoint_names_the_roadmap_and_empty_stream_raises(
        tmp_path, monkeypatch):
    # The per-epoch checkpoint is ported: what stays refused is a JAX
    # checkpoint's threefry key where the fit would draw with it. The
    # JAX fit writes the state.npz format as under several processes.
    from tdc_tpu.data import loader as jload
    from tdc_tpu.parallel import multihost as jmh

    x, init, _ = _blobs()
    ck = str(tmp_path / "ck")
    with monkeypatch.context() as mp_:
        mp_.setattr(jax, "process_count", lambda: 2)
        mp_.setattr(jmh, "barrier", lambda *a, **kw: None)
        jmb.minibatch_kmeans_fit(jload.NpzStream(x, ROWS), K, D, init=init,
                                 epochs=1, ckpt_dir=ck,
                                 key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="threefry key"):
        tmb.minibatch_kmeans_fit(tload.NpzStream(x, ROWS), K, D, init=init,
                                 epochs=2, ckpt_dir=ck, device="cpu")
    with pytest.raises(ValueError, match="partial_fit was never called"):
        tmb.minibatch_kmeans_fit(lambda: iter(()), K, D, init=init,
                                 device="cpu")


def test_named_init_from_fitted_and_repeats(tmp_path):
    x, init, _ = _blobs(2)
    fits = [tmb.minibatch_kmeans_fit(
        tload.NpzStream(x, ROWS), K, D, init=name, epochs=2, device="cpu",
        generator=torch.Generator().manual_seed(3))
        for name in ("kmeans++", "kmeans++", "kmeans||")]
    assert torch.equal(fits[0].centroids, fits[1].centroids)
    assert torch.isfinite(fits[2].centroids).all()
    from tdc_tpu_torch.models.persist import save_fitted

    save_fitted(str(tmp_path / "m"), fits[0])
    mbk = tmb.MiniBatchKMeans.from_fitted(str(tmp_path / "m"),
                                          prior_count=5.0, device="cpu")
    assert torch.equal(mbk.centroids, fits[0].centroids)
    assert torch.equal(mbk.state.counts, torch.full((K,), 5.0))
    mbk.partial_fit(x[:ROWS])
    assert mbk.state.step == 1
    with pytest.raises(ValueError, match="counts shape"):
        tmb.MiniBatchKMeans.from_fitted(str(tmp_path / "m"),
                                        counts=np.ones(3), device="cpu")


# Two gloo ranks: the mini-batch fit on a mesh (ragged batches: every
# rank's slice is padded and corrected), weighted and with reassignment,
# and 'kmeans||' drawn on rank 0 under resolve_init_replicated.

MESH_N = 603  # batches of 150 rows and a last one of 3: slices padded


def _mesh_job(world):
    from tdc_tpu_torch.models import kmeans as tkm

    x, init, w = _blobs(3, n=MESH_N)
    mesh = tmesh.make_mesh(world)
    out = {}
    for name, kw in (("plain", dict(kernel="xla")),
                     ("pallas", dict(kernel="pallas")),
                     ("reassign", dict(kernel="xla",
                                       reassignment_ratio=0.05))):
        res = tmb.minibatch_kmeans_fit(
            tload.NpzStream(x, ROWS), K, D, init=init, epochs=3, tol=-1.0,
            mesh=mesh, device="cpu",
            **{"reassignment_ratio": 0.0, **kw})
        out[name] = (res.centroids.numpy(), float(res.sse), res.history)
    mbk = tmb.MiniBatchKMeans(K, D, init=init, mesh=mesh,
                              reassignment_ratio=0.05, device="cpu")
    for s in range(0, MESH_N, ROWS):
        mbk.partial_fit(x[s:s + ROWS], w[s:s + ROWS])
    out["weighted"] = (mbk.centroids.numpy(), float(mbk.state.last_sse),
                       mbk.state.counts.numpy())
    gen = torch.Generator().manual_seed(7 + tmh.process_index())
    out["kmeans||"] = tkm.resolve_init_replicated(
        torch.from_numpy(x), K, "kmeans||", gen, mesh).numpy()
    return out


def _rank_main(rank, world, init_method, queue):
    torch.set_num_threads(1)
    try:
        tmh.initialize_distributed(init_method, world, rank, device="cpu")
        queue.put((rank, _mesh_job(world)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        tmh.shutdown()


def _spawn(tmp_path, world, timeout=240):
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
        while len(results) < world:
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
def ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mb_ranks"), 2)


def _one_process(name, x, init, w, uniforms=None, monkeypatch=None):
    """The port's fit of MESH case `name` in this process; `uniforms`
    replaces its reassignment draws."""
    if uniforms is not None:
        monkeypatch.setattr(tmb, "_uniforms", uniforms)
    if name == "weighted":
        mbk = tmb.MiniBatchKMeans(K, D, init=init, reassignment_ratio=0.05,
                                  device="cpu")
        for s in range(0, MESH_N, ROWS):
            mbk.partial_fit(x[s:s + ROWS], w[s:s + ROWS])
        return mbk.centroids.numpy(), float(mbk.state.last_sse)
    res = tmb.minibatch_kmeans_fit(
        tload.NpzStream(x, ROWS), K, D, init=init, epochs=3, tol=-1.0,
        kernel="pallas" if name == "pallas" else "xla",
        reassignment_ratio=0.05 if name == "reassign" else 0.0,
        device="cpu")
    return res.centroids.numpy(), float(res.sse)


def _jax_mesh(name, x, init, w):
    from tdc_tpu.data import loader as jload
    from tdc_tpu.parallel import mesh as jmesh

    jm = jmesh.make_mesh(2)
    key = jax.random.PRNGKey(0)
    if name == "weighted":
        mbk = jmb.MiniBatchKMeans(K, D, init=init, mesh=jm, key=key,
                                  reassignment_ratio=0.05)
        for s in range(0, MESH_N, ROWS):
            mbk.partial_fit(x[s:s + ROWS], w[s:s + ROWS])
        return np.asarray(mbk.centroids), float(mbk.state.last_sse)
    j = jmb.minibatch_kmeans_fit(
        jload.NpzStream(x, ROWS), K, D, init=init, epochs=3, tol=-1.0,
        mesh=jm, key=key, kernel="pallas" if name == "pallas" else "xla",
        reassignment_ratio=0.05 if name == "reassign" else 0.0)
    return np.asarray(j.centroids), float(j.sse)


@pytest.mark.parametrize("name", ["plain", "pallas", "reassign", "weighted"])
def test_mesh_fit_against_one_process_and_the_jax_mesh(ranks, name,
                                                       monkeypatch):
    # Two ranks against the port in one process from the same torch draws
    # (rank 0's generator, seeded 0, draws what one process's does), and
    # the port in one process fed JAX's uniforms against the JAX package
    # on a 2-device mesh.
    x, init, w = _blobs(3, n=MESH_N)
    for field in range(len(ranks[0][name])):  # every rank: the same bits
        assert np.array_equal(np.asarray(ranks[0][name][field]),
                              np.asarray(ranks[1][name][field]))
    got_c, got_sse = ranks[0][name][:2]
    one_c, one_sse = _one_process(name, x, init, w)
    np.testing.assert_allclose(got_c, one_c, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got_sse, one_sse, rtol=RTOL)
    _, step_key = jax.random.split(jax.random.PRNGKey(0))
    fed_c, fed_sse = _one_process(name, x, init, w, JaxUniforms(step_key),
                                  monkeypatch)
    want_c, want_sse = _jax_mesh(name, x, init, w)
    if name == "pallas":
        # The JAX kernel in interpret mode pads the last 3-row batch to its
        # block with zero rows and subtracts them: ~5e-4 of that batch's
        # SSE cancels away. Its 'xla' fit holds the SSE (the port's is
        # within 1e-6 of the f64 one).
        want_sse = _jax_mesh("plain", x, init, w)[1]
    np.testing.assert_allclose(fed_c, want_c, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(fed_sse, want_sse, rtol=RTOL)
    if name in ("reassign", "weighted"):
        assert np.abs(got_c[-1]).max() < 50.0  # the far center moved


def test_kmeans_parallel_drawn_on_rank_zero(ranks):
    a, b = ranks[0]["kmeans||"], ranks[1]["kmeans||"]
    assert np.array_equal(a, b)
    x, _, _ = _blobs(3, n=MESH_N)
    from tdc_tpu_torch.ops import kmeans_parallel as tkp

    want = tkp.init_kmeans_parallel(torch.Generator().manual_seed(7),
                                    torch.from_numpy(x), K).numpy()
    np.testing.assert_array_equal(a, want)


def test_batch_sizing_follows_the_port_working_set(monkeypatch):
    from tdc_tpu_torch.data import batching as tbat

    monkeypatch.setattr(tbat, "device_hbm_bytes",
                        lambda device=None: 80 << 30)
    # B1 keeps no (rows, K) buffer; the plain form keeps 16·K bytes a row.
    assert tbat.working_set_row_bytes(128, 1024, kernel="pallas") == 528
    assert tbat.working_set_row_bytes(128, 1024) == 512 + 16 * 1024
    budget = int(0.6 * (80 << 30))
    assert tbat.hbm_budget_bytes() == budget
    assert tbat.auto_batch_size(128, 1024, kernel="pallas",
                                n_devices=2) == 2 * (budget // 528)
    assert tbat.auto_batch_size(128, 1 << 40) == 1
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no device memory"):
        tbat.auto_batch_size(8, 4, device="cpu")
