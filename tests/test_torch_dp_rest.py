"""The rest of data parallel against the JAX package, on the CPU: the
hierarchical (dcn × ici) mesh under the stats and the streamed fits, the
quantized per-pass reduces with error feedback, and the CLI's
gaussianMixture and quantized reduces on two ranks.

Ranks: one group of 4 and one of 2 on gloo (`test_torch_reduce`'s
`spawn_ranks`, once per test run); the JAX side on the conftest's 8
virtual devices, with `make_hierarchical_mesh(2, n_devices=4)` against
the port's (2, 2) mesh and `make_mesh(w)` against w flat ranks.
Tolerances:
- stats on the (2, 2) mesh: tests/test_torch_parallel.py's (sums rtol
  1e-5 / atol 1e-4, counts equal, SSE rtol 1e-5; Σμx within 1e-5 of
  Σμ|x|, Σμ and J_m rtol 1e-5);
- streamed fits on the (2, 2) mesh, per batch and per pass, against
  JAX's hierarchical fits and the port's 4 flat ranks:
  tests/test_torch_streaming.py's fit bounds (n_iter and converged
  equal, centroids rtol 1e-5 / atol 1e-5, cost rtol 1e-5 and atol 1e-5
  of Σ‖x‖², GMM means atol 1e-4), comms equal JAX's;
- quantized fits (bf16, int8; flat and hierarchical): the cost within
  1e-3 relative of the f32 per_pass fit and of JAX's quantized fit, the
  centroids within 0.05 of both (JAX's own bounds,
  tests/test_reduce.py:304-381), comms equal JAX's (strategy, reduces,
  logical bytes, passes). The GMM: the log-likelihood within 1e-3 of
  JAX's quantized fit but 2e-3 of the f32 one, the means within 0.1 of
  both: after eight EM steps on overlapping blobs JAX's own bf16 fit of
  the full covariance sits 9.5e-4 from its f32 fit, and its quantized
  means up to 0.094 from the f32 ones; the port's rank slices
  (np.array_split) are not JAX's device slices (padded at the end), so
  each rank encodes other sums and lands elsewhere within that noise;
- the CLI rows against the JAX CLI's on 2 devices: every column but the
  timings equal, the cost column rtol 1e-5 (1e-3 under a quantized
  reduce).
"""

import csv

import numpy as np
import pytest
import torch

from test_torch_reduce import same_on_every_rank, shared_groups, spawn_ranks
from test_torch_streaming import (
    MESH_ROWS,
    _assert_fit,
    _blobs,
    _gmm_blobs,
    _out,
)
from tdc_tpu_torch.cli import main as tcli
from tdc_tpu_torch.data import loader as tload
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import streaming as tst
from tdc_tpu_torch.parallel import collectives as tcol
from tdc_tpu_torch.parallel import mesh as tmesh
from tdc_tpu_torch.parallel import multihost as tmh

RTOL = 1e-5
K, D = 6, 5
Q_ROWS = 250  # the quantized fits' batches: 4 of 250 and a ragged 200

# name: (method, kernel, reduce, covariance type)
HIER_CASES = {
    "kmeans_xla_per_batch": ("kmeans", "xla", "per_batch", None),
    "kmeans_pallas_per_pass": ("kmeans", "pallas", "per_pass", None),
    "fuzzy_xla_per_pass": ("fuzzy", "xla", "per_pass", None),
    "fuzzy_pallas_per_batch": ("fuzzy", "pallas", "per_batch", None),
    "gmm_diag_per_batch": ("gmm", "xla", "per_batch", "diag"),
    "gmm_full_per_pass": ("gmm", "xla", "per_pass", "full"),
}
# name: (method, reduce, mesh, covariance type)
Q_CASES = {
    "kmeans_int8_flat": ("kmeans", "per_pass:int8", "flat", None),
    "kmeans_bf16_flat": ("kmeans", "per_pass:bf16", "flat", None),
    "kmeans_int8_hier": ("kmeans", "per_pass:int8", "hier", None),
    "kmeans_bf16_hier": ("kmeans", "per_pass:bf16", "hier", None),
    "fuzzy_int8_flat": ("fuzzy", "per_pass:int8", "flat", None),
    "fuzzy_bf16_hier": ("fuzzy", "per_pass:bf16", "hier", None),
    "gmm_int8_hier": ("gmm", "per_pass:int8", "hier", "diag"),
    "gmm_bf16_flat": ("gmm", "per_pass:bf16", "flat", "full"),
}


def _blobs_small():
    """The conftest's blobs_small: 3 well-separated blobs, 1200 × 2."""
    rng = np.random.default_rng(0)
    centers = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]], np.float32)
    x = np.concatenate([rng.normal(c, 1.0, size=(400, 2)).astype(np.float32)
                        for c in centers])
    return x[rng.permutation(len(x))], centers


def _q_data(method):
    """(points, init) of a quantized case: the conftest's blobs_small
    from their true centers for K-Means and fuzzy; for the GMM the
    streamed tests' overlapping blobs (on well-separated blobs centred
    at 10, an int8 step of Σr·x² is larger than a component's variance,
    and the JAX package's own quantized fits move the log-likelihood by
    up to 3%)."""
    if method == "gmm":
        return _gmm_blobs()
    return _blobs_small()


def _stats_points():
    """The streamed tests' blobs cut to N = 1000 (JAX shards an array
    only evenly)."""
    x, init = _blobs()
    return x[:1000], init


def _fit_fn(pkg_streaming, pkg_gmm, method):
    return {"kmeans": pkg_streaming.streamed_kmeans_fit,
            "fuzzy": pkg_streaming.streamed_fuzzy_fit,
            "gmm": pkg_gmm.streamed_gmm_fit}[method]


def _hier_kw(case):
    method, kernel, reduce, cov = HIER_CASES[case]
    kw = dict(kernel=kernel, reduce=reduce)
    if cov:
        kw.update(covariance_type=cov, tol=-1.0, max_iters=6)
    else:
        kw.update(tol=1e-4, max_iters=12)
    return method, kw


def _q_kw(case):
    method, reduce, _, cov = Q_CASES[case]
    kw = dict(reduce=reduce, tol=-1.0, max_iters=8)
    if cov:
        kw["covariance_type"] = cov
    return method, kw


def _cli_data(path):
    rng = np.random.default_rng(0)
    centers = rng.uniform(-3, 3, size=(12, 6))
    y = rng.integers(0, 12, size=1200)
    x = (centers[y] + rng.normal(size=(1200, 6))).astype(np.float32)
    np.savez(path, X=x, Y=y)


CLI_BASE = ["--K=12", "--init=first_k", "--tol=-1", "--n_max_iters=5",
            "--seed=7"]
CLI_RUNS = {
    "gmm_diag": ["--method_name=gaussianMixture", "--kernel=xla"],
    "gmm_full": ["--method_name=gaussianMixture", "--kernel=xla",
                 "--covariance_type=full"],
    "kmeans_int8": ["--method_name=distributedKMeans", "--kernel=pallas",
                    "--num_batches=4", "--reduce=per_pass:int8"],
    "fuzzy_bf16": ["--method_name=distributedFuzzyCMeans", "--kernel=xla",
                   "--num_batches=4", "--reduce=per_pass:bf16"],
    "gmm_int8": ["--method_name=gaussianMixture", "--kernel=xla",
                 "--num_batches=3", "--reduce=per_pass:int8"],
}


def _job(world, tmp):
    out = {}
    if world == 2:
        # The CLI on two ranks: rank 0 writes the data and the rows.
        data = f"{tmp}/cli.npz"
        if tmh.process_index() == 0:
            _cli_data(data)
        tmh.barrier()
        for name, flags in CLI_RUNS.items():
            log = f"{tmp}/{name}.csv"
            rc = tcli.main([*CLI_BASE, *flags, f"--data_file={data}",
                            "--n_GPUs=2", "--device=cpu",
                            f"--log_file={log}"])
            out["cli", name] = (rc, _row(log) if tmh.process_index() == 0
                                else None)
        return out
    flat = tmesh.make_mesh(world)
    hier = tmesh.make_hierarchical_mesh(2)
    # The stats on the hierarchical mesh, both kernels.
    x, init = _stats_points()
    xl = tmesh.shard_points(torch.from_numpy(x), hier)
    c = torch.from_numpy(init)
    for kern in ("xla", "pallas"):
        out["lloyd", kern] = tuple(
            t.numpy() for t in tcol.distributed_lloyd_stats(
                xl, c, hier, kernel=kern))
        out["fuzzy", kern] = tuple(
            t.numpy() for t in tcol.distributed_fuzzy_stats(
                xl, c, hier, m=1.7, kernel=kern))
    for case in HIER_CASES:
        method, kw = _hier_kw(case)
        xc, ic = _gmm_blobs() if method == "gmm" else _blobs()
        fit = _fit_fn(tst, tgmm, method)
        for name, m in (("hier", hier), ("flat", flat)):
            out[case, name] = _out(fit(
                tload.NpzStream(xc, MESH_ROWS), K, D, init=ic, mesh=m,
                device="cpu", **kw))
    for case in Q_CASES:
        method, kw = _q_kw(case)
        xs, init = _q_data(method)
        m = hier if Q_CASES[case][2] == "hier" else flat
        fit = _fit_fn(tst, tgmm, method)
        out[case] = _out(fit(tload.NpzStream(xs, Q_ROWS), *init.shape,
                             init=init, mesh=m, device="cpu", **kw))
        kw["reduce"] = "per_pass"
        out[case, "f32"] = _out(fit(tload.NpzStream(xs, Q_ROWS),
                                    *init.shape, init=init, mesh=flat,
                                    device="cpu", **kw))
    return out


def _make(tmp):
    return {w: spawn_ranks(tmp, w, _job, (str(tmp),)) for w in (2, 4)}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return shared_groups(tmp_path_factory, "torch_dp_rest_ranks", _make)


def _same_fit(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key]["centroids"],
                                      first["centroids"])
        for f in ("n_iter", "converged", "cost", "comms"):
            assert r[key][f] == first[f], f
    return first


def _jax_hier():
    from tdc_tpu.parallel import mesh as jmesh

    return jmesh.make_hierarchical_mesh(2, n_devices=4)


@pytest.mark.parametrize("kern", ["xla", "pallas"])
def test_stats_on_the_hierarchical_mesh_against_jax(groups, kern):
    from tdc_tpu.ops import assign as jassign
    from tdc_tpu.parallel import collectives as jcol
    from tdc_tpu.parallel import mesh as jmesh

    x, init = _stats_points()
    jm = _jax_hier()
    xs = jmesh.shard_points(x, jm)
    got = same_on_every_rank(groups[4], ("lloyd", kern))
    want = jcol.distributed_lloyd_stats(xs, init, jm)
    np.testing.assert_allclose(got[0], np.asarray(want.sums), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_array_equal(got[1], np.asarray(want.counts))
    np.testing.assert_allclose(got[2], np.asarray(want.sse), rtol=RTOL)
    mu = np.asarray(jassign.fuzzy_memberships(x, init, m=1.7)) ** 1.7
    got = same_on_every_rank(groups[4], ("fuzzy", kern))
    want = jcol.distributed_fuzzy_stats(xs, init, jm, m=1.7)
    np.testing.assert_allclose(got[0], np.asarray(want.weighted_sums),
                               rtol=0,
                               atol=1e-5 * float((mu.T @ np.abs(x)).max()))
    np.testing.assert_allclose(got[1], np.asarray(want.weights), rtol=RTOL)
    np.testing.assert_allclose(got[2], np.asarray(want.objective),
                               rtol=RTOL)
    assert jmesh.is_hierarchical(jm)


@pytest.mark.parametrize("case", sorted(HIER_CASES))
def test_streamed_fits_on_the_hierarchical_mesh(groups, case):
    """Per batch and per pass on a (2, 2) mesh, each rank's slice of
    every batch padded, against JAX's hierarchical fits (which reduce
    ici first too) and the port's four flat ranks; the kernel route is
    held to JAX's plain route, the same function
    (tests/test_torch_streaming.py says why)."""
    from tdc_tpu.data.loader import NpzStream as JStream
    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.models import streaming as jst

    method, kw = _hier_kw(case)
    x, init = _gmm_blobs() if method == "gmm" else _blobs()
    got = _same_fit(groups[4], (case, "hier"))
    kw["kernel"] = "xla"
    want = _out(_fit_fn(jst, jgmm, method)(JStream(x, MESH_ROWS), K, D,
                                           init=init, mesh=_jax_hier(),
                                           **kw))
    cost_atol = RTOL * float((x * x).sum())
    _assert_fit(got, want, cost_atol=cost_atol)
    assert got["comms"] == want["comms"]
    strategy, reduces, _, passes = got["comms"]
    # Two stages a reduce: 7 batches a pass, or one reduce a pass.
    assert reduces == 2 * passes * (1 if strategy == "per_pass" else 7)
    _assert_fit(got, _same_fit(groups[4], (case, "flat")),
                cost_atol=cost_atol)


@pytest.mark.parametrize("case", sorted(Q_CASES))
def test_quantized_fits_against_f32_and_jax(groups, case):
    from tdc_tpu.data.loader import NpzStream as JStream
    from tdc_tpu.models import gmm as jgmm
    from tdc_tpu.models import streaming as jst
    from tdc_tpu.parallel import mesh as jmesh

    method, kw = _q_kw(case)
    x, init = _q_data(method)
    got = _same_fit(groups[4], case)
    f32 = groups[4][0][case, "f32"]
    jm = (_jax_hier() if Q_CASES[case][2] == "hier"
          else jmesh.make_mesh(4))
    want = _out(_fit_fn(jst, jgmm, method)(JStream(x, Q_ROWS), *init.shape,
                                           init=init, mesh=jm, **kw))
    c_tol = 0.1 if method == "gmm" else 0.05
    for ref, rtol in ((want, 1e-3), (f32, 2e-3 if method == "gmm" else 1e-3)):
        assert abs(got["cost"] - ref["cost"]) <= rtol * abs(ref["cost"])
        assert np.abs(got["centroids"] - ref["centroids"]).max() < c_tol
    assert got["n_iter"] == want["n_iter"] == 8
    assert got["comms"] == want["comms"]
    assert got["comms"][0] == kw["reduce"]
    if method == "kmeans":
        # The blobs' true centers.
        d = np.linalg.norm(got["centroids"][:, None] - init[None],
                           axis=-1)
        assert (d.min(axis=1) < 0.5).all()


def _row(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_cli_rows_on_two_ranks_against_the_jax_cli(groups, name, tmp_path):
    from tdc_tpu.cli import main as jcli

    assert [r["cli", name][0] for r in groups[2]] == [0, 0]
    t = groups[2][0]["cli", name][1]
    data = tmp_path / "cli.npz"
    _cli_data(data)
    jlog = tmp_path / "jax.csv"
    assert jcli.main([*CLI_BASE, *CLI_RUNS[name], f"--data_file={data}",
                      f"--log_file={jlog}", "--n_GPUs=2",
                      "--cache_dir="]) == 0
    j = _row(jlog)
    assert list(j) == list(t)
    assert (t["num_GPUs"], t["status"], t["backend"]) == ("2", "ok", "cpu")
    rtol = 1e-3 if "int8" in name or "bf16" in name else RTOL
    np.testing.assert_allclose(float(t["sse"]), float(j["sse"]), rtol=rtol)
    timing = {"setup_time", "initialization_time", "computation_time",
              "backend", "points_per_sec_per_chip", "sse"}
    for col in set(j) - timing:
        assert t[col] == j[col], col
