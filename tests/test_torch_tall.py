"""The port's feature-major path against the JAX package's, on the CPU:
B10's and B11's plain versions (`tdc_tpu_torch/ops/tall.py`) against the
JAX tall kernels in interpret mode, both fits with layout="features", the
error contract, the `*.fm.npy` loaders and both CLIs with
--layout=features.

Tolerances: counts and labels equal; Σx rtol 1e-5 / atol 1e-4; SSE rtol
1e-5; fuzzy Σμx rtol 1e-5 with atol 1e-5 of the largest |Σμx|, Σμ and J_m
rtol 1e-5 (float32, another summation order); fits: n_iter and converged
equal, centroids within rtol 1e-5 / atol 1e-5; CLI rows: every column but
the timings and `backend` equal, `sse` within rtol 1e-5.

The JAX kernels pad N to their column block (32,768 columns at d=5,
K=15) and subtract the padding's contribution. For Lloyd that correction
is exact in the counts and sums, but the SSE subtracts n_fake·‖c‖² and
cancels (1.1e-5 relative at N=1000); for fuzzy it subtracts n_fake times
one zero column's memberships, which cancels too (and, on bf16 columns,
uses the unrounded centroids). So every stats comparison pads at most a
few hundred columns (an explicit small `block_n`), and the fits and CLI
rows take N equal to the JAX block where the cost is compared.
"""

import csv

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tdc_tpu.cli import main as jcli
from tdc_tpu.data import loader as jloader
from tdc_tpu.models import fuzzy as jfz
from tdc_tpu.models import kmeans as jkm
from tdc_tpu.ops import tall as jtall
from tdc_tpu_torch import convert
from tdc_tpu_torch.cli import main as tcli
from tdc_tpu_torch.data import loader as tloader
from tdc_tpu_torch.data import make_blobs
from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.ops import tall as ttall

RTOL = 1e-5
TIMING = {"setup_time", "initialization_time", "computation_time",
          "backend", "points_per_sec_per_chip"}


def _blobs(seed, n, k, d, spread=4.0):
    """(xt (d, n) f32, centroids (k, d) f32): blobs around k centers and
    centroids near them, so no column sits near a tie."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(k, d))
    x = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))
    c = centers + 0.1 * rng.normal(size=(k, d))
    return (np.ascontiguousarray(x.T).astype(np.float32),
            c.astype(np.float32))


def _cols(xt, dtype):
    """(the JAX array, the port's tensor) of the same columns."""
    if dtype == "bfloat16":
        xb = xt.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(xb),
                torch.from_numpy(xb.view(np.uint16)).view(torch.bfloat16))
    return jnp.asarray(xt), torch.from_numpy(xt)


def _exact_labels(xt, c, dtype):
    """argmin of the exact (f64) d² of the operands as both kernels see
    them: bf16 columns take bf16-rounded centroids."""
    if dtype == "bfloat16":
        xt = xt.astype(ml_dtypes.bfloat16).astype(np.float64)
        c = c.astype(ml_dtypes.bfloat16).astype(np.float64)
    d2 = ((xt.T[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    return d2.argmin(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k,block_n", [
    (1000, 5, 15, 200),   # the reference sweep's d and K
    (4096, 16, 64, 1024),
    (1300, 12, 3, 128),   # 108 padded columns in the JAX kernel
])
def test_lloyd_stats_tall_matches_jax(n, d, k, block_n, dtype):
    xt, c = _blobs(0, n, k, d)
    jx, tx = _cols(xt, dtype)
    j = jtall.lloyd_stats_tall(jx, jnp.asarray(c), block_n=block_n)
    t, lab = ttall.lloyd_stats_tall(tx, torch.from_numpy(c),
                                    return_labels=True)
    np.testing.assert_array_equal(lab.numpy(), _exact_labels(xt, c, dtype))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_allclose(t.sums.numpy(), np.asarray(j.sums),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(float(t.sse), float(j.sse), rtol=RTOL)


@pytest.mark.parametrize("m", [2.0, 1.7])
@pytest.mark.parametrize("n,block_n,dtype", [
    (1024, 256, "float32"),
    (1000, 256, "float32"),  # 24 padded columns in the JAX kernel
    # bf16 unpadded only: the JAX correction would use the unrounded
    # centroids (ROADMAP, "Not faults").
    (1024, 256, "bfloat16"),
])
def test_fuzzy_stats_tall_matches_jax(n, block_n, dtype, m):
    xt, c = _blobs(1, n, 15, 5, spread=2.0)
    jx, tx = _cols(xt, dtype)
    j = jtall.fuzzy_stats_tall(jx, jnp.asarray(c), m=m, block_n=block_n)
    t = ttall.fuzzy_stats_tall(tx, torch.from_numpy(c), m=m)
    jw = np.asarray(j.weighted_sums)
    np.testing.assert_allclose(t.weighted_sums.numpy(), jw, rtol=RTOL,
                               atol=RTOL * np.abs(jw).max())
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=RTOL)
    np.testing.assert_allclose(float(t.objective), float(j.objective),
                               rtol=RTOL)


def _assert_fit(j, t, cost):
    assert t.n_iter == int(j.n_iter)
    assert t.converged == bool(j.converged)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(getattr(t, cost)),
                               float(getattr(j, cost)), rtol=RTOL)
    if j.history is not None:
        jh, th = np.asarray(j.history), t.history
        assert th.shape == jh.shape
        np.testing.assert_allclose(th[:, 0], jh[:, 0], rtol=RTOL)
        np.testing.assert_allclose(th[:, 1], jh[:, 1], rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("variant", ["plain", "spherical", "history",
                                     "bfloat16"])
@pytest.mark.parametrize("init", ["first_k", "array"])
def test_kmeans_fit_features_matches_jax(init, variant):
    n = jtall.tall_block_n(8, 5)
    xt, c = _blobs(2, n, 8, 5)
    kw = {"spherical": variant == "spherical",
          "history": variant == "history"}
    if variant == "bfloat16":
        xt = xt.astype(ml_dtypes.bfloat16)
    spec = "first_k" if init == "first_k" else c
    j = jkm.kmeans_fit(xt, 8, init=spec, max_iters=12, tol=1e-4,
                       layout="features", **kw)
    t = tkm.kmeans_fit(xt, 8, init=spec, max_iters=12, tol=1e-4,
                       layout="features", device="cpu", **kw)
    _assert_fit(j, t, "sse")


@pytest.mark.parametrize("variant", ["plain", "history", "bfloat16"])
@pytest.mark.parametrize("init", ["first_k", "array"])
def test_fuzzy_fit_features_matches_jax(init, variant):
    bf16 = variant == "bfloat16"
    # N is the JAX kernel's own block: no padded columns (module note).
    n = jtall.tall_block_n(6, 5, 2 if bf16 else 4, temps=5)
    xt, c = _blobs(3, n, 6, 5, spread=3.0)
    if bf16:
        xt = xt.astype(ml_dtypes.bfloat16)
    spec = "first_k" if init == "first_k" else c
    kw = {"history": variant == "history"}
    j = jfz.fuzzy_cmeans_fit(xt, 6, init=spec, max_iters=8, tol=-1.0,
                             layout="features", **kw)
    t = tfz.fuzzy_cmeans_fit(xt, 6, init=spec, max_iters=8, tol=-1.0,
                             layout="features", device="cpu", **kw)
    _assert_fit(j, t, "objective")


def _message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


X_FM = np.zeros((4, 64), np.float32)  # (d, N)
W = np.ones(64, np.float32)
VALIDATION = {
    "kmeans_unknown_layout": (
        lambda fit, **kw: fit(X_FM.T, 3, layout="rows", **kw), "kmeans"),
    "kmeans_relocate": (
        lambda fit, **kw: fit(X_FM, 3, layout="features",
                              empty_policy="relocate", **kw), "kmeans"),
    "kmeans_mesh": (
        lambda fit, **kw: fit(X_FM, 3, layout="features", mesh=object(),
                              **kw), "kmeans"),
    "kmeans_weights": (
        lambda fit, **kw: fit(X_FM, 3, layout="features", sample_weight=W,
                              **kw), "kmeans"),
    "kmeans_kernel": (
        lambda fit, **kw: fit(X_FM, 3, layout="features", kernel="pallas",
                              **kw), "kmeans"),
    "fuzzy_unknown_layout": (
        lambda fit, **kw: fit(X_FM.T, 3, layout="rows", **kw), "fuzzy"),
    "fuzzy_mesh": (
        lambda fit, **kw: fit(X_FM, 3, layout="features", mesh=object(),
                              **kw), "fuzzy"),
    "fuzzy_weights": (
        lambda fit, **kw: fit(X_FM, 3, layout="features", sample_weight=W,
                              **kw), "fuzzy"),
    "fuzzy_kernel": (
        lambda fit, **kw: fit(X_FM, 3, layout="features",
                              kernel="pallas_bf16", **kw), "fuzzy"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_fit_validation_errors_in_the_reference_words(case):
    call, model = VALIDATION[case]
    jfit, tfit = ((jkm.kmeans_fit, tkm.kmeans_fit) if model == "kmeans"
                  else (jfz.fuzzy_cmeans_fit, tfz.fuzzy_cmeans_fit))
    assert (_message(lambda: call(tfit, device="cpu"))
            == _message(lambda: call(jfit)))


@pytest.mark.parametrize("d,k,fuzzy", [(5, 4000, False), (128, 2600, True),
                                       (5, 2600, True)])
def test_k_past_the_reference_limit_raises_the_reference_error(d, k, fuzzy):
    xt = np.zeros((d, 256), np.float32)
    c = np.zeros((k, d), np.float32)
    assert ttall.tall_block_n(k, d, temps=5 if fuzzy else 3) == 0
    jfn, tfn = ((jtall.fuzzy_stats_tall, ttall.fuzzy_stats_tall) if fuzzy
                else (jtall.lloyd_stats_tall, ttall.lloyd_stats_tall))
    assert (_message(lambda: tfn(torch.from_numpy(xt), torch.from_numpy(c)))
            == _message(lambda: jfn(jnp.asarray(xt), jnp.asarray(c))))


@pytest.mark.parametrize("k,d,itemsize,temps", [
    (15, 5, 4, 3), (15, 5, 2, 5), (1024, 128, 4, 3), (1024, 128, 4, 5),
    (3376, 5, 4, 3), (3377, 5, 4, 3), (2536, 32, 4, 5), (2537, 32, 4, 5),
])
def test_tall_block_n_is_the_reference_rule(k, d, itemsize, temps):
    assert (ttall.tall_block_n(k, d, itemsize, temps=temps)
            == jtall.tall_block_n(k, d, itemsize, temps=temps))


# B10's streaming-form plan (consumer warps, ring slots, CTAs), made on
# the host and checked by the kernel's entry point on the card.
@pytest.mark.parametrize("itemsize", [4, 2])
def test_b10_plan_fits_beside_the_accumulators(itemsize):
    for d in range(1, 9):
        for k in range(1, 200):
            plan = ttall.lloyd_plan(k, d, itemsize)
            if k * (d + 1) > ttall.LLOYD_MAX_ENTRIES:
                assert plan == (0, 0)  # the tile form
                continue
            # The most warps that leave room for two slots and 32 KiB of
            # columns; as many slots as fit in the CTA's shared memory,
            # at most 16.
            assert plan.warps in ttall.LLOYD_WARPS
            for w in ttall.LLOYD_WARPS:
                if w <= plan.warps:
                    break
                ring = -(-(32 << 10) // (d * 128 * w * itemsize))
                assert ttall.lloyd_smem(k, d, max(2, ring), itemsize,
                                        w) > ttall.SMEM_LIMIT
            assert 2 <= plan.slots <= ttall.LLOYD_MAX_SLOTS
            assert plan.slots * d * plan.tile_cols * itemsize >= 32 << 10
            smem = ttall.lloyd_smem(k, d, plan.slots, itemsize, plan.warps)
            assert smem <= ttall.SMEM_LIMIT
            assert (plan.slots == ttall.LLOYD_MAX_SLOTS
                    or ttall.lloyd_smem(k, d, plan.slots + 1, itemsize,
                                        plan.warps) > ttall.SMEM_LIMIT)
    assert ttall.lloyd_plan(1, 9, 4) == (0, 0)  # d > 8: the tile form


@pytest.mark.parametrize("k,d,itemsize,warps,slots,smem", [
    # the tall route: 12 warps, 15 · 6 · 1.5 KiB of accumulators
    (15, 5, 4, 12, 2, 203552), (15, 5, 2, 12, 5, 219152),
    # K·(d+1) = 144, the limit: 8 warps and two f32 slots at d = 8
    (16, 8, 4, 8, 2, 216192), (16, 8, 2, 8, 4, 216448),
    (72, 1, 4, 8, 16, 216192), (9, 8, 4, 12, 2, 226816),
])
def test_b10_plan_at_the_route_and_the_limit(k, d, itemsize, warps, slots,
                                             smem):
    plan = ttall.lloyd_plan(k, d, itemsize)
    assert plan == (warps, slots)
    assert ttall.lloyd_smem(k, d, slots, itemsize, warps) == smem


@pytest.mark.parametrize("n,sms,warps,grid", [
    (10 ** 8, 132, 12, 132), (1, 132, 12, 1), (1536, 132, 12, 1),
    (1537, 132, 12, 2), (1024, 132, 8, 1), (1025, 132, 8, 2),
    (132 * 1024, 132, 8, 132), (1 << 21, 114, 8, 114), (0, 132, 8, 1),
])
def test_b10_grid_is_one_cta_per_sm_and_at_most_one_per_tile(n, sms, warps,
                                                            grid):
    assert ttall.lloyd_grid(n, sms, ttall.LloydPlan(warps, 2)) == grid


def _save(path, x):
    if x.dtype == ml_dtypes.bfloat16:
        x = x.view(np.dtype("V2"))  # how numpy stores ml_dtypes' bfloat16
    if str(path).endswith(".npz"):
        np.savez(path, X=x, Y=np.arange(x.shape[0]))
    else:
        np.save(path, x)
    return str(path)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ext", [".npy", ".npz"])
def test_feature_major_files_round_trip_across_packages(tmp_path, ext,
                                                        dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 7)).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    src = _save(tmp_path / f"points{ext}", x)
    jdst, tdst = str(tmp_path / "j.fm.npy"), str(tmp_path / "t.fm.npy")
    assert jloader.to_feature_major(src, jdst, chunk_rows=64) == jdst
    assert tloader.to_feature_major(src, tdst, chunk_rows=64) == tdst
    with open(jdst, "rb") as a, open(tdst, "rb") as b:
        assert a.read() == b.read()  # the same file, byte for byte
    want = _bits(x.T)
    for path in (jdst, tdst, src):  # each package reads every file
        jx, _ = jloader.load_points_feature_major(path, chunk_rows=64)
        tx, _ = tloader.load_points_feature_major(path, chunk_rows=64)
        np.testing.assert_array_equal(_bits(jx), want)
        np.testing.assert_array_equal(_bits(tx), want)
        assert (isinstance(tx, torch.Tensor)) == (dtype == "bfloat16")


def test_loaders_refuse_what_the_reference_refuses(tmp_path):
    path = _save(tmp_path / "x.fm.npy", np.zeros((3, 10), np.float32))
    assert (_message(lambda: tloader.load_points(path))
            == _message(lambda: jloader.load_points(path)))
    src = _save(tmp_path / "x.npy", np.zeros((10, 3), np.float32))
    bad = str(tmp_path / "x_fm.npy")
    assert (_message(lambda: tloader.to_feature_major(src, bad))
            == _message(lambda: jloader.to_feature_major(src, bad)))


def test_make_blobs_features_layout_shares_the_samples_centers():
    xs, ys = make_blobs(5, 4000, 6, 4, device="cpu")
    xf, yf = make_blobs(5, 4000, 6, 4, device="cpu", layout="features")
    assert xf.shape == (6, 4000) and xf.is_contiguous()
    assert torch.equal(ys, yf)  # same labels; the noise is drawn transposed
    for j in range(4):
        np.testing.assert_allclose(xf[:, yf == j].mean(1).numpy(),
                                   xs[ys == j].mean(0).numpy(), atol=0.15)
    xb, _ = make_blobs(5, 4000, 6, 4, device="cpu", layout="features",
                       dtype=torch.bfloat16)
    assert torch.equal(xb, xf.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown layout"):
        make_blobs(5, 10, 2, 2, device="cpu", layout="rows")


@pytest.mark.parametrize("layout", ["samples", "features"])
def test_jax_fit_in_either_layout_converts_and_predicts(layout):
    xt, c = _blobs(6, 2048, 5, 4)
    x = xt if layout == "features" else np.ascontiguousarray(xt.T)
    j = jkm.kmeans_fit(x, 5, init=c, max_iters=10, layout=layout)
    state = convert.kmeans_state_from_numpy(
        np.asarray(j.centroids), n_iter=int(j.n_iter), sse=float(j.sse),
        shift=float(j.shift), converged=bool(j.converged), device="cpu")
    got = tkm.kmeans_predict(xt.T, state.centroids, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jkm.kmeans_predict(xt.T, j.centroids)))
    back = convert.to_numpy(state)
    np.testing.assert_array_equal(back["centroids"], np.asarray(j.centroids))
    assert back["n_iter"] == int(j.n_iter)


# The CLIs. N is the fuzzy JAX kernel's block at K=15, d=5, so the fuzzy
# rows compare unpadded (module note); the Lloyd correction is exact.
CLI_N = jtall.tall_block_n(15, 5, temps=5)
CLI_FLAGS = ["--K=15", "--init=first_k", "--tol=-1", "--n_max_iters=4",
             "--seed=7"]


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    xt, _ = _blobs(8, CLI_N, 15, 5, spread=3.0)
    root = tmp_path_factory.mktemp("tall_cli")
    npy = _save(root / "points.npy", np.ascontiguousarray(xt.T))
    fm = str(root / "points.fm.npy")
    tloader.to_feature_major(npy, fm)
    return {"npy": npy, "fm": fm}


def _row(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def _cli_rows(tmp_path, flags):
    jlog, tlog = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jcli.main([*flags, f"--log_file={jlog}", "--n_GPUs=1",
                      "--cache_dir="]) == 0
    assert tcli.main([*flags, f"--log_file={tlog}", "--device", "cpu"]) == 0
    j, t = _row(jlog), _row(tlog)
    assert list(j) == list(t)
    np.testing.assert_allclose(float(t["sse"]), float(j["sse"]), rtol=RTOL)
    for col in set(j) - TIMING - {"sse"}:
        assert t[col] == j[col], col
    return t


@pytest.mark.parametrize("method", ["distributedKMeans",
                                    "distributedFuzzyCMeans"])
@pytest.mark.parametrize("file", ["fm", "npy"])
def test_cli_features_rows_agree(cli_files, tmp_path, file, method):
    t = _cli_rows(tmp_path, [f"--method_name={method}", *CLI_FLAGS,
                             "--layout=features",
                             f"--data_file={cli_files[file]}"])
    assert (t["kernel"], t["n_iter"], t["n_obs"], t["n_dim"]) == (
        "tall", "4", str(CLI_N), "5")


@pytest.mark.parametrize("file", ["fm", "npy"])
def test_cli_features_bf16_rows_agree(cli_files, tmp_path, file):
    # --dtype=bfloat16 casts the f32 file's columns, in both CLIs.
    t = _cli_rows(tmp_path, ["--method_name=distributedKMeans", *CLI_FLAGS,
                             "--layout=features", "--dtype=bfloat16",
                             f"--data_file={cli_files[file]}"])
    assert (t["kernel"], t["n_iter"]) == ("tall", "4")


@pytest.mark.parametrize("method", ["distributedKMeans",
                                    "distributedFuzzyCMeans"])
def test_cli_features_on_synthetic_data_runs_in_both(tmp_path, method):
    # The two CLIs draw different blobs from one seed, so only the row's
    # shape columns and `kernel` can agree.
    rows = []
    for cli, extra, name in ((jcli, ["--n_GPUs=1", "--cache_dir="], "j"),
                             (tcli, ["--device", "cpu"], "t")):
        log = tmp_path / f"{name}.csv"
        assert cli.main([f"--method_name={method}", "--n_obs=3000",
                         "--n_dim=5", "--K=4", "--layout=features",
                         "--n_max_iters=3", "--tol=-1", f"--log_file={log}",
                         *extra]) == 0
        rows.append(_row(log))
    for col in ("kernel", "n_obs", "n_dim", "n_iter", "status"):
        assert rows[0][col] == rows[1][col], col
    assert rows[1]["kernel"] == "tall"


def test_cli_layout_auto_runs_the_samples_layout(cli_files, tmp_path):
    t = _cli_rows(tmp_path, ["--method_name=distributedKMeans", *CLI_FLAGS,
                             "--layout=auto",
                             f"--data_file={cli_files['npy']}"])
    assert t["kernel"] == ""
    samples = tmp_path / "samples.csv"
    assert tcli.main(["--method_name=distributedKMeans", *CLI_FLAGS,
                      "--layout=samples", f"--data_file={cli_files['npy']}",
                      f"--log_file={samples}", "--device", "cpu"]) == 0
    assert _row(samples)["sse"] == t["sse"]


@pytest.mark.parametrize("flags", [
    ["--method_name=gaussianMixture"],
    ["--kernel=xla"],
    ["--kernel=pallas", "--method_name=distributedFuzzyCMeans"],
    ["--empty_policy=relocate"],
    ["--weight_file=WEIGHTS"],
])
def test_cli_features_parse_rejections_match_jax(tmp_path, capsys, flags):
    wfile = tmp_path / "w.npy"
    np.save(wfile, np.ones(64, np.float32))
    argv = ["--n_obs=64", "--n_dim=5", "--K=3", "--layout=features",
            *[f.replace("WEIGHTS", str(wfile)) for f in flags]]
    errors = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1]
                      .split("error: ", 1)[1])
    assert errors[0] == errors[1]
