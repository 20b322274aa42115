"""The port's CLI against the JAX package's on the same .npz, on the CPU,
for distributedKMeans, distributedFuzzyCMeans, gaussianMixture and
bisectingKMeans (k-means++ pinned in both packages), --minibatch and
--init=kmeans_parallel (the JAX CLI's draws fed to the port), with and
without a shared --weight_file, and on bfloat16 data files (.npy and
.npz, as ml_dtypes arrays store them) under --dtype float32 and bfloat16.
The JAX CLI's checks of these flags give the same words in both.

Both write one CSV row; they must agree on every column except the
timings, `backend` and `points_per_sec_per_chip`, with `sse` within rtol
1e-5 (float32 summation order; a gaussianMixture row's `sse` is the mean
log-likelihood). So must the rows of two ranks (gloo on the CPU) and of
the JAX CLI on two devices, for the K-sharded fuzzy tower (--shard_k=2)
and data-parallel K-Means.
"""

import csv
import multiprocessing as mp
import queue as queue_lib
import time
import traceback

import ml_dtypes
import numpy as np
import pytest

from tdc_tpu.cli import main as jcli
from tdc_tpu_torch.cli import main as tcli

FLAGS = ["--method_name=distributedKMeans", "--K=40", "--init=first_k",
         "--tol=-1", "--kernel=pallas", "--n_max_iters=5", "--seed=7"]
FUZZY_FLAGS = ["--method_name=distributedFuzzyCMeans", "--fuzzifier=2.0",
               *FLAGS[1:]]
GMM_FLAGS = ["--method_name=gaussianMixture", "--covariance_type=diag",
             *FLAGS[1:]]
TIMING = {"setup_time", "initialization_time", "computation_time",
          "backend", "points_per_sec_per_chip"}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    rng = np.random.default_rng(0)
    centers = rng.uniform(-3, 3, size=(40, 20))
    y = rng.integers(0, 40, size=3000)
    x = (centers[y] + rng.normal(size=(3000, 20))).astype(np.float32)
    path = tmp_path_factory.mktemp("cli") / "data.npz"
    np.savez(path, X=x, Y=y)
    return str(path)


def _row(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    rng = np.random.default_rng(1)
    w = rng.uniform(0, 3, size=3000).astype(np.float32)
    w[rng.choice(3000, 100, replace=False)] = 0.0
    path = tmp_path_factory.mktemp("cli") / "w.npy"
    np.save(path, w)
    return str(path)


def _rows_agree(npz, tmp_path, flags, kernel="pallas"):
    jlog, tlog = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jcli.main([*flags, f"--data_file={npz}", f"--log_file={jlog}",
                      "--n_GPUs=1", "--cache_dir="]) == 0
    assert tcli.main([*flags, f"--data_file={npz}", f"--log_file={tlog}",
                      "--device", "cpu"]) == 0
    j, t = _row(jlog), _row(tlog)
    assert list(j) == list(t)  # same schema, same column order
    assert (t["kernel"], t["n_iter"], t["status"]) == (kernel, "5", "ok")
    assert t["backend"] == "cpu"
    np.testing.assert_allclose(float(t["sse"]), float(j["sse"]), rtol=1e-5)
    for col in set(j) - TIMING - {"sse"}:
        assert t[col] == j[col], col


def test_cli_rows_agree(npz, tmp_path):
    _rows_agree(npz, tmp_path, FLAGS)


def test_cli_rows_agree_fuzzy(npz, tmp_path):
    # `sse` holds the objective J_m in both CLIs' fuzzy rows.
    _rows_agree(npz, tmp_path, FUZZY_FLAGS)


def test_cli_rows_agree_weighted(npz, weights, tmp_path):
    # The weighted kernel route (B4's plain version on the CPU) against
    # the JAX CLI's interpret-mode weighted fused kernel.
    _rows_agree(npz, tmp_path, [*FLAGS, f"--weight_file={weights}"])


def test_cli_rows_agree_fuzzy_weighted(npz, weights, tmp_path):
    flags = [f for f in FUZZY_FLAGS if f != "--kernel=pallas"]
    _rows_agree(npz, tmp_path, [*flags, "--kernel=xla",
                                f"--weight_file={weights}"], kernel="xla")


@pytest.fixture(scope="module")
def bf16_files(npz, tmp_path_factory):
    """The npz fixture's points as ml_dtypes bfloat16, saved with np.save
    and np.savez (numpy stores them as unstructured '|V2')."""
    with np.load(npz) as z:
        x, y = z["X"].astype(ml_dtypes.bfloat16), z["Y"]
    root = tmp_path_factory.mktemp("bf16")
    np.save(root / "x.npy", x)
    np.savez(root / "x.npz", X=x, Y=y)
    assert np.load(root / "x.npy").dtype == np.dtype("V2")
    return {"npy": str(root / "x.npy"), "npz": str(root / "x.npz")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["npy", "npz"])
def test_cli_rows_agree_bf16_file(bf16_files, kind, dtype, tmp_path):
    # A bf16 file stays bf16 under either --dtype in both CLIs, so the
    # kernel route runs B5's plain version against the JAX CLI's
    # interpret-mode fused kernel on bf16 inputs.
    _rows_agree(bf16_files[kind], tmp_path, [*FLAGS, f"--dtype={dtype}"])


@pytest.mark.parametrize("kernel", ["xla", "pallas_bf16"])
def test_cli_rows_agree_bf16(npz, kernel, tmp_path):
    # xla: f32 points cast to bf16 on the device, promoted by the plain
    # stats; pallas_bf16: f32 points, B5's bf16 cross operands.
    flags = [f for f in FLAGS if f != "--kernel=pallas"]
    dtype = "bfloat16" if kernel == "xla" else "float32"
    _rows_agree(npz, tmp_path, [*flags, f"--kernel={kernel}",
                                f"--dtype={dtype}"], kernel=kernel)


def test_cli_rows_agree_gmm(npz, tmp_path):
    # The E-step kernel route (B9's plain version on the CPU) against the
    # JAX CLI's interpret-mode fused E-step.
    _rows_agree(npz, tmp_path, GMM_FLAGS)


def test_cli_rows_agree_gmm_weighted(npz, weights, tmp_path):
    flags = [f for f in GMM_FLAGS if f not in ("--kernel=pallas",
                                               "--covariance_type=diag")]
    _rows_agree(npz, tmp_path, [*flags, "--kernel=xla",
                                "--covariance_type=spherical",
                                f"--weight_file={weights}"], kernel="xla")


@pytest.mark.parametrize("flags,message", [
    (["--method_name=gaussianMixture", "--kernel=pallas",
      "--covariance_type=tied"], "diag/spherical, unweighted"),
    (["--method_name=gaussianMixture", "--kernel=pallas",
      "--covariance_type=full"], "diag/spherical, unweighted"),
    (["--method_name=gaussianMixture", "--spherical"],
     "distributedKMeans only"),
    (["--method_name=gaussianMixture", "--kernel=refined"],
     "distributedKMeans only"),
    (["--init=kmeans"], "gaussianMixture seeding mode"),
    (["--method_name=distributedFuzzyCMeans", "--covariance_type=full"],
     "gaussianMixture only"),
])
def test_cli_gmm_rejections(npz, flags, message, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", f"--data_file={npz}", *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("flags,message", [
    (["--method_name=gaussianMixture", "--kernel=pallas"],
     "diag/spherical, unweighted"),
    (["--method_name=distributedFuzzyCMeans", "--kernel=pallas"],
     "distributedKMeans only"),
    (["--kernel=refined"], "refined"),
    (["--kernel=pallas_bf16"], "does not support --weight_file"),
])
def test_cli_weight_file_rejections(npz, weights, flags, message, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", f"--data_file={npz}",
                   f"--weight_file={weights}", *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("method", ["distributedFuzzyCMeans",
                                    "gaussianMixture"])
def test_cli_pallas_bf16_is_kmeans_only(npz, method, capsys):
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--K=4", f"--data_file={npz}", "--kernel=pallas_bf16",
                      f"--method_name={method}"])
        assert exc.value.code == 2
        assert "distributedKMeans only" in capsys.readouterr().err


def test_cli_missing_or_misshapen_weight_file(npz, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", f"--data_file={npz}",
                   f"--weight_file={tmp_path / 'none.npy'}"])
    assert exc.value.code == 2
    assert "does not exist" in capsys.readouterr().err
    bad = tmp_path / "w2.npy"
    np.save(bad, np.ones((10, 2), np.float32))
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", "--n_obs=10", "--n_dim=3", f"--weight_file={bad}"])
    assert exc.value.code == 2
    assert "expected (10,)" in capsys.readouterr().err


def test_cli_default_device_fails_without_a_card(npz, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    log = tmp_path / "err.csv"
    assert tcli.main([*FLAGS, f"--data_file={npz}",
                      f"--log_file={log}"]) == 1
    row = _row(log)
    assert row["status"] == "error:RuntimeError"
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--shard_k=2"],
])
def test_cli_unported_flags_name_the_roadmap(npz, flags, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", f"--data_file={npz}", *flags])
    assert exc.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def _pin_kmeanspp(monkeypatch):
    """Both packages' k-means++ pinned to the same function of its inputs
    (tests/test_torch_bisecting.py), so every bisecting split starts
    alike."""
    from test_torch_bisecting import pin_jax, pin_port

    from tdc_tpu.models import kmeans as jkm
    from tdc_tpu_torch.models import kmeans as tkm

    monkeypatch.setattr(jkm, "init_kmeans_pp", pin_jax)
    monkeypatch.setattr(tkm, "init_kmeans_pp", pin_port)


def _inject_kmeans_parallel(monkeypatch, n, k, seed=7):
    """The port's k-means‖ fed the JAX CLI's draws (its key is
    PRNGKey(--seed), handed to init_kmeans_parallel as it is)."""
    import jax

    from test_torch_kmeans_parallel import JaxDraws, inject

    inject(monkeypatch, JaxDraws(jax.random.PRNGKey(seed), n, k))


def _rows_match(npz, tmp_path, flags):
    """Both CLIs on the same file: every column equal but the timings and
    `sse` (rtol 1e-5). Returns the port's row."""
    jlog, tlog = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jcli.main([*flags, f"--data_file={npz}", f"--log_file={jlog}",
                      "--n_GPUs=1", "--cache_dir="]) == 0
    assert tcli.main([*flags, f"--data_file={npz}", f"--log_file={tlog}",
                      "--device", "cpu"]) == 0
    j, t = _row(jlog), _row(tlog)
    assert list(j) == list(t) and t["status"] == "ok"
    np.testing.assert_allclose(float(t["sse"]), float(j["sse"]), rtol=1e-5)
    for col in set(j) - TIMING - {"sse"}:
        assert t[col] == j[col], col
    return t


@pytest.mark.parametrize("flags", [
    ["--method_name=bisectingKMeans"],
    ["--init=kmeans_parallel"],
])
def test_cli_retired_refusals_now_agree_with_jax(npz, tmp_path, flags,
                                                 monkeypatch):
    # Both raised a parse error naming the ROADMAP (A8) before bisecting
    # and k-means‖ were ported. Now: the same options give the JAX CLI's
    # row (k-means++ pinned in both packages for the splits; the JAX
    # draws for k-means‖).
    _pin_kmeanspp(monkeypatch)
    _inject_kmeans_parallel(monkeypatch, 3000, 4)
    _rows_match(npz, tmp_path, ["--K=4", "--n_max_iters=5", "--seed=7",
                                *flags])


@pytest.mark.parametrize("flags", [
    ["--method_name=bisectingKMeans", "--K=12", "--n_max_iters=10"],
    ["--method_name=bisectingKMeans", "--K=12", "--n_max_iters=10",
     "WEIGHTS"],
    ["--method_name=bisectingKMeans", "--K=12", "--n_max_iters=10",
     "--num_batches=3"],
    ["--method_name=bisectingKMeans", "--K=12", "--n_max_iters=10",
     "--streamed", "WEIGHTS"],
], ids=["in_memory", "weighted", "streamed", "streamed_weighted"])
def test_cli_bisecting_rows_agree(npz, weights, tmp_path, flags,
                                  monkeypatch):
    _pin_kmeanspp(monkeypatch)
    flags = [f"--weight_file={weights}" if f == "WEIGHTS" else f
             for f in flags]
    t = _rows_match(npz, tmp_path, ["--seed=7", "--tol=1e-4", *flags])
    assert t["method_name"] == "bisectingKMeans" and int(t["n_iter"]) >= 11


@pytest.mark.parametrize("flags", [
    ["--kernel=xla", "--num_batches=4"],
    ["--kernel=pallas", "--num_batches=4"],
    ["--kernel=pallas", "--num_batches=3", "--reassignment_ratio=0"],
    ["--kernel=xla"],  # one batch: the whole set (no device memory)
    ["--kernel=xla", "--num_batches=5", "--init=kmeans_parallel"],
], ids=["xla", "pallas", "pallas_no_reassign", "one_batch", "kmeans_par"])
def test_cli_minibatch_rows_agree(npz, tmp_path, flags, monkeypatch):
    # The reassignment's uniforms: the JAX CLI's (its MiniBatchKMeans
    # splits PRNGKey(--seed) into an init key and a step key), from the
    # start in each of the two fits.
    import jax

    from test_torch_minibatch import JaxUniforms

    from tdc_tpu_torch import models as tmodels
    from tdc_tpu_torch.models import minibatch as tmb

    init_key, step_key = jax.random.split(jax.random.PRNGKey(7))
    real = tmodels.minibatch_kmeans_fit

    def fed(*args, **kwargs):
        monkeypatch.setattr(tmb, "_uniforms", JaxUniforms(step_key))
        return real(*args, **kwargs)

    monkeypatch.setattr(tmodels, "minibatch_kmeans_fit", fed)
    rows = -(-3000 // int(next((f.split("=")[1] for f in flags
                                if f.startswith("--num_batches")), 1)))
    # --init=kmeans_parallel seeds on the first batch with the init key.
    from test_torch_kmeans_parallel import JaxDraws, inject

    inject(monkeypatch, JaxDraws(init_key, rows, 40))
    t = _rows_match(npz, tmp_path, ["--K=40", "--n_max_iters=4",
                                    "--tol=-1", "--seed=7", "--minibatch",
                                    "--init=first_k", *flags])
    assert t["n_iter"] == "4"


@pytest.mark.parametrize("flags", [
    ["--method_name=distributedFuzzyCMeans"],
    ["--method_name=gaussianMixture", "--kernel=pallas"],
    ["--num_batches=3", "--kernel=pallas"],
])
def test_cli_kmeans_parallel_rows_agree(npz, tmp_path, flags, monkeypatch):
    n = 3000 if "--num_batches=3" not in flags else 1000  # the first batch
    _inject_kmeans_parallel(monkeypatch, n, 40)
    _rows_match(npz, tmp_path, ["--K=40", "--n_max_iters=5", "--tol=-1",
                                "--seed=7", "--init=kmeans_parallel",
                                *flags])


@pytest.mark.parametrize("flags", [
    ["--minibatch", "--method_name=distributedFuzzyCMeans"],
    ["--minibatch", "--shard_k=2", "--n_GPUs=2"],
    ["--minibatch", "--mean_combine"],
    ["--minibatch", "--empty_policy=relocate"],
    ["--minibatch", "--kernel=refined"],
    ["--minibatch", "--kernel=pallas_bf16"],
    ["--minibatch", "--layout=features"],
    ["--minibatch", "WEIGHTS"],
    ["--reassignment_ratio=0.5"],
    ["--minibatch", "--reassignment_ratio=1.5"],
    ["--method_name=bisectingKMeans", "--spherical"],
    ["--method_name=bisectingKMeans", "--mean_combine"],
    ["--method_name=bisectingKMeans", "--kernel=xla"],
    ["--method_name=bisectingKMeans", "--init=first_k"],
    ["--method_name=bisectingKMeans", "--history_file=h.csv"],
])
def test_cli_checks_in_the_jax_words(npz, weights, flags, capsys):
    flags = [f"--weight_file={weights}" if f == "WEIGHTS" else f
             for f in flags]
    words = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--K=4", f"--data_file={npz}", *flags])
        assert exc.value.code == 2
        words.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert words[1].split("error: ")[1] == words[0].split("error: ")[1]


# Several ranks: two gloo ranks on the CPU, each a spawned process that
# joins through a file:// store and calls the port's CLI, which runs in
# the process group it finds. Rank 0 alone writes the row.

def _cli_rank(rank, world, init_method, runs, queue):
    import torch

    from tdc_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    try:
        multihost.initialize_distributed(init_method, world, rank,
                                         device="cpu")
        queue.put((rank, [tcli.main(argv) for argv in runs]))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        multihost.shutdown()


def _cli_on_ranks(tmp_path, runs, world=2, timeout=240):
    """Each rank runs the CLI once per argv in `runs`; returns rank 0's
    exit codes (every rank's must agree)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=_cli_rank,
                         args=(r, world, init, runs, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:  # drain before joining
            try:
                rank, out = queue.get(timeout=2)
                got[rank] = out
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
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
        if isinstance(got.get(rank), str):
            pytest.fail(f"rank {rank} failed:\n{got[rank]}")
    assert all(got[r] == got[0] for r in range(world))
    return got[0]


def test_cli_rows_agree_on_two_ranks(npz, tmp_path):
    """The K-sharded fuzzy row (--shard_k=2: a (1, 2) grid, B7 + B8's
    plain versions) and the data-parallel K-Means row on two ranks against
    the JAX CLI's rows on 2 devices; then synthetic points from --seed on
    two ranks (the fit refuses points that differ between ranks) against
    the port's single-rank row."""
    sharded = [*FUZZY_FLAGS, "--shard_k=2"]
    synth = ["--method_name=distributedKMeans", "--n_obs=2000",
             "--n_dim=4", "--K=8", "--init=first_k", "--tol=-1",
             "--n_max_iters=5", "--seed=3", "--kernel=pallas"]
    logs = {name: tmp_path / f"{name}.csv"
            for name in ("sharded", "dp", "synth", "synth1")}
    runs = [[*sharded, f"--data_file={npz}", "--n_GPUs=2", "--device=cpu",
             f"--log_file={logs['sharded']}"],
            [*FLAGS, f"--data_file={npz}", "--n_GPUs=2", "--device=cpu",
             f"--log_file={logs['dp']}"],
            [*synth, "--n_GPUs=2", "--device=cpu",
             f"--log_file={logs['synth']}"]]
    assert _cli_on_ranks(tmp_path, runs) == [0, 0, 0]
    for flags, name in ((sharded, "sharded"), (FLAGS, "dp")):
        jlog = tmp_path / f"jax_{name}.csv"
        assert jcli.main([*flags, f"--data_file={npz}", f"--log_file={jlog}",
                          "--n_GPUs=2", "--cache_dir="]) == 0
        j, t = _row(jlog), _row(logs[name])
        assert list(j) == list(t)
        assert (t["num_GPUs"], t["n_chips"], t["n_iter"], t["status"],
                t["backend"]) == ("2", "2", "5", "ok", "cpu")
        np.testing.assert_allclose(float(t["sse"]), float(j["sse"]),
                                   rtol=1e-5)
        for col in set(j) - TIMING - {"sse"}:
            assert t[col] == j[col], col
    assert tcli.main([*synth, "--device=cpu",
                      f"--log_file={logs['synth1']}"]) == 0
    two, one = _row(logs["synth"]), _row(logs["synth1"])
    assert (two["num_GPUs"], one["num_GPUs"]) == ("2", "1")
    assert two["n_iter"] == one["n_iter"] == "5"
    np.testing.assert_allclose(float(two["sse"]), float(one["sse"]),
                               rtol=1e-5)


@pytest.mark.parametrize("flags, words", [
    (["--shard_k=2"], "A7 and A9); in memory, call "
     "tdc_tpu_torch.parallel.kmeans_fit_sharded"),
    (["--shard_k=2", "--method_name=gaussianMixture"], "A9"),
    (["--shard_k=3", "--method_name=distributedFuzzyCMeans"],
     "not divisible by --shard_k=3"),
    (["--n_GPUs=2"], "torchrun --nproc_per_node=2"),
    (["--n_GPUs=2", "--method_name=distributedFuzzyCMeans",
      "--shard_k=2"], "torchrun --nproc_per_node=2"),
    (["--method_name=distributedFuzzyCMeans", "--shard_k=2",
      "--num_batches=4"], "streamed K-sharded towers of A9"),
    (["--streamed", "--reduce=per_pass:int8", "--n_GPUs=2"],
     "torchrun --nproc_per_node=2"),
    (["--method_name=gaussianMixture", "--kernel=pallas", "--n_GPUs=2"],
     "--kernel=pallas gaussianMixture is single-device"),
])
def test_cli_multi_gpu_rejections(npz, flags, words, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", f"--data_file={npz}", *flags])
    assert exc.value.code == 2
    assert words in capsys.readouterr().err


# ---------------------------------------------------------------------------
# --residency (the streamed kmeans/fuzzy fits' device cache and spill ring)
# ---------------------------------------------------------------------------

RESIDENCY_FLAGS = ["--K=40", "--init=first_k", "--tol=-1", "--kernel=xla",
                   "--n_max_iters=5", "--seed=7", "--num_batches=3"]


@pytest.mark.parametrize("residency", ["hbm", "spill", "auto"])
@pytest.mark.parametrize("method", ["distributedKMeans",
                                    "distributedFuzzyCMeans"])
def test_cli_residency_rows_agree(npz, tmp_path, method, residency):
    """The JAX CLI's row within the f32 tolerance, and the port's own
    --residency=stream row to the last digit."""
    flags = [f"--method_name={method}", *RESIDENCY_FLAGS]
    _rows_agree(npz, tmp_path, [*flags, f"--residency={residency}"],
                kernel="xla")
    log = tmp_path / "stream.csv"
    assert tcli.main([*flags, f"--data_file={npz}", f"--log_file={log}",
                      "--device", "cpu"]) == 0
    streamed, resident = _row(log), _row(tmp_path / "port.csv")
    assert (resident["sse"], resident["n_iter"]) == (streamed["sse"],
                                                     streamed["n_iter"])


@pytest.mark.parametrize("flags", [
    ["--residency=hbm"],
    ["--residency=auto", "--mean_combine", "--num_batches=2"],
    ["--residency=spill", "--minibatch", "--num_batches=2"],
    ["--residency=hbm", "--method_name=bisectingKMeans", "--num_batches=2"],
    ["--residency=hbm", "--method_name=gaussianMixture", "--num_batches=2"],
    ["--residency=hbm", "--num_batches=2", "--ckpt_dir=ck",
     "--ckpt_every_batches=1"],
])
def test_cli_residency_refusals_in_the_jax_words(npz, flags, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    words = []
    for cli, extra in ((jcli, ["--n_GPUs=1", "--cache_dir="]),
                       (tcli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--K=4", f"--data_file={npz}", *flags, *extra])
        words.append(str(exc.value))
    assert words[0] == words[1]
    assert "--residency" in words[1]


def test_cli_residency_with_shard_k_names_a9(npz, tmp_path, capsys):
    log = tmp_path / "log.csv"
    assert tcli.main(["--method_name=distributedFuzzyCMeans", "--K=4",
                      "--shard_k=2", "--residency=hbm",
                      f"--data_file={npz}", f"--log_file={log}",
                      "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "NotImplementedError" in err and "Queue A, A9" in err
    assert _row(log)["status"] == "error:NotImplementedError"


def test_cli_residency_caps_the_batch_rows(npz, tmp_path, monkeypatch):
    """--residency=auto with a cache that leaves the batches 500 rows of
    working set: the rows are capped (a `residency_batch_cap` event), the
    fit goes resident, and it is the streamed fit on 500-row batches."""
    import json

    from tdc_tpu_torch.data import batching as tbat
    from tdc_tpu_torch.data import device_cache as tdc

    pinned = 3000 * 20 * 4 + tdc.state_reserve_bytes(40, 20)
    budget = pinned + 500 * tbat.working_set_row_bytes(20, 40)
    for mod in (tbat, tdc):
        monkeypatch.setattr(mod, "planner_budget_bytes",
                            lambda device=None: budget)
    runlog = tmp_path / "run.jsonl"
    monkeypatch.setenv("TDC_RUNLOG", str(runlog))
    flags = ["--method_name=distributedKMeans", *RESIDENCY_FLAGS[:-1],
             f"--data_file={npz}", "--device", "cpu"]
    assert tcli.main([*flags, "--num_batches=2", "--residency=auto",
                      f"--log_file={tmp_path / 'auto.csv'}"]) == 0
    events = [json.loads(line) for line in runlog.read_text().splitlines()]
    caps = [e for e in events if e["event"] == "residency_batch_cap"]
    assert caps and (caps[0]["rows"], caps[0]["cap"],
                     caps[0]["resident_bytes"]) == (1500, 500, pinned)
    assert not [e for e in events if e["event"] == "residency_fallback"]
    assert tcli.main([*flags, "--num_batches=6",
                      f"--log_file={tmp_path / 'stream.csv'}"]) == 0
    assert _row(tmp_path / "auto.csv")["sse"] == _row(
        tmp_path / "stream.csv")["sse"]
