"""The port's CLI against the JAX package's on the same .npz, on the CPU,
for distributedKMeans and distributedFuzzyCMeans.

Both write one CSV row; they must agree on every column except the
timings, `backend` and `points_per_sec_per_chip`, with `sse` within rtol
1e-5 (float32 summation order).
"""

import csv

import numpy as np
import pytest

from tdc_tpu.cli import main as jcli
from tdc_tpu_torch.cli import main as tcli

FLAGS = ["--method_name=distributedKMeans", "--K=40", "--init=first_k",
         "--tol=-1", "--kernel=pallas", "--n_max_iters=5", "--seed=7"]
FUZZY_FLAGS = ["--method_name=distributedFuzzyCMeans", "--fuzzifier=2.0",
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


def _rows_agree(npz, tmp_path, flags):
    jlog, tlog = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jcli.main([*flags, f"--data_file={npz}", f"--log_file={jlog}",
                      "--n_GPUs=1", "--cache_dir="]) == 0
    assert tcli.main([*flags, f"--data_file={npz}", f"--log_file={tlog}",
                      "--device", "cpu"]) == 0
    j, t = _row(jlog), _row(tlog)
    assert list(j) == list(t)  # same schema, same column order
    assert (t["kernel"], t["n_iter"], t["status"]) == ("pallas", "5", "ok")
    assert t["backend"] == "cpu"
    np.testing.assert_allclose(float(t["sse"]), float(j["sse"]), rtol=1e-5)
    for col in set(j) - TIMING - {"sse"}:
        assert t[col] == j[col], col


def test_cli_rows_agree(npz, tmp_path):
    _rows_agree(npz, tmp_path, FLAGS)


def test_cli_rows_agree_fuzzy(npz, tmp_path):
    # `sse` holds the objective J_m in both CLIs' fuzzy rows.
    _rows_agree(npz, tmp_path, FUZZY_FLAGS)


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
    ["--method_name=gaussianMixture"],
    ["--n_GPUs=2"],
    ["--dtype=bfloat16"],
])
def test_cli_unported_flags_name_the_roadmap(npz, flags, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--K=4", f"--data_file={npz}", *flags])
    assert exc.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
