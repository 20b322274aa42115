"""The port's fault points (`tdc_tpu_torch/testing/faults.py`) against the
JAX package's (`tdc_tpu/testing/faults.py`), on the CPU: one $TDC_FAULTS
string parses the same in both, the registries are equal, the same hit
sequence fires the same faults, and the port's wired points fire at their
sites (exact comparisons: the registry is data, not numbers).
"""

# The synthetic point names ('p', 'p.x', ...) test the machinery, not
# real sites: the registry cross-check does not apply to them.
# tdclint: disable-file=TDC005

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tdc_tpu_torch.testing import faults as tfaults

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from tdc_tpu.testing import faults as jfaults

    monkeypatch.delenv("TDC_FAULTS", raising=False)
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


def test_registry_and_constants_equal_the_jax_package():
    from tdc_tpu.testing import faults as jfaults

    assert tfaults.KNOWN_POINTS == jfaults.KNOWN_POINTS
    assert tfaults.CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE
    assert tfaults.ENV_VAR == jfaults.ENV_VAR == "TDC_FAULTS"
    assert sorted(tfaults.__all__) == sorted(jfaults.__all__)


@pytest.mark.parametrize("spec", [
    "ckpt.save.pre_replace=crash@2,stream.batch=delay:1.5@10,"
    "reduce.psum=raise:OSError,s.b=kill@3&attempt=0&pid=1",
    "p=delay:0@3+",
    "a=exit:7@4&process=2&zone=x, ,b=sigterm",
])
def test_specs_parse_as_in_the_jax_package(spec):
    from tdc_tpu.testing import faults as jfaults

    got = [tuple(vars(s).values()) for s in tfaults.parse_faults(spec)]
    want = [tuple(vars(s).values()) for s in jfaults.parse_faults(spec)]
    assert got == want and got


@pytest.mark.parametrize("bad", [
    "noequals", "p=unknownaction", "p=raise", "p=exit:notanint",
    "p=delay:xyz", "p=crash@0", "p=crash@x", "p=kill&badfilter",
])
def test_bad_specs_refused_in_the_jax_words(bad):
    from tdc_tpu.testing import faults as jfaults

    with pytest.raises(tfaults.FaultSpecError) as got:
        tfaults.parse_faults(bad)
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.parse_faults(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "p.x=raise:OSError@2", "p.x=raise:ValueError@2+",
    "p.x=raise:OSError@1&attempt=1", "p.x=raise:KeyError@3,p.x=raise:OSError@5",
])
def test_the_same_hits_fire_in_both_packages(spec, monkeypatch):
    from tdc_tpu.testing import faults as jfaults

    monkeypatch.setenv("TDC_FAULTS", spec)
    monkeypatch.setenv("TDC_ATTEMPT", "0")

    def fired(mod):
        out = []
        for _ in range(6):
            try:
                mod.fault_point("p.x")
                out.append(None)
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        return out, mod.hit_count("p.x")

    assert fired(tfaults) == fired(jfaults)


def test_unset_env_and_other_points(monkeypatch):
    tfaults.fault_point("anything")
    assert tfaults.hit_count("anything") == 0
    monkeypatch.setenv("TDC_FAULTS", "p.z=raise:OSError@1")
    tfaults.fault_point("other.point")
    assert tfaults.hit_count("p.z") == 0


def test_spec_change_reparses_and_resets_counts(monkeypatch):
    monkeypatch.setenv("TDC_FAULTS", "p.a=raise:OSError@5")
    tfaults.fault_point("p.a")
    monkeypatch.setenv("TDC_FAULTS", "p.a=raise:OSError@2")
    tfaults.fault_point("p.a")  # counter restarted with the new spec
    with pytest.raises(OSError):
        tfaults.fault_point("p.a")


def test_delay_and_bad_raise_target(monkeypatch):
    import time

    monkeypatch.setenv("TDC_FAULTS", "p.d=delay:0.05@1")
    t0 = time.perf_counter()
    tfaults.fault_point("p.d")
    assert time.perf_counter() - t0 >= 0.04
    monkeypatch.setenv("TDC_FAULTS", "p.r=raise:NotAnException")
    with pytest.raises(tfaults.FaultSpecError, match="not a builtin"):
        tfaults.fault_point("p.r")


@pytest.mark.parametrize("action,expected", [
    ("crash", tfaults.CRASH_EXIT_CODE), ("exit:7", 7), ("kill", -9),
])
def test_terminal_actions_in_a_subprocess(action, expected):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tdc_tpu_torch.testing import faults\n"
            "faults.fault_point('t.p')\n"
            "print('survived')\n" % str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "TDC_FAULTS": f"t.p={action}@1"},
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == expected, proc.stderr
    assert "survived" not in proc.stdout
    assert "fault_injected" in proc.stderr  # logged before dying


def test_wired_points_fire_at_their_sites(tmp_path, monkeypatch):
    """The points whose sites the port has: data.load, the checkpoint
    points, ckpt.restore.layout and stream.batch (the data.* and store.*
    points: tests/test_torch_ingest.py and test_torch_store.py)."""
    from tdc_tpu_torch.data import loader as tload
    from tdc_tpu_torch.models import streaming as tst
    from tdc_tpu_torch.utils import checkpoint as tck

    x = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    p = str(tmp_path / "x.npy")
    np.save(p, x)

    def fires(spec, fn, exc=OSError):
        monkeypatch.setenv("TDC_FAULTS", spec)
        tfaults.reset()
        with pytest.raises(exc, match="injected fault"):
            fn()
        monkeypatch.delenv("TDC_FAULTS")

    fires("data.load=raise:OSError", lambda: tload.load_points(p))
    state = tck.ClusterState(centroids=x[:2], n_iter=1, key=None,
                             batch_cursor=0, meta={"layout_n_devices": 1})
    ck = str(tmp_path / "ck")
    fires("ckpt.save.pre_replace=raise:OSError",
          lambda: tck.save_checkpoint(ck, state, step=1))
    # The interrupted save left no state.npz: the step is unreadable.
    tck.save_checkpoint(ck, state, step=2)
    fires("ckpt.restore=raise:OSError",
          lambda: tck.restore_checkpoint(ck, step=2))
    from tdc_tpu_torch.parallel import reshard

    fires("ckpt.restore.layout=raise:OSError",
          lambda: reshard.layout_from_meta(
              tck.restore_checkpoint(ck, step=2).meta))
    fires("stream.batch=raise:OSError@3",
          lambda: tst.streamed_kmeans_fit(
              tload.NpzStream(x, 16), 2, 3, init=x[:2], max_iters=1,
              device="cpu"))
    assert tfaults.hit_count("stream.batch") == 3
