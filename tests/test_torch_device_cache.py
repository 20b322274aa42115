"""The port's residency planner and device cache
(`tdc_tpu_torch/data/device_cache.py`) against the JAX package's
(`tdc_tpu/data/device_cache.py`), on the CPU.

Planner: over a grid of requests, geometries and budgets (the budget
injected into both packages), the same mode, reason, structlog events
(every field but the timestamps, pid and reserve_bytes), resident_bytes,
spill_bytes and spill_slots; each package's reserve_bytes follows its own
working-set model (the port's costs 16 bytes a row beside x, the JAX
package's 8), and the budgets of the grid are chosen where both models
decide alike. The ValueErrors are the JAX package's words. Builder: the
cache replays the stream's batches in order, exactly; a stream that breaks
its advertised geometry, or an out-of-memory error during the fill,
abandons the cache loudly and the fit streams on, bit for bit.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from tdc_tpu.data import batching as jbat
from tdc_tpu.data import device_cache as jdc
from tdc_tpu.data.loader import NpzStream as JStream
from tdc_tpu_torch.data import batching as tbat
from tdc_tpu_torch.data import device_cache as tdc
from tdc_tpu_torch.data.loader import NpzStream
from tdc_tpu_torch.models import streaming as tst

HINTS = (100_000, 256, 391)  # n_rows, batch_rows, n_batches


def _data(n=1003, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8, size=(8, d)).astype(np.float32)
    return (centers[rng.integers(0, 8, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _events(path):
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


@pytest.fixture
def runlog(tmp_path, monkeypatch):
    path = tmp_path / "runlog.jsonl"
    monkeypatch.setenv("TDC_RUNLOG", str(path))
    return path


def _plans(runlog, monkeypatch, budget, requested, hints, **kw):
    """(JAX plan, its events, port plan, its events) under one budget."""
    monkeypatch.setattr(jdc, "hbm_budget_bytes", lambda device=None: budget)
    monkeypatch.setattr(tdc, "planner_budget_bytes",
                        lambda device=None: budget)
    out = []
    for mod in (jdc, tdc):
        if runlog.exists():
            runlog.unlink()
        h = None if hints is None else mod.StreamHints(*hints)
        out += [mod.plan_residency(requested, hints=h, **kw),
                _events(runlog)]
    return out


def _comparable(events):
    drop = {"ts", "pid", "process_index", "reserve_bytes"}
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _reserve(mod_bat, plan, d, k, itemsize, kernel, n_devices, multiple):
    batch = -(-(-(-HINTS[1] // multiple) * multiple) // n_devices)
    return (batch * mod_bat.working_set_row_bytes(d, k, itemsize=itemsize,
                                                  kernel=kernel)
            + 6 * k * d * 4)


GEOMETRIES = {
    "plain": dict(d=8, k=8),
    "mesh4_bf16_pallas": dict(d=8, k=8, n_devices=4, pad_multiple=4,
                              itemsize=2, kernel="pallas"),
    "weighted_mesh2": dict(d=8, k=8, n_devices=2, pad_multiple=2,
                           weighted=True),
    "wide": dict(d=64, k=32, kernel="pallas"),
}


@pytest.mark.parametrize("requested", ["auto", "hbm", "spill"])
@pytest.mark.parametrize("budget", ["none", "ring_only", "all"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_planner_matches_jax(requested, budget, geometry, runlog,
                             monkeypatch):
    kw = dict(GEOMETRIES[geometry], label="t")
    if budget == "ring_only":
        # Past both packages' ring + reserve, short of both caches.
        probes = _plans(runlog, monkeypatch, 1 << 40, "spill", HINTS, **kw)
        jp, tp = probes[0], probes[2]
        budget_bytes = max(jp.spill_bytes + jp.reserve_bytes,
                           tp.spill_bytes + tp.reserve_bytes) + 1
        assert budget_bytes < min(jp.resident_bytes + jp.reserve_bytes,
                                  tp.resident_bytes + tp.reserve_bytes)
    else:
        budget_bytes = {"none": 10, "all": 1 << 40}[budget]
    jp, jev, tp, tev = _plans(runlog, monkeypatch, budget_bytes, requested,
                              HINTS, **kw)
    assert (tp.mode, tp.reason, tp.requested) == (jp.mode, jp.reason,
                                                  jp.requested)
    assert (tp.resident_bytes, tp.spill_bytes, tp.spill_slots,
            tp.budget_bytes) == (jp.resident_bytes, jp.spill_bytes,
                                 jp.spill_slots, jp.budget_bytes)
    assert _comparable(tev) == _comparable(jev)
    if tp.reserve_bytes:
        args = (kw["d"], kw["k"], kw.get("itemsize", 4),
                kw.get("kernel", "xla"), kw.get("n_devices", 1),
                kw.get("pad_multiple", 1))
        assert tp.reserve_bytes == _reserve(tbat, tp, *args)
        assert jp.reserve_bytes == _reserve(jbat, jp, *args)


@pytest.mark.parametrize("requested,kw", [
    ("stream", dict(hints=None)),
    ("auto", dict(hints=None)),
    ("spill", dict(hints=None)),
    ("auto", dict(hints=HINTS, cursor=2)),
    ("spill", dict(hints=HINTS, cursor=2)),
    ("hbm", dict(hints=HINTS, cursor=2)),
    ("auto", dict(hints=HINTS, mid_pass_ckpt=True)),
    ("spill", dict(hints=HINTS, mid_pass_ckpt=True)),
])
def test_planner_fallbacks_match_jax(requested, kw, runlog, monkeypatch):
    kw = dict(kw)
    hints = kw.pop("hints")
    jp, jev, tp, tev = _plans(runlog, monkeypatch, 1 << 40, requested,
                              hints, d=8, k=8, **kw)
    assert (tp.mode, tp.reason) == (jp.mode, jp.reason)
    assert _comparable(tev) == _comparable(jev)


@pytest.mark.parametrize("requested,kw", [
    ("hmb", dict(hints=HINTS)),
    ("hbm", dict(hints=None)),
    ("hbm", dict(hints=HINTS, mid_pass_ckpt=True)),
    ("hbm", dict(hints=None, mid_pass_ckpt=True)),
])
def test_planner_errors_in_the_jax_words(requested, kw):
    kw = dict(kw)
    hints = kw.pop("hints")
    msgs = []
    for mod in (jdc, tdc):
        h = None if hints is None else mod.StreamHints(*hints)
        dev = {} if mod is jdc else {"device": "cpu"}
        with pytest.raises(ValueError) as e:
            mod.plan_residency(requested, hints=h, d=8, k=8, **kw, **dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cpu_budget_is_the_jax_default():
    """On a CPU device the planner budgets the JAX package's 16 GiB
    default; the card's budget (`hbm_budget_bytes`) still raises there."""
    assert tbat.planner_budget_bytes("cpu") == jbat.hbm_budget_bytes() == (
        int(0.6 * (16 << 30)))
    plan = tdc.plan_residency("auto", hints=tdc.StreamHints(*HINTS), d=8,
                              k=8, device="cpu")
    assert plan.budget_bytes == tbat.planner_budget_bytes("cpu")
    with pytest.raises(ValueError, match="no device memory"):
        tbat.hbm_budget_bytes("cpu")


def test_rows_in_budget_subtracts_resident_bytes(monkeypatch):
    """The CLI's batch cap under a resident cache; auto_batch_size is
    rows_in_budget of the card's whole budget."""
    monkeypatch.setattr(tbat, "device_hbm_bytes",
                        lambda device=None: 80 << 30)
    budget = tbat.hbm_budget_bytes()
    free = tbat.rows_in_budget(budget, 128, 1024)
    assert free == tbat.auto_batch_size(128, 1024)
    half = tbat.rows_in_budget(budget, 128, 1024, resident_bytes=budget // 2)
    assert half < free and abs(half - free // 2) <= 1
    assert tbat.rows_in_budget(budget, 128, 1024,
                               resident_bytes=2 * budget) == 1
    assert tbat.rows_in_budget(budget, 128, 1024, kernel="pallas",
                               n_devices=2) == 2 * (budget // 528)


def test_stream_hints_and_itemsize_match_jax():
    x = _data(1000)
    bf = x.astype(ml_dtypes.bfloat16)
    v2 = bf.view(np.dtype("V2"))
    for got_mod, want_mod, s_got, s_want in (
            (tdc, jdc, NpzStream(x, 256), JStream(x, 256)),
            (tdc, jdc, NpzStream(v2, 256), JStream(bf, 256))):
        assert tuple(got_mod.stream_hints(s_got)) == tuple(
            want_mod.stream_hints(s_want))
        assert got_mod.stream_itemsize(s_got) == want_mod.stream_itemsize(
            s_want)
    t16 = NpzStream(torch.from_numpy(x).to(torch.bfloat16), 256)
    assert tdc.stream_itemsize(t16) == 2
    assert tdc.stream_hints(t16) == tdc.StreamHints(1000, 256, 4)
    sized = tdc.SizedBatches(lambda: iter(()), 1000, 256, itemsize=2)
    assert tdc.stream_itemsize(sized) == 2 and sized.num_batches == 4
    assert tdc.stream_hints(lambda: iter([x])) is None
    assert tdc.stream_itemsize(lambda: iter([x])) is None


def test_plan_1d_budgets_bf16_streams_at_their_own_itemsize():
    x = _data(1000)
    v2 = x.astype(ml_dtypes.bfloat16).view(np.dtype("V2"))
    kw = dict(weighted=False, kernel="xla", cursor=0, label="t",
              mid_pass_ckpt=False, device="cpu")
    f32, _ = tst._plan_1d_residency("auto", NpzStream(x, 256), 8, 8, None,
                                    **kw)
    bf16, builder = tst._plan_1d_residency("auto", NpzStream(v2, 256), 8, 8,
                                           None, **kw)
    assert f32.resident_bytes == 1000 * 8 * 4
    assert bf16.resident_bytes == 1000 * 8 * 2
    assert builder is not None and builder.n_batches == 4
    assert tst._plan_1d_residency("stream", NpzStream(x, 256), 8, 8, None,
                                  **kw) == (None, None)


# ---------------------------------------------------------------------------
# The builder
# ---------------------------------------------------------------------------


def _add(builder, rows, weights=None):
    xb = torch.from_numpy(np.ascontiguousarray(rows))
    builder.add(xb, xb.shape[0],
                None if weights is None else torch.from_numpy(weights))


def test_fill_and_scan_replays_stream_order():
    x = _data(700, d=4)
    w = np.linspace(0.5, 2.0, 700, dtype=np.float32)
    b = tdc.DeviceCacheBuilder(3, weighted=True)
    for i in range(0, 700, 256):
        _add(b, x[i:i + 256], w[i:i + 256])
    cache = b.finish()
    assert cache is not None and cache.n_batches == 3
    assert cache.stacked.shape == (2, 256, 4) and cache.tail.shape == (188, 4)
    assert (cache.nv_full, cache.nv_tail) == (256, 188)
    seen = tdc.scan_cache([], cache, lambda a, xb, wb, nv: a + [(xb, wb)],
                          True)
    assert all(xb.is_contiguous() for xb, _ in seen)
    np.testing.assert_array_equal(
        torch.cat([xb for xb, _ in seen]).numpy(), x)
    np.testing.assert_array_equal(
        torch.cat([wb for _, wb in seen]).numpy(), w)
    assert tdc.cache_pad_rows(cache) == 0


def test_cache_pad_rows_counts_the_rank_slices_padding():
    b = tdc.DeviceCacheBuilder(3)
    for n_valid, rows in ((75, 75), (75, 75), (54, 55)):
        b.add(torch.zeros((rows, 2)), n_valid)
    assert tdc.cache_pad_rows(b.finish()) == 1
    b = tdc.DeviceCacheBuilder(2)
    for n_valid in (74, 55):
        b.add(torch.zeros((75 if n_valid == 74 else 56, 2)), n_valid)
    assert tdc.cache_pad_rows(b.finish()) == 2


@pytest.mark.parametrize("batches,n,reason", [
    ([256, 144, 256, 44], 4, "batch_geometry_mismatch"),
    ([128, 128, 128, 128], 2, "more_batches_than_advertised"),
    ([128], 3, "fewer_batches_than_advertised"),
])
def test_geometry_surprises_abandon_loudly(batches, n, reason, runlog):
    x = _data(sum(batches), d=4)
    b = tdc.DeviceCacheBuilder(n)
    at = 0
    for rows in batches:
        _add(b, x[at:at + rows])
        at += rows
    assert b.finish() is None and b.abandoned == reason
    ev = [e for e in _events(runlog)
          if e["event"] == "residency_cache_abandoned"]
    assert [e["reason"] for e in ev] == [reason]


def test_tail_width_and_weight_stream_mismatches_abandon():
    b = tdc.DeviceCacheBuilder(2)
    b.add(torch.zeros((4, 3)), 4)
    b.add(torch.zeros((2, 5)), 2)
    assert b.abandoned == "tail_feature_width_mismatch"
    b = tdc.DeviceCacheBuilder(2, weighted=True)
    b.add(torch.zeros((4, 3)), 4)
    assert b.abandoned == "weight_stream_mismatch"


def _sized(x, rows, gen=None):
    def batches():
        for i in range(0, x.shape[0], rows):
            yield x[i:i + rows]

    return tdc.SizedBatches(gen or batches, x.shape[0], rows)


def test_abandoned_fit_still_streams_bit_for_bit(runlog):
    """A stream that breaks its advertised geometry: the cache is dropped
    mid-pass and every iteration streams (tests/test_resident.py's
    test_abandoned_fit_still_streams_correctly)."""
    x = _data(600, d=4)

    def lying():
        yield x[:300]
        yield x[300:500]
        yield x[500:]

    batches = _sized(x, 300, lying)
    kw = dict(init=x[:4], max_iters=5, tol=1e-6, device="cpu")
    got = tst.streamed_kmeans_fit(batches, 4, 4, residency="hbm", **kw)
    want = tst.streamed_kmeans_fit(batches, 4, 4, residency="stream", **kw)
    assert torch.equal(got.centroids, want.centroids)
    assert got.n_iter == want.n_iter and float(got.sse) == float(want.sse)
    assert any(e["event"] == "residency_cache_abandoned"
               for e in _events(runlog))


def test_out_of_memory_during_the_fill_abandons_and_streams(runlog,
                                                            monkeypatch):
    """A CUDA out-of-memory error while the cache is allocated: the fit
    frees it, says so and streams on, bit for bit."""
    x = _data(1003)
    released = []

    def no_room(t, n):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(tdc, "_stacked_like", no_room)
    monkeypatch.setattr(tdc, "release_device_memory",
                        lambda: released.append(True))
    kw = dict(init=x[:8], max_iters=4, tol=-1.0, device="cpu")
    got = tst.streamed_kmeans_fit(NpzStream(x, 256), 8, 8, residency="hbm",
                                  **kw)
    want = tst.streamed_kmeans_fit(NpzStream(x, 256), 8, 8, **kw)
    assert torch.equal(got.centroids, want.centroids)
    assert np.array_equal(got.history, want.history)
    ev = [e for e in _events(runlog)
          if e["event"] == "residency_cache_abandoned"]
    assert [e["reason"] for e in ev] == ["hbm_oom_during_fill"]
    assert released == [True]


def test_builder_keeps_other_errors(monkeypatch):
    def broken(t, n):
        raise RuntimeError("not an out-of-memory error")

    monkeypatch.setattr(tdc, "_stacked_like", broken)
    with pytest.raises(RuntimeError, match="not an out-of-memory"):
        tdc.DeviceCacheBuilder(2).add(torch.zeros((4, 3)), 4)


def test_residency_modes_moved_to_the_cache_module():
    assert tdc.RESIDENCY_MODES == jdc.RESIDENCY_MODES
    assert tst.RESIDENCY_MODES is tdc.RESIDENCY_MODES
    assert tdc.state_reserve_bytes(1024, 128) == jdc.state_reserve_bytes(
        1024, 128)
