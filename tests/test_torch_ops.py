"""Parity of the port's plain ops (tdc_tpu_torch.ops.distance / assign /
init) with the JAX package, on the CPU.

Inputs come from np.random.default_rng and go to both packages as numpy.
Tolerances: labels equal; counts exactly equal; distances, sums and SSE
within rtol 1e-5 plus an atol of 1e-5 of the operands' squared-norm scale
(float32, different summation order in the two frameworks' matmuls).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_tpu.ops import assign as jassign
from tdc_tpu.ops import distance as jdist
from tdc_tpu.ops import init as jinit
from tdc_tpu_torch.ops import assign as tassign
from tdc_tpu_torch.ops import distance as tdist
from tdc_tpu_torch.ops import init as tinit

RTOL = 1e-5


def _data(seed, n=500, k=17, d=11, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) + offset).astype(np.float32)
    c = (x[rng.choice(n, k, replace=False)]
         + rng.normal(scale=0.1, size=(k, d))).astype(np.float32)
    return x, c


def _scale(x, c):
    return 1e-5 * float((x * x).sum(1).max() + (c * c).sum(1).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("center,shifted", [(False, False), (True, False),
                                            (False, True)])
def test_pairwise_sq_dist(center, shifted):
    x, c = _data(0, offset=3.0)
    want = np.asarray(jdist.pairwise_sq_dist(x, c, center=center,
                                             shifted=shifted))
    got = tdist.pairwise_sq_dist(_t(x), _t(c), center=center,
                                 shifted=shifted).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_scale(x, c))


def test_pairwise_sq_dist_rejects_center_with_shifted():
    x, c = _data(0)
    with pytest.raises(ValueError):
        jdist.pairwise_sq_dist(x, c, center=True, shifted=True)
    with pytest.raises(ValueError):
        tdist.pairwise_sq_dist(_t(x), _t(c), center=True, shifted=True)


def test_pairwise_direct_and_dist():
    x, c = _data(1, n=300)
    np.testing.assert_allclose(
        tdist.pairwise_sq_dist_direct(_t(x), _t(c), block_rows=128).numpy(),
        np.asarray(jdist.pairwise_sq_dist_direct(x, c, block_rows=128)),
        rtol=RTOL, atol=_scale(x, c))
    np.testing.assert_allclose(
        tdist.pairwise_dist(_t(x), _t(c)).numpy(),
        np.asarray(jdist.pairwise_dist(x, c)), rtol=RTOL, atol=1e-3)


def test_assign_clusters():
    x, c = _data(2)
    got = tassign.assign_clusters(_t(x), _t(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jassign.assign_clusters(x, c)))


def test_cluster_stats():
    x, c = _data(3)
    lab = np.random.default_rng(3).integers(0, 17, size=500).astype(np.int32)
    ws, wc = jassign.cluster_stats(x, lab, 17)
    gs, gc = tassign.cluster_stats(_t(x), _t(lab), 17)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL,
                               atol=1e-4)


def _assert_stats(got, want, x, c):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL,
                               atol=_scale(x, c))


@pytest.mark.parametrize("name", ["lloyd_stats", "lloyd_stats_refined"])
def test_lloyd_stats(name):
    x, c = _data(4)
    _assert_stats(getattr(tassign, name)(_t(x), _t(c)),
                  getattr(jassign, name)(x, c), x, c)


@pytest.mark.parametrize("refined", [False, True])
def test_lloyd_stats_padded_blocked(refined):
    # N=500 over 128-row blocks: a ragged tail of zero rows to correct.
    x, c = _data(5)
    want = jassign.lloyd_stats_padded_blocked(
        jnp.asarray(x), jnp.asarray(c), 128, jassign.lloyd_stats_refined if refined else None)
    got = tassign.lloyd_stats_padded_blocked(
        _t(x), _t(c), 128, tassign.lloyd_stats_refined if refined else None)
    _assert_stats(got, want, x, c)


def test_assign_refined():
    x, c = _data(6, offset=20.0)
    wl, wm = jassign.assign_refined(x, c)
    gl, gm = tassign.assign_refined(_t(x), _t(c))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=RTOL,
                               atol=1e-5)


def test_assign_refined_ties_go_to_the_lowest_index():
    """C4: four equal centroids nominate in jax.lax.top_k's order (the
    lower index first among equal distances), so the label is 0."""
    x = np.zeros((1, 4), np.float32)
    c = np.ones((4, 4), np.float32)
    wl, wm = jassign.assign_refined(x, c)
    gl, gm = tassign.assign_refined(_t(x), _t(c))
    assert int(np.asarray(wl)[0]) == 0
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_apply_centroid_update_keeps_empty_cluster():
    x, c = _data(7)
    c[4] = 1e3  # nobody's nearest: an empty cluster
    ws = jassign.lloyd_stats(x, c)
    gs = tassign.lloyd_stats(_t(x), _t(c))
    assert float(gs.counts[4]) == 0.0
    want = np.asarray(jassign.apply_centroid_update(ws, jnp.asarray(c)))
    got = tassign.apply_centroid_update(gs, _t(c)).numpy()
    np.testing.assert_array_equal(got[4], c[4])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_init_first_k_exact():
    x, _ = _data(8)
    np.testing.assert_array_equal(tinit.init_first_k(_t(x), 9).numpy(),
                                  np.asarray(jinit.init_first_k(x, 9)))


@pytest.mark.parametrize("which", ["init_random", "init_kmeans_pp"])
def test_seeded_init_picks_distinct_rows_reproducibly(which):
    # JAX's threefry and torch's generators never agree, so the property
    # is checked instead of the values: K distinct data rows, and the same
    # seed gives the same rows.
    x, _ = _data(9, n=400)
    fn = getattr(tinit, which)
    a = fn(torch.Generator().manual_seed(5), _t(x), 12).numpy()
    b = fn(torch.Generator().manual_seed(5), _t(x), 12).numpy()
    np.testing.assert_array_equal(a, b)
    rows = {tuple(r) for r in x}
    assert all(tuple(r) in rows for r in a)
    assert len({tuple(r) for r in a}) == 12
    other = fn(torch.Generator().manual_seed(6), _t(x), 12).numpy()
    assert not np.array_equal(a, other)


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_resolve_kernel_unknown_model_follows_jax(platform, tmp_path,
                                                  monkeypatch):
    """ROADMAP Queue C5: an unknown model resolves to 'xla' off the
    accelerator, with the `kernel_selected` event, and raises the JAX
    package's ValueError on it (a CUDA device here, a TPU there)."""
    import json

    from tdc_tpu.ops.pallas_kernels import resolve_kernel as jresolve
    from tdc_tpu_torch.ops.lloyd_kernels import resolve_kernel as tresolve

    log = tmp_path / "run.jsonl"
    monkeypatch.setenv("TDC_RUNLOG", str(log))
    kw = dict(k=8, d=4, model="gmm_sharded")
    if platform == "cpu":
        assert jresolve("auto", platform="cpu", **kw) == "xla"
        assert tresolve("auto", device=torch.device("cpu"), **kw) == "xla"
        events = [json.loads(line) for line in log.read_text().splitlines()]
        picked = [(e["kernel"], e["model"]) for e in events
                  if e["event"] == "kernel_selected"]
        assert picked == [("xla", "gmm_sharded")] * 2
        return
    with pytest.raises(ValueError) as want:
        jresolve("auto", platform="tpu", **kw)
    with pytest.raises(ValueError) as got:
        tresolve("auto", device=torch.device("cuda"), **kw)
    assert str(got.value) == str(want.value) == (
        "resolve_kernel: unknown model 'gmm_sharded'")
